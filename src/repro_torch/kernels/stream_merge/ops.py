"""Dispatch for the streaming-merge kernel.

A CUDA tensor goes to the CUDA kernel (``stream_merge``), which launches
or raises; a CPU tensor goes to the plain version (``ref``). Nothing
falls back from one to the other. The page axis needs no padding: the
JAX package pads it to 128 lanes for the TPU's tiling, which Hopper does
not have.
"""

from __future__ import annotations

from repro_torch.kernels.stream_merge import ref
from repro_torch.kernels.stream_merge.stream_merge import (merge_cuda,
                                                         merge_entries_cuda)


def merge(alloc, ptrs, bfi=None):
    """(K, N) planes → ``(found, ptr, src)``, each (N,)."""
    if alloc.is_cuda:
        return merge_cuda(alloc, ptrs)
    return ref.merge_ref(alloc, ptrs, bfi)


def merge_entries(sub):
    """(K, N, 2) packed words → ``(merged (N, 2), found (N,), src (N,))``."""
    if sub.is_cuda:
        return merge_entries_cuda(sub)
    return ref.merge_entries_ref(sub)
