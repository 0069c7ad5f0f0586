"""Plain PyTorch versions of the streaming-merge kernel's two entries.

``merge_ref`` is line for line the oracle of
``repro.kernels.stream_merge.ref``; ``merge_entries_ref`` is the body of
the JAX package's ``core.chain.plan_merge`` on the packed words. The CPU
tests pin it against the JAX oracle and the Pallas kernel in interpret
mode; ``chip_smoke.py`` holds the CUDA kernel (K9) against it on the
card. Pointers are the ``int32`` carrier of ``core.format``.
"""

from __future__ import annotations

import torch

from repro_torch.core import format as fmt


def merge_ref(alloc, ptrs, bfi=None):
    """Merge K snapshot layers into one (paper's streaming job).

    alloc/ptrs: (K, N); ``alloc`` bool or int (tested ``!= 0``), ``ptrs``
    int32. For each page, take the entry of the highest allocated layer.
    ``bfi`` is accepted for the JAX signature and unused, as there.
    Returns (found (N,) bool, ptr (N,) int32 — the JAX ``uint32``
    pointer's bits, 0 where absent, src_layer (N,) int32 [-1 if absent]).
    """
    k = alloc.shape[0]
    idx = torch.arange(k, dtype=torch.int32, device=alloc.device)[:, None]
    src = torch.where(alloc != 0, idx, -1).amax(dim=0)
    found = src >= 0
    ptr = torch.gather(ptrs, 0, src.clamp(min=0)[None].to(torch.int64))[0]
    return (found, torch.where(found, ptr, 0).to(torch.int32),
            src.to(torch.int32))


def merge_entries_ref(sub):
    """The merge plan of K layers from their packed words.

    sub: (K, N, 2) int32 L2 entries. The allocation and pointer planes go
    through ``merge_ref``; the merged entries are then gathered from the
    layer it names, layer 0 where it names none (as
    ``jnp.take_along_axis`` at ``max(src, 0)`` does in the JAX package).
    Returns (merged (N, 2) int32, found (N,) bool, src (N,) int32 [-1 if
    absent]).
    """
    found, _, src = merge_ref(fmt.entry_allocated(sub), fmt.entry_ptr(sub))
    pick = src.clamp(min=0).to(torch.int64)[None, :, None].expand(1, -1, 2)
    return torch.gather(sub, 0, pick)[0], found, src
