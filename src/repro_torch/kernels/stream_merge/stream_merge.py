"""CUDA kernel for the streaming merge plan (K9).

The counterpart of ``repro.kernels.stream_merge.stream_merge``'s
``merge_pallas``: hand-written CUDA C++ in ``csrc/stream_merge.cu``, built
for Hopper by ``kernels._build``, with two entries. ``merge_entries_cuda``
takes the packed (K, N, 2) L2 words and returns the whole merge plan (the
entry ``core.chain.plan_merge`` calls); ``merge_cuda`` keeps the JAX
signature, (K, N) planes in. The wrappers take CUDA tensors only, check
what the kernel takes, allocate the outputs, launch on the current stream
without synchronising, and count the launch under ``merge``. ``ops``
dispatches CPU tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the planes entry's pages a thread (one load of their allocation entries
#: a layer; 1 where 4 does not fit N) and layers a batch, fixed in
#: ``csrc/stream_merge.cu``
PLANES_VEC = 4
PLANES_UNROLL = 32


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")


def merge_entries_cuda(sub: torch.Tensor):
    """The merge plan of K layers from their packed words: ``sub`` (K, N, 2)
    int32, contiguous. Returns ``(merged (N, 2) int32 — the entry of the
    highest layer that has the page allocated, layer 0's where none has,
    found (N,) bool, src (N,) int32 [-1 where not found])``."""
    _check("merge_entries", sub)
    if sub.dtype != torch.int32:
        raise TypeError(f"merge_entries: expected int32 words, got {sub.dtype}")
    if sub.dim() != 3 or sub.shape[2] != 2:
        raise ValueError("merge_entries: words must be (K, N, 2)")
    k, n, _ = sub.shape
    if k == 0:
        raise ValueError("merge_entries: needs at least one layer")
    dev = sub.device
    merged = torch.empty((n, 2), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return merged, found, src
    code = _build.library().merge_entries(
        sub.data_ptr(), merged.data_ptr(), found.data_ptr(), src.data_ptr(),
        k, n, _build.launch_stream(sub))
    _build.check_launch("merge", code)
    return merged, found, src


def planes_config(alloc: torch.Tensor) -> tuple[int, int]:
    """``(pages a thread, layers a batch)`` of the planes entry. The pages
    a thread must divide N, with the plane aligned to their bytes: 4 where
    that holds, else 1."""
    esz, n = alloc.element_size(), alloc.shape[1]
    v = PLANES_VEC
    fits = n % v == 0 and alloc.data_ptr() % (v * esz) == 0
    return (v if fits else 1), PLANES_UNROLL


def merge_cuda(alloc: torch.Tensor, ptrs: torch.Tensor):
    """Per page, the highest allocated of K layers: ``alloc`` (K, N) bool
    or int32 (tested ``!= 0``), ``ptrs`` (K, N) int32. Returns ``(found
    (N,) bool, ptr (N,) int32 [0 where not found], src (N,) int32 [-1
    where not found])``."""
    for x in (alloc, ptrs):
        _check("merge", x)
    if alloc.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"merge: alloc must be bool or int32, got {alloc.dtype}")
    if ptrs.dtype != torch.int32:
        raise TypeError(f"merge: ptrs must be int32, got {ptrs.dtype}")
    if alloc.dim() != 2 or ptrs.shape != alloc.shape:
        raise ValueError("merge: alloc and ptrs must both be (K, N)")
    k, n = alloc.shape
    if k == 0:
        raise ValueError("merge: needs at least one layer")
    dev = alloc.device
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    ptr = torch.empty((n,), dtype=torch.int32, device=dev)
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return found, ptr, src
    v, _ = planes_config(alloc)
    code = _build.library().merge(
        alloc.data_ptr(), ptrs.data_ptr(), found.data_ptr(), ptr.data_ptr(),
        src.data_ptr(), k, n, alloc.element_size(), v,
        _build.launch_stream(alloc))
    _build.check_launch("merge", code)
    return found, ptr, src
