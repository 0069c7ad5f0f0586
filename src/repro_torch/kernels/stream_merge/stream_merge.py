"""CUDA kernel for the streaming merge plan (K9).

The counterpart of ``repro.kernels.stream_merge.stream_merge``'s
``merge_pallas``: hand-written CUDA C++ in ``csrc/stream_merge.cu``, built
for Hopper by ``kernels._build``. The wrapper takes CUDA tensors only,
checks what the kernel takes, allocates the outputs, launches on the
current stream without synchronising, and counts the launch under
``merge``. ``ops`` dispatches CPU tensors to the plain version in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def merge_cuda(alloc: torch.Tensor, ptrs: torch.Tensor):
    """Per page, the highest allocated of K layers: ``alloc`` (K, N) bool
    or int32 (tested ``!= 0``), ``ptrs`` (K, N) int32. Returns ``(found
    (N,) bool, ptr (N,) int32 [0 where not found], src (N,) int32 [-1
    where not found])``."""
    for x in (alloc, ptrs):
        if not x.is_cuda:
            raise ValueError(f"merge: expected CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("merge: inputs must be contiguous")
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
    code = _build.library().merge(
        alloc.data_ptr(), ptrs.data_ptr(), found.data_ptr(), ptr.data_ptr(),
        src.data_ptr(), k, n, alloc.element_size(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("merge", code)
    return found, ptr, src
