"""CUDA kernel for the resolved-page gather from the device page pool.

The counterpart of ``repro.kernels.cow_gather.cow_gather``'s
``gather_pallas`` (K8, one chain's (B,) pages) and ``gather_fleet_pallas``
(K5, a fleet's (T, B) pages): one hand-written CUDA C++ kernel in
``csrc/cow_gather.cu`` that copies each page as raw bytes, built for
Hopper by ``kernels._build``. The wrappers here take CUDA tensors only,
check what the kernel takes, allocate the output, launch on the current
stream without synchronising, and count the launch under their own
name. ``ops`` dispatches CPU tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _launch(name: str, pool: torch.Tensor, rows: torch.Tensor,
            found: torch.Tensor) -> torch.Tensor:
    for x in (pool, rows, found):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if pool.dim() != 2:
        raise ValueError(f"{name}: pool must be (R, P), got {tuple(pool.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
    if found.dtype != torch.bool or found.shape != rows.shape:
        raise ValueError(f"{name}: found must be bool of the rows' shape")
    r, p = pool.shape
    out = torch.empty((*rows.shape, p), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    code = _build.library().cow_gather(
        pool.data_ptr(), rows.data_ptr(), found.data_ptr(), out.data_ptr(),
        rows.numel(), r, p * pool.element_size(),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check_launch(name, code)
    return out


def gather_cuda(pool: torch.Tensor, rows: torch.Tensor,
                found: torch.Tensor) -> torch.Tensor:
    """K8: ``pool`` (R, P), ``rows`` (B,) int32, ``found`` (B,) bool →
    (B, P): ``pool[rows[i]]`` where found, +0.0 bytes elsewhere. The pool
    is never read where not found (nor at a row outside [0, R))."""
    if rows.dim() != 1:
        raise ValueError(f"gather: rows must be (B,), got {tuple(rows.shape)}")
    return _launch("gather", pool, rows, found)


def gather_fleet_cuda(pool: torch.Tensor, rows: torch.Tensor,
                      found: torch.Tensor) -> torch.Tensor:
    """K5: the stacked fleet gather, ``rows``/``found`` (T, B) → (T, B, P);
    the pool is global, so one launch serves every tenant."""
    if rows.dim() != 2:
        raise ValueError(
            f"gather_fleet: rows must be (T, B), got {tuple(rows.shape)}")
    return _launch("gather_fleet", pool, rows, found)
