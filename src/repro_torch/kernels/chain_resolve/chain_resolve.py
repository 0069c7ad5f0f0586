"""CUDA kernels for stacked (T, C, P) fleet chain resolution.

The counterparts of ``repro.kernels.chain_resolve.chain_resolve``'s
``resolve_vanilla_fleet_pallas`` and ``resolve_direct_fleet_pallas``:
hand-written CUDA C++ in ``csrc/chain_resolve.cu``, built for Hopper by
``kernels._build``. The wrappers here take CUDA tensors only, check what
the kernel takes, allocate the outputs, launch on the current stream
without synchronising, and count the launch. ``ops`` dispatches CPU
tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check_words(name: str, *tensors: torch.Tensor) -> None:
    for x in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 words, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def resolve_vanilla_fleet_cuda(w0: torch.Tensor, lengths: torch.Tensor):
    """Stacked first-hit chain walk: ``w0`` (T, C, P) int32 packed word0,
    ``lengths`` (T,) int32. Returns ``(owner (T, P) int32 [-1 on a miss],
    hit (T, P) int32 — the owner's raw word0, 0 on a miss)``."""
    _check_words("resolve_vanilla_fleet", w0, lengths)
    t, c, p = w0.shape
    if lengths.shape != (t,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({t},)")
    owner = torch.empty((t, p), dtype=torch.int32, device=w0.device)
    hit = torch.empty((t, p), dtype=torch.int32, device=w0.device)
    if t * p == 0:
        return owner, hit
    lib = _build.library()
    code = lib.resolve_vanilla_fleet(
        w0.data_ptr(), lengths.data_ptr(), owner.data_ptr(), hit.data_ptr(),
        t, c, p, torch.cuda.current_stream(w0.device).cuda_stream)
    _build.check_launch("resolve_vanilla_fleet", code)
    return owner, hit


def resolve_direct_fleet_cuda(w0: torch.Tensor, w1: torch.Tensor,
                              lengths: torch.Tensor):
    """Stacked direct access of each tenant's active layer ``length - 1``
    (a length-0 tenant wraps to layer C-1, as the JAX reference does).
    Returns ``(owner (T, P) int32, h0 (T, P) int32, h1 (T, P) int32)``."""
    _check_words("resolve_direct_fleet", w0, w1, lengths)
    t, c, p = w0.shape
    if w1.shape != w0.shape or lengths.shape != (t,):
        raise ValueError("resolve_direct_fleet: w0/w1 (T, C, P), lengths (T,)")
    owner, h0, h1 = (torch.empty((t, p), dtype=torch.int32, device=w0.device)
                     for _ in range(3))
    if t * p == 0:
        return owner, h0, h1
    lib = _build.library()
    code = lib.resolve_direct_fleet(
        w0.data_ptr(), w1.data_ptr(), lengths.data_ptr(), owner.data_ptr(),
        h0.data_ptr(), h1.data_ptr(), t, c, p,
        torch.cuda.current_stream(w0.device).cuda_stream)
    _build.check_launch("resolve_direct_fleet", code)
    return owner, h0, h1
