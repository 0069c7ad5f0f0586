"""Dispatch for the resolved-page gather kernels.

A CUDA tensor goes to the CUDA kernel (``cow_gather``), which launches or
raises; a CPU tensor goes to the plain version (``ref``). Nothing falls
back from one to the other. The page axis needs no padding: the JAX
package pads it to 128 lanes for the TPU's tiling, which Hopper does not
have.
"""

from __future__ import annotations

from repro_torch.kernels.cow_gather import ref
from repro_torch.kernels.cow_gather.cow_gather import (
    gather_cuda,
    gather_fleet_cuda,
    gather_fleet_resolved_cuda,
)


def gather(pool, rows, found):
    """Single-chain read gather: (R, P) pool, (B,) rows/found → (B, P)."""
    if pool.is_cuda:
        return gather_cuda(pool, rows, found)
    return ref.gather_ref(pool, rows, found)


def gather_fleet(pool, rows, found):
    """Fleet read gather: (R, P) pool, (T, B) rows/found → (T, B, P)."""
    if pool.is_cuda:
        return gather_fleet_cuda(pool, rows, found)
    return ref.gather_fleet_ref(pool, rows, found)


def gather_fleet_resolved(pool, ptr, found, zero, cold):
    """Fleet read gather on a resolve's (T, B) leaves → (T, B, P): the
    pages found in the device pool (not ZERO, not COLD), zeros elsewhere."""
    if pool.is_cuda:
        return gather_fleet_resolved_cuda(pool, ptr, found, zero, cold)
    return ref.gather_fleet_resolved_ref(pool, ptr, found, zero, cold)
