"""Plain PyTorch versions of the resolved-page gather kernels.

Line for line the oracles of ``repro.kernels.cow_gather.ref``: the
single-chain gather (K8) and the stacked fleet gather (K5). The CPU tests
pin them against the JAX oracles and Pallas kernels; ``chip_smoke.py``
holds the CUDA kernels against them on the card. Beside them, the plain
version of K5's entry on a resolve's leaves, which has no JAX counterpart.
"""

from __future__ import annotations

import torch


def gather_ref(pool, rows, found):
    """pool: (R, P); rows: (B,) int32; found: (B,) bool → (B, P).

    Unresolved pages read as zeros (Qcow2 unallocated-cluster semantics).
    """
    safe = torch.where(found, rows, 0).to(torch.int64)
    data = pool[safe]
    return torch.where(found[:, None], data, torch.zeros_like(data))


def gather_fleet_ref(pool, rows, found):
    """pool: (R, P); rows: (T, B) int32; found: (T, B) bool → (T, B, P).

    The pool is global across tenants, so the fleet gather is one fancy
    index; unresolved pages read as zeros, as in the single-chain case.
    """
    safe = torch.where(found, rows, 0).to(torch.int64)
    data = pool[safe]
    return torch.where(found[..., None], data, torch.zeros_like(data))


def gather_fleet_resolved_ref(pool, ptr, found, zero, cold):
    """pool: (R, P); ptr: (T, B) int32; found, zero, cold: (T, B) bool →
    (T, B, P).

    The fleet gather on a resolve's leaves: a page is read from the pool
    where it was found and is neither a ZERO cluster nor COLD (a cold
    ``ptr`` addresses a host-tier row), and reads as zeros elsewhere. The
    JAX package masks the leaves so before its fleet gather
    (``repro.core.fleet``), as ``store.readable_rows`` does here.
    """
    ok = found & ~zero & ~cold
    return gather_fleet_ref(pool, torch.where(ok, ptr, 0), ok)
