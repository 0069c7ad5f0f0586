"""Dispatch for the chain-resolve kernels (fleet and single-chain).

A CUDA tensor goes to the CUDA kernel (``chain_resolve``), which launches
or raises; a CPU tensor goes to the plain version (``ref``). Nothing
falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.chain_resolve import ref
from repro_torch.kernels.chain_resolve.chain_resolve import (
    resolve_auto_batch_cuda,
    resolve_direct_cuda,
    resolve_direct_fleet_cuda,
    resolve_vanilla_cuda,
    resolve_vanilla_fleet_cuda,
)


def resolve_vanilla(alloc, ptrs, length):
    """(C, N) single-chain walk → ``(owner, ptr)``, each (N,). No lane
    padding: the 128-lane page axis is a TPU tiling fact."""
    if alloc.is_cuda:
        return resolve_vanilla_cuda(alloc, ptrs, length)
    return ref.resolve_vanilla_ref(alloc, ptrs, length)


def resolve_direct(alloc_active, bfi_active, ptrs_active):
    """(N,) single-chain direct lookup → ``(owner, ptr)``, each (N,)."""
    if alloc_active.is_cuda:
        return resolve_direct_cuda(alloc_active, bfi_active, ptrs_active)
    return ref.resolve_direct_ref(alloc_active, bfi_active, ptrs_active)


def resolve_vanilla_fleet(w0, lengths):
    """Stacked (T, C, P) chain walk → ``(owner, hit)``, each (T, P)."""
    if w0.is_cuda:
        return resolve_vanilla_fleet_cuda(w0, lengths)
    return ref.resolve_vanilla_fleet_ref(w0, lengths)


def resolve_direct_fleet(w0, w1, lengths):
    """Stacked (T, C, P) direct lookup → ``(owner, h0, h1)``, each (T, P)."""
    if w0.is_cuda:
        return resolve_direct_fleet_cuda(w0, w1, lengths)
    return ref.resolve_direct_fleet_ref(w0, w1, lengths)


def resolve_auto_batch(w0, w1, lengths, page_ids):
    """The auto resolve of (T, B) page ids over (T, C, P) words →
    ``(owner, ptr, found, zero, lookups, cold)``, each (T, B)."""
    if w0.is_cuda:
        return resolve_auto_batch_cuda(w0, w1, lengths, page_ids)
    return ref.resolve_auto_batch_ref(w0, w1, lengths, page_ids)
