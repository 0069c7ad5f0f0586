"""Dispatch for the fleet chain-resolve kernels.

A CUDA tensor goes to the CUDA kernel (``chain_resolve``), which launches
or raises; a CPU tensor goes to the plain version (``ref``). Nothing
falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.chain_resolve import ref
from repro_torch.kernels.chain_resolve.chain_resolve import (
    resolve_direct_fleet_cuda,
    resolve_vanilla_fleet_cuda,
)


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
