"""Plain PyTorch versions of the chain-resolve kernels.

Line for line the oracles of ``repro.kernels.chain_resolve.ref``, for the
single-chain (C, N) planes and the stacked (T, C, P) fleet layout. The CPU tests pin them against the JAX oracles and
Pallas kernels; ``chip_smoke.py`` holds the CUDA kernels against them on
the card. Words are the ``int32`` carrier of ``core.format``.
"""

from __future__ import annotations

import torch

from repro_torch.core import format as fmt


def resolve_vanilla_ref(alloc, ptrs, length):
    """First allocated layer from the top of the chain.

    alloc: (C, N) bool/int — per-layer allocation map for N pages.
    ptrs:  (C, N) int32 — per-layer pool pointers.
    length: scalar int (or 0-d tensor) — live chain length (layers >=
    length are dead).

    Returns (owner (N,) int32 [-1 if absent], ptr (N,) int32 — the JAX
    ``uint32`` pointer's bits, 0 where absent).
    """
    c = alloc.shape[0]
    idx = torch.arange(c, dtype=torch.int32, device=alloc.device)[:, None]
    live = idx < torch.as_tensor(length, device=alloc.device)
    a = (alloc != 0) & live
    owner = torch.where(a, idx, -1).amax(dim=0)
    ptr = torch.gather(ptrs, 0, owner.clamp(min=0)[None].to(torch.int64))[0]
    ptr = torch.where(owner >= 0, ptr, 0)
    return owner.to(torch.int32), ptr.to(torch.int32)


def resolve_direct_ref(alloc_active, bfi_active, ptrs_active):
    """sQEMU direct access: one lookup of the active volume's entries.

    All inputs (N,). Returns (owner (N,) int32, ptr (N,) int32).
    """
    owner = torch.where(alloc_active != 0, bfi_active.to(torch.int32), -1)
    ptr = torch.where(alloc_active != 0, ptrs_active, 0)
    return owner.to(torch.int32), ptr.to(torch.int32)


def resolve_vanilla_fleet_ref(w0, lengths):
    """Stacked first-hit walk over packed word0 tables.

    w0: (T, C, P) int32 — L2 word0 per ``core.format``.
    lengths: (T,) int32 — per-tenant live chain length.

    Returns (owner (T, P) int32 [-1 if absent], hit (T, P) int32 — the
    owning layer's raw word0, 0 where absent).
    """
    c = w0.shape[1]
    layers = torch.arange(c, dtype=torch.int32, device=w0.device)[None, :, None]
    live = layers < lengths.to(torch.int32)[:, None, None]
    alloc = ((w0 & fmt.FLAG_ALLOCATED_I32) != 0) & live
    owner = torch.where(alloc, layers, -1).amax(dim=1)           # (T, P)
    hit = torch.gather(w0, 1, owner.clamp(min=0)[:, None, :].to(torch.int64))[:, 0]
    hit = torch.where(owner >= 0, hit, 0)
    return owner.to(torch.int32), hit.to(torch.int32)


def direct_layer(lengths, c: int):
    """Active layer ``length - 1`` per tenant, with the JAX indexing rules:
    a negative index wraps (a length-0 tenant reads layer C-1, as
    ``jnp.take_along_axis`` and ``lax.dynamic_index_in_dim`` do), then the
    index is clamped into range."""
    act = lengths.to(torch.int64) - 1
    act = torch.where(act < 0, act + c, act)
    return act.clamp(0, c - 1)


def resolve_direct_fleet_ref(w0, w1, lengths):
    """Stacked direct access: each tenant's active layer, one lookup.

    w0/w1: (T, C, P) int32 packed L2 words; lengths: (T,) int32.

    Returns (owner (T, P) int32 [-1 if unallocated], h0 (T, P) int32,
    h1 (T, P) int32 — the active layer's raw entry words).
    """
    c, p = w0.shape[1], w0.shape[2]
    active = direct_layer(lengths, c)[:, None, None].expand(-1, 1, p)
    h0 = torch.gather(w0, 1, active)[:, 0]                        # (T, P)
    h1 = torch.gather(w1, 1, active)[:, 0]
    alloc = (h0 & fmt.FLAG_ALLOCATED_I32) != 0
    bfi = h1 & fmt.BFI_MASK
    owner = torch.where(alloc, bfi, -1)
    return owner.to(torch.int32), h0.to(torch.int32), h1.to(torch.int32)


def resolve_auto_batch_ref(w0, w1, lengths, page_ids):
    """The auto resolve of a batch of pages: the direct entry where it is
    trusted (ALLOCATED and BFI_VALID), the first-hit walk otherwise.

    w0/w1: (T, C, P) int32 packed L2 words; lengths: (T,) int32;
    page_ids: (T, B) ids in [0, P).

    Returns (owner, ptr, found, zero, lookups, cold), each (T, B): int32
    owner (-1 on a miss), ptr (0 on a miss) and lookups (1 where trusted,
    ``length - owner`` where a walk finds the page, ``length`` where it
    does not); bool found, zero and cold. Leaf for leaf what
    ``resolve_direct_fleet_ref`` and ``resolve_vanilla_fleet_ref`` give at
    these pages after the auto pick, on any words. The table helper
    ``core.resolve.resolve_auto_tables`` differs in one leaf, and only on
    a miss: its ``ptr`` there is layer 0's pointer bits, where this one,
    like every stacked resolver, gives 0. They agree wherever that entry
    is all zeros, as an unallocated entry is; a miss at an allocated one
    is a length-0 tenant's.
    """
    t, c = w0.shape[0], w0.shape[1]
    idx = page_ids.to(torch.int64)[:, None, :].expand(t, c, page_ids.shape[1])
    g0, g1 = torch.gather(w0, 2, idx), torch.gather(w1, 2, idx)  # (T, C, B)
    bfi_owner, h0, h1 = resolve_direct_fleet_ref(g0, g1, lengths)
    walk_owner, hit = resolve_vanilla_fleet_ref(g0, lengths)
    trust = ((h0 & fmt.FLAG_ALLOCATED_I32) != 0) & ((h1 & fmt.FLAG_BFI_VALID) != 0)
    ln = lengths.to(torch.int32)[:, None]
    lookups = torch.where(trust, 1, torch.where(walk_owner >= 0, ln - walk_owner, ln))
    owner = torch.where(trust, bfi_owner, walk_owner)
    word = torch.where(trust, h0, hit)
    return (owner, word & fmt.PTR_MASK, owner >= 0, (word & fmt.FLAG_ZERO_I32) != 0,
            lookups.to(torch.int32), (word & fmt.FLAG_COLD_I32) != 0)
