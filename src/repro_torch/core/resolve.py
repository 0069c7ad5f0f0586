"""Page resolution: the vanilla chain walk vs sQEMU direct access (PyTorch port).

Given a batch of logical page ids, resolution answers: *which snapshot owns
the latest version of each page, and at which pool row does it live?* The
semantics are those of ``repro.core.resolve``:

``resolve_vanilla``
    First-hit walk from the active volume down the chain; the cost
    (``lookups``) is O(chain length) per page — the paper's Eq. 1.
``resolve_direct``
    One lookup of the active volume's entry, which carries
    ``backing_file_index``. O(1).
``resolve_auto``
    Direct where the active entry is trusted (allocated and BFI_VALID),
    the walk otherwise (mixed images, paper §5.1).

The ``*_tables`` helpers are stacked over a leading tenant axis — l2
(T, C, n_pages, 2), length (T,), page_ids (T, B) — so ``core.fleet`` calls
them directly where the JAX package vmaps them; a single chain is the
T = 1 case. The ``resolve_*_stacked`` functions run the fleet kernels of
``kernels/chain_resolve`` (CUDA on the card, the plain versions on the
CPU): ``resolve_auto_stacked`` one launch of the batch entry over the
batch's (T, B) pages, which answers a trusted read from its active entry
and walks only the others; ``resolve_vanilla_stacked`` and
``resolve_direct_stacked`` the whole-map kernels over every tenant's full
page table, then a gather of the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import format as fmt
from repro_torch.core.chain import Chain
from repro_torch.kernels.chain_resolve import ops as _kernel_ops
from repro_torch.kernels.chain_resolve.ref import direct_layer


class ResolveResult(NamedTuple):
    owner: torch.Tensor    # (..., B) int32 — owning snapshot index; -1 if not found
    ptr: torch.Tensor      # (..., B) int32 — pool row (valid only where found)
    found: torch.Tensor    # (..., B) bool
    zero: torch.Tensor     # (..., B) bool — qcow2 "zero cluster"
    lookups: torch.Tensor  # (..., B) int32 — #L2 consultations performed (cost)
    cold: torch.Tensor     # (..., B) bool — hit lives in the host tier


def tables_from_hits(owner: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Direct block tables from a stacked first-hit resolve: the pool row
    where found, -1 holes — what the paged-attention plane consumes."""
    ptr = hit & fmt.PTR_MASK
    return torch.where(owner >= 0, ptr, -1).to(torch.int32)


def _gather_pages(l2: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """(T, C, n_pages, 2) entries at (T, B) page ids → (T, C, B, 2)."""
    t, c = l2.shape[0], l2.shape[1]
    b = page_ids.shape[1]
    idx = page_ids.to(torch.int64)[:, None, :, None].expand(t, c, b, 2)
    return torch.gather(l2, 2, idx)


def resolve_vanilla_tables(l2: torch.Tensor, length: torch.Tensor,
                           page_ids: torch.Tensor) -> ResolveResult:
    """First-hit scan from the active volume down the chain. O(chain)."""
    c = l2.shape[1]
    entries = _gather_pages(l2, page_ids)                   # (T, C, B, 2)
    idx = torch.arange(c, dtype=torch.int32, device=l2.device)[None, :, None]
    length = length.to(torch.int32)
    live = idx < length[:, None, None]
    alloc = fmt.entry_allocated(entries) & live             # (T, C, B)
    owner = torch.where(alloc, idx, -1).amax(dim=1)         # (T, B)
    found = owner >= 0
    b = page_ids.shape[1]
    pick = owner.clamp(min=0).to(torch.int64)[:, None, :, None].expand(-1, 1, b, 2)
    picked = torch.gather(entries, 1, pick)[:, 0]           # (T, B, 2)
    # walk cost: active volume down to the owner (inclusive); a miss walks
    # the entire chain
    ln = length[:, None]
    lookups = torch.where(found, ln - owner, ln)
    return ResolveResult(
        owner=owner.to(torch.int32),
        ptr=fmt.entry_ptr(picked),
        found=found,
        zero=fmt.entry_zero(picked) & found,
        lookups=lookups.to(torch.int32),
        cold=fmt.entry_cold(picked) & found,
    )


def resolve_direct_tables(l2: torch.Tensor, length: torch.Tensor,
                          page_ids: torch.Tensor) -> ResolveResult:
    """Single active-volume lookup using backing_file_index. O(1).

    The active layer ``length - 1`` follows the JAX indexing rules
    (``direct_layer``): a length-0 tenant (free or padded rows) reads
    layer C-1 rather than faulting."""
    t, c = l2.shape[0], l2.shape[1]
    act = direct_layer(length, c)
    layer = l2[torch.arange(t, device=l2.device), act]     # (T, n_pages, 2)
    b = page_ids.shape[1]
    entries = torch.gather(
        layer, 1, page_ids.to(torch.int64)[:, :, None].expand(t, b, 2))
    alloc = fmt.entry_allocated(entries)
    valid = fmt.entry_bfi_valid(entries)
    owner = torch.where(alloc, fmt.entry_bfi(entries), -1)
    return ResolveResult(
        owner=owner.to(torch.int32),
        ptr=fmt.entry_ptr(entries),
        found=alloc & valid,
        zero=fmt.entry_zero(entries) & alloc,
        lookups=torch.ones_like(page_ids, dtype=torch.int32),
        cold=fmt.entry_cold(entries) & alloc,
    )


def combine_auto(trust: torch.Tensor, direct: ResolveResult,
                 walk: ResolveResult) -> ResolveResult:
    """Field-wise pick of ``direct`` where ``trust`` else ``walk``.

    ``trust`` is "the active entry is allocated AND carries a valid
    backing_file_index" — exactly ``direct.found``. The plain auto
    resolver's pick; the batch entry of ``resolve_auto_stacked`` makes the
    same pick per read in its epilogue, and the tests hold the two equal.
    """
    return ResolveResult(*(torch.where(trust, d, w)
                           for d, w in zip(direct, walk)))


def resolve_auto_tables(l2: torch.Tensor, length: torch.Tensor,
                        page_ids: torch.Tensor) -> ResolveResult:
    """Direct access where BFI_VALID, chain walk otherwise (paper §5.1)."""
    direct = resolve_direct_tables(l2, length, page_ids)
    walk = resolve_vanilla_tables(l2, length, page_ids)
    return combine_auto(direct.found, direct, walk)


_TABLE_RESOLVERS = {
    "vanilla": resolve_vanilla_tables,
    "direct": resolve_direct_tables,
    "auto": resolve_auto_tables,
}


# -- kernel resolvers over the stacked (T, C, P, 2) fleet layout -------------


def _take(maps: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.gather(maps, 1, ids)


def resolve_vanilla_stacked(l2: torch.Tensor, lengths: torch.Tensor,
                            page_ids: torch.Tensor) -> ResolveResult:
    """Kernel-backed first-hit walk for a whole fleet in one launch: the
    kernel resolves every tenant's full page table, reading word0 in place
    through the strided ``l2[..., 0]`` view (no plane copy), then the
    batch is a per-tenant gather. Bit-identical to
    ``resolve_vanilla_tables``."""
    ids = page_ids.to(torch.int64)
    owner_map, hit_map = _kernel_ops.resolve_vanilla_fleet(
        l2[..., 0], lengths.to(torch.int32).contiguous())
    owner = _take(owner_map, ids)
    hit = _take(hit_map, ids)
    found = owner >= 0
    ln = lengths.to(torch.int32)[:, None]
    return ResolveResult(
        owner=owner,
        ptr=hit & fmt.PTR_MASK,
        found=found,
        # a miss returns hit == 0, so the ZERO/COLD bits read as False there
        zero=(hit & fmt.FLAG_ZERO_I32) != 0,
        lookups=torch.where(found, ln - owner, ln).to(torch.int32),
        cold=(hit & fmt.FLAG_COLD_I32) != 0,
    )


def resolve_direct_stacked(l2: torch.Tensor, lengths: torch.Tensor,
                           page_ids: torch.Tensor) -> ResolveResult:
    """Kernel-backed direct access for a whole fleet in one launch: the
    kernel reads only each tenant's active layer, in place through the
    ``l2[..., 0]``/``l2[..., 1]`` views of the packed words (no plane
    copy). Bit-identical to ``resolve_direct_tables``."""
    ids = page_ids.to(torch.int64)
    owner_map, h0_map, h1_map = _kernel_ops.resolve_direct_fleet(
        l2[..., 0], l2[..., 1], lengths.to(torch.int32).contiguous())
    owner = _take(owner_map, ids)
    h0 = _take(h0_map, ids)
    h1 = _take(h1_map, ids)
    alloc = (h0 & fmt.FLAG_ALLOCATED_I32) != 0
    return ResolveResult(
        owner=owner,
        ptr=h0 & fmt.PTR_MASK,
        found=alloc & ((h1 & fmt.FLAG_BFI_VALID) != 0),
        zero=((h0 & fmt.FLAG_ZERO_I32) != 0) & alloc,
        lookups=torch.ones_like(owner),
        cold=((h0 & fmt.FLAG_COLD_I32) != 0) & alloc,
    )


def resolve_auto_stacked(l2: torch.Tensor, lengths: torch.Tensor,
                         page_ids: torch.Tensor) -> ResolveResult:
    """Kernel-backed mixed-image resolution of the batch's pages in one
    launch: the active entry where it is trusted (``combine_auto``'s
    trust), the walk elsewhere, read in place from the packed words.
    Bit-identical to ``combine_auto`` over ``resolve_direct_stacked`` and
    ``resolve_vanilla_stacked``, and so to ``resolve_auto_tables`` but for
    ``ptr`` on a miss (``ref.resolve_auto_batch_ref``)."""
    return ResolveResult(*_kernel_ops.resolve_auto_batch(
        l2[..., 0], l2[..., 1], lengths.to(torch.int32).contiguous(),
        page_ids.to(torch.int32)))


def _as_chain(fn):
    """Run a stacked resolver on a single chain (a 1-tenant fleet)."""

    def resolver(chain: Chain, page_ids) -> ResolveResult:
        ids = torch.as_tensor(page_ids, device=chain.l2.device)
        res = fn(chain.l2[None], chain.length[None], ids[None])
        return ResolveResult(*(leaf[0] for leaf in res))

    return resolver


resolve_vanilla = _as_chain(resolve_vanilla_tables)
resolve_direct = _as_chain(resolve_direct_tables)
resolve_auto = _as_chain(resolve_auto_tables)

_RESOLVERS = {
    "vanilla": resolve_vanilla,
    "direct": resolve_direct,
    "auto": resolve_auto,
    # kernel-backed paths: a chain is a 1-tenant fleet, so the stacked
    # fleet kernels serve single chains too
    "pallas_vanilla": _as_chain(resolve_vanilla_stacked),
    "pallas_direct": _as_chain(resolve_direct_stacked),
}


def lookup_resolver(registry: dict, name: str):
    """Shared registry lookup (chain-, table- and fleet-level registries)."""
    try:
        return registry[name]
    except KeyError:
        raise ValueError(
            f"unknown resolver {name!r}; expected one of {sorted(registry)}"
        ) from None


def get_resolver(name: str):
    return lookup_resolver(_RESOLVERS, name)


def get_table_resolver(name: str):
    """Table-level resolver (stacked over tenants; used by ``core.fleet``)."""
    return lookup_resolver(_TABLE_RESOLVERS, name)
