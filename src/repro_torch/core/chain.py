"""Snapshot-chain state: the table-level helpers the fleet maps (PyTorch port).

A ``Chain`` is the analogue of a Qcow2 backing-file chain (see
``repro.core.chain``): ``max_chain`` layers of L1/L2 index tables over one
global page pool; layer ``length - 1`` is the active volume. The port
has the geometry, ``create``, the COW ``write``, ``snapshot``, the
table-level helpers ``core.fleet`` maps over its tenant axis
(``write_tables``, ``copy_forward_tables``, ``merge_tables``), and the
maintenance ops: ``stream`` (the provider's streaming job, chain
compaction), ``compact_pool`` (pool GC) and ``convert_to_scalable``
(offline image conversion). ``plan_merge``, the owner scan every merge
starts from, runs the streaming-merge kernel of ``kernels/stream_merge``
(K9: CUDA on the card, its plain version on the CPU).

Unlike the JAX package, whose updates are functional, the port updates a
chain's tensors in place and returns the same object: a chain is never
read again in the state it had before an update (a caller that needs the
old state clones it first). The maintenance ops are host-driven, as in
the JAX package: they read the concrete chain length and sync by design.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import format as fmt
from repro_torch.device import as_device
from repro_torch.kernels.stream_merge import ops as merge_ops

#: pool rows moved per gather/scatter by the maintenance ops (1 GiB of
#: 64 KiB pages): bounds their temporaries on a large disk
_COPY_ROWS = 16_384


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static geometry of a chain."""

    n_pages: int
    page_size: int
    max_chain: int
    pool_capacity: int
    l2_per_table: int = 64  # L2 entries per L2 table (qcow2: cluster_size/8)
    slice_len: int = 16     # cache-slice granularity, in entries (qcow2 docs)
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_pages % self.l2_per_table != 0:
            raise ValueError("n_pages must be a multiple of l2_per_table")
        if self.max_chain > fmt.MAX_CHAIN_REPRESENTABLE:
            raise ValueError("max_chain exceeds 16-bit backing_file_index")
        if self.pool_capacity > fmt.MAX_POOL_ROWS:
            raise ValueError("pool_capacity exceeds 28-bit page_ptr")
        if self.l2_per_table % self.slice_len != 0:
            raise ValueError("l2_per_table must be a multiple of slice_len")

    @property
    def n_l1(self) -> int:
        return self.n_pages // self.l2_per_table

    @property
    def n_slices(self) -> int:
        return self.n_pages // self.slice_len

    def index_bytes_per_snapshot(self) -> int:
        """On-disk metadata bytes added per snapshot (Eq. 2 numerator)."""
        return self.n_pages * fmt.ENTRY_WORDS * 4 + self.n_l1 * 4


@dataclasses.dataclass
class Chain:
    spec: ChainSpec
    scalable: bool
    l1: torch.Tensor           # (max_chain, n_l1) int32 — bit0: L2 table present
    l2: torch.Tensor           # (max_chain, n_pages, 2) int32 — L2 entries
    pool: torch.Tensor         # (pool_capacity, page_size) dtype
    pool_cursor: torch.Tensor  # () int32 — next free pool row
    length: torch.Tensor       # () int32 — #files in chain; active = length - 1
    overflow: torch.Tensor     # () bool — a write ran past pool_capacity
    snap_dropped: torch.Tensor  # () bool — snapshot dropped at max_chain

    @property
    def active(self) -> torch.Tensor:
        return self.length - 1


def create(spec: ChainSpec, *, scalable: bool = True, device="cuda") -> Chain:
    """A fresh virtual disk: chain of length 1 (a single active volume)."""
    dev = as_device(device)
    return Chain(
        spec=spec,
        scalable=scalable,
        l1=torch.zeros((spec.max_chain, spec.n_l1), dtype=torch.int32, device=dev),
        l2=fmt.empty_entries((spec.max_chain, spec.n_pages), dev),
        pool=torch.zeros((spec.pool_capacity, spec.page_size), dtype=spec.dtype,
                         device=dev),
        pool_cursor=torch.zeros((), dtype=torch.int32, device=dev),
        length=torch.ones((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        snap_dropped=torch.zeros((), dtype=torch.bool, device=dev),
    )


def write_tables(l1: torch.Tensor, l2: torch.Tensor, active: torch.Tensor,
                 page_ids: torch.Tensor, rows: torch.Tensor, *, scalable,
                 l2_per_table: int, mask=None) -> None:
    """Stamp COW entries for ``rows`` into the active volumes' L1/L2, in place.

    Stacked over a leading tenant axis: ``l1`` (T, C, n_l1), ``l2``
    (T, C, n_pages, 2), ``active``/``scalable`` (T,), ``page_ids``/``rows``
    /``mask`` (T, B). A single chain passes T = 1. Entries where ``mask``
    is False are left untouched (inactive tenants, pool overflow).
    Surviving page ids are unique per tenant (the write contract), so the
    scatter has no duplicate-index ordering hazard.
    """
    t, bsz = page_ids.shape
    dev = l2.device
    page_ids = page_ids.to(torch.int64)
    scal = torch.as_tensor(scalable, dtype=torch.bool, device=dev)
    scal = scal.expand(t) if scal.dim() == 0 else scal
    entries = fmt.pack_entry(
        rows, active.to(torch.int64)[:, None].expand(t, bsz),
        allocated=True, bfi_valid=scal[:, None].expand(t, bsz),
    )
    keep = (torch.ones((t, bsz), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev)
            .expand(t, bsz))
    tids = torch.arange(t, device=dev)[:, None].expand(t, bsz)
    act = active.to(torch.int64)[:, None].expand(t, bsz)
    l2[tids[keep], act[keep], page_ids[keep]] = entries[keep]
    l1[tids[keep], act[keep], page_ids[keep] // l2_per_table] = 1


def copy_forward_tables(l1: torch.Tensor, l2: torch.Tensor,
                        new: torch.Tensor, do_copy: torch.Tensor) -> None:
    """sQEMU §5.4 snapshot copy-forward, in place and stacked over tenants:
    where ``do_copy`` (T,), duplicate layer ``new - 1``'s L1/L2 set into
    layer ``new`` (T,), so the new active volume indexes the whole chain
    and direct access stays O(1)."""
    c = l2.shape[1]
    tids = torch.arange(l2.shape[0], device=l2.device)
    dst = new.to(torch.int64).clamp(0, c - 1)
    src = (new.to(torch.int64) - 1).clamp(0, c - 1)
    d2 = do_copy[:, None, None]
    l2[tids, dst] = torch.where(d2, l2[tids, src], l2[tids, dst])
    l1[tids, dst] = torch.where(do_copy[:, None], l1[tids, src], l1[tids, dst])


def write(chain: Chain, page_ids, data) -> Chain:
    """COW write of whole pages to the active volume.

    ``page_ids``: (B,) logical page indices, unique within the batch;
    ``data``: (B, page_size). Writes always take fresh pool rows and update
    only the active volume's L1/L2; overflow rows are dropped and flagged.
    """
    spec = chain.spec
    dev = chain.pool.device
    page_ids = torch.as_tensor(page_ids, device=dev).to(torch.int64)
    bsz = page_ids.shape[0]
    rows = chain.pool_cursor.to(torch.int64) + torch.arange(bsz, device=dev)
    ok = rows < spec.pool_capacity
    chain.overflow |= ~torch.all(ok)
    data = torch.as_tensor(data, device=dev).to(spec.dtype)
    chain.pool[rows[ok]] = data[ok]
    write_tables(chain.l1[None], chain.l2[None], chain.active[None],
                 page_ids[None], torch.where(ok, rows, 0)[None],
                 scalable=chain.scalable, l2_per_table=spec.l2_per_table,
                 mask=ok[None])
    chain.pool_cursor += ok.sum(dtype=torch.int32)
    return chain


def snapshot(chain: Chain, *, scalable: bool | None = None) -> Chain:
    """Freeze the active volume as a backing file; open a new active volume.

    ``scalable=None`` follows the chain's format flag. A full chain cannot
    snapshot: its length is capped and ``snap_dropped`` raised.
    """
    if scalable is None:
        scalable = chain.scalable
    can = chain.length < chain.spec.max_chain
    if scalable:
        copy_forward_tables(chain.l1[None], chain.l2[None], chain.length[None],
                            can[None])
    # vanilla: the new active volume starts with no tables at all (layers
    # above ``length`` are still all-zeros by construction)
    chain.length += can.to(torch.int32)
    chain.snap_dropped |= ~can
    return chain


# -- maintenance plane: merge, stream, compact, convert ----------------------


def snapshot_cost_model(spec: ChainSpec) -> dict:
    """Paper Eq. 2: per-snapshot metadata overhead of the scalable format.

    S_sq = S_vq + disk_size / cluster_size * l2_entry_size
    """
    l2_entry_size = fmt.ENTRY_WORDS * 4
    extra = spec.n_pages * l2_entry_size + spec.n_l1 * 4
    return dict(
        vanilla_bytes=spec.n_l1 * 4,     # header+L1 only (refcounts elided)
        scalable_bytes=spec.n_l1 * 4 + extra,
        extra_bytes=extra,
    )


def plan_merge(l2: torch.Tensor, merge_upto: int):
    """Owner-resolve layers ``[0, merge_upto]`` of one table stack.

    ``l2``: (C, n_pages, 2). Returns ``(merged (n_pages, 2), found
    (n_pages,) bool)``: per page, the entry of the topmost merged layer
    that has it allocated, layer 0's where none has (as
    ``jnp.take_along_axis`` at ``max(owner, 0)`` does in the JAX package,
    so the words match bit for bit). One launch of K9's word entry
    (``stream_merge.ops.merge_entries``) reads the merged layers' packed
    words in place and writes the plan: no plane copy, no gather.
    Table-level helper shared by ``stream`` and the fleet's
    ``stream_tenants``.
    """
    merged, found, _ = merge_ops.merge_entries(l2[:merge_upto + 1])
    return merged, found


def merge_tables(l1: torch.Tensor, l2: torch.Tensor, length: int,
                 merge_upto: int, *, scalable,
                 ptr_override: torch.Tensor | None = None, plan=None):
    """Merge layers ``[0, merge_upto]`` of one table stack into one base,
    in place.

    The table-level core of streaming, shared by ``stream`` and the
    fleet's ``stream_tenants`` (so chain and fleet semantics cannot drift).
    ``l1``: (C, n_l1); ``l2``: (C, n_pages, 2) — a chain's tables or one
    tenant's views into a fleet's; ``length`` is the concrete chain length.
    ``ptr_override``: optional (n_pages,) replacement pool rows for merged
    pages (the data-movement path); scalable upper-layer entries that
    reference a merged owner are rewritten to match. ``plan``: an already
    computed ``plan_merge(l2, merge_upto)``.

    Renumbering: the merged base takes bfi 0; upper layer ``s`` becomes
    ``s - merge_upto``, and upper entries pointing below the merge point
    collapse onto bfi 0. Every rewritten entry is repacked, which drops
    the ENCRYPTED and COLD bits as the JAX package does. Returns
    ``(l1, l2, new_length)`` with ``l1``/``l2`` the tensors given.
    """
    k = merge_upto + 1
    merged, found = plan_merge(l2, merge_upto) if plan is None else plan
    ptr = fmt.entry_ptr(merged) if ptr_override is None else ptr_override
    merged_entries = fmt.pack_entry(
        ptr, torch.zeros_like(ptr), allocated=found, bfi_valid=scalable,
        zero=fmt.entry_zero(merged),
    )

    n_upper = length - k
    upper_l2 = l2[k:k + n_upper]
    old_bfi = fmt.entry_bfi(upper_l2)
    new_bfi = (old_bfi - merge_upto).clamp(min=0)
    upper_alloc = fmt.entry_allocated(upper_l2)
    upper_valid = fmt.entry_bfi_valid(upper_l2)
    upper_ptr = fmt.entry_ptr(upper_l2)
    if ptr_override is not None:
        # Upper entries whose owner was merged must point at the new rows.
        # Only bfi-valid entries reference an ancestor's row; a vanilla
        # (bfi-invalid) allocated entry owns its page outright, and its
        # bfi field of 0 must not be mistaken for "points below".
        points_below = upper_alloc & upper_valid & (old_bfi <= merge_upto)
        upper_ptr = torch.where(points_below, ptr_override[None, :], upper_ptr)
    upper_l2 = fmt.pack_entry(
        upper_ptr, new_bfi, allocated=upper_alloc, bfi_valid=upper_valid,
        zero=fmt.entry_zero(upper_l2),
    )
    base_l1 = l1[:k].amax(dim=0)
    upper_l1 = l1[k:k + n_upper].clone()

    # every new value is computed above, so the shift down cannot read a
    # layer it already overwrote
    new_len = 1 + n_upper
    l2[0] = merged_entries
    l2[1:new_len] = upper_l2
    l2[new_len:] = 0
    l1[0] = base_l1
    l1[1:new_len] = upper_l1
    l1[new_len:] = 0
    return l1, l2, new_len


def _copy_rows(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> None:
    """``pool[dst] = pool[src]`` in chunks of ``_COPY_ROWS``, each chunk
    gathered before it is written. Correct wherever no chunk writes a row
    that a later chunk reads (both callers guarantee it)."""
    for lo in range(0, src.numel(), _COPY_ROWS):
        pool[dst[lo:lo + _COPY_ROWS]] = pool.index_select(0, src[lo:lo + _COPY_ROWS])


def stream(chain: Chain, merge_upto: int, *, copy_data: bool = True) -> Chain:
    """Compact layers ``[0, merge_upto]`` into a single base layer, in place.

    Host-side maintenance op (uses the concrete chain length).
    ``copy_data=True`` rewrites merged pages into fresh pool rows,
    modelling the real streaming job's data movement (the source of the
    paper's observed 100x guest-latency hit during streaming); ``False``
    merges metadata only (pool rows are immutable and global, so this is
    safe). The fresh rows lie at and above the cursor and every source row
    below it, so the copy never overlaps.

    On pool exhaustion the copy is dropped and the merge degrades to
    metadata-only, flagging ``overflow`` (the write path's contract), so a
    background scheduler can skip, compact and retry. The chain stays
    consistent either way.
    """
    spec = chain.spec
    length = int(chain.length)
    if not (0 <= merge_upto < length - 1):
        raise ValueError("can only merge strictly below the active volume")

    cursor = int(chain.pool_cursor)
    ptr_override = None
    plan = None
    if copy_data:
        plan = merged, found = plan_merge(chain.l2, merge_upto)
        ptr = fmt.entry_ptr(merged)
        n_live = int(found.sum())
        if cursor + n_live > spec.pool_capacity:
            chain.overflow.fill_(True)
        elif n_live:
            # rewrite surviving merged pages to fresh rows (data movement)
            live = torch.nonzero(found).flatten()          # ascending pages
            dst_rows = cursor + torch.arange(n_live, device=live.device)
            _copy_rows(chain.pool, ptr[live].to(torch.int64), dst_rows)
            ptr_override = ptr.clone()
            ptr_override[live] = dst_rows.to(ptr.dtype)
            cursor += n_live

    _, _, new_len = merge_tables(
        chain.l1, chain.l2, length, merge_upto,
        scalable=chain.scalable, ptr_override=ptr_override, plan=plan,
    )
    chain.pool_cursor.fill_(cursor)
    chain.length.fill_(new_len)
    # the dropped-snapshot flag is resolved only if streaming actually made
    # room (merge_upto=0 merges layer 0 into itself and shortens nothing)
    chain.snap_dropped &= new_len >= spec.max_chain
    return chain


def compact_pool(chain: Chain) -> Chain:
    """Garbage-collect the page pool, in place: keep only rows referenced
    by allocated L2 entries, remap pointers, reset the allocation cursor.

    Host-side maintenance op (like streaming). As in the JAX package,
    every row an *allocated* entry names is kept (ZERO and COLD entries
    included) and every live entry's ptr, allocated or not, is rewritten
    through the remap table. The kept rows move down to the front of the
    pool in ascending order (a kept row never moves up, so the chunked
    copy reads no row it already overwrote) and the rest of the pool is
    zeroed, which is the JAX package's fresh pool bit for bit without a
    second pool-sized tensor. Reads are unchanged.
    """
    spec = chain.spec
    length = int(chain.length)
    entries = chain.l2[:length]                       # (L, n_pages, 2)
    alloc = fmt.entry_allocated(entries)
    rows = fmt.entry_ptr(entries).to(torch.int64)
    used = torch.unique(rows[alloc])                  # sorted ascending
    n_used = int(used.numel())
    lut = torch.zeros(spec.pool_capacity, dtype=torch.int64, device=rows.device)
    lut[used] = torch.arange(n_used, device=rows.device)
    _copy_rows(chain.pool, used, torch.arange(n_used, device=rows.device))
    chain.pool[n_used:] = 0
    chain.l2[:length] = fmt.pack_entry(
        lut[rows], fmt.entry_bfi(entries), allocated=alloc,
        bfi_valid=fmt.entry_bfi_valid(entries), zero=fmt.entry_zero(entries),
    )
    chain.pool_cursor.fill_(n_used)
    # GC resolves pool overflow; snap_dropped is chain exhaustion and is
    # untouched (compaction frees rows, it doesn't shorten the chain)
    chain.overflow.fill_(False)
    return chain


def convert_to_scalable(chain: Chain) -> Chain:
    """Offline conversion of a vanilla-format chain to the scalable format,
    in place.

    Models the paper's image-conversion path for adoption (§5.1): resolves
    every page through the chain walk once and writes a fully flattened,
    bfi-stamped L1/L2 set into the active volume.
    """
    from repro_torch.core import resolve  # local import to avoid a cycle

    spec = chain.spec
    res = resolve.resolve_vanilla(
        chain, torch.arange(spec.n_pages, dtype=torch.int32, device=chain.l2.device))
    active = int(chain.length) - 1
    chain.l2[active] = fmt.pack_entry(
        res.ptr, res.owner, allocated=res.found, bfi_valid=True,
        zero=res.zero, cold=res.cold,
    )
    chain.l1[active] = res.found.reshape(spec.n_l1, spec.l2_per_table).any(
        dim=1).to(torch.int32)
    chain.scalable = True
    return chain
