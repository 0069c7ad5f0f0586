"""Paged KV cache with COW sequence forking — the fleet-backed serving plane
(PyTorch port of ``repro.kvcache.paged``).

vLLM-style block pool plus the paper's two designs at the block-table
level: **vanilla forks** (a forked sequence starts with an empty table and
resolves missing blocks by walking its fork chain — O(fork depth)) and
**scalable forks** (the parent's resolved table is copied forward with an
owner id per block — O(1)). Appending to a block owned by an ancestor
first copies it into a fresh pool block (cluster COW); pool blocks are
refcounted so shared prefixes are stored once.

**Fleet backing.** Every unfreed sequence occupies one tenant row of a
``core.fleet.ChainFleet`` whose page axis is ``max_blocks_per_seq`` and
whose L2 ``ptr`` field holds KV pool block ids; for vanilla caches chain
layer *i* of a tenant is the table of ancestor *i* on its fork path.
Fork is a per-tenant snapshot into a fresh tenant, COW-prepare is one
batched metadata stamp, and a decode step's tables come from ONE stacked
fleet resolve (the CUDA fleet kernels on the card). Writes by a node are
propagated to every tenant stack holding a copy of its layer (the
``_occupants`` registry), so the stacked index always resolves exactly
like the live parent-pointer walk, which survives as the numpy oracle
``_resolve_oracle``.

**Fused decode path.** ``prepare_step_fused`` derives the COW-prepare
decisions from a *narrow* resolve of just the batch's write columns and
returns a ``FusedStepPlan`` the fused attention kernel consumes directly,
walking the chain inside the decode step.

**Tiering.** A parked sequence's exclusively-owned KV blocks can spill to
host memory (``demote_seq``): the data leaves ``pool_k``/``pool_v`` (the
blocks return to the free list), the owning L2 entries are stamped with
the ``FLAG_COLD`` residency bit, and the stacked resolve reports the
cold positions. Promotion is lazy and on-demand: every table-producing
path (``prepare_step*``, ``batched_tables``, ``block_table``, the write
preps, ``fork``) calls ``promote_seq`` on involved sequences first, before
it resolves, so a resumed sequence pays its transfer on the first step it
actually joins. Shared-prefix blocks (refcount > 1) and blocks visible to
forked descendants never spill: exclusivity is what makes the host copy
the unique owner. The host copies are CPU tensors of the pool's dtype
(numpy has no bfloat16), verified bytewise on both transfers.

Never run ``fleet.stream_tenants``/``compact`` on this cache's fleet: it
is a metadata plane whose pool rows are refcounted KV block ids shared
across tenants by design, not leased rows.

**Golden prefixes.** ``register_golden`` freezes a sequence as a shared
base under a content hash of its resolved K/V; forks of it share its
blocks by refcount, and every write path, ``free_seq`` and ``demote_seq``
refuse or skip it until ``release_golden``. ``prepare_span``/
``advance_span`` prepare and commit a bulk write of a forked suffix
(``serve.paged_decode.paged_suffix_prefill``).

**Migration.** ``export_seq`` packs a live sequence's resolved K/V into a
self-contained blob (``seq_fingerprint`` is its mid-flight guard) and
``import_seq`` lands one as a fresh root, whatever the block size, pool
size or format flag.

Port notes: the pools are updated in place (``commit_pools`` adopts the
tensors a decode step updated), and the fleet is updated in place by
``core.fleet``. Digests hash raw bytes in the JAX package's order, so they
agree across the packages; a blob's K/V are CPU tensors (numpy has no
bfloat16).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import fleet as fleet_lib
from repro_torch.core import format as fmt
from repro_torch.device import as_device, dtype_name


class FusedStepPlan(NamedTuple):
    """Device inputs for one fused decode step (``prepare_step_fused``):
    the index references plus three (N,) host-assembled vectors — the only
    per-step host→device traffic on this path."""

    l2: torch.Tensor             # (T, C, P, 2) int32 — the stacked index
    chain_lengths: torch.Tensor  # (T,) int32 per-tenant chain length
    tenants: torch.Tensor        # (N,) int32 batch row → tenant row
    lengths: torch.Tensor        # (N,) int32 pre-advance sequence lengths
    write_blocks: torch.Tensor   # (N,) int32 COW-prepared in-step write target


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    block_size: int = 16
    n_blocks: int = 256
    max_blocks_per_seq: int = 64
    dtype: object = torch.bfloat16


@dataclasses.dataclass
class _Seq:
    sid: int
    table: np.ndarray        # (max_blocks,) int32 pool block or -1 (own layer)
    owner: np.ndarray        # (max_blocks,) int32 owning sid (bfi analogue)
    parent: Optional[int]
    length: int
    refs: set = dataclasses.field(default_factory=set)  # blocks we refcount
    freed: bool = False      # tombstone: freed but pinned by live children
    children: int = 0        # seqs (live or tombstoned) naming us as parent
    tenant: Optional[int] = None  # fleet row while unfreed; None once freed
    path: tuple = ()         # fork ancestry, root first, self last
    cold: set = dataclasses.field(default_factory=set)  # host-spilled blks
    golden: bool = False     # frozen shared-prefix base (register_golden)


#: Initial fleet geometry; both axes grow by doubling on demand.
_INIT_TENANTS = 8
_INIT_CHAIN = 8


def _fleet_tables(fleet, page_ids, method):
    """ONE stacked fleet resolve → (4, T, P) int32: per tenant row, the
    flat block table (-1 holes), the owner field (chain layer for the
    walk, bfi-sid for direct), the per-page lookup cost, and the tier
    residency bit."""
    res = fleet_lib.get_resolver(method)(fleet, page_ids)
    table = torch.where(res.found, res.ptr, -1)
    return torch.stack([table.to(torch.int32), res.owner.to(torch.int32),
                        res.lookups.to(torch.int32), res.cold.to(torch.int32)])


class PagedKVCache:
    def __init__(self, cfg: PagedKVConfig, *, scalable: bool = True,
                 resolver: str = "auto", device="cuda"):
        self.cfg = cfg
        self.scalable = scalable
        fleet_lib.get_resolver(resolver)   # fail fast on unknown methods
        self.resolver = resolver
        self.device = as_device(device)
        shape = (cfg.n_layers, cfg.n_blocks, cfg.block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        self.pool_k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._free = list(range(cfg.n_blocks - 1, -1, -1))
        self._ref = np.zeros(cfg.n_blocks, np.int32)
        self._reserved: set[int] = set()
        self._seqs: dict[int, _Seq] = {}
        self._next_sid = 0
        self.lookup_count = 0  # fork-chain index consultations (Fig 13 analogue)
        # the metadata plane: one tenant row per unfreed sequence
        self.fleet = fleet_lib.create(
            self._fleet_spec(_INIT_TENANTS, 1 if scalable else _INIT_CHAIN),
            scalable=scalable, device=self.device,
        )
        self._free_tenants = list(range(_INIT_TENANTS - 1, -1, -1))
        # node sid -> [(tenant, layer)] tenant stacks holding a live copy
        # of that node's table: the fan-out set of a COW-prepare stamp
        self._occupants: dict[int, list[tuple[int, int]]] = {}
        self._grid = None      # cached (T, P) page-id grid for the resolve
        # host tier: sid -> {block index -> (k, v) CPU tensors (L, bs, H, D)}
        # for sequences whose exclusive blocks were demoted (demote_seq)
        self._cold_kv: dict[int, dict[int, tuple]] = {}
        self.demoted_blocks = 0   # lifetime spills (tier metrics)
        self.promoted_blocks = 0  # lifetime un-spills
        # golden prefixes: sid -> content hash (register_golden); the
        # flagged sequences are frozen: forked, never written or freed
        self._golden: dict[int, str] = {}

    # -- fleet geometry -------------------------------------------------------

    def _fleet_spec(self, n_tenants: int, max_chain: int) -> fleet_lib.FleetSpec:
        p = self.cfg.max_blocks_per_seq
        return fleet_lib.FleetSpec(
            n_tenants=n_tenants,
            n_pages=p,
            page_size=1,             # metadata plane: KV data lives in pool_k/v
            max_chain=max_chain,
            pool_capacity=self.cfg.n_blocks,
            lease_quantum=self.cfg.n_blocks,   # lease allocator idle here
            l2_per_table=p,
            slice_len=1,
        )

    def _grow_fleet(self, *, n_tenants: int | None = None,
                    max_chain: int | None = None) -> None:
        """Double a fleet axis (tenant rows / chain depth), copying the
        stacked index into the larger geometry."""
        old = self.fleet
        t0, c0 = old.spec.n_tenants, old.spec.max_chain
        t1, c1 = n_tenants or t0, max_chain or c0
        nf = fleet_lib.create(self._fleet_spec(t1, c1), scalable=self.scalable,
                              device=self.device)
        nf.l1[:t0, :c0] = old.l1
        nf.l2[:t0, :c0] = old.l2
        nf.length[:t0] = old.length
        nf.scalable[:t0] = old.scalable
        nf.cold_count[:t0] = old.cold_count
        self.fleet = nf
        self._free_tenants = (list(range(t1 - 1, t0 - 1, -1))
                              + self._free_tenants)
        self._grid = None

    def _claim_tenant(self) -> int:
        if not self._free_tenants:
            self._grow_fleet(n_tenants=self.fleet.spec.n_tenants * 2)
        return self._free_tenants.pop()

    def _page_grid(self) -> torch.Tensor:
        spec = self.fleet.spec
        if self._grid is None or tuple(self._grid.shape) != (spec.n_tenants,
                                                             spec.n_pages):
            self._grid = torch.arange(
                spec.n_pages, dtype=torch.int32, device=self.device
            )[None].expand(spec.n_tenants, spec.n_pages)
        return self._grid

    def _resolve_all(self):
        """One stacked fleet resolve of every tenant's full block table;
        one device→host sync. Returns host (tables, owners, lookups,
        colds), each (T, P) int32."""
        # the ONE designed sync per decode step: everything downstream
        # (COW-prepare mask, attention tables) derives from this result
        out = np.array(_fleet_tables(self.fleet, self._page_grid(),  # fleetlint: disable=FL002
                                     self.resolver).cpu())
        return out[0], out[1], out[2], out[3]

    def _resolve_tenant(self, t: int):
        """Stacked fleet resolve restricted to one tenant row (a 1-tenant
        view of the same tensors), so single-sequence ops don't pay the
        fleet-wide O(T·C·P) resolve. Returns host (table, owner, lookups,
        cold), each (P,) int32."""
        view = fleet_lib.tenant_slice(self.fleet, t)
        grid = torch.arange(self.cfg.max_blocks_per_seq, dtype=torch.int32,
                            device=self.device)[None]
        # single-tenant admission/fork edge, not the per-step loop: the
        # decode path itself resolves through _resolve_all
        out = np.array(_fleet_tables(view, grid, self.resolver).cpu())  # fleetlint: disable=FL002
        return out[0, 0], out[1, 0], out[2, 0], out[3, 0]

    def _count_lookups(self, seq: _Seq, table_row: np.ndarray,
                       lookups_row: np.ndarray) -> int:
        # bit-compatible with the oracle's accounting: sequences the
        # oracle resolves directly (scalable format, or a vanilla root)
        # charge one consultation per resolved block; walked sequences
        # charge the per-block chain depth the resolver reports
        if self.scalable or seq.parent is None:
            return int(np.sum(table_row >= 0)) or 1
        return int(np.sum(lookups_row))

    # -- sequence lifecycle ---------------------------------------------------

    def new_seq(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        mb = self.cfg.max_blocks_per_seq
        # the claimed slot is already a clean length-1 chain with the
        # cache's format flag (free_seq ran free_tenant on it)
        t = self._claim_tenant()
        self._seqs[sid] = _Seq(
            sid, np.full(mb, -1, np.int32), np.full(mb, -1, np.int32),
            None, 0, tenant=t, path=(sid,),
        )
        self._occupants[sid] = [(t, 0)]
        return sid

    def fork(self, sid: int) -> int:
        parent = self._live_seq(sid)
        # a parked parent promotes first: the fork shares its table by
        # block id, and a spilled block's id is stale by definition
        if parent.cold:
            self.promote_seq(sid)
        child = self._next_sid
        self._next_sid += 1
        mb = self.cfg.max_blocks_per_seq
        tp, tc = parent.tenant, self._claim_tenant()
        if self.scalable:
            # sQEMU snapshot copy-forward: the child's table directly
            # indexes every ancestor-owned block; the fleet-side fork is a
            # plain row clone (depth stays 1 — O(1) resolution)
            shared = parent.table
            owner = np.where(shared >= 0, parent.owner, -1)
            owner = np.where((shared >= 0) & (owner < 0), sid, owner)
            self.fleet = fleet_lib.clone_tenant(self.fleet, tp, tc)
            seq = _Seq(child, shared.copy(), owner.astype(np.int32), None,
                       parent.length, tenant=tc, path=(child,))
            self._occupants[child] = [(tc, 0)]
            self.lookup_count += int(np.sum(shared >= 0)) or 1
        else:
            # vanilla: the child's tenant stack = the parent's + a fresh
            # empty active layer; the resolved view for the child's
            # refcounts comes from the fleet, not a host walk
            depth = len(parent.path)
            if depth >= self.fleet.spec.max_chain:
                self._grow_fleet(
                    max_chain=max(self.fleet.spec.max_chain * 2, depth + 1)
                )
            shared, _, lookups_r, _ = self._resolve_tenant(tp)
            self.lookup_count += self._count_lookups(parent, shared,
                                                     lookups_r)
            self.fleet = fleet_lib.fork_tenant(self.fleet, tp, tc)
            seq = _Seq(child, np.full(mb, -1, np.int32),
                       np.full(mb, -1, np.int32), sid, parent.length,
                       tenant=tc, path=parent.path + (child,))
            self._occupants[child] = [(tc, depth)]
            # live ancestors keep writing their layers; register the
            # child's copies so those writes propagate
            for i, anc_sid in enumerate(parent.path):
                anc = self._seqs.get(anc_sid)
                if anc is not None and not anc.freed:
                    self._occupants[anc_sid].append((tc, i))
            parent.children += 1
        # the child holds a reference on every shared block
        seq.refs = {int(b) for b in shared[shared >= 0]}
        for b in seq.refs:
            self._ref[b] += 1
        self._seqs[child] = seq
        return child

    def free_seq(self, sid: int) -> None:
        """Free a sequence, tombstoning it while forked children live.

        The refcounted blocks of a vanilla parent stay until its last
        descendant is freed, then the dead suffix of the chain is reaped
        at once. The fleet tenant row is released immediately: children
        resolve from their own copies of the ancestor layers.
        """
        seq = self._live_seq(sid)
        if seq.golden:
            raise ValueError(
                f"sequence {sid} is a registered golden prefix; call "
                "release_golden(sid) before freeing it"
            )
        seq.freed = True
        t = seq.tenant
        seq.tenant = None
        self.fleet = fleet_lib.free_tenant(self.fleet, t)
        self._free_tenants.append(t)
        # a freed node never writes again, and nothing may keep stamping
        # into its (soon reused) tenant row; its host-tier spill (exclusive
        # by construction) has no other reader and is dropped with it
        self._occupants.pop(sid, None)
        self._cold_kv.pop(sid, None)
        seq.cold.clear()
        for anc_sid in seq.path[:-1]:
            occ = self._occupants.get(anc_sid)
            if occ is not None:
                self._occupants[anc_sid] = [o for o in occ if o[0] != t]
        self._reap(seq)

    def _live_seq(self, sid: int) -> _Seq:
        seq = self._seqs[sid]
        if seq.freed:
            raise KeyError(f"sequence {sid} has been freed")
        return seq

    def _reap(self, seq: _Seq) -> None:
        # release freed nodes bottom-up: a node goes only when nothing
        # (live or tombstoned) still names it as parent
        while seq is not None and seq.freed and seq.children == 0:
            for b in seq.refs:
                self._ref[b] -= 1
                if self._ref[b] <= 0:
                    self._free.append(int(b))
                    self._ref[b] = 0
            del self._seqs[seq.sid]
            parent = (self._seqs.get(seq.parent)
                      if seq.parent is not None else None)
            if parent is not None:
                parent.children -= 1
            seq = parent

    # -- resolution: the retained numpy oracle --------------------------------

    def _resolve_oracle(self, sid: int):
        """Host-side per-sequence walk — the retained numpy reference the
        fleet plane is asserted bit-identical against. Pure. Returns
        ``(table, owner, lookups)``."""
        seq = self._seqs[sid]
        if self.scalable or seq.parent is None:
            lookups = int(np.sum(seq.table >= 0)) or 1
            return seq.table, seq.owner, lookups
        mb = self.cfg.max_blocks_per_seq
        table = np.full(mb, -1, np.int32)
        owner = np.full(mb, -1, np.int32)
        lookups = 0
        for b in range(mb):
            node: Optional[int] = sid
            while node is not None:
                nseq = self._seqs[node]
                lookups += 1
                if nseq.table[b] >= 0:
                    table[b] = nseq.table[b]
                    owner[b] = nseq.owner[b] if nseq.owner[b] >= 0 else node
                    break
                node = nseq.parent
        return table, owner, lookups

    # -- fleet-backed table materialization -----------------------------------

    def block_table(self, sid: int) -> torch.Tensor:
        """Direct block table for the attention kernel (fleet-resolved).
        Promotes the sequence first if any of its blocks are host-spilled
        (a stale cold block id must never reach the kernel)."""
        seq = self._live_seq(sid)
        if seq.cold:
            self.promote_seq(sid)
        table_r, _, lookups_r, _ = self._resolve_tenant(seq.tenant)
        self.lookup_count += self._count_lookups(seq, table_r, lookups_r)
        return torch.as_tensor(table_r, device=self.device)

    def _check_pad(self, n_sids: int, pad_to: int,
                   pad_block: int | None) -> None:
        if max(n_sids, pad_to) > n_sids and pad_block is None:
            raise ValueError(
                "padding rows need an explicit pad_block reserved via "
                "reserve_block(); a default of 0 would alias a live block"
            )
        if pad_block is not None and pad_block not in self._reserved:
            raise ValueError(
                f"pad_block {pad_block} was not reserved via reserve_block(); "
                "the decode step would scribble K/V into a live block"
            )

    def _assemble(self, sids, tables: np.ndarray, pad_to: int,
                  pad_block: int | None):
        """Stack per-tenant resolved rows into ONE (N, max_blocks) table +
        (N,) lengths and ship them in a single host→device transfer."""
        n = max(len(sids), pad_to)
        # without a reserved scratch block, -1 holes stay -1: rewriting
        # them to a real block id would alias it for the in-step scatter
        fill = -1 if pad_block is None else pad_block
        mb = self.cfg.max_blocks_per_seq
        out = np.full((n, mb + 1), fill, np.int32)
        out[:, mb] = 0
        for i, sid in enumerate(sids):
            seq = self._seqs[sid]
            row = tables[seq.tenant]
            out[i, :mb] = np.where(row >= 0, row, fill)
            out[i, mb] = seq.length
        dev = torch.as_tensor(out, device=self.device)
        return dev[:, :mb].contiguous(), dev[:, mb].contiguous()

    def batched_tables(self, sids, *, pad_to: int = 0,
                       pad_block: int | None = None):
        """ONE stacked fleet resolve covers every sequence, and one stacked
        (N, max_blocks) table + (N,) lengths ship to the device. Rows
        beyond ``len(sids)`` (up to ``pad_to``) are filled with
        ``pad_block`` — a block taken out of circulation by
        ``reserve_block()`` — and length 0."""
        self._check_pad(len(sids), pad_to, pad_block)
        for sid in sids:
            self._live_seq(sid)          # freed sequences must raise
        self._promote_cold(sids)
        tables, _, lookups = self._resolve_all()[:3]
        for sid in sids:
            seq = self._seqs[sid]
            self.lookup_count += self._count_lookups(
                seq, tables[seq.tenant], lookups[seq.tenant])
        return self._assemble(sids, tables, pad_to, pad_block)

    def reserve_block(self) -> int:
        """Permanently take one pool block out of circulation (a scratch
        target for padded batch rows). Excluded from ``blocks_in_use``."""
        b = self._pop_free()
        self._reserved.add(b)
        return b

    # -- writes ----------------------------------------------------------------

    def _pop_free(self) -> int:
        if not self._free:
            raise RuntimeError("KV pool exhausted")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def _alloc(self, seq: _Seq) -> int:
        b = self._pop_free()
        seq.refs.add(b)
        return b

    def _patch(self, tables: np.ndarray, owners: np.ndarray, seq: _Seq,
               blk: int, nb: int, row_map: dict | None,
               col_map: dict | None = None) -> None:
        """Mirror one stamp into the host copy of the resolve maps, so
        later sequences in the same batch observe it exactly as the
        sequential host path did. ``row_map`` maps tenant ids to rows of
        ``tables``/``owners`` (None: identity); ``col_map`` maps logical
        block indexes to columns (None: identity)."""
        def row(t: int):
            return t if row_map is None else row_map.get(t)

        col = blk if col_map is None else col_map[blk]
        if self.scalable:
            r = row(seq.tenant)
            if r is not None:
                tables[r, col] = nb
                owners[r, col] = seq.sid
            return
        for t, layer in self._occupants[seq.sid]:
            r = row(t)
            if r is not None and owners[r, col] <= layer:
                tables[r, col] = nb
                owners[r, col] = layer

    def _copy_blocks(self, src: list[int], dst: list[int]) -> None:
        """Batched COW data movement with *sequential* semantics.

        One gather/scatter reads every source before any write (the
        right-hand side is materialized first). That matches running the
        copies one by one in list order, except when a copy's source is a
        block an earlier copy in the batch wrote; the batch is flushed at
        each such read-after-write point (a new wave)."""
        group_s: list[int] = []
        group_d: list[int] = []

        def flush():
            if not group_s:
                return
            idx = torch.as_tensor([group_s, group_d], device=self.device)
            self.pool_k[:, idx[1]] = self.pool_k[:, idx[0]]
            self.pool_v[:, idx[1]] = self.pool_v[:, idx[0]]
            group_s.clear()
            group_d.clear()

        for s, d in zip(src, dst):
            if s in group_d:          # reads a block this batch writes
                flush()
            group_s.append(s)
            group_d.append(d)
        flush()

    def _prepare_block(self, seq: _Seq, blk: int, tables: np.ndarray,
                       owners: np.ndarray, row_map: dict | None,
                       writes: list, cow_src: list, cow_dst: list, *,
                       col_map: dict | None = None,
                       copy_data: bool = True) -> None:
        """The COW-prepare protocol for ONE (sequence, block) site: fresh
        alloc / COW with refcount release / owned no-op, plus the stamp
        bookkeeping and host-map patch. ``copy_data=False`` skips the data
        copy of a COW (a fully covered block is overwritten anyway)."""
        row = seq.tenant if row_map is None else row_map[seq.tenant]
        col = blk if col_map is None else col_map[blk]
        cur = int(tables[row, col])
        owns = seq.table[blk] >= 0 and seq.owner[blk] in (-1, seq.sid)
        if cur < 0:
            nb = self._alloc(seq)
        elif not owns:
            # COW: the block belongs to an ancestor — copy before write
            nb = self._alloc(seq)
            if copy_data:
                cow_src.append(cur)
                cow_dst.append(nb)
            if cur in seq.refs:
                seq.refs.discard(cur)
                self._ref[cur] -= 1
                if self._ref[cur] <= 0:
                    self._free.append(cur)
                    self._ref[cur] = 0
        else:
            nb = int(seq.table[blk])
        if nb != cur:
            writes.append((seq.sid, blk, nb))
            self._patch(tables, owners, seq, blk, nb, row_map, col_map)
        seq.table[blk] = nb
        seq.owner[blk] = seq.sid

    def _prepare_against(self, sids, tables: np.ndarray, owners: np.ndarray,
                         row_map: dict | None = None,
                         col_map: dict | None = None
                         ) -> list[tuple[int, int, int]]:
        """COW-prepare the next-token slot of every sid against the synced
        resolve maps; returns the stamp list ``[(sid, blk, new_block)]``."""
        bs = self.cfg.block_size
        writes: list[tuple[int, int, int]] = []
        cow_src: list[int] = []
        cow_dst: list[int] = []
        for sid in sids:
            seq = self._live_seq(sid)
            self._check_writable(seq)
            blk = seq.length // bs
            if blk >= self.cfg.max_blocks_per_seq:
                raise RuntimeError(f"sequence {sid} is at max_blocks_per_seq")
            self._prepare_block(seq, blk, tables, owners, row_map,
                                writes, cow_src, cow_dst, col_map=col_map)
        self._copy_blocks(cow_src, cow_dst)
        return writes

    @staticmethod
    def _check_writable(seq: _Seq) -> None:
        if seq.golden:
            raise RuntimeError(
                f"sequence {seq.sid} is a registered golden prefix and is "
                "frozen; fork it to continue decoding"
            )

    def _stamp_fleet(self, writes: list[tuple[int, int, int]]) -> None:
        """One batched fleet stamp for a step's COW-prepares: each write
        fans out to every tenant stack holding a copy of the writer's
        layer (``_occupants``)."""
        if not writes:
            return
        ts, ls, ps, w0s, w1s = [], [], [], [], []
        for sid, blk, nb in writes:
            if self.scalable:
                # bfi carries the owning sid as a diagnostic (16 bits):
                # sids past 2^16 wrap harmlessly — tables read only
                # ptr/ALLOCATED/BFI_VALID
                w1 = fmt.FLAG_BFI_VALID | (sid & fmt.BFI_MASK)
            else:
                w1 = 0                       # vanilla images leave word1 = 0
            for t, layer in self._occupants[sid]:
                ts.append(t)
                ls.append(layer)
                ps.append(blk)
                w0s.append(fmt.FLAG_ALLOCATED | nb)
                w1s.append(w1)
        ent = np.stack([np.asarray(w0s, np.uint32),
                        np.asarray(w1s, np.uint32)], axis=-1)
        self.fleet = fleet_lib.stamp_entries(self.fleet, ts, ls, ps, ent)

    def prepare_write(self, sid: int) -> int:
        """Make the block receiving the next token writable by ``sid``
        (COW-copying an ancestor-owned block or allocating a fresh one);
        returns the pool block. Commit with ``advance``."""
        seq = self._live_seq(sid)
        if seq.cold:
            self.promote_seq(sid)
        table_r, owner_r, lookups_r, _ = self._resolve_tenant(seq.tenant)
        self.lookup_count += self._count_lookups(seq, table_r, lookups_r)
        writes = self._prepare_against([sid], table_r[None], owner_r[None],
                                       row_map={seq.tenant: 0})
        self._stamp_fleet(writes)
        return int(seq.table[seq.length // self.cfg.block_size])

    def prepare_step_single(self, sid: int, *, pad_to: int = 1,
                            pad_block: int | None = None):
        """``prepare_step`` for a batch of ONE: a narrow (single tenant
        row) resolve drives both the COW-prepare and the table, O(C·P)
        instead of O(T·C·P). Bit-identical to ``prepare_step([sid], ...)``."""
        self._check_pad(1, pad_to, pad_block)
        seq = self._live_seq(sid)
        if seq.cold:
            self.promote_seq(sid)
        table_r, owner_r, lookups_r, _ = self._resolve_tenant(seq.tenant)
        self.lookup_count += self._count_lookups(seq, table_r, lookups_r)
        writes = self._prepare_against([sid], table_r[None], owner_r[None],
                                       row_map={seq.tenant: 0})
        self._stamp_fleet(writes)
        # table_r was patched in place through its [None] view
        return self._assemble([sid], {seq.tenant: table_r}, max(1, pad_to),
                              pad_block)

    def prepare_step(self, sids, *, pad_to: int = 0,
                     pad_block: int | None = None):
        """COW-prepare + table materialization for one decode step, all
        from ONE stacked fleet resolve: derive each sequence's COW-prepare
        decision from the synced result, stamp the prepared slots back in
        one batched write, and return the *post-prepare* ``(tables,
        lengths)`` padded like ``batched_tables``. ``advance`` each sid
        after the decode step commits its token."""
        self._check_pad(len(sids), pad_to, pad_block)
        self._promote_cold(sids)
        tables, owners, lookups, _ = self._resolve_all()
        for sid in sids:
            seq = self._live_seq(sid)
            self.lookup_count += self._count_lookups(
                seq, tables[seq.tenant], lookups[seq.tenant])
        writes = self._prepare_against(sids, tables, owners)
        self._stamp_fleet(writes)
        return self._assemble(sids, tables, pad_to, pad_block)

    def prepare_step_fused(self, sids, *, pad_to: int = 0,
                           pad_block: int | None = None) -> FusedStepPlan:
        """COW-prepare for one decode step *without* materializing block
        tables. The fused kernel walks the stacked index on the device, so
        the host needs the resolve only at the batch's **write columns**:
        that narrow resolve is this path's ONE designed sync per step.

        Padded rows (up to ``pad_to``) get tenant 0 with length 0 and
        scatter their in-step K/V write into the reserved ``pad_block``.
        ``lookup_count`` is charged from the host mirrors for scalable
        rows and parentless roots and with the narrow resolve's actual
        consultations for walked forks.
        """
        self._check_pad(len(sids), pad_to, pad_block)
        self._promote_cold(sids)
        bs = self.cfg.block_size
        cols = sorted({self._live_seq(sid).length // bs for sid in sids})
        # pad the column batch to the step's batch bucket, so the narrow
        # resolve keeps one shape while sequences cross block boundaries
        k = 1
        while k < max(len(cols), pad_to):
            k *= 2
        ids = np.zeros(k, np.int32)
        ids[:len(cols)] = cols
        grid = torch.as_tensor(ids, device=self.device)[None].expand(
            self.fleet.spec.n_tenants, k)
        # the fused path's ONE designed sync per step: the narrow
        # write-column resolve REPLACES _resolve_all's full-table sync
        out = np.array(_fleet_tables(self.fleet, grid,  # fleetlint: disable=FL002
                                     self.resolver).cpu())
        tables, owners, lookups = out[0], out[1], out[2]
        col_map = {c: i for i, c in enumerate(cols)}
        for sid in sids:
            seq = self._seqs[sid]
            if self.scalable or seq.parent is None:
                self.lookup_count += int(np.sum(seq.table >= 0)) or 1
            else:
                self.lookup_count += int(
                    lookups[seq.tenant, col_map[seq.length // bs]])
        writes = self._prepare_against(sids, tables, owners,
                                       col_map=col_map)
        self._stamp_fleet(writes)
        n = max(len(sids), pad_to)
        vecs = np.zeros((3, n), np.int32)      # tenants, lengths, write blocks
        vecs[2] = pad_block if pad_block is not None else 0
        for i, sid in enumerate(sids):
            seq = self._seqs[sid]
            vecs[:, i] = (seq.tenant, seq.length, seq.table[seq.length // bs])
        dev = torch.as_tensor(vecs, device=self.device)
        return FusedStepPlan(
            l2=self.fleet.l2,
            chain_lengths=self.fleet.length,
            tenants=dev[0],
            lengths=dev[1],
            write_blocks=dev[2],
        )

    def commit_pools(self, pool_k: torch.Tensor, pool_v: torch.Tensor) -> None:
        """Adopt the KV pools returned by an external decode step. The
        cache owns ``pool_k``/``pool_v`` (FL004); the port's decode steps
        update them in place and hand the same tensors back here."""
        if pool_k.shape != self.pool_k.shape or pool_v.shape != self.pool_v.shape:
            raise ValueError(
                f"commit_pools: shape mismatch {tuple(pool_k.shape)}/"
                f"{tuple(pool_v.shape)} vs cache pools {tuple(self.pool_k.shape)}")
        self.pool_k = pool_k
        self.pool_v = pool_v

    def advance(self, sid: int) -> None:
        """Commit one token written externally into a slot set up by
        ``prepare_write``/``prepare_step``."""
        seq = self._live_seq(sid)
        blk_idx = seq.length // self.cfg.block_size
        if seq.table[blk_idx] < 0 or seq.owner[blk_idx] != sid:
            raise RuntimeError(
                f"sequence {sid} has no prepared slot at position "
                f"{seq.length}; call prepare_write(sid) before advance(sid)"
            )
        seq.length += 1

    def append(self, sid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one token's K/V. k, v: (L, n_kv_heads, head_dim)."""
        seq = self._live_seq(sid)
        off = seq.length % self.cfg.block_size
        nb = self.prepare_write(sid)
        self.pool_k[:, nb, off] = k.to(self.cfg.dtype)
        self.pool_v[:, nb, off] = v.to(self.cfg.dtype)
        self.advance(sid)

    def append_prefill(self, sid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Bulk append. k, v: (L, T, n_kv_heads, head_dim).

        One fleet resolve + one batched stamp + one pool scatter for the
        whole prompt: blocks fully covered by the span are allocated fresh
        without a COW data copy; only a shared first block with a live
        partial prefix pays the copy.
        """
        seq = self._live_seq(sid)
        self._check_writable(seq)
        nt = int(k.shape[1])
        if nt == 0:
            return
        bs = self.cfg.block_size
        start, end = seq.length, seq.length + nt
        if (end - 1) // bs >= self.cfg.max_blocks_per_seq:
            raise RuntimeError(f"sequence {sid} is at max_blocks_per_seq")
        if seq.cold:
            self.promote_seq(sid)
        table_r, owner_r, lookups_r, _ = self._resolve_tenant(seq.tenant)
        self.lookup_count += self._count_lookups(seq, table_r, lookups_r)
        tables, owners = table_r[None], owner_r[None]
        row_map = {seq.tenant: 0}
        writes: list[tuple[int, int, int]] = []
        cow_src: list[int] = []
        cow_dst: list[int] = []
        for blk in range(start // bs, (end - 1) // bs + 1):
            self._prepare_block(
                seq, blk, tables, owners, row_map,
                writes, cow_src, cow_dst,
                copy_data=blk == start // bs and bool(start % bs),
            )
        self._copy_blocks(cow_src, cow_dst)
        self._stamp_fleet(writes)
        pos = np.arange(start, end)
        slots = torch.as_tensor(np.stack([seq.table[pos // bs], pos % bs]),
                                device=self.device)
        self.pool_k[:, slots[0], slots[1]] = k.to(self.cfg.dtype)
        self.pool_v[:, slots[0], slots[1]] = v.to(self.cfg.dtype)
        seq.length = end

    def prepare_span(self, sid: int, n: int):
        """COW-prepare the next ``n`` token slots of one sequence for an
        external bulk write (``serve.paged_decode.paged_suffix_prefill``).

        The prepare phase of ``append_prefill`` without the data: one
        host-side resolve, the per-block COW protocol (only a shared
        partial first block pays a data copy), one batched stamp. The
        resolve is the retained host oracle, not a fleet dispatch: this is
        the single-sequence admission edge, where a device round trip per
        admitted request would dominate the fork it prepares, and the
        oracle is bit-identical to the fleet resolve. Returns ``(table,
        blocks, offsets)``: the sequence's post-prepare resolved table
        (``(max_blocks,)`` int32, -1 holes) and the pool slot of each of
        the ``n`` positions. Commit with ``advance_span`` after the
        external scatter lands.
        """
        seq = self._live_seq(sid)
        self._check_writable(seq)
        if n <= 0:
            raise ValueError(f"prepare_span needs n >= 1, got {n}")
        bs = self.cfg.block_size
        start, end = seq.length, seq.length + n
        if (end - 1) // bs >= self.cfg.max_blocks_per_seq:
            raise RuntimeError(f"sequence {sid} is at max_blocks_per_seq")
        if seq.cold:
            self.promote_seq(sid)
        table_r, owner_r, lookups = self._resolve_oracle(sid)
        self.lookup_count += lookups
        # the oracle may return the live host mirrors themselves: copy so
        # the patched view (and the returned table) never alias cache state
        table_r = np.array(table_r, dtype=np.int32)
        owner_r = np.array(owner_r, dtype=np.int32)
        tables, owners = table_r[None], owner_r[None]
        row_map = {seq.tenant: 0}
        writes: list[tuple[int, int, int]] = []
        cow_src: list[int] = []
        cow_dst: list[int] = []
        for blk in range(start // bs, (end - 1) // bs + 1):
            self._prepare_block(
                seq, blk, tables, owners, row_map,
                writes, cow_src, cow_dst,
                copy_data=blk == start // bs and bool(start % bs),
            )
        self._copy_blocks(cow_src, cow_dst)
        self._stamp_fleet(writes)
        pos = np.arange(start, end)
        return (table_r, seq.table[pos // bs].astype(np.int32),
                (pos % bs).astype(np.int32))

    def advance_span(self, sid: int, n: int) -> None:
        """Commit ``n`` tokens written externally into slots set up by
        ``prepare_span`` (the suffix-prefill scatter)."""
        seq = self._live_seq(sid)
        bs = self.cfg.block_size
        for p in range(seq.length, seq.length + n):
            blk = p // bs
            if seq.table[blk] < 0 or seq.owner[blk] != sid:
                raise RuntimeError(
                    f"sequence {sid} has no prepared slot at position {p}; "
                    f"call prepare_span(sid, n) before advance_span"
                )
        seq.length += n

    # -- tiering: host spill of parked sequences' exclusive blocks -------------

    def _promote_cold(self, sids) -> None:
        """Lazy promotion hook: un-spill every involved sequence *before*
        the table-producing fleet resolve (promotion mutates the fleet,
        so it must not run against an already-synced result)."""
        for sid in sids:
            if self._seqs[sid].cold:
                self.promote_seq(sid)

    def _demotable_blocks(self, seq: _Seq) -> list[int]:
        """Logical block indexes of ``seq`` that may spill to host.

        A block is demotable only when this sequence is provably its sole
        reader: the entry sits in the sequence's own layer (``owner`` is
        self), the pool block is refcounted exactly once *by this
        sequence*, no other tenant stack holds a copy of any of this
        node's layers (vanilla post-fork writes are stamped into
        descendants' stacks without a refcount, so the refcount alone
        cannot prove exclusivity), and it is not the active tail block
        still receiving tokens — the COW-layer analogue of the fleet
        rule that only immutable snapshot layers demote.
        """
        if any(t != seq.tenant for t, _ in self._occupants[seq.sid]):
            return []
        active = seq.length // self.cfg.block_size
        out = []
        for blk in range(self.cfg.max_blocks_per_seq):
            b = int(seq.table[blk])
            if (b >= 0 and blk != active and blk not in seq.cold
                    and seq.owner[blk] in (-1, seq.sid)
                    and b in seq.refs and int(self._ref[b]) == 1):
                out.append(blk)
        return out

    def _stamp_cold(self, seq: _Seq, blks: list[int]) -> None:
        """Mark ``seq``'s entries for ``blks`` host-resident: rewrite each
        with ``FLAG_COLD`` set, keeping the (now stale) block id in the
        ptr field as a breadcrumb. ``_demotable_blocks`` guarantees every
        copy of the layer lives in the sequence's own tenant stack."""
        w1 = (fmt.FLAG_BFI_VALID | (seq.sid & fmt.BFI_MASK)) if self.scalable else 0
        sites = [(t, layer, blk) for t, layer in self._occupants[seq.sid]
                 for blk in blks]
        ent = np.asarray(
            [(fmt.FLAG_ALLOCATED | fmt.FLAG_COLD | int(seq.table[blk]), w1)
             for _, _, blk in sites], np.uint32)
        ts, ls, ps = (np.asarray(col, np.int64) for col in zip(*sites))
        self.fleet = fleet_lib.stamp_entries(self.fleet, ts, ls, ps, ent)

    def _pool_rows(self, sel: torch.Tensor):
        """Host copies of the pool blocks ``sel`` (K and V)."""
        return self.pool_k[:, sel].cpu(), self.pool_v[:, sel].cpu()

    def demote_seq(self, sid: int, *, max_blocks: int | None = None,
                   verify: bool = True) -> int:
        """Spill a parked sequence's exclusively-owned blocks to host.

        Moves the K/V data of every demotable block (``_demotable_blocks``)
        out of ``pool_k``/``pool_v`` in one batched device→host transfer,
        returns the pool blocks to the free list, and stamps the owning
        fleet entries with ``FLAG_COLD`` so the stacked resolve reports
        the positions host-resident. ``verify`` re-reads the device copy
        before the blocks are released and requires it bit-identical to
        the staged host bytes. The sequence stays live throughout: any
        later table-producing call promotes it transparently. Returns
        the number of blocks spilled.
        """
        seq = self._live_seq(sid)
        if seq.golden:
            # a golden base's blocks back live forks bit-for-bit
            return 0
        blks = self._demotable_blocks(seq)
        if max_blocks is not None:
            blks = blks[:max_blocks]
        if not blks:
            return 0
        bids = [int(seq.table[blk]) for blk in blks]
        sel = torch.as_tensor(bids, dtype=torch.int64, device=self.device)
        ks, vs = self._pool_rows(sel)
        if verify:
            k2, v2 = self._pool_rows(sel)
            if not (fleet_lib._same_bytes(ks, k2) and fleet_lib._same_bytes(vs, v2)):
                raise RuntimeError(f"demote_seq({sid}): device read not stable")
        host = self._cold_kv.setdefault(sid, {})
        for i, blk in enumerate(blks):
            host[blk] = (ks[:, i], vs[:, i])
            seq.cold.add(blk)
        self._stamp_cold(seq, blks)
        for b in bids:
            seq.refs.discard(b)
            self._ref[b] = 0
            self._free.append(b)
        self.demoted_blocks += len(blks)
        return len(blks)

    def promote_seq(self, sid: int) -> int:
        """Un-spill every host-resident block of a sequence.

        Allocates fresh pool blocks, restores the K/V data in one batched
        host→device scatter, bit-verifies the landed bytes against the
        host copy, and stamps the entries hot again through the normal
        write protocol (which clears ``FLAG_COLD``). This is what a
        resumed sequence pays, lazily, on the first decode step it
        actually joins. Returns the number of blocks promoted.
        """
        seq = self._live_seq(sid)
        if not seq.cold:
            return 0
        blks = sorted(seq.cold)
        host = self._cold_kv[sid]
        nbs = [self._alloc(seq) for _ in blks]
        sel = torch.as_tensor(nbs, dtype=torch.int64, device=self.device)
        ks = torch.stack([host[blk][0] for blk in blks], dim=1)
        vs = torch.stack([host[blk][1] for blk in blks], dim=1)
        self.pool_k[:, sel] = ks.to(self.device)
        self.pool_v[:, sel] = vs.to(self.device)
        # bit-verify readback on the (rare) promote-on-resume edge — the
        # residency contract, not a per-step cost
        back_k, back_v = self._pool_rows(sel)  # fleetlint: disable=FL002
        if not (fleet_lib._same_bytes(ks, back_k) and fleet_lib._same_bytes(vs, back_v)):
            raise RuntimeError(
                f"promote_seq({sid}): host→device transfer corrupted data")
        writes = []
        for blk, nb in zip(blks, nbs):
            seq.table[blk] = nb
            host.pop(blk)
            writes.append((seq.sid, blk, nb))
        seq.cold.clear()
        if not host:
            self._cold_kv.pop(sid, None)
        self._stamp_fleet(writes)
        self.promoted_blocks += len(blks)
        return len(blks)

    def host_blocks_in_use(self) -> int:
        """Blocks currently resident in the host tier (spilled K/V)."""
        return sum(len(d) for d in self._cold_kv.values())

    # -- golden prefixes: content-addressed shared-base registration -----------

    def register_golden(self, sid: int) -> str:
        """Freeze a sequence as a golden shared-prefix base.

        Promotes any spilled blocks first (a base must stay fully
        device-resident: its block ids back every fork bit for bit), then
        computes the content address: a sha256 over the length (int64)
        and the sequence's *resolved* K then V bytes in ``gather``'s
        (L, T, Hkv, D) C order, so two prefixes hash equal exactly when
        their cached state is bit-identical, whatever the fork topology or
        block placement. A registered base is frozen: every write path and
        ``free_seq`` refuse it, and ``demote_seq`` skips it, until
        ``release_golden``. Forking it stays the normal ``fork``.
        Idempotent for an already-registered sid. Returns the content hash.
        """
        seq = self._live_seq(sid)
        if sid in self._golden:
            return self._golden[sid]
        if seq.length == 0:
            raise ValueError(f"sequence {sid} is empty; nothing to register")
        if seq.cold:
            self.promote_seq(sid)
        k, v = self.gather(sid)
        h = hashlib.sha256()
        h.update(np.asarray([seq.length], np.int64).tobytes())
        h.update(_raw_bytes(k))
        h.update(_raw_bytes(v))
        digest = h.hexdigest()
        seq.golden = True
        self._golden[sid] = digest
        return digest

    def release_golden(self, sid: int) -> str:
        """Un-freeze a golden base, returning its content hash. The
        sequence becomes an ordinary live sequence again (writable,
        freeable, demotable); forks taken while it was golden keep their
        shared blocks alive through the usual refcounts."""
        if sid not in self._golden:
            raise KeyError(f"sequence {sid} is not a registered golden prefix")
        digest = self._golden.pop(sid)
        self._seqs[sid].golden = False
        return digest

    def is_golden(self, sid: int) -> bool:
        return sid in self._golden

    def golden_stats(self) -> dict:
        """Dedup accounting of the registered golden bases.

        ``golden_blocks``: distinct pool blocks referenced by golden
        sequences. ``golden_blocks_shared``: the subset whose refcount
        exceeds one, the blocks live forks alias right now.
        ``dedup_blocks_saved``: sum over golden blocks of ``ref - 1``, the
        pool blocks a dedup-free serving plane would additionally hold to
        back the same set of sequences.
        """
        blocks: set[int] = set()
        for sid in self._golden:
            blocks |= self._seqs[sid].refs
        shared = sum(1 for b in blocks if int(self._ref[b]) > 1)
        saved = sum(int(self._ref[b]) - 1 for b in blocks)
        return dict(
            golden_seqs=len(self._golden),
            golden_blocks=len(blocks),
            golden_blocks_shared=shared,
            dedup_blocks_saved=saved,
        )

    # -- reads (reference path; kernels/paged_attention is the fast path) ------

    def gather(self, sid: int):
        """Materialize (L, T, H, D) K/V for a sequence (test oracle).
        Spilled blocks read straight from the host tier: the oracle must
        not perturb residency by promoting."""
        seq = self._live_seq(sid)
        table, _, _ = self._resolve_oracle(sid)
        bs = self.cfg.block_size
        n_blk = -(-seq.length // bs) if seq.length else 0
        L, H, D = self.cfg.n_layers, self.cfg.n_kv_heads, self.cfg.head_dim
        blocks = torch.as_tensor(np.asarray(table[:n_blk], np.int64),
                                 device=self.device)
        k = self.pool_k[:, blocks]                     # (L, n_blk, bs, H, D)
        v = self.pool_v[:, blocks]
        for b, (hk, hv) in self._cold_kv.get(sid, {}).items():
            if b < n_blk:
                k[:, b] = hk.to(self.device)
                v[:, b] = hv.to(self.device)
        k = k.reshape(L, n_blk * bs, H, D)[:, :seq.length]
        v = v.reshape(L, n_blk * bs, H, D)[:, :seq.length]
        return k, v

    def seq_length(self, sid: int) -> int:
        return self._seqs[sid].length

    # -- live migration: move a sequence's KV state between caches -------------

    def seq_fingerprint(self, sid: int) -> str:
        """Digest of everything about a live sequence that a decode step,
        append, spill or promotion could change: the mid-flight guard for
        ``export_seq``. A fork of the sequence does *not* change it (COW:
        the parent's data is untouched)."""
        seq = self._live_seq(sid)
        h = hashlib.sha256()
        h.update(np.asarray([seq.length], np.int64).tobytes())
        h.update(np.ascontiguousarray(seq.table).tobytes())
        h.update(np.ascontiguousarray(seq.owner).tobytes())
        h.update(np.asarray(sorted(seq.cold), np.int64).tobytes())
        return h.hexdigest()

    def export_seq(self, sid: int) -> dict:
        """Pack a live sequence into a portable, self-contained blob.

        The K/V payload is *resolved*, read back through the fork chain
        and the host tier, so the blob depends on no other sequence. Pure
        read: spilled blocks are served from the host tier, not promoted.
        ``k``/``v`` are (L, T, Hkv, D) CPU tensors of the pool's dtype;
        ``dtype`` is its name as numpy spells it (``"bfloat16"``,
        ``"float32"``), as in the JAX package.
        """
        cfg = self.cfg
        k, v = self.gather(sid)
        return dict(
            n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim,
            dtype=dtype_name(cfg.dtype),
            length=self._live_seq(sid).length,
            k=k.cpu(),
            v=v.cpu(),
            fingerprint=self.seq_fingerprint(sid),
        )

    def import_seq(self, blob: dict) -> int:
        """Land an exported sequence in this cache as a fresh root.

        The migrated sequence arrives with no parent: its resolved prefix
        is bulk-appended (``append_prefill``), so its blocks are
        exclusively owned here. Block size, pool size and format flag may
        all differ from the source cache; the model geometry must match.
        ``blob["k"]``/``["v"]`` may be tensors or numpy arrays.
        """
        cfg = self.cfg
        for field in ("n_layers", "n_kv_heads", "head_dim"):
            if blob[field] != getattr(cfg, field):
                raise ValueError(
                    f"imported sequence disagrees on {field}: blob has "
                    f"{blob[field]}, cache has {getattr(cfg, field)}"
                )
        if blob["dtype"] != dtype_name(cfg.dtype):
            raise ValueError(
                f"imported sequence dtype {blob['dtype']} != cache dtype "
                f"{dtype_name(cfg.dtype)}"
            )
        if blob["length"] > cfg.max_blocks_per_seq * cfg.block_size:
            raise ValueError(
                f"imported sequence length {blob['length']} exceeds this "
                "cache's max_blocks_per_seq"
            )
        sid = self.new_seq()
        if blob["length"]:
            self.append_prefill(sid, torch.as_tensor(blob["k"]).to(self.device),
                                torch.as_tensor(blob["v"]).to(self.device))
        return sid

    def blocks_in_use(self) -> int:
        """Blocks holding sequence data (reserved scratch blocks excluded)."""
        return int(np.sum(self._ref > 0)) - len(self._reserved)


def _raw_bytes(x: torch.Tensor) -> bytes:
    """A tensor's bytes in C order, read through a ``uint8`` view so no
    dtype (bfloat16 included) enters a digest."""
    return x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
