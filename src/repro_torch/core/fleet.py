"""ChainFleet: N independent snapshot chains over one shared page pool (PyTorch port).

The data plane of ``repro.core.fleet``: a *stacked* representation of
``n_tenants`` chains — per-tenant L1/L2 index stacks ``(T, max_chain, ...)``
and chain ``length`` / ``scalable`` / ``overflow`` state — over **one
global page pool**, carved into fixed-size lease quanta by a fleet-level
allocator (a tenant's n-th allocated row lives at
``lease_index[t, n // Q] * Q + n % Q``).

Every data-path operation is batched across the fleet: the resolvers run
the stacked table helpers of ``core.resolve`` over the tenant axis, or the
fleet kernels of ``kernels/chain_resolve`` (``"pallas_*"`` and ``"auto"``;
the registry keys keep the JAX package's names so tests compare like with
like); ``write`` performs fleet-wide COW; ``snapshot`` snapshots any
subset of tenants, honouring each tenant's format flag.

Unlike the JAX package, whose updates are functional, every operation
here updates the fleet's tensors in place and returns the same object:
callers always continue from the returned fleet, and in-place updates
spare a copy of the (T, C, P, 2) index per operation.

The read plane gathers the resolved pages through the ``cow_gather``
fleet kernel (``read``, ``materialize``), and the host cold tier moves
immutable snapshot layers between the device pool and a ``TieredStore``
(``demote_tenants``, ``promote_tenants``, ``read_tiered``). The
maintenance plane streams tenants (``stream_tenants``: ``chain.merge_tables``
per tenant, whose merge plan runs the streaming-merge kernel K9) and
repacks their leases (``compact``); ``core.scheduler`` budgets both beside
serving. Migration installs a whole chain into a slot (``install_tenant``,
driven by ``core.migrate``), and the golden registry (``core.golden``)
rides through ``free_tenant``, ``stream_tenants``, ``compact`` and
``demote_tenants``: registered owners are left alone and rows pinned by
golden forks are never repacked or spilled.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import chain as chain_lib
from repro_torch.core import format as fmt
from repro_torch.core import resolve as resolve_lib
from repro_torch.core import store as store_lib
from repro_torch.core.chain import Chain, ChainSpec
from repro_torch.device import as_device
from repro_torch.kernels.cow_gather import ops as cow_ops
from repro_torch.trace import span


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Static geometry of a fleet."""

    n_tenants: int
    n_pages: int
    page_size: int
    max_chain: int
    pool_capacity: int       # global pool rows shared by the whole fleet
    lease_quantum: int = 64  # pool rows acquired per lease
    l2_per_table: int = 64
    slice_len: int = 16
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        if self.pool_capacity % self.lease_quantum != 0:
            raise ValueError("pool_capacity must be a multiple of lease_quantum")
        # delegate the per-chain validations (bit widths, divisibility)
        self.chain_spec()

    @property
    def n_quanta(self) -> int:
        return self.pool_capacity // self.lease_quantum

    @property
    def n_l1(self) -> int:
        return self.n_pages // self.l2_per_table

    def chain_spec(self) -> ChainSpec:
        """The per-tenant view: same geometry, the shared (global) pool."""
        return ChainSpec(
            n_pages=self.n_pages,
            page_size=self.page_size,
            max_chain=self.max_chain,
            pool_capacity=self.pool_capacity,
            l2_per_table=self.l2_per_table,
            slice_len=self.slice_len,
            dtype=self.dtype,
        )


@dataclasses.dataclass
class ChainFleet:
    spec: FleetSpec
    l1: torch.Tensor           # (T, max_chain, n_l1) int32
    l2: torch.Tensor           # (T, max_chain, n_pages, 2) int32
    pool: torch.Tensor         # (pool_capacity, page_size) dtype — shared
    lease_owner: torch.Tensor  # (n_quanta,) int32 — owning tenant, -1 = free
    lease_index: torch.Tensor  # (T, n_quanta) int32 — quantum ids in lease order
    lease_count: torch.Tensor  # (T,) int32 — leases held per tenant
    alloc_count: torch.Tensor  # (T,) int32 — pool rows allocated per tenant
    length: torch.Tensor       # (T,) int32 — chain length per tenant
    scalable: torch.Tensor     # (T,) bool — per-tenant format flag
    overflow: torch.Tensor     # (T,) bool — per-tenant pool-lease exhaustion
    snap_dropped: torch.Tensor  # (T,) bool — snapshot attempted at max_chain
    cold_count: torch.Tensor   # (T,) int32 — host-tier rows held per tenant

    @property
    def device(self) -> torch.device:
        return self.l2.device


def create(spec: FleetSpec, *, scalable=True, device="cuda") -> ChainFleet:
    """A fresh fleet: every tenant is a chain of length 1 with no leases.

    ``scalable`` may be a python bool (uniform fleet) or a (T,) bool array
    (mixed deployment: some tenants on the vanilla format).
    """
    dev = as_device(device)
    t = spec.n_tenants
    i32 = dict(dtype=torch.int32, device=dev)
    scal = torch.as_tensor(np.broadcast_to(np.asarray(scalable, bool), (t,)).copy(),
                           device=dev)
    return ChainFleet(
        spec=spec,
        l1=torch.zeros((t, spec.max_chain, spec.n_l1), **i32),
        l2=fmt.empty_entries((t, spec.max_chain, spec.n_pages), dev),
        pool=torch.zeros((spec.pool_capacity, spec.page_size), dtype=spec.dtype,
                         device=dev),
        lease_owner=torch.full((spec.n_quanta,), -1, **i32),
        lease_index=torch.full((t, spec.n_quanta), -1, **i32),
        lease_count=torch.zeros((t,), **i32),
        alloc_count=torch.zeros((t,), **i32),
        length=torch.ones((t,), **i32),
        scalable=scal,
        overflow=torch.zeros((t,), dtype=torch.bool, device=dev),
        snap_dropped=torch.zeros((t,), dtype=torch.bool, device=dev),
        cold_count=torch.zeros((t,), **i32),
    )


# -- fleet allocator ---------------------------------------------------------


def _acquire_leases(fleet: ChainFleet, rows_needed: torch.Tensor):
    """Grant each tenant enough fresh quanta to cover ``rows_needed`` more
    rows. Vectorized as in the JAX package: free quanta are ranked once
    and handed out in tenant order via an exclusive cumsum. Returns the
    updated lease state plus a per-tenant "went short" flag (new tensors;
    the fleet is not touched).
    """
    spec = fleet.spec
    q, nq, t = spec.lease_quantum, spec.n_quanta, spec.n_tenants
    dev = fleet.device

    new_total = fleet.alloc_count + rows_needed
    want = (-(-new_total // q) - fleet.lease_count).clamp(min=0)

    free = fleet.lease_owner < 0
    # free quanta first, in id order (a stable sort stands in for the
    # fixed-size nonzero of the JAX package)
    free_ids = torch.sort((~free).to(torch.int32), stable=True).indices
    n_free = free.sum()

    start = torch.cumsum(want, 0) - want                          # exclusive
    j = torch.arange(nq, device=dev)[None, :]
    src = start[:, None] + j
    ok = (j < want[:, None]) & (src < n_free)
    grant = torch.where(ok, free_ids[src.clamp(0, nq - 1)], -1)   # (T, nq)
    # compare against want itself, not the (T, nq) grid: one batch can want
    # more quanta than the whole pool holds
    short = ok.sum(1) < want

    # non-grants scatter into one extra sentinel slot, sliced off after
    tids = torch.arange(t, device=dev, dtype=torch.int32)[:, None].expand(t, nq)
    owner_pad = torch.cat([fleet.lease_owner, fleet.lease_owner.new_full((1,), -1)])
    owner_pad[torch.where(ok, grant, nq).reshape(-1)] = tids.reshape(-1)
    lease_owner = owner_pad[:nq].clone()

    pos = torch.where(ok, fleet.lease_count[:, None].to(torch.int64) + j, nq)
    index_pad = torch.cat([fleet.lease_index,
                           fleet.lease_index.new_full((t, 1), -1)], dim=1)
    index_pad.scatter_(1, pos, grant.to(torch.int32))
    lease_index = index_pad[:, :nq].clone()
    lease_count = fleet.lease_count + ok.sum(1, dtype=torch.int32)
    return lease_owner, lease_index, lease_count, short


def _rows_for(spec: FleetSpec, lease_index: torch.Tensor,
              alloc_count: torch.Tensor, bsz: int):
    """Global pool rows for each tenant's next ``bsz`` allocations.

    Returns ``(rows (T, B) int64, leased (T, B) bool)`` — ``rows`` is -1
    where the tenant holds no lease for that slot.
    """
    q, nq = spec.lease_quantum, spec.n_quanta
    local = (alloc_count.to(torch.int64)[:, None]
             + torch.arange(bsz, device=lease_index.device)[None, :])
    slot = local // q
    # bound the gather: an unbounded slot would alias post-exhaustion
    # writes onto the final quantum's (immutable) rows
    quantum = torch.gather(lease_index.to(torch.int64), 1, slot.clamp(max=nq - 1))
    leased = (quantum >= 0) & (slot < nq)
    rows = torch.where(leased, quantum * q + local % q, -1)
    return rows, leased


# -- batched data path -------------------------------------------------------


def write(fleet: ChainFleet, page_ids, data, mask=None) -> ChainFleet:
    """Fleet-wide COW write: one batch of pages per tenant.

    ``page_ids``: (T, B), unique within each tenant's batch; ``data``:
    (T, B, page_size); ``mask``: optional (T,) bool selecting which tenants
    participate. Semantics per tenant match ``chain.write``; rows come
    from the tenant's leased quanta, and tenants the pool cannot serve are
    flagged ``overflow`` (their excess pages are dropped — never written
    into another tenant's lease).
    """
    spec = fleet.spec
    dev = fleet.device
    page_ids = torch.as_tensor(page_ids, device=dev).to(torch.int64)
    t, bsz = page_ids.shape
    tmask = (torch.ones((t,), dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(mask, dtype=torch.bool, device=dev))
    need = torch.where(tmask, bsz, 0).to(torch.int32)

    lease_owner, lease_index, lease_count, short = _acquire_leases(fleet, need)
    rows, leased = _rows_for(spec, lease_index, fleet.alloc_count, bsz)
    valid = leased & tmask[:, None]                       # (T, B)

    data = torch.as_tensor(data, device=dev).to(spec.dtype)
    fleet.pool[rows[valid]] = data[valid]
    chain_lib.write_tables(fleet.l1, fleet.l2, fleet.length - 1, page_ids,
                           rows.clamp(min=0), scalable=fleet.scalable,
                           l2_per_table=spec.l2_per_table, mask=valid)
    fleet.lease_owner = lease_owner
    fleet.lease_index = lease_index
    fleet.lease_count = lease_count
    fleet.alloc_count = fleet.alloc_count + valid.sum(1, dtype=torch.int32)
    fleet.overflow = fleet.overflow | (short & tmask)
    return fleet


def snapshot(fleet: ChainFleet, mask=None, scalable=None) -> ChainFleet:
    """Per-tenant snapshot: freeze each selected tenant's active volume.

    ``mask``: optional (T,) bool — which tenants snapshot. ``scalable``:
    optional override (python bool or (T,) bool), as in ``chain.snapshot``.
    Tenants already at ``max_chain`` are skipped and flagged
    ``snap_dropped``.
    """
    spec = fleet.spec
    dev = fleet.device
    t = spec.n_tenants
    tmask = (torch.ones((t,), dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(mask, dtype=torch.bool, device=dev))
    scal = (fleet.scalable if scalable is None
            else torch.as_tensor(scalable, dtype=torch.bool, device=dev).expand(t))
    can = tmask & (fleet.length < spec.max_chain)
    chain_lib.copy_forward_tables(fleet.l1, fleet.l2, fleet.length, can & scal)
    fleet.length = fleet.length + can.to(torch.int32)
    fleet.snap_dropped = fleet.snap_dropped | (tmask & ~can)
    return fleet


def _batched_resolver(name: str):
    fn = resolve_lib.get_table_resolver(name)

    def batched(fleet: ChainFleet, page_ids):
        ids = torch.as_tensor(page_ids, device=fleet.device)
        return fn(fleet.l2, fleet.length, ids)

    return batched


#: Batched resolvers: page_ids (T, B) → ResolveResult of (T, B) leaves.
resolve_vanilla = _batched_resolver("vanilla")
resolve_direct = _batched_resolver("direct")


def fused_layout_ok(n_pages: int) -> bool:
    """The JAX package's lane-alignment rule, kept as its auto-selection
    rule so ``Engine(decode_path="auto")`` picks the same path in both
    packages. The 128-lane width is a TPU tiling fact; revisiting the rule
    for Hopper needs times of both decode paths."""
    return n_pages % 128 == 0


def _kernel_layout_ok(fleet: ChainFleet) -> bool:
    """Rule for ``method="auto"``: on a CUDA fleet the kernels take any
    page axis; a CPU fleet follows the JAX package's rule (the plain
    versions of the kernels are bit-identical to the table helpers)."""
    return fleet.l2.is_cuda or fused_layout_ok(fleet.spec.n_pages)


def _ids_on(fleet: ChainFleet, page_ids) -> torch.Tensor:
    """``page_ids`` as a tensor on the fleet's device: the tensor itself
    where it already is one there, with no ``as_tensor`` call (about 0.8 µs
    of host time a call on an H100 machine; ``read`` and ``resolve_auto``,
    the auto read's path, use it)."""
    if isinstance(page_ids, torch.Tensor) and page_ids.device == fleet.l2.device:
        return page_ids
    return torch.as_tensor(page_ids, device=fleet.device)


def resolve_pallas_vanilla(fleet: ChainFleet, page_ids):
    """Stacked-kernel chain walk; bit-identical to ``resolve_vanilla``."""
    ids = torch.as_tensor(page_ids, device=fleet.device)
    return resolve_lib.resolve_vanilla_stacked(fleet.l2, fleet.length, ids)


def resolve_pallas_direct(fleet: ChainFleet, page_ids):
    """Stacked-kernel direct access; bit-identical to ``resolve_direct``."""
    ids = torch.as_tensor(page_ids, device=fleet.device)
    return resolve_lib.resolve_direct_stacked(fleet.l2, fleet.length, ids)


def resolve_auto(fleet: ChainFleet, page_ids):
    """Mixed-image resolution (direct where trusted, walk otherwise): the
    fleet kernels when ``_kernel_layout_ok``, the stacked table helpers
    otherwise. Both produce bit-identical results."""
    ids = _ids_on(fleet, page_ids)
    if _kernel_layout_ok(fleet):
        return resolve_lib.resolve_auto_stacked(fleet.l2, fleet.length, ids)
    return resolve_lib.get_table_resolver("auto")(fleet.l2, fleet.length, ids)


_RESOLVERS = {
    "vanilla": resolve_vanilla,
    # "gather" names the implementation rather than the strategy: the
    # plain stacked walk, the baseline the kernels are compared against
    "gather": resolve_vanilla,
    "direct": resolve_direct,
    "auto": resolve_auto,
    "pallas_vanilla": resolve_pallas_vanilla,
    "pallas_direct": resolve_pallas_direct,
}


def get_resolver(name: str):
    """Look up a batched fleet resolver by method name: ``"vanilla"``
    (alias ``"gather"``), ``"direct"``, ``"pallas_vanilla"``,
    ``"pallas_direct"`` (the fleet kernels) or ``"auto"``. Every method
    returns ``(fleet, page_ids (T, B)) -> ResolveResult`` of (T, B) leaves.
    Raises ``ValueError`` for unknown names."""
    return resolve_lib.lookup_resolver(_RESOLVERS, name)


def _uses_kernels(fleet: ChainFleet, method: str) -> bool:
    return (method in store_lib.KERNEL_METHODS
            or (method == "auto" and _kernel_layout_ok(fleet)))


def read(fleet: ChainFleet, page_ids, *, method: str = "auto"):
    """Batched whole-page read across the fleet.

    Args:
        fleet: the fleet state (untouched: reads modify nothing).
        page_ids: (T, B) int32 logical page indices, one batch per tenant.
        method: resolver method (see ``get_resolver``). The default
            ``"auto"`` resolves each page direct-where-trusted and runs on
            the kernels when ``_kernel_layout_ok`` (every CUDA fleet).

    Returns:
        ``(data, result)``: ``data`` (T, B, page_size) and the
        ``ResolveResult`` of (T, B) leaves the gather consumed.
        Unallocated, ZERO and COLD pages read as +0.0, exactly as
        ``store.read``. Kernel methods gather through the fleet gather of
        ``kernels/cow_gather`` (K5), whose entry on a resolve's leaves
        tests each page itself, so on the card an auto read is two
        launches (K1's batch entry, then K5) with nothing between them;
        the plain methods use ``store.gather_pages``. Both give the same
        bytes.

    While a profiler records, the call is the span ``fleet.read``, and the
    resolver and the gather are ``fleet.resolve`` and ``fleet.gather``
    inside it (``repro_torch.trace``).
    """
    with span("fleet.read"):
        ids = _ids_on(fleet, page_ids)
        with span("fleet.resolve"):
            res = get_resolver(method)(fleet, ids)
        with span("fleet.gather"):
            if _uses_kernels(fleet, method):
                # cold hits address the host tier: read as zeros like ZERO
                # clusters (read_tiered fills them from the TieredStore)
                data = cow_ops.gather_fleet_resolved(fleet.pool, res.ptr, res.found,
                                                     res.zero, res.cold)
            else:
                data = store_lib.gather_pages(fleet.pool, res)
        return data, res


def materialize(fleet: ChainFleet, *, method: str = "auto") -> torch.Tensor:
    """Read every tenant's full virtual disk: (T, n_pages, page_size).

    ``method`` is any ``get_resolver`` name; the fleet-wide 'dd' op.
    """
    spec = fleet.spec
    ids = torch.arange(spec.n_pages, dtype=torch.int32, device=fleet.device)
    data, _ = read(fleet, ids[None].expand(spec.n_tenants, -1), method=method)
    return data


# -- tenant lifecycle: attach / clone / fork / free / stamp ------------------


def _tenant_sel(n_tenants: int, tenants) -> np.ndarray:
    """Normalize an int / id-list / bool-mask tenant selector to a mask."""
    t = np.asarray(tenants)
    if t.dtype == bool:
        return np.broadcast_to(t, (n_tenants,))
    sel = np.zeros(n_tenants, bool)
    if t.size:                     # an empty id list selects nothing
        sel[np.atleast_1d(t).astype(np.int64)] = True
    return sel


def _entry_masks(w0: torch.Tensor):
    """(allocated, zero, cold) masks and the ptr field of word0 words."""
    return ((w0 & fmt.FLAG_ALLOCATED_I32) != 0, (w0 & fmt.FLAG_ZERO_I32) != 0,
            (w0 & fmt.FLAG_COLD_I32) != 0, (w0 & fmt.PTR_MASK).to(torch.int64))


def _tenant_cold_rows(w0_t: torch.Tensor):
    """Cold entries of one tenant's live word0 stack (L, n_pages): the
    (layer, page) mask and every entry's ptr field (a host row where
    cold)."""
    alloc, zero, cold, rows = _entry_masks(w0_t)
    return cold & alloc & ~zero, rows


def free_tenant(fleet: ChainFleet, tenants, *, store=None,
                registry=None) -> ChainFleet:
    """Retire tenants wholesale: reset their chains to an empty length-1
    chain and return each one's *entire* lease set to the allocator.

    ``tenants``: an int tenant id, a sequence of ids, or a (T,) bool mask.
    ``store``: the ``TieredStore`` holding any demoted pages of the freed
    tenants; their host rows return to its free list here, so a freed
    tenant leaves no orphaned host pages. Required iff a selected tenant
    holds cold rows. ``registry``: the ``GoldenRegistry``, when the fleet
    runs one. Freeing a registered golden *owner* is refused (forks may pin
    its rows: ``unregister`` first); freeing a golden *fork* releases its
    pins on the shared base here, so callers cannot leak refcounts. Pool
    rows the freed tenants referenced are garbage until their quanta are
    re-leased (rows are never zeroed).
    """
    spec = fleet.spec
    idx = np.flatnonzero(_tenant_sel(spec.n_tenants, tenants))
    if idx.size == 0:
        return fleet
    if registry is not None:
        owners = [int(t) for t in idx if registry.is_golden_owner(int(t))]
        if owners:
            raise ValueError(
                f"tenants {owners} are registered golden bases; "
                "unregister them before freeing (forks may pin their rows)"
            )
        for t in idx:
            if registry.is_fork(int(t)):
                registry.release(int(t))
    cold_held = fleet.cold_count.cpu().numpy()[idx]
    if np.any(cold_held > 0):
        if store is None:
            raise ValueError(
                f"tenants {idx[cold_held > 0].tolist()} hold host-tier "
                "rows; pass the TieredStore so free_tenant can release "
                "them (orphaned host pages otherwise)"
            )
        # sweep the freed tenants' L2 stacks for COLD entries and hand
        # their host rows back to the cold tier's free list
        lengths = fleet.length.cpu().numpy()
        for t in idx[cold_held > 0]:
            coldm, rows = _tenant_cold_rows(fleet.l2[t, : lengths[t], :, 0])
            store.free(torch.unique(rows[coldm]).cpu().numpy())
    rows = torch.as_tensor(idx, dtype=torch.int64, device=fleet.device)
    fleet.lease_owner[torch.isin(fleet.lease_owner,
                                rows.to(torch.int32))] = -1
    fleet.lease_index[rows] = -1
    for a in (fleet.l1, fleet.l2, fleet.lease_count, fleet.alloc_count,
              fleet.cold_count):
        a[rows] = 0
    fleet.length[rows] = 1
    fleet.overflow[rows] = False
    fleet.snap_dropped[rows] = False
    return fleet


def attach_tenant(fleet: ChainFleet, t: int, *,
                  scalable: bool | None = None,
                  registry=None) -> ChainFleet:
    """(Re)initialize tenant slot ``t`` for a new occupant: a fresh empty
    length-1 chain with the given format flag (default: keep the slot's
    flag). Any leases the slot still held are released first
    (``free_tenant``, honouring ``registry`` pins)."""
    free_tenant(fleet, t, registry=registry)
    if scalable is not None:
        fleet.scalable[t] = bool(scalable)
    return fleet


def _clone_into(fleet: ChainFleet, src: int, dst: int, *,
                bump: bool) -> ChainFleet:
    if int(fleet.cold_count[src]) > 0:
        raise ValueError(
            f"tenant {src} holds host-tier rows; promote_tenants before "
            "cloning (cold entries cannot be shared across tenants)"
        )
    fleet.l1[dst] = fleet.l1[src]
    fleet.l2[dst] = fleet.l2[src]
    fleet.length[dst] = fleet.length[src] + (1 if bump else 0)
    fleet.scalable[dst] = fleet.scalable[src]
    return fleet


def clone_tenant(fleet: ChainFleet, src: int, dst: int) -> ChainFleet:
    """Copy tenant ``src``'s chain metadata (L1/L2 stacks, length, format
    flag) into slot ``dst``. Pool rows are shared, not copied: the caller
    owns cross-tenant row lifetime (the serving plane refcounts KV blocks
    host-side). Raises if ``src`` holds demoted (host-tier) rows: a cloned
    COLD entry would alias the host row across tenants, so promote first."""
    return _clone_into(fleet, src, dst, bump=False)


def fork_tenant(fleet: ChainFleet, src: int, dst: int) -> ChainFleet:
    """Serving-plane fork: clone ``src``'s chain into ``dst`` and open a
    fresh (all-zeros) active volume on top. Raises if ``src`` is already
    at ``max_chain`` (callers grow the fleet geometry first)."""
    if int(fleet.length[src]) >= fleet.spec.max_chain:
        raise ValueError(
            f"tenant {src} is at max_chain={fleet.spec.max_chain}; "
            "grow the fleet geometry before forking"
        )
    return _clone_into(fleet, src, dst, bump=True)


def stamp_entries(fleet: ChainFleet, tenants, layers, pages,
                  entries) -> ChainFleet:
    """Raw batched L2/L1 stamp at explicit ``(tenant, layer, page)`` sites.

    The serving plane's COW-prepare write: pool rows are allocated by the
    caller, so no lease is acquired and the pool is untouched — this
    stamps index metadata only, one scatter for the whole batch. Inputs
    are host arrays; ``entries``: (K, 2) packed words (``uint32`` or the
    ``int32`` carrier). A tenant id of ``n_tenants`` acts as a drop
    sentinel, so callers can pad the batch to a fixed K.
    """
    spec = fleet.spec
    t = np.asarray(tenants, np.int64)
    keep = t < spec.n_tenants
    if not keep.any():
        return fleet
    idx = np.stack([t[keep], np.asarray(layers, np.int64)[keep],
                    np.asarray(pages, np.int64)[keep]])
    idx = torch.as_tensor(idx, device=fleet.device)
    ent = fmt.words(np.asarray(entries)[keep], device=fleet.device)
    fleet.l2[idx[0], idx[1], idx[2]] = ent
    fleet.l1[idx[0], idx[1], idx[2] // spec.l2_per_table] = 1
    return fleet


def acquire_rows(fleet: ChainFleet, t: int, n: int):
    """Grant tenant ``t`` ownership of ``n`` fresh device pool rows.

    Quanta are acquired on demand exactly as in ``write``, and
    ``alloc_count`` grows by ``n`` so the granted rows are the tenant's
    next ``n`` lease-order slots. Returns ``(fleet, rows)`` with ``rows``
    an (n,) int64 numpy array of global pool row ids. Raises
    ``RuntimeError`` (leaving the fleet untouched) if the pool cannot
    serve the grant.
    """
    spec = fleet.spec
    if n <= 0:
        return fleet, np.zeros(0, np.int64)
    need = torch.zeros(spec.n_tenants, dtype=torch.int32, device=fleet.device)
    need[t] = n
    lease_owner, lease_index, lease_count, short = _acquire_leases(fleet, need)
    if bool(short[t]):
        raise RuntimeError(
            f"pool exhausted granting {n} rows to tenant {t}: free or "
            "stream other tenants first"
        )
    rows, leased = _rows_for(spec, lease_index, fleet.alloc_count, n)
    if not bool(leased[t].all()):
        raise RuntimeError(
            f"lease table cannot address {n} more rows for tenant {t}"
        )
    fleet.lease_owner = lease_owner
    fleet.lease_index = lease_index
    fleet.lease_count = lease_count
    fleet.alloc_count = fleet.alloc_count + need
    return fleet, rows[t].cpu().numpy().astype(np.int64)


def install_tenant(fleet: ChainFleet, t: int, *, l1, l2, length: int,
                   scalable: bool, cold_count: int = 0,
                   pool_rows=None, pool_data=None) -> ChainFleet:
    """Install a complete chain into tenant slot ``t`` in one shot.

    The attach half of migration: the slot's L1/L2 stacks are replaced
    wholesale (layers past ``length`` zeroed; ``l1``/``l2`` are packed
    words, ``uint32`` or the ``int32`` carrier), its ``length``/format/
    ``cold_count`` set, and, when given, ``pool_data`` scattered into
    ``pool_rows`` (rows the caller obtained from ``acquire_rows``: the
    blob's page payload landing in the device pool). The pressure flags
    reset: an imported chain starts clean.

    The caller is responsible for slot hygiene (``free_tenant`` first, so
    a predecessor's leases are returned) and for the entries in ``l2``
    pointing only at rows granted to ``t``: ``core.migrate`` remaps
    blob-local pointers before calling in, and ``core.invariants`` checks
    the result.
    """
    spec = fleet.spec
    length = int(length)
    if not 1 <= length <= spec.max_chain:
        raise ValueError(
            f"cannot install a length-{length} chain into a fleet with "
            f"max_chain={spec.max_chain}"
        )
    dev = fleet.device
    fleet.l1[t] = 0
    fleet.l2[t] = 0
    fleet.l1[t, :length] = fmt.words(l1, device=dev)
    fleet.l2[t, :length] = fmt.words(l2, device=dev)
    if pool_rows is not None and len(pool_rows):
        rows = torch.as_tensor(np.asarray(pool_rows, np.int64), device=dev)
        fleet.pool[rows] = torch.as_tensor(pool_data).to(device=dev,
                                                         dtype=spec.dtype)
    fleet.length[t] = length
    fleet.scalable[t] = bool(scalable)
    fleet.overflow[t] = False
    fleet.snap_dropped[t] = False
    fleet.cold_count[t] = int(cold_count)
    return fleet


# -- maintenance plane: lease reclamation ------------------------------------


def _reclaim(fleet: ChainFleet, sel: np.ndarray, *,
             shared_rows=None) -> ChainFleet:
    """Repack each selected tenant's live rows into its leading lease
    quanta and return now-empty quanta to the allocator free list.

    Host-driven, like the JAX package's. Per selected tenant: gather the
    pool rows its live L2 entries reference, copy them into the densest
    prefix of its leased quanta, remap the L2 pointers, then release every
    quantum past the packed prefix. COLD entries point at the host tier:
    they pin no device row and keep their ptr. ``overflow`` clears only
    for tenants whose row count actually shrank.

    ``shared_rows`` (the golden registry's ``pinned_rows()``) marks rows a
    tenant may legally reference *without owning*: a golden fork's entries
    alias its base's frozen rows. Like COLD entries, shared rows are not
    repacked, keep their pointer verbatim, and never count toward the
    referencing tenant's lease footprint.
    """
    spec = fleet.spec
    q = spec.lease_quantum
    dev = fleet.device
    lengths = fleet.length.cpu().numpy()
    reclaimed = torch.zeros(spec.n_tenants, dtype=torch.bool, device=dev)
    shared_lut = None
    if shared_rows is not None and len(shared_rows):
        shared_lut = torch.zeros(spec.pool_capacity, dtype=torch.bool, device=dev)
        shared_lut[torch.as_tensor(np.asarray(shared_rows, np.int64),
                                   device=dev)] = True
    for t in np.flatnonzero(sel):
        length_t = int(lengths[t])
        entries = fleet.l2[t, :length_t]                 # (L, n_pages, 2)
        alloc, zero, cold, rows = _entry_masks(entries[..., 0])
        # ZERO clusters never dereference their ptr and COLD ones address
        # the host tier: neither pins a device row
        live = alloc & ~zero & ~cold
        shared = torch.zeros_like(live)
        if shared_lut is not None:
            shared = live & shared_lut[torch.where(live, rows, 0)]
            live = live & ~shared
        used = torch.unique(rows[live])                  # sorted global rows
        n_live = int(used.numel())
        if n_live and not bool((fleet.lease_owner[used // q] == t).all()):
            raise RuntimeError(
                f"tenant {t} references pool rows outside its leased "
                "quanta: fleet state is corrupt"
            )
        n_keep = -(-n_live // q)
        if n_live:
            keep = fleet.lease_index[t, :n_keep].to(torch.int64)
            i = torch.arange(n_live, device=dev)
            new_rows = keep[i // q] * q + i % q
            # the source rows are gathered into a new tensor before the
            # scatter, so old and new rows that overlap inside the kept
            # quanta cannot read a row already overwritten
            fleet.pool[new_rows] = fleet.pool.index_select(0, used)
            lut = torch.zeros(spec.pool_capacity, dtype=torch.int64, device=dev)
            lut[used] = new_rows
            # COLD entries keep their (host-tier) ptr verbatim, and so do
            # shared golden rows: the LUT maps this tenant's own rows only
            new_ptr = torch.where(cold | shared, rows,
                                  lut[torch.where(live, rows, 0)])
            fleet.l2[t, :length_t] = fmt.pack_entry(
                new_ptr, fmt.entry_bfi(entries), allocated=alloc,
                bfi_valid=fmt.entry_bfi_valid(entries), zero=zero, cold=cold)
        count = int(fleet.lease_count[t])
        fleet.lease_owner[fleet.lease_index[t, n_keep:count].to(torch.int64)] = -1
        fleet.lease_index[t, n_keep:] = -1
        fleet.lease_count[t] = n_keep
        reclaimed[t] = int(fleet.alloc_count[t]) > n_live
        fleet.alloc_count[t] = n_live
    fleet.overflow = fleet.overflow & ~reclaimed
    return fleet


def stream_tenants(fleet: ChainFleet, mask, merge_upto, *,
                   reclaim: bool = True, registry=None) -> ChainFleet:
    """Stream (merge layers ``[0, merge_upto]``) each selected tenant and
    return the pool quanta this frees to the lease allocator.

    The fleet-granularity analogue of ``chain.stream``: host-side
    maintenance over the stacked (T, C, P) layout, built on the same
    ``chain.merge_tables`` core (run in place on each tenant's views of
    the fleet's tables) so chain and fleet semantics cannot drift.

    Args:
        fleet: the fleet state, updated in place and returned.
        mask: (T,) bool host array, or a scalar broadcast over tenants —
            which tenants to stream this call.
        merge_upto: int or (T,) int — per tenant, merge layers
            ``[0, merge_upto]`` into the base. Tenants whose
            ``merge_upto`` does not fall strictly below their active
            volume are skipped (a background job must tolerate racing
            chain growth, where ``chain.stream`` raises), and so are
            tenants holding demoted pages (merging would collapse COLD
            entries across layers and strand their host rows).
        reclaim: run the shared ``_reclaim`` repack afterwards (default).
            Pass ``False`` for a metadata-only merge that frees nothing.
        registry: the ``GoldenRegistry``, when the fleet runs one.
            Registered golden *owners* are skipped (their chains are
            content-frozen; a merge would invalidate every fork's base)
            and forks' shared base rows ride through the repack untouched
            (``_reclaim(shared_rows=...)``).

    Returns:
        The fleet. With ``reclaim=True``, rows orphaned by the merge leave
        each tenant's lease footprint and freed quanta return to the
        allocator free list; ``overflow`` clears only for tenants that
        actually shrank, and ``snap_dropped`` clears only where streaming
        made room below ``max_chain``.
    """
    spec = fleet.spec
    t = spec.n_tenants
    mask = np.broadcast_to(np.asarray(mask, bool), (t,))
    upto = np.broadcast_to(np.asarray(merge_upto, np.int64), (t,))
    lengths = fleet.length.cpu().numpy().copy()
    cold = fleet.cold_count.cpu().numpy()
    sel = mask & (upto >= 0) & (upto < lengths - 1) & (cold == 0)
    if registry is not None:
        sel &= ~registry.golden_owner_mask(t)
    snap_dropped = fleet.snap_dropped.cpu().numpy().copy()
    scalable = fleet.scalable.cpu().numpy()
    for i in np.flatnonzero(sel):
        _, _, new_len = chain_lib.merge_tables(
            fleet.l1[i], fleet.l2[i], int(lengths[i]), int(upto[i]),
            scalable=bool(scalable[i]),
        )
        lengths[i] = new_len
        snap_dropped[i] &= new_len >= spec.max_chain
    fleet.length.copy_(torch.as_tensor(lengths.astype(np.int32)))
    fleet.snap_dropped.copy_(torch.as_tensor(snap_dropped))
    if not reclaim:
        return fleet
    return _reclaim(fleet, sel, shared_rows=_pinned(registry))


def _pinned(registry):
    """The rows ``_reclaim`` must leave in place: every row a registered
    golden chain freezes (``None`` without a registry)."""
    return registry.pinned_rows() if registry is not None else None


def compact(fleet: ChainFleet, mask=None, *, registry=None) -> ChainFleet:
    """Fleet-level GC: repack every (selected) tenant's live rows and
    return the freed quanta to the allocator free list.

    The fleet analogue of ``chain.compact_pool``: COW writes and streaming
    orphan pool rows, and this is the background job that hands them
    back. ``mask``: optional (T,) bool selecting the tenants to repack
    (``None``: every tenant). ``registry``: the ``GoldenRegistry``, when
    the fleet runs one: golden owners are never repacked (their pointer
    layout is part of the frozen fingerprint and their rows are pinned);
    forks repack only their own rows, aliased base rows ride through
    verbatim. Updates the fleet in place and returns it; ``overflow``
    clears only for tenants whose rows were actually reclaimed.
    """
    t = fleet.spec.n_tenants
    sel = (np.ones(t, bool) if mask is None
           else np.broadcast_to(np.asarray(mask, bool), (t,)))
    if registry is not None:
        sel = sel & ~registry.golden_owner_mask(t)
    return _reclaim(fleet, sel, shared_rows=_pinned(registry))


# -- host cold tier: demote / promote / tiered read --------------------------


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bytewise equality, on the device when both tensors share one."""
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def demote_tenants(fleet: ChainFleet, store, tenants, *,
                   max_rows: int | None = None, verify: bool = True,
                   registry=None):
    """Demote immutable snapshot-layer pages of the selected tenants to
    the host tier, freeing their device rows.

    Only pages **owned by a layer below the active volume** are eligible
    (a page's owner is the lowest layer referencing its row); every entry
    in any layer that references a demoted row is rewritten to the host
    row under ``FLAG_COLD`` in the same transfer, so the index never
    dangles. The freed device rows then leave the tenant's lease footprint
    through ``_reclaim`` and their quanta return to the allocator.

    Host-driven (maintenance plane; it syncs by design and is never
    reached from a decode step). Transfers are bit-verified by default:
    the host copy is read back and compared bitwise against the rows read
    from the device.

    Args:
        fleet: the fleet state, updated in place and returned.
        store: the ``TieredStore`` cold tier receiving the pages.
        tenants: int id, id sequence, or (T,) bool mask.
        max_rows: demote at most this many pool rows across the call;
            ``None`` = no cap. Oldest layers go first.
        verify: bit-verify every transferred row (default True).
        registry: the ``GoldenRegistry``, when the fleet runs one.
            Registered golden owners are skipped entirely (the frozen
            base stays device-resident by contract), and rows pinned by
            the registry are never picked from *any* tenant: a fork's
            lower layers reference the shared base below its active
            volume, exactly the demotion-eligible shape, and spilling
            them would pull the base out from under every sibling fork.

    Returns:
        ``(fleet, report)`` where report is
        ``dict(rows_demoted=int, tenants=[ids that moved rows])``.
    """
    spec = fleet.spec
    dev = fleet.device
    sel = _tenant_sel(spec.n_tenants, tenants)
    pinned_lut = None
    if registry is not None:
        sel = sel & ~registry.golden_owner_mask(spec.n_tenants)
        pinned = registry.pinned_rows()
        if pinned.size:
            pinned_lut = torch.zeros(spec.pool_capacity, dtype=torch.bool,
                                     device=dev)
            pinned_lut[torch.as_tensor(pinned, device=dev)] = True
    lengths = fleet.length.cpu().numpy()
    budget = np.inf if max_rows is None else int(max_rows)
    total = 0
    moved: list[int] = []

    for t in np.flatnonzero(sel):
        if budget <= 0:
            break
        length_t = int(lengths[t])
        if length_t < 2:
            continue                       # nothing below the active volume
        w0 = fleet.l2[t, :length_t, :, 0]              # (L, n_pages) view
        alloc, zero, cold, rows = _entry_masks(w0)
        hot = alloc & ~zero & ~cold
        if pinned_lut is not None:
            # golden-pinned rows are immovable while any fork aliases them
            hot &= ~pinned_lut[torch.where(hot, rows, 0)]
        if not bool(hot.any()):
            continue
        # a row's owner is the lowest layer referencing it (copy-forward
        # re-references ancestor rows from every upper layer)
        layer_idx = torch.arange(length_t, device=dev)[:, None].expand_as(hot)
        uniq_rows, inverse = torch.unique(rows[hot], return_inverse=True)
        owner_layer = torch.full_like(uniq_rows, length_t).scatter_reduce_(
            0, inverse, layer_idx[hot], "amin")
        eligible = owner_layer < length_t - 1        # never the active layer
        uniq_rows, owner_layer = uniq_rows[eligible], owner_layer[eligible]
        if uniq_rows.numel() == 0:
            continue
        # coldest first: the oldest layers' rows go first under the budget
        pick = torch.sort(owner_layer, stable=True).indices
        if pick.numel() > budget:
            pick = pick[: int(budget)]
        dem_rows = uniq_rows[pick]
        n = int(dem_rows.numel())

        host_rows = store.alloc(n)
        vals = fleet.pool.index_select(0, dem_rows).cpu()
        store.put(host_rows, vals)
        if verify and not _same_bytes(store.get(host_rows), vals):
            raise RuntimeError(
                f"demotion transfer verification failed for tenant {t}"
            )
        # rewrite every entry (any layer) referencing a demoted row:
        # ptr -> host row, FLAG_COLD set; all other bits carried
        lut = torch.zeros(spec.pool_capacity, dtype=torch.int64, device=dev)
        in_set = torch.zeros(spec.pool_capacity, dtype=torch.bool, device=dev)
        lut[dem_rows] = torch.as_tensor(host_rows, device=dev)
        in_set[dem_rows] = True
        hit = hot & in_set[torch.where(hot, rows, 0)]
        new_ptr = lut[torch.where(hit, rows, 0)].to(torch.int32)
        w0.copy_(torch.where(hit, (w0 & ~fmt.PTR_MASK) | new_ptr
                             | fmt.FLAG_COLD_I32, w0))
        fleet.cold_count[t] += n
        budget -= n
        total += n
        moved.append(int(t))

    if not moved:
        return fleet, dict(rows_demoted=0, tenants=[])
    # repack: the demoted rows are no longer referenced by any hot entry,
    # so _reclaim returns their quanta to the allocator free list
    fleet = _reclaim(fleet, _tenant_sel(spec.n_tenants, moved),
                     shared_rows=_pinned(registry))
    return fleet, dict(rows_demoted=total, tenants=moved)


def promote_tenants(fleet: ChainFleet, store, tenants, *,
                    max_rows: int | None = None, verify: bool = True):
    """Promote the selected tenants' demoted pages back into the device
    pool (the inverse of ``demote_tenants``).

    Fresh device rows come from the tenant's own leases (acquiring quanta
    on demand); the host copies are scattered in, every COLD entry
    referencing them is rewritten to the new device row with the residency
    bit cleared, and the host rows return to the store's free list.
    Bit-verified by default: the device rows are read back and compared
    against the host copies. Raises ``RuntimeError`` (leaving the fleet
    untouched) if the pool cannot grant enough quanta.

    Args:
        fleet: the fleet state, updated in place and returned.
        store: the ``TieredStore`` the pages were demoted into.
        tenants: int id, id sequence, or (T,) bool mask.
        max_rows: promote at most this many rows across the call
            (``None`` = everything cold the selected tenants hold).
        verify: bit-verify every transferred row (default True).

    Returns:
        ``(fleet, report)``: ``dict(rows_promoted=int, tenants=[...])``.
    """
    spec = fleet.spec
    dev = fleet.device
    sel = _tenant_sel(spec.n_tenants, tenants)
    lengths = fleet.length.cpu().numpy()
    cold_count = fleet.cold_count.cpu().numpy()
    budget = np.inf if max_rows is None else int(max_rows)

    # pick the host rows to promote per tenant, under the budget
    plans: dict[int, torch.Tensor] = {}      # t -> sorted host rows
    need = torch.zeros(spec.n_tenants, dtype=torch.int32, device=dev)
    for t in np.flatnonzero(sel & (cold_count > 0)):
        if budget <= 0:
            break
        coldm, rows = _tenant_cold_rows(fleet.l2[t, : lengths[t], :, 0])
        host_rows = torch.unique(rows[coldm])
        if host_rows.numel() > budget:
            host_rows = host_rows[: int(budget)]
        if host_rows.numel() == 0:
            continue
        plans[int(t)] = host_rows
        need[t] = host_rows.numel()
        budget -= host_rows.numel()
    if not plans:
        return fleet, dict(rows_promoted=0, tenants=[])

    lease_owner, lease_index, lease_count, short = _acquire_leases(fleet, need)
    bad = [t for t in plans if bool(short[t])]
    if bad:
        raise RuntimeError(
            f"device pool exhausted promoting tenants {bad}: demote or "
            "free other tenants first"
        )
    bsz = int(need.max())
    dev_rows, _ = _rows_for(spec, lease_index, fleet.alloc_count, bsz)

    # one batched scatter for the whole call's data movement
    dev_cat = torch.cat([dev_rows[t, : h.numel()] for t, h in plans.items()])
    host_cat = torch.cat(list(plans.values()))
    vals = store.get(host_cat.cpu())
    fleet.pool[dev_cat] = vals.to(dev)
    if verify and not _same_bytes(fleet.pool.index_select(0, dev_cat), vals):
        raise RuntimeError("promotion transfer verification failed")

    # rewrite the promoted COLD entries: host row -> device row, bit clear
    for t, host_rows in plans.items():
        w0 = fleet.l2[t, : lengths[t], :, 0]           # in-place view
        coldm, rows = _tenant_cold_rows(w0)
        promoting = coldm & torch.isin(rows, host_rows)
        # host_rows is sorted: searchsorted maps each promoted entry's host
        # row to its fresh device row
        idx = torch.searchsorted(host_rows, rows[promoting])
        new_ptr = dev_rows[t, : host_rows.numel()][idx].to(torch.int32)
        w0[promoting] = ((w0[promoting] & ~fmt.PTR_MASK & ~fmt.FLAG_COLD_I32)
                         | new_ptr)
        fleet.alloc_count[t] += host_rows.numel()
        fleet.cold_count[t] -= host_rows.numel()
        store.free(host_rows.cpu().numpy())
        store.promoted_rows += int(host_rows.numel())
    fleet.lease_owner = lease_owner
    fleet.lease_index = lease_index
    fleet.lease_count = lease_count
    return fleet, dict(rows_promoted=int(need.sum()), tenants=sorted(plans))


def read_tiered(fleet: ChainFleet, store, page_ids, *, method: str = "auto"):
    """Batched fleet read that serves cold pages from the host tier.

    The device gather (``read``) masks cold hits to zeros; this host-side
    wrapper fills exactly those positions from the ``TieredStore``. The
    maintenance and verification planes read through it without
    perturbing residency; serving promotes before reading instead.

    Returns ``(data (T, B, page_size) on the fleet's device,
    ResolveResult)``.
    """
    data, res = read(fleet, page_ids, method=method)
    coldm = res.cold & res.found & ~res.zero
    if bool(coldm.any()):
        data[coldm] = store.get(res.ptr[coldm].cpu()).to(data.device)
    return data, res


# -- per-tenant views & host-side helpers ------------------------------------


def tenant_slice(fleet: ChainFleet, t: int) -> ChainFleet:
    """A one-tenant fleet over tenant ``t``'s views of the fleet's
    tensors and the whole shared pool: the batched data path on it
    (``read``, ``read_tiered``, the fleet kernels) costs one tenant's
    O(C·P), not the fleet's O(T·C·P), and bit for bit equals row ``t`` of
    the same call on the whole fleet. Read-only: the lease state of a
    slice is not the fleet's."""
    s = slice(t, t + 1)
    return dataclasses.replace(
        fleet,
        spec=dataclasses.replace(fleet.spec, n_tenants=1),
        **{name: getattr(fleet, name)[s] for name in (
            "l1", "l2", "lease_index", "lease_count", "alloc_count", "length",
            "scalable", "overflow", "snap_dropped", "cold_count")},
    )


def tenant_chain(fleet: ChainFleet, t: int) -> Chain:
    """A read-only single-``Chain`` view of tenant ``t``.

    Its L1/L2 are views of the fleet's tables and its pool is the fleet's
    global pool, so resolvers and reads on the view agree bit for bit
    with the batched fleet paths. Do **not** run a mutating single-chain
    op through the view: ``chain.write`` allocates from a linear cursor,
    not the fleet's leases, and would overwrite other tenants' rows. The
    view's ``pool_cursor`` is pinned to ``pool_capacity``, so an
    accidental ``write`` only flags overflow.
    """
    return Chain(
        spec=fleet.spec.chain_spec(),
        scalable=bool(fleet.scalable[t]),
        l1=fleet.l1[t],
        l2=fleet.l2[t],
        pool=fleet.pool,
        pool_cursor=torch.tensor(fleet.spec.pool_capacity, dtype=torch.int32,
                                 device=fleet.device),
        length=fleet.length[t].clone(),
        overflow=fleet.overflow[t].clone(),
        snap_dropped=fleet.snap_dropped[t].clone(),
    )


def check_pool_capacity(fleet: ChainFleet) -> None:
    """Raise if any tenant hit a resource limit (host-side guard)."""
    bad = np.flatnonzero(fleet.overflow.cpu().numpy())
    if bad.size:
        raise RuntimeError(
            f"page pool exhausted for tenants {bad.tolist()}: grow "
            "FleetSpec.pool_capacity or stream/compact their chains"
        )
    capped = np.flatnonzero(fleet.snap_dropped.cpu().numpy())
    if capped.size:
        raise RuntimeError(
            f"snapshot dropped for tenants {capped.tolist()}: their chains "
            "are at max_chain; stream them to make room"
        )


def fleet_stats(fleet: ChainFleet) -> dict:
    """Host-side occupancy summary (monitoring / benchmark reporting)."""
    st = tenant_stats(fleet)
    owner = fleet.lease_owner.cpu().numpy()
    return dict(
        n_tenants=fleet.spec.n_tenants,
        quanta_total=fleet.spec.n_quanta,
        quanta_leased=int(np.sum(owner >= 0)),
        quanta_free=int(np.sum(owner < 0)),
        rows_allocated=int(np.sum(st["alloc_count"])),
        mean_chain_length=float(np.mean(st["length"])),
        overflowed_tenants=int(np.sum(st["overflow"])),
        snapshot_capped_tenants=int(np.sum(st["snap_dropped"])),
        rows_cold=int(np.sum(st["cold_count"])),
        cold_tenants=int(np.sum(st["cold_count"] > 0)),
    )


def tenant_stats(fleet: ChainFleet) -> dict:
    """Per-tenant occupancy arrays: (T,) numpy arrays of chain ``length``,
    ``alloc_count`` (pool rows held), ``lease_count`` (quanta held),
    ``cold_count`` (host rows held) and the ``overflow``/``snap_dropped``
    pressure flags. Owned copies: a caller keeps them across ops that
    update the fleet in place (the scheduler's tick does)."""
    return {name: getattr(fleet, name).cpu().numpy().copy()
            for name in ("length", "alloc_count", "lease_count", "overflow",
                         "snap_dropped", "cold_count")}
