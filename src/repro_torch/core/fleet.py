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

``read``/``materialize`` (which gather through the ``cow_gather`` kernel)
and the maintenance, tiering and migration planes come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import chain as chain_lib
from repro_torch.core import format as fmt
from repro_torch.core import resolve as resolve_lib
from repro_torch.core.chain import ChainSpec
from repro_torch.device import as_device


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
    ids = torch.as_tensor(page_ids, device=fleet.device)
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


def free_tenant(fleet: ChainFleet, tenants) -> ChainFleet:
    """Retire tenants wholesale: reset their chains to an empty length-1
    chain and return each one's *entire* lease set to the allocator.

    ``tenants``: an int tenant id, a sequence of ids, or a (T,) bool mask.
    Pool rows the freed tenants referenced are garbage until their quanta
    are re-leased (rows are never zeroed). Host-tier rows and golden pins
    arrive with the tiering and golden slices.
    """
    spec = fleet.spec
    idx = np.flatnonzero(_tenant_sel(spec.n_tenants, tenants))
    if idx.size == 0:
        return fleet
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
                  scalable: bool | None = None) -> ChainFleet:
    """(Re)initialize tenant slot ``t`` for a new occupant: a fresh empty
    length-1 chain with the given format flag (default: keep the slot's
    flag). Any leases the slot still held are released first."""
    free_tenant(fleet, t)
    if scalable is not None:
        fleet.scalable[t] = bool(scalable)
    return fleet


def _clone_into(fleet: ChainFleet, src: int, dst: int, *,
                bump: bool) -> ChainFleet:
    fleet.l1[dst] = fleet.l1[src]
    fleet.l2[dst] = fleet.l2[src]
    fleet.length[dst] = fleet.length[src] + (1 if bump else 0)
    fleet.scalable[dst] = fleet.scalable[src]
    return fleet


def clone_tenant(fleet: ChainFleet, src: int, dst: int) -> ChainFleet:
    """Copy tenant ``src``'s chain metadata (L1/L2 stacks, length, format
    flag) into slot ``dst``. Pool rows are shared, not copied: the caller
    owns cross-tenant row lifetime (the serving plane refcounts KV blocks
    host-side)."""
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
