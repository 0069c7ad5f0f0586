"""Analytical cost models from the paper (Eq. 1, Eq. 2), the latency
mapping of the cache model's events, and the observability counters of the
fleet plane (PyTorch port of ``repro.core.metrics``).

Eq. 1 — average lookup cost on a chain of length N::

    Y = [(Hit% * T_M) + (Miss% * (T_D + T_L + T_F)) + (UnAl% * T_F)] * N

with T_M the RAM access time (~100 ns), T_D the disk access time (~80 us),
T_L the software/network traversal time (~1 us) and T_F the per-event
driver overhead (~1 us; unnamed constant in the paper). The *shape* (linear
in N for vanilla, N-independent for direct) is the claim being reproduced,
so the constants are parameters.

Eq. 2 — per-snapshot metadata overhead of the scalable format::

    S_sq = S_vq + disk_size / cluster_size * l2_entry_size

Tiering (the paper's §6.3 memory headline, at fleet granularity):
``tier_residency`` snapshots the two-tier pool occupancy off a fleet and
its ``TieredStore``, and ``tiered_pool_bytes`` is the bytes-resident-per-
tenant model. ``golden_residency`` snapshots the golden registry's dedup
counters; the counters are read on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import format as fmt
from repro_torch.core.cache import SimTrace
from repro_torch.core.chain import ChainSpec


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Timing constants (seconds). Defaults are the paper's host values."""

    t_m: float = 100e-9   # cache/RAM probe
    t_d: float = 80e-6    # backing-store (disk/HBM) access
    t_l: float = 1e-6     # software + network layers
    t_f: float = 1e-6     # per hit-unallocated driver overhead


def eq1_average_cost(
    hit_pct: float,
    miss_pct: float,
    unal_pct: float,
    chain_length: int,
    c: CostConstants = CostConstants(),
) -> float:
    """Paper Eq. 1, verbatim."""
    return (
        hit_pct * c.t_m
        + miss_pct * (c.t_d + c.t_l + c.t_f)
        + unal_pct * c.t_f
    ) * chain_length


def eq2_snapshot_overhead_bytes(
    disk_size_bytes: int,
    cluster_size_bytes: int = 64 * 1024,
    l2_entry_size: int = 8,
    s_vq_bytes: int = 256 * 1024,
) -> int:
    """Paper Eq. 2: size of a fresh scalable snapshot file."""
    return s_vq_bytes + (disk_size_bytes // cluster_size_bytes) * l2_entry_size


def trace_latencies(trace: SimTrace, c: CostConstants = CostConstants()):
    """Per-request modelled lookup latency (seconds, float32) from simulated
    events.

    Every probe costs a T_M, every slice fetch a T_D + T_L, every
    hit-unallocated a T_F — the event-level form of Eq. 1 (which is its
    expectation over a request stream).
    """
    return (
        trace.probes.to(torch.float32) * c.t_m
        + trace.misses.to(torch.float32) * (c.t_d + c.t_l)
        + trace.hit_unallocated.to(torch.float32) * c.t_f
    )


@dataclasses.dataclass(frozen=True)
class TierResidency:
    """One observation of the two-tier pool occupancy."""

    device_rows: int      # pool rows currently leased to tenants (HBM)
    host_rows: int        # rows resident in the TieredStore cold tier
    cold_tenants: int     # tenants holding at least one demoted row
    demoted_rows: int     # lifetime device -> host transfers (pages)
    promoted_rows: int    # lifetime host -> device transfers (pages)


def tier_residency(fleet, store=None) -> TierResidency:
    """Tier-residency counters from a fleet (+ optional ``TieredStore``).

    The supported observability surface for tiering: benchmarks and tests
    assert on these instead of reading allocator internals. With
    ``store=None`` the host-side counters read as zero (an untiered fleet
    is just an all-device pool).
    """
    cold = fleet.cold_count.cpu()
    return TierResidency(
        device_rows=int(fleet.alloc_count.cpu().sum()),
        host_rows=0 if store is None else store.host_rows_in_use(),
        cold_tenants=int((cold > 0).sum()),
        demoted_rows=0 if store is None else store.demoted_rows,
        promoted_rows=0 if store is None else store.promoted_rows,
    )


@dataclasses.dataclass(frozen=True)
class GoldenResidency:
    """One observation of the golden-prefix dedup state (core plane)."""

    golden_chains: int       # registered content-addressed bases
    golden_forks: int        # live tenants forked off a base
    golden_rows_pinned: int  # distinct device rows pinned by bases
    dedup_rows_saved: int    # rows a dedup-free fleet would also hold


def golden_residency(registry) -> GoldenResidency:
    """Golden-registry counters off a ``core.golden.GoldenRegistry``.

    ``dedup_rows_saved`` sums, over every live fork, the shared rows the
    fork aliases instead of copying: the device rows a registry-free fleet
    would additionally lease to back the same tenants.
    """
    st = registry.stats()
    return GoldenResidency(
        golden_chains=st["golden_chains"],
        golden_forks=st["golden_forks"],
        golden_rows_pinned=st["golden_rows_pinned"],
        dedup_rows_saved=st["dedup_rows_saved"],
    )


def tiered_pool_bytes(spec: ChainSpec, chain_length: int,
                      rows_per_layer: int, *, tiered: bool) -> int:
    """Data-pool bytes resident on the device for one tenant at depth D.

    Each snapshot layer freezes ``rows_per_layer`` pool rows (the pages it
    wrote). All on the device, every layer's rows stay resident:
    ``D * rows_per_layer`` pages. Tiered, the steady state keeps only the
    active layer's rows hot — the demotion policy spills every immutable
    layer — so residency is ``rows_per_layer`` pages, independent of D.
    Index metadata is not included (see ``index_bytes``; it is the same in
    both configurations).
    """
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    rows = rows_per_layer * (1 if tiered else chain_length)
    return rows * spec.page_size * itemsize


def index_bytes(spec: ChainSpec, chain_length: int, *, scalable: bool) -> int:
    """On-disk index metadata bytes for a whole chain (Fig 19a analogue).

    Vanilla snapshots carry only L1 (+ lazily allocated L2 tables — the
    worst case is counted, as the paper's model does); scalable snapshots
    always carry the full copied-forward L2 set.
    """
    l1 = spec.n_l1 * 4
    l2_full = spec.n_pages * fmt.ENTRY_WORDS * 4
    per_snapshot = l1 + l2_full if scalable else l1
    return chain_length * per_snapshot
