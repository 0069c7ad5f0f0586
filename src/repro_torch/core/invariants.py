"""The fleet's cross-plane invariant suite (PyTorch port of
``repro.core.invariants``) — shared by the tests and ``chip_smoke.py``.

These are the *structural* contracts that every maintenance, tiering,
serving and migration op must preserve, promoted out of the test files so
one implementation is checked everywhere:

* **Lease non-aliasing** (``check_fleet_invariants``): leases are
  disjoint, every hot L2 pointer sits inside its owner's quanta, and the
  allocator's free set is exactly the complement of the held set —
  the no-cross-tenant-aliasing property the lease-quantum allocator
  exists to provide (docs/architecture.md).
* **Cold-residency consistency**: a tenant's ``cold_count`` equals the
  number of distinct host rows its ``FLAG_COLD`` entries reference, cold
  rows never alias across tenants, and — given the ``TieredStore`` —
  every cold pointer addresses a live (allocated, un-freed) host row.
* **Free-list disjointness** (``TieredStore``): no host row is both free
  and referenced, and no row is on the free list twice.
* **Refcount/tombstone sanity** (``check_kv_invariants``): the serving
  plane's block refcounts equal the per-sequence reference sets, freed
  blocks are never refcounted, tombstones exist only while descendants
  pin them, and the host-spill bookkeeping (``seq.cold`` vs ``_cold_kv``)
  agrees.

All checks are host-side and raise ``AssertionError`` with a labelled
message on the first violation; they read fleet/store/cache state but
never mutate it. The KV cache's private fleet is a *metadata* plane whose
lease allocator is idle (see ``kvcache/paged.py``), so
``check_kv_invariants`` does not run the lease checks against it.

* **Golden bookkeeping**: given a ``GoldenRegistry``, a fork may alias
  exactly its base's pinned rows, and the registry's own check holds
  (frozen owners unchanged, pins equal to the live forks);
  ``check_kv_invariants`` holds the KV cache's golden registrations
  against the per-sequence flags.

Port notes: the state is read off the device once per check (the fleet's
tensors as host arrays); the checks themselves are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import format as fmt


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _entry_fields(entries: torch.Tensor):
    """Host (allocated, zero, cold) masks and ptrs of (..., 2) entries."""
    return tuple(_host(f(entries)) for f in (
        fmt.entry_allocated, fmt.entry_zero, fmt.entry_cold, fmt.entry_ptr))


def _cold_host_rows(entries: torch.Tensor) -> np.ndarray:
    """Distinct host rows a tenant's live COLD entries reference."""
    allocm, zerom, coldm, ptr = _entry_fields(entries)
    return np.unique(ptr[coldm & allocm & ~zerom].astype(np.int64))


def check_fleet_invariants(fl, *, store=None, check_leases: bool = True,
                           registry=None) -> None:
    """Assert the structural invariants of a ``ChainFleet`` (and, when
    given, the ``TieredStore`` behind it).

    ``check_leases=False`` skips the lease/row-ownership checks for
    fleets whose lease allocator is deliberately idle (the KV cache's
    metadata plane, where pool rows are refcounted block ids shared
    across tenant rows by design).

    ``registry`` (a ``core.golden.GoldenRegistry``) relaxes the
    no-cross-tenant-aliasing rule in exactly one place: a recorded golden
    *fork* may reference rows inside its base's pinned set, checked
    against the registry's per-fork row sets and the registry's own
    bookkeeping (``GoldenRegistry.check``). Without a registry, any
    foreign reference is corruption.
    """
    spec = fl.spec
    q = spec.lease_quantum
    owner = _host(fl.lease_owner)
    index = _host(fl.lease_index)
    count = _host(fl.lease_count)
    alloc = _host(fl.alloc_count)
    lengths = _host(fl.length)
    cold_count = _host(fl.cold_count)
    l2 = fl.l2.cpu()

    assert (lengths >= 1).all() and (lengths <= spec.max_chain).all(), \
        "chain length outside [1, max_chain]"

    held_all: list[int] = []
    cold_rows_by_tenant: dict[int, np.ndarray] = {}
    for t in range(spec.n_tenants):
        if check_leases:
            held = index[t, :count[t]]
            assert (held >= 0).all(), f"tenant {t} holds an unstitched lease"
            assert (owner[held] == t).all(), \
                f"tenant {t} lease/owner mismatch"
            assert (index[t, count[t]:] == -1).all(), \
                f"tenant {t} has quantum ids past its lease count"
            assert alloc[t] <= count[t] * q, \
                f"tenant {t} allocated more rows than its leases hold"
            held_all.extend(held.tolist())
        entries = l2[t, :int(lengths[t])]
        allocm, zerom, coldm, ptr = _entry_fields(entries)
        # COLD entries' ptrs address the host tier, not leased device rows
        live = allocm & ~zerom & ~coldm
        rows = ptr[live]
        if check_leases and rows.size:
            own = owner[rows // q] == t
            if not own.all():
                # legal exactly when t is a recorded golden fork and the
                # aliased rows sit inside its base's pinned set
                foreign = np.unique(rows[~own]).astype(np.int64)
                allowed = (registry.shared_rows_for(t)
                           if registry is not None else None)
                assert allowed is not None \
                    and np.isin(foreign, allowed).all(), (
                    f"tenant {t} references a foreign row outside any "
                    "registered golden base"
                )
        cold_rows = _cold_host_rows(entries)
        assert cold_rows.size == int(cold_count[t]), (
            f"tenant {t}: cold_count={int(cold_count[t])} but its L2 "
            f"references {cold_rows.size} distinct host rows"
        )
        if cold_rows.size:
            cold_rows_by_tenant[t] = cold_rows

    if check_leases:
        assert len(held_all) == len(set(held_all)), "quantum leased twice"
        assert sorted(held_all) == sorted(np.flatnonzero(owner >= 0).tolist()), \
            "allocator free set is not the complement of the held set"

    # cold host rows never alias across tenants (each demotion allocates
    # fresh store rows; sharing one would dangle on the first free)
    all_cold = np.concatenate(list(cold_rows_by_tenant.values())) \
        if cold_rows_by_tenant else np.zeros(0, np.int64)
    assert all_cold.size == np.unique(all_cold).size, \
        "host-tier row referenced by more than one tenant"

    if store is not None:
        check_store_invariants(store, referenced=all_cold)

    if registry is not None:
        # the registry's own bookkeeping: frozen owners unchanged, pinned
        # rows still lease-owned by their owner, layer refcounts == forks
        registry.check(fl)


def check_store_invariants(store, *, referenced=None) -> None:
    """``TieredStore`` free-list discipline: free rows are unique, inside
    the allocated range, and disjoint from ``referenced`` (the host rows
    the fleet's COLD entries still address)."""
    free = np.asarray(store._free, np.int64)
    top = store._top
    assert np.unique(free).size == free.size, "host row freed twice"
    if free.size:
        assert free.min() >= 0 and free.max() < top, \
            "free list holds a never-allocated host row"
    assert store.host_rows_in_use() >= 0, "more rows freed than allocated"
    if referenced is not None and len(referenced):
        ref = np.asarray(referenced, np.int64)
        assert ref.min() >= 0 and ref.max() < top, \
            "COLD entry references a never-allocated host row"
        assert not np.isin(ref, free).any(), \
            "COLD entry references a freed host row"


def check_kv_invariants(cache) -> None:
    """Refcount/tombstone/spill sanity of a ``PagedKVCache``.

    The block pool contract: ``_ref[b]`` equals the number of sequences
    (live or tombstoned) holding ``b`` in their reference set, free
    blocks are unreferenced and listed once, tombstones persist only
    while descendants pin them, live sequences own distinct tenant rows
    disjoint from the free-tenant list, and the host-spill sets agree
    between ``seq.cold`` and ``_cold_kv``.
    """
    n_blocks = cache.cfg.n_blocks
    expected = np.zeros(n_blocks, np.int64)
    for seq in cache._seqs.values():
        for b in seq.refs:
            assert 0 <= b < n_blocks, f"sid {seq.sid} refs bad block {b}"
            expected[b] += 1
    for b in cache._reserved:
        expected[b] += 1
    ref = _host(cache._ref).astype(np.int64)
    assert (ref == expected).all(), (
        "block refcounts drifted from the per-sequence reference sets at "
        f"blocks {np.flatnonzero(ref != expected).tolist()}"
    )

    free = list(cache._free)
    assert len(free) == len(set(free)), "KV block freed twice"
    for b in free:
        assert expected[b] == 0, f"block {b} is both free and referenced"

    children = {sid: 0 for sid in cache._seqs}
    for seq in cache._seqs.values():
        if seq.parent is not None and seq.parent in children:
            children[seq.parent] += 1
    for sid, seq in cache._seqs.items():
        assert seq.children == children[sid], (
            f"sid {sid}: children={seq.children} but {children[sid]} "
            "sequences name it as parent"
        )
        if seq.freed:
            # _reap removes freed leaves immediately: a surviving
            # tombstone must be pinned by at least one descendant
            assert seq.children > 0, f"unreaped childless tombstone {sid}"
            assert seq.tenant is None, f"tombstone {sid} still owns a row"
            assert sid not in cache._occupants, \
                f"tombstone {sid} still registered for write fan-out"
        else:
            assert seq.tenant is not None, f"live sid {sid} has no row"
            assert sid in cache._occupants, \
                f"live sid {sid} missing from the occupants registry"

    live_tenants = [s.tenant for s in cache._seqs.values() if not s.freed]
    assert len(live_tenants) == len(set(live_tenants)), \
        "two live sequences share a tenant row"
    assert not set(live_tenants) & set(cache._free_tenants), \
        "a live sequence's tenant row is on the free-tenant list"

    for sid, seq in cache._seqs.items():
        spilled = set(cache._cold_kv.get(sid, {}))
        assert seq.cold == spilled, (
            f"sid {sid}: cold set {sorted(seq.cold)} != host-tier keys "
            f"{sorted(spilled)}"
        )
    for sid in cache._cold_kv:
        assert sid in cache._seqs, f"host spill for unknown sid {sid}"

    # golden (shared-base) bookkeeping: the registration map and the
    # per-sequence flags agree, and a registered prefix is live, fully
    # device-resident, and every block it shares is refcounted
    golden = getattr(cache, "_golden", {})
    for sid in golden:
        assert sid in cache._seqs, f"golden registration for unknown sid {sid}"
        seq = cache._seqs[sid]
        assert not seq.freed, f"golden sid {sid} is tombstoned"
        assert not seq.cold, f"golden sid {sid} holds host-spilled blocks"
        assert seq.length > 0, f"golden sid {sid} is empty"
    for sid, seq in cache._seqs.items():
        flagged = bool(getattr(seq, "golden", False))
        assert flagged == (sid in golden), (
            f"sid {sid}: golden flag {flagged} disagrees with the "
            "registration map"
        )
        if flagged:
            for b in seq.refs:
                assert ref[b] >= 1, \
                    f"golden sid {sid} shares unreferenced block {b}"
