"""The seeded storm on the port (``tests/scenario/harness_torch.py``):
both planes of ``repro_torch`` interleaved, the invariant suite after
every event and the data oracle on its cadence.

* **Lockstep against JAX.** The JAX harness and the port's run one
  config event by event (seed 0 for 200 events, seed 1 for 120). Every
  record is equal, and at every data check and at the end the two states
  are equal: both fleets' words and counters, the pool rows some entry
  references, the host rows in use, the registry's and the scheduler's
  stats, and both KV caches (each sequence's table, owner, length, cold
  set and tombstone flag, ``_ref``, ``_free`` and every live sequence's
  gathered K/V). A mismatch names the event, its record and the field.
* **The port's copies of ``tests/scenario/test_scenarios.py``'s gates**:
  smoke storms for seeds 0-2 at 200 events, guard hits, both planes and the golden plane
  exercised, replay determinism and diverging seeds, the 1,500-event
  soak (slow), and the six self-tests against the port's
  ``core/invariants.py``. Corruptions go to clones: the port's
  ``dataclasses.replace`` shares the fleet's tensors with the storm.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import fleet as fleet_lib  # noqa: E402
from repro_torch.core import format as fmt  # noqa: E402
from repro_torch.core.invariants import (  # noqa: E402
    check_fleet_invariants,
    check_kv_invariants,
    check_store_invariants,
)
from repro_torch.core.store import TieredStore  # noqa: E402
from repro_torch.kvcache.paged import PagedKVCache, PagedKVConfig  # noqa: E402

from tests.scenario import harness as jharness  # noqa: E402
from tests.scenario import harness_torch as ht  # noqa: E402
from tests.scenario.harness_torch import (  # noqa: E402
    ScenarioConfig,
    ScenarioHarness,
)

SMOKE_SEEDS = [0, 1, 2]
LOCKSTEP = {0: 200, 1: 120}
SMOKE_EVENTS = 200

def state_diffs(jh, th) -> list[str]:
    """Every field where the port's harness state differs from JAX's."""
    return ht.state_diffs(ht.state_of(jh), ht.state_of(th))


@pytest.mark.parametrize("seed", sorted(LOCKSTEP))
def test_lockstep_with_jax(seed):
    """Both harnesses on one config, event by event: equal records, and
    equal states at every data check and at the end."""
    events = LOCKSTEP[seed]
    jh = jharness.ScenarioHarness(
        jharness.ScenarioConfig(seed=seed, events=events))
    th = ScenarioHarness(ScenarioConfig(seed=seed, events=events,
                                        device="cpu"))
    every = th.config.check_data_every
    for i in range(1, events + 1):
        jr, tr = jh.step(), th.step()
        assert repr(tr) == repr(jr), (
            f"seed {seed} event {i}: port record {tr!r} != JAX {jr!r}")
        if i % every == 0 or i == events:
            diffs = state_diffs(jh, th)
            assert not diffs, (
                f"seed {seed} event {i} ({tr!r}): state differs from the "
                f"JAX harness in {diffs}")
    jh.check(data=True)
    th.check(data=True)
    assert repr(th.trace) == repr(jh.trace)
    assert th.stats() == jh.stats()
    assert state_diffs(jh, th) == []


def test_state_diffs_catch_a_drift():
    """The lockstep's comparison can fail: one drifted refcount, one
    rewritten pool row and one stolen host row are each named."""
    cfg = dict(seed=0, events=40)
    jh = jharness.ScenarioHarness(jharness.ScenarioConfig(**cfg))
    th = ScenarioHarness(ScenarioConfig(**cfg, device="cpu"))
    jh.run()
    th.run()
    assert state_diffs(jh, th) == []
    th.kv._ref[int(np.flatnonzero(th.kv._ref)[0])] += 1
    row = int(ht.referenced_rows(ht._words(th.fleet.l2),
                                 th.fleet.length.numpy())[0])
    th.fleet.pool[row] += 1.0
    th.dst_store._top += 1
    diffs = state_diffs(jh, th)
    assert {"kv._ref", "fleet.pool[referenced rows]",
            "dst_store._top"} <= set(diffs), diffs


@pytest.fixture(scope="module")
def storms():
    """One 200-event storm per smoke seed on the CPU; every event already
    ran the invariant suite (run() raises on the first violation)."""
    out = {}
    for seed in SMOKE_SEEDS:
        h = ScenarioHarness(ScenarioConfig(seed=seed, events=SMOKE_EVENTS,
                                           device="cpu"))
        h.run()
        out[seed] = h
    return out


@pytest.mark.parametrize("seed", SMOKE_SEEDS)
def test_smoke_storm(seed, storms):
    h = storms[seed]
    assert len(h.trace) == SMOKE_EVENTS
    assert h.stats()["invariant_checks"] >= SMOKE_EVENTS


def test_guard_events_fire(storms):
    assert sum(h.stats()["guard_hits"] for h in storms.values()) > 0


def test_storms_cover_both_planes(storms):
    for h in storms.values():
        kinds = {e[1] for e in h.trace}
        assert any(k.startswith("kv_") for k in kinds)
        assert any(not k.startswith("kv_") for k in kinds)
        assert "migrate" in kinds or "kv_migrate" in kinds


def test_storms_exercise_golden_plane(storms):
    kinds = {e[1] for h in storms.values() for e in h.trace}
    assert {"golden_register", "golden_fork", "golden_release"} <= kinds
    assert {"kv_golden_register", "kv_golden_admit",
            "kv_golden_release"} <= kinds
    assert any(e[1] == "golden_fork" and isinstance(e[-1], int)
               for h in storms.values() for e in h.trace)
    assert any(e[1] == "kv_golden_admit" and isinstance(e[-1], int)
               for h in storms.values() for e in h.trace)


def test_replay_determinism():
    cfg = ScenarioConfig(seed=7, events=120, device="cpu")
    assert ScenarioHarness(cfg).run() == ScenarioHarness(cfg).run()


def test_seeds_diverge():
    a = ScenarioHarness(ScenarioConfig(seed=1, events=60, device="cpu")).run()
    b = ScenarioHarness(ScenarioConfig(seed=2, events=60, device="cpu")).run()
    assert [e[1:] for e in a] != [e[1:] for e in b]


@pytest.mark.slow
def test_long_randomized_storm():
    for seed in range(3, 6):
        h = ScenarioHarness(ScenarioConfig(seed=seed, events=1500,
                                           device="cpu"))
        h.run()
        assert h.stats()["invariant_checks"] >= 1500


# -- self-tests: the port's suite must catch a deliberately broken fleet ------


def _cloned(fl, **fields):
    """``dataclasses.replace`` with every tensor cloned, then ``fields``:
    a corruption that never reaches the storm's shared tensors."""
    own = {f.name: getattr(fl, f.name).clone()
           for f in dataclasses.fields(fl)
           if isinstance(getattr(fl, f.name), torch.Tensor)}
    return dataclasses.replace(fl, **{**own, **fields})


@pytest.fixture(scope="module")
def grown(storms):
    return storms[SMOKE_SEEDS[0]]


def test_invariants_catch_stolen_lease(grown):
    fl = grown.fleet
    before = fl.lease_owner.clone()
    owner = fl.lease_owner.clone()
    held = torch.nonzero(owner >= 0).flatten()
    assert held.numel(), "storm left no leases to corrupt"
    owner[held[0]] = -1
    with pytest.raises(AssertionError):
        check_fleet_invariants(_cloned(fl, lease_owner=owner),
                               store=grown.store)
    assert torch.equal(grown.fleet.lease_owner, before)
    check_fleet_invariants(grown.fleet, store=grown.store,
                           registry=grown.registry)


def test_invariants_catch_foreign_row(grown):
    fl = grown.fleet
    owner = fl.lease_owner.cpu().numpy()
    held = np.flatnonzero(owner >= 0)
    assert held.size
    victim_q = int(held[0])
    thief = (int(owner[victim_q]) + 1) % fl.spec.n_tenants
    foreign = victim_q * fl.spec.lease_quantum
    broken = _cloned(fl)
    broken.l2[thief, 0, 0] = fmt.pack_entry(foreign, 0, allocated=True,
                                            bfi_valid=False)
    with pytest.raises(AssertionError):
        check_fleet_invariants(broken, store=grown.store)
    check_fleet_invariants(grown.fleet, store=grown.store,
                           registry=grown.registry)


def test_invariants_catch_cold_count_drift(grown):
    fl = grown.fleet
    broken = _cloned(fl)
    broken.cold_count[0] += 1
    with pytest.raises(AssertionError):
        check_fleet_invariants(broken, store=grown.store)
    check_fleet_invariants(grown.fleet, store=grown.store,
                           registry=grown.registry)


def test_invariants_catch_double_free_host_row():
    spec = fleet_lib.FleetSpec(n_tenants=2, n_pages=32, page_size=4,
                               max_chain=4, pool_capacity=64,
                               lease_quantum=8, l2_per_table=32)
    store = TieredStore.for_fleet(spec)
    rows = store.alloc(4)
    store.free(rows[:2])
    store._free.append(int(rows[0]))    # the deliberate corruption
    with pytest.raises(AssertionError):
        check_store_invariants(store)


def _small_cache():
    cfg = PagedKVConfig(n_layers=1, n_kv_heads=1, head_dim=4, block_size=4,
                        n_blocks=16, max_blocks_per_seq=4,
                        dtype=torch.float32)
    cache = PagedKVCache(cfg, scalable=False, device="cpu")
    sid = cache.new_seq()
    k = torch.zeros((1, 6, 1, 4), dtype=torch.float32)
    cache.append_prefill(sid, k, k)
    check_kv_invariants(cache)
    return cache, sid


def test_invariants_catch_refcount_drift():
    cache, _ = _small_cache()
    refd = np.flatnonzero(np.asarray(cache._ref) > 0)
    assert refd.size
    cache._ref[int(refd[0])] += 1       # the deliberate corruption
    with pytest.raises(AssertionError):
        check_kv_invariants(cache)


def test_invariants_catch_orphaned_spill():
    cache, sid = _small_cache()
    cache._cold_kv[sid] = {0: (torch.zeros(1), torch.zeros(1))}  # no seq.cold
    with pytest.raises(AssertionError):
        check_kv_invariants(cache)
