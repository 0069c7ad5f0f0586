"""The port's fleet maintenance plane against ``repro.core``: streaming
(``stream_tenants``), lease reclamation (``compact``) and the
``MaintenanceScheduler``.

The op sequences of ``tests/test_maintenance.py`` replay on both packages
from the same numpy inputs. After every op and every tick the fleet's
fields (L1/L2 words, pool bytes, leases, counts, flags) and
``fleet_stats`` must match bit for bit, reads must give the same bytes,
and both packages' ``check_fleet_invariants`` must pass; every scheduler
report, ``candidates()``, ``backlog()``, ``drain()`` count and ``stats()``
must be equal. Exact equality throughout: no tolerance.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fleet as jfleet  # noqa: E402
from repro.core.invariants import check_fleet_invariants as jcheck  # noqa: E402
from repro.core.scheduler import MaintenanceScheduler as JSched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core.invariants import check_fleet_invariants as tcheck  # noqa: E402
from repro_torch.core.scheduler import MaintenanceScheduler as TSched  # noqa: E402

N_PAGES, PAGE, MAXC = 64, 4, 8
METHODS = ("vanilla", "direct", "auto")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _bytes(x) -> np.ndarray:
    return _np(x).astype(np.float32).view(np.uint32)


def fleets_equal(jf, tf):
    for name in convert.FLEET_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tf, name)),
                                      _np(getattr(jf, name)), err_msg=name)
    assert tfleet.fleet_stats(tf) == jfleet.fleet_stats(jf)
    ids = np.broadcast_to(np.arange(N_PAGES, dtype=np.int32)[None],
                          (jf.spec.n_tenants, N_PAGES)).copy()
    for m in METHODS:
        jd, _ = jfleet.read(jf, jnp.asarray(ids), method=m)
        td, _ = tfleet.read(tf, torch.as_tensor(ids), method=m)
        np.testing.assert_array_equal(_bytes(td), _bytes(jd), err_msg=m)
    jcheck(jf)
    tcheck(tf)


class Pair:
    """Both packages' fleets, advanced op by op and compared after each."""

    def __init__(self, n_tenants, scalable, *, pool_capacity=2048,
                 lease_quantum=8, max_chain=MAXC):
        kw = dict(n_tenants=n_tenants, n_pages=N_PAGES, page_size=PAGE,
                  max_chain=max_chain, pool_capacity=pool_capacity,
                  lease_quantum=lease_quantum, l2_per_table=32)
        scal = np.broadcast_to(np.asarray(scalable, bool), (n_tenants,))
        self.jf = jfleet.create(jfleet.FleetSpec(**kw), scalable=jnp.asarray(scal))
        self.tf = tfleet.create(tfleet.FleetSpec(**kw), scalable=scal.copy(),
                                device="cpu")
        self.T = n_tenants
        self.check()

    def check(self):
        fleets_equal(self.jf, self.tf)

    def clone(self) -> "Pair":
        out = object.__new__(Pair)
        out.jf, out.T = self.jf, self.T
        out.tf = dataclasses.replace(
            self.tf, **{f: getattr(self.tf, f).clone()
                        for f in convert.FLEET_FIELDS})
        return out

    def write(self, ids, data, mask=None):
        ids = np.asarray(ids, np.int32)
        data = np.asarray(data, np.float32)
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(np.asarray(mask))
        self.jf = jfleet.write(self.jf, jnp.asarray(ids), jnp.asarray(data), jm)
        self.tf = tfleet.write(self.tf, torch.as_tensor(ids),
                               torch.as_tensor(data), tm)
        self.check()

    def snapshot(self, mask=None):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(np.asarray(mask))
        self.jf = jfleet.snapshot(self.jf, jm)
        self.tf = tfleet.snapshot(self.tf, tm)
        self.check()

    def stream(self, mask, upto, **kw):
        self.jf = jfleet.stream_tenants(self.jf, mask, upto, **kw)
        self.tf = tfleet.stream_tenants(self.tf, mask, upto, **kw)
        self.check()

    def compact(self, mask=None):
        self.jf = jfleet.compact(self.jf, mask)
        self.tf = tfleet.compact(self.tf, mask)
        self.check()

    def lengths(self):
        return self.tf.length.numpy().tolist()

    def grow(self, layers, *, writes=8, seed=0, mask=None):
        rng = np.random.default_rng(seed)
        for layer in range(layers):
            ids = np.stack([rng.choice(N_PAGES, writes, replace=False)
                            for _ in range(self.T)])
            self.write(ids, rng.standard_normal((self.T, writes, PAGE)), mask)
            if layer < layers - 1:
                self.snapshot(mask)


class SchedPair:
    """Both packages' schedulers over a ``Pair``'s fleets; every tick's
    report, the queue and the lifetime stats compared."""

    def __init__(self, pair: Pair, **kw):
        self.p = pair
        self.js = JSched(pair.jf, **kw)
        self.ts = TSched(pair.tf, **kw)
        self.check()

    def check(self):
        self.p.jf, self.p.tf = self.js.fleet, self.ts.fleet
        self.p.check()
        assert self.ts.candidates() == self.js.candidates()
        assert self.ts.backlog() == self.js.backlog()
        assert self.ts.stats() == self.js.stats()

    def tick(self):
        jr, tr = self.js.tick(), self.ts.tick()
        assert tr == jr
        self.check()
        return tr

    def drain(self, **kw):
        n = self.js.drain(**kw)
        assert self.ts.drain(**kw) == n
        self.check()
        return n

    def serve(self, op, *args):
        """A serving op on the scheduler's fleet (write / snapshot)."""
        self.p.jf, self.p.tf = self.js.fleet, self.ts.fleet
        getattr(self.p, op)(*args)
        self.js.fleet, self.ts.fleet = self.p.jf, self.p.tf


# -- stream_tenants, compact ---------------------------------------------------


@pytest.mark.parametrize("scalable", [True, False])
@pytest.mark.parametrize("merge_upto", [0, 1, 3])
def test_stream_single_tenant(scalable, merge_upto):
    p = Pair(3, scalable)
    p.grow(5, seed=1)
    p.stream(np.asarray([False, True, False]), merge_upto)
    assert p.lengths() == [5, 5 - merge_upto, 5]


@pytest.mark.parametrize("reclaim", [True, False])
def test_stream_mixed_formats_and_reclaim_flag(reclaim):
    p = Pair(3, [True, False, True])
    p.grow(5, seed=4)
    p.stream(True, np.asarray([2, 3, 0]), reclaim=reclaim)
    assert p.lengths() == [3, 2, 5]


def test_stream_skips_tenants_it_cannot_merge():
    p = Pair(2, True)
    p.grow(3, seed=2)
    p.snapshot(np.asarray([True, False]))            # lengths 4, 3
    p.stream(True, 2)                                # valid for t0 only
    assert p.lengths() == [2, 3]


def test_stream_reclaims_quanta_to_free_list():
    p = Pair(4, True, pool_capacity=1024)
    ids = np.broadcast_to(np.arange(8)[None], (4, 8))
    for layer in range(5):        # same 8 pages overwritten 5x: 4/5 garbage
        p.write(ids, np.full((4, 8, PAGE), float(layer + 1)))
        if layer < 4:
            p.snapshot()
    free0 = tfleet.fleet_stats(p.tf)["quanta_free"]
    p.stream(True, np.asarray(p.lengths()) - 2)
    assert p.tf.alloc_count.tolist() == [16] * 4
    assert p.tf.lease_count.tolist() == [2] * 4
    assert tfleet.fleet_stats(p.tf)["quanta_free"] == free0 + 3 * 4
    p.write(ids + 16, np.full((4, 8, PAGE), 9.0))    # freed quanta re-lease
    assert not p.tf.overflow.any()


def test_compact_reclaims_cow_garbage_and_overflow_clears_iff_reclaimed():
    p = Pair(2, True, pool_capacity=48, lease_quantum=8)
    ids = np.broadcast_to(np.arange(8)[None], (2, 8))
    for v in (1.0, 2.0, 3.0):
        p.write(ids, np.full((2, 8, PAGE), v))
    p.write(ids + 8, np.full((2, 8, PAGE), 4.0))     # nowhere to go
    assert p.tf.overflow.all()
    p.compact()
    assert not p.tf.overflow.any()
    counts = p.tf.alloc_count.clone()
    p.compact()                                      # converged
    assert torch.equal(p.tf.alloc_count, counts)


def test_overflow_stays_latched_when_nothing_reclaimable():
    p = Pair(1, True, pool_capacity=8, lease_quantum=8)
    ids = np.arange(8)[None]
    p.write(ids, np.ones((1, 8, PAGE)))
    p.write(ids + 8, np.ones((1, 8, PAGE)))          # all dropped
    p.compact()
    assert bool(p.tf.overflow[0]) and int(p.tf.alloc_count[0]) == 8


def test_snap_dropped_clears_iff_streaming_made_room():
    p = Pair(1, True, max_chain=3)
    p.write(np.arange(4)[None], np.ones((1, 4, PAGE)))
    for _ in range(3):
        p.snapshot()                                 # the third is dropped
    still = p.clone()
    still.stream(True, 0)
    assert bool(still.tf.snap_dropped[0])
    p.stream(True, 1)
    assert not bool(p.tf.snap_dropped[0]) and p.lengths() == [2]


def test_reclaimed_quanta_reacquired_without_aliasing():
    p = Pair(2, True, pool_capacity=48, lease_quantum=8)
    ids8 = np.arange(8)
    t0 = np.asarray([True, False])
    for layer in range(4):
        p.write(np.stack([ids8, ids8]), np.full((2, 8, PAGE), float(layer + 1)),
                t0)
        if layer < 3:
            p.snapshot(t0)
    p.stream(t0, np.asarray(p.lengths()) - 2)
    assert int(p.tf.lease_count[0]) == 2
    for i in range(4):
        p.write(np.stack([ids8, ids8 + 8 * i]), np.full((2, 8, PAGE), 8.0 + i),
                ~t0)
    assert not p.tf.overflow.any() and int(p.tf.lease_count[1]) == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_maintenance_ops(seed):
    """Seeded write / snapshot / stream / compact interleavings (the
    property test's op mix) on mixed-format fleets."""
    rng = np.random.default_rng(seed)
    p = Pair(3, rng.random(3) < 0.5, pool_capacity=512)
    for _ in range(10):
        kind = rng.choice(["write", "snapshot", "stream", "compact"])
        mask = rng.random(3) < 0.6
        if kind == "write":
            ids = np.stack([rng.choice(N_PAGES, 6, replace=False)
                            for _ in range(3)])
            p.write(ids, rng.standard_normal((3, 6, PAGE)), mask)
        elif kind == "snapshot":
            p.snapshot(mask)
        elif kind == "stream":
            p.stream(mask, int(rng.integers(0, MAXC)))
        else:
            p.compact(mask)


# -- MaintenanceScheduler ------------------------------------------------------


def busy(n_tenants=6, layers=5, seed=3):
    p = Pair(n_tenants, True, pool_capacity=4096)
    p.grow(layers, seed=seed)
    return p


def test_scheduler_budget_and_drain():
    s = SchedPair(busy(), max_tenants_per_tick=2)
    rep = s.tick()
    assert len(rep["streamed"]) == 2 and rep["backlog"] == 4
    assert s.drain() == 2
    assert s.p.lengths() == [2] * 6
    assert s.ts.stats()["quanta_reclaimed"] > 0 and s.ts.candidates() == []


def test_scheduler_prefers_longest_chains():
    p = busy(n_tenants=4, layers=3)
    p.snapshot(np.asarray([False, True, False, False]))
    p.write(np.broadcast_to(np.arange(4)[None], (4, 4)), np.ones((4, 4, PAGE)))
    s = SchedPair(p, max_tenants_per_tick=1)
    assert s.ts.candidates()[0] == 1
    s.tick()
    assert s.p.lengths()[1] == 2


def test_scheduler_compacts_wedged_tenants():
    p = Pair(1, True, pool_capacity=24, lease_quantum=8)
    ids = np.arange(8)[None]
    for v in (1.0, 2.0, 3.0, 4.0):                   # the last overflows
        p.write(ids, np.full((1, 8, PAGE), v))
    s = SchedPair(p, max_tenants_per_tick=1)
    assert s.ts.candidates() == [] and s.ts.backlog() == 1
    assert s.tick()["compacted"]
    s.serve("write", ids, np.full((1, 8, PAGE), 4.0))
    assert not s.ts.fleet.overflow.any()


@pytest.mark.parametrize("compact_on_overflow", [True, False])
def test_scheduler_parks_unhelpable_tenants(compact_on_overflow):
    p = Pair(1, True, pool_capacity=8, lease_quantum=8)
    ids = np.arange(8)[None]
    p.write(ids, np.ones((1, 8, PAGE)))              # pool full, live
    p.write(ids + 8, np.ones((1, 8, PAGE)))          # dropped
    p.snapshot()
    s = SchedPair(p, max_tenants_per_tick=1,
                  compact_on_overflow=compact_on_overflow)
    first = s.tick()
    assert first["compacted"] == compact_on_overflow
    assert s.drain(max_ticks=10) == 0                # parked, not spinning
    s.tick()
    s.serve("snapshot")                              # un-parks the tenant
    assert s.ts.candidates() == [0]
    s.tick()


def test_scheduler_converges_at_threshold_two():
    s = SchedPair(busy(), max_tenants_per_tick=2, stream_chain_threshold=2)
    s.drain(max_ticks=20)
    assert s.p.lengths() == [2] * 6
    rep = s.tick()
    assert rep["streamed"] == [] and not rep["compacted"]


def test_reads_unperturbed_mid_maintenance():
    p = busy()
    before = _bytes(tfleet.materialize(p.tf))
    s = SchedPair(p, max_tenants_per_tick=1)
    for _ in range(8):
        if s.ts.candidates():
            s.tick()
        np.testing.assert_array_equal(_bytes(tfleet.materialize(s.ts.fleet)),
                                      before)


@pytest.mark.parametrize("aging_weight", [0, 1])
def test_scheduler_aging(aging_weight):
    """The starvation guard: heavy tenants regrow after every pick; with
    aging the modest tenant is served, without it it starves."""
    p = busy(n_tenants=4, layers=4, seed=5)
    rng = np.random.default_rng(6)

    def regrow(s, tenants, layers):
        mask = np.zeros(4, bool)
        mask[tenants] = True
        while max(s.ts.fleet.length[tenants].tolist()) < layers:
            ids = np.stack([rng.choice(N_PAGES, 4, replace=False)
                            for _ in range(4)])
            s.serve("write", ids, rng.standard_normal((4, 4, PAGE)), mask)
            s.serve("snapshot", mask)

    s = SchedPair(p, max_tenants_per_tick=1, aging_weight=aging_weight)
    regrow(s, [1, 2, 3], 7)
    s.check()
    picked = []
    for _ in range(12):
        rep = s.tick()
        picked += rep["streamed"]
        if 0 in picked:
            break
        heavy = [t for t in rep["streamed"] if t != 0]
        if heavy:
            regrow(s, heavy, 7)
    assert (0 in picked) == bool(aging_weight)
