"""The port's fleet read plane and host cold tier against ``repro.core.fleet``.

The op sequences of ``tests/test_tiering.py`` (demote/promote round trip,
COW writes while an ancestor is cold, ``free_tenant(store=)``, clone of a
cold tenant, ``compact`` with cold entries, the scheduler's demotion
policy interleaved with serving) replay on both packages from the same
numpy inputs. After every op the fleet's fields (L2 words, pool bytes,
leases, counts), the ``TieredStore`` rows, free list and counters, and
``fleet_stats`` must match bit for bit, and ``read`` (every method),
``materialize`` and ``read_tiered`` must give the same bytes and the same
``ResolveResult``; both packages' invariant suites must pass.

The serving plane's spill (``PagedKVCache.demote_seq``/``promote_seq``,
lazy promotion from every table-producing path) replays the KV cases of
the same file: block counts, host blocks, gathered K/V bytes, resolved
tables and the cache's fleet words must match after every op, in f32 and
in bf16 (held on the host as torch tensors, compared bytewise).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fleet as jfleet  # noqa: E402
from repro.core import invariants as jinv  # noqa: E402
from repro.core.scheduler import MaintenanceScheduler as JSched  # noqa: E402
from repro.core.store import TieredStore as JStore  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import invariants as tinv  # noqa: E402
from repro_torch.core.scheduler import MaintenanceScheduler as TSched  # noqa: E402
from repro_torch.core.store import TieredStore as TStore  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402

METHODS = ["vanilla", "gather", "direct", "auto", "pallas_vanilla",
           "pallas_direct"]
N_PAGES, PAGE = 32, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _bytes(x) -> np.ndarray:
    return _np(x).astype(np.float32).view(np.uint32)


def _grid(t):
    return np.broadcast_to(np.arange(N_PAGES, dtype=np.int32)[None],
                           (t, N_PAGES)).copy()


class FleetPair:
    """Both packages' fleets and cold tiers, advanced op by op and compared
    after each."""

    def __init__(self, *, scalable=True, max_chain=8, n_tenants=3):
        self.T = n_tenants
        kw = dict(n_tenants=n_tenants, n_pages=N_PAGES, page_size=PAGE,
                  max_chain=max_chain, pool_capacity=1024, lease_quantum=8,
                  l2_per_table=N_PAGES)
        self.jf = jfleet.create(jfleet.FleetSpec(dtype=jnp.float32, **kw),
                                scalable=jnp.asarray(scalable, bool))
        self.tf = tfleet.create(tfleet.FleetSpec(dtype=torch.float32, **kw),
                                scalable=scalable, device="cpu")
        self.js = JStore.for_fleet(self.jf.spec)
        self.ts = TStore.for_fleet(self.tf.spec)
        self.check()

    def check(self):
        for name in convert.FLEET_FIELDS:
            np.testing.assert_array_equal(_np(getattr(self.tf, name)),
                                          _np(getattr(self.jf, name)),
                                          err_msg=name)
        assert self.ts.stats() == self.js.stats()
        assert self.ts._free == self.js._free
        top = self.js._top
        np.testing.assert_array_equal(_bytes(self.ts.get(np.arange(top))),
                                      _bytes(self.js.get(np.arange(top))))
        assert tfleet.fleet_stats(self.tf) == jfleet.fleet_stats(self.jf)
        for k, v in jfleet.tenant_stats(self.jf).items():
            np.testing.assert_array_equal(tfleet.tenant_stats(self.tf)[k], v)
        ids = _grid(self.T)
        for m in METHODS:
            jd, jres = jfleet.read(self.jf, jnp.asarray(ids), method=m)
            td, tres = tfleet.read(self.tf, torch.as_tensor(ids), method=m)
            np.testing.assert_array_equal(_bytes(td), _bytes(jd), err_msg=m)
            for field, w, g in zip(jres._fields, jres, tres):
                np.testing.assert_array_equal(_np(g), _np(w),
                                              err_msg=f"{m}.{field}")
        np.testing.assert_array_equal(_bytes(tfleet.materialize(self.tf)),
                                      _bytes(jfleet.materialize(self.jf)))
        jd, _ = jfleet.read_tiered(self.jf, self.js, jnp.asarray(ids))
        td, _ = tfleet.read_tiered(self.tf, self.ts, torch.as_tensor(ids))
        np.testing.assert_array_equal(_bytes(td), _bytes(jd))
        jinv.check_fleet_invariants(self.jf, store=self.js)
        tinv.check_fleet_invariants(self.tf, store=self.ts)

    def grow(self, layers, *, writes=6, seed=0):
        rng = np.random.default_rng(seed)
        for layer in range(layers):
            ids = np.stack([rng.choice(N_PAGES, writes, replace=False)
                            for _ in range(self.T)]).astype(np.int32)
            data = rng.standard_normal((self.T, writes, PAGE)).astype(np.float32)
            self.write(ids, data)
            if layer < layers - 1:
                self.snapshot()

    def write(self, ids, data):
        self.jf = jfleet.write(self.jf, jnp.asarray(ids), jnp.asarray(data))
        self.tf = tfleet.write(self.tf, torch.as_tensor(ids), torch.as_tensor(data))
        self.check()

    def snapshot(self):
        self.jf = jfleet.snapshot(self.jf)
        self.tf = tfleet.snapshot(self.tf)
        self.check()

    def demote(self, tenants, **kw):
        self.jf, jrep = jfleet.demote_tenants(self.jf, self.js, tenants, **kw)
        self.tf, trep = tfleet.demote_tenants(self.tf, self.ts, tenants, **kw)
        assert trep == jrep
        self.check()
        return trep

    def promote(self, tenants, **kw):
        self.jf, jrep = jfleet.promote_tenants(self.jf, self.js, tenants, **kw)
        self.tf, trep = tfleet.promote_tenants(self.tf, self.ts, tenants, **kw)
        assert trep == jrep
        self.check()
        return trep

    def free(self, tenants):
        self.jf = jfleet.free_tenant(self.jf, tenants, store=self.js)
        self.tf = tfleet.free_tenant(self.tf, tenants, store=self.ts)
        self.check()

    def compact(self):
        self.jf = jfleet.compact(self.jf)
        self.tf = tfleet.compact(self.tf)
        self.check()

    def reads(self):
        data, res = tfleet.read(self.tf, torch.as_tensor(_grid(self.T)))
        return _bytes(data), res


@pytest.mark.parametrize("scalable", [True, False])
def test_demote_promote_roundtrip_bit_identical(scalable):
    p = FleetPair(scalable=scalable)
    p.grow(5, seed=1)
    before, _ = p.reads()
    rep = p.demote([0, 2])
    assert rep["rows_demoted"] > 0 and sorted(rep["tenants"]) == [0, 2]
    assert p.ts.host_rows_in_use() == rep["rows_demoted"]
    dev, res = p.reads()
    cold = res.cold.numpy()
    assert cold[[0, 2]].any() and not cold[1].any()
    assert not dev[cold].any()                 # +0.0 exactly where cold
    tiered, _ = tfleet.read_tiered(p.tf, p.ts, torch.as_tensor(_grid(p.T)))
    np.testing.assert_array_equal(_bytes(tiered), before)
    assert p.promote([0, 2])["rows_promoted"] == rep["rows_demoted"]
    assert p.ts.host_rows_in_use() == 0
    np.testing.assert_array_equal(p.reads()[0], before)


@pytest.mark.parametrize("scalable", [True, False])
def test_cow_write_while_ancestor_cold(scalable):
    p = FleetPair(scalable=scalable, n_tenants=2)
    p.grow(4, seed=3)
    assert p.demote(True)["rows_demoted"] > 0
    p.snapshot()
    p.write(np.asarray([[0, 1], [2, 3]], np.int32),
            np.full((2, 2, PAGE), 7.5, np.float32))
    p.promote(True)
    assert p.ts.host_rows_in_use() == 0


@pytest.mark.parametrize("scalable", [True, False])
def test_budgeted_demote_and_promote(scalable):
    """``max_rows`` caps each call: oldest layers first on demotion, the
    lowest host rows first on promotion, tenant by tenant."""
    p = FleetPair(scalable=scalable, max_chain=10)
    p.grow(7, seed=4)
    while p.demote(True, max_rows=5)["rows_demoted"]:
        pass
    while p.promote([2, 0, 1], max_rows=7)["rows_promoted"]:
        pass
    assert p.ts.host_rows_in_use() == 0


def test_free_tenant_returns_cold_rows():
    p = FleetPair()
    p.grow(4, seed=5)
    held = p.demote([0, 1])["rows_demoted"]
    assert p.ts.host_rows_in_use() == held > 0
    with pytest.raises(ValueError, match="host-tier rows"):
        tfleet.free_tenant(p.tf, [0])          # a cold tenant needs the store
    p.free([0])
    assert 0 < p.ts.host_rows_in_use() < held
    p.free([1])
    assert p.ts.host_rows_in_use() == 0
    assert tfleet.fleet_stats(p.tf)["cold_tenants"] == 0
    # freed host rows are recycled, not leaked: demoting again reuses them
    p.grow(3, seed=6)
    rep = p.demote(True)
    assert p.ts.host_rows_in_use() == rep["rows_demoted"]


def test_clone_refuses_cold_source():
    p = FleetPair()
    p.grow(3, seed=9)
    p.demote([0])
    for mod, f in ((jfleet, p.jf), (tfleet, p.tf)):
        with pytest.raises(ValueError, match="cold"):
            mod.clone_tenant(f, 0, 2)


def test_tenant_chain_view_reads_like_the_fleet():
    from repro_torch.core import store as tstore

    p = FleetPair(scalable=False)
    p.grow(4, seed=7)
    data, res = tfleet.read(p.tf, torch.as_tensor(_grid(p.T)), method="vanilla")
    for t in range(p.T):
        view = tfleet.tenant_chain(p.tf, t)
        assert int(view.pool_cursor) == p.tf.spec.pool_capacity
        d, r = tstore.read(view, torch.arange(N_PAGES), method="vanilla")
        np.testing.assert_array_equal(_bytes(d), _bytes(data[t]))
        np.testing.assert_array_equal(r.lookups.numpy(), res.lookups[t].numpy())
    tfleet.check_pool_capacity(p.tf)
    p.tf.overflow[1] = True
    with pytest.raises(RuntimeError, match=r"tenants \[1\]"):
        tfleet.check_pool_capacity(p.tf)


def test_compact_preserves_cold_entries():
    """A pool repack moves device rows only: cold entries keep their host
    row ptrs, and the tiered read is unchanged."""
    p = FleetPair()
    p.grow(4, seed=8)
    p.demote([1])
    before = _bytes(tfleet.read_tiered(p.tf, p.ts,
                                       torch.as_tensor(_grid(p.T)))[0])
    p.compact()
    after = _bytes(tfleet.read_tiered(p.tf, p.ts, torch.as_tensor(_grid(p.T)))[0])
    np.testing.assert_array_equal(after, before)
    assert p.ts.host_rows_in_use() > 0


@pytest.mark.parametrize("scalable", [True, False])
def test_scheduler_demotion_interleaved_with_serving(scalable):
    """Budgeted demotion ticks between serving writes and snapshots: every
    tick report, the fleet, the cold tier and ``stats()`` match, then the
    fleet converges to the device budget with its reads intact."""
    p = FleetPair(scalable=scalable, max_chain=12, n_tenants=4)
    kw = dict(stream_chain_threshold=10**6, device_page_budget=40,
              demote_rows_per_tick=7)
    js = JSched(p.jf, store=p.js, **kw)
    ts = TSched(p.tf, store=p.ts, **kw)
    rng = np.random.default_rng(7)

    def tick():
        jr, tr = js.tick(), ts.tick()
        assert tr == jr and tr["rows_demoted"] <= 7
        p.jf, p.tf = js.fleet, ts.fleet
        p.check()
        assert ts.stats() == js.stats()
        return tr

    for step in range(18):
        ids = np.stack([rng.choice(N_PAGES, 4, replace=False)
                        for _ in range(4)]).astype(np.int32)
        p.write(ids, rng.standard_normal((4, 4, PAGE)).astype(np.float32))
        if step % 3 == 2 and step < 15:
            p.snapshot()
        js.fleet, ts.fleet = p.jf, p.tf
        tick()
    tiered0 = _bytes(tfleet.read_tiered(p.tf, p.ts,
                                        torch.as_tensor(_grid(p.T)))[0])
    for _ in range(200):
        if ts._over_budget(tfleet.tenant_stats(ts.fleet)) == 0:
            break
        if not tick()["rows_demoted"]:
            break
    st = tfleet.tenant_stats(ts.fleet)
    assert ts._over_budget(st) == 0 or not ts._demote_candidates(st)
    assert ts.rows_demoted == p.ts.demoted_rows > 0
    tiered1 = _bytes(tfleet.read_tiered(p.tf, p.ts, torch.as_tensor(_grid(p.T)))[0])
    np.testing.assert_array_equal(tiered1, tiered0)


# -- serving plane: PagedKVCache spill -----------------------------------------


KV_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


class KVPair:
    """Both packages' KV caches, op by op; gathered K/V bytes, counters,
    resolved tables and the metadata fleet's words compared after each."""

    def __init__(self, scalable, dtypes=KV_DTYPES[0]):
        cfg = dict(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
                   n_blocks=64, max_blocks_per_seq=8)
        self.jdt, self.tdt = dtypes
        self.j = jpaged.PagedKVCache(jpaged.PagedKVConfig(dtype=self.jdt, **cfg),
                                     scalable=scalable)
        self.t = tpaged.PagedKVCache(tpaged.PagedKVConfig(dtype=self.tdt, **cfg),
                                     scalable=scalable, device="cpu")

    def both(self, op, *args, **kw):
        a = getattr(self.j, op)(*args, **kw)
        b = getattr(self.t, op)(*args, **kw)
        if not isinstance(a, tuple) and not hasattr(a, "shape"):
            assert b == a, op
        self.check()
        return b

    def append(self, sid, i, t):
        k = np.full((2, 2, 4), i * 100 + t, np.float32)
        self.j.append(sid, jnp.asarray(k, self.jdt), jnp.asarray(-k, self.jdt))
        self.t.append(sid, torch.as_tensor(k).to(self.tdt),
                      torch.as_tensor(-k).to(self.tdt))
        self.check()

    def gathered(self, sid):
        k, v = self.t.gather(sid)
        jk, jv = self.j.gather(sid)
        for got, want in ((k, jk), (v, jv)):
            np.testing.assert_array_equal(
                got.float().numpy().view(np.uint32),
                np.asarray(want, np.float32).view(np.uint32))
        return k.view(torch.uint8).clone()

    def check(self):
        j, t = self.j, self.t
        assert t.blocks_in_use() == j.blocks_in_use()
        assert t.host_blocks_in_use() == j.host_blocks_in_use()
        assert (t.demoted_blocks, t.promoted_blocks) == (j.demoted_blocks,
                                                         j.promoted_blocks)
        assert t._free == j._free and t.lookup_count == j.lookup_count
        np.testing.assert_array_equal(t._ref, j._ref)
        for sid, seq in j._seqs.items():
            tseq = t._seqs[sid]
            assert tseq.cold == seq.cold and tseq.refs == seq.refs
            np.testing.assert_array_equal(tseq.table, seq.table)
            if not seq.freed:
                self.gathered(sid)
        for name in ("l1", "l2", "length", "cold_count"):
            np.testing.assert_array_equal(_np(getattr(t.fleet, name)),
                                          _np(getattr(j.fleet, name)),
                                          err_msg=name)
        jinv.check_kv_invariants(j)
        tinv.check_kv_invariants(t)


@pytest.mark.parametrize("dtypes", KV_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("scalable", [True, False])
def test_kv_demote_promote_roundtrip(scalable, dtypes):
    p = KVPair(scalable, dtypes)
    a = p.both("new_seq")
    for t in range(10):
        p.append(a, 1, t)
    before = p.gathered(a)
    assert p.both("demote_seq", a) == 2           # the tail block stays
    assert torch.equal(p.gathered(a), before)     # read through the host tier
    p.both("block_table", a)                      # promotes lazily
    assert p.t.host_blocks_in_use() == 0 and not p.t._seqs[a].cold
    assert torch.equal(p.gathered(a), before)


@pytest.mark.parametrize("scalable", [True, False])
def test_kv_shared_blocks_never_spill(scalable):
    p = KVPair(scalable)
    a = p.both("new_seq")
    for t in range(10):
        p.append(a, 1, t)
    c = p.both("fork", a)
    assert p.both("demote_seq", a) == 0           # everything shared
    for t in range(6):
        p.append(c, 2, t)
    assert p.both("demote_seq", c) >= 1
    p.both("free_seq", c)                         # drops c's spill with it
    assert p.t.host_blocks_in_use() == 0
    assert p.both("demote_seq", a) == 2           # fork gone: exclusive
    p.both("fork", a)                             # promotes the parent
    assert not p.t._seqs[a].cold


@pytest.mark.parametrize("scalable", [True, False])
def test_kv_parked_seq_survives_batch_decodes(scalable):
    p = KVPair(scalable)
    a, b = p.both("new_seq"), p.both("new_seq")
    for t in range(9):
        p.append(a, 1, t)
        p.append(b, 2, t)
    assert p.both("demote_seq", a) == 2
    pad = p.both("reserve_block")
    for _ in range(3):                            # a parked, b decoding
        p.both("prepare_step", [b], pad_to=2, pad_block=pad)
        p.both("advance", b)
    assert p.t._seqs[a].cold
    p.both("prepare_step_fused", [a, b], pad_to=2, pad_block=pad)
    assert p.t.host_blocks_in_use() == 0          # promoted before resolve
    p.both("advance", a)
    p.both("advance", b)
    assert p.both("demote_seq", b, max_blocks=1) == 1
    p.both("prepare_step_single", b, pad_to=1)    # the narrow path promotes
    p.both("advance", b)
    assert p.both("demote_seq", a) == 2
    p.both("batched_tables", [a, b], pad_to=2, pad_block=pad)
    assert p.t.host_blocks_in_use() == 0
