"""The port's golden-prefix plane against ``repro.core.golden`` and the JAX
serving plane.

Every case of ``tests/test_golden.py`` replays on both packages from the
same numpy inputs:

* ``PrefixTrie``: every lookup, insert and remove gives the same answer;
* the fleet registry (``GoldenRegistry`` with ``free_tenant``,
  ``stream_tenants``, ``compact``, ``demote_tenants``, the scheduler and
  ``check_fleet_invariants(registry=)``): after every op the fleet's
  fields, the ``TieredStore``, every tenant's migration fingerprint, the
  registry's chains (content hashes, pinned rows, pins), ``stats()`` and
  ``golden_residency`` equal the JAX package's, and both invariant suites
  pass (or both raise);
* the KV cache (``register_golden``, frozen writes, forks, ``golden_stats``,
  ``prepare_step_single``): content hashes, ``golden_stats()``, gathered
  K/V bytes and resolved tables equal the JAX package's, in float32 and,
  for the digest, in bfloat16;
* the engine: golden admission (trie probe, fork, ``_suffix_prefill``)
  emits the JAX engine's tokens on both fork formats, in float32 compute
  (bf16 rounds at other places in the two frameworks); within one package
  a hit's K/V are bitwise a duplicate-storage admission's, across the two
  they agree to float32 rounding (XLA and PyTorch order matmul sums
  differently).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import invariants as jinv  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import migrate as jmigrate  # noqa: E402
from repro.core.golden import GoldenRegistry as JReg  # noqa: E402
from repro.core.golden import PrefixTrie as JTrie  # noqa: E402
from repro.core.scheduler import MaintenanceScheduler as JSched  # noqa: E402
from repro.core.store import TieredStore as JStore  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import invariants as tinv  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import migrate as tmigrate  # noqa: E402
from repro_torch.core.golden import GoldenRegistry as TReg  # noqa: E402
from repro_torch.core.golden import PrefixTrie as TTrie  # noqa: E402
from repro_torch.core.scheduler import MaintenanceScheduler as TSched  # noqa: E402
from repro_torch.core.store import TieredStore as TStore  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

N_PAGES, PAGE = 32, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x.view(np.int32)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# -- PrefixTrie ---------------------------------------------------------------


class TriePair:
    def __init__(self):
        self.j, self.t = JTrie(), TTrie()

    def __getattr__(self, op):
        """Apply ``op`` to both tries: the same result, or the same error
        (returned as its type)."""
        def both(*args):
            outs = []
            for trie in (self.j, self.t):
                try:
                    outs.append(getattr(trie, op)(*args))
                except (KeyError, ValueError) as e:
                    outs.append(type(e))
            assert outs[0] == outs[1], op
            assert len(self.j) == len(self.t)
            return outs[1]
        return both


def test_trie_longest_prefix_picks_deepest():
    t = TriePair()
    t.insert([1, 2], "short")
    t.insert([1, 2, 3, 4], "long")
    assert t.longest_prefix([1, 2, 3, 4, 9]) == (4, "long")
    assert t.longest_prefix([1, 2, 3]) == (2, "short")
    assert t.longest_prefix([1, 9]) == (0, None)
    assert len(t.t) == 2


def test_trie_edge_split_on_divergence():
    t = TriePair()
    t.insert([5, 6, 7, 8], "a")
    t.insert([5, 6, 9], "b")       # splits the compressed [5,6,7,8] edge
    assert t.longest_prefix([5, 6, 7, 8]) == (4, "a")
    assert t.longest_prefix([5, 6, 9, 1]) == (3, "b")
    assert t.longest_prefix([5, 6]) == (0, None)


def test_trie_remove_and_guards():
    t = TriePair()
    t.insert([1, 2, 3], "x")
    assert t.insert([], "empty") is ValueError
    assert t.insert([1, 2, 3], "other") is ValueError   # same key, new value
    t.remove([1, 2, 3])
    assert t.longest_prefix([1, 2, 3]) == (0, None)
    assert len(t.t) == 0
    assert t.remove([1, 2, 3]) is KeyError


# -- fleet-plane registry -----------------------------------------------------


def _same_registry(j, t):
    assert t._owners == j._owners and t._forks == j._forks
    assert t._by_hash == j._by_hash and t._next_gid == j._next_gid
    assert sorted(t._chains) == sorted(j._chains)
    for gid, jc in j._chains.items():
        tc = t._chains[gid]
        assert (tc.gid, tc.tenant, tc.length, tc.layer_hashes, tc.fingerprint) \
            == (jc.gid, jc.tenant, jc.length, jc.layer_hashes, jc.fingerprint)
        assert len(tc.cum_rows) == len(jc.cum_rows)
        for a, b in zip(tc.cum_rows, jc.cum_rows):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tc.layer_refs, jc.layer_refs)
    assert t.stats() == j.stats()
    assert dataclasses.asdict(tmetrics.golden_residency(t)) == \
        dataclasses.asdict(jmetrics.golden_residency(j))


class GPair:
    """Both packages' fleets, cold tiers and golden registries: the port's
    fleet starts as ``convert.fleet_from_numpy`` of the JAX one, then every
    op runs on both and ``check`` compares everything after it."""

    def __init__(self, n_tenants=4, *, scalable=True, pool_capacity=512,
                 max_chain=6, store=False):
        kw = dict(n_tenants=n_tenants, n_pages=N_PAGES, page_size=PAGE,
                  max_chain=max_chain, pool_capacity=pool_capacity,
                  lease_quantum=8, l2_per_table=N_PAGES)
        self.T = n_tenants
        self.jf = jfleet.create(jfleet.FleetSpec(**kw),
                                scalable=jnp.asarray(scalable, bool))
        self.tf = convert.fleet_from_numpy(
            tfleet.FleetSpec(**kw),
            {n: np.asarray(getattr(self.jf, n)) for n in convert.FLEET_FIELDS},
            device="cpu")
        self.js = JStore.for_fleet(self.jf.spec) if store else None
        self.ts = TStore.for_fleet(self.tf.spec) if store else None
        self.jreg, self.treg = JReg(), TReg()

    def check(self, *, invariants=True):
        for name in convert.FLEET_FIELDS:
            np.testing.assert_array_equal(_np(getattr(self.tf, name)),
                                          _np(getattr(self.jf, name)),
                                          err_msg=name)
        if self.js is not None:
            assert self.ts.stats() == self.js.stats()
            assert self.ts._free == self.js._free
        for t in range(self.T):
            assert tmigrate.tenant_fingerprint(self.tf, t) == \
                jmigrate.tenant_fingerprint(self.jf, t)
        _same_registry(self.jreg, self.treg)
        if invariants:
            jinv.check_fleet_invariants(self.jf, store=self.js, registry=self.jreg)
            tinv.check_fleet_invariants(self.tf, store=self.ts, registry=self.treg)

    def write(self, t_mask, ids, data):
        self.jf = jfleet.write(self.jf, jnp.asarray(ids), jnp.asarray(data),
                               jnp.asarray(t_mask))
        self.tf = tfleet.write(self.tf, torch.as_tensor(ids),
                               torch.as_tensor(data), torch.as_tensor(t_mask))

    def snapshot(self, mask):
        self.jf = jfleet.snapshot(self.jf, jnp.asarray(mask))
        self.tf = tfleet.snapshot(self.tf, torch.as_tensor(mask))

    def grow(self, t, layers, *, writes=6, seed=0):
        """``tests/test_golden.py``'s ``write_layers``: write + snapshot
        ``layers`` times on tenant ``t`` only, with tenant-independent
        bytes; returns the tenant's expected page -> row view."""
        rng = np.random.default_rng(seed)
        mask = np.zeros(self.T, bool)
        mask[t] = True
        view = {}
        for layer in range(layers):
            ids = np.broadcast_to(
                rng.choice(N_PAGES, writes, replace=False).astype(np.int32),
                (self.T, writes)).copy()
            data = np.broadcast_to(
                rng.standard_normal((writes, PAGE)).astype(np.float32),
                (self.T, writes, PAGE)).copy()
            self.write(mask, ids, data)
            for i in range(writes):
                view[int(ids[t, i])] = data[t, i].copy()
            if layer < layers - 1:
                self.snapshot(mask)
        return view

    def register(self, t):
        got = (self.jreg.register(self.jf, t, store=self.js),
               self.treg.register(self.tf, t, store=self.ts))
        assert got[0] == got[1]
        return got[1]

    def fork(self, gid, dst, **kw):
        self.jf = self.jreg.fork(self.jf, gid, dst, store=self.js, **kw)
        self.tf = self.treg.fork(self.tf, gid, dst, store=self.ts, **kw)

    def free(self, t):
        self.jf = jfleet.free_tenant(self.jf, t, store=self.js, registry=self.jreg)
        self.tf = tfleet.free_tenant(self.tf, t, store=self.ts, registry=self.treg)

    def raises(self, exc, match, jcall, tcall):
        """Both packages refuse the same op with the same error; nothing
        moved."""
        with pytest.raises(exc, match=match):
            jcall()
        with pytest.raises(exc, match=match):
            tcall()
        self.check()

    def view(self, t):
        ids = np.broadcast_to(np.arange(N_PAGES, dtype=np.int32), (self.T, N_PAGES))
        jv = np.asarray(jfleet.read(self.jf, jnp.asarray(ids))[0])[t]
        tv = tfleet.read(self.tf, torch.as_tensor(ids.copy()))[0][t].numpy()
        np.testing.assert_array_equal(tv, jv)
        return tv


def view_from(pages):
    out = np.zeros((N_PAGES, PAGE), np.float32)
    for p, row in pages.items():
        out[p] = row
    return out


@pytest.mark.parametrize("scalable", [False, True])
def test_register_is_content_addressed(scalable):
    """Two tenants written identically hash to the same gid although their
    pool rows differ; a third, different tenant does not."""
    p = GPair(scalable=scalable)
    p.grow(0, 3, seed=1)
    p.grow(1, 3, seed=1)
    p.grow(2, 3, seed=2)
    p.check()
    gid0, created0 = p.register(0)
    gid1, created1 = p.register(1)
    gid2, created2 = p.register(2)
    assert created0 and not created1 and created2
    assert gid0 == gid1 != gid2
    assert p.treg.is_golden_owner(0) and not p.treg.is_golden_owner(1)
    p.check()


@pytest.mark.parametrize("scalable", [False, True])
def test_fork_aliases_base_and_overlays_cow(scalable):
    p = GPair(scalable=scalable)
    base_view = p.grow(0, 3, seed=3)
    gid, _ = p.register(0)
    p.fork(gid, 2)
    p.check()
    np.testing.assert_array_equal(p.view(2), view_from(base_view))
    # COW overlay: the fork writes, the frozen base must not move
    mask = np.zeros(4, bool)
    mask[2] = True
    ids = np.zeros((4, 2), np.int32)
    ids[2] = [0, 1]
    p.write(mask, ids, np.full((4, 2, PAGE), 9.0, np.float32))
    p.check()
    got = p.view(2)
    assert (got[0] == 9.0).all() and (got[1] == 9.0).all()
    np.testing.assert_array_equal(p.view(0), view_from(base_view))
    st = p.treg.stats()
    assert st["golden_forks"] == 1 and st["dedup_rows_saved"] > 0
    assert tmetrics.golden_residency(p.treg).golden_chains == 1


def test_partial_depth_fork_pins_only_lower_layers():
    p = GPair(scalable=True)
    p.grow(0, 4, seed=4)
    gid, _ = p.register(0)
    p.fork(gid, 1, depth=2)
    ch = p.treg._chains[gid]
    np.testing.assert_array_equal(ch.layer_refs, [1, 1, 0, 0])
    shared = p.treg.shared_rows_for(1)
    np.testing.assert_array_equal(shared, p.jreg.shared_rows_for(1))
    np.testing.assert_array_equal(shared, ch.cum_rows[1])
    assert shared.size < ch.rows.size   # deeper layers are NOT pinned
    p.check()
    assert p.treg.release(1) == p.jreg.release(1) == gid
    assert not ch.layer_refs.any()
    # tenant 1 still aliases the base, now unrecorded: state only
    p.check(invariants=False)


def test_lifecycle_guards():
    p = GPair()
    p.grow(0, 2, seed=5)
    gid, _ = p.register(0)
    p.fork(gid, 1)
    p.check()
    # a frozen owner cannot be freed while registered
    p.raises(ValueError, "golden",
             lambda: jfleet.free_tenant(p.jf, 0, registry=p.jreg),
             lambda: tfleet.free_tenant(p.tf, 0, registry=p.treg))
    # a fork aliases foreign rows: it can never itself be registered
    p.raises(ValueError, "fork", lambda: p.jreg.register(p.jf, 1),
             lambda: p.treg.register(p.tf, 1))
    # an owner/fork slot is not a legal fork destination
    p.raises(ValueError, "slot", lambda: p.jreg.fork(p.jf, gid, 1),
             lambda: p.treg.fork(p.tf, gid, 1))
    # a pinned chain cannot be unregistered
    p.raises(ValueError, "forks", lambda: p.jreg.unregister(gid),
             lambda: p.treg.unregister(gid))
    p.raises(ValueError, "depth", lambda: p.jreg.fork(p.jf, gid, 2, depth=99),
             lambda: p.treg.fork(p.tf, gid, 2, depth=99))
    # freeing the fork releases its pins; then the chain can go
    p.free(1)
    p.check()
    p.jreg.unregister(gid)
    p.treg.unregister(gid)
    p.free(0)
    p.check()


@pytest.mark.parametrize("scalable", [False, True])
def test_maintenance_preserves_frozen_base(scalable):
    """compact + stream + demote with the registry leave the owner
    bit-frozen and every fork's view intact, on both packages alike."""
    p = GPair(scalable=scalable, store=True)
    base_view = p.grow(0, 3, seed=6)
    p.grow(3, 3, seed=7)                      # churn neighbour
    gid, _ = p.register(0)
    fp = p.treg._chains[gid].fingerprint
    p.fork(gid, 1)
    p.check()
    p.jf = jfleet.compact(p.jf, registry=p.jreg)
    p.tf = tfleet.compact(p.tf, registry=p.treg)
    p.check()
    p.jf = jfleet.stream_tenants(p.jf, np.ones(4, bool), 1, registry=p.jreg)
    p.tf = tfleet.stream_tenants(p.tf, np.ones(4, bool), 1, registry=p.treg)
    p.check()
    p.jf, jrep = jfleet.demote_tenants(p.jf, p.js, [0, 1, 3], registry=p.jreg)
    p.tf, trep = tfleet.demote_tenants(p.tf, p.ts, [0, 1, 3], registry=p.treg)
    assert trep == jrep
    p.check()
    assert tmigrate.tenant_fingerprint(p.tf, 0) == fp
    np.testing.assert_array_equal(p.view(1), view_from(base_view))
    # the neighbour DID demote: the exclusion is per row, not global
    assert trep["rows_demoted"] > 0


def test_demote_fork_race_never_spills_pinned_rows():
    """A fork's lower layers are immutable-below-active, demotion's
    eligibility shape, but spilling them would pull the base from under
    every sibling fork: neither package spills them, by call or by the
    scheduler's budget-pressure policy."""
    p = GPair(scalable=True, store=True)
    p.grow(0, 3, seed=8)
    gid, _ = p.register(0)
    p.fork(gid, 1)
    p.snapshot(np.asarray([False, True, False, False]))
    p.check()
    for tenants in ([0], [1]):
        p.jf, jrep = jfleet.demote_tenants(p.jf, p.js, tenants, registry=p.jreg)
        p.tf, trep = tfleet.demote_tenants(p.tf, p.ts, tenants, registry=p.treg)
        assert trep == jrep and trep["rows_demoted"] == 0
        p.check()
    assert int(p.tf.cold_count[0]) == 0 and int(p.tf.cold_count[1]) == 0
    kw = dict(device_page_budget=1, demote_rows_per_tick=64)
    js = JSched(p.jf, store=p.js, registry=p.jreg, **kw)
    ts = TSched(p.tf, store=p.ts, registry=p.treg, **kw)
    for _ in range(4):
        assert ts.tick() == js.tick()
        p.jf, p.tf = js.fleet, ts.fleet
        p.check()
    assert ts.stats() == js.stats()
    assert tmigrate.tenant_fingerprint(p.tf, 0) == p.treg._chains[gid].fingerprint


def test_invariants_catch_mutated_frozen_owner():
    p = GPair()
    p.grow(0, 2, seed=9)
    p.register(0)
    mask = np.zeros(4, bool)
    mask[0] = True
    p.write(mask, np.zeros((4, 1), np.int32),
            np.ones((4, 1, PAGE), np.float32))   # write on a frozen base
    p.check(invariants=False)
    for inv, fl, reg in ((jinv, p.jf, p.jreg), (tinv, p.tf, p.treg)):
        with pytest.raises(AssertionError, match="mutated"):
            inv.check_fleet_invariants(fl, registry=reg)


def test_invariants_catch_refcount_drift():
    p = GPair()
    p.grow(0, 2, seed=10)
    gid, _ = p.register(0)
    p.fork(gid, 1)
    p.check()
    for inv, fl, reg in ((jinv, p.jf, p.jreg), (tinv, p.tf, p.treg)):
        reg._chains[gid].layer_refs[0] += 1          # the deliberate drift
        with pytest.raises(AssertionError, match="refcounts"):
            inv.check_fleet_invariants(fl, registry=reg)


# -- serving plane: PagedKVCache ---------------------------------------------


class KVPair:
    """A JAX and a port ``PagedKVCache`` driven by the same ops."""

    def __init__(self, scalable, *, dtype="float32", n_blocks=64, max_blocks=8):
        kw = dict(n_layers=1, n_kv_heads=1, head_dim=8, block_size=4,
                  n_blocks=n_blocks, max_blocks_per_seq=max_blocks)
        self.j = jpaged.PagedKVCache(
            jpaged.PagedKVConfig(dtype=getattr(jnp, dtype), **kw),
            scalable=scalable, resolver="gather")
        self.t = tpaged.PagedKVCache(
            tpaged.PagedKVConfig(dtype=getattr(torch, dtype), **kw),
            scalable=scalable, resolver="gather", device="cpu")

    def __getattr__(self, op):
        """Apply ``op`` to both caches (numpy arguments reach each package
        as its own arrays); the results must agree. Returns the port's."""
        def both(*args):
            ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
            ta = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
            a, b = getattr(self.j, op)(*ja), getattr(self.t, op)(*ta)
            if isinstance(b, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(_np(y), _np(x), err_msg=op)
            else:
                assert a == b, op
            return b
        return both

    def raises(self, exc, match, op, *args):
        for cache in (self.j, self.t):
            with pytest.raises(exc, match=match):
                getattr(cache, op)(*args)

    def check(self):
        assert self.t.golden_stats() == self.j.golden_stats()
        assert self.t._golden == self.j._golden
        assert self.t.blocks_in_use() == self.j.blocks_in_use()
        assert self.t.lookup_count == self.j.lookup_count
        for sid, seq in self.j._seqs.items():
            if seq.freed:
                continue
            assert self.t.is_golden(sid) == self.j.is_golden(sid)
            for x, y in zip(self.j.gather(sid), self.t.gather(sid)):
                np.testing.assert_array_equal(_np(y), _np(x))
        for x, y in zip(self.j._resolve_all(), self.t._resolve_all()):
            np.testing.assert_array_equal(y, x)
        jinv.check_kv_invariants(self.j)
        tinv.check_kv_invariants(self.t)


def rand_kv(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((1, n, 1, 8)).astype(np.float32),
            r.standard_normal((1, n, 1, 8)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scalable", [False, True])
def test_kv_register_freezes_sequence(scalable, dtype):
    """The content hash (length, then the resolved K and V bytes) equals
    the JAX package's in float32 and bfloat16, and both refuse the same
    writes on a frozen sequence."""
    kv = KVPair(scalable, dtype=dtype)
    sid = kv.new_seq()
    k, v = rand_kv(8, 11)
    kv.append_prefill(sid, k, v)
    h = kv.register_golden(sid)
    assert kv.register_golden(sid) == h          # idempotent
    assert kv.is_golden(sid)
    kv.check()
    kv.raises(RuntimeError, "frozen", "append_prefill", sid,
              torch.as_tensor(k), torch.as_tensor(v))
    kv.raises(RuntimeError, "frozen", "prepare_step", [sid])
    kv.raises(RuntimeError, "frozen", "prepare_span", sid, 2)
    kv.raises(ValueError, "release_golden", "free_seq", sid)
    assert kv.demote_seq(sid) == 0               # golden layers stay hot
    kv.check()
    twin, other = kv.new_seq(), kv.new_seq()
    kv.append_prefill(twin, k, v)
    kv.append_prefill(other, *rand_kv(8, 12))
    assert kv.register_golden(twin) == h
    assert kv.register_golden(other) != h
    kv.check()
    assert kv.release_golden(sid) == h
    kv.free_seq(sid)                             # now an ordinary free
    kv.check()


@pytest.mark.parametrize("scalable", [False, True])
def test_kv_fork_of_golden_decodes_on(scalable):
    kv = KVPair(scalable)
    sid = kv.new_seq()
    kv.append_prefill(sid, *rand_kv(8, 13))
    kv.register_golden(sid)
    child = kv.fork(sid)
    kv.append_prefill(child, *rand_kv(2, 14))   # the suffix
    kv.check()
    gk, _ = kv.t.gather(child)
    pk, _ = kv.t.gather(sid)
    np.testing.assert_array_equal(gk[:, :8].numpy(), pk.numpy())
    st = kv.t.golden_stats()
    assert st["golden_seqs"] == 1
    assert st["golden_blocks_shared"] == 2       # 8 tokens / bs 4
    assert st["dedup_blocks_saved"] == 2


@pytest.mark.parametrize("scalable", [False, True])
def test_kv_prepare_span_matches_jax(scalable):
    """``prepare_span`` on a fork of a golden base: the same table, slots,
    COW copy of the shared partial block and stamps as the JAX package's;
    ``advance_span`` commits them."""
    kv = KVPair(scalable)
    sid = kv.new_seq()
    kv.append_prefill(sid, *rand_kv(6, 21))     # a partial second block
    kv.register_golden(sid)
    child = kv.fork(sid)
    kv.prepare_span(child, 5)
    kv.raises(RuntimeError, "prepare_span", "advance_span", child, 7)
    kv.advance_span(child, 5)
    kv.check()
    assert kv.t.seq_length(child) == 11


def test_kv_invariants_catch_golden_flag_drift():
    kv = KVPair(True)
    sid = kv.new_seq()
    kv.append_prefill(sid, *rand_kv(4, 15))
    kv.register_golden(sid)
    kv.check()
    for cache, inv in ((kv.j, jinv), (kv.t, tinv)):
        del cache._golden[sid]                   # the deliberate drift
        with pytest.raises(AssertionError):
            inv.check_kv_invariants(cache)


@pytest.mark.parametrize("scalable", [False, True])
def test_prepare_step_single_matches_batched(scalable):
    kv = KVPair(scalable)
    a, b = kv.new_seq(), kv.new_seq()
    kv.append_prefill(a, *rand_kv(7, 16))
    kv.append_prefill(b, *rand_kv(5, 17))
    c = kv.fork(a)
    want_t, want_l = kv.prepare_step([c])
    # a fresh fork, so the single-sequence path does its own COW prepare
    d = kv.fork(a)
    got_t, got_l = kv.prepare_step_single(d)
    assert got_t.shape == want_t.shape and got_l.shape == want_l.shape
    # same parent, same length: the write block differs (each fork COWs
    # its own), everything else agrees
    blk = int(want_l[0]) // kv.t.cfg.block_size
    np.testing.assert_array_equal(np.delete(got_t[0].numpy(), blk),
                                  np.delete(want_t[0].numpy(), blk))
    np.testing.assert_array_equal(got_l.numpy(), want_l.numpy())
    # on the very same sequence the two paths are bit-identical
    t1, l1 = kv.prepare_step([c])
    t2, l2 = kv.prepare_step_single(c)
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    kv.check()


# -- serving plane: Engine admission -----------------------------------------


@pytest.fixture(scope="module")
def f32():
    """Float32 compute in both packages for the engine cases; JAX's
    compiled traces are cleared so no other module sees an f32 trace."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def tiny_model(f32):
    jcfg = dataclasses.replace(j_smoke("qwen2.5-3b"), n_layers=1)
    tcfg = dataclasses.replace(t_smoke("qwen2.5-3b"), n_layers=1)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


class EnginePair:
    def __init__(self, tiny_model, scalable=True):
        jcfg, tcfg, jparams, tparams = tiny_model
        kw = dict(scalable=scalable, n_blocks=256, block_size=4,
                  max_blocks_per_seq=32, resolver="gather", decode_path="tables")
        self.j = JEngine(jcfg, jparams, **kw)
        self.t = TEngine(tcfg, tparams, device="cpu", **kw)
        self.vocab = jcfg.vocab_size

    def __getattr__(self, op):
        def both(*args):
            a, b = getattr(self.j, op)(*args), getattr(self.t, op)(*args)
            assert a == b, op
            self.check()
            return b
        return both

    def check(self):
        jm, tm = self.j.memory_stats(), self.t.memory_stats()
        assert tm == jm
        assert self.t.active == self.j.active
        assert self.t._golden_info == self.j._golden_info
        for sid in self.j.active:
            for x, y in zip(self.j.kv.gather(sid), self.t.kv.gather(sid)):
                np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                           rtol=1e-5, atol=1e-5)
        jinv.check_kv_invariants(self.j.kv)
        tinv.check_kv_invariants(self.t.kv)


@pytest.mark.parametrize("scalable", [False, True])
def test_engine_admission_bitwise_vs_duplicate_storage(tiny_model, scalable):
    """A prefix-hit admission is, in each package, bitwise what a
    dedup-free engine would store (duplicate the golden's bytes, run the
    SAME suffix pass); and the port's tokens are the JAX engine's."""
    e = EnginePair(tiny_model, scalable)
    rng = np.random.default_rng(18)
    prefix = rng.integers(0, e.vocab, 24).tolist()
    suffix = rng.integers(0, e.vocab, 3).tolist()
    gsid = e.register_golden(np.asarray(prefix, np.int32))
    sid = e.add_request(np.asarray(prefix + suffix, np.int32))
    assert e.t.golden_hits == 1
    tok = e.t.active[sid][0]

    for eng in (e.j, e.t):
        gk, gv = eng.kv.gather(gsid)
        osid = eng.kv.new_seq()
        eng.kv.append_prefill(osid, gk, gv)      # duplicate the storage
        assert eng._suffix_prefill(osid, suffix) == tok
        for x, y in zip(eng.kv.gather(sid), eng.kv.gather(osid)):
            np.testing.assert_array_equal(_np(x), _np(y))
    e.check()
    e.step()                                     # the fork decodes on
    assert len(e.t.active[sid]) == 2
    stats = e.t.memory_stats()
    assert stats["golden_hits"] == 1 and stats["golden_seqs"] == 1
    assert stats["dedup_blocks_saved"] >= 6      # 24 tokens / bs 4


def test_engine_exact_match_skips_model(tiny_model):
    e = EnginePair(tiny_model)
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, e.vocab, 16).tolist()
    gsid = e.register_golden(np.asarray(prompt, np.int32))
    before = e.t.kv.blocks_in_use()
    sid = e.add_request(np.asarray(prompt, np.int32))
    assert e.t.active[sid][0] == e.t._golden_info[gsid][1]
    assert e.t.kv.blocks_in_use() <= before + 1
    assert e.t.golden_hits == 1


def test_engine_miss_takes_full_prefill(tiny_model):
    e = EnginePair(tiny_model)
    rng = np.random.default_rng(20)
    e.register_golden(np.asarray(rng.integers(0, e.vocab, 16), np.int32))
    sid = e.add_request(np.asarray(rng.integers(0, e.vocab, 12), np.int32))
    assert e.t.golden_hits == 0 and e.t.kv.seq_length(sid) == 12
    e.step()
    assert len(e.t.active[sid]) == 2


def test_engine_release_golden_unfreezes(tiny_model):
    e = EnginePair(tiny_model)
    rng = np.random.default_rng(21)
    prompt = np.asarray(rng.integers(0, e.vocab, 16), np.int32)
    gsid = e.register_golden(prompt)
    sid = e.add_request(np.asarray(
        prompt.tolist() + rng.integers(0, e.vocab, 2).tolist(), np.int32))
    e.release_golden(gsid)
    sid2 = e.add_request(prompt)                 # no trie match: full prefill
    assert e.t.golden_hits == 1
    e.step()                                     # the fork decodes on
    assert len(e.t.active[sid]) == 2 and len(e.t.active[sid2]) == 2
