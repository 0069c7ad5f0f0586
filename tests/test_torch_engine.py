"""The port's ``Engine`` against the JAX ``Engine`` on the same weights.

Both fork formats × both decode paths run the add / fork / step / finish
lifecycle of ``test_engine_deep_chain_lifecycle_matches_oracle`` (a fork
chain past depth 32 with interleaved finishes and steps), and a
park / step / resume / step lifecycle on the host cold tier. Emitted
tokens must be identical, and ``blocks_in_use``, ``lookup_count``, the
host blocks and the final tables must match. An engine with a
``MaintenanceScheduler`` (``tests/test_kvcache_serve.py``) must emit the
same tokens, tick reports and streamed fleet as the JAX engine, and an
idle engine must still drain the backlog.

Tokens are compared in float32 compute on both sides: bf16 rounds at other
places in the two frameworks and would flip near-tied argmaxes (bf16 is
held at the step level in ``test_torch_model.py``). The JAX side resolves
with ``"gather"`` to keep CPU time down; results are bit-identical across
resolvers.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

KW = dict(n_blocks=256, block_size=4, max_blocks_per_seq=128)


@pytest.fixture(scope="module")
def f32():
    """Float32 compute in both packages for this module's cases; JAX's
    compiled traces are cleared on both sides so no other test module
    sees an f32 trace."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    jcfg = j_smoke("qwen2.5-3b")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, t_smoke("qwen2.5-3b"), jparams, tparams


def _tables(eng, sids):
    tables = eng.kv._resolve_all()[0]
    return {s: tables[eng.kv._seqs[s].tenant] for s in sids}


@pytest.mark.parametrize("path", ["tables", "fused"])
@pytest.mark.parametrize("scalable", [True, False])
def test_engine_lifecycle_emits_identical_tokens(f32, weights, scalable, path):
    jcfg, tcfg, jparams, tparams = weights
    je = JEngine(jcfg, jparams, scalable=scalable, resolver="gather",
                 decode_path=path, **KW)
    te = TEngine(tcfg, tparams, scalable=scalable, decode_path=path,
                 device="cpu", **KW)
    assert je.decode_path == te.decode_path == path

    def both(op, *args):
        a, b = getattr(je, op)(*args), getattr(te, op)(*args)
        assert a == b, op
        return a

    def check():
        jm, tm = je.memory_stats(), te.memory_stats()
        for k in ("blocks_in_use", "lookups", "n_seqs"):
            assert tm[k] == jm[k], k
        assert te.active == je.active
        jt, tt = _tables(je, sorted(je.active)), _tables(te, sorted(te.active))
        for s in jt:
            np.testing.assert_array_equal(tt[s], jt[s])

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (5, 9, 3)]
    sids = [both("add_request", p) for p in prompts]
    both("fork_request", sids[1])            # a long-lived sibling rides along
    both("step")
    sid = sids[0]
    for depth in range(34):
        child = both("fork_request", sid)
        both("finish_request", sid)          # tombstone the parent
        sid = child
        if depth % 16 == 0:
            both("step")
            check()
    for _ in range(2):
        both("step")
    check()
    for s in sorted(je.active):
        both("finish_request", s)
    check()
    assert te.kv.blocks_in_use() == 0
    assert te.kv._seqs == {}


# -- maintenance hook and park/resume ------------------------------------------


def _fleet_pair(n_tenants, layers, *, pool_capacity, values):
    """The same storage fleet in both packages: ``layers`` rounds of writes
    to pages 0-7 (``values(layer)``) with a snapshot between."""
    from repro.core import fleet as jfleet
    from repro_torch.core import fleet as tfleet

    kw = dict(n_tenants=n_tenants, n_pages=64, page_size=4, max_chain=8,
              pool_capacity=pool_capacity, lease_quantum=8, l2_per_table=32)
    jf = jfleet.create(jfleet.FleetSpec(**kw))
    tf = tfleet.create(tfleet.FleetSpec(**kw), device="cpu")
    ids = np.tile(np.arange(8, dtype=np.int32), (n_tenants, 1))
    for layer in range(layers):
        data = np.full((n_tenants, 8, 4), values(layer), np.float32)
        jf = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data))
        tf = tfleet.write(tf, torch.as_tensor(ids), torch.as_tensor(data))
        if layer < layers - 1:
            jf = jfleet.snapshot(jf)
            tf = tfleet.snapshot(tf)
    return jf, tf


def _same_fleet(jf, tf):
    from repro.core import fleet as jfleet
    from repro_torch.core import fleet as tfleet

    for name in convert.FLEET_FIELDS:
        want = np.asarray(getattr(jf, name))
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(getattr(tf, name).numpy(), want,
                                      err_msg=name)
    assert tfleet.fleet_stats(tf) == jfleet.fleet_stats(jf)


@pytest.mark.parametrize("path", ["tables", "fused"])
def test_engine_with_scheduler_matches_jax(f32, weights, path):
    """A scheduler ticked after every step streams its fleet beside
    decoding: the tokens, every tick report, the stats and the streamed
    fleet equal the JAX engine's, and the tokens equal a scheduler-less
    engine's."""
    from repro.core.scheduler import MaintenanceScheduler as JSched
    from repro_torch.core.scheduler import MaintenanceScheduler as TSched

    jcfg, tcfg, jparams, tparams = weights
    jf, tf = _fleet_pair(4, 5, pool_capacity=2048, values=lambda i: i + 1.0)
    js, ts = JSched(jf, max_tenants_per_tick=1), TSched(tf, max_tenants_per_tick=1)
    je = JEngine(jcfg, jparams, resolver="gather", decode_path=path,
                 scheduler=js, **KW)
    te = TEngine(tcfg, tparams, decode_path=path, device="cpu", scheduler=ts,
                 **KW)
    plain = TEngine(tcfg, tparams, decode_path=path, device="cpu", **KW)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=9)
    a = je.add_request(prompt)
    assert te.add_request(prompt) == a and plain.add_request(prompt) == a
    for _ in range(5):
        out = te.step()
        assert out == je.step() == plain.step()
        assert te.last_maintenance == je.last_maintenance
    assert ts.tenants_streamed >= 4 and tf.length.tolist() == [2] * 4
    assert te.memory_stats()["maintenance"] == je.memory_stats()["maintenance"]
    _same_fleet(js.fleet, ts.fleet)


def test_idle_engine_still_drains_maintenance_backlog(weights):
    """``step()`` with nothing to decode still ticks the scheduler."""
    from repro.core.scheduler import MaintenanceScheduler as JSched
    from repro_torch.core.scheduler import MaintenanceScheduler as TSched

    jcfg, tcfg, jparams, tparams = weights
    jf, tf = _fleet_pair(2, 4, pool_capacity=512, values=lambda i: 1.0)
    js, ts = JSched(jf, max_tenants_per_tick=1), TSched(tf, max_tenants_per_tick=1)
    je = JEngine(jcfg, jparams, resolver="gather", scheduler=js, **KW)
    te = TEngine(tcfg, tparams, device="cpu", scheduler=ts, **KW)
    assert te.step() == je.step() == {}
    assert ts.ticks == js.ticks == 1
    while ts.candidates():
        assert te.step() == je.step() == {}
        assert te.last_maintenance == je.last_maintenance
    assert ts.fleet.length.tolist() == [2, 2]
    _same_fleet(js.fleet, ts.fleet)


@pytest.mark.parametrize("path", ["tables", "fused"])
@pytest.mark.parametrize("scalable", [True, False])
def test_park_resume_lifecycle_emits_identical_tokens(f32, weights, scalable,
                                                       path):
    """Park (spill to the host tier) / step / resume (lazy promotion on the
    next step) / finish-while-parked, on both packages: the same tokens,
    the same spill counts and the same memory stats, invariants holding."""
    from repro.core.invariants import check_kv_invariants as jcheck
    from repro_torch.core.invariants import check_kv_invariants as tcheck

    jcfg, tcfg, jparams, tparams = weights
    je = JEngine(jcfg, jparams, scalable=scalable, resolver="gather",
                 decode_path=path, **KW)
    te = TEngine(tcfg, tparams, scalable=scalable, decode_path=path,
                 device="cpu", **KW)

    def both(op, *args):
        a, b = getattr(je, op)(*args), getattr(te, op)(*args)
        assert a == b, op
        jm, tm = je.memory_stats(), te.memory_stats()
        for k in ("blocks_in_use", "host_blocks", "lookups", "n_seqs",
                  "n_parked"):
            assert tm[k] == jm[k], k
        assert te.active == je.active and te.parked == je.parked
        jcheck(je.kv)
        tcheck(te.kv)
        return b

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (13, 9, 6)]
    sids = [both("add_request", p) for p in prompts]
    both("step")
    assert both("park_request", sids[0]) > 0          # spills its blocks
    assert te.memory_stats()["host_blocks"] > 0
    both("step")
    both("step")
    both("resume_request", sids[0])
    both("step")                                       # promotes lazily
    assert te.memory_stats()["host_blocks"] == 0
    both("park_request", sids[1])
    child = both("fork_request", sids[1])              # promotes the parent
    both("step")
    both("park_request", child)
    both("finish_request", child)                      # finish while parked
    both("resume_request", sids[1])
    both("step")
    for s in sorted(te.active):
        both("finish_request", s)
    assert te.kv.blocks_in_use() == 0 and te.kv.host_blocks_in_use() == 0
