"""The port's cost models and counters (``core/metrics.py``) and the
paper's setup (``configs/paper_chain.py``) against the JAX package.

Eq. 1, Eq. 2, ``trace_latencies`` (on the JAX and port simulations of one
chain and stream: counts exact, latencies within one float32 ulp),
``tiered_pool_bytes``, ``index_bytes`` and ``tier_residency`` (on a fleet
carried into the port and demoted / promoted on both sides) must equal
JAX's; ``SETUP`` and ``headline_claims()`` too. The Eq. 1 / Eq. 2 /
paper-setup cases of ``tests/test_core_chain.py`` and
``tests/test_tiering.py::test_tiered_pool_bytes_model`` replay on the port.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import paper_chain as jpaper  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.chain import ChainSpec as JSpec  # noqa: E402
from repro.core.store import TieredStore as JStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import paper_chain as tpaper  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core.chain import ChainSpec as TSpec  # noqa: E402
from repro_torch.core.store import TieredStore as TStore  # noqa: E402

PUBLIC = ("CostConstants", "eq1_average_cost", "eq2_snapshot_overhead_bytes",
          "trace_latencies", "TierResidency", "tier_residency",
          "GoldenResidency", "golden_residency", "tiered_pool_bytes",
          "index_bytes")


def test_every_public_name_is_ported():
    jax_names = {n for n in dir(jmetrics) if not n.startswith("_")
                 and getattr(getattr(jmetrics, n), "__module__", "") == jmetrics.__name__}
    assert jax_names == set(PUBLIC)
    for name in PUBLIC:
        assert hasattr(tmetrics, name), name


@pytest.mark.parametrize("args", [(0.9, 0.05, 0.05, 10), (0.9, 0.05, 0.05, 1000),
                                  (0.5, 0.3, 0.2, 500), (1.0, 0.0, 0.0, 1)])
def test_eq1_equals_jax(args):
    assert tmetrics.eq1_average_cost(*args) == jmetrics.eq1_average_cost(*args)
    c = tmetrics.CostConstants(t_m=2e-7, t_d=1e-5, t_l=3e-6, t_f=4e-6)
    jc = jmetrics.CostConstants(t_m=2e-7, t_d=1e-5, t_l=3e-6, t_f=4e-6)
    assert tmetrics.eq1_average_cost(*args, c) == jmetrics.eq1_average_cost(*args, jc)


def test_eq1_linear_in_chain_length():
    a = tmetrics.eq1_average_cost(0.9, 0.05, 0.05, 10)
    b = tmetrics.eq1_average_cost(0.9, 0.05, 0.05, 1000)
    assert abs(b / a - 100.0) < 1e-6


@pytest.mark.parametrize("disk", [16 * 2**30, 50 * 2**30, 150 * 2**30])
def test_eq2_equals_jax(disk):
    assert tmetrics.eq2_snapshot_overhead_bytes(disk) == \
        jmetrics.eq2_snapshot_overhead_bytes(disk)
    assert tmetrics.eq2_snapshot_overhead_bytes(disk, 4096, 16, 0) == \
        jmetrics.eq2_snapshot_overhead_bytes(disk, 4096, 16, 0)


def test_eq2_matches_paper_example():
    got = tmetrics.eq2_snapshot_overhead_bytes(50 * 2**30)
    assert abs(got - 6.25 * 2**20) < 0.5 * 2**20


def test_paper_setup_equals_jax():
    assert dataclasses.asdict(tpaper.SETUP) == dataclasses.asdict(jpaper.SETUP)
    assert tpaper.headline_claims() == jpaper.headline_claims()
    for disk in tpaper.SETUP.disk_sizes_bytes:
        assert tpaper.SETUP.l2_cache_bytes_full(disk) == \
            jpaper.SETUP.l2_cache_bytes_full(disk)


def test_paper_setup_constants():
    """``tests/test_core_chain.py``'s paper-setup case on the port."""
    setup = tpaper.SETUP
    assert setup.l2_cache_bytes_full(50 * 2**30) == 6_553_600
    got = tmetrics.eq2_snapshot_overhead_bytes(
        50 * 2**30, setup.cluster_bytes, setup.l2_entry_bytes, 0)
    claims = tpaper.headline_claims()
    assert abs(got - claims["snapshot_overhead_bytes_50gb"]) / got < 0.1


def _chain(scalable):
    rng = np.random.default_rng(3)
    jc = jstore.create(128, 4, max_chain=32, scalable=scalable,
                       pool_capacity=4096, l2_per_table=16, slice_len=4)
    for _ in range(11):
        ids = rng.choice(128, 16, replace=False).astype(np.int32)
        jc = jstore.write(jc, jnp.asarray(ids), jnp.ones((16, 4)))
        jc = jstore.snapshot(jc)
    spec = TSpec(**{f.name: getattr(jc.spec, f.name)
                    for f in dataclasses.fields(jc.spec) if f.name != "dtype"})
    tc = convert.chain_from_numpy(
        spec, {n: np.asarray(getattr(jc, n)) for n in convert.CHAIN_FIELDS},
        scalable=scalable, device="cpu")
    return jc, tc


@pytest.mark.parametrize("sim", ["simulate_vanilla", "simulate_unified"])
def test_trace_latencies_equal_jax(sim):
    jc, tc = _chain(sim == "simulate_unified")
    reqs = np.random.default_rng(4).integers(0, 128, 160).astype(np.int32)
    jt = getattr(jcache, sim)(jc, jnp.asarray(reqs), 4)
    tt = getattr(tcache, sim)(tc, torch.as_tensor(reqs), 4)
    for field in ("probes", "misses", "hit_unallocated"):
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)))
    for c, jcst in ((tmetrics.CostConstants(), jmetrics.CostConstants()),
                    (tmetrics.CostConstants(t_m=3e-7, t_f=5e-6),
                     jmetrics.CostConstants(t_m=3e-7, t_f=5e-6))):
        got = tmetrics.trace_latencies(tt, c)
        want = np.asarray(jmetrics.trace_latencies(jt, jcst))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_tiered_pool_bytes_and_index_bytes_equal_jax():
    kw = dict(n_pages=1024, page_size=16, max_chain=512, pool_capacity=4096,
              l2_per_table=64)
    spec, jspec = TSpec(**kw), JSpec(**kw)
    for depth in (1, 64, 500):
        for rows in (1, 8, 64):
            for tiered in (False, True):
                assert tmetrics.tiered_pool_bytes(spec, depth, rows, tiered=tiered) == \
                    jmetrics.tiered_pool_bytes(jspec, depth, rows, tiered=tiered)
        for scalable in (False, True):
            assert tmetrics.index_bytes(spec, depth, scalable=scalable) == \
                jmetrics.index_bytes(jspec, depth, scalable=scalable)
    bf = TSpec(**kw, dtype=torch.bfloat16)
    jbf = JSpec(**kw, dtype=jnp.bfloat16)
    assert tmetrics.tiered_pool_bytes(bf, 8, 8, tiered=False) == \
        jmetrics.tiered_pool_bytes(jbf, 8, 8, tiered=False)


def test_tiered_pool_bytes_model():
    """``tests/test_tiering.py::test_tiered_pool_bytes_model`` on the port
    (its fleet: 32-float pages)."""
    spec = tfleet.FleetSpec(n_tenants=4, n_pages=64, page_size=32, max_chain=8,
                            pool_capacity=1024, lease_quantum=8)
    all_hbm = tmetrics.tiered_pool_bytes(spec, 500, 8, tiered=False)
    tiered = tmetrics.tiered_pool_bytes(spec, 500, 8, tiered=True)
    assert all_hbm == 500 * tiered
    assert tiered == 8 * 32 * 4


def _fleet_pair():
    """A 4-tenant JAX fleet with three layers of writes, and the port's copy."""
    rng = np.random.default_rng(5)
    jspec = jfleet.FleetSpec(n_tenants=4, n_pages=32, page_size=4, max_chain=8,
                             pool_capacity=1024, lease_quantum=8, l2_per_table=32)
    jf = jfleet.create(jspec, scalable=False)
    for layer in range(3):
        if layer:
            jf = jfleet.snapshot(jf)
        ids = np.stack([rng.choice(32, 4, replace=False) for _ in range(4)])
        data = rng.standard_normal((4, 4, 4)).astype(np.float32)
        jf = jfleet.write(jf, jnp.asarray(ids.astype(np.int32)), jnp.asarray(data))
    tspec = tfleet.FleetSpec(**{f.name: getattr(jspec, f.name)
                                for f in dataclasses.fields(jspec) if f.name != "dtype"})
    tf = convert.fleet_from_numpy(
        tspec, {n: np.asarray(getattr(jf, n)) for n in convert.FLEET_FIELDS},
        device="cpu")
    return jf, tf


def test_tier_residency_equals_jax():
    jf, tf = _fleet_pair()
    js, ts = JStore.for_fleet(jf.spec), TStore.for_fleet(tf.spec)
    same = lambda: dataclasses.asdict(tmetrics.tier_residency(tf, ts)) == \
        dataclasses.asdict(jmetrics.tier_residency(jf, js))  # noqa: E731
    assert same()
    assert dataclasses.asdict(tmetrics.tier_residency(tf)) == \
        dataclasses.asdict(jmetrics.tier_residency(jf))
    jf, _ = jfleet.demote_tenants(jf, js, [1, 3], max_rows=5)
    tf, _ = tfleet.demote_tenants(tf, ts, [1, 3], max_rows=5)
    assert same()
    res = tmetrics.tier_residency(tf, ts)
    assert res.cold_tenants > 0 and res.host_rows == res.demoted_rows > 0
    jf, _ = jfleet.promote_tenants(jf, js, [1])
    tf, _ = tfleet.promote_tenants(tf, ts, [1])
    assert same()
    assert tmetrics.tier_residency(tf, ts).promoted_rows > 0
