"""The port's Qcow2 slice-cache model (``core/cache.py``) against
``repro.core.cache``.

Chains are built by the JAX store from numpy-seeded writes (128 pages,
C = 32, lengths 1, 4 and 24, both formats) and carried into the port with
``convert.chain_from_numpy``. Both simulators run on both packages over a
sequential stream and a random stream with repeats, at 1, 8 and 64 slots;
every ``SimTrace`` field must be equal. Also: the empty-cache fill order,
the cases of ``tests/test_distributed.py``'s simulator and Fig 12 memory
tests, and ``cache_correction`` on the inputs of
``tests/test_core_properties.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.chain import ChainSpec as JSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.core.chain import ChainSpec as TSpec  # noqa: E402

N_PAGES, PAGE, MAX_CHAIN = 128, 4, 32
GEOMETRY = dict(l2_per_table=16, slice_len=4)   # 8 L2 tables, 32 slices
REQUESTS = 192


def build_jax(length, scalable, seed=0, **geometry):
    """A JAX chain of ``length`` files: 16 random pages written per layer."""
    rng = np.random.default_rng(seed)
    ch = jstore.create(N_PAGES, PAGE, max_chain=MAX_CHAIN, scalable=scalable,
                       pool_capacity=4096, **geometry)
    for _ in range(length - 1):
        ids = rng.choice(N_PAGES, 16, replace=False).astype(np.int32)
        ch = jstore.write(ch, jnp.asarray(ids), jnp.ones((16, PAGE)))
        ch = jstore.snapshot(ch)
    return ch


def to_port(jc):
    spec = TSpec(**{f.name: getattr(jc.spec, f.name)
                    for f in dataclasses.fields(jc.spec) if f.name != "dtype"})
    return convert.chain_from_numpy(
        spec, {n: np.asarray(getattr(jc, n)) for n in convert.CHAIN_FIELDS},
        scalable=jc.scalable, device="cpu")


def streams():
    rng = np.random.default_rng(1)
    seq = np.arange(REQUESTS, dtype=np.int32) % N_PAGES
    rand = rng.integers(0, N_PAGES, REQUESTS).astype(np.int32)  # repeats
    return {"sequential": seq, "random": rand}


def same_trace(jt, tt, what):
    for field, w, g in zip(jcache.SimTrace._fields, jt, tt):
        assert g.dtype == torch.int32, f"{what}.{field} dtype"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{what}.{field}")


_CHAINS = {}


def chains(length):
    if length not in _CHAINS:
        _CHAINS[length] = {
            scalable: (jc, to_port(jc)) for scalable in (False, True)
            for jc in [build_jax(length, scalable, **GEOMETRY)]}
    return _CHAINS[length]


@pytest.mark.parametrize("n_slots", [1, 8, 64])
@pytest.mark.parametrize("length", [1, 4, 24])
def test_simtrace_equals_jax(length, n_slots):
    """Every field, both simulators, both formats, both streams."""
    for scalable, (jc, tc) in chains(length).items():
        for name, reqs in streams().items():
            for sim in ("simulate_vanilla", "simulate_unified"):
                jt = getattr(jcache, sim)(jc, jnp.asarray(reqs), n_slots)
                tt = getattr(tcache, sim)(tc, torch.as_tensor(reqs), n_slots)
                same_trace(jt, tt, f"{sim}/{scalable}/{name}/L{length}/S{n_slots}")


@pytest.mark.parametrize("sim", ["simulate_vanilla", "simulate_unified"])
def test_eviction_from_an_empty_cache_equals_jax(sim):
    """4 slots filled from empty by slices a b c d, a touched, then e evicts
    b (the least recently used), so a later b misses and a later a hits —
    as in the JAX run."""
    jc, tc = chains(4)[True]
    slices = [0, 1, 2, 3, 0, 4, 1, 0]
    reqs = np.asarray([s * GEOMETRY["slice_len"] for s in slices], np.int32)
    tt = getattr(tcache, sim)(tc, torch.as_tensor(reqs), 4)
    jt = getattr(jcache, sim)(jc, jnp.asarray(reqs), 4)
    same_trace(jt, tt, sim)
    if sim == "simulate_unified":
        assert tt.misses.tolist() == [1, 1, 1, 1, 0, 1, 1, 0]


def test_lru_fill_order_and_sink():
    """An empty cache fills slots 0, 1, 2, ... (the JAX ``argmin`` picks the
    first of the tied empty slots) and evicts its least recently used slot;
    a cache that does not fetch writes only its sink column, so a later
    probe for that slice still misses there. File 0: 5 7 9 fill slots 0-2,
    5 hits, 8 evicts 7 (slot 1), 7 evicts 9 (slot 2). File 1 skips the
    first 5: 7 9 5 fill slots 0-2, 8 evicts 7, 7 evicts 9."""
    probed = torch.ones((6, 2), dtype=torch.bool)
    fetchable = torch.ones((6, 2), dtype=torch.bool)
    fetchable[0, 1] = False
    misses, tags = tcache._lru_misses([5, 7, 9, 5, 8, 7], probed, fetchable, 3)
    assert misses.tolist() == [1, 2, 2, 1, 2, 2]
    assert tags.tolist() == [[5, 8, 7], [8, 7, 5]]


def test_cache_sim_vanilla_grows_unified_flat():
    """``tests/test_distributed.py``'s Fig 13 case on the port."""
    reqs = torch.arange(128, dtype=torch.int32)

    def build(length, scalable):
        return to_port(build_jax(length, scalable))

    v_short = tcache.summarize(tcache.simulate_vanilla(build(4, False), reqs, 8))
    v_long = tcache.summarize(tcache.simulate_vanilla(build(24, False), reqs, 8))
    u_short = tcache.summarize(tcache.simulate_unified(build(4, True), reqs, 8))
    u_long = tcache.summarize(tcache.simulate_unified(build(24, True), reqs, 8))
    assert v_long["hit_unallocated"] > 2 * max(v_short["hit_unallocated"], 1)
    assert u_long["probes"] == u_short["probes"] == 128
    assert u_long["hit_unallocated"] <= u_short["hit_unallocated"] + 8


def test_summarize_equals_jax():
    jc, tc = chains(24)[False]
    reqs = streams()["random"]
    assert tcache.summarize(tcache.simulate_vanilla(tc, torch.as_tensor(reqs), 8)) \
        == jcache.summarize(jcache.simulate_vanilla(jc, jnp.asarray(reqs), 8))


def test_cache_memory_model_fig12_shape():
    """``tests/test_distributed.py``'s Fig 12 case, and equal to JAX's."""
    spec = TSpec(n_pages=1024, page_size=16, max_chain=1024, pool_capacity=2048)
    jspec = JSpec(n_pages=1024, page_size=16, max_chain=1024, pool_capacity=2048)
    v = [tcache.cache_memory_bytes(spec, 64, n, unified=False) for n in (1, 500, 1000)]
    u = [tcache.cache_memory_bytes(spec, 64, n, unified=True) for n in (1, 500, 1000)]
    assert v[2] > 100 * v[0]
    assert v[1] / u[1] > 10
    flat = [tcache.cache_memory_bytes(spec, 64, n, unified=True,
                                      per_snapshot_overhead=0) for n in (1, 1000)]
    assert flat[0] == flat[1]
    for n in (1, 5, 50, 100, 500, 1000):
        for unified in (False, True):
            assert tcache.cache_memory_bytes(spec, 64, n, unified=unified) == \
                jcache.cache_memory_bytes(jspec, 64, n, unified=unified)


def _rand_slices(seed, n=16):
    """``tests/test_core_properties.py``'s random slices, in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ptr, bfi = rng.integers(0, 1000, n), rng.integers(0, 8, n)
        alloc = rng.random(n) < 0.7
        j = jfmt.pack_entry(jnp.asarray(ptr, jnp.uint32), jnp.asarray(bfi, jnp.uint32),
                            allocated=jnp.asarray(alloc), bfi_valid=True)
        t = tfmt.pack_entry(torch.as_tensor(ptr), torch.as_tensor(bfi),
                            allocated=torch.as_tensor(alloc), bfi_valid=True)
        out.append((j, t))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_cache_correction_equals_jax_idempotent_monotone(seed):
    (jsv, tsv), (jsb, tsb) = _rand_slices(seed)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv).view(np.int32))
    once = tcache.cache_correction(tsv, tsb)
    np.testing.assert_array_equal(
        once.numpy(), np.asarray(jcache.cache_correction(jsv, jsb)).view(np.int32))
    twice = tcache.cache_correction(once, tsb)
    assert torch.equal(once, twice)
    sv_alloc = tfmt.entry_allocated(tsv)
    assert bool((tfmt.entry_bfi(once)[sv_alloc] >= tfmt.entry_bfi(tsv)[sv_alloc]).all())
