"""The port's single-chain store (``core/store.py``) against ``repro.core.store``.

The op sequences of ``tests/test_core_chain.py``'s read tests replay on
both packages from the same numpy inputs; after every op the chain state
must match bit for bit, and ``read``, ``materialize`` and
``allocated_mask`` must give the same bytes and the same ``ResolveResult``
(``lookups`` included) for all five resolver methods. Also the host cold
tier's ``TieredStore`` API and the numpy converters.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

METHODS = ["vanilla", "direct", "auto", "pallas_vanilla", "pallas_direct"]
N_PAGES, PAGE = 128, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _bytes(x) -> np.ndarray:
    return _np(x).astype(np.float32).view(np.uint32)


def _stores(**kw):
    kw.setdefault("max_chain", 16)
    return (jstore.create(N_PAGES, PAGE, **kw),
            tstore.create(N_PAGES, PAGE, device="cpu", **kw))


def _state_equal(jc, tc):
    for f in convert.CHAIN_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tc, f)), _np(getattr(jc, f)),
                                      err_msg=f)
    assert tstore.chain_length(tc) == jstore.chain_length(jc)


def _reads_equal(jc, tc, ids):
    for m in METHODS:
        jd, jres = jstore.read(jc, jnp.asarray(ids), method=m)
        td, tres = tstore.read(tc, torch.as_tensor(ids), method=m)
        np.testing.assert_array_equal(_bytes(td), _bytes(jd), err_msg=m)
        for field, w, g in zip(jres._fields, jres, tres):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{m}.{field}")
        np.testing.assert_array_equal(
            _bytes(tstore.materialize(tc, method=m)),
            _bytes(jstore.materialize(jc, method=m)), err_msg=m)
        np.testing.assert_array_equal(
            _np(tstore.allocated_mask(tc, method=m)),
            _np(jstore.allocated_mask(jc, method=m)), err_msg=m)


class Pair:
    """Both packages' chains, advanced op by op and compared after each."""

    def __init__(self, **kw):
        self.jc, self.tc = _stores(**kw)
        self.check()

    def check(self, ids=(0, 3, 5, 7, 127)):
        ids = np.asarray(ids, np.int32)
        _state_equal(self.jc, self.tc)
        _reads_equal(self.jc, self.tc, ids)

    def write(self, ids, data):
        ids = np.asarray(ids, np.int32)
        data = np.asarray(data, np.float32)
        self.jc = jstore.write(self.jc, jnp.asarray(ids), jnp.asarray(data))
        self.tc = tstore.write(self.tc, torch.as_tensor(ids), torch.as_tensor(data))
        self.check(ids)

    def snapshot(self):
        self.jc = jstore.snapshot(self.jc)
        self.tc = tstore.snapshot(self.tc)
        self.check()


def test_write_read_roundtrip():
    rng = np.random.default_rng(0)
    p = Pair()
    p.write([0, 3, 127], rng.standard_normal((3, PAGE)))


def test_unwritten_pages_read_as_zeros():
    p = Pair()
    td, res = tstore.read(p.tc, torch.tensor([5, 6], dtype=torch.int32))
    assert not _bytes(td).any() and not bool(res.found.any())


def test_cow_snapshot_immutability():
    p = Pair()
    p.write([1, 2], np.ones((2, PAGE)))
    p.snapshot()
    p.write([1, 2], 2 * np.ones((2, PAGE)))
    _, res = tstore.read(p.tc, torch.tensor([1, 2], dtype=torch.int32),
                         method="direct")
    np.testing.assert_array_equal(res.owner.numpy(), 1)


@pytest.mark.parametrize("scalable", [True, False])
def test_chain_walk_cost(scalable):
    """Eq. 1 at small size: direct is one lookup at any depth; on a vanilla
    image the walk to a page owned by layer 0 costs the chain length (a
    scalable image's copy-forward puts the entry in the active layer)."""
    p = Pair(scalable=scalable)
    p.write([7], np.ones((1, PAGE)))
    for _ in range(6):
        p.snapshot()
    ids = torch.tensor([7], dtype=torch.int32)
    _, res_v = tstore.read(p.tc, ids, method="vanilla")
    assert int(res_v.lookups[0]) == (1 if scalable else 7)
    if scalable:
        _, res_d = tstore.read(p.tc, ids, method="direct")
        assert int(res_d.lookups[0]) == 1 and bool(res_d.found[0])


def test_snapshot_copy_forward_semantics():
    p = Pair()
    p.write([1, 2, 3], np.ones((3, PAGE)))
    p.snapshot()
    _, res = tstore.read(p.tc, torch.tensor([1, 2, 3], dtype=torch.int32),
                         method="direct")
    assert bool(res.found.all())
    np.testing.assert_array_equal(res.lookups.numpy(), 1)
    np.testing.assert_array_equal(res.owner.numpy(), 0)


@pytest.mark.parametrize("scalable", [True, False])
def test_long_chain_with_overflow_replays(scalable):
    """A chain grown past its pool and its max_chain: every layer's reads,
    the dropped snapshot and the overflow flag match, and the guard
    raises in both packages."""
    rng = np.random.default_rng(5)
    p = Pair(scalable=scalable, max_chain=5, pool_capacity=40)
    for _ in range(6):
        ids = rng.permutation(N_PAGES)[:9]
        p.write(ids, rng.standard_normal((9, PAGE)))
        p.snapshot()
    for mod, c in ((jstore, p.jc), (tstore, p.tc)):
        with pytest.raises(RuntimeError, match="overflow"):
            mod.check_pool_capacity(c)


def test_kernel_methods_gather_through_the_gather_kernel(monkeypatch):
    """``pallas_*`` reads gather through ``cow_gather.ops.gather`` (K8);
    the plain methods through ``gather_pages``. On the CPU both are the
    plain versions, so nothing launches."""
    from repro_torch.kernels.cow_gather import ops as cow_ops

    rng = np.random.default_rng(2)
    p = Pair()
    p.write(rng.permutation(N_PAGES)[:20], rng.standard_normal((20, PAGE)))
    calls = []
    real = cow_ops.gather
    monkeypatch.setattr(cow_ops, "gather",
                        lambda *a: calls.append(1) or real(*a))
    before = dict(_build.LAUNCHES)
    for m in METHODS:
        tstore.materialize(p.tc, method=m)
    assert len(calls) == 2 and _build.LAUNCHES == before


def test_reads_modify_nothing():
    rng = np.random.default_rng(3)
    p = Pair()
    p.write(rng.permutation(N_PAGES)[:20], rng.standard_normal((20, PAGE)))
    before = {f: getattr(p.tc, f).clone() for f in convert.CHAIN_FIELDS}
    for m in METHODS:
        tstore.materialize(p.tc, method=m)
        tstore.allocated_mask(p.tc, method=m)
    for f, v in before.items():
        assert torch.equal(getattr(p.tc, f), v), f


def test_chain_from_numpy_round_trips():
    rng = np.random.default_rng(9)
    p = Pair(scalable=False)
    p.write(rng.permutation(N_PAGES)[:10], rng.standard_normal((10, PAGE)))
    p.snapshot()
    tc = convert.chain_from_numpy(
        p.tc.spec, {f: np.asarray(getattr(p.jc, f)) for f in convert.CHAIN_FIELDS},
        scalable=False, device="cpu")
    _state_equal(p.jc, tc)
    _reads_equal(p.jc, tc, np.arange(N_PAGES, dtype=np.int32))


def test_tiered_store_api_matches():
    """alloc (free list first, LIFO, then fresh rows with doubling), put,
    get, free, clone and stats, op by op against the JAX store."""
    from repro.core.store import TieredStore as JStore

    rng = np.random.default_rng(4)
    js, ts = JStore(PAGE, jnp.float32, initial_rows=3), \
        tstore.TieredStore(PAGE, torch.float32, initial_rows=3)

    def same():
        assert ts.stats() == js.stats()
        np.testing.assert_array_equal(ts.get(np.arange(js._top)).numpy(),
                                      js.get(np.arange(js._top)))

    for n in (2, 5, 1):
        jr, tr = js.alloc(n), ts.alloc(n)
        np.testing.assert_array_equal(tr, jr)
        vals = rng.standard_normal((n, PAGE)).astype(np.float32)
        js.put(jr, vals)
        ts.put(tr, torch.as_tensor(vals))
        same()
    js.free([1, 4, 0])
    ts.free([1, 4, 0])
    same()
    jc, tc = js.clone(), ts.clone()
    np.testing.assert_array_equal(tc.alloc(4), jc.alloc(4))
    assert tc.stats() == jc.stats() and ts.stats() == js.stats()
    with pytest.raises(ValueError, match="never allocated"):
        ts.free([js._top])
    back = convert.tiered_store_from_numpy(
        PAGE, torch.float32, js._data, free=js._free, top=js._top,
        demoted_rows=js.demoted_rows, promoted_rows=js.promoted_rows)
    assert back.stats() == js.stats()
    np.testing.assert_array_equal(back.alloc(5), js.clone().alloc(5))
