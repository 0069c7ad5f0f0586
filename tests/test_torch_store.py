"""The port's single-chain store (``core/store.py``) against ``repro.core.store``.

The op sequences of ``tests/test_core_chain.py``'s read and maintenance
tests replay on both packages from the same numpy inputs; after every op
(write, snapshot, ``stream`` with and without data movement and on an
exhausted pool, ``compact_pool``, ``convert_to_scalable``) the chain
state — L1/L2 words, pool bytes, cursor, length, flags and format — must
match bit for bit, and ``read``, ``materialize`` and ``allocated_mask``
must give the same bytes and the same ``ResolveResult`` (``lookups``
included) for all five resolver methods. Also ``plan_merge``, the host
cold tier's ``TieredStore`` API and the numpy converters.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import chain as jchain  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
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
    assert tc.scalable == jc.scalable


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

    def clone(self) -> "Pair":
        """An independent copy: the port's ops work in place, so a case
        that runs two ops on one state clones it first."""
        out = object.__new__(Pair)
        out.jc = self.jc
        out.tc = dataclasses.replace(
            self.tc, **{f: getattr(self.tc, f).clone()
                        for f in convert.CHAIN_FIELDS})
        return out

    def stream(self, merge_upto, **kw):
        self.jc = jstore.stream(self.jc, merge_upto, **kw)
        self.tc = tstore.stream(self.tc, merge_upto, **kw)
        self.check()

    def compact(self):
        self.jc = jstore.compact_pool(self.jc)
        self.tc = tstore.compact_pool(self.tc)
        self.check()

    def convert(self):
        self.jc = jstore.convert_to_scalable(self.jc)
        self.tc = tstore.convert_to_scalable(self.tc)
        self.check()

    def strip_extension(self):
        """The on-disk vanilla view: word1 all zero."""
        self.jc = dataclasses.replace(self.jc,
                                      l2=jfmt.strip_extension(self.jc.l2))
        self.tc.l2[..., 1] = 0
        self.check()

    def grow(self, rng, layers, writes):
        for _ in range(layers):
            self.write(rng.choice(N_PAGES, writes, replace=False),
                       rng.standard_normal((writes, PAGE)))
            self.snapshot()


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


# -- maintenance: stream, compact_pool, convert_to_scalable ------------------


@pytest.mark.parametrize("scalable", [True, False])
@pytest.mark.parametrize("copy_data", [False, True])
def test_stream_preserves_content_and_shortens_chain(scalable, copy_data):
    rng = np.random.default_rng(1)
    p = Pair(scalable=scalable)
    p.grow(rng, 5, 16)
    before = _bytes(tstore.materialize(p.tc))
    p.stream(2, copy_data=copy_data)
    assert tstore.chain_length(p.tc) == 4
    np.testing.assert_array_equal(_bytes(tstore.materialize(p.tc)), before)


def test_stream_twice_from_one_state():
    """Both ``copy_data`` values from the same chain (the JAX case streams
    one value twice; the port's in-place op streams a clone)."""
    rng = np.random.default_rng(11)
    p = Pair()
    p.grow(rng, 5, 16)
    for copy_data in (False, True):
        q = p.clone()
        q.stream(2, copy_data=copy_data)


def test_stream_pool_exhaustion_flags_overflow_not_raise():
    """On a full pool the copy is dropped, the merge degrades to metadata
    only and ``overflow`` is set; GC then a retry clears it."""
    p = Pair(max_chain=4, pool_capacity=16)
    ids = np.arange(8)
    p.write(ids, np.ones((8, PAGE)))
    p.snapshot()
    p.write(ids, 2 * np.ones((8, PAGE)))             # pool now full
    p.snapshot()
    before = _bytes(tstore.materialize(p.tc))
    p.stream(1, copy_data=True)
    assert bool(p.tc.overflow) and tstore.chain_length(p.tc) == 2
    np.testing.assert_array_equal(_bytes(tstore.materialize(p.tc)), before)
    p.compact()
    p.stream(0, copy_data=True)
    assert not bool(p.tc.overflow)


def test_stream_copy_data_preserves_stripped_vanilla_image():
    """bfi-invalid upper entries keep their own pointers on the copy path."""
    p = Pair(scalable=False)
    ids = np.arange(8)
    p.write(ids, np.ones((8, PAGE)))
    p.snapshot()
    p.write(ids, 2 * np.ones((8, PAGE)))
    p.snapshot()
    p.write([30], np.ones((1, PAGE)))
    p.strip_extension()
    p.stream(0, copy_data=True)
    out, _ = tstore.read(p.tc, torch.as_tensor(ids), method="vanilla")
    np.testing.assert_array_equal(out.numpy(), 2.0)


def test_convert_to_scalable_enables_direct():
    p = Pair(scalable=False)
    ids = torch.tensor([3, 9], dtype=torch.int32)
    p.write([3, 9], np.ones((2, PAGE)))
    p.snapshot()
    p.write([9], 2 * np.ones((1, PAGE)))
    _, res = tstore.read(p.tc, ids, method="direct")
    assert not bool(res.found.all())
    p.convert()
    out, res2 = tstore.read(p.tc, ids, method="direct")
    assert bool(res2.found.all()) and p.tc.scalable
    np.testing.assert_array_equal(
        _bytes(out), _bytes(tstore.read(p.tc, ids, method="vanilla")[0]))


def test_snapshot_cap_clears_only_when_streaming_makes_room():
    p = Pair(max_chain=3)
    p.write([1], np.ones((1, PAGE)))
    p.snapshot()
    p.snapshot()
    p.snapshot()                                     # dropped
    assert bool(p.tc.snap_dropped)
    q = p.clone()
    q.stream(0)
    assert bool(q.tc.snap_dropped)                   # still full
    p.stream(1)
    assert not bool(p.tc.snap_dropped)               # room made


@pytest.mark.parametrize("scalable", [True, False])
def test_compact_pool_preserves_reads(scalable):
    rng = np.random.default_rng(2)
    p = Pair(scalable=scalable)
    p.grow(rng, 6, 24)
    p.stream(3, copy_data=False)
    cursor = int(p.tc.pool_cursor)
    before = _bytes(tstore.materialize(p.tc))
    p.compact()
    np.testing.assert_array_equal(_bytes(tstore.materialize(p.tc)), before)
    assert int(p.tc.pool_cursor) <= cursor


@pytest.mark.parametrize("scalable", [True, False])
def test_maintenance_sequence_replays(scalable):
    """stream (both kinds) / compact / convert / write interleaved."""
    rng = np.random.default_rng(3)
    p = Pair(scalable=scalable, max_chain=12, pool_capacity=400)
    p.grow(rng, 7, 20)
    p.stream(4, copy_data=True)
    p.compact()
    p.grow(rng, 3, 12)
    p.stream(1, copy_data=False)
    p.convert()
    p.write(rng.choice(N_PAGES, 9, replace=False), rng.standard_normal((9, PAGE)))
    p.compact()


@pytest.mark.parametrize("merge_upto", [0, 2, 5])
def test_plan_merge_matches_jax(merge_upto):
    """The merged words and ``found`` equal the JAX plan bit for bit,
    including pages no merged layer allocates (JAX takes layer 0's words
    there, allocated or not) and ZERO clusters."""
    rng = np.random.default_rng(merge_upto)
    c, n = 8, 96
    l2 = jfmt.pack_entry(
        jnp.asarray(rng.integers(0, 1 << 20, (c, n)), jnp.uint32),
        jnp.asarray(rng.integers(0, c, (c, n)), jnp.uint32),
        allocated=jnp.asarray(rng.random((c, n)) < 0.2),
        bfi_valid=jnp.asarray(rng.random((c, n)) < 0.5),
        zero=jnp.asarray(rng.random((c, n)) < 0.1),
    )
    jm, jf = jchain.plan_merge(l2, merge_upto)
    tm, tf = tchain.plan_merge(torch.from_numpy(_np(l2).copy()), merge_upto)
    assert not np.asarray(jf).all()                  # some pages unallocated
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), _np(jm))


def test_snapshot_cost_model_and_geometry():
    p = Pair()
    spec_j, spec_t = p.jc.spec, p.tc.spec
    assert tchain.snapshot_cost_model(spec_t) == jchain.snapshot_cost_model(spec_j)
    assert spec_t.n_slices == spec_j.n_slices
    assert spec_t.index_bytes_per_snapshot() == spec_j.index_bytes_per_snapshot()
