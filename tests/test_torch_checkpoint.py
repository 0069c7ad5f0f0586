"""The port's delta checkpointer (``checkpoint/snapstore_ckpt.py``) against
``repro.checkpoint.snapstore_ckpt``.

The cases of ``tests/test_checkpoint.py`` replay on the port (all but
the trainer restart, which ``tests/test_torch_train.py`` holds;
``test_elastic_reshard`` restores onto a one-rank ``gloo`` mesh). States are drawn with numpy and handed to
both packages; after the same saves the port's chain (L1/L2 words, pool
words, cursor, length, flags) and every save's stats must equal the JAX
checkpointer's — through the pool GC and the streaming policy too. Also:
each leaf dtype's words equal JAX's ``bitcast_convert_type`` words (a bf16
leaf of odd size included), leaves follow sorted-key order, ``chain.npz``
cross-loads both ways, a state changed in place after ``save_async``
returns does not reach the checkpoint, the tenant checkpoint directory
round trip of ``tests/test_migrate.py``, and the ``convert`` bit view of
an integer pool.
"""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import snapstore_ckpt as jckpt  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import migrate as jmigrate  # noqa: E402
from repro.core.store import TieredStore as JStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import snapstore_ckpt as tckpt  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import migrate as tmigrate  # noqa: E402
from repro_torch.core.chain import ChainSpec as TSpec  # noqa: E402
from repro_torch.core.invariants import check_fleet_invariants  # noqa: E402
from repro_torch.core.store import TieredStore as TStore  # noqa: E402

METHODS = ["vanilla", "direct", "pallas_vanilla", "pallas_direct"]


def _np(x) -> np.ndarray:
    """Raw bits of either package's array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        elif x.dtype == torch.uint32:
            x = x.view(torch.int32)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name in ("bfloat16", "float16"):
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype in (np.uint32, np.float32) else x


def make_state(seed=0, scale=1.0):
    """``tests/test_checkpoint.py``'s state, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        w=(scale * rng.standard_normal((32, 16))).astype(np.float32),
        b=np.zeros((16,), np.float32),
        step=np.asarray(int(scale), np.int32),
        nested=dict(m=(scale * np.ones((8, 8))).astype(np.float32),
                    flag=np.asarray(3, np.int32)),
    )


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def to_jax(tree):
    return _map(tree, jnp.asarray)


def to_torch(tree):
    def conv(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        if x.dtype == np.uint32:
            return torch.from_numpy(x.view(np.int32).copy()).view(torch.uint32)
        return torch.from_numpy(x.copy())
    return _map(tree, conv)


def leaves(tree):
    return tckpt._leaves(tree)


def same_state(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_np(a), _np(b))


def same_chain(jck, tck):
    for name in convert.CHAIN_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tck.chain, name)),
                                      _np(getattr(jck.chain, name)), err_msg=name)
    assert tck.chain.scalable == jck.chain.scalable
    assert tck.stats == jck.stats
    np.testing.assert_array_equal(_np(tck._shadow), _np(jck._shadow))


class Pair:
    """Both packages' checkpointers over one numpy state."""

    def __init__(self, state, **kw):
        self.j = jckpt.SnapshotCheckpointer(to_jax(state), **kw)
        self.t = tckpt.SnapshotCheckpointer(to_torch(state), device="cpu", **kw)
        assert self.t.spec.n_pages == self.j.spec.n_pages
        assert self.t.spec.pool_capacity == self.j.spec.pool_capacity

    def save(self, state):
        sj = self.j.save(to_jax(state))
        st = self.t.save(to_torch(state))
        assert st == sj
        same_chain(self.j, self.t)
        return st


# -- tests/test_checkpoint.py on the port -------------------------------------


def test_roundtrip_all_dtypes():
    state = to_torch(make_state())
    ck = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    ck.save(state)
    got = ck.restore()
    for a, b in zip(leaves(state), leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_bf16_leaves_roundtrip():
    x = np.random.default_rng(1).standard_normal((9, 7)).astype(np.float32)
    state = dict(p=torch.from_numpy(x).to(torch.bfloat16))
    ck = tckpt.SnapshotCheckpointer(state, page_size=32, device="cpu")
    ck.save(state)
    got = ck.restore()
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), state["p"].view(torch.int16))


def test_delta_saves_write_only_dirty_pages():
    pair = Pair(make_state(), page_size=64)
    s1 = pair.save(make_state())
    assert s1["pages_written"] > 0
    s2 = pair.save(make_state())
    assert s2["pages_written"] == 0
    state2 = make_state()
    state2["b"] = state2["b"] + 1.0
    s3 = pair.save(state2)
    assert 0 < s3["pages_written"] < s1["pages_written"]
    same_state(pair.t.restore(), state2)


def test_restore_vanilla_equals_direct_with_cost_gap():
    state = make_state()
    ps = Pair(state, page_size=64, scalable=True)
    pv = Pair(state, page_size=64, scalable=False)
    for _ in range(8):
        state = _map(state, lambda x: x + 1 if x.dtype == np.float32 else x)
        ps.save(state)
        pv.save(state)
    a = ps.t.restore(method="direct")
    b = pv.t.restore(method="vanilla")
    same_state(a, state)
    same_state(b, state)
    assert ps.t.resolve_cost("direct") < pv.t.resolve_cost("vanilla")
    for p in (ps, pv):
        for m in METHODS + ["auto"]:
            assert p.t.resolve_cost(m) == p.j.resolve_cost(m), m


def test_streaming_policy_bounds_chain():
    state = make_state()
    pair = Pair(state, page_size=64, stream_threshold=6)
    for i in range(20):
        state["step"] = np.asarray(i, np.int32)
        pair.save(state)
    assert int(pair.t.chain.length) <= 7
    got = pair.t.restore()
    assert int(got["step"]) == 19
    same_state(got, state)


def test_save_load_dir_restart(tmp_path):
    state = to_torch(make_state())
    ck = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    ck.save(state)
    state["step"] = torch.tensor(42, dtype=torch.int32)
    ck.save(state)
    ck.save_to_dir(str(tmp_path))
    ck2 = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    ck2.load_from_dir(str(tmp_path))
    assert int(ck2.restore()["step"]) == 42


def test_async_save_overlaps_and_orders():
    state = to_torch(make_state())
    ck = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    futs = []
    for i in range(4):
        state = dict(state)
        state["step"] = torch.tensor(i, dtype=torch.int32)
        futs.append(ck.save_async(state))
    stats = [f.result() for f in futs]
    assert [s["chain_length"] for s in stats] == [2, 3, 4, 5]
    assert int(ck.restore()["step"]) == 3


# -- parity and the port's own rules ------------------------------------------


@pytest.mark.parametrize("scalable", [True, False])
@pytest.mark.parametrize("case", ["deltas", "pool_gc", "stream"])
def test_chain_equals_jax_after_saves(case, scalable):
    """Same saves, same chain: through the pool GC (a pool of 1.5x the
    pages, which the deltas outgrow) and the streaming policy (threshold
    4)."""
    kw = dict(page_size=32, scalable=scalable, max_chain=16)
    if case == "pool_gc":
        kw["pool_slack"] = 1.5
    if case == "stream":
        kw["stream_threshold"] = 4
    state = make_state(seed=2)
    pair = Pair(state, **kw)
    rng = np.random.default_rng(3)
    streamed = gc = False
    for i in range(10):
        state = _map(state, lambda x: x.copy())
        state["w"][rng.choice(32, 4, replace=False)] += 1.0
        state["step"] = np.asarray(i, np.int32)
        cursor = int(pair.t.chain.pool_cursor)
        length = int(pair.t.chain.length)
        st = pair.save(state)
        gc |= int(pair.t.chain.pool_cursor) < cursor + st["pages_written"]
        streamed |= int(pair.t.chain.length) <= length
    assert gc == (case == "pool_gc")
    assert streamed == (case in ("pool_gc", "stream"))
    # direct access reads only the active volume: a scalable chain's
    for m in METHODS if scalable else ["vanilla", "pallas_vanilla", "auto"]:
        same_state(pair.t.restore(method=m), state)


@pytest.mark.parametrize("method", METHODS)
def test_restore_methods_bitwise(method):
    state = make_state(seed=4)
    pair = Pair(state, page_size=32, scalable=method != "vanilla")
    for i in range(3):
        state["nested"]["m"] = state["nested"]["m"] * 2.0
        pair.save(state)
    got = pair.t.restore(method=method)
    same_state(got, state)
    same_state(got, pair.j.restore(method=method))


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32", "bfloat16",
                                   "float16"])
@pytest.mark.parametrize("size", [1, 6, 7])
def test_leaf_words_equal_jax(dtype, size):
    """Every leaf dtype's words equal JAX's ``bitcast_convert_type`` words,
    odd half-precision leaves padded with one zero element."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal(size) * 1e3
    if dtype in ("int32", "uint32"):
        x = rng.integers(-2**31 if dtype == "int32" else 0,
                         2**31 if dtype == "int32" else 2**32, size)
    j = jnp.asarray(x, dtype)
    t = to_torch(np.asarray(j))
    want = np.asarray(jckpt._leaf_to_u32(j)).view(np.int32)
    got = tckpt._leaf_to_words(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tckpt._words_to_leaf(got, tckpt._Leaf(tuple(t.shape), t.dtype))
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(_np(back), _np(t))


def test_odd_bf16_leaves_in_a_state_equal_jax():
    rng = np.random.default_rng(5)
    state = dict(a=rng.standard_normal((3, 5)).astype(jnp.bfloat16),
                 c=rng.standard_normal(7).astype(np.float16),
                 b=np.asarray(rng.integers(0, 2**32, 9), np.uint32))
    pair = Pair(state, page_size=8)
    pair.save(state)
    state["a"] = (state["a"].astype(np.float32) + 1).astype(jnp.bfloat16)
    pair.save(state)
    same_state(pair.t.restore(), state)


def test_leaves_follow_sorted_key_order():
    """Insertion order is not layout order: ``z`` was inserted first but
    ``a``'s words come first, as in JAX; lists keep their order."""
    state = {"z": np.full(4, 2.0, np.float32), "a": np.full(4, 1.0, np.float32),
             "m": [np.full(2, 3.0, np.float32), np.full(2, 4.0, np.float32)]}
    pair = Pair(state, page_size=16)
    pair.save(state)
    words = pair.t._flatten(to_torch(state)).reshape(-1)[:12].view(torch.float32)
    assert words.tolist() == [1.0] * 4 + [3.0, 3.0, 4.0, 4.0] + [2.0] * 4
    got = pair.t.restore()
    assert list(got) == ["z", "a", "m"] and isinstance(got["m"], list)
    same_state(got, state)


def test_restore_is_freed_with_its_leaves():
    """A restored image lives exactly as long as its leaves: restore builds
    no reference cycle (with the collector off, dropping the state frees
    the leaves)."""
    state = to_torch(make_state(seed=9))
    ck = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    ck.save(state)
    gc.disable()
    try:
        got = ck.restore()
        refs = [weakref.ref(x) for x in leaves(got)]
        del got
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_unsupported_dtype_and_mismatched_state_raise():
    with pytest.raises(TypeError):
        tckpt.SnapshotCheckpointer(dict(x=torch.zeros(3, dtype=torch.float64)),
                                   device="cpu")
    ck = tckpt.SnapshotCheckpointer(dict(x=torch.zeros(3)), device="cpu")
    with pytest.raises(ValueError):
        ck.save(dict(x=torch.zeros(3, dtype=torch.int32)))


def test_async_mutation_after_submit_is_not_saved():
    """Each ``save_async`` holds the state as it was at submission, though
    the caller changes it in place right after the call returns."""
    state = to_torch(make_state(seed=6))
    ck = tckpt.SnapshotCheckpointer(state, page_size=64, device="cpu")
    expected, futs = [], []
    for i in range(4):
        state["step"].fill_(i)
        expected.append(_map(state, torch.clone))
        futs.append(ck.save_async(state))
        state["w"].add_(1.0)                      # in place, at once
        state["nested"]["m"][i].neg_()
        fut = futs[-1]
        fut.result()
        same_state(ck.restore(), expected[-1])
    assert [f.result()["chain_length"] for f in futs] == [2, 3, 4, 5]


@pytest.mark.parametrize("scalable", [True, False])
def test_chain_npz_cross_loads(tmp_path, scalable):
    """A ``chain.npz`` of either package loads in the other; the files hold
    the same keys, dtypes and values."""
    state = make_state(seed=7)
    pair = Pair(state, page_size=32, scalable=scalable)
    pair.save(state)
    state["w"] = state["w"] * 3.0
    pair.save(state)
    pair.j.save_to_dir(str(tmp_path / "jax"))
    pair.t.save_to_dir(str(tmp_path / "port"))
    zj = np.load(tmp_path / "jax" / "chain.npz")
    zt = np.load(tmp_path / "port" / "chain.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    fresh = make_state(seed=8)
    t2 = tckpt.SnapshotCheckpointer(to_torch(fresh), page_size=32,
                                    scalable=scalable, device="cpu")
    t2.load_from_dir(str(tmp_path / "jax"))
    j2 = jckpt.SnapshotCheckpointer(to_jax(fresh), page_size=32, scalable=scalable)
    j2.load_from_dir(str(tmp_path / "port"))
    t2.stats = j2.stats = pair.j.stats
    same_chain(j2, t2)
    method = "direct" if scalable else "vanilla"
    same_state(t2.restore(method=method), state)
    same_state(j2.restore(method=method), state)
    state["b"] = state["b"] - 1.0                   # both resume alike
    assert t2.save(to_torch(state)) == j2.save(to_jax(state))
    same_chain(j2, t2)


def test_convert_integer_pool_bit_view():
    """A JAX ``uint32`` pool with words above 2^24 (and NaN bf16 pairs)
    converts bit for bit; float32 would round them."""
    words = np.asarray([[0xFFFFFFFF, (1 << 24) + 1, 0x7FC17FC1, 0x80000001]],
                       np.uint32)
    spec = TSpec(n_pages=64, page_size=4, max_chain=2, pool_capacity=1,
                 dtype=torch.int32)
    arrays = dict(l1=np.zeros((2, 1), np.uint32),
                  l2=np.zeros((2, 64, 2), np.uint32), pool=words,
                  pool_cursor=np.asarray(1, np.int32),
                  length=np.asarray(1, np.int32),
                  overflow=np.asarray(False), snap_dropped=np.asarray(False))
    ch = convert.chain_from_numpy(spec, arrays, scalable=True, device="cpu")
    assert ch.pool.dtype == torch.int32
    np.testing.assert_array_equal(ch.pool.numpy().view(np.uint32), words)


# -- tenant checkpoints (tests/test_migrate.py's directory round trip) --------

N_PAGES, PAGE = 32, 4


def _fleet_spec(module, **kw):
    base = dict(n_tenants=3, n_pages=N_PAGES, page_size=PAGE, max_chain=8,
                pool_capacity=4096, lease_quantum=8, l2_per_table=N_PAGES)
    base.update(kw)
    return module.FleetSpec(**base)


def _grown(depth):
    """A JAX fleet grown ``depth`` layers deep, tenant 1 holding demoted
    layers, carried into the port."""
    rng = np.random.default_rng(depth)
    jspec = _fleet_spec(jfleet, max_chain=depth + 1)
    jf = jfleet.create(jspec, scalable=True)
    for layer in range(depth):
        if layer:
            jf = jfleet.snapshot(jf)
        for _ in range(2):
            ids = np.stack([rng.choice(N_PAGES, 2, replace=False)
                            for _ in range(3)]).astype(np.int32)
            data = rng.standard_normal((3, 2, PAGE)).astype(np.float32)
            jf = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data))
    js = JStore.for_fleet(jspec)
    jf, _ = jfleet.demote_tenants(jf, js, [1], max_rows=24)
    tspec = _fleet_spec(tfleet, max_chain=depth + 1)
    tf = convert.fleet_from_numpy(
        tspec, {n: np.asarray(getattr(jf, n)) for n in convert.FLEET_FIELDS},
        device="cpu")
    ts = convert.tiered_store_from_numpy(
        js.page_size, torch.float32, js._data, free=js._free, top=js._top,
        demoted_rows=js.demoted_rows, promoted_rows=js.promoted_rows)
    return jf, js, tf, ts


def _dst(module, store_cls, depth):
    spec = _fleet_spec(module, n_tenants=2, pool_capacity=8192,
                       lease_quantum=16, max_chain=depth + 2)
    kw = dict(device="cpu") if module is tfleet else {}
    return module.create(spec, scalable=False, **kw), store_cls.for_fleet(spec)


@pytest.mark.parametrize("depth", [1, 12])
def test_checkpoint_tenant_dir_round_trip(tmp_path, depth):
    """Save tenant 1 (cold layers included) into a directory and restore it
    into a different-geometry fleet, in the port; then across packages."""
    jf, js, tf, ts = _grown(depth)
    tckpt.save_tenant_to_dir(tf, 1, str(tmp_path / "port"), store=ts)
    dst, dst_store = _dst(tfleet, TStore, depth)
    dst = tckpt.load_tenant_from_dir(dst, 0, str(tmp_path / "port"),
                                     src_tenant=1, store=dst_store)
    want = tmigrate.materialize_tenant(tf, 1, store=ts)
    assert torch.equal(_bits(tmigrate.materialize_tenant(dst, 0, store=dst_store)),
                       _bits(want))
    check_fleet_invariants(dst, store=dst_store)
    # a JAX-saved tenant directory restores in the port, and the reverse
    jckpt.save_tenant_to_dir(jf, 1, str(tmp_path / "jax"), store=js)
    dst2, dst2_store = _dst(tfleet, TStore, depth)
    dst2 = tckpt.load_tenant_from_dir(dst2, 1, str(tmp_path / "jax"),
                                      store=dst2_store)
    assert torch.equal(_bits(tmigrate.materialize_tenant(dst2, 1, store=dst2_store)),
                       _bits(want))
    jdst, jdst_store = _dst(jfleet, JStore, depth)
    jdst = jckpt.load_tenant_from_dir(jdst, 0, str(tmp_path / "port"),
                                      src_tenant=1, store=jdst_store)
    np.testing.assert_array_equal(
        _np(jmigrate.materialize_tenant(jdst, 0, store=jdst_store)), _np(want))


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("method", METHODS)
def test_elastic_reshard(method):
    """Save unsharded, restore onto a live mesh with real shardings: every
    leaf a ``DTensor`` with the requested placements, its local tensor
    bitwise the saved leaf, and the values JAX's ``restore(shardings=)``
    gives on its own one-device mesh."""
    import jax
    import torch.distributed as dist
    from jax.sharding import NamedSharding as JNamed
    from jax.sharding import PartitionSpec as JP
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh

    state = dict(w=np.random.default_rng(5).standard_normal((8, 16)).astype(
        np.float32), b=np.arange(6, dtype=np.int32))
    pair = Pair(state, page_size=32, scalable=method != "vanilla")
    pair.save(state)
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    try:
        shardings = dict(w=sh.NamedSharding(mesh, sh.P("data", "model")),
                         b=sh.NamedSharding(mesh, sh.P(None)))
        got = pair.t.restore(method=method, shardings=shardings)
        assert isinstance(got["w"], DTensor) and isinstance(got["b"], DTensor)
        assert list(got["w"].placements) == [Shard(0), Shard(1)]
        assert list(got["b"].placements) == [Replicate(), Replicate()]
        jmesh = j_host_mesh(data=1, model=1)
        jgot = pair.j.restore(method=method, shardings=dict(
            w=JNamed(jmesh, JP(None, None)), b=JNamed(jmesh, JP(None))))
        for k in state:
            np.testing.assert_array_equal(got[k].to_local().numpy(), state[k])
            np.testing.assert_array_equal(got[k].full_tensor().numpy(),
                                          np.asarray(jax.device_get(jgot[k])))
    finally:
        dist.destroy_process_group()
