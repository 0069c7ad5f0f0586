"""The port's distribution layer against the JAX package: the sharding
rules (``distributed/sharding.py``), int8 DP compression
(``distributed/compression.py``), the meshes (``launch/mesh.py``) and the
per-device op counts (``launch/op_analysis.py``).

- Rule resolution needs axis names and sizes only: both packages resolve
  on abstract meshes of the production geometries, and every spec of the
  full-size configs must equal JAX's ``PartitionSpec`` entry for entry.
- Sharded runs happen on a one-rank ``gloo`` group (``make_host_mesh``):
  each family's smoke config placed by ``param_shardings`` and run under
  ``use_rules`` must give bitwise the plain prefill, decode step, loss
  and gradients.
- ``compressed_psum`` on 2 and 4 ranks runs in processes spawned with
  ``gloo`` and a ``FileStore`` under ``tmp_path``; the fake group of
  ``op_analysis``'s collective case lives in this process only while its
  test runs (no other group is up then).
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cells_for as j_cells_for  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.api import batch_specs as j_batch_specs  # noqa: E402
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import SHAPES, cells_for, get_config, list_archs  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.api import batch_specs, make_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.train_step import make_train_step, value_and_grad  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCHS = list_archs()
GEOMETRIES = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_abstract_mesh((16, 16), ("data", "model"))


@pytest.fixture
def host_mesh():
    """A one-rank ``gloo`` mesh for one test; no other group around it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield tmesh.make_host_mesh(device="cpu")
    dist.destroy_process_group()


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _same(a, b) -> bool:
    return torch.equal(_full(a), b)


# ---------------------------------------------------------------------------
# the cases of tests/test_distributed.py that cover these modules
# ---------------------------------------------------------------------------

def test_rules_divisibility_guard(mesh):
    rules = sh.make_rules(mesh)
    model_size = mesh.shape["model"]
    assert rules.partition(("heads",), (model_size + 1,)) == sh.P(None)
    assert rules.partition(("heads",), (model_size * 4,)) == sh.P("model")


def test_rules_duplicate_axis_dedup(mesh):
    rules = sh.make_rules(mesh)
    ms = mesh.shape["model"]
    spec = rules.partition(("kv_seq", "kv_heads"), (ms * 2, ms * 2))
    assert spec[0] == "model" and spec[1] is None


def test_param_specs_name_rules(mesh):
    rules = sh.make_rules(mesh)
    meta = dict(device="meta")
    params = dict(layers=dict(attn=dict(wq=torch.empty((4, 64, 64), **meta))),
                  embed=torch.empty((128, 64), **meta),
                  ln=torch.empty((64,), **meta))
    specs = sh.param_specs(params, rules)
    assert specs["ln"] == sh.P(None)
    assert len(specs["layers"]["attn"]["wq"]) == 3  # stacked rank respected


def test_compressed_psum_error_feedback():
    """Error feedback: accumulated compressed transmissions converge to the
    true mean; a single shot's error is within one quantization step."""
    x = torch.from_numpy(
        (np.random.default_rng(0).standard_normal(256) * 3).astype(np.float32))
    err = torch.zeros_like(x)
    total = torch.zeros_like(x)
    for _ in range(50):
        y = x + err
        q, scale = comp.quantize_int8(y)
        deq = q.float() * scale
        err = y - deq
        total = total + deq
    np.testing.assert_allclose((total / 50).numpy(), x.numpy(), atol=3e-3)
    q, scale = comp.quantize_int8(x)
    assert float((x - q.float() * scale).abs().max()) <= float(scale)


def test_compression_wire_bytes():
    """On 2 ranks the counts are JAX's; past that the int8 all-gather
    sends ``ranks - 1`` copies and the f32 ring all-reduce about two: the
    same at 8 ranks (but for the scales), twice as much at 16."""
    tree = dict(a=torch.zeros((100,)), b=torch.zeros((28,)))
    assert comp.wire_bytes(tree, compressed=False, ranks=2) == 512
    assert comp.wire_bytes(tree, compressed=True, ranks=2) == 128 + 8
    jtree = dict(a=jnp.zeros((100,)), b=jnp.zeros((28,)))
    for c in (False, True):
        assert comp.wire_bytes(tree, compressed=c, ranks=2) == jcomp.wire_bytes(
            jtree, compressed=c)
    assert comp.wire_bytes(tree, compressed=False, ranks=4) == 768
    assert comp.wire_bytes(tree, compressed=True, ranks=4) == 3 * 136
    assert comp.wire_bytes(tree, compressed=False, ranks=8) == 896
    assert comp.wire_bytes(tree, compressed=True, ranks=8) == 7 * 136
    assert comp.wire_bytes(tree, compressed=False, ranks=16) == 960
    assert comp.wire_bytes(tree, compressed=True, ranks=16) == 15 * 136


# ---------------------------------------------------------------------------
# every spec of the full-size configs equals JAX's
# ---------------------------------------------------------------------------

def _jspec(s):
    return tuple(s)


def _match(port_tree, jax_tree):
    """Leaf-for-leaf equality of a port spec tree and a JAX one."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_tree, is_leaf=lambda x: isinstance(x, JP))
    n = 0
    for path, js in flat:
        node = port_tree
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node) == _jspec(js), (path, node, js)
        n += 1
    assert n == len(leaves_of_specs(port_tree))


def leaves_of_specs(tree):
    if isinstance(tree, sh.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of_specs(v)]
    return [x for v in tree for x in leaves_of_specs(v)]


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    jm = j_get_model(j_get_config(arch))
    spec = J_SHAPES["decode_32k"]
    cache = jax.eval_shape(lambda: jm.init_cache(spec.global_batch, spec.seq_len))
    return jm.init_shapes(), cache


@pytest.mark.parametrize("seq_shard", [False, True], ids=["dp_tp", "sp"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, geometry, seq_shard):
    """``param_specs`` of ``init_shapes()``, ``cache_specs`` of the
    decode_32k cache and ``batch_spec`` of every cell's inputs, at full
    size: JAX's specs leaf for leaf."""
    shape, axes = GEOMETRIES[geometry]
    rules = sh.make_rules(tmesh.make_abstract_mesh(shape, axes),
                          seq_shard=seq_shard)
    jrules = jsh.make_rules(jmesh.make_abstract_mesh(shape, axes),
                            seq_shard=seq_shard)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model = get_model(cfg)
    jparams, jcache = _jax_shapes(arch)
    _match(sh.param_specs(model.init_shapes(), rules),
           jsh.param_specs(jparams, jrules))
    opt = adamw.init(model.init_shapes())
    _match(sh.param_specs(opt, rules),
           jsh.param_specs(jax.eval_shape(jadamw.init, jparams), jrules))
    spec = SHAPES["decode_32k"]
    cache = model.init_cache(spec.global_batch, spec.seq_len, device="meta")
    _match(sh.cache_specs(cache, rules), jsh.cache_specs(jcache, jrules))
    assert cells_for(arch) == j_cells_for(arch)
    for cell in cells_for(arch):
        s, js = SHAPES[cell], J_SHAPES[cell]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            js.name, js.seq_len, js.global_batch, js.kind)
        b = batch_specs(cfg, s.global_batch, s.seq_len, kind=s.kind)
        jb = j_batch_specs(jcfg, s.global_batch, s.seq_len, kind=s.kind)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in b.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
        _match(sh.batch_spec(b, rules), jsh.batch_spec(jb, jrules))


def test_init_shapes_allocate_nothing():
    """``init_shapes`` is the parameter tree on ``meta``: JAX's shapes and
    dtypes, the whole of Qwen2-72B, with no storage."""
    model = get_model(get_config("qwen2-72b"))
    tree = model.init_shapes()
    assert all(x.device.type == "meta" for x in leaves(tree))
    jtree = _jax_shapes("qwen2-72b")[0]
    assert [tuple(x.shape) for x in leaves(tree)] == [
        tuple(x.shape) for x in jax.tree.leaves(jtree)]
    assert sum(x.numel() for x in leaves(tree)) == sum(
        x.size for x in jax.tree.leaves(jtree))


# ---------------------------------------------------------------------------
# specs → placements, lshard without rules
# ---------------------------------------------------------------------------

def test_placements_one_per_mesh_dim(host_mesh):
    class Mesh3:   # the placement rule needs the dim names alone
        mesh_dim_names = ("pod", "data", "model")

    m3 = Mesh3()
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m3) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.placements(sh.P(None, "data"), m3) == [
        Replicate(), Shard(1), Replicate()]
    assert sh.placements(sh.P(), m3) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("data", "pod")), m3)
    # a singleton dim stays whole (it may name only size-1 axes)
    assert sh.placements(sh.P("data", "model"), host_mesh, (1, 4)) == [
        Replicate(), Shard(1)]
    x = torch.arange(12.0).reshape(3, 4)
    d = sh.place(x, sh.NamedSharding(host_mesh, sh.P("data", "model")))
    assert list(d.placements) == [Shard(0), Shard(1)]
    assert torch.equal(d.to_local(), x)


def test_lshard_noop_without_rules(host_mesh):
    x = torch.randn(2, 3)
    assert sh.lshard(x, "batch", "embed") is x
    rules = sh.make_rules(host_mesh)
    with sh.use_rules(rules):
        assert sh.active_rules() is rules
        assert sh.lshard(x, "batch", "embed") is x       # plain tensor
        d = sh.place(x, sh.NamedSharding(host_mesh, sh.P()))
        out = sh.lshard(d, "batch", "embed")
        assert list(out.placements) == [Shard(0), Replicate()]
        with pytest.raises(ValueError, match="names"):
            sh.lshard(d, "batch")
    assert sh.active_rules() is None
    d = sh.place(x, sh.NamedSharding(host_mesh, sh.P()))
    assert sh.lshard(d, "batch", "embed") is d           # no rules


# ---------------------------------------------------------------------------
# sharded ≡ plain on a one-rank mesh, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_plain(host_mesh, arch):
    """Parameters placed by ``param_shardings``, the batch by
    ``batch_spec`` and the decode cache by ``cache_specs``, run under
    ``use_rules``: prefill logits, one decode step, the loss and every
    gradient bitwise equal to the plain run."""
    cfg = smoke_config(arch)
    model = get_model(cfg)
    rules = sh.make_rules(host_mesh)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, 0, 2, 8, device="cpu")
    dparams = sh.distribute(params, sh.param_shardings(params, rules))
    dbatch = sh.distribute(batch, sh.shardings_of(sh.batch_spec(batch, rules),
                                                  host_mesh))
    assert any(isinstance(x, DTensor) and Shard(0) in x.placements
               for x in leaves(dparams))
    logits, _ = model.prefill(params, batch)
    tok = batch["tokens"][:, :1]
    cache = model.init_cache(2, 12, device="cpu")
    dcache = sh.distribute(model.init_cache(2, 12, device="cpu"),
                           sh.shardings_of(sh.cache_specs(cache, rules), host_mesh))
    step_logits, _ = model.decode_step(params, cache, tok)
    loss, grads = value_and_grad(model.loss, params, batch)
    with sh.use_rules(rules):
        dlogits, _ = model.prefill(dparams, dbatch)
        dstep, _ = model.decode_step(
            dparams, dcache,
            sh.place(tok, sh.NamedSharding(host_mesh, sh.P("data", None))))
        dloss, dgrads = value_and_grad(model.loss, dparams, dbatch)
    assert isinstance(dlogits, DTensor) and _same(dlogits, logits)
    assert _same(dstep, step_logits)
    assert _same(dloss, loss)
    for g, want in zip(leaves(dgrads), leaves(grads)):
        assert isinstance(g, DTensor) and _same(g, want)


def test_train_step_pins_grads(host_mesh, monkeypatch):
    """``grad_shardings`` pins DTensor gradients and the accumulation
    carry to the parameters' placements (the gradients AdamW gets are
    placed as their parameters); the step with accumulation is bitwise
    the plain step."""
    seen = []
    real_apply = adamw.apply

    def spy(cfg_, grads, state, params_):
        seen.append(grads)
        return real_apply(cfg_, grads, state, params_)

    monkeypatch.setattr(adamw, "apply", spy)
    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    rules = sh.make_rules(host_mesh)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, 0, 4, 8, device="cpu")
    shardings = sh.param_shardings(params, rules)
    # a one-rank DTensor may share its tensor's storage: the plain step
    # below updates ``params`` in place, so the sharded run gets a copy
    dparams = sh.distribute(tree_map(torch.clone, params), shardings)
    dopt = sh.distribute(adamw.init(params), dict(
        m=shardings, v=shardings,
        step=sh.NamedSharding(host_mesh, sh.P())))
    dbatch = sh.distribute(batch, sh.shardings_of(sh.batch_spec(batch, rules),
                                                  host_mesh))
    opt = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(), accum_steps=2)
    _, _, met = step(params, opt, batch)
    dstep = make_train_step(model, adamw.AdamWConfig(), accum_steps=2,
                            grad_shardings=shardings)
    with sh.use_rules(rules):
        dp, dopt, dmet = dstep(dparams, dopt, dbatch)
    assert _same(dmet["loss"], met["loss"])
    for a, b in zip(leaves(dp), leaves(params)):
        assert _same(a, b)
    assert len(seen) == 2
    for g, s in zip(leaves(seen[1]), leaves_of_shardings(shardings)):
        assert isinstance(g, DTensor)
        assert list(g.placements) == s.placements_for(tuple(g.shape))
    for a, s in zip(leaves(dopt["m"]), leaves_of_shardings(shardings)):
        assert list(a.placements) == s.placements_for(tuple(a.shape))


def leaves_of_shardings(tree):
    if isinstance(tree, sh.NamedSharding):
        return [tree]
    return [x for k in sorted(tree) for x in leaves_of_shardings(tree[k])]


# ---------------------------------------------------------------------------
# compression against JAX
# ---------------------------------------------------------------------------

def _jax_psum_one(x, err):
    mesh = jmesh.make_host_mesh(data=1, model=1)
    fn = jax.shard_map(lambda a, e: jcomp.compressed_psum(a, e, "data"),
                       mesh=mesh, in_specs=(JP(), JP()), out_specs=(JP(), JP()),
                       check_vma=False)
    return jax.jit(fn)(jnp.asarray(x), jnp.asarray(err))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_psum_bitwise_jax(host_mesh, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 33)) * 10 ** rng.uniform(-3, 2)).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    jsum, jerr = _jax_psum_one(x, err)
    got, new_err = comp.compressed_psum(torch.from_numpy(x), torch.from_numpy(err),
                                        host_mesh.get_group("data"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))


def _psum_worker(rank, world, store_path, out_dir):
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        x = torch.from_numpy(np.load(os.path.join(out_dir, f"x{rank}.npy")))
        err = torch.from_numpy(np.load(os.path.join(out_dir, f"e{rank}.npy")))
        mesh = tmesh.make_host_mesh(data=world, model=1, device="cpu")
        total, new_err = comp.compressed_psum(x, err, mesh.get_group("data"))
        np.save(os.path.join(out_dir, f"sum{rank}.npy"), total.numpy())
        np.save(os.path.join(out_dir, f"err{rank}.npy"), new_err.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_ranks(tmp_path, world):
    """On ``world`` spawned gloo ranks: every rank's sum equals the f32
    sum, in rank order, of each rank's JAX-dequantized values, and each
    rank's error state is bitwise JAX's residual of its own input."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(world)
    xs = [(rng.standard_normal(300) * (r + 1)).astype(np.float32)
          for r in range(world)]
    es = [(rng.standard_normal(300) * 1e-2).astype(np.float32)
          for r in range(world)]
    for r in range(world):
        np.save(tmp_path / f"x{r}.npy", xs[r])
        np.save(tmp_path / f"e{r}.npy", es[r])
    mp.spawn(_psum_worker, args=(world, str(tmp_path / "store"), str(tmp_path)),
             nprocs=world, join=True)
    want, jerrs = None, []
    for x, e in zip(xs, es):
        deq, jerr = map(np.asarray, _jax_psum_one(x, e))   # one rank's own
        jerrs.append(jerr)
        want = deq if want is None else (want + deq).astype(np.float32)
    for r in range(world):
        np.testing.assert_array_equal(np.load(tmp_path / f"sum{r}.npy"), want)
        np.testing.assert_array_equal(np.load(tmp_path / f"err{r}.npy"), jerrs[r])


# ---------------------------------------------------------------------------
# the DP train step
# ---------------------------------------------------------------------------

@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _rel(got, want) -> float:
    got = np.asarray(_full(got).detach().double().numpy())
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("compress", [False, True], ids=["f32", "int8"])
def test_dp_train_step_vs_jax(host_mesh, f32, compress):
    """One rank: two steps of the port's DP step against JAX's.

    After the first step AdamW's ``m`` is ``(1 - b1)`` times the summed
    gradient, so it holds the gradient the step reduced. Uncompressed,
    each leaf of ``m`` is JAX's within ``test_torch_train.py``'s f32
    gradient tolerance, 1e-4 relative L2. Compressed, a gradient element
    that the two packages' last ulp puts on either side of a rounding
    boundary lands one int8 step apart, so each element of ``m`` and of
    the error state is held within one step of JAX's (1 % over for the
    scales' own rounding): for the error state JAX's scale of its
    gradient leaf, ``max|g| / 127``, and for ``m`` that step as AdamW
    took it, ``max|m| / 127``.
    Then each step's loss at 1e-4 relative (the second reads the first's
    update), and every parameter within 2·lr a step of JAX's: AdamW moves
    an element by about ``lr`` whatever its gradient, so a gradient near
    zero whose sign the last ulp decides moves it up to 2·lr the other
    way. The error state is zero unless compressed."""
    arch = "qwen2.5-3b"
    jm = j_get_model(j_smoke(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    model = get_model(smoke_config(arch))
    params = convert.params_from_jax(np_params, device="cpu")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    jstep = jcomp.make_dp_train_step(jm, jadamw.AdamWConfig(lr=1e-3, warmup_steps=1),
                                     jmesh.make_host_mesh(data=1, model=1),
                                     compress=compress)
    step = comp.make_dp_train_step(model, ocfg, host_mesh, compress=compress)
    jopt, jerr = jadamw.init(jparams), jcomp.init_error_state(jparams)
    opt, err = adamw.init(params), comp.init_error_state(params)
    for i in range(2):
        jb = j_make_batch(jm.cfg, jax.random.PRNGKey(i), 4, 16)
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
        jgrads = jax.grad(jm.loss)(jparams, jb) if i == 0 else None
        jparams, jopt, jerr, jloss = jstep(jparams, jopt, jerr, jb)
        params, opt, err, loss = step(params, opt, err, b)
        assert _rel(loss, jloss) < 1e-4
        if i:
            continue
        pairs = list(zip(leaves(opt["m"]), jax.tree.leaves(jopt["m"]),
                         leaves(err), jax.tree.leaves(jerr),
                         jax.tree.leaves(jgrads)))
        assert len(pairs) == len(leaves(params))
        for m, jm_, e, je, jg in pairs:
            jm_, je, jg = np.asarray(jm_), np.asarray(je), np.asarray(jg)
            if not compress:
                assert _rel(m, jm_) < 1e-4
                continue
            assert np.abs(m.numpy() - jm_).max() <= 1.01 * np.abs(jm_).max() / 127
            assert np.abs(e.numpy() - je).max() <= 1.01 * np.abs(jg).max() / 127
    for a, b in zip(leaves(params), jax.tree.leaves(jparams)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * 2 * ocfg.lr
    assert all(torch.isfinite(e).all() for e in leaves(err))
    assert any(float(e.abs().max()) > 0 for e in leaves(err)) == compress


def test_dp_step_uncompressed_is_train_step(host_mesh):
    """On one rank ``make_dp_train_step(compress=False)`` is bitwise
    ``make_train_step``: loss, parameters and AdamW state; and with
    compression each residual element is within its leaf's scale."""
    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    p1 = model.init(torch.Generator().manual_seed(0), device="cpu")
    p2 = tree_map(torch.clone, p1)
    p3 = tree_map(torch.clone, p1)
    o1, o2, o3 = adamw.init(p1), adamw.init(p2), adamw.init(p3)
    ref = make_train_step(model, ocfg)
    dp = comp.make_dp_train_step(model, ocfg, host_mesh, compress=False)
    dpc = comp.make_dp_train_step(model, ocfg, host_mesh, compress=True)
    e2, e3 = comp.init_error_state(p2), comp.init_error_state(p3)
    for i in range(3):
        b = make_batch(cfg, i, 2, 8, device="cpu")
        p1, o1, met = ref(p1, o1, b)
        p2, o2, e2, loss = dp(p2, o2, e2, b)
        assert torch.equal(loss, met["loss"])
        grads = value_and_grad(model.loss, p3, b)[1]
        scales = [comp.quantize_int8(g.float() + e)[1]
                  for g, e in zip(leaves(grads), leaves(e3))]
        p3, o3, e3, _ = dpc(p3, o3, e3, b)
        for e, s in zip(leaves(e3), scales):
            assert bool((e.abs() <= s).all())
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# decode over a kv_seq-sharded cache: the split softmax, on two ranks
# ---------------------------------------------------------------------------

SPLIT_ARCHS = ("qwen2.5-3b", "zamba2-2.7b", "whisper-base")
SPLIT_PROMPT = 14


def _pad_kv(cache, length):
    """The cache with its self-attention K/V (L, B, S, Hkv, D) zero-padded
    to ``length`` positions (cross K/V and states as they are)."""
    def visit(path, x):
        if str(path[-1]) in ("k", "v"):
            pad = x.new_zeros(x.shape[:2] + (length - x.shape[2],) + x.shape[3:])
            return torch.cat([x, pad], dim=2)
        return x.clone() if isinstance(x, torch.Tensor) else x
    return sh.map_with_path(visit, cache)


def _split_decode_worker(rank, world, store_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        tl.COMPUTE_DTYPE = torch.float32
        mesh = tmesh.make_host_mesh(data=1, model=2, device="cpu")
        rules = sh.make_rules(mesh)
        for arch in SPLIT_ARCHS:
            cfg = smoke_config(arch)
            model = get_model(cfg)
            params = model.init(torch.Generator().manual_seed(0), device="cpu")
            batch = make_batch(cfg, 0, 2, SPLIT_PROMPT, device="cpu")
            _, cache = model.prefill(params, batch)
            dparams = sh.distribute(params, sh.param_shardings(params, rules))
            gen = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=gen,
                                 dtype=torch.int32)

            def placed(c):
                return sh.distribute(c, sh.shardings_of(sh.cache_specs(c, rules),
                                                        mesh))

            # 32 positions in two shards of 16: the first two steps leave
            # shard 1 wholly past kv_len, the last two write into it
            plain, dcache = _pad_kv(cache, 32), placed(_pad_kv(cache, 32))
            assert Shard(2) in dcache["k"].placements, arch
            for tok in toks:
                want, plain = model.decode_step(params, plain, tok)
                with sh.use_rules(rules):
                    got, dcache = model.decode_step(
                        dparams, dcache,
                        sh.place(tok, sh.NamedSharding(mesh, sh.P("data", None))))
                got = _full(got)
                assert torch.isfinite(got).all(), arch
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
            for name in ("k", "v"):
                torch.testing.assert_close(_full(dcache[name]), plain[name],
                                           rtol=0, atol=1e-4)
            # the step's collectives do not grow with the cache: nothing of
            # it is gathered
            reports = []
            for length in (32, 64):
                dc = placed(_pad_kv(cache, length))
                with sh.use_rules(rules):
                    _, rep = op_analysis.count(
                        model.decode_step, dparams, dc,
                        sh.place(toks[0], sh.NamedSharding(mesh, sh.P("data", None))))
                reports.append(rep["collective_bytes"])
            assert reports[0] == reports[1], (arch, reports)
            assert reports[0]["all-reduce"] > 0, arch
    finally:
        dist.destroy_process_group()


def test_split_softmax_decode_on_two_ranks(tmp_path):
    """Decode over a cache whose sequence is split over two spawned gloo
    ranks (a (1, 2) mesh), in f32, for the three families whose decode
    writes and reads a ``kv_seq`` cache: every step's logits within 1e-4
    of the plain decode, the written caches too, a shard wholly past
    ``kv_len`` contributing zeros (no NaN), and the collective bytes of a
    step the same at 32 and 64 cached positions (the cache is never
    all-gathered)."""
    import torch.multiprocessing as mp

    mp.spawn(_split_decode_worker, args=(2, str(tmp_path / "store")),
             nprocs=2, join=True)


def _seq_shard_train_worker(rank, world, store_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        tl.COMPUTE_DTYPE = torch.float32
        mesh = tmesh.make_host_mesh(data=1, model=2, device="cpu")
        rules = sh.make_rules(mesh, seq_shard=True)
        cfg = smoke_config("qwen2.5-3b")
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = make_batch(cfg, 0, 2, 16, device="cpu")
        loss, grads = value_and_grad(model.loss, params, batch)
        dparams = sh.distribute(params, sh.param_shardings(params, rules))
        dbatch = sh.distribute(batch, sh.shardings_of(
            sh.batch_spec(batch, rules), mesh))
        with sh.use_rules(rules):
            dloss, dgrads = value_and_grad(model.loss, dparams, dbatch)
        torch.testing.assert_close(_full(dloss), loss, rtol=0, atol=1e-4)
        for g, want in zip(leaves(dgrads), leaves(grads)):
            assert torch.isfinite(_full(g)).all()
            torch.testing.assert_close(_full(g), want, rtol=0, atol=1e-4)
    finally:
        dist.destroy_process_group()


def test_seq_shard_train_step_on_two_ranks(tmp_path):
    """The loss and every gradient of a training step under
    ``make_rules(seq_shard=True)`` on two spawned gloo ranks (a (1, 2)
    mesh), in f32: k/v's sequence is split over the model axis, and a step
    that records gradients gathers them (the split softmax's collectives
    carry no gradient); within 1e-4 of the plain step."""
    import torch.multiprocessing as mp

    mp.spawn(_seq_shard_train_worker, args=(2, str(tmp_path / "store")),
             nprocs=2, join=True)


def test_attention_partial_combines_to_attention_ref():
    """The split softmax's shard function: two shards' partials, combined
    as ``_split_softmax`` combines them, equal ``attention_ref`` within
    1e-6, with one shard wholly masked."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 3, 4, 8, generator=gen)
    k = torch.randn(2, 10, 2, 8, generator=gen)
    v = torch.randn(2, 10, 2, 8, generator=gen)
    for kv_len in (4, 5, 9):
        want = tl.attention_ref(q, k, v, causal=False, kv_len=kv_len)
        parts = [tl.attention_partial(q, k[:, a:b], v[:, a:b], causal=False,
                                      kv_len=kv_len, k_offset=a)
                 for a, b in ((0, 5), (5, 10))]
        big = torch.maximum(parts[0][0], parts[1][0])
        alphas = [torch.exp(m - big) for m, _, _ in parts]
        den = sum(l * a for (_, l, _), a in zip(parts, alphas))
        num = sum(o * a.permute(0, 3, 1, 2, 4).reshape(2, 3, 4, 1)
                  for (_, _, o), a in zip(parts, alphas))
        got = num / den.permute(0, 3, 1, 2, 4).reshape(2, 3, 4, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        if kv_len <= 5:
            assert parts[1][0].isinf().all() and (parts[1][1] == 0).all()
            assert (parts[1][2] == 0).all()


# ---------------------------------------------------------------------------
# op_analysis
# ---------------------------------------------------------------------------

def test_op_analysis_looped_matmul_exact():
    """FLOPs of a looped matmul == 2·M·N·K·trips exactly (the port's case
    of ``test_weighted_costs_exact_on_known_scan``)."""
    m = n = k = 64
    trips = 7

    def f(a, b):
        x = a
        for i in range(trips):
            x = torch.tanh(x @ b[i])
        return x

    _, rep = op_analysis.count(f, torch.randn(m, k), torch.randn(trips, k, n))
    assert rep["flops"] == 2.0 * m * n * k * trips
    # the matmuls and tanh read and write their tensors; views move nothing
    assert rep["hbm_bytes"] == trips * 4 * (m * k + k * n + m * n + 2 * m * n)
    assert rep["collective_bytes"]["total"] == 0


def test_op_analysis_all_gather_on_fake_mesh():
    """A known redistribution on a fake (2, 4) mesh: the all-gather bytes
    are the gathered result's, exactly, on ``meta`` tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = tmesh._mesh((2, 4), ("data", "model"), "cpu")
        x = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        _, rep = op_analysis.count(
            lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
        assert rep["collective_bytes"]["all-gather"] == 32 * 32 * 4
        y = DTensor.from_local(torch.empty(16, 8, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        _, rep = op_analysis.count(
            lambda: y.redistribute(mesh, [Replicate(), Replicate()]))
        assert rep["collective_bytes"]["all-gather"] == 16 * 32 * 4
        assert rep["collective_bytes"]["total"] == 16 * 32 * 4
        assert rep["flops"] == 0
    finally:
        dist.destroy_process_group()


def test_mesh_refusals(monkeypatch):
    """A production mesh on fewer ranks names the ranks it needs; a mesh
    on ``cuda`` with no card raises."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks; the world has 1"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh(device="cuda")
    assert tmesh.HW["peak_flops_bf16"] == 989e12 and "H100" in tmesh.HW["name"]
    am = tmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    jm = jmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert am.shape == dict(jm.shape) and am.axis_names == tuple(jm.axis_names)
