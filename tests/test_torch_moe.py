"""The port's Mixture-of-Experts layer and the dense variants' layers
(gelu, squared ReLU, the ungated MLP, qk-norm) against the JAX package, on
the same weights (``convert.params_from_jax``) and numpy-seeded inputs.

``moe_apply`` is held in float32 (1e-4) and in bf16 at the bf16 tolerance
of ``tests/test_torch_model.py`` (2e-2, relative to the tensor's largest
magnitude), over one and two dispatch groups, with and without a shared
expert. Two cases pin the routing: router weights of zero (every
probability ties; JAX's ``top_k`` takes experts 0..k-1 and drops what
overflows their capacity) and a capacity factor of 0.25 (most
assignments drop). The combine's order of rounding is pinned bit for bit
in bf16 against the JAX combine's own lines, and the activations are
held bit for bit in f32 and bf16.

Measured on these inputs (CPU): moe_apply differs from JAX by at most
2.7e-7 in f32 and by one bf16 ulp (3.1e-5) in one of 5,120 outputs in
bf16; the aux losses agree within 1.2e-7.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# qwen2-moe keeps one shared expert at smoke size, phi3.5-moe has none
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]


def _configs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def _layer(jcfg, seed=0):
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(compute, shape, seed=0):
    jdt, tdt = DTYPES[compute]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32)).astype(jdt)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, compute):
    got, want = _np(got), _np(want)
    tol = TOL[compute]
    scale = max(1.0, float(np.abs(want).max())) if compute == "bf16" else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _both(jcfg, tcfg, jp, tp, jx, tx):
    jo, ja = jax.jit(lambda p, x: jmoe.moe_apply(jcfg, p, x))(jp, jx)
    to, ta = tmoe.moe_apply(tcfg, tp, tx)
    assert to.dtype == tx.dtype and ta.dtype == torch.float32
    return (jo, ja), (to, ta)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, groups, compute):
    jcfg, tcfg = _configs(arch, dispatch_groups=groups)
    jp, tp = _layer(jcfg)
    assert ("shared" in tp) == (arch == "qwen2-moe-a2.7b")
    jx, tx = _inputs(compute, (2, 40, jcfg.d_model))
    (jo, ja), (to, ta) = _both(jcfg, tcfg, jp, tp, jx, tx)
    _close(to, jo, compute)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def _top_i_and_slots(tcfg, tp, tx):
    xt = tx.reshape(tcfg.dispatch_groups, -1, tcfg.d_model)
    _, top_p, top_i = tmoe.route(tcfg, tp, xt)
    cap = tmoe.capacity(xt.shape[1], tcfg)
    _, slot = tmoe.dispatch(xt, top_i, tcfg.n_experts, cap)
    return top_p, top_i, slot, cap


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lowest_experts(arch):
    """Router weights of zero: every probability is 1/E, so every token
    takes experts 0..k-1 (lowest index first, as ``jax.lax.top_k``), and
    each of those experts keeps its first ``cap`` tokens and drops the
    rest. Output and aux equal JAX's."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _layer(jcfg, seed=1)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = _inputs("f32", (1, 48, jcfg.d_model), seed=1)
    top_p, top_i, slot, cap = _top_i_and_slots(tcfg, tp, tx)
    k, e = tcfg.top_k, tcfg.n_experts
    assert torch.equal(top_i[0], torch.arange(k).expand(48, k))
    assert torch.allclose(top_p, torch.full_like(top_p, 1 / k))
    assert cap < 48                                   # drops happen
    kept = (slot[0] < e * cap).reshape(48, k)
    assert torch.equal(kept, (torch.arange(48) < cap)[:, None].expand(48, k))
    (jo, ja), (to, ta) = _both(jcfg, tcfg, jp, tp, jx, tx)
    _close(to, jo, "f32")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    np.testing.assert_allclose(float(ta), e * (1 / e) * k * (1 / k), rtol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_jax(arch, groups):
    """A capacity factor of 0.25: each group's experts hold a quarter of
    their mean load (16 slots for 64 assignments in one group, 8 for 32 in
    two), so most assignments drop; the kept count per expert is its
    capacity or its load, and output and aux equal JAX's."""
    jcfg, tcfg = _configs(arch, capacity_factor=0.25, dispatch_groups=groups)
    jp, tp = _layer(jcfg, seed=2)
    jx, tx = _inputs("f32", (2, 64, jcfg.d_model), seed=2)
    _, top_i, slot, cap = _top_i_and_slots(tcfg, tp, tx)
    assert cap == 16 // groups
    e = tcfg.n_experts
    load = torch.nn.functional.one_hot(top_i, e).sum(dim=(1, 2))   # (g, E)
    kept = slot < e * cap
    kept_by_e = torch.stack([torch.bincount(top_i[g].reshape(-1)[kept[g]],
                                            minlength=e)
                             for g in range(groups)])
    assert torch.equal(kept_by_e, load.clamp(max=cap))
    assert int((~kept).sum()) > kept.numel() // 2
    (jo, ja), (to, ta) = _both(jcfg, tcfg, jp, tp, jx, tx)
    _close(to, jo, "f32")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_combine_rounds_as_the_jax_combine():
    """bf16: the JAX combine's lines (``moe.py``'s ``combine_one``) and
    the port's ``combine`` on the same expert outputs, slots (a third
    dropped) and weights agree bit for bit."""
    rng = np.random.default_rng(3)
    g, e, cap, d, tg, k = 2, 8, 16, 64, 40, 4
    ob = jnp.asarray(rng.standard_normal((g, e, cap, d))).astype(jnp.bfloat16)
    sl = jnp.asarray(np.where(rng.random((g, tg * k)) < 0.33, e * cap,
                              rng.integers(0, e * cap, (g, tg * k))), jnp.int32)
    w = jnp.asarray(rng.random((g, tg, k)), jnp.float32)

    def combine_one(ob, sl, w):
        flat = ob.reshape(e * cap, d)
        picked = jnp.where(
            (sl < e * cap)[:, None], flat[jnp.minimum(sl, e * cap - 1)], 0.0
        )
        return jnp.sum(
            picked.reshape(tg, k, d) * w[..., None].astype(ob.dtype), axis=1
        )

    want = jax.jit(jax.vmap(combine_one))(ob, sl, w)
    got = tmoe.combine(torch.from_numpy(np.array(_np(ob))).to(torch.bfloat16),
                       torch.from_numpy(np.asarray(sl).astype(np.int64)),
                       torch.from_numpy(np.array(w)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


# -- the dense variants' layers -----------------------------------------------


@pytest.mark.parametrize("name,compute", [
    ("gelu", "f32"), ("gelu", "bf16"), ("relu2", "f32"), ("relu2", "bf16"),
    ("silu", "bf16")])
def test_activation_bitwise(name, compute):
    """Each activation equals JAX's bit for bit: gelu in its tanh form
    (XLA's f32 tanh and all), squared ReLU, and silu in bf16, the dtype
    the models run it in (in f32 the two libraries' exp differ by an ulp
    on about a tenth of inputs; the model tests hold it within 1e-4)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(60_000) * 3,
                        rng.standard_normal(2_000) * 1e-3,
                        rng.standard_normal(2_000) * 20]).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[compute][0])
    tx = torch.from_numpy(_np(jx)).to(DTYPES[compute][1])
    got = tlayers.activation_fn(name)(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(jlayers.activation_fn(name)(jx)))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("gated,activation", [(False, "relu2"), (False, "gelu"),
                                              (True, "gelu")])
def test_mlp_variants_match_jax(gated, activation, compute):
    jp = jlayers.mlp_init(jax.random.PRNGKey(5), 64, 128, gated=gated)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert ("w_gate" in tp) == gated
    jx, tx = _inputs(compute, (2, 9, 64), seed=5)
    want = jax.jit(lambda p, x: jlayers.mlp_apply(p, x, activation))(jp, jx)
    _close(tlayers.mlp_apply(tp, tx, activation), want, compute)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attn_qkv_with_qk_norm_matches_jax(qkv_bias, compute):
    """qk-norm after the bias and before rope, at rmsnorm's default eps;
    the norm weights are drawn away from ones so a swapped or skipped norm
    shows."""
    h, hkv, hd = 4, 2, 16
    jp = jlayers.attn_init(jax.random.PRNGKey(6), 64, h, hkv, hd,
                           qkv_bias=qkv_bias, qk_norm=True)
    rng = np.random.default_rng(6)
    for name in ("q_norm", "k_norm") + (("bq", "bk") if qkv_bias else ()):
        jp[name] = jnp.asarray(rng.uniform(0.5, 1.5, jp[name].shape), jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_init = tlayers.attn_init(torch.Generator().manual_seed(0), 64, h, hkv, hd,
                               qkv_bias=qkv_bias, qk_norm=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in t_init.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    jx, tx = _inputs(compute, (2, 7, 64), seed=6)
    pos = np.arange(7, dtype=np.int32)[None] + 3
    want = jax.jit(lambda p, x: jlayers.attn_qkv(
        p, x, h, hkv, hd, jnp.asarray(pos), rope_theta=1e4))(jp, jx)
    got = tlayers.attn_qkv(tp, tx, h, hkv, hd, torch.as_tensor(pos),
                           rope_theta=1e4)
    for a, b in zip(got, want):
        _close(a, b, compute)
