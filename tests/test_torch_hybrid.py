"""The port's Mamba2 block (``models/mamba2.py``) and Zamba2-style hybrid
(``models/hybrid.py``) against the JAX package on the same weights
(``convert.params_from_jax``), at the smoke config and at a config with
trailing Mamba2 layers (``n_layers % attn_every != 0``).

Both packages compute in float32 (both ``COMPUTE_DTYPE``s patched, JAX's
traces cleared around the module). Tolerances, with what was measured on
the CPU: logits, every cache leaf, the block's output and the loss within
1e-4 absolute and relative (logits 4e-7, conv contexts and K/V 6e-6, SSM
states 2e-7); every gradient leaf within 1e-4 relative L2 (4e-6).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = 1e-4
CACHE = ("conv", "ssm", "k", "v")


@pytest.fixture(scope="module", autouse=True)
def f32():
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


class Pair:
    """Both packages' models of one config on the same weights, with one
    ``jax.jit`` a function shared by the cases."""

    def __init__(self, **updates):
        self.jcfg = dataclasses.replace(j_smoke(ARCH), **updates)
        self.tcfg = dataclasses.replace(t_smoke(ARCH), **updates)
        self.jm, self.tm = j_get_model(self.jcfg), t_get_model(self.tcfg)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.tp = convert.params_from_jax(jax.tree.map(np.asarray, self.jp),
                                          device="cpu")
        self.prefill = jax.jit(self.jm.prefill)
        self.decode = jax.jit(self.jm.decode_step)
        self.grad = jax.jit(jax.value_and_grad(self.jm.loss))

    def batches(self, seed, seq):
        return (j_make_batch(self.jcfg, jax.random.PRNGKey(seed), 2, seq),
                t_make_batch(self.tcfg, seed, 2, seq, device="cpu"))


@pytest.fixture(scope="module")
def smoke():
    return Pair()


@pytest.fixture(scope="module")
def trailing():
    """Five Mamba2 layers, the shared block after layers 2 and 4, and one
    trailing layer."""
    return Pair(n_layers=5)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("seq,with_state", [(1, True), (16, False), (80, True)])
def test_mamba2_block_apply(seq, with_state):
    """One block on random input and states: a decode step (one token),
    a prefill from zero states, and a sequence past ``scan_chunk``."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = jmamba.block_init(jcfg, jax.random.PRNGKey(7))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seq)
    conv_shape, ssm_shape = tmamba.state_shapes(tcfg, 2)
    assert (conv_shape, ssm_shape) == jmamba.state_shapes(jcfg, 2)
    x = rng.standard_normal((2, seq, tcfg.d_model)).astype(np.float32)
    cp = rng.standard_normal(conv_shape).astype(np.float32) * with_state
    st = rng.standard_normal(ssm_shape).astype(np.float32) * with_state
    want = jax.jit(lambda *a: jmamba.block_apply(jcfg, jp, *a))(x, cp, st)
    got = tmamba.block_apply(tcfg, tp, *map(torch.from_numpy, (x, cp, st)))
    for a, b in zip(got, want):
        _close(a, b)


def test_init_tree_count_and_scales():
    """The port's own init: JAX's leaves and shapes (the shared block and
    the stacked Mamba2 blocks), every parameter counted, the constants."""
    cfg = t_smoke(ARCH)
    params = t_get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat_t = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(params)[0]}
    jshapes = jax.eval_shape(j_get_model(j_smoke(ARCH)).init, jax.random.PRNGKey(0))
    flat_j = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(jshapes)[0]}
    assert flat_t.keys() == flat_j.keys() and len(flat_t) == 21
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape and flat_t[k].is_contiguous(), k
    d, n = cfg.d_model, cfg.n_layers
    din, nh = tmamba.d_inner(cfg), tmamba.n_ssm_heads(cfg)
    conv = cfg.ssm_conv * (din + 2 * cfg.ssm_state) + din + 2 * cfg.ssm_state
    extra = n * (d + conv + 3 * nh + din) + 2 * d + d
    assert sum(x.numel() for x in flat_t.values()) == cfg.param_count() + extra
    lay = params["layers"]
    torch.testing.assert_close(lay["a_log"][1], torch.log(torch.linspace(1.0, 16.0, nh)))
    assert abs(float(lay["conv_w"].std()) / 0.1 - 1) < 0.15
    assert not torch.equal(lay["in_proj"][0], lay["in_proj"][1])


@pytest.mark.parametrize("which", ["smoke", "trailing"])
def test_prefill_logits_and_cache(which, request):
    m = request.getfixturevalue(which)
    jb, tb = m.batches(1, 16)
    jl, jc = m.prefill(m.jp, jb)
    tl, tc = m.tm.prefill(m.tp, tb)
    _close(tl, jl)
    assert tc["conv"].shape[0] == tc["ssm"].shape[0] == m.tcfg.n_layers
    for k in CACHE:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 16


def _spliced(m, cache, room, jax_side=False):
    """A prefill cache spliced into an empty one with ``room`` positions,
    as the JAX package's tests do (a decode step writes at ``pos``)."""
    s = cache["k"].shape[2]
    if jax_side:
        fixed = m.jm.init_cache(2, room)
        return dict(cache, k=fixed["k"].at[:, :, :s].set(cache["k"]),
                    v=fixed["v"].at[:, :, :s].set(cache["v"]))
    fixed = m.tm.init_cache(2, room, device="cpu")
    fixed["k"][:, :, :s] = cache["k"]
    fixed["v"][:, :, :s] = cache["v"]
    return dict(cache, k=fixed["k"], v=fixed["v"])


@pytest.mark.parametrize("which", ["smoke", "trailing"])
def test_decode_steps_after_spliced_prefill(which, request):
    """Prefill 16 tokens, splice into a 32-position cache, three greedy
    decode steps: logits and every cache leaf after each."""
    m = request.getfixturevalue(which)
    jb, tb = m.batches(2, 16)
    jl, jc = m.prefill(m.jp, jb)
    tl, tc = m.tm.prefill(m.tp, tb)
    jc, tc = _spliced(m, jc, 32, jax_side=True), _spliced(m, tc, 32)
    for _ in range(3):
        nt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = m.decode(m.jp, jc, jnp.asarray(nt))
        tl, tc = m.tm.decode_step(m.tp, tc, torch.as_tensor(nt))
        _close(tl, jl)
        for k in CACHE:
            _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 19


@pytest.mark.parametrize("which", ["smoke", "trailing"])
def test_loss_and_grads(which, request):
    """``loss`` and every gradient leaf against ``jax.value_and_grad``
    (remat on: layer and chunk checkpoints); 80 tokens, past one chunk."""
    m = request.getfixturevalue(which)
    jb, tb = m.batches(3, 80)
    jloss, jgrads = m.grad(m.jp, jb)
    xs = [p.detach().requires_grad_(True) for p in leaves(m.tp)]
    tloss = m.tm.loss(unflatten(m.tp, xs), tb)
    tgrads = torch.autograd.grad(tloss, xs, allow_unused=True, materialize_grads=True)
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for a, b in zip(jleaves, tgrads):
        assert tuple(b.shape) == a.shape
        assert _rel(b, a) < TOL


def test_decode_equals_prefill_of_one_more(smoke):
    """The port alone: prefill(S), splice, one decode step give the logits
    of prefill(S + 1), within 1e-4 in f32."""
    _, tb = smoke.batches(6, 16)
    with torch.no_grad():
        logits, cache = smoke.tm.prefill(smoke.tp, tb)
        cache = _spliced(smoke, cache, 24)
        nt = logits.argmax(-1)[:, None]
        l2, _ = smoke.tm.decode_step(smoke.tp, cache, nt)
        l17, _ = smoke.tm.prefill(smoke.tp, dict(tokens=torch.cat([tb["tokens"], nt], 1)))
    torch.testing.assert_close(l2, l17, rtol=1e-4, atol=1e-4)
