"""The port's Whisper-style encoder-decoder (``models/encdec.py``) and the
layers it adds (``layers.layernorm``, ``layers.sinusoidal_positions``)
against the JAX package on the same weights (``convert.params_from_jax``)
and the same batches (``make_batch``'s frames are JAX's bit for bit), at
the smoke config.

Both packages compute in float32 (both ``COMPUTE_DTYPE``s patched, JAX's
traces cleared around the module). Tolerances, with what was measured on
the CPU: the encoder memory, the cross K/V, prefill and decode logits,
every cache leaf and the loss within 1e-4 absolute and relative (logits
2e-7, K/V 2e-6); every gradient leaf within 1e-4 relative L2 (9e-7). The
sinusoidal table at Whisper's 1,500 frames x 512 within 1e-6 absolute:
XLA's and PyTorch's f32 ``pow``, ``sin`` and ``cos`` differ by ulps (5 %
of the entries differ, by 6e-8 at most).
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "whisper-base"
TOL = 1e-4
CACHE = ("k", "v", "xk", "xv")


@pytest.fixture(scope="module", autouse=True)
def f32():
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def m():
    """Both packages' models on the same weights, one ``jax.jit`` a
    function shared by the cases."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jm, tm = j_get_model(jcfg), t_get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp,
        tp=convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        prefill=jax.jit(jm.prefill), decode=jax.jit(jm.decode_step),
        grad=jax.jit(jax.value_and_grad(jm.loss)),
        encode=jax.jit(lambda p, f: jencdec.encode(jcfg, p, f)))


def _batches(m, seed, seq):
    jb = j_make_batch(m.jcfg, jax.random.PRNGKey(seed), 2, seq)
    tb = t_make_batch(m.tcfg, seed, 2, seq, device="cpu")
    assert tb["frames"].shape == (2, m.tcfg.enc_frames, m.tcfg.d_model)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    return jb, tb


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_layernorm():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((4, 7, 64))).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    for eps in (1e-5, 1e-2):
        want = jlayers.layernorm(jnp.asarray(x), g, b, eps)
        got = tlayers.layernorm(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(b), eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_pos,d", [(12, 64), (1500, 512)])
def test_sinusoidal_positions(n_pos, d):
    """The table; and any row computed alone (``offset``) equals the
    table's row bit for bit, as the decode step's row equals prefill's."""
    want = np.asarray(jlayers.sinusoidal_positions(n_pos, d))
    got = tlayers.sinusoidal_positions(n_pos, d, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for pos in (0, n_pos // 2, n_pos - 1):
        row = tlayers.sinusoidal_positions(1, d, "cpu", offset=pos)
        assert torch.equal(row[0], got[pos])


def test_init_tree_count_and_scales():
    """The port's own init: JAX's leaves and shapes (encoder and decoder
    stacks, the cross-attention), every parameter counted."""
    cfg = t_smoke(ARCH)
    params = t_get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat_t = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(params)[0]}
    jshapes = jax.eval_shape(j_get_model(j_smoke(ARCH)).init, jax.random.PRNGKey(0))
    flat_j = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(jshapes)[0]}
    assert flat_t.keys() == flat_j.keys() and len(flat_t) == 31
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape and flat_t[k].is_contiguous(), k
    d = cfg.d_model
    norms = 4 * d * (cfg.n_enc_layers + cfg.n_layers) + 2 * d * cfg.n_layers + 4 * d
    assert sum(x.numel() for x in flat_t.values()) == cfg.param_count() + norms
    w = params["dec_layers"]["xattn"]["wo"]
    assert abs(float(w.std()) * (2 * cfg.n_layers * d) ** 0.5 - 1) < 0.15
    assert not torch.equal(params["enc_layers"]["attn"]["wq"][0],
                           params["enc_layers"]["attn"]["wq"][1])


def test_encode_and_cross_kv(m):
    """The encoder memory, and prefill's cross K/V equal to JAX's and to
    each layer's projection of the port's memory."""
    jb, tb = _batches(m, 1, 8)
    mem = tencdec.encode(m.tcfg, m.tp, tb["frames"])
    _close(mem, m.encode(m.jp, jb["frames"]))
    _, jc = m.prefill(m.jp, jb)
    _, tc = m.tm.prefill(m.tp, tb)
    for i in range(m.tcfg.n_layers):
        p = tlayers.layer(m.tp["dec_layers"], i)
        xk, xv = tencdec._cross_kv(m.tcfg, p, mem)
        assert torch.equal(tc["xk"][i], xk) and torch.equal(tc["xv"][i], xv)
    _close(tc["xk"], jc["xk"])
    _close(tc["xv"], jc["xv"])


def test_prefill_logits_and_cache(m):
    jb, tb = _batches(m, 2, 16)
    jl, jc = m.prefill(m.jp, jb)
    tl, tc = m.tm.prefill(m.tp, tb)
    _close(tl, jl)
    for k in CACHE:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 16


def test_decode_steps_after_spliced_prefill(m):
    """Prefill 16 tokens, splice the self-attention K/V into a 32-position
    cache, three greedy decode steps: logits and every cache leaf."""
    jb, tb = _batches(m, 3, 16)
    jl, jc = m.prefill(m.jp, jb)
    tl, tc = m.tm.prefill(m.tp, tb)
    jfixed, tfixed = m.jm.init_cache(2, 32), m.tm.init_cache(2, 32, device="cpu")
    jc = dict(jc, k=jfixed["k"].at[:, :, :16].set(jc["k"]),
              v=jfixed["v"].at[:, :, :16].set(jc["v"]))
    tfixed["k"][:, :, :16], tfixed["v"][:, :, :16] = tc["k"], tc["v"]
    tc = dict(tc, k=tfixed["k"], v=tfixed["v"])
    for _ in range(3):
        nt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = m.decode(m.jp, jc, jnp.asarray(nt))
        tl, tc = m.tm.decode_step(m.tp, tc, torch.as_tensor(nt))
        _close(tl, jl)
        for k in CACHE:
            _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"]) == 19


def test_loss_and_grads(m):
    """``loss`` and every gradient leaf against ``jax.value_and_grad``,
    the tied embedding's gradient from both its uses."""
    jb, tb = _batches(m, 4, 16)
    jloss, jgrads = m.grad(m.jp, jb)
    xs = [p.detach().requires_grad_(True) for p in leaves(m.tp)]
    tloss = m.tm.loss(unflatten(m.tp, xs), tb)
    tgrads = torch.autograd.grad(tloss, xs, allow_unused=True, materialize_grads=True)
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 31
    for a, b in zip(jleaves, tgrads):
        want = np.asarray(a, np.float64)
        rel = np.linalg.norm(b.double().numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < TOL


def test_decode_equals_prefill_of_one_more(m):
    """The port alone: prefill(S), splice, one decode step give the logits
    of prefill(S + 1) on the same frames, within 1e-4 in f32."""
    _, tb = _batches(m, 5, 16)
    with torch.no_grad():
        logits, pre = m.tm.prefill(m.tp, tb)
        cache = m.tm.init_cache(2, 24, device="cpu")
        cache["k"][:, :, :16], cache["v"][:, :, :16] = pre["k"], pre["v"]
        cache.update(xk=pre["xk"], xv=pre["xv"], pos=pre["pos"])
        nt = logits.argmax(-1)[:, None]
        l2, _ = m.tm.decode_step(m.tp, cache, nt)
        l17, _ = m.tm.prefill(m.tp, dict(tb, tokens=torch.cat([tb["tokens"], nt], 1)))
    torch.testing.assert_close(l2, l17, rtol=1e-4, atol=1e-4)
