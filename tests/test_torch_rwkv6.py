"""The port's RWKV-6 (``models/rwkv6.py``) against the JAX package on the
same weights (``convert.params_from_jax``), at the smoke config.

Both packages compute in float32 (both ``COMPUTE_DTYPE``s patched, JAX's
traces cleared around the module). Tolerances, with what was measured on
the CPU: prefill and decode logits, every cache leaf and the loss within
1e-4 absolute and relative (logits 5e-7, token-shift carries 2e-6, the
f32 states 2e-5: XLA fuses the recurrence's multiply-adds); every
gradient leaf within 1e-4 relative L2 (2e-6). The chunkwise-parallel form
is held to JAX's chunked form with the same bounds (``torch.cumprod`` and
``jnp.cumprod`` may multiply in other orders) and to the port's own scan
with the JAX package's chunked-vs-scan tolerances
(``tests/test_models_smoke.py::test_rwkv_chunked_matches_scan``).
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
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "rwkv6-3b"
TOL = 1e-4
CHUNKED = dict(rwkv_chunked=True, scan_chunk=16)


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
def scan():
    return Pair()


@pytest.fixture(scope="module")
def chunked():
    return Pair(**CHUNKED)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def _grads(tm, params, batch):
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = tm.loss(unflatten(params, xs), batch)
    return loss.detach(), torch.autograd.grad(loss, xs, materialize_grads=True,
                                              allow_unused=True)


def test_init_tree_count_and_scales():
    """The port's own init: JAX's 24 leaves and shapes, every parameter
    counted, the JAX init's constants and scales, layers drawn apart."""
    cfg = t_smoke(ARCH)
    params = t_get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat_t = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(params)[0]}
    jshapes = jax.eval_shape(j_get_model(j_smoke(ARCH)).init, jax.random.PRNGKey(0))
    flat_j = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(jshapes)[0]}
    assert flat_t.keys() == flat_j.keys() and len(flat_t) == 24
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape and flat_t[k].is_contiguous(), k
    d, f, n, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    per = 6 * d * d + 2 * d * f + 2 * d * trwkv.LORA_RANK + 15 * d
    assert sum(x.numel() for x in flat_t.values()) == n * per + 2 * v * d + 2 * d
    lay = params["layers"]
    assert torch.equal(lay["w0"], torch.full((n, d), -5.0))
    assert torch.equal(lay["mu"], torch.full((n, 5, d), 0.5))
    for name, s in (("w_r", d ** -0.5), ("wk_ff", d ** -0.5),
                    ("wv_ff", (2 * n * f) ** -0.5), ("u", 0.1)):
        assert abs(float(lay[name].std()) / s - 1) < 0.15, name
    assert not torch.equal(lay["w_k"][0], lay["w_k"][1])


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_prefill_logits_and_cache(form, request):
    m = request.getfixturevalue(form)
    jb, tb = m.batches(1, 64 if form == "chunked" else 16)
    jl, jc = m.prefill(m.jp, jb)
    tl, tc = m.tm.prefill(m.tp, tb)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for k in ("att_shift", "ffn_shift", "state"):
                _close(tc[k], jc[k])
    assert tc["pos"] == int(jc["pos"])


def test_decode_steps_after_prefill(scan):
    """Prefill 16 tokens, then three greedy decode steps: logits and every
    cache leaf after each step."""
    jb, tb = scan.batches(2, 16)
    jl, jc = scan.prefill(scan.jp, jb)
    tl, tc = scan.tm.prefill(scan.tp, tb)
    for _ in range(3):
        nt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = scan.decode(scan.jp, jc, jnp.asarray(nt))
        tl, tc = scan.tm.decode_step(scan.tp, tc, torch.as_tensor(nt))
        _close(tl, jl)
        for k in ("att_shift", "ffn_shift", "state"):
            _close(tc[k], jc[k])
        assert tc["pos"] == int(jc["pos"])


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_loss_and_grads(form, request):
    """``loss`` and every gradient leaf against ``jax.value_and_grad``
    (remat on, as the config says: chunk and layer checkpoints)."""
    m = request.getfixturevalue(form)
    jb, tb = m.batches(3, 64 if form == "chunked" else 80)
    jloss, jgrads = m.grad(m.jp, jb)
    tloss, tgrads = _grads(m.tm, m.tp, tb)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 24
    for a, b in zip(jleaves, tgrads):
        assert tuple(b.shape) == a.shape
        assert _rel(b, a) < TOL


def test_chunked_matches_scan(scan, chunked):
    """The port's two forms on the same weights, at the JAX package's
    chunked-vs-scan tolerances."""
    _, tb = scan.batches(4, 64)
    l_scan, l_chunk = scan.tm.loss(scan.tp, tb), chunked.tm.loss(scan.tp, tb)
    np.testing.assert_allclose(float(l_chunk), float(l_scan), rtol=2e-3)
    with torch.no_grad():
        lg_s, _ = scan.tm.prefill(scan.tp, tb)
        lg_c, _ = chunked.tm.prefill(scan.tp, tb)
    np.testing.assert_allclose(lg_c.numpy(), lg_s.numpy(), rtol=5e-2, atol=5e-2)
    _, g_s = _grads(scan.tm, scan.tp, tb)
    _, g_c = _grads(chunked.tm, scan.tp, tb)
    for a, b in zip(g_s, g_c):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-2, atol=1e-3)


def test_chunked_refuses_a_ragged_sequence(chunked):
    _, tb = chunked.batches(5, 40)
    with pytest.raises(ValueError, match="must divide chunk"):
        chunked.tm.prefill(chunked.tp, tb)


def test_decode_equals_prefill_of_one_more(scan):
    """The port alone: prefill(S) and one decode step give the logits of
    prefill(S + 1), within 1e-4 in f32 (the scan's state carried through
    the cache is the state the longer prefill reaches)."""
    _, tb = scan.batches(6, 16)
    with torch.no_grad():
        logits, cache = scan.tm.prefill(scan.tp, tb)
        nt = logits.argmax(-1)[:, None]
        l2, _ = scan.tm.decode_step(scan.tp, cache, nt)
        l17, _ = scan.tm.prefill(scan.tp, dict(tokens=torch.cat([tb["tokens"], nt], 1)))
    torch.testing.assert_close(l2, l17, rtol=1e-4, atol=1e-4)
