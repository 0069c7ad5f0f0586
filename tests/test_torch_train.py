"""The port's training path against the JAX package: ``layers.lm_loss``,
``transformer.loss_fn`` and its gradients, ``optim/adamw.py``,
``train/train_step.py``, ``train/trainer.py`` with its checkpoint chain,
``convert.train_state_from_jax`` and ``launch/train.py``.

Both packages get the same numpy inputs (made from a seed) and the same
weights (``convert``). Tolerances:

- f32 compute (both ``COMPUTE_DTYPE``s patched to float32): the loss and
  every gradient leaf within 1e-4 relative L2 (measured ~1e-6) — the
  algorithm;
- bf16 compute, the packages' default: 2e-2 relative L2, bf16's bound in
  ``tests/test_kernels.py`` (measured 0.8-1.8e-2 per leaf: XLA keeps some
  fused intermediates in f32 where eager PyTorch rounds every op);
- AdamW with the same gradients fed in: bitwise where the global norm is
  the same number in both packages (no clipping, or a norm whose sum of
  squares is exact in f32), since each op of ``upd`` is one rounded op in
  both. XLA's f32 reduction order differs from PyTorch's, so the norm of
  random gradients can differ by an ulp; with clipping active that ulp
  scales every gradient, and the test bounds its effect (below).
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import snapstore_ckpt as jckpt  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as j_train_step  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import snapstore_ckpt as tckpt  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TData  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.train import train_step as t_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map, unflatten  # noqa: E402

ARCHS = ["qwen2.5-3b", "qwen2-moe-a2.7b"]
TOL = {"f32": 1e-4, "bf16": 2e-2}
METHODS = ["vanilla", "direct", "pallas_vanilla", "pallas_direct"]


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """The compute dtype of both packages for one case (JAX's caches
    cleared around it, so no trace of the other dtype is reused)."""
    if request.param == "f32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jm = j_get_model(j_smoke(arch))
    return jm, _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _models(arch):
    """Both models and the JAX init's weights: JAX's params and a fresh
    port copy (the port's optimizer updates it in place)."""
    jm, params = _jax_init(arch)
    tm = t_get_model(t_smoke(arch))
    return (jm, tm, jax.tree.map(jnp.asarray, params),
            convert.params_from_jax(params, device="cpu"))


def _value_and_grad(tm, params, batch):
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = tm.loss(unflatten(params, xs), batch)
    return loss.detach(), torch.autograd.grad(loss, xs, materialize_grads=True,
                                              allow_unused=True)


def test_config_fields_mirror_jax():
    """Every field of the port's ModelConfig is the JAX field of that name
    with the same default; ``remat`` (new here) defaults on."""
    jf = {f.name: f.default for f in dataclasses.fields(j_base.ModelConfig)}
    for f in dataclasses.fields(t_base.ModelConfig):
        assert f.name in jf and f.default == jf[f.name], f.name
    assert t_base.ModelConfig.__dataclass_fields__["remat"].default is True
    for arch in ARCHS:
        assert t_smoke(arch).remat == j_smoke(arch).remat


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seq,chunk", [(7, 512), (37, 16), (64, 16)])
def test_lm_loss(seq, chunk, masked):
    """f32 within 1e-6 relative; bf16 hidden within 2e-2. A short last
    chunk (37 of 16) sums the same terms as JAX's masked pad."""
    rng = np.random.default_rng(seq)
    h = rng.standard_normal((2, seq, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 97))).astype(np.float32)
    lab = rng.integers(0, 97, (2, seq)).astype(np.int32)
    mask = rng.random((2, seq)) < 0.7 if masked else None
    tmask = None if mask is None else torch.from_numpy(mask)
    want = jl.lm_loss(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
                      s_chunk=chunk, mask=None if mask is None else jnp.asarray(mask))
    got = tl.lm_loss(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(lab), s_chunk=chunk, mask=tmask)
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got, want) < 1e-6
    want = jl.lm_loss(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w),
                      jnp.asarray(lab), s_chunk=chunk,
                      mask=None if mask is None else jnp.asarray(mask))
    got = tl.lm_loss(torch.from_numpy(h).bfloat16(), torch.from_numpy(w),
                     torch.from_numpy(lab), s_chunk=chunk, mask=tmask)
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch, compute):
    """``LM.loss`` and every gradient leaf against ``jax.value_and_grad``
    (the MoE's aux loss included)."""
    jm, tm, jp, tp = _models(arch)
    jb = j_make_batch(j_smoke(arch), jax.random.PRNGKey(1), 2, 16)
    tb = t_make_batch(t_smoke(arch), 1, 2, 16, device="cpu")
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tloss, tgrads = _value_and_grad(tm, tp, tb)
    assert _rel(tloss, jloss) < TOL[compute]
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for a, b in zip(jleaves, tgrads):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        assert _rel(b, a) < TOL[compute]


def test_moe_aux_loss_enters_the_loss():
    """The MoE loss is nll + 0.01 · (sum of the layers' aux losses): with
    the aux term the port's loss moves off the plain nll, as JAX's does."""
    arch = "qwen2-moe-a2.7b"
    jm, tm, jp, tp = _models(arch)
    cfg = t_smoke(arch)
    tb = t_make_batch(cfg, 2, 2, 16, device="cpu")
    from repro_torch.models import transformer as ttr
    with torch.no_grad():
        x = ttr.embed_tokens(tp, tb["tokens"])
        pos = torch.arange(16, dtype=torch.int32)[None]
        x, aux = ttr.train_stack(cfg, tp["layers"], x, pos)
        x = tl.rmsnorm(x, tp["ln_f"], cfg.norm_eps)
        nll = tl.lm_loss(x, tp["w_out"].to(x.dtype), tb["labels"])
        loss = tm.loss(tp, tb)
    assert float(aux) > 0
    torch.testing.assert_close(loss, nll + 0.01 * aux, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing(arch):
    """Per-layer checkpointing recomputes the same ops: loss and gradients
    bitwise equal with and without it."""
    tm = t_get_model(t_smoke(arch))
    norem = t_get_model(dataclasses.replace(t_smoke(arch), remat=False))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tb = t_make_batch(tm.cfg, 4, 2, 16, device="cpu")
    la, ga = _value_and_grad(tm, tp, tb)
    lb, gb = _value_and_grad(norem, tp, tb)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_params(rng):
    return dict(w=rng.standard_normal((33, 17)).astype(np.float32),
                b=rng.standard_normal((17,)).astype(np.float32),
                layers=dict(x=rng.standard_normal((2, 5, 7)).astype(np.float32)))


def _run_adamw(cfg_kw, grad_fn, steps=3, seed=0, monkeypatch=None):
    """Both packages' ``apply`` for ``steps`` steps on the same gradients;
    yields (jax params, m, v, diag, port params, m, v, diag) after each.
    With ``monkeypatch``, the port's ``global_norm`` returns JAX's norm of
    the step, so the rest of the update is held on its own."""
    rng = np.random.default_rng(seed)
    params = _adam_params(rng)
    jc, tc = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = tadamw.init(tp)
    for _ in range(steps):
        grads = jax.tree.map(lambda a: grad_fn(rng, a.shape), params)
        tgrads = tree_map(lambda a: torch.from_numpy(a.copy()), grads)
        jp, js, jd = jadamw.apply(jc, jax.tree.map(jnp.asarray, grads), js, jp)
        if monkeypatch is not None:
            norm = torch.from_numpy(np.array(jd["grad_norm"]))
            monkeypatch.setattr(tadamw, "global_norm", lambda g, n=norm: n)
        tp2, ts, td = tadamw.apply(tc, tgrads, ts, tp)
        assert tp2 is tp                              # updated in place
        for a, b in zip(leaves(grads), leaves(tgrads)):
            np.testing.assert_array_equal(b.numpy(), a)   # grads untouched
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"])
        yield jp, js, jd, tp, ts, td


def _bits(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32).view(np.int32).astype(np.int64)


def _state_trees(jp, js, tp, ts):
    return [(jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dyadic(rng, shape):
    """Gradients k / 64 with |k| <= 8: every square and every partial sum
    of squares is exact in f32, so the norm is one number in any order."""
    return (rng.integers(-8, 9, shape) / 64.0).astype(np.float32)


@pytest.mark.parametrize("grad_fn,clip", [(_normal, 1e9), (_dyadic, 0.5)],
                         ids=["unclipped", "clipped_exact_norm"])
def test_adamw_bitwise(grad_fn, clip):
    """Same norm in both packages → params, m and v bitwise after each of 3
    steps (warmup 2 of 5, so the schedule's warmup and cosine both run)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    for jp, js, jd, tp, ts, td in _run_adamw(kw, grad_fn):
        if clip < 1e9:                                # clipping active
            assert float(jd["grad_norm"]) > clip
            assert float(td["grad_norm"]) == float(jd["grad_norm"])
        else:                                         # the sum's order
            assert abs(_bits(td["grad_norm"]) - _bits(jd["grad_norm"])) <= 1
        assert float(td["lr"]) == float(jd["lr"])
        for jt, tt in _state_trees(jp, js, tp, ts):
            for a, b in zip(jax.tree.leaves(jt), leaves(tt)):
                np.testing.assert_array_equal(_bits(b), _bits(a))


def test_adamw_clipped_random_gradients():
    """Normal gradients, clipping active: the norm within 1 ulp (the f32
    sum's order), so the scale too. That ulp of the scale moves every
    gradient by an ulp of its own (and PyTorch's CPU ``sqrt`` moves a few
    updates by one; the case below holds the rest bitwise), and where
    terms cancel (m = b1·m + (1 − b1)·g, p − lr·update) a result near 0
    moves by many of its own ulps. So params, m and v are held within 8 ulps of each leaf's
    largest magnitude after each of 3 steps (measured at most 5.3 over
    seeds 0-7, 1.8 on this seed's)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5)
    eps = np.finfo(np.float32).eps
    for jp, js, jd, tp, ts, td in _run_adamw(kw, _normal):
        assert float(jd["grad_norm"]) > 0.5
        assert abs(_bits(td["grad_norm"]) - _bits(jd["grad_norm"])) <= 1
        assert float(td["lr"]) == float(jd["lr"])
        for jt, tt in _state_trees(jp, js, tp, ts):
            for a, b in zip(jax.tree.leaves(jt), leaves(tt)):
                a, b = np.asarray(a), b.numpy()
                assert np.abs(b - a).max() <= 8 * eps * np.abs(a).max()


def test_adamw_clipped_random_gradients_bitwise_given_the_norm(monkeypatch):
    """The case above with JAX's global norm fed to the port's ``apply``
    and a correctly rounded square root (the card's; PyTorch's CPU
    ``sqrt`` is one ulp off on ~0.7% of f32 inputs with AVX-512): params,
    m and v bitwise after each of 3 steps. So the arithmetic of ``upd`` is
    JAX's op for op, and the bound above covers only the norm's
    summation order and the CPU square root."""
    monkeypatch.setattr(torch.Tensor, "sqrt_",
                        lambda x: x.copy_(x.double().sqrt()))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5)
    for jp, js, jd, tp, ts, td in _run_adamw(kw, _normal, monkeypatch=monkeypatch):
        assert float(jd["grad_norm"]) > 0.5
        assert float(td["grad_norm"]) == float(jd["grad_norm"])
        assert float(td["lr"]) == float(jd["lr"])
        for jt, tt in _state_trees(jp, js, tp, ts):
            for a, b in zip(jax.tree.leaves(jt), leaves(tt)):
                np.testing.assert_array_equal(_bits(b), _bits(a))


def test_adamw_global_norm():
    """``global_norm``: an f32 scalar within 4 ulps of the exact norm of
    every leaf."""
    grads = _adam_params(np.random.default_rng(4))
    got = tadamw.global_norm(tree_map(torch.from_numpy, grads))
    exact = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                        for g in leaves(grads)))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - exact) <= 4 * np.finfo(np.float32).eps * exact


def test_adamw_schedule():
    """Warmup, cosine and the floor past ``total_steps``, bitwise."""
    for kw in (dict(warmup_steps=3, total_steps=20), dict(warmup_steps=100),
               dict(warmup_steps=1, total_steps=1)):
        jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
        for s in list(range(0, 25)) + [99, 100, 5_000, 10_000, 10_050]:
            want = jadamw.schedule(jc, jnp.asarray(s, jnp.int32))
            got = tadamw.schedule(tc, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert _bits(got) == _bits(want), (kw, s)


def test_adamw_init_and_bf16_params():
    """``init`` gives f32 zeros and an int32 step 0; a bf16 parameter is
    updated in f32 and stored back in bf16, as JAX's ``astype(p.dtype)``."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((8, 4)).astype(np.float32)
    g = rng.standard_normal((8, 4)).astype(np.float32)
    jp = dict(w=jnp.asarray(p, jnp.bfloat16))
    tp = dict(w=torch.from_numpy(p).bfloat16())
    ts = tadamw.init(tp)
    assert ts["m"]["w"].dtype == torch.float32 and ts["step"].dtype == torch.int32
    assert int(ts["step"]) == 0 and not ts["v"]["w"].any()
    cfg = dict(lr=1e-2, warmup_steps=1, clip_norm=1e9)
    jp, _, _ = jadamw.apply(jadamw.AdamWConfig(**cfg), dict(w=jnp.asarray(g)),
                            jadamw.init(jp), jp)
    tp, _, _ = tadamw.apply(tadamw.AdamWConfig(**cfg), dict(w=torch.from_numpy(g)),
                            ts, tp)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].view(torch.int16).numpy(),
                                  np.asarray(jp["w"]).view(np.int16))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum,cast", [(2, False), (1, True)],
                         ids=["accum2", "cast_bf16"])
def test_train_step(accum, cast):
    """One ``make_train_step`` step against JAX's: the loss, the norm and
    AdamW's ``m`` and ``√v`` (after one step (1 − b1)·g and √(1 − b2)·|g|
    of the clipped gradient g) within bf16's 2e-2."""
    arch = "qwen2.5-3b"
    jm, tm, jp, tp = _models(arch)
    jb = j_make_batch(j_smoke(arch), jax.random.PRNGKey(3), 4, 16)
    tb = t_make_batch(t_smoke(arch), 3, 4, 16, device="cpu")
    cfg = dict(lr=1e-3)
    jstep = j_train_step.make_train_step(jm, jadamw.AdamWConfig(**cfg),
                                         accum_steps=accum, cast_bf16=cast)
    tstep = t_train_step.make_train_step(tm, tadamw.AdamWConfig(**cfg),
                                         accum_steps=accum, cast_bf16=cast,
                                         grad_shardings=object())
    _, js, jmet = jax.jit(jstep)(jp, jadamw.init(jp), jb)
    tp2, ts, tmet = tstep(tp, tadamw.init(tp), tb)
    assert tp2 is tp and tmet["loss"].dtype == torch.float32
    assert _rel(tmet["loss"], jmet["loss"]) < 2e-2
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) < 2e-2
    assert float(tmet["lr"]) == float(jmet["lr"])
    for a, b in zip(jax.tree.leaves(js["m"]), leaves(ts["m"])):
        assert _rel(b, a) < 2e-2
    for a, b in zip(jax.tree.leaves(js["v"]), leaves(ts["v"])):
        assert _rel(b.sqrt(), np.sqrt(a)) < 2e-2


def test_accumulation_equals_the_whole_batch():
    """Two microbatches of 2 give the whole batch's loss and update (f32
    compute; equal up to the f32 sums' order)."""
    arch = "qwen2.5-3b"
    tm = t_get_model(t_smoke(arch))
    tb = t_make_batch(tm.cfg, 6, 4, 16, device="cpu")
    out = {}
    for accum in (1, 2):
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        step = t_train_step.make_train_step(tm, tadamw.AdamWConfig(lr=1e-3),
                                            accum_steps=accum)
        out[accum] = step(tp, tadamw.init(tp), tb)
    assert _rel(out[2][2]["loss"], out[1][2]["loss"].numpy()) < 1e-6
    for a, b in zip(leaves(out[1][1]["m"]), leaves(out[2][1]["m"])):
        assert _rel(b, a.numpy()) < 2e-2


def test_init_state():
    tm = t_get_model(t_smoke("qwen2.5-3b"))
    params, opt = t_train_step.init_state(tm, torch.Generator().manual_seed(0),
                                          device="cpu")
    assert [tuple(x.shape) for x in leaves(opt["m"])] == \
        [tuple(x.shape) for x in leaves(params)]
    assert opt["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer and its checkpoint chain
# ---------------------------------------------------------------------------

def _trainer_cfgs(cfg, steps=9, every=3, page=256, batch=2, seq=16):
    d = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    t = dict(total_steps=steps, ckpt_every=every, page_size=page)
    return JData(**d), TData(**d), JTrainerConfig(**t), TTrainerConfig(**t)


def test_train_state_from_jax():
    """params, m and v bitwise; the int32 step taken as an integer (2^24 + 1
    would round to 2^24 through float32)."""
    jm, _, jp, _ = _models("qwen2.5-3b")
    jopt = jadamw.init(jp)
    jopt["m"] = jax.tree.map(lambda x: x + 0.5, jopt["m"])
    jopt["step"] = jnp.asarray(2**24 + 1, jnp.int32)
    params, opt = convert.train_state_from_jax(_np_tree(jp), _np_tree(jopt),
                                               device="cpu")
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 2**24 + 1
    for jt, tt in ((jp, params), (jopt["m"], opt["m"]), (jopt["v"], opt["v"])):
        for a, b in zip(jax.tree.leaves(jt), leaves(tt)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(_bits(b), _bits(a))


def test_trainer_matches_jax():
    """The port's ``Trainer`` from JAX's initial state: 9 steps, every loss
    within 2e-2 of JAX's (bf16 compute); every save's ``pages_written`` and
    ``chain_length`` equal JAX's; the step word equal; the report; and
    JAX's trained state carried across checkpoints to JAX's chain, word
    for word."""
    arch = "qwen2.5-3b"
    jm, tm, _, _ = _models(arch)
    jd, td, jtc, ttc = _trainer_cfgs(tm.cfg)
    jt = JTrainer(jm, jadamw.AdamWConfig(lr=1e-3), jd, jtc, seed=0)
    state = convert.train_state_from_jax(_np_tree(jt.params),
                                         _np_tree(jt.opt_state), device="cpu")
    jrep = jt.run()
    tt = TTrainer(tm, tadamw.AdamWConfig(lr=1e-3), td, ttc, device="cpu")
    tt.params, tt.opt_state = state
    trep = tt.run()
    assert len(tt.losses) == len(jt.losses) == 9
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=2e-2)
    jck = [e for e in jt.events if e["kind"] == "ckpt"]
    tck = [e for e in tt.events if e["kind"] == "ckpt"]
    assert [(e["step"], e["pages_written"], e["bytes_written"], e["chain_length"])
            for e in tck] == [(e["step"], e["pages_written"], e["bytes_written"],
                               e["chain_length"]) for e in jck]
    assert tt.ckpt.spec.n_pages == jt.ckpt.spec.n_pages
    assert trep["steps"] == jrep["steps"] == 9
    assert trep["ckpt_chain_length"] == jrep["ckpt_chain_length"]
    assert np.isfinite(trep["final_loss"]) and trep["goodput"] > 0
    # the restored step words and leaf order are the JAX chain's
    jr, tr = jt.ckpt.restore(), tt.ckpt.restore()
    assert int(tr["step"]) == int(jr["step"]) == 9
    assert [tuple(x.shape) for x in leaves(tr)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jr)]
    # the same training state (JAX's, carried across) saves to the same
    # chain word for word: the trainer's state layout is JAX's
    params, opt = convert.train_state_from_jax(_np_tree(jt.params),
                                               _np_tree(jt.opt_state), device="cpu")
    state = dict(params=params, opt=opt, step=torch.tensor(9, dtype=torch.int32))
    jck = jckpt.SnapshotCheckpointer(jt._state(), page_size=256)
    tck = tckpt.SnapshotCheckpointer(state, page_size=256, device="cpu")
    assert tck.save(state) == jck.save(jt._state())
    for name in ("l1", "l2", "pool", "pool_cursor", "length"):
        want = np.asarray(getattr(jck.chain, name))
        got = getattr(tck.chain, name).numpy()
        np.testing.assert_array_equal(got.view(want.dtype) if got.dtype.itemsize
                                      == want.dtype.itemsize else got, want)


@pytest.fixture(scope="module")
def crashed():
    """A port trainer crashed after step 5 (saves at 3), and the reference
    run of 9 steps."""
    tm = t_get_model(t_smoke("qwen2.5-3b"))
    _, td, _, ttc = _trainer_cfgs(tm.cfg)
    ref = TTrainer(tm, tadamw.AdamWConfig(lr=1e-3), td, ttc, seed=0, device="cpu")
    ref.run()
    t = TTrainer(tm, tadamw.AdamWConfig(lr=1e-3), td, ttc, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash at step 5"):
        t.run(crash_after=5)
    return ref, t


@pytest.mark.parametrize("method", METHODS)
def test_restore_methods_equal_the_saved_image(crashed, method):
    """Every restore method's state flattens to the last saved page image,
    word for word."""
    _, t = crashed
    ck = t.ckpt
    got = ck._flatten(ck.restore(method=method))
    assert torch.equal(got, ck._shadow)
    pages = ck._flatten(dict(params=t.params, opt=t.opt_state,
                             step=torch.tensor(3, dtype=torch.int32)))
    assert not torch.equal(pages, ck._shadow)       # the live state moved on


def test_trainer_crash_restart_resumes_bitwise(crashed):
    """``tests/test_checkpoint.py``'s crash/restart on the port: resume at
    step 3 through the kernel method, finish, and the final loss equals
    the uninterrupted run's bit for bit (on the CPU every op is
    deterministic)."""
    ref, t = crashed
    assert t.resume(method="pallas_direct") == 3
    ptrs = [x.data_ptr() for x in leaves(t.params)]
    assert len(set(ptrs)) == len(ptrs)
    t.run()
    assert t.step == 9 and len(t.losses) == 5 + 6
    assert t.losses[-1] == ref.losses[-1]
    assert t.losses[5:] == ref.losses[3:]


@pytest.mark.parametrize("arch", ["whisper-base", "rwkv6-3b"])
def test_trainer_crash_restart_other_families(arch):
    """The crash/restart of ``tests/test_checkpoint.py`` on Whisper (its
    batches carry ``batch_at``'s frames) and RWKV-6: 6 steps saving every
    2, crashed after 3, resumed at 2 through the kernel method and
    finished; every loss after the resume equals the uninterrupted run's
    bit for bit."""
    tm = t_get_model(t_smoke(arch))
    _, td, _, ttc = _trainer_cfgs(tm.cfg, steps=6, every=2)
    ref = TTrainer(tm, tadamw.AdamWConfig(lr=1e-3), td, ttc, seed=0, device="cpu")
    batch = ref._batch(0)
    assert ("frames" in batch) == (arch == "whisper-base")
    ref.run()
    t = TTrainer(tm, tadamw.AdamWConfig(lr=1e-3), td, ttc, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash at step 3"):
        t.run(crash_after=3)
    assert t.resume(method="pallas_direct") == 2
    assert torch.equal(t.ckpt._flatten(t._state()), t.ckpt._shadow)
    t.run()
    assert t.step == 6 and t.losses[3:] == ref.losses[2:]
    assert all(np.isfinite(ref.losses))


def test_full_lifecycle_train_crash_restore_serve():
    """``tests/test_system.py``'s lifecycle on the port: train, crash,
    restore, finish, then serve the trained weights with a forked pair."""
    cfg = t_smoke("qwen2-7b")
    model = t_get_model(cfg)
    _, dcfg, _, tcfg = _trainer_cfgs(cfg, steps=6, every=2)
    trainer = TTrainer(model, tadamw.AdamWConfig(lr=1e-3), dcfg, tcfg, seed=0,
                       device="cpu")
    with pytest.raises(RuntimeError):
        trainer.run(crash_after=3)
    assert trainer.resume() == 2
    report = trainer.run()
    assert report["steps"] == 6
    assert np.isfinite(report["final_loss"])
    assert report["goodput"] > 0

    eng = TEngine(cfg, trainer.params, scalable=True, n_blocks=64,
                  block_size=4, max_blocks_per_seq=16, device="cpu")
    prompt = np.arange(5) % cfg.vocab_size
    a = eng.add_request(prompt)
    b = eng.fork_request(a)
    toks = eng.step()
    assert toks[a] == toks[b]


def test_launch_train_cpu(capsys):
    report = t_launch.main(["--scale", "smoke", "--device", "cpu", "--steps", "2",
                            "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "device: cpu  arch: qwen2.5-3b" in out and "done: loss" in out
    assert report["steps"] == 2 and report["ckpt_chain_length"] == 3
    with pytest.raises(RuntimeError, match="needs 256 ranks; the world has 1"):
        t_launch.main(["--production", "--device", "cpu"])
    report = t_launch.main(["--arch", "whisper-base", "--device", "cpu",
                            "--steps", "1", "--batch", "2", "--seq", "16"])
    assert "arch: whisper-base" in capsys.readouterr().out
    assert report["steps"] == 1 and np.isfinite(report["final_loss"])
