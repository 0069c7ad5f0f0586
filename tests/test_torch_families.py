"""The rest of the decoder-only transformer family in the port against the
JAX package: every registered config, and for the smoke configs of
qwen2-moe-a2.7b (MHA, QKV bias, routed + shared experts), phi3.5-moe
(GQA, routed experts only), nemotron-4-15b (squared ReLU, ungated MLP) and
chameleon-34b (qk-norm) the whole model on the same weights
(``convert.params_from_jax``): prefill, the plain decode step, the three
paged steps and the serving engine's tokens.

Everything runs in float32 compute on both sides (1e-4), as
``tests/test_torch_engine.py`` does for tokens: a bf16 rounding apart in a
hidden state can move a router's near-tied top-k and reroute a token, a
jump no tolerance describes (bf16 is held at the MoE layer on equal
inputs in ``tests/test_torch_moe.py``). Measured here (CPU): prefill
logits differ by at most 3.9e-7, K/V by 3.1e-6.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.layers as jlayers  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.kernels.paged_attention import ref as jpa_ref  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import paged_decode as jpd  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402
from repro_torch.serve import paged_decode as tpd  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

TOL = 1e-4
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "nemotron-4-15b",
         "chameleon-34b"]
DECODER_ONLY = [a for a in jconfigs.list_archs()
                if jconfigs.get_config(a).family in ("dense", "moe")]
ALL_ARCHS = jconfigs.list_archs()


@pytest.fixture(scope="module", autouse=True)
def f32():
    """Float32 compute in both packages for this module's cases; JAX's
    compiled traces are cleared on both sides so no other test module
    sees an f32 trace."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


_MODELS = {}


def model(arch):
    """The smoke config in both packages and the same weights."""
    if arch not in _MODELS:
        jcfg = jconfigs.smoke_config(arch)
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODELS[arch] = (jcfg, tconfigs.smoke_config(arch), jparams, tparams)
    return _MODELS[arch]


def _close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


# -- configs --------------------------------------------------------------------


def test_registry_holds_every_decoder_only_config():
    """The port's registry is JAX's, all ten configs: the seven
    decoder-only ones and RWKV-6, Zamba2 and Whisper."""
    assert tconfigs.list_archs() == ALL_ARCHS and len(ALL_ARCHS) == 10
    assert len(DECODER_ONLY) == 7
    assert {tconfigs.get_config(a).family for a in ALL_ARCHS} == \
        {"dense", "moe", "ssm", "hybrid", "encdec"}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_mirrors_jax(arch):
    """Every field the port's config has equals JAX's, on the full config
    and its smoke config, with the derived counts (``param_count``'s ssm,
    hybrid and encdec branches included)."""
    for jc, tc in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                   (jconfigs.smoke_config(arch), tconfigs.smoke_config(arch))):
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (arch, f.name)
        for derived in ("hd", "is_moe"):
            assert getattr(tc, derived) == getattr(jc, derived), derived
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_get_model_serves_every_config(arch):
    """``get_model`` of every registered config's smoke config serves the
    five entry points on the CPU: ``init``, ``loss``, ``prefill``,
    ``init_cache`` and a ``decode_step`` into a cache with room (the
    prefill's K/V spliced in, as the JAX package's tests do)."""
    cfg = tconfigs.smoke_config(arch)
    m = t_get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = t_make_batch(cfg, 0, 2, 8, device="cpu")
    with torch.no_grad():
        assert bool(torch.isfinite(m.loss(params, batch)))
        logits, pre = m.prefill(params, batch)
        cache = m.init_cache(2, 16, device="cpu")
        for k, v in pre.items():
            if k == "pos" or v.shape == cache[k].shape:
                cache[k] = v
            else:
                cache[k][tuple(slice(0, n) for n in v.shape)] = v
        nt = logits.argmax(-1)[:, None]
        logits2, cache = m.decode_step(params, cache, nt)
    assert logits.shape == logits2.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all()) and cache["pos"] == 9


def exact_param_count(cfg) -> int:
    """Every parameter: ``param_count()`` (matrices and the router) plus
    the norms, QKV biases, qk-norm weights and the shared-expert gate."""
    d, hd = cfg.d_model, cfg.hd
    per = 2 * d
    per += hd * (cfg.n_heads + 2 * cfg.n_kv_heads) if cfg.qkv_bias else 0
    per += 2 * hd if cfg.qk_norm else 0
    per += d if cfg.is_moe and cfg.n_shared_experts else 0
    return cfg.param_count() + cfg.n_layers * per + d


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_count_and_scales(arch):
    """The port's own init: JAX's tree of leaves and shapes, every
    parameter counted, and the JAX init's scales (no JAX weights)."""
    cfg = tconfigs.smoke_config(arch)
    params = t_get_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    flat_t = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(params)[0]}
    jshapes = jax.eval_shape(
        lambda k: j_get_model(jconfigs.smoke_config(arch)).init(k),
        jax.random.PRNGKey(0))
    flat_j = {jtu.keystr(k): v for k, v in jtu.tree_flatten_with_path(jshapes)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        assert flat_t[k].is_contiguous(), k
    assert sum(v.numel() for v in flat_t.values()) == exact_param_count(cfg)
    d, n = cfg.d_model, cfg.n_layers
    if cfg.is_moe:
        f = cfg.moe_d_ff
        want = {"['layers']['ff']['router']": 0.02,
                "['layers']['ff']['e_up']": d ** -0.5,
                "['layers']['ff']['e_gate']": d ** -0.5,
                "['layers']['ff']['e_down']": (2 * n * f) ** -0.5}
    else:
        want = {"['layers']['ff']['w_up']": d ** -0.5,
                "['layers']['ff']['w_down']": (2 * n * cfg.d_ff) ** -0.5}
    for k, s in want.items():
        assert abs(float(flat_t[k].std()) / s - 1) < 0.1, k
    # layers differ: each was drawn, not copied
    assert not torch.equal(params["layers"]["attn"]["wq"][0],
                           params["layers"]["attn"]["wq"][1])


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_kv_match(arch):
    jcfg, tcfg, jparams, tparams = model(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    jl, jc = jax.jit(j_get_model(jcfg).prefill)(jparams,
                                                dict(tokens=jnp.asarray(toks)))
    tl, tc = t_get_model(tcfg).prefill(tparams, dict(tokens=torch.as_tensor(toks)))
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["pos"] == int(jc["pos"]) == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_after_prefill_matches(arch):
    """Prefill 16 tokens, splice the cache into an empty 32-position one,
    decode one token: logits and the written cache rows equal JAX's."""
    jcfg, tcfg, jparams, tparams = model(arch)
    jm, tm = j_get_model(jcfg), t_get_model(tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16))
    jl, jc = jax.jit(jm.prefill)(jparams, dict(tokens=jnp.asarray(toks)))
    jfixed = jm.init_cache(2, 32)
    jc = dict(k=jfixed["k"].at[:, :, :16].set(jc["k"].astype(jfixed["k"].dtype)),
              v=jfixed["v"].at[:, :, :16].set(jc["v"].astype(jfixed["v"].dtype)),
              pos=jc["pos"])
    nt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl2, jc2 = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(nt))

    tl, tc = tm.prefill(tparams, dict(tokens=torch.as_tensor(toks)))
    tfixed = tm.init_cache(2, 32, device="cpu")
    assert tfixed["k"].dtype == torch.float32 and tfixed["pos"] == 0
    tfixed["k"][:, :, :16] = tc["k"]
    tfixed["v"][:, :, :16] = tc["v"]
    tfixed["pos"] = tc["pos"]
    tl2, tc2 = tm.decode_step(tparams, tfixed, torch.as_tensor(nt))
    _close(tl2, jl2)
    assert tc2["pos"] == int(jc2["pos"]) == 17
    _close(tc2["k"], jc2["k"])
    _close(tc2["v"], jc2["v"])


def _pools(cfg, rng, nb, bs):
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    pk, pv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return jnp.asarray(pk), jnp.asarray(pv), torch.from_numpy(pk), torch.from_numpy(pv)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches(arch):
    """Batch 4 (a length-0 padded-style row included), MoE over all rows."""
    jcfg, tcfg, jparams, tparams = model(arch)
    rng = np.random.default_rng(3)
    nb, bs, m, b = 32, 4, 8, 4
    jpk, jpv, tpk, tpv = _pools(jcfg, rng, nb, bs)
    lengths = np.array([0, 5, 17, 30], np.int32)
    tables = np.stack([rng.permutation(nb)[:m] for _ in range(b)]).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jk, jv = jpd.paged_decode_step(jcfg, jparams, jpk, jpv,
                                       jnp.asarray(tables), jnp.asarray(lengths),
                                       jnp.asarray(toks))
    tl, tk, tv = tpd.paged_decode_step(tcfg, tparams, tpk, tpv,
                                       torch.as_tensor(tables),
                                       torch.as_tensor(lengths),
                                       torch.as_tensor(toks))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_fused_matches(arch):
    jcfg, tcfg, jparams, tparams = model(arch)
    rng = np.random.default_rng(4)
    nb, bs, t, c, p, b = 64, 4, 3, 4, 16, 4
    jpk, jpv, tpk, tpv = _pools(jcfg, rng, nb, bs)
    l2 = np.array(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, nb, (t, c, p)).astype(np.uint32)),
        jnp.zeros((t, c, p), jnp.uint32),
        allocated=jnp.asarray(rng.random((t, c, p)) < 0.5), bfi_valid=False))
    l2[:, 0, :, 0] |= np.uint32(jfmt.FLAG_ALLOCATED)   # no holes below length
    chain_lengths = np.array([1, 3, 4], np.int32)
    tenants = np.array([0, 2, 1, 2], np.int32)
    lengths = np.array([3, 9, 20, 40], np.int32)
    tables = np.asarray(jpa_ref.fused_tables_ref(jnp.asarray(l2[..., 0]),
                                                 jnp.asarray(chain_lengths),
                                                 jnp.asarray(tenants)))
    write_blocks = tables[np.arange(b), lengths // bs].astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jk, jv = jpd.paged_decode_step_fused(
        jcfg, jparams, jpk, jpv, jnp.asarray(l2), jnp.asarray(chain_lengths),
        jnp.asarray(tenants), jnp.asarray(lengths), jnp.asarray(write_blocks),
        jnp.asarray(toks))
    tl, tk, tv = tpd.paged_decode_step_fused(
        tcfg, tparams, tpk, tpv, tfmt.words(l2), torch.as_tensor(chain_lengths),
        torch.as_tensor(tenants), torch.as_tensor(lengths),
        torch.as_tensor(write_blocks), torch.as_tensor(toks))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_suffix_prefill_matches(arch):
    """5 suffix tokens after a 10-token paged prefix, padded to 8 rows
    (scratch block, length 1): the padded rows go through the MoE too and
    take capacity, in both packages."""
    jcfg, tcfg, jparams, tparams = model(arch)
    rng = np.random.default_rng(5)
    nb, bs, m, prefix, s, pad = 32, 4, 8, 10, 5, 8
    jpk, jpv, tpk, tpv = _pools(jcfg, rng, nb, bs)
    table = rng.permutation(nb - 1)[:m].astype(np.int32)     # nb-1: scratch
    pos = prefix + np.arange(s)
    blk = np.full(pad, nb - 1, np.int32)
    off = np.zeros(pad, np.int32)
    blk[:s], off[:s] = table[pos // bs], pos % bs
    lens = np.ones(pad, np.int32)
    lens[:s] = pos + 1
    tables = np.repeat(table[None], pad, 0)
    toks = np.zeros((1, pad), np.int32)
    toks[0, :s] = rng.integers(0, jcfg.vocab_size, s)
    args = (tables, blk, off, lens, toks)
    jl, jk, jv = jpd.paged_suffix_prefill(jcfg, jparams, jpk, jpv,
                                          *map(jnp.asarray, args))
    tl, tk, tv = tpd.paged_suffix_prefill(tcfg, tparams, tpk, tpv,
                                          *map(torch.as_tensor, args))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


# -- the engine -----------------------------------------------------------------

KW = dict(n_blocks=256, block_size=4, max_blocks_per_seq=128)


@pytest.mark.parametrize("path", ["tables", "fused"])
@pytest.mark.parametrize("scalable", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_lifecycle_emits_identical_tokens(arch, scalable, path):
    """Admit, fork, a fork chain with finishes, a golden prefix and an
    admission that extends it (one suffix-prefill pass), steps between,
    finish all: the same tokens and block counts as the JAX engine. Every
    full prefill is 6 tokens long: the JAX engine compiles its prefill
    once per length and engine."""
    jcfg, tcfg, jparams, tparams = model(arch)
    je = JEngine(jcfg, jparams, scalable=scalable, resolver="gather",
                 decode_path=path, **KW)
    te = TEngine(tcfg, tparams, scalable=scalable, decode_path=path,
                 device="cpu", **KW)

    def both(op, *args):
        a, b = getattr(je, op)(*args), getattr(te, op)(*args)
        assert a == b, op
        assert te.kv.blocks_in_use() == je.kv.blocks_in_use(), op
        return a

    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, size=6) for _ in range(3)]
    sids = [both("add_request", p) for p in prompts]
    both("fork_request", sids[1])
    both("step")
    sid = sids[0]
    for _ in range(5):
        child = both("fork_request", sid)
        both("finish_request", sid)
        sid = child
    both("step")
    golden = rng.integers(0, jcfg.vocab_size, size=6)
    both("register_golden", golden)
    both("add_request", np.concatenate([golden, prompts[1][:3]]))
    assert te.golden_hits == je.golden_hits == 1
    for _ in range(2):
        both("step")
    assert te.active == je.active
    for s in sorted(je.active):
        both("finish_request", s)
    assert te.kv.blocks_in_use() == je.kv.blocks_in_use()
