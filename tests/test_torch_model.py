"""The port's dense transformer and paged decode steps against the JAX
package, on the same weights (``convert.params_from_jax``) and inputs.

Each case runs twice: in float32 compute on both sides (the algorithm;
1e-4) and in the bf16 compute dtype at the bf16 tolerance of
``tests/test_kernels.py`` (2e-2). In bf16 the bound is taken relative to
the tensor's largest magnitude: eager PyTorch rounds every op to bf16,
while XLA keeps some fused intermediates in f32 (excess precision, e.g.
the residual sum feeding the next RMSNorm), so single elements near zero
drift by an ulp or two of the tensor's scale. The port rounds op by op
exactly as the JAX code is written (its SiLU spells XLA's expansion), so
an op fed the same bf16 inputs agrees bit for bit.

Measured on this file's inputs (smoke qwen2.5-3b, CPU): in f32 the
largest absolute difference is 3.2e-6; in bf16 it is 2.3e-2 on prefill
K/V (values up to 4.25), 5.4e-3 on prefill logits, 5.7e-3 on decode-step
logits and 1.6e-2 on the updated pools (values up to 4.4).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import paged_decode as jpd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import paged_decode as tpd  # noqa: E402

TOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke("qwen2.5-3b")
    tcfg = t_smoke("qwen2.5-3b")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """The compute dtype of both packages for one case."""
    import repro.models.layers as jl
    from repro_torch.models import layers as tl
    if request.param == "f32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _close(got, want, compute):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = TOL[compute]
    scale = max(1.0, float(np.abs(want).max())) if compute == "bf16" else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_config_mirrors_jax():
    jcfg, tcfg = j_smoke("qwen2.5-3b"), t_smoke("qwen2.5-3b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "hd", "qkv_bias", "activation", "rope_theta", "norm_eps"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert tget("qwen2.5-3b").param_count() == jget("qwen2.5-3b").param_count()


@pytest.mark.parametrize("seq", [7, 33])
def test_prefill_logits_and_kv_match(model, compute, seq):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(seq).integers(0, jcfg.vocab_size, (2, seq))
    jl, jc = j_get_model(jcfg).prefill(jparams, dict(tokens=jnp.asarray(toks)))
    tl, tc = ttr.prefill(tcfg, tparams, torch.as_tensor(toks))
    _close(tl, jl, compute)
    _close(tc["k"], jc["k"], compute)
    _close(tc["v"], jc["v"], compute)


def _pools(cfg, rng, nb, bs, compute):
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    pk = jnp.asarray(rng.standard_normal(shape)).astype(jdt)
    pv = jnp.asarray(rng.standard_normal(shape)).astype(jdt)
    to_t = lambda a: torch.as_tensor(np.array(a.astype(jnp.float32))).to(tdt)
    return pk, pv, to_t(pk), to_t(pv)


def test_paged_decode_step_matches(model, compute):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(0)
    nb, bs, m, b = 32, 4, 8, 4
    jpk, jpv, tpk, tpv = _pools(jcfg, rng, nb, bs, compute)
    lengths = np.array([0, 5, 17, 30], np.int32)
    tables = np.stack([rng.permutation(nb)[:m] for _ in range(b)]).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jk, jv = jpd.paged_decode_step(jcfg, jparams, jpk, jpv, jnp.asarray(tables),
                                       jnp.asarray(lengths), jnp.asarray(toks))
    tl, tk, tv = tpd.paged_decode_step(tcfg, tparams, tpk, tpv,
                                       torch.as_tensor(tables),
                                       torch.as_tensor(lengths),
                                       torch.as_tensor(toks))
    assert tk is tpk                      # updated in place
    _close(tl, jl, compute)
    _close(tk, jk, compute)
    _close(tv, jv, compute)


def test_paged_decode_step_fused_matches(model, compute):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    nb, bs, t, c, p, b = 64, 4, 3, 4, 16, 4
    jpk, jpv, tpk, tpv = _pools(jcfg, rng, nb, bs, compute)
    # a chain per tenant: each layer owns a random subset of pages
    l2 = np.array(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, nb, (t, c, p)).astype(np.uint32)),
        jnp.zeros((t, c, p), jnp.uint32),
        allocated=jnp.asarray(rng.random((t, c, p)) < 0.5), bfi_valid=False))
    l2[:, 0, :, 0] |= np.uint32(jfmt.FLAG_ALLOCATED)   # no holes below length
    chain_lengths = np.array([1, 3, 4], np.int32)
    tenants = np.array([0, 2, 1, 2], np.int32)
    lengths = np.array([3, 9, 20, 40], np.int32)
    from repro.kernels.paged_attention import ref as jref
    tables = np.asarray(jref.fused_tables_ref(jnp.asarray(l2[..., 0]),
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
    _close(tl, jl, compute)
    _close(tk, jk, compute)
    _close(tv, jv, compute)


def test_init_params_scales():
    """The port's own init draws the JAX init's distributions: weight
    standard deviations match the JAX scales (no JAX weights involved)."""
    cfg = t_smoke("qwen2.5-3b")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda k: j_get_model(j_smoke("qwen2.5-3b")).init(k),
                             jax.random.PRNGKey(0))
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    want = {"['embed']": 0.02, "['w_out']": 0.02,
            "['layers']['attn']['wq']": d ** -0.5,
            "['layers']['attn']['wo']": (2 * n * d) ** -0.5,
            "['layers']['ff']['w_down']": (2 * n * f) ** -0.5}
    for k, s in want.items():
        assert abs(float(flat_t[k].std()) / s - 1) < 0.1, k



@pytest.mark.parametrize("helper,args,kwargs", [
    ("dense_init", (4, 8), {}),
    ("embed_init", (16, 4), {}),
    ("rope_frequencies", (8,), {}),
    ("attn_init", (8, 2, 1, 4), {"qkv_bias": True}),
    ("mlp_init", (8, 16), {"gated": True}),
])
def test_init_helpers_default_to_the_card(helper, args, kwargs):
    """With no card and no explicit CPU request, the public init helpers
    raise instead of running on the CPU, like every entry point; with
    ``device="cpu"`` they run there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.models import layers as L

    fn = getattr(L, helper)
    if helper != "rope_frequencies":
        args = (torch.Generator().manual_seed(0),) + args
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args, **kwargs)
    out = fn(*args, **kwargs, device="cpu")
    leaves = out.values() if isinstance(out, dict) else [out]
    assert all(x.device.type == "cpu" for x in leaves)
