"""Shared neural-net layers (PyTorch port of ``repro.models.layers``).

Plain functions over explicit parameter dicts of tensors. Compute dtype is
bf16 and parameters are f32, as in the JAX package; norms, RoPE and
softmax work in f32. Every function casts a weight to the compute dtype
at use (``.to(cd)``), exactly where the JAX code writes ``.astype(cd)``;
weights already held in the compute dtype (cast once at load) make that
cast a no-op with the same result.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import as_device

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# init helpers: the JAX init's distributions and scales, drawn from a
# torch.Generator (the numbers differ from jax.random's; tests carry JAX
# params across with ``convert.params_from_jax`` instead). Like every entry
# point of the port they default to ``device="cuda"`` and raise without a
# card (``device.as_device``); callers that want the CPU say so.
# ---------------------------------------------------------------------------

def _normal(generator: torch.Generator, shape, scale: float, dtype, device):
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.mul_(scale).to(device=as_device(device), dtype=dtype)


def dense_init(generator, d_in, d_out, *, scale=None, dtype=PARAM_DTYPE,
               device="cuda"):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return _normal(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator, vocab, d_model, *, dtype=PARAM_DTYPE, device="cuda"):
    return _normal(generator, (vocab, d_model), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e4, device="cuda"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=as_device(device)) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _f32(c: float) -> float:
    return float(torch.tensor(c, dtype=torch.float32))


# XLA's f32 tanh (Eigen's rational approximation, its multiply-adds fused),
# which jax.nn.gelu's tanh lowers to; torch.tanh differs from it by an ulp
# on about a third of f32 inputs. Coefficients as the f32 constants they are
_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = tuple(map(_f32, (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03)))
_TANH_DEN = tuple(map(_f32, (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03)))


def _tanh(x):
    """tanh as XLA computes it on the CPU: in f32, rounded to ``x``'s dtype.
    Each fused multiply-add is one f64 multiply-add rounded to f32 (the
    product of two f32 is exact in f64)."""
    x32 = x.float()
    xc = x32.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()

    def poly(coeffs):
        acc = torch.full_like(x32, coeffs[0])
        for c in coeffs[1:]:
            acc = (x2 * acc.double() + c).float()
        return acc

    out = xc * poly(_TANH_NUM) / poly(_TANH_DEN)
    return torch.where(x32.abs() < 0.0004, x32, out).to(x.dtype)


def _gelu(x):
    """jax.nn.gelu's default (tanh) form, op by op in ``x``'s dtype with its
    constants rounded to that dtype first, as XLA evaluates it (the erf
    form of ``F.gelu`` is another function)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + _tanh(c * (x + k * (x * x * x)))))


def activation_fn(name: str):
    if name == "silu":
        # jax.nn.silu is x * logistic(x), and XLA expands logistic into
        # 1 / (1 + exp(-x)), rounding to the compute dtype after each op;
        # the same ops here give the same bf16 bits (F.silu rounds once)
        return lambda x: x * (1 / (1 + torch.exp(-x)))
    if name == "gelu":
        return _gelu
    if name == "relu2":  # nemotron-4 squared ReLU
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# attention (prefill): plain PyTorch, as the JAX package's is plain jnp
# ---------------------------------------------------------------------------

def _grouped_scores(q, k):
    """q: (B, Sq, H, D), k: (B, Sk, Hkv, D) → (B, Hkv, G, Sq, Sk) f32,
    without materializing repeated KV."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def _grouped_out(probs, v):
    """probs: (B, Hkv, G, Sq, Sk); v: (B, Sk, Hkv, D) → (B, Sq, H, D)."""
    b, hkv, g, sq, sk = probs.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hkv * g, v.shape[-1])


def attention_ref(q, k, v, *, causal: bool, kv_len=None, q_chunk: int = 1024):
    """Chunked exact attention (softmax per q-chunk over full K rows), so
    memory is O(q_chunk * Sk) per chunk. ``kv_len`` masks the valid prefix
    of the KV buffers."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kpos = torch.arange(sk, device=q.device)

    def one_chunk(q_blk, q_start):
        scores = _grouped_scores(q_blk, k) * scale           # (B,Hkv,G,qc,Sk)
        mask = torch.ones((q_blk.shape[1], sk), dtype=torch.bool, device=q.device)
        if causal:
            qpos = q_start + torch.arange(q_blk.shape[1], device=q.device)
            mask &= kpos[None, :] <= qpos[:, None]
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
        return _grouped_out(probs, v)

    outs = [one_chunk(q[:, s:s + q_chunk], s) for s in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def decode_attention_ref(q, k_cache, v_cache, kv_len):
    """Single-position attention against a (possibly oversized) KV cache.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); kv_len: the valid prefix."""
    return attention_ref(q, k_cache, v_cache, causal=False, kv_len=kv_len)


# ---------------------------------------------------------------------------
# attention block parameters
# ---------------------------------------------------------------------------

def attn_init(generator, d_model, n_heads, n_kv_heads, head_dim, *, qkv_bias,
              qk_norm=False, n_layers_scale=1, dtype=PARAM_DTYPE, device="cuda"):
    kw = dict(dtype=dtype, device=as_device(device))
    p = dict(
        wq=dense_init(generator, d_model, n_heads * head_dim, **kw),
        wk=dense_init(generator, d_model, n_kv_heads * head_dim, **kw),
        wv=dense_init(generator, d_model, n_kv_heads * head_dim, **kw),
        wo=dense_init(generator, n_heads * head_dim, d_model,
                      scale=1.0 / math.sqrt(2.0 * n_layers_scale * d_model), **kw),
    )
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), **kw)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), **kw)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), **kw)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), **kw)
        p["k_norm"] = torch.ones((head_dim,), **kw)
    return p


def attn_qkv(p, x, n_heads, n_kv_heads, head_dim, positions, *, rope_theta,
             use_rope=True):
    """Project to rope'd q/k and v. x: (B, S, d) → (B,S,H,D),(B,S,Hkv,D)x2."""
    b, s, _ = x.shape
    cd = x.dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    if "q_norm" in p:
        # after the bias, before rope, at rmsnorm's default eps (not the
        # config's norm_eps), as the JAX package
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model, d_ff, *, gated: bool, n_layers_scale=1,
             dtype=PARAM_DTYPE, device="cuda"):
    kw = dict(dtype=dtype, device=as_device(device))
    p = dict(
        w_up=dense_init(generator, d_model, d_ff, **kw),
        w_down=dense_init(generator, d_ff, d_model,
                          scale=1.0 / math.sqrt(2.0 * n_layers_scale * d_ff), **kw),
    )
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, **kw)
    return p


def mlp_apply(p, x, activation: str):
    cd = x.dtype
    act = activation_fn(activation)
    up = x @ p["w_up"].to(cd)
    if "w_gate" in p:
        up = act(x @ p["w_gate"].to(cd)) * up
    else:
        up = act(up)
    return up @ p["w_down"].to(cd)


# ---------------------------------------------------------------------------
# LM loss (chunked over the sequence so (B, S, V) never fully materializes)
# ---------------------------------------------------------------------------

def lm_loss(hidden, w_out, labels, *, s_chunk: int = 512, mask=None):
    """Cross-entropy of hidden @ w_out against labels, chunked over S.

    hidden: (B, S, d) compute-dtype; w_out: (d, V); labels: (B, S) int.
    Returns the mean nll over unmasked positions (f32 scalar). Each chunk's
    logits are f32 (the product in the compute dtype, then cast) and its
    nll is logsumexp minus the gold logit. The JAX package pads S up to a
    whole number of chunks and masks the pad; here the last chunk is
    short instead, which sums the same terms."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=hidden.device)
    w = w_out.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, s_chunk):
        h = hidden[:, lo:lo + s_chunk]
        lab = labels[:, lo:lo + s_chunk].long()
        m = mask[:, lo:lo + s_chunk]
        logits = (h @ w).float()
        gold = logits.gather(-1, lab[..., None])[..., 0]
        nll = torch.where(m, torch.logsumexp(logits, dim=-1) - gold, 0.0)
        total = total + nll.sum()
        count = count + m.sum()
    return total / count.clamp(min=1.0)
