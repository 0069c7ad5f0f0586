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
from torch.utils.checkpoint import checkpoint

from repro_torch.device import as_device
from repro_torch.distributed import sharding as sh

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# init helpers: the JAX init's distributions and scales, drawn from a
# torch.Generator (the numbers differ from jax.random's; tests carry JAX
# params across with ``convert.params_from_jax`` instead). Like every entry
# point of the port they default to ``device="cuda"`` and raise without a
# card (``device.as_device``); callers that want the CPU say so.
# ---------------------------------------------------------------------------

def normal_init(generator: torch.Generator, shape, scale: float, dtype, device):
    dev = as_device(device)
    if dev.type == "meta":  # shapes only (``LM.init_shapes``): draw nothing
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.mul_(scale).to(device=dev, dtype=dtype)


def dense_init(generator, d_in, d_out, *, scale=None, dtype=PARAM_DTYPE,
               device="cuda"):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return normal_init(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator, vocab, d_model, *, dtype=PARAM_DTYPE, device="cuda"):
    return normal_init(generator, (vocab, d_model), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# layer stacks: every family keeps its layers' leaves stacked along a
# leading L axis, as the JAX package's scans over layers do
# ---------------------------------------------------------------------------

def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the L-stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _empty_stack(p: dict, n: int) -> dict:
    return {k: _empty_stack(v, n) if isinstance(v, dict)
            else v.new_empty((n,) + tuple(v.shape)) for k, v in p.items()}


def _put(stacked: dict, p: dict, i: int) -> None:
    for k, v in p.items():
        if isinstance(v, dict):
            _put(stacked[k], v, i)
        else:
            stacked[k][i] = v


def stacked(draw, n: int) -> dict:
    """``n`` calls of ``draw()`` stacked along a leading axis. Each leaf is
    allocated once at (n, ...) and filled as its layer is drawn, so no
    stacked leaf exists twice (a list of layers and its ``torch.stack``):
    the init's peak is the model plus one layer's or one leaf's draws."""
    out = None
    for i in range(n):
        p = draw()
        if out is None:
            out = _empty_stack(p, n)
        _put(out, p, i)
    return out


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` while autograd records, under a
    non-reentrant ``checkpoint`` (the JAX package's ``jax.checkpoint``):
    the backward keeps the inputs and recomputes the rest."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def unbind_layers(stacked: dict, n: int) -> list:
    """The L-stacked leaves as ``n`` per-layer dicts of ``unbind`` views:
    the backward stacks each leaf's gradient once (a ``layer(...)`` view
    per layer would add a zero-padded full-size gradient a layer)."""
    cols = {k: unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in stacked.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm in f32 with the biased variance, the mean of the squared
    deviations (``jnp.var``'s two passes, not a one-pass update)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


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


def sinusoidal_positions(n_pos: int, d_model: int, device="cuda", offset=0):
    """The sinusoidal table's rows ``offset .. offset + n_pos - 1``, (n_pos,
    d_model) f32: sin at even columns, cos at odd, of pos / 10000^(2i/d).
    Each element is one formula of its own position, so a slice of a
    longer table and the rows computed alone are the same numbers."""
    dev = as_device(device)
    pos = torch.arange(offset, offset + n_pos, dtype=torch.float32, device=dev)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=dev)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((n_pos, d_model), dtype=torch.float32, device=dev)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


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


def tanh(x):
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
    return x * (0.5 * (1.0 + tanh(c * (x + k * (x * x * x)))))


def sigmoid(x):
    """jax.nn.sigmoid: XLA expands ``logistic`` into 1 / (1 + exp(-x)),
    rounding to the compute dtype after each op; the same ops here give
    the same bf16 bits (``torch.sigmoid`` rounds once)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """jax.nn.silu, x * logistic(x), op by op as ``sigmoid``."""
    return x * sigmoid(x)


def softplus(x):
    """jax.nn.softplus, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)).
    ``F.softplus`` returns x itself above its threshold of 20, another
    function in the last bits."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def activation_fn(name: str):
    if name == "silu":
        return silu
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
    of the KV buffers. ``DTensor`` inputs run it on each rank's heads
    (``sharding.local_attention``)."""
    if sh.active_rules() is not None and (isinstance(q, sh.DTensor)
                                          or isinstance(k, sh.DTensor)):
        return sh.local_attention(
            lambda q, k, v: attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                          q_chunk=q_chunk), q, k, v)
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
    cd = x.dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = sh.split_last(q, n_heads)
    k = sh.split_last(k, n_kv_heads)
    v = sh.split_last(v, n_kv_heads)
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
        if isinstance(logits, sh.DTensor):
            # a vocab-sharded gather is a masked partial sum whose mask
            # DTensor checks by value (no meta kernel: the dry-run's
            # tensors have no values); select by comparison instead, the
            # same number (one term of the sum is not zero)
            hit = lab[..., None] == torch.arange(logits.shape[-1],
                                                 device=lab.device)
            gold = torch.where(hit, logits, 0.0).sum(-1, keepdim=True)
        else:
            gold = logits.gather(-1, lab[..., None])
        nll = (torch.logsumexp(logits, dim=-1, keepdim=True) - gold)[..., 0]
        nll = torch.where(m, nll, 0.0)
        total = total + nll.sum()
        count = count + m.sum()
    return total / count.clamp(min=1.0)
