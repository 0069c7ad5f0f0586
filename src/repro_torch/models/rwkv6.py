"""RWKV6 "Finch": attention-free LM with data-dependent decay (PyTorch
port of ``repro.models.rwkv6``).

Per layer: a time-mixing block (multi-head matrix-valued recurrent state,
decay ``w_t`` produced by a LoRA on the token-shifted input) and a
channel-mixing block (squared-ReLU FFN with receptance gate). All
projections run over the full sequence; only the rank-1 state update
``S ← diag(w_t) S + k_t v_tᵀ`` lives in the scan
(``recurrent.chunked_time_scan``), or, with ``cfg.rwkv_chunked``, in the
chunkwise-parallel form (``_chunked_recurrence``).

Parameters keep the JAX package's tree: ``embed``, ``ln_f_g``, ``ln_f_b``,
``w_out`` and ``layers`` (20 leaves stacked on a leading L axis). State
per layer: S (B, H, D, D) f32, plus two token-shift carries (B, d).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.distributed.sharding import (
    local_batch,
    lshard,
    merge_last,
    split_last,
)
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.transformer import embed_tokens

LORA_RANK = 64


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=L.PARAM_DTYPE):
    """Random weights with the JAX init's distributions and scales, drawn
    from ``generator`` and stored on ``device`` in ``dtype``."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=as_device(device))

    def dense(d_in, d_out, scale=None):
        return L.dense_init(generator, d_in, d_out, scale=scale, **kw)

    def layer_init():
        return dict(
            ln1_g=torch.ones((d,), **kw), ln1_b=torch.zeros((d,), **kw),
            ln2_g=torch.ones((d,), **kw), ln2_b=torch.zeros((d,), **kw),
            # time-mix
            mu=torch.full((5, d), 0.5, **kw),      # r, k, v, w, g shift blends
            w_r=dense(d, d), w_k=dense(d, d), w_v=dense(d, d), w_g=dense(d, d),
            wo=dense(d, d, 1.0 / math.sqrt(2.0 * cfg.n_layers * d)),
            w0=torch.full((d,), -5.0, **kw),      # decay bias (slow decay)
            w_lora_a=dense(d, LORA_RANK, 0.01),
            w_lora_b=dense(LORA_RANK, d, 0.01),
            u=L.normal_init(generator, (d,), 0.1, dtype, kw["device"]),
            lnx_g=torch.ones((d,), **kw), lnx_b=torch.zeros((d,), **kw),
            # channel-mix
            mu_ff=torch.full((2, d), 0.5, **kw),  # k, r blends
            wk_ff=dense(d, f),
            wv_ff=dense(f, d, 1.0 / math.sqrt(2.0 * cfg.n_layers * f)),
            wr_ff=dense(d, d),
        )

    return dict(
        embed=L.embed_init(generator, cfg.vocab_size, d, **kw),
        ln_f_g=torch.ones((d,), **kw),
        ln_f_b=torch.zeros((d,), **kw),
        w_out=dense(d, cfg.vocab_size, 0.02),
        layers=L.stacked(layer_init, cfg.n_layers),
    )


def _heads(cfg: ModelConfig, x):
    return split_last(x, cfg.n_heads)


def _time_mix(cfg: ModelConfig, p, x, shift_prev, state):
    """x: (B, S, d). Returns (out, new_shift, new_state)."""
    s = x.shape[1]
    cd = x.dtype
    shifted, new_shift = R.token_shift(x, shift_prev)

    def blend(i):
        m = p["mu"][i].to(cd)
        return x * m + shifted * (1.0 - m)

    xr, xk, xv, xw, xg = (blend(i) for i in range(5))
    r = _heads(cfg, xr @ p["w_r"].to(cd))
    k = _heads(cfg, xk @ p["w_k"].to(cd))
    v = _heads(cfg, xv @ p["w_v"].to(cd))
    g = xg @ p["w_g"].to(cd)
    lora = L.tanh(xw @ p["w_lora_a"].to(cd)) @ p["w_lora_b"].to(cd)
    logw = p["w0"].float() + lora.float()
    w = _heads(cfg, torch.exp(-torch.exp(logw)))     # (B,S,H,D) data-dep decay
    u = p["u"].float().reshape(cfg.n_heads, cfg.ssm_head_dim)

    # the recurrences run on each rank's batch rows (sharding.local_batch)
    if cfg.rwkv_chunked and s > 1:
        state, y = local_batch(
            lambda rkvw, u, st: _chunked_recurrence(cfg, *rkvw, u, st),
            ((r, k, v, w), 0), (u, None), (state, 0))
        y = merge_last(y)
    else:
        def scan(xs, u, state):
            def step(S, inp):                        # S: (B, H, D, E)
                r_t, k_t, v_t, w_t = inp             # (B, H, D) each
                kv = k_t[..., :, None] * v_t[..., None, :]
                y = torch.einsum("bhd,bhde->bhe", r_t, S + u[None, :, :, None] * kv)
                return w_t[..., :, None] * S + kv, y

            return R.chunked_time_scan(step, state, xs, chunk=cfg.scan_chunk,
                                       remat=cfg.remat)

        xs = tuple(a.float().movedim(1, 0) for a in (r, k, v, w))
        state, ys = local_batch(scan, (xs, 1), (u, None), (state, 0),
                                out_dims=(0, 1))
        y = merge_last(ys.movedim(0, 1))             # (B, S, d) f32
    y = L.layernorm(y.to(cd), p["lnx_g"], p["lnx_b"])
    out = (y * L.silu(g)) @ p["wo"].to(cd)
    return out, new_shift, state


def _chunk_step(t, uu, S, r_, k_, v_, w_):
    """One chunk of the chunkwise-parallel recurrence. (B, H, T, D) inputs,
    S (B, H, D, E). Returns (S after the chunk, y (B, H, T, D))."""
    p = torch.cumprod(w_, dim=2)                      # p_t, t = 1..T
    p_prev = torch.cat([torch.ones_like(p[:, :, :1]), p[:, :, :-1]], dim=2)
    q = r_ * p_prev
    kappa = k_ / torch.clamp(p, min=1e-30)
    scores = torch.einsum("bhtd,bhsd->bhts", q, kappa)     # (B, H, T, T)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=S.device),
                      diagonal=-1)                         # strict s < t
    scores = torch.where(mask, scores, 0.0)
    y = torch.einsum("bhts,bhsd->bhtd", scores, v_)        # intra-chunk
    y = y + torch.einsum("bhtd,bhde->bhte", q, S)          # inter-chunk
    diag = torch.sum(r_ * uu[None, :, None, :] * k_, dim=-1, keepdim=True)
    y = y + diag * v_                                      # current token
    decay = p[:, :, -1, :]                                 # p_T (B, H, D)
    S = decay[..., None] * S + torch.einsum(
        "bhtd,bhte->bhde", k_ * (decay[:, :, None] / torch.clamp(p, min=1e-30)), v_)
    return S, y


def _chunked_recurrence(cfg: ModelConfig, r, k, v, w, u, state):
    """The chunkwise-parallel RWKV6 recurrence. With S_t = diag(w_t) S_{t-1}
    + k_t v_tᵀ and p_t = Π_{τ≤t} w_τ within a chunk (p_0 = 1)::

        y_t = (r_t ⊙ p_{t-1})ᵀ S_0                       (inter-chunk)
            + Σ_{s<t} ((r_t ⊙ p_{t-1}/p_s)·k_s) v_s      (intra, matmul)
            + ((r_t ⊙ u)·k_t) v_t                        (diagonal bonus)
        S_T = p_T ⊙ S_0 + (k ⊙ p_T/p)ᵀ V                 (one update a chunk)

    The state is read and written once a chunk instead of once a token.
    ``s`` must be a multiple of ``min(cfg.scan_chunk, s)``. With
    ``cfg.remat`` each chunk runs under ``checkpoint`` while autograd
    records."""
    b, s, h, dh = r.shape
    t = min(cfg.scan_chunk, s)
    if s % t:
        raise ValueError(f"seq {s} must divide chunk {t}")
    n_chunks = s // t

    def reshape(a):                                        # (C, B, H, T, D)
        return a.float().reshape(b, n_chunks, t, h, dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (reshape(a) for a in (r, k, v, w))
    uu = u.float()
    ys = []
    for c in range(n_chunks):
        state, y = L.remat_call(cfg.remat, _chunk_step, t, uu, state, rc[c], kc[c],
                                vc[c], wc[c])
        ys.append(y)
    # (C, B, H, T, D) -> (B, S, H, D)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dh)
    return state, y


def _channel_mix(p, x, shift_prev):
    cd = x.dtype
    shifted, new_shift = R.token_shift(x, shift_prev)
    mk = p["mu_ff"][0].to(cd)
    mr = p["mu_ff"][1].to(cd)
    xk = x * mk + shifted * (1.0 - mk)
    xr = x * mr + shifted * (1.0 - mr)
    k = torch.square(torch.relu(xk @ p["wk_ff"].to(cd)))
    out = L.sigmoid(xr @ p["wr_ff"].to(cd)) * (k @ p["wv_ff"].to(cd))
    return out, new_shift


def _block(cfg: ModelConfig, p, x, att_shift, ffn_shift, state):
    h = L.layernorm(x, p["ln1_g"], p["ln1_b"])
    att, att_shift, state = _time_mix(cfg, p, h, att_shift, state)
    x = lshard(x + att, "batch", "seq", "embed")
    h2 = L.layernorm(x, p["ln2_g"], p["ln2_b"])
    ffn, ffn_shift = _channel_mix(p, h2, ffn_shift)
    return lshard(x + ffn, "batch", "seq", "embed"), att_shift, ffn_shift, state


def _stack(cfg: ModelConfig, params, x, cache):
    """Every layer in turn; the cache holds (att_shift, ffn_shift, state),
    each stacked on a leading L axis. While autograd records, each layer
    runs under ``checkpoint`` where ``cfg.remat``, as the JAX package's
    remat scan over layers."""
    outs = []
    for i, p in enumerate(L.unbind_layers(params["layers"], cfg.n_layers)):
        x, *st = L.remat_call(cfg.remat, _block, cfg, p, x, cache["att_shift"][i],
                              cache["ffn_shift"][i], cache["state"][i])
        outs.append(st)
    a_s, f_s, st = (torch.stack(c) for c in zip(*outs))
    return x, dict(att_shift=a_s, ffn_shift=f_s, state=st, pos=cache["pos"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int = 0, device="cuda"):
    """Zero token-shift carries (L, B, d) in the compute dtype and zero
    states (L, B, H, D, D) f32; ``pos`` 0. ``max_seq`` is unused: the state
    does not grow with the sequence."""
    dev = as_device(device)
    lbd = (cfg.n_layers, batch, cfg.d_model)
    return dict(
        att_shift=torch.zeros(lbd, dtype=L.COMPUTE_DTYPE, device=dev),
        ffn_shift=torch.zeros(lbd, dtype=L.COMPUTE_DTYPE, device=dev),
        state=torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.ssm_head_dim,
                           cfg.ssm_head_dim), dtype=torch.float32, device=dev),
        pos=0,
    )


def loss_fn(cfg: ModelConfig, params, tokens, labels):
    x = embed_tokens(params, tokens)
    x, _ = _stack(cfg, params, x, init_cache(cfg, tokens.shape[0],
                                             device=tokens.device))
    x = L.layernorm(x, params["ln_f_g"], params["ln_f_b"])
    return L.lm_loss(x, params["w_out"].to(x.dtype), labels)


def prefill(cfg: ModelConfig, params, tokens):
    """tokens: (B, S). Returns (last-position logits (B, V) f32, cache)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens)
    x, cache = _stack(cfg, params, x, init_cache(cfg, b, device=tokens.device))
    x = L.layernorm(x, params["ln_f_g"], params["ln_f_b"])
    logits = (x[:, -1] @ params["w_out"].to(x.dtype)).float()
    cache["pos"] = s
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1). Returns (logits (B, V) f32, the next cache)."""
    x = embed_tokens(params, tokens)
    x, new = _stack(cfg, params, x, cache)
    x = L.layernorm(x, params["ln_f_g"], params["ln_f_b"])
    logits = (x[:, 0] @ params["w_out"].to(x.dtype)).float()
    new["pos"] = int(cache["pos"]) + 1
    return logits, new
