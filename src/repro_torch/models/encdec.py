"""Whisper-style encoder-decoder backbone, the conv/mel frontend stubbed
(PyTorch port of ``repro.models.encdec``).

``frames`` — precomputed frame embeddings (B, F, d_model) — stand in for
the conv1d + mel frontend. Encoder: bidirectional self-attention; decoder:
causal self-attention and cross-attention; GELU MLPs, LayerNorm,
sinusoidal positions (extended past Whisper's 448 decoder positions, as
in the JAX package). Parameters keep the JAX package's tree: ``embed``
(tied to the output), ``ln_f``/``ln_fb``, ``enc_ln``/``enc_lnb``, and
``enc_layers`` and ``dec_layers`` stacked on a leading L axis (each with
``ln1``/``ln1b``, ``ln2``/``ln2b``, ``attn.{wq,wk,wv,wo}``,
``ff.{w_up,w_down}``; a decoder layer also ``lnx``/``lnxb`` and
``xattn.{wq,wk,wv,wo}``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.distributed.sharding import (
    lshard,
    merge_last,
    split_last,
    write_position,
)
from repro_torch.models import layers as L
from repro_torch.models.transformer import embed_tokens


def _attn_block_init(cfg: ModelConfig, generator, kw, *, cross: bool):
    d = cfg.d_model

    def attn():
        return L.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qkv_bias=False, qk_norm=False,
                           n_layers_scale=cfg.n_layers, **kw)

    p = dict(ln1=torch.ones((d,), **kw), ln1b=torch.zeros((d,), **kw),
             ln2=torch.ones((d,), **kw), ln2b=torch.zeros((d,), **kw),
             attn=attn(),
             ff=L.mlp_init(generator, d, cfg.d_ff, gated=cfg.gated_mlp,
                           n_layers_scale=cfg.n_layers, **kw))
    if cross:
        p.update(lnx=torch.ones((d,), **kw), lnxb=torch.zeros((d,), **kw),
                 xattn=attn())
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=L.PARAM_DTYPE):
    """Random weights with the JAX init's distributions and scales, drawn
    from ``generator`` and stored on ``device`` in ``dtype``."""
    kw = dict(dtype=dtype, device=as_device(device))
    d = cfg.d_model
    return dict(
        embed=L.embed_init(generator, cfg.vocab_size, d, **kw),
        ln_f=torch.ones((d,), **kw), ln_fb=torch.zeros((d,), **kw),
        enc_ln=torch.ones((d,), **kw), enc_lnb=torch.zeros((d,), **kw),
        enc_layers=L.stacked(
            lambda: _attn_block_init(cfg, generator, kw, cross=False),
            cfg.n_enc_layers),
        dec_layers=L.stacked(
            lambda: _attn_block_init(cfg, generator, kw, cross=True), cfg.n_layers),
    )


def _layers(cfg: ModelConfig, body, x, stack: dict, n: int, *extra):
    """``body(cfg, p, x, *extra) -> (x, out)`` over the ``n`` stacked
    layers, each under ``checkpoint`` where ``cfg.remat`` while autograd
    records. Returns (x, the outs)."""
    outs = []
    for p in L.unbind_layers(stack, n):
        x, out = L.remat_call(cfg.remat, body, cfg, p, x, *extra)
        outs.append(out)
    return x, outs


def _self_attn(cfg: ModelConfig, p, x, positions, *, causal):
    h = L.layernorm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta, use_rope=False)
    out = L.attention_ref(q, k, v, causal=causal)
    out = merge_last(out)
    return x + out @ p["attn"]["wo"].to(x.dtype), (k, v)


def _cross_attn(cfg: ModelConfig, p, x, k, v):
    h = L.layernorm(x, p["lnx"], p["lnxb"], cfg.norm_eps)
    q = split_last(h @ p["xattn"]["wq"].to(h.dtype), cfg.n_heads)
    out = L.attention_ref(q, k, v, causal=False)
    out = merge_last(out)
    return x + out @ p["xattn"]["wo"].to(x.dtype)


def _mlp(cfg: ModelConfig, p, x):
    h = L.layernorm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
    return x + L.mlp_apply(p["ff"], h, cfg.activation)


def _enc_block(cfg: ModelConfig, p, x, positions):
    x, _ = _self_attn(cfg, p, x, positions, causal=False)
    return _mlp(cfg, p, x), None


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, F, d_model) stub embeddings → encoder memory."""
    x = frames.to(L.COMPUTE_DTYPE)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    x = lshard(x, "batch", "frames", "embed")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    x, _ = _layers(cfg, _enc_block, x, params["enc_layers"], cfg.n_enc_layers,
                   positions)
    return L.layernorm(x, params["enc_ln"], params["enc_lnb"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p, memory):
    k = split_last(memory @ p["xattn"]["wk"].to(memory.dtype), cfg.n_kv_heads)
    v = split_last(memory @ p["xattn"]["wv"].to(memory.dtype), cfg.n_kv_heads)
    return k, v


def _dec_block(cfg: ModelConfig, p, x, positions, memory):
    x, kv = _self_attn(cfg, p, x, positions, causal=True)
    kv = tuple(lshard(a, "batch", "kv_seq", "kv_heads", "head_dim") for a in kv)
    xkv = _cross_kv(cfg, p, memory)
    x = _cross_attn(cfg, p, x, *xkv)
    return _mlp(cfg, p, x), (kv, xkv)


def _decoder(cfg: ModelConfig, params, tokens, memory):
    """The decoder over ``tokens`` from position 0: (x after the final
    LayerNorm, each layer's ((k, v), (cross k, cross v)))."""
    s = tokens.shape[1]
    x = embed_tokens(params, tokens)
    x = x + L.sinusoidal_positions(s, cfg.d_model, x.device)[None].to(x.dtype)
    x = lshard(x, "batch", "seq", "embed")
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    x, kvs = _layers(cfg, _dec_block, x, params["dec_layers"], cfg.n_layers,
                     positions, memory)
    return L.layernorm(x, params["ln_f"], params["ln_fb"], cfg.norm_eps), kvs


def loss_fn(cfg: ModelConfig, params, tokens, labels, frames):
    memory = encode(cfg, params, frames)
    x, _ = _decoder(cfg, params, tokens, memory)
    w_out = params["embed"].T            # whisper ties the embedding and head
    return L.lm_loss(x, w_out.to(x.dtype), labels)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zero self-attention K/V (L, B, max_seq, Hkv, D) and cross K/V (L, B,
    enc_frames, Hkv, D) in the compute dtype; ``pos`` 0."""
    kw = dict(dtype=L.COMPUTE_DTYPE, device=as_device(device))
    ldim = (cfg.n_layers, batch)
    return dict(
        k=torch.zeros(ldim + (max_seq, cfg.n_kv_heads, cfg.hd), **kw),
        v=torch.zeros(ldim + (max_seq, cfg.n_kv_heads, cfg.hd), **kw),
        xk=torch.zeros(ldim + (cfg.enc_frames, cfg.n_kv_heads, cfg.hd), **kw),
        xv=torch.zeros(ldim + (cfg.enc_frames, cfg.n_kv_heads, cfg.hd), **kw),
        pos=0,
    )


def prefill(cfg: ModelConfig, params, tokens, frames):
    """tokens: (B, S), frames (B, F, d). Returns (last-position logits (B, V)
    f32, cache) with K/V (L, B, S, Hkv, D) — a decode step needs them
    spliced into an ``init_cache(B, max_seq)`` with room — and each
    decoder layer's cross K/V of the encoder memory."""
    memory = encode(cfg, params, frames)
    x, kvs = _decoder(cfg, params, tokens, memory)
    logits = (x[:, -1] @ params["embed"].T.to(x.dtype)).float()
    (k, v), (xk, xv) = ([torch.stack(c) for c in zip(*pair)]
                        for pair in zip(*kvs))
    return logits, dict(k=k, v=v, xk=xk, xv=xv, pos=tokens.shape[1])


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1), every row at ``cache["pos"]``. Returns (logits (B, V)
    f32, cache): the same K/V tensors, written at ``pos`` in place, the
    same cross K/V, and ``pos + 1``. The sinusoidal row of ``pos`` is
    computed alone, as the JAX package does."""
    pos = int(cache["pos"])
    b = tokens.shape[0]
    x = embed_tokens(params, tokens)
    x = x + L.sinusoidal_positions(1, cfg.d_model, x.device, offset=pos)[None].to(x.dtype)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        p = L.layer(params["dec_layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.layernorm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                             positions, rope_theta=cfg.rope_theta, use_rope=False)
        write_position(kc, pos, k[:, 0].to(kc.dtype))
        write_position(vc, pos, v[:, 0].to(vc.dtype))
        out = L.decode_attention_ref(q, kc, vc, pos + 1)
        x = x + out.reshape(b, 1, -1).to(x.dtype) @ p["attn"]["wo"].to(x.dtype)
        hx = L.layernorm(x, p["lnx"], p["lnxb"], cfg.norm_eps)
        qx = (hx @ p["xattn"]["wq"].to(x.dtype)).reshape(b, 1, cfg.n_heads, cfg.hd)
        xk, xv = cache["xk"][i], cache["xv"][i]
        outx = L.decode_attention_ref(qx, xk, xv, xk.shape[1])
        x = x + outx.reshape(b, 1, -1).to(x.dtype) @ p["xattn"]["wo"].to(x.dtype)
        x = _mlp(cfg, p, x)
    x = L.layernorm(x, params["ln_f"], params["ln_fb"], cfg.norm_eps)
    logits = (x[:, 0] @ params["embed"].T.to(x.dtype)).float()
    return logits, dict(k=cache["k"], v=cache["v"], xk=cache["xk"],
                        xv=cache["xv"], pos=pos + 1)
