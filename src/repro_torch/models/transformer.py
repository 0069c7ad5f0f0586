"""Decoder-only dense transformer (PyTorch port of ``repro.models.transformer``).

Parameters keep the JAX package's layout: a dict with ``embed``, ``ln_f``,
``w_out`` and ``layers``, whose leaves are stacked along a leading L axis
(``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo,bq,bk,bv}``, ``ff.{w_up,w_gate,
w_down}``). The JAX scan over layers becomes a Python loop over
``layer(params["layers"], i)`` views. MoE layers arrive in a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.models import layers as L


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the L-stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _stack(per_layer: list[dict]) -> dict:
    first = per_layer[0]
    return {k: _stack([p[k] for p in per_layer]) if isinstance(first[k], dict)
            else torch.stack([p[k] for p in per_layer])
            for k in first}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=L.PARAM_DTYPE):
    """Random weights with the JAX init's distributions and scales, drawn
    from ``generator`` (on its own device) and stored on ``device`` in
    ``dtype``. The JAX package keeps f32 parameters and casts them to the
    compute dtype at every use; passing ``dtype=L.COMPUTE_DTYPE`` casts
    once here instead, which gives the same values at use."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers (models/moe.py) are ported in a later slice")
    dev = as_device(device)
    kw = dict(dtype=dtype, device=dev)

    def layer_init():
        return dict(
            ln1=torch.ones((cfg.d_model,), **kw),
            ln2=torch.ones((cfg.d_model,), **kw),
            attn=L.attn_init(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, qkv_bias=cfg.qkv_bias,
                             n_layers_scale=cfg.n_layers, **kw),
            ff=L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                          gated=cfg.gated_mlp, n_layers_scale=cfg.n_layers,
                          **kw),
        )

    params = dict(
        embed=L.embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        ln_f=torch.ones((cfg.d_model,), **kw),
        layers=_stack([layer_init() for _ in range(cfg.n_layers)]),
    )
    if not cfg.tie_embeddings:
        params["w_out"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                       scale=0.02, **kw)
    return params


def output_matrix(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["w_out"]


def embed_tokens(params, tokens):
    """Token embeddings in the compute dtype. Ids are clamped into the
    vocabulary, as the JAX gather clamps out-of-range indices."""
    table = params["embed"]
    ids = tokens.clamp(0, table.shape[0] - 1)
    return table.to(L.COMPUTE_DTYPE)[ids]


def block_fwd(cfg: ModelConfig, p, x, positions):
    """Full-sequence (prefill) block. Returns (x, k, v)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta,
                         use_rope=cfg.use_rope)
    attn = L.attention_ref(q, k, v, causal=True)
    attn = attn.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.hd)
    x = x + attn @ p["attn"]["wo"].to(x.dtype)
    h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + L.mlp_apply(p["ff"], h2, cfg.activation)
    return x, k, v


def prefill(cfg: ModelConfig, params, tokens):
    """tokens: (B, S). Returns (last-position logits (B, V) f32, cache)
    with cache ``k``/``v`` of shape (L, B, S, Hkv, D)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = block_fwd(cfg, layer(params["layers"], i), x, positions)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, -1] @ output_matrix(cfg, params).to(x.dtype)).float()
    cache = dict(k=torch.stack(ks), v=torch.stack(vs), pos=s)
    return logits, cache
