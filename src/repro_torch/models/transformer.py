"""Decoder-only transformer, dense GQA and MoE (PyTorch port of
``repro.models.transformer``).

Covers qwen2-72b/7b, qwen2.5-3b, nemotron-4-15b (squared-ReLU, ungated),
chameleon-34b (qk-norm), qwen2-moe-a2.7b and phi3.5-moe-42b-a6.6b
(``cfg.is_moe`` → the routed FF of ``models.moe``).

Parameters keep the JAX package's layout: a dict with ``embed``, ``ln_f``,
``w_out`` and ``layers``, whose leaves are stacked along a leading L axis
(``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo,bq,bk,bv,q_norm,k_norm}``, and
``ff.{w_up,w_gate,w_down}`` or the MoE's ``ff.{router,e_gate,e_up,e_down,
shared.{w_gate,w_up,w_down},shared_gate}``). The JAX scan over layers
becomes a Python loop over ``L.layer(params["layers"], i)`` views;
training (``loss_fn``) loops over the leaves unbound a layer at a time,
each layer under ``torch.utils.checkpoint`` where ``cfg.remat`` (the
JAX package's ``jax.checkpoint`` of the scan body). The plain decode
path (``init_cache``, ``decode_step``) keeps a dense
(L, B, S, Hkv, D) cache per request; serving reads a paged pool instead
(``serve.paged_decode``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.distributed.sharding import lshard, merge_last, write_position
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=L.PARAM_DTYPE):
    """Random weights with the JAX init's distributions and scales, drawn
    from ``generator`` (on its own device) and stored on ``device`` in
    ``dtype``. The JAX package keeps f32 parameters and casts them to the
    compute dtype at every use; passing ``dtype=L.COMPUTE_DTYPE`` casts
    once here instead, which gives the same values at use."""
    dev = as_device(device)
    kw = dict(dtype=dtype, device=dev)

    def layer_init():
        p = dict(
            ln1=torch.ones((cfg.d_model,), **kw),
            ln2=torch.ones((cfg.d_model,), **kw),
            attn=L.attn_init(generator, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, qkv_bias=cfg.qkv_bias,
                             qk_norm=cfg.qk_norm, n_layers_scale=cfg.n_layers,
                             **kw),
        )
        if cfg.is_moe:
            p["ff"] = moe_lib.moe_init(cfg, generator, **kw)
        else:
            p["ff"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                 gated=cfg.gated_mlp,
                                 n_layers_scale=cfg.n_layers, **kw)
        return p

    params = dict(
        embed=L.embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        ln_f=torch.ones((cfg.d_model,), **kw),
        layers=L.stacked(layer_init, cfg.n_layers),
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
    return lshard(table.to(L.COMPUTE_DTYPE)[ids], "batch", "seq", "embed")


def ff(cfg: ModelConfig, p_ff, h):
    """The block's feed-forward: (out, aux); a dense MLP's aux is 0.0 (a
    Python float: no device op a layer)."""
    if cfg.is_moe:
        return moe_lib.moe_apply(cfg, p_ff, h)
    return L.mlp_apply(p_ff, h, cfg.activation), 0.0


def block_fwd(cfg: ModelConfig, p, x, positions):
    """Full-sequence (prefill) block. Returns (x, k, v, aux)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta,
                         use_rope=cfg.use_rope)
    q = lshard(q, "batch", "seq", "heads", "head_dim")
    k = lshard(k, "batch", "seq", "kv_heads", "head_dim")
    v = lshard(v, "batch", "seq", "kv_heads", "head_dim")
    attn = L.attention_ref(q, k, v, causal=True)
    attn = merge_last(attn)
    x = x + attn @ p["attn"]["wo"].to(x.dtype)
    x = lshard(x, "batch", "seq", "embed")
    h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff_out, aux = ff(cfg, p["ff"], h2)
    x = lshard(x + ff_out, "batch", "seq", "embed")
    # cache-destined copies are sequence-sharded (kv_seq → model axis) so a
    # 32k-token prefill's collected KV fits per-device memory
    k_out = lshard(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v_out = lshard(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return x, k_out, v_out, aux


def _block_train(cfg: ModelConfig, p, x, positions):
    x, _, _, aux = block_fwd(cfg, p, x, positions)
    return x, aux


def train_stack(cfg: ModelConfig, layers: dict, x, positions):
    """The training forward of every layer: (x, the MoE aux losses summed,
    0.0 for a dense model). With ``cfg.remat`` each layer runs under a
    non-reentrant ``checkpoint``, so the backward keeps each layer's input
    and recomputes the rest, as the JAX package's remat scan does."""
    aux = 0.0
    for p in L.unbind_layers(layers, cfg.n_layers):
        x, a = L.remat_call(cfg.remat, _block_train, cfg, p, x, positions)
        aux = aux + a
    return x, aux


def loss_fn(cfg: ModelConfig, params, tokens, labels):
    """Teacher-forced LM loss. tokens/labels: (B, S) int. The attention is
    ``L.attention_ref``, as in the JAX package's training path."""
    x = embed_tokens(params, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None]
    x, aux = train_stack(cfg, params["layers"], x, positions)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    nll = L.lm_loss(x, output_matrix(cfg, params).to(x.dtype), labels)
    return nll + 0.01 * aux


def block_decode(cfg: ModelConfig, p, x, k_cache, v_cache, pos: int):
    """One-token block. x: (B, 1, d); caches (B, S, Hkv, D), written at
    ``pos`` in place; attends over positions ``<= pos``."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta,
                         use_rope=cfg.use_rope)
    write_position(k_cache, pos, k[:, 0].to(k_cache.dtype))
    write_position(v_cache, pos, v[:, 0].to(v_cache.dtype))
    k_cache = lshard(k_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    v_cache = lshard(v_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    attn = L.decode_attention_ref(q, k_cache, v_cache, pos + 1)
    attn = merge_last(attn).to(x.dtype)
    x = x + attn @ p["attn"]["wo"].to(x.dtype)
    h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    ff_out, _ = ff(cfg, p["ff"], h2)
    return x + ff_out


def prefill(cfg: ModelConfig, params, tokens):
    """tokens: (B, S). Returns (last-position logits (B, V) f32, cache)
    with cache ``k``/``v`` of shape (L, B, S, Hkv, D) and ``pos`` S."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v, _ = block_fwd(cfg, L.layer(params["layers"], i), x, positions)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, -1] @ output_matrix(cfg, params).to(x.dtype)).float()
    cache = dict(k=torch.stack(ks), v=torch.stack(vs), pos=s)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """An empty plain decode cache: ``k``/``v`` (L, B, max_seq, Hkv, D) in
    f32 where ``cfg.cache_f32`` says so, else the compute dtype; ``pos`` 0."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = torch.float32 if cfg.cache_f32 else L.COMPUTE_DTYPE
    dev = as_device(device)
    return dict(k=torch.zeros(shape, dtype=dt, device=dev),
                v=torch.zeros(shape, dtype=dt, device=dev), pos=0)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1), every row at ``cache["pos"]``. Returns (logits (B, V)
    f32, cache): the new cache holds the same ``k``/``v`` tensors, written
    at ``pos`` in place, and ``pos + 1``."""
    pos = int(cache["pos"])
    x = embed_tokens(params, tokens)
    for i in range(cfg.n_layers):
        x = block_decode(cfg, L.layer(params["layers"], i), x, cache["k"][i],
                         cache["v"][i], pos)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, 0] @ output_matrix(cfg, params).to(x.dtype)).float()
    return logits, dict(k=cache["k"], v=cache["v"], pos=pos + 1)
