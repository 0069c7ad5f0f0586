"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention
block (PyTorch port of ``repro.models.hybrid``).

``cfg.n_layers`` Mamba2 blocks, with a single shared (attention + MLP)
block — one parameter set, reused — applied after every ``cfg.attn_every``
Mamba2 layers; the ``n_layers % attn_every`` trailing Mamba2 layers run
after the last application. Parameters keep the JAX package's tree:
``embed``, ``ln_f``, ``w_out``, ``shared.{ln1,ln2,attn,ff}`` and ``layers``
(the Mamba2 blocks stacked on a leading L axis).

Decode cache: per-layer Mamba2 conv and SSM states, and one KV cache per
application site of the shared block (G sites: a leading G axis).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.distributed.sharding import lshard, merge_last
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.transformer import embed_tokens


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=L.PARAM_DTYPE):
    """Random weights with the JAX init's distributions and scales, drawn
    from ``generator`` and stored on ``device`` in ``dtype``."""
    kw = dict(dtype=dtype, device=as_device(device))
    scale = max(1, _n_groups(cfg))
    shared = dict(
        ln1=torch.ones((cfg.d_model,), **kw),
        ln2=torch.ones((cfg.d_model,), **kw),
        attn=L.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, qkv_bias=False, qk_norm=False,
                         n_layers_scale=scale, **kw),
        ff=L.mlp_init(generator, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                      n_layers_scale=scale, **kw),
    )
    return dict(
        embed=L.embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        ln_f=torch.ones((cfg.d_model,), **kw),
        w_out=L.dense_init(generator, cfg.d_model, cfg.vocab_size, scale=0.02, **kw),
        shared=shared,
        layers=L.stacked(lambda: M.block_init(cfg, generator, **kw), cfg.n_layers),
    )


def _shared_fwd(cfg: ModelConfig, p, x, positions):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta)
    attn = L.attention_ref(q, k, v, causal=True)
    attn = merge_last(attn)
    x = x + attn @ p["attn"]["wo"].to(x.dtype)
    h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + L.mlp_apply(p["ff"], h2, cfg.activation)
    k = lshard(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = lshard(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return lshard(x, "batch", "seq", "embed"), (k, v)


def _shared_decode(cfg: ModelConfig, p, x, k_cache, v_cache, pos: int):
    """The shared block at one token, its K/V written into the site's
    caches (B, S, Hkv, D) at ``pos`` in place."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         positions, rope_theta=cfg.rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    k_cache = lshard(k_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    v_cache = lshard(v_cache, "batch", "kv_seq", "kv_heads", "head_dim")
    attn = L.decode_attention_ref(q, k_cache, v_cache, pos + 1)
    attn = merge_last(attn).to(x.dtype)
    x = x + attn @ p["attn"]["wo"].to(x.dtype)
    h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["ff"], h2, cfg.activation)


def _mamba_layers(cfg: ModelConfig, blocks, lo: int, hi: int, x, cache, convs, ssms):
    """Mamba2 layers ``lo .. hi-1`` on ``x``, their states from ``cache``
    appended to ``convs``/``ssms``. While autograd records each layer runs
    under ``checkpoint`` where ``cfg.remat``."""
    for i in range(lo, hi):
        x, cp, st = L.remat_call(cfg.remat, M.block_apply, cfg, blocks[i], x,
                                 cache["conv"][i], cache["ssm"][i])
        convs.append(cp)
        ssms.append(st)
    return x


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zero conv contexts (L, B, K-1, C) and K/V (G, B, max_seq, Hkv, D) in
    the compute dtype, zero SSM states (L, B, nH, headD, N) f32; ``pos``
    0."""
    dev = as_device(device)
    conv_shape, ssm_shape = M.state_shapes(cfg, batch)
    kv = (_n_groups(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cd = dict(dtype=L.COMPUTE_DTYPE, device=dev)
    return dict(
        conv=torch.zeros((cfg.n_layers,) + conv_shape, **cd),
        ssm=torch.zeros((cfg.n_layers,) + ssm_shape, dtype=torch.float32, device=dev),
        k=torch.zeros(kv, **cd),
        v=torch.zeros(kv, **cd),
        pos=0,
    )


def _forward(cfg: ModelConfig, params, tokens, cache, *, collect_kv: bool):
    b, s = tokens.shape
    ae, g = cfg.attn_every, _n_groups(cfg)
    blocks = L.unbind_layers(params["layers"], cfg.n_layers)
    x = embed_tokens(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None] \
        + int(cache["pos"])
    convs, ssms, kvs = [], [], []
    for gi in range(g):
        x = _mamba_layers(cfg, blocks, gi * ae, (gi + 1) * ae, x, cache, convs, ssms)
        x, kv = _shared_fwd(cfg, params["shared"], x, positions)
        kvs.append(kv)
    # the trailing Mamba2 layers (n_layers % attn_every)
    x = _mamba_layers(cfg, blocks, g * ae, cfg.n_layers, x, cache, convs, ssms)
    new_cache = dict(
        conv=torch.stack(convs),
        ssm=torch.stack(ssms),
        k=torch.stack([kv[0] for kv in kvs]) if collect_kv else cache["k"],
        v=torch.stack([kv[1] for kv in kvs]) if collect_kv else cache["v"],
        pos=int(cache["pos"]) + s,
    )
    return x, new_cache


def _logits(cfg: ModelConfig, params, x):
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["w_out"].to(x.dtype)).float()


def loss_fn(cfg: ModelConfig, params, tokens, labels):
    cache = init_cache(cfg, tokens.shape[0], 0, device=tokens.device)
    x, _ = _forward(cfg, params, tokens, cache, collect_kv=False)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.lm_loss(x, params["w_out"].to(x.dtype), labels)


def prefill(cfg: ModelConfig, params, tokens):
    """tokens: (B, S). Returns (last-position logits (B, V) f32, cache)
    with K/V (G, B, S, Hkv, D): a decode step needs them spliced into an
    ``init_cache(B, max_seq)`` with room."""
    cache = init_cache(cfg, tokens.shape[0], 0, device=tokens.device)
    x, cache = _forward(cfg, params, tokens, cache, collect_kv=True)
    return _logits(cfg, params, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """tokens: (B, 1), every row at ``cache["pos"]``. Returns (logits (B, V)
    f32, cache): new conv and SSM states, the same K/V tensors written at
    ``pos`` in place, and ``pos + 1``."""
    ae, g = cfg.attn_every, _n_groups(cfg)
    pos = int(cache["pos"])
    blocks = L.unbind_layers(params["layers"], cfg.n_layers)
    x = embed_tokens(params, tokens)
    convs, ssms = [], []
    for gi in range(g):
        x = _mamba_layers(cfg, blocks, gi * ae, (gi + 1) * ae, x, cache, convs, ssms)
        x = _shared_decode(cfg, params["shared"], x, cache["k"][gi],
                           cache["v"][gi], pos)
    x = _mamba_layers(cfg, blocks, g * ae, cfg.n_layers, x, cache, convs, ssms)
    new_cache = dict(conv=torch.stack(convs), ssm=torch.stack(ssms),
                     k=cache["k"], v=cache["v"], pos=pos + 1)
    return _logits(cfg, params, x[:, 0]), new_cache
