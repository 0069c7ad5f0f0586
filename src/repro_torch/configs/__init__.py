"""Arch registry of the port: ``get_config(arch_id)`` and smoke-reduced
variants, for every config of ``repro.configs``: the decoder-only
transformers (dense and MoE), RWKV-6 (ssm), Zamba2 (hybrid) and Whisper
(encdec); and the dry-run's shape cells (``SHAPES``, ``cells_for``)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    cells_for,
)

from repro_torch.configs import (  # noqa: E402
    chameleon_34b,
    nemotron_4_15b,
    phi3_5_moe,
    qwen2_5_3b,
    qwen2_7b,
    qwen2_72b,
    qwen2_moe_a2_7b,
    rwkv6_3b,
    whisper_base,
    zamba2_2_7b,
)

_REGISTRY = {
    c.CONFIG.name: c.CONFIG
    for c in (
        whisper_base, qwen2_72b, qwen2_5_3b, nemotron_4_15b, qwen2_7b,
        chameleon_34b, qwen2_moe_a2_7b, phi3_5_moe, rwkv6_3b, zamba2_2_7b,
    )
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {list_archs()}") from None


def smoke_config(arch: str) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests — the same rule as
    ``repro.configs.smoke_config``: small widths, depth and vocab, few
    experts, with every structural feature kept (GQA ratio, bias,
    activation, qk-norm, MoE topology, hybrid period, the encoder-decoder
    split)."""
    c = get_config(arch)
    kv = max(1, min(c.n_kv_heads, 2 if c.n_kv_heads < c.n_heads else 4))
    heads = 4 if c.n_heads != c.n_kv_heads else kv
    if c.n_heads == c.n_kv_heads:
        heads = kv = 4
    updates = dict(
        n_layers=min(c.n_layers, 4 if c.family == "hybrid" else 2),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if c.is_moe:
        updates.update(n_experts=4, top_k=min(c.top_k, 2), moe_d_ff=32,
                       n_shared_experts=min(c.n_shared_experts, 1))
    if c.family == "encdec":
        updates.update(n_enc_layers=2, enc_frames=12)
    if c.family == "ssm":
        updates.update(n_heads=4, n_kv_heads=4, ssm_head_dim=16)
    if c.family == "hybrid":
        updates.update(ssm_head_dim=16, ssm_state=8, attn_every=2,
                       n_heads=4, n_kv_heads=4)
    return dataclasses.replace(c, **updates)
