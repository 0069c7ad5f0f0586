"""Arch registry of the port: ``get_config(arch_id)`` and smoke-reduced
variants. This slice serves one model, qwen2.5-3b; the other families of
``repro.configs`` arrive with their model code."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen2_5_3b
from repro_torch.configs.base import ModelConfig

_REGISTRY = {c.CONFIG.name: c.CONFIG for c in (qwen2_5_3b,)}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {list_archs()}") from None


def smoke_config(arch: str) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests — the same rule as
    ``repro.configs.smoke_config``: small widths, depth and vocab, with
    every structural feature kept (GQA ratio, bias, activation)."""
    c = get_config(arch)
    kv = max(1, min(c.n_kv_heads, 2 if c.n_kv_heads < c.n_heads else 4))
    heads = 4 if c.n_heads != c.n_kv_heads else kv
    if c.n_heads == c.n_kv_heads:
        heads = kv = 4
    return dataclasses.replace(
        c,
        n_layers=min(c.n_layers, 2),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
