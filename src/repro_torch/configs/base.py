"""Model configuration dataclass (PyTorch port's own copy).

The fields and derived quantities of ``repro.configs.base.ModelConfig``,
so a config means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    activation: str = "silu"    # silu | gelu | relu2
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    use_rope: bool = True
    # run-time knobs, as in the JAX package
    dispatch_groups: int = 1    # MoE dispatch groups (each with its capacity)
    remat: bool = True          # activation checkpointing per layer (training)
    cache_f32: bool = False     # storage dtype of the plain decode KV cache

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count of a decoder (matrices and the
        router; no norms, biases or shared-expert gate), as
        ``repro.configs.base.ModelConfig.param_count`` for the dense and
        MoE families."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.is_moe:
            mlp = (3 if self.gated_mlp else 2) * d * self.moe_d_ff
            routed = self.n_experts * mlp
            shared = self.n_shared_experts * mlp
            router = d * self.n_experts
            blocks = self.n_layers * (attn + routed + shared + router)
        else:
            mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
            blocks = self.n_layers * (attn + mlp)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return blocks + embed

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        mlp = (3 if self.gated_mlp else 2) * d * self.moe_d_ff
        active = self.n_layers * (
            self.hd * d * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.hd * d
            + (self.top_k + self.n_shared_experts) * mlp + d * self.n_experts
        )
        return active + self.vocab_size * d * (1 if self.tie_embeddings else 2)
