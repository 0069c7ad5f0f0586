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
    n_experts: int = 0          # MoE layers arrive in a later slice
    use_rope: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count of a dense decoder (matrices only,
        as ``repro.configs.base.ModelConfig.param_count``)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        per = attn + (3 if self.gated_mlp else 2) * d * self.d_ff
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per + embed
