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
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0         # hybrid: shared attention block every k layers
    # encoder-decoder
    n_enc_layers: int = 0
    enc_frames: int = 0         # stub audio frontend's sequence length
    use_rope: bool = True       # False: sinusoidal positions (whisper) or none
    # run-time knobs, as in the JAX package
    dispatch_groups: int = 1    # MoE dispatch groups (each with its capacity)
    remat: bool = True          # activation checkpointing per layer (training)
    scan_chunk: int = 64        # recurrence time chunk (SSM and hybrid)
    rwkv_chunked: bool = False  # chunkwise-parallel (matmul) RWKV recurrence
    cache_f32: bool = False     # storage dtype of the plain decode KV cache

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (the matrices and the router; no
        norms, biases or shared-expert gate; RWKV's LoRA, decay and mixing
        vectors and Mamba2's conv left out too), the same formula as
        ``repro.configs.base.ModelConfig.param_count`` for every family."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm":                       # rwkv6 time + channel mix
            blocks = self.n_layers * (5 * d * d + 3 * d * self.d_ff)
        elif self.family == "hybrid":                  # mamba2 blocks + shared attn
            d_in = self.ssm_expand * d
            mamba = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                     + d_in * d)
            # ONE shared attention + MLP block (zamba2's parameter trick)
            blocks = (self.n_layers * mamba + attn
                      + (3 if self.gated_mlp else 2) * d * self.d_ff)
        elif self.is_moe:
            mlp = (3 if self.gated_mlp else 2) * d * self.moe_d_ff
            routed = self.n_experts * mlp
            shared = self.n_shared_experts * mlp
            router = d * self.n_experts
            blocks = self.n_layers * (attn + routed + shared + router)
        else:
            mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
            blocks = self.n_layers * (attn + mlp)
            if self.family == "encdec":                # + encoder, cross-attention
                blocks += self.n_enc_layers * (attn + mlp) + self.n_layers * attn
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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling: it runs only for the
# SSM and hybrid archs
LONG_CONTEXT_ARCHS = ("rwkv6-3b", "zamba2-2.7b")


def cells_for(arch: str) -> list[str]:
    """The dry-run's shape cells of ``arch``."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells
