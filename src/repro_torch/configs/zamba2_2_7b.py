"""zamba2-2.7b [hybrid]: Mamba2 backbone + one shared attention block
applied every `attn_every` layers, ssm_state=64. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    activation="gelu", gated_mlp=True,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
)
