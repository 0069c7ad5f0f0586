"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # 40 heads of 64
    d_ff=8960, vocab_size=65536,
    activation="relu2", gated_mlp=False, use_rope=False,
    ssm_head_dim=64,
)
