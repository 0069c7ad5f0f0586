"""chameleon-34b [vlm]: early-fusion, VQ image tokens (backbone only; the
VQ tokenizer is a stub — image tokens are ids in the 65536 vocab).
qk-norm per the paper's stability fix. [arXiv:2405.09818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    activation="silu", qk_norm=True, rope_theta=1e4,
)
