"""whisper-base [audio]: encoder-decoder, the conv frontend stubbed
(precomputed frame embeddings stand in for it). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,            # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    gated_mlp=False,
    use_rope=False,        # sinusoidal positions
    enc_frames=1500,
    tie_embeddings=True,
)
