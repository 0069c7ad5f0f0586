"""Model code: the decoder-only transformers (dense and MoE)."""

from repro_torch.models.api import LM, get_model  # noqa: F401
