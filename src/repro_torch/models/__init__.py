"""Model code: every family of the JAX package (dense, moe, ssm, hybrid,
encdec) behind one interface."""

from repro_torch.models.api import LM, get_model  # noqa: F401
