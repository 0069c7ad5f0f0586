"""Model code: the dense transformer of this slice."""

from repro_torch.models.api import LM, get_model  # noqa: F401
