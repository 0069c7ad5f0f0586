"""Uniform LM interface (PyTorch port of ``repro.models.api``).

This slice serves the ``dense`` family; ``get_model`` raises for the
families whose model code arrives in later slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def prefill(self, params, batch):
        return transformer.prefill(self.cfg, params, batch["tokens"])


def get_model(cfg: ModelConfig) -> LM:
    if cfg.family == "moe" or cfg.is_moe:
        raise NotImplementedError(
            "MoE (models/moe.py) is ported in a later slice of the port")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; this slice "
            "serves dense transformers")
    return LM(cfg)
