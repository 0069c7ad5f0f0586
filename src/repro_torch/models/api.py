"""Uniform LM interface (PyTorch port of ``repro.models.api``).

The port serves the decoder-only transformers, the ``dense`` and ``moe``
families, through ``init``, ``prefill``, ``init_cache`` and
``decode_step``; ``get_model`` raises for the SSM, hybrid and
encoder-decoder families, whose model code is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda",
             dtype=L.PARAM_DTYPE):
        return transformer.init_params(self.cfg, generator, device, dtype)

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_seq, device)

    def prefill(self, params, batch):
        return transformer.prefill(self.cfg, params, batch["tokens"])

    def decode_step(self, params, cache, tokens):
        return transformer.decode_step(self.cfg, params, cache, tokens)


def get_model(cfg: ModelConfig) -> LM:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port serves "
            "the decoder-only transformers (dense and moe)")
    return LM(cfg)
