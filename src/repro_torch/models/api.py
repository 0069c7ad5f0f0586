"""Uniform LM interface (PyTorch port of ``repro.models.api``).

The port serves and trains the decoder-only transformers, the ``dense``
and ``moe`` families, through ``init``, ``loss``, ``prefill``,
``init_cache`` and ``decode_step``; ``get_model`` raises for the SSM,
hybrid and encoder-decoder families, whose model code is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import _threefry as tf
from repro_torch.device import as_device
from repro_torch.models import layers as L
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda",
             dtype=L.PARAM_DTYPE):
        return transformer.init_params(self.cfg, generator, device, dtype)

    def loss(self, params, batch):
        return transformer.loss_fn(self.cfg, params, batch["tokens"],
                                   batch["labels"])

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


def make_batch(cfg: ModelConfig, seed: int, batch: int, seq: int,
               device="cuda") -> dict[str, Any]:
    """A concrete random batch (smoke tests, examples): ``tokens`` (batch,
    seq) int32 uniform over the vocabulary and ``labels`` (tokens rolled
    left by one), the tokens of the JAX package's ``make_batch`` under
    ``PRNGKey(seed)``."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family (frames) is not ported yet")
    kt, _ = tf.split(tf.prng_key(seed))
    tokens = tf.randint(kt, (batch, seq), 0, cfg.vocab_size)
    dev = as_device(device)
    return dict(tokens=torch.from_numpy(tokens).to(dev),
                labels=torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))
