"""Uniform LM interface over every architecture family (PyTorch port of
``repro.models.api``).

Every family exposes the same five entry points, so train and serve code
is architecture-agnostic:

* ``init(generator) -> params`` (``init_shapes()``: the tree on ``meta``)
* ``loss(params, batch) -> scalar``          (batch: tokens/labels[/frames])
* ``init_cache(batch, max_seq) -> cache``
* ``prefill(params, batch) -> (logits, cache)``
* ``decode_step(params, cache, tokens) -> (logits, cache)``

The families: ``dense`` and ``moe`` (``transformer``), ``ssm`` (RWKV-6),
``hybrid`` (Zamba2: Mamba2 and a shared attention block) and ``encdec``
(Whisper, whose batches carry ``frames``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import _threefry as tf
from repro_torch.device import as_device
from repro_torch.models import encdec, hybrid, rwkv6, transformer
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda",
             dtype=L.PARAM_DTYPE):
        return _mod(self.cfg).init_params(self.cfg, generator, device, dtype)

    def init_shapes(self, dtype=L.PARAM_DTYPE):
        """The parameter tree on the ``meta`` device: every leaf's shape
        and dtype with no allocation and no random draw (the JAX
        package's ``jax.eval_shape`` of ``init``)."""
        return self.init(torch.Generator(), device="meta", dtype=dtype)

    def loss(self, params, batch):
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                                  batch["frames"])
        return _mod(cfg).loss_fn(cfg, params, batch["tokens"], batch["labels"])

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        return _mod(self.cfg).init_cache(self.cfg, batch, max_seq, device)

    def prefill(self, params, batch):
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.prefill(cfg, params, batch["tokens"], batch["frames"])
        return _mod(cfg).prefill(cfg, params, batch["tokens"])

    def decode_step(self, params, cache, tokens):
        return _mod(self.cfg).decode_step(self.cfg, params, cache, tokens)


def _mod(cfg: ModelConfig):
    return {
        "dense": transformer,
        "moe": transformer,
        "encdec": encdec,
        "ssm": rwkv6,
        "hybrid": hybrid,
    }[cfg.family]


def get_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def make_batch(cfg: ModelConfig, seed: int, batch: int, seq: int,
               device="cuda") -> dict[str, Any]:
    """A concrete random batch (smoke tests, examples), the JAX package's
    ``make_batch`` under ``PRNGKey(seed)`` bit for bit: ``tokens`` (batch,
    seq) int32 uniform over the vocabulary, ``labels`` (tokens rolled left
    by one) and, for the encoder-decoder family, ``frames`` (batch,
    enc_frames, d_model) f32 standard normal."""
    if cfg.family == "encdec" and cfg.enc_frames <= 0:
        raise ValueError(f"{cfg.name}: an encoder-decoder config needs "
                         "enc_frames > 0")
    kt, kf = tf.split(tf.prng_key(seed))
    tokens = tf.randint(kt, (batch, seq), 0, cfg.vocab_size)
    dev = as_device(device)
    out = dict(tokens=torch.from_numpy(tokens).to(dev),
               labels=torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(
            tf.normal(kf, (batch, cfg.enc_frames, cfg.d_model))).to(dev)
    return out


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *, kind: str):
    """``meta`` tensors standing in for every model input of a shape cell:
    int32 ``tokens`` (and ``labels`` to train), (batch, 1) tokens to
    decode, and the encoder-decoder's f32 ``frames`` to train or prefill."""
    meta = torch.device("meta")
    tok = torch.empty((batch, seq), dtype=torch.int32, device=meta)
    if kind == "train":
        specs = dict(tokens=tok, labels=torch.empty_like(tok))
    elif kind == "prefill":
        specs = dict(tokens=tok)
    elif kind == "decode":
        specs = dict(tokens=torch.empty((batch, 1), dtype=torch.int32,
                                        device=meta))
    else:
        raise ValueError(kind)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        specs["frames"] = torch.empty((batch, cfg.enc_frames, cfg.d_model),
                                      dtype=torch.float32, device=meta)
    return specs
