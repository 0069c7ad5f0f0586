"""Deterministic synthetic data pipeline (PyTorch port of
``repro.data.pipeline``).

``batch_at(step)`` is a pure function of (seed, step) — any worker can
reproduce any batch, which is what makes checkpoint/restart and elastic
re-slicing trivial: the pipeline "state" is just the step counter, carried
inside the checkpointed training state. Per-host sharding slices the
global batch by process index.

The tokens are the JAX package's bit for bit: they are drawn with the
port's own copy of JAX's Threefry-2x32 (``data._threefry``) in numpy on
the host, where the batches are small, and moved to the device at the
end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import _threefry as tf
from repro_torch.device import as_device

#: the lcg pattern's recurrence t_{i+1} = (A·t_i + C) mod V
LCG_A, LCG_C = 31, 17


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern: str = "lcg"   # "lcg" (learnable recurrence) | "uniform"
    n_processes: int = 1
    process_index: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_processes:
            raise ValueError(f"global_batch {self.global_batch} does not split "
                             f"over {self.n_processes} processes")
        return self.global_batch // self.n_processes


def lcg_tokens(start, noise, keep, vocab_size: int) -> np.ndarray:
    """The lcg pattern's tokens: row b starts at ``start[b]``, and each next
    token is ``(A·t + C) mod V`` where ``keep`` holds, else ``noise``.
    ``start`` (B,), ``noise`` and ``keep`` (B, S) → (B, S) int32; the loop
    runs over the sequence, a vector over the batch."""
    b, s = noise.shape
    out = np.empty((b, s), np.int64)
    tok = start.astype(np.int64)
    out[:, 0] = tok
    for i in range(s - 1):
        tok = np.where(keep[:, i], (LCG_A * tok + LCG_C) % vocab_size, noise[:, i])
        out[:, i + 1] = tok
    return out.astype(np.int32)


def batch_at(cfg: DataConfig, step: int, *, with_frames: int = 0,
             d_model: int = 0, device="cuda"):
    """Global batch for ``step``, sliced to this process: ``tokens`` and
    ``labels`` (tokens rolled left by one), (local_batch, seq_len) int32 on
    ``device``.

    Tokens follow a noisy affine recurrence (``pattern="lcg"``):
    ``t_{i+1} = (a·t_i + c) mod V`` with probability 0.9, uniform noise
    otherwise — *learnable* structure, so example training curves actually
    descend below the uniform-entropy floor. ``pattern="uniform"`` gives
    pure iid tokens (benchmarks). ``with_frames`` (the encoder-decoder
    family's stub frames) raises: that family is not ported."""
    if with_frames:
        raise NotImplementedError(
            "with_frames feeds the encoder-decoder family, whose model code "
            "(models/encdec.py) is not ported yet")
    dev = as_device(device)
    key = tf.fold_in(tf.prng_key(cfg.seed), step)
    kt, _ = tf.split(key)
    shape = (cfg.global_batch, cfg.seq_len)
    if cfg.pattern == "uniform":
        tokens = tf.randint(kt, shape, 0, cfg.vocab_size)
    elif cfg.pattern == "lcg":
        k0, kn, km = tf.split(kt, 3)
        start = tf.randint(k0, (cfg.global_batch,), 0, cfg.vocab_size)
        noise = tf.randint(kn, shape, 0, cfg.vocab_size)
        keep = tf.uniform(km, shape) < np.float32(0.9)
        tokens = lcg_tokens(start, noise, keep, cfg.vocab_size)
    else:
        raise ValueError(f"unknown pattern {cfg.pattern!r}")
    lo = cfg.process_index * cfg.local_batch
    tokens = tokens[lo:lo + cfg.local_batch]
    return dict(tokens=torch.from_numpy(tokens).to(dev),
                labels=torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev))
