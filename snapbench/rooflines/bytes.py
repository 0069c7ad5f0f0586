"""Bytes that reading a batch needs, fixed by the format, whatever the
kernels do.

Each input byte is counted once and each output byte once: a cluster read
twice in a batch is resolved and read once, but written to each of its
output slots.

- Resolve. Vanilla Qcow2 consults the L2 entry of each layer from the top
  of the chain down to the layer that holds the cluster, or down the whole
  chain for a hole: 8 bytes an entry. sQemu's extended Qcow2 consults one
  entry, the top layer's, which names the layer that holds the cluster.
- Gather. A found cluster is read whole from the pool; every output
  cluster, holes included, is written whole.
- Write (a mix that writes). Each written cluster is read whole from the
  write bank, written whole into the pool, and its L2 entry written once.

In a mix that writes, a batch's reads are counted against the versions
as the reference replays them up to that batch (``batch_bytes`` given
that state). Vanilla Qcow2's resolve bytes then hang on where streaming
left each version, which the reference does not follow: where the mix
ticks maintenance they are not countable (``resolve_countable``), and a
reader gives nothing rather than a wrong share.
"""

from __future__ import annotations

import numpy as np

ENTRY_BYTES = 8
FORMATS = ("qcow2", "sqemu")


def entries_consulted(fmt: str, length, owner) -> np.ndarray:
    """L2 entries a read consults in a chain of ``length`` layers whose
    newest version of the cluster is in layer ``owner`` (-1: a hole)."""
    length, owner = np.broadcast_arrays(np.asarray(length, np.int64),
                                        np.asarray(owner, np.int64))
    if fmt == "qcow2":
        return np.where(owner >= 0, length - owner, length)
    if fmt == "sqemu":
        return np.ones_like(owner)
    raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")


def resolve_bytes(fmt: str, length, owner) -> np.ndarray:
    return ENTRY_BYTES * entries_consulted(fmt, length, owner)


def gather_bytes(found: int, outputs: int, cluster_bytes: int) -> int:
    """Bytes of a gather that reads ``found`` clusters and writes ``outputs``."""
    return (found + outputs) * cluster_bytes


def write_bytes(writes, cluster_bytes: int):
    """Bytes that ``writes`` cluster writes need."""
    return writes * (2 * cluster_bytes + ENTRY_BYTES)


def resolve_countable(fmt: str, mix: dict) -> bool:
    """Whether the resolve bytes of a mix's reads follow from the
    reference's versions: not on vanilla Qcow2 where streaming moves them."""
    return not (fmt == "qcow2" and mix.get("maintenance") is not None)


def batch_bytes(fmt: str, ids: np.ndarray, version: np.ndarray,
                lengths: np.ndarray, cluster_bytes: int):
    """``(resolve, gather)`` bytes of each batch of ``ids`` (..., T, B):
    ``version`` (T, clusters) is the layer of each cluster's newest version
    (-1 a hole), ``lengths`` (T,) the chain lengths."""
    ids = np.sort(np.asarray(ids, np.int64), axis=-1)
    first = np.ones(ids.shape, bool)
    first[..., 1:] = ids[..., 1:] != ids[..., :-1]
    t = np.arange(ids.shape[-2])[:, None]
    owner = version[t, ids]
    resolve = (resolve_bytes(fmt, lengths[:, None], owner) * first).sum(axis=(-2, -1))
    found = ((owner >= 0) & first).sum(axis=(-2, -1))
    outputs = ids.shape[-2] * ids.shape[-1]
    return resolve, gather_bytes(found, outputs, cluster_bytes)
