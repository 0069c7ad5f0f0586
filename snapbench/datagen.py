"""The benchmark's inputs, made from ``--seed``: cluster contents and the
write schedule that grows each tenant's snapshot chain.

A cluster version's bytes are a pure function of ``(seed, tenant, layer,
cluster)``, computed with plain integer ops on whatever device holds the
tensors. Set-up writes them into the program's fleet on the card, and the
plain reference works the same bytes out again for the clusters it checks,
so no second copy of the fleet's data is ever held.

Every value is a float32 in [1, 2) with 23 mixed mantissa bits: a hole
(+0.0) never looks like data, and a copy that passed through bfloat16
(8 mantissa bits) differs from it.

A mix that writes draws its payloads from a bank of ``(T, W)`` rows made
once in set-up, row ``(tenant, slot)`` being ``page_data`` under the
layer key ``BANK_LAYER``, which no set-up version uses. Before each batch
the harness stamps two floats of every row (``stamp``): float 0 the
batch's index, float 1 the cluster the row is written to. So the version
a batch writes into a cluster is a pure function of ``(seed, tenant,
slot, batch, cluster)`` (``written_data``), distinct from every other
version of that cluster, and a write that lands in another cluster or
another disk, or never lands, reads back wrong.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: multipliers below 2**31, so a product of a 32-bit value stays inside int64
_M1, _M2, _M3 = 0x7FEB352D, 0x2C1B3C6D, 0x297A2D39
_GOLDEN = 0x9E3779B1 & 0x7FFFFFFF
_ONE_BITS = 0x3F800000          # float32 1.0
_MANTISSA = 0x007FFFFF
#: int64 temporaries a chunk of ``page_data`` holds at most (256 MiB each)
CHUNK_ELEMENTS = 1 << 25


def _mix(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix of int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * _M1) & MASK32
    h = h ^ (h >> 15)
    h = (h * _M2) & MASK32
    h = h ^ (h >> 16)
    h = (h * _M3) & MASK32
    return h ^ (h >> 13)


def seed_words(seed: int) -> tuple[int, int]:
    """The low and high 32-bit words of a seed (any integer; reduced mod 2**64)."""
    s = int(seed) % (1 << 64)
    return s & MASK32, (s >> 32) & MASK32


def _seed_key(seed: int) -> int:
    lo, hi = (torch.tensor(w, dtype=torch.int64) for w in seed_words(seed))
    return int(_mix(lo ^ _mix(hi)))


def cluster_keys(seed: int, tenant, layer, cluster) -> torch.Tensor:
    """One 32-bit key per cluster version (int64 tensor of the broadcast
    shape, on ``cluster``'s device)."""
    cluster = torch.as_tensor(cluster).to(torch.int64)
    tenant, layer = (torch.as_tensor(x, device=cluster.device).to(torch.int64)
                     for x in (tenant, layer))
    k = _mix(_seed_key(seed) ^ (tenant & MASK32))
    k = _mix(k ^ (layer & MASK32))
    return _mix(k ^ (cluster & MASK32))


def page_data(seed: int, tenant, layer, cluster, page_floats: int,
              dtype=torch.float32) -> torch.Tensor:
    """The bytes of cluster versions: ``(*shape, page_floats)`` float32 (or
    rounded to ``dtype`` and back, which the control uses), where ``shape``
    is the broadcast shape of ``tenant``, ``layer`` and ``cluster`` and the
    device is ``cluster``'s."""
    keys = cluster_keys(seed, tenant, layer, cluster)
    shape = keys.shape
    keys = keys.reshape(-1)
    out = torch.empty((keys.numel(), page_floats), dtype=torch.float32,
                      device=keys.device)
    col = (torch.arange(page_floats, dtype=torch.int64, device=keys.device)
           * _GOLDEN) & MASK32
    rows = max(1, CHUNK_ELEMENTS // page_floats)
    for lo in range(0, keys.numel(), rows):
        h = _mix(keys[lo:lo + rows, None] ^ col[None, :])
        bits = ((h & _MANTISSA) | _ONE_BITS).to(torch.int32)
        out[lo:lo + rows] = bits.view(torch.float32)
        del h, bits
    if dtype != torch.float32:
        out = out.to(dtype).to(torch.float32)
    return out.reshape(*shape, page_floats)


#: the layer key of the write bank's rows: above any chain a fleet holds
BANK_LAYER = MASK32
#: a stamp holds a batch index or a cluster id below this
STAMP_LIMIT = 1 << 23


def stamp(x) -> torch.Tensor:
    """The float32 in [1, 2) whose 23 mantissa bits are ``x`` (int tensor
    or int, each below ``STAMP_LIMIT``)."""
    x = torch.as_tensor(x).to(torch.int32)
    return ((x & _MANTISSA) | _ONE_BITS).view(torch.float32)


def bank_data(seed: int, tenant, slot, page_floats: int, dtype=torch.float32):
    """The write bank's rows before stamping (``page_data`` of ``BANK_LAYER``)."""
    return page_data(seed, tenant, BANK_LAYER, slot, page_floats, dtype)


def written_data(seed: int, tenant, slot, batch, cluster, page_floats: int,
                 dtype=torch.float32) -> torch.Tensor:
    """The version batch ``batch`` wrote into ``cluster`` from bank row
    ``(tenant, slot)``: ``(N, page_floats)`` float32 for 1-d tensors of N
    on one device (rounded through ``dtype``, as ``page_data``)."""
    out = bank_data(seed, tenant, slot, page_floats)
    out[:, 0] = stamp(batch)
    out[:, 1] = stamp(cluster)
    if dtype != torch.float32:
        out = out.to(dtype).to(torch.float32)
    return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How set-up grows the fleet, shared by the program and the reference.

    ``targets`` (T,): each tenant's final chain length. ``base`` (T,
    n_base): the clusters written into layer 0. ``layers`` (L - 1, T, W):
    the clusters written into layer ``l`` (row ``l - 1``) by every tenant
    whose target exceeds ``l``, after its snapshot to that layer.
    """

    targets: np.ndarray
    base: np.ndarray
    layers: np.ndarray


def chain_targets(tenants: int, max_depth: int) -> np.ndarray:
    """Tenant t's chain length: 1 + floor((max_depth - 1) t / (T - 1))."""
    t = np.arange(tenants, dtype=np.int64)
    return (1 + (max_depth - 1) * t // max(tenants - 1, 1)).astype(np.int32)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of the seed."""
    return np.random.default_rng([*seed_words(seed), stream])


def write_schedule(cfg: dict, seed: int) -> Schedule:
    """The seed's base fill and per-layer writes for a configuration."""
    t, p = cfg["tenants"], cfg["disk_clusters"]
    n_base = int(round(cfg["base_fill"] * p))
    w = cfg["layer_writes"]
    depth = cfg["chain_length"]
    rng = rng_for(seed, 1)
    base = np.argsort(rng.random((t, p)), axis=1)[:, :n_base].astype(np.int32)
    layers = rng.integers(0, p, size=(max(depth - 1, 0), t, w), dtype=np.int64)
    # a write batch holds distinct clusters: draw again where a row repeats
    while True:
        srt = np.sort(layers, axis=2)
        dup = (srt[..., 1:] == srt[..., :-1]).any(axis=2)
        if not dup.any():
            break
        layers[dup] = rng.integers(0, p, size=(int(dup.sum()), w))
    return Schedule(chain_targets(t, depth), base, layers.astype(np.int32))
