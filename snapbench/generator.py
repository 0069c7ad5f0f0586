"""The one traffic generator: reads a mix's parameters and makes a ring of
batches from the seed.

A batch is ``(T, B)`` cluster ids, ``reads_per_tenant`` for each tenant.
The window cycles through a ring of ``ring_batches`` batches made in
set-up, so every seed gives the same amount of work and no id is made
inside the window. Parameters of a mix (``traffic/<name>.json``):

- ``kind``: ``zipfian`` (YCSB's ScrambledZipfianGenerator at theta 0.99:
  a Zipfian rank over 10**10 items, FNV-hashed onto the items) or
  ``sequential`` (each tenant reads ``reads_per_tenant`` contiguous
  clusters a batch from a cursor drawn from the seed, wrapping around the
  disk);
- ``over``: ``allocated`` (each tenant's allocated clusters) or ``disk``
  (every cluster, holes included);
- ``warmup_batches`` before the window and, in a traced run,
  ``trace_warmup`` and ``trace_batches`` under the profiler.
"""

from __future__ import annotations

import numpy as np

from snapbench import datagen

#: the traffic kinds ``make_ring`` knows
KINDS = ("zipfian", "sequential")
#: YCSB's ScrambledZipfianGenerator: its constant, ITEM_COUNT and its zeta
THETA = 0.99
SCRAMBLED_ITEMS = 10_000_000_000
SCRAMBLED_ZETAN = 26.46902820178302
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def zipf_ranks(rng: np.random.Generator, size, n: int = SCRAMBLED_ITEMS,
               zetan: float = SCRAMBLED_ZETAN) -> np.ndarray:
    """YCSB ZipfianGenerator.nextLong at ``THETA`` over ranks 0..n-1 (0 the
    most popular), where ``zetan`` is the zeta of ``n`` items."""
    zeta2 = 1.0 + 0.5 ** THETA
    alpha = 1.0 / (1.0 - THETA)
    eta = (1.0 - (2.0 / n) ** (1.0 - THETA)) / (1.0 - zeta2 / zetan)
    u = rng.random(size)
    uz = u * zetan
    ret = np.floor(n * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ret = np.where(uz < zeta2, 1, ret)
    ret = np.where(uz < 1.0, 0, ret)
    return np.minimum(ret, n - 1)


def fnv_hash64(values: np.ndarray) -> np.ndarray:
    """YCSB Utils.fnvhash64: FNV-1a over the 8 low-first octets, then abs."""
    v = values.astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, np.uint64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        h *= np.uint64(FNV_PRIME_64)
        v >>= np.uint64(8)
    return np.abs(h.view(np.int64))


def _items(mix: dict, reference, tenant: int, clusters: int) -> np.ndarray:
    if mix["over"] == "allocated":
        return reference.allocated(tenant)
    if mix["over"] == "disk":
        return np.arange(clusters, dtype=np.int32)
    raise ValueError(f"unknown 'over': {mix['over']!r}")


def make_ring(mix: dict, cfg: dict, reference, seed: int) -> np.ndarray:
    """The mix's ring of batches: ``(ring_batches, T, reads_per_tenant)``
    int32 cluster ids."""
    r, b = mix["ring_batches"], mix["reads_per_tenant"]
    t, p = cfg["tenants"], cfg["disk_clusters"]
    rng = datagen.rng_for(seed, 2)
    ring = np.empty((r, t, b), np.int32)
    kind = mix["kind"]
    if kind not in KINDS:
        raise ValueError(f"unknown traffic kind {kind!r}")
    if kind == "sequential":
        cursor = rng.integers(0, p, size=t)
        for i in range(t):
            items = _items(mix, reference, i, p)
            pos = (cursor[i] + np.arange(r * b)) % len(items)
            ring[:, i] = items[pos].reshape(r, b)
        return ring
    for i in range(t):
        items = _items(mix, reference, i, p)
        idx = fnv_hash64(zipf_ranks(rng, r * b)) % len(items)
        ring[:, i] = items[idx].reshape(r, b)
    return ring
