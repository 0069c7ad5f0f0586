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

A mix may also write, snapshot and tick maintenance; where these fields
are absent, a batch is the read alone, as above:

- ``writes_per_tenant`` (W): clusters each disk updates a batch, drawn by
  the mix's ``kind`` and ``over`` from a stream of the seed that the read
  ids do not use, unique within a disk's batch (a repeat is drawn again).
  The ring of write ids (``make_write_ring``) has as many batches as the
  ring of reads, and batch i writes row ``i % ring_batches`` of it;
- ``snapshot_every`` (N): every N-th batch (batch i where ``(i + 1) % N
  == 0``) snapshots every disk first;
- ``maintenance``: the keyword arguments of the port's
  ``MaintenanceScheduler``, ticked once a batch after its read, as
  ``{"stream_chain_threshold": 30, "max_tenants_per_tick": 1}``.

Batches are numbered from the first warm-up batch on, through the window
and the traced batches alike. One batch runs in this order: the snapshot
if due, then the writes, then the reads, then the tick. So a read of a
cluster written in its own batch returns that batch's version.
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
    return _ring(mix, cfg, reference, datagen.rng_for(seed, 2),
                 mix["reads_per_tenant"])


def make_write_ring(mix: dict, cfg: dict, reference, seed: int) -> np.ndarray | None:
    """The clusters each batch writes: ``(ring_batches, T,
    writes_per_tenant)`` int32, unique within each disk's batch; ``None``
    for a mix that does not write."""
    w = mix.get("writes_per_tenant", 0)
    if not w:
        return None
    rng = datagen.rng_for(seed, 4)
    ring = _ring(mix, cfg, reference, rng, w)
    for i in range(cfg["tenants"]):
        items = _items(mix, reference, i, cfg["disk_clusters"])
        if len(items) < w:
            raise ValueError(f"disk {i} has {len(items)} clusters to write, "
                             f"fewer than writes_per_tenant {w}")
        rows = ring[:, i]
        while True:
            order = np.argsort(rows, axis=1, kind="stable")
            srt = np.take_along_axis(rows, order, axis=1)
            dup = np.zeros(rows.shape, bool)
            dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
            if not dup.any():
                break
            # a repeat, not its first occurrence, is drawn again (only a
            # Zipfian row repeats: a sequential one is W consecutive items)
            again = np.zeros(rows.shape, bool)
            np.put_along_axis(again, order, dup, axis=1)
            rows[again] = items[fnv_hash64(zipf_ranks(rng, int(again.sum())))
                                % len(items)]
    return ring


def snapshot_due(mix: dict, batch: int) -> bool:
    """Whether batch ``batch`` (counted from the first warm-up batch)
    snapshots every disk first."""
    n = mix.get("snapshot_every", 0)
    return bool(n) and (batch + 1) % n == 0


def _ring(mix: dict, cfg: dict, reference, rng: np.random.Generator, b: int) -> np.ndarray:
    r = mix["ring_batches"]
    t, p = cfg["tenants"], cfg["disk_clusters"]
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
