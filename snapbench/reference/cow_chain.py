"""Plain reference of a fleet of copy-on-write snapshot chains.

The semantics, independent of the program under test: a tenant's disk is a
chain of layers; a write puts a new version of a cluster into the chain's
top layer, a snapshot freezes the top layer and opens a new one above it,
and a read returns, bit for bit, the newest version of the cluster in the
chain, or +0.0 where no layer holds it (a hole). Both formats (vanilla
Qcow2 and sQemu's extended Qcow2) give the same answers; they differ only
in how they find them.

The reference replays the seed's write schedule into one (T, clusters)
map of the layer that holds each cluster's newest version, and works the
bytes of that version out again from the seed (``datagen.page_data``). It
uses plain PyTorch and numpy, and nothing of the program.

A mix that writes is followed batch by batch: ``snapshot`` and ``write``
replay the window's snapshots and writes in the order the harness issues
them, and the newest version of a cluster written there is the one
``datagen.written_data`` makes from (seed, tenant, bank slot, batch,
cluster). Streaming and compaction never change what a read returns, so
the reference does not model them; a snapshot of a chain at
``max_chain`` is dropped, as the format's chains cannot grow past it.
Read mixes never call either, and the reference is then what it was.
"""

from __future__ import annotations

import numpy as np
import torch

from snapbench import datagen

#: clusters whose expected bytes are made at a time
BLOCK = 8_192


class CowChainReference:
    def __init__(self, cfg: dict, schedule: datagen.Schedule, seed: int):
        self.seed = seed
        self.page_floats = cfg["cluster_bytes"] // 4
        t, p = cfg["tenants"], cfg["disk_clusters"]
        ver = np.full((t, p), -1, np.int32)
        ver[np.arange(t)[:, None], schedule.base] = 0
        for layer, ids in enumerate(schedule.layers, start=1):
            live = schedule.targets > layer
            ver[np.nonzero(live)[0][:, None], ids[live]] = layer
        #: (T, clusters): layer of each cluster's newest version, -1 a hole
        self.version = ver
        self.lengths = schedule.targets.copy()
        self.max_chain = cfg["max_chain"]
        #: (T, clusters) batch and bank slot of the newest write a mix made
        #: (batch -1: none); made at the first write
        self.written = self.slot = None

    def snapshot(self):
        """Every disk snapshots: its top layer freezes, a new one opens."""
        self.lengths = np.minimum(self.lengths + 1, self.max_chain)

    def write(self, batch: int, ids: np.ndarray):
        """Batch ``batch`` writes, in each tenant's top layer, clusters
        ``ids`` (T, W), from bank slots 0..W-1."""
        if self.written is None:
            self.written = np.full(self.version.shape, -1, np.int64)
            self.slot = np.zeros(self.version.shape, np.int32)
        t = np.arange(ids.shape[0])[:, None]
        self.version[t, ids] = (self.lengths - 1)[:, None]
        self.written[t, ids] = batch
        self.slot[t, ids] = np.arange(ids.shape[1], dtype=np.int32)[None]

    def allocated(self, tenant: int) -> np.ndarray:
        """The tenant's allocated clusters, in ascending order."""
        return np.flatnonzero(self.version[tenant] >= 0).astype(np.int32)

    def expected(self, tenants, clusters, device, dtype=torch.float32):
        """(N, page_floats) float32: what reads of (tenant, cluster) pairs
        return. ``dtype`` below float32 rounds each version through it (the
        control)."""
        tenants = np.asarray(tenants, np.int64)
        clusters = np.asarray(clusters, np.int64)
        ver = self.version[tenants, clusters]
        out = torch.zeros((len(ver), self.page_floats), dtype=torch.float32,
                          device=device)
        batch = (np.full(len(ver), -1) if self.written is None
                 else self.written[tenants, clusters])
        hit = np.flatnonzero((ver >= 0) & (batch < 0))
        if hit.size:
            t, l, c = (torch.as_tensor(x[hit], device=device)
                       for x in (tenants, ver, clusters))
            out[torch.as_tensor(hit, device=device)] = datagen.page_data(
                self.seed, t, l, c, self.page_floats, dtype)
        new = np.flatnonzero(batch >= 0)
        if new.size:
            slot = self.slot[tenants, clusters]
            t, s, i, c = (torch.as_tensor(x[new], device=device)
                          for x in (tenants, slot, batch, clusters))
            out[torch.as_tensor(new, device=device)] = datagen.written_data(
                self.seed, t, s, i, c, self.page_floats, dtype)
        return out

    def mismatched(self, tenants, clusters, got: torch.Tensor) -> np.ndarray:
        """(N,) bool: which of the read clusters ``got`` (N, page_floats)
        differ from the newest version in any bit; compared ``BLOCK`` at
        a time."""
        tenants = np.asarray(tenants).reshape(-1)
        clusters = np.asarray(clusters).reshape(-1)
        got = got.reshape(len(tenants), self.page_floats)
        out = np.zeros(len(tenants), bool)
        for lo in range(0, len(tenants), BLOCK):
            want = self.expected(tenants[lo:lo + BLOCK], clusters[lo:lo + BLOCK],
                                 got.device)
            have = got[lo:lo + BLOCK].contiguous()
            out[lo:lo + BLOCK] = (have.view(torch.int32) != want.view(torch.int32)
                                  ).any(dim=1).cpu().numpy()
            del want, have
        return out

    def wrong_clusters(self, tenants, clusters, got: torch.Tensor) -> int:
        """How many of the read clusters ``got`` (N, page_floats) differ
        from the newest version in any bit."""
        return int(self.mismatched(tenants, clusters, got).sum())


REFERENCE = CowChainReference
