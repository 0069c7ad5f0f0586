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
        hit = np.flatnonzero(ver >= 0)
        if hit.size:
            t, l, c = (torch.as_tensor(x[hit], device=device)
                       for x in (tenants, ver, clusters))
            out[torch.as_tensor(hit, device=device)] = datagen.page_data(
                self.seed, t, l, c, self.page_floats, dtype)
        return out

    def wrong_clusters(self, tenants, clusters, got: torch.Tensor) -> int:
        """How many of the read clusters ``got`` (N, page_floats) differ
        from the newest version in any bit; compared ``BLOCK`` at a time."""
        tenants = np.asarray(tenants).reshape(-1)
        clusters = np.asarray(clusters).reshape(-1)
        got = got.reshape(len(tenants), self.page_floats)
        wrong = 0
        for lo in range(0, len(tenants), BLOCK):
            want = self.expected(tenants[lo:lo + BLOCK], clusters[lo:lo + BLOCK],
                                 got.device)
            have = got[lo:lo + BLOCK].contiguous()
            wrong += int((have.view(torch.int32) != want.view(torch.int32))
                         .any(dim=1).sum())
            del want, have
        return wrong


REFERENCE = CowChainReference
