"""Content-addressed golden-chain registry: shared-prefix fork dedup
(PyTorch port of ``repro.core.golden``).

Most snapshot chains of a fleet descend from a handful of golden base
images, thousands of disks sharing one read-only ancestor. This module
makes that sharing an *accounted* state of the fleet:

* ``GoldenRegistry.register`` freezes a tenant's chain under a content hash
  built from the localized ``TenantBlob`` packing migration uses
  (``core.migrate.export_tenant``), so two tenants holding bit-identical
  chains hash to the same golden id whatever their pool rows. Pure
  bookkeeping: no copy.
* ``GoldenRegistry.fork`` clones the frozen chain into a destination slot,
  optionally truncated to a shallower ``depth``, and opens a fresh active
  volume on top. The fork's lower layers alias the owner's pool rows by
  design; per-layer refcounts record which layers each live fork pins.
* The maintenance plane honours the pins: ``free_tenant`` refuses to drop a
  registered owner (and releases forks), ``stream_tenants``/``compact``/
  ``demote_tenants`` skip owners and treat pinned rows as immovable.
* ``core.invariants.check_fleet_invariants`` takes the registry and allows
  cross-tenant aliasing exactly on a fork's pinned golden rows.

The owner's chain must stay bit-frozen while registered: writes, snapshots
and maintenance repacks change its migration fingerprint, and
``GoldenRegistry.check``/``fork`` fail loudly on a mismatch.

``PrefixTrie`` is the serving-plane half: a path-compressed lookup keyed on
token ids, mapping prompt prefixes to registered golden sequences, so
``Engine.add_request`` forks the deepest match and prefills only the
suffix.

Port notes: the fleet ops update the fleet in place, so ``fork`` does too
and returns the same fleet. Content hashes cover the same bytes in the
same order as the JAX package's (the blob's ``uint32`` words and its page
bytes), so a chain hashes identically in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core import fleet as fleet_lib
from repro_torch.core import migrate


def _blob_layer_hashes(blob) -> tuple[str, ...]:
    """Cumulative per-layer content hashes of an exported chain.

    Layer ``i``'s digest covers layers ``[0, i]``: the localized L1/L2
    words plus the bytes of every hot page those layers reference, in
    blob-local (layout-free) order. Two chains agree on ``hashes[i]`` iff
    their first ``i + 1`` layers are guest-visibly identical, so the last
    entry is the chain's content address.
    """
    hotm, _ = migrate.entry_masks(blob.l2)
    ptrs = migrate.entry_ptrs(blob.l2)
    h = hashlib.sha256()
    out = []
    for i in range(blob.length):
        h.update(np.asarray(blob.l1[i]).tobytes())
        h.update(np.asarray(blob.l2[i]).tobytes())
        h.update(blob.hot_pages[np.unique(ptrs[i][hotm[i]])].tobytes())
        out.append(h.hexdigest())
    return tuple(out)


@dataclasses.dataclass
class GoldenChain:
    """One registered golden base: a frozen tenant chain plus the pins live
    forks hold on it. ``layer_refs[i]`` counts forks whose depth covers
    layer ``i`` (a depth-``d`` fork pins layers ``[0, d)``), so
    ``layer_refs[0]`` is the total live-fork count."""

    gid: int
    tenant: int
    length: int
    layer_hashes: tuple[str, ...]   # cumulative content hash per layer
    cum_rows: tuple[np.ndarray, ...]  # device rows pinned up to each depth
    layer_refs: np.ndarray          # (length,) int64 live-fork pins
    fingerprint: str                # migrate.tenant_fingerprint at register

    @property
    def content_hash(self) -> str:
        return self.layer_hashes[-1]

    @property
    def rows(self) -> np.ndarray:
        """Every device row the frozen chain references (sorted)."""
        return self.cum_rows[-1]

    @property
    def fork_count(self) -> int:
        return int(self.layer_refs[0]) if self.length else 0


class GoldenRegistry:
    """Fleet-side registry of golden chains and the forks pinning them.

    Host-side bookkeeping only: the registry never owns fleet state; it is
    threaded through the lifecycle/maintenance ops (``free_tenant``,
    ``stream_tenants``, ``compact``, ``demote_tenants``, the scheduler),
    which consult it before touching a registered owner or a pinned row.
    """

    def __init__(self) -> None:
        self._chains: dict[int, GoldenChain] = {}
        self._by_hash: dict[str, int] = {}
        self._owners: dict[int, int] = {}           # tenant -> gid
        self._forks: dict[int, tuple[int, int]] = {}  # tenant -> (gid, depth)
        self._next_gid = 0

    # -- registration ------------------------------------------------------

    def register(self, fleet, t: int, *, store=None) -> tuple[int, bool]:
        """Freeze tenant ``t``'s chain as a golden base.

        Returns ``(gid, created)``. Content-addressed: if an already
        registered chain hashes identically, its gid is returned with
        ``created=False`` and ``t`` is *not* recorded: the caller keeps (or
        frees) its duplicate and forks off the existing base.

        The tenant must be fully device-resident (``cold_count == 0``): a
        golden layer must stay hot, and registering it is what keeps
        demotion away from it afterwards. Promote first if needed.
        """
        t = int(t)
        if t in self._forks:
            raise ValueError(
                f"tenant {t} is a golden fork; it aliases another chain's "
                "rows and cannot itself be registered"
            )
        if t in self._owners:
            return self._owners[t], False
        if int(fleet.cold_count[t]) > 0:
            raise ValueError(
                f"tenant {t} holds host-tier rows; promote_tenants before "
                "registering (golden layers must stay device-resident)"
            )
        blob = migrate.export_tenant(fleet, t, store=store)
        hashes = _blob_layer_hashes(blob)
        gid = self._by_hash.get(hashes[-1])
        if gid is not None:
            return gid, False

        # rows pinned per depth: a depth-d fork aliases every device row
        # layers [0, d) reference
        entries = fleet.l2[t, : blob.length].cpu().numpy().view(np.uint32)
        hotm, _ = migrate.entry_masks(entries)
        ptrs = migrate.entry_ptrs(entries)
        cum, seen = [], np.zeros(0, np.int64)
        for i in range(blob.length):
            seen = np.union1d(seen, ptrs[i][hotm[i]])
            cum.append(seen)

        gid = self._next_gid
        self._next_gid += 1
        self._chains[gid] = GoldenChain(
            gid=gid,
            tenant=t,
            length=blob.length,
            layer_hashes=hashes,
            cum_rows=tuple(cum),
            layer_refs=np.zeros(blob.length, np.int64),
            fingerprint=blob.fingerprint,
        )
        self._by_hash[hashes[-1]] = gid
        self._owners[t] = gid
        return gid, True

    def unregister(self, gid: int) -> None:
        """Drop a golden chain with no live forks; the owner tenant becomes
        an ordinary (writable, demotable, freeable) tenant."""
        ch = self._chain(gid)
        if ch.fork_count:
            raise ValueError(
                f"golden chain {gid} has {ch.fork_count} live forks; "
                "free them before unregistering"
            )
        del self._chains[gid]
        del self._by_hash[ch.content_hash]
        del self._owners[ch.tenant]

    # -- fork / release ----------------------------------------------------

    def fork(self, fleet, gid: int, dst: int, *, depth: int | None = None,
             store=None):
        """Fork golden chain ``gid`` into tenant slot ``dst``: clone the
        frozen chain (optionally truncated to its first ``depth`` layers),
        open a fresh active volume on top, and pin the shared layers.
        Updates the fleet in place and returns it.

        The destination slot is reset first (``free_tenant``: pass
        ``store`` if it holds cold rows). No page data moves: the fork's
        lower layers alias the owner's pool rows under the registry's
        refcounts.
        """
        ch = self._chain(gid)
        depth = ch.length if depth is None else int(depth)
        if not 1 <= depth <= ch.length:
            raise ValueError(
                f"fork depth {depth} outside [1, {ch.length}] for golden "
                f"chain {gid}"
            )
        dst = int(dst)
        if dst == ch.tenant or dst in self._owners or dst in self._forks:
            raise ValueError(
                f"tenant slot {dst} is a registered golden owner or fork; "
                "pick a free slot"
            )
        if depth + 1 > fleet.spec.max_chain:
            raise ValueError(
                f"a depth-{depth} fork needs chain room for its active "
                f"volume (max_chain={fleet.spec.max_chain}); grow the "
                "fleet geometry first"
            )
        if migrate.tenant_fingerprint(fleet, ch.tenant) != ch.fingerprint:
            raise RuntimeError(
                f"golden chain {gid}: owner tenant {ch.tenant} changed "
                "since registration — the frozen base was written, "
                "snapshotted or repacked; registry state is corrupt"
            )
        fleet = fleet_lib.free_tenant(fleet, dst, store=store, registry=self)
        fleet = fleet_lib.clone_tenant(fleet, ch.tenant, dst)
        fleet.l1[dst, depth:] = 0
        fleet.l2[dst, depth:] = 0
        if bool(fleet.scalable[dst]):
            # scalable (copy-forward) format: the fresh active volume is a
            # copy of the fork-point table, exactly as ``snapshot`` builds it
            fleet.l1[dst, depth] = fleet.l1[dst, depth - 1]
            fleet.l2[dst, depth] = fleet.l2[dst, depth - 1]
        fleet.length[dst] = depth + 1
        ch.layer_refs[:depth] += 1
        self._forks[dst] = (gid, depth)
        return fleet

    def release(self, t: int) -> int:
        """Drop tenant ``t``'s pin on its golden base (the fork is being
        freed or migrated away). Returns the gid it pinned."""
        gid, depth = self._forks.pop(int(t))
        self._chains[gid].layer_refs[:depth] -= 1
        return gid

    # -- queries (consulted by the lifecycle/maintenance ops) --------------

    def _chain(self, gid: int) -> GoldenChain:
        if gid not in self._chains:
            raise KeyError(f"unknown golden chain id {gid}")
        return self._chains[gid]

    def lookup(self, content_hash: str) -> int | None:
        """gid registered under ``content_hash``, or None."""
        return self._by_hash.get(content_hash)

    def is_golden_owner(self, t: int) -> bool:
        return int(t) in self._owners

    def is_fork(self, t: int) -> bool:
        return int(t) in self._forks

    def gid_of(self, t: int) -> int | None:
        """gid tenant ``t`` owns or pins, or None."""
        t = int(t)
        if t in self._owners:
            return self._owners[t]
        if t in self._forks:
            return self._forks[t][0]
        return None

    def golden_owner_mask(self, n_tenants: int) -> np.ndarray:
        """(T,) bool: tenants whose chains are frozen golden bases."""
        mask = np.zeros(n_tenants, bool)
        if self._owners:
            mask[list(self._owners)] = True
        return mask

    def pinned_rows(self) -> np.ndarray:
        """Every device row some registered chain freezes (sorted). The
        maintenance plane treats these as immovable: excluded from repack
        relocation and from demotion picks while registered."""
        if not self._chains:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(
            [ch.rows for ch in self._chains.values()]
        ))

    def shared_rows_for(self, t: int) -> np.ndarray | None:
        """Rows tenant ``t`` legally aliases: the pinned rows of the golden
        layers it forked (None if ``t`` is not a fork)."""
        rec = self._forks.get(int(t))
        if rec is None:
            return None
        gid, depth = rec
        return self._chains[gid].cum_rows[depth - 1]

    def stats(self) -> dict:
        """Registry-level dedup accounting. ``dedup_rows_saved`` is the
        device rows forks alias instead of copying: the capacity the golden
        plane returns to the pool."""
        saved = sum(
            int(self._chains[gid].cum_rows[depth - 1].size)
            for gid, depth in self._forks.values()
        )
        return dict(
            golden_chains=len(self._chains),
            golden_forks=len(self._forks),
            golden_rows_pinned=int(self.pinned_rows().size),
            dedup_rows_saved=saved,
        )

    # -- self-check (run from core.invariants) -----------------------------

    def check(self, fl) -> None:
        """Assert registry/fleet agreement: frozen owners unchanged, pinned
        rows still inside their owner's leases, per-layer pins consistent
        with the recorded forks."""
        q = fl.spec.lease_quantum
        owner = fl.lease_owner.cpu().numpy()
        want_refs = {gid: np.zeros(ch.length, np.int64)
                     for gid, ch in self._chains.items()}
        for t, (gid, depth) in self._forks.items():
            assert gid in self._chains, \
                f"fork tenant {t} pins unknown golden chain {gid}"
            want_refs[gid][:depth] += 1
        for gid, ch in self._chains.items():
            assert self._owners.get(ch.tenant) == gid, \
                f"golden chain {gid} owner bookkeeping drifted"
            fp = migrate.tenant_fingerprint(fl, ch.tenant)
            assert fp == ch.fingerprint, (
                f"golden chain {gid}: owner tenant {ch.tenant} mutated "
                "while registered (write/snapshot/repack on a frozen base)"
            )
            assert np.array_equal(ch.layer_refs, want_refs[gid]), (
                f"golden chain {gid}: layer refcounts "
                f"{ch.layer_refs.tolist()} disagree with live forks"
            )
            if ch.rows.size:
                assert (owner[ch.rows // q] == ch.tenant).all(), (
                    f"golden chain {gid}: pinned rows left owner tenant "
                    f"{ch.tenant}'s leases"
                )


# -- serving-plane prefix lookup ---------------------------------------------


class _TrieNode:
    __slots__ = ("edges", "value")

    def __init__(self) -> None:
        self.edges: dict[int, tuple[tuple[int, ...], _TrieNode]] = {}
        self.value: object | None = None


class PrefixTrie:
    """Radix-style (path-compressed) prefix lookup over token ids.

    Maps registered token sequences to an opaque value (the serving plane
    stores the golden sequence id). ``longest_prefix`` returns the deepest
    *registered* sequence that prefixes a query: admission forks that
    golden chain and prefills only the suffix. Edges are compressed token
    runs, so lookup cost scales with the number of distinct branch points,
    not prompt length times fanout.
    """

    def __init__(self) -> None:
        self._root = _TrieNode()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def insert(self, tokens, value) -> None:
        """Register ``tokens`` (non-empty int sequence) -> ``value``."""
        key = tuple(int(t) for t in tokens)
        if not key:
            raise ValueError("cannot register an empty token sequence")
        node, i = self._root, 0
        while i < len(key):
            edge = node.edges.get(key[i])
            if edge is None:
                leaf = _TrieNode()
                node.edges[key[i]] = (key[i:], leaf)
                node, i = leaf, len(key)
                continue
            run, child = edge
            common = _common_len(run, key[i:])
            if common == len(run):
                node, i = child, i + common
                continue
            # split the edge at the divergence point
            mid = _TrieNode()
            mid.edges[run[common]] = (run[common:], child)
            node.edges[key[i]] = (run[:common], mid)
            node, i = mid, i + common
        if node.value is not None and node.value != value:
            raise ValueError("token sequence already registered")
        if node.value is None:
            self._len += 1
        node.value = value

    def longest_prefix(self, tokens):
        """Deepest registered sequence prefixing ``tokens``:
        ``(match_len, value)`` or ``(0, None)``."""
        key = tuple(int(t) for t in tokens)
        node, i = self._root, 0
        best_len, best_val = 0, None
        while i < len(key):
            edge = node.edges.get(key[i])
            if edge is None:
                break
            run, child = edge
            if _common_len(run, key[i:]) < len(run):
                break
            node, i = child, i + len(run)
            if node.value is not None:
                best_len, best_val = i, node.value
        return best_len, best_val

    def remove(self, tokens) -> None:
        """Unregister ``tokens`` (must be registered). Emptied leaves are
        pruned; single-child pass-through nodes are left (harmless for
        lookup correctness)."""
        key = tuple(int(t) for t in tokens)
        path: list[tuple[_TrieNode, int]] = []
        node, i = self._root, 0
        while i < len(key):
            edge = node.edges.get(key[i])
            if edge is None:
                raise KeyError("token sequence not registered")
            run, child = edge
            if key[i:i + len(run)] != run:
                raise KeyError("token sequence not registered")
            path.append((node, key[i]))
            node, i = child, i + len(run)
        if node.value is None:
            raise KeyError("token sequence not registered")
        node.value = None
        self._len -= 1
        while path and node.value is None and not node.edges:
            parent, tok = path.pop()
            del parent.edges[tok]
            node = parent


def _common_len(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n
