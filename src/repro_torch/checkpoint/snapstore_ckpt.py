"""Incremental (delta) checkpointing of a state pytree on the snapshot store
(PyTorch port of ``repro.checkpoint.snapstore_ckpt``).

Every ``save`` writes only the *dirty pages* of the flattened state into
the chain's active volume and then snapshots — a COW backing file per
checkpoint, the paper's workload (§3: daily-or-faster snapshot creation,
chains into the hundreds). ``restore`` materializes the virtual disk
through any method of ``store.materialize``:

* ``method="vanilla"`` — the O(chain) walk (vQemu restore);
* ``method="direct"``  — sQEMU direct access, O(1) per page;
* ``method="pallas_vanilla"``/``"pallas_direct"`` — the same strategies
  through the kernels: the chain is a one-tenant fleet for the resolve
  kernels (K1 / K2), then the single-chain gather kernel (K8) reads the
  pages.

Fig 17's "VM boot time" is a cold ``restore``. The provider's streaming
policy (merge beyond a threshold, default 30 — §3 Take-away 2) is
``maybe_stream``; it and the pool GC of ``save`` merge through
``store.stream`` (``plan_merge``: the streaming-merge kernel K9).

**Layout, the JAX package's word for word.** The state is a nested
dict/list/tuple of tensors. Its leaves are laid out in JAX's pytree order
(dict keys sorted, lists and tuples in order) as 32-bit words: float32,
int32 and uint32 leaves one word an element, bf16 and f16 leaves one word
a pair (low half first, an odd leaf padded with one zero element), each
word equal to JAX's ``bitcast_convert_type`` word. The pool holds the words
in the ``int32`` carrier (``core.format``; torch's ``uint32`` has no
comparisons on the CPU), so after the same saves the chain equals the JAX
checkpointer's, and ``chain.npz`` (``save_to_dir``/``load_from_dir``)
holds the same keys and numpy dtypes: a file saved by either package
loads in the other.

**Async saves.** Torch tensors change in place, so ``save_async`` flattens
the state into a fresh page image on the caller's thread before it
returns; the worker diffs and writes that image. A change made to the
state after ``save_async`` returns never reaches the checkpoint.

Restored leaves are views into one freshly materialized page image on the
chain's device: no leaf aliases the chain, the state saved or another
leaf. ``restore(shardings=)`` places each leaf by its sharding (a tree of
``distributed.sharding.NamedSharding``) as a ``DTensor`` on that mesh:
an elastic restore onto another mesh than the one that saved.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import chain as chain_lib
from repro_torch.core import format as fmt
from repro_torch.core import resolve as resolve_lib
from repro_torch.core import store as store_lib
from repro_torch.core.chain import Chain, ChainSpec
from repro_torch.device import as_device
from repro_torch.distributed import sharding
from repro_torch.tree import leaves as _leaves
from repro_torch.tree import tree_map
from repro_torch.tree import unflatten as _unflatten

#: leaf dtypes held one word an element / two elements a word
_WORD_DTYPES = (torch.float32, torch.int32, torch.uint32)
_HALF_DTYPES = (torch.bfloat16, torch.float16)

#: pages a ``store.write`` call takes at once: bounds the copies a full
#: save makes (the rows are assigned in the same order either way)
_WRITE_PAGES = 65_536


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A template leaf: shape and dtype."""

    shape: tuple
    dtype: torch.dtype

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def n_words(self) -> int:
        return -(-self.size // 2) if self.dtype in _HALF_DTYPES else self.size


def _leaf_to_words(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf as 1-D ``int32`` words (a view where no padding is needed)."""
    if leaf.dtype not in _WORD_DTYPES + _HALF_DTYPES:
        raise TypeError(f"unsupported checkpoint dtype {leaf.dtype}")
    flat = leaf.reshape(-1)
    if leaf.dtype in _HALF_DTYPES and flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat.view(torch.int32)


def _words_to_leaf(words: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
    """The inverse of ``_leaf_to_words`` on the leaf's own words: a view
    of ``words`` (a half-precision pad element dropped)."""
    return words.view(leaf.dtype)[:leaf.size].reshape(leaf.shape)


class SnapshotCheckpointer:
    """COW delta-checkpoint chain for an arbitrary state pytree, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        template: Any,
        *,
        page_size: int = 2048,
        max_chain: int = 64,
        scalable: bool = True,
        stream_threshold: int = 30,
        pool_slack: float = 4.0,
        device="cuda",
    ):
        self.template = tree_map(lambda x: _Leaf(tuple(x.shape), x.dtype),
                                 template)
        for leaf in _leaves(self.template):
            if leaf.dtype not in _WORD_DTYPES + _HALF_DTYPES:
                raise TypeError(f"unsupported checkpoint dtype {leaf.dtype}")
        self._offsets = np.cumsum(
            [0] + [x.n_words for x in _leaves(self.template)]).tolist()
        n_pages = max(1, -(-self._offsets[-1] // page_size))
        self.spec = ChainSpec(
            n_pages=_round_up(n_pages, 64),
            page_size=page_size,
            max_chain=max_chain,
            pool_capacity=int(_round_up(n_pages, 64) * pool_slack),
            dtype=torch.int32,
        )
        self.device = as_device(device)
        self.chain: Chain = chain_lib.create(self.spec, scalable=scalable,
                                             device=self.device)
        self.stream_threshold = stream_threshold
        self._shadow: Optional[torch.Tensor] = None  # last-saved page image
        self.stats: list[dict] = []
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    # -- flatten / unflatten -------------------------------------------------

    def _flatten(self, state) -> torch.Tensor:
        """A fresh (n_pages, page_size) ``int32`` page image of ``state``."""
        leaves = _leaves(state)
        want = _leaves(self.template)
        if len(leaves) != len(want):
            raise ValueError("state does not match the checkpoint template")
        words = torch.zeros(self.spec.n_pages * self.spec.page_size,
                            dtype=torch.int32, device=self.device)
        for leaf, spec, lo, hi in zip(leaves, want, self._offsets,
                                      self._offsets[1:]):
            if tuple(leaf.shape) != spec.shape or leaf.dtype != spec.dtype:
                raise ValueError(
                    f"leaf {tuple(leaf.shape)} {leaf.dtype} does not match "
                    f"the template's {spec.shape} {spec.dtype}")
            words[lo:hi] = _leaf_to_words(leaf)
        return words.view(self.spec.n_pages, self.spec.page_size)

    def _unflatten(self, pages: torch.Tensor):
        words = pages.reshape(-1)
        leaves = [_words_to_leaf(words[lo:hi], spec) for spec, lo, hi in
                  zip(_leaves(self.template), self._offsets, self._offsets[1:])]
        return _unflatten(self.template, leaves)

    # -- save / restore -------------------------------------------------------

    def save(self, state) -> dict:
        """Write dirty pages + snapshot. Returns per-save stats."""
        return self._save_pages(self._flatten(state))

    def _save_pages(self, pages: torch.Tensor) -> dict:
        spec = self.spec
        if self._shadow is None:
            ids = torch.arange(spec.n_pages, device=self.device)
        else:
            ids = torch.nonzero((pages != self._shadow).any(dim=1)).flatten()
        n = int(ids.numel())
        if n:
            if int(self.chain.pool_cursor) + n > spec.pool_capacity:
                # background GC: stream old deltas, then compact the pool
                if int(self.chain.length) > 3:
                    store_lib.stream(self.chain, int(self.chain.length) - 3,
                                     copy_data=False)
                store_lib.compact_pool(self.chain)
            for lo in range(0, n, _WRITE_PAGES):
                part = ids[lo:lo + _WRITE_PAGES]
                store_lib.write(self.chain, part, pages[part])
        store_lib.snapshot(self.chain)
        # guard after the snapshot so a drop (chain at max_chain) surfaces
        # on THIS save, before the next save overwrites the active volume
        store_lib.check_pool_capacity(self.chain)
        self._shadow = pages
        st = dict(
            pages_written=n,
            bytes_written=n * spec.page_size * 4,
            chain_length=int(self.chain.length),
        )
        self.stats.append(st)
        self.maybe_stream()
        return st

    def save_async(self, state) -> concurrent.futures.Future:
        """Non-blocking save: flattens ``state`` into a fresh page image now,
        on the caller's thread, and runs the dirty-page diff, the write and
        the snapshot on a worker thread. Returns a Future with the stats.

        The caller may change ``state`` in place as soon as this returns:
        the checkpoint holds the state as it was at submission. Saves run
        one at a time, in submission order."""
        pages = self._flatten(state)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

        def job():
            with self._lock:
                return self._save_pages(pages)

        return self._pool.submit(job)

    def restore(self, *, method: str = "direct", shardings: Any = None):
        """The last saved state, read through ``store.materialize(method)``;
        with ``shardings`` (a tree shaped like the state) each leaf placed
        by its ``NamedSharding`` as a ``DTensor``."""
        state = self._unflatten(store_lib.materialize(self.chain, method=method))
        if shardings is not None:
            state = sharding.distribute(state, shardings)
        return state

    def resolve_cost(self, method: str) -> int:
        """Total index lookups a full restore performs (Fig 17 low-level)."""
        ids = torch.arange(self.spec.n_pages, dtype=torch.int32,
                           device=self.device)
        res = resolve_lib.get_resolver(method)(self.chain, ids)
        return int(res.lookups.sum())

    # -- maintenance -----------------------------------------------------------

    def maybe_stream(self) -> bool:
        """Provider streaming policy: compact when the chain passes the
        threshold (keeps the most recent ``stream_threshold // 2`` deltas)."""
        if int(self.chain.length) <= self.stream_threshold:
            return False
        keep = max(2, self.stream_threshold // 2)
        merge_upto = int(self.chain.length) - keep - 1
        store_lib.stream(self.chain, merge_upto, copy_data=False)
        return True

    # -- durability ------------------------------------------------------------

    def save_to_dir(self, path: str) -> None:
        """Write the chain and the last-saved image as ``chain.npz``: the
        JAX package's keys and numpy dtypes (words as ``uint32``)."""
        ch = self.chain

        def u32(x):
            return x.cpu().numpy().view(np.uint32)

        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "chain.npz"),
            l1=u32(ch.l1),
            l2=u32(ch.l2),
            pool=u32(ch.pool),
            pool_cursor=ch.pool_cursor.cpu().numpy(),
            length=ch.length.cpu().numpy(),
            overflow=ch.overflow.cpu().numpy(),
            snap_dropped=ch.snap_dropped.cpu().numpy(),
            shadow=(u32(self._shadow) if self._shadow is not None
                    else np.zeros(0)),
        )

    def load_from_dir(self, path: str) -> None:
        """Load a ``chain.npz`` written by either package."""
        with np.load(os.path.join(path, "chain.npz")) as z:
            arrays = {n: z[n] for n in convert.CHAIN_FIELDS if n in z.files}
            arrays.setdefault("snap_dropped", np.zeros((), bool))
            shadow = z["shadow"]
        self.chain = convert.chain_from_numpy(
            self.spec, arrays, scalable=self.chain.scalable, device=self.device)
        self._shadow = (fmt.words(shadow, device=self.device)
                        if shadow.size else None)


def save_tenant_to_dir(fleet, t: int, path: str, *, store=None) -> None:
    """Durable per-tenant checkpoint: export tenant ``t`` as a migration
    blob and write it under ``path``.

    A tenant checkpoint and a migration share one container — the
    pointer-localized ``TenantBlob`` (``core.migrate``) — so a blob saved
    here can be restored into any fleet whose logical geometry matches, in
    either package. ``store`` is required when the tenant holds cold
    (host-tier) layers.
    """
    from repro_torch.core import migrate as migrate_lib

    os.makedirs(path, exist_ok=True)
    blob = migrate_lib.export_tenant(fleet, t, store=store)
    migrate_lib.save_blob(blob, os.path.join(path, f"tenant_{t}.npz"))


def load_tenant_from_dir(fleet, t: int, path: str, *, src_tenant=None,
                         store=None):
    """Restore a tenant checkpoint into slot ``t`` of ``fleet``.

    ``src_tenant`` names the slot the blob was saved from (defaults to
    ``t``); the destination slot is evicted and the blob lands through the
    fleet's own lease allocator. Returns the updated fleet.
    """
    from repro_torch.core import migrate as migrate_lib

    src = t if src_tenant is None else src_tenant
    blob = migrate_lib.load_blob(os.path.join(path, f"tenant_{src}.npz"))
    return migrate_lib.import_tenant(fleet, t, blob, store=store)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
