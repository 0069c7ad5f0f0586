"""L2 indexing-cache model: per-file caches (vQemu) vs unified (sQEMU)
(PyTorch port of ``repro.core.cache``).

The read path resolves pages with gathers (``resolve.py``, ``kernels/``);
this module reproduces the paper's **low-level metrics** (Fig 13: cache
misses, cache hits unallocated, per-file lookup distribution; Fig 14:
lookup latency; Fig 16: cache-size sensitivity). It simulates the Qcow2
slice cache as §2 of the paper describes it — slice-granular, fully
associative, LRU — sequentially over a request stream, with the JAX
package's event accounting:

* **cache miss** — the slice holding the request's L2 entry is not in the
  (relevant) cache and must be fetched from the file (one T_D + T_L cost);
* **cache hit** — the cached entry describes an allocated page;
* **cache hit unallocated** — the cached entry is unallocated, so vQemu
  moves on to the next backing file's cache (one T_F cost per event).

Under vQemu a request probes every file from the active volume down to
its owner (the whole chain on a miss); under sQEMU it probes one cache,
and the entry's ``backing_file_index`` makes it usable even where the data
lives in a backing file (``backing_reads`` counts those). Memory: vQemu
allocates one cache per file, sQEMU one (Fig 12).

The JAX package runs each simulation as one ``lax.scan``. Here everything
but ``misses`` is a function of the chain and the request alone, so it is
computed for the whole stream at once: which files a request probes (the
port's vanilla resolver: its ``lookups`` are the probes), which of them
hold the slice's L2 table, hits, unallocated events, backing reads and the
per-file histogram (a difference array over the probed ranges). Only the
misses need the sequential LRU state; that loop runs one request at a
time, over all C per-file caches at once (they evolve independently, since
which files a request probes depends only on the chain). Every field
equals the JAX simulation's for the same chain, stream and ``n_slots``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import format as fmt
from repro_torch.core import resolve as resolve_lib
from repro_torch.core.chain import Chain, ChainSpec


class SimTrace(NamedTuple):
    """Per-request event counts from a cache simulation (shape (R,), int32)."""

    probes: torch.Tensor           # cache lookups performed
    misses: torch.Tensor           # slice fetches from "disk"
    hits: torch.Tensor             # allocated-entry hits
    hit_unallocated: torch.Tensor  # unallocated-entry events
    backing_reads: torch.Tensor    # data reads served by a backing file
    hist: torch.Tensor             # (max_chain,) lookups by owning file


def cache_memory_bytes(
    spec: ChainSpec,
    n_slots: int,
    chain_length: int,
    *,
    unified: bool,
    per_snapshot_overhead: int = 256,
) -> int:
    """Index-cache RAM model (Fig 12).

    vQemu allocates one slice cache per file in the chain at boot; sQEMU
    keeps a single one. ``per_snapshot_overhead`` models the residual
    per-snapshot driver structures the paper observes even under sQEMU
    (§6.2: "other per-snapshot data structures").
    """
    slice_bytes = spec.slice_len * fmt.ENTRY_WORDS * 4
    slot_bytes = slice_bytes + 16  # tag + ref + dirty + lru bookkeeping
    one_cache = n_slots * slot_bytes
    caches = 1 if unified else chain_length
    return caches * one_cache + chain_length * per_snapshot_overhead


def cache_correction(sv_entries: torch.Tensor,
                     sb_entries: torch.Tensor) -> torch.Tensor:
    """Paper §5.3 "cache correction": merge backing slice ``sb`` into the
    cached slice ``sv``.

    An entry of ``sv`` is replaced by the corresponding ``sb`` entry iff
    ``sb`` is allocated and its ``backing_file_index`` is >= that of the
    ``sv`` entry (or ``sv`` is unallocated). Monotone in bfi and
    idempotent.
    """
    sb_alloc = fmt.entry_allocated(sb_entries)
    sv_alloc = fmt.entry_allocated(sv_entries)
    newer = fmt.entry_bfi(sb_entries) >= fmt.entry_bfi(sv_entries)
    replace = sb_alloc & (~sv_alloc | newer)
    return torch.where(replace[..., None], sb_entries, sv_entries)


def _lru_misses(slices: list, probed: torch.Tensor, fetchable: torch.Tensor,
                n_slots: int):
    """Slice fetches per request of C independent LRU caches of ``n_slots``:
    ``(misses (R,) int32, tags (C, n_slots))``, the second the caches' final
    slice tags (-1 empty).

    ``slices``: the R requests' slice ids (host ints); ``probed`` (R, C):
    the caches a request looks in; ``fetchable`` (R, C): those where a miss
    fetches (the file holds the slice's L2 table). A probe that finds the
    slice refreshes its age; a fetch fills the least recently used slot,
    the lowest-numbered one among ties (so an empty cache fills in slot
    order, as the JAX ``argmin`` does). Column ``n_slots`` is a sink that
    absorbs the writes of caches that do not fetch, so a step never syncs.
    """
    n_req, c = probed.shape
    dev = probed.device
    tags = torch.full((c, n_slots + 1), -1, dtype=torch.int32, device=dev)
    age = torch.full((c, n_slots + 1), -1, dtype=torch.int32, device=dev)
    slot_tags, slot_age = tags[:, :n_slots], age[:, :n_slots]
    sink = torch.full((c,), n_slots, dtype=torch.int64, device=dev)
    fetched = torch.empty((n_req, c), dtype=torch.bool, device=dev)
    for r, s in enumerate(slices):
        t = r + 1
        match = slot_tags == s
        in_cache = match.any(dim=1)
        # fetchable & ~in_cache, written straight into this request's row
        torch.gt(fetchable[r], in_cache, out=fetched[r])
        slot_age.masked_fill_(match & probed[r][:, None], t)
        dst = torch.where(fetched[r], slot_age.argmin(dim=1), sink)[:, None]
        tags.scatter_(1, dst, s)
        age.scatter_(1, dst, t)
    return fetched.sum(dim=1, dtype=torch.int32), slot_tags


def _request_ids(chain: Chain, page_ids) -> torch.Tensor:
    return torch.as_tensor(page_ids, device=chain.l2.device).to(torch.int64)


def simulate_vanilla(chain: Chain, page_ids, n_slots: int) -> SimTrace:
    """Simulate the vQemu per-file caches over a request stream.

    Each request walks the chain from the active volume down to the owning
    file (the whole chain on a miss), probing one cache per file visited;
    a miss fetches the slice where that file holds its L2 table.
    """
    spec = chain.spec
    c = spec.max_chain
    ids = _request_ids(chain, page_ids)
    n_req = ids.numel()
    length = int(chain.length)
    res = resolve_lib.resolve_vanilla(chain, ids)
    low = torch.where(res.found, res.owner, 0).to(torch.int64)      # (R,)
    files = torch.arange(c, device=ids.device)
    probed = (files >= low[:, None]) & (files < length)             # (R, C)
    on_disk = (chain.l1[:, ids // spec.l2_per_table] != 0).T        # (R, C)
    fetchable = probed & on_disk
    owner_on_disk = on_disk.gather(1, res.owner.clamp(min=0).to(torch.int64)[:, None])[:, 0]
    unal = (fetchable.sum(dim=1, dtype=torch.int32)
            - (res.found & owner_on_disk).to(torch.int32))
    # every request probes the files [low, length): +1 at low, -1 at length
    starts = torch.bincount(low, minlength=c + 1)
    hist = torch.where(files < length, starts.cumsum(0)[:c], 0).to(torch.int32)
    slices = (ids // spec.slice_len).tolist()
    return SimTrace(
        probes=res.lookups,
        misses=_lru_misses(slices, probed, fetchable, n_slots)[0],
        hits=res.found.to(torch.int32),
        hit_unallocated=unal,
        backing_reads=torch.zeros(n_req, dtype=torch.int32, device=ids.device),
        hist=hist,
    )


def simulate_unified(chain: Chain, page_ids, n_slots: int) -> SimTrace:
    """Simulate the sQEMU unified cache over a request stream.

    One probe per request; the active volume's copied-forward L2 entry is
    directly usable (ptr + backing_file_index), so data living in a backing
    file costs a ``backing_read`` but never a chain walk. Every miss
    fetches.
    """
    spec = chain.spec
    ids = _request_ids(chain, page_ids)
    n_req = ids.numel()
    active = int(chain.length) - 1
    entries = chain.l2[active][ids]                                  # (R, 2)
    alloc = fmt.entry_allocated(entries)
    bfi = fmt.entry_bfi(entries)
    # lookups by owning file; a bfi past the chain counts nowhere (one_hot)
    owner = torch.where(alloc, bfi, active).to(torch.int64)
    hist = torch.bincount(owner, minlength=spec.max_chain)[:spec.max_chain]
    ones = torch.ones((n_req, 1), dtype=torch.bool, device=ids.device)
    slices = (ids // spec.slice_len).tolist()
    return SimTrace(
        probes=torch.ones(n_req, dtype=torch.int32, device=ids.device),
        misses=_lru_misses(slices, ones, ones, n_slots)[0],
        hits=alloc.to(torch.int32),
        hit_unallocated=(~alloc).to(torch.int32),
        backing_reads=(alloc & (bfi != active)).to(torch.int32),
        hist=hist.to(torch.int32),
    )


def summarize(trace: SimTrace) -> dict:
    return dict(
        probes=int(trace.probes.sum()),
        misses=int(trace.misses.sum()),
        hits=int(trace.hits.sum()),
        hit_unallocated=int(trace.hit_unallocated.sum()),
        backing_reads=int(trace.backing_reads.sum()),
    )
