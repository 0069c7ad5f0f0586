"""Snapshot-chain state: the table-level helpers the fleet maps (PyTorch port).

A ``Chain`` is the analogue of a Qcow2 backing-file chain (see
``repro.core.chain``): ``max_chain`` layers of L1/L2 index tables over one
global page pool; layer ``length - 1`` is the active volume. This slice
ports the geometry, ``create``, the COW ``write``, ``snapshot`` and the
two table-level helpers ``core.fleet`` maps over its tenant axis
(``write_tables``, ``copy_forward_tables``). Merge, stream and compact
come with the maintenance plane in a later slice.

Unlike the JAX package, whose updates are functional, the port updates a
chain's tensors in place and returns the same object: a chain is never
read again in the state it had before an update.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import format as fmt
from repro_torch.device import as_device


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static geometry of a chain."""

    n_pages: int
    page_size: int
    max_chain: int
    pool_capacity: int
    l2_per_table: int = 64  # L2 entries per L2 table (qcow2: cluster_size/8)
    slice_len: int = 16     # cache-slice granularity, in entries (qcow2 docs)
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_pages % self.l2_per_table != 0:
            raise ValueError("n_pages must be a multiple of l2_per_table")
        if self.max_chain > fmt.MAX_CHAIN_REPRESENTABLE:
            raise ValueError("max_chain exceeds 16-bit backing_file_index")
        if self.pool_capacity > fmt.MAX_POOL_ROWS:
            raise ValueError("pool_capacity exceeds 28-bit page_ptr")
        if self.l2_per_table % self.slice_len != 0:
            raise ValueError("l2_per_table must be a multiple of slice_len")

    @property
    def n_l1(self) -> int:
        return self.n_pages // self.l2_per_table


@dataclasses.dataclass
class Chain:
    spec: ChainSpec
    scalable: bool
    l1: torch.Tensor           # (max_chain, n_l1) int32 — bit0: L2 table present
    l2: torch.Tensor           # (max_chain, n_pages, 2) int32 — L2 entries
    pool: torch.Tensor         # (pool_capacity, page_size) dtype
    pool_cursor: torch.Tensor  # () int32 — next free pool row
    length: torch.Tensor       # () int32 — #files in chain; active = length - 1
    overflow: torch.Tensor     # () bool — a write ran past pool_capacity
    snap_dropped: torch.Tensor  # () bool — snapshot dropped at max_chain

    @property
    def active(self) -> torch.Tensor:
        return self.length - 1


def create(spec: ChainSpec, *, scalable: bool = True, device="cuda") -> Chain:
    """A fresh virtual disk: chain of length 1 (a single active volume)."""
    dev = as_device(device)
    return Chain(
        spec=spec,
        scalable=scalable,
        l1=torch.zeros((spec.max_chain, spec.n_l1), dtype=torch.int32, device=dev),
        l2=fmt.empty_entries((spec.max_chain, spec.n_pages), dev),
        pool=torch.zeros((spec.pool_capacity, spec.page_size), dtype=spec.dtype,
                         device=dev),
        pool_cursor=torch.zeros((), dtype=torch.int32, device=dev),
        length=torch.ones((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        snap_dropped=torch.zeros((), dtype=torch.bool, device=dev),
    )


def write_tables(l1: torch.Tensor, l2: torch.Tensor, active: torch.Tensor,
                 page_ids: torch.Tensor, rows: torch.Tensor, *, scalable,
                 l2_per_table: int, mask=None) -> None:
    """Stamp COW entries for ``rows`` into the active volumes' L1/L2, in place.

    Stacked over a leading tenant axis: ``l1`` (T, C, n_l1), ``l2``
    (T, C, n_pages, 2), ``active``/``scalable`` (T,), ``page_ids``/``rows``
    /``mask`` (T, B). A single chain passes T = 1. Entries where ``mask``
    is False are left untouched (inactive tenants, pool overflow).
    Surviving page ids are unique per tenant (the write contract), so the
    scatter has no duplicate-index ordering hazard.
    """
    t, bsz = page_ids.shape
    dev = l2.device
    page_ids = page_ids.to(torch.int64)
    scal = torch.as_tensor(scalable, dtype=torch.bool, device=dev)
    scal = scal.expand(t) if scal.dim() == 0 else scal
    entries = fmt.pack_entry(
        rows, active.to(torch.int64)[:, None].expand(t, bsz),
        allocated=True, bfi_valid=scal[:, None].expand(t, bsz),
    )
    keep = (torch.ones((t, bsz), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool, device=dev)
            .expand(t, bsz))
    tids = torch.arange(t, device=dev)[:, None].expand(t, bsz)
    act = active.to(torch.int64)[:, None].expand(t, bsz)
    l2[tids[keep], act[keep], page_ids[keep]] = entries[keep]
    l1[tids[keep], act[keep], page_ids[keep] // l2_per_table] = 1


def copy_forward_tables(l1: torch.Tensor, l2: torch.Tensor,
                        new: torch.Tensor, do_copy: torch.Tensor) -> None:
    """sQEMU §5.4 snapshot copy-forward, in place and stacked over tenants:
    where ``do_copy`` (T,), duplicate layer ``new - 1``'s L1/L2 set into
    layer ``new`` (T,), so the new active volume indexes the whole chain
    and direct access stays O(1)."""
    c = l2.shape[1]
    tids = torch.arange(l2.shape[0], device=l2.device)
    dst = new.to(torch.int64).clamp(0, c - 1)
    src = (new.to(torch.int64) - 1).clamp(0, c - 1)
    d2 = do_copy[:, None, None]
    l2[tids, dst] = torch.where(d2, l2[tids, src], l2[tids, dst])
    l1[tids, dst] = torch.where(do_copy[:, None], l1[tids, src], l1[tids, dst])


def write(chain: Chain, page_ids, data) -> Chain:
    """COW write of whole pages to the active volume.

    ``page_ids``: (B,) logical page indices, unique within the batch;
    ``data``: (B, page_size). Writes always take fresh pool rows and update
    only the active volume's L1/L2; overflow rows are dropped and flagged.
    """
    spec = chain.spec
    dev = chain.pool.device
    page_ids = torch.as_tensor(page_ids, device=dev).to(torch.int64)
    bsz = page_ids.shape[0]
    rows = chain.pool_cursor.to(torch.int64) + torch.arange(bsz, device=dev)
    ok = rows < spec.pool_capacity
    chain.overflow |= ~torch.all(ok)
    data = torch.as_tensor(data, device=dev).to(spec.dtype)
    chain.pool[rows[ok]] = data[ok]
    write_tables(chain.l1[None], chain.l2[None], chain.active[None],
                 page_ids[None], torch.where(ok, rows, 0)[None],
                 scalable=chain.scalable, l2_per_table=spec.l2_per_table,
                 mask=ok[None])
    chain.pool_cursor += ok.sum(dtype=torch.int32)
    return chain


def snapshot(chain: Chain, *, scalable: bool | None = None) -> Chain:
    """Freeze the active volume as a backing file; open a new active volume.

    ``scalable=None`` follows the chain's format flag. A full chain cannot
    snapshot: its length is capped and ``snap_dropped`` raised.
    """
    if scalable is None:
        scalable = chain.scalable
    can = chain.length < chain.spec.max_chain
    if scalable:
        copy_forward_tables(chain.l1[None], chain.l2[None], chain.length[None],
                            can[None])
    # vanilla: the new active volume starts with no tables at all (layers
    # above ``length`` are still all-zeros by construction)
    chain.length += can.to(torch.int32)
    chain.snap_dropped |= ~can
    return chain
