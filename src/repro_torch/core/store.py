"""VirtualTensorStore: the user-facing COW snapshot store (PyTorch port).

The read plane of ``repro.core.store``: whole-page reads of one virtual
disk through its snapshot chain (``read``, the 'dd' op ``materialize``,
``allocated_mask``), the store constructor and its guards, and the host
cold tier (``TieredStore``) behind a fleet's device pool. Writes and
snapshots are ``core.chain``'s, re-exported here, and so are the
maintenance ops: streaming (``stream``, whose merge plan runs the
streaming-merge kernel K9), pool compaction (``compact_pool``) and format
conversion (``convert_to_scalable``). Like every op of the port, they
update the chain in place and return it.

``read`` resolves through the resolver registry of ``core.resolve``; the
kernel methods (``"pallas_vanilla"``, ``"pallas_direct"``) also gather
through the single-chain gather kernel of ``kernels/cow_gather`` (K8),
as ``fleet.read`` does with the fleet gather (K5). The plain methods use
``gather_pages``. Both give the same bytes. Reads never modify the chain.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import chain as chain_lib
from repro_torch.core import format as fmt
from repro_torch.core import resolve as resolve_lib
from repro_torch.core.chain import Chain, ChainSpec
from repro_torch.kernels.cow_gather import ops as cow_ops

#: resolver methods that run on the kernels, resolve and gather alike
KERNEL_METHODS = ("pallas_vanilla", "pallas_direct")


def readable_rows(res: resolve_lib.ResolveResult):
    """``(rows int32, ok bool)``: where a resolved page is read from the
    device pool (found, not a ZERO cluster, not COLD — a cold ``ptr``
    addresses a host-tier row, which would alias an unrelated pool row
    here) and its pool row there, 0 elsewhere. What the gather kernels
    take."""
    ok = res.found & ~res.zero & ~res.cold
    return torch.where(ok, res.ptr, 0).to(torch.int32), ok


def gather_pages(pool: torch.Tensor, res: resolve_lib.ResolveResult) -> torch.Tensor:
    """Gather resolved pages from a pool; unallocated, ZERO and COLD pages
    read as +0.0.

    Callers that need cold data promote first (``fleet.promote_tenants``)
    or read through ``fleet.read_tiered``. Shape-polymorphic over leading
    batch axes: (B,) results for one chain, (T, B) for a fleet (the pool
    is global, so one gather covers every tenant). The zeros are written
    in place into the gathered copy, so a full-disk read holds one copy of
    the data, not three.
    """
    rows, ok = readable_rows(res)
    data = pool[rows.to(torch.int64)]
    return data.masked_fill_(~ok[..., None], 0)


class TieredStore:
    """The host cold tier behind a fleet's device page pool.

    A flat CPU page array with its own row allocator:
    ``fleet.demote_tenants`` copies whole immutable snapshot layers out of
    the device pool into host rows allocated here and rewrites the evicted
    L2 entries to ``(host_row | FLAG_COLD)``; ``fleet.promote_tenants``
    moves them back and returns the host rows to this free list. Rows are
    addressed by the entry's 28-bit ``ptr`` field, so the two tiers share
    one pointer format.

    Capacity grows by doubling on demand. All methods are host-side, like
    the rest of the maintenance plane. The array is a CPU tensor (not
    numpy, which has no bfloat16), so ``get`` returns a CPU tensor of the
    pool's dtype. Lifetime transfer counters (``demoted_rows``/
    ``promoted_rows``) are kept as in the JAX package.
    """

    def __init__(self, page_size: int, dtype=torch.float32, *,
                 initial_rows: int = 0):
        self.page_size = int(page_size)
        self.dtype = dtype
        cap = max(int(initial_rows), 1)
        self._data = torch.zeros((cap, self.page_size), dtype=dtype)
        self._free: list[int] = []
        self._top = 0            # high-water mark of ever-allocated rows
        self.demoted_rows = 0    # lifetime pages moved device -> host
        self.promoted_rows = 0   # lifetime pages moved host -> device

    @classmethod
    def for_fleet(cls, spec) -> "TieredStore":
        """A cold tier matching a ``FleetSpec``'s page geometry (reserving
        ``pool_capacity`` host rows up front)."""
        return cls(spec.page_size, spec.dtype, initial_rows=spec.pool_capacity)

    def host_rows_in_use(self) -> int:
        return self._top - len(self._free)

    def alloc(self, n: int):
        """Allocate ``n`` host rows; returns their ids (int64 numpy).

        Free-listed rows are reused first (last freed, first out); fresh
        rows extend the array (doubling). Raises if a row id would not fit
        the 28-bit ``ptr`` field.
        """
        take = min(n, len(self._free))
        rows = [self._free.pop() for _ in range(take)]
        fresh = n - take
        if fresh:
            if self._top + fresh > fmt.MAX_POOL_ROWS:
                raise RuntimeError(
                    "host tier exhausted: row ids no longer fit the "
                    "28-bit ptr field"
                )
            cap = self._data.shape[0]
            while cap < self._top + fresh:
                cap *= 2
            if cap != self._data.shape[0]:
                grown = torch.zeros((cap, self.page_size), dtype=self.dtype)
                grown[: self._data.shape[0]] = self._data
                self._data = grown
            rows.extend(range(self._top, self._top + fresh))
            self._top += fresh
        return np.asarray(rows, np.int64)

    def put(self, rows, data: torch.Tensor) -> None:
        """Fill host rows (a demotion's data movement)."""
        idx = torch.as_tensor(rows, dtype=torch.int64)
        self._data[idx] = data.to(device="cpu", dtype=self.dtype)
        self.demoted_rows += int(idx.numel())

    def get(self, rows) -> torch.Tensor:
        """Read host rows (a promotion's source, or a tiered read)."""
        return self._data[torch.as_tensor(rows, dtype=torch.int64)]

    def free(self, rows) -> None:
        """Return host rows to the free list (promotion / tenant free)."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        if rows.size and (rows.min() < 0 or rows.max() >= self._top):
            raise ValueError("freeing host rows that were never allocated")
        self._free.extend(int(r) for r in rows)

    def clone(self) -> "TieredStore":
        """An isolated copy sharing no state with ``self`` (the store is
        mutable host state: a flow that speculates against it forks it
        first, or later frees corrupt the shared free list)."""
        out = TieredStore(self.page_size, self.dtype, initial_rows=1)
        out._data = self._data.clone()
        out._free = list(self._free)
        out._top = self._top
        out.demoted_rows = self.demoted_rows
        out.promoted_rows = self.promoted_rows
        return out

    def stats(self) -> dict:
        return dict(
            host_rows_in_use=self.host_rows_in_use(),
            host_rows_capacity=int(self._data.shape[0]),
            demoted_rows=self.demoted_rows,
            promoted_rows=self.promoted_rows,
        )


def read(chain: Chain, page_ids, *, method: str = "auto"):
    """Read whole pages. Unallocated or ZERO pages read as zeros.

    Returns ``(data (B, page_size), ResolveResult)``. The kernel methods
    gather through K8; the others through ``gather_pages``.
    """
    ids = torch.as_tensor(page_ids, device=chain.l2.device)
    res = resolve_lib.get_resolver(method)(chain, ids)
    if method in KERNEL_METHODS:
        return cow_ops.gather(chain.pool, *readable_rows(res)), res
    return gather_pages(chain.pool, res), res


write = chain_lib.write
snapshot = chain_lib.snapshot
stream = chain_lib.stream
compact_pool = chain_lib.compact_pool
convert_to_scalable = chain_lib.convert_to_scalable


def create(
    n_pages: int,
    page_size: int,
    *,
    max_chain: int = 64,
    pool_capacity: int | None = None,
    scalable: bool = True,
    dtype=torch.float32,
    l2_per_table: int = 64,
    slice_len: int = 16,
    device="cuda",
) -> Chain:
    """Convenience constructor with the JAX package's defaults; on the card
    unless ``device`` says otherwise."""
    if pool_capacity is None:
        pool_capacity = 4 * n_pages
    spec = ChainSpec(
        n_pages=n_pages,
        page_size=page_size,
        max_chain=max_chain,
        pool_capacity=pool_capacity,
        l2_per_table=l2_per_table,
        slice_len=slice_len,
        dtype=dtype,
    )
    return chain_lib.create(spec, scalable=scalable, device=device)


def chain_length(chain: Chain) -> int:
    return int(chain.length)


def _all_pages(chain: Chain) -> torch.Tensor:
    return torch.arange(chain.spec.n_pages, dtype=torch.int32,
                        device=chain.l2.device)


def allocated_mask(chain: Chain, *, method: str = "auto") -> torch.Tensor:
    """(n_pages,) bool: which logical pages currently hold data."""
    return resolve_lib.get_resolver(method)(chain, _all_pages(chain)).found


def materialize(chain: Chain, *, method: str = "auto") -> torch.Tensor:
    """Read the full virtual disk: (n_pages, page_size). The 'dd' op."""
    data, _ = read(chain, _all_pages(chain), method=method)
    return data


def check_pool_capacity(chain: Chain) -> None:
    """Raise if the chain hit a resource limit (host-side guard)."""
    if bool(chain.overflow):
        raise RuntimeError(
            "page pool overflow: grow ChainSpec.pool_capacity or stream "
            "the chain"
        )
    if bool(chain.snap_dropped):
        raise RuntimeError(
            "snapshot dropped: the chain is at max_chain; stream() to "
            "shorten it (the flag clears only if streaming actually makes "
            "room — a merge_upto=0 stream shortens nothing and leaves it "
            "latched)"
        )
