"""CUDA kernel for the resolved-page gather from the device page pool.

The counterpart of ``repro.kernels.cow_gather.cow_gather``'s
``gather_pallas`` (K8, one chain's (B,) pages) and ``gather_fleet_pallas``
(K5, a fleet's (T, B) pages): one hand-written CUDA C++ kernel in
``csrc/cow_gather.cu`` that copies each page as raw bytes, one to eight
warps a page, built for Hopper by ``kernels._build``. K5 has a second
entry, ``gather_fleet_resolved_cuda``, that takes a resolve's leaves as
the resolver wrote them and tests each page itself (no TPU counterpart:
the JAX package masks the leaves first), so a fleet read launches nothing
between its resolve and its gather. The wrappers here take CUDA tensors
only, check what the kernel takes, pick the kernel's variant from the
page bytes alone (``gather_variant``), allocate the output, launch on the
current stream without synchronising, and count the launch under their
own name. ``ops`` dispatches CPU tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

#: 16-byte loads a lane issues before their stores (a round), by bucket
_UNITS = (1, 2, 4, 8, 16)
#: warps that copy one page together (a block holds eight warps)
_WARPS_PER_PAGE = (1, 2, 4, 8)
#: 16-byte loads a lane should have of a page at least: a page is spread
#: over as many warps as leave each lane this many
_MIN_LOADS = 4


class GatherVariant(NamedTuple):
    units: int
    warps_per_page: int

    @property
    def name(self) -> str:
        return f"u{self.units}g{self.warps_per_page}"


@functools.cache
def gather_variant(page_bytes: int) -> GatherVariant:
    """The kernel's variant for pages of ``page_bytes``, from the shape
    alone (no sync, no read of ``found``). Warps a page: the most that
    leave each lane ``_MIN_LOADS`` 16-byte loads of the page (8 KiB: 4
    warps; 16 KiB and up: 8). Loads a lane a round: the fewest that cover
    the page in one round of the group, at most 16 (a 64 KiB page over 8
    warps). The page count and the SM count do not enter: on the card the
    best variant was the same at 64 and at 829,376 pages (``PERF.md`` §6).
    Cached by page size: it runs on every launch's host path."""
    g = max((w for w in _WARPS_PER_PAGE if 512 * _MIN_LOADS * w <= page_bytes),
            default=1)
    need = -(-page_bytes // (512 * g))
    units = next((u for u in _UNITS if u >= need), _UNITS[-1])
    return GatherVariant(units, g)


def _prepare(name: str, pool: torch.Tensor, rows: torch.Tensor,
             flags: tuple[torch.Tensor, ...], variant: GatherVariant | None):
    """Checks what the kernel reads, from attributes alone; returns the
    output, the page bytes and the variant (``variant`` overrides the
    pick)."""
    for x in (pool, rows, *flags):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if pool.dim() != 2:
        raise ValueError(f"{name}: pool must be (R, P), got {tuple(pool.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
    for f in flags:
        if f.dtype != torch.bool or f.shape != rows.shape:
            raise ValueError(f"{name}: each flag (found, zero, cold) must be "
                             "bool of the rows' shape")
    page = pool.shape[1] * pool.element_size()
    v = variant or gather_variant(page)
    if v.units not in _UNITS or v.warps_per_page not in _WARPS_PER_PAGE:
        raise ValueError(f"{name}: no kernel variant {v}")
    out = torch.empty((*rows.shape, pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    return out, page, v


def _launch(name: str, pool: torch.Tensor, rows: torch.Tensor,
            found: torch.Tensor,
            variant: GatherVariant | None = None) -> torch.Tensor:
    """Checks, allocates and launches ``cow_gather``; ``variant`` overrides
    the pick (the GPU tests run every instantiation of the kernel through
    it)."""
    out, page, v = _prepare(name, pool, rows, (found,), variant)
    if out.numel():
        code = _build.library().cow_gather(
            pool.data_ptr(), rows.data_ptr(), found.data_ptr(), out.data_ptr(),
            rows.numel(), pool.shape[0], page, v.units, v.warps_per_page,
            _build.launch_stream(pool))
        _build.check_launch(name, code)
    return out


def gather_cuda(pool: torch.Tensor, rows: torch.Tensor,
                found: torch.Tensor) -> torch.Tensor:
    """K8: ``pool`` (R, P), ``rows`` (B,) int32, ``found`` (B,) bool →
    (B, P): ``pool[rows[i]]`` where found, +0.0 bytes elsewhere. The pool
    is never read where not found (nor at a row outside [0, R))."""
    if rows.dim() != 1:
        raise ValueError(f"gather: rows must be (B,), got {tuple(rows.shape)}")
    return _launch("gather", pool, rows, found)


def gather_fleet_cuda(pool: torch.Tensor, rows: torch.Tensor,
                      found: torch.Tensor) -> torch.Tensor:
    """K5: the stacked fleet gather, ``rows``/``found`` (T, B) → (T, B, P);
    the pool is global, so one launch serves every tenant."""
    if rows.dim() != 2:
        raise ValueError(
            f"gather_fleet: rows must be (T, B), got {tuple(rows.shape)}")
    return _launch("gather_fleet", pool, rows, found)


#: The entry key of K5 on a resolve's leaves: its kernel is K5's
#: (``gather_pages_kernel``), so a trace and ``_build.LAUNCHES`` count its
#: launches as K5's (``gather_fleet``); this key counts them apart besides.
RESOLVED_ENTRY = "gather_fleet_resolved"


def gather_fleet_resolved_cuda(pool: torch.Tensor, ptr: torch.Tensor,
                               found: torch.Tensor, zero: torch.Tensor,
                               cold: torch.Tensor, *,
                               variant: GatherVariant | None = None) -> torch.Tensor:
    """K5 on a resolve's (T, B) leaves as the resolver wrote them: ``ptr``
    int32, ``found``/``zero``/``cold`` bool → (T, B, P): ``pool[ptr]``
    where the page was found and is neither a ZERO cluster nor COLD (a
    cold ``ptr`` addresses a host-tier row), +0.0 bytes elsewhere; a row
    outside [0, R) reads as zeros too. Bit for bit ``gather_fleet_cuda``
    on ``store.readable_rows`` of the same leaves, in one launch and with
    no mask made before it; counted as K5's and as ``RESOLVED_ENTRY``'s.
    ``variant`` overrides the pick (for the tests)."""
    if ptr.dim() != 2:
        raise ValueError(f"{RESOLVED_ENTRY}: ptr must be (T, B), got {tuple(ptr.shape)}")
    out, page, v = _prepare(RESOLVED_ENTRY, pool, ptr, (found, zero, cold), variant)
    if out.numel():
        code = _build.library().cow_gather_resolved(
            pool.data_ptr(), ptr.data_ptr(), found.data_ptr(), zero.data_ptr(),
            cold.data_ptr(), out.data_ptr(), ptr.numel(), pool.shape[0], page,
            v.units, v.warps_per_page, _build.launch_stream(pool))
        _build.check_launch("gather_fleet", code, entry=RESOLVED_ENTRY)
    return out
