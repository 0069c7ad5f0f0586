"""Tenant live migration: export → detach → attach, bit-identically
(PyTorch port of ``repro.core.migrate``).

A tenant's whole chain (L1/L2 words, the leased device pool pages its hot
entries reference, the host-tier pages its ``FLAG_COLD`` entries
reference) is packed into a self-contained portable blob, freed on the
source fleet, and installed on a destination fleet that may have another
pool geometry and lease state.

**Blob format**, the JAX package's field for field: ``l1`` verbatim and
``l2`` with every hot pointer rewritten to an index into ``hot_pages`` and
every COLD pointer to an index into ``cold_pages`` (flags and word1
untouched), both ``uint32`` numpy (the ``int32`` carrier's bytes viewed
unsigned); ``hot_pages``/``cold_pages`` the referenced rows' data,
deduplicated, as numpy arrays of the fleet's page dtype; ``fingerprint``
the source state at export time. ``save_blob``/``load_blob`` write one
compressed ``.npz`` in the JAX package's layout, so a blob saved by either
package loads and installs in the other byte for byte.

**Lifecycle.** ``export_tenant`` is a pure read; ``detach_tenant``
recomputes the fingerprint and refuses (``MigrationError``) if anything
about the tenant changed since the export, then frees it;
``import_tenant`` resets the destination slot, acquires rows through the
destination's own lease allocator and store, delocalizes the pointers and
installs the chain (``fleet.install_tenant``). ``migrate_tenant`` strings
these together and bit-verifies the destination against the source
(``materialize_tenant``, which reads the one tenant alone) before it
detaches: the source is never dropped until the destination serves
identical bytes.

Port notes: the fleet ops update fleets in place and return them. On a
refused detach or a failed verification the source is untouched, as in
the JAX package, and ``migrate_tenant`` frees the destination slot it
imported into, so the caller's destination holds no tenant that did not
land (the JAX package's functional update drops the import with the
exception; here the slot is left empty). Pages travel as numpy
arrays, so a fleet's page dtype must be one numpy holds (every fleet in
the repo pages float32). Digests hash the same bytes in the same order as
the JAX package's, so fingerprints agree across the packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import fleet as fleet_lib
from repro_torch.core import format as fmt
from repro_torch.device import dtype_name


class MigrationError(RuntimeError):
    """A migration step refused: stale export, geometry mismatch, or a
    destination that failed bit-verification."""


# -- fingerprint: the mid-flight write guard ---------------------------------


def tenant_fingerprint(fleet, t: int) -> str:
    """Digest of everything about tenant ``t`` that an op could change:
    the live L1/L2 stacks (the ``int32`` carrier holds ``uint32``'s
    bytes), then length, ``alloc_count``, ``cold_count`` and the format
    flag as int64. Any write, snapshot, stream, compact, demote or promote
    changes it; maintenance repacks rewrite pointers even when data is
    preserved, and the conservative guard treats that as staleness too."""
    length = int(fleet.length[t])
    h = hashlib.sha256()
    h.update(fleet.l1[t, :length].cpu().numpy().tobytes())
    h.update(fleet.l2[t, :length].cpu().numpy().tobytes())
    h.update(np.asarray(
        [length, int(fleet.alloc_count[t]), int(fleet.cold_count[t]),
         int(bool(fleet.scalable[t]))], np.int64
    ).tobytes())
    return h.hexdigest()


# -- the portable blob -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantBlob:
    """A tenant's chain, packed self-contained and geometry-localized."""

    n_pages: int
    page_size: int
    l2_per_table: int
    dtype: str               # dtype name of the page payloads ("float32")
    length: int
    scalable: bool
    l1: np.ndarray           # (length, n_l1) uint32, verbatim
    l2: np.ndarray           # (length, n_pages, 2) uint32, ptrs localized
    hot_pages: np.ndarray    # (n_hot, page_size): referenced device rows
    cold_pages: np.ndarray   # (n_cold, page_size): referenced host rows
    fingerprint: str         # source state at export time (detach guard)

    @property
    def n_hot(self) -> int:
        return self.hot_pages.shape[0]

    @property
    def n_cold(self) -> int:
        return self.cold_pages.shape[0]

    def nbytes(self) -> int:
        return (self.l1.nbytes + self.l2.nbytes
                + self.hot_pages.nbytes + self.cold_pages.nbytes)


def entry_masks(l2: np.ndarray):
    """(allocated & data & hot, allocated & data & cold) masks of a host
    ``uint32`` L2 stack."""
    w0 = l2[..., 0]
    data = (((w0 & np.uint32(fmt.FLAG_ALLOCATED)) != 0)
            & ((w0 & np.uint32(fmt.FLAG_ZERO)) == 0))
    coldm = (w0 & np.uint32(fmt.FLAG_COLD)) != 0
    return data & ~coldm, data & coldm


def entry_ptrs(l2: np.ndarray) -> np.ndarray:
    """Every entry's pointer field of a host ``uint32`` L2 stack, int64."""
    return (l2[..., 0] & np.uint32(fmt.PTR_MASK)).astype(np.int64)


def _rewrite_ptrs(l2: np.ndarray, mask: np.ndarray,
                  new_ptrs: np.ndarray) -> np.ndarray:
    """Replace the pointer field of the masked entries, flags untouched."""
    out = l2.copy()
    w0 = out[..., 0]
    w0[mask] = ((w0[mask] & ~np.uint32(fmt.PTR_MASK))
                | new_ptrs.astype(np.uint32))
    return out


def _host_words(x: torch.Tensor) -> np.ndarray:
    """An owned ``uint32`` host copy of index words. ``.cpu()`` of a CPU
    tensor is the tensor itself, and the fleet ops rewrite ``l1``/``l2``
    in place, so a blob must never hold a view of them."""
    return x.cpu().numpy().view(np.uint32).copy()


# -- export ------------------------------------------------------------------


def export_tenant(fleet, t: int, *, store=None) -> TenantBlob:
    """Pack tenant ``t`` into a portable blob. Pure read: the source fleet
    is untouched and stays writable (``detach_tenant`` catches any write
    that lands in the window).

    ``store`` is required iff the tenant holds demoted (cold) layers:
    their host-tier pages ride along in the blob.
    """
    spec = fleet.spec
    length = int(fleet.length[t])
    l1 = _host_words(fleet.l1[t, :length])
    l2 = _host_words(fleet.l2[t, :length])
    hotm, coldm = entry_masks(l2)
    ptrs = entry_ptrs(l2)

    hot_rows = np.unique(ptrs[hotm])
    cold_rows = np.unique(ptrs[coldm])
    if cold_rows.size and store is None:
        raise MigrationError(
            f"tenant {t} holds {cold_rows.size} host-tier rows; pass the "
            "TieredStore so export can pack its cold pages"
        )
    empty = np.zeros((0, spec.page_size), dtype_name(spec.dtype))
    # advanced indexing gathers into fresh tensors: both are owned copies
    hot_pages = (fleet.pool[torch.as_tensor(hot_rows, device=fleet.device)]
                 .cpu().numpy() if hot_rows.size else empty)
    cold_pages = store.get(cold_rows).numpy() if cold_rows.size else empty

    # localize: pointer -> dense index into the blob's page tables
    l2_local = _rewrite_ptrs(l2, hotm, np.searchsorted(hot_rows, ptrs[hotm]))
    l2_local = _rewrite_ptrs(l2_local, coldm,
                             np.searchsorted(cold_rows, ptrs[coldm]))

    return TenantBlob(
        n_pages=spec.n_pages,
        page_size=spec.page_size,
        l2_per_table=spec.l2_per_table,
        dtype=dtype_name(spec.dtype),
        length=length,
        scalable=bool(fleet.scalable[t]),
        l1=l1,
        l2=l2_local,
        hot_pages=hot_pages,
        cold_pages=cold_pages,
        fingerprint=tenant_fingerprint(fleet, t),
    )


# -- attach ------------------------------------------------------------------


def _check_geometry(spec, blob: TenantBlob) -> None:
    """The destination must agree on the *guest-visible* geometry; pool
    capacity, lease quantum, tenant count and spare chain depth are the
    host's business and may all differ."""
    mismatches = [
        name for name, got, want in [
            ("n_pages", spec.n_pages, blob.n_pages),
            ("page_size", spec.page_size, blob.page_size),
            ("l2_per_table", spec.l2_per_table, blob.l2_per_table),
            ("dtype", dtype_name(spec.dtype), blob.dtype),
        ] if got != want
    ]
    if mismatches:
        raise MigrationError(
            "destination fleet disagrees on guest-visible geometry: "
            + ", ".join(mismatches)
        )
    if blob.length > spec.max_chain:
        raise MigrationError(
            f"blob chain depth {blob.length} exceeds destination "
            f"max_chain={spec.max_chain}"
        )


def import_tenant(fleet, t: int, blob: TenantBlob, *, store=None):
    """Attach a blob into slot ``t`` of the destination fleet.

    The slot is reset first (``free_tenant``: a previous occupant's leases
    and host rows are returned), hot rows are granted through the
    destination's lease allocator and cold rows through its store, and the
    blob's localized pointers are rewritten to the new rows. Raises
    ``MigrationError`` on geometry mismatch, ``RuntimeError`` if the
    destination pool cannot grant ``blob.n_hot`` rows.
    """
    _check_geometry(fleet.spec, blob)
    if blob.n_cold and store is None:
        raise MigrationError(
            f"blob carries {blob.n_cold} cold pages; pass the destination "
            "TieredStore to land them"
        )
    fleet = fleet_lib.free_tenant(fleet, t, store=store)
    fleet, dev_rows = fleet_lib.acquire_rows(fleet, t, blob.n_hot)
    host_rows = np.zeros(0, np.int64)
    if blob.n_cold:
        host_rows = store.alloc(blob.n_cold)
        store.put(host_rows, torch.from_numpy(np.asarray(blob.cold_pages)))

    l2 = np.asarray(blob.l2, np.uint32)
    hotm, coldm = entry_masks(l2)
    local = entry_ptrs(l2)
    l2 = _rewrite_ptrs(l2, hotm, dev_rows[local[hotm]])
    if blob.n_cold:
        l2 = _rewrite_ptrs(l2, coldm, host_rows[local[coldm]])

    return fleet_lib.install_tenant(
        fleet, t,
        l1=np.asarray(blob.l1, np.uint32), l2=l2, length=blob.length,
        scalable=blob.scalable, cold_count=blob.n_cold, pool_rows=dev_rows,
        pool_data=torch.from_numpy(np.asarray(blob.hot_pages)),
    )


def detach_tenant(fleet, t: int, blob: TenantBlob, *, store=None,
                  registry=None):
    """Release tenant ``t`` from the source fleet: the commit point of a
    migration. Refuses with ``MigrationError`` if the tenant's state no
    longer matches ``blob`` (a write/snapshot/maintenance op landed after
    export): the blob is stale and must be re-exported.

    ``registry``: the source fleet's ``GoldenRegistry``, when it runs one.
    Migrating a golden *fork* away releases its pins here (the destination
    copy is self-contained: export materialized the shared pages into the
    blob); detaching a registered *owner* is refused by ``free_tenant``
    until it is unregistered.
    """
    if tenant_fingerprint(fleet, t) != blob.fingerprint:
        raise MigrationError(
            f"tenant {t} changed after export (mid-migration write or "
            "maintenance op): re-export before detaching"
        )
    return fleet_lib.free_tenant(fleet, t, store=store, registry=registry)


# -- verification & orchestration --------------------------------------------


def materialize_tenant(fleet, t: int, *, store=None,
                       method: str = "auto") -> torch.Tensor:
    """Tenant ``t``'s full guest-visible disk, ``(n_pages, page_size)`` on
    the fleet's device, cold pages served from the host tier.

    Reads tenant ``t`` alone: one ``read_tiered`` of a (1, n_pages) grid
    over ``fleet.tenant_slice``, so a verify holds one tenant's disk, not
    the fleet's. The bytes equal row ``t`` of a read of every tenant."""
    one = fleet_lib.tenant_slice(fleet, t)
    grid = torch.arange(fleet.spec.n_pages, dtype=torch.int32,
                        device=fleet.device)[None]
    data, _ = fleet_lib.read_tiered(one, store, grid, method=method)
    return data[0]


def migrate_tenant(src_fleet, src_t: int, dst_fleet, dst_t: int, *,
                   src_store=None, dst_store=None, method: str = "auto",
                   verify: bool = True, src_registry=None):
    """Full migration round-trip: export from ``src_fleet[src_t]``, import
    into ``dst_fleet[dst_t]``, bit-verify every guest page, and only then
    detach the source.

    Returns ``(src_fleet, dst_fleet, report)``; ``report`` records the blob
    shape and whether verification ran. On any failure (stale export,
    geometry mismatch, verification miss) the source tenant is left fully
    intact, and a destination slot the blob was imported into is freed
    (its leases and host rows returned) before the error propagates.
    """
    blob = export_tenant(src_fleet, src_t, store=src_store)
    dst_fleet = import_tenant(dst_fleet, dst_t, blob, store=dst_store)
    try:
        if verify:
            want = materialize_tenant(src_fleet, src_t, store=src_store,
                                      method=method)
            got = materialize_tenant(dst_fleet, dst_t, store=dst_store,
                                     method=method)
            same = fleet_lib._same_bytes(want, got)
            del want, got
            if not same:
                raise MigrationError(
                    f"destination tenant {dst_t} is not bit-identical to "
                    f"source tenant {src_t}; source left intact"
                )
        src_fleet = detach_tenant(src_fleet, src_t, blob, store=src_store,
                                  registry=src_registry)
    except Exception:
        # a tenant that did not land leaves the destination slot empty
        fleet_lib.free_tenant(dst_fleet, dst_t, store=dst_store)
        raise
    report = dict(
        length=blob.length,
        rows_hot=blob.n_hot,
        rows_cold=blob.n_cold,
        blob_bytes=blob.nbytes(),
        verified=bool(verify),
    )
    return src_fleet, dst_fleet, report


# -- disk container ----------------------------------------------------------

_META_FIELDS = ("n_pages", "page_size", "l2_per_table", "length")


def save_blob(blob: TenantBlob, path) -> None:
    """Write a blob as one compressed ``.npz`` (numpy arrays only, no
    pickle), in the JAX package's layout."""
    np.savez_compressed(
        path,
        meta=np.asarray([getattr(blob, f) for f in _META_FIELDS], np.int64),
        scalable=np.asarray(blob.scalable),
        dtype=np.frombuffer(blob.dtype.encode(), np.uint8),
        fingerprint=np.frombuffer(blob.fingerprint.encode(), np.uint8),
        l1=blob.l1,
        l2=blob.l2,
        hot_pages=blob.hot_pages,
        cold_pages=blob.cold_pages,
    )


def load_blob(path) -> TenantBlob:
    with np.load(path) as z:
        meta = {f: int(v) for f, v in zip(_META_FIELDS, z["meta"])}
        return TenantBlob(
            **meta,
            scalable=bool(z["scalable"]),
            dtype=z["dtype"].tobytes().decode(),
            fingerprint=z["fingerprint"].tobytes().decode(),
            l1=z["l1"],
            l2=z["l2"],
            hot_pages=z["hot_pages"],
            cold_pages=z["cold_pages"],
        )
