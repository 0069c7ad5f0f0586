"""The port's tenant and sequence migration against ``repro.core.migrate``
and the JAX serving plane.

The cases of ``tests/test_migrate.py`` replay on both packages (all but
the checkpoint round trip, whose ``checkpoint/`` plane is not ported).
Source fleets are grown by the JAX package once per depth (1, 64 and 500,
a tenant with demoted layers included) and carried into the port with
``convert``; the JAX migration at each depth is the reference every
resolver of the port's is held against:

* blobs are equal field for field (``uint32`` words, page bytes, the
  fingerprint), and fingerprints equal after every op;
* after a migration, both fleets and both cold tiers equal the JAX
  package's, and the port's ``materialize_tenant`` (one tenant alone)
  equals the JAX row ``t`` on the source and the destination;
* a blob saved by either package loads in the other and installs byte for
  byte;
* sequences migrate between KV caches of other block sizes, pool sizes
  and formats with the same bytes, in float32 and bfloat16, and an engine
  request migrated off a tombstoned parent decodes the JAX engine's tokens
  on both fork formats (float32 compute, as in ``test_torch_engine.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import invariants as jinv  # noqa: E402
from repro.core import migrate as jmigrate  # noqa: E402
from repro.core.store import TieredStore as JStore  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import invariants as tinv  # noqa: E402
from repro_torch.core import migrate as tmigrate  # noqa: E402
from repro_torch.core.store import TieredStore as TStore  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

RESOLVERS = ["vanilla", "direct", "auto", "pallas_vanilla", "pallas_direct"]
N_PAGES, PAGE = 32, 4
BLOB_FIELDS = ("n_pages", "page_size", "l2_per_table", "dtype", "length",
               "scalable", "l1", "l2", "hot_pages", "cold_pages",
               "fingerprint")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x.view(np.int32)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _kw(**kw):
    base = dict(n_tenants=3, n_pages=N_PAGES, page_size=PAGE, max_chain=8,
                pool_capacity=4096, lease_quantum=8, l2_per_table=N_PAGES)
    base.update(kw)
    return base


def _grow(fl, rng, *, layers, writes_per_layer=2, batch=2):
    """``tests/test_migrate.py``'s random COW churn, on the JAX fleet."""
    spec = fl.spec
    for layer in range(layers):
        if layer:
            fl = jfleet.snapshot(fl)
        for _ in range(writes_per_layer):
            ids = np.stack([
                rng.choice(spec.n_pages, batch, replace=False)
                for _ in range(spec.n_tenants)
            ]).astype(np.int32)
            data = rng.standard_normal(
                (spec.n_tenants, batch, spec.page_size)).astype(np.float32)
            fl = jfleet.write(fl, jnp.asarray(ids), jnp.asarray(data))
    assert not np.asarray(fl.overflow).any()
    return fl


def to_port(jf, js=None):
    """The JAX fleet (and store) as fresh port objects on the CPU."""
    spec = tfleet.FleetSpec(**{f.name: getattr(jf.spec, f.name)
                               for f in dataclasses.fields(jf.spec)
                               if f.name != "dtype"})
    tf = convert.fleet_from_numpy(
        spec, {n: np.asarray(getattr(jf, n)) for n in convert.FLEET_FIELDS},
        device="cpu")
    if js is None:
        return tf, None
    ts = convert.tiered_store_from_numpy(
        js.page_size, torch.float32, js._data, free=js._free, top=js._top,
        demoted_rows=js.demoted_rows, promoted_rows=js.promoted_rows)
    return tf, ts


def same_fleet(jf, tf):
    for name in convert.FLEET_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tf, name)),
                                      _np(getattr(jf, name)), err_msg=name)
    for t in range(jf.spec.n_tenants):
        assert tmigrate.tenant_fingerprint(tf, t) == \
            jmigrate.tenant_fingerprint(jf, t)


def same_store(js, ts):
    assert ts.stats() == js.stats() and ts._free == js._free
    top = js._top
    np.testing.assert_array_equal(ts.get(np.arange(top)).numpy(),
                                  js.get(np.arange(top)))


def same_blob(jb, tb):
    for f in BLOB_FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert b == a, f
    assert tb.nbytes() == jb.nbytes()


def _dst_kw(depth):
    """A destination with another tenant count, pool capacity, lease
    quantum, spare chain depth and default format flag."""
    return _kw(n_tenants=2, pool_capacity=8192, lease_quantum=16,
               max_chain=depth + 2)


def dst_pair(depth):
    jd = jfleet.create(jfleet.FleetSpec(**_dst_kw(depth)), scalable=False)
    td = tfleet.create(tfleet.FleetSpec(**_dst_kw(depth)), scalable=False,
                       device="cpu")
    return jd, JStore.for_fleet(jd.spec), td, TStore.for_fleet(td.spec)


@pytest.fixture(scope="module", params=[1, 64, 500])
def grown(request):
    """One grown JAX source fleet per depth (tenant 1 carries demoted
    layers), and the JAX migration of tenants 0 -> 1 and 1 -> 0 into a
    destination of another geometry: the reference of every resolver."""
    depth = request.param
    rng = np.random.default_rng(depth)
    fl = jfleet.create(jfleet.FleetSpec(**_kw(max_chain=depth + 1)),
                       scalable=True)
    fl = _grow(fl, rng, layers=depth,
               writes_per_layer=2 if depth < 500 else 1)
    store = JStore.for_fleet(fl.spec)
    fl, rep = jfleet.demote_tenants(fl, store, [1], max_rows=24)
    if depth > 1:
        assert rep["rows_demoted"] > 0
    jinv.check_fleet_invariants(fl, store=store)
    ref = []
    dst, dst_store, _, _ = dst_pair(depth)
    for t_src, t_dst in [(0, 1), (1, 0)]:
        src_store = store.clone()
        blob = jmigrate.export_tenant(fl, t_src, store=src_store)
        before = jmigrate.materialize_tenant(fl, t_src, store=src_store)
        src2, dst, report = jmigrate.migrate_tenant(
            fl, t_src, dst, t_dst, src_store=src_store, dst_store=dst_store,
            method="vanilla")
        ref.append(dict(t_src=t_src, t_dst=t_dst, blob=blob, before=before,
                        src=src2, src_store=src_store, dst=dst,
                        dst_store=dst_store.clone(), report=report))
    return depth, fl, store, ref


@pytest.mark.parametrize("method", RESOLVERS)
def test_round_trip_bit_identical(grown, method):
    """Every resolver × depth, into a different-geometry fleet, cold layers
    included: the port's blob, source, destination, stores, report and
    ``materialize_tenant`` equal the JAX migration's."""
    depth, jf, js, ref = grown
    _, _, td, tds = dst_pair(depth)
    for r in ref:
        tf, ts = to_port(jf, js)
        same_blob(r["blob"], tmigrate.export_tenant(tf, r["t_src"], store=ts))
        before = tmigrate.materialize_tenant(tf, r["t_src"], store=ts,
                                             method=method)
        np.testing.assert_array_equal(before.numpy(), r["before"])
        tf, td, report = tmigrate.migrate_tenant(
            tf, r["t_src"], td, r["t_dst"], src_store=ts, dst_store=tds,
            method=method)
        assert report == r["report"]
        assert report["length"] == depth and report["verified"]
        same_fleet(r["src"], tf)
        same_fleet(r["dst"], td)
        same_store(r["src_store"], ts)
        same_store(r["dst_store"], tds)
        after = tmigrate.materialize_tenant(td, r["t_dst"], store=tds,
                                            method=method)
        np.testing.assert_array_equal(after.numpy(), r["before"])
        # the plain read agrees wherever the destination copy is hot
        grid = np.broadcast_to(np.arange(N_PAGES, dtype=np.int32),
                               (td.spec.n_tenants, N_PAGES)).copy()
        data, res = tfleet.read(td, torch.as_tensor(grid), method=method)
        hot = ~res.cold[r["t_dst"]].numpy()
        np.testing.assert_array_equal(data[r["t_dst"]].numpy()[hot],
                                      after.numpy()[hot])
        tinv.check_fleet_invariants(tf, store=ts)
        tinv.check_fleet_invariants(td, store=tds)
        if r["t_src"] == 1:
            assert report["rows_cold"] == (0 if depth == 1 else
                                           int(td.cold_count[r["t_dst"]]))


def test_materialize_tenant_is_row_t_of_the_fleet(grown):
    """The one-tenant read equals row ``t`` of a read of every tenant, and
    the JAX package's ``materialize_tenant``."""
    depth, jf, js, _ = grown
    tf, ts = to_port(jf, js)
    grid = np.broadcast_to(np.arange(N_PAGES, dtype=np.int32),
                           (tf.spec.n_tenants, N_PAGES)).copy()
    full, _ = tfleet.read_tiered(tf, ts, torch.as_tensor(grid))
    for t in range(tf.spec.n_tenants):
        got = tmigrate.materialize_tenant(tf, t, store=ts)
        np.testing.assert_array_equal(got.numpy(), full[t].numpy())
        np.testing.assert_array_equal(
            got.numpy(), jmigrate.materialize_tenant(jf, t, store=js))


def test_detached_source_slot_is_clean(grown):
    depth, jf, js, _ = grown
    js = js.clone()
    tf, ts = to_port(jf, js)
    jd, jds, td, tds = dst_pair(depth)
    host_before = ts.host_rows_in_use()
    cold_held = int(tf.cold_count[1])
    jf2, jd, jrep = jmigrate.migrate_tenant(jf, 1, jd, 0, src_store=js,
                                            dst_store=jds)
    tf, td, trep = tmigrate.migrate_tenant(tf, 1, td, 0, src_store=ts,
                                           dst_store=tds)
    assert trep == jrep
    same_fleet(jf2, tf)
    same_fleet(jd, td)
    same_store(js, ts)
    same_store(jds, tds)
    assert int(tf.length[1]) == 1 and int(tf.lease_count[1]) == 0
    assert int(tf.cold_count[1]) == 0
    assert ts.host_rows_in_use() == host_before - cold_held
    assert tds.host_rows_in_use() == cold_held
    tinv.check_fleet_invariants(tf, store=ts)


def test_mid_migration_write_guard(grown):
    """A write landing between export and detach makes both packages'
    detach refuse, leaving the source intact."""
    depth, jf, js, _ = grown
    js = js.clone()
    tf, ts = to_port(jf, js)
    jblob = jmigrate.export_tenant(jf, 0, store=js)
    tblob = tmigrate.export_tenant(tf, 0, store=ts)
    ids = np.zeros((3, 1), np.int32)
    data = np.ones((3, 1, PAGE), np.float32)
    mask = np.asarray([True, False, False])
    jf2 = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data), jnp.asarray(mask))
    tf = tfleet.write(tf, torch.as_tensor(ids), torch.as_tensor(data),
                      torch.as_tensor(mask))
    with pytest.raises(jmigrate.MigrationError):
        jmigrate.detach_tenant(jf2, 0, jblob, store=js)
    with pytest.raises(tmigrate.MigrationError):
        tmigrate.detach_tenant(tf, 0, tblob, store=ts)
    same_fleet(jf2, tf)
    # un-written tenants detach fine with their own (fresh) blob
    jf3 = jmigrate.detach_tenant(jf2, 1, jmigrate.export_tenant(jf2, 1, store=js),
                                 store=js)
    tf = tmigrate.detach_tenant(tf, 1, tmigrate.export_tenant(tf, 1, store=ts),
                                store=ts)
    same_fleet(jf3, tf)
    same_store(js, ts)
    tinv.check_fleet_invariants(tf, store=ts)


def test_maintenance_after_export_is_also_stale(grown):
    """Streaming rewrites pointers without changing data; the guard treats
    that as staleness too, in both packages alike. (A length-1 chain has
    nothing to stream: its fresh export still detaches.)"""
    depth, jf, js, _ = grown
    js = js.clone()
    tf, ts = to_port(jf, js)
    jblob = jmigrate.export_tenant(jf, 0, store=js)
    tblob = tmigrate.export_tenant(tf, 0, store=ts)
    mask = np.asarray([True, False, False])
    jf2 = jfleet.stream_tenants(jf, mask, max(depth - 2, 0))
    tf = tfleet.stream_tenants(tf, mask, max(depth - 2, 0))
    same_fleet(jf2, tf)
    stale = jmigrate.tenant_fingerprint(jf2, 0) != jblob.fingerprint
    assert stale == (depth > 2)
    if stale:
        with pytest.raises(jmigrate.MigrationError):
            jmigrate.detach_tenant(jf2, 0, jblob, store=js)
        with pytest.raises(tmigrate.MigrationError):
            tmigrate.detach_tenant(tf, 0, tblob, store=ts)
    else:
        jf2 = jmigrate.detach_tenant(jf2, 0, jblob, store=js)
        tf = tmigrate.detach_tenant(tf, 0, tblob, store=ts)
    same_fleet(jf2, tf)


def test_blob_disk_round_trip(grown, tmp_path):
    """A blob saved by either package loads in the other, field for field,
    and installs byte for byte."""
    depth, jf, js, _ = grown
    tf, ts = to_port(jf, js)
    jblob = jmigrate.export_tenant(jf, 1, store=js)
    tblob = tmigrate.export_tenant(tf, 1, store=ts)
    jmigrate.save_blob(jblob, tmp_path / "jax.npz")
    tmigrate.save_blob(tblob, tmp_path / "port.npz")
    for load in (jmigrate.load_blob, tmigrate.load_blob):
        for name in ("jax.npz", "port.npz"):
            same_blob(jblob, load(tmp_path / name))
    want = jmigrate.materialize_tenant(jf, 1, store=js)
    jd, jds, td, tds = dst_pair(depth)
    jd = jmigrate.import_tenant(jd, 1, jmigrate.load_blob(tmp_path / "port.npz"),
                                store=jds)
    td = tmigrate.import_tenant(td, 1, tmigrate.load_blob(tmp_path / "jax.npz"),
                                store=tds)
    same_fleet(jd, td)
    same_store(jds, tds)
    np.testing.assert_array_equal(jmigrate.materialize_tenant(jd, 1, store=jds),
                                  want)
    np.testing.assert_array_equal(
        tmigrate.materialize_tenant(td, 1, store=tds).numpy(), want)


def test_import_refuses_geometry_mismatch():
    rng = np.random.default_rng(0)
    jf = _grow(jfleet.create(jfleet.FleetSpec(**_kw()), scalable=True), rng,
               layers=2)
    tf, _ = to_port(jf)
    blob = tmigrate.export_tenant(tf, 0)
    same_blob(jmigrate.export_tenant(jf, 0), blob)
    wide = dict(n_tenants=2, n_pages=2 * N_PAGES, page_size=PAGE, max_chain=8,
                pool_capacity=4096, lease_quantum=8, l2_per_table=2 * N_PAGES)
    for mig, mod, kw in ((jmigrate, jfleet, {}), (tmigrate, tfleet,
                                                  dict(device="cpu"))):
        with pytest.raises(mig.MigrationError, match="n_pages"):
            mig.import_tenant(mod.create(mod.FleetSpec(**wide), **kw), 0, blob)
    # max_chain == length fits exactly; one less refuses
    jd = jmigrate.import_tenant(
        jfleet.create(jfleet.FleetSpec(**_kw(max_chain=blob.length))), 0, blob)
    td = tmigrate.import_tenant(
        tfleet.create(tfleet.FleetSpec(**_kw(max_chain=blob.length)),
                      device="cpu"), 0, blob)
    same_fleet(jd, td)
    for mig, mod, kw in ((jmigrate, jfleet, {}), (tmigrate, tfleet,
                                                  dict(device="cpu"))):
        with pytest.raises(mig.MigrationError, match="max_chain"):
            mig.import_tenant(mod.create(mod.FleetSpec(
                **_kw(max_chain=blob.length - 1)), **kw), 0, blob)


def test_import_evicts_previous_occupant():
    """Landing a migrant in an occupied slot resets it first: the evictee's
    leases and host rows are returned, in both packages alike."""
    rng = np.random.default_rng(1)
    jf = _grow(jfleet.create(jfleet.FleetSpec(**_kw()), scalable=True), rng,
               layers=3)
    js = JStore.for_fleet(jf.spec)
    jf, _ = jfleet.demote_tenants(jf, js, [2], max_rows=8)
    tf, ts = to_port(jf, js)
    jd, jds, td, tds = dst_pair(3)
    for t_src in (2, 0):
        jd = jmigrate.import_tenant(jd, 0, jmigrate.export_tenant(jf, t_src, store=js),
                                    store=jds)
        td = tmigrate.import_tenant(td, 0, tmigrate.export_tenant(tf, t_src, store=ts),
                                    store=tds)
        same_fleet(jd, td)
        same_store(jds, tds)
    np.testing.assert_array_equal(
        tmigrate.materialize_tenant(td, 0, store=tds).numpy(),
        jmigrate.materialize_tenant(jf, 0, store=js))
    tinv.check_fleet_invariants(td, store=tds)


@pytest.mark.parametrize("fault", ["verify_miss", "stale_detach"])
def test_failed_migration_leaves_destination_slot_empty(monkeypatch, fault):
    """A migration that fails after the import (a destination that does
    not read back the source's bytes, or a detach that refuses a stale
    export) raises ``MigrationError`` in both packages and leaves both
    sources as they were. The JAX package's destination is the caller's
    untouched fleet; the port frees the slot it imported into, so its
    destination holds no tenant, no leases and no host rows, and a clean
    migration into the slot then lands as the JAX one does."""
    rng = np.random.default_rng(5)
    jf = _grow(jfleet.create(jfleet.FleetSpec(**_kw()), scalable=True), rng,
               layers=3)
    js = JStore.for_fleet(jf.spec)
    jf, _ = jfleet.demote_tenants(jf, js, [2], max_rows=8)
    tf, ts = to_port(jf, js)
    jd, jds, td, tds = dst_pair(3)
    for pkg in (jmigrate, tmigrate):
        if fault == "verify_miss":          # one page corrupted in transit
            real = pkg.import_tenant

            def corrupt(fleet, t, blob, *, store=None, _real=real):
                hot = blob.hot_pages.copy()
                hot[0, 0] += 1
                return _real(fleet, t, dataclasses.replace(blob, hot_pages=hot),
                             store=store)

            monkeypatch.setattr(pkg, "import_tenant", corrupt)
        else:                               # the source moved since export
            real = pkg.export_tenant

            def stale(fleet, t, *, store=None, _real=real):
                return dataclasses.replace(_real(fleet, t, store=store),
                                           fingerprint="0" * 64)

            monkeypatch.setattr(pkg, "export_tenant", stale)
    want = jmigrate.materialize_tenant(jf, 2, store=js)
    with pytest.raises(jmigrate.MigrationError):
        jmigrate.migrate_tenant(jf, 2, jd, 1, src_store=js, dst_store=jds)
    with pytest.raises(tmigrate.MigrationError):
        tmigrate.migrate_tenant(tf, 2, td, 1, src_store=ts, dst_store=tds)
    same_fleet(jf, tf)
    same_store(js, ts)
    np.testing.assert_array_equal(
        tmigrate.materialize_tenant(tf, 2, store=ts).numpy(), want)
    assert int(td.length[1]) == 1 and int(td.lease_count[1]) == 0
    assert int(td.alloc_count[1]) == 0 and int(td.cold_count[1]) == 0
    assert tfleet.fleet_stats(td)["rows_allocated"] == 0
    assert tds.host_rows_in_use() == 0
    tinv.check_fleet_invariants(td, store=tds)
    monkeypatch.undo()
    jds = JStore.for_fleet(jd.spec)
    jd = jmigrate.import_tenant(jd, 1, jmigrate.export_tenant(jf, 2, store=js),
                                store=jds)
    td = tmigrate.import_tenant(td, 1, tmigrate.export_tenant(tf, 2, store=ts),
                                store=tds)
    # the rows granted differ (the freed quanta went back to the free
    # list), the bytes the tenant serves do not
    np.testing.assert_array_equal(
        tmigrate.materialize_tenant(td, 1, store=tds).numpy(),
        jmigrate.materialize_tenant(jd, 1, store=jds))
    np.testing.assert_array_equal(
        tmigrate.materialize_tenant(td, 1, store=tds).numpy(), want)
    tinv.check_fleet_invariants(td, store=tds)


# -- serving plane: sequence migration between caches/engines ----------------


GEOM = dict(n_layers=2, n_kv_heads=1, head_dim=4, block_size=4, n_blocks=64,
            max_blocks_per_seq=8)
GEOM_DST = dict(GEOM, block_size=8, n_blocks=32)


def kv_pair(geom, scalable, dtype="float32"):
    return (jpaged.PagedKVCache(jpaged.PagedKVConfig(dtype=getattr(jnp, dtype),
                                                     **geom), scalable=scalable),
            tpaged.PagedKVCache(tpaged.PagedKVConfig(dtype=getattr(torch, dtype),
                                                     **geom), scalable=scalable,
                                device="cpu"))


def _toks(rng, n):
    shape = (2, n, 1, 4)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def append(pair, sid, k, v):
    pair[0].append_prefill(sid, jnp.asarray(k), jnp.asarray(v))
    pair[1].append_prefill(sid, torch.as_tensor(k), torch.as_tensor(v))


def same_blob_seq(jb, tb):
    for f in ("n_layers", "n_kv_heads", "head_dim", "dtype", "length",
              "fingerprint"):
        assert tb[f] == jb[f], f
    for f in ("k", "v"):
        np.testing.assert_array_equal(_np(tb[f]), _np(jb[f]), err_msg=f)


def same_cache(pair, sids):
    j, t = pair
    assert t.blocks_in_use() == j.blocks_in_use()
    assert t.host_blocks_in_use() == j.host_blocks_in_use()
    for sid in sids:
        for x, y in zip(j.gather(sid), t.gather(sid)):
            np.testing.assert_array_equal(_np(y), _np(x))
    jinv.check_kv_invariants(j)
    tinv.check_kv_invariants(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_migration_with_tombstoned_ancestor(dtype):
    """Migrate a forked child while its freed parent is a tombstone; the
    source-side free after migration reaps the whole dead chain. Blobs and
    fingerprints equal the JAX package's."""
    rng = np.random.default_rng(2)
    src = kv_pair(GEOM, False, dtype)          # vanilla: real parent links
    dst = kv_pair(GEOM_DST, True, dtype)
    root = src[1].new_seq()
    assert src[0].new_seq() == root
    append(src, root, *_toks(rng, 10))
    child = src[1].fork(root)
    assert src[0].fork(root) == child
    append(src, child, *_toks(rng, 5))
    for c in src:
        c.free_seq(root)
    assert src[1]._seqs[root].freed
    same_cache(src, [child])

    jb, tb = src[0].export_seq(child), src[1].export_seq(child)
    same_blob_seq(jb, tb)
    assert tb["dtype"] == dtype and tb["k"].device.type == "cpu"
    new = dst[1].import_seq(tb)
    assert dst[0].import_seq(jb) == new
    same_cache(dst, [new])
    np.testing.assert_array_equal(_np(dst[1].gather(new)[0]), _np(tb["k"]))

    for c in src:
        c.free_seq(child)                     # detach: the cascade reaps
    assert root not in src[1]._seqs and child not in src[1]._seqs
    assert src[1].blocks_in_use() == 0
    same_cache(src, [])


def test_seq_migration_of_spilled_sequence():
    """A parked (host-spilled) sequence migrates without being promoted on
    the source."""
    rng = np.random.default_rng(3)
    src = kv_pair(GEOM, False)
    dst = kv_pair(GEOM_DST, True)
    sid = src[1].new_seq()
    assert src[0].new_seq() == sid
    append(src, sid, *_toks(rng, 9))
    spilled = src[1].demote_seq(sid)
    assert spilled == src[0].demote_seq(sid) and spilled > 0
    host_before = src[1].host_blocks_in_use()
    jb, tb = src[0].export_seq(sid), src[1].export_seq(sid)
    same_blob_seq(jb, tb)
    assert src[1].host_blocks_in_use() == host_before   # residency untouched
    new = dst[1].import_seq(tb)
    assert dst[0].import_seq(jb) == new
    same_cache(src, [sid])
    same_cache(dst, [new])


@pytest.fixture(scope="module")
def f32_model():
    """Float32 compute in both packages (JAX's traces cleared around it)
    and the smoke model's weights in both."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        jcfg = j_smoke("qwen2.5-3b")
        jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        yield jcfg, t_smoke("qwen2.5-3b"), jparams, tparams
    jax.clear_caches()


@pytest.mark.parametrize("src_scalable", [False, True])
def test_engine_migration_decode_parity(f32_model, src_scalable):
    """A request forked off a tombstoned parent and migrated to an engine
    of another block size, pool size and format keeps decoding exactly as
    an unmigrated reference, and as the JAX engines do."""
    jcfg, tcfg, jparams, tparams = f32_model
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (9,), 0,
                                           jcfg.vocab_size))
    geoms = dict(src=dict(scalable=src_scalable, n_blocks=64, block_size=4,
                          max_blocks_per_seq=16),
                 dst=dict(scalable=not src_scalable, n_blocks=96, block_size=8,
                          max_blocks_per_seq=8),
                 ref=dict(scalable=True, n_blocks=64, block_size=4,
                          max_blocks_per_seq=16))
    j = {k: JEngine(jcfg, jparams, resolver="gather", **g) for k, g in geoms.items()}
    t = {k: TEngine(tcfg, tparams, device="cpu", **g) for k, g in geoms.items()}

    def both(name, op, *args):
        a, b = getattr(j[name], op)(*args), getattr(t[name], op)(*args)
        assert a == b, (name, op)
        return b

    a = both("src", "add_request", prompt)
    r = both("ref", "add_request", prompt)
    outs_a = [both("src", "step") for _ in range(2)]
    outs_r = [both("ref", "step") for _ in range(2)]
    assert [o[a] for o in outs_a] == [o[r] for o in outs_r]

    b = both("src", "fork_request", a)
    both("src", "finish_request", a)         # tombstone the parent
    new = t["src"].migrate_request_to(t["dst"], b)
    assert j["src"].migrate_request_to(j["dst"], b) == new
    assert not t["src"].active and new in t["dst"].active
    for name in ("src", "dst"):
        assert t[name].memory_stats() == j[name].memory_stats()
        tinv.check_kv_invariants(t[name].kv)

    outs_d = [both("dst", "step") for _ in range(3)]
    outs_r2 = [both("ref", "step") for _ in range(3)]
    assert [o[new] for o in outs_d] == [o[r] for o in outs_r2]

    # a decode landing mid-migration flips the fingerprint guard, and a
    # stale migration is refused with the destination rolled back
    c = both("src", "add_request", prompt)
    blob = t["src"].kv.export_seq(c)
    both("src", "step")
    assert t["src"].kv.seq_fingerprint(c) != blob["fingerprint"]
    real_export = t["src"].kv.export_seq
    t["src"].kv.export_seq = lambda sid: blob
    before = t["dst"].kv.blocks_in_use()
    with pytest.raises(RuntimeError, match="mid-migration"):
        t["src"].migrate_request_to(t["dst"], c)
    t["src"].kv.export_seq = real_export
    assert t["dst"].kv.blocks_in_use() == before and c in t["src"].active


def test_import_seq_refuses_model_geometry_mismatch():
    rng = np.random.default_rng(4)
    src = kv_pair(GEOM, True)
    sid = src[1].new_seq()
    src[0].new_seq()
    append(src, sid, *_toks(rng, 4))
    jb, tb = src[0].export_seq(sid), src[1].export_seq(sid)
    same_blob_seq(jb, tb)
    bad = dict(GEOM, n_layers=3, n_blocks=16, max_blocks_per_seq=4)
    tiny = dict(GEOM, n_blocks=16, max_blocks_per_seq=1)
    for cache, blob in zip(kv_pair(bad, True), (jb, tb)):
        with pytest.raises(ValueError, match="n_layers"):
            cache.import_seq(blob)
    long = {"length": 5, "k": np.zeros((2, 5, 1, 4), np.float32),
            "v": np.zeros((2, 5, 1, 4), np.float32)}
    for cache, blob in zip(kv_pair(tiny, True), (jb, tb)):
        with pytest.raises(ValueError, match="max_blocks_per_seq"):
            cache.import_seq({**blob, **long})
    _, other = kv_pair(GEOM, True, "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        other.import_seq(tb)
