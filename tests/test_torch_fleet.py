"""The port's ``ChainFleet`` data plane against ``repro.core.fleet``.

One seeded op sequence (create, write, masked snapshot, fork_tenant,
clone_tenant, stamp_entries, free_tenant, ...) is replayed on both
packages; after every op the L2 words, L1, lengths, lease state and pool
must match bit for bit, and every resolver method must give bit-identical
results.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fleet as jfleet  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import format as fmt  # noqa: E402

METHODS = ["vanilla", "gather", "direct", "auto", "pallas_vanilla", "pallas_direct"]
T, Q, CAP, C = 4, 16, 256, 6


def _specs(p):
    kw = dict(n_tenants=T, n_pages=p, page_size=8, max_chain=C,
              pool_capacity=CAP, lease_quantum=Q, l2_per_table=16, slice_len=4)
    return (jfleet.FleetSpec(dtype=jnp.float32, **kw),
            tfleet.FleetSpec(dtype=torch.float32, **kw))


def _state_equal(jf, tf):
    for name in convert.FLEET_FIELDS:
        want = np.asarray(getattr(jf, name))
        got = getattr(tf, name).numpy()
        if name in ("l1", "l2"):
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _resolvers_equal(jf, tf, rng, p):
    ids = np.stack([rng.permutation(p)[:24] for _ in range(T)]).astype(np.int32)
    for m in METHODS:
        want = jfleet.get_resolver(m)(jf, jnp.asarray(ids))
        got = tfleet.get_resolver(m)(tf, torch.as_tensor(ids))
        for field, w, g in zip(want._fields, want, got):
            w = np.asarray(w)
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{m}.{field}")


def _write(jf, tf, rng, p, bsz, mask):
    ids = np.stack([rng.permutation(p)[:bsz] for _ in range(T)]).astype(np.int32)
    data = rng.standard_normal((T, bsz, 8)).astype(np.float32)
    jf = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data), jnp.asarray(mask))
    tf = tfleet.write(tf, torch.as_tensor(ids), torch.as_tensor(data),
                      torch.as_tensor(mask))
    return jf, tf


@pytest.mark.parametrize("p", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_op_sequence_replays_bit_exact(p, seed):
    rng = np.random.default_rng(seed)
    jspec, tspec = _specs(p)
    scal = np.array([True, False, True, False])
    jf = jfleet.create(jspec, scalable=jnp.asarray(scal))
    tf = tfleet.create(tspec, scalable=scal, device="cpu")
    _state_equal(jf, tf)

    def step(jt):
        nonlocal jf, tf
        jf, tf = jt
        _state_equal(jf, tf)
        _resolvers_equal(jf, tf, rng, p)

    step(_write(jf, tf, rng, p, 12, np.array([True, True, True, False])))
    snap = np.array([True, True, False, True])
    step((jfleet.snapshot(jf, jnp.asarray(snap)), tfleet.snapshot(tf, snap)))
    step(_write(jf, tf, rng, p, 20, np.ones(T, bool)))
    step((jfleet.fork_tenant(jf, 0, 2), tfleet.fork_tenant(tf, 0, 2)))
    step((jfleet.clone_tenant(jf, 1, 3), tfleet.clone_tenant(tf, 1, 3)))
    # a vanilla tool snapshotting every image: copy-forward is skipped
    step((jfleet.snapshot(jf, None, False), tfleet.snapshot(tf, None, False)))
    # raw stamps, padded with the drop sentinel tenant id T
    k = 6
    ts = np.array([0, 1, 2, 3, T, T], np.int32)
    ls = rng.integers(0, 3, k).astype(np.int32)
    ps = rng.permutation(p)[:k].astype(np.int32)
    ent = np.asarray(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, CAP, k).astype(np.uint32)),
        jnp.asarray(ls.astype(np.uint32)), allocated=True,
        bfi_valid=jnp.asarray(rng.random(k) < 0.5)))
    step((jfleet.stamp_entries(jf, ts, ls, ps, ent),
          tfleet.stamp_entries(tf, ts, ls, ps, ent)))
    step((jfleet.free_tenant(jf, [1, 2]), tfleet.free_tenant(tf, [1, 2])))
    # freed quanta are re-leased; the pool runs short for some tenants
    step(_write(jf, tf, rng, p, 40, np.ones(T, bool)))
    step(_write(jf, tf, rng, p, 40, np.array([False, True, True, True])))
    step((jfleet.attach_tenant(jf, 3, scalable=True),
          tfleet.attach_tenant(tf, 3, scalable=True)))
    # snapshots up to max_chain: the dropped ones are flagged
    for _ in range(C):
        step((jfleet.snapshot(jf), tfleet.snapshot(tf)))


@pytest.mark.parametrize("scalable", [True, False])
def test_single_chain_ops_and_resolvers_match(scalable):
    """``core.chain`` create/write/snapshot and the chain-level resolver
    registry (a chain is a one-tenant fleet for the kernel entries)."""
    from repro.core import chain as jchain
    from repro.core import resolve as jres
    from repro_torch.core import chain as tchain
    from repro_torch.core import resolve as tres

    rng = np.random.default_rng(11)
    kw = dict(n_pages=64, page_size=4, max_chain=4, pool_capacity=40,
              l2_per_table=16, slice_len=4)
    jc = jchain.create(jchain.ChainSpec(dtype=jnp.float32, **kw), scalable=scalable)
    tc = tchain.create(tchain.ChainSpec(dtype=torch.float32, **kw),
                       scalable=scalable, device="cpu")
    for step in range(6):          # the pool overflows and the chain fills
        ids = rng.permutation(64)[:9].astype(np.int32)
        data = rng.standard_normal((9, 4)).astype(np.float32)
        jc = jchain.write(jc, jnp.asarray(ids), jnp.asarray(data))
        tc = tchain.write(tc, torch.as_tensor(ids), torch.as_tensor(data))
        if step % 2:
            jc, tc = jchain.snapshot(jc), tchain.snapshot(tc)
        for f in ("l1", "l2", "pool", "pool_cursor", "length", "overflow",
                  "snap_dropped"):
            want = np.asarray(getattr(jc, f))
            want = want.view(np.int32) if want.dtype == np.uint32 else want
            np.testing.assert_array_equal(getattr(tc, f).numpy(), want, err_msg=f)
    ids = np.arange(64, dtype=np.int32)
    for m in ("vanilla", "direct", "auto", "pallas_vanilla", "pallas_direct"):
        want = jres.get_resolver(m)(jc, jnp.asarray(ids))
        got = tres.get_resolver(m)(tc, torch.as_tensor(ids))
        for field, w, g in zip(want._fields, want, got):
            w = np.asarray(w)
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{m}.{field}")


def test_acquire_rows_matches():
    jspec, tspec = _specs(64)
    jf = jfleet.create(jspec)
    tf = tfleet.create(tspec, device="cpu")
    for t, n in ((0, 5), (2, 40), (0, 20)):
        jf, jrows = jfleet.acquire_rows(jf, t, n)
        tf, trows = tfleet.acquire_rows(tf, t, n)
        np.testing.assert_array_equal(trows, jrows)
        _state_equal(jf, tf)
    with pytest.raises(RuntimeError, match="exhausted"):
        tfleet.acquire_rows(tf, 1, CAP)


def test_fleet_from_numpy_round_trips():
    jspec, tspec = _specs(64)
    rng = np.random.default_rng(3)
    jf = jfleet.create(jspec, scalable=False)
    ids = np.stack([rng.permutation(64)[:10] for _ in range(T)]).astype(np.int32)
    jf = jfleet.write(jf, jnp.asarray(ids), jnp.ones((T, 10, 8), jnp.float32))
    jf = jfleet.snapshot(jf)
    tf = convert.fleet_from_numpy(
        tspec, {n: np.asarray(getattr(jf, n)) for n in convert.FLEET_FIELDS},
        device="cpu")
    _state_equal(jf, tf)
    _resolvers_equal(jf, tf, rng, 64)


def test_entry_points_default_to_the_card():
    """With no card and no explicit CPU request, an entry point raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        tfleet.create(_specs(64)[1])


@pytest.mark.parametrize("method", ["auto", "pallas_vanilla", "pallas_direct"])
def test_kernel_reads_gather_on_the_resolves_leaves(method, monkeypatch):
    """A fleet read on the kernels hands the resolve's own leaves to K5's
    entry for them and makes no ``store.readable_rows`` mask between the
    resolve and the gather. On the CPU, with P a multiple of 128 so that
    ``auto`` takes the kernel path, both run as their plain versions and
    give the plain gather's bytes of the same leaves, with holes, ZERO
    clusters and COLD pages reading +0.0."""
    from repro_torch.core import store as tstore
    from repro_torch.kernels.cow_gather import ops as cow_ops

    rng = np.random.default_rng(5)
    spec = dataclasses.replace(_specs(128)[1], pool_capacity=1024)
    tf = tfleet.create(spec, scalable=[True, False, True, False], device="cpu")
    for layer in range(4):
        if layer:
            tfleet.snapshot(tf)
        ids = np.stack([rng.permutation(128)[:40] for _ in range(T)]).astype(np.int32)
        tfleet.write(tf, torch.as_tensor(ids),
                     torch.as_tensor(rng.standard_normal((T, 40, 8)).astype(np.float32)))
    store = tstore.TieredStore.for_fleet(spec)
    tf, rep = tfleet.demote_tenants(tf, store, [1, 2], max_rows=30)
    assert rep["rows_demoted"] > 0
    tf.l2[0, :, :32, 0] |= fmt.FLAG_ZERO_I32            # ZERO clusters
    ids = torch.as_tensor(rng.integers(0, 128, (T, 64)).astype(np.int32))
    calls = []
    real = cow_ops.gather_fleet_resolved
    monkeypatch.setattr(cow_ops, "gather_fleet_resolved",
                        lambda *a: calls.append(a) or real(*a))

    def no_mask(res):
        raise AssertionError("a kernel read made the readable_rows mask")

    monkeypatch.setattr(tstore, "readable_rows", no_mask)
    data, res = tfleet.read(tf, ids, method=method)
    assert len(calls) == 1
    assert calls[0][0] is tf.pool
    assert all(a is b for a, b in zip(calls[0][1:], (res.ptr, res.found, res.zero, res.cold)))
    assert bool(res.zero.any()) and bool((~res.found).any())
    # demotion moves snapshot layers, and direct access reads the active one
    assert bool(res.cold.any()) == (method != "pallas_direct")
    monkeypatch.undo()
    want = tstore.gather_pages(tf.pool, res)
    assert torch.equal(data.view(torch.int32), want.view(torch.int32))
