"""The traffic generator: YCSB's scrambled Zipfian, the sequential dd
cursor, and one ring a seed."""

import numpy as np
import pytest

from snapbench import datagen, generator


class Items:
    """A stand-in reference: tenant t holds clusters t, t + 10, t + 20, ..."""

    def allocated(self, t):
        return np.arange(t, 1000, 10, dtype=np.int32)


CFG = dict(tenants=3, disk_clusters=1000)


def test_zipf_ranks_are_skewed_and_in_range():
    rng = np.random.default_rng(0)
    zeta = float(np.sum(1.0 / np.arange(1, 1001) ** generator.THETA))
    r = generator.zipf_ranks(rng, 200_000, n=1000, zetan=zeta)
    assert r.min() == 0 and r.max() < 1000
    share0 = (r == 0).mean()
    assert abs(share0 - 1 / zeta) < 0.01
    assert (r == 0).sum() > (r == 1).sum() > (r == 10).sum()


def test_fnv_hash_is_ycsbs():
    # FNV-1a over the 8 low-first octets of 0 and of 1 (computed by hand)
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = (h * 1099511628211) % 2**64
    want = h if h < 2**63 else 2**64 - h
    assert generator.fnv_hash64(np.array([0]))[0] == want
    assert len(set(generator.fnv_hash64(np.arange(1000)) % 997)) > 600


def test_scrambled_zipfian_ring_reads_allocated_clusters():
    mix = dict(kind="zipfian", over="allocated", reads_per_tenant=64, ring_batches=8)
    ring = generator.make_ring(mix, CFG, Items(), 2**33 + 7)
    assert ring.shape == (8, 3, 64) and ring.dtype == np.int32
    for t in range(3):
        assert (ring[:, t] % 10 == t).all()
    # scrambled: the hottest cluster is not the first allocated one
    vals, counts = np.unique(ring[:, 0], return_counts=True)
    assert counts.max() > 3 * np.median(counts)


def test_an_unknown_kind_is_refused():
    mix = dict(kind="uniform", over="disk", reads_per_tenant=4, ring_batches=2)
    with pytest.raises(ValueError):
        generator.make_ring(mix, CFG, Items(), 3)


def test_sequential_ring_wraps_around_the_disk():
    mix = dict(kind="sequential", over="disk", reads_per_tenant=100, ring_batches=10)
    ring = generator.make_ring(mix, CFG, Items(), 5)
    for t in range(3):
        flat = ring[:, t].reshape(-1)
        assert sorted(flat.tolist()) == list(range(1000))      # one pass, holes too
        assert ((np.diff(flat) == 1) | (np.diff(flat) == -999)).all()


def test_schedule_writes_distinct_clusters_a_layer():
    cfg = dict(tenants=4, disk_clusters=64, base_fill=0.25, layer_writes=3,
               chain_length=40)
    s = datagen.write_schedule(cfg, 12)
    assert s.base.shape == (4, 16) and s.layers.shape == (39, 4, 3)
    assert all(len(set(row)) == 16 for row in s.base)
    assert all(len(set(w)) == 3 for layer in s.layers for w in layer)
    assert s.targets.tolist() == [1, 14, 27, 40]


WRITE_MIX = dict(kind="zipfian", over="allocated", reads_per_tenant=16, ring_batches=8,
                 writes_per_tenant=32, snapshot_every=3)


def test_write_ring_is_unique_a_disk_and_leaves_the_reads_alone():
    ring = generator.make_write_ring(WRITE_MIX, CFG, Items(), 2**33 + 9)
    assert ring.shape == (8, 3, 32) and ring.dtype == np.int32
    for t in range(3):
        assert (ring[:, t] % 10 == t).all()
        assert all(len(set(row)) == 32 for row in ring[:, t])
    # Zipfian still: the hot clusters are written in most batches
    vals, counts = np.unique(ring[:, 0], return_counts=True)
    assert counts.max() == 8
    # the read ids are those of the same mix without writes
    reads = {k: v for k, v in WRITE_MIX.items()
             if k not in ("writes_per_tenant", "snapshot_every")}
    assert (generator.make_ring(WRITE_MIX, CFG, Items(), 4)
            == generator.make_ring(reads, CFG, Items(), 4)).all()
    assert generator.make_write_ring(reads, CFG, Items(), 4) is None


def test_write_ring_and_stamps_follow_the_seed():
    import torch

    from snapbench.harness import WriteBank
    rings = [generator.make_write_ring(WRITE_MIX, CFG, Items(), s) for s in (5, 5, 6)]
    assert (rings[0] == rings[1]).all() and not (rings[0] == rings[2]).all()
    banks = [WriteBank(s, rings[0], 16, "cpu") for s in (5, 5, 6)]
    stamped = [b.stamped(10)[1].clone() for b in banks]
    assert torch.equal(stamped[0], stamped[1]) and not torch.equal(stamped[0], stamped[2])
    ids, data = banks[0].stamped(11)
    assert torch.equal(ids, torch.as_tensor(rings[0][11 % 8]))
    assert (data[..., 0] == datagen.stamp(11)).all()
    assert torch.equal(data[..., 1], datagen.stamp(ids))
    # the stamp is all that differs from batch 10's, and each row is the
    # version the reference makes from (seed, tenant, slot, batch, cluster)
    assert torch.equal(data[..., 2:], stamped[0][..., 2:])
    t, w = torch.meshgrid(torch.arange(3), torch.arange(32), indexing="ij")
    want = datagen.written_data(5, t.reshape(-1), w.reshape(-1), torch.full((96,), 11),
                                ids.reshape(-1), 16)
    assert torch.equal(data.reshape(96, 16), want)
    assert ((data >= 1) & (data < 2)).all()


def test_snapshots_fall_on_every_nth_batch():
    due = [i for i in range(10) if generator.snapshot_due(WRITE_MIX, i)]
    assert due == [2, 5, 8]
    assert not any(generator.snapshot_due(dict(kind="zipfian"), i) for i in range(10))
