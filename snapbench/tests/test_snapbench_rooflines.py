"""The bytes a batch needs, from shapes: resolve bytes of each format for a
hit at each depth and for a hole, gather bytes of found clusters against
holes, and a cluster read twice in a batch counted once."""

import numpy as np
import pytest

from snapbench.rooflines import bytes as rb
from snapbench.rooflines.peaks import peaks

CB = 65536


@pytest.mark.parametrize("length", [1, 2, 7, 500])
def test_resolve_bytes_at_each_depth(length):
    owners = np.arange(length)
    # vanilla Qcow2: from the top (layer length - 1) down to the owner
    assert (rb.resolve_bytes("qcow2", length, owners) == 8 * (length - owners)).all()
    assert rb.resolve_bytes("qcow2", length, -1) == 8 * length       # a hole
    # sQemu: the top layer's entry alone, hit or hole
    assert (rb.resolve_bytes("sqemu", length, np.append(owners, -1)) == 8).all()
    with pytest.raises(ValueError):
        rb.resolve_bytes("vmdk", length, owners)


def test_gather_bytes_found_against_holes():
    assert rb.gather_bytes(found=0, outputs=10, cluster_bytes=CB) == 10 * CB
    assert rb.gather_bytes(found=10, outputs=10, cluster_bytes=CB) == 20 * CB


def test_batch_bytes_counts_each_input_once():
    version = np.array([[0, 3, -1, 1], [-1, -1, 0, 0]])
    lengths = np.array([4, 1])
    ids = np.array([[[1, 1, 2, 0], [3, 3, 3, 3]]])          # one batch, T 2, B 4
    resolve, gather = rb.batch_bytes("qcow2", ids, version, lengths, CB)
    # tenant 0 reads {0, 1, 2}: 4 + 1 + 4 entries; tenant 1 reads {3}: 1
    assert resolve.tolist() == [8 * (4 + 1 + 4 + 1)]
    # found and distinct: 2 + 1; every one of the 8 outputs is written
    assert gather.tolist() == [(3 + 8) * CB]
    resolve, gather = rb.batch_bytes("sqemu", ids, version, lengths, CB)
    assert resolve.tolist() == [8 * 4] and gather.tolist() == [(3 + 8) * CB]
    # a ring of batches gives one number a batch
    resolve, _ = rb.batch_bytes("qcow2", np.concatenate([ids, ids]), version, lengths, CB)
    assert resolve.shape == (2,)


def test_peaks_by_card_name():
    assert peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peaks("cpu") is None


def test_write_bytes_and_what_is_countable():
    assert rb.write_bytes(10, CB) == 10 * (2 * CB + 8)
    assert rb.resolve_countable("sqemu", dict(maintenance={}))
    assert rb.resolve_countable("qcow2", dict())
    assert not rb.resolve_countable("qcow2", dict(maintenance={}))


def test_replayed_bytes_follow_writes_and_snapshots():
    """Vanilla Qcow2: a cluster written in batch 0 sits in the top layer,
    one entry from the top; after batch 1's snapshot (and its write of
    another cluster), two. Its read is
    then of a found cluster, where set-up had a hole. sQemu reads one
    entry either way; with maintenance Qcow2's resolve is not countable."""
    from snapbench import datagen
    from snapbench.harness import ReplayedBytes, follow
    from snapbench.reference.cow_chain import CowChainReference

    cfg = dict(format="qcow2", tenants=1, disk_clusters=8, cluster_bytes=CB,
               base_fill=0.0, chain_length=3, layer_writes=1, max_chain=8)
    sched = datagen.write_schedule(cfg, 1)
    ref = CowChainReference(cfg, sched, 1)
    hole, other = np.flatnonzero(ref.version[0] < 0)[:2]
    ring = np.full((1, 1, 1), hole, np.int32)
    wring = np.asarray([hole, other], np.int32).reshape(2, 1, 1)
    mix = dict(snapshot_every=2)
    win = dict(first=0, batches=1)

    def counted(cfg, mix):
        count = ReplayedBytes(cfg, mix, ring, wring, win, [1])
        assert count.stop == 2
        assert follow(CowChainReference(cfg, sched, 1), mix, wring, [], count.stop,
                      count) == (0, 0)
        return count.result()

    got = counted(cfg, mix)
    assert got["window"] == dict(resolve=8.0, gather=2.0 * CB, write=2.0 * CB + 8)
    assert got["trace"] == dict(resolve=16.0, gather=2.0 * CB, write=2.0 * CB + 8)
    none = counted(cfg, dict(mix, maintenance={}))
    assert none["window"]["resolve"] is None and none["trace"]["gather"] == 2.0 * CB
    sq = counted(dict(cfg, format="sqemu"), dict(mix, maintenance={}))
    assert sq["window"]["resolve"] == sq["trace"]["resolve"] == 8.0
