"""The plain reference against the port's CPU fleet: it agrees on every
cluster of both formats, and it catches one corrupted page and a pool
kept in bfloat16."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import TINY

from snapbench import datagen
from snapbench.reference.cow_chain import CowChainReference
from snapbench.systems import build_fleet

SEEDS = (0, 5, 2**33 + 1)


def tiny(fmt):
    return dict(TINY, format=fmt, base_fill=0.25)


def materialize(fl):
    from repro_torch.core import fleet as fleet_lib
    return fleet_lib.materialize(fl, method="auto")


def every_cluster(cfg):
    t, p = cfg["tenants"], cfg["disk_clusters"]
    return np.repeat(np.arange(t), p), np.tile(np.arange(p), t)


def fleet_of(cfg, seed, dtype=torch.float32):
    from repro_torch.core import fleet as fleet_lib
    sched = datagen.write_schedule(cfg, seed)
    return sched, build_fleet(fleet_lib, cfg, sched, seed, "cpu", dtype)


@pytest.mark.parametrize("fmt", ["qcow2", "sqemu"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_agrees_with_the_port(fmt, seed):
    cfg = tiny(fmt)
    sched, fl = fleet_of(cfg, seed)
    ref = CowChainReference(cfg, sched, seed)
    t, c = every_cluster(cfg)
    got = materialize(fl).reshape(-1, cfg["cluster_bytes"] // 4)
    assert ref.wrong_clusters(t, c, got) == 0
    # holes read +0.0 and data is never zero
    holes = ref.version[t, c] < 0
    assert holes.any() and (~holes).any()
    assert not got[torch.as_tensor(holes)].view(torch.int32).any()
    assert (got[torch.as_tensor(~holes)] >= 1.0).all()
    assert (ref.lengths == datagen.chain_targets(cfg["tenants"], cfg["chain_length"])).all()


def test_versions_follow_the_chain():
    """A cluster written in layer 0 and again in layer k reads layer k's
    version; layers a tenant's chain never reaches leave it alone."""
    cfg = tiny("qcow2")
    sched = datagen.write_schedule(cfg, 9)
    base = np.zeros((cfg["tenants"], 1), np.int32)
    layers = np.zeros_like(sched.layers)
    layers[:, :, 1] = 1
    sched = dataclasses.replace(sched, base=base, layers=layers)
    ref = CowChainReference(cfg, sched, 9)
    assert (ref.version[:, 0] == sched.targets - 1).all()
    assert (ref.version[:, 2:] == -1).all()


def test_one_corrupted_page_fails():
    cfg = tiny("sqemu")
    sched, fl = fleet_of(cfg, 3)
    ref = CowChainReference(cfg, sched, 3)
    t, c = every_cluster(cfg)
    got = materialize(fl).reshape(-1, cfg["cluster_bytes"] // 4)
    hit = int(np.flatnonzero(ref.version[t, c] >= 0)[5])
    got[hit, 7] = torch.nextafter(got[hit, 7], torch.tensor(3.0))
    assert ref.wrong_clusters(t, c, got) == 1


def test_a_bf16_pool_fails():
    cfg = tiny("qcow2")
    sched, fl = fleet_of(cfg, 4, torch.bfloat16)
    assert fl.pool.dtype == torch.bfloat16
    ref = CowChainReference(cfg, sched, 4)
    t, c = every_cluster(cfg)
    got = materialize(fl).to(torch.float32).reshape(-1, cfg["cluster_bytes"] // 4)
    found = int((ref.version[t, c] >= 0).sum())
    assert ref.wrong_clusters(t, c, got) == found > 0


def test_control_precision_differs_on_every_version():
    x = datagen.page_data(1, torch.arange(4)[:, None], 0, torch.arange(8)[None], 64)
    y = datagen.page_data(1, torch.arange(4)[:, None], 0, torch.arange(8)[None], 64,
                          torch.bfloat16)
    assert x.shape == (4, 8, 64) and ((x >= 1) & (x < 2)).all()
    assert (x.view(torch.int32) != y.view(torch.int32)).any(dim=-1).all()


@pytest.mark.parametrize("fmt", ["qcow2", "sqemu"])
def test_reference_follows_writes_snapshots_and_streaming(fmt):
    """The port's CPU fleet driven through ``FleetProgram``'s writes,
    snapshots and maintenance ticks, 40 batches, and the reference
    replaying the same snapshots and writes: every cluster of every disk
    reads alike, and a snapshot at ``max_chain`` is dropped on both."""
    from snapbench.harness import NEVER, BatchOps, WriteBank, replay
    from snapbench.systems import FleetProgram

    cfg = dict(tiny(fmt), pool_headroom_rows=96)
    mix = dict(kind="zipfian", over="allocated", writes_per_tenant=8, snapshot_every=3,
               ring_batches=8, maintenance=dict(stream_chain_threshold=4))
    seed = 2**33 + 3
    sched = datagen.write_schedule(cfg, seed)
    ref = CowChainReference(cfg, sched, seed)
    from snapbench import generator
    wring = generator.make_write_ring(mix, cfg, ref, seed)
    prog = FleetProgram(cfg, sched, seed, "cpu", maintenance=mix["maintenance"])
    ops = BatchOps(mix, prog, WriteBank(seed, wring, cfg["cluster_bytes"] // 4, "cpu"),
                   cfg["tenants"], cfg["disk_clusters"], "cpu")
    for _ in range(40):
        ops.before()
        ops.after()
    replay(ref, mix, wring, 0, ops.next)
    t, c = every_cluster(cfg)
    got = materialize(prog.fleet).reshape(-1, cfg["cluster_bytes"] // 4)
    assert ref.wrong_clusters(t, c, got) == 0
    assert (ref.written >= 0).sum() > 0 and prog.sched.ticks == 40
    assert prog.maintenance_stats()["tenants_streamed"] > 0
    seen = ops.pressure_seen()
    assert seen["refused"].shape == (4, cfg["disk_clusters"]) and not seen["refused"].any()
    assert (seen["first_refused"] == NEVER).all() and (seen["first_dropped"] == NEVER).all()

    # no maintenance: the chains grow to max_chain, and a snapshot there is
    # dropped; nothing reclaims the rows overwrites orphan, so the pool
    # holds them all
    cfg["pool_headroom_rows"] = 30 * 8
    ref = CowChainReference(cfg, sched, seed)
    prog = FleetProgram(cfg, sched, seed, "cpu")
    mix = dict(mix, maintenance=None)
    ops = BatchOps(mix, prog, WriteBank(seed, wring, cfg["cluster_bytes"] // 4, "cpu"),
                   cfg["tenants"], cfg["disk_clusters"], "cpu")
    for _ in range(30):
        ops.before()
        ops.after()
    replay(ref, mix, wring, 0, ops.next)
    assert (ref.lengths == prog.fleet.length.numpy()).all()
    assert (ref.lengths == cfg["max_chain"]).any()
    got = materialize(prog.fleet).reshape(-1, cfg["cluster_bytes"] // 4)
    assert ref.wrong_clusters(t, c, got) == 0
    seen = ops.pressure_seen()
    assert not seen["refused"].any() and (seen["first_dropped"] < NEVER).any()


def test_written_versions_differ_from_every_other():
    """A written version differs from set-up's version of its cluster and
    from the same bank row written by another batch or into another
    cluster, and rounding it through bfloat16 changes it."""
    v = datagen.page_data(4, torch.tensor([1]), torch.tensor([3]), torch.tensor([9]), 64)
    one = lambda batch, cluster, slot=0, dtype=torch.float32: datagen.written_data(
        4, torch.tensor([1]), torch.tensor([slot]), torch.tensor([batch]),
        torch.tensor([cluster]), 64, dtype)
    base = one(7, 9)
    for other in (v, one(8, 9), one(7, 10), one(7, 9, slot=1), one(7, 9, dtype=torch.bfloat16)):
        assert (base.view(torch.int32) != other.view(torch.int32)).any()
    assert torch.equal(base, one(7, 9))
    assert datagen.stamp(datagen.STAMP_LIMIT - 1).item() < 2.0
