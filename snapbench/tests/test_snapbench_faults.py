"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: half of the batch left out, and one answer
altered where it is produced; in a cell that writes also a dropped write,
half the disks' writes dropped, a write into the wrong cluster, and a
read served before its batch's write, and a write lost on a disk whose
other writes of the batch the program refused. The harness's look for a card is
skipped (a CPU fleet); the rest of the run is the benchmark's own."""

import io
import json

import pytest
import torch
from conftest import TINY_CELLS, TINY_WRITE_CELLS

from snapbench.harness import run_cell
from snapbench.systems import FleetProgram


class HalfBatch(FleetProgram):
    """The second half of the tenants' reads never produced."""

    def read(self, ids):
        data, res = super().read(ids)
        data[data.shape[0] // 2:] = 0
        return data, res


class AlteredAnswer(FleetProgram):
    """One cluster's first value of every batch altered by one ulp."""

    def read(self, ids):
        data, res = super().read(ids)
        data[0, 0, 0] = torch.nextafter(data[0, 0, 0], torch.tensor(3.0))
        return data, res


class DroppedWrite(FleetProgram):
    """Disk 0's first write of every batch never made."""

    def write(self, ids, data):
        super().write(ids[:, 1:], data[:, 1:])
        others = torch.arange(ids.shape[0], device=ids.device) > 0
        self._hold(self._lib.write(self.fleet, ids[:, :1], data[:, :1], others))


class HalfDisksWrites(FleetProgram):
    """The second half of the disks' writes never made."""

    def write(self, ids, data):
        first = torch.arange(ids.shape[0], device=ids.device) < ids.shape[0] // 2
        self._hold(self._lib.write(self.fleet, ids, data, first))


class WrongCluster(FleetProgram):
    """Each payload written into the cluster of the disk's next write."""

    def write(self, ids, data):
        super().write(ids.roll(1, dims=1), data)


class ReadBeforeWrite(FleetProgram):
    """A batch's writes made only after its read was served."""

    pending = None

    def write(self, ids, data):
        self.pending = (ids, data.clone())

    def read(self, ids):
        out = super().read(ids)
        if self.pending is not None:
            super().write(*self.pending)
            self.pending = None
        return out


@pytest.mark.parametrize("fault", [HalfBatch, AlteredAnswer])
@pytest.mark.parametrize("cell", TINY_CELLS + TINY_WRITE_CELLS)
def test_fault_is_caught(checkout, cell, fault):
    r = run_cell(checkout, cell, 31, 0.05, False, device="cpu", make_system=fault,
                 log=io.StringIO())
    assert not r["correct"] and r["compared"]["wrong_clusters"]["value"] > 0


@pytest.mark.parametrize("fault", [DroppedWrite, HalfDisksWrites, WrongCluster])
@pytest.mark.parametrize("cell", TINY_WRITE_CELLS)
def test_lost_write_is_caught(checkout, cell, fault):
    log = io.StringIO()
    r = run_cell(checkout, cell, 33, 0.05, False, device="cpu", make_system=fault, log=log)
    assert not r["correct"] and r["compared"]["lost_writes"]["value"] > 0
    assert r["failed"] == 0 and "overflow: 0 disk(s), never" in log.getvalue()


@pytest.mark.parametrize("cell", TINY_WRITE_CELLS)
def test_read_before_its_batchs_write_is_caught(checkout, cell):
    r = run_cell(checkout, cell, 35, 0.05, False, device="cpu",
                 make_system=ReadBeforeWrite, log=io.StringIO())
    assert not r["correct"] and r["compared"]["wrong_clusters"]["value"] > 0


@pytest.mark.parametrize("fault", [DroppedWrite, WrongCluster])
@pytest.mark.parametrize("cell", TINY_WRITE_CELLS)
def test_lost_write_beside_refused_ones_is_caught(checkout, cell, fault):
    """Without headroom every disk overflows from its first batch on, so
    the program refuses some of each batch's writes and the scheduler
    compacts the flagged disks: a write the program took and then lost
    counts as lost, not as refused."""
    cfg = checkout / "snapbench" / "configs" / f"{cell.split('.')[0]}.json"
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()), pool_headroom_rows=0)))
    log = io.StringIO()
    r = run_cell(checkout, cell, 37, 0.1, False, device="cpu", make_system=fault, log=log)
    assert not r["correct"] and r["compared"]["lost_writes"]["value"] > 0
    assert r["failed"] > 0 and "overflow: 4 disk(s), first at batch 0" in log.getvalue()
