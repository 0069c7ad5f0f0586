"""A run with the timed path broken underneath comes out not correct, for
each fault a read cell can have: half of the batch left out, and one
answer altered where it is produced. The harness's look for a card is
skipped (a CPU fleet); the rest of the run is the benchmark's own."""

import io

import pytest
from conftest import TINY_CELLS

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
        import torch
        data, res = super().read(ids)
        data[0, 0, 0] = torch.nextafter(data[0, 0, 0], torch.tensor(3.0))
        return data, res


@pytest.mark.parametrize("fault", [HalfBatch, AlteredAnswer])
@pytest.mark.parametrize("cell", TINY_CELLS)
def test_fault_is_caught(checkout, cell, fault):
    r = run_cell(checkout, cell, 31, 0.05, False, device="cpu", make_system=fault,
                 log=io.StringIO())
    assert not r["correct"] and r["compared"]["wrong_clusters"]["value"] > 0
