"""The control: the plain reference in the program's place, each version
rounded through bfloat16, comes out not correct on every seed where the
program comes out correct (tiny cells on the CPU; on the card at the
cells' own size, ``python3 snapbench/control.py``)."""

import io

import pytest
from conftest import TINY_CELLS, TINY_WRITE_CELLS

from snapbench.bench import Bench
from snapbench.control import control_system
from snapbench.harness import run_cell

SEEDS = (21, 22, 2**33 + 23)


@pytest.mark.parametrize("cell", TINY_CELLS + TINY_WRITE_CELLS)
def test_control_fails_where_the_program_passes(checkout, cell):
    make = control_system(Bench(checkout))
    for seed in SEEDS:
        prog = run_cell(checkout, cell, seed, 0.05, False, device="cpu", log=io.StringIO())
        ctrl = run_cell(checkout, cell, seed, 0.05, False, device="cpu",
                        make_system=make, log=io.StringIO())
        assert prog["correct"] and prog["compared"]["wrong_clusters"]["value"] == 0
        assert not ctrl["correct"]
        assert ctrl["compared"]["wrong_clusters"]["value"] > 0
