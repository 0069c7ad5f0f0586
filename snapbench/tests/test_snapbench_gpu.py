"""On the card: a tiny cell through the CUDA kernels (a cell that writes
included), and the command in a directory that holds only the manifest
and the benchmark's folder."""

import io
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, TINY_CELLS, TINY_WRITE_CELLS

from snapbench.harness import run_cell


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TINY_CELLS + TINY_WRITE_CELLS)
def test_tiny_cell_on_the_card(checkout, cell):
    need_card()
    for trace in (False, True):
        r = run_cell(checkout, cell, 41, 0.2, trace, device="cuda", log=io.StringIO())
        assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "idle_share" in r["metrics"]


@pytest.mark.gpu
def test_command_without_the_program_fails(tmp_path):
    need_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "snapbench", tmp_path / "snapbench")
    p = subprocess.run([sys.executable, "snapbench/run.py", "--workload",
                        "qcow2-fleet64.ycsb-c", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
