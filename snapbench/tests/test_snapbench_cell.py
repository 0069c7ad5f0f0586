"""One cell end to end at a tiny geometry on the CPU fleet: the result
line keeps the contract, and the command refuses to run without a card."""

import io
import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, TINY_CELLS, TINY_WRITE_CELLS

from snapbench import harness
from snapbench.harness import run_cell

E2E = {"ops_per_s": "ops/s", "io_p95_ms": "ms", "mem_per_data": "B/B", "setup_s": "s"}


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_result_line(checkout, cell):
    log = io.StringIO()
    r = run_cell(checkout, cell, 2**33 + 5, 0.2, False, device="cpu", log=log)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert {k: v["unit"] for k, v in line["metrics"].items()} == E2E
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["count"] == 1 and line["device"]["memory_peak_bytes"] > 0
    assert line["compared"]["wrong_clusters"] == {"value": 0, "limit": 0}
    tail = log.getvalue().splitlines()[-2:]
    assert tail[0].startswith("wrong_clusters 0 (limit: at most 0)")
    assert tail[1].startswith("checked_clusters ")


def test_traced_result_line(checkout):
    r = run_cell(checkout, TINY_CELLS[1], 11, 0.2, True, device="cpu", log=io.StringIO())
    # the CPU has no device trace: only the host span and the counter read
    assert set(r["metrics"]) == {"read_host_ms", "lookups_per_read"}
    assert r["metrics"]["lookups_per_read"]["value"] >= 1.0
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(checkout):
    from snapbench import datagen, generator
    from snapbench.bench import Bench
    bench = Bench(checkout)
    cell = bench.cell(TINY_CELLS[0])
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    rings = []
    for seed in (3, 3, 4):
        s = datagen.write_schedule(cfg, seed)
        rings.append(generator.make_ring(mix, cfg, bench.reference(cfg)(cfg, s, seed), seed))
    assert (rings[0] == rings[1]).all() and not (rings[0] == rings[2]).all()


def test_forbidden_module_withholds_the_result(checkout, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    log = io.StringIO()
    assert run_cell(checkout, TINY_CELLS[0], 1, 0.1, False, device="cpu", log=log) is None
    assert "loaded at the window's close: repro" in log.getvalue()
    assert harness.loaded_forbidden() == ["repro"]


def test_command_without_a_card_fails_and_prints_nothing(tmp_path):
    """Here there is no card; in a directory that holds only the manifest
    and the benchmark's folder there is no program either."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "snapbench", tmp_path / "snapbench")
    for root in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "snapbench/run.py", "--workload",
                            "qcow2-fleet64.ycsb-c", "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=root, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("cell", TINY_WRITE_CELLS)
def test_write_cell_is_correct(checkout, cell):
    """A tiny YCSB-A cell, writes, snapshots and ticks in its batches, on
    three seeds, untraced and traced: every read and every write it made
    read back as the reference has them."""
    for seed in (3, 2**31 + 77, 2**33 + 5):
        for trace in (False, True):
            log = io.StringIO()
            r = run_cell(checkout, cell, seed, 0.1, trace, device="cpu", log=log)
            assert r["correct"] is True and r["failed"] == 0, log.getvalue()
            assert list(r["compared"]) == ["wrong_clusters", "checked_clusters",
                                           "lost_writes"]
            assert r["compared"]["lost_writes"] == {"value": 0, "limit": 0}
            text = log.getvalue()
            assert "overflow: 0 disk(s), never" in text and "tick ms:" in text
            assert text.splitlines()[-1] == "lost_writes 0 (limit: at most 0)"
            written = int(text.split("written clusters ")[1].split(",")[0])
            assert written > 0
            # each batch reads 8 and writes 8 clusters a disk
            assert r["attempted"] % (4 * 16) == 0
    assert set(r["metrics"]) == {"read_host_ms", "lookups_per_read"}


def test_a_pool_that_runs_out_shows_refused_writes(checkout):
    """Without headroom the first writes overflow the pool: the program
    drops them and says so, and the run counts them under ``failed`` and
    comes out not correct, its reads of those clusters being stale."""
    cfg = checkout / "snapbench" / "configs" / "tiny-sqemu-w.json"
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()), pool_headroom_rows=0)))
    log = io.StringIO()
    r = run_cell(checkout, TINY_WRITE_CELLS[1], 5, 0.1, False, device="cpu", log=log)
    assert not r["correct"] and r["failed"] > 0
    assert r["compared"]["lost_writes"]["value"] == 0
    text = log.getvalue()
    assert "overflow: 4 disk(s), first at batch 0" in text
    # exactly the clusters whose newest write was refused read back old
    refused = int(text.split("newest write refused ")[1].split(",")[0])
    assert refused == r["failed"]

