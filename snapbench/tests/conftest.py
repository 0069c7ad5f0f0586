"""Fixtures of the benchmark's CPU tests: a copy of the checkout's
benchmark with tiny cells added as files and manifest entries alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a tiny deployment of each format: 4 disks of 256 clusters of 256 bytes
TINY = dict(tenants=4, disk_clusters=256, cluster_bytes=256, chain_length=8,
            layer_writes=2, max_chain=16, lease_quantum=8)
TINY_MIX = {"ycsb-c": dict(reads_per_tenant=16, ring_batches=8),
            "dd": dict(reads_per_tenant=32, ring_batches=8)}
TINY_CELLS = [f"tiny-{f}.{m}-tiny" for f in ("qcow2", "sqemu") for m in TINY_MIX]
#: a tiny YCSB-A, reads and updates, on the tiny disks with room for the
#: window's writes: a snapshot of every disk every 4 batches and the
#: scheduler ticked each batch
TINY_HEADROOM = dict(pool_headroom_rows=96)
TINY_WRITE_MIX = dict(kind="zipfian", over="allocated", reads_per_tenant=8,
                      writes_per_tenant=8, snapshot_every=4,
                      maintenance=dict(stream_chain_threshold=4, max_tenants_per_tick=1),
                      ring_batches=8, warmup_batches=16, trace_warmup=2, trace_batches=8)
TINY_WRITE_CELLS = [f"tiny-{f}-w.ycsb-a-tiny" for f in ("qcow2", "sqemu")]


def add_tiny_cells(root: Path) -> list[str]:
    """Add the tiny configurations, mixes and cells to the checkout at
    ``root`` as new files and new manifest entries; returns the cells."""
    home = root / "snapbench"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for fmt in ("qcow2", "sqemu"):
        src = json.loads((home / "configs" / f"{fmt}-fleet64.json").read_text())
        for name, extra in ((f"tiny-{fmt}", {}), (f"tiny-{fmt}-w", TINY_HEADROOM)):
            (home / "configs" / f"{name}.json").write_text(
                json.dumps(dict(src, name=name, **TINY, **extra)))
            manifest["configs"].append(dict(
                name=name, source="test", file=f"snapbench/configs/{name}.json",
                reduced=sorted(TINY), why="a CPU test"))
    for mix, sizes in TINY_MIX.items():
        src = json.loads((home / "traffic" / f"{mix}.json").read_text())
        (home / "traffic" / f"{mix}-tiny.json").write_text(json.dumps(dict(src, **sizes)))
    (home / "traffic" / "ycsb-a-tiny.json").write_text(json.dumps(TINY_WRITE_MIX))
    cells = TINY_CELLS + TINY_WRITE_CELLS
    for cell in cells:
        cfg, mix = cell.split(".")
        manifest["workloads"].append(dict(name=cell, config=cfg, traffic=mix, chips=1,
                                          why="a CPU test"))
    for m in manifest["per_layer"]:
        m["workloads"] = m["workloads"] + cells
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return cells


@pytest.fixture
def checkout(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``snapbench/`` with the tiny cells."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "snapbench", tmp_path / "snapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(tmp_path)
    return tmp_path
