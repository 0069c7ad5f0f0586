"""The manifest keeps the benchmark's contract, and every part is found by
name: configurations, traffic mixes, per-layer readers and layer maps, a
new cell included when it arrives as files and entries alone."""

import json
import re

import pytest
from conftest import ROOT, TINY_CELLS, TINY_WRITE_CELLS

from snapbench import generator
from snapbench.bench import Bench
from snapbench.harness import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: what the benchmark has to hold at the least; later cells and metrics add to it
END_TO_END = {"ops_per_s", "io_p95_ms", "mem_per_data", "setup_s"}
PER_LAYER = {"read_host_ms", "resolve_roofline", "lookups_per_read",
             "gather_roofline", "read_roofline", "idle_share"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "snapbench/run.py"] and m["paths"] == ["snapbench"]
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("snapbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in m["configs"]}
    cells = [w["name"] for w in m["workloads"]]
    assert len(set(cells)) == len(cells) and len(configs) == len(m["configs"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(cells)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert configs == {w["config"] for w in m["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for x in m[kind]:
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
            assert set(x.get("workloads", cells)) <= set(cells)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert END_TO_END <= set(e2e)
    assert all(0.01 <= x["bound"] <= 0.25 for x in e2e.values())
    assert PER_LAYER <= {x["name"] for x in m["per_layer"]}
    layers = {lay["layer"] for lay in Bench(ROOT).layers()}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        if x["source"] == "device_trace" and x["name"] != "idle_share":
            assert x["layer"] in layers
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    """``setup_s``, another end-to-end metric and a per-layer metric in
    every cell, and each per-layer metric only where the end-to-end metric
    it moves is reported."""
    bench = Bench(ROOT)
    for cell in (w["name"] for w in bench.manifest["workloads"]):
        e2e = {x["name"] for x in bench.metrics_of("end_to_end", cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = bench.metrics_of("per_layer", cell)
        assert per_layer and all(x["moves"] in e2e for x in per_layer)


def test_every_named_part_is_found():
    bench = Bench(ROOT)
    for w in bench.manifest["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert set(cfg["reduced"]) == set(
            next(c for c in bench.manifest["configs"] if c["name"] == w["config"])["reduced"])
        reference = bench.reference(cfg)
        assert callable(reference.expected) and callable(reference.wrong_clusters)
        assert bench.traffic(w["traffic"])["kind"] in generator.KINDS
        for m in bench.metrics_of("per_layer", w["name"]):
            assert callable(bench.metric_reader(m["name"]))
    for lay in bench.layers():
        assert lay["kernels"] and set(lay["launches"].values()) <= set(lay["kernels"])


def test_unknown_names_are_refused():
    bench = Bench(ROOT)
    with pytest.raises(KeyError):
        bench.cell("qcow2-fleet64.nope")
    with pytest.raises(KeyError):
        bench.config("nope")
    with pytest.raises(FileNotFoundError):
        bench.metric_reader("nope")


def test_a_cell_added_as_files_alone_runs(checkout):
    """The tiny cells arrive as new files and manifest entries; nothing of
    the harness is edited, and each runs end to end on the CPU."""
    bench = Bench(checkout)
    cells = TINY_CELLS + TINY_WRITE_CELLS
    assert [w["name"] for w in bench.manifest["workloads"]][-len(cells):] == cells
    for cell in cells:
        assert bench.config(cell.split(".")[0])["tenants"] == 4
        r = run_cell(checkout, cell, 7, 0.1, False, device="cpu")
        assert r["correct"] and set(r["metrics"]) == {"ops_per_s", "io_p95_ms",
                                                      "mem_per_data", "setup_s"}


def test_a_metric_added_as_a_file_alone_is_read(checkout):
    (checkout / "snapbench" / "metrics" / "batches_traced.py").write_text(
        "def read(run):\n    return float(run['trace']['steps'])\n")
    m = json.loads((checkout / "BENCHMARK.json").read_text())
    m["per_layer"].append(dict(name="batches_traced", unit="batches", better="higher",
                               source="device_trace", layer="device", moves="ops_per_s",
                               workloads=[TINY_CELLS[0]]))
    (checkout / "BENCHMARK.json").write_text(json.dumps(m))
    r = run_cell(checkout, TINY_CELLS[0], 8, 0.1, True, device="cpu")
    assert r["metrics"]["batches_traced"]["value"] == 48.0


def test_readers_read_spans_and_counters(checkout):
    """A traced run hands a reader the host seconds, count and idle
    seconds of every range (the harness's and the program's) and the
    program's counters over the traced steps, in a cell that writes too."""
    (checkout / "snapbench" / "metrics" / "write_host_ms.py").write_text(
        "def read(run):\n"
        "    s = run['spans'].get('snapbench.write')\n"
        "    return None if s is None else 1e3 * s['host_s'] / s['count']\n")
    (checkout / "snapbench" / "metrics" / "traced_ops.py").write_text(
        "def read(run):\n"
        "    c = run['counters']\n"
        "    return float(c['reads'] + c['writes'])\n")
    m = json.loads((checkout / "BENCHMARK.json").read_text())
    cells = [TINY_CELLS[0], TINY_WRITE_CELLS[0]]
    for name in ("write_host_ms", "traced_ops"):
        m["per_layer"].append(dict(name=name, unit="ms", better="lower",
                                   source="program_span", layer="fleet front",
                                   moves="ops_per_s", workloads=cells))
    (checkout / "BENCHMARK.json").write_text(json.dumps(m))
    read = run_cell(checkout, cells[0], 8, 0.1, True, device="cpu")
    assert "write_host_ms" not in read["metrics"]
    assert read["metrics"]["traced_ops"]["value"] == 48 * 4 * 16
    write = run_cell(checkout, cells[1], 8, 0.1, True, device="cpu")
    assert write["metrics"]["write_host_ms"]["value"] > 0
    assert write["metrics"]["traced_ops"]["value"] == 8 * 4 * (8 + 8)


def test_span_summary_by_hand():
    """Two steps of 100 µs; device busy [30, 50] and [60, 80] in each. The
    write range [0, 40] holds 10 µs of device time; the read range [40, 90]
    holds 30; a range outside the steps is left out."""
    import torch
    from types import SimpleNamespace

    from snapbench import tracing

    def ev(name, s, e, dev=False, ann=False):
        return SimpleNamespace(
            name=name, is_user_annotation=ann, time_range=SimpleNamespace(start=s, end=e),
            device_type=(torch.autograd.DeviceType.CUDA if dev
                         else torch.autograd.DeviceType.CPU))
    events = [ev("snapbench.tick", 300.0, 310.0, ann=True)]
    for o in (0.0, 100.0):
        events += [ev(f"ProfilerStep#{int(o)}", o, o + 100, ann=True),
                   ev("snapbench.write", o, o + 40, ann=True),
                   ev("snapbench.read", o + 40, o + 90, ann=True),
                   ev("snapbench.read", o + 40, o + 90, dev=True),
                   ev("k1", o + 30, o + 50, dev=True), ev("k5", o + 60, o + 80, dev=True),
                   ev("aten::empty", o + 1, o + 2)]
    got = tracing.span_summary(events, torch)
    assert set(got) == {"snapbench.write", "snapbench.read"}
    assert got["snapbench.write"] == dict(host_s=pytest.approx(80e-6), count=2,
                                          idle_s=pytest.approx(60e-6))
    assert got["snapbench.read"] == dict(host_s=pytest.approx(100e-6), count=2,
                                         idle_s=pytest.approx(40e-6))
