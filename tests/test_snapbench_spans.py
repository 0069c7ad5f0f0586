"""The accepted benchmark's trace of a program that carries its own spans.

``fleet.read`` records ``fleet.read``, ``fleet.resolve`` and
``fleet.gather`` while a profiler records (``repro_torch.trace``). The
benchmark's ``tracing.summarize`` counts none of them as device work,
whatever the profiler mirrors onto the device's timeline, and keeps every
value it computes as it was without them; its breakdown of the idle gaps
names the innermost host range a gap falls in, which may now be a
program span. Each traced step holds the three spans inside the
harness's own ``snapbench.read``. On the card, an auto read's resolve is
one kernel that the layer map counts as K1's, and the trace of it is
complete.
"""

import importlib.util
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from snapbench import datagen, generator, harness, tracing  # noqa: E402
from snapbench.bench import Bench  # noqa: E402
from snapbench.systems import FleetProgram  # noqa: E402

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
SPANS = ("fleet.read", "fleet.resolve", "fleet.gather")
LAYERS = [dict(layer="resolve", kernels=["vanilla_fleet_kernel"],
               launches={"resolve_vanilla_fleet": "vanilla_fleet_kernel"}),
          dict(layer="gather", kernels=["gather_pages_kernel"],
               launches={"gather_fleet": "gather_pages_kernel"})]
LAUNCHED = {"resolve_vanilla_fleet": 2, "gather_fleet": 2}


def ev(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=float(start), end=float(end)))


def canned(spans: bool, host_ops: bool = True):
    """Two profiler steps of 100 µs. In each the harness's span is
    [5, 90], the read [10, 85], its resolve [10, 50] and gather [50, 85].
    Device: K1 [30, 50], K5 [60, 80] (step 2: +100), so the gaps inside a
    read are [10, 30] (resolve), [50, 60] (gather) and [80, 85]. With
    ``host_ops`` aten ops cover the first two, so the gaps are named alike
    with the program's spans or without them. With ``spans`` the read's
    three ranges are there, and so are the device-side mirrors the
    profiler adds for the inner two (flagged as user annotations, as on
    the card), which are no operation."""
    out = []
    for k in range(2):
        o = 100 * k
        out += [ev(f"ProfilerStep#{k}", o, o + 100, annotation=True),
                ev("snapbench.read", o + 5, o + 90, annotation=True),
                ev("cudaDeviceSynchronize", o + 88, o + 99),
                ev("vanilla_fleet_kernel", o + 30, o + 50, CUDA),
                ev("gather_pages_kernel", o + 60, o + 80, CUDA)]
        if host_ops:
            out += [ev("aten::bitwise_and", o + 10, o + 35),
                    ev("aten::empty", o + 50, o + 65)]
        if spans:
            out += [ev("fleet.read", o + 10, o + 85, annotation=True),
                    ev("fleet.resolve", o + 10, o + 50, annotation=True),
                    ev("fleet.gather", o + 50, o + 85, annotation=True),
                    ev("fleet.resolve", o + 30, o + 50, CUDA, annotation=True),
                    ev("fleet.gather", o + 60, o + 80, CUDA, annotation=True)]
    return out


def test_summarize_keeps_every_value_with_program_spans():
    bare = tracing.summarize(canned(False), LAYERS, LAUNCHED, 2, torch)
    full = tracing.summarize(canned(True), LAYERS, LAUNCHED, 2, torch)
    assert full == bare
    assert bare["complete"] and bare["busy_s"] == pytest.approx(80e-6)
    assert bare["window_s"] == pytest.approx(200e-6)
    assert bare["layer_s"] == pytest.approx(dict(resolve=40e-6, gather=40e-6))
    assert not any(name.startswith("fleet.") for name, _ in full["breakdown"]["device_ops"])


def _gaps(events) -> dict:
    out = tracing.summarize(events, LAYERS, LAUNCHED, 2, torch)
    return {name: pytest.approx(s) for name, s in out["breakdown"]["idle_gaps"]}


def test_idle_gaps_fall_to_the_innermost_program_span():
    """Without host ops in the way, a gap inside the read is named by the
    program span it falls in; without the program's spans, by the
    harness's. The gaps by hand (µs): [0, 30] (mid 15, in the resolve),
    [50, 60] and [150, 160] (in the gather), [80, 130] (mid 105, where the
    next step's harness span begins, before its read), [180, 200] (mid
    190, in the sync)."""
    assert _gaps(canned(False, host_ops=False)) == {
        "snapbench.read": (30 + 10 + 50 + 10) * 1e-6, "cudaDeviceSynchronize": 20e-6}
    assert _gaps(canned(True, host_ops=False)) == {
        "snapbench.read": 50e-6, "fleet.resolve": 30e-6, "fleet.gather": 20e-6,
        "cudaDeviceSynchronize": 20e-6}


def _tiny(tmp_path):
    """A copy of the benchmark with the tiny CPU cells of its own tests."""
    spec = importlib.util.spec_from_file_location(
        "snapbench_tests_conftest", ROOT / "snapbench" / "tests" / "conftest.py")
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "snapbench", tmp_path / "snapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cells = conf.add_tiny_cells(tmp_path)
    return Bench(tmp_path), cells


def _inside(outer, inner) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("which", [0, 3])
def test_traced_window_records_the_spans_inside_each_step(tmp_path, monkeypatch, which):
    bench, cells = _tiny(tmp_path)
    cell = bench.cell(cells[which])
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    seed = 2**33 + 17
    schedule = datagen.write_schedule(cfg, seed)
    ring = torch.as_tensor(generator.make_ring(
        mix, cfg, bench.reference(cfg)(cfg, schedule, seed), seed))
    system = FleetProgram(cfg, schedule, seed, "cpu")
    seen = []
    real = tracing.summarize

    def keep(events, *args):
        seen.append([(e.name, e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == CPU and e.is_user_annotation])
        return real(events, *args)

    monkeypatch.setattr(tracing, "summarize", keep)
    warm, active = 2, 3
    out = tracing.traced_window(system, lambda n: (ring[k % len(ring)] for k in range(n)),
                                bench.layers(), warm, active, harness.Device("cpu"),
                                torch, tries=1)
    system.close()
    assert not out["complete"] and out["steps"] == active     # the CPU has no device
    ranges = seen[0]
    steps = sorted(r[1:] for r in ranges if r[0].startswith("ProfilerStep"))
    assert len(steps) == active
    for step in steps:
        mine = {n: (s, e) for n, s, e in ranges if _inside(step, (s, e))}
        assert {"snapbench.read", *SPANS} <= set(mine)
        assert _inside(mine["snapbench.read"], mine["fleet.read"])
        assert _inside(mine["fleet.read"], mine["fleet.resolve"])
        assert _inside(mine["fleet.read"], mine["fleet.gather"])
        assert mine["fleet.resolve"][1] <= mine["fleet.gather"][0]
    assert sum(n in SPANS for n, _, _ in ranges) == 3 * active


@pytest.mark.gpu
def test_auto_read_is_one_k1_launch_in_the_trace():
    """One ``fleet.read(method="auto")`` adds 1 to K1's launch counter,
    0 to K2's and T × B to K1's pages, and 1 to K5's and to its entry on
    a resolve's leaves; its profiler trace holds exactly one device event
    whose name contains ``vanilla_fleet_kernel``, none with
    ``direct_fleet_kernel``, and no elementwise, ``where`` or ``select``
    kernel between it and K5's ``gather_pages_kernel`` (nor any on the
    host inside ``fleet.read``), so the accepted harness's ``summarize``
    sees as many launches as the counters made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fleet as tfleet
    from repro_torch.kernels import _build

    t, p, b = 4, 256, 32
    spec = tfleet.FleetSpec(n_tenants=t, n_pages=p, page_size=8, max_chain=8,
                            pool_capacity=1024, lease_quantum=16, dtype=torch.float32)
    fl = tfleet.create(spec, scalable=[True, False, True, False], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(4):
        ids = torch.stack([torch.randperm(p, generator=g, device="cuda")[:b]
                           for _ in range(t)]).to(torch.int32)
        tfleet.write(fl, ids, torch.randn((t, b, 8), generator=g, device="cuda"))
        tfleet.snapshot(fl)
    ids = torch.randint(0, p, (t, b), generator=g, device="cuda", dtype=torch.int32)
    tfleet.read(fl, ids, method="auto")
    torch.cuda.synchronize()
    before, pages = dict(_build.LAUNCHES), dict(_build.PAGES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tfleet.read(fl, ids, method="auto")
        torch.cuda.synchronize()
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched["resolve_vanilla_fleet"] == 1
    assert launched["resolve_direct_fleet"] == 0
    assert launched["gather_fleet"] == 1 and launched["gather_fleet_resolved"] == 1
    assert _build.PAGES["resolve_vanilla_fleet"] - pages["resolve_vanilla_fleet"] == t * b
    events = prof.events()
    device = sorted(tracing._device_events(events, torch), key=lambda e: e.time_range.start)
    names = [e.name for e in device]
    assert sum("vanilla_fleet_kernel" in n for n in names) == 1
    assert not any("direct_fleet_kernel" in n for n in names)
    k1 = next(i for i, n in enumerate(names) if "vanilla_fleet_kernel" in n)
    k5 = next(i for i, n in enumerate(names) if "gather_pages_kernel" in n)
    assert k1 < k5
    masks = ("bitwise", "where", "select", "elementwise")
    assert not [n for n in names[k1 + 1:k5] if any(m in n for m in masks)]
    read = next(e for e in events if e.name == "fleet.read"
                and e.device_type == CPU)
    inside = [e.name for e in events if e.device_type == CPU and e.name.startswith("aten::")
              and read.time_range.start <= e.time_range.start <= read.time_range.end]
    assert not [n for n in inside if any(m in n for m in ("bitwise", "where", "_to_copy"))]
    out = tracing.summarize(events, Bench(ROOT).layers(), launched, 0, torch)
    assert out["launches_seen"] == out["launches_made"]
    assert out["launches_made"]["vanilla_fleet_kernel"] == 1
