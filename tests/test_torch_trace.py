"""The port's host spans and page counter.

``repro_torch.trace.span`` records a ``record_function`` range only while
a profiler records; ``fleet.read`` carries three spans, ``fleet.read``
with ``fleet.resolve`` and then ``fleet.gather`` inside it. On the card,
``_build.PAGES`` counts the pages the fleet resolvers were given beside
``_build.LAUNCHES`` (the ``gpu`` case skips here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

METHODS = ["auto", "vanilla", "direct", "pallas_vanilla", "pallas_direct"]
SPANS = ("fleet.read", "fleet.resolve", "fleet.gather")
T, P, B = 3, 64, 8


def small_fleet(device="cpu"):
    """Three tenants of 64 pages, two layers deep, on both formats."""
    spec = tfleet.FleetSpec(n_tenants=T, n_pages=P, page_size=4, max_chain=4,
                            pool_capacity=256, lease_quantum=16, l2_per_table=16,
                            slice_len=4, dtype=torch.float32)
    fl = tfleet.create(spec, scalable=np.array([True, False, True]), device=device)
    rng = np.random.default_rng(5)
    for _ in range(2):
        ids = np.stack([rng.permutation(P)[:B] for _ in range(T)]).astype(np.int32)
        data = rng.standard_normal((T, B, 4)).astype(np.float32)
        fl = tfleet.write(fl, torch.as_tensor(ids, device=device),
                          torch.as_tensor(data, device=device))
        fl = tfleet.snapshot(fl)
    ids = np.stack([rng.permutation(P)[:B] for _ in range(T)]).astype(np.int32)
    return fl, torch.as_tensor(ids, device=device)


@pytest.fixture
def counted(monkeypatch):
    """Count the entries of ``record_function`` under both of its names."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return calls


@pytest.mark.parametrize("method", METHODS)
def test_no_span_is_entered_without_a_profiler(counted, method):
    fl, ids = small_fleet()
    assert not torch._C._autograd._profiler_enabled()
    tfleet.read(fl, ids, method=method)
    assert counted == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tfleet.read(fl, ids, method=method)
    assert counted == list(SPANS)                     # the patch does see them


def test_span_is_a_shared_no_op_when_off():
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as x:
        assert x is None


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.is_user_annotation and e.name in SPANS]


@pytest.mark.parametrize("method", METHODS)
def test_read_spans_nest_in_order_under_a_profiler(method):
    fl, ids = small_fleet()
    want, _ = tfleet.read(fl, ids, method=method)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got, _ = tfleet.read(fl, ids, method=method)
    assert torch.equal(got, want)                      # the spans change nothing
    ranges = sorted(_ranges(prof), key=lambda r: r[1])
    assert [r[0] for r in ranges] == list(SPANS)
    (_, r0, r1), (_, s0, s1), (_, g0, g1) = ranges
    assert r0 <= s0 <= s1 <= g0 <= g1 <= r1


def test_spans_are_recorded_per_call_and_only_while_profiling():
    fl, ids = small_fleet()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            tfleet.read(fl, ids)
    tfleet.read(fl, ids)                               # after the profiler: none
    names = [r[0] for r in _ranges(prof)]
    assert {n: names.count(n) for n in SPANS} == {n: 3 for n in SPANS}


def test_reset_launches_clears_pages_beside_launches(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS, 4))
    monkeypatch.setattr(_build, "PAGES", dict.fromkeys(_build.KERNELS, 9))
    _build.reset_launches()
    assert set(_build.PAGES) == set(_build.LAUNCHES) == set(_build.KERNELS)
    assert not any(_build.PAGES.values()) and not any(_build.LAUNCHES.values())


def test_check_launch_counts_pages_beside_the_launch(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS, 0))
    monkeypatch.setattr(_build, "PAGES", dict.fromkeys(_build.KERNELS, 0))
    _build.check_launch("resolve_vanilla_fleet", 0, pages=T * P)
    _build.check_launch("gather_fleet", 0)
    with pytest.raises(RuntimeError):
        _build.check_launch("resolve_direct_fleet", 7, pages=5)
    assert _build.LAUNCHES["resolve_vanilla_fleet"] == 1
    assert _build.PAGES["resolve_vanilla_fleet"] == T * P
    assert _build.LAUNCHES["gather_fleet"] == 1 and _build.PAGES["gather_fleet"] == 0
    assert _build.LAUNCHES["resolve_direct_fleet"] == 0
    assert _build.PAGES["resolve_direct_fleet"] == 0


@pytest.mark.gpu
def test_auto_read_counts_each_resolvers_whole_map():
    """One ``fleet.read(method="auto")`` gives K1 and K2 T × P pages each;
    ``reset_launches`` clears both counters, and ``chip_smoke.uncounted``
    puts the pages back as well as the launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    import importlib.util
    from pathlib import Path

    fl, ids = small_fleet("cuda")
    tfleet.read(fl, ids, method="auto")
    _build.reset_launches()
    assert not any(_build.PAGES.values())
    tfleet.read(fl, ids, method="auto")
    torch.cuda.synchronize()
    assert _build.PAGES["resolve_vanilla_fleet"] == T * P
    assert _build.PAGES["resolve_direct_fleet"] == T * P
    assert _build.LAUNCHES["resolve_vanilla_fleet"] == 1
    assert _build.LAUNCHES["resolve_direct_fleet"] == 1
    assert _build.PAGES["gather_fleet"] == 0
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before, pages = dict(_build.LAUNCHES), dict(_build.PAGES)
    with smoke.uncounted(_build):
        tfleet.read(fl, ids, method="auto")
        assert _build.PAGES["resolve_vanilla_fleet"] == 2 * T * P
    assert _build.LAUNCHES == before and _build.PAGES == pages
    _build.reset_launches()
    assert not any(_build.PAGES.values()) and not any(_build.LAUNCHES.values())
