"""The traced window: batches under ``torch.profiler``, reduced to device
time by layer, the device's busy time, and a breakdown.

Each batch is one profiler step. A trace counts as complete only where
the profiler saw, for every program kernel that a layer map names, as
many launches as the program's own counters (``_build.LAUNCHES``) made
while the steps were recorded; an incomplete trace is taken again.
"""

from __future__ import annotations

import numpy as np

SPAN = "snapbench.read"
TOP = 10


def _device_events(events, torch):
    """Operations that ran on the device; a ``record_function`` range's
    device-side mirror spans the whole read and is no operation."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != SPAN]


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged (start, end) rows of (N, 2) intervals."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged)


def layer_of(name: str, layers: list[dict]) -> str | None:
    for lay in layers:
        if any(k in name for k in lay["kernels"]):
            return lay["layer"]
    return None


def summarize(events, layers: list[dict], launched: dict | None, n_steps: int,
              torch) -> dict:
    """Device time by layer (seconds over the traced steps), busy and window
    seconds, whether the trace is complete, and the breakdown."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    steps = [e for e in cpu if e.name.startswith("ProfilerStep")]
    dev = _device_events(events, torch)
    if steps:
        w0 = min(e.time_range.start for e in steps)
        w1 = max(e.time_range.end for e in steps)
    else:
        w0 = w1 = 0.0
    window_s = (w1 - w0) / 1e6
    iv = np.asarray([[max(e.time_range.start, w0), min(e.time_range.end, w1)]
                     for e in dev], dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    busy = _union(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e6 if len(busy) else 0.0

    seen, want = {}, {}
    for lay in layers:
        for counter, kernel in lay.get("launches", {}).items():
            want[kernel] = want.get(kernel, 0) + (launched or {}).get(counter, 0)
            seen[kernel] = 0
    by_layer = {lay["layer"]: 0.0 for lay in layers}
    by_op = {}
    for e in dev:
        sec = (e.time_range.end - e.time_range.start) / 1e6
        by_op[e.name] = by_op.get(e.name, 0.0) + sec
        lay = layer_of(e.name, layers)
        if lay is not None:
            by_layer[lay] += sec
        for kernel in seen:
            if kernel in e.name:
                seen[kernel] += 1
    complete = (bool(dev) and len(steps) == n_steps and launched is not None
                and all(seen[k] == want[k] for k in want))

    gaps = np.stack([np.concatenate([[w0], busy[:, 1]]),
                     np.concatenate([busy[:, 0], [w1]])], axis=1) if len(busy) else \
        np.asarray([[w0, w1]])
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    host = [e for e in cpu if not e.name.startswith("ProfilerStep")]
    starts = np.asarray([e.time_range.start for e in host], np.float64)
    ends = np.asarray([e.time_range.end for e in host], np.float64)
    by_gap = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = (host[inside[np.argmin(ends[inside] - starts[inside])]].name
                if inside.size else "harness, between reads")
        by_gap[name] = by_gap.get(name, 0.0) + (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(complete=complete, steps=len(steps), window_s=window_s,
                busy_s=busy_s, layer_s=by_layer, launches_seen=seen,
                launches_made=want,
                breakdown=dict(device_ops=top(by_op), idle_gaps=top(by_gap)))


def traced_window(system, batches, layers: list[dict], warmup: int, active: int,
                  device, torch, tries: int = 3) -> dict:
    """``active`` batches under the profiler after ``warmup`` profiled but
    unrecorded ones, each read and synchronised as in the window; taken
    again, up to ``tries`` times, while the trace is incomplete."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU]
    if device.is_cuda:
        acts.append(ProfilerActivity.CUDA)
    counters = system.launches
    for attempt in range(tries):
        before = after = None
        device.sync()
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=warmup, active=active, repeat=1)) as prof:
            for k, ids in enumerate(batches(warmup + active)):
                if k == warmup and counters is not None:
                    before = dict(counters)
                with record_function(SPAN):
                    data, res = system.read(ids)
                device.sync()
                del data, res
                prof.step()
            if counters is not None:
                after = dict(counters)
        launched = (None if before is None
                    else {k: after[k] - before.get(k, 0) for k in after})
        out = summarize(prof.events(), layers, launched, active, torch)
        del prof
        out["tries"] = attempt + 1
        if out["complete"]:
            return out
    return out


def mean_lookups(system, batches, torch) -> float | None:
    """The program's mean ``ResolveResult.lookups`` a read over the
    ``batches``, read apart from the traced window (its sums are no part
    of the traced work)."""
    total = count = 0
    for ids in batches:
        _, res = system.read(ids)
        if res is None:
            return None
        total += int(res.lookups.sum(dtype=torch.int64))
        count += res.lookups.numel()
        del _, res
    return total / count if count else None
