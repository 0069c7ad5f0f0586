"""The traced window: batches under ``torch.profiler``, reduced to device
time by layer, the device's busy time, and a breakdown.

Each batch is one profiler step. A trace counts as complete only where
the profiler saw, for every program kernel that a layer map names, as
many launches as the program's own counters (``_build.LAUNCHES``) made
while the steps were recorded; an incomplete trace is taken again.

The harness's own ranges are ``snapbench.<op>``: ``snapbench.read``
around each read and, in a mix that writes, ``snapbench.snapshot``,
``snapbench.stamp``, ``snapbench.write`` and ``snapbench.tick``. Beside
``summarize``, a traced window hands per-layer readers ``spans``
(``span_summary``: host seconds, count and device-idle seconds of every
range, the program's spans included) and ``counters`` (the program's
``launches`` and ``pages`` counters' deltas over the recorded steps, and
the ``reads`` and ``writes`` those steps issued).
"""

from __future__ import annotations

import numpy as np

SPAN = "snapbench.read"
TOP = 10


def _device_events(events, torch):
    """Operations that ran on the device; a ``record_function`` range's
    device-side mirror spans the whole op and is no operation."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("snapbench.")]


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


def _busy(events, torch):
    """The host events, the profiler steps, the traced window ``(w0, w1)``
    (µs) and the merged intervals in which a device operation ran."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    steps = [e for e in cpu if e.name.startswith("ProfilerStep")]
    dev = _device_events(events, torch)
    if steps:
        w0 = min(e.time_range.start for e in steps)
        w1 = max(e.time_range.end for e in steps)
    else:
        w0 = w1 = 0.0
    iv = np.asarray([[max(e.time_range.start, w0), min(e.time_range.end, w1)]
                     for e in dev], dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    return cpu, steps, dev, w0, w1, _union(iv)


def summarize(events, layers: list[dict], launched: dict | None, n_steps: int,
              torch) -> dict:
    """Device time by layer (seconds over the traced steps), busy and window
    seconds, whether the trace is complete, and the breakdown."""
    cpu, steps, dev, w0, w1, busy = _busy(events, torch)
    window_s = (w1 - w0) / 1e6
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


def span_summary(events, torch) -> dict:
    """For each ``record_function`` range on the host (the harness's and
    the program's, by name): its seconds inside the traced window
    (``host_s``), how many there were (``count``), and the seconds of them
    in which no device operation ran (``idle_s``)."""
    cpu, _, _, w0, w1, busy = _busy(events, torch)
    out = {}
    for e in cpu:
        if e.name.startswith("ProfilerStep") or not getattr(e, "is_user_annotation", False):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        ran = (np.clip(np.minimum(t, busy[:, 1]) - np.maximum(s, busy[:, 0]), 0, None).sum()
               if len(busy) else 0.0)
        d = out.setdefault(e.name, dict(host_s=0.0, count=0, idle_s=0.0))
        d["host_s"] += (t - s) / 1e6
        d["count"] += 1
        d["idle_s"] += (t - s - ran) / 1e6
    return out


def _counts(system, ops) -> dict:
    """The program's counters and the writes issued, as they stand."""
    return dict(launches=None if system.launches is None else dict(system.launches),
                pages=None if system.pages is None else dict(system.pages),
                writes=0 if ops is None else ops.writes)


def _delta(after: dict | None, before: dict | None) -> dict | None:
    if after is None or before is None:
        return None
    return {k: after[k] - before.get(k, 0) for k in after}


def traced_window(system, batches, layers: list[dict], warmup: int, active: int,
                  device, torch, tries: int = 3, ops=None) -> dict:
    """``active`` batches under the profiler after ``warmup`` profiled but
    unrecorded ones, each read and synchronised as in the window (with
    ``ops``, a ``harness.BatchOps``, its ops around the read, each in a
    range of its own); taken again, up to ``tries`` times, while the trace
    is incomplete. ``batches(n)`` gives the read ids of the next ``n``."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU]
    if device.is_cuda:
        acts.append(ProfilerActivity.CUDA)
    for attempt in range(tries):
        before, reads = None, 0
        device.sync()
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=warmup, active=active, repeat=1)) as prof:
            for k, ids in enumerate(batches(warmup + active)):
                if k == warmup:
                    before = _counts(system, ops)
                if ops is not None:
                    ops.before(record_function)
                with record_function(SPAN):
                    data, res = system.read(ids)
                if ops is not None:
                    ops.after(record_function)
                device.sync()
                if k >= warmup:
                    reads += ids.numel()
                del data, res
                prof.step()
            after = _counts(system, ops)
        launched = _delta(after["launches"], before and before["launches"])
        events = prof.events()
        out = summarize(events, layers, launched, active, torch)
        out["spans"] = span_summary(events, torch)
        out["counters"] = dict(launches=launched,
                               pages=_delta(after["pages"], before and before["pages"]),
                               reads=reads,
                               writes=after["writes"] - (before or after)["writes"])
        del prof, events
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
