"""One run of one cell: set-up, the measured window, the traced window,
and the comparison with the plain reference.

The window is a closed loop with one batch in flight: a batch is one
``read`` over every tenant, due when the previous one completes, and
complete when its data is on the device (a CUDA event recorded after it
has been reached). Its latency runs from the previous batch's completion
to its own, both read from the device's clock. The window ends with the
first batch that completes after ``seconds``.

Correctness is judged once the window has closed and the program's state
is freed: every cluster of the window's last batch, and the clusters a
seeded reservoir sampled from the window's batches as they completed,
each against the newest version the reference works out from the seed.
"""

from __future__ import annotations

import resource
import subprocess
import sys
import time

import numpy as np
import torch

from snapbench import datagen, generator, tracing
from snapbench.bench import Bench
from snapbench.rooflines import bytes as rbytes
from snapbench.rooflines.peaks import peaks
from snapbench.systems import FleetProgram

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: one batch in ``SAMPLE_STRIDE`` is offered to the reservoir of sampled
#: clusters, which keeps ``SAMPLE_SLOTS`` batches' ``SAMPLE_ROWS`` clusters
SAMPLE_STRIDE, SAMPLE_SLOTS, SAMPLE_ROWS = 16, 32, 64
SAMPLE_TABLE = 8_192


class _HostEvent:
    """A completion mark on the host clock (a CPU run has no device clock)."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)


class Device:
    """The few device calls a run makes, with stand-ins on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.is_cuda = self.device.type == "cuda"

    def sync(self):
        if self.is_cuda:
            torch.cuda.synchronize()

    def event(self):
        if not self.is_cuda:
            return _HostEvent()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def reset_peak(self):
        if self.is_cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_reserved(self) -> int:
        if self.is_cuda:
            return torch.cuda.max_memory_reserved()
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def describe(self, peak: int) -> dict:
        if not self.is_cuda:
            return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=peak)
        out = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                   memory_peak_bytes=peak)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "-i", "0"],
                capture_output=True, text=True, timeout=30)
            out["nvidia_smi"] = smi.stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as exc:
            out["nvidia_smi"] = f"not read: {exc}"
        return out


class Sampler:
    """A seeded reservoir of clusters copied out of the window's batches as
    they complete, into a buffer made in set-up (so the memory held is the
    same in every run)."""

    def __init__(self, seed: int, n_flat: int, floats: int, device: Device):
        rng = datagen.rng_for(seed, 3)
        self.offset = int(rng.integers(SAMPLE_STRIDE))
        self.pos_host = rng.integers(0, n_flat, size=(SAMPLE_TABLE, SAMPLE_ROWS))
        self.pos = torch.as_tensor(self.pos_host, device=device.device)
        self.u = rng.random(SAMPLE_TABLE)
        self.buf = torch.empty((SAMPLE_SLOTS, SAMPLE_ROWS, floats),
                               dtype=torch.float32, device=device.device)
        self.held: list = [None] * SAMPLE_SLOTS
        self.offered = 0

    def warm(self, data):
        torch.index_select(data.reshape(-1, self.buf.shape[-1]), 0, self.pos[0],
                           out=self.buf[0])

    def take(self, i: int, data):
        if (i + self.offset) % SAMPLE_STRIDE:
            return
        s = self.offered
        self.offered += 1
        slot = s if s < SAMPLE_SLOTS else int(self.u[s % SAMPLE_TABLE] * (s + 1))
        if slot >= SAMPLE_SLOTS:
            return
        row = s % SAMPLE_TABLE
        torch.index_select(data.reshape(-1, self.buf.shape[-1]), 0, self.pos[row],
                           out=self.buf[slot])
        self.held[slot] = (i, row)


def run_window(system, ring_dev, start: int, seconds: float, sampler: Sampler,
               device: Device) -> dict:
    n_ring = ring_dev.shape[0]
    done, host_s = [], []
    device.sync()
    first = device.event()
    t0 = time.perf_counter()
    i = start
    while True:
        h0 = time.perf_counter()
        data, res = system.read(ring_dev[i % n_ring])
        host_s.append(time.perf_counter() - h0)
        sampler.take(i - start, data)
        ev = device.event()
        ev.synchronize()
        done.append(ev)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
        del data, res
    window_s = time.perf_counter() - t0
    marks = [first] + done
    lat_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    return dict(batches=i - start, first=start, seconds=window_s, host_s=host_s,
                latency_ms=lat_ms, last=data, last_index=i - 1)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", make_system=None, t_start: float | None = None,
             log=sys.stderr) -> dict | None:
    """One run of one cell; returns the result line's object, or ``None``
    after naming on ``log`` what made the run unfit to report."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    dev = Device(device)
    floats = cfg["cluster_bytes"] // 4
    t, b = cfg["tenants"], mix["reads_per_tenant"]

    marks = [("start", time.perf_counter())]
    schedule = datagen.write_schedule(cfg, seed)
    reference = bench.reference(cfg)(cfg, schedule, seed)
    ring = generator.make_ring(mix, cfg, reference, seed)
    marks.append(("inputs", time.perf_counter()))
    resolve_b, gather_b = rbytes.batch_bytes(cfg["format"], ring, reference.version,
                                             reference.lengths, cfg["cluster_bytes"])
    data_bytes = int(sum(schedule.base.shape[1] + cfg["layer_writes"]
                         * (schedule.targets.astype(np.int64) - 1))) * cfg["cluster_bytes"]

    system = (make_system or FleetProgram)(cfg, schedule, seed, dev.device)
    dev.sync()
    marks.append(("system", time.perf_counter()))
    ring_dev = torch.as_tensor(ring, device=dev.device)
    sampler = Sampler(seed, t * b, floats, dev)
    for k in range(mix["warmup_batches"]):
        data, _ = system.read(ring_dev[k % len(ring)])
        sampler.warm(data)
        del data, _
    dev.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = dev.peak_reserved()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start
    print("set-up s: before run_cell %.3f, " % (marks[0][1] - t_start)
          + ", ".join(f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
                      in zip(marks[:-1], marks[1:])), file=log)

    win = run_window(system, ring_dev, mix["warmup_batches"], seconds, sampler, dev)
    dev.sync()
    window_peak = dev.peak_reserved()
    traced = None
    if trace:
        nxt = win["last_index"] + 1
        batches = lambda n: (ring_dev[(nxt + k) % len(ring)] for k in range(n))
        traced = tracing.traced_window(system, batches, bench.layers(),
                                       mix["trace_warmup"], mix["trace_batches"],
                                       dev, torch)
        traced["ring_index"] = [(nxt + mix["trace_warmup"] + k) % len(ring)
                                for k in range(mix["trace_batches"])]
        traced["lookups_per_read"] = tracing.mean_lookups(
            system, (ring_dev[i] for i in traced["ring_index"]), torch)
        dev.sync()
    peak = max(setup_peak, window_peak, dev.peak_reserved())

    # the program's state goes before the reference runs
    last, last_index = win.pop("last"), win["last_index"]
    system.close()
    del system
    dev.reset_peak()

    t_check = time.perf_counter()
    last_ids = ring[last_index % len(ring)]
    wrong = reference.wrong_clusters(np.repeat(np.arange(t), b), last_ids.reshape(-1),
                                     last.reshape(-1, floats))
    checked = t * b
    del last
    for slot, held in enumerate(sampler.held):
        if held is None:
            continue
        i, row = held
        pos = sampler.pos_host[row]
        ids = ring[(win["first"] + i) % len(ring)]
        wrong += reference.wrong_clusters(pos // b, ids.reshape(-1)[pos],
                                          sampler.buf[slot])
        checked += len(pos)
    compared = dict(wrong_clusters=dict(value=wrong, limit=0),
                    checked_clusters=dict(value=checked, limit=t * b))
    correct = wrong <= 0 and checked >= t * b
    print(f"check s: {time.perf_counter() - t_check:.3f}", file=log)

    bad = loaded_forbidden()
    if bad:
        print(f"loaded at the window's close: {', '.join(bad)}", file=log)
        return None

    idx = (win["first"] + np.arange(win["batches"])) % len(ring)
    ops = win["batches"] * t * b
    if trace:
        print(f"trace: complete {traced['complete']} after {traced['tries']} "
              f"tries; launches seen {traced['launches_seen']}, made "
              f"{traced['launches_made']}", file=log)
        # what a per-layer reader reads (metrics/<name>.py)
        run = dict(window=win, trace=traced,
                   lookups_per_read=traced["lookups_per_read"],
                   peaks=peaks(torch.cuda.get_device_name(0)) if dev.is_cuda else None,
                   bytes=dict(window=dict(resolve=float(resolve_b[idx].sum()),
                                          gather=float(gather_b[idx].sum())),
                              trace=dict(resolve=float(resolve_b[traced["ring_index"]].sum()),
                                         gather=float(gather_b[traced["ring_index"]].sum()))))
        metrics = {}
        for m in bench.metrics_of("per_layer", workload):
            value = bench.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(ops_per_s=ops / win["seconds"],
                      io_p95_ms=float(np.percentile(win["latency_ms"], 95)),
                      mem_per_data=window_peak / data_bytes,
                      setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in bench.metrics_of("end_to_end", workload)}

    result = dict(correct=bool(correct), attempted=ops, failed=0, metrics=metrics,
                  device=dev.describe(peak))
    if trace:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"],
                                trace_complete=traced["complete"],
                                trace_tries=traced["tries"])
        result["breakdown"] = traced["breakdown"]
    result["compared"] = compared
    for name, c in compared.items():
        bound = "at most" if name == "wrong_clusters" else "at least"
        print(f"{name} {c['value']} (limit: {bound} {c['limit']})", file=log)
    return result
