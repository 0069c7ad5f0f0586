"""One run of one cell: set-up, the measured window, the traced window,
and the comparison with the plain reference.

The window is a closed loop with one batch in flight: a batch is one
``read`` over every tenant, due when the previous one completes, and
complete when its data is on the device (a CUDA event recorded after it
has been reached). Its latency runs from the previous batch's completion
to its own, both read from the device's clock. The window ends with the
first batch that completes after ``seconds``. In a mix that writes,
snapshots or ticks maintenance (``generator.py``), a batch is the
snapshot if due, the writes, the read and the tick (``BatchOps``); it is
still complete when its read's data is on the device, so a tick's time
falls in the next batch's latency, as a guest's next I/O waits for it.

Correctness is judged once the window has closed and the program's state
is freed: every cluster of the window's last batch, and the clusters a
seeded reservoir sampled from the window's batches as they completed,
each against the newest version the reference works out from the seed,
as of its own batch (the reference replays the batches' snapshots and
writes up to it). In a mix that writes, every cluster the run wrote is
read back first, through the program and before it is freed, after the
peak of memory has been read: each has to hold its newest write. One
that does not, where that newest write was refused, is a write the
program said it did not take (``failed``); any other is lost
(``lost_writes``, limit 0). A write is refused where the program gave its
disk's row no pool row and flagged the disk ``overflow``: ``fleet.write``
takes each row's pages from the front while the disk's leases last, so
the pages past the count its ``alloc_count`` grew by are the refused
ones (``BatchOps``). A refused write leaves the older version, which the
window's reads return: those reads count as wrong, so a run in which the
pool ran out is not correct either.
"""

from __future__ import annotations

import contextlib
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
#: clusters the read-back of a mix that writes reads a call
READ_BACK_CLUSTERS = 8_192
#: a batch index that no run reaches (no flag seen)
NEVER = 1 << 62


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


class WriteBank:
    """The payloads of a mix that writes: ``(T, W)`` rows made in set-up
    from the seed (``datagen.bank_data``), of which batch i stamps float 0
    with i and float 1 with each row's cluster before its writes, in two
    ``(T, W)`` device ops. The write ids' ring and their stamps are made in
    set-up too."""

    def __init__(self, seed: int, wring: np.ndarray, floats: int, device):
        t, w = wring.shape[1:]
        self.ids = torch.as_tensor(wring, device=device).to(torch.int64)
        self.cluster_stamps = datagen.stamp(self.ids)
        self.rows = datagen.bank_data(seed, torch.arange(t, device=device)[:, None],
                                      torch.arange(w, device=device)[None], floats)

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (self.ids, self.cluster_stamps, self.rows))

    def stamped(self, batch: int):
        """Batch ``batch``'s write ids ``(T, W)`` and payloads ``(T, W,
        floats)`` (the bank itself: the next batch stamps it again)."""
        if batch >= datagen.STAMP_LIMIT:
            raise RuntimeError(f"batch {batch} is past what a stamp holds")
        r = batch % self.ids.shape[0]
        self.rows[:, :, 0].fill_(datagen.stamp(batch).item())
        self.rows[:, :, 1].copy_(self.cluster_stamps[r])
        return self.ids[r], self.rows


class BatchOps:
    """What a batch of a mix that writes, snapshots or ticks does around
    its read, in ``generator.py``'s order: ``before`` the read the
    snapshot if due and the writes, ``after`` it the tick. Batches are
    counted from the first warm-up batch (``next``).

    Where the system keeps pressure flags (the program), each batch's
    writes also mark, on the device and in buffers made in set-up, which
    of them the program refused: the pages of a disk's row past the
    count its ``allocated()`` grew by in the write, where the write left
    the disk flagged ``overflow``. ``refused`` holds, for each ``(disk,
    cluster)``, whether its newest write was refused; ``first_refused``
    and ``first_dropped`` the first batch a disk refused a write, and the
    first after whose snapshot it stood ``snap_dropped``. They are read
    once, after the window. ``span`` wraps each op (a profiler range in
    the traced window)."""

    def __init__(self, mix: dict, system, bank: WriteBank | None, tenants: int,
                 clusters: int, device):
        self.mix, self.system, self.bank = mix, system, bank
        self.ticks = mix.get("maintenance") is not None
        self.next = self.writes = 0
        self.tick_s: list[float] = []
        self.refused = self.first_refused = self.first_dropped = self.cols = None
        if system.pressure() is not None:
            self.first_dropped = torch.full((tenants,), NEVER, dtype=torch.int64,
                                            device=device)
            if bank is not None:
                self.refused = torch.zeros((tenants, clusters), dtype=torch.bool,
                                           device=device)
                self.first_refused = torch.full_like(self.first_dropped, NEVER)
                self.cols = torch.arange(bank.ids.shape[-1], device=device)[None]

    def before(self, span=contextlib.nullcontext):
        i = self.next
        if generator.snapshot_due(self.mix, i):
            with span("snapbench.snapshot"):
                self.system.snapshot()
            if self.first_dropped is not None:
                torch.minimum(self.first_dropped,
                              torch.where(self.system.pressure()[1], i, NEVER),
                              out=self.first_dropped)
        if self.bank is not None:
            with span("snapbench.stamp"):
                ids, data = self.bank.stamped(i)
            if self.refused is not None:
                taken = self.system.allocated().clone()
            with span("snapbench.write"):
                self.system.write(ids, data)
            if self.refused is not None:
                taken = self.system.allocated() - taken
                refused = (self.cols >= taken[:, None]) & self.system.pressure()[0][:, None]
                self.refused.scatter_(1, ids, refused)
                # a row's refused pages are its last ones
                torch.minimum(self.first_refused, torch.where(refused[:, -1], i, NEVER),
                              out=self.first_refused)
            self.writes += ids.numel()

    def after(self, span=contextlib.nullcontext):
        if self.ticks:
            t0 = time.perf_counter()
            with span("snapbench.tick"):
                self.system.tick()
            self.tick_s.append(time.perf_counter() - t0)
        self.next += 1

    @property
    def nbytes(self) -> int:
        """Device bytes the harness holds for the batch's ops."""
        return (0 if self.bank is None else self.bank.nbytes) + sum(
            x.numel() * x.element_size()
            for x in (self.refused, self.first_refused, self.first_dropped, self.cols)
            if x is not None)

    def pressure_seen(self) -> dict | None:
        """What the batches saw of the program's pressure, on the host:
        ``refused`` ``(T, clusters)`` bool (``None`` in a mix that does
        not write), and the first batch a disk refused a write,
        ``first_refused``, and stood ``snap_dropped``, ``first_dropped``
        (``(T,)``; ``NEVER``: not seen). ``None`` where the system has no
        flags."""
        if self.first_dropped is None:
            return None
        host = lambda x: None if x is None else x.cpu().numpy()
        return dict(refused=host(self.refused), first_refused=host(self.first_refused),
                    first_dropped=host(self.first_dropped))


def replay(reference, mix: dict, wring: np.ndarray | None, start: int, stop: int):
    """Bring the reference through batches ``start`` .. ``stop - 1``: each
    one's snapshot if due, then its writes."""
    for i in range(start, stop):
        if generator.snapshot_due(mix, i):
            reference.snapshot()
        if wring is not None:
            reference.write(i, wring[i % len(wring)])


def read_back(system, reference, floats: int, device: Device):
    """Every cluster the run wrote, read through the program, ``(T, C)``
    at a time, against the reference's newest versions. Returns the ids
    ``(T, n)`` (a disk's row padded with its first id), which of them were
    written and which read back wrong."""
    written = reference.written >= 0
    t = written.shape[0]
    per = [np.flatnonzero(row) for row in written]
    width = max(1, max(len(x) for x in per))
    ids = np.zeros((t, width), np.int32)
    valid = np.zeros((t, width), bool)
    for i, x in enumerate(per):
        ids[i] = x[0] if len(x) else 0
        ids[i, :len(x)] = x
        valid[i, :len(x)] = True
    bad = np.zeros((t, width), bool)
    step = max(1, READ_BACK_CLUSTERS // t)
    for lo in range(0, width, step):
        chunk = ids[:, lo:lo + step]
        data, _ = system.read(torch.as_tensor(np.ascontiguousarray(chunk),
                                              device=device.device))
        bad[:, lo:lo + step] = reference.mismatched(
            np.repeat(np.arange(t), chunk.shape[1]), chunk.reshape(-1),
            data.reshape(-1, floats)).reshape(t, -1)
        del data, _
    return ids, valid, bad & valid


def run_window(system, ring_dev, start: int, seconds: float, sampler: Sampler,
               device: Device, ops: BatchOps | None = None) -> dict:
    n_ring = ring_dev.shape[0]
    done, host_s = [], []
    device.sync()
    first = device.event()
    t0 = time.perf_counter()
    i = start
    while True:
        if ops is not None:
            ops.before()
        h0 = time.perf_counter()
        data, res = system.read(ring_dev[i % n_ring])
        host_s.append(time.perf_counter() - h0)
        sampler.take(i - start, data)
        ev = device.event()
        if ops is not None:
            ops.after()
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


def _writes_log(ops: BatchOps, system, win: dict, log) -> np.ndarray | None:
    """What a run that writes saw of the program's pressure flags and its
    maintenance, on ``log``; returns whether each ``(disk, cluster)``'s
    newest write was refused (``None`` where nothing was recorded)."""
    seen = ops.pressure_seen()
    if seen is not None:
        for name, key in (("overflow", "first_refused"), ("snap_dropped", "first_dropped")):
            if seen[key] is None:
                continue
            first = seen[key][seen[key] < NEVER]
            at = f"first at batch {int(first.min())}" if len(first) else "never"
            print(f"{name}: {len(first)} disk(s), {at}", file=log)
    if ops.tick_s:
        ms = 1e3 * np.asarray(ops.tick_s)
        print(f"tick ms: mean {ms.mean():.4f}, p50 {np.median(ms):.4f}, "
              f"p95 {np.percentile(ms, 95):.4f}, max {ms.max():.4f} over {len(ms)}",
              file=log)
    lat = np.asarray(win["latency_ms"])
    print(f"batch ms: mean {lat.mean():.4f}, p50 {np.median(lat):.4f}; "
          f"window batches {win['first']}..{win['last_index']}, run batches {ops.next}",
          file=log)
    stats = system.maintenance_stats()
    if stats is not None:
        print("maintenance: " + ", ".join(f"{k} {v}" for k, v in stats.items()), file=log)
    return None if seen is None else seen["refused"]


def follow(reference, mix: dict, wring: np.ndarray | None, items: list, stop: int,
           count=None) -> tuple[int, int]:
    """Walk ``reference`` forward through batches ``0 .. stop - 1`` (each
    one's snapshot if due, then its writes; nothing in a read mix), and at
    each batch check the reads ``items`` ((batch, tenants, clusters, data))
    due there against it and hand it to ``count(batch, reference)``.
    Returns the wrong and the checked clusters."""
    due: dict = {}
    for item in items:
        due.setdefault(item[0], []).append(item[1:])
    wrong = checked = 0
    for i in range(stop):
        replay(reference, mix, wring, i, i + 1)
        for tenants, clusters, got in due.pop(i, ()):
            wrong += reference.wrong_clusters(tenants, clusters, got)
            checked += len(tenants)
        if count is not None:
            count(i, reference)
    if due:
        raise ValueError(f"reads of batches {sorted(due)} past the walk's {stop}")
    return wrong, checked


class ReplayedBytes:
    """The bytes of the window's and the traced batches of a mix that
    writes, each batch's reads counted against the versions the reference
    holds as ``follow`` walks it there (``rooflines.bytes``), and its
    writes; resolve ``None`` where the format's bytes are not countable."""

    def __init__(self, cfg: dict, mix: dict, ring: np.ndarray, wring: np.ndarray | None,
                 win: dict, traced: list[int]):
        self.fmt, self.cb, self.ring = cfg["format"], cfg["cluster_bytes"], ring
        self.batches = dict(window=range(win["first"], win["first"] + win["batches"]),
                            trace=set(traced))
        self.sums = {key: dict(resolve=0.0, gather=0.0) for key in self.batches}
        self.stop = max(win["first"] + win["batches"], max(traced) + 1)
        self.writes = 0 if wring is None else wring.shape[1] * wring.shape[2]
        self.countable = rbytes.resolve_countable(self.fmt, mix)

    def __call__(self, i: int, reference):
        keys = [key for key, b in self.batches.items() if i in b]
        if not keys:
            return
        r, g = rbytes.batch_bytes(self.fmt, self.ring[i % len(self.ring)],
                                  reference.version, reference.lengths, self.cb)
        for key in keys:
            self.sums[key]["resolve"] += float(r)
            self.sums[key]["gather"] += float(g)

    def result(self) -> dict:
        out = {}
        for key, batches in self.batches.items():
            out[key] = dict(self.sums[key],
                            write=float(rbytes.write_bytes(len(batches) * self.writes, self.cb)))
            if not self.countable:
                out[key]["resolve"] = None
        return out


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
    w = mix.get("writes_per_tenant", 0)
    if w and cfg["disk_clusters"] > datagen.STAMP_LIMIT:
        raise ValueError(f"cluster ids reach {cfg['disk_clusters']}, past what a stamp holds")
    has_ops = bool(w or mix.get("snapshot_every") or mix.get("maintenance") is not None)

    marks = [("start", time.perf_counter())]
    schedule = datagen.write_schedule(cfg, seed)
    reference = bench.reference(cfg)(cfg, schedule, seed)
    ring = generator.make_ring(mix, cfg, reference, seed)
    wring = generator.make_write_ring(mix, cfg, reference, seed)
    marks.append(("inputs", time.perf_counter()))
    resolve_b, gather_b = rbytes.batch_bytes(cfg["format"], ring, reference.version,
                                             reference.lengths, cfg["cluster_bytes"])
    data_bytes = int(sum(schedule.base.shape[1] + cfg["layer_writes"]
                         * (schedule.targets.astype(np.int64) - 1))) * cfg["cluster_bytes"]

    make = make_system or FleetProgram
    if mix.get("maintenance") is not None:
        system = make(cfg, schedule, seed, dev.device, maintenance=mix["maintenance"])
    else:
        system = make(cfg, schedule, seed, dev.device)
    dev.sync()
    marks.append(("system", time.perf_counter()))
    ring_dev = torch.as_tensor(ring, device=dev.device)
    sampler = Sampler(seed, t * b, floats, dev)
    ops = None
    if has_ops:
        bank = None if wring is None else WriteBank(seed, wring, floats, dev.device)
        ops = BatchOps(mix, system, bank, t, cfg["disk_clusters"], dev.device)
        mine = (ring_dev.numel() * ring_dev.element_size()
                + sampler.buf.numel() * sampler.buf.element_size() + ops.nbytes)
        card = (torch.cuda.get_device_properties(0).total_memory if dev.is_cuda
                else None)
        print(f"harness buffers B: {mine} (write bank, ids and refusal map {ops.nbytes})"
              + ("" if card is None else f", {100 * mine / card:.3f} % of the card"),
              file=log)
    for k in range(mix["warmup_batches"]):
        if ops is not None:
            ops.before()
        data, _ = system.read(ring_dev[k % len(ring)])
        sampler.warm(data)
        if ops is not None:
            ops.after()
        del data, _
    dev.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = dev.peak_reserved()
    dev.reset_peak()
    setup_s = time.perf_counter() - t_start
    print("set-up s: before run_cell %.3f, " % (marks[0][1] - t_start)
          + ", ".join(f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
                      in zip(marks[:-1], marks[1:])), file=log)

    win = run_window(system, ring_dev, mix["warmup_batches"], seconds, sampler, dev, ops)
    dev.sync()
    window_peak = dev.peak_reserved()
    traced = None
    if trace:
        nxt = win["last_index"] + 1
        starts = []

        def batches(n):
            start = nxt if ops is None else ops.next
            starts.append(start)
            return (ring_dev[(start + k) % len(ring)] for k in range(n))

        traced = tracing.traced_window(system, batches, bench.layers(),
                                       mix["trace_warmup"], mix["trace_batches"],
                                       dev, torch, ops=ops)
        first_traced = starts[-1] + mix["trace_warmup"]
        traced["batch_index"] = list(range(first_traced, first_traced + mix["trace_batches"]))
        traced["ring_index"] = [i % len(ring) for i in traced["batch_index"]]
        traced["lookups_per_read"] = tracing.mean_lookups(
            system, (ring_dev[i] for i in traced["ring_index"]), torch)
        dev.sync()
    peak = max(setup_peak, window_peak, dev.peak_reserved())

    failed = lost = 0
    if ops is not None:
        refused_map = _writes_log(ops, system, win, log)
        win["tick_s"] = ops.tick_s
        if wring is not None:
            # every write read back through the program, before it is freed
            t_back = time.perf_counter()
            replay(reference, mix, wring, 0, ops.next)
            ids, valid, bad = read_back(system, reference, floats, dev)
            refused = np.zeros_like(bad)
            if refused_map is not None:
                refused = bad & refused_map[np.arange(t)[:, None], ids]
            failed, lost = int(refused.sum()), int((bad & ~refused).sum())
            newest = 0 if refused_map is None else int(refused_map.sum())
            print(f"read-back s: {time.perf_counter() - t_back:.3f}; written clusters "
                  f"{int(valid.sum())}, newest write refused {newest}, refused and "
                  f"missing {failed}, lost {lost}", file=log)

    # the program's state goes before the reference runs
    last, last_index = win.pop("last"), win["last_index"]
    system.close()
    del system
    dev.reset_peak()

    t_check = time.perf_counter()
    items = [(last_index, np.repeat(np.arange(t), b),
              ring[last_index % len(ring)].reshape(-1), last.reshape(-1, floats))]
    for slot, held in enumerate(sampler.held):
        if held is not None:
            i, row = held
            pos = sampler.pos_host[row]
            ids = ring[(win["first"] + i) % len(ring)]
            items.append((win["first"] + i, pos // b, ids.reshape(-1)[pos], sampler.buf[slot]))
    follower, count, stop = reference, None, last_index + 1
    if ops is not None:
        # a fresh reference walks the batches, checking each read as of
        # its own batch and counting the bytes of a traced run on the way
        follower = bench.reference(cfg)(cfg, schedule, seed)
        if trace:
            count = ReplayedBytes(cfg, mix, ring, wring, win, traced["batch_index"])
            stop = count.stop
    wrong, checked = follow(follower, mix, wring, items, stop, count)
    del items, last
    compared = dict(wrong_clusters=dict(value=wrong, limit=0),
                    checked_clusters=dict(value=checked, limit=t * b))
    if wring is not None:
        compared["lost_writes"] = dict(value=lost, limit=0)
    correct = wrong <= 0 and checked >= t * b and lost <= 0
    print(f"check s: {time.perf_counter() - t_check:.3f}", file=log)

    bad_mods = loaded_forbidden()
    if bad_mods:
        print(f"loaded at the window's close: {', '.join(bad_mods)}", file=log)
        return None

    ops_done = win["batches"] * t * (b + w)
    if trace:
        print(f"trace: complete {traced['complete']} after {traced['tries']} "
              f"tries; launches seen {traced['launches_seen']}, made "
              f"{traced['launches_made']}", file=log)
        if ops is None:
            idx = (win["first"] + np.arange(win["batches"])) % len(ring)
            nbytes = dict(window=dict(resolve=float(resolve_b[idx].sum()),
                                      gather=float(gather_b[idx].sum())),
                          trace=dict(resolve=float(resolve_b[traced["ring_index"]].sum()),
                                     gather=float(gather_b[traced["ring_index"]].sum())))
        else:
            nbytes = count.result()
        # what a per-layer reader reads (metrics/<name>.py)
        run = dict(window=win, trace=traced,
                   lookups_per_read=traced["lookups_per_read"],
                   spans=traced["spans"], counters=traced["counters"],
                   peaks=peaks(torch.cuda.get_device_name(0)) if dev.is_cuda else None,
                   bytes=nbytes)
        metrics = {}
        for m in bench.metrics_of("per_layer", workload):
            value = bench.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(ops_per_s=ops_done / win["seconds"],
                      io_p95_ms=float(np.percentile(win["latency_ms"], 95)),
                      mem_per_data=window_peak / data_bytes,
                      setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in bench.metrics_of("end_to_end", workload)}

    result = dict(correct=bool(correct), attempted=ops_done, failed=failed, metrics=metrics,
                  device=dev.describe(peak))
    if trace:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"],
                                trace_complete=traced["complete"],
                                trace_tries=traced["tries"])
        result["breakdown"] = traced["breakdown"]
    result["compared"] = compared
    for name, c in compared.items():
        bound = "at least" if name == "checked_clusters" else "at most"
        print(f"{name} {c['value']} (limit: {bound} {c['limit']})", file=log)
    return result

