"""What a run reads through: the program under test, or the control.

``FleetProgram`` is the system under test: ``repro_torch``'s fleet, built
through the port's own ``fleet.create``, ``write`` and ``snapshot`` from
the seed's schedule, and read by ``fleet.read(method="auto")``, the entry
a guest's I/O takes (resolve by K1/K2, gather by K5).

``ReferenceReads`` is the control: the plain reference in the program's
place, each cluster version rounded through a lower precision.

Both have ``read(ids) -> (data, result)``, where ``result`` is the
program's ``ResolveResult`` (``None`` for the control), ``launches`` and
``pages``, the program's kernel launch and page counters (``None`` for
the control). For a mix that writes, both have ``write(ids, data)`` (a
batch of ``(T, W)`` clusters, unique within each disk's row),
``snapshot()`` (every disk) and ``tick()`` (one maintenance slice), and
``pressure()``: the program's ``(overflow, snap_dropped)`` flags as they
stand, on the device, and ``allocated()``: the ``(T,)`` pool rows each
disk has taken (``fleet.alloc_count``; ``None`` for the control, both).
The program runs them through the port's ``fleet.write``,
``fleet.snapshot`` and ``MaintenanceScheduler.tick``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from snapbench import datagen

#: base-fill clusters a tenant written by one fleet.write
BASE_CHUNK = 128


def _nvcc_version() -> str:
    """``nvcc --version`` of the ``nvcc`` a build would take, or why none."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60)
        return nvcc + "\n" + out.stdout
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"no nvcc: {exc}"


def cache_kernel_build(build_mod) -> None:
    """Build the program's kernel library once per checkout.

    The port's ``_build.build`` compiles every source in each process. This
    wraps it so that a run finds the library an earlier run of this
    checkout built, where the sources, the build module itself (its
    compile and link commands), the flags, the format macros and the
    ``nvcc`` are the same (a digest kept beside the library, in the
    program's own build directory inside the checkout), and builds it
    otherwise."""
    build = getattr(build_mod, "build", None)
    if build is None or getattr(build, "snapbench_cached", False):
        return
    lib = build_mod.BUILD_DIR / build_mod.LIB_NAME
    stamp = lib.with_name(lib.name + ".digest")
    h = hashlib.sha256()
    sources = sorted(p for p in build_mod.CSRC.rglob("*") if p.is_file())
    for path in [Path(build_mod.__file__), *sources]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    from repro_torch.core import format as fmt
    h.update(repr((build_mod.NVCC_FLAGS, fmt.cuda_macros())).encode())
    h.update(_nvcc_version().encode())
    digest = h.hexdigest()

    def cached_build():
        if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
            return lib
        out = build()
        tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}")
        tmp.write_text(digest)
        os.replace(tmp, stamp)
        return out

    cached_build.snapbench_cached = True
    build_mod.build = cached_build


def pool_rows(cfg: dict, schedule: datagen.Schedule) -> int:
    """The pool's rows: each tenant's set-up rows in whole leases, and
    ``pool_headroom_rows`` (absent: 0) a tenant, in whole leases, for the
    window's writes. The headroom stays free in the pool until a tenant's
    write leases it."""
    q = cfg["lease_quantum"]
    rows = schedule.base.shape[1] + cfg["layer_writes"] * (schedule.targets - 1)
    headroom = -(-cfg.get("pool_headroom_rows", 0) // q) * q
    return int((-(-rows // q)).sum()) * q + cfg["tenants"] * headroom


def build_fleet(fleet_lib, cfg: dict, schedule: datagen.Schedule, seed: int,
                device, dtype=torch.float32):
    """The configuration's fleet, grown through the port's own calls: the
    base fill into layer 0, then for each layer a snapshot and a write of
    ``layer_writes`` clusters by every tenant whose chain reaches it. The
    pool holds each tenant's rows in whole leases, and the headroom of
    ``pool_rows``; its ``dtype`` is the configuration's float32 but in a
    test."""
    t, p, q = cfg["tenants"], cfg["disk_clusters"], cfg["lease_quantum"]
    floats = cfg["cluster_bytes"] // 4
    spec = fleet_lib.FleetSpec(
        n_tenants=t, n_pages=p, page_size=floats, max_chain=cfg["max_chain"],
        pool_capacity=pool_rows(cfg, schedule), lease_quantum=q, dtype=dtype)
    fl = fleet_lib.create(spec, scalable=cfg["format"] == "sqemu", device=device)
    tids = torch.arange(t, device=device)[:, None]
    base = torch.as_tensor(schedule.base, device=device)
    for lo in range(0, base.shape[1], BASE_CHUNK):
        ids = base[:, lo:lo + BASE_CHUNK]
        fleet_lib.write(fl, ids, datagen.page_data(seed, tids, 0, ids, floats))
    layers = torch.as_tensor(schedule.layers, device=device)
    targets = torch.as_tensor(schedule.targets, device=device)
    for layer in range(1, layers.shape[0] + 1):
        live = targets > layer
        fleet_lib.snapshot(fl, live)
        ids = layers[layer - 1]
        fleet_lib.write(fl, ids, datagen.page_data(seed, tids, layer, ids, floats),
                        live)
    fleet_lib.check_pool_capacity(fl)
    if not torch.equal(fl.length.cpu(), targets.cpu()):
        raise RuntimeError("the fleet's chain lengths differ from the schedule's")
    return fl


class FleetProgram:
    """The system under test. ``maintenance``: the keyword arguments of the
    ``MaintenanceScheduler`` that ``tick`` runs, which then holds the
    fleet, as its docstring shows."""

    def __init__(self, cfg: dict, schedule: datagen.Schedule, seed: int,
                 device, maintenance: dict | None = None):
        from repro_torch.core import fleet as fleet_lib
        from repro_torch.kernels import _build

        if torch.device(device).type == "cuda":
            cache_kernel_build(_build)
        self.launches, self.pages = _build.LAUNCHES, _build.PAGES
        self._lib = fleet_lib
        self._read = fleet_lib.read
        self.fleet = build_fleet(fleet_lib, cfg, schedule, seed, device)
        self.sched = None
        if maintenance is not None:
            from repro_torch.core.scheduler import MaintenanceScheduler
            self.sched = MaintenanceScheduler(self.fleet, **maintenance)

    def read(self, ids):
        return self._read(self.fleet, ids, method="auto")

    def _hold(self, fleet):
        self.fleet = fleet
        if self.sched is not None:
            self.sched.fleet = fleet

    def write(self, ids, data):
        self._hold(self._lib.write(self.fleet, ids, data))

    def snapshot(self):
        self._hold(self._lib.snapshot(self.fleet))

    def tick(self) -> dict:
        report = self.sched.tick()
        self.fleet = self.sched.fleet
        return report

    def pressure(self):
        return self.fleet.overflow, self.fleet.snap_dropped

    def allocated(self):
        return self.fleet.alloc_count

    def maintenance_stats(self) -> dict | None:
        """The scheduler's lifetime counters and the fleet's occupancy."""
        return None if self.sched is None else self.sched.stats()

    def close(self):
        self.fleet = self.sched = None


class ReferenceReads:
    """The control: reads answered by the plain reference, each version
    rounded through ``dtype``. It follows a mix's snapshots and writes as
    the reference replays them, taking each write's batch from the stamp
    the harness put in its payloads."""

    launches = pages = None

    def __init__(self, reference, dtype, device):
        self.reference, self.dtype, self.device = reference, dtype, device

    def write(self, ids, data):
        batch = data[0, 0, :1].view(torch.int32).item() & (datagen.STAMP_LIMIT - 1)
        self.reference.write(batch, ids.cpu().numpy())

    def snapshot(self):
        self.reference.snapshot()

    def tick(self) -> dict:
        return {}

    def pressure(self):
        return None

    def allocated(self):
        return None

    def maintenance_stats(self):
        return None

    def read(self, ids):
        host = ids.cpu().numpy()
        t, b = host.shape
        data = self.reference.expected(np.repeat(np.arange(t), b), host.reshape(-1),
                                       self.device, self.dtype)
        return data.reshape(t, b, -1), None

    def close(self):
        pass
