"""What a run reads through: the program under test, or the control.

``FleetProgram`` is the system under test: ``repro_torch``'s fleet, built
through the port's own ``fleet.create``, ``write`` and ``snapshot`` from
the seed's schedule, and read by ``fleet.read(method="auto")``, the entry
a guest's I/O takes (resolve by K1/K2, gather by K5).

``ReferenceReads`` is the control: the plain reference in the program's
place, each cluster version rounded through a lower precision.

Both have ``read(ids) -> (data, result)``, where ``result`` is the
program's ``ResolveResult`` (``None`` for the control), and ``launches``,
the program's kernel launch counters (``None`` for the control).
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


def build_fleet(fleet_lib, cfg: dict, schedule: datagen.Schedule, seed: int,
                device, dtype=torch.float32):
    """The configuration's fleet, grown through the port's own calls: the
    base fill into layer 0, then for each layer a snapshot and a write of
    ``layer_writes`` clusters by every tenant whose chain reaches it. The
    pool holds each tenant's rows in whole leases and nothing more; its
    ``dtype`` is the configuration's float32 but in a test."""
    t, p, q = cfg["tenants"], cfg["disk_clusters"], cfg["lease_quantum"]
    floats = cfg["cluster_bytes"] // 4
    rows = schedule.base.shape[1] + cfg["layer_writes"] * (schedule.targets - 1)
    spec = fleet_lib.FleetSpec(
        n_tenants=t, n_pages=p, page_size=floats, max_chain=cfg["max_chain"],
        pool_capacity=int((-(-rows // q)).sum()) * q, lease_quantum=q,
        dtype=dtype)
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
    """The system under test."""

    def __init__(self, cfg: dict, schedule: datagen.Schedule, seed: int,
                 device):
        from repro_torch.core import fleet as fleet_lib
        from repro_torch.kernels import _build

        if torch.device(device).type == "cuda":
            cache_kernel_build(_build)
        self.launches = _build.LAUNCHES
        self._read = fleet_lib.read
        self.fleet = build_fleet(fleet_lib, cfg, schedule, seed, device)

    def read(self, ids):
        return self._read(self.fleet, ids, method="auto")

    def close(self):
        self.fleet = None


class ReferenceReads:
    """The control: reads answered by the plain reference, each version
    rounded through ``dtype``."""

    launches = None

    def __init__(self, reference, dtype, device):
        self.reference, self.dtype, self.device = reference, dtype, device

    def read(self, ids):
        host = ids.cpu().numpy()
        t, b = host.shape
        data = self.reference.expected(np.repeat(np.arange(t), b), host.reshape(-1),
                                       self.device, self.dtype)
        return data.reshape(t, b, -1), None

    def close(self):
        pass
