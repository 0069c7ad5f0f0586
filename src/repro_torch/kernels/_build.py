"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into one shared library with a plain ``extern "C"``
interface, ``build/repro_torch/libsnapkernels.so`` at the repo root, and
loaded with ``ctypes``. The build runs once per process, at the first
kernel launch (or an explicit ``build()``), from the repo's own sources:
one ``nvcc -c`` per source, all started together, then one link. The L2
entry layout reaches the sources as ``-D`` macros generated from
``repro_torch.core.format``, so the bits have one home.

PyTorch's ``cpp_extension`` builder is deliberately not used: sources
that include PyTorch's headers take minutes to compile, plain C takes
seconds.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. ``PAGES`` counts, beside it, the pages
each launch was given to resolve: the whole-map fleet resolvers K1 and K2
take every tenant's whole map (T × P pages); K1's batch entry
(``resolve_auto_batch``) takes the read's T × B pages, so an auto read
gives K1 one page a read. The batch entry's kernels carry K1's name, so
it counts under K1's name (as a trace sees it) and under its own: K1's
whole-map launches and pages are the difference.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from repro_torch.core import format as fmt

KERNELS = ("resolve_vanilla_fleet", "resolve_direct_fleet", "paged_attention",
           "fused_chain_attention", "gather_fleet", "resolve_vanilla",
           "resolve_direct", "gather", "merge", "resolve_auto_batch")

#: Launches per kernel since the last ``reset_launches``.
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
#: Pages given to the launches counted in ``LAUNCHES`` (the fleet resolvers').
PAGES: dict[str, int] = {name: 0 for name in KERNELS}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libsnapkernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: argtypes of every C launcher; each returns its cudaGetLastError() code.
#: ``resolve_auto_batch`` is counted as ``resolve_vanilla_fleet`` (K1's);
#: ``cow_gather`` launches both K5 (``gather_fleet``) and K8 (``gather``),
#: ``merge_entries`` and ``merge`` both launch K9 (counted as ``merge``);
#: ``paged_attention``/``fused_chain_attention`` launch a split pass and its
#: combine, counted as one launch; ``paged_attention_shared`` (the
#: shared-table entry) counts as ``paged_attention``.
_SIGNATURES = {
    "resolve_vanilla_fleet": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "resolve_direct_fleet": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "resolve_auto_batch": [_P, _P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P],
    "paged_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    "paged_attention_shared": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P],
    "fused_chain_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "resolve_vanilla": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "resolve_direct": [_P, _P, _P, _P, _P, _I, _I, _P],
    "cow_gather": [_P, _P, _P, _P, _L, _L, _L, _I, _I, _P],
    "merge": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "merge_entries": [_P, _P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the build of this process reported: seconds and ptxas lines
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        PAGES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (atomically replaced,
    so concurrent processes never load a half-written file). Returns its
    path; ``BUILD_INFO`` holds the seconds taken and ptxas's register and
    shared-memory lines."""
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *fmt.cuda_macros(),
                              "-I", str(CSRC), "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.Popen([nvcc, "-shared", "-o", str(lib_tmp),
                                 *map(str, objs)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        link_log = link.communicate()[0]
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link_log}")
        out = BUILD_DIR / LIB_NAME
        os.replace(lib_tmp, out)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = [ln.strip() for log in logs for ln in log.splitlines()
                           if "ptxas info" in ln or "spill" in ln]
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(name: str, code: int, pages: int = 0,
                 entry: str | None = None) -> None:
    """Raise if a C launcher reported a CUDA error; else count the launch
    and the ``pages`` it was given under ``name``, and under ``entry`` too
    where the launcher is another entry of ``name``'s kernel."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {entry or name} failed to launch: "
                           f"cudaError {code}")
    for key in (name,) if entry is None else (name, entry):
        LAUNCHES[key] += 1
        PAGES[key] += pages
