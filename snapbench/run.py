"""Run one cell of the benchmark of ``repro_torch`` on one card.

    python3 snapbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The checkout's ``src/`` goes first on
``sys.path``, so the program under test is the checkout's own. Prints the
result as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Exits
non-zero and prints no result where there is no CUDA card, where the
checkout has no ``src/repro_torch``, or where JAX or the JAX package was
loaded when the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of a build or a compile stays in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "snapbench" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
if sys.path[2:3] == [str(Path(__file__).resolve().parent)]:
    del sys.path[2]          # the script's own folder is no import root

import torch  # noqa: E402

T_TORCH = time.perf_counter()

CPU_THREADS = 2


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from snapbench.bench import Bench

    cell = Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch
    except ImportError as exc:
        print(f"no program to run: {exc}", file=sys.stderr)
        return 3
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"repro_torch comes from {repro_torch.__file__}, not from this "
              "checkout's src/", file=sys.stderr)
        return 3
    torch.set_num_threads(CPU_THREADS)
    from snapbench.harness import run_cell

    print(f"load s: import torch {T_TORCH - T_START:.3f}, to run_cell "
          f"{time.perf_counter() - T_TORCH:.3f}", file=sys.stderr)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    if result is None:
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
