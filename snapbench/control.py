"""The control of a cell's comparison: the plain reference put in the
program's place, each cluster version rounded through bfloat16 (the
precision below the configuration's float32), driven through the whole of
a run at the cell's own size. Its runs have to come out not correct.

    python3 snapbench/control.py --workload <cell> --seeds <n>,<n>,... --seconds <s>

prints one JSON line a seed with the numbers compared and ``correct``.
The benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from snapbench.bench import Bench  # noqa: E402
from snapbench.harness import run_cell  # noqa: E402
from snapbench.systems import ReferenceReads  # noqa: E402

LOWER = torch.bfloat16


def control_system(bench: Bench):
    def make(cfg, schedule, seed, device, maintenance=None):
        # streaming never changes what a read returns: the control has
        # nothing to maintain
        return ReferenceReads(bench.reference(cfg)(cfg, schedule, seed), LOWER, device)
    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(ROOT, args.workload, seed, args.seconds, False,
                     device="cuda", make_system=control_system(bench))
        print(json.dumps(dict(workload=args.workload, seed=seed, control=str(LOWER),
                              correct=r["correct"], compared=r["compared"],
                              attempted=r["attempted"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
