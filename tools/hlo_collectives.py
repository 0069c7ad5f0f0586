"""The collectives of one cell of the JAX package's dry-run, computation by
computation: each while body (one layer of a scanned stack) with its trip
count, and the entry. Prints each collective op (kind, result shape,
payload bytes a device, as ``repro.launch.hlo_analysis.collective_bytes``
counts them), each computation's sums by kind, and the cell's total.

    PYTHONPATH=src python tools/hlo_collectives.py --arch qwen2.5-3b \\
        --shape decode_32k [--multi-pod]

It lowers the cell through ``repro.launch.dryrun.lower_cell`` (512 host
devices on the CPU) and reads the compiled HLO that it analyses.
"""

from __future__ import annotations

import argparse
import collections
import re

import repro.launch.dryrun as dryrun  # sets the host device count first
from repro.launch import hlo_analysis

_OP = re.compile(
    r"=\s*((?:\([^)]*\)|[\w\[\],{}]+))\s+("
    + "|".join(hlo_analysis._COLLECTIVES) + r")(?:-start)?\(")


def by_computation(hlo: str) -> dict:
    """{computation: (trip count, {kind: [ops, bytes]}, [(kind, shape,
    bytes)])} for every computation that holds a collective."""
    comps = hlo_analysis._split_computations(hlo)
    mult = hlo_analysis._multipliers(comps)
    out = {}
    for name, text in comps.items():
        kinds = collections.defaultdict(lambda: [0, 0])
        ops = []
        for line in text.splitlines():
            m = _OP.search(line)
            if not m or "-done(" in line:
                continue
            nbytes = hlo_analysis._shape_bytes(m.group(1))
            if m.group(2) == "reduce-scatter":
                nbytes = max(nbytes, hlo_analysis._shape_bytes(line[m.end():]))
            kinds[m.group(2)][0] += 1
            kinds[m.group(2)][1] += nbytes
            ops.append((m.group(2), m.group(1)[:60], nbytes))
        if kinds:
            out[name] = (mult.get(name, 1) or 1, dict(kinds), ops)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    seen = []
    count = hlo_analysis.collective_bytes

    def keep(hlo):
        seen.append(hlo)
        return count(hlo)

    hlo_analysis.collective_bytes = keep
    try:
        rec = dryrun.lower_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    finally:
        hlo_analysis.collective_bytes = count
    for name, (trips, kinds, ops) in by_computation(seen[-1]).items():
        print(f"{name} (x{trips})")
        for kind, shape, nbytes in ops:
            print(f"    {kind:<20} {shape:<60} {nbytes:>12,} B")
        for kind, (n, nbytes) in sorted(kinds.items()):
            print(f"  {kind:<20} {n:>3} ops {nbytes:>14,} B")
    print("cell total, bytes a device:", rec["collective_bytes_per_device"])


if __name__ == "__main__":
    main()
