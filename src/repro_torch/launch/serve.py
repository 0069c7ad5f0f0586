"""Serving launcher: continuous batching over the COW paged KV cache
(PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --requests 4 --forks 2 --tokens 8

Admits ``--requests`` random prompts, forks each ``--forks`` times, steps
the engine ``--tokens`` times, and prints the JAX launcher's two lines.
Weights are drawn from a ``torch.Generator`` seeded 0 on the device, and
the prompts from numpy's ``default_rng(0)``, as in the JAX launcher. The
device is the card unless ``--device cpu`` is given. ``--decode-path``
and ``--max-blocks-per-seq`` pick the engine's decode path (``fused``
needs a multiple of 128 blocks a sequence); the defaults are the JAX
launcher's engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.device import as_device
from repro_torch.models import get_model
from repro_torch.serve.engine import Engine


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--forks", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--vanilla", action="store_true",
                    help="vanilla fork chains (walks) instead of direct")
    ap.add_argument("--decode-path", choices=("auto", "fused", "tables"),
                    default="auto")
    ap.add_argument("--max-blocks-per-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def start_engine(args):
    """The launcher's engine with its requests admitted and forked."""
    cfg = get_config(args.arch) if args.scale == "full" else smoke_config(args.arch)
    dev = as_device(args.device)
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0),
                                 device=dev)
    eng = Engine(cfg, params, scalable=not args.vanilla, n_blocks=1024,
                 block_size=8, max_blocks_per_seq=args.max_blocks_per_seq,
                 decode_path=args.decode_path, device=dev)
    rng = np.random.default_rng(0)
    roots = [eng.add_request(rng.integers(0, cfg.vocab_size, args.prompt_len))
             for _ in range(args.requests)]
    for r in roots:
        for _ in range(args.forks):
            eng.fork_request(r)
    return eng


def main(argv=None):
    args = parse(argv)
    eng = start_engine(args)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        eng.step()
    dt = time.perf_counter() - t0
    st = eng.memory_stats()
    n_seqs = st["n_seqs"]
    print(f"{n_seqs} sequences ({args.requests} roots x {args.forks} forks), "
          f"{args.tokens} steps in {dt:.2f}s "
          f"({n_seqs*args.tokens/dt:.1f} tok/s)")
    print(f"blocks in use: {st['blocks_in_use']} "
          f"(independent copies would need ~"
          f"{n_seqs * (args.prompt_len // 8 + 2)}); "
          f"table lookups: {st['lookups']} "
          f"({'vanilla walk' if args.vanilla else 'direct'})")
    st["tokens"] = {sid: list(toks) for sid, toks in eng.active.items()}
    return st


if __name__ == "__main__":
    main()
