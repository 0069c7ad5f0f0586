"""Training launcher (PyTorch port of ``repro.launch.train``).

Trains one model with the fault-tolerant ``Trainer``, its state
delta-checkpointed on the snapshot chain, and prints the same lines as the
JAX launcher. The state and every batch are ``DTensor``s placed on a mesh
by its sharding rules, and the step runs under those rules: each rank
keeps its shards and takes its slice of the batch. The mesh is
``make_host_mesh()`` over the ranks that exist (one on one card; the
launcher starts a one-process group when there is none), or with
``--production`` the 16x16 production mesh, which needs a job of 256
ranks and raises on fewer. The device is the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 20 --scale smoke
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_shape
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--production", action="store_true",
                    help="use the 16x16 production mesh (needs 256 devices)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" else smoke_config(args.arch)
    model = get_model(cfg)
    started = not dist.is_initialized()   # make_host_mesh may start one
    mesh = (make_production_mesh(device=args.device) if args.production
            else make_host_mesh(device=args.device))
    rules = sh.make_rules(mesh)
    print(f"mesh: {mesh_shape(mesh)}  device: {args.device}  arch: {cfg.name} "
          f"({cfg.param_count()/1e6:.1f}M params)")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every)
    with sh.use_rules(rules):
        trainer = Trainer(model, AdamWConfig(lr=1e-3, total_steps=args.steps),
                          dcfg, tcfg, device=args.device, rules=rules)
        report = trainer.run()
    if started:
        dist.destroy_process_group()
    print(f"done: loss {trainer.losses[0]:.3f} -> {trainer.losses[-1]:.3f}  "
          f"goodput={report['goodput']:.2f}  "
          f"ckpt chain={report['ckpt_chain_length']}  "
          f"stragglers={report['straggler_steps']}")
    return report


if __name__ == "__main__":
    main()
