"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake
process group of 256 or 512 ranks (PyTorch port of
``repro.launch.dryrun``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke \
        --arch qwen2.5-3b --shape train_4k     # smoke config, (2, 4) mesh

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``, or
``<out>/<arch>__<shape>__<mesh>.json.fail`` with the traceback.

How a cell is traced. The process joins a fake ``torch.distributed``
group of the mesh's size (``FakeStore``: rank 0 of 256 or 512, every
collective returns at once) and builds the production mesh on it. The
parameters, the optimizer state, the batch and the decode cache are
``DTensor``s placed by ``param_specs`` / ``cache_specs`` / ``batch_spec``
whose local tensors live on the ``meta`` device: rank 0's shards, with
shapes and dtypes and no storage. The cell's step then runs once, as the
cell's kind says (the train step with gradient accumulation, ``prefill``,
or ``decode_step`` against a ``seq_len`` cache), under ``op_analysis``'s
counter (per-device FLOPs, memory bytes and collective bytes, every loop
trip counted) and ``MemTracker`` (the peak of rank 0's live tensors).

The record keeps the JAX record's field names where they mean the same
thing. JAX's ``compile_s`` becomes ``trace_s`` (the wall time of the one
traced call: nothing is compiled), and ``xla_cost_analysis`` has no
counterpart (no compiler reports costs). ``roofline_terms_s`` divide by
the H100's data-sheet rates (``launch.mesh.HW``); collective bytes count
an all-reduce twice (a ring moves about twice its payload).

The fake group cannot share a process with a real one, so the dry-run
always runs as its own process (``python -m``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (
    SHAPES,
    cells_for,
    get_config,
    list_archs,
    smoke_config,
)
from repro_torch.distributed import sharding as sh
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import HW, _mesh, make_production_mesh, mesh_shape
from repro_torch.models import get_model
from repro_torch.models.api import batch_specs
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves

# Gradient-accumulation plan for the big train cells (the JAX package's).
ACCUM = {
    ("qwen2-72b", "train_4k"): 16,
    ("chameleon-34b", "train_4k"): 8,
    ("nemotron-4-15b", "train_4k"): 8,
    ("qwen2-7b", "train_4k"): 8,
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 8,
    ("qwen2.5-3b", "train_4k"): 4,
    ("qwen2-moe-a2.7b", "train_4k"): 4,
    ("zamba2-2.7b", "train_4k"): 4,
    ("rwkv6-3b", "train_4k"): 4,
    ("whisper-base", "train_4k"): 2,
}


# the smoke mesh: a (data=2, model=4) fake group of 8 ranks
SMOKE_MESH = ((2, 4), ("data", "model"))


def input_specs(arch: str, shape_name: str, *, smoke: bool = False):
    """``meta`` stand-ins for every model input of a cell."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    spec = SHAPES[shape_name]
    return batch_specs(cfg, spec.global_batch, spec.seq_len, kind=spec.kind)


def _n_dp(mesh) -> int:
    shape = mesh_shape(mesh)
    return shape["data"] * shape.get("pod", 1)


def _tuned_config(arch: str, shape_name: str, mesh, *, smoke: bool = False):
    cfg = smoke_config(arch) if smoke else get_config(arch)
    spec = SHAPES[shape_name]
    groups = _n_dp(mesh)
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    while groups > 1 and tokens % groups:
        groups //= 2
    return dataclasses.replace(cfg, dispatch_groups=groups)


def join_fake_world(n: int) -> None:
    """Make this process rank 0 of a fake group of ``n`` ranks (leaving
    any fake group it was in)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _placed(tree, specs, mesh):
    """``meta`` leaves as ``DTensor``s placed by ``specs``: rank 0's
    shards, split locally (nothing is sent)."""
    return sh.map_with_path(
        lambda path, leaf: sh.place(leaf, sh.NamedSharding(mesh, _at(specs, path))),
        tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size()
               for x in leaves(tree) if isinstance(x, torch.Tensor))


def mesh_tag(multi_pod: bool, smoke: bool = False) -> str:
    if smoke:
        return "x".join(map(str, SMOKE_MESH[0]))
    return "2x16x16" if multi_pod else "16x16"


def world_of(multi_pod: bool, smoke: bool = False) -> int:
    return 8 if smoke else (512 if multi_pod else 256)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               smoke: bool = False) -> dict:
    """Trace one cell: no sequence sharding, the ``ACCUM`` plan, gradients
    pinned to the parameters' placements. ``smoke``: the arch's smoke
    config on the (2, 4) smoke mesh. Needs a (fake) default group of the
    mesh's size."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mesh = (_mesh(*SMOKE_MESH, "cpu") if smoke
            else make_production_mesh(multi_pod=multi_pod, device="cpu"))
    rules = sh.make_rules(mesh)
    cfg = _tuned_config(arch, shape_name, mesh, smoke=smoke)
    model = get_model(cfg)
    spec = SHAPES[shape_name]
    n_dev = mesh.size()

    params_shapes = model.init_shapes()
    p_specs = sh.param_specs(params_shapes, rules)
    params = _placed(params_shapes, p_specs, mesh)
    b_shapes = input_specs(arch, shape_name, smoke=smoke)
    batch = _placed(b_shapes, sh.batch_spec(b_shapes, rules), mesh)

    tracker = MemTracker()
    args = [params, batch]
    with sh.use_rules(rules):
        if spec.kind == "train":
            accum = ACCUM.get((arch, shape_name), 1)
            opt_shapes = adamw.init(params_shapes)
            opt = _placed(opt_shapes, sh.param_specs(opt_shapes, rules), mesh)
            args.append(opt)
            step_fn = make_train_step(
                model, adamw.AdamWConfig(), accum_steps=accum,
                grad_shardings=sh.shardings_of(p_specs, mesh))
            call = lambda: step_fn(params, opt, batch)  # noqa: E731
        elif spec.kind == "prefill":
            call = lambda: model.prefill(params, batch)  # noqa: E731
        else:  # decode — one token against a seq_len KV cache
            cache_shapes = model.init_cache(spec.global_batch, spec.seq_len,
                                            device="meta")
            cache = _placed(cache_shapes, sh.cache_specs(cache_shapes, rules),
                            mesh)
            args.append(cache)
            call = lambda: model.decode_step(params, cache, batch["tokens"])  # noqa: E731
        arg_bytes = sum(_local_bytes(a) for a in args)
        t0 = time.time()
        with tracker:
            tracker.track_external(*[x for a in args for x in _tensors(a)])
            _, costs = op_analysis.count(call)
        trace_s = time.time() - t0
    peak = sum(v.get("Total", 0) if isinstance(v, dict) else 0
               for v in tracker.get_tracker_snapshot("peak").values())

    flops_dev = costs["flops"]
    bytes_dev = costs["hbm_bytes"]
    coll = costs["collective_bytes"]
    # ring all-reduce moves ~2x the payload over a link; others ~1x
    coll_dev = float(coll["total"]) + float(coll["all-reduce"])

    # model FLOPs (the "useful work" yardstick)
    n_active = cfg.active_param_count()
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    model_flops = (6.0 if spec.kind == "train" else 2.0) * n_active * tokens

    terms = dict(
        compute_s=flops_dev / HW["peak_flops_bf16"],
        memory_s=bytes_dev / HW["hbm_bw"],
        collective_s=coll_dev / HW["link_bw"],
    )
    bottleneck = max(terms, key=terms.get)
    return dict(
        arch=arch,
        shape=shape_name,
        mesh=mesh_tag(multi_pod, smoke),
        n_devices=n_dev,
        kind=spec.kind,
        accum=accum if spec.kind == "train" else 1,
        trace_s=round(trace_s, 1),
        memory=dict(argument_bytes=arg_bytes, peak_bytes_per_device=peak),
        flops_per_device=flops_dev,
        hbm_bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll,
        model_flops_total=model_flops,
        model_flops_per_device=model_flops / n_dev,
        useful_flops_ratio=(model_flops / n_dev) / flops_dev if flops_dev else 0.0,
        roofline_terms_s=terms,
        roofline_hw=HW["name"],
        bottleneck=bottleneck,
        roofline_frac=(
            (model_flops / n_dev / HW["peak_flops_bf16"]) / max(terms.values())
            if max(terms.values()) > 0 else 0.0
        ),
    )


def _tensors(tree):
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config on a fake (2, 4) mesh")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in list_archs():
            for shape in cells_for(arch):
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    failures = 0
    for arch, shape, mp in cells:
        tag = mesh_tag(mp, args.smoke)
        path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
        if os.path.exists(path):
            print(f"[skip] {arch} {shape} {tag} (exists)")
            continue
        print(f"[trace] {arch} {shape} {tag} ...", flush=True)
        try:
            join_fake_world(world_of(mp, args.smoke))
            rec = lower_cell(arch, shape, multi_pod=mp, smoke=args.smoke)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(
                f"  ok: trace={rec['trace_s']}s "
                f"peak={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB/dev "
                f"flops/dev={rec['flops_per_device']:.3g} "
                f"coll/dev={rec['collective_bytes_per_device']['total']:.3g}B "
                f"bottleneck={rec['bottleneck']}",
                flush=True,
            )
        except Exception:  # noqa: BLE001 — a cell failure is a bug report
            failures += 1
            print(f"  FAIL:\n{traceback.format_exc()}", flush=True)
            with open(path + ".fail", "w") as f:
                f.write(traceback.format_exc())
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"done. failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
