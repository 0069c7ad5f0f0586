#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and hold every
kernel against its plain PyTorch version.

Run from the repo root, with one card:

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name, count and power limit; TF32 off.
2. build — ``nvcc`` builds ``src/repro_torch/csrc/*.cu`` for sm_90a (one
   process per source, started together); seconds and ptxas lines.
3. reference — at smoke size in float32, the port's ``Engine`` on the
   card (CUDA kernels) must emit the same tokens as on the CPU (the
   kernels' plain versions), both fork formats x both decode paths.
4. serve — Qwen2.5-3B at full width and depth (random bf16 weights from
   ``torch.Generator(device="cuda").manual_seed(0)``), four engines
   {scalable, vanilla} x {tables, fused}: admit 4 prompts of 64-512
   tokens, fork two, on the vanilla engines build a fork chain 64 deep,
   decode 16 steps (2 warm-up, 12 timed with CUDA events, 2 under
   torch.profiler for kernel time by kernel and the device idle share),
   finish all.
   Per format, tables and fused must emit identical tokens; every engine
   must end with ``blocks_in_use() == 0``; every kernel of the path must
   have launched. Launch counts are zeroed just before each engine's run
   and read just after it.
5. kernels — each kernel on the vanilla-fused engine's own state (its
   pools, L2 words, chain lengths and decode batch) against its plain
   version (K1/K2 bit-exact, K3/K4 within bf16 2e-2; K3 and K4 bit-identical
   to each other), timed with CUDA events (L2 flushed before each call),
   with the least time the card could take (bound) beside it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine with no card, or a
directory without the repo's ``src/``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 (tensor cores)
STEPS, WARMUP, PROFILED = 16, 2, 2   # of the 16 steps, 12 are timed
SPIN_CYCLES = 2_000_000        # about 1 ms of card clock (kernel timing)
PROMPT_LENGTHS = (64, 192, 320, 512)
CHAIN_DEPTH = 64
KERNEL_SOURCES = {
    "resolve_vanilla_fleet": ("src/repro_torch/csrc/chain_resolve.cu",
                              "src/repro/kernels/chain_resolve/chain_resolve.py:145"),
    "resolve_direct_fleet": ("src/repro_torch/csrc/chain_resolve.cu",
                             "src/repro/kernels/chain_resolve/chain_resolve.py:190"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/paged_attention.py:90"),
    "fused_chain_attention": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention/paged_attention.py:220"),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: smoke-size reference, card against CPU -------------------------


def reference_phase(torch, mods):
    L, Engine, smoke_config, init_params = (mods["layers"], mods["Engine"],
                                            mods["smoke_config"],
                                            mods["init_params"])
    cfg = smoke_config("qwen2.5-3b")
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        cpu_params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        gpu_params = _to(torch, cpu_params, "cuda")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 3)]
        for scalable in (True, False):
            for path in ("tables", "fused"):
                toks = []
                for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
                    eng = Engine(cfg, params, scalable=scalable, n_blocks=256,
                                 block_size=4, max_blocks_per_seq=128,
                                 decode_path=path, device=dev)
                    toks.append(_lifecycle_tokens(eng, prompts, depth=12))
                require(toks[0] == toks[1],
                        f"card vs CPU tokens differ (scalable={scalable}, {path})")
                emit({"phase": "reference", "scalable": scalable, "path": path,
                      "tokens_equal_card_vs_cpu": True,
                      "n_tokens": sum(len(v) for v in toks[0].values())})
    finally:
        L.COMPUTE_DTYPE = saved


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


def _lifecycle_tokens(eng, prompts, depth):
    sids = [eng.add_request(p) for p in prompts]
    eng.fork_request(sids[1])
    sid = sids[0]
    for d in range(depth):
        child = eng.fork_request(sid)
        eng.finish_request(sid)
        sid = child
        if d % 4 == 0:
            eng.step()
    for _ in range(3):
        eng.step()
    out = {s: list(t) for s, t in eng.active.items()}
    for s in sorted(eng.active):
        eng.finish_request(s)
    require(eng.kv.blocks_in_use() == 0, "blocks leaked at smoke size")
    return out


# -- phase 4: full-size serving ----------------------------------------------


def serve_phase(torch, mods, cfg, params, prompts):
    Engine, _build = mods["Engine"], mods["_build"]
    results, captured = {}, None
    for scalable in (True, False):
        for path in ("tables", "fused"):
            name = f"{'scalable' if scalable else 'vanilla'}/{path}"
            _build.reset_launches()
            eng = Engine(cfg, params, scalable=scalable, n_blocks=1024,
                         block_size=16, max_blocks_per_seq=128, resolver="auto",
                         decode_path=path)
            require(eng.decode_path == path, "decode path selection")
            sids = [eng.add_request(p) for p in prompts]
            eng.fork_request(sids[0])
            eng.fork_request(sids[1])
            if not scalable:
                sid = eng.fork_request(sids[2])
                for _ in range(CHAIN_DEPTH - 1):
                    child = eng.fork_request(sid)
                    eng.finish_request(sid)
                    sid = child
                depth = len(eng.kv._seqs[sid].path) - 1
                require(depth == CHAIN_DEPTH, f"fork chain depth {depth}")
            batch = len(eng.active)
            for _ in range(WARMUP):
                eng.step()
            before = dict(_build.LAUNCHES)
            ms = []
            timed = STEPS - WARMUP - PROFILED
            for _ in range(timed):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                eng.step()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            per_step = {k: (_build.LAUNCHES[k] - before[k]) / timed
                        for k in before}
            step_ms = float(np.mean(ms))
            profile = profile_steps(torch, eng, PROFILED, step_ms)
            launches = dict(_build.LAUNCHES)       # read just after the run
            tokens = {s: list(t) for s, t in eng.active.items()}
            if not scalable and path == "fused":
                captured = capture_state(torch, eng)
            for s in sorted(eng.active):
                eng.finish_request(s)
            require(eng.kv.blocks_in_use() == 0, f"{name}: blocks leaked")
            want = ({"resolve_vanilla_fleet", "resolve_direct_fleet"}
                    | {"paged_attention" if path == "tables"
                       else "fused_chain_attention"})
            for k in want:
                require(launches[k] > 0, f"{name}: kernel {k} never launched")
            results[name] = dict(tokens=tokens, launches=launches,
                                 per_step=per_step)
            emit({"phase": "serve", "engine": name, "model": cfg.name,
                  "batch": batch, "steps_timed": len(ms),
                  "ms_per_step": step_ms,
                  "tokens_per_s": batch * 1000.0 / step_ms,
                  "max_chain": eng.kv.fleet.spec.max_chain,
                  "launches": launches, "launches_per_step": per_step,
                  "blocks_in_use_after": eng.kv.blocks_in_use()})
            emit({"phase": "profile", "engine": name, **profile})
            del eng
            torch.cuda.empty_cache()
    for fmt_name in ("scalable", "vanilla"):
        same = (results[f"{fmt_name}/tables"]["tokens"]
                == results[f"{fmt_name}/fused"]["tokens"])
        require(same, f"{fmt_name}: tables and fused paths emitted different tokens")
        emit({"phase": "serve", "format": fmt_name,
              "tables_equal_fused_tokens": True})
    return results, captured


def profile_steps(torch, eng, n, step_ms):
    """Kernel time by kernel over ``n`` decode steps under torch.profiler.
    The device idle share compares the device time per step with the
    unprofiled ``step_ms`` (the profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        # device events only: a CPU op also reports the device time of the
        # kernels it launched, which would count them twice
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / n
    device_ms = sum(by_kernel.values())
    groups = {"attention (K3/K4)": ("paged_attention_kernel",
                                    "fused_chain_attention_kernel"),
              "chain resolve (K1/K2)": ("fleet_kernel",),
              "matmul": ("nvjet", "gemm", "gemv", "xmma", "cutlass")}
    by_group = {g: 0.0 for g in groups}
    by_group["other"] = 0.0
    for k, v in by_kernel.items():
        g = next((g for g, keys in groups.items() if any(x in k for x in keys)),
                 "other")
        by_group[g] += v
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        steps_profiled=n, device_ms_per_step=device_ms,
        device_idle_share=(1.0 - device_ms / step_ms) if device_ms else None,
        device_ms_by_group=by_group,
        top_kernels=[[k[:80], v] for k, v in top],
    )


def capture_state(torch, eng):
    """The engine's own state for the kernel phase: layer 0's pools, the
    fleet's L2 words and chain lengths, and the decode batch (padded as
    the engine pads it)."""
    kv = eng.kv
    sids = sorted(eng.active)
    pad_to = eng._bucket(len(sids))
    tables, lengths = kv.batched_tables(sids, pad_to=pad_to,
                                        pad_block=eng._pad_block)
    tenants = torch.zeros(pad_to, dtype=torch.int32, device=kv.device)
    tenants[:len(sids)] = torch.as_tensor([kv._seqs[s].tenant for s in sids],
                                          dtype=torch.int32, device=kv.device)
    return dict(
        pool_k=kv.pool_k[0].clone(), pool_v=kv.pool_v[0].clone(),
        w0=kv.fleet.l2[..., 0].contiguous(), w1=kv.fleet.l2[..., 1].contiguous(),
        chain_lengths=kv.fleet.length.clone(), tables=tables, lengths=lengths,
        tenants=tenants,
    )


# -- phase 5: every kernel against its plain version -------------------------


def timed_ms(torch, fn, n, flush):
    """Mean ms per call over ``n`` calls after a warm-up, each call timed
    alone with CUDA events after the L2 cache was flushed (a decode step
    finds a layer's pool slice cold: 36 layers of weights pass between).
    A spin of about a millisecond on the card precedes each call, so the
    host has enqueued the whole call before the first event is reached
    and the events time the device work, not the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def walk_words(w0, chain_lengths, pages_of, allocated_bit):
    """Words a first-hit walk must read: per (tenant, page) from the
    active layer down to the owner (the whole live chain on a miss)."""
    c = w0.shape[1]
    total = 0
    for t, pages in pages_of.items():
        top = min(int(chain_lengths[t]), c) - 1
        if top < 0 or not len(pages):
            continue
        col = w0[t, : top + 1][:, pages]                  # (top+1, n)
        alloc = (col & np.int32(allocated_bit)) != 0
        layers = np.arange(top + 1)[:, None]
        owner = np.where(alloc, layers, -1).max(axis=0)
        total += int(np.sum(np.where(owner >= 0, top - owner + 1, top + 1)))
    return total


def kernel_phase(torch, mods, state, per_step_of, launches_of):
    cr, cr_ref, pa, pa_ref = (mods["cr"], mods["cr_ref"], mods["pa"],
                              mods["pa_ref"])
    s = state
    dev = s["w0"].device
    g = torch.Generator(device=dev).manual_seed(1)
    b = s["tables"].shape[0]
    cfg = mods["cfg"]
    q = torch.randn((b, cfg.n_heads, cfg.hd), generator=g, device=dev
                    ).to(s["pool_k"].dtype)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    alloc_bit = mods["fmt"].FLAG_ALLOCATED_I32
    w0, w1, cl = s["w0"], s["w1"], s["chain_lengths"]
    kv_len = s["lengths"]
    t, c, p = w0.shape
    nb, bs, hkv, d = s["pool_k"].shape
    elt = s["pool_k"].element_size()

    w0_h, cl_h = w0.cpu().numpy(), cl.cpu().numpy()
    tables_h, len_h, ten_h = (s["tables"].cpu().numpy(), kv_len.cpu().numpy(),
                              s["tenants"].cpu().numpy())

    # data-dependent byte counts: what these inputs need, each read once
    k1_bytes = 4 * (walk_words(w0_h, cl_h, {i: np.arange(p) for i in range(t)},
                               alloc_bit)
                    + t + 2 * t * p)
    k2_bytes = 4 * (2 * t * p + t + 3 * t * p)
    nblk = np.minimum(-(-len_h // bs), tables_h.shape[1])
    slots = {(int(tables_h[r, j]), o) for r in range(b) for j in range(nblk[r])
             for o in range(bs) if j * bs + o < len_h[r]}
    kv_bytes = len(slots) * hkv * d * elt * 2
    qo_bytes = 2 * b * cfg.n_heads * cfg.hd * elt
    attn_ops = 4 * cfg.n_heads * cfg.hd * int(len_h.sum())
    k3_bytes = kv_bytes + qo_bytes + 4 * (int(nblk.sum()) + b)
    pages_of = {}
    for r in range(b):
        if nblk[r]:
            tt = int(ten_h[r])
            pages_of[tt] = np.arange(max(nblk[r], len(pages_of.get(tt, []))))
    k4_bytes = kv_bytes + qo_bytes + 4 * (walk_words(w0_h, cl_h, pages_of, alloc_bit)
                                          + len(pages_of) + 2 * b)

    runs = {
        "resolve_vanilla_fleet": (
            lambda: cr.resolve_vanilla_fleet_cuda(w0, cl),
            lambda: cr_ref.resolve_vanilla_fleet_ref(w0, cl), k1_bytes, 0, None),
        "resolve_direct_fleet": (
            lambda: cr.resolve_direct_fleet_cuda(w0, w1, cl),
            lambda: cr_ref.resolve_direct_fleet_ref(w0, w1, cl), k2_bytes, 0, None),
        "paged_attention": (
            lambda: pa.paged_attention_cuda(q, s["pool_k"], s["pool_v"],
                                            s["tables"], kv_len),
            lambda: pa_ref.paged_attention_ref(q, s["pool_k"], s["pool_v"],
                                               s["tables"], kv_len),
            k3_bytes, attn_ops, 2e-2),
        "fused_chain_attention": (
            lambda: pa.fused_chain_attention_cuda(q, s["pool_k"], s["pool_v"], w0,
                                                  cl, s["tenants"], kv_len),
            lambda: pa_ref.fused_chain_attention_ref(q, s["pool_k"], s["pool_v"],
                                                     w0, cl, s["tenants"], kv_len),
            k4_bytes, attn_ops, 2e-2),
    }
    rows, outs = [], {}
    for name, (kern, plain, nbytes, ops, tol) in runs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - b_.float()).abs().max()) for a, b_ in zip(got, want))
        if tol is None:
            require(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
                    f"{name} is not bit-exact against its plain version")
        else:
            require(err <= tol, f"{name} error {err} above {tol}")
            require(bool(torch.isfinite(got[0].float()).all()), f"{name} not finite")
        outs[name] = got
        kernel_ms = timed_ms(torch, kern, 50, flush)
        plain_ms = timed_ms(torch, plain, 10, flush)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / BF16_FLOPS
        src, replaces = KERNEL_SOURCES[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches_of[name], launches_per_step=per_step_of[name],
            max_abs_err=err, max_err=err, ms=kernel_ms, kernel_ms=kernel_ms,
            plain_ms=plain_ms, bytes=nbytes, ops=ops,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None,
        ))
    require(torch.equal(outs["paged_attention"][0], outs["fused_chain_attention"][0]),
            "paged_attention and fused_chain_attention differ on the same rows")
    emit({"phase": "kernels", "shapes": {
        "fleet_T_C_P": [t, c, p], "pool_nb_bs_hkv_d": [nb, bs, hkv, d],
        "batch": b, "kv_lengths": len_h.tolist()},
        "k3_equals_k4_bitwise": True})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import format as fmt
    from repro_torch.kernels import _build
    from repro_torch.kernels.chain_resolve import chain_resolve as cr
    from repro_torch.kernels.chain_resolve import ref as cr_ref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.engine import Engine

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # 2. build
    _build.library()
    emit({"phase": "build", "seconds": _build.BUILD_INFO["seconds"],
          "ptxas": _build.BUILD_INFO["ptxas"]})

    mods = dict(layers=layers, Engine=Engine, smoke_config=smoke_config,
                init_params=init_params, _build=_build, cr=cr, cr_ref=cr_ref,
                pa=pa, pa_ref=pa_ref, fmt=fmt)

    # 3. smoke-size reference: the card against the plain versions on the CPU
    t0 = time.perf_counter()
    reference_phase(torch, mods)
    emit({"phase": "reference", "seconds": time.perf_counter() - t0})

    # 4. full-size serving
    cfg = get_config("qwen2.5-3b")
    mods["cfg"] = cfg
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=layers.COMPUTE_DTYPE)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in PROMPT_LENGTHS]
    logits, _ = prefill(cfg, params, torch.as_tensor(prompts[0][None], device="cuda"))
    require(tuple(logits.shape) == (1, cfg.vocab_size), "prefill logits shape")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    n_params = sum(x.numel() for x in _leaves(params))
    require(n_params == cfg.param_count() + cfg.n_layers * (
        2 * cfg.d_model + cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads)) + cfg.d_model,
        "parameter count of the full-width model")
    emit({"phase": "serve", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "param_dtype": str(layers.COMPUTE_DTYPE),
          "init_seconds": time.perf_counter() - t0,
          "prompt_lengths": list(PROMPT_LENGTHS)})
    results, state = serve_phase(torch, mods, cfg, params, prompts)

    # 5. kernels at the main path's shapes
    launches_of = {k: sum(r["launches"][k] for r in results.values())
                   for k in KERNEL_SOURCES}
    per_step_of = {
        "resolve_vanilla_fleet": results["vanilla/fused"]["per_step"]["resolve_vanilla_fleet"],
        "resolve_direct_fleet": results["vanilla/fused"]["per_step"]["resolve_direct_fleet"],
        "paged_attention": results["vanilla/tables"]["per_step"]["paged_attention"],
        "fused_chain_attention": results["vanilla/fused"]["per_step"]["fused_chain_attention"],
    }
    rows = kernel_phase(torch, mods, state, per_step_of, launches_of)

    print(nvidia_smi_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
