#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
hold every kernel against its plain PyTorch version.

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
   with the least time the card could take (bound) beside it. K3/K4's
   rows carry the plan they ran with (the body's layout, ``tokens`` or
   ``heads``, warps a block, pages per split, grid, working blocks: at
   least the card's SMs) and a long-context shape: 8 rows of
   2,048 tokens through 128 distinct blocks each of the 1,024-block pool,
   K4 through a 64-deep chain, held against the plain versions and timed
   against the bytes bound, with scaled_dot_product_attention over the
   K/V gathered dense timed beside them (``dense_sdpa_ms``, a yardstick).
   K3 is also timed at 1-16 pages a split beside the planner's pick, at
   four shapes up to batch 512 (``split_sweep`` on its row). K1 runs on
   the strided ``l2[..., 0]`` of the packed words (its bound 8 bytes a
   walked entry), with its time on the contiguous plane beside it and its
   ms with each walk forced (a thread or a warp a page) beside the
   planner's pick (``walk_sweep`` on its row; phase 7 adds the fleet's
   shapes). K2 likewise runs on the ``l2[..., 0]``/``l2[..., 1]`` pair of
   the packed words, with its time on the two contiguous planes beside it
   (``plane_ms``) and its layout (``elem_stride``). K1's batch entry
   (``resolve_auto_batch``, the auto resolve) has a row of its own at the
   engine's call: every page, one row of ids expanded over the tenants;
   every leaf bit-exact with each walk forced and with the planner's pick
   (``walk_sweep``), its bound the active entries, the untrusted reads'
   walks, the ids, lengths and leaves (phase 7 adds the read's shape).
   Its launches count under K1's name too; K1's row counts the whole
   map's alone.
6. store — one 16 GiB virtual disk (262,144 clusters of 64 KiB, float32
   pages of 16,384) in both formats with the same content: a base layer
   at 25 % fill, then 64 random clusters per layer with a snapshot
   between, read at chain length 1 and 500. dd (``store.materialize``,
   every method; ``direct`` on the scalable image only, as the paper's
   Fig. 15) and YCSB-C (``store.read`` of 4,096 uniform random clusters,
   Fig. 18); every read of one content must be bit-identical across
   methods and formats; at depth 500 the vanilla walk costs about 500
   lookups a request and direct exactly 1. K6/K7/K8 run on the disk's own
   planes and must equal ``store.read``; at depth 500 each is held against
   its plain version and timed as in phase 5. K6's row carries
   ``pages_a_thread``, ``layers_a_batch``, ``words_walked`` and
   ``group_words_walked`` (V times the deepest walk of each group of V
   pages a thread: what the group reads past its pages' own walks), as
   its checkpoint-chain row does. K7's row carries
   ``size_sweep``: K7 at N = 2^18 to 2^24, each size held bit-exact,
   and the line through (bytes, ms): its slope as a rate and its
   intercept, the fixed cost a call.
7. fleet — 64 tenants, each a 1 GiB disk (16,384 clusters) at 12.5 %
   fill, tenant t grown to chain length 1 + 499 t / 63 with 4 clusters a
   layer, one format at a time. ``fleet.read(auto)`` (K1's batch entry,
   one launch over the read's pages, + K5) of
   1,024 random clusters per tenant must equal ``method="vanilla"`` bit
   for bit. Cold tier: two 16,384-row ``demote_tenants`` calls on the odd
   tenants, then the device read is zeros exactly where cold,
   ``read_tiered`` and the read after ``promote_tenants`` equal the read
   before, and ``free_tenant(store=)`` returns every host row.
   ``fleet.read(pallas_vanilla)`` is timed with CUDA events and profiled
   with K1, K2, K5 and the copies apart (the profiler's split is an
   estimate where it dropped events; these measurements and a profile's
   retakes leave the launch and page counts as they were);
   ``fleet.read(auto)``, the read the benchmark's cells time
   (``snapbench/``), is checked here and not timed. K5 is held against its plain
   version and timed on the vanilla fleet's read; K1 likewise at the
   fleet's shape on the strided words (beside the contiguous plane and the
   copy it no longer pays), then swept over its walks at P = 16-16,384;
   K2 at the fleet's shape on the ``l2[..., 0]``/``l2[..., 1]`` pair
   (``k2_fleet_shape``: bit-exact, its bound, the contiguous planes' time
   and ``plane_copy_ms``, the two copies it no longer pays; its
   ``size_sweep`` at 16-1,024 tenants of 16,384 pages, as K7's). K1's
   batch entry at the read's 64 x 1,024 ids on both formats
   (``auto_batch_fleet_shape``: every leaf bit-exact with each walk and
   the planner's pick, each timed, beside its bound).
   The pallas_vanilla read is timed by CUDA events after a spin of twice
   its host ms (so the host has enqueued the whole read before the first
   event), and after a spin of 1 ms and of four times its host ms beside
   it (``read_pallas_vanilla_device_ms_by_spin``): the time is device
   time only where it stays flat as the spin grows.
8. maintenance — (a) one disk: the phase-6 disk at depth 500 (pool of
   196,608 rows), one format at a time, ``store.stream(chain, 498,
   copy_data=True)``, then ``compact_pool``, then on the vanilla image
   ``convert_to_scalable``; after each step every read (page chunks,
   every method the format serves) is bit-identical to the read before
   streaming, and YCSB-C's mean walk falls from ~470 lookups to at most 2.
   ``plan_merge`` (one launch of K9's word entry on the packed words) is
   timed on the host clock and with CUDA events, and held bit-exact
   against the planes-then-``merge_ref`` composition it replaced; K9's
   word entry on the disk's own (499, 262,144, 2) words and its planes
   entry on the bool planes are each held against their plain versions
   and timed against their own bounds.
   (b) a fleet: the phase-7 fleet, one format at a time, streamed
   stop-the-world (``stream_tenants``, one call) and, on a copy, budgeted
   (``MaintenanceScheduler``, 4 tenants a tick, drained); after each,
   ``fleet.read(auto)`` equals the reference, every length is at most 2,
   quanta came free and ``check_fleet_invariants`` passes. Then 256
   clusters a tenant are overwritten twice and ``compact`` must keep the
   reads and give the garbage back; on the vanilla fleet a demotion-policy
   scheduler (``TieredStore``, device budget 75 % of the rows, 4,096 rows
   a tick) drains to the budget with ``read_tiered`` equal to the
   reference. (c) Qwen2.5-3B (phase 4's weights and prompts) on vanilla
   fused engines: 12 steps without and with a scheduler over a fresh
   phase-7 fleet, the two engines stepping in turns (same tokens, at
   least 12 tenants streamed, the fleet's reads unchanged), then park /
   4 steps / resume / 4 steps of the
   512-token sequence against a run that never parks it (same tokens,
   host blocks back to 0, ``check_kv_invariants`` after each event).

9. golden — (a) Qwen2.5-3B (phase 4's weights) on a vanilla fused engine
   and a scalable tables engine: a golden prompt of 392 tokens registered
   (24½ blocks of 16, so a fork's shared tail block is copied on write),
   four prompts extending it by 0, 17, 100 and 200 tokens admitted through
   the trie (suffix buckets 32, 128, 256: ``paged_suffix_prefill``, K3's
   shared-table entry with the bucket's rows on the sequence's one table)
   and one miss. Each hit's first token and
   gathered K/V must equal, bit for bit, a duplicate-storage admission
   through the same ``_suffix_prefill``; ``golden_stats`` must show at
   least 24 blocks saved a fork; hits and duplicates then decode 8 steps
   to the same tokens, ``release_golden`` after the 4th. Printed: each
   admission's ms beside a full prefill of the 592-token prompt, and the
   blocks the hits hold against the duplicates'. K3 at the 256-row suffix
   shape (lengths 393-592), through the shared-table entry and through the
   JAX-signature entry on the table repeated, is held against its plain
   version and timed against its bound, with its plan, dense SDPA beside
   it (``suffix_shape`` on K3's row). (b) At the end of phase 7, on its vanilla fleet while it
   lives: the tenants of depth 1, 64 and 500 (256 rows of the deeper two
   demoted first) migrate to a 4-tenant scalable fleet with twice the
   lease quantum; export, import, verify (``materialize_tenant`` of both,
   one tenant alone, bit for bit) and detach are timed, with the device
   memory one verify adds at its peak. (c) A request on a vanilla engine
   (bs 16) forked, its parent finished, and the child migrated to a
   scalable engine of block size 32: its next 8 tokens equal an unmigrated
   reference engine's. (d) Also on the phase-7 fleet: tenant 16 (depth
   127) registered in a ``GoldenRegistry`` and forked into 8 free slots
   at depths 127 and 64 (each fork then writes and snapshots); a
   ``MaintenanceScheduler(registry=...)`` over a device budget ticks 3
   times, ``check_fleet_invariants(registry=...)`` after each, the owner
   never streamed and every fork page on a pinned row still on it, hot.
10. paper — the paper's evaluation plane; its lines carry ``"phase":
   "paper"`` and the card's name and power limit. (a) Fig 17: Qwen2.5-3B's
   params in bf16 (drawn as phase 4 draws them) and an int32 step in a
   ``SnapshotCheckpointer`` (8 KiB pages, pool slack 4, max_chain 34,
   streaming off), one format at a time (scalable, then vanilla): 32
   saves, before each a small bf16 delta to layer i % 36 of
   ``layers.attn.wo`` and a step bump; after saves 1, 8 and 32 every
   method's restore (all four on the scalable chain; the walks and
   ``auto`` on the vanilla one, whose active volume alone indexes
   nothing) is bit-equal to the live state and timed by CUDA events
   beside the bound (the image in and out), with ``resolve_cost``. On the
   vanilla chain at depth 32: the threshold set to 30 and ``maybe_stream``
   (K9 at full width, held against its plain version first), a restore
   again, then 4 ``save_async`` calls each followed at once by an
   in-place change, each restoring to the state at its submission. K1,
   K2, K6, K7, K8 and K9 at the checkpoint chain's shape against their
   plain versions (``ckpt_shape`` on their rows). Then the page gather's
   sweep (``page_sweep`` on K5's and K8's rows): 6.79 GB of all-found
   pages of 8, 16 and 64 KiB and two small reads, each bit-exact, timed
   beside ``torch.index_select`` and the card's contiguous copy of the
   same bytes. (b) Figs 13, 14 and 16:
   the Qcow2 slice-cache model on phase 6's two depth-500 disks (their
   index tables, kept on the host through phases 7-9): a sequential sweep
   of 16,384 clusters and phase 6's YCSB-C batch, 1 MiB of L2 cache a file
   (8,192 slots), ``summarize``, Eq. 1 latencies (mean, p99) and ms a
   request; then 30-100 % of the disk's slices, the unified cache S slots
   and each vanilla file S // 500, modelled IOPS. Probes equal the walk's
   lookups (unified: one a request), hits the resolvers' found, misses on
   the random stream a host ``OrderedDict`` LRU oracle, and the first 256
   requests the same simulation on the CPU. (c) Fig 12's cache-memory model
   and Eq. 2 (models, not card numbers). (d) In phase 7, after its
   demotions, ``tier_residency`` equals the phase's own counters.
11. families — the rest of the decoder-only family; its lines carry
   ``"phase": "families"`` and the card's name and power limit. (a) Phase
   3 for the smoke configs of Qwen2-MoE-A2.7B, Phi-3.5-MoE, Nemotron-4-15B
   and Chameleon-34B, the MoE ones with a golden suffix admission in the
   lifecycle. (b) Qwen2-MoE-A2.7B at full width and depth (bf16 weights
   drawn on the card from seed 0; every parameter counted by kind; the
   init's peak memory): phase 4's four engines and profile, the profile's
   device time under the MoE's steps by ``record_function`` range (expert
   products, shared expert, dispatch/combine) beside the weight-read
   bound; K3/K4 at its engine state and at the long context (16 KV heads,
   group 1) beside dense SDPA; phase 9a's golden admission (a hit and its
   duplicate, two identical rows of one batch, may decode apart under the
   experts' capacity); then one decode step (8 padded rows) and the
   200-token admission (the 256-row bucket) again with every layer's MoE
   input recorded: the dropped assignments a layer, and layer 12's input
   through ``moe_apply`` on the card in bf16 against the CPU in f32
   (``moe_check``: routing and drops equal off near ties, outputs within
   2e-2 relative L2). (c) Nemotron-4-15B and Qwen2-7B whole, Chameleon-34B
   (24 of 48 layers), Phi-3.5-MoE (16 of 32) and Qwen2-72B (16 of 80) at
   full width on a vanilla engine of 256 blocks: 8 timed steps on each
   path, the same tokens on both, K3/K4 at the engine's state.
12. train — training on the snapshot-checkpoint chain; its lines carry
   ``"phase": "train"`` and the card's name and power limit. (c) One
   training step of the smoke qwen2.5-3b and qwen2-moe on the card
   against the CPU: ``batch_at``'s tokens bitwise, the loss and every
   gradient within 2e-2 relative L2. (a) Qwen2.5-3B whole at full width,
   f32 state, bf16 compute, remat, 1 x 4,096 tokens: 3 steps by CUDA
   events, tokens/s, peak GB, the model FLOPs' share of the bf16 peak,
   and a profiled step split into matmuls, attention, AdamW and the rest.
   (b) The ``Trainer`` at full width with 2 of 36 layers, 12 steps, a save
   every 2: run whole, then crashed after step 7 and resumed at step 6
   through direct, pallas_vanilla and pallas_direct (word-exact), its
   final loss within 1e-5 of the whole run's. After each run's last save,
   past the pool GC, every restore method reads the saved image back,
   and each GC merge equals the plain merge (K9 at this shape,
   ``train_shape`` on its row). The resumed weights serve a forked pair
   on both decode paths, in bf16 and in f32 against the plain greedy
   ``prefill``/``decode_step``.
13. families — the other model families: RWKV-6 (ssm), Zamba2 (hybrid:
   Mamba2 and a shared attention block) and Whisper (encoder-decoder); its
   lines carry ``"phase": "families"`` and the card's name and power
   limit. (a) The three smoke configs on the card against the CPU (bf16
   on both, the same weights): prefill logits, a decode step into a cache
   with room, the loss and every gradient within 2e-2 relative L2;
   ``batch_at``'s frames bitwise. (b) RWKV6-3B, Zamba2-2.7B and
   Whisper-base (1,500 frames) whole, bf16 weights drawn on the card from
   seed 0: prefill 8 prompts of 512 tokens, 16 greedy decode steps into a
   cache with room, prefill ms and decode ms a step by CUDA events, wall
   ms, peak GB; prefill(S) and one decode step against prefill(S + 1),
   and RWKV-6's chunked prefill against its scan, in bf16 within 1e-1
   relative L2 (bf16's roundings compound over the random-weight layers)
   and in f32 compute on the same weights within 1e-3. (c) RWKV6-3B trained whole (chunked
   form, f32 state, bf16 compute, remat, 1 x 4,096 tokens): 3 steps by
   CUDA events after a warm-up, tokens/s, peak GB, its bound from the
   shapes (``rwkv_train_flops``); one Zamba2-2.7B step at 1 x 512. (d)
   Whisper-base whole on the ``Trainer``'s chain, 4 x 448 tokens with
   frames, 12 steps saving every 2, crashed after 7 and resumed at 6
   through the three methods, word-exact, every resumed loss bitwise
   equal to the whole run's; each pool-GC merge (K9) equals the plain
   merge (``whisper_train_shape`` on K9's row). 13d's K1/K2/K8/K9
   launches go on the kernels line.
14. distributed — distribution and the launchers, on a one-rank
   ``nccl`` group (``launch.mesh.make_host_mesh``) destroyed at its end;
   its lines carry ``"phase": "distributed"`` and the card's name and
   power limit. (f) starts first, in a subprocess. (a) The serve launcher
   (``launch.serve.main``) at full width, Qwen2.5-3B, both formats and
   both decode paths (fused at 128 blocks a sequence): its tokens equal an
   ``Engine`` stepped directly on the same weights, and ``n_seqs``,
   ``blocks_in_use`` and ``lookups`` equal the launcher's at the smoke
   scale on the CPU; K1-K4 launch. (b) Qwen2.5-3B whole in bf16 placed by
   ``param_shardings`` on the host mesh under ``use_rules``: a 4 x 512
   prefill's logits and one decode step bitwise the plain run's, the
   host ms of both paths; then every smoke config: prefill, a decode
   step, the loss and every gradient bitwise, both runs under
   deterministic algorithms.
   (c) ``restore(shardings=)`` of a Qwen2.5-3B bf16 checkpoint chain at
   phase 10's page size through direct, pallas_vanilla and pallas_direct
   (K1, K2, K8): ``DTensor`` leaves with the requested placements, their
   local tensors bitwise the saved state, each timed by CUDA events
   beside the unsharded restore. (d) ``make_dp_train_step`` at Qwen2.5-3B's
   width with 2 layers, f32 state, 3 steps of 4 x 64 under deterministic
   algorithms: without compression bitwise ``make_train_step``; with int8
   compression every residual within its leaf's scale; step ms and
   ``wire_bytes`` on 2 and 16 ranks. (e) The training launcher
   (``--scale smoke --steps 8 --ckpt-every 1``: its pool GC merges, K9)
   on the host mesh, its state and batches ``DTensor``s, its last loss
   bitwise a plain ``Trainer``'s; and ``--production``'s refusal. (f) ``python -m repro_torch.launch.dryrun
   --arch qwen2.5-3b --shape train_4k`` (the 16x16 fake group), its
   record's headline fields.

15. storm — the seeded storm of both planes (``tests/scenario/
   harness_torch.py``: COW writes, snapshots, streaming, compaction,
   scheduler ticks, demote/promote, free/attach, migration to a fleet of
   another geometry, writes mid-migration, golden register/fork/release;
   KV fork storms, appends, tombstone cascades, park/resume, sequence
   migration, golden admission), the invariant suite after every event
   and the data oracle every 10; its lines carry ``"phase": "storm"`` and
   the card's name and power limit. (a) The harness's geometry, seeds 0-2,
   200 events each, on the card and on the CPU in this process: equal
   traces and final states equal word for word and byte for byte; K1
   (the auto resolve's batch entry), K5 and K9 launch in the events (the
   checks run uncounted). (b) 200
   events at deployment scale (``STORM_SCALE``: 64 tenants of 512
   clusters of 64 KiB, chains to 256, Qwen2.5-3B's KV geometry, 36 layers
   x 2 KV heads x 128 in blocks of 16; the cuts from phase 7's fleet and
   the check costs that force them are named beside the constants): host
   ms an event and of its checks by kind, of a check with and without the
   data oracle, events a second, launches, peak device memory.

Phases 10 to 15 start with ``gc.collect()``, and before it a report
of what it frees (``cycles``): the CUDA tensors that only reference
cycles hold, largest first, with the objects that refer to them;
``held_GB_before_collect`` must then stay within 1 GB of
``held_GB_at_start``.

Launch counts are zeroed just before each phase's main path (an engine's
run, a store depth, a fleet, each part of phase 9, each checkpoint chain
of phase 10, each engine of phase 11, phase 12b's and 13d's trainer
paths, phase 14's launcher runs and sharded restores, phase 15's storms
on the card) and read
just after it,
before any kernel is compared with its plain version. Every row of the kernels line carries
``floor_ms``: ``timed_ms`` of a one-element ``zero_()``, the harness's
floor under the same flush and spin.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine with no card, or a
directory without the repo's ``src/``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import inspect
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
# K3/K4 at the long context against their plain versions (bf16): outputs
# there have a spread of ~0.036, so the abs limit is a few bf16 ulps near
# 0.2 (a sound run differs by one, 0.00098), and the relative L2 error is
# bounded too (a dropped page of 128 moves it by ~0.2)
LONG_CONTEXT_TOL, LONG_CONTEXT_REL_TOL = 4e-3, 1e-2
SWEEP_SPLITS = (1, 2, 4, 8, 16)  # pages per split K3 is timed at (phase 5)
# phase 6: one virtual disk (benchmarks/paper_figs.py frames a page as a
# 64 KiB Qcow2 cluster); 16 GiB so two images and two full reads share
# one 80 GB card
CLUSTER = 16_384                 # float32 per page: 64 KiB
DISK_PAGES = 262_144             # 16 GiB
DISK_CHAIN = 512
DISK_POOL = 98_304               # 65,536 + 499 * 64 = 97,472 rows used
DISK_DEPTHS = (1, 500)
BASE_FILL = 65_536               # 25 %, as fig18_ycsb
LAYER_WRITES = 64
YCSB_BATCH = 4_096
DD_TIMED, YCSB_TIMED = 3, 20
PROFILED_DD = ("vanilla/vanilla", "vanilla/pallas_vanilla", "scalable/direct")
# phase 7: a fleet of 64 one-GiB disks; chain lengths 1..500 (the paper's
# §3 long tail)
FLEET_T, FLEET_PAGES, FLEET_CHAIN, FLEET_Q = 64, 16_384, 512, 64
FLEET_BASE, FLEET_LAYER_WRITES, FLEET_BATCH = 2_048, 4, 1_024
FLEET_MAX_DEPTH = 500
DEMOTE_ROWS, DEMOTE_CALLS = 16_384, 2
FLEET_SWEEP_PAGES = (16, 64, 256, 1_024, 16_384)   # K1's walk sweep (phase 7)
# phase 8: maintenance. The streamed disk needs room for the copy:
# 97,472 rows in use + about 89,000 merged pages moved to fresh rows
MAINT_DISK_POOL = 196_608        # 12.9 GB
MAINT_DEPTH = 500
COMPARE_PAGES = 32_768           # pages per chunk of a full-disk comparison
SCHED_TENANTS_PER_TICK, SCHED_THRESHOLD = 4, 3
OVERWRITE = 256                  # clusters per tenant, written twice
DEMOTE_BUDGET_SHARE, DEMOTE_PER_TICK, HOST_ROWS = 0.75, 4_096, 32_768
MAINT_STEPS, PARK_STEPS = 12, 4
# phase 9: golden admission (a prompt of 24 full blocks of 16 and a partial
# one, so the fork's tail block takes the copy-on-write path) and migration
GOLDEN_PROMPT = 392
GOLDEN_EXTENSIONS = (0, 17, 100, 200)   # suffix buckets 32, 128 and 256
GOLDEN_STEPS = 8
MIGRATE_TENANTS = (0, 8, 63)            # the phase-7 tenants of these depths
MIGRATE_DEPTHS = (1, 64, 500)
MIGRATE_COLD = 256                      # rows demoted from the deeper two first
MIGRATE_POOL = 9_216                    # destination rows: ~7,900 hot + slack
REGISTRY_OWNER, REGISTRY_FORKS, REGISTRY_SHALLOW = 16, 8, 64
REGISTRY_TICKS, REGISTRY_STREAMS = 3, 16
# phase 10: the paper's evaluation plane. Fig 17 as paper_figs.fig17_boot:
# delta saves into a chain two deeper than the saves, streaming off
CKPT_SAVES = 32
CKPT_RESTORE_AT = (1, 8, 32)
CKPT_MAX_CHAIN = CKPT_SAVES + 2
CKPT_STREAM_AT = 30              # SETUP.streaming_threshold, set at depth 32
CKPT_ASYNC = 4
CKPT_TIMED = 3                   # CUDA-event timed restores per method
# a delta: one layer of wo (8 MiB, straddling a page boundary) + step's page
CKPT_DELTA_PAGES = (1_025, 1_026)
SIM_SWEEP = 16_384               # clusters of the sequential stream
SIM_PREFIX = 256                 # requests held against the CPU simulation
FIG12_LENGTHS, FIG12_SLOTS = (1, 5, 50, 100, 500, 1000), 64
# the page gather (K8; K5 on the fleet row, the same body) over page
# sizes: the checkpoint chain's 6.79 GB image as all-found pages of 8, 16
# and 64 KiB in random order, and two small reads (a grid that cannot
# fill the card). (label, page bytes, pool rows, B)
GATHER_SWEEP = (
    ("image_8KiB", 8_192, 829_376, 829_376),
    ("image_16KiB", 16_384, 414_688, 414_688),
    ("image_64KiB", 65_536, 103_672, 103_672),
    ("few_8KiB", 8_192, 829_376, 256),
    ("few_64KiB", 65_536, 98_304, 64),
)
# phase 11: the rest of the decoder-only family. Qwen2-MoE-A2.7B whole;
# the dense variants and Phi-3.5-MoE whole where they fit one card, else
# at full width with the depth cut to fit beside a pool of 256 blocks
FAMILY_SMOKE = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "nemotron-4-15b",
                "chameleon-34b")
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CHECK_LAYER = 12             # the layer whose MoE input is held to the CPU
MOE_REL_TOL = 2e-2               # bf16 on the card against f32 on the CPU
FAMILY_DEPTHS = (("nemotron-4-15b", None), ("qwen2-7b", None),
                 ("chameleon-34b", 24), ("phi3.5-moe-42b-a6.6b", 16),
                 ("qwen2-72b", 16))
FAMILY_POOL, FAMILY_STEPS = 256, 8
# phase 12: training on the snapshot-checkpoint chain. 12a: Qwen2.5-3B
# whole, f32 params and AdamW state (54.4 GB), bf16 compute, remat, one
# sequence of train_4k's 4,096 tokens (its global batch of 256 cut to 1 so
# that the state fits one card). 12b: the Trainer at full width with the
# depth cut to fit beside its chain (a pool of 4x the state, a shadow
# image, a save's fresh image: ~92 B a parameter; 61.5 GB peak at 1 layer
# on an H100, so 2 layers, ~68.6 GB), the launcher's batch of 4 x 64.
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_TIMED = 4_096, 1, 3
TRAIN_CHAIN_LAYERS = 2
TRAIN_CHAIN_STEPS, TRAIN_CHAIN_EVERY, TRAIN_CRASH = 12, 2, 7
TRAIN_CHAIN_BATCH, TRAIN_CHAIN_SEQ, TRAIN_PAGE = 4, 64, 2_048
TRAIN_RESTORE_TIMED = 3
TRAIN_SERVE_STEPS = 4            # tokens the served pair decodes after the first
TRAIN_SMOKE = ("qwen2.5-3b", "qwen2-moe-a2.7b")
TRAIN_REL_TOL = 2e-2             # bf16 on the card against bf16 on the CPU
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores
# phase 13: the other model families. 13b serves each at full width and
# depth; 13c trains RWKV6-3B whole on one sequence of train_4k's 4,096
# tokens (its global batch of 256 cut to 1 so that the f32 state, 49.2 GB,
# fits one card, as 12a) and takes one Zamba2-2.7B step at 512 tokens (its
# per-token scan launches a few kernels a token and layer); 13d runs
# Whisper-base whole on the trainer's chain at 4 x 448 tokens (its decoder
# context) with 1,500 frames.
FAMILY_ARCHS = ("rwkv6-3b", "zamba2-2.7b", "whisper-base")
FAMILY_PROMPTS, FAMILY_PROMPT, FAMILY_DECODE = 8, 512, 16
FAMILY_TRAIN = (("rwkv6-3b", 4_096, 3), ("zamba2-2.7b", 512, 1))
FAMILY_CHAIN_ARCH, FAMILY_CHAIN_BATCH, FAMILY_CHAIN_SEQ = "whisper-base", 4, 448
FAMILY_REL_TOL = 2e-2            # bf16 on the card against bf16 on the CPU
# decode against prefill(S + 1) and RWKV's chunked prefill against its
# scan: the same function in another op order. In bf16 the roundings of
# 32-54 random-weight layers compound (0.6-4.4e-2 measured on an H100);
# f32 compute on the same weights holds the algorithm
FAMILY_BF16_TOL, FAMILY_F32_TOL = 1e-1, 1e-3
# phase 14: distribution and the launchers. (a) the serve launcher at full
# width, both formats, both decode paths (fused: 128 blocks a sequence);
# (b) Qwen2.5-3B whole in bf16 placed on the host mesh, a 4 x 512 prefill
# and one decode step; (d) the DP step at 12b's cut (2 layers, 4 x 64);
# (e) the training launcher with a save a step for 8 steps, so that its
# pool GC merges (K9)
DIST_ARCH = "qwen2.5-3b"
DIST_SERVE = ((False, "auto", 64), (True, "auto", 64),
              (False, "fused", 128), (True, "fused", 128))   # vanilla, path, blocks
DIST_PREFILL = (4, 512)
DIST_DP_LAYERS, DIST_DP_STEPS, DIST_DP_BATCH = 2, 3, (4, 64)
DIST_WIRE_RANKS = (2, 16)      # the pod axis and the data axis
DIST_TRAIN_ARGV = ["--scale", "smoke", "--steps", "8", "--ckpt-every", "1"]
DIST_RESTORES = ("direct", "pallas_vanilla", "pallas_direct")
# phase 15: the seeded storm of both planes (tests/scenario/harness_torch.py).
# (a) the harness's own geometry, seeds 0-2, 200 events, card against CPU;
# (b) deployment scale: phase 6/7's 64 KiB pages and 64 tenants, and
# Qwen2.5-3B's KV geometry on the serving plane. The phase has ~90 s: 200
# events, the invariant suite after each, the data oracle after every
# 10th. Two costs set the cuts from phase 7's fleet (64 disks of 16,384
# clusters, 1 GiB; chains to 500), each a host read that grows with a
# dimension of the fleet (H100, 700 W: 1.2-1.4 ms a MB for a data
# check, which reads both fleets' disks to the host and compares them;
# 0.33-0.62 ms a MB of L2 words for the invariants, which read every
# fleet's L2):
#   disks of 512 clusters (32 MiB; 1/32 of phase 7's): 20 data checks of
#   (64 + 16) x 32 MiB = 2.7 GB, 3.3-3.7 s each, 65-73 s; at 16,384
#   clusters one check would take ~2 min;
#   chains to 256 (of 500): 180 invariants-only checks of 84 MB of L2
#   words, 28-52 ms each, 5-10 s (at 500, 164 MB, 55-100 ms each, 10-18
#   s, and the phase would pass 90 s).
#   A 200-event storm, which streams and compacts as it snapshots, keeps
#   its chains far shorter than either anyway;
# a pool of 16,384 rows (1 GiB), half the disks' clusters, so that the
# scheduler's device budget (half the pool) binds.
STORM_SEEDS = (0, 1, 2)
STORM_EVENTS = 200
STORM_SCALE = dict(
    n_tenants=64, n_pages=512, page_size=16_384, max_chain=256,
    pool_capacity=16_384, lease_quantum=8,
    dst_tenants=16, dst_max_chain=264, dst_pool_capacity=8_192,
    dst_lease_quantum=16,
    kv_layers=36, kv_heads=2, kv_head_dim=128, kv_block_size=16,
    kv_blocks=1_024, kv_max_blocks=128, kv_dst_block_size=32,
    kv_dst_blocks=512,
)
STORM_KERNELS = ("resolve_vanilla_fleet", "gather_fleet", "merge")
DEV = "cuda"                     # phases 6-15 run here
KERNEL_SOURCES = {
    "resolve_vanilla_fleet": ("src/repro_torch/csrc/chain_resolve.cu",
                              "src/repro/kernels/chain_resolve/chain_resolve.py:145"),
    "resolve_direct_fleet": ("src/repro_torch/csrc/chain_resolve.cu",
                             "src/repro/kernels/chain_resolve/chain_resolve.py:190"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/paged_attention.py:90"),
    "fused_chain_attention": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention/paged_attention.py:220"),
    "gather_fleet": ("src/repro_torch/csrc/cow_gather.cu",
                     "src/repro/kernels/cow_gather/cow_gather.py:59"),
    "resolve_vanilla": ("src/repro_torch/csrc/chain_resolve.cu",
                        "src/repro/kernels/chain_resolve/chain_resolve.py:58"),
    "resolve_direct": ("src/repro_torch/csrc/chain_resolve.cu",
                       "src/repro/kernels/chain_resolve/chain_resolve.py:94"),
    "gather": ("src/repro_torch/csrc/cow_gather.cu",
               "src/repro/kernels/cow_gather/cow_gather.py:27"),
    "merge": ("src/repro_torch/csrc/stream_merge.cu",
              "src/repro/kernels/stream_merge/stream_merge.py:41"),
    # K1's batch entry: the auto pick of K1 (:145) and K2 (:190) at a
    # read's pages; its launches are counted under K1's name too
    "resolve_auto_batch": ("src/repro_torch/csrc/chain_resolve.cu",
                           "src/repro/kernels/chain_resolve/chain_resolve.py:145"),
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


def reference_phase(torch, mods, arch="qwen2.5-3b", line=emit, golden=False):
    """The smoke config of ``arch`` in float32: the lifecycle's tokens on
    the card equal the CPU's, both formats x both decode paths; with
    ``golden`` the lifecycle also registers a golden prompt and admits an
    extension of it (a suffix-prefill pass)."""
    L, Engine, smoke_config, init_params = (mods["layers"], mods["Engine"],
                                            mods["smoke_config"],
                                            mods["init_params"])
    cfg = smoke_config(arch)
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        cpu_params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        gpu_params = _to(torch, cpu_params, "cuda")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 3)]
        base = rng.integers(0, cfg.vocab_size, size=6) if golden else None
        for scalable in (True, False):
            for path in ("tables", "fused"):
                toks = []
                for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
                    eng = Engine(cfg, params, scalable=scalable, n_blocks=256,
                                 block_size=4, max_blocks_per_seq=128,
                                 decode_path=path, device=dev)
                    toks.append(_lifecycle_tokens(eng, prompts, depth=12,
                                                  golden=base))
                require(toks[0] == toks[1],
                        f"{arch}: card vs CPU tokens differ (scalable={scalable}, "
                        f"{path})")
                line({"phase": "reference", "model": arch, "scalable": scalable,
                      "path": path, "golden_admission": golden,
                      "tokens_equal_card_vs_cpu": True,
                      "n_tokens": sum(len(v) for v in toks[0].values())})
    finally:
        L.COMPUTE_DTYPE = saved


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


def _lifecycle_tokens(eng, prompts, depth, golden=None):
    sids = [eng.add_request(p) for p in prompts]
    eng.fork_request(sids[1])
    sid = sids[0]
    for d in range(depth):
        child = eng.fork_request(sid)
        eng.finish_request(sid)
        sid = child
        if d % 4 == 0:
            eng.step()
    if golden is not None:
        gsid = eng.register_golden(golden)
        eng.add_request(np.concatenate([golden, prompts[1][:3]]))
        require(eng.golden_hits == 1, "the golden extension did not fork")
    for _ in range(3):
        eng.step()
    out = {s: list(t) for s, t in eng.active.items()}
    if golden is not None:
        eng.release_golden(gsid)
    for s in sorted(eng.active):
        eng.finish_request(s)
    require(eng.kv.blocks_in_use() == 0, "blocks leaked at smoke size")
    return out


# -- phase 4: full-size serving ----------------------------------------------


def serve_phase(torch, mods, cfg, params, prompts, tag=None, groups=None,
                ranges=None):
    """Four engines over ``prompts``, each step timed, profiled and
    launch-counted. Phase 4's lines are ``{"phase": "serve"|"profile"}``;
    with ``tag`` (phase 11) each line is ``tag`` with ``"part"``. The
    profile groups kernels by name (``groups``, phase 4's by default) and,
    with ``ranges``, the device time under the MoE's steps by range
    (``moe_ranges``)."""
    Engine, _build = mods["Engine"], mods["_build"]
    results, captured = {}, None

    def line(kind, obj):
        emit({"phase": kind, **obj} if tag is None else {**tag, "part": kind, **obj})

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
            with moe_ranges(torch, mods, ranges):
                profile = profile_calls(torch, eng.step, PROFILED, step_ms,
                                        groups or SERVE_GROUPS, ranges=ranges)
            launches = dict(_build.LAUNCHES)       # read just after the run
            tokens = {s: list(t) for s, t in eng.active.items()}
            if not scalable and path == "fused":
                captured = capture_state(torch, eng)
            for s in sorted(eng.active):
                eng.finish_request(s)
            require(eng.kv.blocks_in_use() == 0, f"{name}: blocks leaked")
            # the auto resolver is one launch of K1's batch entry
            want = ({"resolve_vanilla_fleet"}
                    | {"paged_attention" if path == "tables"
                       else "fused_chain_attention"})
            for k in want:
                require(launches[k] > 0, f"{name}: kernel {k} never launched")
            results[name] = dict(tokens=tokens, launches=launches,
                                 per_step=per_step)
            line("serve", {"engine": name, "model": cfg.name,
                  "batch": batch, "steps_timed": len(ms),
                  "ms_per_step": step_ms,
                  "tokens_per_s": batch * 1000.0 / step_ms,
                  "max_chain": eng.kv.fleet.spec.max_chain,
                  "launches": launches, "launches_per_step": per_step,
                  "blocks_in_use_after": eng.kv.blocks_in_use()})
            line("profile", {"engine": name, **profile})
            del eng
            torch.cuda.empty_cache()
    for fmt_name in ("scalable", "vanilla"):
        same = (results[f"{fmt_name}/tables"]["tokens"]
                == results[f"{fmt_name}/fused"]["tokens"])
        require(same, f"{fmt_name}: tables and fused paths emitted different tokens")
        line("serve", {"format": fmt_name, "tables_equal_fused_tokens": True})
    return results, captured


SERVE_GROUPS = {"attention (K3/K4)": ("paged_attention_kernel",
                                      "fused_chain_attention_kernel",
                                      "shared_table_kernel",
                                      "attention_combine"),
                "chain resolve (K1/K2)": ("fleet_kernel",),
                "matmul": ("nvjet", "gemm", "gemv", "xmma", "cutlass")}
READ_GROUPS = {"gather (K5/K8)": ("gather_pages_kernel",),
               "walk (K1)": ("vanilla_fleet_kernel",),
               "direct (K2)": ("direct_fleet_kernel",),
               "single-chain resolve (K6/K7)": ("vanilla_kernel", "direct_kernel"),
               # a strided .contiguous() (K2's two word planes) or a cast
               "copies and casts": ("direct_copy_kernel",),
               "other copies and indexing": ("copy", "Copy", "elementwise", "index",
                                             "Index", "gather", "scatter", "where",
                                             "fill")}


@contextlib.contextmanager
def uncounted(_build):
    """Launches made inside are measurements, not the main path's run: the
    launch and page counts are put back as they were on the way out."""
    before, pages = dict(_build.LAUNCHES), dict(_build.PAGES)
    try:
        yield
    finally:
        _build.LAUNCHES.update(before)
        _build.PAGES.update(pages)


def profile_calls(torch, fn, n, wall_ms, groups, tries=1, counts=None,
                  ranges=None):
    """Kernel time by kernel over ``n`` calls of ``fn`` under torch.profiler:
    a kernel's ms a call is its total over the trace divided by ``n``. The
    device idle share compares the device time per call with the
    unprofiled ``wall_ms`` (the profiler slows the host, not the kernels).
    The profiler now and then drops device events: a call whose ``fn``
    does the same work every time passes ``tries`` > 1 and the launch
    counts (``counts``, the ``_build`` module), and a trace with no device
    events, or with a kernel seen a number of times that is not a multiple
    of ``n``, is taken again, up to ``tries`` times, its launches left
    uncounted. ``complete`` says whether the last trace was whole; a split
    from an incomplete one is an estimate (it misses the dropped events).
    ``ranges`` maps a group to ``torch.profiler.record_function`` names:
    the device time of the kernels launched under those ranges is that
    group's, taken out of the name groups (``other``)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with (uncounted(counts) if attempt else contextlib.nullcontext()), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                out = fn()
                del out
            torch.cuda.synchronize()
        # device events only: a CPU op also reports the device time of the
        # kernels it launched, which would count them twice
        range_names = {r for rs in (ranges or {}).values() for r in rs}
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in range_names]
        complete = bool(events) and all(e.count % n == 0 for e in events)
        if complete:
            break
    by_kernel = {}
    for e in events:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / n
    device_ms = sum(by_kernel.values())
    by_group = {g: 0.0 for g in groups}
    by_group["other"] = 0.0
    for k, v in by_kernel.items():
        g = next((g for g, keys in groups.items() if any(x in k for x in keys)),
                 "other")
        by_group[g] += v
    for g, names in (ranges or {}).items():
        by_group[g] = sum(e.device_time_total for e in prof.events()
                          if e.name in names
                          and e.device_type == torch.autograd.DeviceType.CPU
                          ) / 1e3 / n
        by_group["other"] -= by_group[g]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    # The first profiler's set-up imports torch._inductor (its
    # hasattr(torch, "_inductor") goes through torch's lazy import), and
    # that import leaves a reference cycle holding the frames then on the
    # stack: ``fn`` and the callers' locals (phase 4's engine and its
    # weights, 7.4 GB at phase 10's start). Collected here, where it is
    # made, with the profiler's own cycles of events.
    del prof, events
    gc.collect()
    return dict(
        calls_profiled=n, device_ms_per_call=device_ms,
        device_idle_share=(1.0 - device_ms / wall_ms) if device_ms else None,
        device_ms_by_group=by_group,
        top_kernels=[[k[:80], v] for k, v in top],
        complete=complete, traces_taken=attempt + 1,
    )


def capture_state(torch, eng):
    """The engine's own state for the kernel phase: layer 0's pools, the
    fleet's packed L2 words (and their word planes), chain lengths, and the
    decode batch (padded as the engine pads it)."""
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
        l2=kv.fleet.l2.clone(), w0=kv.fleet.l2[..., 0].contiguous(),
        w1=kv.fleet.l2[..., 1].contiguous(),
        chain_lengths=kv.fleet.length.clone(), tables=tables, lengths=lengths,
        tenants=tenants,
    )


# -- phase 5: every kernel against its plain version -------------------------


def timed_ms(torch, fn, n, flush, spin=SPIN_CYCLES):
    """Mean ms per call over ``n`` calls after a warm-up, each call timed
    alone with CUDA events after the L2 cache was flushed (a decode step
    finds a layer's pool slice cold: 36 layers of weights pass between).
    A spin of ``spin`` card cycles (by default about a millisecond)
    precedes each call, so the host has enqueued the whole call before the
    first event is reached and the events time the device work, not the
    host's launch latency; a call whose host side takes longer needs a
    longer spin. ``flush`` is a buffer of 64 MiB, zeroed (which leaves the
    L2 full of dirty lines the call must write back), or a function that
    flushes."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush() if callable(flush) else flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def clean_flush(torch, flush):
    """A flush that reads: the L2 is left clean, so the call's time holds
    none of the write-backs the zeroing flush adds."""
    return lambda: flush.sum(dtype=torch.int32)


def floor_ms(torch, flush):
    """``timed_ms`` of a launched kernel that does nothing (a one-element
    ``zero_()``) under the same flush and spin, and under the reading flush
    (``clean_flush``): the part of a small kernel's time that is the
    harness's floor (the ramp-up of a launch; the lines a call brings into
    an L2 full of the zeroing flush's dirty lines cost a write-back each on
    top)."""
    one = torch.empty(1, device=flush.device)
    return (timed_ms(torch, lambda: one.zero_(), 50, flush),
            timed_ms(torch, lambda: one.zero_(), 50, clean_flush(torch, flush)))


def size_sweep(torch, name, cases, flush):
    """A kernel at several sizes: each ``(bytes, kern, plain)`` held
    bit-exact against its plain version, then timed under the zeroing
    flush and the reading one (``clean_flush``). For each flush, the
    least-squares line through (bytes, ms): its slope as a rate in GB/s
    (the card's memory rate is 3,350) and its intercept, the fixed cost a
    call, so neither rests on subtracting another kernel's time."""
    points = []
    for nbytes, kern, plain in cases:
        require(all(torch.equal(a, b) for a, b in zip(kern(), plain())),
                f"{name}: differs from its plain version at {nbytes} bytes")
        points.append(dict(bytes=nbytes, ms=timed_ms(torch, kern, 50, flush),
                           ms_clean_l2=timed_ms(torch, kern, 50,
                                                clean_flush(torch, flush))))
    x = np.array([q["bytes"] for q in points], dtype=np.float64)
    fits = {}
    for key in ("ms", "ms_clean_l2"):
        slope, intercept = np.polyfit(x, [q[key] for q in points], 1)
        fits[key] = dict(rate_GBps=1 / slope / 1e6, intercept_ms=intercept)
    return dict(points=points, bit_exact=True, fit=fits)


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


def attention_cost(tables_h, len_h, bs, hkv, d, elt, n_heads):
    """What K3 needs for host ``tables_h`` (B, M) and ``len_h`` (B,):
    ``(bytes, ops, kv_bytes, qo_bytes, blocks_per_row)``. Bytes count each
    distinct K/V slot the rows attend over once, q and the output once,
    and the table entries and lengths read; ops 4·H·D a (row, position)."""
    b = len(len_h)
    nblk = np.minimum(-(-len_h // bs), tables_h.shape[1])
    slots = {(int(tables_h[r, j]), o) for r in range(b) for j in range(nblk[r])
             for o in range(bs) if j * bs + o < len_h[r]}
    kv_bytes = len(slots) * hkv * d * elt * 2
    qo_bytes = 2 * b * n_heads * d * elt
    ops = 4 * n_heads * d * int(len_h.sum())
    return (kv_bytes + qo_bytes + 4 * (int(nblk.sum()) + b), ops, kv_bytes,
            qo_bytes, nblk)


def walk_cost(w0_h, cl_h, ten_h, nblk, allocated_bit):
    """The bytes K4 reads beyond K3's K/V, q and out: the words its walks
    read (each tenant's pages up to its longest row's), a chain length a
    tenant, a tenant and a length a row."""
    pages_of = {}
    for r in range(len(nblk)):
        if nblk[r]:
            tt = int(ten_h[r])
            pages_of[tt] = np.arange(max(nblk[r], len(pages_of.get(tt, []))))
    return 4 * (walk_words(w0_h, cl_h, pages_of, allocated_bit) + len(pages_of)
                + 2 * len(nblk))


def measure(torch, name, kern, plain, nbytes, ops, tol, flush, library=None,
            n_kernel=50, n_plain=10):
    """Hold ``kern`` against ``plain`` on the same inputs (bit-exact where
    ``tol`` is None) and time both, and ``library`` where one PyTorch call
    computes the same function. Returns the kernels-line row (without the
    launch counts) and the kernel's outputs."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    if tol is None:
        require(all(a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                                       b.view(torch.uint8))
                    for a, b in zip(got, want)),
                f"{name} is not bit-exact against its plain version")
    else:
        require(err <= tol, f"{name} error {err} above {tol}")
        require(bool(torch.isfinite(got[0].float()).all()), f"{name} not finite")
    del want
    kernel_ms = timed_ms(torch, kern, n_kernel, flush)
    plain_ms = timed_ms(torch, plain, n_plain, flush)
    library_ms = None if library is None else timed_ms(torch, library,
                                                       n_plain, flush)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / BF16_FLOPS
    src, replaces = KERNEL_SOURCES[name]
    row = dict(
        name=name, route="cuda", source=src, replaces=replaces,
        max_abs_err=err, max_err=err, ms=kernel_ms, kernel_ms=kernel_ms,
        plain_ms=plain_ms, bytes=nbytes, ops=ops,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    if library_ms is not None:
        row["library_ratio"] = kernel_ms / library_ms
    return row, got


def kernel_phase(torch, mods, state):
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
    l2, w0, w1, cl = s["l2"], s["w0"], s["w1"], s["chain_lengths"]
    kv_len = s["lengths"]
    t, c, p = w0.shape
    nb, bs, hkv, d = s["pool_k"].shape
    elt = s["pool_k"].element_size()

    w0_h, cl_h = w0.cpu().numpy(), cl.cpu().numpy()
    tables_h, len_h, ten_h = (s["tables"].cpu().numpy(), kv_len.cpu().numpy(),
                              s["tenants"].cpu().numpy())

    # data-dependent byte counts: what these inputs need, each read once
    # K1 reads word0 in place at a stride of 2: word1 shares its sectors,
    # 8 bytes a walked entry (4 on the contiguous plane)
    k1_walked = walk_words(w0_h, cl_h, {i: np.arange(p) for i in range(t)},
                           alloc_bit)
    k1_bytes = 8 * k1_walked + 4 * (t + 2 * t * p)
    k1_plane_bytes = 4 * (k1_walked + t + 2 * t * p)
    k2_bytes = 4 * (2 * t * p + t + 3 * t * p)
    k3_bytes, attn_ops, kv_bytes, qo_bytes, nblk = attention_cost(
        tables_h, len_h, bs, hkv, d, elt, cfg.n_heads)
    k4_bytes = kv_bytes + qo_bytes + walk_cost(w0_h, cl_h, ten_h, nblk, alloc_bit)

    runs = {
        "resolve_vanilla_fleet": (
            lambda: cr.resolve_vanilla_fleet_cuda(l2[..., 0], cl),
            lambda: cr_ref.resolve_vanilla_fleet_ref(l2[..., 0], cl), k1_bytes, 0,
            None),
        "resolve_direct_fleet": (
            lambda: cr.resolve_direct_fleet_cuda(l2[..., 0], l2[..., 1], cl),
            lambda: cr_ref.resolve_direct_fleet_ref(l2[..., 0], l2[..., 1], cl),
            k2_bytes, 0, None),
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
        row, outs[name] = measure(torch, name, kern, plain, nbytes, ops, tol,
                                  flush)
        rows.append(row)
    require(torch.equal(outs["paged_attention"][0], outs["fused_chain_attention"][0]),
            "paged_attention and fused_chain_attention differ on the same rows")
    # K1 on the contiguous plane too, comparable with the first version's
    # row, and with each walk forced (the sweep goes on in phase 7)
    plane, _ = measure(torch, "resolve_vanilla_fleet",
                       lambda: cr.resolve_vanilla_fleet_cuda(w0, cl),
                       lambda: cr_ref.resolve_vanilla_fleet_ref(w0, cl),
                       k1_plane_bytes, 0, None, flush)
    rows[0].update(walk=cr.fleet_walk(t, p), words_walked=k1_walked,
                   plane_ms=plane["ms"], plane_bound_ms=plane["bound_ms"],
                   walk_sweep={"engine": walk_sweep(torch, mods, l2, cl, flush)})
    # K2 likewise: the packed words in place, the contiguous planes beside
    plane, _ = measure(torch, "resolve_direct_fleet",
                       lambda: cr.resolve_direct_fleet_cuda(w0, w1, cl),
                       lambda: cr_ref.resolve_direct_fleet_ref(w0, w1, cl),
                       k2_bytes, 0, None, flush)
    es = cr.direct_fleet_stride(l2[..., 0], l2[..., 1])
    rows[1].update(elem_stride=es, plane_ms=plane["ms"],
                   plane_bound_ms=plane["bound_ms"])
    split = {"paged_attention": split_report(pa, q, hkv, s["tables"].shape[1], bs,
                                             len_h),
             "fused_chain_attention": split_report(pa, q, hkv, p, bs, len_h)}
    for row in rows:
        if row["name"] in split:
            row.update(split[row["name"]])
            row["device_ms_by_pass"] = attention_passes(torch, runs[row["name"]][0],
                                                        flush)
            require(row["working_blocks"] >= pa.sm_count(dev),
                    f"{row['name']}: {row['working_blocks']} working blocks "
                    "do not cover the SMs")
    # K1's batch entry as prepare_step calls it: every page, one row of ids
    # expanded over the tenants (row stride 0)
    ids = torch.arange(p, dtype=torch.int32, device=dev)[None].expand(t, -1)
    shape = auto_batch_shape(torch, mods, l2, cl, ids, flush)
    batch_row, _ = measure(
        torch, "resolve_auto_batch",
        lambda: cr.resolve_auto_batch_cuda(l2[..., 0], l2[..., 1], cl, ids),
        lambda: cr_ref.resolve_auto_batch_ref(l2[..., 0], l2[..., 1], cl, ids),
        shape["bytes"], 0, None, flush)
    batch_row.update(walk=shape["planner_picks"], walk_sweep={"engine": shape})
    rows.append(batch_row)
    emit({"phase": "kernels", "shapes": {
        "fleet_T_C_P": [t, c, p], "pool_nb_bs_hkv_d": [nb, bs, hkv, d],
        "k1_words_walked": k1_walked, "k1_walk": rows[0]["walk"],
        "k2_elem_stride": es,
        "batch": b, "kv_lengths": len_h.tolist()},
        "k3_equals_k4_bitwise": True, "split": split})
    long = long_context(torch, mods, flush)
    for row in rows:
        if row["name"] in long:
            row["long_context"] = long[row["name"]]
        if row["name"] == "paged_attention":
            row["split_sweep"] = split_sweep(torch, mods, flush)
    return rows


ATTENTION_PASSES = {"split pass": ("paged_attention_kernel",
                                   "fused_chain_attention_kernel",
                                   "shared_table_kernel"),
                    "combine": ("attention_combine",)}


def attention_passes(torch, kern, flush, tries=3):
    """Device ms per K3/K4 call by pass (the split pass, the combine), from
    torch.profiler over 20 calls, each after an L2 flush as in timed_ms.
    A trace that holds neither pass (the profiler now and then returns no
    device events) is taken again, up to ``tries`` times; after that the
    passes are None, not zero."""
    for _ in range(tries):
        prof = profile_calls(torch, lambda: (flush.zero_(), kern()), 20, 1.0,
                             ATTENTION_PASSES)
        by_pass = {k: prof["device_ms_by_group"][k] for k in ATTENTION_PASSES}
        if all(by_pass.values()):
            return by_pass
    return {k: None for k in ATTENTION_PASSES}


def plan_report(plan, lengths, bs, n_pages):
    """What a K3/K4 plan chose (the body's layout, warps a block, pages a
    split, grid) and the blocks that did work."""
    return dict(layout="tokens" if plan.layout else "heads", warps=plan.warps,
                pages_per_split=plan.pages_per_split, grid=list(plan.grid),
                working_blocks=plan.working_blocks(lengths, bs, n_pages))


def split_report(pa, q, hkv, n_pages, bs, lengths):
    """The plan K3/K4 chose for this call, and the blocks that did work."""
    b, h, _ = q.shape
    plan = pa.plan(b, h, hkv, n_pages, bs, q.dtype, pa.sm_count(q.device))
    return plan_report(plan, lengths, bs, n_pages)


def long_context(torch, mods, flush, cfg=None, line=emit):
    """K3/K4 at a long context: 8 rows of 2,048 tokens, each through 128
    distinct blocks of the engine's 1,024-block pool at one layer (bf16,
    bs 16, ``cfg``'s heads: phase 4's model's 2 KV heads of 128 by
    default), and for K4 a 64-deep chain (65 layers of word0; each page's
    owner drawn from the 65 layers, older copies below it). Each is held
    against its plain version and timed against its bytes bound;
    scaled_dot_product_attention over the same K/V gathered dense is timed
    beside them as a yardstick (``dense_sdpa_ms``: it computes no paged
    function and the port never calls it)."""
    pa, pa_ref, fmt = mods["pa"], mods["pa_ref"], mods["fmt"]
    cfg = cfg or mods["cfg"]
    b, n_pages, bs, nb, depth, chain = 8, 128, 16, 1024, CHAIN_DEPTH + 1, 128
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=DEV).manual_seed(2)
    pool_k, pool_v = (torch.randn((nb, bs, hkv, d), generator=g, device=DEV)
                      .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, h, d), generator=g, device=DEV).to(torch.bfloat16)
    rng = np.random.default_rng(2)
    tables_h = rng.permutation(nb).reshape(b, n_pages).astype(np.int32)
    owner = rng.integers(0, depth, (b, n_pages))
    words = np.zeros((b, chain, n_pages), np.uint32)
    layer = np.arange(chain)[None, :, None]
    older = (layer < owner[:, None, :]) & (rng.random(words.shape) < 0.3)
    words[older] = fmt.FLAG_ALLOCATED | rng.integers(0, nb, int(older.sum()))
    bi, ji = np.indices((b, n_pages))
    words[bi, owner, ji] = fmt.FLAG_ALLOCATED | tables_h.astype(np.uint32)
    w0 = torch.as_tensor(words.view(np.int32), device=DEV)
    tables = torch.as_tensor(tables_h, device=DEV)
    lengths = torch.full((b,), n_pages * bs, dtype=torch.int32, device=DEV)
    chain_lengths = torch.full((b,), depth, dtype=torch.int32, device=DEV)
    tenants = torch.arange(b, dtype=torch.int32, device=DEV)
    require(torch.equal(pa_ref.fused_tables_ref(w0, chain_lengths, tenants), tables),
            "long-context chain does not resolve to its tables")

    elt = pool_k.element_size()
    kv_bytes = b * n_pages * bs * hkv * d * elt * 2
    qo_bytes = 2 * b * h * d * elt
    ops = 4 * h * d * b * n_pages * bs
    walk = walk_words(words.view(np.int32), np.full(b, depth),
                      {t: np.arange(n_pages) for t in range(b)},
                      fmt.FLAG_ALLOCATED_I32)
    runs = {
        "paged_attention": (
            lambda: pa.paged_attention_cuda(q, pool_k, pool_v, tables, lengths),
            lambda: pa_ref.paged_attention_ref(q, pool_k, pool_v, tables, lengths),
            kv_bytes + qo_bytes + 4 * (b * n_pages + b)),
        "fused_chain_attention": (
            lambda: pa.fused_chain_attention_cuda(q, pool_k, pool_v, w0,
                                                  chain_lengths, tenants, lengths),
            lambda: pa_ref.fused_chain_attention_ref(q, pool_k, pool_v, w0,
                                                     chain_lengths, tenants,
                                                     lengths),
            kv_bytes + qo_bytes + 4 * (walk + 3 * b)),
    }
    kd, vd = (x[tables.long()].reshape(b, n_pages * bs, hkv, d).transpose(1, 2)
              .contiguous() for x in (pool_k, pool_v))
    qd = q[:, :, None, :]
    def dense():
        return torch.nn.functional.scaled_dot_product_attention(qd, kd, vd,
                                                                enable_gqa=True)

    clean = clean_flush(torch, flush)
    dense_ms = timed_ms(torch, dense, 50, flush)
    out, outs = {}, {}
    for name, (kern, plain, nbytes) in runs.items():
        row, outs[name] = measure(torch, name, kern, plain, nbytes, ops,
                                  LONG_CONTEXT_TOL, flush)
        want = plain().float()
        rel = float((outs[name][0].float() - want).norm() / want.norm())
        require(rel <= LONG_CONTEXT_REL_TOL,
                f"long context: {name} relative error {rel}")
        out[name] = dict(
            batch=b, tokens_per_row=n_pages * bs, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], bytes=nbytes, max_abs_err=row["max_abs_err"],
            rel_err=rel, tol=LONG_CONTEXT_TOL, rel_tol=LONG_CONTEXT_REL_TOL,
            dense_sdpa_ms=dense_ms,
            ms_clean_l2=timed_ms(torch, kern, 50, clean),
            dense_sdpa_ms_clean_l2=timed_ms(torch, dense, 50, clean),
            device_ms_by_pass=attention_passes(torch, kern, flush),
            **split_report(pa, q, hkv, n_pages, bs, [n_pages * bs] * b))
    require(torch.equal(outs["paged_attention"][0], outs["fused_chain_attention"][0]),
            "long context: paged_attention and fused_chain_attention differ")
    line({"phase": "kernels", "shape": "long_context", "model": cfg.name,
          "heads": [h, hkv], "k3_equals_k4_bitwise": True, **out})
    return out


def split_sweep(torch, mods, flush):
    """K3 at every pages-per-split in ``SWEEP_SPLITS``, beside the one the
    planner picks from shapes, at four shapes (bf16, head dim 128, pages of
    16 tokens, M = 128, every row through pool blocks of its own):
    Qwen2.5-3B's 16 query heads over 2 KV heads at the engine's decode
    batch, at the long context and at batch 512 (rows of 1-2,048 tokens),
    and 32 query heads over 4 KV heads at batch 64. Each call is held
    against the plain version and timed as in ``measure``."""
    pa, pa_ref = mods["pa"], mods["pa_ref"]
    g = torch.Generator(device=DEV).manual_seed(3)
    rng = np.random.default_rng(3)
    d, bs, m = 128, 16, 128
    shapes = {
        "engine": (8, 16, 2, [80, 208, 336, 528, 80, 208, 336, 1]),
        "long_context": (8, 16, 2, [2048] * 8),
        "batch512": (512, 16, 2, rng.integers(1, 2049, 512).tolist()),
        "batch64_4kv": (64, 32, 4, rng.integers(1, 2049, 64).tolist()),
    }
    out = {}
    for shape, (b, h, hkv, lens) in shapes.items():
        nb = b * m
        pool_k, pool_v = (torch.randn((nb, bs, hkv, d), generator=g, device=DEV)
                          .to(torch.bfloat16) for _ in range(2))
        q = torch.randn((b, h, d), generator=g, device=DEV).to(torch.bfloat16)
        tables = (torch.randperm(nb, generator=g, device=DEV).reshape(b, m)
                  .to(torch.int32))
        lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
        want = pa_ref.paged_attention_ref(q, pool_k, pool_v, tables, lengths).float()
        res = dict(batch=b, heads=h, kv_heads=hkv, pages=int(
            sum(-(-n // bs) for n in lens)), planner_picks=pa.plan(
                b, h, hkv, m, bs, q.dtype, pa.sm_count(q.device)).pages_per_split,
            max_abs_err=0.0, ms={})
        for pps in SWEEP_SPLITS:
            def call():
                return pa.paged_attention_cuda(q, pool_k, pool_v, tables, lengths,
                                               pages_per_split=pps)
            err = float((call().float() - want).abs().max())
            require(err <= 2e-2, f"split sweep {shape}, {pps} pages a split: "
                    f"error {err}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"][pps] = timed_ms(torch, call, 30, flush)
        out[shape] = res
        del pool_k, pool_v, want
    emit({"phase": "kernels", "split_sweep": out})
    return out


def walk_sweep(torch, mods, l2, lengths, flush, n=30):
    """K1 on the strided ``l2[..., 0]`` of (T, C, P, 2) words with each walk
    forced (a thread a page with U loads in flight, a warp a page with 32
    layers a load), beside the planner's pick, each call held bit-exact
    against the plain version; the bound counts 8 bytes a walked entry."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    t, c, p, _ = l2.shape
    w0 = l2[..., 0]
    want = cr_ref.resolve_vanilla_fleet_ref(w0, lengths)
    top = lengths.clamp(max=c).to(torch.int64)[:, None]
    walked = int(torch.where(want[0] >= 0, top - want[0], top).sum())
    res = dict(T_C_P=[t, c, p], pages=t * p, planner_picks=cr.fleet_walk(t, p),
               words_walked=walked,
               bound_ms=1e3 * (8 * walked + 4 * t + 8 * t * p) / HBM_BYTES_PER_S,
               ms={})
    for walk in cr.WALKS:
        def call():
            return cr.resolve_vanilla_fleet_cuda(w0, lengths, walk=walk)
        require(all(torch.equal(a, b) for a, b in zip(call(), want)),
                f"K1 {walk} walk at {[t, c, p]} is not bit-exact")
        res["ms"][walk] = timed_ms(torch, call, n, flush)
    return res


def auto_batch_bytes(torch, mods, l2, lengths, ids, want):
    """What K1's batch entry needs for (T, B) ``ids`` on the (T, C, P, 2)
    words ``l2``, whose plain answer is ``want``: each distinct (tenant,
    page) read's active entry (8 bytes) and, where that entry is not
    trusted, the rest of its walk (8 bytes a further entry), the ids as
    stored, a length a tenant, and 15 bytes of leaves a read. Returns
    ``(bytes, distinct reads, trusted reads, words the walks read)``."""
    fmt = mods["fmt"]
    t, c, p, _ = l2.shape
    b = ids.shape[1]
    tt = torch.arange(t, device=ids.device)[:, None].expand(t, b)
    act = (lengths.to(torch.int64) - 1)[:, None].expand(t, b)
    act = torch.where(act < 0, act + c, act).clamp(0, c - 1)
    entry = l2[tt, act, ids.to(torch.int64)]                    # (T, B, 2)
    trusted = (((entry[..., 0] & fmt.FLAG_ALLOCATED_I32) != 0)
               & ((entry[..., 1] & fmt.FLAG_BFI_VALID) != 0))
    top = lengths.clamp(max=c).to(torch.int64)[:, None].expand(t, b)
    walked = torch.where(trusted, 0, torch.where(want[2], top - want[0].to(torch.int64),
                                                 top))
    key = tt * p + ids.to(torch.int64)
    uniq, inv = torch.unique(key.reshape(-1), return_inverse=True)
    per = torch.zeros(len(uniq), dtype=torch.int64, device=ids.device)
    per.scatter_(0, inv, (walked - 1).clamp(min=0).reshape(-1))
    n_ids = b if ids.stride(0) == 0 else t * b
    nbytes = 8 * (len(uniq) + int(per.sum())) + 4 * (n_ids + t) + 15 * t * b
    return nbytes, len(uniq), int(trusted.sum()), int(walked.sum())


def auto_batch_shape(torch, mods, l2, lengths, ids, flush, n=30):
    """K1's batch entry (``resolve_auto_batch_cuda``) at (T, B) ``ids`` on
    the packed words' ``l2[..., 0]``/``l2[..., 1]`` pair, with each walk
    forced and with the planner's pick, every leaf of every call held bit
    for bit against its plain version, each timed; the bound counts
    ``auto_batch_bytes``."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    t, c, p, _ = l2.shape
    w0, w1 = l2[..., 0], l2[..., 1]
    want = cr_ref.resolve_auto_batch_ref(w0, w1, lengths, ids)
    nbytes, distinct, trusted, walked = auto_batch_bytes(torch, mods, l2, lengths,
                                                         ids, want)
    res = dict(T_C_P=[t, c, p], B=ids.shape[1], reads=ids.numel(),
               distinct_reads=distinct, trusted_reads=trusted, words_walked=walked,
               planner_picks=cr.fleet_walk(t, ids.shape[1]), bytes=nbytes,
               bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, ms={})
    for walk in (*cr.WALKS, None):
        def call():
            return cr.resolve_auto_batch_cuda(w0, w1, lengths, ids, walk=walk)
        got = call()
        require(all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want)),
                f"K1's batch entry, {walk or 'planner'} walk, at "
                f"{[t, c, p, ids.shape[1]]} is not bit-exact")
        res["ms"][walk or "planner"] = timed_ms(torch, call, n, flush)
    del want
    res["plain_ms"] = timed_ms(torch, lambda: cr_ref.resolve_auto_batch_ref(
        w0, w1, lengths, ids), 3, flush)
    return res


# -- phase 6: one virtual disk, dd and YCSB-C --------------------------------


def _bits(torch, x):
    """The raw bits of a float tensor, for bit-exact comparison."""
    return x.view(torch.int32) if x.element_size() == 4 else x.view(torch.int16)


def _same(torch, a, b, rows=16_384) -> bool:
    """Bit-exact equality, compared ``rows`` leading rows at a time so a
    full-disk comparison needs no disk-sized temporary."""
    return a.shape == b.shape and all(
        torch.equal(_bits(torch, a[i:i + rows]), _bits(torch, b[i:i + rows]))
        for i in range(0, a.shape[0], rows))


def _host_ms(torch, fn, n):
    """Mean host-clock ms of ``n`` calls, each ending in a synchronize;
    the result is dropped before the next call."""
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
        del out
    return 1e3 * total / n


def _grow_disks(torch, store, chains, g, to_depth):
    """Snapshot and write ``LAYER_WRITES`` random clusters into every image
    until each is ``to_depth`` long; the same clusters and data for all."""
    while store.chain_length(chains[0]) < to_depth:
        ids = torch.randperm(DISK_PAGES, generator=g, device=DEV)[:LAYER_WRITES]
        data = torch.randn((LAYER_WRITES, CLUSTER), generator=g, device=DEV)
        for c in chains:
            store.snapshot(c)
            store.write(c, ids, data)


def store_phase(torch, mods):
    store, fmt, _build = mods["store"], mods["fmt"], mods["_build"]
    cr, cg = mods["cr_ops"], mods["cg_ops"]
    g = torch.Generator(device=DEV).manual_seed(6)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    van, sca = chains = [store.create(DISK_PAGES, CLUSTER, max_chain=DISK_CHAIN,
                                      pool_capacity=DISK_POOL, scalable=s,
                                      device=DEV)
                         for s in (False, True)]
    base = torch.randperm(DISK_PAGES, generator=g, device=DEV)[:BASE_FILL]
    for lo in range(0, BASE_FILL, 8_192):
        ids = base[lo:lo + 8_192]
        data = torch.randn((ids.numel(), CLUSTER), generator=g, device=DEV)
        for c in chains:
            store.write(c, ids, data)
    del data
    ycsb = torch.randint(0, DISK_PAGES, (YCSB_BATCH,), generator=g,
                         device=DEV, dtype=torch.int32)
    emit({"phase": "store", "disk_GiB": DISK_PAGES * CLUSTER * 4 / 2**30,
          "n_pages": DISK_PAGES, "page_bytes": CLUSTER * 4,
          "max_chain": DISK_CHAIN, "pool_rows": DISK_POOL,
          "base_fill": BASE_FILL, "layer_writes": LAYER_WRITES,
          "base_seconds": time.perf_counter() - t0})
    total, measured = {}, None
    for depth in DISK_DEPTHS:
        t0 = time.perf_counter()
        _grow_disks(torch, store, chains, g, depth)
        for c in chains:
            store.check_pool_capacity(c)
            require(store.chain_length(c) == depth, f"chain length {depth}")
        grow_s = time.perf_counter() - t0
        _build.reset_launches()
        runs = [(van, m) for m in ("vanilla", "auto", "pallas_vanilla")] + [
            (sca, m) for m in ("vanilla", "direct", "auto", "pallas_vanilla",
                               "pallas_direct")]
        # dd: every full read of the one content is bit-identical
        ref = store.materialize(sca, method="direct")
        dd = {}
        for c, m in runs:
            key = f"{'scalable' if c.scalable else 'vanilla'}/{m}"
            out = store.materialize(c, method=m)
            require(_same(torch, out, ref), f"dd depth {depth} {key} differs")
            del out
            ms = _host_ms(torch, lambda: store.materialize(c, method=m), DD_TIMED)
            dd[key] = dict(ms=ms, GBps=DISK_PAGES * CLUSTER * 4 / ms / 1e6)
            if depth == max(DISK_DEPTHS) and key in PROFILED_DD:
                dd[key]["profile"] = profile_calls(
                    torch, lambda: store.materialize(c, method=m), 2, ms,
                    READ_GROUPS, tries=3, counts=_build)
        del ref
        # YCSB-C: one batch of uniform random clusters, every method
        yref, _ = store.read(sca, ycsb, method="direct")
        yc = {}
        for c, m in runs:
            key = f"{'scalable' if c.scalable else 'vanilla'}/{m}"
            data, res = store.read(c, ycsb, method=m)
            require(_same(torch, data, yref), f"YCSB depth {depth} {key} differs")
            ms = _host_ms(torch, lambda: store.read(c, ycsb, method=m), YCSB_TIMED)
            yc[key] = dict(ms=ms, kops=YCSB_BATCH / ms,
                           mean_lookups=float(res.lookups.float().mean()))
        walk = yc["vanilla/vanilla"]["mean_lookups"]
        require(yc["scalable/direct"]["mean_lookups"] == 1.0,
                "direct must cost exactly one lookup")
        if depth == max(DISK_DEPTHS):
            require(walk >= 0.9 * depth, f"vanilla walk {walk} lookups at {depth}")
        # K6/K7/K8 on the disk's own planes, against store.read
        planes = single_chain_planes(torch, fmt, van, sca)
        _, yres = store.read(van, ycsb, method="vanilla")
        safe_rows, ok = mods["readable_rows"](yres)
        before = dict(_build.LAUNCHES)
        k6 = cr.resolve_vanilla(planes["alloc"], planes["ptrs"], van.length)
        k7 = cr.resolve_direct(planes["alloc_active"], planes["bfi_active"],
                               planes["ptrs_active"])
        k8 = cg.gather(van.pool, safe_rows, ok)
        launches = dict(_build.LAUNCHES)        # read just after the run
        per_call = {k: launches[k] - before[k]
                    for k in ("resolve_vanilla", "resolve_direct", "gather")}
        require(_same(torch, k8, yref), "K8 gather differs from store.read")
        step = min(32_768, DISK_PAGES)
        for (c, m, got) in ((van, "vanilla", k6), (sca, "direct", k7)):
            for lo in range(0, DISK_PAGES, step):
                ids = torch.arange(lo, lo + step, dtype=torch.int32, device=DEV)
                _, r = store.read(c, ids, method=m)
                require(torch.equal(got[0][lo:lo + step], r.owner)
                        and torch.equal(got[1][lo:lo + step], r.ptr),
                        f"{m} kernel resolve differs from store.read")
        for k in ("resolve_vanilla", "resolve_direct", "gather"):
            require(launches[k] > 0, f"store: kernel {k} never launched")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        emit({"phase": "store", "depth": depth, "grow_seconds": grow_s,
              "dd": dd, "ycsb": yc, "dd_equal_across_methods_and_formats": True,
              "k6_k7_k8_equal_store_read": True, "launches": launches,
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
        if depth == max(DISK_DEPTHS):
            measured = store_kernels(torch, mods, planes, van, safe_rows, ok,
                                     k6, flush)
        del planes, k6, k7, k8, yref
        torch.cuda.empty_cache()
    # phase 10's cache model reads the depth-500 disks' index tables (their
    # pools go): kept on the host until then, with the YCSB-C batch
    indexes = dict(ycsb=ycsb.cpu(), disks={
        "scalable" if c.scalable else "vanilla": dict(
            spec=c.spec, scalable=c.scalable, l1=c.l1.cpu(), l2=c.l2.cpu(),
            length=store.chain_length(c)) for c in chains})
    del chains, van, sca
    torch.cuda.empty_cache()
    return measured, total, per_call, indexes


def single_chain_planes(torch, fmt, van, sca):
    """The planes K6/K7 take: the vanilla image's allocation map and
    pointers (C, N), and the scalable image's active layer."""
    act = sca.l2[int(sca.length) - 1]
    return dict(
        alloc=fmt.entry_allocated(van.l2).to(torch.int32),
        ptrs=fmt.entry_ptr(van.l2).contiguous(),
        alloc_active=fmt.entry_allocated(act).to(torch.int32),
        bfi_active=fmt.entry_bfi(act).contiguous(),
        ptrs_active=fmt.entry_ptr(act).contiguous(),
    )


def store_kernels(torch, mods, planes, van, safe_rows, ok, k6, flush):
    """K6, K7 and K8 at the store phase's shapes against their plain
    versions, timed, with their bounds from this run's data."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    cg, cg_ref = mods["cg"], mods["cg_ref"]
    c, n = planes["alloc"].shape
    length = van.length
    owner = k6[0]
    hits = int((owner >= 0).sum())
    walk = k6_walk(torch, cr, planes["alloc"], owner, length)
    walked = walk["words_walked"]
    page = van.pool.shape[1] * van.pool.element_size()
    found = int(ok.sum())
    b = safe_rows.numel()
    rows = []
    for name, kern, plain, nbytes, library in (
        ("resolve_vanilla",
         lambda: cr.resolve_vanilla_cuda(planes["alloc"], planes["ptrs"], length),
         lambda: cr_ref.resolve_vanilla_ref(planes["alloc"], planes["ptrs"], length),
         4 * (walked + hits + 1) + 8 * n, None),
        ("resolve_direct",
         lambda: cr.resolve_direct_cuda(planes["alloc_active"],
                                        planes["bfi_active"], planes["ptrs_active"]),
         lambda: cr_ref.resolve_direct_ref(planes["alloc_active"],
                                           planes["bfi_active"], planes["ptrs_active"]),
         12 * n + 8 * n, None),
        ("gather",
         lambda: cg.gather_cuda(van.pool, safe_rows, ok),
         lambda: cg_ref.gather_ref(van.pool, safe_rows, ok),
         (found + b) * page + 5 * b,
         lambda: torch.index_select(van.pool, 0, safe_rows)),
    ):
        row, _ = measure(torch, name, kern, plain, nbytes, 0, None, flush,
                         library=library)
        rows.append(row)
    rows[0].update(walk)
    rows[1]["size_sweep"] = k7_size_sweep(torch, mods, flush)
    rows[2]["variant"] = cg.gather_variant(page).name
    emit({"phase": "store", "kernel_shapes": {
        "resolve_vanilla_C_N": [c, n], "length": int(length),
        "words_walked": walked, "hits": hits, "gather_pages": b,
        "gather_found": found}})
    return rows


def k6_walk(torch, cr, alloc, owner, length):
    """What K6's walk reads on this data: ``words_walked``, per page the
    layers from the top down to its owner (the whole live chain on a
    miss), and ``group_words_walked``, V times the deepest walk of each
    group of V pages a thread (a thread walks until its deepest page is
    found), beside its ``pages_a_thread`` and ``layers_a_batch``."""
    v, u = cr.vanilla_config(alloc)
    top = min(int(length), alloc.shape[0]) - 1
    depth = torch.where(owner >= 0, top - owner + 1, top + 1).to(torch.int64)
    return dict(words_walked=int(depth.sum()),
                group_words_walked=v * int(depth.view(-1, v).amax(1).sum()),
                pages_a_thread=v, layers_a_batch=u)


def k7_size_sweep(torch, mods, flush):
    """K7 at N = 2^18 (the disk's) to 2^24 pages of random int32 planes,
    20 bytes a page (three 4-byte planes in, two out)."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    g = torch.Generator(device=DEV).manual_seed(16)
    cases = []
    for n in (1 << 18, 1 << 20, 1 << 22, 1 << 24):
        planes = tuple(torch.randint(0, hi, (n,), generator=g, device=DEV,
                                     dtype=torch.int32)
                       for hi in (2, 1 << 16, 1 << 28))
        cases.append((20 * n, lambda x=planes: cr.resolve_direct_cuda(*x),
                      lambda x=planes: cr_ref.resolve_direct_ref(*x)))
    return size_sweep(torch, "resolve_direct", cases, flush)


# -- phase 7: a fleet of disks, fleet.read and the host cold tier ------------


def build_fleet(torch, fleet_lib, scalable, seed, extra_rows=0):
    """The phase-7 fleet: each tenant's base at 12.5 % fill, then tenant t
    snapshots and writes 4 clusters a layer up to its target length.
    ``extra_rows`` per tenant widens the pool for later writes."""
    target = 1 + (FLEET_MAX_DEPTH - 1) * torch.arange(FLEET_T) // (FLEET_T - 1)
    rows = (FLEET_BASE + FLEET_LAYER_WRITES * (target - 1) + extra_rows
            + FLEET_Q - 1) // FLEET_Q
    # every tenant's own rows rounded up to whole quanta, plus slack for
    # the promotion's fresh quanta
    spec = fleet_lib.FleetSpec(
        n_tenants=FLEET_T, n_pages=FLEET_PAGES, page_size=CLUSTER,
        max_chain=FLEET_CHAIN, pool_capacity=(int(rows.sum()) + FLEET_T) * FLEET_Q,
        lease_quantum=FLEET_Q)
    fl = fleet_lib.create(spec, scalable=scalable, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed)

    def fresh_ids(k):
        perm = torch.argsort(torch.rand((FLEET_T, FLEET_PAGES), generator=g,
                                        device=DEV), dim=1)
        return perm[:, :k]

    base = fresh_ids(FLEET_BASE)
    for lo in range(0, FLEET_BASE, 256):
        chunk = base[:, lo:lo + 256]
        data = torch.randn((FLEET_T, chunk.shape[1], CLUSTER), generator=g,
                           device=DEV)
        fleet_lib.write(fl, chunk, data)
    del data
    target = target.to(DEV)
    for layer in range(1, FLEET_MAX_DEPTH):
        mask = target > layer
        fleet_lib.snapshot(fl, mask)
        data = torch.randn((FLEET_T, FLEET_LAYER_WRITES, CLUSTER), generator=g,
                           device=DEV)
        fleet_lib.write(fl, fresh_ids(FLEET_LAYER_WRITES), data, mask)
    fleet_lib.check_pool_capacity(fl)
    require(torch.equal(fl.length.cpu(), target.cpu().to(torch.int32)),
            "fleet chain lengths")
    return fl


def fleet_phase(torch, mods):
    fleet_lib, _build = mods["fleet"], mods["_build"]
    TieredStore = mods["TieredStore"]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(7)
    ids = torch.randint(0, FLEET_PAGES, (FLEET_T, FLEET_BATCH), generator=g,
                        device=DEV, dtype=torch.int32)
    out_bytes = FLEET_T * FLEET_BATCH * CLUSTER * 4
    odd = list(range(1, FLEET_T, 2))
    total, measured, shapes, golden, batch_shapes = {}, None, None, None, {}
    for scalable in (False, True):
        name = "scalable" if scalable else "vanilla"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fl = build_fleet(torch, fleet_lib, scalable, seed=8)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _build.reset_launches()
        pre, res = fleet_lib.read(fl, ids, method="auto")
        per_read = dict(_build.LAUNCHES)        # one read's launches
        plain, _ = fleet_lib.read(fl, ids, method="vanilla")
        require(_same(torch, pre, plain), f"{name}: fleet read auto != vanilla")
        del plain
        van_ms = _host_ms(torch, lambda: fleet_lib.read(fl, ids, method="vanilla"), 3)
        # measurements beside the phase's own reads: the pallas_vanilla read
        # checked, timed by CUDA events and split
        with uncounted(_build):
            walk_read, _ = fleet_lib.read(fl, ids, method="pallas_vanilla")
            require(_same(torch, walk_read, pre),
                    f"{name}: pallas_vanilla read differs")
            del walk_read
            pv_ms = _host_ms(torch, lambda: fleet_lib.read(
                fl, ids, method="pallas_vanilla"), 3)
            pv_by_spin = spin_sweep(torch, lambda: fleet_lib.read(
                fl, ids, method="pallas_vanilla"), pv_ms, flush)
            pv_profile = profile_calls(
                torch, lambda: fleet_lib.read(fl, ids, method="pallas_vanilla"),
                2, pv_ms, READ_GROUPS, tries=3, counts=_build)
        store = TieredStore(CLUSTER, torch.float32, initial_rows=2 * DEMOTE_ROWS)
        demote = []
        for _ in range(DEMOTE_CALLS):
            t0 = time.perf_counter()
            fl, rep = fleet_lib.demote_tenants(fl, store, odd, max_rows=DEMOTE_ROWS,
                                               verify=True)
            torch.cuda.synchronize()
            demote.append(dict(ms=1e3 * (time.perf_counter() - t0),
                               rows=rep["rows_demoted"], tenants=len(rep["tenants"])))
        require(all(d["rows"] == DEMOTE_ROWS for d in demote), "demoted rows")
        # (phase 10d) the tier-residency counters equal the phase's own
        residency = mods["metrics"].tier_residency(fl, store)
        st = fleet_lib.fleet_stats(fl)
        demoted = sum(d["rows"] for d in demote)
        require(residency == mods["metrics"].TierResidency(
            device_rows=st["rows_allocated"], host_rows=demoted,
            cold_tenants=st["cold_tenants"], demoted_rows=demoted,
            promoted_rows=0) and st["rows_cold"] == demoted,
            f"{name}: tier_residency differs from the phase's counters")
        dev_read, dres = fleet_lib.read(fl, ids, method="auto")
        cold = dres.cold & dres.found & ~dres.zero
        require(bool(cold.any()), f"{name}: nothing read cold after demotion")
        require(not bool(_bits(torch, dev_read)[cold].any()),
                f"{name}: device read not zero where cold")
        require(torch.equal(_bits(torch, dev_read)[~cold], _bits(torch, pre)[~cold]),
                f"{name}: device read differs where hot")
        del dev_read
        tiered, _ = fleet_lib.read_tiered(fl, store, ids, method="auto")
        require(_same(torch, tiered, pre), f"{name}: read_tiered differs")
        del tiered
        t0 = time.perf_counter()
        fl, prep = fleet_lib.promote_tenants(fl, store, odd, verify=True)
        torch.cuda.synchronize()
        promote = dict(ms=1e3 * (time.perf_counter() - t0),
                       rows=prep["rows_promoted"])
        require(prep["rows_promoted"] == DEMOTE_CALLS * DEMOTE_ROWS, "promoted rows")
        require(store.host_rows_in_use() == 0, "host rows left after promotion")
        after, _ = fleet_lib.read(fl, ids, method="auto")
        require(_same(torch, after, pre), f"{name}: read after promotion differs")
        del after
        fl, rep = fleet_lib.demote_tenants(fl, store, odd, max_rows=DEMOTE_ROWS)
        held = store.host_rows_in_use()
        fleet_lib.free_tenant(fl, rep["tenants"], store=store)
        require(held == DEMOTE_ROWS and store.host_rows_in_use() == 0,
                f"{name}: free_tenant left host rows")
        launches = dict(_build.LAUNCHES)        # read just after the run
        for k in ("resolve_vanilla_fleet", "gather_fleet"):
            require(launches[k] > 0, f"fleet {name}: kernel {k} never launched")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        emit({"phase": "fleet", "format": name, "tenants": FLEET_T,
              "n_pages": FLEET_PAGES, "pool_rows": fl.spec.pool_capacity,
              "chain_lengths": [1, FLEET_MAX_DEPTH], "build_seconds": build_s,
              "read_pages_per_tenant": FLEET_BATCH, "read_GB": out_bytes / 1e9,
              "read_vanilla_ms": van_ms,
              "read_vanilla_GBps": out_bytes / van_ms / 1e6,
              "read_pallas_vanilla_ms": pv_ms,
              "read_pallas_vanilla_device_ms": pv_by_spin["2x_host"],
              "read_pallas_vanilla_device_ms_by_spin": pv_by_spin,
              "read_pallas_vanilla_profile": pv_profile,
              "auto_equals_vanilla": True, "demote": demote, "promote": promote,
              "tier_residency_after_demotion": dataclasses.asdict(residency),
              "device_read_zero_where_cold": True, "tiered_equals_before": True,
              "promoted_equals_before": True, "host_rows_after_free": 0,
              "launches": launches, "stats": fleet_lib.fleet_stats(fl),
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
        batch_shapes[name] = auto_batch_shape(torch, mods, fl.l2, fl.length, ids,
                                              flush, n=10)
        emit({"phase": "fleet", "format": name,
              "auto_batch_fleet_shape": batch_shapes[name]})
        if not scalable:
            measured = fleet_kernel(torch, mods, fl.pool, res, flush)
            shapes = dict(fleet_walk(torch, mods, fl, flush),
                          k2_fleet_shape=k2_fleet_shape(torch, mods, fl, flush),
                          auto_batch_fleet_shape=batch_shapes)
        del pre, res
        if not scalable:
            golden = golden_fleet(torch, mods, fl, store)   # phase 9b and 9d
        del fl, store
        torch.cuda.empty_cache()
    return measured, total, per_read, shapes, golden


def spin_sweep(torch, fn, host_ms, flush):
    """``timed_ms`` of a call whose host side is long (a fleet read) after
    a spin of 1 ms, of twice and of four times its host-clock ms."""
    return {key: timed_ms(torch, fn, 5, flush, spin=int(SPIN_CYCLES * k))
            for key, k in (("1ms", 1.0), ("2x_host", 2 * host_ms),
                           ("4x_host", 4 * host_ms))}


def fleet_kernel(torch, mods, pool, res, flush):
    """K5 at the fleet read's shapes against its plain version, timed."""
    cg, cg_ref = mods["cg"], mods["cg_ref"]
    safe_rows, ok = mods["readable_rows"](res)
    page = pool.shape[1] * pool.element_size()
    tb = safe_rows.numel()
    row, _ = measure(
        torch, "gather_fleet", lambda: cg.gather_fleet_cuda(pool, safe_rows, ok),
        lambda: cg_ref.gather_fleet_ref(pool, safe_rows, ok),
        (int(ok.sum()) + tb) * page + 5 * tb, 0, None, flush,
        library=lambda: torch.index_select(pool, 0, safe_rows.view(-1)),
        n_kernel=10, n_plain=3)
    row["variant"] = cg.gather_variant(page).name
    return [row]


def fleet_walk(torch, mods, fl, flush):
    """K1 at the fleet read's shape on the strided ``l2[..., 0]`` against
    its plain version, timed, beside K1 on the contiguous plane and the
    plane copy it no longer pays; then the walk sweep at this fleet's T and
    C over P = 16 ... 16,384 (the first P pages of every tenant)."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    l2, lengths = fl.l2, fl.length
    t, c, p, _ = l2.shape
    w0 = l2[..., 0]
    want = cr_ref.resolve_vanilla_fleet_ref(w0, lengths)
    top = lengths.clamp(max=c).to(torch.int64)[:, None]
    walked = int(torch.where(want[0] >= 0, top - want[0], top).sum())
    del want
    row, _ = measure(torch, "resolve_vanilla_fleet",
                     lambda: cr.resolve_vanilla_fleet_cuda(w0, lengths),
                     lambda: cr_ref.resolve_vanilla_fleet_ref(w0, lengths),
                     8 * walked + 4 * t + 8 * t * p, 0, None, flush,
                     n_kernel=10, n_plain=3)
    plane = w0.contiguous()
    plane_ms = timed_ms(torch, lambda: cr.resolve_vanilla_fleet_cuda(plane, lengths),
                        10, flush)
    del plane
    copy_ms = timed_ms(torch, lambda: w0.contiguous(), 5, flush)
    out = dict(T_C_P=[t, c, p], walk=cr.fleet_walk(t, p), words_walked=walked,
               ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
               max_abs_err=row["max_abs_err"], plane_ms=plane_ms,
               plane_bound_ms=1e3 * (4 * walked + 4 * t + 8 * t * p)
               / HBM_BYTES_PER_S, plane_copy_ms=copy_ms)
    sweep = {}
    for pp in FLEET_SWEEP_PAGES:
        sub = l2 if pp == p else l2[:, :, :pp].contiguous()
        sweep[f"fleet_P{pp}"] = walk_sweep(torch, mods, sub, lengths, flush,
                                           n=10 if pp == p else 30)
        del sub
    emit({"phase": "fleet", "k1_fleet_shape": out, "k1_walk_sweep": sweep})
    return dict(fleet_shape=out, walk_sweep=sweep)


def k2_fleet_shape(torch, mods, fl, flush):
    """K2 at the fleet read's shape on the ``l2[..., 0]``/``l2[..., 1]``
    pair against its plain version, timed, beside K2 on the contiguous
    planes and the two plane copies it no longer pays."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    l2, lengths = fl.l2, fl.length
    t, c, p, _ = l2.shape
    w0, w1 = l2[..., 0], l2[..., 1]
    nbytes = 20 * t * p + 4 * t         # the active entry, 12 out, a length
    row, _ = measure(torch, "resolve_direct_fleet",
                     lambda: cr.resolve_direct_fleet_cuda(w0, w1, lengths),
                     lambda: cr_ref.resolve_direct_fleet_ref(w0, w1, lengths),
                     nbytes, 0, None, flush, n_plain=3)
    es = cr.direct_fleet_stride(w0, w1)
    planes = (w0.contiguous(), w1.contiguous())
    plane_ms = timed_ms(torch, lambda: cr.resolve_direct_fleet_cuda(
        *planes, lengths), 50, flush)
    del planes
    copy_ms = timed_ms(torch, lambda: (w0.contiguous(), w1.contiguous()), 5,
                       flush)
    clean_ms = timed_ms(torch, lambda: cr.resolve_direct_fleet_cuda(
        w0, w1, lengths), 50, clean_flush(torch, flush))
    out = dict(T_C_P=[t, c, p], elem_stride=es,
               ms=row["ms"], ms_clean_l2=clean_ms,
               plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
               max_abs_err=row["max_abs_err"], plane_ms=plane_ms,
               plane_bound_ms=row["bound_ms"], plane_copy_ms=copy_ms,
               size_sweep=k2_size_sweep(torch, mods, p, flush))
    emit({"phase": "fleet", "k2_fleet_shape": out})
    return out


def k2_size_sweep(torch, mods, p, flush):
    """K2 on the packed words of 16 to 1,024 tenants of the fleet's P
    pages, C = 4 (it reads one layer; C only places it), random words,
    lengths 0..C: 20 bytes a page and 4 a tenant."""
    cr, cr_ref = mods["cr"], mods["cr_ref"]
    g = torch.Generator(device=DEV).manual_seed(16)
    c = 4
    cases = []
    for t in (16, 64, 256, 1024):
        l2 = torch.randint(-2**31, 2**31 - 1, (t, c, p, 2), generator=g,
                           device=DEV, dtype=torch.int32)
        lens = torch.randint(0, c + 1, (t,), generator=g, device=DEV,
                             dtype=torch.int32)
        cases.append((20 * t * p + 4 * t,
                      lambda x=l2, n=lens: cr.resolve_direct_fleet_cuda(
                          x[..., 0], x[..., 1], n),
                      lambda x=l2, n=lens: cr_ref.resolve_direct_fleet_ref(
                          x[..., 0], x[..., 1], n)))
    return size_sweep(torch, "resolve_direct_fleet", cases, flush)


# -- phase 8: the maintenance plane -------------------------------------------


def _timed(torch, fn):
    """``(result, host ms)`` of one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _ms(torch, fn) -> float:
    """Host ms of one call; its result (often a chain or a fleet the op
    updated in place) is dropped, so no stray reference keeps it alive."""
    return _timed(torch, fn)[1]


def _require_disk_reads(torch, store, chain, ref, methods, what):
    """Every method's read of the whole disk, a page chunk at a time,
    bit-identical to ``ref``."""
    n = chain.spec.n_pages
    for m in methods:
        for lo in range(0, n, COMPARE_PAGES):
            ids = torch.arange(lo, min(lo + COMPARE_PAGES, n), dtype=torch.int32,
                               device=DEV)
            data, _ = store.read(chain, ids, method=m)
            require(_same(torch, data, ref[lo:lo + COMPARE_PAGES]),
                    f"{what}: {m} read differs from the read before streaming")
            del data


def _mean_walk(store, chain, ids) -> float:
    _, res = store.read(chain, ids, method="vanilla")
    return float(res.lookups.float().mean())


def disk_maintenance(torch, mods):
    """8a: stream, compact and convert one 16 GiB disk at depth 500."""
    store, chain_lib, fmt, _build = (mods["store"], mods["chain"], mods["fmt"],
                                     mods["_build"])
    sm, sm_ref = mods["sm"], mods["sm_ref"]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    total, measured, out = {}, None, {}
    k = MAINT_DEPTH - 1                       # layers [0, 498] merge
    for scalable in (False, True):
        name = "scalable" if scalable else "vanilla"
        methods = (("vanilla", "direct", "auto", "pallas_vanilla", "pallas_direct")
                   if scalable else ("vanilla", "auto", "pallas_vanilla"))
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device=DEV).manual_seed(9)
        t0 = time.perf_counter()
        chain = store.create(DISK_PAGES, CLUSTER, max_chain=DISK_CHAIN,
                             pool_capacity=MAINT_DISK_POOL, scalable=scalable,
                             device=DEV)
        base = torch.randperm(DISK_PAGES, generator=g, device=DEV)[:BASE_FILL]
        for lo in range(0, BASE_FILL, 8_192):
            ids = base[lo:lo + 8_192]
            store.write(chain, ids, torch.randn((ids.numel(), CLUSTER),
                                                generator=g, device=DEV))
        _grow_disks(torch, store, [chain], g, MAINT_DEPTH)
        store.check_pool_capacity(chain)
        require(store.chain_length(chain) == MAINT_DEPTH, "disk depth")
        ycsb = torch.randint(0, DISK_PAGES, (YCSB_BATCH,), generator=g,
                             device=DEV, dtype=torch.int32)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ref = store.materialize(chain, method="vanilla")
        walk_before = _mean_walk(store, chain, ycsb)

        # the merge plan apart: the whole plan (one launch of K9's word
        # entry), the plane copies the plan made before it read the words in
        # place, and K9's two entries on this disk's own words and planes
        # against their plain versions (not the main path: launch counts
        # are zeroed after)
        sub = chain.l2[:k]
        merged, plan_found = chain_lib.plan_merge(chain.l2, k - 1)   # warm-up
        planes_ms = _host_ms(torch, lambda: (fmt.entry_allocated(sub),
                                             fmt.entry_ptr(sub)), 3)
        plan_ms = _host_ms(torch, lambda: chain_lib.plan_merge(chain.l2, k - 1), 5)
        plan_device_ms = timed_ms(
            torch, lambda: chain_lib.plan_merge(chain.l2, k - 1), 20, flush)
        alloc, ptrs = fmt.entry_allocated(sub), fmt.entry_ptr(sub)
        # the composition plan_merge replaced: planes, merge_ref, the gather
        # at max(src, 0)
        c_found, _, c_src = sm_ref.merge_ref(alloc, ptrs)
        pick = c_src.clamp(min=0).to(torch.int64)[None, :, None].expand(1, -1, 2)
        require(torch.equal(merged, torch.gather(sub, 0, pick)[0])
                and torch.equal(plan_found, c_found),
                "plan_merge differs from the planes-then-merge_ref composition")
        del pick
        found, ptr, src = sm.merge_cuda(alloc, ptrs)
        require(torch.equal(found, plan_found) and torch.equal(src, c_src),
                "K9 planes entry differs from plan_merge")
        require(torch.equal(ptr[found], fmt.entry_ptr(merged)[found]),
                "K9 ptr differs from the merged entries' ptr")
        if not scalable:
            hits = int(found.sum())
            walked = int(torch.where(src >= 0, k - src, k).sum())
            esz = alloc.element_size()
            n = alloc.shape[1]
            # the word entry: 8 bytes a walked entry (a 32-byte sector holds
            # four whole entries, so word1 comes with word0), 13 out a page
            row, _ = measure(torch, "merge", lambda: sm.merge_entries_cuda(sub),
                             lambda: sm_ref.merge_entries_ref(sub),
                             8 * walked + 13 * n, 0, None, flush)
            planes, _ = measure(torch, "merge", lambda: sm.merge_cuda(alloc, ptrs),
                                lambda: sm_ref.merge_ref(alloc, ptrs),
                                esz * walked + 4 * hits + 9 * n, 0, None, flush)
            row.update(
                bound_full_scan_ms=1e3 * (8 * k * n + 13 * n) / HBM_BYTES_PER_S,
                planes_ms=planes["ms"], planes_bound_ms=planes["bound_ms"],
                planes_plain_ms=planes["plain_ms"], planes_bytes=planes["bytes"],
                planes_config=list(sm.planes_config(alloc)),
                planes_bound_full_scan_ms=1e3 * ((esz + 4) * k * n + 9 * n)
                / HBM_BYTES_PER_S)
            measured = [row]
            emit({"phase": "maintenance", "part": "disk", "kernel_shapes": {
                "merge_K_N": [k, n], "alloc_dtype": str(alloc.dtype),
                "words_walked": walked, "hits": hits}})
        del sub, alloc, ptrs, merged, plan_found, found, ptr, src, c_found, c_src

        _build.reset_launches()
        cursor0 = int(chain.pool_cursor)
        stream_ms = _ms(torch, lambda: store.stream(chain, k - 1, copy_data=True))
        per_call = _build.LAUNCHES["merge"]     # one stream, one plan
        moved = int(chain.pool_cursor) - cursor0
        require(store.chain_length(chain) == 2, "streamed chain length")
        require(not bool(chain.overflow), "stream ran out of pool rows")
        require(moved > 0, "stream moved no rows")
        _require_disk_reads(torch, store, chain, ref, methods, f"{name} stream")
        walk_after = _mean_walk(store, chain, ycsb)
        if not scalable:
            require(walk_before >= 0.9 * MAINT_DEPTH and walk_after <= 2,
                    f"walk {walk_before} -> {walk_after} lookups")
        live_l2 = chain.l2[:2]
        live = int(torch.unique(
            fmt.entry_ptr(live_l2)[fmt.entry_allocated(live_l2)]).numel())
        del live_l2
        compact_ms = _ms(torch, lambda: store.compact_pool(chain))
        require(int(chain.pool_cursor) == live, "compact_pool cursor != live rows")
        _require_disk_reads(torch, store, chain, ref, methods, f"{name} compact")
        convert_ms = None
        if not scalable:
            convert_ms = _ms(torch, lambda: store.convert_to_scalable(chain))
            _require_disk_reads(torch, store, chain, ref,
                                ("direct", "pallas_direct", "auto"),
                                f"{name} convert")
        launches = dict(_build.LAUNCHES)       # read just after the run
        require(launches["merge"] > 0, "disk maintenance: K9 never launched")
        total = {key: total.get(key, 0) + v for key, v in launches.items()}
        out[name] = dict(
            build_seconds=build_s, stream_ms=stream_ms, plan_merge_ms=plan_ms,
            plan_merge_device_ms=plan_device_ms, plane_copies_ms=planes_ms,
            rows_moved=moved,
            GB_copied=moved * CLUSTER * 4 / 1e9, compact_ms=compact_ms,
            live_rows=live, convert_ms=convert_ms,
            ycsb_mean_lookups_before=walk_before,
            ycsb_mean_lookups_after=walk_after)
        emit({"phase": "maintenance", "part": "disk", "format": name,
              "pool_rows": MAINT_DISK_POOL, "depth": MAINT_DEPTH,
              "merge_upto": k - 1, **out[name],
              "reads_equal_after_each_step": True, "launches": launches,
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
        del chain, ref
        torch.cuda.empty_cache()
    if measured:
        for key in ("plan_merge_ms", "plan_merge_device_ms", "plane_copies_ms"):
            measured[0][key] = out["vanilla"][key]
    return measured, total, per_call


def _clone_fleet(fl):
    """An independent copy of a fleet (the ops work in place)."""
    import dataclasses

    return dataclasses.replace(fl, **{
        f.name: getattr(fl, f.name).clone()
        for f in dataclasses.fields(fl) if f.name != "spec"})


def _check_streamed(torch, mods, fl, ref, ids, lengths0, free0, what):
    fleet_lib = mods["fleet"]
    got, _ = fleet_lib.read(fl, ids, method="auto")
    require(_same(torch, got, ref), f"{what}: read differs from the reference")
    require(torch.equal(fl.length.cpu(), lengths0.clamp(max=2)),
            f"{what}: chain lengths are not min(length, 2)")
    require(fleet_lib.fleet_stats(fl)["quanta_free"] > free0,
            f"{what}: no quanta came free")
    mods["check_fleet_invariants"](fl)


def _drain_timed(torch, sched):
    """Tick until the backlog is empty; the host ms of every tick."""
    ms = []
    while sched.backlog():
        require(len(ms) < 10_000, "maintenance backlog did not drain")
        ms.append(_ms(torch, sched.tick))
    require(sched.drain() == 0, "drain() found work after the timed ticks")
    return ms


def _tick_summary(ms):
    return dict(ticks=len(ms), tick_ms_mean=float(np.mean(ms)) if ms else 0.0,
                tick_ms_max=float(np.max(ms)) if ms else 0.0)


def fleet_maintenance(torch, mods):
    """8b: stop-the-world streaming against the budgeted scheduler on the
    phase-7 fleet, then compaction and the demotion policy."""
    fleet_lib, _build, Sched = mods["fleet"], mods["_build"], mods["Sched"]
    check = mods["check_fleet_invariants"]
    g = torch.Generator(device=DEV).manual_seed(7)
    ids = torch.randint(0, FLEET_PAGES, (FLEET_T, FLEET_BATCH), generator=g,
                        device=DEV, dtype=torch.int32)      # phase 7's ids
    total = {}
    for scalable in (False, True):
        name = "scalable" if scalable else "vanilla"
        torch.cuda.reset_peak_memory_stats()
        stw = build_fleet(torch, fleet_lib, scalable, seed=8,
                          extra_rows=2 * OVERWRITE)
        budgeted = _clone_fleet(stw)
        ref, _ = fleet_lib.read(stw, ids, method="vanilla")
        lengths0 = stw.length.cpu()
        free0 = fleet_lib.fleet_stats(stw)["quanta_free"]
        rows0 = fleet_lib.fleet_stats(stw)["rows_allocated"]

        _build.reset_launches()
        stw_ms = _ms(torch, lambda: fleet_lib.stream_tenants(
            stw, True, (lengths0 - 2).numpy()))
        _check_streamed(torch, mods, stw, ref, ids, lengths0, free0,
                        f"{name} stop-the-world")
        stw_stats = fleet_lib.fleet_stats(stw)

        sched = Sched(budgeted, max_tenants_per_tick=SCHED_TENANTS_PER_TICK,
                      stream_chain_threshold=SCHED_THRESHOLD)
        tick_ms = _drain_timed(torch, sched)
        budgeted = sched.fleet
        _check_streamed(torch, mods, budgeted, ref, ids, lengths0, free0,
                        f"{name} scheduler")
        sched_stats = sched.stats()

        # compaction: overwrite clusters twice in the active layer, then GC
        pages = torch.argsort(torch.rand((FLEET_T, FLEET_PAGES), generator=g,
                                         device=DEV), dim=1)[:, :OVERWRITE]
        for _ in range(2):
            fleet_lib.write(stw, pages, torch.randn(
                (FLEET_T, OVERWRITE, CLUSTER), generator=g, device=DEV))
        fleet_lib.check_pool_capacity(stw)
        ref2, _ = fleet_lib.read(stw, ids, method="auto")
        alloc0 = stw.alloc_count.clone()
        compact_ms = _ms(torch, lambda: fleet_lib.compact(stw))
        got, _ = fleet_lib.read(stw, ids, method="auto")
        require(_same(torch, got, ref2), f"{name}: compact changed the reads")
        freed = alloc0 - stw.alloc_count
        require(bool((freed >= OVERWRITE).all()),
                f"{name}: compact freed fewer rows than were overwritten")
        check(stw)
        del got, ref2

        demote = None
        if not scalable:
            # the demotion policy on the streamed fleet: a host tier sized
            # for the spill, not for the whole pool
            store = mods["TieredStore"](CLUSTER, torch.float32,
                                        initial_rows=HOST_ROWS)
            budget = int(DEMOTE_BUDGET_SHARE
                         * fleet_lib.fleet_stats(budgeted)["rows_allocated"])
            dsched = Sched(budgeted, store=store, device_page_budget=budget,
                           demote_rows_per_tick=DEMOTE_PER_TICK)
            dms = _drain_timed(torch, dsched)
            budgeted = dsched.fleet
            rows_after = fleet_lib.fleet_stats(budgeted)["rows_allocated"]
            require(rows_after <= budget, f"rows {rows_after} above {budget}")
            tiered, _ = fleet_lib.read_tiered(budgeted, store, ids, method="auto")
            require(_same(torch, tiered, ref), "read_tiered after demotion differs")
            check(budgeted, store=store)
            demote = dict(budget_rows=budget, rows_after=rows_after,
                          rows_demoted=dsched.rows_demoted,
                          host_rows=store.host_rows_in_use(), **_tick_summary(dms))
            del tiered, store, dsched
        launches = dict(_build.LAUNCHES)       # read just after the run
        for key in ("merge", "resolve_vanilla_fleet", "gather_fleet"):
            require(launches[key] > 0, f"fleet maintenance: {key} never launched")
        total = {key: total.get(key, 0) + v for key, v in launches.items()}
        emit({"phase": "maintenance", "part": "fleet", "format": name,
              "tenants": FLEET_T, "pool_rows": stw.spec.pool_capacity,
              "rows_allocated_before": rows0,
              "stop_the_world_ms": stw_ms,
              "stop_the_world_quanta_free": stw_stats["quanta_free"],
              "scheduler": dict(**_tick_summary(tick_ms),
                                tenants_streamed=sched_stats["tenants_streamed"],
                                quanta_free=sched_stats["quanta_free"]),
              "quanta_free_before": free0,
              "compact_ms": compact_ms, "compact_rows_freed": int(freed.sum()),
              "demotion_policy": demote,
              "reads_equal_reference": True, "invariants": True,
              "launches": launches,
              "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
        del stw, budgeted, sched, ref
        torch.cuda.empty_cache()
    return total


def serve_maintenance(torch, mods, cfg, params, prompts):
    """8c: decode beside a maintenance scheduler, and park/resume."""
    Engine, fleet_lib, _build = mods["Engine"], mods["fleet"], mods["_build"]
    check_kv = mods["check_kv_invariants"]
    g = torch.Generator(device=DEV).manual_seed(7)
    ids = torch.randint(0, FLEET_PAGES, (FLEET_T, FLEET_BATCH), generator=g,
                        device=DEV, dtype=torch.int32)
    fl = build_fleet(torch, fleet_lib, False, seed=8)
    fref, _ = fleet_lib.read(fl, ids, method="vanilla")

    def engine(**extra):
        eng = Engine(cfg, params, scalable=False, n_blocks=1024, block_size=16,
                     max_blocks_per_seq=128, resolver="auto",
                     decode_path="fused", **extra)
        return eng, [eng.add_request(p) for p in prompts]

    def decode(eng, n):
        return [_ms(torch, eng.step) for _ in range(n)]

    def finish(eng):
        tokens = {s: list(t) for s, t in eng.active.items()}
        for s in sorted(eng.active):
            eng.finish_request(s)
        require(eng.kv.blocks_in_use() == 0 and eng.kv.host_blocks_in_use() == 0,
                "serve maintenance: blocks left after finishing")
        return tokens

    sched = mods["Sched"](fl, max_tenants_per_tick=1)
    tick_ms, tick = [], sched.tick

    def timed_tick():
        out, ms = _timed(torch, tick)
        tick_ms.append(ms)
        return out

    sched.tick = timed_tick
    _build.reset_launches()
    # the two engines step in turns, so host drift hits both alike
    plain, _ = engine()
    maint, _ = engine(scheduler=sched)
    plain_ms, sched_ms = [], []
    for _ in range(MAINT_STEPS):
        plain_ms += decode(plain, 1)
        sched_ms += decode(maint, 1)
    streamed = maint.memory_stats()["maintenance"]["tenants_streamed"]
    require(finish(maint) == finish(plain), "tokens differ with the scheduler")
    require(streamed >= MAINT_STEPS, f"only {streamed} tenants streamed")
    got, _ = fleet_lib.read(sched.fleet, ids, method="auto")
    require(_same(torch, got, fref), "scheduler fleet read differs")
    # the wrapper closes over sched's own bound method: as an attribute of
    # sched it is a reference cycle that would hold the fleet (17 GB) until
    # the cycle collector ran
    del sched.tick
    del plain, maint, got, fref, sched, fl
    torch.cuda.empty_cache()

    # park / resume the 512-token sequence against a run that never parks
    eng, sids = engine()
    decode(eng, 3 * PARK_STEPS)
    never_parked = finish(eng)
    del eng
    eng, sids = engine()
    parked = sids[PROMPT_LENGTHS.index(max(PROMPT_LENGTHS))]
    promote_ms, promote = [], eng.kv.promote_seq

    def timed_promote(sid):
        out, ms = _timed(torch, lambda: promote(sid))
        promote_ms.append(ms)
        return out

    eng.kv.promote_seq = timed_promote
    decode(eng, PARK_STEPS)
    spilled, demote_ms = _timed(torch, lambda: eng.park_request(parked))
    host = eng.memory_stats()["host_blocks"]
    require(spilled > 0 and host == spilled, f"park spilled {spilled} blocks")
    check_kv(eng.kv)
    decode(eng, PARK_STEPS)
    eng.resume_request(parked)
    check_kv(eng.kv)
    decode(eng, 1)
    require(eng.memory_stats()["host_blocks"] == 0, "host blocks after resume")
    check_kv(eng.kv)
    decode(eng, PARK_STEPS - 1)
    tokens = finish(eng)
    for s, t in tokens.items():
        want = never_parked[s][:len(t)]
        require(t == want, f"sid {s}: tokens differ across park/resume")
    require(len(tokens[parked]) == 1 + 2 * PARK_STEPS, "parked sequence length")
    launches = dict(_build.LAUNCHES)           # read just after the run
    for key in ("resolve_vanilla_fleet", "fused_chain_attention", "gather_fleet",
                "merge"):
        require(launches[key] > 0, f"serve maintenance: {key} never launched")
    emit({"phase": "maintenance", "part": "serve", "model": cfg.name,
          "engine": "vanilla/fused", "steps": MAINT_STEPS,
          "ms_per_step_plain": float(np.mean(plain_ms)),
          "ms_per_step_with_scheduler": float(np.mean(sched_ms)),
          "tick_ms_mean": float(np.mean(tick_ms)),
          "tick_ms_max": float(np.max(tick_ms)), "tenants_streamed": streamed,
          "tokens_equal_with_and_without_scheduler": True,
          "park": dict(blocks_spilled=spilled, demote_ms=demote_ms,
                       promote_ms=promote_ms, steps_parked=PARK_STEPS),
          "tokens_equal_across_park_resume": True, "launches": launches})
    del eng.kv.promote_seq          # a cycle through kv, as sched.tick above
    del eng
    torch.cuda.empty_cache()
    return launches


# -- phase 9: golden admission and migration ---------------------------------


def _engine(mods, cfg, params, *, scalable, path="auto", block_size=16,
            max_blocks=128):
    return mods["Engine"](cfg, params, scalable=scalable, n_blocks=1024,
                          block_size=block_size, max_blocks_per_seq=max_blocks,
                          resolver="auto", decode_path=path)


def golden_admission(torch, mods, cfg, params, line=emit):
    """9a: a golden prompt of 392 tokens (24 full blocks of 16 and a
    shared partial one) registered on two engines, four admissions that
    extend it by 0, 17, 100 and 200 tokens and one miss. Each hit's first
    token and K/V equal, bit for bit, a duplicate-storage admission through
    the same ``_suffix_prefill``; hits and duplicates then decode the same
    tokens, across ``release_golden`` too (a dense model's: an MoE's
    capacity may part two identical rows of one batch). Returns the
    launches and K3's row at the 256-row suffix shape."""
    _build, check_kv = mods["_build"], mods["check_kv_invariants"]
    rng = np.random.default_rng(9)
    golden = rng.integers(0, cfg.vocab_size, GOLDEN_PROMPT)
    tail = rng.integers(0, cfg.vocab_size, max(GOLDEN_EXTENSIONS))
    prompts = [np.concatenate([golden, tail[:n]]) for n in GOLDEN_EXTENSIONS]
    miss = rng.integers(0, cfg.vocab_size, GOLDEN_PROMPT)
    total, suffix_state = {}, None
    for name, scalable, path in (("vanilla/fused", False, "fused"),
                                 ("scalable/tables", True, "tables")):
        _build.reset_launches()
        eng = _engine(mods, cfg, params, scalable=scalable, path=path)
        kv = eng.kv
        gsid, register_ms = _timed(torch, lambda: eng.register_golden(golden))
        blocks_golden = kv.blocks_in_use()
        hits, admit_ms = [], []
        for p in prompts:
            sid, ms = _timed(torch, lambda: eng.add_request(p))
            hits.append(sid)
            admit_ms.append(ms)
        require(eng.golden_hits == len(prompts), f"{name}: golden hits")
        stats = kv.golden_stats()
        require(stats["dedup_blocks_saved"] >= (GOLDEN_PROMPT // 16) * len(hits),
                f"{name}: {stats['dedup_blocks_saved']} blocks saved")
        blocks_hits = kv.blocks_in_use() - blocks_golden
        msid, miss_ms = _timed(torch, lambda: eng.add_request(miss))
        require(eng.golden_hits == len(prompts), f"{name}: the miss forked")
        # the duplicate-storage oracle: the golden's bytes copied, the same
        # suffix pass; its launches are the check's, not the main path's
        with uncounted(_build):
            gk, gv = kv.gather(gsid)
            blocks_before_dups = kv.blocks_in_use()
            dups = []
            for p, sid in zip(prompts, hits):
                dup = kv.new_seq()
                kv.append_prefill(dup, gk, gv)
                suffix = [int(x) for x in p[GOLDEN_PROMPT:]]
                tok = (eng._suffix_prefill(dup, suffix) if suffix
                       else eng._golden_info[gsid][1])
                require(tok == eng.active[sid][0],
                        f"{name}: +{len(suffix)} first token differs from duplicate")
                for a, b in zip(kv.gather(sid), kv.gather(dup)):
                    require(_same(torch, a, b),
                            f"{name}: +{len(suffix)} K/V differ from duplicate")
                eng.active[dup] = [tok]
                dups.append(dup)
            blocks_dups = kv.blocks_in_use() - blocks_before_dups
            del gk, gv
        check_kv(kv)
        for step in range(GOLDEN_STEPS):
            if step == GOLDEN_STEPS // 2:
                eng.release_golden(gsid)      # the forks decode on
                check_kv(kv)
            eng.step()
        # a hit and its duplicate are two identical rows of one decode batch:
        # a dense model decodes them alike; an MoE routes both to the same
        # experts, whose capacity keeps the earlier row's assignment and may
        # drop the later one's, so there their tokens may part (as in JAX)
        same_decode = [eng.active[sid] == eng.active[dup]
                       for sid, dup in zip(hits, dups)]
        require(cfg.is_moe or all(same_decode),
                f"{name}: hit and duplicate decoded different tokens")
        require(len(eng.active[hits[0]]) == 1 + GOLDEN_STEPS, "decode steps")
        launches = dict(_build.LAUNCHES)          # read just after the run
        require(launches["paged_attention"] > 0,
                f"{name}: suffix prefill never launched paged_attention")
        # a full prefill of the longest prompt, beside its suffix admission
        (full_sid, _), full_ms = _timed(torch, lambda: eng._prefill_seq(prompts[-1]))
        kv.free_seq(full_sid)
        if path == "tables":
            sid = hits[-1]
            table = kv._resolve_oracle(sid)[0]
            suffix_state = dict(pool_k=kv.pool_k[0].clone(),
                                pool_v=kv.pool_v[0].clone(),
                                table=np.where(table >= 0, table, eng._pad_block))
        for s in sorted(eng.active):
            eng.finish_request(s)
        require(kv.blocks_in_use() == 0, f"{name}: blocks leaked")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        line({"phase": "golden", "part": "admission", "engine": name,
              "model": cfg.name, "golden_tokens": GOLDEN_PROMPT,
              "extensions": list(GOLDEN_EXTENSIONS),
              "buckets": [eng._bucket(n) if n else 0 for n in GOLDEN_EXTENSIONS],
              "register_ms": register_ms, "admit_ms": admit_ms,
              "miss_ms": miss_ms, "full_prefill_ms": full_ms,
              "full_prefill_tokens": len(prompts[-1]),
              "blocks_golden": blocks_golden,
              "blocks_hits_with_dedup": blocks_hits,
              "blocks_same_sequences_without_dedup": blocks_dups,
              "golden_stats_after_hits": stats,
              "hits_equal_duplicates_bitwise": True,
              "tokens_equal_over_steps": GOLDEN_STEPS if all(same_decode) else None,
              "hits_decoding_as_their_duplicates": sum(same_decode),
              "release_golden_at_step": GOLDEN_STEPS // 2,
              "launches": launches})
        del eng, kv
        torch.cuda.empty_cache()
    return total, suffix_kernel(torch, mods, suffix_state, cfg, line)


def suffix_kernel(torch, mods, s, cfg, line=emit):
    """K3 at the suffix prefill's shape, on the engine's own layer-0 pools
    and the 200-token admission's table: 256 rows (200 real, lengths
    393-592, and 56 padded of length 1) reading one table, through the
    shared-table entry the suffix prefill calls and through the
    JAX-signature entry on the table repeated (``repeated_table``). Each is
    held against its plain version (the long context's absolute and
    relative L2 limits, with the outputs' spread beside them, and a check
    that the errors a dropped page or a short length would give exceed
    them) and timed against its bound, with its plan and its ms by pass
    (the split pass, the combine). ``scaled_dot_product_attention`` over
    the same K/V gathered dense, with the causal mask, is timed beside
    them as a yardstick."""
    pa, pa_ref = mods["pa"], mods["pa_ref"]
    n = max(GOLDEN_EXTENSIONS)
    pad = mods["Engine"]._bucket(n)
    lens_h = np.ones(pad, np.int32)
    lens_h[:n] = GOLDEN_PROMPT + 1 + np.arange(n)
    tables_h = np.repeat(s["table"][None].astype(np.int32), pad, 0)
    pool_k, pool_v = s["pool_k"], s["pool_v"]
    nb, bs, hkv, d = pool_k.shape
    tables = torch.as_tensor(tables_h, device=DEV)
    lens = torch.as_tensor(lens_h, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(9)
    q = torch.randn((pad, cfg.n_heads, d), generator=g, device=DEV).to(pool_k.dtype)
    nbytes, ops, *_ = attention_cost(tables_h, lens_h, bs, hkv, d,
                                     pool_k.element_size(), cfg.n_heads)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    m = int(lens_h.max())
    blocks = tables[0, : -(-m // bs)].long()
    kd, vd = (x[blocks].reshape(-1, hkv, d)[:m].transpose(0, 1)[None].contiguous()
              for x in (pool_k, pool_v))
    causal = torch.arange(m, device=DEV)[None, :] < lens[:, None]

    def dense():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(0, 1)[None], kd, vd, attn_mask=causal, enable_gqa=True)

    table = tables[0].contiguous()

    def kern():
        return pa.paged_attention_cuda(q, pool_k, pool_v, tables, lens)

    def plain(lengths=lens):
        return pa_ref.paged_attention_ref(q, pool_k, pool_v, tables, lengths)

    def shared():
        return pa.paged_attention_shared_table_cuda(q, pool_k, pool_v, table, lens)

    def shared_plain():
        return pa_ref.paged_attention_shared_table_ref(q, pool_k, pool_v, table,
                                                       lens)

    def rel_l2(a, want):
        return float((a.float() - want).norm() / want.norm())

    with uncounted(mods["_build"]):
        row, got = measure(torch, "paged_attention", kern, plain, nbytes, ops,
                           LONG_CONTEXT_TOL, flush)
        want = plain().float()
        rel = rel_l2(got[0], want)
        require(rel <= LONG_CONTEXT_REL_TOL,
                f"suffix shape: paged_attention relative error {rel}")
        srow, sgot = measure(torch, "paged_attention", shared, shared_plain,
                             nbytes, ops, LONG_CONTEXT_TOL, flush)
        require(torch.equal(shared_plain().float(), want),
                "suffix shape: the shared table's plain version is not K3's")
        srel = rel_l2(sgot[0], want)
        require(srel <= LONG_CONTEXT_REL_TOL,
                f"suffix shape: the shared-table entry's relative error {srel}")
        splan = pa.shared_plan(pad, cfg.n_heads, hkv, tables.shape[1], bs, q.dtype,
                               pa.sm_count(q.device))
        # what the two limits see of a fault: the plain version with the
        # real rows' last 16 positions (up to a page) dropped, and 4 short
        faults = {}
        for fault, short in (("last_16_dropped", bs), ("short_by_4", 4)):
            w = plain(torch.where(lens > short, lens - short, lens))
            faults[fault] = dict(max_abs=float((w.float() - want).abs().max()),
                                 rel=rel_l2(w, want))
            require(faults[fault]["max_abs"] > LONG_CONTEXT_TOL
                    or faults[fault]["rel"] > LONG_CONTEXT_REL_TOL,
                    f"suffix shape: the limits would pass a kernel with {fault}")
        dense_ms = timed_ms(torch, dense, 50, flush)
        by_pass = attention_passes(torch, kern, flush)
        shared_by_pass = attention_passes(torch, shared, flush)
    real = want[:n]
    out = dict(batch=pad, real_rows=n, lengths=[int(lens_h[0]), m],
               ms=srow["ms"], plain_ms=srow["plain_ms"], bound_ms=srow["bound_ms"],
               bound_by=srow["bound_by"], bytes=nbytes, ops=ops,
               max_abs_err=srow["max_abs_err"], rel_err=srel, tol=LONG_CONTEXT_TOL,
               rel_tol=LONG_CONTEXT_REL_TOL,
               output_spread=dict(std=float(real.std()),
                                  max_abs=float(real.abs().max())),
               fault_errors=faults, dense_sdpa_ms=dense_ms,
               device_ms_by_pass=shared_by_pass,
               **plan_report(splan, lens_h, bs, tables.shape[1]),
               repeated_table=dict(
                   ms=row["ms"], plain_ms=row["plain_ms"],
                   max_abs_err=row["max_abs_err"], rel_err=rel,
                   device_ms_by_pass=by_pass,
                   **split_report(pa, q, hkv, tables.shape[1], bs, lens_h)))
    line({"phase": "golden", "part": "k3_suffix_shape", "model": cfg.name,
          "heads": [cfg.n_heads, hkv], **out})
    return out


def sequence_migration(torch, mods, cfg, params, prompt):
    """9c: a request forked on a vanilla engine (block size 16, fused
    path), its parent finished, the child migrated to a scalable engine of
    block size 32 (tables path); its next tokens equal those of an
    unmigrated reference engine of the destination's geometry, which
    admitted the same prompt. The child migrates right after admission:
    a decode step on the source would attend in 16-token pages, the
    reference in 32-token ones, and bf16 sums in another order could
    move a near-tied argmax."""
    _build, check_kv = mods["_build"], mods["check_kv_invariants"]
    _build.reset_launches()
    src = _engine(mods, cfg, params, scalable=False)
    dst = _engine(mods, cfg, params, scalable=True, block_size=32, max_blocks=64)
    ref = _engine(mods, cfg, params, scalable=True, block_size=32, max_blocks=64)
    require(src.decode_path == "fused" and dst.decode_path == "tables",
            "sequence migration: decode paths")
    a = src.add_request(prompt)
    with uncounted(_build):                    # the reference is the check's
        r = ref.add_request(prompt)
    require(src.active[a] == ref.active[r], "sequence migration: first token")
    b = src.fork_request(a)
    src.finish_request(a)                      # tombstone the parent
    new, migrate_ms = _timed(torch, lambda: src.migrate_request_to(dst, b))
    require(not src.active and src.kv.blocks_in_use() == 0,
            "sequence migration: source not retired")
    for eng in (src, dst):
        check_kv(eng.kv)
    got = [dst.step()[new] for _ in range(GOLDEN_STEPS)]
    with uncounted(_build):
        want = [ref.step()[r] for _ in range(GOLDEN_STEPS)]
    require(got == want, "migrated request decodes other tokens than the reference")
    launches = dict(_build.LAUNCHES)           # read just after the run
    require(launches["paged_attention"] > 0, "sequence migration: K3 not launched")
    emit({"phase": "golden", "part": "sequence_migration", "model": cfg.name,
          "prompt_tokens": len(prompt), "src": "vanilla/fused bs 16",
          "dst": "scalable/tables bs 32", "migrate_ms": migrate_ms,
          "tokens_equal_reference": GOLDEN_STEPS, "launches": launches})
    for eng in (dst, ref):
        for s in sorted(eng.active):
            eng.finish_request(s)
    del src, dst, ref
    torch.cuda.empty_cache()
    return launches


def golden_fleet(torch, mods, fl, store):
    """9b and 9d on the phase-7 vanilla fleet, while it still lives.

    9b: tenants of depth 1, 64 and 500 (a cold layer demoted first, so
    their blobs carry host pages) migrate to a fleet of 4 tenants, twice
    the lease quantum and the scalable flag: export, import, verify (the
    port's ``materialize_tenant`` of both, bit for bit) and detach, each
    timed, with the device memory one verify adds at its peak.

    9d: tenant 16 (depth 127) registered with a ``GoldenRegistry`` and
    forked into 8 free slots, 4 at its full depth and 4 at depth 64, each
    fork then writing 4 clusters of its own and snapshotting; a
    ``MaintenanceScheduler(registry=...)`` over a device budget ticks
    ``REGISTRY_TICKS`` times with ``check_fleet_invariants(registry=...)``
    after each: the owner is never streamed, and every fork page that
    resolved to a pinned row still resolves to it, hot."""
    fleet_lib, migrate, _build = mods["fleet"], mods["migrate"], mods["_build"]
    check = mods["check_fleet_invariants"]
    _build.reset_launches()
    # 9b: tenant migration
    spec = fleet_lib.FleetSpec(
        n_tenants=4, n_pages=FLEET_PAGES, page_size=CLUSTER,
        max_chain=FLEET_MAX_DEPTH + 2, pool_capacity=MIGRATE_POOL,
        lease_quantum=2 * FLEET_Q)
    dst = fleet_lib.create(spec, scalable=True, device=DEV)
    dst_store = mods["TieredStore"](CLUSTER, torch.float32, initial_rows=2 * MIGRATE_COLD)
    for t in MIGRATE_TENANTS[1:]:
        fl, rep = fleet_lib.demote_tenants(fl, store, [t], max_rows=MIGRATE_COLD)
        require(rep["rows_demoted"] == MIGRATE_COLD, f"tenant {t}: demoted rows")
    host0 = store.host_rows_in_use()
    out = []
    for slot, t in enumerate(MIGRATE_TENANTS):
        depth = int(fl.length[t])
        blob, export_ms = _timed(torch, lambda: migrate.export_tenant(fl, t, store=store))
        dst, import_ms = _timed(torch, lambda: migrate.import_tenant(
            dst, slot, blob, store=dst_store))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        want, src_ms = _timed(torch, lambda: migrate.materialize_tenant(
            fl, t, store=store))
        one_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        got, dst_ms = _timed(torch, lambda: migrate.materialize_tenant(
            dst, slot, store=dst_store))
        verify_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        require(_same(torch, want, got), f"tenant {t}: migrated disk differs")
        del want, got
        fl, detach_ms = _timed(torch, lambda: migrate.detach_tenant(
            fl, t, blob, store=store))
        require(int(fl.length[t]) == 1 and int(fl.lease_count[t]) == 0,
                f"tenant {t}: source slot not clean")
        out.append(dict(tenant=t, depth=depth, rows_hot=blob.n_hot,
                        rows_cold=blob.n_cold, blob_bytes=blob.nbytes(),
                        export_ms=export_ms, import_ms=import_ms,
                        verify_ms=src_ms + dst_ms,
                        materialize_peak_extra_GB=one_peak,
                        verify_peak_extra_GB=verify_peak, detach_ms=detach_ms))
        del blob
    require([o["depth"] for o in out] == list(MIGRATE_DEPTHS), "migrated depths")
    require(out[-1]["rows_cold"] == MIGRATE_COLD, "no host pages travelled")
    require(store.host_rows_in_use() == host0 - 2 * MIGRATE_COLD,
            "detach left host rows")
    check(dst, store=dst_store)
    emit({"phase": "golden", "part": "tenant_migration", "src_tenants": FLEET_T,
          "src_quantum": FLEET_Q, "dst_tenants": spec.n_tenants,
          "dst_quantum": spec.lease_quantum, "dst_scalable": True,
          "cluster_bytes": CLUSTER * 4, "migrations": out,
          "verified_bitwise": True})
    del dst, dst_store
    torch.cuda.empty_cache()

    # 9d: the golden registry beside the maintenance plane
    reg = mods["GoldenRegistry"]()
    gid, created = reg.register(fl, REGISTRY_OWNER)
    require(created, "registry: not created")
    lengths = fl.length.cpu().numpy()
    alloc = fl.alloc_count.cpu().numpy()
    free_slots = [t for t in range(FLEET_T) if lengths[t] == 1 and alloc[t] == 0]
    forks = free_slots[:REGISTRY_FORKS]
    require(len(forks) == REGISTRY_FORKS, f"free slots {free_slots}")
    full = int(lengths[REGISTRY_OWNER])
    for i, f in enumerate(forks):
        fl = reg.fork(fl, gid, f, depth=full if i % 2 else REGISTRY_SHALLOW)
    g = torch.Generator(device=DEV).manual_seed(16)
    mask = torch.zeros(FLEET_T, dtype=torch.bool, device=DEV)
    mask[forks] = True
    ids = torch.argsort(torch.rand((FLEET_T, FLEET_PAGES), generator=g, device=DEV),
                        dim=1)[:, :FLEET_LAYER_WRITES]
    fleet_lib.write(fl, ids, torch.randn((FLEET_T, FLEET_LAYER_WRITES, CLUSTER),
                                         generator=g, device=DEV), mask)
    fleet_lib.snapshot(fl, mask)
    check(fl, store=store, registry=reg)
    pinned = torch.as_tensor(reg.pinned_rows(), device=DEV)
    grid = torch.arange(FLEET_PAGES, dtype=torch.int32, device=DEV)[None]

    def pinned_pages(f):
        # a check's read: its launches are not the main path's
        with uncounted(_build):
            res = fleet_lib.get_resolver("auto")(fleet_lib.tenant_slice(fl, f), grid)
        hot = res.found[0] & ~res.zero[0] & ~res.cold[0]
        return hot, res.ptr[0].long()

    before = {}
    for f in forks:
        hot, ptr = pinned_pages(f)
        keep = hot & torch.isin(ptr, pinned)
        before[f] = (keep, ptr)
    owner_len = int(fl.length[REGISTRY_OWNER])
    rows = fleet_lib.fleet_stats(fl)["rows_allocated"]
    sched = mods["Sched"](fl, max_tenants_per_tick=REGISTRY_STREAMS, store=store,
                          device_page_budget=rows - REGISTRY_TICKS * DEMOTE_PER_TICK,
                          demote_rows_per_tick=DEMOTE_PER_TICK, registry=reg)
    ticks = []
    for _ in range(REGISTRY_TICKS):
        rep, ms = _timed(torch, sched.tick)
        fl = sched.fleet
        require(REGISTRY_OWNER not in rep["streamed"], "golden owner streamed")
        check(fl, store=store, registry=reg)
        for f, (keep, ptr) in before.items():
            hot, now = pinned_pages(f)
            require(bool((hot[keep] & (now[keep] == ptr[keep])).all()),
                    f"fork {f}: a pinned row was demoted or moved")
        ticks.append(dict(ms=ms, streamed=len(rep["streamed"]),
                          rows_demoted=rep["rows_demoted"]))
    require(int(fl.length[REGISTRY_OWNER]) == owner_len, "golden owner changed")
    require(sched.rows_demoted > 0, "the demotion policy demoted nothing")
    registry_stats = reg.stats()
    fleet_lib.free_tenant(fl, forks, store=store, registry=reg)
    reg.unregister(gid)
    check(fl, store=store, registry=reg)
    launches = dict(_build.LAUNCHES)           # read just after the run
    for key in ("resolve_vanilla_fleet", "gather_fleet", "merge"):
        require(launches[key] > 0, f"golden fleet: {key} never launched")
    emit({"phase": "golden", "part": "registry", "owner": REGISTRY_OWNER,
          "owner_depth": owner_len, "forks": forks,
          "fork_depths": [full if i % 2 else REGISTRY_SHALLOW
                          for i in range(len(forks))],
          "stats": registry_stats,
          "ticks": ticks, "rows_demoted": sched.rows_demoted,
          "owner_never_streamed": True, "pinned_rows_never_demoted": True,
          "invariants_every_tick": True, "launches": launches})
    return launches


# -- phase 10: the paper's evaluation plane ----------------------------------


def _paper(obj, mods):
    """A phase-10 line: the card's name and power limit beside its numbers."""
    emit({"phase": "paper", "card": mods["smi"], **obj})


def _same_leaves(torch, got, want) -> bool:
    """Two states of one structure, bit for bit (bf16 through int16)."""
    def same(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return torch.equal(_bits(torch, a.reshape(-1)), _bits(torch, b.reshape(-1)))
        return torch.equal(a, b)

    return all(same(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def _checkpoint_state(torch, mods, cfg):
    """Qwen2.5-3B's params in bf16, drawn as phase 4 draws them, and a step."""
    params = mods["init_params"](cfg, torch.Generator(device=DEV).manual_seed(0),
                                 device=DEV, dtype=mods["layers"].COMPUTE_DTYPE)
    return dict(params, step=torch.zeros((), dtype=torch.int32, device=DEV))


def _restores(torch, ck, live, methods, flush):
    """Every method's restore bit-equal to ``live``, then timed by CUDA
    events (L2 flushed, a spin first), with its lookups."""
    out = {}
    for m in methods:
        got = ck.restore(method=m)
        require(_same_leaves(torch, got, live), f"checkpoint restore {m} differs")
        del got
        out[m] = dict(ms=timed_ms(torch, lambda: ck.restore(method=m),
                                  CKPT_TIMED, flush),
                      lookups=ck.resolve_cost(m))
    return out


def checkpoint_phase(torch, mods, cfg, flush):
    """10a: Fig 17 on a Qwen2.5-3B checkpoint chain, one format at a time."""
    ckpt, _build = mods["ckpt"], mods["_build"]
    total, shapes, lines = {}, {}, {}
    for scalable in (True, False):
        name = "scalable" if scalable else "vanilla"
        torch.cuda.reset_peak_memory_stats()
        state = _checkpoint_state(torch, mods, cfg)
        wo = state["layers"]["attn"]["wo"]
        g = torch.Generator(device=DEV).manual_seed(17)
        ck = ckpt.SnapshotCheckpointer(state, max_chain=CKPT_MAX_CHAIN,
                                       scalable=scalable, stream_threshold=10**9,
                                       device=DEV)
        image_bytes = ck.spec.n_pages * ck.spec.page_size * 4
        methods = (("vanilla", "direct", "pallas_vanilla", "pallas_direct")
                   if scalable else ("vanilla", "pallas_vanilla", "auto"))
        _build.reset_launches()
        saves, restores = [], {}
        for i in range(1, CKPT_SAVES + 1):
            layer = wo[i % cfg.n_layers]
            layer += (torch.randn(layer.shape, generator=g, device=DEV)
                      * 1e-3).to(layer.dtype)
            state["step"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = ck.save(state)
            saves.append(dict(ms=1e3 * (time.perf_counter() - t0), **st))
            if i in CKPT_RESTORE_AT:
                restores[i] = _restores(torch, ck, state, methods, flush)
        require(saves[0]["pages_written"] == ck.spec.n_pages, "first save not full")
        require(all(CKPT_DELTA_PAGES[0] <= s["pages_written"] <= CKPT_DELTA_PAGES[1]
                    for s in saves[1:]), "delta saves wrote the wrong page count")
        require(ck.chain.length.item() == CKPT_SAVES + 1, "checkpoint chain length")
        line = dict(part="fig17", format=name, model=cfg.name,
                    n_pages=ck.spec.n_pages, page_bytes=ck.spec.page_size * 4,
                    pool_rows=ck.spec.pool_capacity, image_GB=image_bytes / 1e9,
                    restore_bound_ms=1e3 * 2 * image_bytes / HBM_BYTES_PER_S,
                    first_save_ms=saves[0]["ms"],
                    delta_save_ms_mean=float(np.mean([s["ms"] for s in saves[1:]])),
                    delta_save_ms_max=max(s["ms"] for s in saves[1:]),
                    pages_written=[s["pages_written"] for s in saves],
                    restores={str(k): v for k, v in restores.items()},
                    restores_bitwise_equal=True)
        if not scalable:
            # K9 at the chain's shape, then the provider's streaming policy
            shapes["merge"] = _ckpt_merge(torch, mods, ck, flush)
            ck.stream_threshold = CKPT_STREAM_AT
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            require(ck.maybe_stream(), "maybe_stream did not stream")
            torch.cuda.synchronize()
            line["stream_ms"] = 1e3 * (time.perf_counter() - t0)
            line["length_after_stream"] = ck.chain.length.item()
            line["restores_after_stream"] = _restores(torch, ck, state, methods, flush)
            line["async"] = _async_saves(torch, ck, state, wo)
        launches = dict(_build.LAUNCHES)            # read just after the run
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        line.update(launches=launches,
                    peak_GB=torch.cuda.max_memory_allocated() / 1e9)
        lines[name] = line
        _paper(line, mods)
        del state, wo, layer
        with uncounted(_build):
            shapes.update(_ckpt_kernels(torch, mods, ck, flush))
        del ck
        torch.cuda.empty_cache()
    for k in ("resolve_vanilla_fleet", "resolve_direct_fleet", "gather", "merge"):
        require(total[k] > 0, f"paper: kernel {k} never launched")
    for row in shapes.values():
        row["launches_on_path"] = total[row["kernel"]]
    _paper(dict(part="fig17_kernel_shapes", shapes=shapes), mods)
    return total, shapes


def _async_saves(torch, ck, state, wo):
    """``save_async`` then, at once, an in-place change (a layer of ``wo``
    negated, bit-exact to undo): each checkpoint restores to the state as
    it was at its submission."""
    out = []
    for i in range(CKPT_ASYNC):
        j = i % wo.shape[0]
        state["step"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fut = ck.save_async(state)
        submit_ms = 1e3 * (time.perf_counter() - t0)
        wo[j].neg_()
        st = fut.result()
        torch.cuda.synchronize()
        done_ms = 1e3 * (time.perf_counter() - t0)
        got = ck.restore(method="pallas_vanilla")
        wo[j].neg_()                    # the state as it was at submission
        require(_same_leaves(torch, got, state), "async save saw a later change")
        wo[j].neg_()                    # the change stays for the next save
        del got
        out.append(dict(submit_ms=submit_ms, done_ms=done_ms, **st))
    require([s["chain_length"] for s in out]
            == list(range(out[0]["chain_length"], out[0]["chain_length"] + CKPT_ASYNC)),
            "async saves out of order")
    return out


def _ckpt_merge(torch, mods, ck, flush):
    """K9's word entry on the layers ``maybe_stream`` will merge."""
    sm, sm_ref = mods["sm"], mods["sm_ref"]
    length = ck.chain.length.item()
    k = length - max(2, CKPT_STREAM_AT // 2)     # merge_upto + 1
    sub = ck.chain.l2[:k]
    with uncounted(mods["_build"]):
        want = sm_ref.merge_entries_ref(sub)
        walked = int(torch.where(want[2] >= 0, k - want[2], k).sum())
        del want
        row, _ = measure(torch, "merge", lambda: sm.merge_entries_cuda(sub),
                         lambda: sm_ref.merge_entries_ref(sub),
                         8 * walked + 13 * sub.shape[1], 0, None, flush,
                         n_kernel=20, n_plain=3)
    return _shape_row(row, "merge", K_N=[k, sub.shape[1]], words_walked=walked)


def _shape_row(row, kernel, **extra):
    keep = ("ms", "plain_ms", "library_ms", "library_ratio", "bound_ms",
            "bound_by", "bytes", "max_abs_err")
    return dict(kernel=kernel, **{k: row[k] for k in keep if k in row}, **extra)


def _ckpt_kernels(torch, mods, ck, flush):
    """The single-chain and one-tenant kernels at the checkpoint chain's
    shape against their plain versions, timed: K2, K7 and K8 on the
    scalable chain; K1 and K6 on the vanilla one."""
    cr, cr_ref, cg, cg_ref, fmt = (mods["cr"], mods["cr_ref"], mods["cg"],
                                   mods["cg_ref"], mods["fmt"])
    ch = ck.chain
    l2, length = ch.l2, ch.length
    c, n = l2.shape[0], l2.shape[1]
    out = {}
    if ch.scalable:
        w0, w1, lens = l2[None][..., 0], l2[None][..., 1], length[None]
        row, _ = measure(torch, "resolve_direct_fleet",
                         lambda: cr.resolve_direct_fleet_cuda(w0, w1, lens),
                         lambda: cr_ref.resolve_direct_fleet_ref(w0, w1, lens),
                         20 * n + 4, 0, None, flush, n_plain=3)
        out["resolve_direct_fleet"] = _shape_row(row, "resolve_direct_fleet",
                                                 T_C_P=[1, c, n])
        act = l2[length.item() - 1]
        planes = (fmt.entry_allocated(act).to(torch.int32),
                  fmt.entry_bfi(act).contiguous(), fmt.entry_ptr(act).contiguous())
        row, _ = measure(torch, "resolve_direct",
                         lambda: cr.resolve_direct_cuda(*planes),
                         lambda: cr_ref.resolve_direct_ref(*planes),
                         20 * n, 0, None, flush, n_plain=3)
        out["resolve_direct"] = _shape_row(row, "resolve_direct", N=n)
        _, res = mods["store"].read(ch, torch.arange(n, device=l2.device),
                                    method="direct")
        rows, ok = mods["readable_rows"](res)
        page = ch.pool.shape[1] * ch.pool.element_size()
        row, _ = measure(torch, "gather", lambda: cg.gather_cuda(ch.pool, rows, ok),
                         lambda: cg_ref.gather_ref(ch.pool, rows, ok),
                         (int(ok.sum()) + n) * page + 5 * n, 0, None, flush,
                         library=lambda: torch.index_select(ch.pool, 0, rows),
                         n_kernel=10, n_plain=3)
        out["gather"] = _shape_row(
            row, "gather", B=n, page_bytes=page,
            variant=cg.gather_variant(page).name)
    else:
        w0, lens = l2[None][..., 0], length[None]
        want = cr_ref.resolve_vanilla_fleet_ref(w0, lens)
        top = min(length.item(), c)
        walked = int(torch.where(want[0] >= 0, top - want[0], top).sum())
        hits = int((want[0] >= 0).sum())
        del want
        row, _ = measure(torch, "resolve_vanilla_fleet",
                         lambda: cr.resolve_vanilla_fleet_cuda(w0, lens),
                         lambda: cr_ref.resolve_vanilla_fleet_ref(w0, lens),
                         8 * walked + 4 + 8 * n, 0, None, flush,
                         n_kernel=20, n_plain=3)
        out["resolve_vanilla_fleet"] = _shape_row(
            row, "resolve_vanilla_fleet", T_C_P=[1, c, n], words_walked=walked,
            walk=cr.fleet_walk(1, n))
        alloc = fmt.entry_allocated(l2).to(torch.int32)
        ptrs = fmt.entry_ptr(l2).contiguous()
        row, got = measure(torch, "resolve_vanilla",
                           lambda: cr.resolve_vanilla_cuda(alloc, ptrs, length),
                           lambda: cr_ref.resolve_vanilla_ref(alloc, ptrs, length),
                           4 * (walked + hits + 1) + 8 * n, 0, None, flush,
                           n_kernel=20, n_plain=3)
        walk = k6_walk(torch, cr, alloc, got[0], length)
        require(walk["words_walked"] == walked, "K6 walked words differ from K1's")
        out["resolve_vanilla"] = _shape_row(row, "resolve_vanilla", C_N=[c, n],
                                            **walk)
    return out


def gather_sweep(torch, mods, flush, n=10):
    """K8 over ``GATHER_SWEEP``, every page found: each shape's output
    held bit-exact against the plain version, then timed in turns, twice
    (the second round kept: the first calls after the set-up run slower),
    beside ``torch.index_select`` of the same rows. Where every page of
    the pool is read once, ``copy_ms`` times the card's contiguous copy of
    the pool (``Tensor.copy_``), a ceiling for any gather of those bytes.
    The bound is each page in and out, with the indices, over 3.35 TB/s.
    It calls nothing but the wrapper and its plain version, so it times
    an earlier kernel the same way."""
    cg, cg_ref = mods["cg"], mods["cg_ref"]
    g = torch.Generator(device=DEV).manual_seed(21)
    out = []
    for label, page, pool_rows, b in GATHER_SWEEP:
        pool = torch.empty((pool_rows, page // 4), dtype=torch.float32,
                           device=DEV)
        pool.view(torch.int32).random_(generator=g)
        if b == pool_rows:
            rows = torch.randperm(pool_rows, generator=g, device=DEV)
        else:
            rows = torch.randint(0, pool_rows, (b,), generator=g, device=DEV)
        rows = rows.to(torch.int32)
        ok = torch.ones(b, dtype=torch.bool, device=DEV)
        require(torch.equal(cg.gather_cuda(pool, rows, ok).view(torch.uint8),
                            cg_ref.gather_ref(pool, rows, ok).view(torch.uint8)),
                f"gather sweep {label}: not bit-exact")
        calls = {"kernel": lambda: cg.gather_cuda(pool, rows, ok),
                 "library": lambda: torch.index_select(pool, 0, rows)}
        ms = {}
        for _ in range(2):
            for name, call in calls.items():
                ms[name] = timed_ms(torch, call, n, flush)
        copy_ms = None
        if b == pool_rows:
            # the card's own copy of the same bytes, contiguous: a ceiling
            dst = torch.empty_like(pool)
            copy_ms = timed_ms(torch, lambda: dst.copy_(pool), n, flush)
            del dst
        nbytes = 2 * b * page + 5 * b
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        out.append(dict(shape=label, page_bytes=page, B=b, pool_rows=pool_rows,
                        bytes=nbytes, bound_ms=bound, ms=ms["kernel"],
                        library_ms=ms["library"],
                        library_ratio=ms["kernel"] / ms["library"],
                        copy_ms=copy_ms, bound_share=bound / ms["kernel"],
                        library_bound_share=bound / ms["library"]))
        del pool, rows, ok, calls
        torch.cuda.empty_cache()
    return out


def _garbage_name(o, child) -> str:
    """A short name for ``o``, an object that refers to ``child``."""
    if isinstance(o, dict):
        keys = [k for k, v in o.items() if v is child][:2]
        return f"dict[{', '.join(repr(k)[:40] for k in keys)}]"
    if inspect.isfunction(o):
        return f"function {o.__qualname__}"
    if inspect.isframe(o):
        return f"frame {o.f_code.co_name}:{o.f_lineno}"
    if inspect.ismethod(o):
        return f"method {o.__func__.__qualname__}"
    t = type(o)
    attrs = [k for k, v in getattr(o, "__dict__", {}).items() if v is child][:2]
    return f"{t.__module__}.{t.__qualname__}" + (f".{attrs}" if attrs else "")


def cycle_report(torch, top=6, depth=10):
    """What the cycle collector frees now: the CUDA storages that only
    reference cycles keep alive, largest first, each with the chain of
    objects that refer to it inside the garbage (type names, a function's
    or frame's name, a dict's key), and the garbage's commonest types.
    Collected with ``DEBUG_SAVEALL`` so the garbage can be read; then
    dropped, so the caller's ``gc.collect()`` frees it."""
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        garbage = list(gc.garbage)
        gc.garbage.clear()
    finally:
        gc.set_debug(0)
    inside = {id(o) for o in garbage}
    parents = collections.defaultdict(list)
    for o in garbage:
        for r in gc.get_referents(o):
            if id(r) in inside:
                parents[id(r)].append(o)
    storages = {}
    for o in garbage:
        if isinstance(o, torch.Tensor) and o.is_cuda:
            s = o.untyped_storage()
            storages.setdefault(s.data_ptr(), (s.nbytes(), o))
    held = []
    for nbytes, t in sorted(storages.values(), key=lambda x: -x[0])[:top]:
        chain, node, seen = [], t, {id(t)}
        for _ in range(depth):
            up = next((p for p in parents[id(node)] if id(p) not in seen), None)
            if up is None:
                break
            chain.append(_garbage_name(up, node))
            seen.add(id(up))
            node = up
        held.append(dict(GB=nbytes / 1e9, shape=list(t.shape), dtype=str(t.dtype),
                         referrers=chain))
    report = dict(garbage_objects=len(garbage),
                  garbage_cuda_GB=sum(n for n, _ in storages.values()) / 1e9,
                  largest=held,
                  types=collections.Counter(
                      type(o).__qualname__ for o in garbage).most_common(12))
    return report


def collect_cycles(torch, line):
    """A phase's start: ``cycle_report``, then ``gc.collect()``, both on
    ``line``. What the collection frees must be under 1 GB of device
    memory: no reference cycle holds an earlier phase's tensors."""
    held = torch.cuda.memory_allocated()
    cycles = cycle_report(torch)
    gc.collect()
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    line({"held_GB_at_start": at_start / 1e9,
          "held_GB_before_collect": held / 1e9, "cycles": cycles})
    require(held - at_start < 1e9,
            f"{(held - at_start) / 1e9:.2f} GB sat in reference cycles")


def _index_chain(torch, mods, disk, device=None):
    """A phase-6 disk's index tables on ``device`` (``DEV`` by default),
    with no pool: all the cache model reads."""
    device = device or DEV
    return mods["chain"].Chain(
        spec=disk["spec"], scalable=disk["scalable"], l1=disk["l1"].to(device),
        l2=disk["l2"].to(device),
        pool=torch.empty((0, disk["spec"].page_size), device=device),
        pool_cursor=torch.zeros((), dtype=torch.int32, device=device),
        length=torch.tensor(disk["length"], dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        snap_dropped=torch.zeros((), dtype=torch.bool, device=device))


def lru_oracle(disk, pages, n_slots, unified):
    """Slice fetches per request of the Qcow2 caches, on the host from the
    raw words: one ``OrderedDict`` LRU per file. A request probes the
    active volume down to the first file holding its page allocated (the
    whole chain on a miss; sQEMU: the active volume only); a probe that
    finds the slice refreshes it; a miss fetches where the file holds the
    slice's L2 table (sQEMU: always), evicting the least recently used."""
    spec, length = disk["spec"], disk["length"]
    l1 = disk["l1"].numpy()[:length] != 0
    w0 = disk["l2"].numpy()[:length, pages, 0].view(np.uint32)
    alloc = (w0 & np.uint32(1 << 31)) != 0                       # (L, R)
    caches = [collections.OrderedDict() for _ in range(length)]
    misses = []
    for r, p in enumerate(pages.tolist()):
        s = p // spec.slice_len
        if unified:
            files = [length - 1]
        else:
            hit = np.nonzero(alloc[:, r])[0]
            low = int(hit[-1]) if hit.size else 0
            # a file without the slice's L2 table never caches the slice
            on_disk = l1[low:, p // spec.l2_per_table]
            files = (np.nonzero(on_disk)[0] + low).tolist()
        m = 0
        for f in files:
            cache = caches[f]
            if s in cache:
                cache.move_to_end(s)
                continue
            m += 1
            if len(cache) >= n_slots:
                cache.popitem(last=False)
            cache[s] = True
        misses.append(m)
    return np.asarray(misses, np.int32)


def _simulate(torch, mods, chain, pages, n_slots):
    """One format's simulation: vQemu's per-file caches on the vanilla
    disk, sQEMU's unified cache on the scalable one; ms a request on the
    host clock."""
    cache = mods["cache"]
    sim = cache.simulate_unified if chain.scalable else cache.simulate_vanilla
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = sim(chain, pages, n_slots)
    torch.cuda.synchronize()
    return trace, 1e3 * (time.perf_counter() - t0) / pages.numel()


def cache_phase(torch, mods, indexes):
    """10b: the Qcow2 slice-cache model (Figs 13, 14, 16) on phase 6's
    depth-500 disks, checked against the resolvers, a host LRU oracle and
    the same simulation on the CPU."""
    cache, metrics, resolve = mods["cache"], mods["metrics"], mods["resolve"]
    setup = mods["paper_chain"].SETUP
    disks = indexes["disks"]
    spec = disks["vanilla"]["spec"]
    slots = setup.default_l2_cache_bytes // (spec.slice_len * 8)   # 1 MiB
    streams = dict(sequential=torch.arange(SIM_SWEEP, device=DEV),
                   random=indexes["ycsb"].to(DEV))
    lines = {}
    for name, disk in disks.items():
        chain = _index_chain(torch, mods, disk)
        for sname, pages in streams.items():
            trace, ms = _simulate(torch, mods, chain, pages, slots)
            lat = metrics.trace_latencies(trace).cpu().numpy()
            summary = cache.summarize(trace)
            n_req = pages.numel()
            # the kernel resolvers (K1 walk, K2 direct) as the reference
            with uncounted(mods["_build"]):
                res = resolve.get_resolver(
                    "pallas_direct" if disk["scalable"] else "pallas_vanilla")(
                        chain, pages)
            if disk["scalable"]:
                require(summary["probes"] == n_req, "unified probes != requests")
            else:
                require(summary["probes"] == int(res.lookups.sum()),
                        "vanilla probes differ from the walk's lookups")
            require(summary["hits"] == int(res.found.sum()), f"{name} hits != found")
            require(int(trace.hist.sum()) == summary["probes"], "hist != probes")
            if sname == "random":
                oracle = lru_oracle(disk, pages.cpu().numpy(), slots,
                                    disk["scalable"])
                require(np.array_equal(trace.misses.cpu().numpy(), oracle),
                        f"{name}: misses differ from the host LRU oracle")
                ref, _ = _simulate(torch, mods, _index_chain(torch, mods, disk, "cpu"),
                                   pages[:SIM_PREFIX].cpu(), slots)
                require(all(torch.equal(a[:SIM_PREFIX].cpu(), b)
                            for a, b in zip(trace[:5], ref[:5])),
                        f"{name}: the card's first {SIM_PREFIX} requests differ "
                        "from the CPU's")
            lines[f"{name}/{sname}"] = dict(
                n_slots=slots, requests=n_req, **summary,
                lat_mean_us=float(lat.mean()) * 1e6,
                lat_p99_us=float(np.percentile(lat, 99)) * 1e6,
                ms_per_request=ms, hist_nonzero_files=int((trace.hist > 0).sum()))
        del chain
    _paper(dict(part="fig13_fig14", chain_length=disks["vanilla"]["length"],
                n_pages=spec.n_pages, slice_len=spec.slice_len,
                cache_bytes_per_file=setup.default_l2_cache_bytes,
                checks=["vanilla probes = walk lookups", "unified probes = R",
                        "hits = found", "misses = host LRU oracle (random)",
                        f"first {SIM_PREFIX} requests = CPU (random)"],
                traces=lines), mods)
    # Fig 16: the equal-memory protocol on the random stream
    pages = streams["random"]
    n_req = pages.numel()
    chains = {n: _index_chain(torch, mods, d) for n, d in disks.items()}
    length = disks["vanilla"]["length"]
    fig16 = []
    for frac in setup.cache_fracs:
        s_slots = int(frac * spec.n_slices)
        per_file = max(1, s_slots // length)
        tv, ms_v = _simulate(torch, mods, chains["vanilla"], pages, per_file)
        tu, ms_u = _simulate(torch, mods, chains["scalable"], pages, s_slots)
        if frac == min(setup.cache_fracs):
            for t, d, k in ((tv, disks["vanilla"], per_file),
                            (tu, disks["scalable"], s_slots)):
                require(np.array_equal(t.misses.cpu().numpy(), lru_oracle(
                    d, pages.cpu().numpy(), k, d["scalable"])),
                        "fig16: misses differ from the host LRU oracle")
        lv = float(metrics.trace_latencies(tv).sum())
        lu = float(metrics.trace_latencies(tu).sum())
        fig16.append(dict(cache_frac=frac, unified_slots=s_slots,
                          vanilla_slots_per_file=per_file,
                          vanilla_misses=int(tv.misses.sum()),
                          unified_misses=int(tu.misses.sum()),
                          vanilla_iops=n_req / lv, unified_iops=n_req / lu,
                          speedup=lv / lu, vanilla_ms_per_request=ms_v,
                          unified_ms_per_request=ms_u))
    del chains
    _paper(dict(part="fig16", requests=n_req, n_slices=spec.n_slices,
                chain_length=length, model_not_card_numbers=True,
                oracle_checked_at=min(setup.cache_fracs), points=fig16), mods)
    return lines, fig16


def paper_models(torch, mods, spec):
    """10c: Fig 12's cache-memory model and Eq. 2 (models, not card
    numbers)."""
    cache, metrics = mods["cache"], mods["metrics"]
    claims = mods["paper_chain"].headline_claims()
    fig12 = {}
    for n in FIG12_LENGTHS:
        v = cache.cache_memory_bytes(spec, FIG12_SLOTS, n, unified=False)
        u = cache.cache_memory_bytes(spec, FIG12_SLOTS, n, unified=True)
        fig12[n] = dict(vanilla_bytes=v, unified_bytes=u, reduction=v / u)
    require(fig12[1000]["reduction"] > fig12[500]["reduction"] > 10,
            "fig12: the per-file caches must cost more with chain length")
    _paper(dict(part="fig12_eq2", model_not_card_numbers=True,
                slots=FIG12_SLOTS, fig12=fig12,
                reduction_at_500=fig12[500]["reduction"],
                paper_reduction_at_500=claims["memory_reduction_at_500"],
                reduction_at_1000=fig12[1000]["reduction"],
                paper_reduction_at_1000=claims["memory_reduction_at_1000"],
                eq2_overhead_bytes_50GB=metrics.eq2_snapshot_overhead_bytes(50 * 2**30),
                paper_overhead_bytes_50GB=claims["snapshot_overhead_bytes_50gb"]),
          mods)


# -- phase 11: the rest of the decoder-only family ---------------------------


MOE_RANGES = {"expert products": ("moe.expert_products",),
              "shared expert": ("moe.shared_expert",),
              "dispatch/combine": ("moe.route", "moe.aux_loss", "moe.dispatch",
                                   "moe.combine")}
MOE_GROUPS = {k: v for k, v in SERVE_GROUPS.items() if k != "matmul"}


def _families(obj, mods):
    """A phase-11 line: the card's name and power limit beside its numbers."""
    emit({**obj, "phase": "families", "card": mods["smi"]})


def param_breakdown(cfg) -> dict:
    """Every parameter of ``cfg``'s model by kind: ``param_count()`` (the
    matrices and the router), then the norms, QKV biases, qk-norm weights
    and shared-expert gates it leaves out; ``exact`` is their sum."""
    d, hd, n = cfg.d_model, cfg.hd, cfg.n_layers
    parts = dict(
        param_count=cfg.param_count(),
        norms=n * 2 * d + d,
        qkv_biases=n * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) if cfg.qkv_bias else 0,
        qk_norms=n * 2 * hd if cfg.qk_norm else 0,
        shared_gates=n * d if cfg.is_moe and cfg.n_shared_experts else 0,
    )
    parts["exact"] = sum(parts.values())
    return parts


@contextlib.contextmanager
def moe_ranges(torch, mods, ranges):
    """While inside, each MoE step that ``ranges`` names (``moe.<name>``)
    runs under a ``torch.profiler.record_function`` of that name, so a
    profile can read the device time of the kernels it launched. Nothing
    is wrapped when ``ranges`` is None."""
    moe = mods["moe"]
    names = [r.removeprefix("moe.") for rs in (ranges or {}).values() for r in rs]
    saved = {name: getattr(moe, name) for name in names}

    def ranged(name, fn):
        def call(*args):
            with torch.profiler.record_function(f"moe.{name}"):
                return fn(*args)
        return call

    try:
        for name, fn in saved.items():
            setattr(moe, name, ranged(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


@contextlib.contextmanager
def moe_inputs(mods):
    """While inside, every ``moe_apply`` call's input (cloned) and layer
    weights are recorded, in call order: one pass of a model gives one
    entry a layer."""
    moe = mods["moe"]
    apply, seen = moe.moe_apply, []

    def recording(cfg, p, x):
        seen.append((x.clone(), p))
        return apply(cfg, p, x)

    moe.moe_apply = recording
    try:
        yield seen
    finally:
        moe.moe_apply = apply


def attention_pair(torch, mods, cfg, s, flush):
    """K3 and K4 on an engine's own layer-0 state (``capture_state``) at
    ``cfg``'s heads: each held against its plain version (bf16 2e-2) and
    the two bitwise against each other, timed beside its bound and beside
    ``scaled_dot_product_attention`` over each row's K/V gathered dense
    with a length mask (``dense_sdpa_ms``, a yardstick)."""
    pa, pa_ref, _build = mods["pa"], mods["pa_ref"], mods["_build"]
    pool_k, pool_v = s["pool_k"], s["pool_v"]
    nb, bs, hkv, d = pool_k.shape
    b = s["tables"].shape[0]
    g = torch.Generator(device=DEV).manual_seed(11)
    q = torch.randn((b, cfg.n_heads, d), generator=g, device=DEV).to(pool_k.dtype)
    w0, cl, tn, lens = s["w0"], s["chain_lengths"], s["tenants"], s["lengths"]
    tables_h, len_h = s["tables"].cpu().numpy(), lens.cpu().numpy()
    nbytes, ops, kv_bytes, qo_bytes, nblk = attention_cost(
        tables_h, len_h, bs, hkv, d, pool_k.element_size(), cfg.n_heads)
    k4_bytes = kv_bytes + qo_bytes + walk_cost(
        w0.cpu().numpy(), cl.cpu().numpy(), tn.cpu().numpy(), nblk,
        mods["fmt"].FLAG_ALLOCATED_I32)
    m = int(len_h.max())
    blocks = s["tables"][:, : -(-m // bs)].clamp(min=0).long()
    kd, vd = (x[blocks].reshape(b, -1, hkv, d)[:, :m].transpose(1, 2).contiguous()
              for x in (pool_k, pool_v))
    mask = (torch.arange(m, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

    def dense():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True)

    runs = {
        "paged_attention": (
            lambda: pa.paged_attention_cuda(q, pool_k, pool_v, s["tables"], lens),
            lambda: pa_ref.paged_attention_ref(q, pool_k, pool_v, s["tables"], lens),
            nbytes, pa.plan(b, cfg.n_heads, hkv, s["tables"].shape[1], bs, q.dtype,
                            pa.sm_count(q.device))),
        "fused_chain_attention": (
            lambda: pa.fused_chain_attention_cuda(q, pool_k, pool_v, w0, cl, tn, lens),
            lambda: pa_ref.fused_chain_attention_ref(q, pool_k, pool_v, w0, cl, tn,
                                                     lens),
            k4_bytes, pa.plan(b, cfg.n_heads, hkv, w0.shape[2], bs, q.dtype,
                              pa.sm_count(q.device))),
    }
    out, got = {}, {}
    with uncounted(_build):
        dense_ms = timed_ms(torch, dense, 50, flush)
        for name, (kern, plain, nb_, plan) in runs.items():
            row, got[name] = measure(torch, name, kern, plain, nb_, ops, 2e-2, flush)
            out[name] = dict(batch=b, heads=[cfg.n_heads, hkv], head_dim=d,
                             kv_lengths=len_h.tolist(), ms=row["ms"],
                             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                             bound_by=row["bound_by"], max_abs_err=row["max_abs_err"],
                             dense_sdpa_ms=dense_ms,
                             **plan_report(plan, len_h, bs, plan.splits
                                           * plan.pages_per_split))
    require(torch.equal(got["paged_attention"][0], got["fused_chain_attention"][0]),
            f"{cfg.name}: K3 and K4 differ on the engine's rows")
    return out


def moe_check(torch, mods, cfg, x, p, what):
    """One layer's MoE input from a real pass, on the card in bf16 against
    the CPU in f32 with that layer's weights. The card's router logits
    (bf16) must lie within bf16's resolution of the f32 ones: 2^-7 of the
    row's largest magnitude, plus 1e-3 for the order of the f32 sums. A
    row whose k-th and (k+1)-th f32 logits are no further apart than twice
    its largest logit error may rank them either way: it is a near tie,
    counted and left out. Elsewhere the routed experts must agree, and so
    must each (token, expert) assignment's kept or dropped status, except
    where a near tie moved an expert's load (a cascade: that expert's
    later tokens shift a rank); the outputs of the other rows within
    ``MOE_REL_TOL`` relative L2."""
    moe = mods["moe"]
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(t, cfg)

    def run(x, p):
        xt = x.reshape(1, t, d)
        _, _, top_i = moe.route(cfg, p, xt)
        slot = moe.dispatch(xt, top_i, e, cap)[1]
        member = torch.zeros((t, e), dtype=torch.bool, device=x.device)
        kept = torch.zeros((t, e), dtype=torch.bool, device=x.device)
        member.scatter_(1, top_i[0], True)
        kept.scatter_(1, top_i[0], (slot[0] < e * cap).reshape(t, k))
        out = moe.moe_apply(cfg, p, x)[0].reshape(t, d)
        return member.cpu(), kept.cpu(), out.float().cpu()

    def f32_cpu(v):
        if isinstance(v, dict):
            return {n: f32_cpu(w) for n, w in v.items()}
        return v.to("cpu").float()

    p_cpu, x_cpu = f32_cpu(p), f32_cpu(x)
    member_card, kept_card, out_card = run(x, p)
    member_cpu, kept_cpu, out_cpu = run(x_cpu, p_cpu)
    logits = x_cpu.reshape(t, d) @ p_cpu["router"]
    err = ((x.reshape(t, d) @ p["router"]).float().cpu() - logits).abs().amax(-1)
    top = logits.abs().amax(-1)
    require(bool((err <= 2.0 ** -7 * top + 1e-3).all()),
            f"{what}: router logits off by {float(err.max())} (largest {float(top.max())})")
    ranked = logits.sort(dim=-1, descending=True).values
    near = ranked[:, k - 1] - ranked[:, k] <= 2 * err
    same = (member_card == member_cpu).all(dim=-1)
    require(bool(same[~near].all()),
            f"{what}: {int((~same & ~near).sum())} rows routed differently "
            "beyond a near tie")
    flipped = (member_card != member_cpu)[near].any(dim=0)            # (E,)
    kept_diff = (kept_card != kept_cpu) & ~near[:, None]
    require(not bool((kept_diff & ~flipped[None, :]).any()),
            f"{what}: a kept/dropped assignment differs at an expert no near "
            "tie moved")
    cascade = kept_diff.any(dim=-1)
    rows = ~near & ~cascade
    want = out_cpu[rows]
    rel = float((out_card[rows] - want).norm() / want.norm())
    require(rel <= MOE_REL_TOL, f"{what}: MoE output relative L2 {rel}")
    require(bool(torch.isfinite(out_card).all()), f"{what}: MoE output not finite")
    return dict(input=what, tokens=t, capacity=cap, near_tie_rows=int(near.sum()),
                max_logit_err=float(err.max()), max_logit=float(top.max()),
                cascade_rows=int(cascade.sum()), rows_compared=int(rows.sum()),
                rel_l2=rel, max_abs_err=float((out_card[rows] - want).abs().max()),
                rel_tol=MOE_REL_TOL,
                dropped_card=int((member_card & ~kept_card).sum()),
                dropped_cpu=int((member_cpu & ~kept_cpu).sum()))


def dropped_assignments(torch, mods, cfg, inputs):
    """Dropped (token, k) assignments in each layer of one pass (untimed)."""
    moe = mods["moe"]
    out = []
    for x, p in inputs:
        t = x.shape[0] * x.shape[1]
        cap = moe.capacity(t // cfg.dispatch_groups, cfg)
        xt = x.reshape(cfg.dispatch_groups, -1, cfg.d_model)
        slot = moe.dispatch(xt, moe.route(cfg, p, xt)[2], cfg.n_experts, cap)[1]
        out.append(int((slot == cfg.n_experts * cap).sum()))
    return out


def _init_full(torch, mods, cfg):
    """``cfg``'s bf16 weights drawn on the card from seed 0, every parameter
    counted: (params, the init line's numbers)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mods["init_params"](cfg, torch.Generator(device=DEV).manual_seed(0),
                                 device=DEV, dtype=mods["layers"].COMPUTE_DTYPE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    parts = param_breakdown(cfg)
    n = sum(x.numel() for x in leaves)
    require(n == parts["exact"], f"{cfg.name}: {n} parameters, {parts['exact']} "
            "expected")
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    # a decode step reads every weight but the embedding table (a row a token)
    read = nbytes - params["embed"].numel() * params["embed"].element_size()
    return params, dict(model=cfg.name, n_layers=cfg.n_layers, params=n, **parts,
                        weights_GB=nbytes / 1e9, init_seconds=init_s,
                        init_peak_GB=(torch.cuda.max_memory_allocated() - base) / 1e9,
                        init_extra_GB=(torch.cuda.max_memory_allocated() - base
                                       - nbytes) / 1e9,
                        weight_read_bound_ms=1e3 * read / HBM_BYTES_PER_S)


def _prompts(cfg):
    """Phase 4's prompt lengths, ids drawn from ``cfg``'s vocabulary."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in PROMPT_LENGTHS]


def moe_serve(torch, mods, flush):
    """11b: Qwen2-MoE-A2.7B at full width and depth on the four engines,
    K3/K4 at its state and the long context, golden admission, the drops
    at the suffix bucket and the full-width MoE check. Returns the main
    paths' launches and K3/K4's shapes."""
    cfg = mods["get_config"](MOE_ARCH)
    prompts = _prompts(cfg)                     # phase 4's: the same vocabulary
    params, init = _init_full(torch, mods, cfg)
    _families({"part": "init", **init}, mods)
    tag = {"phase": "families", "card": mods["smi"], "model": cfg.name}
    results, state = serve_phase(torch, mods, cfg, params, prompts, tag=tag,
                                 groups=MOE_GROUPS, ranges=MOE_RANGES)
    launches = collections.Counter()
    for r in results.values():
        launches.update(r["launches"])
    shapes = {"engine_state": attention_pair(torch, mods, cfg, state, flush)}
    del state
    long = long_context(torch, mods, flush, cfg=cfg,
                        line=lambda o: _families({**o, "part": "long_context"}, mods))
    admitted, suffix = golden_admission(torch, mods, cfg, params,
                                        line=lambda o: _families(o, mods))
    launches.update(admitted)

    # one decode step (the padded 8 rows) and the 200-token admission (the
    # 256-row bucket) again, their MoE inputs recorded; a check's launches
    with uncounted(mods["_build"]):
        eng = _engine(mods, cfg, params, scalable=False, path="tables")
        sids = [eng.add_request(p) for p in prompts]
        eng.fork_request(sids[0])
        eng.fork_request(sids[1])
        with moe_inputs(mods) as decode:
            eng.step()
        rng = np.random.default_rng(9)          # golden_admission's prompts
        golden = rng.integers(0, cfg.vocab_size, GOLDEN_PROMPT)
        tail = rng.integers(0, cfg.vocab_size, max(GOLDEN_EXTENSIONS))
        gsid = eng.register_golden(golden)
        with moe_inputs(mods) as admit:
            eng.add_request(np.concatenate([golden, tail]))
        require(eng.golden_hits == 1, "the extension did not fork the golden")
        eng.release_golden(gsid)
        for s in sorted(eng.active):
            eng.finish_request(s)
        require(eng.kv.blocks_in_use() == 0, "capture engine: blocks leaked")
        del eng
        require(len(decode) == len(admit) == cfg.n_layers, "one MoE input a layer")
        require(tuple(decode[0][0].shape[:2]) == (8, 1)
                and tuple(admit[0][0].shape[:2]) == (1, 256), "captured shapes")
        drops = {"decode_8_rows": dropped_assignments(torch, mods, cfg, decode),
                 "suffix_256_rows": dropped_assignments(torch, mods, cfg, admit)}
        _families({"part": "drops", "model": cfg.name, "top_k": cfg.top_k,
                   "capacity": {"decode_8_rows": mods["moe"].capacity(8, cfg),
                                "suffix_256_rows": mods["moe"].capacity(256, cfg)},
                   "assignments_per_layer": {"decode_8_rows": 8 * cfg.top_k,
                                             "suffix_256_rows": 256 * cfg.top_k},
                   "dropped_by_layer": drops,
                   "dropped_total": {k: sum(v) for k, v in drops.items()}}, mods)
        for what, inputs in (("decode_8_rows", decode), ("suffix_256_rows", admit)):
            x, p = inputs[MOE_CHECK_LAYER]
            _families({"part": "moe_check", "model": cfg.name,
                       "layer": MOE_CHECK_LAYER,
                       **moe_check(torch, mods, cfg, x, p, what)}, mods)
        del decode, admit
    del params
    torch.cuda.empty_cache()
    shapes["long_context"] = long
    return launches, shapes, suffix


def dense_family(torch, mods, flush):
    """11c: each of ``FAMILY_DEPTHS`` at full width (the depth cut where
    the model does not fit one card whole) on a vanilla engine of 256
    blocks, tables then fused path, 8 timed steps each: the same tokens
    on both paths, ms a step, and K3/K4 at its head layout. Returns the
    runs' launches and K3/K4's shapes."""
    _build, Engine = mods["_build"], mods["Engine"]
    launches, shapes = collections.Counter(), {}
    for arch, depth in FAMILY_DEPTHS:
        full = mods["get_config"](arch)
        cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
        prompts = _prompts(cfg)
        params, init = _init_full(torch, mods, cfg)
        tokens, state, per_path = {}, None, {}
        for path in ("tables", "fused"):
            _build.reset_launches()
            eng = Engine(cfg, params, scalable=False, n_blocks=FAMILY_POOL,
                         block_size=16, max_blocks_per_seq=128, resolver="auto",
                         decode_path=path)
            sids = [eng.add_request(p) for p in prompts]
            eng.fork_request(sids[0])
            eng.fork_request(sids[1])
            eng.step()                                  # warm-up
            ms = []
            for _ in range(FAMILY_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                eng.step()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            run = dict(_build.LAUNCHES)                 # read just after the run
            attn = "paged_attention" if path == "tables" else "fused_chain_attention"
            for kname in ("resolve_vanilla_fleet", attn):
                require(run[kname] > 0, f"{arch} {path}: {kname} never launched")
            launches.update(run)
            tokens[path] = {s: list(t) for s, t in eng.active.items()}
            if path == "fused":
                state = capture_state(torch, eng)
            batch = len(eng.active)
            for s in sorted(eng.active):
                eng.finish_request(s)
            require(eng.kv.blocks_in_use() == 0, f"{arch} {path}: blocks leaked")
            per_path[path] = dict(ms_per_step=float(np.mean(ms)),
                                  ms_min=float(np.min(ms)), ms_max=float(np.max(ms)),
                                  tokens_per_s=batch * 1000.0 / float(np.mean(ms)),
                                  launches=run)
            del eng
        require(tokens["tables"] == tokens["fused"],
                f"{arch}: tables and fused paths emitted different tokens")
        pair = attention_pair(torch, mods, cfg, state, flush)
        shapes[arch] = pair
        _families({"part": "dense", **init, "of_layers": full.n_layers,
                   "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
                   "pool_blocks": FAMILY_POOL, "batch": batch,
                   "steps_timed": FAMILY_STEPS, "paths": per_path,
                   "tables_equal_fused_tokens": True,
                   "k3_ms": pair["paged_attention"]["ms"],
                   "k4_ms": pair["fused_chain_attention"]["ms"],
                   "k3_bound_ms": pair["paged_attention"]["bound_ms"],
                   "dense_sdpa_ms": pair["paged_attention"]["dense_sdpa_ms"]}, mods)
        del params, state
        torch.cuda.empty_cache()
    return launches, shapes


def families_phase(torch, mods, flush):
    """11: (a) the smoke configs of ``FAMILY_SMOKE`` card against CPU, (b)
    Qwen2-MoE-A2.7B at full width, (c) the dense variants. Returns the
    main paths' launches and K3/K4's shapes by model."""
    t0 = time.perf_counter()
    for arch in FAMILY_SMOKE:
        reference_phase(torch, mods, arch, golden=mods["smoke_config"](arch).is_moe,
                        line=lambda o: _families({**o, "part": "reference"}, mods))
    _families({"part": "reference", "seconds": time.perf_counter() - t0}, mods)
    t0 = time.perf_counter()
    launches, moe_shapes, suffix = moe_serve(torch, mods, flush)
    _families({"part": "moe", "seconds": time.perf_counter() - t0}, mods)
    t0 = time.perf_counter()
    dense_launches, dense_shapes = dense_family(torch, mods, flush)
    _families({"part": "dense", "seconds": time.perf_counter() - t0}, mods)
    launches.update(dense_launches)
    shapes = {name: {MOE_ARCH: {"engine_state": moe_shapes["engine_state"][name],
                                "long_context": moe_shapes["long_context"][name]},
                     **{arch: pair[name] for arch, pair in dense_shapes.items()}}
              for name in ("paged_attention", "fused_chain_attention")}
    shapes["paged_attention"][MOE_ARCH]["suffix_shape"] = suffix
    return launches, shapes


# -- phase 12: training on the snapshot-checkpoint chain ---------------------


def _train(obj, mods):
    """A phase-12 line: the card's name and power limit beside its numbers."""
    emit({**obj, "phase": "train", "card": mods["smi"]})


def _rel(torch, got, want) -> float:
    """Relative L2 of ``got`` against ``want``, on the host in f64."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _events_ms(torch, fn):
    """``fn()`` timed by CUDA events: (its result, ms)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


TRAIN_ATTENTION, TRAIN_ADAMW = "train.attention", "train.adamw"
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def train_flops(cfg, seq, batch) -> dict:
    """One training step's operations, counted from the shapes: ``model``
    is 6·N·T for the N matrix parameters (every layer's and ``w_out``; the
    embedding is a lookup) plus the attention's two S x S products
    forward and backward (3x forward); ``total`` adds the per-layer
    recompute (remat: the layers' forward again). The score product QK^T
    runs in f32 (``attention_ref`` scores in f32, TF32 off): its forward,
    recompute and two backward products are ``f32``; the rest is bf16."""
    t = seq * batch
    d, hd = cfg.d_model, cfg.hd
    attn_w = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    layer_w = cfg.n_layers * (attn_w + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff)
    n_matrix = layer_w + d * cfg.vocab_size
    product = 2 * batch * seq * seq * cfg.n_heads * hd      # one S x S product
    model = 6 * n_matrix * t + cfg.n_layers * 6 * product
    remat = (2 * layer_w * t + cfg.n_layers * 2 * product) if cfg.remat else 0
    f32 = cfg.n_layers * (4 if cfg.remat else 3) * product
    return dict(matrix_params=n_matrix, model=model, total=model + remat,
                bf16=model + remat - f32, f32=f32)


def _kernel_ms(event):
    """The device kernels a profiled CPU op launched: (name, ms) each."""
    return [(k.name, k.duration / 1e3) for k in event.kernels]


def _is_matmul(kernel_name):
    return any(g in kernel_name.lower() for g in GEMM_NAMES)


def train_profile(torch, mods, run):
    """One call of ``run`` under torch.profiler, its device time split into
    matmuls, attention, AdamW and the rest. ``attention_ref`` and
    ``adamw.apply`` run under ``record_function`` ranges for the call; a
    kernel launched under the AdamW range is AdamW's, under the attention
    range (the forward and the remat recompute) or by a backward op whose
    forward op ran there (matched by sequence number and thread) the
    attention's; of the rest, GEMM kernels are matmuls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    L, adamw = mods["layers"], mods["adamw"]
    attention_ref, apply = L.attention_ref, adamw.apply

    def ranged(name, fn):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    L.attention_ref = ranged(TRAIN_ATTENTION, attention_ref)
    adamw.apply = ranged(TRAIN_ADAMW, apply)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        L.attention_ref, adamw.apply = attention_ref, apply
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]

    def ranges_of(e):
        names = set()
        while e is not None:
            names.add(e.name)
            e = e.cpu_parent
        return names

    attn_fwd = {(e.sequence_nr, e.thread) for e in cpu
                if e.sequence_nr >= 0 and TRAIN_ATTENTION in ranges_of(e)}

    def attn_bwd(e):
        while e is not None:
            if "Backward" in e.name and (e.sequence_nr, e.fwd_thread) in attn_fwd:
                return True
            e = e.cpu_parent
        return False

    groups = dict(matmuls=0.0, attention=0.0, adamw=0.0, other=0.0)
    matched = 0
    for e in cpu:
        spent = _kernel_ms(e)
        if not spent:
            continue
        names = ranges_of(e)
        group = ("adamw" if TRAIN_ADAMW in names else
                 "attention" if TRAIN_ATTENTION in names else None)
        if group is None and attn_bwd(e):
            group, matched = "attention", matched + 1
        for name, ms in spent:
            groups[group or ("matmuls" if _is_matmul(name) else "other")] += ms
    del prof, cpu
    gc.collect()
    return dict(device_ms_by_group=groups, device_ms=sum(groups.values()),
                attention_backward_ops_matched=matched)


def train_full(torch, mods):
    """12a: Qwen2.5-3B whole at full width, f32 params, bf16 compute, remat:
    one warm-up step and ``TRAIN_TIMED`` steps of ``make_train_step`` on
    ``batch_at``'s 4,096-token sequences, each timed by CUDA events, then
    one profiled step. Its attention alone (one layer's ``attention_ref``
    forward and backward at the step's shape) is timed beside it."""
    cfg = mods["get_config"](TRAIN_ARCH)
    model = mods["get_model"](cfg)
    leaves, adamw = mods["tree"].leaves, mods["adamw"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    opt = adamw.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in leaves(params))
    require(n_params == param_breakdown(cfg)["exact"], "train: parameter count")
    require(all(x.dtype == torch.float32 for x in leaves(params)), "train: f32 params")
    dcfg = mods["DataConfig"](vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH)
    step = mods["make_train_step"](model, adamw.AdamWConfig())
    state = [params, opt]
    del params, opt

    def one(batch):
        state[0], state[1], met = step(state[0], state[1], batch)
        return met

    def batch_at(i):
        return mods["batch_at"](dcfg, i, device=DEV)

    losses = [float(one(batch_at(0))["loss"])]          # warm-up
    ms = []
    for i in range(1, 1 + TRAIN_TIMED):
        batch = batch_at(i)                     # drawn on the host, outside
        met, t = _events_ms(torch, lambda: one(batch))
        ms.append(t)
        losses.append(float(met["loss"]))
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    require(int(state[1]["step"]) == 1 + TRAIN_TIMED, "train: optimizer step")
    peak = torch.cuda.max_memory_allocated()
    batch = batch_at(1 + TRAIN_TIMED)
    prof = train_profile(torch, mods, lambda: one(batch))
    attn = _attention_alone(torch, mods, cfg)
    del state
    torch.cuda.empty_cache()
    fl = train_flops(cfg, TRAIN_SEQ, TRAIN_BATCH)
    step_ms = float(np.mean(ms))
    state_bytes = 16 * n_params
    adamw_bytes = 28 * n_params          # p, m, v read and written, g read
    ops_ms = 1e3 * (fl["bf16"] / BF16_FLOPS + fl["f32"] / F32_FLOPS)
    line = dict(part="full", model=cfg.name, n_layers=cfg.n_layers,
                d_model=cfg.d_model, params=n_params, param_dtype="float32",
                compute_dtype=str(mods["layers"].COMPUTE_DTYPE), remat=cfg.remat,
                seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                state_GB=state_bytes / 1e9, init_seconds=init_s,
                losses=losses, ms_per_step=step_ms, ms_min=min(ms), ms_max=max(ms),
                tokens_per_s=TRAIN_SEQ * TRAIN_BATCH * 1e3 / step_ms,
                peak_GB=peak / 1e9, flops=fl,
                model_flops_share_of_bf16_peak=fl["model"] / (step_ms / 1e3) / BF16_FLOPS,
                bound_ms=max(ops_ms, 1e3 * adamw_bytes / HBM_BYTES_PER_S),
                bound_by=("operations" if ops_ms > 1e3 * adamw_bytes / HBM_BYTES_PER_S
                          else "bytes"),
                ops_bound_ms=ops_ms,
                ops_bound_all_bf16_ms=1e3 * fl["total"] / BF16_FLOPS,
                adamw_bytes_bound_ms=1e3 * adamw_bytes / HBM_BYTES_PER_S,
                profile=prof, attention_alone=attn)
    _train(line, mods)
    return line


def _attention_alone(torch, mods, cfg):
    """One layer's ``attention_ref`` at the 12a step's shape, forward and
    forward + backward, timed by CUDA events (no flush: a layer's q, k and
    v are made just before), and the step's share: each layer runs the
    forward twice (remat) and the backward once."""
    L = mods["layers"]
    g = torch.Generator(device=DEV).manual_seed(5)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    q = torch.randn(shape + (cfg.n_heads, cfg.hd), generator=g, device=DEV).to(L.COMPUTE_DTYPE)
    k = torch.randn(shape + (cfg.n_kv_heads, cfg.hd), generator=g, device=DEV).to(L.COMPUTE_DTYPE)
    v = torch.randn_like(k)
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    dout = torch.randn_like(q)

    def fwd():
        with torch.no_grad():
            return L.attention_ref(q, k, v, causal=True)

    def fwd_bwd():
        out = L.attention_ref(q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), dout)

    def timed(fn, n=3):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    f, fb = timed(fwd), timed(fwd_bwd)
    return dict(forward_ms=f, forward_backward_ms=fb,
                step_ms=cfg.n_layers * (f + fb) if cfg.remat else cfg.n_layers * fb)


@contextlib.contextmanager
def timed_saves(torch, ck):
    """Each ``ck.save`` inside, synchronized and timed on the host clock:
    the list of its stats with ``ms``. The wrapper is an attribute of
    ``ck`` closing over ``ck``'s bound method, a reference cycle: it is
    deleted on the way out."""
    out, save = [], ck.save

    def timed(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = save(state)
        torch.cuda.synchronize()
        out.append(dict(ms=1e3 * (time.perf_counter() - t0), **st))
        return st

    ck.save = timed
    try:
        yield out
    finally:
        del ck.save


@contextlib.contextmanager
def recorded_merges(ops):
    """Each call of K9's word entry inside (``plan_merge``'s, in the save's
    pool GC), kept as (its input, its outputs), copies both: the merge
    that follows rewrites the merged layers in place. The module's entry
    is put back on the way out."""
    calls, merge_entries = [], ops.merge_entries

    def recorded(sub):
        before = sub.clone()
        out = merge_entries(sub)
        calls.append((before, tuple(x.clone() for x in out)))
        return out

    ops.merge_entries = recorded
    try:
        yield calls
    finally:
        ops.merge_entries = merge_entries


def _require_saved_image(torch, mods, ck, what):
    """After the run's last save (and the pool GC's merges and compaction
    before it), every restore method reads the last saved page image back
    word for word. Check reads: their launches are not the path's."""
    with uncounted(mods["_build"]):
        for method in ("direct", "pallas_vanilla", "pallas_direct"):
            got = mods["store"].materialize(ck.chain, method=method)
            require(torch.equal(got, ck._shadow),
                    f"train: {what}: restore({method}) is not the saved image")
            del got


def _train_merge(torch, mods, calls, flush):
    """K9 at 12b's shape: every merge of both runs' pool GCs bit-equal to
    the plain merge on its input; the last one's input timed against its
    plain version (its row's ``train_shape``)."""
    sm, sm_ref = mods["sm"], mods["sm_ref"]
    require(calls, "train: the pool GC never merged")
    for sub, got in calls:
        want = sm_ref.merge_entries_ref(sub)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "train: K9's merge in the pool GC differs from the plain merge")
        del want
    sub = calls[-1][0]
    k = sub.shape[0]
    with uncounted(mods["_build"]):
        src = sm_ref.merge_entries_ref(sub)[2]
        walked = int(torch.where(src >= 0, k - src, k).sum())
        del src
        row, _ = measure(torch, "merge", lambda: sm.merge_entries_cuda(sub),
                         lambda: sm_ref.merge_entries_ref(sub),
                         8 * walked + 13 * sub.shape[1], 0, None, flush,
                         n_kernel=20, n_plain=3)
    return _shape_row(row, "merge", K_N=[k, sub.shape[1]], words_walked=walked,
                      merges_checked=len(calls))


def _greedy_plain(torch, mods, cfg, params, prompt, steps):
    """Greedy tokens of the plain ``prefill`` and ``decode_step`` (dense
    per-sequence cache, ``decode_attention_ref``): the first token and
    ``steps`` more."""
    T = mods["transformer"]
    toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=DEV)
    logits, pre = T.prefill(cfg, params, toks)
    s = toks.shape[1]
    cache = T.init_cache(cfg, 1, s + steps, device=DEV)
    cache["k"][:, :, :s] = pre["k"]
    cache["v"][:, :, :s] = pre["v"]
    cache["pos"] = pre["pos"]
    out = [int(torch.argmax(logits[0]))]
    for _ in range(steps):
        nxt = torch.tensor([[out[-1]]], dtype=torch.int64, device=DEV)
        logits, cache = T.decode_step(cfg, params, cache, nxt)
        out.append(int(torch.argmax(logits[0])))
    return out


def _serve_trained(torch, mods, cfg, params):
    """The trained weights on the port's ``Engine`` through both decode
    paths (tables: K3; fused: K4), a forked pair decoding
    ``TRAIN_SERVE_STEPS`` tokens: in the compute dtype (bf16) the pair's
    tokens are equal; in f32 both of the pair decode the plain
    ``prefill``/``decode_step`` tokens on the same weights and prompt.
    Returns the tokens by dtype and path."""
    L = mods["layers"]
    prompt = np.random.default_rng(12).integers(0, cfg.vocab_size, 24)
    compute = L.COMPUTE_DTYPE
    out = {}
    try:
        for dtype in (compute, torch.float32):
            L.COMPUTE_DTYPE = dtype
            want = (_greedy_plain(torch, mods, cfg, params, prompt, TRAIN_SERVE_STEPS)
                    if dtype == torch.float32 else None)
            for path, width in (("tables", 16), ("fused", 128)):
                eng = mods["Engine"](cfg, params, scalable=True, n_blocks=64,
                                     block_size=16, max_blocks_per_seq=width,
                                     decode_path=path, device=DEV)
                a = eng.add_request(prompt)
                b = eng.fork_request(a)
                for _ in range(TRAIN_SERVE_STEPS):
                    eng.step()
                got = list(eng.active[a])
                require(got == eng.active[b],
                        f"train: the forked pair decoded apart ({path}, {dtype})")
                require(want is None or got == want,
                        f"train: {path} serving {got} against the plain decode {want}")
                for sid in sorted(eng.active):
                    eng.finish_request(sid)
                require(eng.kv.blocks_in_use() == 0, "train: serving leaked blocks")
                out[f"{path}_{str(dtype).removeprefix('torch.')}"] = got
                del eng
    finally:
        L.COMPUTE_DTYPE = compute
    return out


def crash_and_resume(torch, mods, flush, model, dcfg, tcfg, opt_cfg, what,
                     exact=False):
    """The ``Trainer`` on its chain, as ``tests/test_checkpoint.py``'s
    crash/restart: an uninterrupted run, then a run crashed after step
    ``TRAIN_CRASH``, resumed through ``direct``, ``pallas_vanilla`` and
    last ``pallas_direct`` (each time the state equal to the last saved
    page image word for word) and finished: its final loss within 1e-5 of
    the uninterrupted run's, or with ``exact`` every loss after the resume
    equal to the uninterrupted run's bit for bit. After each run's last
    save (past its pool GC) every restore method reads the saved image
    back. Launches count from the first run on (restores timed for the
    line uncounted). Returns the runs' numbers, the merges the GC made
    (K9's word entry, recorded) and the resumed weights."""
    _build, leaves = mods["_build"], mods["tree"].leaves
    Trainer, merge_ops = mods["Trainer"], mods["chain"].merge_ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    t0 = time.perf_counter()
    ref = Trainer(model, opt_cfg, dcfg, tcfg, seed=0, device=DEV)
    n_params = sum(x.numel() for x in leaves(ref.params))
    spec = ref.ckpt.spec
    with timed_saves(torch, ref.ckpt) as ref_saves, \
            recorded_merges(merge_ops) as merges:
        ref_report = ref.run()
    ref_losses = list(ref.losses)
    ref_s = time.perf_counter() - t0
    merge_after_run = _build.LAUNCHES["merge"]
    require(merge_after_run > 0, f"{what}: the uninterrupted run's pool GC never ran")
    _require_saved_image(torch, mods, ref.ckpt, f"{what}: uninterrupted run")
    del ref
    torch.cuda.empty_cache()

    t = Trainer(model, opt_cfg, dcfg, tcfg, seed=0, device=DEV)
    with timed_saves(torch, t.ckpt) as saves:
        try:
            t.run(crash_after=TRAIN_CRASH)
            crashed = False
        except RuntimeError as e:
            crashed = "simulated crash" in str(e)
    require(crashed and t.step == TRAIN_CRASH, f"{what}: the run did not crash")
    last_saved = TRAIN_CRASH // tcfg.ckpt_every * tcfg.ckpt_every
    restores = {}
    for method in ("direct", "pallas_vanilla", "pallas_direct"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        at = t.resume(method=method)
        torch.cuda.synchronize()
        resume_ms = 1e3 * (time.perf_counter() - t1)
        require(at == last_saved, f"{what}: resume({method}) at {at}, not {last_saved}")
        require(torch.equal(t.ckpt._flatten(t._state()), t.ckpt._shadow),
                f"{what}: resume({method}) is not the saved image word for word")
        with uncounted(_build):
            ms = timed_ms(torch, lambda: t.ckpt.restore(method=method),
                          TRAIN_RESTORE_TIMED, flush)
        restores[method] = dict(resume_ms=resume_ms, restore_ms=ms,
                                word_exact=True)
    with timed_saves(torch, t.ckpt) as saves_after, \
            recorded_merges(merge_ops) as resumed_merges:
        report = t.run()
    final, want = t.losses[-1], ref_losses[-1]
    resumed = t.losses[TRAIN_CRASH:]
    require(report["steps"] == tcfg.total_steps, f"{what}: resumed run's steps")
    if exact:
        require(resumed == ref_losses[last_saved:],
                f"{what}: resumed losses {resumed} against {ref_losses[last_saved:]}")
    require(abs(final - want) <= 1e-5 * abs(want),
            f"{what}: resumed final loss {final} against {want}")
    require(resumed_merges, f"{what}: the resumed run's pool GC never ran")
    _require_saved_image(torch, mods, t.ckpt, f"{what}: resumed run")
    out = dict(params=t.params, chain_length=int(t.ckpt.chain.length),
               merges=merges, resumed_merges=resumed_merges, n_params=n_params,
               spec=spec, ref_s=ref_s, ref_losses=ref_losses, resumed=resumed,
               final=final, want=want, last_saved=last_saved,
               ref_report=ref_report, report=report, restores=restores,
               saves=dict(uninterrupted=ref_saves, crashed=saves,
                          resumed=saves_after),
               merge_after_run=merge_after_run,
               peak=torch.cuda.max_memory_allocated())
    del t
    torch.cuda.empty_cache()
    return out


def chain_line(run, merge_row, launches):
    """The numbers of a ``crash_and_resume`` run for its phase's line."""
    spec = run["spec"]
    image_bytes = spec.n_pages * spec.page_size * 4
    all_saves = [x for v in run["saves"].values() for x in v]
    return dict(
        params=run["n_params"], steps=run["report"]["steps"],
        crash_after=TRAIN_CRASH, n_pages=spec.n_pages,
        page_bytes=spec.page_size * 4, pool_rows=spec.pool_capacity,
        image_GB=image_bytes / 1e9, uninterrupted_seconds=run["ref_s"],
        ref_losses=run["ref_losses"], resumed_losses=run["resumed"],
        final_loss=run["final"], ref_final_loss=run["want"],
        final_loss_rel_diff=abs(run["final"] - run["want"]) / abs(run["want"]),
        resumed_equal_ref=[x == y for x, y in
                           zip(run["resumed"], run["ref_losses"][run["last_saved"]:])],
        resumed_at=run["last_saved"], chain_length=run["chain_length"],
        ref_report=run["ref_report"], report=run["report"], saves=run["saves"],
        first_save_ms=all_saves[0]["ms"],
        save_ms_mean=float(np.mean([x["ms"] for x in all_saves[1:]])),
        merge_launches_first_run=run["merge_after_run"],
        merges=dict(uninterrupted=len(run["merges"]),
                    resumed=len(run["resumed_merges"])),
        saved_image_after_gc_word_exact=True, restores=run["restores"],
        restore_bound_ms=1e3 * 2 * image_bytes / HBM_BYTES_PER_S,
        launches=launches, merge_shape=merge_row, peak_GB=run["peak"] / 1e9)


CHAIN_KERNELS = ("resolve_vanilla_fleet", "resolve_direct_fleet", "gather", "merge")


def train_chain(torch, mods, flush):
    """12b: the ``Trainer`` at Qwen2.5-3B's full width, ``TRAIN_CHAIN_LAYERS``
    layers, saving every ``TRAIN_CHAIN_EVERY`` steps into its chain, crashed
    and resumed (``crash_and_resume``); each merge the pool GC made
    through K9 equals the plain merge. The resumed weights then serve a
    forked pair on both decode paths. Launches are counted from the first
    run to the serving. Returns the launches and K9's row at this
    shape."""
    full = mods["get_config"](TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_CHAIN_LAYERS)
    dcfg = mods["DataConfig"](vocab_size=cfg.vocab_size, seq_len=TRAIN_CHAIN_SEQ,
                              global_batch=TRAIN_CHAIN_BATCH)
    tcfg = mods["TrainerConfig"](total_steps=TRAIN_CHAIN_STEPS,
                                 ckpt_every=TRAIN_CHAIN_EVERY, page_size=TRAIN_PAGE)
    opt_cfg = mods["adamw"].AdamWConfig(lr=1e-3, total_steps=TRAIN_CHAIN_STEPS)
    run = crash_and_resume(torch, mods, flush, mods["get_model"](cfg), dcfg, tcfg,
                           opt_cfg, "train")
    served = _serve_trained(torch, mods, cfg, run.pop("params"))
    launches = dict(mods["_build"].LAUNCHES)          # read just after the path
    torch.cuda.empty_cache()
    for k in CHAIN_KERNELS + ("paged_attention", "fused_chain_attention"):
        require(launches[k] > 0, f"train: kernel {k} never launched")
    merge_row = _train_merge(torch, mods, run["merges"] + run["resumed_merges"], flush)
    line = chain_line(run, merge_row, launches)
    line["merge_train_shape"] = line.pop("merge_shape")
    _train(dict(part="chain", model=cfg.name, n_layers=cfg.n_layers,
                of_layers=full.n_layers, d_model=cfg.d_model,
                batch=[TRAIN_CHAIN_BATCH, TRAIN_CHAIN_SEQ],
                ckpt_every=TRAIN_CHAIN_EVERY, served_tokens=served, **line), mods)
    return launches, merge_row


def _value_and_grad(torch, mods, model, params, batch):
    """``model.loss`` and its gradient by every leaf of ``params``."""
    tree = mods["tree"]
    xs = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = model.loss(tree.unflatten(params, xs), batch)
    return loss.detach(), torch.autograd.grad(loss, xs, materialize_grads=True,
                                              allow_unused=True)


def train_reference(torch, mods):
    """12c: one training step of the smoke configs on the card against the
    CPU on the same weights (bf16 compute on both): the loss and every
    gradient leaf within ``TRAIN_REL_TOL`` relative L2, and ``batch_at``'s
    tokens equal bit for bit."""
    tree = mods["tree"]
    for arch in TRAIN_SMOKE:
        model = mods["get_model"](mods["smoke_config"](arch))
        cpu_params = model.init(torch.Generator().manual_seed(1), device="cpu")
        card_params = tree.tree_map(lambda x: x.to(DEV), cpu_params)
        dcfg = mods["DataConfig"](vocab_size=model.cfg.vocab_size, seq_len=32,
                                  global_batch=4)
        cpu_b, card_b = (mods["batch_at"](dcfg, 3, device="cpu"),
                         mods["batch_at"](dcfg, 3, device=DEV))
        require(all(torch.equal(card_b[k].cpu(), cpu_b[k]) for k in cpu_b),
                f"train: {arch} batch_at tokens differ card vs CPU")

        want_loss, want = _value_and_grad(torch, mods, model, cpu_params, cpu_b)
        got_loss, got = _value_and_grad(torch, mods, model, card_params, card_b)
        grad_rel = [_rel(torch, b, a) for a, b in zip(want, got)]
        loss_rel = _rel(torch, got_loss, want_loss)
        require(loss_rel < TRAIN_REL_TOL and max(grad_rel) < TRAIN_REL_TOL,
                f"train: {arch} card vs CPU loss {loss_rel}, grads {max(grad_rel)}")
        _train(dict(part="reference", model=arch, tokens_equal=True,
                    loss_card=float(got_loss), loss_cpu=float(want_loss),
                    loss_rel=loss_rel, grad_rel_max=max(grad_rel),
                    grad_leaves=len(grad_rel), tolerance=TRAIN_REL_TOL), mods)


def train_phase(torch, mods):
    """12: (c) the smoke configs card against CPU, (a) Qwen2.5-3B whole,
    (b) the trainer on its chain. Returns 12b's launches and K9's row at
    12b's shape."""
    collect_cycles(torch, lambda obj: _train({"part": "start", **obj}, mods))
    t0 = time.perf_counter()
    train_reference(torch, mods)
    train_full(torch, mods)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    launches, merge_row = train_chain(torch, mods, flush)
    _train({"part": "end", "seconds": time.perf_counter() - t0}, mods)
    return launches, merge_row


# -- phase 13: the other model families ---------------------------------------


def _fam(obj, mods):
    """A phase-13 line: the card's name and power limit beside its numbers."""
    emit({**obj, "phase": "families", "card": mods["smi"]})


def _splice(mods, model, pre, room, device):
    """A prefill cache spliced into ``model.init_cache(B, room)``: leaves
    of the same shape taken as they are, the K/V written into the first
    positions, so a decode step has room to write at ``pos``."""
    batch = next(v for v in pre.values() if hasattr(v, "shape")).shape[1]
    cache = model.init_cache(batch, room, device=device)
    for k, v in pre.items():
        if k == "pos" or tuple(v.shape) == tuple(cache[k].shape):
            cache[k] = v
        else:
            cache[k][tuple(slice(0, n) for n in v.shape)] = v
    return cache


def family_reference(torch, mods):
    """13a: the smoke configs of ``FAMILY_ARCHS`` on the card against the
    CPU on the same weights, bf16 compute on both: prefill logits, a
    decode step into a cache with room (the same token on both), the loss
    and every gradient leaf within ``FAMILY_REL_TOL`` relative L2; for the
    encoder-decoder, ``batch_at``'s frames bitwise card against CPU."""
    tree = mods["tree"]
    for arch in FAMILY_ARCHS:
        cfg = mods["smoke_config"](arch)
        model = mods["get_model"](cfg)
        cpu_params = model.init(torch.Generator().manual_seed(1), device="cpu")
        card_params = tree.tree_map(lambda x: x.to(DEV), cpu_params)
        frames = cfg.enc_frames if cfg.family == "encdec" else 0
        dcfg = mods["DataConfig"](vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2)
        cpu_b, card_b = (mods["batch_at"](dcfg, 3, with_frames=frames,
                                          d_model=cfg.d_model, device=dev)
                         for dev in ("cpu", DEV))
        require(all(torch.equal(card_b[k].cpu(), cpu_b[k]) for k in cpu_b),
                f"families: {arch} batch_at differs card vs CPU")
        out = {}
        with torch.no_grad():
            for name, params, batch, dev in (("cpu", cpu_params, cpu_b, "cpu"),
                                             ("card", card_params, card_b, DEV)):
                logits, pre = model.prefill(params, batch)
                cache = _splice(mods, model, pre, 24, dev)
                nt = torch.full((2, 1), 7, dtype=torch.int32, device=dev)
                logits2, _ = model.decode_step(params, cache, nt)
                out[name] = (logits, logits2)

        want_loss, want = _value_and_grad(torch, mods, model, cpu_params, cpu_b)
        got_loss, got = _value_and_grad(torch, mods, model, card_params, card_b)
        rel = dict(prefill_logits=_rel(torch, out["card"][0], out["cpu"][0]),
                   decode_logits=_rel(torch, out["card"][1], out["cpu"][1]),
                   loss=_rel(torch, got_loss, want_loss),
                   grad_max=max(_rel(torch, b, a) for a, b in zip(want, got)))
        require(max(rel.values()) < FAMILY_REL_TOL,
                f"families: {arch} card vs CPU {rel}")
        _fam(dict(part="reference", model=arch, family=cfg.family,
                  batch_at_equal=True, frames=frames, rel_l2=rel,
                  grad_leaves=len(got), tolerance=FAMILY_REL_TOL), mods)


def _agreement(torch, got, want, tol, what):
    """Two logits of one input: relative L2 (held below ``tol``), the
    largest difference and the share of rows with the same greedy token."""
    out = dict(rel_l2=_rel(torch, got, want),
               max_abs=float((got.float() - want.float()).abs().max()),
               argmax_equal=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
               tolerance=tol)
    require(out["rel_l2"] < tol, f"{what}: {out}")
    return out


def consistency(torch, mods, cfg, model, params, batch, tol):
    """In the compute dtype of the moment: the logits of prefill(S) and one
    decode step (into a cache with room) against prefill(S + 1), and for
    RWKV-6 the chunked prefill against the scan's."""
    tokens = batch["tokens"]
    logits, pre = model.prefill(params, batch)
    cache = _splice(mods, model, pre, tokens.shape[1] + 1, DEV)
    del pre
    first = logits.argmax(-1)[:, None]
    step, _ = model.decode_step(params, cache, first)
    del cache
    longer, _ = model.prefill(params, dict(batch, tokens=torch.cat([tokens, first], 1)))
    dtype = str(mods["layers"].COMPUTE_DTYPE)
    out = dict(decode_vs_prefill=_agreement(torch, step, longer, tol,
                                            f"{cfg.name}: decode vs prefill, {dtype}"))
    if cfg.family == "ssm":
        chunked = mods["get_model"](dataclasses.replace(cfg, rwkv_chunked=True))
        lc, _ = chunked.prefill(params, batch)
        out["chunked_vs_scan"] = _agreement(torch, lc, logits, tol,
                                            f"{cfg.name}: chunked vs scan, {dtype}")
    return out


def family_serve(torch, mods, arch):
    """13b: ``arch`` at full width and depth, bf16 weights drawn on the card
    from seed 0: prefill ``FAMILY_PROMPTS`` prompts of ``FAMILY_PROMPT``
    tokens (a warm-up, then one timed; RWKV-6's chunked form timed too),
    ``FAMILY_DECODE`` greedy decode steps into a cache with room, each
    timed; then ``consistency`` in bf16 and in f32 compute (the same bf16
    weights)."""
    L, tree = mods["layers"], mods["tree"]
    cfg = mods["get_config"](arch)
    model = mods["get_model"](cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV,
                        dtype=L.COMPUTE_DTYPE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (FAMILY_PROMPTS, FAMILY_PROMPT)), device=DEV)
    batch = dict(tokens=tokens)
    if cfg.family == "encdec":
        g = torch.Generator(device=DEV).manual_seed(13)
        batch["frames"] = torch.randn((FAMILY_PROMPTS, cfg.enc_frames, cfg.d_model),
                                      generator=g, device=DEV)
    line = dict(part="serve", model=arch, family=cfg.family, n_layers=cfg.n_layers,
                d_model=cfg.d_model, params=n_params,
                weights_GB=sum(x.numel() * x.element_size()
                               for x in tree.leaves(params)) / 1e9,
                init_seconds=init_s, prompts=[FAMILY_PROMPTS, FAMILY_PROMPT])
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(params, batch)                         # warm-up
        (logits, pre), line["prefill_ms"] = _events_ms(
            torch, lambda: model.prefill(params, batch))
        require(bool(torch.isfinite(logits).all()), f"{arch}: prefill logits")
        cache = _splice(mods, model, pre, FAMILY_PROMPT + FAMILY_DECODE, DEV)
        del pre
        nxt, out, step_ms = logits.argmax(-1)[:, None], [], []
        for _ in range(FAMILY_DECODE):
            (lg, cache), ms = _events_ms(torch, lambda: model.decode_step(
                params, cache, nxt))
            step_ms.append(ms)
            nxt = lg.argmax(-1)[:, None]
            out.append(nxt[:, 0].tolist())
        torch.cuda.synchronize()
        line["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        require(bool(torch.isfinite(lg).all()) and cache["pos"] ==
                FAMILY_PROMPT + FAMILY_DECODE, f"{arch}: decode")
        line.update(decode_ms_per_step=float(np.mean(step_ms)),
                    decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
                    decode_tokens_per_s=FAMILY_PROMPTS * 1e3 / float(np.mean(step_ms)),
                    greedy_tokens_row0=[o[0] for o in out])
        del cache, logits, lg
        if cfg.family == "ssm":
            chunked = mods["get_model"](dataclasses.replace(cfg, rwkv_chunked=True))
            chunked.prefill(params, batch)                   # warm-up
            _, line["chunked_prefill_ms"] = _events_ms(
                torch, lambda: chunked.prefill(params, batch))
        line["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        line["bf16"] = consistency(torch, mods, cfg, model, params, batch,
                                   FAMILY_BF16_TOL)
        compute = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = torch.float32
        try:
            line["f32"] = consistency(torch, mods, cfg, model, params, batch,
                                      FAMILY_F32_TOL)
        finally:
            L.COMPUTE_DTYPE = compute
    del params
    torch.cuda.empty_cache()
    _fam(line, mods)
    return line


def rwkv_train_flops(cfg, seq) -> dict:
    """One RWKV-6 training step's operations, from the shapes: 6·N·T for
    the N matrix parameters (every layer's and ``w_out``), the remat
    recompute's 2·N_layers·T, and the chunked recurrence in f32 (per chunk
    of T_c tokens and head of D: the T_c x T_c scores and their product
    with V, the inter-chunk read and the state update, 8·T_c·D·(T_c + D)
    forward; forward, recompute and a backward of twice the forward)."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    layer_w = n * (6 * d * d + 2 * d * f + 2 * d * 64)
    n_matrix = layer_w + d * cfg.vocab_size
    tc, hd = cfg.scan_chunk, cfg.ssm_head_dim
    rec = n * (seq // tc) * cfg.n_heads * 8 * tc * hd * (tc + hd)
    model = 6 * n_matrix * seq
    remat = 2 * layer_w * seq if cfg.remat else 0
    f32 = rec * (5 if cfg.remat else 3)
    return dict(matrix_params=n_matrix, model=model, total=model + remat + f32,
                bf16=model + remat, f32=f32)


def family_train(torch, mods, arch, seq, timed):
    """13c: ``arch`` trained whole at full width, f32 params and AdamW state,
    bf16 compute, remat (RWKV-6 in the chunked form): ``timed`` steps of
    ``make_train_step`` on ``batch_at``'s sequence of ``seq`` tokens, each
    timed by CUDA events (with a warm-up step before them when ``timed`` >
    1), tokens/s and peak GB."""
    adamw, tree = mods["adamw"], mods["tree"]
    cfg = mods["get_config"](arch)
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, rwkv_chunked=True)
    model = mods["get_model"](cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    opt = adamw.init(params)
    n_params = sum(x.numel() for x in tree.leaves(params))
    dcfg = mods["DataConfig"](vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1)
    step = mods["make_train_step"](model, adamw.AdamWConfig())
    state = [params, opt]
    del params, opt

    def one(batch):
        state[0], state[1], met = step(state[0], state[1], batch)
        return met

    losses, ms = [], []
    for i in range(timed + (timed > 1)):
        batch = mods["batch_at"](dcfg, i, device=DEV)
        met, t = _events_ms(torch, lambda: one(batch))
        losses.append(float(met["loss"]))
        if timed == 1 or i > 0:
            ms.append(t)
    require(all(np.isfinite(losses)), f"{arch}: train losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    step_ms = float(np.mean(ms))
    line = dict(part="train", model=arch, family=cfg.family, n_layers=cfg.n_layers,
                params=n_params, param_dtype="float32",
                compute_dtype=str(mods["layers"].COMPUTE_DTYPE), remat=cfg.remat,
                rwkv_chunked=cfg.rwkv_chunked, seq_len=seq, global_batch=1,
                state_GB=16 * n_params / 1e9, losses=losses, ms_per_step=step_ms,
                ms_all=ms, tokens_per_s=seq * 1e3 / step_ms, peak_GB=peak / 1e9)
    if cfg.family == "ssm":
        fl = rwkv_train_flops(cfg, seq)
        ops_ms = 1e3 * (fl["bf16"] / BF16_FLOPS + fl["f32"] / F32_FLOPS)
        bytes_ms = 1e3 * 28 * n_params / HBM_BYTES_PER_S   # AdamW: p, m, v, g
        line.update(flops=fl, bound_ms=max(ops_ms, bytes_ms),
                    bound_by="operations" if ops_ms > bytes_ms else "bytes",
                    model_flops_share_of_bf16_peak=fl["model"] / (step_ms / 1e3)
                    / BF16_FLOPS)
    _fam(line, mods)
    return line


def whisper_chain(torch, mods, flush):
    """13d: Whisper-base whole on the ``Trainer``'s chain (no cut):
    ``FAMILY_CHAIN_BATCH`` x ``FAMILY_CHAIN_SEQ`` tokens with
    ``batch_at``'s frames, crashed and resumed through the three methods
    with every resumed loss bitwise equal to the whole run's
    (``crash_and_resume(exact=True)``), every pool-GC merge equal to the
    plain merge. Returns the path's launches and K9's row at this shape."""
    cfg = mods["get_config"](FAMILY_CHAIN_ARCH)
    dcfg = mods["DataConfig"](vocab_size=cfg.vocab_size, seq_len=FAMILY_CHAIN_SEQ,
                              global_batch=FAMILY_CHAIN_BATCH)
    tcfg = mods["TrainerConfig"](total_steps=TRAIN_CHAIN_STEPS,
                                 ckpt_every=TRAIN_CHAIN_EVERY, page_size=TRAIN_PAGE)
    opt_cfg = mods["adamw"].AdamWConfig(lr=1e-3, total_steps=TRAIN_CHAIN_STEPS)
    run = crash_and_resume(torch, mods, flush, mods["get_model"](cfg), dcfg, tcfg,
                           opt_cfg, "families", exact=True)
    launches = dict(mods["_build"].LAUNCHES)          # read just after the path
    del run["params"]
    torch.cuda.empty_cache()
    for k in CHAIN_KERNELS:
        require(launches[k] > 0, f"families: kernel {k} never launched")
    merge_row = _train_merge(torch, mods, run["merges"] + run["resumed_merges"], flush)
    _fam(dict(part="chain", model=cfg.name, n_layers=cfg.n_layers,
              n_enc_layers=cfg.n_enc_layers, enc_frames=cfg.enc_frames,
              batch=[FAMILY_CHAIN_BATCH, FAMILY_CHAIN_SEQ],
              ckpt_every=TRAIN_CHAIN_EVERY, resumed_losses_bitwise=True,
              **chain_line(run, merge_row, launches)), mods)
    return launches, merge_row


def other_families_phase(torch, mods):
    """13: (a) the smoke configs card against CPU, (b) RWKV6-3B,
    Zamba2-2.7B and Whisper-base served at full width, (c) RWKV6-3B and
    Zamba2-2.7B trained, (d) Whisper-base on the trainer's chain. Returns
    13d's launches and K9's row at its shape."""
    collect_cycles(torch, lambda obj: _fam({"part": "start", **obj}, mods))
    t0 = time.perf_counter()
    family_reference(torch, mods)
    for arch in FAMILY_ARCHS:
        family_serve(torch, mods, arch)
    for arch, seq, timed in FAMILY_TRAIN:
        family_train(torch, mods, arch, seq, timed)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
    launches, merge_row = whisper_chain(torch, mods, flush)
    _fam({"part": "end", "seconds": time.perf_counter() - t0}, mods)
    return launches, merge_row


def _dist(obj, mods):
    """A phase-14 line: the card's name and power limit beside its numbers."""
    emit({**obj, "phase": "distributed", "card": mods["smi"]})


def _host_timed(torch, fn):
    """``fn()`` on the host clock, the card synchronized on both sides:
    (its result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _full(x):
    """A ``DTensor``'s whole value; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def serve_launcher(torch, mods, d):
    """14a: ``python -m repro_torch.launch.serve`` at full width through its
    ``main``, every ``DIST_SERVE`` engine: the tokens equal an ``Engine``
    stepped directly on the same weights (drawn once here from the same
    seed), the counts equal the launcher's at the smoke scale on the CPU.
    Launches count over the four launcher runs."""
    _build, Engine = mods["_build"], mods["Engine"]
    cfg = mods["get_config"](DIST_ARCH)
    runs, launches = [], collections.Counter()
    for vanilla, path, blocks in DIST_SERVE:
        argv = ["--scale", "full", "--arch", DIST_ARCH,
                "--decode-path", path, "--max-blocks-per-seq", str(blocks)]
        argv += ["--vanilla"] if vanilla else []
        _build.reset_launches()
        st, ms = _host_timed(torch, lambda: d["serve"].main(argv))
        launches.update(_build.LAUNCHES)          # read just after the run
        cpu = d["serve"].main(argv[2:] + ["--device", "cpu"])   # smoke, CPU
        for k in ("n_seqs", "blocks_in_use", "lookups"):
            require(st[k] == cpu[k], f"serve launcher {k}: {st[k]} on the card, "
                    f"{cpu[k]} at the smoke scale on the CPU")
        runs.append(dict(argv=argv, ms=ms, tokens=st.pop("tokens"), stats=st))
        del st
        torch.cuda.empty_cache()
    args = d["serve"].parse([])
    with uncounted(_build):
        params = mods["get_model"](cfg).init(
            torch.Generator(device=DEV).manual_seed(0), device=DEV)
        for run, (vanilla, path, blocks) in zip(runs, DIST_SERVE):
            eng = Engine(cfg, params, scalable=not vanilla, n_blocks=1024,
                         block_size=8, max_blocks_per_seq=blocks,
                         decode_path=path, device=DEV)
            rng = np.random.default_rng(0)
            roots = [eng.add_request(rng.integers(0, cfg.vocab_size,
                                                  args.prompt_len))
                     for _ in range(args.requests)]
            for r in roots:
                for _ in range(args.forks):
                    eng.fork_request(r)
            for _ in range(args.tokens):
                eng.step()
            want = {sid: list(t) for sid, t in eng.active.items()}
            require(run["tokens"] == want,
                    f"serve launcher {run['argv']}: tokens differ from the engine's")
            run["engine_path"] = eng.decode_path
            del eng
    del params
    torch.cuda.empty_cache()
    for k in ("resolve_vanilla_fleet", "paged_attention", "fused_chain_attention"):
        require(launches[k] > 0, f"serve launcher: kernel {k} never launched")
    _dist(dict(part="serve_launcher", model=cfg.name,
               runs=[dict(argv=r["argv"], host_ms=r["ms"], stats=r["stats"],
                          decode_path=r["engine_path"], tokens_equal_engine=True,
                          counts_equal_cpu_smoke=True) for r in runs],
               launches=dict(launches)), mods)
    return dict(launches)


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic algorithms inside the block: a CUDA op that would sum
    in another order each run (the embedding gradient's scatter-add) sums
    in one, so a gradient can be held bitwise."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def sharded_equals_plain(torch, mods, d, mesh):
    """14b: Qwen2.5-3B whole in bf16 placed by ``param_shardings`` on the
    host mesh, under ``use_rules``: a 4 x 512 prefill's logits and one
    decode step (into the prefill's cache spliced into one with room)
    bitwise the plain run's; the host ms of both. Then every smoke config
    the same way with the loss and gradients too, both runs under
    deterministic algorithms, every gradient leaf held bitwise."""
    sh, tree = d["sh"], mods["tree"]
    rules = sh.make_rules(mesh)
    cfg = mods["get_config"](DIST_ARCH)
    model = mods["get_model"](cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV,
                        dtype=mods["layers"].COMPUTE_DTYPE)
    dparams = sh.distribute(params, sh.param_shardings(params, rules))
    b, sq = DIST_PREFILL
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, sq)), dtype=torch.int32, device=DEV)
    tok_sh = sh.NamedSharding(mesh, sh.batch_spec({"t": tokens}, rules)["t"])
    out = {}
    with torch.no_grad():
        (logits, cache), plain_ms = _host_timed(
            torch, lambda: model.prefill(params, dict(tokens=tokens)))
        with sh.use_rules(rules):
            dtok = sh.place(tokens, tok_sh)
            (dlogits, _), dt_ms = _host_timed(
                torch, lambda: model.prefill(dparams, dict(tokens=dtok)))
        require(torch.equal(_full(dlogits), logits),
                "sharded prefill logits differ from the plain run's")
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        room = _splice(mods, model, cache, sq + 1, DEV)
        dcache = sh.distribute(_splice(mods, model, cache, sq + 1, DEV),
                               sh.shardings_of(sh.cache_specs(room, rules), mesh))
        (step, _), plain_step_ms = _host_timed(
            torch, lambda: model.decode_step(params, room, nxt))
        with sh.use_rules(rules):
            dnxt = sh.place(nxt, tok_sh)
            (dstep, _), dt_step_ms = _host_timed(
                torch, lambda: model.decode_step(dparams, dcache, dnxt))
        require(torch.equal(_full(dstep), step),
                "sharded decode step differs from the plain run's")
    out[f"{cfg.name} whole"] = dict(prefill=[b, sq], prefill_host_ms=plain_ms,
                         prefill_dtensor_host_ms=dt_ms,
                         decode_host_ms=plain_step_ms,
                         decode_dtensor_host_ms=dt_step_ms, bitwise=True)
    del params, dparams, cache, room, dcache, logits, dlogits
    torch.cuda.empty_cache()

    from repro_torch.configs import list_archs
    from repro_torch.train.train_step import value_and_grad

    for arch in list_archs():
        scfg = mods["smoke_config"](arch)
        m = mods["get_model"](scfg)
        p = m.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
        batch = d["make_batch"](scfg, 0, 2, 8, device=DEV)
        dp = sh.distribute(p, sh.param_shardings(p, rules))
        db = sh.distribute(batch, sh.shardings_of(sh.batch_spec(batch, rules), mesh))
        tok = batch["tokens"][:, :1]
        with _deterministic(torch):
            with torch.no_grad():
                lg, _ = m.prefill(p, batch)
                st, _ = m.decode_step(p, m.init_cache(2, 12, device=DEV), tok)
            loss, grads = value_and_grad(m.loss, p, batch)
            plain = [loss] + tree.leaves(grads)
            t0 = time.perf_counter()
            with sh.use_rules(rules):
                with torch.no_grad():
                    dlg, _ = m.prefill(dp, db)
                    dst, _ = m.decode_step(dp, sh.distribute(
                        m.init_cache(2, 12, device=DEV), sh.shardings_of(
                            sh.cache_specs(m.init_cache(2, 12, device="meta"),
                                           rules), mesh)), sh.place(tok, tok_sh))
                dl, dg = value_and_grad(m.loss, dp, db)
            host_ms = 1e3 * (time.perf_counter() - t0)
        require(torch.equal(_full(dlg), lg), f"{arch}: sharded prefill differs")
        require(torch.equal(_full(dst), st), f"{arch}: sharded decode differs")
        got = [_full(dl)] + [_full(g) for g in tree.leaves(dg)]
        require(len(got) == len(plain)
                and all(torch.equal(a, w) for a, w in zip(got, plain)),
                f"{arch}: the sharded loss or a gradient differs from the plain run's")
        out[arch] = dict(bitwise_prefill=True, bitwise_decode=True,
                         bitwise_loss_and_grads=True, leaves=len(got),
                         dtensor_host_ms=host_ms)
        del p, dp, batch, db
    torch.cuda.empty_cache()
    _dist(dict(part="sharded_equals_plain", mesh=d["mesh_shape"](mesh),
               results=out), mods)


def restore_sharded(torch, mods, d, mesh, flush):
    """14c: a Qwen2.5-3B bf16 checkpoint chain at phase 10's page size (one
    full save, one delta) restored with ``shardings=`` through
    ``DIST_RESTORES``: every leaf a ``DTensor`` with the requested
    placements whose local tensor is bitwise the saved state; each timed
    by CUDA events beside the same method's unsharded restore."""
    sh, _build = d["sh"], mods["_build"]
    cfg = mods["get_config"](DIST_ARCH)
    state = _checkpoint_state(torch, mods, cfg)
    rules = sh.make_rules(mesh)
    ck = mods["ckpt"].SnapshotCheckpointer(state, max_chain=CKPT_MAX_CHAIN,
                                           scalable=True, stream_threshold=10**9,
                                           device=DEV)
    shardings = sh.param_shardings(state, rules)
    _build.reset_launches()
    ck.save(state)
    state["layers"]["attn"]["wo"][0] += 1
    state["step"] += 1
    ck.save(state)
    rows = {}
    for m in DIST_RESTORES:
        got = ck.restore(method=m, shardings=shardings)
        for x, want, s_ in zip(_leaves_sorted(got), _leaves_sorted(state),
                               _leaves_sorted(shardings)):
            require(list(x.placements) == s_.placements_for(tuple(x.shape)),
                    f"restore({m}, shardings=): placements")
            require(_same_leaves(torch, x.to_local(), want),
                    f"restore({m}, shardings=) differs from the saved state")
        del got
        rows[m] = dict(bitwise=True)
    launches = dict(_build.LAUNCHES)              # read just after the path
    for k in ("resolve_vanilla_fleet", "resolve_direct_fleet", "gather"):
        require(launches[k] > 0, f"restore(shardings=): kernel {k} never launched")
    with uncounted(_build):
        for m in DIST_RESTORES:
            rows[m]["sharded_ms"] = timed_ms(
                torch, lambda: ck.restore(method=m, shardings=shardings),
                CKPT_TIMED, flush)
            rows[m]["unsharded_ms"] = timed_ms(
                torch, lambda: ck.restore(method=m), CKPT_TIMED, flush)
    image_bytes = ck.spec.n_pages * ck.spec.page_size * 4
    _dist(dict(part="restore_sharded", model=cfg.name, n_pages=ck.spec.n_pages,
               page_bytes=ck.spec.page_size * 4, image_GB=image_bytes / 1e9,
               restore_bound_ms=1e3 * 2 * image_bytes / HBM_BYTES_PER_S,
               methods=rows, launches=launches), mods)
    del ck, state
    torch.cuda.empty_cache()
    return launches


def _leaves_sorted(tree):
    """Leaves in sorted-key order (``NamedSharding`` leaves too)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    return [tree]


def dp_train(torch, mods, d, mesh):
    """14d: ``make_dp_train_step`` on the one-rank group, Qwen2.5-3B at full
    width with 2 layers, f32 state, ``DIST_DP_STEPS`` steps: without
    compression bitwise ``make_train_step`` (loss, parameters, AdamW
    state); with compression every residual element within its leaf's
    scale. Both under deterministic algorithms (the embedding gradient's
    scatter-add sums in one order); each step timed by CUDA events;
    ``wire_bytes`` of both on the pod axis (2 ranks) and the data axis
    (16), where the int8 all-gather sends more than the f32 all-reduce."""
    comp, tree = d["comp"], mods["tree"]
    cfg = dataclasses.replace(mods["get_config"](DIST_ARCH), n_layers=DIST_DP_LAYERS)
    model = mods["get_model"](cfg)
    ocfg = mods["adamw"].AdamWConfig(lr=1e-3, total_steps=DIST_DP_STEPS)
    from repro_torch.train.train_step import value_and_grad

    def fresh():
        p = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
        return p, mods["adamw"].init(p)

    ref = mods["make_train_step"](model, ocfg)
    dp = comp.make_dp_train_step(model, ocfg, mesh, compress=False)
    dpc = comp.make_dp_train_step(model, ocfg, mesh, compress=True)
    batches = [d["make_batch"](cfg, i, *DIST_DP_BATCH, device=DEV)
               for i in range(DIST_DP_STEPS)]
    with _deterministic(torch):
        p1, o1 = fresh()
        ms = dict(train_step=[], dp=[], dp_int8=[])
        for b in batches:
            (p1, o1, met), t = _events_ms(torch, lambda: ref(p1, o1, b))
            ms["train_step"].append(t)
        ref_loss = float(met["loss"])
        p2, o2 = fresh()
        e2 = comp.init_error_state(p2)
        for b in batches:
            (p2, o2, e2, loss), t = _events_ms(torch, lambda: dp(p2, o2, e2, b))
            ms["dp"].append(t)
        require(float(loss) == ref_loss, "DP step loss differs from make_train_step")
        require(all(torch.equal(a, b) for a, b in zip(tree.leaves((p1, o1)),
                                                       tree.leaves((p2, o2)))),
                "DP step (no compression) is not bitwise make_train_step")
        wire = {f"{k}_{n}_ranks": comp.wire_bytes(p2, compressed=k == "int8",
                                                   ranks=n)
                for n in DIST_WIRE_RANKS for k in ("f32", "int8")}
        del p1, o1, p2, o2, e2
        torch.cuda.empty_cache()
        p3, o3 = fresh()
        e3 = comp.init_error_state(p3)
        worst = 0.0
        for b in batches:
            grads = value_and_grad(model.loss, p3, b)[1]
            scales = [comp.quantize_int8(g.float() + e)[1]
                      for g, e in zip(tree.leaves(grads), tree.leaves(e3))]
            del grads
            (p3, o3, e3, loss_c), t = _events_ms(torch, lambda: dpc(p3, o3, e3, b))
            ms["dp_int8"].append(t)
            for e, s_ in zip(tree.leaves(e3), scales):
                require(bool((e.abs() <= s_).all()), "int8 residual above its scale")
                worst = max(worst, float((e.abs() / s_).max()))
    _dist(dict(part="dp_train", model=cfg.name, n_layers=cfg.n_layers,
               batch=list(DIST_DP_BATCH), steps=DIST_DP_STEPS,
               step_ms=ms, loss=ref_loss, loss_int8=float(loss_c),
               bitwise_equal_train_step=True, residual_over_scale_max=worst,
               wire_bytes=wire), mods)
    del p3, o3, e3
    torch.cuda.empty_cache()


def train_launcher(torch, mods, d):
    """14e: ``python -m repro_torch.launch.train`` through its ``main`` on
    the host mesh (``DIST_TRAIN_ARGV``): the state and batches are
    ``DTensor``s, its pool GC merges (K9), and its last loss is bitwise a
    plain ``Trainer``'s at the same settings (both under deterministic
    algorithms); then ``--production`` refuses on one rank, naming the
    ranks it needs."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    _build = mods["_build"]
    with _deterministic(torch):
        _build.reset_launches()
        report, ms = _host_timed(torch, lambda: d["train"].main(DIST_TRAIN_ARGV))
        launches = dict(_build.LAUNCHES)          # read just after the run
        with uncounted(_build):
            cfg = mods["smoke_config"](DIST_ARCH)
            steps = report["steps"]
            plain = Trainer(mods["get_model"](cfg),
                            mods["adamw"].AdamWConfig(lr=1e-3, total_steps=steps),
                            DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                       global_batch=4),
                            TrainerConfig(total_steps=steps, ckpt_every=1),
                            device=DEV).run()
    require(launches["merge"] > 0, "train launcher: K9 never launched")
    require(report["final_loss"] == plain["final_loss"],
            f"train launcher's loss {report['final_loss']!r} is not the plain "
            f"Trainer's {plain['final_loss']!r}")
    try:
        d["train"].main(["--production"])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    require(refused is not None and "needs 256 ranks" in refused,
            f"--production on one rank: {refused!r}")
    _dist(dict(part="train_launcher", argv=DIST_TRAIN_ARGV, host_ms=ms,
               report={k: v for k, v in report.items()
                       if isinstance(v, (int, float, str))},
               plain_final_loss=plain["final_loss"],
               production_refusal=refused, launches=launches), mods)
    return launches


def start_dryrun(out_dir):
    """14f: the dry-run of Qwen2.5-3B's train_4k on the 16x16 fake group,
    in its own process (the fake group cannot share one with the real)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DIST_ARCH,
         "--shape", "train_4k", "--out", str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def distributed_phase(torch, mods):
    """14: (f) started in a subprocess first, then on a one-rank ``nccl``
    group (``make_host_mesh``): (a) the serve launcher, (b) sharded ≡
    plain, (c) ``restore(shardings=)``, (d) the DP step, (e) the training
    launcher; the group destroyed at the end. Returns the launches of
    (a), (c) and (e)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, train
    from repro_torch.models.api import make_batch

    collect_cycles(torch, lambda obj: _dist({"part": "start", **obj}, mods))
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    dry = start_dryrun(out_dir)
    try:
        mesh = mesh_lib.make_host_mesh(device=DEV)
        require(dist.get_backend() == ("nccl" if DEV == "cuda" else "gloo")
                and dist.get_world_size() == 1, "phase 14 needs a one-rank group")
        d = dict(sh=sh, comp=comp, serve=serve, train=train,
                 make_batch=make_batch, mesh_shape=mesh_lib.mesh_shape)
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEV)
        totals = collections.Counter(serve_launcher(torch, mods, d))
        sharded_equals_plain(torch, mods, d, mesh)
        totals.update(restore_sharded(torch, mods, d, mesh, flush))
        dp_train(torch, mods, d, mesh)
        totals.update(train_launcher(torch, mods, d))
        del flush
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    try:
        log, _ = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
    require(dry.returncode == 0, f"dry-run failed:\n{log[-4000:]}")
    rec = json.loads((out_dir / f"{DIST_ARCH}__train_4k__16x16.json").read_text())
    _dist(dict(part="dryrun", cell=f"{DIST_ARCH} train_4k 16x16",
               record={k: rec[k] for k in (
                   "n_devices", "accum", "trace_s", "memory", "flops_per_device",
                   "hbm_bytes_per_device", "collective_bytes_per_device",
                   "model_flops_per_device", "useful_flops_ratio",
                   "roofline_terms_s", "bottleneck", "roofline_frac")}), mods)
    _dist({"part": "end", "seconds": time.perf_counter() - t0,
           "launches": dict(totals)}, mods)
    return dict(totals)


# -- phase 15: the seeded storm of both planes ---------------------------------


def _storm(obj, mods):
    """A phase-15 line: the card's name and power limit beside its numbers."""
    emit({**obj, "phase": "storm", "card": mods["smi"]})


def _by_kind(timings) -> dict:
    """Host ms an event and of its checks, by event kind: count, mean, max."""
    out = collections.defaultdict(list)
    for kind, ev, chk in timings:
        out[kind].append((1e3 * ev, 1e3 * chk))
    return {k: dict(n=len(v), event_ms_mean=float(np.mean([e for e, _ in v])),
                    event_ms_max=float(max(e for e, _ in v)),
                    check_ms_mean=float(np.mean([c for _, c in v])))
            for k, v in sorted(out.items())}


def _check_ms(h) -> dict:
    """Host ms of a step's checks: the invariant suite alone, and with the
    data oracle (every ``check_data_every``-th step), mean and count."""
    every = h.config.check_data_every
    out = {"invariants": [], "invariants_and_data": []}
    for i, (_, _, chk) in enumerate(h.timings, start=1):
        out["invariants_and_data" if i % every == 0 else "invariants"].append(
            1e3 * chk)
    return {k: dict(n=len(v), ms_mean=float(np.mean(v)) if v else None)
            for k, v in out.items()}


def _require_launched(launches: dict) -> None:
    if DEV == "cuda":
        for k in STORM_KERNELS:
            require(launches[k] > 0, f"storm: {k} never launched")


def _events_only(h, _build):
    """The harness ``h`` with its checks (the invariant suite after every
    event, the data oracle on its cadence) uncounted: what its run counts
    is its events' launches, the main path's."""
    check = h.check

    def check_uncounted(**kwargs):
        with uncounted(_build):
            check(**kwargs)

    h.check = check_uncounted
    return h


def _run_counted(h, _build) -> dict:
    """``h.run()`` with the launch counts zeroed just before it; the
    events' launches, read just after it."""
    _build.reset_launches()
    h.run()
    return {k: _build.LAUNCHES[k] for k in STORM_KERNELS}


def _storm_harness():
    """``tests/scenario/harness_torch.py``, loaded by its path: a ``tests``
    package installed elsewhere may shadow the repo's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "harness_torch", ROOT / "tests" / "scenario" / "harness_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def storm_phase(torch, mods):
    """15: (a) the storm at the harness's geometry, seeds 0-2, on the card
    and on the CPU in this process: equal traces, equal final states word
    for word and byte for byte, the invariant suite after every event and
    the data oracle every 10 on both; (b) 200 events at deployment scale
    (``STORM_SCALE``). Returns the launches of the storms' events on the
    card: the checks run uncounted, and the counts are read before
    ``state_of`` gathers the final states."""
    ht = _storm_harness()
    _build = mods["_build"]
    collect_cycles(torch, lambda obj: _storm({"part": "start", **obj}, mods))
    t0 = time.perf_counter()
    small = dict.fromkeys(STORM_KERNELS, 0)
    for seed in STORM_SEEDS:
        runs = {}
        for dev in (DEV, "cpu"):
            h = _events_only(ht.ScenarioHarness(ht.ScenarioConfig(
                seed=seed, events=STORM_EVENTS, device=dev)), _build)
            t1 = time.perf_counter()
            launches = _run_counted(h, _build)
            runs[dev] = (h, time.perf_counter() - t1)
            if dev == DEV:
                small = {k: small[k] + launches[k] for k in STORM_KERNELS}
        (card, card_s), (cpu, cpu_s) = runs[DEV], runs["cpu"]
        require(card.trace == cpu.trace, f"storm seed {seed}: traces differ")
        diffs = ht.state_diffs(ht.state_of(card), ht.state_of(cpu))
        require(not diffs, f"storm seed {seed}: states differ in {diffs[:8]}")
        _storm(dict(part="card_vs_cpu", seed=seed, events=STORM_EVENTS,
                    card_s=card_s, cpu_s=cpu_s, stats=card.stats(),
                    traces_equal=True, states_equal=True), mods)
        del runs, card, cpu
    _require_launched(small)
    _storm(dict(part="card_vs_cpu", seconds=time.perf_counter() - t0,
                launches=small), mods)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    h = _events_only(ht.ScenarioHarness(ht.ScenarioConfig(
        seed=0, events=STORM_EVENTS, device=DEV, **STORM_SCALE)), _build)
    big = _run_counted(h, _build)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    _require_launched(big)
    stats = h.stats()
    require(stats["invariant_checks"] >= STORM_EVENTS, "storm: checks missed")
    _storm(dict(part="scale", geometry=STORM_SCALE, events=STORM_EVENTS,
                seconds=wall, events_per_s=STORM_EVENTS / wall,
                by_kind=_by_kind(h.timings), check_ms=_check_ms(h),
                stats=stats, launches=big,
                peak_GB=torch.cuda.max_memory_allocated() / 1e9), mods)
    del h
    torch.cuda.empty_cache()
    _storm({"part": "end", "seconds": time.perf_counter() - t0}, mods)
    return {k: small[k] + big[k] for k in STORM_KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}: run the script "
              "from a checkout of the repo", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import fleet
    from repro_torch.core import format as fmt
    from repro_torch.core import store
    from repro_torch.kernels import _build
    from repro_torch.kernels.chain_resolve import chain_resolve as cr
    from repro_torch.kernels.chain_resolve import ops as cr_ops
    from repro_torch.kernels.chain_resolve import ref as cr_ref
    from repro_torch.kernels.cow_gather import cow_gather as cg
    from repro_torch.kernels.cow_gather import ops as cg_ops
    from repro_torch.kernels.cow_gather import ref as cg_ref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.stream_merge import ref as sm_ref
    from repro_torch.kernels.stream_merge import stream_merge as sm
    from repro_torch.checkpoint import snapstore_ckpt
    from repro_torch.configs import paper_chain
    from repro_torch.core import cache, chain, metrics, migrate, resolve
    from repro_torch.core.golden import GoldenRegistry
    from repro_torch.core.invariants import (check_fleet_invariants,
                                             check_kv_invariants)
    from repro_torch.core.scheduler import MaintenanceScheduler
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import get_model, layers, moe, transformer
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

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
                cr_ops=cr_ops, pa=pa, pa_ref=pa_ref, fmt=fmt, cg=cg,
                cg_ref=cg_ref, cg_ops=cg_ops, store=store, fleet=fleet,
                TieredStore=store.TieredStore,
                readable_rows=store.readable_rows, chain=chain, sm=sm,
                sm_ref=sm_ref, Sched=MaintenanceScheduler,
                check_fleet_invariants=check_fleet_invariants,
                check_kv_invariants=check_kv_invariants, migrate=migrate,
                GoldenRegistry=GoldenRegistry, metrics=metrics, cache=cache,
                resolve=resolve, ckpt=snapstore_ckpt, paper_chain=paper_chain,
                smi=smi, get_config=get_config, moe=moe, tree=tree,
                get_model=get_model, adamw=adamw, DataConfig=DataConfig,
                batch_at=batch_at, make_train_step=make_train_step,
                Trainer=Trainer, TrainerConfig=TrainerConfig,
                transformer=transformer)

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
    require(n_params == param_breakdown(cfg)["exact"],
            "parameter count of the full-width model")
    emit({"phase": "serve", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "param_dtype": str(layers.COMPUTE_DTYPE),
          "init_seconds": time.perf_counter() - t0,
          "prompt_lengths": list(PROMPT_LENGTHS)})
    results, state = serve_phase(torch, mods, cfg, params, prompts)

    # 5. kernels at the main path's shapes
    per_step_of = {
        "resolve_vanilla_fleet": results["vanilla/fused"]["per_step"]["resolve_vanilla_fleet"],
        "resolve_direct_fleet": results["vanilla/fused"]["per_step"]["resolve_direct_fleet"],
        "resolve_auto_batch": results["vanilla/fused"]["per_step"]["resolve_auto_batch"],
        "paged_attention": results["vanilla/tables"]["per_step"]["paged_attention"],
        "fused_chain_attention": results["vanilla/fused"]["per_step"]["fused_chain_attention"],
    }
    rows = kernel_phase(torch, mods, state)
    del params, state, logits
    torch.cuda.empty_cache()

    # 6. one virtual disk: dd and YCSB-C through the snapshot chain
    t0 = time.perf_counter()
    store_rows, store_launches, store_per_call, disk_indexes = store_phase(torch, mods)
    emit({"phase": "store", "seconds": time.perf_counter() - t0})
    per_step_of.update(store_per_call)

    # 7. a fleet of disks: fleet.read and the host cold tier
    t0 = time.perf_counter()
    fleet_rows, fleet_launches, fleet_per_read, fleet_shapes, golden_fleet_launches = \
        fleet_phase(torch, mods)
    emit({"phase": "fleet", "seconds": time.perf_counter() - t0})
    per_step_of["gather_fleet"] = fleet_per_read["gather_fleet"]

    # 8. the maintenance plane: one disk, a fleet, serving beside it
    t0 = time.perf_counter()
    merge_rows, disk_launches, per_plan = disk_maintenance(torch, mods)
    maint_launches = fleet_maintenance(torch, mods)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", dtype=layers.COMPUTE_DTYPE)
    serve8_launches = serve_maintenance(torch, mods, cfg, params, prompts)
    emit({"phase": "maintenance", "seconds": time.perf_counter() - t0})
    per_step_of["merge"] = per_plan         # launches per plan_merge call

    # 9. golden admission and migration (9b and 9d ran on phase 7's fleet)
    t0 = time.perf_counter()
    admission_launches, suffix_row = golden_admission(torch, mods, cfg, params)
    seqmig_launches = sequence_migration(torch, mods, cfg, params, prompts[-1])
    del params
    torch.cuda.empty_cache()
    emit({"phase": "golden", "seconds": time.perf_counter() - t0})

    # 10. the paper's evaluation plane: Fig 17 on a checkpoint chain, the
    # cache model on phase 6's disks, Fig 12 and Eq. 2
    t0 = time.perf_counter()
    collect_cycles(torch, lambda obj: _paper(obj, mods))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    paper_launches, ckpt_shapes = checkpoint_phase(torch, mods, cfg, flush)
    with uncounted(_build):
        page_sweep = gather_sweep(torch, mods, flush)
    _paper(dict(part="gather_sweep", sweep=page_sweep), mods)
    cache_phase(torch, mods, disk_indexes)
    paper_models(torch, mods, disk_indexes["disks"]["vanilla"]["spec"])
    del disk_indexes
    _paper({"seconds": time.perf_counter() - t0}, mods)

    # 11. the rest of the decoder-only family: the smoke configs card
    # against CPU, Qwen2-MoE-A2.7B at full width, the dense variants
    t0 = time.perf_counter()
    collect_cycles(torch, lambda obj: _families({"part": "start", **obj}, mods))
    family_launches, family_shapes = families_phase(torch, mods, flush)
    del flush
    _families({"part": "end", "seconds": time.perf_counter() - t0}, mods)

    # 12. training on the snapshot-checkpoint chain
    train_launches, train_merge_row = train_phase(torch, mods)

    # 13. the other model families: RWKV-6, Zamba2, Whisper
    family13_launches, family13_merge_row = other_families_phase(torch, mods)

    # 14. distribution and the launchers, on a one-rank nccl group
    dist_launches = distributed_phase(torch, mods)

    # 15. the seeded storm of both planes, card against CPU and at scale
    storm_launches = storm_phase(torch, mods)

    # launches on the main paths: the engines' runs, both store depths,
    # both fleets, the maintenance runs, the golden and migration runs,
    # phase 11's engines, phase 12's and 13's trainer paths, phase 14's
    # launcher runs and sharded restores and phase 15's storms on the card
    # (each counted from zero just before its run)
    launches_of = {k: sum(r["launches"][k] for r in results.values())
                   + sum(x.get(k, 0) for x in (store_launches, fleet_launches,
                                              disk_launches, maint_launches,
                                              serve8_launches,
                                              golden_fleet_launches,
                                              admission_launches,
                                              seqmig_launches, paper_launches,
                                              family_launches, train_launches,
                                              family13_launches, dist_launches,
                                              storm_launches))
                   for k in KERNEL_SOURCES}
    # the batch entry counts under K1's name too: K1's row is the whole map's
    launches_of["resolve_vanilla_fleet"] -= launches_of["resolve_auto_batch"]
    per_step_of["resolve_vanilla_fleet"] -= per_step_of["resolve_auto_batch"]
    rows[0]["fleet_shape"] = fleet_shapes["fleet_shape"]      # K1's row
    rows[0]["walk_sweep"].update(fleet_shapes["walk_sweep"])
    rows[1]["fleet_shape"] = fleet_shapes["k2_fleet_shape"]   # K2's row
    rows[2]["suffix_shape"] = suffix_row                      # K3's row
    rows[2]["families"] = family_shapes["paged_attention"]    # phase 11
    rows[3]["families"] = family_shapes["fused_chain_attention"]
    rows[4]["fleet_shape"] = fleet_shapes["auto_batch_fleet_shape"]  # batch entry
    rows += fleet_rows + store_rows + merge_rows
    for row in rows:                      # the page gather's two rows
        if row["name"] in ("gather", "gather_fleet"):
            row["page_sweep"] = page_sweep
    for row in rows:                      # the checkpoint chain's shapes
        if row["name"] in ckpt_shapes:
            row["ckpt_shape"] = ckpt_shapes[row["name"]]
        if row["name"] == "merge":        # phase 12b's and 13d's pool GC
            row["train_shape"] = train_merge_row
            row["whisper_train_shape"] = family13_merge_row
    floor, floor_clean = floor_ms(torch, torch.empty(64 * 2**20, dtype=torch.uint8,
                                                     device="cuda"))
    for row in rows:
        row.update(floor_ms=floor, floor_ms_clean_l2=floor_clean)
        row["launches"] = launches_of[row["name"]]
        row["launches_per_step"] = per_step_of[row["name"]]
        require(row["launches"] > 0, f"kernel {row['name']} never launched")
    require(sorted(r["name"] for r in rows) == sorted(KERNEL_SOURCES),
            "one kernels-line row per kernel")

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
