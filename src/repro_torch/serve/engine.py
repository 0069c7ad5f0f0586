"""Serving engine: continuous batching over the fleet-backed KV cache
(PyTorch port of ``repro.serve.engine``).

Request lifecycle: ``add_request(prompt)`` prefills through the model and
streams the K/V into the paged pool (one bulk fleet write);
``fork_request`` COW-forks a sequence — with the scalable cache this
clones the resolved tenant row forward (sQEMU snapshotting), with the
vanilla cache the fork becomes a new fleet tenant whose chain pays the
walk; ``step()`` decodes one token for every active sequence;
``finish_request`` releases a sequence's blocks (tombstoned while forks
are live) and retires its fleet tenant row.

``step()`` performs **zero per-sequence host-side chain walks**. Two
decode paths exist (``decode_path``, default ``"auto"``):

- ``"tables"`` — the COW-prepare mask and the attention block tables
  both come from ONE stacked fleet resolve (``PagedKVCache.prepare_step``,
  the CUDA fleet-resolve kernels on the card), and every layer runs the
  CUDA paged-attention kernel through those tables.
- ``"fused"`` — a *narrow* resolve of the batch's write columns stamps
  the COW slots, then every layer runs the fused CUDA kernel, which walks
  the (T, C, P) fleet index itself.

``"auto"`` keeps the JAX package's selection rule (fused iff
``max_blocks_per_seq`` is a multiple of 128) so both packages pick the
same path.

The engine can also drive a fleet maintenance plane: pass a
``core.scheduler.MaintenanceScheduler`` and every ``step()`` (an idle one
too) ends with one budgeted maintenance tick — background streaming and
GC running *beside* the serving path instead of stopping the world
(paper §6.4).

Tiering: ``park_request`` pulls a sequence out of the decode batch and
spills its exclusively-owned KV blocks to host memory
(``PagedKVCache.demote_seq``); ``resume_request`` just re-activates it —
promotion is *lazy*, paid by the first ``step()`` whose batch includes the
sequence (the cache promotes before it resolves).

Golden prefixes: ``register_golden(prompt)`` prefills a prompt once and
freezes it as a shared base; an ``add_request`` whose prompt extends a
registered base (a radix-trie probe on token ids) COW-forks the base and
prefills only the suffix, in one ``paged_suffix_prefill`` pass through the
CUDA paged-attention kernel against the forked paged prefix, whatever
``decode_path`` the engine decodes with. The shared span costs no fresh
pool blocks and no prefill FLOPs.

Migration: ``migrate_request_to`` moves a live sequence's resolved KV
state to another engine (any block size, pool size or format),
bit-verifies it there and only then retires it here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fleet as fleet_lib
from repro_torch.core.golden import PrefixTrie
from repro_torch.device import as_device
from repro_torch.kvcache.paged import PagedKVCache, PagedKVConfig
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.serve.paged_decode import (
    paged_decode_step,
    paged_decode_step_fused,
    paged_suffix_prefill,
)


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, scalable: bool = True,
                 n_blocks: int = 512, block_size: int = 16,
                 max_blocks_per_seq: int = 64, scheduler=None,
                 resolver: str = "auto", decode_path: str = "auto",
                 device="cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError("paged serving engine supports attention LMs")
        if decode_path not in ("auto", "fused", "tables"):
            raise ValueError(f"unknown decode_path {decode_path!r}")
        if decode_path == "auto":
            decode_path = ("fused"
                           if fleet_lib.fused_layout_ok(max_blocks_per_seq)
                           else "tables")
        elif decode_path == "fused" and not fleet_lib.fused_layout_ok(
                max_blocks_per_seq):
            raise ValueError(
                "decode_path='fused' needs a lane-aligned page axis "
                f"(max_blocks_per_seq % 128 == 0, got {max_blocks_per_seq})"
            )
        self.decode_path = decode_path
        self.cfg = cfg
        self.params = params
        self.model = get_model(cfg)
        self.device = as_device(device)
        self.kv = PagedKVCache(
            PagedKVConfig(
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, block_size=block_size, n_blocks=n_blocks,
                max_blocks_per_seq=max_blocks_per_seq,
                dtype=L.COMPUTE_DTYPE,
            ),
            scalable=scalable,
            resolver=resolver,
            device=self.device,
        )
        self.active: dict[int, list[int]] = {}  # sid -> generated tokens
        self.parked: dict[int, list[int]] = {}  # sid -> tokens, off-batch
        # golden-prefix registry, the admission-time dedup plane: the trie
        # maps registered prompt token ids -> golden sid; _golden_info
        # keeps each base's prompt (for trie removal) and its first token
        # (an exact-match admission skips the model entirely)
        self._trie = PrefixTrie()
        self._golden_info: dict[int, tuple[tuple[int, ...], int]] = {}
        self.golden_hits = 0   # admissions served by forking a base
        # Scratch block absorbing the in-step pool writes of padded batch
        # rows, so a padded decode can never touch a live sequence's blocks.
        self._pad_block = self.kv.reserve_block()
        # Optional MaintenanceScheduler (core.scheduler) ticked between
        # decode steps — the background half of the serving loop.
        self.scheduler = scheduler
        self.last_maintenance: dict | None = None

    def _prefill_seq(self, prompt_tokens) -> tuple[int, int]:
        """Full-prompt prefill into a fresh sequence: one model prefill,
        one bulk KV append. Returns ``(sid, first_token)``."""
        toks = torch.as_tensor(np.asarray(prompt_tokens, np.int64).reshape(1, -1),
                               device=self.device)
        logits, cache = self.model.prefill(self.params, dict(tokens=toks))
        sid = self.kv.new_seq()
        # cache k/v: (L, 1, S, Hkv, D) → (L, S, Hkv, D)
        self.kv.append_prefill(sid, cache["k"][:, 0], cache["v"][:, 0])
        return sid, int(torch.argmax(logits[0]))

    def add_request(self, prompt_tokens: np.ndarray) -> int:
        """Admit a prompt; returns the sequence id.

        Admission probes the golden-prefix trie first: when a registered
        base's prompt is a prefix of this one, the base is COW-forked (the
        shared prefix takes no fresh pool blocks and no prefill FLOPs) and
        only the suffix runs, in one suffix-prefill pass. An exact match
        skips the model entirely (the base's first token was recorded at
        registration). Without a trie hit this is the ordinary full
        prefill.
        """
        toks = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        depth, gsid = self._trie.longest_prefix(toks)
        if gsid is not None:
            self.golden_hits += 1
            sid = self.kv.fork(gsid)
            suffix = toks[depth:]
            nxt = (self._suffix_prefill(sid, suffix) if suffix
                   else self._golden_info[gsid][1])
            self.active[sid] = [nxt]
            return sid
        sid, first = self._prefill_seq(prompt_tokens)
        self.active[sid] = [first]
        return sid

    def _suffix_prefill(self, sid: int, tokens) -> int:
        """Push a prompt suffix through one ``paged_suffix_prefill`` pass
        against the sequence's paged prefix and return the first generated
        token. The pass always attends through block tables (the CUDA
        paged-attention kernel), whatever ``decode_path`` is. The chunk is
        padded to a power-of-two bucket: padded rows scatter into the
        reserved scratch block with attention length 1, and their outputs
        are discarded."""
        s = len(tokens)
        pad = self._bucket(s)
        start = self.kv.seq_length(sid)
        table, blks, offs = self.kv.prepare_span(sid, s)
        m = table.size
        # one host array, one transfer: each row's table (the sequence's,
        # repeated), then its slot block, slot offset, attention length and
        # token
        host = np.zeros((pad, m + 4), np.int32)
        host[:, :m] = np.where(table >= 0, table, self._pad_block)
        host[:, m] = self._pad_block
        host[:s, m] = blks
        host[:s, m + 1] = offs
        host[:, m + 2] = 1
        host[:s, m + 2] = start + 1 + np.arange(s)
        host[:s, m + 3] = tokens
        dev = torch.as_tensor(host, device=self.device)
        logits, pk, pv = paged_suffix_prefill(
            self.cfg, self.params, self.kv.pool_k, self.kv.pool_v,
            dev[:, :m].contiguous(), dev[:, m], dev[:, m + 1],
            dev[:, m + 2].contiguous(), dev[None, :, m + 3].long(),
        )
        self.kv.commit_pools(pk, pv)
        self.kv.advance_span(sid, s)
        return int(torch.argmax(logits[s - 1]))

    def register_golden(self, prompt_tokens: np.ndarray) -> int:
        """Prefill a prompt and freeze it as a golden shared-prefix base.

        The base never joins the decode batch: it exists to be forked by
        later ``add_request`` admissions whose prompts extend its token
        ids. Its KV blocks stay frozen and device-resident
        (``PagedKVCache.register_golden``) until ``release_golden``.
        Returns the base's sid.
        """
        toks = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        sid, first = self._prefill_seq(prompt_tokens)
        self.kv.register_golden(sid)
        self._trie.insert(toks, sid)
        self._golden_info[sid] = (tuple(toks), first)
        return sid

    def release_golden(self, sid: int) -> None:
        """Retire a golden base: unregister it from the trie and the KV
        plane, then free it. Live forks keep their shared blocks through
        the usual refcounts (the base is tombstoned until the last fork
        frees)."""
        toks, _ = self._golden_info.pop(sid)
        self._trie.remove(list(toks))
        self.kv.release_golden(sid)
        self.kv.free_seq(sid)

    def fork_request(self, sid: int) -> int:
        child = self.kv.fork(sid)   # promotes a parked parent first
        tokens = self.active.get(sid) or self.parked.get(sid) or []
        self.active[child] = list(tokens)
        return child

    def finish_request(self, sid: int) -> None:
        """Retire a finished sequence and release its blocks to the pool
        (tombstoned while live forks pin it). Parked sequences may finish
        too: their host-tier spill is dropped with them, never promoted."""
        if sid in self.active:
            del self.active[sid]
        else:
            del self.parked[sid]
        self.kv.free_seq(sid)

    def park_request(self, sid: int) -> int:
        """Suspend a sequence: drop it from the decode batch and spill its
        exclusively-owned KV blocks to the host tier, freeing device pool
        blocks for other admissions. Shared blocks (live forks, common
        prefixes) stay hot and stay shared. Returns the number of blocks
        spilled (0 is fine: parking is always legal, spilling is
        best-effort)."""
        self.parked[sid] = self.active.pop(sid)
        return self.kv.demote_seq(sid)

    def resume_request(self, sid: int) -> None:
        """Re-activate a parked sequence. Promotion is deliberately NOT
        done here: the first ``step()`` including the sequence promotes
        it before its resolve, so a resume costs nothing until the
        sequence actually decodes."""
        self.active[sid] = self.parked.pop(sid)

    def migrate_request_to(self, dst: "Engine", sid: int) -> int:
        """Live-migrate a sequence to another engine; returns its sid there.

        The sequence's resolved KV state is exported from this engine's
        cache, imported into ``dst`` as a fresh root (the fork topology
        stays behind), bit-verified against the export, and only then
        retired here via ``finish_request``, which tombstones/reaps exactly
        as a normal finish. A parked sequence migrates too (its host-tier
        spill is read, never promoted) and lands *active* on ``dst``.
        Raises ``RuntimeError``, with the destination copy rolled back, if
        a decode step landed on the source mid-migration (stale export) or
        the landed bytes differ.
        """
        blob = self.kv.export_seq(sid)
        tokens = list(self.active.get(sid) or self.parked.get(sid) or [])
        new_sid = dst.kv.import_seq(blob)
        k, v = dst.kv.gather(new_sid)
        landed_ok = (fleet_lib._same_bytes(k, blob["k"])
                     and fleet_lib._same_bytes(v, blob["v"]))
        stale = self.kv.seq_fingerprint(sid) != blob["fingerprint"]
        if stale or not landed_ok:
            dst.kv.free_seq(new_sid)
            raise RuntimeError(
                f"migration of sid {sid} aborted "
                + ("(source sequence changed mid-migration)" if stale
                   else "(destination KV not bit-identical)")
                + "; source left intact"
            )
        dst.active[new_sid] = tokens
        self.finish_request(sid)
        return new_sid

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two: the batch is padded to a size bucket."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _decode(self, sids, last_tokens) -> dict[int, int]:
        """ONE fleet-batched decode: COW-prepare, attention, pool commit,
        advance — for ``sids`` feeding ``last_tokens``. Returns
        ``{sid: next_token}``."""
        pad_to = self._bucket(len(sids))
        tok_col = np.zeros((pad_to, 1), np.int64)
        tok_col[: len(sids), 0] = last_tokens
        tokens = torch.as_tensor(tok_col, device=self.device)
        if self.decode_path == "fused":
            # no table materialization: the narrow COW-prepare resolve
            # stamps this step's write slots, then every layer reads K/V
            # straight through the stacked fleet index
            plan = self.kv.prepare_step_fused(
                sids, pad_to=pad_to, pad_block=self._pad_block
            )
            logits, pk, pv = paged_decode_step_fused(
                self.cfg, self.params, self.kv.pool_k, self.kv.pool_v,
                plan.l2, plan.chain_lengths, plan.tenants, plan.lengths,
                plan.write_blocks, tokens,
            )
        else:
            # ONE stacked fleet resolve serves both the COW-prepare mask and
            # the attention block tables; a lone sequence takes the narrow
            # single-row resolve — O(C·P), not O(T·C·P)
            if len(sids) == 1:
                tables, lengths = self.kv.prepare_step_single(
                    sids[0], pad_to=pad_to, pad_block=self._pad_block
                )
            else:
                tables, lengths = self.kv.prepare_step(
                    sids, pad_to=pad_to, pad_block=self._pad_block
                )
            logits, pk, pv = paged_decode_step(
                self.cfg, self.params, self.kv.pool_k, self.kv.pool_v,
                tables, lengths, tokens,
            )
        self.kv.commit_pools(pk, pv)
        out = {}
        # the sampling boundary: greedy argmax must reach the host to
        # extend python-side sequences — the one designed sync in step()
        nxt = np.asarray(torch.argmax(logits, dim=-1).cpu())  # fleetlint: disable=FL002
        for i, sid in enumerate(sids):
            self.kv.advance(sid)
            out[sid] = int(nxt[i])
        return out

    def step(self) -> dict[int, int]:
        """Decode one token for every active sequence — one fleet-batched
        dispatch over the batch padded to a size bucket — then run one
        maintenance tick when a scheduler is attached."""
        sids = sorted(self.active)
        if not sids:
            # an idle engine is the cheapest time for background work —
            # keep draining the maintenance backlog while polling
            self._maintain()
            return {}
        out = self._decode(sids, [self.active[s][-1] for s in sids])
        for sid, tok in out.items():
            self.active[sid].append(tok)
        self._maintain()
        return out

    def _maintain(self) -> None:
        """One budgeted maintenance slice between decode steps: stream/GC
        a few tenants instead of ever stopping the world."""
        if self.scheduler is not None:
            self.last_maintenance = self.scheduler.tick()

    def memory_stats(self) -> dict:
        stats = dict(
            blocks_in_use=self.kv.blocks_in_use(),
            host_blocks=self.kv.host_blocks_in_use(),
            lookups=self.kv.lookup_count,
            n_seqs=len(self.active),
            n_parked=len(self.parked),
            golden_hits=self.golden_hits,
            **self.kv.golden_stats(),
        )
        if self.scheduler is not None:
            stats["maintenance"] = self.scheduler.stats()
        return stats
