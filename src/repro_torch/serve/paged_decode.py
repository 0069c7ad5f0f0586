"""Paged decode step for dense and MoE transformers (PyTorch port of
``repro.serve.paged_decode``).

Reads K/V through *direct block tables* (``paged_decode_step``) or
through the stacked fleet index itself (``paged_decode_step_fused``) from
a shared paged pool. Per-sequence positions come from ``lengths``
(sequences in a continuous batch are at different positions).
``paged_suffix_prefill`` is golden admission's step: the S suffix tokens
of one forked sequence in one pass, attending over its paged prefix.

Port notes: the JAX scan over layers is a Python loop, and the pools are
updated **in place** — this step's K/V is written into its slot *before*
the same layer's attention reads it, the order the JAX scan's functional
``.at[].set`` gives — then returned for ``PagedKVCache.commit_pools``.
On the card every layer runs the CUDA attention kernel; on the CPU the
kernels' plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import embed_tokens, ff, output_matrix


def _layers(cfg: ModelConfig, params, pool_k, pool_v, x, positions, write_at,
            attend):
    """The shared layer loop over ``x``: (R, N, d), R rows of N tokens (a
    decode step: R sequences of one token each; a suffix prefill: one row
    of N tokens). Per layer: project, scatter the R·N new K/V rows at
    ``write_at = (blocks, offsets)`` (each (R·N,)), then attend through
    ``attend(q, pk, pv)`` with the R·N queries on its batch axis, then the
    feed-forward (an MLP, or the MoE over all R·N rows: padded rows are
    routed and take expert capacity, as in the JAX package). Returns the
    final hidden state."""
    r, n = x.shape[:2]
    blk, off = write_at
    for i in range(cfg.n_layers):
        p = L.layer(params["layers"], i)
        pk, pv = pool_k[i], pool_v[i]
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, positions, rope_theta=cfg.rope_theta,
                             use_rope=cfg.use_rope)
        pk[blk, off] = k.flatten(0, 1).to(pk.dtype)
        pv[blk, off] = v.flatten(0, 1).to(pv.dtype)
        attn = attend(q.flatten(0, 1).to(L.COMPUTE_DTYPE).contiguous(), pk, pv)
        x = x + attn.reshape(r, n, -1).to(x.dtype) @ p["attn"]["wo"].to(x.dtype)
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + ff(cfg, p["ff"], h2)[0]
    return L.rmsnorm(x, params["ln_f"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params, x):
    """Logits of every token of ``x`` (R, N, d): (R·N, V) float32."""
    return (x.flatten(0, 1) @ output_matrix(cfg, params).to(x.dtype)).float()


def paged_decode_step(cfg: ModelConfig, params, pool_k, pool_v, tables,
                      lengths, tokens):
    """One decode step for B sequences.

    pool_k/pool_v: (L, nb, bs, Hkv, D); tables: (B, M) int32 (direct);
    lengths: (B,) int32 (tokens already in each sequence); tokens: (B, 1).
    Returns (logits (B, V) f32, pool_k, pool_v), the pools updated in place.
    """
    bs = pool_k.shape[2]
    x = embed_tokens(params, tokens)                           # (B,1,d)
    positions = lengths[:, None]                               # (B,1)
    # JAX clamps the column gather; torch would raise past the table
    col = (lengths // bs).clamp(max=tables.shape[1] - 1).to(torch.int64)
    blk = tables.gather(1, col[:, None])[:, 0].to(torch.int64)
    off = (lengths % bs).to(torch.int64)
    kv_len = lengths + 1

    def attend(q, pk, pv):
        return pa_ops.paged_attention(q, pk, pv, tables, kv_len)

    x = _layers(cfg, params, pool_k, pool_v, x, positions, (blk, off), attend)
    return _logits(cfg, params, x), pool_k, pool_v


def paged_suffix_prefill(cfg: ModelConfig, params, pool_k, pool_v, tables,
                         slots_blk, slots_off, attn_lens, tokens):
    """Prefill S suffix tokens of ONE sequence whose first tokens already
    sit in the paged pool: the golden-fork admission step.

    A suffix chunk is ordinary causal prefill against a paged prefix: per
    layer, every suffix position's K/V is computed from the same input
    hidden states and scattered into its COW-prepared pool slot first, then
    attention runs the S positions as a *batch of S queries* over the
    sequence's block table with per-position lengths: position i sees the
    prefix plus suffix tokens ``<= i``. One pass replaces S decode steps.

    pool_k/pool_v: (L, nb, bs, Hkv, D); tables: (S, M) int32, contiguous
    (the sequence's table repeated per position: attention reads row 0,
    through the shared-table kernel); slots_blk/slots_off: (S,)
    pool slot of each suffix position (padded positions point at a
    reserved scratch block); attn_lens: (S,) int32, prefix + i + 1 for real
    positions (1 for padded rows, whose outputs are discarded); tokens:
    (1, S). Returns (logits (S, V) f32, pool_k, pool_v), the pools updated
    in place; the caller reads the last *real* row.
    """
    x = embed_tokens(params, tokens)                           # (1,S,d)
    positions = (attn_lens - 1)[None, :]                       # (1,S)
    table = tables[0]

    def attend(q, pk, pv):
        return pa_ops.paged_attention_shared_table(q, pk, pv, table, attn_lens)

    x = _layers(cfg, params, pool_k, pool_v, x, positions,
                (slots_blk.to(torch.int64), slots_off.to(torch.int64)), attend)
    return _logits(cfg, params, x), pool_k, pool_v


def paged_decode_step_fused(cfg: ModelConfig, params, pool_k, pool_v, l2,
                            chain_lengths, tenants, lengths, write_blocks,
                            tokens):
    """One decode step reading K/V *through the stacked fleet index*.

    No block tables exist on this path: every layer's attention receives
    the packed word0 stacks, per-tenant ``chain_lengths`` and the batch's
    ``tenants`` and resolves each KV block by walking the chain itself
    (the fused CUDA kernel). The in-step K/V scatter lands in
    ``write_blocks`` — the COW-prepared slots
    ``PagedKVCache.prepare_step_fused`` stamped into the index, so the walk
    resolves the write block too.

    pool_k/pool_v: (L, nb, bs, Hkv, D); l2: (T, C, P, 2) int32;
    chain_lengths: (T,); tenants/lengths/write_blocks: (B,) int32;
    tokens: (B, 1). Returns (logits (B, V) f32, pool_k, pool_v).
    """
    bs = pool_k.shape[2]
    x = embed_tokens(params, tokens)                           # (B,1,d)
    positions = lengths[:, None]                               # (B,1)
    w0 = l2[..., 0].contiguous()
    off = (lengths % bs).to(torch.int64)
    kv_len = lengths + 1

    def attend(q, pk, pv):
        return pa_ops.fused_chain_attention(q, pk, pv, w0, chain_lengths,
                                            tenants, kv_len)

    x = _layers(cfg, params, pool_k, pool_v, x, positions,
                (write_blocks.to(torch.int64), off), attend)
    return _logits(cfg, params, x), pool_k, pool_v
