"""Plain PyTorch versions of the paged decode attention kernels.

Line for line the oracles of ``repro.kernels.paged_attention.ref``:
``paged_attention_ref`` consumes a materialized direct block table;
``fused_chain_attention_ref`` composes the stacked first-hit chain walk
(``kernels.chain_resolve.ref``) with it, so the fused kernel is held
against two already-pinned versions rather than a third one.
``paged_attention_shared_table_ref`` is the shared-table entry's: the
table-consuming version on the one table repeated for every row.
``paged_attention_split_ref`` is the CUDA kernels' two-pass algorithm
(per-split partials, then the combine) in plain PyTorch; only tests use it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import resolve as resolve_lib
from repro_torch.kernels.chain_resolve import ref as chain_ref


def paged_attention_ref(q, pool_k, pool_v, tables, lengths):
    """q: (B, H, D); pool_k/v: (nb, bs, Hkv, D); tables: (B, M) int32
    (-1 = absent); lengths: (B,) int32. Returns (B, H, D) in q.dtype.

    GQA: H = Hkv * G. Softmax in f32.
    """
    b, h, d = q.shape
    nb, bs, hkv, _ = pool_k.shape
    m = tables.shape[1]
    g = h // hkv

    # JAX clamps the out-of-range pool gather; torch would raise
    safe = tables.to(torch.int64).clamp(0, nb - 1)
    k = pool_k[safe].reshape(b, m * bs, hkv, d)        # (B, S, Hkv, D)
    v = pool_v[safe].reshape(b, m * bs, hkv, d)
    pos = torch.arange(m * bs, device=q.device)[None, :]
    mask = (pos < lengths.to(torch.int64)[:, None]) & \
        torch.repeat_interleave(tables >= 0, bs, dim=1)

    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.where(
        mask[:, None, None, :].any(-1, keepdim=True),
        torch.exp(scores - scores.amax(dim=-1, keepdim=True)),
        0.0,
    )
    probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_shared_table_ref(q, pool_k, pool_v, table, lengths):
    """q: (S, H, D); table: (M,) int32, the one table every row reads;
    lengths: (S,) int32. ``paged_attention_ref`` on the table repeated S
    times. Returns (S, H, D) in q.dtype."""
    tables = table[None, :].expand(q.shape[0], table.shape[0])
    return paged_attention_ref(q, pool_k, pool_v, tables, lengths)


def fused_tables_ref(w0, chain_lengths, tenants):
    """Resolve the batch's direct block tables from the stacked index:
    ``w0`` (T, C, P) int32 word0, ``chain_lengths`` (T,), ``tenants`` (B,).
    Returns (B, P) int32 tables with -1 holes; only the batch's tenant rows
    are walked."""
    t = tenants.to(torch.int64).clamp(0, w0.shape[0] - 1)
    owner, hit = chain_ref.resolve_vanilla_fleet_ref(w0[t], chain_lengths[t])
    return resolve_lib.tables_from_hits(owner, hit)


def fused_chain_attention_ref(q, pool_k, pool_v, w0, chain_lengths,
                              tenants, kv_lengths):
    """The fused kernel's plain version: the chain-walk version feeds the
    table-consuming one. Returns (B, H, D) in q.dtype."""
    tables = fused_tables_ref(w0, chain_lengths, tenants)
    return paged_attention_ref(q, pool_k, pool_v, tables, kv_lengths)


def paged_attention_split_ref(q, pool_k, pool_v, tables, lengths,
                              pages_per_split):
    """``paged_attention_ref`` computed as the CUDA kernels compute it:
    each split of ``pages_per_split`` table columns yields f32 partials
    ``(m, l, acc)`` (m = -inf where the split attends to nothing), then the
    splits are folded: weights exp(m_s - max m) under the
    same isfinite guards, out = Σ w·acc / max(Σ w·l, 1e-30). Masks as the
    oracle does (length and -1 entries). Returns (B, H, D) in q.dtype."""
    b, h, d = q.shape
    nb, bs, hkv, _ = pool_k.shape
    m = tables.shape[1]
    g = h // hkv
    pps = pages_per_split
    ns = -(-m // pps)
    pad = torch.full((b, ns * pps - m), -1, dtype=tables.dtype,
                     device=tables.device)
    tab = torch.cat([tables, pad], dim=1)
    safe = tab.to(torch.int64).clamp(0, nb - 1)
    span = pps * bs
    k = pool_k[safe].reshape(b, ns, span, hkv, d).float()
    v = pool_v[safe].reshape(b, ns, span, hkv, d).float()
    pos = torch.arange(ns * span, device=q.device)[None, :]
    mask = (pos < lengths.to(torch.int64)[:, None]) & \
        torch.repeat_interleave(tab >= 0, bs, dim=1)
    mask = mask.reshape(b, ns, 1, 1, span)

    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bnshd->bnhgs", qg, k) / math.sqrt(d)
    scores = scores.masked_fill(~mask, float("-inf"))
    m_s = scores.amax(dim=-1)                               # (B, ns, Hkv, G)
    m_safe = torch.where(torch.isfinite(m_s), m_s, 0.0)
    p = torch.where(torch.isfinite(scores),
                    torch.exp(scores - m_safe[..., None]), 0.0)
    l_s = p.sum(-1)
    acc_s = torch.einsum("bnhgs,bnshd->bnhgd", p, v)

    m_all = m_s.amax(dim=1, keepdim=True)
    m_all = torch.where(torch.isfinite(m_all), m_all, 0.0)
    w = torch.where(torch.isfinite(m_s), torch.exp(m_s - m_all), 0.0)
    l_tot = torch.zeros_like(l_s[:, 0])
    acc = torch.zeros_like(acc_s[:, 0])
    for i in range(ns):                                     # split order
        l_tot = l_tot + l_s[:, i] * w[:, i]
        acc = acc + acc_s[:, i] * w[:, i, ..., None]
    out = acc / l_tot.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)
