"""Plain PyTorch versions of the paged decode attention kernels.

Line for line the oracles of ``repro.kernels.paged_attention.ref``:
``paged_attention_ref`` consumes a materialized direct block table;
``fused_chain_attention_ref`` composes the stacked first-hit chain walk
(``kernels.chain_resolve.ref``) with it, so the fused kernel is held
against two already-pinned versions rather than a third one.
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
