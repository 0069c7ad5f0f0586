"""Dispatch for the paged decode attention kernels.

A CUDA tensor goes to the CUDA kernel (``paged_attention``), which
launches or raises; a CPU tensor goes to the plain version (``ref``).
Nothing falls back from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    fused_chain_attention_cuda,
    paged_attention_cuda,
    paged_attention_shared_table_cuda,
)


def paged_attention(q, pool_k, pool_v, tables, lengths):
    """Decode attention through direct block tables → (B, H, D)."""
    if q.is_cuda:
        return paged_attention_cuda(q, pool_k, pool_v, tables, lengths)
    return ref.paged_attention_ref(q, pool_k, pool_v, tables, lengths)


def paged_attention_shared_table(q, pool_k, pool_v, table, lengths):
    """Attention of S rows that all read one table (M,), each up to its
    own length → (S, H, D)."""
    if q.is_cuda:
        return paged_attention_shared_table_cuda(q, pool_k, pool_v, table,
                                                 lengths)
    return ref.paged_attention_shared_table_ref(q, pool_k, pool_v, table,
                                                lengths)


def fused_chain_attention(q, pool_k, pool_v, w0, chain_lengths, tenants,
                          kv_lengths):
    """Decode attention through the stacked (T, C, P) index → (B, H, D)."""
    if q.is_cuda:
        return fused_chain_attention_cuda(q, pool_k, pool_v, w0, chain_lengths,
                                          tenants, kv_lengths)
    return ref.fused_chain_attention_ref(q, pool_k, pool_v, w0, chain_lengths,
                                         tenants, kv_lengths)
