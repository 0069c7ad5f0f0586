"""CUDA kernels: decode attention over a paged KV pool.

The counterparts of ``repro.kernels.paged_attention.paged_attention``'s
``paged_attention_pallas`` (attention through a materialized block table)
and ``fused_chain_attention_pallas`` (attention that walks the stacked
fleet index itself): hand-written CUDA C++ in ``csrc/paged_attention.cu``,
built for Hopper by ``kernels._build``. Both kernels share one attention
body, so on the same pool rows they give bit-identical outputs.

The wrappers take CUDA tensors only, check what the kernels take
(bf16 or f32 activations and pools, int32 indices, contiguous), allocate
the output, launch on the current stream without synchronising, and count
the launch. ``ops`` dispatches CPU tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most dynamic shared memory a Hopper block may use
_SMEM_LIMIT = 232_448


def _smem_bytes(g: int, d: int, bs: int, n_rows: int) -> int:
    """Mirror of ``attend_floats`` in the CUDA source, plus the row list."""
    floats = g * d + bs * (d + 1) + bs * d + g * bs + g * d + 3 * g
    return 4 * floats + 4 * n_rows


def _check(name, q, pool_k, pool_v, ints):
    for x in (q, pool_k, pool_v, *ints):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q dtype {q.dtype} not in {list(_DTYPES)}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"{name}: pools must share q's dtype {q.dtype}")
    for x in ints:
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got {x.dtype}")
    b, h, d = q.shape
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4 or pool_k.shape[3] != d:
        raise ValueError(f"{name}: pools must be (nb, bs, Hkv, {d})")
    hkv = pool_k.shape[2]
    if h % hkv:
        raise ValueError(f"{name}: {h} query heads over {hkv} KV heads")
    return b, h, d, hkv


def paged_attention_cuda(q, pool_k, pool_v, tables, lengths):
    """q: (B, H, D); pool_k/v: (nb, bs, Hkv, D); tables: (B, M) int32;
    lengths: (B,) int32. Returns (B, H, D) in q.dtype. Table entries are
    clamped to 0 for the load and masking comes from ``lengths`` alone,
    as in the Pallas kernel."""
    b, h, d, hkv = _check("paged_attention", q, pool_k, pool_v,
                          (tables, lengths))
    nb, bs = pool_k.shape[:2]
    m = tables.shape[1]
    if tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention: tables (B, M), lengths (B,)")
    smem = _smem_bytes(h // hkv, d, bs, m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: {smem} B of shared memory needed")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    code = lib.paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, hkv, d, nb, bs, m,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("paged_attention", code)
    return out


def fused_chain_attention_cuda(q, pool_k, pool_v, w0, chain_lengths, tenants,
                               kv_lengths):
    """Decode attention that walks the snapshot chain inside the kernel.

    ``w0``: (T, C, P) int32 packed word0 of the stacked fleet index;
    ``chain_lengths``: (T,); ``tenants``/``kv_lengths``: (B,) int32. Holes
    (first-hit misses) and positions >= ``kv_lengths`` are masked; a row
    with nothing to attend to outputs zeros. Returns (B, H, D) in q.dtype.
    """
    b, h, d, hkv = _check("fused_chain_attention", q, pool_k, pool_v,
                          (w0, chain_lengths, tenants, kv_lengths))
    nb, bs = pool_k.shape[:2]
    t, c, p = w0.shape
    if chain_lengths.shape != (t,) or tenants.shape != (b,) \
            or kv_lengths.shape != (b,):
        raise ValueError("fused_chain_attention: chain_lengths (T,), "
                         "tenants/kv_lengths (B,)")
    smem = _smem_bytes(h // hkv, d, bs, p)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_chain_attention: {smem} B of shared memory needed")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    code = lib.fused_chain_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), w0.data_ptr(),
        chain_lengths.data_ptr(), tenants.data_ptr(), kv_lengths.data_ptr(),
        out.data_ptr(), b, h, hkv, d, nb, bs, t, c, p, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("fused_chain_attention", code)
    return out
