"""CUDA kernels: decode attention over a paged KV pool.

The counterparts of ``repro.kernels.paged_attention.paged_attention``'s
``paged_attention_pallas`` (attention through a materialized block table)
and ``fused_chain_attention_pallas`` (attention that walks the stacked
fleet index itself): hand-written CUDA C++ in ``csrc/paged_attention.cu``,
built for Hopper by ``kernels._build``. Beside the JAX-signature tables
entry, ``paged_attention_shared_table_cuda`` is the same kernel source for
rows that all read one table (golden admission's suffix prefill: S
positions of one sequence, each with its own length).

What bounds them on the card is device-memory bytes: per position and KV
head, 4·D bytes of bf16 K/V for 4·G·D flops, 8 flops a byte at G = 8
against the card's ridge of ~295. Short of that bound, what costs time is
too little in flight (a batch of 8 rows over 2 KV heads is 16 (row, head)
pairs for 132 SMs), mma rows with no query on them, and each block's
fixed cost. So:

- **Split over the SMs** (flash-decoding): a one-warp block attends over
  ``pages_per_split`` pages of one row and one KV head and leaves f32
  partials ``(m, l, acc)`` in scratch this wrapper allocates; a combine
  kernel folds a row's splits in a fixed order under the same guards (a
  block a (row, head), or a warp where there are many). Everything comes
  from ``plan`` below, from shapes only: no host sync, no grid that
  depends on lengths.
- **Async pages:** ``cp.async`` 16-byte copies into a ring of up to three
  16-token stages.
- **Tensor cores for bf16** (``mma.sync.m16n8k16``, f32 accumulate) in one
  of two layouts, picked from the group G = H / Hkv alone: for G ≤ 8 the
  16 tokens of a tile on the mma's rows and the group's heads on its n8
  columns (``TOKENS``: half the mma and expf of 16 heads' rows); above,
  16 query heads on the rows (``HEADS``). **f32 keeps FFMA** in one-warp
  blocks (TF32 would break its 2e-5 tolerance).
- **The shared table** puts 16 (row, head) queries of one KV head on the
  mma's rows and lets a block's warps (query tiles) share each staged
  K/V tile, so a page reaches shared memory once for every 16·W queries
  instead of once a row.
- **K4's walk is warp-cooperative** and covers only its split's pages:
  32 layers a load, ``__ballot_sync`` + ``__ffs`` for the top-most hit.

K3 ≡ K4 bitwise: one attention body and one combine serve both, and both
take their plan from the same planner, which never looks at M or P, so on
the same pool rows they partition every row identically and agree bit for
bit. (K4's grid spans ``ceil(P / pps)`` splits and K3's ``ceil(M / pps)``:
the difference is idle blocks only.)

The wrappers take CUDA tensors only, check what the kernels take (bf16 or
f32 activations and pools, int32 indices, contiguous, a head dim the
kernels are built for), allocate scratch and output, launch on the current
stream without synchronising, and count one launch however many CUDA
kernels the pass uses (the shared-table entry counts as K3,
``paged_attention``). ``ops`` dispatches CPU tensors to the plain versions
in ``ref``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA source instantiates
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the bf16 body's layouts: query heads on the mma's 16 rows, or a tile's
#: 16 tokens on them and up to 8 query heads on its n8 columns (f32 has one
#: FFMA body, launched as ``HEADS``)
HEADS, TOKENS = 0, 1
#: the largest group that takes ``TOKENS``
TOKENS_MAX_GROUP = 8
#: tokens a ring stage holds, and the most stages
TILE, MAX_STAGES = 16, 3
#: pages a split once the batch's (row, KV head) pairs outnumber the SMs
WIDE_PAGES_PER_SPLIT = 2
#: the shared-table block: up to ``SHARED_WARPS`` query tiles of 16 over
#: ``SHARED_PAGES_PER_SPLIT`` pages (a sweep of 1-8 warps x 1-16 pages on
#: an H100, PERF.md)
SHARED_WARPS = 4
SHARED_PAGES_PER_SPLIT = 4
#: the combine takes a warp a (row, head) pair, not a block, from this
#: many pairs an SM up (the suffix prefill's 256 rows, large batches)
WARP_COMBINE_PAIRS_PER_SM = 8
#: the most dynamic shared memory a Hopper block may use
_SMEM_LIMIT = 232_448


def head_tile(dtype: torch.dtype, layout: int) -> int:
    """Queries one warp's tile holds: the mma's 16 rows (bf16 ``HEADS``),
    its 8 columns (``TOKENS``), or 8 heads of the FFMA body (f32)."""
    if dtype == torch.float32:
        return 8
    return 16 if layout == HEADS else 8


def layout_for(n_heads: int, n_kv_heads: int, dtype: torch.dtype) -> int:
    """The body's layout, from the group alone: bf16 groups of up to 8
    heads take ``TOKENS`` (every config the repo serves: G 1-8)."""
    if dtype == torch.bfloat16 and n_heads // n_kv_heads <= TOKENS_MAX_GROUP:
        return TOKENS
    return HEADS


def pages_per_split(batch: int, n_kv_heads: int, n_sms: int) -> int:
    """Pages one block attends over, from shapes only.

    One page a block while the batch's (row, KV head) pairs do not
    outnumber the SMs: then even short rows spread over the card (at batch
    8 and 2 KV heads, a row of 80 tokens is 10 blocks). Beyond that, two:
    ``chip_smoke.py``'s split sweep (phase 5) times 1-16 pages a split, and
    at batch 512 over 2 KV heads and batch 64 over 4 two pages beat one by
    10-13 % (half the partials, a two-stage ring) and beat 4, 8 and 16,
    where one warp walks more pages in turn.
    """
    return 1 if batch * n_kv_heads <= n_sms else WIDE_PAGES_PER_SPLIT


def warp_combine(rows: int, n_heads: int, n_sms: int) -> bool:
    """A warp a (row, head) pair in the combine once there are
    ``WARP_COMBINE_PAIRS_PER_SM`` pairs an SM: then a 256-thread block a
    pair would pay its barriers for a few splits each."""
    return rows * n_heads >= WARP_COMBINE_PAIRS_PER_SM * n_sms


@dataclass(frozen=True)
class SplitPlan:
    """The launch the kernels make for one call."""

    pages_per_split: int
    splits: int          # ceil(pages / pages_per_split)
    stages: int          # ring stages a block uses
    grid: tuple[int, int, int]   # decode: (splits, KV heads x head tiles,
    #                              batch); shared: (splits, KV heads, query blocks)
    layout: int          # HEADS or TOKENS
    warps: int           # warps a block (decode: one)
    warp_combine: bool   # the combine: a warp a (row, head) pair, or a block
    group: int = 0       # shared table: heads a row (0: a decode plan)

    def working_blocks(self, lengths, block_size: int, n_pages: int) -> int:
        """Blocks that attend over something, for host-side ``lengths``
        (the rest return at once). For reports and tests only: the
        kernels never need it."""
        span = self.pages_per_split * block_size
        lens = [max(0, min(int(n), n_pages * block_size)) for n in lengths]
        if self.group:       # a query block attends up to its longest row
            per = self.warps * 16
            lens = [max(lens[z * per // self.group:
                             -(-(z + 1) * per // self.group)], default=0)
                    for z in range(self.grid[2])]
        return sum(-(-n // span) for n in lens) * self.grid[1]


def plan(batch: int, n_heads: int, n_kv_heads: int, n_pages: int,
         block_size: int, dtype: torch.dtype, n_sms: int,
         pps: int | None = None) -> SplitPlan:
    """A decode call's layout, split, grid, ring and combine; K3 passes its
    M, K4 its P. ``pps`` overrides the planner's pages a split (for
    measurements)."""
    pps = pps or pages_per_split(batch, n_kv_heads, n_sms)
    layout = layout_for(n_heads, n_kv_heads, dtype)
    tiles = -(-(n_heads // n_kv_heads) // head_tile(dtype, layout))
    splits = -(-n_pages // pps)
    stages = min(MAX_STAGES, -(-pps * block_size // TILE))
    return SplitPlan(pps, splits, stages, (splits, n_kv_heads * tiles, batch),
                     layout, 1, warp_combine(batch, n_heads, n_sms))


def shared_plan(rows: int, n_heads: int, n_kv_heads: int, n_pages: int,
                block_size: int, dtype: torch.dtype, n_sms: int) -> SplitPlan:
    """The shared-table entry's plan. bf16: ``HEADS``, blocks of up to
    ``SHARED_WARPS`` query tiles of 16 (row, head) queries of one KV head
    over ``SHARED_PAGES_PER_SPLIT`` pages. f32: the decode plan of the
    tables kernel (one-warp blocks), every row reading the one table."""
    if dtype == torch.float32:
        return plan(rows, n_heads, n_kv_heads, n_pages, block_size, dtype,
                    n_sms)
    group = n_heads // n_kv_heads
    qtiles = -(-rows * group // 16)
    warps = min(SHARED_WARPS, qtiles)
    pps = SHARED_PAGES_PER_SPLIT
    splits = -(-n_pages // pps)
    stages = min(MAX_STAGES, -(-pps * block_size // TILE))
    return SplitPlan(pps, splits, stages,
                     (splits, n_kv_heads, -(-qtiles // warps)), HEADS, warps,
                     warp_combine(rows, n_heads, n_sms), group)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: threads of the combine kernel
COMBINE_THREADS = 256


def _smem_bytes(dtype: torch.dtype, d: int, p: SplitPlan) -> tuple[int, int]:
    """Mirror of the CUDA source's shared memory: the split pass
    (``body_bytes``, one ring, and the row list; the shared-table block's
    reduce scratch too) and the combine (``combine_floats``: a block's
    slices and weights, or each warp's weights)."""
    if dtype == torch.bfloat16:
        body = p.stages * 2 * TILE * (d + 8) * 2
    else:
        gt = head_tile(torch.float32, HEADS)
        body = p.stages * TILE * (2 * d + 4) * 4 + 4 * (gt * d + gt * TILE + gt)
    body += 4 * (p.pages_per_split + (SHARED_WARPS if p.group else 0))
    if p.warp_combine:
        combine = 4 * (COMBINE_THREADS // 32) * p.splits
    else:
        combine = 4 * (4 * COMBINE_THREADS + COMBINE_THREADS // 32 + p.splits)
    return body, combine


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
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    hkv = pool_k.shape[2]
    if h % hkv:
        raise ValueError(f"{name}: {h} query heads over {hkv} KV heads")
    return b, h, d, hkv


def _scratch(name, p: SplitPlan, q):
    b, h, d = q.shape
    smem = max(_smem_bytes(q.dtype, d, p))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} B of shared memory needed")
    # f32 partials: acc (B, splits, H, D), then m and l (B, splits, H)
    return torch.empty(b * p.splits * h * (d + 2), dtype=torch.float32,
                       device=q.device)


def paged_attention_cuda(q, pool_k, pool_v, tables, lengths, *,
                         pages_per_split=None):
    """q: (B, H, D); pool_k/v: (nb, bs, Hkv, D); tables: (B, M) int32;
    lengths: (B,) int32. Returns (B, H, D) in q.dtype. Table entries are
    clamped to 0 for the load and masking comes from ``lengths`` alone,
    as in the Pallas kernel. ``pages_per_split`` overrides the planner's
    (``chip_smoke.py`` times each)."""
    b, h, d, hkv = _check("paged_attention", q, pool_k, pool_v,
                          (tables, lengths))
    nb, bs = pool_k.shape[:2]
    m = tables.shape[1]
    if tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_attention: tables (B, M), lengths (B,)")
    out = torch.empty_like(q)
    if b == 0 or m == 0:
        return out.zero_()
    p = plan(b, h, hkv, m, bs, q.dtype, sm_count(q.device), pages_per_split)
    scratch = _scratch("paged_attention", p, q)
    lib = _build.library()
    code = lib.paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, h, hkv, d,
        nb, bs, m, p.pages_per_split, p.layout, int(p.warp_combine),
        _DTYPES[q.dtype], _build.launch_stream(q))
    _build.check_launch("paged_attention", code)
    return out


def paged_attention_shared_table_cuda(q, pool_k, pool_v, table, lengths):
    """K3 for rows that all read one table: q: (S, H, D); pool_k/v: (nb,
    bs, Hkv, D); table: (M,) int32; lengths: (S,) int32, each row's own.
    Returns (S, H, D) in q.dtype: ``paged_attention_cuda`` on the table
    repeated S times, entries clamped to 0 and masking from ``lengths``
    alone. Counts as a ``paged_attention`` launch."""
    s, h, d, hkv = _check("paged_attention_shared_table", q, pool_k, pool_v,
                          (table, lengths))
    nb, bs = pool_k.shape[:2]
    if table.dim() != 1 or lengths.shape != (s,):
        raise ValueError("paged_attention_shared_table: table (M,), lengths (S,)")
    m = table.shape[0]
    out = torch.empty_like(q)
    if s == 0 or m == 0:
        return out.zero_()
    p = shared_plan(s, h, hkv, m, bs, q.dtype, sm_count(q.device))
    scratch = _scratch("paged_attention_shared_table", p, q)
    lib = _build.library()
    code = lib.paged_attention_shared(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(), s, h, hkv, d,
        nb, bs, m, p.pages_per_split, p.warps, int(p.warp_combine),
        _DTYPES[q.dtype], _build.launch_stream(q))
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
    out = torch.empty_like(q)
    if b == 0 or p == 0:
        return out.zero_()
    sp = plan(b, h, hkv, p, bs, q.dtype, sm_count(q.device))
    scratch = _scratch("fused_chain_attention", sp, q)
    lib = _build.library()
    code = lib.fused_chain_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), w0.data_ptr(),
        chain_lengths.data_ptr(), tenants.data_ptr(), kv_lengths.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), b, h, hkv, d, nb, bs, t, c, p,
        sp.pages_per_split, sp.layout, int(sp.warp_combine),
        _DTYPES[q.dtype], _build.launch_stream(q))
    _build.check_launch("fused_chain_attention", code)
    return out
