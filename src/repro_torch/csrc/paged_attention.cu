// Decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention        <- paged_attention_pallas       (_paged_attn_kernel)
//   fused_chain_attention  <- fused_chain_attention_pallas (_fused_chain_attn_kernel)
// and adds paged_attention_shared, the tables kernel for rows that all read
// one table (the golden admission's suffix prefill: S positions of one
// sequence with lengths of their own), beside the JAX-signature entry.
//
// What bounds them on the card: device-memory bytes. Per position and KV
// head a decode step reads 4*D bytes of bf16 K and V and does 4*G*D flops
// (G query heads per KV head): 8 flops a byte at G = 8, against the card's
// ridge of ~295. What costs time short of that bound: too few bytes in
// flight (a batch of 8 rows and 2 KV heads is 16 (row, head) pairs for 132
// SMs), mma rows that hold no query, and per-block fixed costs.
//
// What the design does about it:
// - Split the KV range over the SMs (flash-decoding). A block is one warp
//   and owns (KV head x head tile, split, batch row): `pps` pages of one
//   row and one KV head. It leaves its partial (m, l, acc) in f32 scratch;
//   a combine kernel then folds a row's splits in a fixed order (a block of
//   256 threads a (row, head), or a warp a (row, head) where there are
//   many). Splits past a row's last page return at once, and the combine
//   reads only the ceil(tokens / (pps * bs)) splits that worked. The plan
//   comes from the wrapper's planner, from shapes only
//   (kernels/paged_attention/paged_attention.py). Blocks of 2-8 warps over
//   one split, folding in shared memory, were timed and lost to one warp
//   at every shape the repo serves (PERF.md).
// - Pages reach shared memory by cp.async, 16 bytes a copy, into a ring of
//   up to three 16-token stages. Positions past the range and holes are
//   zero-filled, never read.
// - bf16 runs on the tensor cores: mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), in one of two layouts the planner picks from G:
//   * tokens on rows (G <= 8): S^T = K Q^T with the tile's 16 tokens as the
//     m16 rows and the group's query heads as n8 (Q^T held as B fragments
//     for the whole split), then O^T = V^T P^T: D/8 mma a 16-token tile and
//     4 expf a lane, where 16 heads' rows would cost D/4 mma and 8 expf for
//     at most 8 heads. P^T's B fragment is S^T's accumulator transposed:
//     movmatrix.trans, two a tile. The softmax reduces each query column
//     over the 8 lane groups (xor 4, 8, 16).
//   * heads on rows (G > 8, and the shared-table kernel): S = Q K^T with 16
//     queries as the m16 rows and tokens as n8 tiles; the score fragments
//     become P's A fragments in registers, and O += P V reads V with
//     ldmatrix.trans. In the shared-table kernel the 16 rows are (row,
//     head) pairs of one KV head, each masked by its own row's length, and
//     the block's W warps (W query tiles) share each staged K/V tile: a
//     page reaches shared memory once for every 16 W queries.
//   P is rounded to bf16 for the mma, l summed in f32; K and V stay bf16
//   in shared memory.
// - f32 keeps CUDA-core FFMA in one-warp blocks (TF32 would break the f32
//   tolerance): a lane owns one token of the tile for the scores and D/32
//   output columns for PV, head tiles of 8.
// - K4 resolves only its own split's pages, each with the warp-cooperative
//   first-hit walk (warp_first_hit_row, chain_walk.cuh): 32 layers a load.
//
// The attention bodies are written once and both kernels call them; they
// differ only in where the split's pool rows come from. The tables kernel
// reads tables[b, j] clamped at 0 (paged_attention.py:57-58, :97) and masks
// by length alone; the fused kernel walks the tenant's (C, P) word0 stack
// from min(chain_lengths[t], C) - 1 down and marks holes -1. Both take the
// same plan (split, layout, combine), so on the same rows they give
// bit-identical outputs.
//
// Numerics follow the Pallas kernels: fp32 scores divided by sqrt(D),
// -inf for masked positions and holes, the isfinite guards on m, and
// out = acc / max(l, 1e-30) in the input type, so an all-masked row comes
// out as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "chain_walk.cuh"

#ifndef FMT_FLAG_ALLOCATED
#error "build through repro_torch.kernels._build: the format macros are missing"
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;       // tokens a stage: the k depth of m16n8k16
constexpr int kMaxStages = 3;
constexpr int kMaxWarps = 4;     // the shared-table block's query tiles
constexpr int kHeadTileBf16 = 16;  // heads on rows: the m16 rows of the mma
constexpr int kHeadTileTokens = 8; // tokens on rows: the n8 columns
constexpr int kHeadTileF32 = 8;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use

// the bf16 layouts (f32 has one body and takes kHeads)
enum { kHeads = 0, kTokens = 1 };

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// -- PTX helpers --------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-fill (nothing read) where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// an 8x8 b16 matrix held as the mma's fragments (lane t: row t / 4,
// columns 2 (t % 4) and 2 (t % 4) + 1), transposed across the warp
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Programmatic dependent launch: the combine may start launching once every
// split block got here (or exited), and waits for the split pass's memory
// before it reads the partials.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -- the split --------------------------------------------------------------

// Positions a row attends over: those < length that a table column holds.
__host__ __device__ __forceinline__ int row_tokens(int len, int pages, int bs) {
  const int n = len < pages * bs ? len : pages * bs;
  return n > 0 ? n : 0;
}

// What one warp attends over: tokens [s0, s1) of the block's pages pg0..
// (the block's row list), for the ng query heads h0.. of KV head kvh of
// row b (the shared-table kernel: the queries of its Queries).
struct Split {
  int b, split, kvh, h0, ng, s0, s1, pg0, npg;
  int H, Hkv, bs, bs_shift, NS, stages;
};

// log2(bs) where bs is a power of two (every block size the repo uses),
// else -1: a page index without an integer division
__device__ __forceinline__ int shift_of(int bs) { return (bs & (bs - 1)) ? -1 : __ffs(bs) - 1; }
__device__ __forceinline__ int page_of(const Split& s, int pos) {
  return s.bs_shift >= 0 ? pos >> s.bs_shift : pos / s.bs;
}
__device__ __forceinline__ int in_page(const Split& s, int pos) {
  return s.bs_shift >= 0 ? pos & (s.bs - 1) : pos % s.bs;
}

// Query i of a warp's tile is head h0 + (q0 + i) % per_row of row
// row0 + (q0 + i) / per_row, for q0 + i < n. A decode block's tile is heads
// h0.. of one row (per_row above any tile); the shared-table kernel's runs
// over the (row, head) pairs of one KV head, each row masked by its own
// length (lens, through a table of `pages` columns).
struct Queries {
  int q0, per_row, n, row0, h0;
  const int32_t* lens;
  int pages;
  __device__ __forceinline__ bool valid(int i) const { return q0 + i < n; }
  __device__ __forceinline__ int row(int i) const { return row0 + (q0 + i) / per_row; }
  __device__ __forceinline__ int head(int i) const { return h0 + (q0 + i) % per_row; }
};

// Where a warp leaves its (m, l, acc): the partials of (row, split, head).
struct Sink {
  float *m, *l, *acc;
  __device__ __forceinline__ size_t slot(const Split& s, const Queries& qs, int i) const {
    return ((size_t)qs.row(i) * s.NS + s.split) * s.H + qs.head(i);
  }
};

// Fills the block's split from its grid position (x: KV head x head tile,
// fastest, so neighbouring blocks read the other heads of the same pages;
// y: split; z: row); false if it has no work.
__device__ __forceinline__ bool make_split(Split& s, int ntok, int G, int head_tile,
                                           int pps) {
  const int ngt = (G + head_tile - 1) / head_tile;
  s.b = blockIdx.z;
  s.split = blockIdx.y;
  s.kvh = blockIdx.x / ngt;
  const int g0 = (blockIdx.x % ngt) * head_tile;
  s.h0 = s.kvh * G + g0;
  s.ng = min(head_tile, G - g0);
  s.pg0 = s.split * pps;
  s.s0 = s.pg0 * s.bs;
  s.s1 = min(s.s0 + pps * s.bs, ntok);
  s.npg = (s.s1 + s.bs - 1) / s.bs - s.pg0;
  return s.s0 < s.s1;
}

// Shared-memory bytes of one ring (a warp's, or the shared-table block's).
template <typename T, int D>
__host__ __device__ constexpr int body_bytes(int stages) {
  return sizeof(T) == 2
             ? stages * 2 * kTile * (D + 8) * 2
             : stages * kTile * (2 * D + 4) * 4 +
                   4 * (kHeadTileF32 * D + kHeadTileF32 * kTile + kHeadTileF32);
}

template <typename T, int L>
__host__ __device__ constexpr int head_tile() {
  return sizeof(T) == 4 ? kHeadTileF32 : L == kTokens ? kHeadTileTokens : kHeadTileBf16;
}

// Stage tile [pos0, pos0 + kTile) of the split: K rows at stride KS, V rows
// at stride VS (elements), copied by `nthr` threads (a warp, or the block).
// Positions >= s1 and holes are zero-filled.
template <typename T, int D, int KS, int VS>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* __restrict__ pool_k,
                                          const T* __restrict__ pool_v, const int* rows,
                                          int pos0, const Split& s, int tid, int nthr) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunks = D / kElems;  // 16-byte copies a token row
  for (int c = tid; c < kTile * kChunks; c += nthr) {
    const int tok = c / kChunks, ch = c - tok * kChunks;
    const int pos = pos0 + tok;
    const int row = pos < s.s1 ? rows[page_of(s, pos) - s.pg0] : -1;
    const bool ok = row >= 0;
    const size_t off =
        ok ? ((((size_t)row * s.bs + in_page(s, pos)) * s.Hkv + s.kvh) * D + ch * kElems) : 0;
    cp_async16(ks + tok * KS + ch * kElems, pool_k + off, ok);
    cp_async16(vs + tok * VS + ch * kElems, pool_v + off, ok);
  }
}

// kHoles: the row list may hold -1 (K4's misses); K3's never does
template <bool kHoles>
__device__ __forceinline__ bool attends(const Split& s, const int* rows, int pos) {
  return pos < s.s1 && (!kHoles || rows[page_of(s, pos) - s.pg0] >= 0);
}

template <bool kBlock>
__device__ __forceinline__ void ring_sync() {
  if constexpr (kBlock)
    __syncthreads();
  else
    __syncwarp();
}

// -- bf16, heads on rows --------------------------------------------------------

// kBlock: the block's threads share one ring (the shared-table kernel);
// else the warp has a ring of its own.
template <int D, bool kBlock, bool kHoles>
__device__ void attend_heads(const bf16* __restrict__ q, const bf16* __restrict__ pool_k,
                             const bf16* __restrict__ pool_v, const int* rows,
                             const Split& s, const Queries& qs, const Sink& out,
                             bf16* ring) {
  constexpr int KS = D + 8;  // padded rows: ldmatrix without bank conflicts
  constexpr int kStage = 2 * kTile * KS;
  const int lane = threadIdx.x & 31, grp = lane >> 2, qd = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row of a lane
  const int tid = kBlock ? (int)threadIdx.x : lane, nthr = kBlock ? (int)blockDim.x : 32;
  const int ntiles = s.s1 > s.s0 ? (s.s1 - s.s0 + kTile - 1) / kTile : 0;

  for (int t = 0; t < s.stages; ++t) {
    if (t < ntiles)
      load_tile<bf16, D, KS, KS>(ring + t * kStage, ring + t * kStage + kTile * KS, pool_k,
                                 pool_v, rows, s.s0 + t * kTile, s, tid, nthr);
    cp_async_commit();
  }

  // Q as A fragments: queries grp and grp + 8 of the tile (zero where
  // invalid), each attending up to its row's length
  bool v[2];
  int lim[2];
  const bf16* qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = grp + 8 * r;
    v[r] = qs.valid(i);
    qp[r] = v[r] ? q + ((size_t)qs.row(i) * s.H + qs.head(i)) * D : q;
    lim[r] = !v[r] ? s.s0
             : qs.lens ? min(s.s1, row_tokens(qs.lens[qs.row(i)], qs.pages, s.bs))
                       : s.s1;
  }
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int k = kk * 16 + 2 * qd;
    qa[kk][0] = v[0] ? ld_u32(qp[0] + k) : 0u;
    qa[kk][1] = v[1] ? ld_u32(qp[1] + k) : 0u;
    qa[kk][2] = v[0] ? ld_u32(qp[0] + k + 8) : 0u;
    qa[kk][3] = v[1] ? ld_u32(qp[1] + k + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale = sqrtf((float)D);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(s.stages - 1);
    ring_sync<kBlock>();
    const bf16* kt = ring + (t % s.stages) * kStage;
    const bf16* vt = kt + kTile * KS;

    // S = Q K^T over the tile's two n8 token tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + ((mat >> 1) * 8 + mr) * KS + kk * 16 + (mat & 1) * 8);
      mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
      mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
    }

    // online softmax: element e of token tile nt is query grp + 8 * (e >> 1),
    // token nt * 8 + 2 * qd + (e & 1)
    const int pos0 = s.s0 + t * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + nt * 8 + 2 * qd + (e & 1);
        const bool ok =
            pos < lim[e >> 1] && (!kHoles || rows[page_of(s, pos) - s.pg0] >= 0);
        sc[nt][e] = ok ? sc[nt][e] / scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      alpha[r] = isfinite(m_r[r]) ? expf(m_r[r] - m_safe[r]) : 0.f;
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        const float p = isfinite(x) ? expf(x - m_safe[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        sc[nt][e] = p;
      }
    // the score fragments are P's A fragment (16 queries x 16 tokens)
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + ((mat & 1) * 8 + mr) * KS + (2 * dp + (mat >> 1)) * 8);
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
    ring_sync<kBlock>();  // every thread is done with this stage before it refills
    if (t + s.stages < ntiles)
      load_tile<bf16, D, KS, KS>(ring + (t % s.stages) * kStage,
                                 ring + (t % s.stages) * kStage + kTile * KS, pool_k,
                                 pool_v, rows, s.s0 + (t + s.stages) * kTile, s, tid, nthr);
    cp_async_commit();
  }
  cp_async_wait(0);
  launch_dependents();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
  }
  size_t k[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) k[r] = v[r] ? out.slot(s, qs, grp + 8 * r) : 0;
  if (qd == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (v[r]) out.m[k[r]] = m_r[r], out.l[k[r]] = l_r[r];
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * qd;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (v[r])
        *reinterpret_cast<float2*>(out.acc + k[r] * D + d) =
            make_float2(o[i][2 * r], o[i][2 * r + 1]);
  }
}

// -- bf16, tokens on rows (G <= 8) ------------------------------------------------

template <int D, bool kHoles>
__device__ void attend_tokens(const bf16* __restrict__ q, const bf16* __restrict__ pool_k,
                              const bf16* __restrict__ pool_v, const int* rows,
                              const Split& s, const Queries& qs, const Sink& out,
                              bf16* ring) {
  constexpr int KS = D + 8;
  constexpr int kStage = 2 * kTile * KS;
  const int lane = threadIdx.x & 31, grp = lane >> 2, qd = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int ntiles = s.s1 > s.s0 ? (s.s1 - s.s0 + kTile - 1) / kTile : 0;

  for (int t = 0; t < s.stages; ++t) {
    if (t < ntiles)
      load_tile<bf16, D, KS, KS>(ring + t * kStage, ring + t * kStage + kTile * KS, pool_k,
                                 pool_v, rows, s.s0 + t * kTile, s, lane, 32);
    cp_async_commit();
  }

  // Q^T as B fragments (k = head dim, n = query): lane (grp, qd) holds
  // query grp's elements kk * 16 + 2 qd (+1) and + 8 (+9)
  const bool vq = qs.valid(grp);
  const bf16* qp = q + (vq ? ((size_t)qs.row(grp) * s.H + qs.head(grp)) * D : 0);
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = vq ? ld_u32(qp + kk * 16 + 2 * qd) : 0u;
    qb[kk][1] = vq ? ld_u32(qp + kk * 16 + 8 + 2 * qd) : 0u;
  }

  // O^T: o[dp] holds dims dp * 16 + grp (+ 8) of queries 2 qd and 2 qd + 1;
  // a lane's m and l are those two queries' (equal on the 8 lane groups)
  float o[D / 16][4];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_c[2] = {-INFINITY, -INFINITY}, l_c[2] = {0.f, 0.f};
  const float scale = sqrtf((float)D);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(s.stages - 1);
    __syncwarp();
    const bf16* kt = ring + (t % s.stages) * kStage;
    const bf16* vt = kt + kTile * KS;

    // S^T = K Q^T: two accumulators over alternate k steps, for two
    // independent mma chains; element e is token grp + 8 (e >> 1), query
    // 2 qd + (e & 1)
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, kt + ((mat & 1) * 8 + mr) * KS + kk * 16 + (mat >> 1) * 8);
      mma_bf16((kk & 1) ? sb : sa, ka, qb[kk][0], qb[kk][1]);
    }

    const int pos0 = s.s0 + t * kTile;
    const bool ok[2] = {attends<kHoles>(s, rows, pos0 + grp),
                        attends<kHoles>(s, rows, pos0 + grp + 8)};
    float x[4], mx[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = ok[e >> 1] ? (sa[e] + sb[e]) / scale : -INFINITY;
    float alpha[2], m_safe[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mx[c] = fmaxf(x[c], x[c + 2]);
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(kFull, mx[c], 4));
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(kFull, mx[c], 8));
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(kFull, mx[c], 16));
      const float m_new = fmaxf(m_c[c], mx[c]);
      m_safe[c] = isfinite(m_new) ? m_new : 0.f;
      alpha[c] = isfinite(m_c[c]) ? expf(m_c[c] - m_safe[c]) : 0.f;
      m_c[c] = m_new;
      l_c[c] *= alpha[c];
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = isfinite(x[e]) ? expf(x[e] - m_safe[e & 1]) : 0.f;
      l_c[e & 1] += p[e];
    }
    // P^T's B fragment (k = token, n = query) is the accumulator's 8x8
    // halves (tokens 0-7, 8-15) transposed
    const uint32_t pb0 = movmatrix_trans(pack_bf16(p[0], p[1]));
    const uint32_t pb1 = movmatrix_trans(pack_bf16(p[2], p[3]));

    // O^T = O^T * alpha + V^T P^T
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[1];
      o[i][2] *= alpha[0];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, vt + ((mat >> 1) * 8 + mr) * KS + dp * 16 + (mat & 1) * 8);
      mma_bf16(o[dp], va, pb0, pb1);
    }
    __syncwarp();
    if (t + s.stages < ntiles)
      load_tile<bf16, D, KS, KS>(ring + (t % s.stages) * kStage,
                                 ring + (t % s.stages) * kStage + kTile * KS, pool_k,
                                 pool_v, rows, s.s0 + (t + s.stages) * kTile, s, lane, 32);
    cp_async_commit();
  }
  cp_async_wait(0);
  launch_dependents();

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l_c[c] += __shfl_xor_sync(kFull, l_c[c], 4);
    l_c[c] += __shfl_xor_sync(kFull, l_c[c], 8);
    l_c[c] += __shfl_xor_sync(kFull, l_c[c], 16);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = 2 * qd + c;
    if (!qs.valid(i)) continue;
    const size_t k = out.slot(s, qs, i);
    if (grp == 0) out.m[k] = m_c[c], out.l[k] = l_c[c];
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      out.acc[k * D + dp * 16 + grp] = o[dp][c];
      out.acc[k * D + dp * 16 + grp + 8] = o[dp][2 + c];
    }
  }
}

// -- f32: CUDA-core FFMA (one-warp blocks) ----------------------------------------

template <int D, bool kHoles>
__device__ void attend_f32(const float* __restrict__ q, const float* __restrict__ pool_k,
                           const float* __restrict__ pool_v, const int* rows, const Split& s,
                           float* __restrict__ m_part, float* __restrict__ l_part,
                           float* __restrict__ acc_part, unsigned char* smem) {
  constexpr int KS = D + 4;  // float4 reads of 8 token rows hit 8 distinct bank quads
  constexpr int kStage = kTile * (KS + D);
  constexpr int GT = kHeadTileF32;
  constexpr int ND = (D + 31) / 32;  // output columns a lane owns
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = ring + s.stages * kStage;  // [GT][D]
  float* ps = qs + GT * D;               // [GT][kTile] probabilities
  float* al = ps + GT * kTile;           // [GT] alpha
  const int lane = threadIdx.x, tok = lane & 15, half = lane >> 4;
  const int ntiles = (s.s1 - s.s0 + kTile - 1) / kTile;

  for (int t = 0; t < s.stages; ++t) {
    if (t < ntiles)
      load_tile<float, D, KS, D>(ring + t * kStage, ring + t * kStage + kTile * KS, pool_k,
                                 pool_v, rows, s.s0 + t * kTile, s, lane, 32);
    cp_async_commit();
  }
  for (int i = lane; i < GT * D; i += 32) {
    const int g = i / D;
    qs[i] = g < s.ng ? q[((size_t)s.b * s.H + s.h0) * D + i] : 0.f;
  }

  // a lane scores token `tok` for heads half, half + 2, half + 4, half + 6;
  // its m and l are those heads' (equal on the 16 lanes of a half)
  float acc[GT][ND];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[g][j] = 0.f;
  float m_g[4], l_g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_g[i] = -INFINITY, l_g[i] = 0.f;
  const float scale = sqrtf((float)D);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(s.stages - 1);
    __syncwarp();
    const float* kt = ring + (t % s.stages) * kStage;
    const float* vt = kt + kTile * KS;

    float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kt + tok * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + (half + 2 * i) * D + d);
        dot[i] = fmaf(q4.x, k4.x, dot[i]);
        dot[i] = fmaf(q4.y, k4.y, dot[i]);
        dot[i] = fmaf(q4.z, k4.z, dot[i]);
        dot[i] = fmaf(q4.w, k4.w, dot[i]);
      }
    }
    const bool ok = attends<kHoles>(s, rows, s.s0 + t * kTile + tok);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = ok ? dot[i] / scale : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 8; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_g[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float a = isfinite(m_g[i]) ? expf(m_g[i] - m_safe) : 0.f;
      const float p = isfinite(x) ? expf(x - m_safe) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l_g[i] = l_g[i] * a + sum;
      m_g[i] = m_new;
      ps[(half + 2 * i) * kTile + tok] = p;
      if (tok == 0) al[half + 2 * i] = a;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float a = al[g];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          float pv = 0.f;
#pragma unroll
          for (int k = 0; k < kTile; ++k) pv = fmaf(ps[g * kTile + k], vt[k * D + d], pv);
          acc[g][j] = acc[g][j] * a + pv;
        }
      }
    }
    __syncwarp();
    if (t + s.stages < ntiles)
      load_tile<float, D, KS, D>(ring + (t % s.stages) * kStage,
                                 ring + (t % s.stages) * kStage + kTile * KS, pool_k, pool_v,
                                 rows, s.s0 + (t + s.stages) * kTile, s, lane, 32);
    cp_async_commit();
  }
  cp_async_wait(0);
  launch_dependents();

  const size_t base = ((size_t)s.b * s.NS + s.split) * s.H + s.h0;
  if (tok == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = half + 2 * i;
      if (g < s.ng) m_part[base + g] = m_g[i], l_part[base + g] = l_g[i];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (g < s.ng && d < D) acc_part[(base + g) * D + d] = acc[g][j];
    }
}

// -- a decode block: one warp over one split -------------------------------------

template <typename T, int D, int L, bool kHoles>
__device__ void attend_split(const T* q, const T* pool_k, const T* pool_v, const int* rows,
                             const Split& s, float* m_part, float* l_part, float* acc_part,
                             unsigned char* smem) {
  if constexpr (sizeof(T) == 4) {
    attend_f32<D, kHoles>(q, pool_k, pool_v, rows, s, m_part, l_part, acc_part, smem);
  } else {
    const Queries qs{0, 1 << 30, s.ng, s.b, s.h0, nullptr, 0};
    const Sink out{m_part, l_part, acc_part};
    bf16* ring = reinterpret_cast<bf16*>(smem);
    if constexpr (L == kTokens)
      attend_tokens<D, kHoles>(q, pool_k, pool_v, rows, s, qs, out, ring);
    else
      attend_heads<D, false, kHoles>(q, pool_k, pool_v, rows, s, qs, out, ring);
  }
}

// -- the kernels and the combine ----------------------------------------------------

// One-warp blocks an SM should hold: 16 caps a thread at 128 registers, so
// a batch of 8 rows x 2 KV heads x 128 pages (2,048 blocks) is one wave;
// D = 256 keeps its registers instead. The shared-table kernel's blocks of
// up to 4 warps: four an SM, 128 registers a thread (D = 256: two).
template <int D>
constexpr int kBlocksPerSm = D <= 128 ? 16 : 8;
template <int D>
constexpr int kMinBlocks = D <= 128 ? 4 : 2;

// `tstride`: the tables' row stride (0: every row reads row 0)
template <typename T, int D, int L>
__global__ void __launch_bounds__(32, kBlocksPerSm<D>)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                           const T* __restrict__ pool_v, const int32_t* __restrict__ tables,
                           const int32_t* __restrict__ lengths, float* __restrict__ m_part,
                           float* __restrict__ l_part, float* __restrict__ acc_part, int H,
                           int Hkv, int nb, int bs, int M, int tstride, int pps, int NS,
                           int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  Split s{};
  s.H = H, s.Hkv = Hkv, s.bs = bs, s.bs_shift = shift_of(bs), s.NS = NS, s.stages = stages;
  // lane i reads the split's table column i beside the length: the load
  // does not wait for it (pps <= 32)
  const int j = blockIdx.y * pps + threadIdx.x;
  const int entry =
      (int)threadIdx.x < pps && j < M ? tables[(size_t)blockIdx.z * tstride + j] : 0;
  if (!make_split(s, row_tokens(lengths[blockIdx.z], M, bs), H / Hkv, head_tile<T, L>(), pps))
    return;  // past the row's last page
  int* rows = reinterpret_cast<int*>(smem + body_bytes<T, D>(stages));
  // table entries are clamped to 0 for the load (and to the pool, as the
  // JAX gather); masking comes from the length alone
  if ((int)threadIdx.x < s.npg) rows[threadIdx.x] = min(max(entry, 0), nb - 1);
  __syncwarp();
  attend_split<T, D, L, false>(q, pool_k, pool_v, rows, s, m_part, l_part, acc_part, smem);
}

template <typename T, int D, int L>
__global__ void __launch_bounds__(32, kBlocksPerSm<D>) fused_chain_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const uint32_t* __restrict__ w0, const int32_t* __restrict__ chain_lengths,
    const int32_t* __restrict__ tenants, const int32_t* __restrict__ kv_lengths,
    float* __restrict__ m_part, float* __restrict__ l_part, float* __restrict__ acc_part,
    int H, int Hkv, int nb, int bs, int Tn, int C, int P, int pps, int NS, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  Split s{};
  s.H = H, s.Hkv = Hkv, s.bs = bs, s.bs_shift = shift_of(bs), s.NS = NS, s.stages = stages;
  const int tenant = tenants[blockIdx.z];  // read beside the length
  if (!make_split(s, row_tokens(kv_lengths[blockIdx.z], P, bs), H / Hkv, head_tile<T, L>(),
                  pps))
    return;
  int* rows = reinterpret_cast<int*>(smem + body_bytes<T, D>(stages));
  const int t = min(max(tenant, 0), Tn - 1);
  const int top = min(chain_lengths[t], C) - 1;
  const uint32_t* col = w0 + (size_t)t * C * P + s.pg0;
  // the fused chain walk, for this split's pages only
  for (int i = 0; i < s.npg; ++i) {
    const int r = warp_first_hit_row(col + i, top, P);
    if (threadIdx.x == 0) rows[i] = r < 0 ? -1 : min(r, nb - 1);
  }
  __syncwarp();
  attend_split<T, D, L, true>(q, pool_k, pool_v, rows, s, m_part, l_part, acc_part, smem);
}

// The shared-table kernel (bf16): block = (split, KV head, query block). The
// block's W warps hold W tiles of 16 consecutive (row, head) queries of the
// KV head and share one ring; the block attends up to its longest row.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks<D>) shared_table_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pool_k,
    const bf16* __restrict__ pool_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int S, int H, int Hkv, int nb,
    int bs, int M, int pps, int NS, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = H / Hkv;
  const int qb0 = blockIdx.z * W * kHeadTileBf16;
  const int r0 = qb0 / G, r1 = min(S, (qb0 + W * kHeadTileBf16 - 1) / G + 1);
  int* red = reinterpret_cast<int*>(smem + body_bytes<bf16, D>(stages));  // [kMaxWarps]
  int* rows = red + kMaxWarps;
  // the split's table columns, read beside the lengths (clamped to the
  // pool for the load, as the tables kernel does)
  const int pg0 = blockIdx.x * pps;
  for (int i = threadIdx.x; i < pps && pg0 + i < M; i += blockDim.x)
    rows[i] = min(max(table[pg0 + i], 0), nb - 1);
  int n = 0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    n = max(n, row_tokens(lengths[r], M, bs));
#pragma unroll
  for (int o = 16; o; o >>= 1) n = max(n, __shfl_xor_sync(kFull, n, o));
  if (lane == 0) red[warp] = n;
  __syncthreads();
  n = 0;
  for (int w = 0; w < W; ++w) n = max(n, red[w]);

  Split s{};
  s.H = H, s.Hkv = Hkv, s.bs = bs, s.bs_shift = shift_of(bs), s.NS = NS, s.stages = stages;
  s.split = blockIdx.x;
  s.kvh = blockIdx.y;
  s.pg0 = s.split * pps;
  s.s0 = s.pg0 * bs;
  s.s1 = min(s.s0 + pps * bs, n);
  if (s.s0 >= s.s1) return;  // past the block's longest row
  s.npg = (s.s1 + bs - 1) / bs - s.pg0;
  const Queries qs{qb0 + warp * kHeadTileBf16, G, S * G, 0, s.kvh * G, lengths, M};
  attend_heads<D, true, false>(q, pool_k, pool_v, rows, s, qs,
                               Sink{m_part, l_part, acc_part}, reinterpret_cast<bf16*>(smem));
}

constexpr int kCombineThreads = 256;

// A block-wide max or sum; every thread gets the same value, reduced in a
// fixed order. `red` holds one float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float x = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, x) : v + x;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

constexpr int kCombinePairs = kCombineThreads / 32;  // (row, head) pairs a warp-mode block

// Shared-memory floats of the combine: the slices' partial sums, the
// reduce scratch and the splits' weights (a block a pair), or each warp's
// splits' weights (a warp a pair).
__host__ __device__ __forceinline__ int combine_floats(int NS, bool warp) {
  return warp ? kCombinePairs * NS : 4 * kCombineThreads + kCombineThreads / 32 + NS;
}

// Folds a row's splits: block = (row, query head). Only the splits that
// worked are read. The weights w_s = exp(m_s - max m) (0 where m_s is
// -inf) go to shared memory; then thread (slice, c) sums w_s * acc_s over
// the splits s = slice, slice + slices, ... for output columns 4c..4c+3,
// and the slices are added in slice order. The order is fixed, so the
// result is deterministic and the same for K3 and K4.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    attention_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                             const float* __restrict__ acc_part,
                             const int32_t* __restrict__ lengths, T* __restrict__ out, int H,
                             int D, int bs, int pages, int pps, int NS) {
  extern __shared__ __align__(16) float csm[];
  float* part = csm;                           // [slices][D], float4 aligned
  float* red = part + 4 * kCombineThreads;     // [warps]
  float* w = red + kCombineThreads / 32;       // [NS]
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int span = pps * bs;
  const int n = (row_tokens(lengths[b], pages, bs) + span - 1) / span;
  const size_t base = (size_t)b * NS * H + h;
  wait_for_primary();

  float mx = -INFINITY;
  for (int i = tid; i < n; i += kCombineThreads) mx = fmaxf(mx, m_part[base + (size_t)i * H]);
  mx = block_reduce<true>(mx, red);
  const float m_safe = isfinite(mx) ? mx : 0.f;
  float l = 0.f;
  for (int i = tid; i < n; i += kCombineThreads) {
    const size_t k = base + (size_t)i * H;
    const float m = m_part[k];
    const float wi = isfinite(m) ? expf(m - m_safe) : 0.f;
    w[i] = wi;
    l += l_part[k] * wi;
  }
  l = block_reduce<false>(l, red);  // its barrier also publishes w

  const int cols = D / 4, slices = kCombineThreads / cols;
  const int c = tid % cols, slice = tid / cols;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = slice; i < n; i += slices) {
    const float wi = w[i];
    const float4 v =
        *reinterpret_cast<const float4*>(acc_part + (base + (size_t)i * H) * D + 4 * c);
    a.x = fmaf(v.x, wi, a.x);
    a.y = fmaf(v.y, wi, a.y);
    a.z = fmaf(v.z, wi, a.z);
    a.w = fmaf(v.w, wi, a.w);
  }
  reinterpret_cast<float4*>(part + slice * D)[c] = a;
  __syncthreads();
  for (int d = tid; d < D; d += kCombineThreads) {
    float acc = 0.f;
    for (int sl = 0; sl < slices; ++sl) acc += part[sl * D + d];
    out[((size_t)b * H + h) * D + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

// The combine with a warp a (row, head) pair, for calls with many pairs
// (the suffix prefill's 256 rows, large batches), where a block a pair
// would pay its barriers for a few splits each. The same fold in a fixed
// order: lane-strided max and weighted l, each reduced by a butterfly of
// shuffles (every lane gets the same sum); then a lane (or a slice of
// lanes, for D < 128) sums w_s * acc_s over the splits in split order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    attention_combine_warp_kernel(const float* __restrict__ m_part,
                                  const float* __restrict__ l_part,
                                  const float* __restrict__ acc_part,
                                  const int32_t* __restrict__ lengths, T* __restrict__ out,
                                  int B, int H, int D, int bs, int pages, int pps, int NS) {
  extern __shared__ __align__(16) float csm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kCombinePairs + warp;
  float* w = csm + warp * NS;
  wait_for_primary();
  if (pair >= B * H) return;
  const int b = pair / H, h = pair % H;
  const int span = pps * bs;
  const int n = (row_tokens(lengths[b], pages, bs) + span - 1) / span;
  const size_t base = (size_t)b * NS * H + h;

  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, m_part[base + (size_t)i * H]);
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  const float m_safe = isfinite(mx) ? mx : 0.f;
  float l = 0.f;
  for (int i = lane; i < n; i += 32) {
    const size_t k = base + (size_t)i * H;
    const float m = m_part[k];
    const float wi = isfinite(m) ? expf(m - m_safe) : 0.f;
    w[i] = wi;
    l += l_part[k] * wi;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
  __syncwarp();
  const float den = fmaxf(l, 1e-30f);
  const int cols = D / 4;  // float4 columns
  const int slices = cols >= 32 ? 1 : 32 / cols;
  const int sl = lane / (cols >= 32 ? 32 : cols);
  for (int c = lane % (cols >= 32 ? 32 : cols); c < cols; c += 32) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = sl; i < n; i += slices) {
      const float wi = w[i];
      const float4 v =
          *reinterpret_cast<const float4*>(acc_part + (base + (size_t)i * H) * D + 4 * c);
      a.x = fmaf(v.x, wi, a.x);
      a.y = fmaf(v.y, wi, a.y);
      a.z = fmaf(v.z, wi, a.z);
      a.w = fmaf(v.w, wi, a.w);
    }
    for (int o = cols; o < 32; o <<= 1) {
      a.x += __shfl_xor_sync(kFull, a.x, o);
      a.y += __shfl_xor_sync(kFull, a.y, o);
      a.z += __shfl_xor_sync(kFull, a.z, o);
      a.w += __shfl_xor_sync(kFull, a.w, o);
    }
    if (sl == 0) {
      T* o_row = out + ((size_t)b * H + h) * D + 4 * c;
      o_row[0] = from_f32<T>(a.x / den);
      o_row[1] = from_f32<T>(a.y / den);
      o_row[2] = from_f32<T>(a.z / den);
      o_row[3] = from_f32<T>(a.w / den);
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  (void)cudaGetLastError();
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// What the wrapper's planner decided, and the launch shape it implies.
struct Plan {
  int pps, NS, stages;
  bool warp_combine;
  dim3 grid;
  size_t smem, combine_smem;
};

template <typename T, int D, int L>
Plan make_plan(int B, int H, int Hkv, int bs, int pages, int pps, bool warp_combine) {
  const int G = H / Hkv, tile = head_tile<T, L>();
  const int ngt = (G + tile - 1) / tile;
  Plan p;
  p.pps = pps;
  p.NS = (pages + pps - 1) / pps;
  p.stages = std::min(kMaxStages, (pps * bs + kTile - 1) / kTile);
  p.grid = dim3(Hkv * ngt, p.NS, B);
  p.smem = body_bytes<T, D>(p.stages) + pps * sizeof(int);
  p.warp_combine = warp_combine;
  p.combine_smem = combine_floats(p.NS, warp_combine) * sizeof(float);
  return p;
}

template <int D>
Plan make_shared_plan(int S, int H, int Hkv, int bs, int M, int pps, int W,
                      bool warp_combine) {
  const int qt = (S * (H / Hkv) + kHeadTileBf16 - 1) / kHeadTileBf16;
  Plan p;
  p.pps = pps;
  p.NS = (M + pps - 1) / pps;
  const int extra = (kMaxWarps + pps) * (int)sizeof(int);
  p.stages = std::min(kMaxStages, (pps * bs + kTile - 1) / kTile);
  p.grid = dim3(p.NS, Hkv, (qt + W - 1) / W);
  p.smem = body_bytes<bf16, D>(p.stages) + extra;
  p.warp_combine = warp_combine;
  p.combine_smem = combine_floats(p.NS, warp_combine) * sizeof(float);
  return p;
}

// The combine, launched as a programmatic dependent of the split pass on
// the same stream, so its launch overlaps the split pass's last blocks.
template <typename T>
int launch_combine(const Plan& p, const float* m_part, const float* l_part,
                   const float* acc_part, const int32_t* lengths, T* out, int B, int H, int D,
                   int bs, int pages, cudaStream_t st) {
  int e = p.warp_combine ? allow_smem(attention_combine_warp_kernel<T>, p.combine_smem)
                         : allow_smem(attention_combine_kernel<T>, p.combine_smem);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.warp_combine ? (B * H + kCombinePairs - 1) / kCombinePairs : B * H);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = p.combine_smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (p.warp_combine)
    return (int)cudaLaunchKernelEx(&cfg, attention_combine_warp_kernel<T>, m_part, l_part,
                                   acc_part, lengths, out, B, H, D, bs, pages, p.pps, p.NS);
  return (int)cudaLaunchKernelEx(&cfg, attention_combine_kernel<T>, m_part, l_part, acc_part,
                                 lengths, out, H, D, bs, pages, p.pps, p.NS);
}

template <typename T, int D, int L>
int launch_tables(const void* q, const void* pool_k, const void* pool_v, const void* tables,
                  const void* lengths, float* m_part, float* l_part, float* acc_part,
                  void* out, int B, int H, int Hkv, int nb, int bs, int M, int tstride,
                  int pps, int combine, cudaStream_t st) {
  const Plan p = make_plan<T, D, L>(B, H, Hkv, bs, M, pps, combine);
  int e = allow_smem(paged_attention_kernel<T, D, L>, p.smem);
  if (e) return e;
  paged_attention_kernel<T, D, L><<<p.grid, 32, p.smem, st>>>(
      (const T*)q, (const T*)pool_k, (const T*)pool_v, (const int32_t*)tables,
      (const int32_t*)lengths, m_part, l_part, acc_part, H, Hkv, nb, bs, M, tstride, pps, p.NS,
      p.stages);
  if ((e = (int)cudaGetLastError())) return e;
  return launch_combine<T>(p, m_part, l_part, acc_part, (const int32_t*)lengths, (T*)out, B,
                           H, D, bs, M, st);
}

template <typename T, int D, int L>
int launch_fused(const void* q, const void* pool_k, const void* pool_v, const void* w0,
                 const void* chain_lengths, const void* tenants, const void* kv_lengths,
                 float* m_part, float* l_part, float* acc_part, void* out, int B, int H,
                 int Hkv, int nb, int bs, int Tn, int C, int P, int pps, int combine,
                 cudaStream_t st) {
  const Plan p = make_plan<T, D, L>(B, H, Hkv, bs, P, pps, combine);
  int e = allow_smem(fused_chain_attention_kernel<T, D, L>, p.smem);
  if (e) return e;
  fused_chain_attention_kernel<T, D, L><<<p.grid, 32, p.smem, st>>>(
      (const T*)q, (const T*)pool_k, (const T*)pool_v, (const uint32_t*)w0,
      (const int32_t*)chain_lengths, (const int32_t*)tenants, (const int32_t*)kv_lengths,
      m_part, l_part, acc_part, H, Hkv, nb, bs, Tn, C, P, pps, p.NS, p.stages);
  if ((e = (int)cudaGetLastError())) return e;
  return launch_combine<T>(p, m_part, l_part, acc_part, (const int32_t*)kv_lengths, (T*)out,
                           B, H, D, bs, P, st);
}

template <int D>
int launch_shared(const void* q, const void* pool_k, const void* pool_v, const void* table,
                  const void* lengths, float* m_part, float* l_part, float* acc_part,
                  void* out, int S, int H, int Hkv, int nb, int bs, int M, int pps, int W,
                  int combine, cudaStream_t st) {
  const Plan p = make_shared_plan<D>(S, H, Hkv, bs, M, pps, W, combine);
  int e = allow_smem(shared_table_kernel<D>, p.smem);
  if (e) return e;
  shared_table_kernel<D><<<p.grid, 32 * W, p.smem, st>>>(
      (const bf16*)q, (const bf16*)pool_k, (const bf16*)pool_v, (const int32_t*)table,
      (const int32_t*)lengths, m_part, l_part, acc_part, S, H, Hkv, nb, bs, M, pps, p.NS,
      p.stages);
  if ((e = (int)cudaGetLastError())) return e;
  return launch_combine<bf16>(p, m_part, l_part, acc_part, (const int32_t*)lengths,
                              (bf16*)out, S, H, D, bs, M, st);
}

// dtype 0 = f32, 1 = bf16; layout kHeads or kTokens (bf16 only); D one of
// 16, 32, 64, 128, 256 (the wrapper checks)
#define DISPATCH(LAUNCH, ...)                                                \
  switch (dtype * 10000 + layout * 1000 + D) {                               \
    case 16: return LAUNCH<float, 16, kHeads>(__VA_ARGS__);                  \
    case 32: return LAUNCH<float, 32, kHeads>(__VA_ARGS__);                  \
    case 64: return LAUNCH<float, 64, kHeads>(__VA_ARGS__);                  \
    case 128: return LAUNCH<float, 128, kHeads>(__VA_ARGS__);                \
    case 256: return LAUNCH<float, 256, kHeads>(__VA_ARGS__);                \
    case 10016: return LAUNCH<bf16, 16, kHeads>(__VA_ARGS__);                \
    case 10032: return LAUNCH<bf16, 32, kHeads>(__VA_ARGS__);                \
    case 10064: return LAUNCH<bf16, 64, kHeads>(__VA_ARGS__);                \
    case 10128: return LAUNCH<bf16, 128, kHeads>(__VA_ARGS__);               \
    case 10256: return LAUNCH<bf16, 256, kHeads>(__VA_ARGS__);               \
    case 11016: return LAUNCH<bf16, 16, kTokens>(__VA_ARGS__);               \
    case 11032: return LAUNCH<bf16, 32, kTokens>(__VA_ARGS__);               \
    case 11064: return LAUNCH<bf16, 64, kTokens>(__VA_ARGS__);               \
    case 11128: return LAUNCH<bf16, 128, kTokens>(__VA_ARGS__);              \
    case 11256: return LAUNCH<bf16, 256, kTokens>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// a decode block reads at most a table column a lane (the shared-table
// kernel reads its columns in a loop); f32 runs one-warp blocks
bool bad_plan(int pps, int W, int dtype, bool shared) {
  return W < 1 || W > kMaxWarps || (dtype == 0 && W != 1) || pps < 1 ||
         (pps > 32 && !(shared && dtype == 1));
}

// scratch: f32 acc (B, NS, H, D), then m and l (B, NS, H) each, with
// NS = ceil(pages / pps); the wrapper allocates it
struct Partials {
  float *acc, *m, *l;
  Partials(void* scratch, int B, int pages, int pps, int H, int D) {
    const size_t ns = (pages + pps - 1) / pps;
    acc = (float*)scratch;
    m = acc + (size_t)B * ns * H * D;
    l = m + (size_t)B * ns * H;
  }
};

}  // namespace

extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const void* tables, const void* lengths, void* scratch,
                               void* out, int B, int H, int Hkv, int D, int nb, int bs, int M,
                               int pps, int layout, int combine, int dtype, void* stream) {
  if (bad_plan(pps, 1, dtype, false)) return (int)cudaErrorInvalidValue;
  const Partials pt(scratch, B, M, pps, H, D);
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH(launch_tables, q, pool_k, pool_v, tables, lengths, pt.m, pt.l, pt.acc, out, B, H,
           Hkv, nb, bs, M, M, pps, combine, st)
}

extern "C" int fused_chain_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* w0, const void* chain_lengths,
                                     const void* tenants, const void* kv_lengths,
                                     void* scratch, void* out, int B, int H, int Hkv, int D,
                                     int nb, int bs, int Tn, int C, int P, int pps, int layout,
                                     int combine, int dtype, void* stream) {
  if (bad_plan(pps, 1, dtype, false)) return (int)cudaErrorInvalidValue;
  const Partials pt(scratch, B, P, pps, H, D);
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH(launch_fused, q, pool_k, pool_v, w0, chain_lengths, tenants, kv_lengths, pt.m,
           pt.l, pt.acc, out, B, H, Hkv, nb, bs, Tn, C, P, pps, combine, st)
}

// S rows that all read `table` (M,), each with its own length. bf16 runs
// the shared-table kernel (W query tiles a block); f32 runs the tables
// kernel with a row stride of 0 (one-warp blocks, head tiles of one row).
extern "C" int paged_attention_shared(const void* q, const void* pool_k, const void* pool_v,
                                      const void* table, const void* lengths, void* scratch,
                                      void* out, int S, int H, int Hkv, int D, int nb, int bs,
                                      int M, int pps, int warps, int combine, int dtype,
                                      void* stream) {
  if (bad_plan(pps, warps, dtype, true)) return (int)cudaErrorInvalidValue;
  const Partials pt(scratch, S, M, pps, H, D);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int layout = kHeads;
    DISPATCH(launch_tables, q, pool_k, pool_v, table, lengths, pt.m, pt.l, pt.acc, out, S,
             H, Hkv, nb, bs, M, 0, pps, combine, st)
  }
  switch (D) {
#define SHARED(DD)                                                                       \
  case DD:                                                                               \
    return launch_shared<DD>(q, pool_k, pool_v, table, lengths, pt.m, pt.l, pt.acc, out, \
                             S, H, Hkv, nb, bs, M, pps, warps, combine, st);
    SHARED(16) SHARED(32) SHARED(64) SHARED(128) SHARED(256)
#undef SHARED
    default: return (int)cudaErrorInvalidValue;
  }
}
