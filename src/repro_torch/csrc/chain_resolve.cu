// Chain resolution for Hopper (sm_90a): the stacked (T, C, P) fleet layout
// and the single-chain (C, N) planes.
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/chain_resolve/chain_resolve.py:
//   resolve_vanilla_fleet  <- resolve_vanilla_fleet_pallas (_vanilla_fleet_kernel)
//   resolve_direct_fleet   <- resolve_direct_fleet_pallas  (_direct_fleet_kernel)
//   resolve_vanilla        <- resolve_vanilla_pallas       (_vanilla_kernel)
//   resolve_direct         <- resolve_direct_pallas        (_direct_kernel)
// and one entry that replaces no TPU kernel:
//   resolve_auto_batch     (K1's batch entry, beside resolve_vanilla_fleet as
//                           K9's merge_entries sits beside merge)
//
// What bounds them on the card: device-memory bytes, and for the fleet
// walk the latency of getting them. Each page does a few integer ops per
// 4-byte word it reads, far below the card's ratio of operations to bytes.
//
// The fleet walk (K1) reads word0 where the fleet keeps it: either a
// contiguous (T, C, P) plane or the strided view l2[..., 0] of the packed
// (T, C, P, 2) words (an element stride of 2), so the caller copies no
// plane out first. At a stride of 2, word1 comes with word0 (a 32-byte
// sector holds four whole entries): 8 bytes a walked entry. It has two
// walks, picked by the wrapper from T, C and P alone (no length is read,
// so there is no sync):
//   - many pages (a fleet read, T x P in the millions): one thread a
//     (tenant, page), neighbouring threads on neighbouring pages so every
//     layer's loads are coalesced along P, walking down from the tenant's
//     active layer in batches of U layers whose loads are all issued before
//     any is tested (batched_first_hit, chain_walk.cuh): U loads in flight
//     a thread instead of one, at most U - 1 words read past the owner.
//   - few pages (the decode state, T x P in the thousands, a handful of
//     blocks for 132 SMs): one warp a (tenant, page), 128 layers a round
//     (four loads a lane in flight) with __ballot_sync + __ffs
//     (warp_first_hit), so a 65-layer chain costs one round of loads, not
//     65 dependent loads.
// The direct kernel (K2) reads the active layer's two words and nothing
// else, where the fleet keeps them: two contiguous (T, C, P) planes, or the
// packed (T, C, P, 2) words themselves (the l2[..., 0] / l2[..., 1] pair),
// where a tenant's active layer is one contiguous (P, 2) slab and a page's
// entry one aligned 8-byte load. Tenants are on blockIdx.y, so a block
// reads its tenant's length once, uniformly, and no thread divides. One
// page a thread.
//
// The batch entry resolves a read's (T, B) page ids, not the (T, P) maps:
// the auto resolve of core/resolve.py (direct where the active entry is
// ALLOCATED and BFI_VALID, the walk otherwise) in one launch, with the
// ResolveResult's six leaves written in its epilogue. Whole-map K1 and K2
// resolve every page of every tenant and leave the pick and the batch's
// takes to a dozen further launches; a fleet read asks for 128 (YCSB-C)
// or 16 (dd) times fewer pages than the maps hold. A read loads its
// active entry (one aligned 8-byte load at a stride of 2, as K2) and,
// only where that entry is not trusted, walks from min(length, C) - 1
// down with K1's walks: a thread a read (batched_first_hit) or a warp a
// read (warp_first_hit), picked by the wrapper from T x B alone. Page ids
// come with both strides, so an expanded (T, B) view of one row (row
// stride 0) or any other view is read as it is. An id outside [0, P)
// traps: the launch fails and the stream's next sync raises, as the
// bound check of the gather it replaces did; no read answers with another
// page. Kernel names keep "vanilla_fleet_kernel" (and not
// "direct_fleet_kernel"): a trace puts them in K1's row, and a launch is
// counted as one of K1's.
//
// The single-chain kernels take the chain as separate planes, as the TPU
// kernels do: an allocation map (int32 or bool, tested != 0) and a pointer
// plane. The walk (K6) is K9's planes walk (planes_first_hit,
// chain_walk.cuh) from layer min(length, C) - 1 down (layers >= C are
// invalid, and so are layers >= length; the length is read on the device):
// a thread owns V neighbouring pages (4 where 4 divides N and the plane is
// aligned to their bytes, else 1; the wrapper picks), reads them as one
// load a layer, and issues U layers' loads before testing any, until all V
// have an owner (U: 32 registers of loads, kVanillaLoadWords). A walk of
// one page a thread and one dependent 4-byte load a layer leaves an SM
// 2-8 KB in flight, where the card needs ~15 KB to stream. ptr is the
// owner's pointer, 0 on a miss. The direct kernel (K7) is one elementwise
// pass over the active layer. It does not look at BFI_VALID: its caller
// decides what is trusted.
//
// Words are read as uint32_t; the layout comes from -D macros generated
// from repro_torch/core/format.py (kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "chain_walk.cuh"

#ifndef FMT_FLAG_ALLOCATED
#error "build through repro_torch.kernels._build: the format macros are missing"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// U: layers whose loads a thread issues at once. 8 beat 4 on an H100 at
// every shape of the walk sweep up to 65,536 pages and tied it at the
// fleet read's 1,048,576 (PERF.md).
constexpr int kWalkBatch = 8;

// Registers a thread of the single-chain walk (K6) holds loads in: a
// batch is kVanillaLoadWords / (the 4-byte words of one load) layers, so
// 8 layers of 4 int32 pages, 32 of 4 bool pages or of one page. On an
// H100 4 int32 pages x 32 layers took 160 registers and one block an SM,
// and lost to 8 layers by 44 % at the depth-500 disk and 56 % at the
// checkpoint chain; with 4 bool pages, 32 layers beat 8 at the disk (62
// against 75 us) and lost at the checkpoint chain (20 against 17.5 us)
// (PERF.md).
constexpr int kVanillaLoadWords = 32;

// Many pages: one thread a (tenant, page). ES: word0's element stride.
template <int ES>
__global__ void vanilla_fleet_kernel(const uint32_t* __restrict__ w0,
                                     const int32_t* __restrict__ lengths,
                                     int32_t* __restrict__ owner,
                                     uint32_t* __restrict__ hit,
                                     int T, int C, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * P) return;
  const int t = (int)(i / P);
  const int p = (int)(i % P);
  // layers >= length are dead, and so are layers >= C
  const int top = min(lengths[t], C) - 1;
  const uint32_t* col = w0 + ((size_t)t * C * P + p) * ES;
  const size_t stride = (size_t)P * ES;
  uint32_t w = 0u;
  const int o = batched_first_hit<kWalkBatch>(
      top, [&](int layer) { return __ldg(col + (size_t)layer * stride); },
      [](uint32_t x) { return (x & FMT_FLAG_ALLOCATED) != 0u; }, &w);
  owner[i] = o;
  hit[i] = o >= 0 ? w : 0u;
}

// Few pages: one warp a (tenant, page).
template <int ES>
__global__ void warp_vanilla_fleet_kernel(const uint32_t* __restrict__ w0,
                                          const int32_t* __restrict__ lengths,
                                          int32_t* __restrict__ owner,
                                          uint32_t* __restrict__ hit,
                                          int T, int C, int P) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= (long long)T * P) return;     // whole warps leave together
  const int t = (int)(i / P);
  const int p = (int)(i % P);
  const int top = min(lengths[t], C) - 1;
  const uint32_t* col = w0 + ((size_t)t * C * P + p) * ES;
  uint32_t w;
  const int o = warp_first_hit(col, top, (size_t)P * ES, &w);
  if ((threadIdx.x & 31) == 0) {
    owner[i] = o;
    hit[i] = w;
  }
}

// ES: 1, two (T, C, P) planes w0 and w1; 2, the packed (T, C, P, 2) words
// at w0 (w1 unused), 8-byte aligned.
template <int ES>
__global__ void direct_fleet_kernel(const uint32_t* __restrict__ w0,
                                    const uint32_t* __restrict__ w1,
                                    const int32_t* __restrict__ lengths,
                                    int32_t* __restrict__ owner,
                                    uint32_t* __restrict__ h0,
                                    uint32_t* __restrict__ h1,
                                    int T, int C, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  // more than 65,535 tenants fold onto the grid's y
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    // the JAX indexing rules of the reference: a negative active layer
    // (a length-0 tenant) wraps to C-1, then the index is clamped
    int act = lengths[t] - 1;
    if (act < 0) act += C;
    act = max(0, min(act, C - 1));
    const size_t at = ((size_t)t * C + act) * P + p;   // entry of page p
    uint32_t a, b;
    if constexpr (ES == 2) {
      const uint2 e = __ldg(reinterpret_cast<const uint2*>(w0 + 2 * at));
      a = e.x;
      b = e.y;
    } else {
      a = __ldg(w0 + at);
      b = __ldg(w1 + at);
    }
    const size_t out = (size_t)t * P + p;
    owner[out] = (a & FMT_FLAG_ALLOCATED) != 0u ? (int32_t)(b & FMT_BFI_MASK) : -1;
    h0[out] = a;
    h1[out] = b;
  }
}

// The batch entry's arguments. Outputs are two (3, T, B) stacks: int32
// owner, ptr and lookups at out32, bool found, zero and cold at out8.
struct AutoBatch {
  const uint32_t* l2;         // the packed (T, C, P, 2) words
  const int32_t* lengths;
  const int32_t* ids;         // (T, B), id_row and id_col elements apart
  long long id_row, id_col;
  int32_t* out32;
  uint8_t* out8;
  int T, C, P, B;
};

// Read i's tenant, length, page and active entry (t's layer length - 1,
// wrapped and clamped as in direct_fleet_kernel): one aligned 8-byte load
// of the packed words. A page outside [0, P) traps.
struct AutoRead {
  int t, len, p;
  uint2 e;

  __device__ __forceinline__ AutoRead(const AutoBatch& a, long long i) {
    t = (int)(i / a.B);
    const long long b = i % a.B;
    len = a.lengths[t];
    p = a.ids[(long long)t * a.id_row + b * a.id_col];
    if (p < 0 || p >= a.P) __trap();
    int act = len - 1;
    if (act < 0) act += a.C;
    act = max(0, min(act, a.C - 1));
    const size_t at = ((size_t)t * a.C + act) * a.P + p;
    e = __ldg(reinterpret_cast<const uint2*>(a.l2 + 2 * at));
  }

  // the direct entry answers the read: allocated, with a valid bfi
  __device__ __forceinline__ bool trusted() const {
    return (e.x & FMT_FLAG_ALLOCATED) != 0u && (e.y & FMT_FLAG_BFI_VALID) != 0u;
  }

  // word0 of layer 0 of the read's page; layers are col_stride() apart
  __device__ __forceinline__ const uint32_t* col(const AutoBatch& a) const {
    return a.l2 + ((size_t)t * a.C * a.P + p) * 2;
  }
  __device__ __forceinline__ size_t col_stride(const AutoBatch& a) const {
    return (size_t)a.P * 2;
  }
};

// Read i's six leaves from its owner and that owner's word0 (0 on a miss).
__device__ __forceinline__ void write_read(const AutoBatch& a, long long i,
                                           int owner, uint32_t word,
                                           int lookups) {
  const long long n = (long long)a.T * a.B;
  a.out32[i] = owner;
  a.out32[n + i] = (int32_t)(word & FMT_PTR_MASK);
  a.out32[2 * n + i] = lookups;
  a.out8[i] = owner >= 0;
  a.out8[n + i] = (word & FMT_FLAG_ZERO) != 0u;
  a.out8[2 * n + i] = (word & FMT_FLAG_COLD) != 0u;
}

// The answer of a walk that ended at owner o with word w (o < 0: a miss).
__device__ __forceinline__ void write_walk(const AutoBatch& a, long long i,
                                           int len, int o, uint32_t w) {
  write_read(a, i, o, o >= 0 ? w : 0u, o >= 0 ? len - o : len);
}

// Many reads: one thread a read.
__global__ void batch_vanilla_fleet_kernel(const AutoBatch a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.T * a.B) return;
  const AutoRead r(a, i);
  if (r.trusted()) {
    write_read(a, i, (int)(r.e.y & FMT_BFI_MASK), r.e.x, 1);
    return;
  }
  const uint32_t* col = r.col(a);
  const size_t stride = r.col_stride(a);
  uint32_t w = 0u;
  const int o = batched_first_hit<kWalkBatch>(
      min(r.len, a.C) - 1,
      [&](int layer) { return __ldg(col + (size_t)layer * stride); },
      [](uint32_t x) { return (x & FMT_FLAG_ALLOCATED) != 0u; }, &w);
  write_walk(a, i, r.len, o, w);
}

// Few reads: one warp a read. Every lane loads the active entry (one
// address, one transaction), so the trust test is the warp's own.
__global__ void batch_warp_vanilla_fleet_kernel(const AutoBatch a) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= (long long)a.T * a.B) return;   // whole warps leave together
  const AutoRead r(a, i);
  const bool lead = (threadIdx.x & 31) == 0;
  if (r.trusted()) {
    if (lead) write_read(a, i, (int)(r.e.y & FMT_BFI_MASK), r.e.x, 1);
    return;
  }
  uint32_t w;
  const int o = warp_first_hit(r.col(a), min(r.len, a.C) - 1, r.col_stride(a), &w);
  if (lead) write_walk(a, i, r.len, o, w);
}

// V pages a thread, U layers a batch, E bytes an allocation entry.
template <int E, int V, int U>
__global__ void vanilla_kernel(const uint8_t* __restrict__ alloc,
                               const int32_t* __restrict__ ptrs,
                               const int32_t* __restrict__ length,
                               int32_t* __restrict__ owner,
                               int32_t* __restrict__ ptr, int C, int N) {
  const long long p0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (p0 >= N) return;                     // the host makes V divide N
  int s[V];
  planes_first_hit<E, V, U>(alloc + p0 * E, (size_t)N * E,
                            min(length[0], C) - 1, s);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const long long p = p0 + i;
    owner[p] = s[i];
    ptr[p] = s[i] >= 0 ? ptrs[(size_t)s[i] * N + p] : 0;
  }
}

template <typename A>
__global__ void direct_kernel(const A* __restrict__ alloc,
                              const int32_t* __restrict__ bfi,
                              const int32_t* __restrict__ ptrs,
                              int32_t* __restrict__ owner,
                              int32_t* __restrict__ ptr, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const bool a = alloc[p] != 0;
  owner[p] = a ? bfi[p] : -1;
  ptr[p] = a ? ptrs[p] : 0;
}

unsigned int blocks_for(int T, int P) {
  const long long n = (long long)T * P;
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <int E, int V, int U>
int launch_vanilla(const void* alloc, const void* ptrs, const void* length,
                   void* owner, void* ptr, int C, int N, cudaStream_t st) {
  vanilla_kernel<E, V, U><<<blocks_for(1, N / V), kThreads, 0, st>>>(
      (const uint8_t*)alloc, (const int32_t*)ptrs, (const int32_t*)length,
      (int32_t*)owner, (int32_t*)ptr, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_stride: word0's element stride, 1 (a (T, C, P) plane) or 2 (the
// l2[..., 0] view of (T, C, P, 2) words). walk: 0 one thread a page, 1 one
// warp a page.
extern "C" int resolve_vanilla_fleet(const void* w0, const void* lengths,
                                     void* owner, void* hit, int T, int C,
                                     int P, int elem_stride, int walk,
                                     void* stream) {
  (void)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* w = (const uint32_t*)w0;
  const int32_t* ln = (const int32_t*)lengths;
  int32_t* o = (int32_t*)owner;
  uint32_t* h = (uint32_t*)hit;
  const long long n = (long long)T * P;
  if (elem_stride != 1 && elem_stride != 2) return (int)cudaErrorInvalidValue;
  const bool strided = elem_stride == 2;
  if (walk == 0) {
    const unsigned int blocks = blocks_for(T, P);
    if (strided) vanilla_fleet_kernel<2><<<blocks, kThreads, 0, st>>>(w, ln, o, h, T, C, P);
    else vanilla_fleet_kernel<1><<<blocks, kThreads, 0, st>>>(w, ln, o, h, T, C, P);
    return (int)cudaGetLastError();
  }
  const unsigned int blocks = (unsigned int)((n + kThreads / 32 - 1) / (kThreads / 32));
  if (walk == 1) {
    if (strided) warp_vanilla_fleet_kernel<2><<<blocks, kThreads, 0, st>>>(w, ln, o, h, T, C, P);
    else warp_vanilla_fleet_kernel<1><<<blocks, kThreads, 0, st>>>(w, ln, o, h, T, C, P);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// elem_stride: 1, w0 and w1 are (T, C, P) planes; 2, w0 is the packed
// (T, C, P, 2) words (w1 unused).
extern "C" int resolve_direct_fleet(const void* w0, const void* w1,
                                    const void* lengths, void* owner, void* h0,
                                    void* h1, int T, int C, int P,
                                    int elem_stride, void* stream) {
  (void)cudaGetLastError();
  if (elem_stride != 1 && elem_stride != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = std::min(kThreads, (P + 31) / 32 * 32);
  const dim3 grid((P + threads - 1) / threads, std::min(T, kMaxGridY));
  if (elem_stride == 2)
    direct_fleet_kernel<2><<<grid, threads, 0, st>>>(
        (const uint32_t*)w0, (const uint32_t*)w1, (const int32_t*)lengths,
        (int32_t*)owner, (uint32_t*)h0, (uint32_t*)h1, T, C, P);
  else
    direct_fleet_kernel<1><<<grid, threads, 0, st>>>(
        (const uint32_t*)w0, (const uint32_t*)w1, (const int32_t*)lengths,
        (int32_t*)owner, (uint32_t*)h0, (uint32_t*)h1, T, C, P);
  return (int)cudaGetLastError();
}

// The batch's auto resolve. l2: the packed (T, C, P, 2) words, contiguous
// and 8-byte aligned. ids: (T, B) int32, id_row and id_col elements apart,
// each in [0, P). out32: (3, T, B) int32 (owner, ptr, lookups); out8:
// (3, T, B) bool (found, zero, cold). walk: 0 one thread a read, 1 one warp
// a read.
extern "C" int resolve_auto_batch(const void* l2, const void* lengths,
                                  const void* ids, long long id_row,
                                  long long id_col, void* out32, void* out8,
                                  int T, int C, int P, int B, int walk,
                                  void* stream) {
  (void)cudaGetLastError();
  if (walk != 0 && walk != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const AutoBatch a{(const uint32_t*)l2, (const int32_t*)lengths,
                    (const int32_t*)ids, id_row, id_col, (int32_t*)out32,
                    (uint8_t*)out8, T, C, P, B};
  const long long n = (long long)T * B;
  const long long per_block = walk == 0 ? kThreads : kThreads / 32;
  const unsigned int blocks = (unsigned int)((n + per_block - 1) / per_block);
  if (walk == 0)
    batch_vanilla_fleet_kernel<<<blocks, kThreads, 0, st>>>(a);
  else
    batch_warp_vanilla_fleet_kernel<<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// alloc_bytes: 1 (bool) or 4 (int32) per allocation-map entry; vec: pages
// a thread (1 or 4), which must divide N, with the plane aligned to
// vec * alloc_bytes.
extern "C" int resolve_vanilla(const void* alloc, const void* ptrs,
                               const void* length, void* owner, void* ptr,
                               int C, int N, int alloc_bytes, int vec,
                               void* stream) {
  (void)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define SNAP_VANILLA(E, V)                                                   \
  if (alloc_bytes == E && vec == V)                                          \
    return launch_vanilla<E, V, (kVanillaLoadWords / Entries<E, V>::kWords)>( \
        alloc, ptrs, length, owner, ptr, C, N, st);
  SNAP_VANILLA(1, 1) SNAP_VANILLA(1, 4) SNAP_VANILLA(4, 1) SNAP_VANILLA(4, 4)
#undef SNAP_VANILLA
  return (int)cudaErrorInvalidValue;
}

extern "C" int resolve_direct(const void* alloc, const void* bfi,
                              const void* ptrs, void* owner, void* ptr, int N,
                              int alloc_bytes, void* stream) {
  (void)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (alloc_bytes == 1) {
    direct_kernel<uint8_t><<<blocks_for(1, N), kThreads, 0, st>>>(
        (const uint8_t*)alloc, (const int32_t*)bfi, (const int32_t*)ptrs,
        (int32_t*)owner, (int32_t*)ptr, N);
  } else if (alloc_bytes == 4) {
    direct_kernel<int32_t><<<blocks_for(1, N), kThreads, 0, st>>>(
        (const int32_t*)alloc, (const int32_t*)bfi, (const int32_t*)ptrs,
        (int32_t*)owner, (int32_t*)ptr, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
