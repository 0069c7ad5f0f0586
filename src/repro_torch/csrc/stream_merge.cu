// Streaming merge plan (the owner scan of a chain's lower layers), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/stream_merge/stream_merge.py:
//   merge          <- merge_pallas (_merge_kernel): (K, N) planes in
//   merge_entries  the same scan on the packed (K, N, 2) L2 words, with
//                  the merged entries out (the plan of core/chain.py's
//                  plan_merge, which the TPU built with plane copies and a
//                  gather around merge_pallas)
//
// What it computes: per page, the highest of K layers that has it
// allocated (last write wins): src (the layer, -1 if none) and found
// (src >= 0). merge also gives that layer's pointer (0 if none);
// merge_entries gives its two entry words, layer 0's on a miss (as
// jnp.take_along_axis at max(src, 0) does). It is the plan of the paper's
// streaming job, which merges layers [0, K-1] into one base.
//
// What bounds it on the card: device-memory bytes, and the latency of
// getting them. A page does one compare per entry it reads, far below the
// card's ratio of operations to bytes; but a walk that issues one load,
// tests it, then issues the next keeps one load a thread in flight, about
// 2 KB an SM at full occupancy, where the card's 3.35 TB/s at ~600 ns
// needs ~15 KB an SM. That is what held the first version at 17 % of its
// bound.
//
// What the design does about it: "last write wins going up" is "first hit
// going down", so a thread walks its page(s) down from layer K-1 and stops
// after the batch that holds its first hit; each batch issues U layers'
// loads before testing any (batched_first_hit, chain_walk.cuh). A page
// reads at most U - 1 entries past its owner. Neighbouring threads hold
// neighbouring pages, so every layer's loads are coalesced along N.
//   merge_entries reads each entry in place as one 8-byte load (ALLOCATED
//   is word0's sign bit) and writes the hit entry, or layer 0's, straight
//   into `merged`: no plane copy, no gather, one launch for the whole
//   plan. A warp's load of one layer is 256 contiguous bytes. word1 comes
//   with word0: a 32-byte sector holds four whole entries. U = 4 (it beat
//   8 on an H100 at the depth-500 disk; PERF.md).
//   merge reads a bool or int32 plane through one templated loader
//   (planes_first_hit, chain_walk.cuh, which K6 shares): a thread owns V
//   neighbouring pages (4, so one load of a bool plane is 4 bytes, of an
//   int32 plane 16; 1 where 4 does not divide N), walks 32 layers a batch
//   until all V have an owner, then reads one pointer per hit. 4 pages x
//   32 layers won a sweep of {1, 4} x {8, 16, 32} on a bool plane
//   (PERF.md); the int32 plane takes the same and was not timed here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_walk.cuh"

#ifndef FMT_FLAG_ALLOCATED
#error "build through repro_torch.kernels._build: the format macros are missing"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kEntriesUnroll = 4;   // U of the word entry
constexpr int kPlanesUnroll = 32;   // U of the planes entry

__global__ void merge_entries_kernel(const uint2* __restrict__ sub,
                                     uint2* __restrict__ merged,
                                     uint8_t* __restrict__ found,
                                     int32_t* __restrict__ src, int K, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const uint2* col = sub + p;
  uint2 e = make_uint2(0u, 0u);
  const int s = batched_first_hit<kEntriesUnroll>(
      K - 1, [&](int layer) { return __ldg(col + (size_t)layer * N); },
      [](uint2 w) { return (w.x & FMT_FLAG_ALLOCATED) != 0u; }, &e);
  merged[p] = e;
  found[p] = s >= 0 ? 1 : 0;
  src[p] = s;
}

template <int E, int V>
__global__ void merge_kernel(const uint8_t* __restrict__ alloc,
                             const int32_t* __restrict__ ptrs,
                             uint8_t* __restrict__ found,
                             int32_t* __restrict__ ptr,
                             int32_t* __restrict__ src, int K, int N) {
  const long long p0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (p0 >= N) return;                     // the host makes V divide N
  int s[V];
  planes_first_hit<E, V, kPlanesUnroll>(alloc + p0 * E, (size_t)N * E, K - 1, s);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const long long p = p0 + i;
    src[p] = s[i];
    found[p] = s[i] >= 0 ? 1 : 0;
    ptr[p] = s[i] >= 0 ? ptrs[(size_t)s[i] * N + p] : 0;
  }
}

unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

template <int E, int V>
void launch_merge(const void* alloc, const void* ptrs, void* found, void* ptr,
                  void* src, int K, int N, cudaStream_t st) {
  merge_kernel<E, V><<<blocks_for(N / V), kThreads, 0, st>>>(
      (const uint8_t*)alloc, (const int32_t*)ptrs, (uint8_t*)found,
      (int32_t*)ptr, (int32_t*)src, K, N);
}

}  // namespace

// The plan on the packed (K, N, 2) words.
extern "C" int merge_entries(const void* sub, void* merged, void* found,
                             void* src, int K, int N, void* stream) {
  (void)cudaGetLastError();
  merge_entries_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint2*)sub, (uint2*)merged, (uint8_t*)found, (int32_t*)src, K, N);
  return (int)cudaGetLastError();
}

// The scan on (K, N) planes. alloc_bytes: 1 (bool) or 4 (int32) per
// allocation-map entry; vec: pages a thread (1 or 4), which must divide N,
// with the plane aligned to vec * alloc_bytes.
extern "C" int merge(const void* alloc, const void* ptrs, void* found,
                     void* ptr, void* src, int K, int N, int alloc_bytes,
                     int vec, void* stream) {
  (void)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define SNAP_MERGE(E, V)                                                \
  if (alloc_bytes == E && vec == V) {                                   \
    launch_merge<E, V>(alloc, ptrs, found, ptr, src, K, N, st);         \
    return (int)cudaGetLastError();                                     \
  }
  SNAP_MERGE(1, 1) SNAP_MERGE(1, 4) SNAP_MERGE(4, 1) SNAP_MERGE(4, 4)
#undef SNAP_MERGE
  return (int)cudaErrorInvalidValue;
}
