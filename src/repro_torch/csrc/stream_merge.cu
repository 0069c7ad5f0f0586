// Streaming merge plan (the owner scan of a chain's lower layers), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/stream_merge/stream_merge.py:
//   merge  <- merge_pallas (_merge_kernel)
//
// What it computes: for K layers of a chain stored as (K, N) planes (an
// allocation map and a pointer plane), per page the highest layer that has
// it allocated (last write wins): src (the layer, -1 if none), found
// (src >= 0) and ptr (that layer's pointer, 0 if none). It is the plan of
// the paper's streaming job, which merges layers [0, K-1] into one base.
//
// What bounds it on the card: device-memory bytes. A page does one compare
// per 4-byte word it reads, far below the card's ratio of operations to
// bytes.
//
// What the design does about it: one thread per page, coalesced along N.
// "Last write wins going up" is "first hit going down", so each thread
// walks down from layer K-1 and stops at its first allocated layer
// (first_hit_down, the walk K6 uses), then reads one pointer. The TPU
// kernel's fori_loop visits all K layers of every page and both planes;
// here a page reads only the allocation words above its owner, and the
// pointer plane once per hit. Outputs are 9 bytes a page.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <typename A>
__global__ void merge_kernel(const A* __restrict__ alloc,
                             const int32_t* __restrict__ ptrs,
                             uint8_t* __restrict__ found,
                             int32_t* __restrict__ ptr,
                             int32_t* __restrict__ src, int K, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int s = first_hit_down(alloc, K - 1, N, p);
  src[p] = s;
  found[p] = s >= 0 ? 1 : 0;
  ptr[p] = s >= 0 ? ptrs[(size_t)s * N + p] : 0;
}

}  // namespace

// alloc_bytes: 1 (bool) or 4 (int32) per allocation-map entry.
extern "C" int merge(const void* alloc, const void* ptrs, void* found,
                     void* ptr, void* src, int K, int N, int alloc_bytes,
                     void* stream) {
  (void)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)((N + kThreads - 1) / kThreads);
  if (alloc_bytes == 1) {
    merge_kernel<uint8_t><<<blocks, kThreads, 0, st>>>(
        (const uint8_t*)alloc, (const int32_t*)ptrs, (uint8_t*)found,
        (int32_t*)ptr, (int32_t*)src, K, N);
  } else if (alloc_bytes == 4) {
    merge_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        (const int32_t*)alloc, (const int32_t*)ptrs, (uint8_t*)found,
        (int32_t*)ptr, (int32_t*)src, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
