// First-hit walks down a snapshot chain. first_hit_down is the
// single-chain walk shared by K6 (chain_resolve.cu, resolve_vanilla) and
// K9 (stream_merge.cu, merge); warp_first_hit_row, below, is K4's.
//
// One thread owns page p of a chain stored as (C, N) planes. It walks
// down from layer `top` and stops at the first layer whose allocation
// entry is non-zero; that is the page's owner (-1 if no layer has it).
// "First hit going down" is "last write wins going up", so the same walk
// resolves a read (K6, top = length - 1) and plans a streaming merge (K9,
// top = K - 1 of the merged layers). Neighbouring threads hold
// neighbouring pages, so each layer's loads are coalesced along N, and a
// page stops reading at its owner: only the layers above it are read.

#pragma once

#include <stdint.h>

template <typename A>
__device__ __forceinline__ int first_hit_down(const A* __restrict__ alloc,
                                              int top, int N, int p) {
  for (int layer = top; layer >= 0; --layer) {
    if (alloc[(size_t)layer * N + p] != 0) return layer;
  }
  return -1;
}

// The warp-cooperative first-hit walk of one page of a (C, P) word0 stack,
// for the fused attention kernel (K4, paged_attention.cu). `col` points at
// the page's word in layer 0; layers are P words apart. The 32 lanes read
// 32 layers at once, lane i layer base - i; the ballot of ALLOCATED words
// (the int32 carrier's sign bit, tested != 0) picks the top-most hit with
// __ffs, so a 65-layer chain takes at most three rounds instead of 65
// dependent loads. Returns the pool row (the hit word's FMT_PTR_MASK bits)
// or -1 on a miss, the rows of fused_tables_ref. All 32 lanes must call it
// with the same arguments; every lane gets the result.
__device__ __forceinline__ int warp_first_hit_row(const uint32_t* __restrict__ col,
                                                  int top, int P) {
  const int lane = threadIdx.x & 31;
  for (int base = top; base >= 0; base -= 32) {
    const int layer = base - lane;
    const uint32_t w = layer >= 0 ? col[(size_t)layer * P] : 0u;
    const unsigned hit = __ballot_sync(0xffffffffu, (w & FMT_FLAG_ALLOCATED) != 0u);
    if (hit) {
      const uint32_t hw = __shfl_sync(0xffffffffu, w, __ffs(hit) - 1);
      return (int)(hw & FMT_PTR_MASK);
    }
  }
  return -1;
}
