// The single-chain first-hit walk, shared by K6 (chain_resolve.cu,
// resolve_vanilla) and K9 (stream_merge.cu, merge).
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
