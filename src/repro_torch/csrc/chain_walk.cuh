// First-hit walks down a snapshot chain. planes_first_hit is the walk of
// one chain's (C, N) allocation plane (K9's planes entry, stream_merge.cu
// merge, and K6, chain_resolve.cu resolve_vanilla); warp_first_hit_row is
// K4's; batched_first_hit (K1's many-pages walk and K9's word entry) and
// warp_first_hit (K1's few-pages walk) walk the packed entry words.
//
// A thread owns page p (or V neighbouring pages) of a chain stored as
// (C, N) planes. It walks down from layer `top` and stops at the first
// layer whose allocation entry is non-zero; that is the page's owner (-1
// if no layer has it). "First hit going down" is "last write wins going
// up", so the same walk resolves a read (top = min(length, C) - 1) and
// plans a streaming merge (top = K - 1 of the merged layers). Neighbouring
// threads hold neighbouring pages, so each layer's loads are coalesced
// along N, and a page stops reading at its owner (or at most a batch
// past it): only the layers above it are read.

#pragma once

#include <stdint.h>

// V neighbouring allocation entries of E bytes (1: bool, 4: int32), read
// as one load of E * V bytes.
template <int E, int V>
struct Entries {
  static constexpr int kBytes = E * V;
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ at) {
    if constexpr (kBytes == 16) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(at));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(at));
    } else {
      static_assert(kBytes == 1, "bool x1, bool x4, int32 x1, int32 x4");
      w[0] = __ldg(at);
    }
  }

  __device__ __forceinline__ bool allocated(int i) const {
    if constexpr (E == 4) return w[i] != 0u;
    else return ((w[i / 4] >> (8 * (i % 4))) & 0xffu) != 0u;
  }
};

// The first-hit walk of V neighbouring pages of a (C, N) allocation plane
// of E-byte entries (tested != 0). `col` points at the first page's entry
// in layer 0; layers are `row_bytes` apart, and `col` is aligned to E * V
// bytes (so is every layer: V divides N). A batch issues U layers' loads,
// one load of V entries a layer, before testing any; the walk goes on
// from layer `top` down until all V pages have an owner. `s[i]` gets page
// i's owner (-1 on a miss). Loads below layer 0 are clamped to layer 0
// (the same sector) and never tested. A group reads as deep as its
// deepest page, plus at most U - 1 layers.
template <int E, int V, int U>
__device__ __forceinline__ void planes_first_hit(const uint8_t* __restrict__ col,
                                                 size_t row_bytes, int top,
                                                 int (&s)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = -1;
  bool open = true;
  for (int base = top; base >= 0 && open; base -= U) {
    Entries<E, V> x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) x[j].load(col + (size_t)max(base - j, 0) * row_bytes);
    open = false;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int c = -1;
#pragma unroll
      for (int j = U - 1; j >= 0; --j) {
        if (base - j >= 0 && x[j].allocated(i)) c = base - j;
      }
      if (s[i] < 0) s[i] = c;
      open |= s[i] < 0;
    }
  }
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

// The batched first-hit walk of one page: U layers' loads are issued
// before any of them is tested, so a thread keeps U loads in flight
// instead of one (a dependent load per layer is latency-bound: at full
// occupancy an SM then has ~2 KB in flight, and the card needs ~15 KB an
// SM to stream at its memory rate). `load(layer)` returns the page's
// entry of that layer, `hit(entry)` whether that layer owns the page.
// Loads below layer 0 are clamped to layer 0 (the same sector, no extra
// traffic) and never tested. Returns the owner (-1 on a miss); `*out` gets
// the owner's entry, or on a miss layer 0's entry, which the last batch
// loaded (its last slot is layer 0 whenever it reaches below layer 0).
// A page reads at most U - 1 entries past its owner.
template <int U, typename W, typename Load, typename Hit>
__device__ __forceinline__ int batched_first_hit(int top, Load load, Hit hit,
                                                 W* out) {
  for (int base = top; base >= 0; base -= U) {
    W w[U];
#pragma unroll
    for (int j = 0; j < U; ++j) w[j] = load(max(base - j, 0));
    int s = -1;
#pragma unroll
    for (int j = U - 1; j >= 0; --j) {
      // descending j: the last hit taken is the top-most layer
      if (base - j >= 0 && hit(w[j])) {
        s = base - j;
        *out = w[j];
      }
    }
    if (s >= 0) return s;
    *out = w[U - 1];
  }
  return -1;
}

// The warp-cooperative first-hit walk of one page that also returns the
// hit: in a round lane i issues kWarpWalkLoads loads at once, layers
// base - i - 32j for j < kWarpWalkLoads, of `col` (layers `stride` words
// apart); the ballot of ALLOCATED words, taken for j = 0, 1, ..., picks the
// top-most hit with __ffs, and every lane gets the owner layer (-1 on a
// miss) and `*word`, the owner's word (0 on a miss). A round covers 128
// layers for one load's latency, so a 65-layer chain costs one round, not
// 65 dependent loads (at one load a lane, as warp_first_hit_row, three).
// All 32 lanes must call it with the same arguments.
constexpr int kWarpWalkLoads = 4;

__device__ __forceinline__ int warp_first_hit(const uint32_t* __restrict__ col,
                                              int top, size_t stride,
                                              uint32_t* word) {
  const int lane = threadIdx.x & 31;
  for (int base = top; base >= 0; base -= 32 * kWarpWalkLoads) {
    uint32_t w[kWarpWalkLoads];
#pragma unroll
    for (int j = 0; j < kWarpWalkLoads; ++j) {
      const int layer = base - 32 * j - lane;
      w[j] = layer >= 0 ? __ldg(col + (size_t)layer * stride) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kWarpWalkLoads; ++j) {
      const unsigned hit = __ballot_sync(0xffffffffu,
                                         (w[j] & FMT_FLAG_ALLOCATED) != 0u);
      if (hit) {
        const int src = __ffs(hit) - 1;
        *word = __shfl_sync(0xffffffffu, w[j], src);
        return base - 32 * j - src;
      }
    }
  }
  *word = 0u;
  return -1;
}
