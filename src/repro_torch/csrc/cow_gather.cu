// Resolved-page gather from the device page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/cow_gather/cow_gather.py:
//   gather_fleet  <- gather_fleet_pallas (_gather_fleet_kernel), (T, B) pages
//   gather        <- gather_pallas       (_gather_kernel), the T = 1 case
// Both launch the one kernel below through cow_gather; the wrappers count
// them apart. Its second entry, cow_gather_resolved (no TPU counterpart),
// is K5 on a resolve's leaves as the resolver wrote them, so a fleet read
// makes no mask between the resolve and the gather.
//
// What it computes: out[i] = pool[rows[i]] where found[i] and
// 0 <= rows[i] < R, else zero bytes, for every output page i of the
// flattened (T * B) batch. Pages are copied as raw bytes, so one kernel
// serves every element type (f32, bf16, ...). The two entries differ only
// in the prologue that gives page i's row and its test (a Source below):
// cow_gather reads rows[i] and found[i]; cow_gather_resolved reads ptr[i]
// and the resolve's found[i] && !zero[i] && !cold[i], the pages that live
// in the device pool.
//
// What bounds it on the card: device-memory bytes. It does no arithmetic:
// each found page is read once and every output page written once, so the
// least time is (found pages + output pages) * page bytes over 3.35 TB/s.
// To reach it the card needs a few MB of loads in flight.
//
// What the design does about it: a group of G warps (G = 1, 2, 4 or 8)
// owns a page, and a block of eight warps owns 8 / G pages; no warp takes
// a second page (chip_smoke.py's sweep measured that slower: a block holds
// its SM slot until its slowest page is done). Each warp loads its page's
// row and found entries first. Then each lane issues U 16-byte loads
// (read-only path, ld.global.nc) before any of their stores, the group's
// lanes on neighbouring 16 bytes, so one load instruction of the group
// reads G * 512 contiguous bytes. The wrapper picks G and U from the page
// bytes alone: an 8 KiB page goes to 4 warps of 4 loads a lane, a 64 KiB
// page to 8 warps of 16, one round each. Nothing is staged through shared
// memory: a gather moves each byte once, so registers are the shortest way
// from load to store. Where a page's source and destination are not both
// 16-byte aligned the group moves the widest of 8/4/2/1 bytes that divides
// both addresses, and the bytes past the last whole unit one at a time
// (the tail). Where a page is not found the group writes zeros and never
// touches the pool, so a masked row's pointer (a hole, a ZERO cluster, or
// a COLD entry's host-tier row) is never dereferenced; a found row outside
// [0, R) is written as zeros too, so the kernel can never read past the
// pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kNarrowUnits = 4;        // loads a lane a round below 16 B

// a page's n units by the group's `threads` lanes, this one of rank `me`:
// U loads a lane in flight, then their U stores, a round at a time
template <typename V, int U>
__device__ __forceinline__ void copy_rounds(const V* __restrict__ src,
                                            V* __restrict__ dst, long long n,
                                            int me, int threads) {
  for (long long base = me; base < n; base += (long long)threads * U) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + (long long)u * threads < n) v[u] = __ldg(src + base + u * threads);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + (long long)u * threads < n) dst[base + u * threads] = v[u];
    }
  }
}

template <typename V>
__device__ __forceinline__ void zero_units(V* __restrict__ dst, long long n,
                                           int me, int threads) {
  const V z{};
  for (long long i = me; i < n; i += threads) dst[i] = z;
}

// widest of 16/8/4/2/1 bytes that divides the address
__device__ __forceinline__ int width_of(uintptr_t addr) {
  if (addr % 16 == 0) return 16;
  if (addr % 8 == 0) return 8;
  if (addr % 4 == 0) return 4;
  if (addr % 2 == 0) return 2;
  return 1;
}

template <typename V, int U>
__device__ __forceinline__ void move(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ dst,
                                     long long nbytes, int me, int threads) {
  const long long n = nbytes / (long long)sizeof(V);
  if (src) {
    copy_rounds<V, U>((const V*)src, (V*)dst, n, me, threads);
  } else {
    zero_units<V>((V*)dst, n, me, threads);
  }
  // the tail: bytes past the last whole unit
  for (long long b = n * (long long)sizeof(V) + me; b < nbytes; b += threads) {
    dst[b] = src ? __ldg(src + b) : (uint8_t)0;
  }
}

// one page by one group; src is null where the page reads as zeros
template <int U>
__device__ __forceinline__ void move_page(const uint8_t* src, uint8_t* dst,
                                          long long nbytes, int me,
                                          int threads) {
  // the same width for every lane of the group: the choice is uniform
  switch (width_of((uintptr_t)dst | (src ? (uintptr_t)src : 0))) {
    case 16: move<uint4, U>(src, dst, nbytes, me, threads); break;
    case 8: move<uint2, kNarrowUnits>(src, dst, nbytes, me, threads); break;
    case 4: move<uint32_t, kNarrowUnits>(src, dst, nbytes, me, threads); break;
    case 2: move<uint16_t, kNarrowUnits>(src, dst, nbytes, me, threads); break;
    default: move<uint8_t, kNarrowUnits>(src, dst, nbytes, me, threads); break;
  }
}

// The prologues: page i's pool row and whether the caller reads it from
// the pool. Each loads its words before any test, so the loads are in
// flight together.
struct RowsFound {                     // cow_gather: the rows a caller holds
  const int32_t* rows;
  const uint8_t* found;
  __device__ __forceinline__ bool take(long long i, int32_t* row) const {
    *row = __ldg(rows + i);
    return __ldg(found + i) != 0;
  }
};

struct ResolvedLeaves {                // cow_gather_resolved: a resolve's leaves
  const int32_t* ptr;
  const uint8_t* found;
  const uint8_t* zero;
  const uint8_t* cold;
  __device__ __forceinline__ bool take(long long i, int32_t* row) const {
    *row = __ldg(ptr + i);
    const uint8_t f = __ldg(found + i), z = __ldg(zero + i), c = __ldg(cold + i);
    return (f != 0) & (z == 0) & (c == 0);
  }
};

template <int U, typename Source>
__global__ void __launch_bounds__(kThreads)
gather_pages_kernel(const Source source, const uint8_t* __restrict__ pool,
                    uint8_t* __restrict__ out, long long n_out, long long R,
                    long long row_bytes, int warps_per_page) {
  const int warp = threadIdx.x >> 5;
  const long long i =
      (long long)blockIdx.x * (kWarps / warps_per_page) + warp / warps_per_page;
  if (i >= n_out) return;              // uniform across the group
  int32_t r;
  const bool ok = source.take(i, &r) && r >= 0 && (long long)r < R;
  const int threads = 32 * warps_per_page;
  move_page<U>(ok ? pool + (long long)r * row_bytes : nullptr,
               out + i * row_bytes, row_bytes,
               (warp % warps_per_page) * 32 + (threadIdx.x & 31), threads);
}

template <int U, typename Source>
cudaError_t launch(const Source& source, const void* pool, void* out,
                   long long n_out, long long R, long long row_bytes,
                   int warps_per_page, cudaStream_t stream) {
  const long long per_block = kWarps / warps_per_page;
  const long long blocks = (n_out + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gather_pages_kernel<U, Source><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      source, (const uint8_t*)pool, (uint8_t*)out, n_out, R, row_bytes,
      warps_per_page);
  return cudaGetLastError();
}

// units: 16-byte loads a lane a round (1, 2, 4, 8 or 16); warps_per_page:
// 1, 2, 4 or 8
template <typename Source>
int gather(const Source& source, const void* pool, void* out, long long n_out,
           long long R, long long row_bytes, int units, int warps_per_page,
           void* stream) {
  (void)cudaGetLastError();
  if (warps_per_page < 1 || warps_per_page > kWarps ||
      kWarps % warps_per_page != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (units) {
#define GATHER_CASE(u) \
    case u: return (int)launch<u>(source, pool, out, n_out, R, row_bytes, \
                                  warps_per_page, s);
    GATHER_CASE(1) GATHER_CASE(2) GATHER_CASE(4) GATHER_CASE(8) GATHER_CASE(16)
#undef GATHER_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pool (R, row_bytes) bytes; rows (n_out,) int32; found (n_out,) bool;
// out (n_out, row_bytes) bytes.
extern "C" int cow_gather(const void* pool, const void* rows, const void* found,
                          void* out, long long n_out, long long R,
                          long long row_bytes, int units, int warps_per_page,
                          void* stream) {
  return gather(RowsFound{(const int32_t*)rows, (const uint8_t*)found}, pool,
                out, n_out, R, row_bytes, units, warps_per_page, stream);
}

// As cow_gather, on a resolve's leaves: ptr (n_out,) int32; found, zero and
// cold (n_out,) bool each.
extern "C" int cow_gather_resolved(const void* pool, const void* ptr,
                                   const void* found, const void* zero,
                                   const void* cold, void* out, long long n_out,
                                   long long R, long long row_bytes, int units,
                                   int warps_per_page, void* stream) {
  return gather(ResolvedLeaves{(const int32_t*)ptr, (const uint8_t*)found,
                               (const uint8_t*)zero, (const uint8_t*)cold},
                pool, out, n_out, R, row_bytes, units, warps_per_page, stream);
}
