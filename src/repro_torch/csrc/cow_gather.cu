// Resolved-page gather from the device page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/cow_gather/cow_gather.py:
//   gather_fleet  <- gather_fleet_pallas (_gather_fleet_kernel), (T, B) pages
//   gather        <- gather_pallas       (_gather_kernel), the T = 1 case
// Both launch the one kernel below; the wrappers count them apart.
//
// What it computes: out[i] = pool[rows[i]] where found[i], else zeros, for
// every output page i of the flattened (T * B) batch.
//
// What bounds it on the card: device-memory bytes. It does no arithmetic:
// each found page is read once and every output page written once, so the
// least time is (found pages + output pages) * page bytes over 3.35 TB/s.
//
// What the design does about it: one block per output page, which copies
// the page as raw bytes, so one kernel serves every element type (f32,
// bf16, ...). Where the source and destination rows are both 16-byte
// aligned (any page of 4 f32 / 8 bf16 multiples) the block moves 16-byte
// vectors, four in flight per thread before the stores, with neighbouring
// threads on neighbouring addresses; a row that is only 8-, 4- or 2-byte
// aligned moves in that width, and the bytes past the last whole vector
// are copied one at a time (the tail). Where a page is not found the block
// writes zeros and never touches the pool, so a masked row's pointer (a
// hole, a ZERO cluster, or a COLD entry's host-tier row) is never
// dereferenced; a found row outside [0, R) is written as zeros too, so
// the kernel can never read past the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;

template <typename V>
__device__ __forceinline__ void copy_units(const V* __restrict__ src,
                                           V* __restrict__ dst, long long n) {
  long long i = threadIdx.x;
  const long long step = (long long)kThreads * kInFlight;
  for (; i + (kInFlight - 1) * kThreads < n; i += step) {
    V v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) v[k] = src[i + k * kThreads];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) dst[i + k * kThreads] = v[k];
  }
  for (; i < n; i += kThreads) dst[i] = src[i];
}

template <typename V>
__device__ __forceinline__ void zero_units(V* __restrict__ dst, long long n) {
  const V z{};
  for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = z;
}

// widest of 16/8/4/2/1 bytes that divides the address
__device__ __forceinline__ int width_of(uintptr_t addr) {
  if (addr % 16 == 0) return 16;
  if (addr % 8 == 0) return 8;
  if (addr % 4 == 0) return 4;
  if (addr % 2 == 0) return 2;
  return 1;
}

template <typename V>
__device__ __forceinline__ void move(const uint8_t* src, uint8_t* dst,
                                     long long nbytes) {
  const long long n = nbytes / (long long)sizeof(V);
  if (src) {
    copy_units<V>((const V*)src, (V*)dst, n);
  } else {
    zero_units<V>((V*)dst, n);
  }
  // the tail: bytes past the last whole unit
  for (long long b = n * (long long)sizeof(V) + threadIdx.x; b < nbytes;
       b += kThreads) {
    dst[b] = src ? src[b] : (uint8_t)0;
  }
}

__global__ void gather_rows_kernel(const uint8_t* __restrict__ pool,
                                   const int32_t* __restrict__ rows,
                                   const uint8_t* __restrict__ found,
                                   uint8_t* __restrict__ out, long long R,
                                   long long row_bytes) {
  const long long i = blockIdx.x;
  const int32_t r = rows[i];
  const bool ok = found[i] != 0 && r >= 0 && (long long)r < R;
  const uint8_t* src = ok ? pool + (long long)r * row_bytes : nullptr;
  uint8_t* dst = out + i * row_bytes;
  // the same width for every thread of the block: the choice is uniform
  const int w = width_of((uintptr_t)dst | (src ? (uintptr_t)src : 0));
  switch (w) {
    case 16: move<uint4>(src, dst, row_bytes); break;
    case 8: move<uint2>(src, dst, row_bytes); break;
    case 4: move<uint32_t>(src, dst, row_bytes); break;
    case 2: move<uint16_t>(src, dst, row_bytes); break;
    default: move<uint8_t>(src, dst, row_bytes); break;
  }
}

}  // namespace

// pool (R, row_bytes) bytes; rows (n_out,) int32; found (n_out,) bool;
// out (n_out, row_bytes) bytes.
extern "C" int cow_gather(const void* pool, const void* rows, const void* found,
                          void* out, long long n_out, long long R,
                          long long row_bytes, void* stream) {
  (void)cudaGetLastError();
  if (n_out > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gather_rows_kernel<<<(unsigned int)n_out, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)pool, (const int32_t*)rows, (const uint8_t*)found,
      (uint8_t*)out, R, row_bytes);
  return (int)cudaGetLastError();
}
