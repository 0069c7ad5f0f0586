// Decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention        <- paged_attention_pallas       (_paged_attn_kernel)
//   fused_chain_attention  <- fused_chain_attention_pallas (_fused_chain_attn_kernel)
//
// What bounds them on the card: device-memory bytes. A decode step reads
// each KV position once per KV head and does about 4 * G flops per element
// read (G = query heads per KV head), far below the card's ratio of
// operations to bytes.
//
// What the design does about it: one block per (batch row, KV head), so
// the G query heads of a GQA group share every K/V block load (for
// Qwen2.5-3B, G = 8: one read serves eight heads). The TPU grid's
// sequential kv-block axis becomes a loop inside the block: the online
// softmax state (m, l, acc) stays in fp32 shared memory for the whole
// sweep and never touches device memory, and the loop stops at
// ceil(length / block_size) instead of visiting every table column.
// K/V rows are loaded 128 threads wide, contiguous along the head
// dimension, so the loads coalesce.
//
// The attention body is written once (attend) and both kernels call it;
// they differ only in where the block's pool rows come from. The tables
// kernel copies tables[b, j] clamped at 0 (as paged_attention.py:97); the
// fused kernel walks the tenant's (C, P) word0 stack first (the K1 walk of
// chain_resolve.cu, over the pages in parallel) and parks the resolved
// rows, -1 for holes, in shared memory. On the same rows the two kernels
// therefore give bit-identical outputs.
//
// Numerics follow the Pallas kernels: fp32 scores, -inf for masked
// positions, the isfinite guards on m, out = acc / max(l, 1e-30) in the
// input type, so an all-masked row comes out as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FMT_FLAG_ALLOCATED
#error "build through repro_torch.kernels._build: the format macros are missing"
#endif

namespace {

constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// Shared-memory floats the attention body needs (the row list follows).
__host__ __device__ inline int attend_floats(int G, int D, int bs) {
  return G * D          // q
       + bs * (D + 1)   // k, rows padded by one to spread the dot's banks
       + bs * D         // v
       + G * bs         // scores, then probabilities
       + G * D          // acc
       + 3 * G;         // m, l, alpha
}

// The block's attention over `nblk` pool rows parked in `rows` (-1 =
// hole). Block = (batch row b, KV head kvh); its G query heads are
// kvh*G .. kvh*G+G-1.
template <typename T>
__device__ void attend(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v, const int* rows, int nblk,
                       int kvlen, T* __restrict__ out, int b, int kvh, int H,
                       int Hkv, int D, int nb, int bs, float* smem) {
  const int G = H / Hkv;
  const int KS = D + 1;
  float* qs = smem;
  float* ks = qs + G * D;
  float* vs = ks + bs * KS;
  float* ps = vs + bs * D;
  float* acc = ps + G * bs;
  float* m = acc + G * D;
  float* l = m + G;
  float* alpha = l + G;
  const int tid = threadIdx.x;

  const size_t qbase = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_f32<T>(q[qbase + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const float scale = sqrtf((float)D);
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const int row = rows[j];
    const bool hole = row < 0;
    const int rs = min(max(row, 0), nb - 1);  // JAX clamps the pool gather
    for (int i = tid; i < bs * D; i += blockDim.x) {
      const int s = i / D, d = i - s * D;
      const size_t off = (((size_t)rs * bs + s) * Hkv + kvh) * D + d;
      ks[s * KS + d] = to_f32<T>(pool_k[off]);
      vs[i] = to_f32<T>(pool_v[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * bs; i += blockDim.x) {
      const int g = i / bs, s = i - g * bs;
      float sc = -INFINITY;
      if (!hole && j * bs + s < kvlen) {
        float dot = 0.f;
        const float* qg = qs + g * D;
        const float* kr = ks + s * KS;
        for (int d = 0; d < D; ++d) dot += qg[d] * kr[d];
        sc = dot / scale;
      }
      ps[i] = sc;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x) {
      float* pg = ps + g * bs;
      float mx = -INFINITY;
      for (int s = 0; s < bs; ++s) mx = fmaxf(mx, pg[s]);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      float sum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const float sc = pg[s];
        const float p = isfinite(sc) ? expf(sc - m_safe) : 0.f;
        pg[s] = p;
        sum += p;
      }
      l[g] = l[g] * a + sum;
      m[g] = m_new;
      alpha[g] = a;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pg = ps + g * bs;
      float pv = 0.f;
      for (int s = 0; s < bs; ++s) pv += pg[s] * vs[s * D + d];
      acc[i] = acc[i] * alpha[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    out[qbase + i] = from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ pool_k,
                                       const T* __restrict__ pool_v,
                                       const int32_t* __restrict__ tables,
                                       const int32_t* __restrict__ lengths,
                                       T* __restrict__ out, int H, int Hkv,
                                       int D, int nb, int bs, int M) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  int* rows = (int*)(smem + attend_floats(G, D, bs));
  const int len = lengths[b];
  const int nblk = len > 0 ? min(M, (len + bs - 1) / bs) : 0;
  // table entries are clamped to 0 for the load; masking comes from the
  // length alone (paged_attention.py:57-58, :97)
  for (int j = threadIdx.x; j < nblk; j += blockDim.x)
    rows[j] = max(tables[(size_t)b * M + j], 0);
  __syncthreads();
  attend<T>(q, pool_k, pool_v, rows, nblk, len, out, b, kvh, H, Hkv, D, nb,
            bs, smem);
}

template <typename T>
__global__ void fused_chain_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const uint32_t* __restrict__ w0,
    const int32_t* __restrict__ chain_lengths,
    const int32_t* __restrict__ tenants, const int32_t* __restrict__ kv_lengths,
    T* __restrict__ out, int H, int Hkv, int D, int nb, int bs, int Tn, int C,
    int P) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  int* rows = (int*)(smem + attend_floats(G, D, bs));
  const int t = min(max(tenants[b], 0), Tn - 1);
  const int kvlen = kv_lengths[b];
  const int nblk = kvlen > 0 ? min(P, (kvlen + bs - 1) / bs) : 0;
  const int top = min(chain_lengths[t], C) - 1;
  // the fused chain walk: the block's threads resolve its pages in
  // parallel, first hit from the tenant's active layer down
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    const uint32_t* col = w0 + (size_t)t * C * P + j;
    int r = -1;
    for (int layer = top; layer >= 0; --layer) {
      const uint32_t w = col[(size_t)layer * P];
      if (w & FMT_FLAG_ALLOCATED) {
        r = (int)(w & FMT_PTR_MASK);
        break;
      }
    }
    rows[j] = r;
  }
  __syncthreads();
  attend<T>(q, pool_k, pool_v, rows, nblk, kvlen, out, b, kvh, H, Hkv, D, nb,
            bs, smem);
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  (void)cudaGetLastError();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int paged_attention(const void* q, const void* pool_k,
                               const void* pool_v, const void* tables,
                               const void* lengths, void* out, int B, int H,
                               int Hkv, int D, int nb, int bs, int M,
                               int dtype, void* stream) {
  const int G = H / Hkv;
  const size_t smem = attend_floats(G, D, bs) * sizeof(float) + M * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    int e = allow_smem(paged_attention_kernel<float>, smem);
    if (e) return e;
    paged_attention_kernel<float><<<B * Hkv, kThreads, smem, st>>>(
        (const float*)q, (const float*)pool_k, (const float*)pool_v,
        (const int32_t*)tables, (const int32_t*)lengths, (float*)out, H, Hkv,
        D, nb, bs, M);
  } else if (dtype == 1) {
    int e = allow_smem(paged_attention_kernel<__nv_bfloat16>, smem);
    if (e) return e;
    paged_attention_kernel<__nv_bfloat16><<<B * Hkv, kThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool_k,
        (const __nv_bfloat16*)pool_v, (const int32_t*)tables,
        (const int32_t*)lengths, (__nv_bfloat16*)out, H, Hkv, D, nb, bs, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_chain_attention(const void* q, const void* pool_k,
                                     const void* pool_v, const void* w0,
                                     const void* chain_lengths,
                                     const void* tenants,
                                     const void* kv_lengths, void* out, int B,
                                     int H, int Hkv, int D, int nb, int bs,
                                     int Tn, int C, int P, int dtype,
                                     void* stream) {
  const int G = H / Hkv;
  const size_t smem = attend_floats(G, D, bs) * sizeof(float) + P * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    int e = allow_smem(fused_chain_attention_kernel<float>, smem);
    if (e) return e;
    fused_chain_attention_kernel<float><<<B * Hkv, kThreads, smem, st>>>(
        (const float*)q, (const float*)pool_k, (const float*)pool_v,
        (const uint32_t*)w0, (const int32_t*)chain_lengths,
        (const int32_t*)tenants, (const int32_t*)kv_lengths, (float*)out, H,
        Hkv, D, nb, bs, Tn, C, P);
  } else if (dtype == 1) {
    int e = allow_smem(fused_chain_attention_kernel<__nv_bfloat16>, smem);
    if (e) return e;
    fused_chain_attention_kernel<__nv_bfloat16><<<B * Hkv, kThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool_k,
        (const __nv_bfloat16*)pool_v, (const uint32_t*)w0,
        (const int32_t*)chain_lengths, (const int32_t*)tenants,
        (const int32_t*)kv_lengths, (__nv_bfloat16*)out, H, Hkv, D, nb, bs, Tn,
        C, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
