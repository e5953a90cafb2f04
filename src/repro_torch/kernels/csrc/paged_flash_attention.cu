// Gather-free chunked-prefill flash attention over a paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_attention` (_kernel) of
// src/repro/kernels/paged_flash_attention.py. Queries (B, Hq, Sq, D) attend
// over pool pages (P, page, Hkv, D) that the block table (B, Np) steers;
// each page is read IN PLACE, never gathered into a dense copy. Mask:
// kv_pos <= q_offset[b] + i and kv_pos < kv_len[b].
//
// Work split: one thread block per (q block, kv head h, row b). A block
// holds kRows = 64 query rows: block_q = kRows / G positions times the G
// query heads that share kv head h (row r -> position r / G, head r % G, so
// neighbouring rows sit at neighbouring positions). Each row is owned by
// D / 32 consecutive threads, each holding 32 of the row's q and
// accumulator entries in registers (interleaved, d = k * (D/32) + sub, so
// the threads of a row hit distinct shared-memory banks). Per page the
// block stages head h's (page, D) K and V slices in shared memory as f32,
// then every row runs the online softmax token by token in f32, with a
// 1e-30 floor on the denominator. The block stops at the last page that any
// of its rows can see, min(kv_len, q_offset + last row + 1); ragged Sq rows
// are masked in the kernel (no host-side padding).
//
// Bound on the H100: a chunk of C queries over a context of N tokens does
// about 4*C*N*Hq*D flops against about 4*N*Hkv*D*itemsize bytes of KV, so
// long chunks are compute-bound. This first version does its products on
// the CUDA cores in f32 (no wgmma, no TMA); its time is in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / 32))
paged_flash_kernel(const T* __restrict__ q,          // (B, Hq, Sq, D)
                   const T* __restrict__ k_pages,    // (P, page, Hkv, D)
                   const T* __restrict__ v_pages,
                   const int* __restrict__ table,    // (B, Np)
                   const int* __restrict__ kv_len,   // (B,)
                   const int* __restrict__ q_offset, // (B,)
                   T* __restrict__ o,                // (B, Hq, Sq, D)
                   int Sq, int Np, int page, int Hkv, int G, int block_q,
                   float scale) {
  constexpr int kTpr = D / 32;      // threads per query row
  constexpr int kPer = 32;          // entries of D each thread owns
  const int qblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row = tid / kTpr;
  const int sub = tid % kTpr;
  const int i_local = row / G;
  const int g = row % G;
  const int i = qblk * block_q + i_local;
  const bool real = i_local < block_q && i < Sq;

  extern __shared__ float smem[];
  float* k_s = smem;                 // page * D
  float* v_s = smem + page * D;      // page * D

  const int Hq = Hkv * G;
  const int kl = kv_len[b];
  const int qo = q_offset[b];
  const int q_pos = qo + i;
  const int64_t q_base =
      (((int64_t)b * Hq + h * G + g) * Sq + (real ? i : 0)) * D;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    qr[k] = real ? to_f32(q[q_base + k * kTpr + sub]) * scale : 0.f;
    acc[k] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // the last kv position any row of this block can see
  const int i_last = min(qblk * block_q + block_q, Sq) - 1;
  const int kv_end = min(kl, qo + i_last + 1);
  int n_pages = kv_end > 0 ? (kv_end + page - 1) / page : 0;
  if (n_pages > Np) n_pages = Np;
  const int64_t tok_stride = (int64_t)Hkv * D;

  for (int j = 0; j < n_pages; ++j) {
    const int pid = table[(int64_t)b * Np + j];
    const int n_t = min(page, kv_end - j * page);
    const T* kp = k_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    const T* vp = v_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    __syncthreads();                 // the previous page is consumed
    for (int e = tid; e < n_t * D; e += nthreads) {
      const int t = e / D, d = e % D;
      k_s[e] = to_f32(kp[t * tok_stride + d]);
      v_s[e] = to_f32(vp[t * tok_stride + d]);
    }
    __syncthreads();
    // n_t is uniform over the block, so every lane reaches each shuffle
    for (int t = 0; t < n_t; ++t) {
      const float* kr = k_s + t * D;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) s += qr[k] * kr[k * kTpr + sub];
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int kv_pos = j * page + t;
      if (real && kv_pos <= q_pos && kv_pos < kl) {
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        const float* vr = v_s + t * D;
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          acc[k] = acc[k] * alpha + p * vr[k * kTpr + sub];
        m = m_new;
      }
    }
  }

  if (real) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      o[q_base + k * kTpr + sub] = from_f32<T>(acc[k] / den);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const void* table, const void* kv_len, const void* q_offset,
            void* o, int B, int Sq, int Np, int page, int Hkv, int G,
            float scale, cudaStream_t stream) {
  const int block_q = kRows / G;
  dim3 grid((Sq + block_q - 1) / block_q, Hkv, B);
  const size_t smem = (size_t)2 * page * D * sizeof(float);
  paged_flash_kernel<T, D><<<grid, kRows * (D / 32), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
      static_cast<T*>(o), Sq, Np, page, Hkv, G, block_q, scale);
}

template <typename T>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* table, const void* kv_len, const void* q_offset,
             void* o, int B, int Sq, int Np, int page, int Hkv, int G, int D,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch<T, 32>(q, k_pages, v_pages, table, kv_len, q_offset, o, B, Sq,
                    Np, page, Hkv, G, scale, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k_pages, v_pages, table, kv_len, q_offset, o, B, Sq,
                    Np, page, Hkv, G, scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k_pages, v_pages, table, kv_len, q_offset, o, B, Sq,
                     Np, page, Hkv, G, scale, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Query rows one block holds (the wrapper derives block_q = rows / G).
int paged_flash_rows_per_block() { return kRows; }

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}; G <= 64.
// Returns cudaGetLastError() after the launch (0 on success).
int paged_flash_attention(int dtype, const void* q, const void* k_pages,
                          const void* v_pages, const void* table,
                          const void* kv_len, const void* q_offset, void* o,
                          int B, int Sq, int Np, int page, int Hkv, int G,
                          int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(q, k_pages, v_pages, table, kv_len, q_offset, o, B,
                         Sq, Np, page, Hkv, G, D, scale, s);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(q, k_pages, v_pages, table, kv_len,
                                 q_offset, o, B, Sq, Np, page, Hkv, G, D,
                                 scale, s);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
