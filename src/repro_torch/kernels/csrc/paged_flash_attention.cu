// Gather-free chunked-prefill flash attention over a paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_attention` (_kernel) of
// src/repro/kernels/paged_flash_attention.py. Queries (B, Hq, Sq, D) attend
// over pool pages (P, page, Hkv, D) that the block table (B, Np) steers;
// each page is read IN PLACE, never gathered into a dense copy. Mask:
// kv_pos <= q_offset[b] + i and kv_pos < kv_len[b].
//
// Bound on the H100: a chunk of C queries over a context of N tokens does
// about 4*C*N*Hq*D flops against about 4*N*Hkv*D*itemsize bytes of KV, so
// long chunks are compute-bound: on the tensor cores (989 TFLOP/s in
// bf16), not the f32 CUDA cores (67 TFLOP/s).
//
// Two paths, chosen by dtype:
//
// - bfloat16 (the serving path): the tensor-core core of attn_mma.cuh, one
//   block of 4 warps per (64 query rows, kv head h, batch row b), with
//   the key rows addressed through the table (token t -> page
//   table[b, t / page], offset t % page, token stride Hkv * D), so any page
//   size works and a 64-key tile may span several pages or part of one.
//   cp.async K/V tiles in a 2-stage ring, mma.sync for Q.K^T and P.V, one
//   online-softmax rescale per tile. Keys past min(kv_len, last causal
//   position, Np * page) are zero-filled, never read: table[b, Np] is never
//   touched and stale pages cannot poison a row. The pool and q must be
//   16-byte aligned (the wrapper checks). Design notes in attn_mma.cuh.
// - float32 (the parity sweeps and the f32 model phases; TF32 tensor cores
//   would not hold their 2e-5): the CUDA-core body below. One block per
//   (q block, kv head h, row b) holds kRows = 64 query rows: block_q =
//   kRows / G positions times the G query heads that share kv head h (row
//   r -> position r / G, head r % G). Each row is owned by D / 32
//   consecutive threads, each holding 32 of the row's q and accumulator
//   entries in registers (interleaved, d = k * (D/32) + sub, so the
//   threads of a row hit distinct shared-memory banks). Per page the block
//   stages head h's (page, D) K and V slices in shared memory (2 * page *
//   D floats, at most 48 KiB: the wrapper checks), then every row runs
//   the online softmax token by token in f32.
//
// Both paths stop at the last key any row of the block can see,
// min(kv_len, q_offset + last row + 1), and mask ragged Sq rows in the
// kernel (no host-side padding); the denominator has a 1e-30 floor.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using attn_mma::bf16;

constexpr float kNegInf = -1e30f;
using attn_mma::kRows;         // query rows per block, both paths

// ---- float32: the CUDA-core body --------------------------------------

template <int D>
__global__ void __launch_bounds__(kRows * (D / 32))
paged_flash_kernel_f32(const float* __restrict__ q,       // (B, Hq, Sq, D)
                       const float* __restrict__ k_pages, // (P, page, Hkv, D)
                       const float* __restrict__ v_pages,
                       const int* __restrict__ table,     // (B, Np)
                       const int* __restrict__ kv_len,    // (B,)
                       const int* __restrict__ q_offset,  // (B,)
                       float* __restrict__ o,             // (B, Hq, Sq, D)
                       int Sq, int Np, int page, int Hkv, int G,
                       int block_q, float scale) {
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
    qr[k] = real ? q[q_base + k * kTpr + sub] * scale : 0.f;
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
    const float* kp =
        k_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    const float* vp =
        v_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    __syncthreads();                 // the previous page is consumed
    for (int e = tid; e < n_t * D; e += nthreads) {
      const int t = e / D, d = e % D;
      k_s[e] = kp[t * tok_stride + d];
      v_s[e] = vp[t * tok_stride + d];
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
      o[q_base + k * kTpr + sub] = acc[k] / den;
  }
}

// ---- bfloat16: the tensor-core core of attn_mma.cuh ---------------------

template <int D>
__global__ void __launch_bounds__(attn_mma::kThreads, 2)
paged_flash_kernel_mma(const bf16* __restrict__ q,
                       const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages,
                       const int* __restrict__ table,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset,
                       bf16* __restrict__ o, int Sq, int Np, int page,
                       int Hkv, int G, int block_q, float scale) {
  const int qblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * G;
  const int qo = q_offset[b];
  const int i_last = min(qblk * block_q + block_q, Sq) - 1;
  attn_mma::Block p;
  p.h = h;
  p.G = G;
  p.block_q = block_q;
  p.qblk = qblk;
  p.Sq = Sq;
  p.q_offset = qo;
  p.kv_lo = 0;
  p.kv_hi = max(0, min(min(kv_len[b], qo + i_last + 1), Np * page));
  p.causal = 1;
  p.window = 0;
  p.scale = scale;
  p.softcap = 0.f;
  const int64_t tok = (int64_t)Hkv * D;
  const attn_mma::PagedKeys keys{k_pages + (int64_t)h * D,
                                 v_pages + (int64_t)h * D,
                                 table + (int64_t)b * Np, page, tok};
  const attn_mma::Strides qs{(int64_t)Hq * Sq * D, (int64_t)Sq * D, D};
  const int64_t ob = (int64_t)b * Hq * Sq * D;
  attn_mma::attend<D, false>(keys, q + ob, qs, o + ob, qs, p);
}

struct Args {
  const void *q, *k_pages, *v_pages, *table, *kv_len, *q_offset;
  void* o;
  int B, Sq, Np, page, Hkv, G;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  const int block_q = kRows / a.G;
  dim3 grid((a.Sq + block_q - 1) / block_q, a.Hkv, a.B);
  const size_t smem = (size_t)2 * a.page * D * sizeof(float);
  paged_flash_kernel_f32<D><<<grid, kRows * (D / 32), smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pages),
      static_cast<const float*>(a.v_pages),
      static_cast<const int*>(a.table), static_cast<const int*>(a.kv_len),
      static_cast<const int*>(a.q_offset), static_cast<float*>(a.o), a.Sq,
      a.Np, a.page, a.Hkv, a.G, block_q, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Args& a) {
  constexpr size_t smem = attn_mma::smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_flash_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int block_q = kRows / a.G;
  dim3 grid((a.Sq + block_q - 1) / block_q, a.Hkv, a.B);
  paged_flash_kernel_mma<D><<<grid, attn_mma::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pages),
      static_cast<const bf16*>(a.v_pages), static_cast<const int*>(a.table),
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.q_offset),
      static_cast<bf16*>(a.o), a.Sq, a.Np, a.page, a.Hkv, a.G, block_q,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_mma<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Query rows one block holds (the wrapper derives block_q = rows / G).
int paged_flash_rows_per_block() { return kRows; }

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core core);
// D in {32, 64, 128}; G <= 64. Returns the CUDA error of the launch (0 on
// success).
int paged_flash_attention(int dtype, const void* q, const void* k_pages,
                          const void* v_pages, const void* table,
                          const void* kv_len, const void* q_offset, void* o,
                          int B, int Sq, int Np, int page, int Hkv, int G,
                          int D, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, table, kv_len, q_offset, o, B, Sq,
               Np, page, Hkv, G, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
