// Paged decode attention for Hopper (sm_90a), with an optional fused KV write.
//
// Replaces the Pallas TPU kernels `paged_attention_fused` (_fused_kernel) and
// `paged_attention` (_kernel) of src/repro/kernels/paged_attention.py. One
// source, templated on FUSED and on the element type (float, bf16); the
// C entry `paged_decode_attention` picks the instantiation.
//
// Work split: one thread block per (kv head h, lane b). It loads the lane's
// G query rows of head h (scaled by D**-0.5) into shared memory, then walks
// the lane's block table page by page up to ceil(len / page), where
// len = lengths[b] - FUSED. Each page's (page, D) K and V slice of head h is
// staged in shared memory as f32; scores, the running max / sum and the
// (G, D) accumulator are f32, with a 1e-30 floor on the denominator.
//
// FUSED: the block first stores its own head's k_new / v_new into the pool
// slot (write_pages[b], write_offsets[b]). Page reads stop at len - 1, so the
// slot is never read back; the new token joins the online softmax last,
// straight from k_new / v_new (the TPU kernel's race rule). Idle lanes
// (length 1, all-scratch table, slot (scratch, 0)) read no page and write
// garbage to the scratch page, which nothing reads unmasked.
//
// Bound on the H100: decode reads every valid KV byte once and does ~4*D
// flops per byte pair, so it is bandwidth-bound. This first version is the
// simple one: one block per (b, h), no cp.async / TMA pipelining, so a small
// batch leaves most SMs idle. Its time is recorded in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

size_t smem_floats(int G, int page, int D) {
  // q, acc: G*D each; K: page*(D+1) (padded rows); V: page*D;
  // scores: G*page; m, l, alpha, p_new: G each
  return (size_t)2 * G * D + (size_t)page * (D + 1) + (size_t)page * D +
         (size_t)G * page + 4 * (size_t)G;
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,            // (B, Hq, D)
                    T* k_pages, T* v_pages,              // (P, page, Hkv, D)
                    const int* __restrict__ table,       // (B, maxp)
                    const int* __restrict__ lengths,     // (B,)
                    const T* __restrict__ k_new,         // (B, Hkv, D)
                    const T* __restrict__ v_new,
                    const int* __restrict__ write_pages,   // (B,)
                    const int* __restrict__ write_offsets,
                    T* __restrict__ o,                   // (B, Hq, D)
                    int maxp, int page, int Hkv, int G, int D, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Dp = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // G * D
  float* acc_s = q_s + G * D;         // G * D
  float* k_s = acc_s + G * D;         // page * Dp
  float* v_s = k_s + page * Dp;       // page * D
  float* s_s = v_s + page * D;        // G * page
  float* m_s = s_s + G * page;        // G
  float* l_s = m_s + G;               // G
  float* a_s = l_s + G;               // G
  float* pn_s = a_s + G;              // G

  const int Hq = Hkv * G;
  const int64_t tok_stride = (int64_t)Hkv * D;   // between tokens of a page
  const int64_t new_base = ((int64_t)b * Hkv + h) * D;

  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    q_s[e] = to_f32(q[((int64_t)b * Hq + h * G + g) * D + d]) * scale;
    acc_s[e] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (FUSED) {
    const int64_t dst = ((int64_t)write_pages[b] * page + write_offsets[b]) *
                            tok_stride + (int64_t)h * D;
    for (int d = tid; d < D; d += kThreads) {
      k_pages[dst + d] = k_new[new_base + d];
      v_pages[dst + d] = v_new[new_base + d];
    }
  }
  __syncthreads();

  const int len = lengths[b] - (FUSED ? 1 : 0);
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > maxp) n_pages = maxp;
  for (int j = 0; j < n_pages; ++j) {
    const int pid = table[(int64_t)b * maxp + j];
    const int n_valid = min(page, len - j * page);
    const T* kp = k_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    const T* vp = v_pages + (int64_t)pid * page * tok_stride + (int64_t)h * D;
    for (int e = tid; e < n_valid * D; e += kThreads) {
      const int t = e / D, d = e % D;
      k_s[t * Dp + d] = to_f32(kp[t * tok_stride + d]);
      v_s[t * D + d] = to_f32(vp[t * tok_stride + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * n_valid; e += kThreads) {
      const int g = e / n_valid, t = e % n_valid;
      const float* qr = q_s + g * D;
      const float* kr = k_s + t * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      s_s[g * page + t] = s;
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float* sr = s_s + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < n_valid; ++t) m_new = fmaxf(m_new, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < n_valid; ++t) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      const float* pr = s_s + g * page;
      float pv = 0.f;
      for (int t = 0; t < n_valid; ++t) pv += pr[t] * v_s[t * D + d];
      acc_s[e] = acc_s[e] * a_s[g] + pv;
    }
    __syncthreads();
  }

  if (FUSED) {
    // the new token: one more online-softmax step over a single kv entry
    // at position lengths[b] - 1, read from k_new / v_new, never the pool
    if (tid < G) {
      const int g = tid;
      const float* qr = q_s + g * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * to_f32(k_new[new_base + d]);
      const float m_prev = m_s[g];
      const float m_fin = fmaxf(m_prev, s);
      const float p_new = expf(s - m_fin);
      const float alpha = expf(m_prev - m_fin);
      l_s[g] = alpha * l_s[g] + p_new;
      a_s[g] = alpha;
      pn_s[g] = p_new;
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      acc_s[e] = acc_s[e] * a_s[g] + pn_s[g] * to_f32(v_new[new_base + d]);
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    o[((int64_t)b * Hq + h * G + g) * D + d] =
        from_f32<T>(acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, bool FUSED>
void launch(const void* q, void* k_pages, void* v_pages, const void* table,
            const void* lengths, const void* k_new, const void* v_new,
            const void* write_pages, const void* write_offsets, void* o,
            int B, int maxp, int page, int Hkv, int G, int D, float scale,
            cudaStream_t stream) {
  const size_t smem = smem_floats(G, page, D) * sizeof(float);
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, FUSED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const int*>(write_pages),
      static_cast<const int*>(write_offsets), static_cast<T*>(o), maxp, page,
      Hkv, G, D, scale);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks it).
size_t paged_decode_smem_bytes(int G, int page, int D) {
  return smem_floats(G, page, D) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. fused: 0 = read-only, 1 = KV write fused.
// k_new, v_new, write_pages, write_offsets may be null when fused == 0.
// Returns cudaGetLastError() after the launch (0 on success).
int paged_decode_attention(int dtype, int fused, const void* q, void* k_pages,
                           void* v_pages, const void* table,
                           const void* lengths, const void* k_new,
                           const void* v_new, const void* write_pages,
                           const void* write_offsets, void* o, int B, int maxp,
                           int page, int Hkv, int G, int D, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && fused)
    launch<float, true>(q, k_pages, v_pages, table, lengths, k_new, v_new,
                        write_pages, write_offsets, o, B, maxp, page, Hkv, G,
                        D, scale, s);
  else if (dtype == 0)
    launch<float, false>(q, k_pages, v_pages, table, lengths, k_new, v_new,
                         write_pages, write_offsets, o, B, maxp, page, Hkv, G,
                         D, scale, s);
  else if (dtype == 1 && fused)
    launch<__nv_bfloat16, true>(q, k_pages, v_pages, table, lengths, k_new,
                                v_new, write_pages, write_offsets, o, B, maxp,
                                page, Hkv, G, D, scale, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, false>(q, k_pages, v_pages, table, lengths, k_new,
                                 v_new, write_pages, write_offsets, o, B,
                                 maxp, page, Hkv, G, D, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
