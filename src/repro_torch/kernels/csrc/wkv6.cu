// RWKV6 (WKV) recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6` (_kernel) of
// src/repro/kernels/wkv6.py. Per batch row b and head h, with a K x K f32
// state S carried over the time steps t = 0 .. T-1:
//     o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// w is clipped to [1e-12, 1] first, as the TPU kernel clips it before its
// log. r, k, v are (B, T, H, K) in the model's type (f32 or bf16), w is
// (B, T, H, K) f32; each of the four is given with its own element strides
// (the last dimension contiguous), so the model's projections pass as they
// are: the TPU wrapper's moveaxis to (B, H, T, K) is a tiling artefact and
// has no counterpart here. u is (H, K) f32, the initial state (B, H, K, K)
// f32; o (B, T, H, K) and the final state (B, H, K, K) are f32, contiguous.
//
// Work split (the design of RWKV's own CUDA kernel): one block of K threads
// per (b, h). Thread j holds column j of S in registers (K floats) for the
// whole walk; the TPU kernel's sequential chunk grid becomes the loop over
// t inside the block. Steps are staged kStage at a time: each thread loads
// its lane of r, k, w and v for kStage steps into shared memory as f32
// (coalesced across the block), then every thread walks those steps,
// reading r_t, k_t, w_t and u as broadcast float4s. The output sum of each
// step runs in four partial sums, so it is not one chain of K dependent
// FMAs. Any T >= 1 works; T = 1 is one decode step.
//
// Bound on the H100: the recurrence does about 5*K^2 flops per (b, h, t)
// (the r.S product, the decay and the outer product), ≈ 5*B*T*H*K^2 in all,
// against 3 reads of r/k/v in the model type, one f32 read of w, one f32
// write of o, and the state read and written once. At the main-path
// prefill (B 8, T 1,024, H 32, K 64, bf16) that is ≈ 243 MB, ≈ 0.073 ms at
// 3.35 TB/s (reckoned); its ≈ 5.4 GFLOP take ≈ 0.011 ms at the TF32
// tensor-core peak (a chunked form runs them as matrix products), so bytes
// set the bound. A decode step (T 1) moves the state, ≈ 8.4 MB at B 8,
// ≈ 0.0025 ms. This version does every product on the CUDA cores in f32
// and runs B*H blocks of K threads (256 blocks of 64 at the main path,
// under two per SM), so the serial walk, not memory, limits it; PERF.md
// records its time against the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStage = 32;   // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jnp.clip(w, 1e-12, 1.0); a NaN passes through, as it does there.
__device__ __forceinline__ float clip_decay(float w) {
  return w < 1e-12f ? 1e-12f : (w > 1.0f ? 1.0f : w);
}

struct Strides {       // element strides of one (B, T, H, K) operand
  int64_t b, t, h;
};

// One state entry's step: y += r * (S + u*k*v); S = w*S + k*v.
__device__ __forceinline__ void entry(float& s, float r, float k, float w,
                                      float u, float vj, float& y) {
  const float kv = k * vj;
  y = fmaf(r, fmaf(u, kv, s), y);
  s = fmaf(s, w, kv);
}

template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ sT, Strides rs,
            Strides ks, Strides vs, Strides ws, int Tn, int H) {
  __shared__ __align__(16) float r_s[kStage][K];
  __shared__ __align__(16) float k_s[kStage][K];
  __shared__ __align__(16) float w_s[kStage][K];
  __shared__ __align__(16) float v_s[kStage][K];
  __shared__ __align__(16) float u_s[K];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, j = threadIdx.x;
  u_s[j] = u[h * K + j];

  float s[K];                        // s[i] = S[i][j]
  const float* s_in = s0 + (int64_t)bh * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = s_in[i * K];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = w + b * ws.b + h * ws.h + j;
  const int64_t o_t = (int64_t)H * K;                 // o is contiguous
  float* op = o + (int64_t)b * Tn * o_t + h * K + j;

  for (int t0 = 0; t0 < Tn; t0 += kStage) {
    const int n = min(kStage, Tn - t0);
    __syncthreads();                 // the previous stage is consumed
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const int64_t t = t0 + tt;
      r_s[tt][j] = to_f32(rp[t * rs.t]);
      k_s[tt][j] = to_f32(kp[t * ks.t]);
      v_s[tt][j] = to_f32(vp[t * vs.t]);
      w_s[tt][j] = clip_decay(wp[t * ws.t]);
    }
    __syncthreads();
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&u_s[i]);
        entry(s[i + 0], r4.x, k4.x, w4.x, u4.x, vj, y0);
        entry(s[i + 1], r4.y, k4.y, w4.y, u4.y, vj, y1);
        entry(s[i + 2], r4.z, k4.z, w4.z, u4.z, vj, y2);
        entry(s[i + 3], r4.w, k4.w, w4.w, u4.w, vj, y3);
      }
      op[(t0 + tt) * o_t] = (y0 + y1) + (y2 + y3);
    }
  }

  float* s_out = sT + (int64_t)bh * K * K + j;
#pragma unroll
  for (int i = 0; i < K; ++i) s_out[i * K] = s[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sT, Strides rs,
           Strides ks, Strides vs, Strides ws, int B, int Tn, int H, int K,
           cudaStream_t stream) {
  const dim3 grid(B * H);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  switch (K) {
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, stream>>>(rt, kt, vt, w, u, s0, o,
                                                  sT, rs, ks, vs, ws, Tn, H);
      return 0;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(rt, kt, vt, w, u, s0, o,
                                                  sT, rs, ks, vs, ws, Tn, H);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r/k/v: 0 = float32, 1 = bfloat16; w, u and the states are f32.
// K in {32, 64}; T >= 1. strides: 12 element strides, (b, t, h) of r, k, v
// and w in that order. Returns cudaGetLastError() after the launch.
int wkv6(int dtype, const void* r, const void* k, const void* v,
         const void* w, const void* u, const void* s0, void* o, void* sT,
         const int64_t* strides, int B, int Tn, int H, int K, void* stream) {
  const Strides rs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides ws{strides[9], strides[10], strides[11]};
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* of = static_cast<float*>(o);
  float* sTf = static_cast<float*>(sT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch<float>(r, k, v, wf, uf, s0f, of, sTf, rs, ks, vs, ws, B, Tn,
                       H, K, s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, of, sTf, rs, ks, vs, ws,
                               B, Tn, H, K, s);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
