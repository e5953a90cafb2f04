// Dense flash attention for Hopper (sm_90a): causal or not, sliding window,
// logit softcap, GQA and a chunked-prefill query offset.
//
// Replaces the Pallas TPU kernel `flash_attention` (_kernel, with
// online_softmax_init/block/finish) of src/repro/kernels/flash_attention.py.
// q is (B, Hq, Sq, D) and k/v are (B, Hkv, Skv, D), each given with its own
// element strides (the last dimension contiguous), so the model's
// (B, Sq, Hq, D) queries and the dense cache's (B, Smax, Hkv, D) slot pass
// as transposed views with no copy. Row i sits at kv position q_offset + i;
// score s = (q.k) * D^-0.5, then c*tanh(s/c) when a softcap c is set, then
// the mask kv_pos <= q_offset + i (causal) and q_offset + i - kv_pos <
// window (window > 0). The output is divided by max(l, 1e-30), so a row that
// sees no key stays finite (zero).
//
// Work split: one thread block per (q tile, kv head h, batch row b). A block
// holds kRows = 64 query rows: block_q = kRows / G positions times the G
// query heads that share kv head h (row r -> position r / G, head r % G).
// Each row is owned by D / 32 consecutive threads, each holding 32 of the
// row's q and accumulator entries in registers (interleaved, d = k * (D/32)
// + sub, so the threads of a row hit distinct shared-memory banks). The
// block walks K/V tiles of kTile = 32 keys staged in shared memory as f32:
// per tile every row scores all keys into registers, then runs ONE
// online-softmax update (tile max, one rescale of the accumulator) in f32.
// The walk starts at the first key that the window lets any row of the
// block see and stops at the last key that causality lets any row see,
// never past Skv (padded rows of a chunk may sit past the cache's end).
// Ragged Sq rows are masked here; nothing is padded on the host.
//
// Bound on the H100: a chunk of C queries over N visible keys does about
// 4*C*N*Hq*D flops against 2*Skv*Hkv*D*itemsize bytes of KV, so prefill
// chunks are compute-bound. This first version does its products on the
// CUDA cores in f32 (no mma.sync/wgmma, no TMA); its time is in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kTile = 32;

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

struct Strides {       // element strides of one (B, H, S, D) operand
  int64_t b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kRows * (D / 32))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int Sq, int Skv, int G,
             int block_q, float scale, int causal, int window, float softcap,
             int q_offset) {
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
  const int q_pos = q_offset + i;

  __shared__ float k_s[kTile * D];
  __shared__ float v_s[kTile * D];

  const int hq = h * G + g;
  const int ii = real ? i : 0;
  const T* qp = q + b * qs.b + hq * qs.h + ii * qs.s;
  float qr[kPer], acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    qr[e] = real ? to_f32(qp[e * kTpr + sub]) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // the keys any row of this block can see: [kv_lo, kv_hi)
  const int i_first = qblk * block_q;
  const int i_last = min(i_first + block_q, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q_offset + i_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q_offset + i_first - window + 1);

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += kTile) {
    const int n_t = min(kTile, kv_hi - t0);   // uniform over the block
    __syncthreads();                          // the previous tile is consumed
    for (int e = tid; e < n_t * D; e += nthreads) {
      const int t = e / D, d = e % D;
      k_s[e] = to_f32(kb[(int64_t)(t0 + t) * ks.s + d]);
      v_s[e] = to_f32(vb[(int64_t)(t0 + t) * vs.s + d]);
    }
    __syncthreads();
    // scores of this tile; masked keys take -inf and so weigh exactly 0
    float sc[kTile];
    float m_tile = -INFINITY;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      sc[t] = -INFINITY;
      if (t < n_t) {                  // block-uniform: every lane shuffles
        const float* kr = k_s + t * D;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) s += qr[e] * kr[e * kTpr + sub];
#pragma unroll
        for (int off = kTpr / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kv_pos = t0 + t;
        const bool ok = real && (!causal || kv_pos <= q_pos) &&
                        (window <= 0 || q_pos - kv_pos < window);
        if (ok) {
          sc[t] = s;
          m_tile = fmaxf(m_tile, s);
        }
      }
    }
    if (m_tile > -INFINITY) {         // this row sees a key of the tile
      const float m_new = fmaxf(m, m_tile);
      const float alpha = expf(m - m_new);    // 0 on the first visible tile
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] *= alpha;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t < n_t) {
          const float p = expf(sc[t] - m_new);
          l += p;
          const float* vr = v_s + t * D;
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[e] += p * vr[e * kTpr + sub];
        }
      }
      m = m_new;
    }
  }

  if (real) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + b * os.b + hq * os.h + i * os.s;
#pragma unroll
    for (int e = 0; e < kPer; ++e) op[e * kTpr + sub] = from_f32<T>(acc[e] / den);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o,
            Strides qs, Strides ks, Strides vs, Strides os, int B, int Sq,
            int Skv, int Hkv, int G, float scale, int causal, int window,
            float softcap, int q_offset, cudaStream_t stream) {
  const int block_q = kRows / G;
  dim3 grid((Sq + block_q - 1) / block_q, Hkv, B);
  flash_kernel<T, D><<<grid, kRows * (D / 32), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, Sq, Skv,
      G, block_q, scale, causal, window, softcap, q_offset);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             Strides qs, Strides ks, Strides vs, Strides os, int B, int Sq,
             int Skv, int Hkv, int G, int D, float scale, int causal,
             int window, float softcap, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch<T, 32>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hkv, G, scale,
                    causal, window, softcap, q_offset, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hkv, G, scale,
                    causal, window, softcap, q_offset, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hkv, G, scale,
                     causal, window, softcap, q_offset, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Query rows one block holds (the wrapper derives block_q = rows / G).
int flash_rows_per_block() { return kRows; }

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}; G <= 64.
// strides: 12 element strides, (b, h, s) of q, k, v and o in that order.
// window <= 0: no window; softcap <= 0: no softcap.
// Returns cudaGetLastError() after the launch (0 on success).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    void* o, const int64_t* strides, int B, int Sq, int Skv,
                    int Hkv, int G, int D, float scale, int causal,
                    int window, float softcap, int q_offset, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv, Hkv, G, D,
                         scale, causal, window, softcap, q_offset, s);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(q, k, v, o, qs, ks, vs, os, B, Sq, Skv,
                                 Hkv, G, D, scale, causal, window, softcap,
                                 q_offset, s);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
