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
// Bound on the H100: a chunk of C queries over N visible keys does about
// 4*C*N*Hq*D flops against 2*Skv*Hkv*D*itemsize bytes of KV, so prefill
// chunks are compute-bound: on the tensor cores (989 TFLOP/s in bf16), not
// the f32 CUDA cores (67 TFLOP/s).
//
// Two paths, chosen by dtype:
//
// - bfloat16 (every serving path): the tensor-core core of attn_mma.cuh,
//   one block of 4 warps per (64 query rows, kv head h, batch row b):
//   cp.async K/V tiles of 64 keys in a 2-stage ring, mma.sync for Q.K^T
//   and P.V, the online softmax in f32 registers. Operands must be 16-byte
//   aligned with row strides that are multiples of 8 elements (the
//   wrapper checks). Its design notes are in attn_mma.cuh.
// - float32 (the parity sweeps and the f32 model phases; TF32 tensor cores
//   would not hold their 2e-5): the CUDA-core body below. One thread block
//   per (q tile, kv head h, batch row b) holds kRows = 64 query rows:
//   block_q = kRows / G positions times the G query heads that share kv
//   head h (row r -> position r / G, head r % G). Each row is owned by
//   D / 32 consecutive threads, each holding 32 of the row's q and
//   accumulator entries in registers (interleaved, d = k * (D/32) + sub,
//   so the threads of a row hit distinct shared-memory banks). The block
//   walks K/V tiles of kTile = 32 keys staged in shared memory: per tile
//   every row scores all keys into registers, then runs ONE online-softmax
//   update (tile max, one rescale of the accumulator) in f32.
//
// Both paths walk only the keys their rows can see: from the first key
// that the window lets any row of the block see to the last key that
// causality lets any row see, never past Skv (padded rows of a chunk may
// sit past the cache's end). Ragged Sq rows are masked in the kernel;
// nothing is padded on the host.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using attn_mma::bf16;
using attn_mma::Strides;

using attn_mma::kRows;         // query rows per block, both paths
constexpr int kTile = 32;      // keys per tile, float32 path

// ---- float32: the CUDA-core body --------------------------------------

template <int D>
__global__ void __launch_bounds__(kRows * (D / 32))
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int Sq,
                 int Skv, int G, int block_q, float scale, int causal,
                 int window, float softcap, int q_offset) {
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
  const float* qp = q + b * qs.b + hq * qs.h + ii * qs.s;
  float qr[kPer], acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    qr[e] = real ? qp[e * kTpr + sub] * scale : 0.f;
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

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += kTile) {
    const int n_t = min(kTile, kv_hi - t0);   // uniform over the block
    __syncthreads();                          // the previous tile is consumed
    for (int e = tid; e < n_t * D; e += nthreads) {
      const int t = e / D, d = e % D;
      k_s[e] = kb[(int64_t)(t0 + t) * ks.s + d];
      v_s[e] = vb[(int64_t)(t0 + t) * vs.s + d];
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
    float* op = o + b * os.b + hq * os.h + i * os.s;
#pragma unroll
    for (int e = 0; e < kPer; ++e) op[e * kTpr + sub] = acc[e] / den;
  }
}

// ---- bfloat16: the tensor-core core of attn_mma.cuh ---------------------

template <int D, bool kCap>
__global__ void __launch_bounds__(attn_mma::kThreads, 2)
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int Sq,
                 int Skv, int G, int block_q, float scale, int causal,
                 int window, float softcap, int q_offset) {
  const int qblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i_first = qblk * block_q;
  const int i_last = min(i_first + block_q, Sq) - 1;
  attn_mma::Block p;
  p.h = h;
  p.G = G;
  p.block_q = block_q;
  p.qblk = qblk;
  p.Sq = Sq;
  p.q_offset = q_offset;
  p.kv_lo = window > 0 ? max(0, q_offset + i_first - window + 1) : 0;
  p.kv_hi = causal ? min(Skv, q_offset + i_last + 1) : Skv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const attn_mma::DenseKeys keys{k + b * ks.b + h * ks.h,
                                 v + b * vs.b + h * vs.h, ks.s, vs.s};
  attn_mma::attend<D, kCap>(keys, q + b * qs.b, qs, o + b * os.b, os, p);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int B, Sq, Skv, Hkv, G;
  float scale;
  int causal, window;
  float softcap;
  int q_offset;
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  const int block_q = kRows / a.G;
  dim3 grid((a.Sq + block_q - 1) / block_q, a.Hkv, a.B);
  flash_kernel_f32<D><<<grid, kRows * (D / 32), 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks,
      a.vs, a.os, a.Sq, a.Skv, a.G, block_q, a.scale, a.causal, a.window,
      a.softcap, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D, bool kCap>
int launch_mma(const Args& a) {
  constexpr size_t smem = attn_mma::smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_mma<D, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int block_q = kRows / a.G;
  dim3 grid((a.Sq + block_q - 1) / block_q, a.Hkv, a.B);
  flash_kernel_mma<D, kCap><<<grid, attn_mma::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.qs, a.ks,
      a.vs, a.os, a.Sq, a.Skv, a.G, block_q, a.scale, a.causal, a.window,
      a.softcap, a.q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1)
    return a.softcap > 0.f ? launch_mma<D, true>(a) : launch_mma<D, false>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Query rows one block holds (the wrapper derives block_q = rows / G).
int flash_rows_per_block() { return kRows; }

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core core);
// D in {32, 64, 128}; G <= 64. strides: 12 element strides, (b, h, s) of
// q, k, v and o in that order. window <= 0: no window; softcap <= 0: no
// softcap. Returns the CUDA error of the launch (0 on success).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    void* o, const int64_t* strides, int B, int Sq, int Skv,
                    int Hkv, int G, int D, float scale, int causal,
                    int window, float softcap, int q_offset, void* stream) {
  const Args a{q, k, v, o,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               B, Sq, Skv, Hkv, G, scale, causal, window, softcap, q_offset,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
