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
// Two kernels, chosen by shape only: T >= 2 runs the chunked kernel, T = 1
// (a decode step) the step kernel.
//
// Chunked kernel (wkv6_chunked). One block of 8 warps per (b, h) walks the
// sequence in chunks of kC = 32 steps; the state S lives in shared memory
// for the whole walk, as the TPU kernel keeps it in VMEM scratch across its
// sequential chunk axis. At B 8, H 32 that is 256 blocks of 8 warps, two
// resident on an SM (82,720 bytes of shared memory each at bf16 and K 64,
// 96,544 at f32; at most 128 registers a thread): 16 warps an SM. Per
// chunk, with L_t the inclusive prefix sum of log w along the chunk (rows
// past T get log w = 0, and r = k = v = 0 from cp.async's zero fill, so
// they add nothing):
//     o     = (r * e^{L_{t-1}}) S  +  att v
//     att   = strictly lower triangle of the decayed r k^T, with the bonus
//             r_t . (u * k_t) on its diagonal (written with a select,
//             never a multiply by a mask)
//     S     <- e^{L_last} * S + (k * e^{L_last - L_s})^T v
// Loads: r, k, w and v are copied into shared memory with 16-byte
// cp.async; the next chunk's r/k/w are in flight while this chunk's two
// output products run, its v while the next chunk's prefix sums and
// intra-chunk products run.
//
// Range. The decayed r k^T splits each weight e^{L_{t-1} - L_s} (s < t)
// into a row factor and a key factor around a reference point per channel,
// chosen so that nothing overflows for any w in [1e-12, 1] (the TPU
// kernel's half-chunk centring overflows once |sum log w| over a chunk
// passes ~176, e.g. at w <= 1e-3 and chunk 32):
//  - a channel whose |sum log w| over the chunk is at most kMaxSpan = 60
//    (always, under the model's decay clip: at most 45.4 at 32 steps) is
//    centred on the middle of it, ref = L_last / 2: every factor lies
//    within e^{30}, and the whole triangle runs on the tensor cores;
//  - a steeper channel takes ref = L_e, the last step of the first
//    16-step sub-block: for rows in sub-block 1 and keys in sub-block 0
//    both factors are <= 1 (they can only underflow, where the true weight
//    is below f32's range). If any channel of the chunk is steep, the two
//    diagonal 16 x 16 sub-blocks compute each pair's weight e^{L_{t-1} -
//    L_s} directly on the CUDA cores instead; that branch depends on the
//    data and is taken block-wide.
// The other factors, e^{L_{t-1}} on r for o and e^{L_last - L_s} on k for
// the state, are <= 1 as they stand.
//
// Products. The four products run on the tensor cores as 3xTF32 on
// mma.sync m16n8k8: x = hi + lo with hi = x rounded to TF32, lo = x - hi,
// and hi*hi + hi*lo + lo*hi accumulated in f32, which is f32-accurate (a
// single TF32 pass would round the state, ~60 at the main path, by 2^-11).
// A bf16 v is exact in TF32, so products with v skip their hi*lo term.
// Fragments are read from shared memory with row pitches of K + 4 or K + 8
// floats, chosen per operand so each fragment load hits 32 banks.
//
// Step kernel (wkv6_step). A decode step moves the state: read once,
// written once. Each (b, h) is cut into column slabs of 32 (2 blocks at
// K 64, slabs of one (b, h) adjacent in the grid); a block is one warp,
// thread j holds column j of S in registers, K independent 4-byte loads
// coalesced to 128 bytes across the warp, f32 FMAs on the CUDA cores. At
// B 8 that is 512 blocks. A layout with 16-byte loads (each thread 4
// columns of K / 16 rows, the output summed over rows through shared
// memory) moved the same bytes in flight and was slower on the H100
// (PERF.md).
//
// Bound on the H100: the recurrence needs about 5*K^2 flops per (b, h, t),
// ≈ 5*B*T*H*K^2 in all, against 3 reads of r/k/v in the model type, one f32
// read of w, one f32 write of o, and the state read and written once. At
// the main-path prefill (B 8, T 1,024, H 32, K 64, bf16) that is ≈ 243 MB,
// ≈ 0.073 ms at 3.35 TB/s (reckoned); its ≈ 5.4 GFLOP take ≈ 0.011 ms at the
// TF32 tensor-core peak, so bytes set the bound. The chunked form does
// more (the intra-chunk triangle, and three TF32 products for each, two
// where v is bf16): ≈ 15 GFLOP of tensor-core work, ≈ 0.03 ms at the
// peak (reckoned). A decode step (T 1) moves the state, ≈ 8.4 MB at B 8,
// ≈ 0.0025 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"   // cp.async helpers

namespace {

using bf16 = __nv_bfloat16;
using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::smem_u32;

constexpr int kC = 32;            // steps per chunk
constexpr int kSub = 16;          // steps per sub-block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kMaxSpan = 60.f;  // largest centred |sum log w| of a chunk
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; 0 below -126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// jnp.clip(w, 1e-12, 1.0); a NaN passes through, as it does there.
__device__ __forceinline__ float clip_decay(float w) {
  return w < 1e-12f ? 1e-12f : (w > 1.0f ? 1.0f : w);
}

struct Strides {       // element strides of one (B, T, H, K) operand
  int64_t b, t, h;
};

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

// x = hi + lo: hi = x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna; an integer add and a mask, where cvt.rna.tf32 takes four
// instructions on sm_90), lo = x - hi exactly, passed as it is (the tensor
// core reads its top 19 bits, so lo keeps 2^-21 of x). A NaN or infinite
// x is not special-cased: it gives a NaN product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {          // a 16 x 8 A tile: hi and lo parts
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int n, float x) {
    split(x, hi[n], lo[n]);
  }
};

template <bool kExact>  // kExact: the values are exact in TF32 (lo = 0)
struct FragB {          // an 8 x 8 B tile
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int n, float x) {
    if (kExact)
      hi[n] = __float_as_uint(x);
    else
      split(x, hi[n], lo[n]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b to f32 accuracy, the big term into c and the small ones into d (two
// accumulators, so the three products are not one dependent chain).
template <bool kExact>
__device__ __forceinline__ void mma3(float (&c)[4], float (&d)[4],
                                     const FragA& a, const FragB<kExact>& b) {
  mma_tf32(c, a.hi, b.hi);
  mma_tf32(d, a.lo, b.hi);
  if (!kExact) mma_tf32(d, a.hi, b.lo);
}

// Fragment loads from shared memory; g = lane / 4, q = lane % 4. A[m][k]
// from a row-major M (m = row): a0 (g, q), a1 (g+8, q), a2 (g, q+4),
// a3 (g+8, q+4).
__device__ __forceinline__ void load_a(FragA& f, const float* m, int ld,
                                       int g, int q) {
  f.set(0, m[g * ld + q]);
  f.set(1, m[(g + 8) * ld + q]);
  f.set(2, m[g * ld + q + 4]);
  f.set(3, m[(g + 8) * ld + q + 4]);
}

// A[m][k] = M[k][m] (the transpose of a row-major M).
__device__ __forceinline__ void load_at(FragA& f, const float* m, int ld,
                                        int g, int q) {
  f.set(0, m[q * ld + g]);
  f.set(1, m[q * ld + g + 8]);
  f.set(2, m[(q + 4) * ld + g]);
  f.set(3, m[(q + 4) * ld + g + 8]);
}

// B[k][n] from a row-major M (k = row): b0 (k q, n g), b1 (k q+4, n g).
template <bool kExact, typename E>
__device__ __forceinline__ void load_b(FragB<kExact>& f, const E* m, int ld,
                                       int g, int q) {
  f.set(0, to_f32(m[q * ld + g]));
  f.set(1, to_f32(m[(q + 4) * ld + g]));
}

// B[k][n] = M[n][k] (n = row of M).
__device__ __forceinline__ void load_bt(FragB<false>& f, const float* m,
                                        int ld, int g, int q) {
  f.set(0, m[g * ld + q]);
  f.set(1, m[g * ld + q + 4]);
}

// ---------------------------------------------------------------------------
// the chunked kernel (T >= 2)
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block: f32 arrays, then the raw r/k/v rows
// of the chunk in the model type. Pitches: kLdA = K + 4 for operands read
// as A (m = row) or as a transposed B (n = row), kLdB = K + 8 for operands
// read as B (k = row) or as a transposed A (k = row).
template <typename T, int K>
struct Layout {
  static constexpr int kLdA = K + 4, kLdB = K + 8, kLdAtt = kC + 4;
  static constexpr int kLdR = K + 8;                  // raw rows, in T
  static constexpr int kS = 0;                        // S, K x kLdB
  static constexpr int kAin = kS + K * kLdB;          // r e^{L_{t-1}}
  static constexpr int kQx = kAin + kC * kLdA;        // r e^{L_{t-1} - ref}
  static constexpr int kKx = kQx + kC * kLdA;         // k e^{ref - L_s}
  static constexpr int kKst = kKx + kC * kLdA;        // k e^{L_last - L_s}
  static constexpr int kAtt = kKst + kC * kLdB;       // kC x kLdAtt
  static constexpr int kWl = kAtt + kC * kLdAtt;      // w, then L
  static constexpr int kVec = kWl + kC * kLdA;        // u, e^{L_last}
  static constexpr int kBon = kVec + 2 * K;           // bonus, per 32 channels
  static constexpr int kSeg = kBon + (K / 32) * kC;   // segment sums
  static constexpr int kFlag = kSeg + kThreads;       // steep flags, per warp
  static constexpr int kFloats = kFlag + kWarps;
  static constexpr size_t kBytes =
      kFloats * sizeof(float) + 3 * kC * kLdR * sizeof(T);
};

// Rows t0 .. t0 + kC - 1 of one (B, T, H, K) operand into shared memory at
// dst (pitch ld elements), 16 bytes a copy; rows at or past Tn are
// zero-filled (src-size 0, from row t0, which is valid).
template <int K, typename E>
__device__ __forceinline__ void load_rows(E* dst, int ld, const E* src,
                                          int64_t st, int t0, int Tn,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(E);
  constexpr int kChunks = K / kPer;
  constexpr int kCopies = kC * kChunks;
#pragma unroll
  for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
    const unsigned e = tid + it * kThreads;
    if (kCopies % kThreads == 0 || e < kCopies) {
      const unsigned row = e / kChunks, ch = e % kChunks;
      const int t = t0 + (int)row;
      const bool ok = t < Tn;
      cp_async16(smem_u32(dst + row * ld + ch * kPer),
                 src + (ok ? t : t0) * st + ch * kPer, ok);
    }
  }
}

// The sums over the warp's 32 lanes of each of the N values of p (N a
// power of two up to 32), reduce-scattered: the result is the sum of value
// number idx, which the lane's bits 4, 3, ... select.
template <int N>
__device__ __forceinline__ float warp_sums(float (&p)[N], int lane, int& idx) {
  idx = 0;
#pragma unroll
  for (int half = N / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const float send = up ? p[m] : p[m + half];
      const float keep = up ? p[m + half] : p[m];
      p[m] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (up) idx += half;
  }
  float x = p[0];
#pragma unroll
  for (int off = 16 / N; off >= 1; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunked(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ o, float* __restrict__ sT, Strides rs,
             Strides ks, Strides vs, Strides ws, int Tn, int H) {
  using Lay = Layout<T, K>;
  constexpr int kLdA = Lay::kLdA, kLdB = Lay::kLdB, kLdAtt = Lay::kLdAtt;
  constexpr int kLdR = Lay::kLdR;
  constexpr int kSegs = kThreads / K, kSegLen = kC / kSegs;
  constexpr bool kVExact = sizeof(T) == 2;     // bf16 v is exact in TF32
  extern __shared__ __align__(16) float sm[];
  float* S = sm + Lay::kS;
  float* Ain = sm + Lay::kAin;
  float* Qx = sm + Lay::kQx;
  float* Kx = sm + Lay::kKx;
  float* Kst = sm + Lay::kKst;
  float* att = sm + Lay::kAtt;
  float* wl = sm + Lay::kWl;
  float* u_s = sm + Lay::kVec;
  float* dec_s = u_s + K;     // e^{L_last}
  float* bon = sm + Lay::kBon;
  float* seg = sm + Lay::kSeg;
  int* flag = reinterpret_cast<int*>(sm + Lay::kFlag);
  T* r_raw = reinterpret_cast<T*>(sm + Lay::kFloats);
  T* k_raw = r_raw + kC * kLdR;
  T* v_raw = k_raw + kC * kLdR;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // the fused pass: thread (sg, i) takes channel i at the kSegLen steps of
  // segment sg; a warp holds 32 channels of one segment
  const int i = tid % K, sg = tid / K, t_lo = sg * kSegLen;
  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const float* wp = w + b * ws.b + h * ws.h;

  const float4* s_in =
      reinterpret_cast<const float4*>(s0 + (int64_t)bh * K * K);
  for (int e = tid; e < K * K / 4; e += kThreads)
    *reinterpret_cast<float4*>(S + (e / (K / 4)) * kLdB + 4 * (e % (K / 4))) =
        s_in[e];
  for (int e = tid; e < kC * kLdAtt; e += kThreads) att[e] = 0.f;
  if (tid < K) u_s[tid] = u[h * K + tid];
  __syncthreads();
  const float u_i = u_s[i];

  const int n_chunks = (Tn + kC - 1) / kC;
  load_rows<K>(wl, kLdA, wp, ws.t, 0, Tn, tid);
  load_rows<K>(r_raw, kLdR, rp, rs.t, 0, Tn, tid);
  load_rows<K>(k_raw, kLdR, kp, ks.t, 0, Tn, tid);
  cp_async_commit();
  load_rows<K>(v_raw, kLdR, vp, vs.t, 0, Tn, tid);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC, n = min(kC, Tn - t0);
    cp_async_wait<1>();               // w, r, k of this chunk have landed
    __syncthreads();

    // 1. L = prefix sums of log2 w along the chunk (0 past T), in log2
    //    units so every factor below is one ex2: each thread sums its
    //    segment, then adds the sums of the segments before it.
    float x[kSegLen];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const int t = t_lo + j;
      acc += t < n ? logf(clip_decay(wl[t * kLdA + i])) * kLog2e : 0.f;
      x[j] = acc;
    }
    seg[sg * K + i] = acc;
    __syncthreads();
    float off = 0.f, le = 0.f, tot = 0.f;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      const float part = seg[s * K + i];
      if (s < sg) off += part;
      if (s * kSegLen < kSub) le += part;
      tot += part;
    }

    // 2. the scaled operands. Channel i's reference point: the middle of
    //    the chunk's log-decay when it spans at most kMaxSpan (every factor
    //    within e^{30}), else L_e, the end of sub-block 0 (both factors of
    //    the off-diagonal block <= 1; the diagonal blocks then go per pair).
    const bool steep = !(-tot <= kMaxSpan * kLog2e);
    const float ref = steep ? le : 0.5f * tot;
    const float e_ref = exp2f(ref), e_rest = exp2f(tot - ref);
    float bonus[kSegLen];
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const int t = t_lo + j;
      const float lt = x[j] + off;
      const float lp = j ? x[j - 1] + off : off;
      wl[t * kLdA + i] = lt;
      const float rv = to_f32(r_raw[t * kLdR + i]);
      const float kv = to_f32(k_raw[t * kLdR + i]);
      bonus[j] = rv * u_i * kv;
      if (!steep) {
        const float ex = ex2(lp - ref), ey = ex2(ref - lt);
        Qx[t * kLdA + i] = rv * ex;
        Kx[t * kLdA + i] = kv * ey;
        Ain[t * kLdA + i] = rv * ex * e_ref;
        Kst[t * kLdB + i] = kv * ey * e_rest;
      } else {
        Ain[t * kLdA + i] = rv * ex2(lp);
        Kst[t * kLdB + i] = kv * ex2(tot - lt);
        if (t >= kSub)
          Qx[t * kLdA + i] = rv * ex2(lp - le);
        else
          Kx[t * kLdA + i] = kv * ex2(le - lt);
      }
    }
    int row;
    const float bsum = warp_sums(bonus, lane, row);
    if ((lane & (32 / kSegLen - 1)) == 0)
      bon[(i / 32) * kC + t_lo + row] = bsum;
    const int any_steep = __any_sync(0xffffffffu, steep);
    if (lane == 0) flag[warp] = any_steep;
    if (sg == 0) dec_s[i] = exp2f(tot);
    __syncthreads();

    // 3. att: warps 0-5 take the sub-block pairs (0,0), (1,0), (1,1), 8 key
    //    columns each; the diagonal gets the bonus.
    if (warp < 6) {
      const int bi = warp >> 1, nh = warp & 1;
      const bool diag = bi != 1;
      const int tr = bi ? kSub : 0, sc = bi == 2 ? kSub : 0;
      int pair = 0;
      if (diag)
#pragma unroll
        for (int w2 = 0; w2 < kWarps; ++w2) pair |= flag[w2];
      float cacc[4] = {0.f, 0.f, 0.f, 0.f}, dacc[4] = {0.f, 0.f, 0.f, 0.f};
      if (!pair) {
        const float* qa = Qx + tr * kLdA;
        const float* kb = Kx + (sc + 8 * nh) * kLdA;
#pragma unroll
        for (int kk = 0; kk < K / 8; ++kk) {
          FragA fa;
          FragB<false> fb;
          load_a(fa, qa + 8 * kk, kLdA, g, q);
          load_bt(fb, kb + 8 * kk, kLdA, g, q);
          mma3(cacc, dacc, fa, fb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[e] += dacc[e];
      } else {
        for (int e = 0; e < 4; ++e) {
          const int t = tr + g + 8 * (e >> 1);
          const int s = sc + 8 * nh + 2 * q + (e & 1);
          if (s >= t) continue;
          float sum = 0.f;
          for (int ch = 0; ch < K; ++ch)
            sum += to_f32(r_raw[t * kLdR + ch]) * to_f32(k_raw[s * kLdR + ch]) *
                   ex2(wl[(t - 1) * kLdA + ch] - wl[s * kLdA + ch]);
          cacc[e] = sum;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + g + 8 * (e >> 1);
        const int s = sc + 8 * nh + 2 * q + (e & 1);
        if (!diag || s < t)
          att[t * kLdAtt + s] = cacc[e];
        else if (s == t)
          att[t * kLdAtt + s] = bon[t] + (K > 32 ? bon[kC + t] : 0.f);
      }
    }
    cp_async_wait<0>();               // v of this chunk has landed
    __syncthreads();
    if (c + 1 < n_chunks) {           // the next chunk's w, r, k
      load_rows<K>(wl, kLdA, wp, ws.t, t0 + kC, Tn, tid);
      load_rows<K>(r_raw, kLdR, rp, rs.t, t0 + kC, Tn, tid);
      load_rows<K>(k_raw, kLdR, kp, ks.t, t0 + kC, Tn, tid);
    }
    cp_async_commit();

    // 4. o = Ain S + att v: warp (mt, nt) takes rows 16 mt .. 16 mt + 15
    //    and the 8-column tiles nt, nt + 4.
    {
      constexpr int kN = K / 32;
      const int mt = warp & 1, nt = warp >> 1;
      float oacc[kN][4] = {}, dacc[kN][4] = {};
      const float* a_in = Ain + 16 * mt * kLdA;
#pragma unroll
      for (int kk = 0; kk < K / 8; ++kk) {
        FragA fa;
        load_a(fa, a_in + 8 * kk, kLdA, g, q);
#pragma unroll
        for (int jn = 0; jn < kN; ++jn) {
          FragB<false> fb;
          load_b(fb, S + 8 * kk * kLdB + 8 * (nt + 4 * jn), kLdB, g, q);
          mma3(oacc[jn], dacc[jn], fa, fb);
        }
      }
      const float* a_att = att + 16 * mt * kLdAtt;
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        if (kk >= 2 * (mt + 1)) break;  // keys past the rows: att is 0
        FragA fa;
        load_a(fa, a_att + 8 * kk, kLdAtt, g, q);
#pragma unroll
        for (int jn = 0; jn < kN; ++jn) {
          FragB<kVExact> fb;
          load_b(fb, v_raw + 8 * kk * kLdR + 8 * (nt + 4 * jn), kLdR, g, q);
          mma3(oacc[jn], dacc[jn], fa, fb);
        }
      }
#pragma unroll
      for (int jn = 0; jn < kN; ++jn) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tl = 16 * mt + g + 8 * half;
          if (tl < n) {
            const int j = 8 * (nt + 4 * jn) + 2 * q;
            *reinterpret_cast<float2*>(
                o + (((int64_t)b * Tn + t0 + tl) * H + h) * K + j) =
                make_float2(oacc[jn][2 * half] + dacc[jn][2 * half],
                            oacc[jn][2 * half + 1] + dacc[jn][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();                  // S is read; now it is updated

    // 5. S = e^{L_last} S + Kst^T v: warp (mt, nb) takes rows 16 mt ..
    //    16 mt + 15 of S and kNP 8-column tiles from nb.
    {
      constexpr int kMT = K / 16, kNP = (K / 8) / (kWarps / kMT);
      const int mt = warp % kMT, nb = (warp / kMT) * kNP;
      const int i0 = 16 * mt + g;
      const float d0 = dec_s[i0], d1 = dec_s[i0 + 8];
      float sacc[kNP][4], dacc[kNP][4] = {};
#pragma unroll
      for (int jn = 0; jn < kNP; ++jn) {
        const int j = 8 * (nb + jn) + 2 * q;
        const float2 lo = *reinterpret_cast<const float2*>(S + i0 * kLdB + j);
        const float2 hi =
            *reinterpret_cast<const float2*>(S + (i0 + 8) * kLdB + j);
        sacc[jn][0] = lo.x * d0;
        sacc[jn][1] = lo.y * d0;
        sacc[jn][2] = hi.x * d1;
        sacc[jn][3] = hi.y * d1;
      }
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        FragA fa;
        load_at(fa, Kst + 8 * kk * kLdB + 16 * mt, kLdB, g, q);
#pragma unroll
        for (int jn = 0; jn < kNP; ++jn) {
          FragB<kVExact> fb;
          load_b(fb, v_raw + 8 * kk * kLdR + 8 * (nb + jn), kLdR, g, q);
          mma3(sacc[jn], dacc[jn], fa, fb);
        }
      }
#pragma unroll
      for (int jn = 0; jn < kNP; ++jn) {
        const int j = 8 * (nb + jn) + 2 * q;
        *reinterpret_cast<float2*>(S + i0 * kLdB + j) = make_float2(
            sacc[jn][0] + dacc[jn][0], sacc[jn][1] + dacc[jn][1]);
        *reinterpret_cast<float2*>(S + (i0 + 8) * kLdB + j) = make_float2(
            sacc[jn][2] + dacc[jn][2], sacc[jn][3] + dacc[jn][3]);
      }
    }
    __syncthreads();
    if (c + 1 < n_chunks)             // the next chunk's v
      load_rows<K>(v_raw, kLdR, vp, vs.t, t0 + kC, Tn, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float4* s_out = reinterpret_cast<float4*>(sT + (int64_t)bh * K * K);
  for (int e = tid; e < K * K / 4; e += kThreads)
    s_out[e] = *reinterpret_cast<const float4*>(S + (e / (K / 4)) * kLdB +
                                                4 * (e % (K / 4)));
}

// ---------------------------------------------------------------------------
// the step kernel (T = 1)
// ---------------------------------------------------------------------------

// One state entry's step: y += r * (S + u*k*v); S = w*S + k*v.
__device__ __forceinline__ void entry(float& s, float r, float k, float w,
                                      float u, float vj, float& y) {
  const float kv = k * vj;
  y = fmaf(r, fmaf(u, kv, s), y);
  s = fmaf(s, w, kv);
}

// A block owns a slab of kCols state columns of one (b, h), one column a
// thread, and walks the K rows of its column: K independent 4-byte loads
// a thread in flight, each coalesced to 128 bytes across the warp.
template <int K>
struct Step {
  static constexpr int kCols = K < 32 ? K : 32;
  static constexpr int kThreads = kCols;
};

template <typename T, int K>
__global__ void __launch_bounds__(Step<K>::kThreads)
wkv6_step(const T* __restrict__ r, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ w,
          const float* __restrict__ u, const float* __restrict__ s0,
          float* __restrict__ o, float* __restrict__ sT, Strides rs,
          Strides ks, Strides vs, Strides ws, int H) {
  constexpr int kCols = Step<K>::kCols, kSlabs = K / kCols;
  __shared__ __align__(16) float r_s[K];
  __shared__ __align__(16) float k_s[K];
  __shared__ __align__(16) float w_s[K];
  __shared__ __align__(16) float u_s[K];
  const int slab = blockIdx.x % kSlabs, bh = blockIdx.x / kSlabs;
  const int b = bh / H, h = bh % H, j = kCols * slab + threadIdx.x;
  const float* s_in = s0 + (int64_t)bh * K * K + j;
  float* s_out = sT + (int64_t)bh * K * K + j;
  float s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = s_in[i * K];
  for (int e = threadIdx.x; e < K; e += kCols) {
    r_s[e] = to_f32(r[b * rs.b + h * rs.h + e]);
    k_s[e] = to_f32(k[b * ks.b + h * ks.h + e]);
    w_s[e] = clip_decay(w[b * ws.b + h * ws.h + e]);
    u_s[e] = u[h * K + e];
  }
  const float vj = to_f32(v[b * vs.b + h * vs.h + j]);
  __syncthreads();
  float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
  for (int i = 0; i < K; i += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(&r_s[i]);
    const float4 k4 = *reinterpret_cast<const float4*>(&k_s[i]);
    const float4 w4 = *reinterpret_cast<const float4*>(&w_s[i]);
    const float4 u4 = *reinterpret_cast<const float4*>(&u_s[i]);
    entry(s[i], r4.x, k4.x, w4.x, u4.x, vj, y0);
    entry(s[i + 1], r4.y, k4.y, w4.y, u4.y, vj, y1);
    entry(s[i + 2], r4.z, k4.z, w4.z, u4.z, vj, y2);
    entry(s[i + 3], r4.w, k4.w, w4.w, u4.w, vj, y3);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) s_out[i * K] = s[i];
  o[(int64_t)bh * K + j] = (y0 + y1) + (y2 + y3);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int K>
int launch(const T* r, const T* k, const T* v, const float* w,
           const float* u, const float* s0, float* o, float* sT, Strides rs,
           Strides ks, Strides vs, Strides ws, int B, int Tn, int H,
           cudaStream_t stream) {
  if (Tn == 1) {
    constexpr int kSlabs = K / Step<K>::kCols;
    wkv6_step<T, K><<<B * H * kSlabs, Step<K>::kThreads, 0, stream>>>(
        r, k, v, w, u, s0, o, sT, rs, ks, vs, ws, H);
    return 0;
  }
  constexpr size_t bytes = Layout<T, K>::kBytes;
  static bool ready = false;         // the shared-memory limit, once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunked<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  wkv6_chunked<T, K><<<B * H, kThreads, bytes, stream>>>(
      r, k, v, w, u, s0, o, sT, rs, ks, vs, ws, Tn, H);
  return 0;
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* o, float* sT, Strides rs,
             Strides ks, Strides vs, Strides ws, int B, int Tn, int H, int K,
             cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  switch (K) {
    case 32:
      return launch<T, 32>(rt, kt, vt, w, u, s0, o, sT, rs, ks, vs, ws, B, Tn,
                           H, stream);
    case 64:
      return launch<T, 64>(rt, kt, vt, w, u, s0, o, sT, rs, ks, vs, ws, B, Tn,
                           H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r/k/v: 0 = float32, 1 = bfloat16; w, u and the states are f32.
// K in {32, 64}; T >= 1 (T = 1 runs the step kernel, T >= 2 the chunked
// one). strides: 12 element strides, (b, t, h) of r, k, v and w in that
// order; for T >= 2 every row of r/k/v/w starts 16-byte aligned, and the
// states are 16-byte aligned. Returns cudaGetLastError() after the launch.
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
    rc = launch_k<float>(r, k, v, wf, uf, s0f, of, sTf, rs, ks, vs, ws, B, Tn,
                         H, K, s);
  else if (dtype == 1)
    rc = launch_k<bf16>(r, k, v, wf, uf, s0f, of, sTf, rs, ks, vs, ws, B, Tn,
                        H, K, s);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
