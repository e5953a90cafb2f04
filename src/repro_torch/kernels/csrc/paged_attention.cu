// Paged decode attention for Hopper (sm_90a), split-K (flash-decoding), with
// an optional fused KV write.
//
// Replaces the Pallas TPU kernels `paged_attention_fused` (_fused_kernel) and
// `paged_attention` (_kernel) of src/repro/kernels/paged_attention.py. One
// body, templated on the element type (float, bf16), the head dim D and a
// bound GP on the query heads per kv head; `fused` is a runtime flag. The C
// entry `paged_decode_attention` picks the instantiation and launches two
// kernels on the caller's stream.
//
// What bounds it on the H100: decode reads every valid K and V byte of the
// batch once and does about 4*G*D flops per (K, V) token pair of 4*D bytes,
// about 4 flops a byte at G = 4, far below the ~295 at which the tensor cores
// become the limit. So the memory rate sets the bound, and the design is
// about keeping enough bytes in flight on every SM:
//
// 1. Split the key range across blocks. The grid is (Hkv, B, S): each block
//    owns `pps` pages of one lane's table (split s covers table entries
//    [s*pps, (s+1)*pps)), so a batch of 8 lanes at ~1.2k tokens runs ~320
//    busy blocks of 512 instead of 64, and one 16k-token lane 512 instead
//    of 8; splits past a lane's length exit at once.
//    The host picks pps and S from (B, Hkv, maxp, page) alone, never from
//    `lengths`, so there is no device-to-host sync.
// 2. Read K and V as 16-byte vectors, several in flight. A key row of head
//    h (D elements) is read by TPR = D / VEC threads, VEC = 16 / sizeof(T)
//    elements each. The rows go through a ring of NSTAGE stages in shared
//    memory, filled with 16-byte cp.async copies: NSTAGE - 1 stages (each
//    NV rows a thread) are in flight while one is computed, and since a
//    thread reads back only the slots it copied itself the walk needs no
//    barrier. In-flight bytes live in shared memory, not registers, so a
//    block keeps ~100 registers a thread and ~5 blocks fit an SM. (Register
//    double buffering kept one tile in flight at 168 registers and reached
//    about half the speed.) The page ids of the first stages, q and the
//    lane's length are loaded together; a row's page is found with a
//    multiply-shift divider, not an integer division.
//    The block's G query rows (scaled by D**-0.5 * log2(e)) stay in
//    registers in f32; each q.k dot product is reduced over the row's TPR
//    lanes with warp shuffles. Each thread keeps its own online softmax
//    (m, l) per query head over the rows it reads and an f32 accumulator
//    for its VEC dims. Compute stays on the CUDA cores in f32, exponentials
//    in base 2 on the special-function unit (ex2.approx).
// 3. Write partials, then combine. At its end a block merges its threads'
//    (m, l, acc) (shuffles within a warp, shared memory across warps) and
//    writes one f32 partial per query head to the workspace: m and l at
//    (B, Hq, S), acc at (B, Hq, S, D). An empty split writes m = -1e30,
//    l = 0 (and no acc). A second kernel, one block per (b, query head),
//    computes o = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s,
//    1e-30), M = max_s m_s, over the splits that hold a key; it never waits
//    on `lengths`, so all its loads are issued at once.
//
// Fused: the split-0 block of each (b, h) stores its head's k_new / v_new
// into the pool slot (write_pages[b], write_offsets[b]); pool writes are
// byte copies. Page reads stop at limit = lengths[b] - 1, so the slot (the
// table position of lengths[b] - 1) is never read: rows at or past the
// limit are not read (their ring slots are zero-filled) and weigh 0. The
// new token joins the combine as one more partial, read from k_new / v_new
// and never from the pool: m = q.k_new, l = 1, acc = v_new. Idle lanes
// (length 1, an all-scratch table, slot (scratch, 0)) read no page and
// output v_new, as the TPU kernel does. Read-only: limit = lengths[b]. Both
// clamp the limit to maxp * page.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"   // cp.async helpers

namespace {

using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::kLog2e;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;          // the wrapper's _MAX_SPLITS
constexpr float kEmpty = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// VEC elements of T in one 16-byte vector, unpacked to f32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to zero, which a softmax weight may)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> l, with m and l from
// the host's make_divider (Granlund and Montgomery's round-up method)
struct Divider {
  unsigned m;
  int l;
};
__device__ __forceinline__ int divide(int n, Divider d) {
  return (int)((__umulhi((unsigned)n, d.m) + (unsigned)n) >> d.l);
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const T* __restrict__ q,          // (B, Hq, D)
                   T* k_pages, T* v_pages,            // (P, page, Hkv, D)
                   const int* __restrict__ table,     // (B, maxp)
                   const int* __restrict__ lengths,   // (B,)
                   const T* __restrict__ k_new,       // (B, Hkv, D)
                   const T* __restrict__ v_new,
                   const int* __restrict__ write_pages,   // (B,)
                   const int* __restrict__ write_offsets,
                   float* __restrict__ ws_acc,        // (B, Hq, S, D)
                   float2* __restrict__ ws_ml,        // (B, Hq, S): (m, l)
                   int fused, int maxp, int page, Divider by_page, int Hkv,
                   int G, int pps, int S, float qscale) {
  using V = Vec16<T>;
  constexpr int VEC = V::kVec;
  constexpr int TPR = D / VEC;                 // threads per key row
  constexpr int RG = kThreads / TPR;           // rows per load step
  constexpr int NV = 2;                        // rows per thread per stage
  constexpr int NSTAGE = 3;                    // NSTAGE - 1 stages in flight
  constexpr int TILE = NV * RG;                // rows per stage
  constexpr int RING = NSTAGE * NV * 2 * kThreads;           // uint4 slots
  constexpr int MERGE = (kWarps * GP * (D + 2) + 3) / 4;     // as uint4
  static_assert(D % VEC == 0 && 32 % TPR == 0, "row slices must tile a warp");
  // each thread's own ring slots (it reads back only what it copied, so
  // the walk needs no barrier); reused by the end-of-block merge
  __shared__ uint4 smem[RING > MERGE ? RING : MERGE];

  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int slice = tid % TPR;                 // which 16 bytes of the row
  const int rg = tid / TPR;                    // which row of a step
  const int Hq = Hkv * G;
  const int64_t tok_stride = (int64_t)Hkv * D;
  const int64_t page_stride = (int64_t)page * tok_stride;

  if (fused && s == 0 && tid < TPR) {
    const int64_t src = ((int64_t)b * Hkv + h) * D + slice * VEC;
    const int64_t dst = ((int64_t)write_pages[b] * page + write_offsets[b]) *
                            tok_stride + (int64_t)h * D + slice * VEC;
    *reinterpret_cast<uint4*>(k_pages + dst) =
        *reinterpret_cast<const uint4*>(k_new + src);
    *reinterpret_cast<uint4*>(v_pages + dst) =
        *reinterpret_cast<const uint4*>(v_new + src);
  }

  const int64_t head0 = (int64_t)b * Hq + (int64_t)h * G;   // (b, h*G)
  const int* trow = table + (int64_t)b * maxp;
  const int lo = s * pps * page;
  // the page ids of the first NSTAGE - 1 stages, q and the length are
  // loaded together; rows are copied only once the length says they exist
  int pid0[NSTAGE - 1][NV];
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = divide(lo + st * TILE + i * RG + rg, by_page);
      pid0[st][i] = j < maxp ? __ldg(trow + j) : 0;
    }
  float qr[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          q + (head0 + g) * D + slice * VEC));
      V::unpack(u, qr[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }
  // the keys the lane's walk may read are [0, limit)
  const int limit = min(lengths[b] - fused, maxp * page);
  const int hi = min(limit, lo + pps * page);
  if (lo >= hi) {                               // an empty split
    if (tid < G) ws_ml[(head0 + tid) * S + s] = make_float2(kEmpty, 0.f);
    return;
  }

  const T* kbase = k_pages + (int64_t)h * D + slice * VEC;
  const T* vbase = v_pages + (int64_t)h * D + slice * VEC;
  uint4* ring = smem + tid;                     // slot (st, i, kv): below
  // element offsets within a pool: pid * page_stride + in-page row *
  // tok_stride, one 32 x 32 -> 64-bit multiply (a page holds < 2^31)
  const unsigned page_elems = (unsigned)page_stride;
  const unsigned tok_elems = (unsigned)tok_stride;
  // rows at or past hi are not read: their slots are zero-filled
  auto copy_row = [&](int st, int i, int row, int pid) {
    const bool ok = row < hi;
    const unsigned in_page = (unsigned)(row - divide(row, by_page) * page);
    const uint64_t off =
        ok ? (uint64_t)(unsigned)pid * page_elems + in_page * tok_elems : 0;
    uint4* dst = ring + (st * NV + i) * 2 * kThreads;
    attn_mma::cp_async16(attn_mma::smem_u32(dst), kbase + off, ok);
    attn_mma::cp_async16(attn_mma::smem_u32(dst + kThreads), vbase + off,
                         ok);
  };
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      copy_row(st, i, lo + st * TILE + i * RG + rg, pid0[st][i]);
    cp_async_commit();
  }

  float m[GP], l[GP], acc[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kEmpty;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }
  int st = 0;                                   // the stage computed next
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    cp_async_wait<NSTAGE - 2>();                // stage st has landed
    {   // refill the stage computed last with the tile NSTAGE - 1 ahead
      const int tn = t0 + (NSTAGE - 1) * TILE;
      const int sn = st == 0 ? NSTAGE - 1 : st - 1;
      if (tn < hi) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int row = tn + i * RG + rg;
          copy_row(sn, i, row,
                   row < hi ? __ldg(trow + divide(row, by_page)) : 0);
        }
      }
      cp_async_commit();                        // (empty past hi)
    }
    float sc[NV][GP];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float kf[VEC];
      V::unpack(ring[(st * NV + i) * 2 * kThreads], kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
        sc[i][g] = d;
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          sc[i][g] += __shfl_xor_sync(kFull, sc[i][g], off);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (t0 + i * RG + rg < hi) mx = fmaxf(mx, sc[i][g]);
      const float alpha = ex2(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float p = t0 + i * RG + rg < hi ? ex2(sc[i][g] - mx) : 0.f;
        sc[i][g] = p;
        l[g] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float vf[VEC];
      V::unpack(ring[(st * NV + i) * 2 * kThreads + kThreads], vf);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = fmaf(sc[i][g], vf[e], acc[g][e]);
    }
    st = st == NSTAGE - 1 ? 0 : st + 1;
  }

  // merge the row groups of a warp (lanes with the same slice)...
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo_ = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = ex2(m[g] - mx), c = ex2(mo - mx);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(kFull, acc[g][e], off) * c;
      m[g] = mx;
    }
  }
  // ...then the warps, through the ring's shared memory
  cp_async_wait<0>();
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);         // [kWarps][GP]
  float* sm_l = sm_m + kWarps * GP;                      // [kWarps][GP]
  float* sm_acc = sm_l + kWarps * GP;                    // [kWarps][GP][D]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (lane == 0) {
        sm_m[warp * GP + g] = m[g];
        sm_l[warp * GP + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(warp * GP + g) * D + lane * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = sm_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sm_m[w * GP + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(sm_m[w * GP + g] - M);
      L += sm_l[w * GP + g] * c;
      A += sm_acc[(w * GP + g) * D + d] * c;
    }
    ws_acc[((head0 + g) * S + s) * D + d] = A;
    if (d == 0) ws_ml[(head0 + g) * S + s] = make_float2(M, L);
  }
}

// o = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30) over the
// splits that hold a key (l_s > 0; an empty split wrote no acc), plus (fused)
// the new token's partial. One block per (b, query head). Every load is
// issued first: thread s takes split s's (m, l); warp w the acc rows of
// splits w, w + kWarps, ... (lanes D / 32 dims each); warp 0 q, k_new and
// v_new. None waits on `lengths`.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const T* __restrict__ q, const T* __restrict__ k_new,
                     const T* __restrict__ v_new,
                     const float* __restrict__ ws_acc,
                     const float2* __restrict__ ws_ml, T* __restrict__ o,
                     int fused, int Hkv, int G, int S, float qscale) {
  constexpr int DPL = D / 32;                  // dims per lane
  constexpr int PER_WARP = kMaxSplits / kWarps;
  const int bh = blockIdx.x;                   // b * Hq + query head
  const int Hq = Hkv * G;
  const int b = bh / Hq, h = (bh % Hq) / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* acc = ws_acc + (int64_t)bh * S * D + lane * DPL;
  const int64_t new_base = ((int64_t)b * Hkv + h) * D + lane * DPL;

  const float2 ml = tid < S ? ws_ml[(int64_t)bh * S + tid]
                            : make_float2(kEmpty, 0.f);
  float x[PER_WARP][DPL];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int i = warp + k * kWarps;
    const float* a = acc + (int64_t)i * D;
    if (i >= S) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) x[k][j] = 0.f;
    } else if constexpr (DPL == 4) {
      const float4 u = *reinterpret_cast<const float4*>(a);
      x[k][0] = u.x; x[k][1] = u.y; x[k][2] = u.z; x[k][3] = u.w;
    } else if constexpr (DPL == 2) {
      const float2 u = *reinterpret_cast<const float2*>(a);
      x[k][0] = u.x; x[k][1] = u.y;
    } else {
      x[k][0] = a[0];
    }
  }
  __shared__ float sm_red[kWarps], sm_w[kMaxSplits], sm_acc[kWarps][D];
  __shared__ float sm_new;
  float vn[DPL];
  if (warp == 0) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      vn[j] = fused ? to_f32(v_new[new_base + j]) : 0.f;
      if (fused)
        d = fmaf(to_f32(q[(int64_t)bh * D + lane * DPL + j]),
                 to_f32(k_new[new_base + j]), d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(kFull, d, off);
    if (lane == 0) sm_new = fused ? d * qscale : kEmpty;
  }
  float M = ml.y > 0.f ? ml.x : kEmpty;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
  if (lane == 0) sm_red[warp] = M;
  __syncthreads();
  M = sm_new;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_red[w]);
  const float c_new = fused ? ex2(sm_new - M) : 0.f;
  if (tid < kMaxSplits) sm_w[tid] = ml.y > 0.f ? ex2(ml.x - M) : 0.f;
  float L = tid < kMaxSplits && ml.y > 0.f ? ex2(ml.x - M) * ml.y : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(kFull, L, off);
  __syncthreads();                              // sm_w written, sm_red read
  if (lane == 0) sm_red[warp] = L;
  float A[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) A[j] = 0.f;
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int i = warp + k * kWarps;
    const float w = i < S ? sm_w[i] : 0.f;
    if (w > 0.f)                  // an empty split's acc was never written
#pragma unroll
      for (int j = 0; j < DPL; ++j) A[j] = fmaf(w, x[k][j], A[j]);
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) sm_acc[warp][lane * DPL + j] = A[j];
  __syncthreads();
  if (warp != 0) return;
  L = c_new;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) L += sm_red[w];
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane * DPL + j;
    float y = c_new * vn[j];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += sm_acc[w][d];
    o[(int64_t)bh * D + d] = from_f32<T>(y * inv);
  }
}

struct Args {
  const void *q, *table, *lengths, *k_new, *v_new, *write_pages,
      *write_offsets;
  void *k_pages, *v_pages, *ws, *o;
  int fused, B, maxp, page, Hkv, G, pps, S;
  Divider by_page;
  float qscale;
};

template <typename T, int D, int GP>
void launch(const Args& a, cudaStream_t stream) {
  const int Hq = a.Hkv * a.G;
  float* ws_acc = static_cast<float*>(a.ws);
  float2* ws_ml =
      reinterpret_cast<float2*>(ws_acc + (int64_t)a.B * Hq * a.S * D);
  paged_decode_split<T, D, GP><<<dim3(a.Hkv, a.B, a.S), kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<T*>(a.k_pages),
      static_cast<T*>(a.v_pages), static_cast<const int*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), static_cast<const int*>(a.write_pages),
      static_cast<const int*>(a.write_offsets), ws_acc, ws_ml, a.fused, a.maxp,
      a.page, a.by_page, a.Hkv, a.G, a.pps, a.S, a.qscale);
  paged_decode_combine<T, D><<<a.B * Hq, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), ws_acc, ws_ml, static_cast<T*>(a.o),
      a.fused, a.Hkv, a.G, a.S, a.qscale);
}

template <typename T, int D>
int launch_g(const Args& a, cudaStream_t stream) {
  if (a.G <= 1) launch<T, D, 1>(a, stream);
  else if (a.G <= 2) launch<T, D, 2>(a, stream);
  else if (a.G <= 4) launch<T, D, 4>(a, stream);
  else if (a.G <= 8) launch<T, D, 8>(a, stream);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<T, 32>(a, stream);
    case 64: return launch_g<T, 64>(a, stream);
    case 128: return launch_g<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Divider make_divider(int d) {
  int l = 0;
  while ((1u << l) < (unsigned)d) ++l;
  const uint64_t m = ((uint64_t)1 << 32) * (((uint64_t)1 << l) - d) / d + 1;
  return Divider{(unsigned)m, l};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. fused: 0 = read-only, 1 = KV write fused.
// k_new, v_new, write_pages, write_offsets may be null when fused == 0.
// ws: B * Hkv * G * S * (D + 2) floats, 16-byte aligned: acc (B, Hq, S, D),
// then (m, l) pairs (B, Hq, S). scale: D**-0.5. Returns cudaGetLastError()
// after both launches (0 on success), or cudaErrorInvalidValue for a shape
// no instance takes.
int paged_decode_attention(int dtype, int fused, const void* q, void* k_pages,
                           void* v_pages, const void* table,
                           const void* lengths, const void* k_new,
                           const void* v_new, const void* write_pages,
                           const void* write_offsets, void* ws, void* o, int B,
                           int maxp, int page, int Hkv, int G, int D, int pps,
                           int S, float scale, void* stream) {
  if (S < 1 || S > kMaxSplits || page < 1 || pps < 1 ||
      (int64_t)page * Hkv * D >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{q, table, lengths, k_new, v_new, write_pages, write_offsets,
               k_pages, v_pages, ws, o, fused ? 1 : 0, B, maxp, page, Hkv, G,
               pps, S, make_divider(page), scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = launch_d<float>(a, D, s);
  else if (dtype == 1) rc = launch_d<__nv_bfloat16>(a, D, s);
  else rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
