// Tensor-core attention core for Hopper (sm_90a), shared by the bf16 paths
// of flash_attention.cu (dense, strided) and paged_flash_attention.cu
// (pool pages through a block table); paged_attention.cu (decode) uses
// only its cp.async helpers.
//
// FlashAttention-2's design on the warp-level tensor cores:
//
// - A block has kWarps = 4 warps and kRows = 64 query rows, 16 per warp. A
//   row is a (position, query head) pair: row r -> position r / G, query
//   head h * G + r % G, so the G query heads that share kv head h read one
//   K/V tile. Rows past Sq (or past block_q * G) are zero-filled.
// - Q is copied once with cp.async into shared memory, then held for the
//   whole walk as ldmatrix A-fragments in registers.
// - The block walks its key range [kv_lo, kv_hi) in kKeys = 64-key tiles
//   through a ring of kStages = 2 K/V stages in dynamic shared memory,
//   filled with 16-byte cp.async.cg copies: tile j + 1 is in flight while
//   tile j is computed. Shared rows are padded by 8 elements (16 bytes), so
//   the 8 row addresses of each ldmatrix phase fall in distinct banks.
// - S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 -> f32. K
//   fragments come from ldmatrix, V fragments from ldmatrix.trans; P is
//   rounded to bf16 in registers and reused directly as the A-fragments of
//   the second product (the C layout of one equals the A layout of the
//   other), with no shared-memory round trip.
// - Score: (q.k) * scale, then softcap * tanh(s / softcap) when a softcap
//   is set (a template flag), then the mask. The tanh is computed to f32
//   accuracy (tanh_f32 below, within about 6e-7 of tanh), as the plain
//   version's and the f32 path's tanhf. The online softmax runs in f32
//   registers with exp2f, the scale and log2(e) folded into one FFMA per
//   score; the accumulator is rescaled once per tile, and not at all when
//   no row max of the warp moved. Only the tiles at the edges of the range (the last
//   tile, tiles cut by the causal diagonal or by the window start) mask per
//   element; interior tiles skip it.
// - Keys at or past kv_hi (past Skv, kv_len, the table's Np * page, or the
//   last causal position any row of the block can see) are zero-filled
//   with cp.async's src-size-0 form from a valid address: a masked key
//   weighs exactly 0, and since 0 * NaN is NaN in the mma, stale data that
//   no row may see must never reach shared memory.
// - Epilogue: O / max(l, 1e-30), so a row that sees no key gives zero;
//   stored as bf16 pairs through the output's element strides.
//
// The caller supplies "the address of key row t" (a Keys policy with
// rows(t, k_row, v_row)): dense strides, or the block table for a paged
// pool, where a tile may span several pages or part of one. That is why
// each row is its own cp.async and not a TMA box. The walk order depends
// only on the keys, so two rows that see the same keys give bit-equal
// outputs.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kStages = 2;          // K/V tiles in flight
constexpr int kPad = 8;             // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of one (B, H, S, D) operand
  int64_t b, h, s;
};

// Dynamic shared memory of one block: Q, then kStages (K, V) tile pairs.
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kRows + 2 * kStages * kKeys) * (D + kPad) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid false nothing is read and dst is zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key rows of a dense (B, Hkv, Skv, D) operand, already offset to (b, h).
struct DenseKeys {
  const bf16* k;
  const bf16* v;
  int64_t ks, vs;  // element stride from one key to the next
  __device__ __forceinline__ void rows(int t, const bf16*& kr,
                                       const bf16*& vr) const {
    kr = k + (int64_t)t * ks;
    vr = v + (int64_t)t * vs;
  }
};

// Key rows of a paged pool (P, page, Hkv, D) steered by one block-table row;
// k/v are the pool bases offset to head h.
struct PagedKeys {
  const bf16* k;
  const bf16* v;
  const int* table;  // this batch row's Np page ids
  int page;
  int64_t tok;       // Hkv * D, the element stride from token to token
  __device__ __forceinline__ void rows(int t, const bf16*& kr,
                                       const bf16*& vr) const {
    const int pid = __ldg(table + t / page);
    const int64_t off = ((int64_t)pid * page + t % page) * tok;
    kr = k + off;
    vr = v + off;
  }
};

// What one block computes: rows [qblk * block_q, + block_q) of (b, kv head
// h), walking keys [kv_lo, kv_hi). q/o point at batch row b.
struct Block {
  int h, G, block_q, qblk, Sq;
  int q_offset;      // kv position of query 0
  int kv_lo, kv_hi;  // block-uniform key range
  int causal, window;
  float scale, softcap;
};

// tanh(y) = 1 - 2 / (1 + 2^(2 y log2 e)): one exp2 and one fast divide,
// each within 2 ulps, so the result is within about 6e-7 of tanh (a few
// ulps of 1), without tanhf's branches. |y| is clamped to 9, where tanh
// rounds to +-1 in f32, which keeps the exp2 finite.
__device__ __forceinline__ float tanh_f32(float y) {
  y = fminf(fmaxf(y, -9.f), 9.f);
  return 1.f - __fdividef(2.f, 1.f + exp2f(2.f * kLog2e * y));
}

// kCap: a logit softcap is set (p.softcap > 0).
template <int D, bool kCap, class Keys>
__device__ __forceinline__ void attend(const Keys& keys, const bf16* q,
                                       Strides qs, bf16* o, Strides os,
                                       const Block& p) {
  constexpr int kLd = D + kPad;      // shared row length, elements
  constexpr int kChunks = D / 8;     // 16-byte chunks per row
  constexpr int kDk = D / 16;        // k-steps of Q.K^T
  constexpr int kNs = kKeys / 8;     // 8-key tiles of S
  constexpr int kNo = D / 8;         // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kRows * kLd;    // stage st: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int i0 = p.qblk * p.block_q;  // first query position of the block
  const int i_last = min(i0 + p.block_q, p.Sq) - 1;

  // Q: rows past Sq or past block_q * G are zero-filled
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int c = tid + n * kThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const int il = r / p.G, i = i0 + il;
    const bool ok = il < p.block_q && i < p.Sq;
    const bf16* src =
        ok ? q + (int64_t)(p.h * p.G + r % p.G) * qs.h + (int64_t)i * qs.s +
                 ch * 8
           : q;
    cp_async16(smem_u32(q_s + r * kLd + ch * 8), src, ok);
  }
  cp_async_commit();

  auto load_tile = [&](int t0, int st) {
    bf16* ks = kv_s + (2 * st) * kKeys * kLd;
    bf16* vs = ks + kKeys * kLd;
#pragma unroll
    for (int n = 0; n < kKeys * kChunks / kThreads; ++n) {
      const int c = tid + n * kThreads;
      const int r = c / kChunks, ch = c % kChunks;
      const int t = t0 + r;
      const bool ok = t < p.kv_hi;
      const bf16* kr = keys.k;  // valid addresses for the zero fills
      const bf16* vr = keys.v;
      if (ok) keys.rows(t, kr, vr);
      cp_async16(smem_u32(ks + r * kLd + ch * 8), kr + (ok ? ch * 8 : 0), ok);
      cp_async16(smem_u32(vs + r * kLd + ch * 8), vr + (ok ? ch * 8 : 0), ok);
    }
  };

  const int n_tiles =
      p.kv_hi > p.kv_lo ? (p.kv_hi - p.kv_lo + kKeys - 1) / kKeys : 0;
  if (n_tiles > 0) load_tile(p.kv_lo, 0);
  cp_async_commit();

  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[kDk][4];
  {
    const int r = warp * 16 + (lane % 16);
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk)
      ldsm_x4(qf[kk], smem_u32(q_s + r * kLd + kk * 16 + col));
  }

  // this thread's two rows: warp * 16 + lane / 4 and 8 further
  int qpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    qpos[j] = p.q_offset + i0 + (warp * 16 + lane / 4 + 8 * j) / p.G;
  const int q_first = p.q_offset + i0;
  const int q_last = p.q_offset + i_last;
  // a score in log2 units is f * r: r = q.k (no softcap) or
  // r = tanh(q.k * scale / softcap); the row max runs on r (f > 0) and f
  // folds into exp2's argument as one FFMA
  const float y_mul = kCap ? p.scale / p.softcap : 0.f;
  const float f = kCap ? p.softcap * kLog2e : p.scale * kLog2e;

  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = p.kv_lo + j * kKeys;
    if (j + 1 < n_tiles) load_tile(t0 + kKeys, (j + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* ks = kv_s + (2 * (j % kStages)) * kKeys * kLd;
    const bf16* vs = ks + kKeys * kLd;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int np = 0; np < kNs / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane / 16) * 8 + (lane % 8);
        const int col = kk * 16 + ((lane / 8) % 2) * 8;
        ldsm_x4(b, smem_u32(ks + key * kLd + col));
        mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // softcap, then the mask (edge tiles only)
    const bool full = t0 + kKeys <= p.kv_hi &&
                      (!p.causal || t0 + kKeys - 1 <= q_first) &&
                      (p.window <= 0 || q_last - t0 < p.window);
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r = s[n][e];
        if (kCap) r = tanh_f32(r * y_mul);
        if (!full) {
          const int t = t0 + n * 8 + 2 * (lane % 4) + (e & 1);
          const int qp = qpos[e / 2];
          const bool ok = t < p.kv_hi && (!p.causal || t <= qp) &&
                          (p.window <= 0 || qp - t < p.window);
          if (!ok) r = -INFINITY;
        }
        s[n][e] = r;
      }
    }

    // online softmax; the accumulator is rescaled once per tile, and not
    // at all when no row max of the warp moved (a factor of 1 is exact)
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      base[r] = m_new == -INFINITY ? 0.f : m_new * f;  // no key seen yet
      alpha[r] = exp2f(fmaf(m[r], f, -base[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
      }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(fmaf(s[n][e], f, -base[e / 2]));
        l[e / 2] += pe;
        s[n][e] = pe;
      }
    }

    // O += P V, P from registers as bf16 A-fragments
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kNo / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        const int col = dp * 16 + (lane / 16) * 8;
        ldsm_x4_t(b, smem_u32(vs + key * kLd + col));
        mma16816(acc[2 * dp], a, b[0], b[1]);
        mma16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage j % kStages is free for tile j + kStages
  }
  cp_async_wait<0>();

  // epilogue: the quad's partial row sums, then O / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = warp * 16 + lane / 4 + 8 * r;
    const int il = row / p.G, i = i0 + il;
    if (il >= p.block_q || i >= p.Sq) continue;
    bf16* op = o + (int64_t)(p.h * p.G + row % p.G) * os.h +
               (int64_t)i * os.s + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

}  // namespace attn_mma
