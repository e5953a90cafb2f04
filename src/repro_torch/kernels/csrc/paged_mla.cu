// Multi-head latent attention (MLA) over a latent page pool, for Hopper
// (sm_90a): a split-K decode kernel with its combine, and a chunked-prefill
// kernel. They replace no TPU kernel (the JAX package has no MLA); they
// exist because paged_attention.cu and paged_flash_attention.cu read K and
// V per head, and an MLA pool holds one row of R + Dr = 576 values a token
// ([c | rope(k_pe)], models/mla.py) that every query head shares.
//
// Both run the absorbed form. A query row is q~ = [q_nope W_uk^T | q_pe]
// (576 wide, made by the caller); it scores each latent row over all 576
// values, and the output is the softmax-weighted sum of the rows' first
// R = 512 values (the caller lifts it by W_uv). Latent rows are read from
// their pages in place through the block table.
//
// The decode core (walk) is attn_mma.cuh's FlashAttention-2 design on the
// warp-level tensor cores (mma.sync m16n8k16 bf16 -> f32, ldmatrix
// fragments, P reused from registers as the A operand of P.V), widened to
// MLA's rows; each latent row is read one 16-byte cp.async a chunk, so any
// page size works and a tile may span pages:
//
// - A block holds kRows = 16 * RG query rows and has RG * CG warps: warp
//   (rg, cg) owns rows [16 rg, 16 rg + 16) and output columns
//   [cg R / CG, (cg + 1) R / CG). A 16-row accumulator over all 512
//   columns would take 256 f32 registers a thread; split CG ways it takes
//   512 / CG.
// - The score S = Q K^T of a 16-row group is shared by its CG warps: each
//   computes the partial product over its 576 / CG of the reduction, writes
//   it to shared memory in fragment order, and after one barrier sums the
//   CG partials in a fixed order, so every warp of the group holds the
//   same S, bit for bit, and runs the same online softmax on it. The
//   group's QK work is done once, not CG times.
// - Key tiles of KEYS latent rows (576 values, the first 512 of which are
//   also the values) go through a ring of STAGES tiles in dynamic shared
//   memory, STAGES - 1 in flight while one is computed; a tile takes two
//   barriers (its stage has landed, then the partial scores are written).
//   Shared rows are padded by 8 elements, so each ldmatrix phase's 8 rows
//   fall in distinct banks (1,168-byte rows: 4 words of offset a row). A
//   key's page is found with a shift and a mask when the page size is a
//   power of two, else with a division (16 % slower at page 32 when walk
//   also ran the prefill).
// - Scores are scaled by scale * log2(e) in one FFMA and exponentiated
//   with exp2f; the accumulator is rescaled once a tile, and not at all
//   when no row max of the warp moved. Only edge tiles mask per element.
//   Keys at or past the range end are zero-filled (cp.async's src-size-0
//   form), never read.
//
// Decode (paged_mla_decode_split, paged_mla_decode_combine): one lane's H
// = 32 heads are the block's 32 rows (RG = 2, CG = 4: 8 warps, 64
// accumulator registers; the warp's 9 k-steps of Q stay in registers), so
// the heads share every latent row read. Per key and layer the kernel reads
// 1,152 bytes and does 2 H (2 R + Dr) = 69,632 operations, about 60 a
// byte, below the card's ridge (about 295): the bytes bound it. Split-K:
// the grid is (lane, split), each block walks `per` keys of its lane and
// writes an f32 partial (unnormalised sum, log2-unit max, denominator) per
// head; the combine, one block per (lane, head), merges the splits. The
// host picks the splits from the shapes alone, never from `lengths`, so a
// call can be captured. The new token's row (position lengths - 1) is
// written into its pool slot by the lane's split-0 block, and every split
// takes that row from latent_new, never from the pool, so no block reads
// a slot another is writing.
//
// Prefill (paged_mla_prefill_kernel) runs on the warpgroup path instead
// (sm90.cuh; FlashMLA's Hopper design applied to prefill rows). A block's
// 64 rows are (token, head) pairs, token-major, so the heads of the same
// tokens share each latent tile; causal by absolute position (kv_pos <=
// q_offset + token, kv_pos < kv_len), stopping at the last key a row of
// the block can see. 384 threads: two consumer warpgroups (232 registers
// a thread after setmaxnreg) and a producer warp (40).
//
// - Loads: the producer puts Q (64 x 576, 72 KB) into shared memory once,
//   then each 32-key tile into a ring of 4 stages, by TMA: one box of 64
//   columns by one page's rows of the tile (page 32: 9 boxes a tile), each
//   page found in the block table, 128-byte swizzled; mbarriers mark a
//   stage full (bytes landed) and empty (all 8 consumer warps done). Rows
//   past the range's end are zeroed in shared memory before use, so stale
//   rows never reach a product (0 * NaN is NaN).
// - Consumer w in {0, 1} computes the whole 64 x 32 x 576 score tile S of
//   tiles j = w, w + 2, ... with wgmma (A = Q, B = the tile, both from
//   shared memory), once per tile: no partial sums to exchange. It runs
//   the online softmax on its tile from the running row maxima the other
//   consumer published for tile j - 1, publishes its own maxima and
//   rescale factors, and then its P (bf16) in shared memory.
// - Each consumer owns 256 of the 512 output columns (64 x 256 f32: 128
//   accumulator registers a thread) and runs O = O a + P V for every
//   tile, its own P from registers as wgmma's A operand and the other's
//   from shared memory; V is the tile's first 512 columns, read in place
//   (MN-major). The two interleave, so one's softmax overlaps the other's
//   products. Each keeps the denominator of its own tiles' P; the two are
//   summed at the end. The order of every sum is fixed: no atomics.
// - Scores are scaled by scale * log2(e) in one FFMA and exponentiated
//   with exp2f; a warp rescales its accumulator only when a factor is not
//   1. Only edge tiles mask per element. The accumulator is first written
//   by a product (scale-d 0): a register written by other instructions
//   while a product is in flight makes ptxas serialise every wgmma.
// - 64-key tiles in 2 stages (231,976 bytes) ran 10.1 ms at the timing
//   probe's pack against 8.2 for this shape (CUDA events, one H100): with
//   2 stages a tile can load only once both consumers are done with the
//   one before.
//
// The absorbed form does 69,632 operations a query-key pair against the
// published 2 H (Dn + Dr + Dv) = 20,480, 3.4 times the count; expanding
// k_nope and v tile by tile would cost each block 2 R H (Dn + Dv)
// operations a key, more again at any block a register file holds. At
// pack sizes it is bound by the tensor cores: a block's 64 rows take
// 139,264 operations from each 1,152-byte latent row read from L2, about
// 121 a byte, so 132 blocks at the card's peak would draw about 8 TB/s
// from L2. Measured (one H100, 700 W): a 2,048-token pack at 26,000 keys
// in 7.88 ms of device time, 489 TFLOP/s of absorbed work (22.58 ms, 171
// TFLOP/s, on the mma.sync design it replaced).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "sm90.cuh"

namespace {

using attn_mma::bf16;
using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::kLog2e;
using attn_mma::ldsm_x4;
using attn_mma::ldsm_x4_t;
using attn_mma::mma16816;
using attn_mma::pack_bf16;
using attn_mma::smem_u32;

constexpr int kR = 512;              // latent rank: the values' width
constexpr int kDr = 64;              // roped key width
constexpr int kW = kR + kDr;         // a latent row
constexpr int kLd = kW + 8;          // a shared row, padded
constexpr int kChunks = kW / 8;      // 16-byte chunks a row
constexpr int kDk = kW / 16;         // k-steps of Q.K^T
constexpr float kEmpty = -1e30f;     // an empty split's max
constexpr unsigned kFull = 0xffffffffu;

constexpr int kDecodeHeads = 32;
constexpr int kDecodeKeys = 32;      // the wrapper's DECODE_KEYS
constexpr int kPrefillRows = 64;     // the wrapper's PREFILL_ROWS
constexpr int kPrefillKeys = 32;     // the wrapper's PREFILL_KEYS

template <int RG_, int CG_, int KEYS_, int STAGES_>
struct Shape {
  static constexpr int RG = RG_, CG = CG_, KEYS = KEYS_, STAGES = STAGES_;
  static constexpr int kWarps = RG * CG;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * RG;
  static constexpr int kNs = KEYS / 8;      // 8-key tiles of S
  static constexpr int kCols = kR / CG;     // output columns a warp
  static constexpr int kNo = kCols / 8;     // 8-column tiles of O
  static constexpr int kSteps = kDk / CG;   // k-steps of a warp's partial
  // Q rows, STAGES key tiles, then the partial scores (f32)
  static constexpr size_t kSmem =
      (size_t)(kRows + STAGES * KEYS) * kLd * sizeof(bf16) +
      (size_t)kThreads * kNs * 4 * sizeof(float);
  static_assert(kDk % CG == 0 && kCols % 16 == 0 && KEYS % 16 == 0,
                "the warps must tile the reduction and the columns");
  static_assert(kRows * kChunks % kThreads == 0,
                "the Q copies must tile the threads");
};

using Decode = Shape<2, 4, kDecodeKeys, 3>;
static_assert(Decode::kRows == kDecodeHeads, "one lane's heads a block");

// A lane's latent rows through its block-table row; in decode, position
// `last` is the new row, read from latent_new and never from the pool.
struct Rows {
  const bf16* pool;
  const int* table;     // this lane's page ids
  int page;
  int shift;            // log2(page) for a power of two, else -1
  int last;             // -1: none
  const bf16* fresh;    // the new row
  __device__ __forceinline__ const bf16* row(int t) const {
    if (t == last) return fresh;
    const int j = shift >= 0 ? t >> shift : t / page;
    const int o = shift >= 0 ? t & (page - 1) : t % page;
    return pool + ((int64_t)__ldg(table + j) * page + o) * kW;
  }
};

__host__ __device__ inline int page_shift(int page) {
  for (int s = 0; s < 31; ++s)
    if ((1 << s) == page) return s;
  return -1;
}

// What the walk hands the epilogue: per thread, its two rows' max (log2
// units, 0 when the row saw no key) and denominator, summed over the quad,
// and the unnormalised accumulator of its columns.
template <class Sh>
struct Result {
  float acc[Sh::kNo][4];
  float base[2];
  float l[2];
};

// Walk keys [lo, hi) for the block's kRows query rows at q (kW apart; rows
// at or past n_rows zero-filled). kCausal: the block's row r is the
// call's row row0 + r, token (row0 + r) / H, and sees keys t <= q_pos0 +
// (row0 + r) / H. kQReg: hold the warp's Q fragments in registers.
template <class Sh, bool kCausal, bool kQReg>
__device__ __forceinline__ void walk(const Rows& keys, const bf16* q,
                                     int n_rows, int lo, int hi, int q_pos0,
                                     int row0, int H, float f,
                                     Result<Sh>& res) {
  constexpr int KEYS = Sh::KEYS, STAGES = Sh::STAGES, kNs = Sh::kNs;
  constexpr int kNo = Sh::kNo, kSteps = Sh::kSteps, CG = Sh::CG;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + Sh::kRows * kLd;
  float* xs = reinterpret_cast<float*>(kv_s + STAGES * KEYS * kLd);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = warp / CG, cg = warp % CG;
  const int k0 = cg * kSteps;                 // the warp's first k-step

#pragma unroll
  for (int n = 0; n < Sh::kRows * kChunks / kThreads; ++n) {
    const int c = tid + n * kThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r < n_rows;
    cp_async16(smem_u32(q_s + r * kLd + ch * 8),
               q + (ok ? (int64_t)r * kW + ch * 8 : 0), ok);
  }
  cp_async_commit();

  constexpr int kCopies = KEYS * kChunks;
  auto load_tile = [&](int t0, int st) {
    bf16* ks = kv_s + st * KEYS * kLd;
#pragma unroll
    for (int n = 0; n < (kCopies + kThreads - 1) / kThreads; ++n) {
      const int c = tid + n * kThreads;
      if (kCopies % kThreads != 0 && c >= kCopies) break;
      const int r = c / kChunks, ch = c % kChunks;
      const int t = t0 + r;
      const bool ok = t < hi;
      const bf16* src = ok ? keys.row(t) + ch * 8 : keys.pool;
      cp_async16(smem_u32(ks + r * kLd + ch * 8), src, ok);
    }
  };

  const int n_tiles = hi > lo ? (hi - lo + KEYS - 1) / KEYS : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(lo + st * KEYS, st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();                // Q has landed
  __syncthreads();

  const int arow = rg * 16 + (lane % 16);     // this lane's A-fragment row
  const int acol = (lane / 16) * 8;
  uint32_t qf[kQReg ? kSteps : 1][4];
  if (kQReg) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldsm_x4(qf[kk], smem_u32(q_s + arow * kLd + (k0 + kk) * 16 + acol));
  }

  // this thread's two rows: 16 rg + lane / 4 and 8 further
  int qpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    qpos[j] = q_pos0 + (row0 + rg * 16 + lane / 4 + 8 * j) / H;
  const int q_first = q_pos0 + row0 / H;      // the block's first row's

  float(&acc)[kNo][4] = res.acc;
#pragma unroll
  for (int n = 0; n < kNo; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float base[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = lo + j * KEYS;
    cp_async_wait<STAGES - 2>();              // tile j has landed,
    __syncthreads();                          // and tile j - 1 is done with
    if (j + STAGES - 1 < n_tiles)             // its stage and the partials
      load_tile(t0 + (STAGES - 1) * KEYS, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* ks = kv_s + (j % STAGES) * KEYS * kLd;

    // the warp's partial S over its k-steps: 16 rows x KEYS keys
    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a[4];
      if (kQReg) {
        a[0] = qf[kQReg ? kk : 0][0];
        a[1] = qf[kQReg ? kk : 0][1];
        a[2] = qf[kQReg ? kk : 0][2];
        a[3] = qf[kQReg ? kk : 0][3];
      } else {
        ldsm_x4(a, smem_u32(q_s + arow * kLd + (k0 + kk) * 16 + acol));
      }
#pragma unroll
      for (int np = 0; np < kNs / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane / 16) * 8 + (lane % 8);
        const int col = (k0 + kk) * 16 + ((lane / 8) % 2) * 8;
        ldsm_x4(b, smem_u32(ks + key * kLd + col));
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // the group's S: its CG partials summed in warp order
    float* mine = xs + (size_t)warp * kNs * 4 * 32;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
    __syncthreads();
    if (CG == 2) {                 // p0 + p1 == p1 + p0, bit for bit
      const float* part = xs + (size_t)(rg * CG + 1 - cg) * kNs * 4 * 32;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += part[(n * 4 + e) * 32 + lane];
    } else {
      float tot[kNs][4];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const float* part = xs + (size_t)(rg * CG + c) * kNs * 4 * 32;
#pragma unroll
        for (int n = 0; n < kNs; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = c == cg ? s[n][e] : part[(n * 4 + e) * 32 + lane];
            tot[n][e] = c == 0 ? v : tot[n][e] + v;
          }
      }
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = tot[n][e];
    }

    // the mask (edge tiles only)
    const bool full = t0 + KEYS <= hi && (!kCausal || t0 + KEYS - 1 <= q_first);
    if (!full) {
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + n * 8 + 2 * (lane % 4) + (e & 1);
          const bool ok = t < hi && (!kCausal || t <= qpos[e / 2]);
          if (!ok) s[n][e] = -INFINITY;
        }
    }

    // online softmax; the accumulator is rescaled once a tile, and not at
    // all when no row max of the warp moved (a factor of 1 is exact)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      base[r] = m_new == -INFINITY ? 0.f : m_new * f;  // no key seen yet
      alpha[r] = exp2f(fmaf(m[r], f, -base[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    if (!__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < kNo; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(fmaf(s[n][e], f, -base[e / 2]));
        l[e / 2] += pe;
        s[n][e] = pe;
      }

    // O += P V over the warp's columns, P from registers as bf16 A-fragments
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kNo / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        const int col = cg * Sh::kCols + dp * 16 + (lane / 16) * 8;
        ldsm_x4_t(b, smem_u32(ks + key * kLd + col));
        mma16816(acc[2 * dp], a, b[0], b[1]);
        mma16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(kFull, lr, 1);
    lr += __shfl_xor_sync(kFull, lr, 2);
    res.l[r] = lr;
    res.base[r] = base[r];
  }
}

__global__ void __launch_bounds__(Decode::kThreads, 1)
paged_mla_decode_split(const bf16* __restrict__ q,      // (B, H, kW)
                       bf16* pool,                        // (P, page, kW)
                       const int* __restrict__ table,     // (B, maxp)
                       const int* __restrict__ lengths,   // (B,)
                       const bf16* __restrict__ latent_new,   // (B, kW)
                       const int* __restrict__ write_pages,   // (B,)
                       const int* __restrict__ write_offsets,
                       float* __restrict__ ws_acc,        // (B, S, H, kR)
                       float2* __restrict__ ws_ml,        // (B, S, H)
                       int maxp, int page, int per, int S, float f) {
  const int b = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x;
  const bf16* fresh = latent_new + (int64_t)b * kW;
  if (s == 0 && tid < kChunks) {     // the fused write of the new row
    const int64_t dst =
        ((int64_t)write_pages[b] * page + write_offsets[b]) * kW + tid * 8;
    *reinterpret_cast<uint4*>(pool + dst) =
        *reinterpret_cast<const uint4*>(fresh + tid * 8);
  }
  const int length = min(lengths[b], maxp * page);
  const int lo = s * per, hi = min(length, lo + per);
  const int64_t part = (int64_t)b * S + s;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = warp / Decode::CG, cg = warp % Decode::CG;
  if (lo >= hi) {                    // past the lane's length
    if (tid < kDecodeHeads)
      ws_ml[part * kDecodeHeads + tid] = make_float2(kEmpty, 0.f);
    return;
  }
  const Rows keys{pool, table + (int64_t)b * maxp, page, page_shift(page),
                  lengths[b] - 1, fresh};
  Result<Decode> res;
  walk<Decode, false, true>(keys, q + (int64_t)b * kDecodeHeads * kW,
                            kDecodeHeads, lo, hi, 0, 0, kDecodeHeads, f,
                            res);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = rg * 16 + lane / 4 + 8 * r;
    float* out = ws_acc + (part * kDecodeHeads + head) * kR +
                 cg * Decode::kCols + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < Decode::kNo; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(res.acc[n][2 * r], res.acc[n][2 * r + 1]);
    if (cg == 0 && lane % 4 == 0)
      ws_ml[part * kDecodeHeads + head] = make_float2(res.base[r], res.l[r]);
  }
}

// One block of kR / 4 threads per (lane, head): o = sum_s 2^(m_s - M) acc_s
// / sum_s 2^(m_s - M) l_s over the splits that hold a key, M = max_s m_s.
__global__ void __launch_bounds__(kR / 4)
paged_mla_decode_combine(const float* __restrict__ ws_acc,
                         const float2* __restrict__ ws_ml,
                         bf16* __restrict__ o,            // (B, H, kR)
                         int S) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int H = gridDim.y;
  float top = kEmpty;
  for (int s = 0; s < S; ++s)
    top = fmaxf(top, ws_ml[((int64_t)b * S + s) * H + h].x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s = 0; s < S; ++s) {
    const int64_t part = (int64_t)b * S + s;
    const float2 ml = ws_ml[part * H + h];
    if (ml.x == kEmpty) continue;
    const float w = exp2f(ml.x - top);
    den += w * ml.y;
    const float4 a = *reinterpret_cast<const float4*>(
        ws_acc + (part * H + h) * kR + tid * 4);
    acc.x += w * a.x;
    acc.y += w * a.y;
    acc.z += w * a.z;
    acc.w += w * a.w;
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  __nv_bfloat162* out =
      reinterpret_cast<__nv_bfloat162*>(o + ((int64_t)b * H + h) * kR) +
      tid * 2;
  out[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  out[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

// The prefill's block: 64 rows (one wgmma row tile), KEYS-key tiles
// through a ring of STAGES, 384 threads (2 consumer warpgroups, then the
// producer's). Its shared memory, in bytes from a 1,024-aligned base: Q (9
// column blocks of 64 rows x 128 B, as its TMA boxes land), STAGES latent
// tiles (9 column blocks of KEYS rows x 128 B each), the bf16 P tile
// (64-byte rows, swizzled K-major), the published row maxima and rescale
// factors (two slots), the two warpgroups' denominators, then the
// mbarriers, 227,912 bytes with the alignment slack.
struct Prefill {
  static constexpr int KEYS = kPrefillKeys, STAGES = 4;
  static constexpr int kRows = kPrefillRows;
  static constexpr int kThreads = 384;
  static constexpr int kBlocks = kW / 64;      // 128-byte column blocks
  static constexpr int kQBlock = kRows * 128;
  static constexpr int kKBlock = KEYS * 128;
  static constexpr int kNs = KEYS / 2;         // score registers a thread
  static constexpr int kPRow = KEYS * 2;       // bytes of a P row
  static constexpr int kOffTiles = kBlocks * kQBlock;
  static constexpr int kOffP = kOffTiles + STAGES * kBlocks * kKBlock;
  static constexpr int kOffM = kOffP + kRows * kPRow;
  static constexpr int kOffA = kOffM + 2 * kRows * 4;
  static constexpr int kOffL = kOffA + 2 * kRows * 4;
  static constexpr int kOffBar = kOffL + 2 * kRows * 4;
  static constexpr size_t kSmem = kOffBar + (2 * STAGES + 1) * 8 + 1024;
  static_assert(kRows == 64 && KEYS == 32, "one wgmma row tile; P rows of "
                "64 bytes");
  static_assert(STAGES % 2 == 0, "a warpgroup's tiles keep their stages");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// Named barriers (0 is __syncthreads): consumer w publishes its tile's row
// maxima on kBarM + w and its P tile on kBarP + w (its 128 threads arrive,
// the partner's 128 sync); kBarWG + w spans warpgroup w alone; kBarEnd
// both consumers.
constexpr int kBarM = 1, kBarP = 3, kBarWG = 5, kBarEnd = 7;

// The 16-byte chunk `c` of P row `r` (64-byte swizzle), as wgmma reads it.
__device__ __forceinline__ int p_chunk(int r, int c) {
  return c ^ ((r >> 1) & 3);
}

__global__ void __launch_bounds__(Prefill::kThreads, 1)
paged_mla_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap pmap,
                         const int* __restrict__ table,  // (B, Np)
                         const int* __restrict__ kv_len,     // (B,)
                         const int* __restrict__ q_offset,   // (B,)
                         bf16* __restrict__ o,           // (B, Sq, H, kR)
                         int Sq, int H, int Np, int page, int box, float f) {
  using Sh = Prefill;
  constexpr int KEYS = Sh::KEYS, STAGES = Sh::STAGES, kNs = Sh::kNs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = sm;
  unsigned char* tiles = sm + Sh::kOffTiles;
  unsigned char* p_s = sm + Sh::kOffP;
  float* s_max = reinterpret_cast<float*>(sm + Sh::kOffM);     // [2][64]
  float* s_alpha = reinterpret_cast<float*>(sm + Sh::kOffA);   // [2][64]
  float* s_l = reinterpret_cast<float*>(sm + Sh::kOffL);       // [2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sh::kOffBar);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int blk = blockIdx.x, b = blockIdx.y;
  const int row0 = blk * Sh::kRows;            // (token, head) rows
  const int n_all = Sq * H;
  const int n_rows = min(Sh::kRows, n_all - row0);
  const int tok_last = min((row0 + Sh::kRows - 1) / H, Sq - 1);
  const int q0 = q_offset[b];
  const int hi = max(0, min(min(kv_len[b], q0 + tok_last + 1), Np * page));
  const int n = (hi + KEYS - 1) / KEYS;        // key tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);           // each consumer warp
    }
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer: Q once, then each tile's pages, box rows at a time
    sm90::regs_dec<40>();
    if (threadIdx.x != 256) return;
    sm90::tma_prefetch_map(&qmap);
    sm90::tma_prefetch_map(&pmap);
    sm90::mbar_expect_tx(q_bar, Sh::kOffTiles);
    for (int c = 0; c < Sh::kBlocks; ++c)
      sm90::tma_load_2d(q_s + c * Sh::kQBlock, &qmap, q_bar, c * 64,
                        b * n_all + row0);
    const int* pages = table + (int64_t)b * Np;
    for (int j = 0; j < n; ++j) {
      const int st = j % STAGES, round = j / STAGES;
      if (round > 0) sm90::mbar_wait(&empty[st], (round - 1) & 1);
      const int t0 = j * KEYS;
      const int segs = (min(KEYS, hi - t0) + box - 1) / box;
      sm90::mbar_expect_tx(&full[st], segs * box * kW * 2);
      unsigned char* tile = tiles + st * Sh::kBlocks * Sh::kKBlock;
      for (int k = 0; k < segs; ++k) {
        const int t = t0 + k * box;
        const int row = __ldg(pages + t / page) * page + t % page;
        for (int c = 0; c < Sh::kBlocks; ++c)
          sm90::tma_load_2d(tile + c * Sh::kKBlock + k * box * 128, &pmap,
                            &full[st], c * 64, row);
      }
    }
    return;
  }

  // a consumer: warpgroup w scores tiles j = w, w + 2, ... and owns output
  // columns [256 w, 256 w + 256)
  sm90::regs_inc<232>();
  const int w = warp / 4, wl = warp % 4, tid = threadIdx.x % 128;
  const int r0 = wl * 16 + lane / 4;           // this thread's rows r0, r0 + 8
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (row0 + r0 + 8 * i) / H;
  const int q_first = q0 + row0 / H;           // the block's first row's

  const uint64_t q_desc =
      sm90::desc(sm90::smem_u32(q_s), 16, 1024, sm90::kSwizzle128);
  const uint64_t p_desc =
      sm90::desc(sm90::smem_u32(p_s), 16, 512, sm90::kSwizzle64);
  auto tile_at = [&](int j) {
    return tiles + (j % STAGES) * Sh::kBlocks * Sh::kKBlock;
  };
  auto v_desc = [&](int j) {     // this warpgroup's 256 value columns
    return sm90::desc(sm90::smem_u32(tile_at(j) + 4 * w * Sh::kKBlock),
                      Sh::kKBlock, 1024, sm90::kSwizzle128);
  };
  auto release = [&](int j) {    // this warp is done with tile j
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[j % STAGES]);
  };

  // the accumulator is first written by a product (scale_d 0), never by
  // other instructions, so no product waits on them
  float acc[128];
  int live = 0;                  // acc holds a sum
  float l[2] = {0.f, 0.f};
  int held = -1;                 // own tile whose P.V is not yet released
  sm90::mbar_wait(q_bar, 0);

  for (int j = w; j <= n; j += 2) {
    const bool own = j < n;
    const int t0 = j * KEYS;
    float s[kNs];
    if (own) {
      // S = Q K^T over all 576 values, one product, issued now
      unsigned char* tile = tile_at(j);
      sm90::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
      if (t0 + KEYS > hi) {      // rows past the range: zeros, never stale
        const int v = hi - t0, per = (KEYS - v) * 8;
        for (int i = tid; i < Sh::kBlocks * per; i += 128)
          *reinterpret_cast<uint4*>(tile + (i / per) * Sh::kKBlock +
                                    v * 128 + (i % per) * 16) =
              make_uint4(0, 0, 0, 0);
        sm90::fence_proxy_async();
        sm90::bar_sync(kBarWG + w, 128);
      }
      const uint64_t k_desc =
          sm90::desc(sm90::smem_u32(tile), 16, 1024, sm90::kSwizzle128);
      sm90::fence_regs(s);
      sm90::mma_fence();
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        const uint32_t qo = (kk / 4) * Sh::kQBlock + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * Sh::kKBlock + (kk % 4) * 32;
        sm90::mma_m64n32k16_ss(s, sm90::desc_add(q_desc, qo),
                               sm90::desc_add(k_desc, ko), kk > 0);
      }
      sm90::mma_commit();
    }
    // the partner's tile j - 1: its row maxima and rescale factors
    float m_prev[2] = {-INFINITY, -INFINITY}, a_prev[2] = {1.f, 1.f};
    if (j >= 1) {
      sm90::bar_sync(kBarM + 1 - w, 256);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_prev[i] = s_max[((j - 1) & 1) * 64 + r0 + 8 * i];
        a_prev[i] = s_alpha[((j - 1) & 1) * 64 + r0 + 8 * i];
      }
    }
    sm90::mma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(acc);
    if (held >= 0) release(held);
    held = -1;

    float alpha[2] = {1.f, 1.f};
    uint32_t pf[KEYS / 16][4];
    if (own) {
      // the mask (edge tiles only)
      const bool whole = t0 + KEYS <= hi && t0 + KEYS - 1 <= q_first;
      if (!whole) {
#pragma unroll
        for (int i = 0; i < kNs; ++i) {
          const int t = t0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
          if (!(t < hi && t <= qpos[(i / 2) & 1])) s[i] = -INFINITY;
        }
      }
      // online softmax from the partner's maxima: publish this tile's
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kNs; i += 4)
          mx = fmaxf(mx, fmaxf(s[i + 2 * r], s[i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m_prev[r], mx);
        base[r] = m_new == -INFINITY ? 0.f : m_new * f;  // no key seen yet
        alpha[r] = exp2f(fmaf(m_prev[r], f, -base[r]));
        if (lane % 4 == 0) {
          s_max[(j & 1) * 64 + r0 + 8 * r] = m_new;
          s_alpha[(j & 1) * 64 + r0 + 8 * r] = alpha[r];
        }
        l[r] = l[r] * a_prev[r] * alpha[r];
      }
      sm90::bar_arrive(kBarM + w, 256);
#pragma unroll
      for (int i = 0; i < kNs; ++i) {
        const float pe = exp2f(fmaf(s[i], f, -base[(i / 2) & 1]));
        l[(i / 2) & 1] += pe;
        s[i] = pe;
      }
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          pf[kk][h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
    } else {
      l[0] *= a_prev[0];
      l[1] *= a_prev[1];
    }

    if (j >= 1) {
      // O = O a_{j-1} + P_{j-1} V_{j-1}, the partner's P from shared memory
      sm90::bar_sync(kBarP + 1 - w, 256);
      if (live && !__all_sync(kFull, a_prev[0] == 1.f && a_prev[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= a_prev[(i / 2) & 1];
      }
      const uint64_t vd = v_desc(j - 1);
      sm90::fence_regs(acc);
      sm90::mma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::mma_m64n256k16_ss_t(acc, sm90::desc_add(p_desc, kk * 32),
                                  sm90::desc_add(vd, kk * 2048),
                                  kk > 0 || live);
      sm90::mma_commit();
      live = 1;
      sm90::mma_wait<0>();
      sm90::fence_regs(acc);
      release(j - 1);
    }
    if (own) {
      // publish P_j (bf16) once this warpgroup is done with P_{j-1}
      sm90::bar_sync(kBarWG + w, 128);
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = r0 + 8 * (h & 1), c = 2 * kk + h / 2;
          *reinterpret_cast<uint32_t*>(p_s + r * Sh::kPRow +
                                       p_chunk(r, c) * 16 +
                                       (lane % 4) * 4) = pf[kk][h];
        }
      sm90::fence_proxy_async();
      sm90::bar_arrive(kBarP + w, 256);
      // O = O a_j + P_j V_j, P from registers
      if (live && !__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i / 2) & 1];
      }
      const uint64_t vd = v_desc(j);
      sm90::fence_regs(acc);
      sm90::fence_regs(reinterpret_cast<uint32_t(&)[KEYS / 4]>(pf));
      sm90::mma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::mma_m64n256k16_rs_t(acc, pf[kk],
                                  sm90::desc_add(vd, kk * 2048),
                                  kk > 0 || live);
      sm90::mma_commit();
      live = 1;
      held = j;
    }
  }
  sm90::mma_wait<0>();
  sm90::fence_regs(acc);
  if (!live) {                   // no key: the rows are zero
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  }

  // the denominators: a quad's partial sums, then both warpgroups'
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (lane % 4 == 0) s_l[w * 64 + r0 + 8 * r] = l[r];
  }
  sm90::bar_sync(kBarEnd, 256);
  const int64_t qb = (int64_t)b * n_all + row0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n_rows) continue;
    const float inv = 1.f / fmaxf(s_l[row] + s_l[64 + row], 1e-30f);
    bf16* op = o + (qb + row) * kR + 256 * w + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < 32; ++c)
      *reinterpret_cast<__nv_bfloat162*>(op + c * 8) = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
  }
}

template <class Kernel>
int allow_smem(Kernel k, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of `rows` latent rows (kW bf16 each) from `base`, in boxes of 64
// columns by `box` rows, 128-byte swizzled as wgmma reads them.
bool latent_map(CUtensorMap* map, const void* base, uint64_t rows,
                uint32_t box) {
  const EncodeTiled encode = encoder();
  const cuuint64_t dims[2] = {kW, rows};
  const cuuint64_t strides[1] = {kW * sizeof(bf16)};
  const cuuint32_t boxes[2] = {64, box};
  const cuuint32_t steps[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, boxes, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// The widths and block shapes the kernels are built for (the wrapper
// checks its calls against them): rank, rope width, decode heads, decode
// keys a tile, prefill rows a block, prefill keys a tile.
int paged_mla_shape(int i) {
  const int v[6] = {kR, kDr, kDecodeHeads, kDecodeKeys, kPrefillRows,
                    kPrefillKeys};
  return i >= 0 && i < 6 ? v[i] : -1;
}

// The prefill kernel's dynamic shared memory a block, in bytes.
int paged_mla_prefill_smem() { return (int)Prefill::kSmem; }

// Decode: q (B, 32, 576), pool (P, page, 576), table (B, maxp), lengths,
// latent_new (B, 576), write_pages/write_offsets (B,), workspaces ws_acc
// (B, S, 32, 512) f32 and ws_ml (B, S, 32, 2) f32, o (B, 32, 512); each
// split covers `per` keys. Returns the CUDA error of the launches.
int paged_mla_decode(const void* q, void* pool, const void* table,
                     const void* lengths, const void* latent_new,
                     const void* write_pages, const void* write_offsets,
                     void* ws_acc, void* ws_ml, void* o, int B, int maxp,
                     int page, int per, int S, float scale, void* stream) {
  static const int attr =
      allow_smem(paged_mla_decode_split, Decode::kSmem);
  if (attr != 0) return attr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_mla_decode_split<<<dim3(B, S), Decode::kThreads, Decode::kSmem,
                           st>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(pool),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<const bf16*>(latent_new),
      static_cast<const int*>(write_pages),
      static_cast<const int*>(write_offsets), static_cast<float*>(ws_acc),
      static_cast<float2*>(ws_ml), maxp, page, per, S, scale * kLog2e);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_mla_decode_combine<<<dim3(B, kDecodeHeads), kR / 4, 0, st>>>(
      static_cast<const float*>(ws_acc), static_cast<const float2*>(ws_ml),
      static_cast<bf16*>(o), S);
  return (int)cudaGetLastError();
}

// Prefill: q (B, Sq, H, 576), pool (P, page, 576), table (B, Np), kv_len
// and q_offset (B,), o (B, Sq, H, 512). The page size is a multiple of 8
// that divides the tile's keys or is divided by them (a TMA box holds one
// page's rows of a tile). Returns the CUDA error of the launch,
// cudaErrorInvalidValue for a page size outside that rule, or
// cudaErrorNotSupported when the tensor maps cannot be made.
int paged_mla_prefill(const void* q, const void* pool, const void* table,
                      const void* kv_len, const void* q_offset, void* o,
                      int B, int Sq, int H, int P, int Np, int page,
                      float scale, void* stream) {
  using Sh = Prefill;
  if (page % 8 != 0 || (Sh::KEYS % page != 0 && page % Sh::KEYS != 0))
    return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem(paged_mla_prefill_kernel, Sh::kSmem);
  if (attr != 0) return attr;
  const int box = page < Sh::KEYS ? page : Sh::KEYS;
  CUtensorMap qmap, pmap;
  if (!latent_map(&qmap, q, (uint64_t)B * Sq * H, Sh::kRows) ||
      !latent_map(&pmap, pool, (uint64_t)P * page, box))
    return (int)cudaErrorNotSupported;
  const dim3 grid((Sq * H + Sh::kRows - 1) / Sh::kRows, B);
  paged_mla_prefill_kernel<<<grid, Sh::kThreads, Sh::kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      qmap, pmap, static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
      static_cast<bf16*>(o), Sq, H, Np, page, box, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // extern "C"
