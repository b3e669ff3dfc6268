// The attention tile of the TPU kernels' exp2 form, kept on chip, shared by
// the standalone attention (csrc/flash_attention.cu, row 14), the bf16
// layer kernels (csrc/bf16_layer.cu, rows 1 and 2), the trainable
// attention sub-layer's forward (csrc/fused_attention.cu, row 12) and, with
// an f32 output, the int8 layer kernels (csrc/int8_layer.cu, rows 5, 6, 8
// and 9).  Per (head, image):
//
//   q' = q (the layers fold log2(e)/sqrt(hd) into Wq; row 14 scales q on
//        load: bf16(f32(q) * scale), the TPU kernel's order)
//   p  = bf16(exp2(clip(q'.k, -100, 80))), keys at or past valid_len p = 0
//   o  = (p v) / sum(p)          f32 sums of the rounded p, an exact divide,
//                                stored bf16 (rounded) or f32; the int8
//                                layers' fast form (FAST, f32 output only)
//                                multiplies by ptt::recip_bf16(sum(p))
//
// With no max subtraction there is no running max to rescale by, so the
// softmax is one pass over the keys, 16 at a time, with nothing carried
// between key steps but the output accumulator and the row sums.
//
// What bounds it on the H100: at the use_flash tower's [128, 197, 12, 64]
// it reads q, k, v and writes o once, 155 MB (46 us at 3.35 TB/s), for
// 15.3 GFLOP of products (15 us at the bf16 peak): bytes.  At CLIP
// ViT-L/14 @336's [32, 577, 16, 64] the same 151 MB (45 us) meet 43.6
// GFLOP (44 us) and 170 M exp2 (about 40 us on the SMs' special function
// units): bytes, products and exponentials about even.  So the design
// reads every K and V row from device memory once per (head, image),
// keeps the tensor cores fed from shared memory, and keeps enough warps
// on an SM that one warp's exponentials overlap another's products.  The
// head width HD is a template argument, every multiple of 16 from 16 to
// 128; a real width hd that is a multiple of 8 runs on the next instance
// up (72 on 80): q words and K/V columns past hd are zero (never read from
// the next head's columns of a strided qkv view), add exact zeros to every
// score, and only hd columns are stored.  The words below are for 64:
//   * where K and V fit the ring (RING keys, ~56 KB: 224 keys at 64, so
//     ViT-B/16's 208), one block of 4 warps per (head, image) loads them
//     once into shared memory with 16-byte cp.async from the strided q/k/v
//     views (no copy or transpose; chunks past hd and rows past valid_len
//     zero-filled by a source size of 0, as the TPU kernel zeroes V's pad
//     rows), 53 KB at S 208, four blocks an SM, and the warps walk the
//     query tiles against them;
//   * past it (the streamed path, stream_kernel), a block takes one pass
//     of 64 query rows of one (head, image), a 16-row tile a warp, and the
//     passes of a (head, image) are the grid's fastest axis, so that they
//     run side by side and its K and V come from device memory once and
//     from L2 for the other passes.  One producer warp streams K and V in
//     stages of 64 keys through a ring of 2-3 stages with TMA
//     (cp.async.bulk.tensor over a 4-D map of the strided view: columns of
//     extent hd, heads, rows of extent valid_len, images, so that the
//     copy's out-of-bounds fill gives the zero columns and pad rows, and no
//     other head's columns are read), signalled by a full and an empty
//     mbarrier a stage; the 4 consumer warps never wait on a block
//     barrier.  A row of K or V lands in parts of 64, 32 and 16 columns
//     (80 = 64 + 16), each with TMA's swizzle of its width (128, 64 or 32
//     bytes), which ldmatrix reads without bank conflicts.  A warp takes
//     64 keys a step up to width 80 (16 past it): their scores first, 8
//     independent product chains, then the p.v products 16 keys at a time
//     in key order; and it takes 2^x on ex2.approx.ftz alone
//     (exp2_score).  Three such blocks an SM (128 registers a thread) ran
//     faster on the H100 than blocks of 8 warps (half the L2 reads of K
//     and V a query row, as a cluster of two sharing its loads would
//     give), two tiles a warp, or a producer warpgroup that lends its
//     registers to the consumers (setmaxnreg), each tried; reading K and V
//     from device memory once a pass instead of once a (head, image) had
//     cost 12% of the parent's time.
//     Row 8's cooperative launch streams through its own two-stage
//     cp.async ring (flash_tile below).
//     Only the output accumulator and the row sums carry from key block to
//     key block (there is no running max to rescale), so a query row's
//     16-key steps, and every product into its accumulators, run in the
//     same order on every path: the same bits;
//   * in the cp.async paths, a row of 2, 4, 8 or 16 chunks of 16 bytes is
//     XOR-swizzled by the row, so ldmatrix reads 8 rows without bank
//     conflicts and nothing is padded; a row of 6, 10, 12 or 14 chunks (HD
//     48, 80, 96, 112) has a padded stride of one more chunk, an odd
//     count, so 8 rows at one chunk fall in 8 different 16-byte bank
//     groups;
//   * a warp's q fragments come straight from device memory into
//     registers (row 14 scales them there), its scores for 16 keys stay in
//     registers (mma.sync m16n8k16, bf16 in, f32 out), are rounded to bf16
//     in registers and, since the accumulator layout of m16n8 is the
//     A-fragment layout of m16n8k16, feed the p.v product directly; V's B
//     fragments come from ldmatrix.trans;
//   * the denominator rides the tensor cores as it rides the TPU's MXU:
//     one more m16n8k16 of p against a block of ones gives each row's f32
//     sum of its rounded p; the key mask runs only on the step that holds
//     valid_len;
//   * the output is divided exactly (FAST: times the bf16 reciprocal),
//     rounded, and stored from registers.
// What bounds it, measured: at [32, 577, 16, 64] the streamed tile runs
// at about a quarter of the larger of its byte and product bounds: a
// warp's chain of products, exponentials and products waits on itself,
// and more warps an SM would need fewer registers a thread.  wgmma stays
// out: its chain of products is not known to round as mma.sync's does,
// and every path keeps the bits of the others.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace ptt_flash {

using ptt::bf16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float SCORE_LO = -100.0f, SCORE_HI = 80.0f;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0
constexpr int MAX_HEAD_DIM = 128;
// the ring's bytes at most: four blocks of 4 warps an SM
constexpr int RING_BYTES = 57344;

// The shared-memory layout of the tile at head width HD (a multiple of 16
// up to MAX_HEAD_DIM): LD elements a row, and the ring of STAGES stages
// of KB keys (RING keys of K and V, a multiple of 32, within RING_BYTES).
template <int HD>
struct Layout {
  static_assert(HD % 16 == 0 && HD <= MAX_HEAD_DIM, "an instance width");
  static constexpr int CH = HD / 8;                    // 16-byte chunks a row
  static constexpr bool POW2 = (CH & (CH - 1)) == 0;   // XOR-swizzled
  static constexpr int LD = POW2 ? HD : HD + 8;        // row stride
  static constexpr int STAGES = 2;
  static constexpr int RING =
      RING_BYTES / (2 * LD * (int)sizeof(bf16)) / 32 * 32;
  static constexpr int KB = RING / STAGES;
};

// the instance a real head width hd runs on (the next multiple of 16), or
// 0 where there is none: hd must be a multiple of 8 up to MAX_HEAD_DIM
inline int tile_width(int hd) {
  return hd > 0 && hd % 8 == 0 && hd <= MAX_HEAD_DIM ? (hd + 15) / 16 * 16
                                                     : 0;
}

// K and V of min(Sp, RING) rows at instance width HD
template <int HD>
inline size_t tile_smem(int Sp) {
  using L = Layout<HD>;
  return 2 * (size_t)(Sp < L::RING ? Sp : L::RING) * L::LD * sizeof(bf16);
}

// element offset of the 16-byte chunk c (0 .. HD/8 - 1) of row r: at a
// power-of-two chunk count the chunks are swizzled by the row, so that at
// HD 64 rows r..r+7 put any one chunk in 8 different bank groups (at 128
// too; at 32 and 16, 4 and 2); otherwise the row stride is one chunk more,
// an odd count of chunks, which does the same
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  using L = Layout<HD>;
  if constexpr (L::POW2)
    return r * HD + ((c ^ (r & (L::CH - 1))) << 3);
  else
    return r * L::LD + (c << 3);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

// d += A(16x16, row) . B(16x8, col), bf16 in, f32 accumulation.  Lane l,
// g = l / 4, t = l % 4: a = A[g][2t..], A[g+8][2t..], A[g][8+2t..],
// A[g+8][8+2t..]; b = B[2t..][g], B[8+2t..][g]; d[e] = D[g + 8(e/2)][2t + e%2].
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^clip(s, -100, 80), the scores' exponential.  exp2f is ex2.approx.f32,
// which on sm_90 wraps the special function unit's ex2 in a guard for
// results below 2^-126; RAW takes ex2.approx.ftz.f32 alone, the same
// value wherever the guard does nothing, as on every clamped score.  The
// streamed paths take RAW (two instructions fewer a score); the resident
// ones keep exp2f's code.
template <bool RAW>
__device__ __forceinline__ float exp2_score(float s) {
  const float x = fminf(fmaxf(s, SCORE_LO), SCORE_HI);
  if constexpr (RAW) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K and V rows k0 .. k0 + n - 1 of a head into rows r0 .. of the ring,
// with 16-byte cp.async by every thread of NWARPS warps, committed as one
// group; rows past valid_len and chunks past the real width hd are
// zero-filled (their source is not read)
template <int HD, int NWARPS>
__device__ __forceinline__ void load_keys(bf16* Ks, bf16* Vs,
                                          const bf16* __restrict__ kb,
                                          const bf16* __restrict__ vb,
                                          int kv_row, int k0, int n, int r0,
                                          int valid_len, int hd) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < n * CH; c += 32 * NWARPS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = k0 + r < valid_len && ch * 8 < hd;
    const size_t src = (size_t)(k0 + r) * kv_row + ch * 8;
    ptt::cp_async16(&Ks[swz<HD>(r0 + r, ch)], ok ? kb + src : kb, ok);
    ptt::cp_async16(&Vs[swz<HD>(r0 + r, ch)], ok ? vb + src : vb, ok);
  }
  ptt::cp_async_commit();
}

// A warp's q fragments for query rows r0 (its lane's) and r0 + 8: zero
// past n_q and past hd; SCALE_Q: times `scale` in f32, rounded to bf16.
// hd is HD or HD - 8 (tile_width), so only the last 8 columns can be
// past it: one test a call, where a test a word slowed row 14 by 45% on
// the H100.
template <int HD, bool SCALE_Q>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4],
                                       const bf16* __restrict__ qb,
                                       int q_row, int r0, int n_q, int hd,
                                       float scale, int t) {
  const int r1 = r0 + 8;
  const bool full = hd == HD;
  auto q_word = [&](int r, int c) -> uint32_t {
    if (r >= n_q) return 0u;
    uint32_t w = *reinterpret_cast<const uint32_t*>(&qb[(size_t)r * q_row + c]);
    if constexpr (SCALE_Q) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w));
      w = pack_bf16(f.x * scale, f.y * scale);
    }
    return w;
  };
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = q_word(r0, c);
    qa[kk][1] = q_word(r1, c);
    const bool in = kk < HD / 16 - 1 || full;   // columns c + 8 below hd
    qa[kk][2] = in ? q_word(r0, c + 8) : 0u;
    qa[kk][3] = in ? q_word(r1, c + 8) : 0u;
  }
}

// The ring layouts: the element offset of the 16-byte chunk 2 kk + hi of
// row rb + lr, where rb is a multiple of 16 (a step's first row) and lr
// (0..15) the lane's row in it, so that the swizzle depends on lr alone
// and its part of the offset is the same at every step (kk, the 16-column
// step, is a constant once unrolled).  Swz: the cp.async paths' rows (swz
// above).  TmaRows<HD, ROWS>: a stage of ROWS rows as TMA writes it, in
// parts of 64 columns (HD / 64 of them), then one of 32 and one of 16
// where HD needs them, each part [ROWS][width] with TMA's swizzle of its
// row's bytes: the chunk XOR (row mod 8), (row / 2 mod 4) or (row / 4 mod
// 2) at 128, 64 or 32 bytes.  Every part starts on a 1,024-byte boundary
// (ROWS a multiple of 32), where the swizzle's address bits are the row's.
template <int HD>
struct Swz {
  static __device__ __forceinline__ int off(int rb, int lr, int kk, int hi) {
    using L = Layout<HD>;
    const int c = 2 * kk + hi;
    if constexpr (L::POW2)
      return rb * HD + (lr * HD + ((c ^ (lr & (L::CH - 1))) << 3));
    else
      return rb * L::LD + (lr * L::LD + (c << 3));
  }
};

template <int HD, int ROWS>
struct TmaRows {
  static_assert(ROWS % 32 == 0, "parts on 1,024-byte boundaries");
  static constexpr int N64 = HD / 64;                  // 64-column parts
  static constexpr bool P32 = HD % 64 >= 32;
  static constexpr bool P16 = HD % 32 == 16;
  static constexpr int NPARTS = N64 + P32 + P16;
  // part p's first column and width
  __host__ __device__ static constexpr int col(int p) {
    return p < N64 ? 64 * p : p == N64 && P32 ? 64 * N64 : 64 * N64 + 32 * P32;
  }
  __host__ __device__ static constexpr int width(int p) {
    return p < N64 ? 64 : p == N64 && P32 ? 32 : 16;
  }
  static __device__ __forceinline__ int off(int rb, int lr, int kk, int hi) {
    if (kk < 4 * N64)
      return ROWS * 64 * (kk >> 2) + rb * 64 +
             (lr * 64 + ((((kk & 3) << 1 | hi) ^ (lr & 7)) << 3));
    if (P32 && kk < 4 * N64 + 2)
      return ROWS * 64 * N64 + rb * 32 +
             (lr * 32 + ((((kk - 4 * N64) << 1 | hi) ^ ((lr >> 1) & 3)) << 3));
    return ROWS * (64 * N64 + 32 * P32) + rb * 16 +
           (lr * 16 + ((hi ^ ((lr >> 2) & 1)) << 3));
  }
};

// One step of KS keys (a multiple of 16) of a warp's query tile: the keys
// n..n+KS-1, held in rows r..r+KS-1 of the ring (layout Lay; r a multiple
// of 16), into its output accumulator and row sums.  The scores of all KS
// keys are taken first (KS/8 independent product chains), then the p.v
// products and the row sums 16 keys at a time in key order, so the tile's
// products, and the order they add into its accumulators, are those of
// KS 16: the same bits.  RAW: exp2_score's form.
template <int HD, class Lay = Swz<HD>, int KS = 16, bool RAW = false>
__device__ __forceinline__ void key_step(const uint32_t (&qa)[HD / 16][4],
                                         float (&oacc)[HD / 8][4],
                                         float (&lacc)[4], const bf16* Ks,
                                         const bf16* Vs, int n, int r,
                                         int valid_len, int lane) {
  static_assert(KS % 16 == 0, "16-key sub-steps");
  constexpr int U = KS / 16;
  const int t = lane & 3;
  float sacc[U][2][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[u][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t kf[4];
      ldmatrix_x4(kf, &Ks[Lay::off(r + 16 * u, (lane & 7) + ((lane >> 4) << 3),
                                   kk, (lane >> 3) & 1)]);
      mma_bf16(sacc[u][0], qa[kk], kf[0], kf[1]);
      mma_bf16(sacc[u][1], qa[kk], kf[2], kf[3]);
    }
  uint32_t pa[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[u][j][e] = exp2_score<RAW>(sacc[u][j][e]);
    const int nu = n + 16 * u;
    if (nu + 16 > valid_len) {         // a sub-step that holds pad keys
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nu + 8 * j + 2 * t + (e & 1) >= valid_len) sacc[u][j][e] = 0.0f;
    }
    // p, rounded, in the A-fragment layout of the p.v product
    pa[u][0] = pack_bf16(sacc[u][0][0], sacc[u][0][1]);
    pa[u][1] = pack_bf16(sacc[u][0][2], sacc[u][0][3]);
    pa[u][2] = pack_bf16(sacc[u][1][0], sacc[u][1][1]);
    pa[u][3] = pack_bf16(sacc[u][1][2], sacc[u][1][3]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t vf[4];
      ldmatrix_x4_trans(
          vf, &Vs[Lay::off(r + 16 * u, (lane & 7) + (((lane >> 3) & 1) << 3),
                           jj, lane >> 4)]);
      mma_bf16(oacc[2 * jj], pa[u], vf[0], vf[1]);
      mma_bf16(oacc[2 * jj + 1], pa[u], vf[2], vf[3]);
    }
    mma_bf16(lacc, pa[u], BF16_ONES, BF16_ONES);
  }
}

// The outputs of query rows r0 and r0 + 8 below n_q, their first hd
// columns: divided exactly (FAST: multiplied by the bf16 reciprocal of the
// row sum, the int8 layers' fast form), rounded to OutT
template <int HD, typename OutT, bool FAST = false>
__device__ __forceinline__ void store_o(OutT* __restrict__ ob, int o_row,
                                        const float (&oacc)[HD / 8][4],
                                        const float (&lacc)[4], int r0,
                                        int n_q, int hd, int t) {
  static_assert(!FAST || std::is_same<OutT, float>::value,
                "the fast form is the int8 layers' f32 output's");
  const int r1 = r0 + 8;
  const float d0 = FAST ? ptt::recip_bf16(lacc[0]) : lacc[0];
  const float d1 = FAST ? ptt::recip_bf16(lacc[2]) : lacc[2];
  auto norm = [](float o, float d) {
    return FAST ? __fmul_rn(o, d) : __fdiv_rn(o, d);
  };
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (j == HD / 8 - 1 && hd < HD) break;   // the last 8 columns, past hd
    if (r0 < n_q)
      ptt::store2(&ob[(size_t)r0 * o_row + c], norm(oacc[j][0], d0),
                  norm(oacc[j][1], d0));
    if (r1 < n_q)
      ptt::store2(&ob[(size_t)r1 * o_row + c], norm(oacc[j][2], d1),
                  norm(oacc[j][3], d1));
  }
}

// softmax(q' k^T) v for one (head h, image b): n_q query rows; q, k, v, o
// are row-major views with their own image and row strides (elements,
// even), the head's hd columns at h * hd (hd a multiple of 8, at most HD).
// K and V hold Sp (a multiple of 16) rows, of which those below valid_len
// are read.  SCALE_Q: q times `scale` in f32 on load, rounded to bf16.  o
// is bf16 or f32.  Every thread of the block (NWARPS warps) takes part;
// smem holds tile_smem<HD>(Sp) bytes.  STREAM (Sp > RING; row 8's
// cooperative launch): K and V stream through a two-stage cp.async ring
// once for every NWARPS query tiles; else (Sp <= RING) they are loaded
// once.  A query row's output depends on that row alone,
// whatever the others hold, and is the same either way.  FAST: store_o's.
template <int HD, bool SCALE_Q, bool STREAM, typename OutT = bf16,
          int NWARPS = WARPS, bool FAST = false>
__device__ __forceinline__ void flash_tile(
    const bf16* __restrict__ q, long long q_img, int q_row, int n_q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, long long kv_img,
    int kv_row, OutT* __restrict__ o, long long o_img, int o_row, int Sp,
    int valid_len, int hd, float scale, int h, int b, unsigned char* smem) {
  using L = Layout<HD>;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)(STREAM ? L::RING : Sp) * L::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * q_img + h * hd;
  const bf16* kb = k + b * kv_img + h * hd;
  const bf16* vb = v + b * kv_img + h * hd;
  OutT* ob = o + b * o_img + h * hd;

  if constexpr (!STREAM) {           // K and V once, every tile against them
    load_keys<HD, NWARPS>(Ks, Vs, kb, vb, kv_row, 0, Sp, 0, valid_len, hd);
    ptt::cp_async_wait<0>();
    __syncthreads();
    for (int qt = warp; qt * 16 < n_q; qt += NWARPS) {
      const int r0 = qt * 16 + g;
      uint32_t qa[HD / 16][4];
      load_q<HD, SCALE_Q>(qa, qb, q_row, r0, n_q, hd, scale, t);
      float oacc[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
      float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // row sums: [0] g, [2] g+8
      for (int n = 0; n < Sp; n += 16)
        key_step<HD>(qa, oacc, lacc, Ks, Vs, n, n, valid_len, lane);
      store_o<HD, OutT, FAST>(ob, o_row, oacc, lacc, r0, n_q, hd, t);
    }
  } else {
    // a pass of NWARPS query tiles, a tile a warp, over key blocks of KB
    // streamed through the ring: block i + STAGES - 1 loads while block i
    // is multiplied
    const int blocks = (Sp + L::KB - 1) / L::KB;
    auto load_block = [&](int i) {
      if (i < blocks)
        load_keys<HD, NWARPS>(Ks, Vs, kb, vb, kv_row, i * L::KB,
                              min(L::KB, Sp - i * L::KB),
                              i % L::STAGES * L::KB, valid_len, hd);
      else
        ptt::cp_async_commit();      // an empty group keeps the count
    };
    for (int qt0 = 0; qt0 * 16 < n_q; qt0 += NWARPS) {
      const int r0 = (qt0 + warp) * 16 + g;
      const bool active = r0 - g < n_q;
      uint32_t qa[HD / 16][4];
      load_q<HD, SCALE_Q>(qa, qb, q_row, r0, n_q, hd, scale, t);
      float oacc[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
      float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < L::STAGES - 1; ++i) load_block(i);
      for (int i = 0; i < blocks; ++i) {
        load_block(i + L::STAGES - 1);
        ptt::cp_async_wait<L::STAGES - 1>();   // block i has landed
        __syncthreads();
        if (active) {
          const int n0 = i * L::KB, n1 = min(Sp, n0 + L::KB);
          const int rb = i % L::STAGES * L::KB;
          for (int n = n0; n < n1; n += 16)
            key_step<HD>(qa, oacc, lacc, Ks, Vs, n, rb + n - n0, valid_len,
                         lane);
        }
        __syncthreads();             // block i's stage is free
      }
      ptt::cp_async_wait<0>();
      if (active)
        store_o<HD, OutT, FAST>(ob, o_row, oacc, lacc, r0, n_q, hd, t);
    }
  }
}

// The resident path: one block of THREADS threads per (head, image).
template <int HD, bool SCALE_Q, typename OutT, bool FAST = false>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, long long q_img, int q_row,
                 int n_q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long kv_img, int kv_row,
                 OutT* __restrict__ o, long long o_img, int o_row, int Sp,
                 int valid_len, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_tile<HD, SCALE_Q, false, OutT, WARPS, FAST>(
      q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, Sp,
      valid_len, hd, scale, blockIdx.x, blockIdx.y, smem);
}

// ---- the streamed path: a producer warp's TMA ring

// keys a stage of the streamed paths' rings
constexpr int STREAM_KB = 64;

// The streamed tile at instance width HD: NW consumer warps of one 16-row
// query tile each (ROWS query rows a block) and the producer warp after
// them; KS keys a step; STAGES stages of STREAM_KB keys of K and of V; MINB
// blocks an SM, which bounds the registers a thread.  Measured on the
// H100 against the other shapes tried (PERF.md section 6): two tiles a
// warp or 8 warps a block hold more registers and fewer warps an SM, and
// ran slower.
template <int HD>
struct Stream {
  using Rows = TmaRows<HD, STREAM_KB>;
  static constexpr int NW = 4;
  static constexpr int KS = HD <= 80 ? 64 : 16;
  static constexpr int MINB = HD <= 96 ? 3 : 2;
  static constexpr int THREADS = 32 * (NW + 1);
  static constexpr int ROWS = 16 * NW;
  static constexpr int STAGE = STREAM_KB * HD;    // elements of K (or V)
  static constexpr int STAGES = HD == 96 ? 3 : 2;
  // the ring (1,024-byte aligned by hand), then the full and empty barriers
  static constexpr size_t SMEM =
      1024 + 2 * (size_t)STAGES * STAGE * sizeof(bf16) +
      2 * STAGES * sizeof(uint64_t);
};

// The tensor maps of a head's rows at each part width (64, 32, 16
// columns): maps[i] for parts of width 64 >> i, unused where HD has none
struct PartMaps {
  CUtensorMap m[3];
};

__host__ __device__ constexpr int part_map(int width) {
  return width == 64 ? 0 : width == 32 ? 1 : 2;
}

// a box of a 4-D tensor map at (column, head, row, image)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          ptt_wgmma::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ptt_wgmma::smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// rows r0 .. r0 + ROWS - 1 of head h, image b into `dst` (a stage in the
// TmaRows<HD, ROWS> layout), every part, completing on `bar`
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const PartMaps& maps,
                                          uint64_t* bar, int h, int r0,
                                          int b) {
  using R = TmaRows<HD, ROWS>;
#pragma unroll
  for (int p = 0; p < R::NPARTS; ++p)
    tma_load_4d(dst + ROWS * R::col(p), &maps.m[part_map(R::width(p))], bar,
                R::col(p), h, r0, b);
}

// The producer of the K/V ring (one thread): `count` stages of
// STREAM_KB keys, the key blocks of a sweep in order, `blocks` to a sweep
// (count / blocks sweeps).  Stage s is refilled once its consumers have
// arrived on empty[s].
template <int HD>
__device__ __forceinline__ void produce_kv(const PartMaps& kmaps,
                                           const PartMaps& vmaps, bf16* Ks,
                                           bf16* Vs, uint64_t* full,
                                           uint64_t* empty, int h, int b,
                                           int blocks, int count) {
  using SL = Stream<HD>;
  for (int it = 0; it < count; ++it) {
    const int s = it % SL::STAGES, k0 = it % blocks * STREAM_KB;
    if (it >= SL::STAGES) ptt_wgmma::mbar_wait(&empty[s], (it / SL::STAGES - 1) & 1);
    ptt_wgmma::mbar_expect_tx(&full[s], 2 * SL::STAGE * sizeof(bf16));
    load_rows<HD, STREAM_KB>(Ks + s * SL::STAGE, kmaps, &full[s], h, k0, b);
    load_rows<HD, STREAM_KB>(Vs + s * SL::STAGE, vmaps, &full[s], h, k0, b);
  }
}

// The ring's shared memory: K stages, V stages, full and empty barriers
// (initialized by thread 0, `arrivals` consumer warps a stage); every
// thread of the block calls it
template <int HD>
__device__ __forceinline__ void ring_init(unsigned char* smem_raw, bf16*& Ks,
                                          bf16*& Vs, uint64_t*& full,
                                          uint64_t*& empty, int arrivals) {
  using SL = Stream<HD>;
  Ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  Vs = Ks + SL::STAGES * SL::STAGE;
  full = reinterpret_cast<uint64_t*>(Vs + SL::STAGES * SL::STAGE);
  empty = full + SL::STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SL::STAGES; ++s) {
      ptt_wgmma::mbar_init(&full[s], 1);     // the producer's expect_tx
      ptt_wgmma::mbar_init(&empty[s], arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One pass of Stream<HD>::ROWS query rows of one (head, image) (grid:
// passes x heads x images, so that a (head, image)'s passes are adjacent
// in launch order): NW consumer warps of one 16-row query tile each, then
// the producer warp.
template <int HD, bool SCALE_Q, typename OutT, bool FAST = false>
__global__ void __launch_bounds__(Stream<HD>::THREADS, Stream<HD>::MINB)
    stream_kernel(const __grid_constant__ PartMaps kmaps,
                  const __grid_constant__ PartMaps vmaps,
                  const bf16* __restrict__ q, long long q_img, int q_row,
                  int n_q, OutT* __restrict__ o, long long o_img, int o_row,
                  int Sp, int valid_len, int hd, float scale) {
  using SL = Stream<HD>;
  using Lay = typename SL::Rows;
  extern __shared__ unsigned char smem_raw[];
  bf16 *Ks, *Vs;
  uint64_t *full, *empty;
  ring_init<HD>(smem_raw, Ks, Vs, full, empty, SL::NW);
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks = (Sp + STREAM_KB - 1) / STREAM_KB;
  if (warp == SL::NW) {
    if (lane == 0)
      produce_kv<HD>(kmaps, vmaps, Ks, Vs, full, empty, h, b, blocks, blocks);
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * SL::ROWS;
  const int nq = min(SL::ROWS, n_q - q0);
  const int r0 = warp * 16 + g;
  const bool active = warp * 16 < nq;     // its tile holds a query row
  const bf16* qb = q + b * q_img + (size_t)q0 * q_row + h * hd;
  OutT* ob = o + b * o_img + (size_t)q0 * o_row + h * hd;
  uint32_t qa[HD / 16][4];
  load_q<HD, SCALE_Q>(qa, qb, q_row, r0, nq, hd, scale, t);
  float oacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
  float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < blocks; ++i) {
    const int s = i % SL::STAGES;
    ptt_wgmma::mbar_wait(&full[s], (i / SL::STAGES) & 1);
    if (active) {
      const bf16* Kst = Ks + s * SL::STAGE;
      const bf16* Vst = Vs + s * SL::STAGE;
      const int n0 = i * STREAM_KB, n1 = min(Sp, n0 + STREAM_KB);
      int n = n0;
      for (; n + SL::KS <= n1; n += SL::KS)
        key_step<HD, Lay, SL::KS, true>(qa, oacc, lacc, Kst, Vst, n, n - n0,
                                        valid_len, lane);
      for (; n < n1; n += 16)        // a last block of fewer keys
        key_step<HD, Lay, 16, true>(qa, oacc, lacc, Kst, Vst, n, n - n0,
                                    valid_len, lane);
    }
    __syncwarp();
    if (lane == 0) ptt_wgmma::mbar_arrive(&empty[s]);
  }
  if (active) store_o<HD, OutT, FAST>(ob, o_row, oacc, lacc, r0, nq, hd, t);
}

// The 4-D map of a head's rows in a strided [images, rows, heads x hd]
// view at p: columns (extent hd), heads, rows (extent `rows`), images; a
// box of `width` columns of one head by `box_rows` rows, with TMA's
// swizzle of the box's row bytes.  Columns past hd and rows past `rows`
// read as zero.  False where cuTensorMapEncodeTiled refuses it.
inline bool head_map(CUtensorMap* map, const bf16* p, int hd, int H,
                     int rows, int B, long long row_stride,
                     long long img_stride, int width, int box_rows) {
  ptt_wgmma::EncodeTiled encode = ptt_wgmma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * sizeof(bf16),
                                 (cuuint64_t)row_stride * sizeof(bf16),
                                 (cuuint64_t)img_stride * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)p, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// head_map at each part width of TmaRows<HD, ROWS>
template <int HD, int ROWS>
inline bool part_maps(PartMaps* maps, const bf16* p, int hd, int H, int rows,
                      int B, long long row_stride, long long img_stride) {
  using R = TmaRows<HD, ROWS>;
  for (int i = 0; i < R::NPARTS; ++i)
    if (!head_map(&maps->m[part_map(R::width(i))], p, hd, H, rows, B,
                  row_stride, img_stride, R::width(i), ROWS))
      return false;
  return true;
}

template <int HD, bool SCALE_Q, typename OutT, bool FAST>
int launch_resident(const bf16* q, long long q_img, int q_row, int n_q,
                    const bf16* k, const bf16* v, long long kv_img,
                    int kv_row, OutT* o, long long o_img, int o_row, int B,
                    int H, int hd, int Sp, int valid_len, float scale,
                    cudaStream_t st) {
  const size_t smem = tile_smem<HD>(Sp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, SCALE_Q, OutT, FAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<HD, SCALE_Q, OutT, FAST><<<dim3(H, B), THREADS, smem, st>>>(
      q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, Sp,
      valid_len, hd, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool SCALE_Q, typename OutT, bool FAST>
int launch_streamed(const bf16* q, long long q_img, int q_row, int n_q,
                    const bf16* k, const bf16* v, long long kv_img,
                    int kv_row, OutT* o, long long o_img, int o_row, int B,
                    int H, int hd, int Sp, int valid_len, float scale,
                    cudaStream_t st) {
  using SL = Stream<HD>;
  PartMaps kmaps, vmaps;
  if (!part_maps<HD, STREAM_KB>(&kmaps, k, hd, H, valid_len, B, kv_row,
                                kv_img) ||
      !part_maps<HD, STREAM_KB>(&vmaps, v, hd, H, valid_len, B, kv_row,
                                kv_img))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<HD, SCALE_Q, OutT, FAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int passes = (n_q + SL::ROWS - 1) / SL::ROWS;
  stream_kernel<HD, SCALE_Q, OutT, FAST>
      <<<dim3(passes, H, B), SL::THREADS, SL::SMEM, st>>>(
          kmaps, vmaps, q, q_img, q_row, n_q, o, o_img, o_row, Sp, valid_len,
          hd, scale);
  return (int)cudaGetLastError();
}

// Launch over (heads, images) at real head width hd (a multiple of 8 up to
// MAX_HEAD_DIM) on the instance tile_width(hd); returns cudaGetLastError(),
// or cudaErrorInvalidValue for a width or a sequence the tile does not
// take.  FAST (an f32 output only): the int8 layers' fast normalize.
template <bool SCALE_Q, typename OutT = bf16, bool FAST = false>
int attention(const bf16* q, long long q_img, int q_row, int n_q,
              const bf16* k, const bf16* v, long long kv_img, int kv_row,
              OutT* o, long long o_img, int o_row, int B, int H, int hd,
              int Sp, int valid_len, float scale, cudaStream_t st) {
  if (Sp % 16 || valid_len < 1 || valid_len > Sp || n_q < 1)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto w) {
    constexpr int HD = decltype(w)::value;
    return Sp > Layout<HD>::RING
               ? launch_streamed<HD, SCALE_Q, OutT, FAST>(
                     q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img,
                     o_row, B, H, hd, Sp, valid_len, scale, st)
               : launch_resident<HD, SCALE_Q, OutT, FAST>(
                     q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img,
                     o_row, B, H, hd, Sp, valid_len, scale, st);
  };
  switch (tile_width(hd)) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 48: return run(std::integral_constant<int, 48>());
    case 64: return run(std::integral_constant<int, 64>());
    case 80: return run(std::integral_constant<int, 80>());
    case 96: return run(std::integral_constant<int, 96>());
    case 112: return run(std::integral_constant<int, 112>());
    case 128: return run(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ptt_flash
