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
//                                stored bf16 (rounded) or f32
//
// With no max subtraction there is no running max to rescale by, so the
// softmax is one pass over the keys, 16 at a time, with nothing carried
// between key steps but the output accumulator and the row sums.
//
// What bounds it on the H100: at the use_flash tower's [128, 197, 12, 64]
// it reads q, k, v and writes o once, 155 MB (46 us at 3.35 TB/s), for
// 15.3 GFLOP of products (15 us at the bf16 peak): bytes.  So the design
// reads every K and V row from device memory once per (head, image), and
// keeps enough blocks on an SM that one block's loads overlap the others'
// products.  The head width HD is a template argument, every multiple of
// 16 from 16 to 128; a real width hd that is a multiple of 8 runs on the
// next instance up (72 on 80): q words and K/V columns past hd are zero
// (cp.async with source size 0, so the next head's columns of a strided
// qkv view are never read), add exact zeros to every score, and only hd
// columns are stored.  The words below are for 64:
//   * one block of 4 warps per (head, image) loads the head's K and V
//     into shared memory with 16-byte cp.async from the strided q/k/v
//     views (no copy or transpose); rows past valid_len are zero-filled,
//     as the TPU kernel zeroes V's pad rows.  Where K and V fit the ring
//     (2 x RING keys of HD columns, ~56 KB: 224 keys at 64, so ViT-B/16's
//     208), they are loaded once (53 KB at S 208, four blocks an SM) and
//     the warps walk the query tiles against them; past it, the block
//     takes one pass of 4 query tiles (the grid's third axis splits the
//     query rows) and streams K and V through a ring of two stages of KB
//     keys, block i + 1's loads in flight during block i's products.
//     Only the output accumulator and the row sums carry from key block to
//     key block (there is no running max to rescale), so a query row's
//     16-key steps, and every product into its accumulators, run in the
//     same order either way: the same bits;
//   * a row of 2, 4, 8 or 16 chunks of 16 bytes is XOR-swizzled by the
//     row, so ldmatrix reads 8 rows without bank conflicts and nothing is
//     padded; a row of 6, 10, 12 or 14 chunks (HD 48, 80, 96, 112) has a
//     padded stride of one more chunk, an odd count, so 8 rows at one
//     chunk fall in 8 different 16-byte bank groups (an XOR within groups
//     of 8 chunks would leave the tail group of 2 to 6 chunks conflicted);
//   * the warps walk the query tiles of 16 rows; a warp's q fragments come
//     straight from device memory into registers (row 14 scales them
//     there), its scores for 16 keys stay in registers (mma.sync
//     m16n8k16, bf16 in, f32 out), are rounded to bf16 in registers and,
//     since the accumulator layout of m16n8 is the A-fragment layout of
//     m16n8k16, feed the p.v product directly; V's B fragments come from
//     ldmatrix.trans;
//   * the denominator rides the tensor cores as it rides the TPU's MXU:
//     one more m16n8k16 of p against a block of ones gives each row's f32
//     sum of its rounded p; the key mask runs only on the step that holds
//     valid_len;
//   * the output is divided exactly, rounded, and stored from registers.
// wgmma is not needed: the products are a third of the bound.
#pragma once

#include <type_traits>

#include "common.cuh"

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

// One 16-key step of a warp's query tile: the keys n..n+15, held in rows
// r..r+15 of the ring, into its output accumulator and row sums
template <int HD>
__device__ __forceinline__ void key_step(const uint32_t (&qa)[HD / 16][4],
                                         float (&oacc)[HD / 8][4],
                                         float (&lacc)[4], const bf16* Ks,
                                         const bf16* Vs, int n, int r,
                                         int valid_len, int lane) {
  const int t = lane & 3;
  float sacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t kf[4];
    ldmatrix_x4(kf, &Ks[swz<HD>(r + (lane & 7) + ((lane >> 4) << 3),
                               kk * 2 + ((lane >> 3) & 1))]);
    mma_bf16(sacc[0], qa[kk], kf[0], kf[1]);
    mma_bf16(sacc[1], qa[kk], kf[2], kf[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sacc[j][e] = exp2f(fminf(fmaxf(sacc[j][e], SCORE_LO), SCORE_HI));
  if (n + 16 > valid_len) {            // the step that holds pad keys
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + 8 * j + 2 * t + (e & 1) >= valid_len) sacc[j][e] = 0.0f;
  }
  // p, rounded, in the A-fragment layout of the p.v product
  const uint32_t pa[4] = {pack_bf16(sacc[0][0], sacc[0][1]),
                          pack_bf16(sacc[0][2], sacc[0][3]),
                          pack_bf16(sacc[1][0], sacc[1][1]),
                          pack_bf16(sacc[1][2], sacc[1][3])};
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    uint32_t vf[4];
    ldmatrix_x4_trans(
        vf, &Vs[swz<HD>(r + (lane & 7) + (((lane >> 3) & 1) << 3),
                        jj * 2 + (lane >> 4))]);
    mma_bf16(oacc[2 * jj], pa, vf[0], vf[1]);
    mma_bf16(oacc[2 * jj + 1], pa, vf[2], vf[3]);
  }
  mma_bf16(lacc, pa, BF16_ONES, BF16_ONES);
}

// The outputs of query rows r0 and r0 + 8 below n_q, their first hd
// columns: divided exactly, rounded to OutT
template <int HD, typename OutT>
__device__ __forceinline__ void store_o(OutT* __restrict__ ob, int o_row,
                                        const float (&oacc)[HD / 8][4],
                                        const float (&lacc)[4], int r0,
                                        int n_q, int hd, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (j == HD / 8 - 1 && hd < HD) break;   // the last 8 columns, past hd
    if (r0 < n_q)
      ptt::store2(&ob[(size_t)r0 * o_row + c], __fdiv_rn(oacc[j][0], lacc[0]),
                  __fdiv_rn(oacc[j][1], lacc[0]));
    if (r1 < n_q)
      ptt::store2(&ob[(size_t)r1 * o_row + c], __fdiv_rn(oacc[j][2], lacc[2]),
                  __fdiv_rn(oacc[j][3], lacc[2]));
  }
}

// softmax(q' k^T) v for one (head h, image b): n_q query rows; q, k, v, o
// are row-major views with their own image and row strides (elements,
// even), the head's hd columns at h * hd (hd a multiple of 8, at most HD).
// K and V hold Sp (a multiple of 16) rows, of which those below valid_len
// are read.  SCALE_Q: q times `scale` in f32 on load, rounded to bf16.  o
// is bf16 or f32.  Every thread of the block (NWARPS warps) takes part;
// smem holds tile_smem<HD>(Sp) bytes.  STREAM (Sp > RING): K and V stream
// through the ring once for every NWARPS query tiles; else (Sp <= RING)
// they are loaded once.  A query row's output depends on that row alone,
// whatever the others hold, and is the same either way.
template <int HD, bool SCALE_Q, bool STREAM, typename OutT = bf16,
          int NWARPS = WARPS>
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
      store_o<HD, OutT>(ob, o_row, oacc, lacc, r0, n_q, hd, t);
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
      if (active) store_o<HD, OutT>(ob, o_row, oacc, lacc, r0, n_q, hd, t);
    }
  }
}

// One block of THREADS threads per (head, image), and with STREAM per
// pass of WARPS query tiles (blockIdx.z).
template <int HD, bool SCALE_Q, bool STREAM, typename OutT>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, long long q_img, int q_row,
                 int n_q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long kv_img, int kv_row,
                 OutT* __restrict__ o, long long o_img, int o_row, int Sp,
                 int valid_len, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (STREAM) {
    const int q0 = blockIdx.z * 16 * WARPS;
    flash_tile<HD, SCALE_Q, true, OutT>(
        q + (size_t)q0 * q_row, q_img, q_row, min(16 * WARPS, n_q - q0), k,
        v, kv_img, kv_row, o + (size_t)q0 * o_row, o_img, o_row, Sp,
        valid_len, hd, scale, blockIdx.x, blockIdx.y, smem);
  } else {
    flash_tile<HD, SCALE_Q, false, OutT>(
        q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, Sp,
        valid_len, hd, scale, blockIdx.x, blockIdx.y, smem);
  }
}

template <int HD, bool SCALE_Q, bool STREAM, typename OutT>
int launch(const bf16* q, long long q_img, int q_row, int n_q, const bf16* k,
           const bf16* v, long long kv_img, int kv_row, OutT* o,
           long long o_img, int o_row, int B, int H, int hd, int Sp,
           int valid_len, float scale, cudaStream_t st) {
  const size_t smem = tile_smem<HD>(Sp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, SCALE_Q, STREAM, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = STREAM ? (n_q + 16 * WARPS - 1) / (16 * WARPS) : 1;
  flash_kernel<HD, SCALE_Q, STREAM, OutT>
      <<<dim3(H, B, passes), THREADS, smem, st>>>(
          q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, Sp,
          valid_len, hd, scale);
  return (int)cudaGetLastError();
}

// Launch over (heads, images) at real head width hd (a multiple of 8 up to
// MAX_HEAD_DIM) on the instance tile_width(hd); returns cudaGetLastError(),
// or cudaErrorInvalidValue for a width or a sequence the tile does not
// take.
template <bool SCALE_Q, typename OutT = bf16>
int attention(const bf16* q, long long q_img, int q_row, int n_q,
              const bf16* k, const bf16* v, long long kv_img, int kv_row,
              OutT* o, long long o_img, int o_row, int B, int H, int hd,
              int Sp, int valid_len, float scale, cudaStream_t st) {
  if (Sp % 16 || valid_len < 1 || valid_len > Sp || n_q < 1)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto w) {
    constexpr int HD = decltype(w)::value;
    return Sp > Layout<HD>::RING
               ? launch<HD, SCALE_Q, true, OutT>(
                     q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img,
                     o_row, B, H, hd, Sp, valid_len, scale, st)
               : launch<HD, SCALE_Q, false, OutT>(
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
