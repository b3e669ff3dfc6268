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
// products.  The head width HD is a template argument: 64 (ViT-B/16), 32
// and 16 (the CLIs' small tower, D 64 over 4 heads); the words below are
// for 64:
//   * one block of 4 warps per (head, image) loads the head's K and V
//     (2 x S x 64 bf16, 53 KB at S 208) into shared memory once with
//     16-byte cp.async from the strided q/k/v views (no copy or transpose);
//     rows past valid_len are zero-filled, as the TPU kernel zeroes V's pad
//     rows.  The 16-byte chunks of a row are XOR-swizzled by the row, so
//     ldmatrix reads 8 rows without bank conflicts and nothing is padded:
//     shared memory is K and V alone, four blocks an SM, so that one
//     block's loads overlap the others' products;
//   * the warps walk the query tiles of 16 rows; a warp's q fragments come
//     straight from device memory into registers (row 14 scales them
//     there), its scores for 16 keys stay in registers (mma.sync
//     m16n8k16, bf16 in, f32 out), are rounded to bf16 in registers and,
//     since the accumulator layout of m16n8 is the A-fragment layout of
//     m16n8k16, feed the p.v product directly; V's B fragments come from
//     ldmatrix.trans;
//   * the denominator rides the tensor cores as it rides the TPU's MXU:
//     one more m16n8k16 of p against a block of ones gives each row's f32
//     sum of its rounded p; the key mask runs only on the last key step;
//   * the output is divided exactly, rounded, and stored from registers.
// wgmma is not needed: the products are a third of the bound.
#pragma once

#include "common.cuh"

namespace ptt_flash {

using ptt::bf16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float SCORE_LO = -100.0f, SCORE_HI = 80.0f;
constexpr uint32_t BF16_ONES = 0x3F803F80u;   // two bf16 1.0

// K and V of Sp rows of hd columns
inline size_t smem_bytes(int Sp, int hd) {
  return 2 * (size_t)Sp * hd * sizeof(bf16);
}

// the head widths the tiles are instantiated for
inline bool head_dim_ok(int hd) { return hd == 16 || hd == 32 || hd == 64; }

// element offset of the 16-byte chunk c (0 .. HD/8 - 1) of a row r of HD
// columns: chunks swizzled by the row, so that at HD 64 rows r..r+7 put
// any one chunk in 8 different bank groups (at 32 and 16, 4 and 2)
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & (HD / 8 - 1))) << 3);
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

// softmax(q' k^T) v for one (head h, image b): n_q query rows; q, k, v, o
// are row-major views with their own image and row strides (elements,
// even), the head's HD columns at h * HD.  K and V hold Sp (a multiple of
// 16) rows, of which those below valid_len are read.  SCALE_Q: q times
// `scale` in f32 on load, rounded to bf16.  o is bf16 or f32.  Every
// thread of the block (NWARPS warps) takes part.  A query row's output
// depends on that row alone, whatever the others hold.
template <int HD, bool SCALE_Q, typename OutT = bf16, int NWARPS = WARPS>
__device__ __forceinline__ void flash_tile(
    const bf16* __restrict__ q, long long q_img, int q_row, int n_q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, long long kv_img,
    int kv_row, OutT* __restrict__ o, long long o_img, int o_row, int Sp,
    int valid_len, float scale, int h, int b, unsigned char* smem) {
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)Sp * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * q_img + h * HD;
  const bf16* kb = k + b * kv_img + h * HD;
  const bf16* vb = v + b * kv_img + h * HD;
  OutT* ob = o + b * o_img + h * HD;

  constexpr int CH = HD / 8;             // 16-byte chunks a row
  for (int c = tid; c < Sp * CH; c += 32 * NWARPS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r < valid_len;
    ptt::cp_async16(&Ks[swz<HD>(r, ch)],
                    ok ? kb + (size_t)r * kv_row + ch * 8 : kb, ok);
    ptt::cp_async16(&Vs[swz<HD>(r, ch)],
                    ok ? vb + (size_t)r * kv_row + ch * 8 : vb, ok);
  }
  ptt::cp_async_commit();
  ptt::cp_async_wait<0>();
  __syncthreads();

  for (int qt = warp; qt * 16 < n_q; qt += NWARPS) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    // a q word (two values of row r at column c), zero past n_q
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
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = q_word(r0, c);
      qa[kk][1] = q_word(r1, c);
      qa[kk][2] = q_word(r0, c + 8);
      qa[kk][3] = q_word(r1, c + 8);
    }

    float oacc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
    float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // row sums: [0] row g, [2] g+8

    for (int n = 0; n < Sp; n += 16) {
      // scores of the 16 keys n..n+15: two n8 tiles
      float sacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[swz<HD>(n + (lane & 7) + ((lane >> 4) << 3),
                                   kk * 2 + ((lane >> 3) & 1))]);
        mma_bf16(sacc[0], qa[kk], kf[0], kf[1]);
        mma_bf16(sacc[1], qa[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[j][e] = exp2f(fminf(fmaxf(sacc[j][e], SCORE_LO), SCORE_HI));
      if (n + 16 > valid_len) {        // the step that holds pad keys
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
            vf, &Vs[swz<HD>(n + (lane & 7) + (((lane >> 3) & 1) << 3),
                            jj * 2 + (lane >> 4))]);
        mma_bf16(oacc[2 * jj], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * jj + 1], pa, vf[2], vf[3]);
      }
      mma_bf16(lacc, pa, BF16_ONES, BF16_ONES);
    }

#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (r0 < n_q)
        ptt::store2(&ob[(size_t)r0 * o_row + c],
                    __fdiv_rn(oacc[j][0], lacc[0]),
                    __fdiv_rn(oacc[j][1], lacc[0]));
      if (r1 < n_q)
        ptt::store2(&ob[(size_t)r1 * o_row + c],
                    __fdiv_rn(oacc[j][2], lacc[2]),
                    __fdiv_rn(oacc[j][3], lacc[2]));
    }
  }
}

// One block of THREADS threads per (head, image).
template <int HD, bool SCALE_Q, typename OutT>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, long long q_img, int q_row,
                 int n_q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long kv_img, int kv_row,
                 OutT* __restrict__ o, long long o_img, int o_row, int Sp,
                 int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash_tile<HD, SCALE_Q, OutT>(q, q_img, q_row, n_q, k, v, kv_img, kv_row,
                                o, o_img, o_row, Sp, valid_len, scale,
                                blockIdx.x, blockIdx.y, smem);
}

template <int HD, bool SCALE_Q, typename OutT>
int launch(const bf16* q, long long q_img, int q_row, int n_q, const bf16* k,
           const bf16* v, long long kv_img, int kv_row, OutT* o,
           long long o_img, int o_row, int B, int H, int Sp, int valid_len,
           float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(Sp, HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, SCALE_Q, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<HD, SCALE_Q, OutT><<<dim3(H, B), THREADS, smem, st>>>(
      q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, Sp,
      valid_len, scale);
  return (int)cudaGetLastError();
}

// Launch over (heads, images) at head width hd (16, 32 or 64); returns
// cudaGetLastError().
template <bool SCALE_Q, typename OutT = bf16>
int attention(const bf16* q, long long q_img, int q_row, int n_q,
              const bf16* k, const bf16* v, long long kv_img, int kv_row,
              OutT* o, long long o_img, int o_row, int B, int H, int hd,
              int Sp, int valid_len, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<16, SCALE_Q, OutT>(q, q_img, q_row, n_q, k, v, kv_img,
                                       kv_row, o, o_img, o_row, B, H, Sp,
                                       valid_len, scale, st);
    case 32:
      return launch<32, SCALE_Q, OutT>(q, q_img, q_row, n_q, k, v, kv_img,
                                       kv_row, o, o_img, o_row, B, H, Sp,
                                       valid_len, scale, st);
    case 64:
      return launch<64, SCALE_Q, OutT>(q, q_img, q_row, n_q, k, v, kv_img,
                                       kv_row, o, o_img, o_row, B, H, Sp,
                                       valid_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ptt_flash
