// Whole pre-LN bf16 transformer layer for the ViT serving tower, and its
// CLS-only variant for the last layer.
//
// Replaces the TPU kernels patent_tpu/ops/bf16_layer.py::_bf16_layer_kernel
// (public entry fused_layer_block_bf16) and ::_bf16_layer_cls_kernel
// (fused_layer_cls_bf16).  Both compute the TPU kernel's function:
//
//   h   = bf16(LN1(x))                       (f32 statistics, eps 1e-5)
//   qkv = bf16(h Wqkv' + bqkv')              Wqkv' has log2(e)/sqrt(hd)
//                                            folded into its q columns
//   ao  = bf16((p v) / sum p), p = bf16(exp2(clip(q k^T, -100, 80))),
//         keys at or past valid_len p = 0
//   x1  = (x + ao Wout) + bout               (f32)
//   y   = x1 + (quick_gelu(bf16(LN2(x1)) W1 + b1) W2 + b2),
//         quick_gelu(g) = g / (1 + exp2(NEG_1702_LOG2E g)) in f32, rounded
//
// with bf16 matmul operands and f32 accumulation.  The matrices come as
// their transposes, [out, in] (what csrc/wgmma_gemm.cuh reads), with the q
// rows folded once from f32 by the caller.  The CLS variant computes LN1
// and K/V over every row, but Q, attention, out-projection, LN2 and the
// MLP for row 0 only, with the same kernels, so it equals row 0 of the
// full layer bit for bit.
//
// What bounds it on the H100: at ViT-B/16 @224 (S = 208 padded, D = 768,
// MLP 3072) a layer is ~2.9 GFLOP per image against ~2 MB of activation
// traffic per image and 14 MB of weights per batch, so it is bound by the
// tensor cores; the GEMMs are ~96% of the FLOPs.  Design:
//   * the four GEMMs are csrc/wgmma_gemm.cuh (TMA and wgmma, a producer
//     warpgroup and two consumer warpgroups per 128 x 256 tile) with the
//     epilogues fused (+bias; +bias, quick_gelu; +residual +bias in the
//     TPU kernel's two orders);
//   * attention is csrc/flash_tile.cuh: per (head, image) K and V in
//     shared memory once (streamed in key blocks past the tile's ring,
//     at any S and head widths to 128), scores and p in registers, the
//     one-pass exp2 softmax;
//   * the layer is seven launches, so qkv, ao, x1 and the MLP hidden
//     [M, 3072] pass through device memory (the TPU kernel keeps them on
//     chip); keeping them on chip is later work.  The timings sit in
//     PERF.md.

#include "common.cuh"
#include "flash_tile.cuh"
#include "layernorm.cuh"
#include "wgmma_gemm.cuh"

using ptt::bf16;
using ptt::layernorm;
namespace wg = ptt_wgmma;

extern "C" {

// x [B, S, D] bf16 -> out [B, S, D] bf16.  wqkv_t [3D, D], wout_t [D, D],
// w1_t [F, D], w2_t [D, F] bf16; vectors f32 (bqkv's q part folded).
// Scratch: h [M, D] bf16, qkv [M, 3D] bf16, ao [M, D] bf16, x1 [M, D]
// f32, g [M, F] bf16 (M = B*S).
int ptt_bf16_layer(const void* x, void* out, int B, int S, int D, int H, int F,
                   int valid_len, const void* ln1s, const void* ln1b,
                   const void* wqkv_t, const void* bqkv, const void* wout_t,
                   const void* bout, const void* ln2s, const void* ln2b,
                   const void* w1_t, const void* b1, const void* w2_t,
                   const void* b2, void* h, void* qkv, void* ao, void* x1,
                   void* g, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  const bf16* xb = (const bf16*)x;
  bf16* hb = (bf16*)h;
  bf16* qkvb = (bf16*)qkv;
  bf16* aob = (bf16*)ao;
  float* x1f = (float*)x1;
  bf16* gb = (bf16*)g;
  const float* nores = nullptr;

  layernorm<bf16>(xb, D, (const float*)ln1s, (const float*)ln1b, hb, M, D, st);
  PTT_CHECK();
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      hb, D, (const bf16*)wqkv_t, D, (const float*)bqkv, nores, 0, qkvb, 3 * D,
      M, 3 * D, D, st)));
  PTT_TRY(ptt_flash::attention<false>(
      qkvb, (long long)S * 3 * D, 3 * D, S, qkvb + D, qkvb + 2 * D,
      (long long)S * 3 * D, 3 * D, aob, (long long)S * D, D, B, H, D / H,
      S, valid_len, 0.0f, st));
  PTT_TRY((wg::gemm<wg::EPI_RES_BIAS, bf16, float>(
      aob, D, (const bf16*)wout_t, D, (const float*)bout, xb, D, x1f, D, M, D,
      D, st)));
  layernorm<float>(x1f, D, (const float*)ln2s, (const float*)ln2b, hb, M, D,
                   st);
  PTT_CHECK();
  PTT_TRY((wg::gemm<wg::EPI_BIAS_GELU, float, bf16>(
      hb, D, (const bf16*)w1_t, D, (const float*)b1, nores, 0, gb, F, M, F, D,
      st)));
  PTT_TRY((wg::gemm<wg::EPI_BIAS_RES, float, bf16>(
      gb, F, (const bf16*)w2_t, F, (const float*)b2, x1f, D, (bf16*)out, D, M,
      D, F, st)));
  return 0;
}

// x [B, S, D] bf16 -> out [B, D] bf16, row 0 of ptt_bf16_layer.  Scratch:
// h [M, D] bf16, kv [M, 2D] bf16, qc [B, D] bf16, ao [B, D] bf16,
// x1 [B, D] f32, h2 [B, D] bf16, g [B, F] bf16.
int ptt_bf16_layer_cls(const void* x, void* out, int B, int S, int D, int H,
                       int F, int valid_len, const void* ln1s,
                       const void* ln1b, const void* wqkv_t, const void* bqkv,
                       const void* wout_t, const void* bout, const void* ln2s,
                       const void* ln2b, const void* w1_t, const void* b1,
                       const void* w2_t, const void* b2, void* h, void* kv,
                       void* qc, void* ao, void* x1, void* h2, void* g,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  const bf16* xb = (const bf16*)x;
  const bf16* w = (const bf16*)wqkv_t;
  const float* bq = (const float*)bqkv;
  bf16* hb = (bf16*)h;
  bf16* kvb = (bf16*)kv;
  bf16* qb = (bf16*)qc;
  bf16* aob = (bf16*)ao;
  float* x1f = (float*)x1;
  bf16* h2b = (bf16*)h2;
  bf16* gb = (bf16*)g;
  const float* nores = nullptr;

  layernorm<bf16>(xb, D, (const float*)ln1s, (const float*)ln1b, hb, M, D, st);
  PTT_CHECK();
  // K and V over every row: rows D..3D of wqkv_t
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      hb, D, w + (size_t)D * D, D, bq + D, nores, 0, kvb, 2 * D, M, 2 * D, D,
      st)));
  // Q for the CLS rows only: row 0 of each image is every S-th row of h
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      hb, (long long)S * D, w, D, bq, nores, 0, qb, D, B, D, D, st)));
  PTT_TRY(ptt_flash::attention<false>(
      qb, D, D, 1, kvb, kvb + D, (long long)S * 2 * D, 2 * D, aob, D, D, B, H,
      D / H, S, valid_len, 0.0f, st));
  PTT_TRY((wg::gemm<wg::EPI_RES_BIAS, bf16, float>(
      aob, D, (const bf16*)wout_t, D, (const float*)bout, xb, (long long)S * D,
      x1f, D, B, D, D, st)));
  layernorm<float>(x1f, D, (const float*)ln2s, (const float*)ln2b, h2b, B, D,
                   st);
  PTT_CHECK();
  PTT_TRY((wg::gemm<wg::EPI_BIAS_GELU, float, bf16>(
      h2b, D, (const bf16*)w1_t, D, (const float*)b1, nores, 0, gb, F, B, F, D,
      st)));
  PTT_TRY((wg::gemm<wg::EPI_BIAS_RES, float, bf16>(
      gb, F, (const bf16*)w2_t, F, (const float*)b2, x1f, D, (bf16*)out, D, B,
      D, F, st)));
  return 0;
}

// One GEMM of the layer on its own, for checks and timing:
// C = epi(A Bt^T + bias), A [M, K] (row stride lda), Bt [N, K] (ldb), res
// and C [M, N] (ldr, ldc).  epi: 0 +bias -> bf16; 1 +bias, quick_gelu ->
// bf16; 2 (bf16 res + v) + bias -> f32; 3 f32 res + (v + bias) -> bf16,
// the four instances ptt_bf16_layer runs.
int ptt_wgmma_gemm(int epi, const void* A, long long lda, const void* Bt,
                   long long ldb, const void* bias, const void* res,
                   long long ldr, void* C, long long ldc, int M, int N, int K,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* a = (const bf16*)A;
  const bf16* b = (const bf16*)Bt;
  const float* bi = (const float*)bias;
  switch (epi) {
    case wg::EPI_BIAS:
      return wg::gemm<wg::EPI_BIAS, float, bf16>(a, lda, b, ldb, bi, nullptr,
                                                 0, (bf16*)C, ldc, M, N, K, st);
    case wg::EPI_BIAS_GELU:
      return wg::gemm<wg::EPI_BIAS_GELU, float, bf16>(
          a, lda, b, ldb, bi, nullptr, 0, (bf16*)C, ldc, M, N, K, st);
    case wg::EPI_RES_BIAS:
      return wg::gemm<wg::EPI_RES_BIAS, bf16, float>(
          a, lda, b, ldb, bi, (const bf16*)res, ldr, (float*)C, ldc, M, N, K,
          st);
    case wg::EPI_BIAS_RES:
      return wg::gemm<wg::EPI_BIAS_RES, float, bf16>(
          a, lda, b, ldb, bi, (const float*)res, ldr, (bf16*)C, ldc, M, N, K,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
