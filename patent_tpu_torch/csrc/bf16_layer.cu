// Whole pre-LN bf16 transformer layer for the ViT serving tower, and its
// CLS-only variant for the last layer.
//
// Replaces the TPU kernels patent_tpu/ops/bf16_layer.py::_bf16_layer_kernel
// (public entry fused_layer_block_bf16) and ::_bf16_layer_cls_kernel
// (fused_layer_cls_bf16).  Both compute
//
//     x1 = x + out(MHA(LN1(x)))           (residual carried in f32)
//     y  = x1 + W2 quick_gelu(W1 LN2(x1) + b1) + b2
//
// with LayerNorm statistics in f32 (eps 1e-5), bf16 matmul operands, f32
// accumulation, keys at or past valid_len masked, and quick_gelu(g) =
// g * sigmoid(1.702 g).  The CLS variant computes LN1 and K/V over every
// row, but Q, attention, out-projection, LN2 and the MLP for row 0 only.
//
// What bounds it on the H100: at ViT-B/16 @224 (S = 208 padded, D = 768,
// MLP 3072) a layer is ~2.9 GFLOP per image against ~2 MB of activation
// traffic per image and 14 MB of weights per batch, so it is bound by the
// tensor cores; the GEMMs are ~96% of the FLOPs.  Design:
//   * the GEMMs run on the tensor cores (nvcuda::wmma bf16, f32
//     accumulate), 128x128x32 block tiles, a two-stage cp.async ring, and
//     fused epilogues (+bias, +bias+quick_gelu, +bias+residual);
//   * attention (csrc/attention.cuh) runs one block per (query tile of 64,
//     head, image) with K and V of the whole sequence in shared memory
//     (2 x 208 x 64 bf16), the [64, S] score tile in shared memory, and
//     both products on wmma;
//   * the softmax subtracts the row max (the usual GPU form), in f32, and
//     rounds p to bf16 for the p.v product; the denominator sums the same
//     rounded p, as the TPU kernel's denominator-in-the-matmul does.  The
//     TPU's exp2 form with scores clamped to [-100, 80] is kept only where
//     the TPU kernels' numerics must be reproduced (the int8 layer).
//   * This first version keeps the layer as seven launches, so the MLP
//     hidden [M, 3072] and the QKV tile pass through device memory (the TPU
//     kernel keeps them on chip).  Keeping them on chip, wgmma and TMA are
//     later work; the timings sit in PERF.md.

#include "attention.cuh"
#include "common.cuh"
#include "gemm.cuh"

using ptt::bf16;
using ptt_gemm::EPI_BIAS;
using ptt_gemm::EPI_BIAS_GELU;
using ptt_gemm::EPI_BIAS_RES;
using ptt_gemm::gemm;
using ptt_gemm::layernorm;

namespace {

// the bf16 layer's max-subtracted softmax, scores scaled by 1/sqrt(64)
constexpr float ATT_SCALE = 0.125f;
constexpr auto attention =
    ptt_attention::attention<ptt_attention::SOFTMAX_MAXSUB, bf16>;

}  // namespace

extern "C" {

// x [B, S, D] bf16 -> out [B, S, D] bf16.  Scratch: h [M, D] bf16,
// qkv [M, 3D] bf16, ao [M, D] bf16, x1 [M, D] f32, g [M, F] bf16 (M = B*S).
int ptt_bf16_layer(const void* x, void* out, int B, int S, int D, int H, int F,
                   int valid_len, const void* ln1s, const void* ln1b,
                   const void* wqkv, const void* bqkv, const void* wout,
                   const void* bout, const void* ln2s, const void* ln2b,
                   const void* w1, const void* b1, const void* w2,
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
  gemm<EPI_BIAS, float, bf16>(hb, D, (const bf16*)wqkv, 3 * D,
                              (const float*)bqkv, nores, 0, qkvb, 3 * D, M,
                              3 * D, D, st);
  PTT_CHECK();
  int err = attention(qkvb, (long long)S * 3 * D, 3 * D, S, qkvb + D,
                      qkvb + 2 * D, (long long)S * 3 * D, 3 * D, aob,
                      (long long)S * D, D, B, H, S, valid_len, ATT_SCALE, st);
  if (err) return err;
  gemm<EPI_BIAS_RES, bf16, float>(aob, D, (const bf16*)wout, D,
                                  (const float*)bout, xb, D, x1f, D, M, D, D,
                                  st);
  PTT_CHECK();
  layernorm<float>(x1f, D, (const float*)ln2s, (const float*)ln2b, hb, M, D, st);
  PTT_CHECK();
  gemm<EPI_BIAS_GELU, float, bf16>(hb, D, (const bf16*)w1, F,
                                   (const float*)b1, nores, 0, gb, F, M, F, D,
                                   st);
  PTT_CHECK();
  gemm<EPI_BIAS_RES, float, bf16>(gb, F, (const bf16*)w2, D, (const float*)b2,
                                  x1f, D, (bf16*)out, D, M, D, F, st);
  return (int)cudaGetLastError();
}

// x [B, S, D] bf16 -> out [B, D] bf16, row 0 of ptt_bf16_layer.  Scratch:
// h [M, D] bf16, kv [M, 2D] bf16, qc [B, D] bf16, ao [B, D] bf16,
// x1 [B, D] f32, h2 [B, D] bf16, g [B, F] bf16.
int ptt_bf16_layer_cls(const void* x, void* out, int B, int S, int D, int H,
                       int F, int valid_len, const void* ln1s,
                       const void* ln1b, const void* wqkv, const void* bqkv,
                       const void* wout, const void* bout, const void* ln2s,
                       const void* ln2b, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* h, void* kv,
                       void* qc, void* ao, void* x1, void* h2, void* g,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  const bf16* xb = (const bf16*)x;
  const bf16* w = (const bf16*)wqkv;
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
  // K and V over every row: the [D, 2D] column slice of wqkv
  gemm<EPI_BIAS, float, bf16>(hb, D, w + D, 3 * D, bq + D, nores, 0, kvb,
                              2 * D, M, 2 * D, D, st);
  PTT_CHECK();
  // Q for the CLS rows only: row 0 of each image is every S-th row of h
  gemm<EPI_BIAS, float, bf16>(hb, S * D, w, 3 * D, bq, nores, 0, qb, D, B, D,
                              D, st);
  PTT_CHECK();
  int err = attention(qb, D, D, 1, kvb, kvb + D, (long long)S * 2 * D, 2 * D,
                      aob, D, D, B, H, S, valid_len, ATT_SCALE, st);
  if (err) return err;
  gemm<EPI_BIAS_RES, bf16, float>(aob, D, (const bf16*)wout, D,
                                  (const float*)bout, xb, S * D, x1f, D, B, D,
                                  D, st);
  PTT_CHECK();
  layernorm<float>(x1f, D, (const float*)ln2s, (const float*)ln2b, h2b, B, D, st);
  PTT_CHECK();
  gemm<EPI_BIAS_GELU, float, bf16>(h2b, D, (const bf16*)w1, F,
                                   (const float*)b1, nores, 0, gb, F, B, F, D,
                                   st);
  PTT_CHECK();
  gemm<EPI_BIAS_RES, float, bf16>(gb, F, (const bf16*)w2, D, (const float*)b2,
                                  x1f, D, (bf16*)out, D, B, D, F, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
