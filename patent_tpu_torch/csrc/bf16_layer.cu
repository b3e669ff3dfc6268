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

#include <mma.h>

#include "attention.cuh"
#include "common.cuh"

using namespace nvcuda;
using ptt::bf16;

namespace {

constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int A_LD = GEMM_BK + 8;
constexpr int B_LD = GEMM_BN + 8;

enum Epi { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };

// C[M, N] = epi(A[M, K] @ B[K, N] + bias) with A, B bf16 row-major and f32
// accumulation.  K, N, lda, ldb are multiples of 8 and A, B 16-byte
// aligned (checked by the host code).
template <int EPI, typename ResT, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, int lda,
                     const bf16* __restrict__ B, int ldb,
                     const float* __restrict__ bias,
                     const ResT* __restrict__ res, int ldr,
                     OutT* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][GEMM_BM][A_LD];
  __shared__ __align__(128) bf16 Bs[2][GEMM_BK][B_LD];
  __shared__ __align__(128) float Cs[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * GEMM_BK;
    for (int c = tid; c < GEMM_BM * GEMM_BK / 8; c += GEMM_THREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      ptt::cp_async16(&As[stage][r][kc], ok ? A + (size_t)gr * lda + gk : A,
                      ok);
    }
    for (int c = tid; c < GEMM_BK * GEMM_BN / 8; c += GEMM_THREADS) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      ptt::cp_async16(&Bs[stage][r][nc], ok ? B + (size_t)gk * ldb + gn : B,
                      ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + GEMM_BK - 1) / GEMM_BK;
  load_tile(0, 0);
  ptt::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[st][wm * 64 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in its own
  // shared slot, then 32 lanes apply bias / activation / residual
  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc0 = n0 + wn * 32 + j * 16 + c0;
      if (gr < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gc = gc0 + e;
          if (gc < N) {
            float v = cs[r * 16 + c0 + e] + bias[gc];
            if constexpr (EPI == EPI_BIAS_GELU) v = v / (1.0f + expf(-1.702f * v));
            if constexpr (EPI == EPI_BIAS_RES) v += ptt::to_f(res[(size_t)gr * ldr + gc]);
            ptt::store_f(&C[(size_t)gr * ldc + gc], v);
          }
        }
      }
      __syncwarp();
    }
  }
}

// One warp per row: f32 statistics, bf16 output.
template <typename InT>
__global__ void layernorm_kernel(const InT* __restrict__ x, int ldx,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ out, int ldo, int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const InT* xr = x + (size_t)row * ldx;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += ptt::to_f(xr[c]);
  const float mu = ptt::warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = ptt::to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(ptt::warp_sum(v) / D + 1e-5f);
  bf16* orow = out + (size_t)row * ldo;
  for (int c = lane; c < D; c += 32)
    orow[c] = __float2bfloat16((ptt::to_f(xr[c]) - mu) * rstd * scale[c] + bias[c]);
}

// the bf16 layer's max-subtracted softmax, scores scaled by 1/sqrt(64)
constexpr float ATT_SCALE = 0.125f;
constexpr auto attention =
    ptt_attention::attention<ptt_attention::SOFTMAX_MAXSUB, bf16>;

template <int EPI, typename ResT, typename OutT>
void gemm(const bf16* A, int lda, const bf16* B, int ldb, const float* bias,
          const ResT* res, int ldr, OutT* C, int ldc, int M, int N, int K,
          cudaStream_t st) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI, ResT, OutT><<<grid, GEMM_THREADS, 0, st>>>(
      A, lda, B, ldb, bias, res, ldr, C, ldc, M, N, K);
}

template <typename InT>
void layernorm(const InT* x, int ldx, const float* s, const float* b, bf16* out,
               int M, int D, cudaStream_t st) {
  layernorm_kernel<InT><<<(M + 7) / 8, 256, 0, st>>>(x, ldx, s, b, out, D, M, D);
}

}  // namespace

#define PTT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

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
