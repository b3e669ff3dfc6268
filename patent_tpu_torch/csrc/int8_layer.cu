// The int8 serving layer of the ViT tower: the attention sub-layer, its
// CLS-only variant for the last layer, and the MLP sub-layer, with int8
// tensor-core GEMMs.
//
// Replaces the TPU kernels of patent_tpu/ops/quant_matmul.py:
//   ptt_int8_attn      _qattn_group_kernel / _qattn_block_kernel
//                      (public entry quant_attention_block)
//   ptt_int8_attn_cls  _qattn_cls_group_kernel (quant_attention_cls)
//   ptt_int8_mlp       _qmlp_block_kernel (quant_mlp_block)
// in their exact-division form (fast=False, the XLA fallback's numerics):
//
//   attention:  h = LN1(x);  (hq, hs) = rowquant(h)
//               qkv = bf16(f32(hq @ Wqkv) * hs * sqkv' + bqkv')
//                     (sqkv', bqkv': the q columns carry log2(e)/sqrt(hd))
//               p = bf16(exp2(clip(q.k, -100, 80))), pad keys 0
//               ao = (p @ v) / sum(p)                         (f32)
//               y = bf16(f32(x) + f32(rowquant(ao) @ Wout) * as * sout + bout)
//   MLP:        g = f32(rowquant(LN2(x)) @ W1) * hs * s1 + b1
//               g = g / (1 + exp2(-1.702 log2(e) g))          (f32)
//               y = bf16(f32(x) + f32(rowquant(g) @ W2) * gs * s2 + b2)
//
// rowquant(r): amax = max(max|r|, 1e-8); scale = amax * f32(1/127);
// q = rint(r / scale) (round half to even, an IEEE divide, no clip).  The
// epilogues use explicitly rounded multiplies and adds (__fmul_rn,
// __fadd_rn) in the oracle's order, so that no fused multiply-add changes
// a rounding against the plain PyTorch version.
//
// What bounds it on the H100: at ViT-B/16 @224, batch 128 (M = 26,624 rows
// of D = 768, MLP 3072) the attention sub-layer is 126 GOP of int8 GEMM
// plus 17 GFLOP of bf16 attention (~0.08 ms at the 1,979 TOP/s int8 and
// 989 TFLOP/s bf16 peaks) and the MLP 251 GOP (~0.13 ms): tensor-core
// bound.  Design (a first version, right before fast):
//   * int8 GEMMs C = epi(A[M, K] @ B[N, K]^T) on mma.sync m16n8k32 s8
//     with int32 accumulation (K * 127^2 < 2^31, exact), B held K-major
//     ([out, in], from load time), 128x128x64 block tiles in a two-stage
//     cp.async ring, the dequant / bias / quick_gelu / residual fused into
//     the epilogue;
//   * LayerNorm and the per-row quantization in one warp-per-row kernel;
//   * attention is csrc/attention.cuh in its exp2-clamp form;
//   * the TPU kernels keep ao and the [M, 3072] MLP hidden on chip; here
//     they cross device memory in f32 (a row's quantization needs the
//     whole row), which is the next thing to fuse.
// The CLS variant runs LN1 + quant and the K/V projections over every row
// and the rest on row 0 of each image only, through the same kernels and
// the same per-element operations, so it equals row 0 of ptt_int8_attn
// bit for bit.

#include <stdint.h>

#include "attention.cuh"
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int QG_BM = 128, QG_BN = 128, QG_BK = 64;
constexpr int QG_THREADS = 256;
constexpr int QG_LD = QG_BK + 16;     // bytes per shared row (bank skew)
constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float NEG_1702_LOG2E = (float)(-1.702 * 1.4426950408889634);

enum QEpi { QEPI_BF16 = 0, QEPI_GELU_F32 = 1, QEPI_RES_BF16 = 2 };

// C[M, N] = epi(f32(A @ Bt^T) * rs[r * rs_stride] * cs[c] + bias[c]) with
// A [M, K] and Bt [N, K] int8 row-major.  K, lda, ldb are multiples of 16
// and A, Bt 16-byte aligned (checked by the host code).  8 warps, 2 x 4,
// each 64 x 32 of the 128 x 128 block tile.
template <int EPI, typename OutT>
__global__ void __launch_bounds__(QG_THREADS)
    gemm_s8_kernel(const int8_t* __restrict__ A, int lda,
                   const float* __restrict__ rs, int rs_stride,
                   const int8_t* __restrict__ Bt, int ldb,
                   const float* __restrict__ cs,
                   const float* __restrict__ bias,
                   const bf16* __restrict__ res, int ldr,
                   OutT* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(128) int8_t As[2][QG_BM][QG_LD];
  __shared__ __align__(128) int8_t Bs[2][QG_BN][QG_LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * QG_BM, n0 = blockIdx.x * QG_BN;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * QG_BK;
    for (int c = tid; c < QG_BM * QG_BK / 16; c += QG_THREADS) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      ptt::cp_async16(&As[stage][r][kc], ok ? A + (size_t)gr * lda + gk : A,
                      ok);
    }
    for (int c = tid; c < QG_BN * QG_BK / 16; c += QG_THREADS) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gn = n0 + r, gk = k0 + kc;
      const bool ok = gn < N && gk < K;
      ptt::cp_async16(&Bs[stage][r][kc], ok ? Bt + (size_t)gn * ldb + gk : Bt,
                      ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + QG_BK - 1) / QG_BK;
  load_tile(0, 0);
  ptt::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < QG_BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        a[i][0] = ptt::ld32(&As[st][r][kk + t * 4]);
        a[i][1] = ptt::ld32(&As[st][r + 8][kk + t * 4]);
        a[i][2] = ptt::ld32(&As[st][r][kk + 16 + t * 4]);
        a[i][3] = ptt::ld32(&As[st][r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        b[j][0] = ptt::ld32(&Bs[st][n][kk + t * 4]);
        b[j][1] = ptt::ld32(&Bs[st][n][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ptt::mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue from registers: element e of tile (i, j) sits at row
  // g + 8 * (e >> 1), column 2 * t + (e & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + wm * 64 + i * 16 + g + 8 * (e >> 1);
      if (r >= M) continue;
      const float rsc = rs[(size_t)r * rs_stride];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (c >= N) continue;
        float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), rsc), cs[c]),
            bias[c]);
        if constexpr (EPI == QEPI_GELU_F32)
          v = __fdiv_rn(v, __fadd_rn(1.0f, exp2f(__fmul_rn(NEG_1702_LOG2E, v))));
        if constexpr (EPI == QEPI_RES_BF16)
          v = __fadd_rn(__bfloat162float(res[(size_t)r * ldr + c]), v);
        ptt::store_f(&C[(size_t)r * ldc + c], v);
      }
    }
  }
}

// One warp per row: [LayerNorm (f32 statistics, eps 1e-5), then] the
// per-row int8 quantization.  Writes q [M, D] int8 and its scale qs [M].
// The row is read again in each pass (it stays in L1/L2) and every pass
// recomputes the same f32 values.
template <bool LN, typename InT>
__global__ void rowquant_kernel(const InT* __restrict__ x, int ldx,
                                const float* __restrict__ lns,
                                const float* __restrict__ lnb,
                                int8_t* __restrict__ q, int ldq,
                                float* __restrict__ qs, int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const InT* xr = x + (size_t)row * ldx;
  float mu = 0.0f, rstd = 1.0f;
  if constexpr (LN) {
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += ptt::to_f(xr[c]);
    mu = __fdiv_rn(ptt::warp_sum(s), (float)D);
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = __fsub_rn(ptt::to_f(xr[c]), mu);
      v = __fadd_rn(v, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(ptt::warp_sum(v), (float)D);
    rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  }
  auto val = [&](int c) {
    const float xv = ptt::to_f(xr[c]);
    if constexpr (LN)
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv, mu), rstd), lns[c]),
                       lnb[c]);
    else
      return xv;
  };
  float amax = 0.0f;
  for (int c = lane; c < D; c += 32) amax = fmaxf(amax, fabsf(val(c)));
  const float sc = __fmul_rn(fmaxf(ptt::warp_max(amax), 1e-8f), INV127);
  int8_t* qr = q + (size_t)row * ldq;
  for (int c = lane; c < D; c += 32)
    qr[c] = (int8_t)__float2int_rn(__fdiv_rn(val(c), sc));
  if (lane == 0) qs[row] = sc;
}

template <int EPI, typename OutT>
int gemm_s8(const int8_t* A, int lda, const float* rs, int rs_stride,
            const int8_t* Bt, int ldb, const float* cs, const float* bias,
            const bf16* res, int ldr, OutT* C, int ldc, int M, int N, int K,
            cudaStream_t st) {
  dim3 grid((N + QG_BN - 1) / QG_BN, (M + QG_BM - 1) / QG_BM);
  gemm_s8_kernel<EPI, OutT><<<grid, QG_THREADS, 0, st>>>(
      A, lda, rs, rs_stride, Bt, ldb, cs, bias, res, ldr, C, ldc, M, N, K);
  return (int)cudaGetLastError();
}

template <bool LN, typename InT>
int rowquant(const InT* x, int ldx, const float* lns, const float* lnb,
             int8_t* q, int ldq, float* qs, int M, int D, cudaStream_t st) {
  rowquant_kernel<LN, InT><<<(M + 7) / 8, 256, 0, st>>>(x, ldx, lns, lnb, q,
                                                        ldq, qs, M, D);
  return (int)cudaGetLastError();
}

constexpr auto attention =
    ptt_attention::attention<ptt_attention::SOFTMAX_EXP2_CLAMP, float>;

}  // namespace

#define PTT_TRY(call)          \
  do {                         \
    const int e_ = (call);     \
    if (e_ != 0) return e_;    \
  } while (0)

extern "C" {

// x [B, S, D] bf16 -> out [B, S, D] bf16.  wqkv_t [3D, D], wout_t [D, D]
// int8 ([out, in]); sq, bq [3D] with the q columns folded; sout, bout,
// lns, lnb [D] f32.  Scratch: hq [M, D] int8 and hs [M] f32 (LN1's codes,
// then ao's), qkv [M, 3D] bf16, ao [M, D] f32 (M = B*S).
int ptt_int8_attn(const void* x, void* out, int B, int S, int D, int H,
                  int valid_len, const void* lns, const void* lnb,
                  const void* wqkv_t, const void* sq, const void* bq,
                  const void* wout_t, const void* sout, const void* bout,
                  void* hq, void* hs, void* qkv, void* ao, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  const bf16* xb = (const bf16*)x;
  int8_t* hq8 = (int8_t*)hq;
  float* hsf = (float*)hs;
  bf16* qkvb = (bf16*)qkv;
  float* aof = (float*)ao;

  PTT_TRY((rowquant<true, bf16>(xb, D, (const float*)lns, (const float*)lnb,
                                hq8, D, hsf, M, D, st)));
  PTT_TRY((gemm_s8<QEPI_BF16, bf16>(hq8, D, hsf, 1, (const int8_t*)wqkv_t, D,
                                    (const float*)sq, (const float*)bq,
                                    nullptr, 0, qkvb, 3 * D, M, 3 * D, D, st)));
  PTT_TRY(attention(qkvb, (long long)S * 3 * D, 3 * D, S, qkvb + D,
                    qkvb + 2 * D, (long long)S * 3 * D, 3 * D, aof,
                    (long long)S * D, D, B, H, S, valid_len, 1.0f, st));
  PTT_TRY((rowquant<false, float>(aof, D, nullptr, nullptr, hq8, D, hsf, M, D,
                                  st)));
  return gemm_s8<QEPI_RES_BF16, bf16>(hq8, D, hsf, 1, (const int8_t*)wout_t, D,
                                      (const float*)sout, (const float*)bout,
                                      xb, D, (bf16*)out, D, M, D, D, st);
}

// x [B, S, D] bf16 -> out [B, D] bf16, row 0 of ptt_int8_attn.  Scratch:
// hq [M, D] int8, hs [M] f32, kv [M, 2D] bf16, qc [B, D] bf16, ao [B, D]
// f32, aq [B, D] int8, as [B] f32.
int ptt_int8_attn_cls(const void* x, void* out, int B, int S, int D, int H,
                      int valid_len, const void* lns, const void* lnb,
                      const void* wqkv_t, const void* sq, const void* bq,
                      const void* wout_t, const void* sout, const void* bout,
                      void* hq, void* hs, void* kv, void* qc, void* ao,
                      void* aq, void* as, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  const bf16* xb = (const bf16*)x;
  const int8_t* w = (const int8_t*)wqkv_t;
  const float* sqf = (const float*)sq;
  const float* bqf = (const float*)bq;
  int8_t* hq8 = (int8_t*)hq;
  float* hsf = (float*)hs;
  bf16* kvb = (bf16*)kv;
  bf16* qcb = (bf16*)qc;
  float* aof = (float*)ao;
  int8_t* aq8 = (int8_t*)aq;
  float* asf = (float*)as;

  PTT_TRY((rowquant<true, bf16>(xb, D, (const float*)lns, (const float*)lnb,
                                hq8, D, hsf, M, D, st)));
  // K and V over every row: rows D..3D of wqkv_t
  PTT_TRY((gemm_s8<QEPI_BF16, bf16>(hq8, D, hsf, 1, w + (size_t)D * D, D,
                                    sqf + D, bqf + D, nullptr, 0, kvb, 2 * D,
                                    M, 2 * D, D, st)));
  // Q for the CLS rows only: row 0 of each image is every S-th row of hq
  PTT_TRY((gemm_s8<QEPI_BF16, bf16>(hq8, S * D, hsf, S, w, D, sqf, bqf,
                                    nullptr, 0, qcb, D, B, D, D, st)));
  PTT_TRY(attention(qcb, D, D, 1, kvb, kvb + D, (long long)S * 2 * D, 2 * D,
                    aof, D, D, B, H, S, valid_len, 1.0f, st));
  PTT_TRY((rowquant<false, float>(aof, D, nullptr, nullptr, aq8, D, asf, B, D,
                                  st)));
  return gemm_s8<QEPI_RES_BF16, bf16>(aq8, D, asf, 1, (const int8_t*)wout_t, D,
                                      (const float*)sout, (const float*)bout,
                                      xb, S * D, (bf16*)out, D, B, D, D, st);
}

// x [M, D] bf16 -> out [M, D] bf16.  w1_t [F, D], w2_t [D, F] int8
// ([out, in]); s1, b1 [F], s2, b2, lns, lnb [D] f32.  Scratch: hq [M, D]
// int8, hs [M] f32, g [M, F] f32, gq [M, F] int8, gs [M] f32.
int ptt_int8_mlp(const void* x, void* out, int M, int D, int F,
                 const void* lns, const void* lnb, const void* w1_t,
                 const void* s1, const void* b1, const void* w2_t,
                 const void* s2, const void* b2, void* hq, void* hs, void* g,
                 void* gq, void* gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  int8_t* hq8 = (int8_t*)hq;
  float* hsf = (float*)hs;
  float* gf = (float*)g;
  int8_t* gq8 = (int8_t*)gq;
  float* gsf = (float*)gs;

  PTT_TRY((rowquant<true, bf16>(xb, D, (const float*)lns, (const float*)lnb,
                                hq8, D, hsf, M, D, st)));
  PTT_TRY((gemm_s8<QEPI_GELU_F32, float>(hq8, D, hsf, 1, (const int8_t*)w1_t,
                                         D, (const float*)s1, (const float*)b1,
                                         nullptr, 0, gf, F, M, F, D, st)));
  PTT_TRY((rowquant<false, float>(gf, F, nullptr, nullptr, gq8, F, gsf, M, F,
                                  st)));
  return gemm_s8<QEPI_RES_BF16, bf16>(gq8, F, gsf, 1, (const int8_t*)w2_t, F,
                                      (const float*)s2, (const float*)b2, xb,
                                      D, (bf16*)out, D, M, D, F, st);
}

}  // extern "C"
