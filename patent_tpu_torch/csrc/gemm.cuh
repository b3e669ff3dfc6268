// The bf16 tensor-core GEMM of the trainable MLP block's forward (row 15,
// csrc/mlp_grad.cu) and the warp-per-row LayerNorm, shared by the serving
// layer (csrc/bf16_layer.cu) and the trainable MLP block.
//
//   C[M, N] = epi(A[M, K] @ B[K, N] + bias)  bf16 operands, f32 accumulation
//
// A and B row-major.  128x128x32 block tiles, 8 warps of 64x32 on
// nvcuda::wmma, a two-stage cp.async ring.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ptt_gemm {

using namespace nvcuda;
using ptt::bf16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;       // A tile [BM][BK]
constexpr int B_LD = BN + 8;       // B tile [BK][BN]
constexpr float NEG_1702_LOG2E = (float)(-1.702 * 1.4426950408889634);

enum Epi {
  EPI_BIAS_RES = 2,    // v + bias + res
  EPI_BIAS_GELU2 = 3,  // g = v + bias; C = g * sigmoid(1.702 g), exp2 form
};

// K, N, lda, ldb multiples of 8 and A, B 16-byte aligned (checked by the
// host code).
template <int EPI, typename ResT, typename OutT>
__global__ void __launch_bounds__(THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, int lda,
                     const bf16* __restrict__ B, int ldb,
                     const float* __restrict__ bias,
                     const ResT* __restrict__ res, int ldr,
                     OutT* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][BM * A_LD];
  __shared__ __align__(128) bf16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      ptt::cp_async16(&As[stage][r * A_LD + kc],
                      ok ? A + (size_t)gr * lda + gk : A, ok);
    }
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      ptt::cp_async16(&Bs[stage][r * B_LD + nc],
                      ok ? B + (size_t)gk * ldb + gn : B, ok);
    }
  };

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  ptt::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[4];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm * 64 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk * B_LD + wn * 32 + j * 16],
                               B_LD);
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
            if constexpr (EPI == EPI_BIAS_RES)
              v += ptt::to_f(res[(size_t)gr * ldr + gc]);
            else
              v = v * (1.0f / (1.0f + exp2f(NEG_1702_LOG2E * v)));
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

template <int EPI, typename ResT, typename OutT>
void gemm(const bf16* A, int lda, const bf16* B, int ldb, const float* bias,
          const ResT* res, int ldr, OutT* C, int ldc, int M, int N, int K,
          cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<EPI, ResT, OutT><<<grid, THREADS, 0, st>>>(
      A, lda, B, ldb, bias, res, ldr, C, ldc, M, N, K);
}

template <typename InT>
void layernorm(const InT* x, int ldx, const float* s, const float* b, bf16* out,
               int M, int D, cudaStream_t st) {
  layernorm_kernel<InT><<<(M + 7) / 8, 256, 0, st>>>(x, ldx, s, b, out, D, M, D);
}

}  // namespace ptt_gemm

#define PTT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
