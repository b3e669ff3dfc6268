// The trainable MLP block of the fine-tune tower, x + mlp(LN(x)), forward
// and backward.
//
// Replaces the TPU kernels of patent_tpu/ops/bf16_mlp_grad.py:
//   ptt_mlp_fwd   _mlp_fwd_kernel (public entry fused_mlp_block_bf16)
//   ptt_mlp_bwd   _mlp_bwd_kernel (its custom VJP's backward)
//
//   h = bf16(LN(x))                       (f32 statistics, eps 1e-5)
//   g = h W1 + b1;  s = 1 / (1 + exp2(-1.702 log2(e) g));  a = bf16(g s)
//   out = bf16(x + a W2 + b2)
// Backward (from the saved inputs only: the hidden is recomputed):
//   dW2 = a^T do;  db2 = sum do;  da = do W2^T
//   dg = da s (1 + 1.702 g (1 - s));  dW1 = h^T bf16(dg);  db1 = sum dg
//   dh = bf16(dg) W1^T;  dLN-bias = sum dh;  dLN-scale = sum dh xn
//   dx = bf16(do + (dh lns - mean(dh lns) - xn mean(dh lns xn)) rstd)
// with bf16 operands and f32 accumulation in every product, and the six
// parameter cotangents summed in f32 over all rows.
//
// What bounds it on the H100: at 64 pairs (M = 128 x 197 = 25,216 rows,
// D = 768, F = 3072) the forward is 238 GFLOP and the backward 595 GFLOP
// of tensor-core work against well under 1 GB of traffic: both are bound
// by the tensor cores.  Design (right before fast):
//   * the forward is the MLP half of the serving layer: the shared
//     LayerNorm, then the shared GEMM (csrc/gemm.cuh) with +bias and the
//     exp2 quick_gelu, then with +bias and the bf16 residual;
//   * the backward walks the rows in chunks of up to 8,192: per chunk it
//     recomputes h and g (the hidden [chunk, 3072] lives in device memory
//     only inside the call), and runs the weight-gradient products as the
//     shared GEMM with its A operand transposed (a reduction over the
//     chunk's rows) into f32 sums that the next chunk adds to, and the
//     input-gradient products with B transposed; column sums give the
//     bias and LayerNorm cotangents.  The TPU kernel does the same work
//     one 256-row tile at a time in fast memory; keeping the chunk's
//     hidden out of device memory is later work.

#include "common.cuh"
#include "gemm.cuh"

using ptt::bf16;
using ptt_gemm::gemm;

namespace {

// out[c] += sum over rows of x[r, c]: 32 columns x 8 row groups a block,
// each block a slab of ROWS rows, summed into out with atomics.
constexpr int CS_ROWS = 256;

template <typename InT>
__global__ void colsum_kernel(const InT* __restrict__ x, int ld, int M, int N,
                              float* __restrict__ out) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int g = threadIdx.x >> 5;
  const int r0 = blockIdx.y * CS_ROWS;
  const int r1 = min(M, r0 + CS_ROWS);
  float s = 0.0f;
  if (c < N)
    for (int r = r0 + g; r < r1; r += 8) s += ptt::to_f(x[(size_t)r * ld + c]);
  part[g][threadIdx.x & 31] = s;
  __syncthreads();
  if (g == 0 && c < N) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x & 31];
    atomicAdd(&out[c], t);
  }
}

template <typename InT>
int colsum(const InT* x, int ld, int M, int N, float* out, cudaStream_t st) {
  dim3 grid((N + 31) / 32, (M + CS_ROWS - 1) / CS_ROWS);
  colsum_kernel<InT><<<grid, 256, 0, st>>>(x, ld, M, N, out);
  return (int)cudaGetLastError();
}

// One warp per row: LayerNorm backward.  Recomputes the row's statistics
// as the forward LayerNorm does, writes dx (bf16) and replaces dh by
// dh * xn (summed over rows afterwards into dLN-scale).
__global__ void ln_bwd_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lns,
                              float* __restrict__ dh, bf16* __restrict__ dx,
                              int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float* dhr = dh + (size_t)row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
  const float mu = ptt::warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(ptt::warp_sum(v) / D + 1e-5f);
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float xn = (__bfloat162float(xr[c]) - mu) * rstd;
    const float dxn = dhr[c] * lns[c];
    m1 += dxn;
    m2 += dxn * xn;
  }
  m1 = ptt::warp_sum(m1) / D;
  m2 = ptt::warp_sum(m2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xn = (__bfloat162float(xr[c]) - mu) * rstd;
    const float dxn = dhr[c] * lns[c];
    dx[(size_t)row * D + c] = __float2bfloat16(
        __bfloat162float(dout[(size_t)row * D + c])
        + (dxn - m1 - xn * m2) * rstd);
    dhr[c] = dhr[c] * xn;
  }
}

}  // namespace

extern "C" {

// x [M, D] bf16 -> out [M, D] bf16.  w1 [D, F], w2 [F, D] bf16; lns, lnb,
// b2 [D], b1 [F] f32.  Scratch: h [M, D] bf16, a [M, F] bf16.
int ptt_mlp_fwd(const void* x, void* out, int M, int D, int F,
                const void* lns, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* h,
                void* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  bf16* hb = (bf16*)h;
  bf16* ab = (bf16*)a;
  const float* nores = nullptr;
  ptt_gemm::layernorm<bf16>(xb, D, (const float*)lns, (const float*)lnb, hb,
                            M, D, st);
  PTT_CHECK();
  gemm<ptt_gemm::EPI_BIAS_GELU2, float, bf16>(hb, D, (const bf16*)w1, F,
                                              (const float*)b1, nores, 0, ab,
                                              F, M, F, D, st);
  PTT_CHECK();
  gemm<ptt_gemm::EPI_BIAS_RES, bf16, bf16>(ab, F, (const bf16*)w2, D,
                                           (const float*)b2, xb, D,
                                           (bf16*)out, D, M, D, F, st);
  return (int)cudaGetLastError();
}

// x, dout [M, D] bf16 -> dx [M, D] bf16 and the f32 sums dls, dlb [D],
// dw1 [D, F], db1 [F], dw2 [F, D], db2 [D], which the caller zeroes.
// Rows go in chunks of `chunk`.  Scratch for one chunk: h [chunk, D] bf16,
// a [chunk, F] bf16, g [chunk, F] f32, dg [chunk, F] bf16, dh [chunk, D]
// f32.
int ptt_mlp_bwd(const void* x, const void* dout, const void* lns,
                const void* lnb, const void* w1, const void* b1,
                const void* w2, void* dx, void* dls, void* dlb, void* dw1,
                void* db1, void* dw2, void* db2, int M, int D, int F,
                int chunk, void* h, void* a, void* g, void* dg, void* dh,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* nores = nullptr;
  const bf16* w1b = (const bf16*)w1;
  const bf16* w2b = (const bf16*)w2;
  bf16* hb = (bf16*)h;
  bf16* ab = (bf16*)a;
  float* gf = (float*)g;
  bf16* dgb = (bf16*)dg;
  float* dhf = (float*)dh;
  for (int r0 = 0; r0 < M; r0 += chunk) {
    const int mc = M - r0 < chunk ? M - r0 : chunk;
    const bf16* xc = (const bf16*)x + (size_t)r0 * D;
    const bf16* dc = (const bf16*)dout + (size_t)r0 * D;
    ptt_gemm::layernorm<bf16>(xc, D, (const float*)lns, (const float*)lnb,
                              hb, mc, D, st);
    PTT_CHECK();
    // g (f32) and a = bf16(quick_gelu(g))
    gemm<ptt_gemm::EPI_BIAS_GELU2, float, bf16>(hb, D, w1b, F,
                                                (const float*)b1, nores, 0,
                                                ab, F, mc, F, D, st, gf);
    PTT_CHECK();
    // dW2 += a^T do
    gemm<ptt_gemm::EPI_ACC, float, float, true, false>(
        ab, F, dc, D, nullptr, nores, 0, (float*)dw2, D, F, D, mc, st);
    PTT_CHECK();
    PTT_TRY(colsum<bf16>(dc, D, mc, D, (float*)db2, st));
    // dg = (do W2^T) quick_gelu'(g): bf16 into dg, f32 over g
    gemm<ptt_gemm::EPI_DGELU, float, bf16, false, true>(
        dc, D, w2b, D, nullptr, nores, 0, dgb, F, mc, F, D, st, gf);
    PTT_CHECK();
    PTT_TRY(colsum<float>(gf, F, mc, F, (float*)db1, st));
    // dW1 += h^T bf16(dg)
    gemm<ptt_gemm::EPI_ACC, float, float, true, false>(
        hb, D, dgb, F, nullptr, nores, 0, (float*)dw1, F, D, F, mc, st);
    PTT_CHECK();
    // dh = bf16(dg) W1^T
    gemm<ptt_gemm::EPI_NONE, float, float, false, true>(
        dgb, F, w1b, F, nullptr, nores, 0, dhf, D, mc, D, F, st);
    PTT_CHECK();
    PTT_TRY(colsum<float>(dhf, D, mc, D, (float*)dlb, st));
    ln_bwd_kernel<<<(mc + 7) / 8, 256, 0, st>>>(
        xc, dc, (const float*)lns, dhf, (bf16*)dx + (size_t)r0 * D, mc, D);
    PTT_CHECK();
    PTT_TRY(colsum<float>(dhf, D, mc, D, (float*)dls, st));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
