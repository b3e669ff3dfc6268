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
// by the tensor cores.  Design: every product runs on csrc/wgmma_gemm.cuh
// (TMA and wgmma, 128 x 256 tiles, a persistent block an SM, the
// epilogue on the accumulator registers), which takes B as its transpose
// [N, K]: the caller passes W1^T [F, D] and W2^T [D, F] where a product
// needs them.
//   * the forward: the shared LayerNorm (csrc/layernorm.cuh), then
//     g = h W1 + b1 with the exp2 quick_gelu in its epilogue (the backward
//     recompute's epilogue without the f32 g: the same bits of a), then
//     a W2 + b2 with the bf16 residual added as x + (a W2 + b2);
//   * the backward's recompute g = h W1 + b1 writes the f32 g and
//     a = bf16(quick_gelu(g)) from its accumulators; da = do W2^T runs
//     dgelu in its epilogue, reading g, writing bf16(dg) and each warp's
//     16-row column sums of dg (db1's partials); dh = bf16(dg) W1^T stores
//     f32.  The weight gradients dW2 = a^T do and dW1 = h^T dg read the
//     row-major activations as MN-major tiles (wgmma's transpose bits) and
//     split the rows across CTAs into f32 partials, so that their 72
//     output tiles fill the card;
//   * the LayerNorm backward (a warp a row, a fixed count of blocks) also
//     takes the column sums of dh, dh xn and do as per-block partials;
//   * every partial is added in a fixed order (split, slab, block), so two
//     runs give the same bits, with no atomics; the three kinds of
//     partials are never live at once and share one buffer;
//   * the backward's rows go in chunks (the caller's, up to 32,768: the
//     fine-tune's 25,216 rows are one), the f32 g of a chunk in device
//     memory (310 MB at the fine-tune's shape).

#include <initializer_list>

#include "common.cuh"
#include "layernorm.cuh"
#include "wgmma_gemm.cuh"

using ptt::bf16;

namespace {

constexpr int LN_WARPS = 8;
// blocks of the LayerNorm backward: a fixed count, so that its column sums
// are added in one order at every call
constexpr int LN_BLOCKS = 256;

// out[c] += sum over p of parts[p * ld + c], p in order: 32 columns x 32
// strided groups of parts a block, the groups then added in order
__global__ void colsum_parts_kernel(const float* __restrict__ parts,
                                    int nparts, long long ld, int n,
                                    float* __restrict__ out) {
  __shared__ float sum[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < n)
    for (int p = threadIdx.y; p < nparts; p += 32) s += parts[p * ld + c];
  sum[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) t += sum[i][threadIdx.x];
    out[c] += t;
  }
}

int colsum_parts(const float* parts, int nparts, long long ld, int n,
                 float* out, cudaStream_t st) {
  colsum_parts_kernel<<<(n + 31) / 32, dim3(32, 32), 0, st>>>(
      parts, nparts, ld, n, out);
  return (int)cudaGetLastError();
}

// out[i] += sum over s of part[s * n + i], s in order (the split-K
// partials of a weight gradient), four elements a thread
__global__ void sum_splits_kernel(const float4* __restrict__ part,
                                  int splits, long long n4,
                                  float4* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 t = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = part[s * n4 + i];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    float4 o = out[i];
    o.x += t.x;
    o.y += t.y;
    o.z += t.z;
    o.w += t.w;
    out[i] = o;
  }
}

// out [M, N] += A^T B over K rows (A [K, M], B [K, N] row-major): the
// MN-major GEMM's partials over the ranges of ptt_wgmma::tn_splits' plan,
// then their sum in range order; part holds splits x M x N f32
int weight_grad(const bf16* A, int M, const bf16* B, int N, int K,
                float* part, float* out, cudaStream_t st) {
  int splits = 0;
  PTT_TRY(ptt_wgmma::tn_splits(M, N, K, &splits));
  PTT_TRY(ptt_wgmma::gemm_tn(A, M, B, N, part, M, N, K, splits, st));
  const long long n4 = (long long)M * N / 4;      // N % 8 == 0
  sum_splits_kernel<<<(int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256
                                                    : 4096),
                      256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                    splits, n4,
                                    reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// The LayerNorm backward, a warp a row, LN_BLOCKS blocks walking the rows:
// recomputes the row's statistics as the forward LayerNorm does, writes dx
// (bf16), and sums dh, dh xn and do over its block's rows into part
// [LN_BLOCKS, 3, D] (dLN-bias, dLN-scale and db2, each block's
// warps added in order).  Dynamic shared memory: LN_WARPS x 3 x D f32.
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                  const float* __restrict__ lns, const float* __restrict__ dh,
                  bf16* __restrict__ dx, float* __restrict__ part, int M,
                  int D) {
  extern __shared__ float acc[];          // [LN_WARPS][3][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = acc + (size_t)warp * 3 * D;
  for (int c = lane; c < 3 * D; c += 32) mine[c] = 0.0f;
  for (int row = blockIdx.x * LN_WARPS + warp; row < M;
       row += gridDim.x * LN_WARPS) {
    const bf16* xr = x + (size_t)row * D;
    const bf16* dor = dout + (size_t)row * D;
    const float* dhr = dh + (size_t)row * D;
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
      const float dhv = dhr[c];
      const float dov = __bfloat162float(dor[c]);
      const float dxn = dhv * lns[c];
      dx[(size_t)row * D + c] =
          __float2bfloat16(dov + (dxn - m1 - xn * m2) * rstd);
      mine[c] += dhv;
      mine[D + c] += dhv * xn;
      mine[2 * D + c] += dov;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) t += acc[(size_t)w * 3 * D + c];
    part[(size_t)blockIdx.x * 3 * D + c] = t;
  }
}

}  // namespace

extern "C" {

// x [M, D] bf16 -> out [M, D] bf16.  w1t = W1^T [F, D], w2t = W2^T
// [D, F] bf16; lns, lnb, b2 [D], b1 [F] f32.  Scratch: h [M, D] bf16,
// a [M, F] bf16.
int ptt_mlp_fwd(const void* x, void* out, int M, int D, int F,
                const void* lns, const void* lnb, const void* w1t,
                const void* b1, const void* w2t, const void* b2, void* h,
                void* a, void* stream) {
  namespace wg = ptt_wgmma;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  bf16* hb = (bf16*)h;
  bf16* ab = (bf16*)a;
  const float* nores = nullptr;
  ptt::layernorm<bf16>(xb, D, (const float*)lns, (const float*)lnb, hb, M, D,
                       st);
  PTT_CHECK();
  // a = bf16(quick_gelu(h W1 + b1))
  PTT_TRY((wg::gemm<wg::EPI_BIAS_QGELU, float, bf16>(
      hb, D, (const bf16*)w1t, D, (const float*)b1, nores, 0, ab, F, M, F, D,
      st)));
  // out = bf16(x + (a W2 + b2))
  return wg::gemm<wg::EPI_BIAS_RES, bf16, bf16>(
      ab, F, (const bf16*)w2t, F, (const float*)b2, xb, D, (bf16*)out, D, M,
      D, F, st);
}

// The f32 values of ptt_mlp_bwd's partials buffer for M rows in chunks of
// `chunk`: the weight gradients' split partials (each chunk's own plan),
// db1's slabs and the LayerNorm backward's block partials, whichever is
// largest.
int ptt_mlp_bwd_part(int M, int chunk, int D, int F, long long* floats) {
  long long n = (long long)LN_BLOCKS * 3 * D;
  for (int mc : {M < chunk ? M : chunk, M % chunk}) {
    if (mc < 1) continue;
    int s2 = 0, s1 = 0;
    PTT_TRY(ptt_wgmma::tn_splits(F, D, mc, &s2));
    PTT_TRY(ptt_wgmma::tn_splits(D, F, mc, &s1));
    const long long parts = (long long)(s2 > s1 ? s2 : s1) * D * F;
    const long long slabs = (long long)(mc + ptt_wgmma::BM - 1) /
                            ptt_wgmma::BM * (ptt_wgmma::BM / 16) * F;
    n = parts > n ? parts : n;
    n = slabs > n ? slabs : n;
  }
  *floats = n;
  return 0;
}

// x, dout [M, D] bf16 -> dx [M, D] bf16 and the f32 sums dls, dlb [D],
// dw1 [D, F], db1 [F], dw2 [F, D], db2 [D], which the caller zeroes.
// w1 [D, F] and w1t = W1^T [F, D], w2 [F, D] bf16.  Rows go in chunks of
// `chunk`.  Scratch for one chunk: h [chunk, D] bf16, a [chunk, F] bf16,
// g [chunk, F] f32, dg [chunk, F] bf16, dh [chunk, D] f32, part
// (ptt_mlp_bwd_part's f32 values).
int ptt_mlp_bwd(const void* x, const void* dout, const void* lns,
                const void* lnb, const void* w1, const void* w1t,
                const void* b1, const void* w2, void* dx, void* dls,
                void* dlb, void* dw1, void* db1, void* dw2, void* db2, int M,
                int D, int F, int chunk, void* h, void* a, void* g, void* dg,
                void* dh, void* part, void* stream) {
  namespace wg = ptt_wgmma;
  cudaStream_t st = (cudaStream_t)stream;
  const float* nores = nullptr;
  bf16* hb = (bf16*)h;
  bf16* ab = (bf16*)a;
  float* gf = (float*)g;
  bf16* dgb = (bf16*)dg;
  float* dhf = (float*)dh;
  float* partf = (float*)part;       // the split partials, the slabs and
                                     // the LayerNorm's partials in turn
  const size_t ln_smem = (size_t)LN_WARPS * 3 * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ln_smem);
  if (err != cudaSuccess) return (int)err;
  for (int r0 = 0; r0 < M; r0 += chunk) {
    const int mc = M - r0 < chunk ? M - r0 : chunk;
    const bf16* xc = (const bf16*)x + (size_t)r0 * D;
    const bf16* dc = (const bf16*)dout + (size_t)r0 * D;
    ptt::layernorm<bf16>(xc, D, (const float*)lns, (const float*)lnb, hb,
                         mc, D, st);
    PTT_CHECK();
    // g (f32) and a = bf16(quick_gelu(g))
    PTT_TRY((wg::gemm<wg::EPI_BIAS_GELU_AUX, float, bf16>(
        hb, D, (const bf16*)w1t, D, (const float*)b1, nores, 0, ab, F, mc, F,
        D, st, gf)));
    // dW2 += a^T do
    PTT_TRY(weight_grad(ab, F, dc, D, mc, partf, (float*)dw2, st));
    // dg = (do W2^T) quick_gelu'(g): bf16 into dg, db1's slabs
    PTT_TRY((wg::gemm<wg::EPI_DGELU, float, bf16>(
        dc, D, (const bf16*)w2, D, nullptr, nores, 0, dgb, F, mc, F, D, st,
        gf, partf)));
    PTT_TRY(colsum_parts(partf, (mc + wg::BM - 1) / wg::BM * (wg::BM / 16),
                         F, F, (float*)db1, st));
    // dW1 += h^T bf16(dg)
    PTT_TRY(weight_grad(hb, D, dgb, F, mc, partf, (float*)dw1, st));
    // dh = bf16(dg) W1^T
    PTT_TRY((wg::gemm<wg::EPI_NONE, float, float>(
        dgb, F, (const bf16*)w1, F, nullptr, nores, 0, dhf, D, mc, D, F,
        st)));
    ln_bwd_kernel<<<LN_BLOCKS, LN_WARPS * 32, ln_smem, st>>>(
        xc, dc, (const float*)lns, dhf, (bf16*)dx + (size_t)r0 * D, partf,
        mc, D);
    PTT_CHECK();
    PTT_TRY(colsum_parts(partf, LN_BLOCKS, 3LL * D, D, (float*)dlb, st));
    PTT_TRY(colsum_parts(partf + D, LN_BLOCKS, 3LL * D, D, (float*)dls, st));
    PTT_TRY(colsum_parts(partf + 2 * D, LN_BLOCKS, 3LL * D, D, (float*)db2,
                         st));
  }
  return (int)cudaGetLastError();
}

// The ranges of k-steps the weight-gradient GEMM splits an [M, N] output
// over K rows into on the current device (ptt_wgmma::tn_splits).
int ptt_weight_grad_plan(int M, int N, int K, int* splits) {
  return ptt_wgmma::tn_splits(M, N, K, splits);
}

// out [M, N] += A^T B (f32) of A [K, M] and B [K, N] bf16 row-major, the
// weight-gradient GEMM alone (for checks); part: ptt_weight_grad_plan's
// splits x M x N f32
int ptt_weight_grad(const void* A, const void* B, void* out, int M, int N,
                    int K, void* part, void* stream) {
  return weight_grad((const bf16*)A, M, (const bf16*)B, N, K, (float*)part,
                     (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
