// The int8 serving layer of the ViT tower: the attention sub-layer, its
// CLS-only variant for the last layer, the MLP sub-layer, the whole layer
// with an f32 mid-layer residual, and the standalone int8 dense layer and
// MLP, with int8 tensor-core GEMMs.
//
// Replaces the TPU kernels of patent_tpu/ops/quant_matmul.py:
//   ptt_int8_attn      _qattn_group_kernel / _qattn_block_kernel
//                      (public entry quant_attention_block)
//   ptt_int8_attn_cls  _qattn_cls_group_kernel (quant_attention_cls)
//   ptt_int8_mlp       _qmlp_block_kernel (quant_mlp_block)
//   ptt_int8_layer     _qlayer_kernel (quant_layer_block) and
//                      _qlayer_group_kernel (quant_layer_group)
//   ptt_int8_dense     _qdense_kernel (quant_dense)
//   ptt_int8_qmlp      _qmlp_kernel (quant_mlp)
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
//   layer:      the attention sub-layer's y kept f32 (x1, never rounded),
//               then the MLP sub-layer on x1: LN2 and the residual read the
//               f32 x1, and only bf16(x1 + mlp) is stored
//   dense:      act(f32(rowquant(x) @ W) * xs * s + b) in x's dtype (bf16 or
//               f32), act none or quick_gelu; the MLP op is two of them with
//               the f32 hidden row-quantized between.
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
// bound.  At one image (M = 208) a whole layer is 3.1 GOP against 7.1 MB
// of int8 weights: 2.3 us to read them at 3.35 TB/s, so launches and the
// weight stream, not arithmetic, set its time.  Design (a first version,
// right before fast):
//   * int8 GEMMs C = epi(A[M, K] @ B[N, K]^T) on mma.sync m16n8k32 s8
//     with int32 accumulation (K * 127^2 < 2^31, exact), B held K-major
//     ([out, in], from load time), 128x128x64 block tiles in a two-stage
//     cp.async ring, the dequant / bias / quick_gelu / residual fused into
//     the epilogue;
//   * LayerNorm and the per-row quantization one warp per row;
//   * attention is csrc/attention.cuh in its exp2-clamp form;
//   * the TPU kernels keep ao and the [M, 3072] MLP hidden on chip; here
//     they cross device memory in f32 (a row's quantization needs the
//     whole row), which is the next thing to fuse;
//   * the sub-layers are chains of launches of those pieces; the whole
//     layer is ONE cooperative launch, as the TPU kernel is one program: a
//     persistent grid of every block that fits on the card at once runs
//     the nine phases (LN1 + quant, QKV tiles, attention tiles, quant(ao),
//     out-projection tiles into the f32 x1, LN2 + quant, MLP-in tiles,
//     quant(g), MLP-out tiles) as grid-stride loops over the same device
//     bodies, with a grid-wide barrier between phases.
// The CLS variant runs LN1 + quant and the K/V projections over every row
// and the rest on row 0 of each image only, through the same kernels and
// the same per-element operations, so it equals row 0 of ptt_int8_attn
// bit for bit.

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "attention.cuh"
#include "common.cuh"

using ptt::bf16;

namespace {

constexpr int QG_BM = 128, QG_BN = 128, QG_BK = 64;
constexpr int QG_THREADS = 256;
constexpr int QG_LD = QG_BK + 16;     // bytes per shared row (bank skew)
// the GEMM's shared memory: two stages of the A and the B tile
constexpr int QG_SMEM = 2 * (QG_BM + QG_BN) * QG_LD;
constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float NEG_1702_LOG2E = (float)(-1.702 * 1.4426950408889634);

// epilogues after the dequant + bias: none, quick_gelu, + residual
enum QEpi { QEPI_BIAS = 0, QEPI_GELU = 1, QEPI_RES = 2 };

// One 128 x 128 tile at (m0, n0) of C[M, N] = epi(f32(A @ Bt^T) *
// rs[r * rs_stride] * cs[c] + bias[c]) with A [M, K] and Bt [N, K] int8
// row-major, the residual (QEPI_RES) read from res [M, ldr] (bf16 or f32)
// and C stored as OutT (bf16 or f32).  K, lda, ldb are multiples of 16
// and A, Bt 16-byte aligned (checked by the host code).  8 warps, 2 x 4,
// each 64 x 32 of the tile; smem holds QG_SMEM bytes.  The k-loop ends
// with a block barrier, so a caller may run the next tile at once.
template <int EPI, typename OutT, typename ResT>
__device__ __forceinline__ void gemm_s8_tile(
    const int8_t* __restrict__ A, int lda, const float* __restrict__ rs,
    int rs_stride, const int8_t* __restrict__ Bt, int ldb,
    const float* __restrict__ cs, const float* __restrict__ bias,
    const ResT* __restrict__ res, int ldr, OutT* __restrict__ C, int ldc,
    int M, int N, int K, int m0, int n0, unsigned char* smem) {
  auto As = reinterpret_cast<int8_t(*)[QG_BM][QG_LD]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[QG_BN][QG_LD]>(
      smem + 2 * QG_BM * QG_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
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
        if constexpr (EPI == QEPI_GELU)
          v = __fdiv_rn(v, __fadd_rn(1.0f, exp2f(__fmul_rn(NEG_1702_LOG2E, v))));
        if constexpr (EPI == QEPI_RES)
          v = __fadd_rn(ptt::to_f(res[(size_t)r * ldr + c]), v);
        ptt::store_f(&C[(size_t)r * ldc + c], v);
      }
    }
  }
}

template <int EPI, typename OutT, typename ResT>
__global__ void __launch_bounds__(QG_THREADS)
    gemm_s8_kernel(const int8_t* __restrict__ A, int lda,
                   const float* __restrict__ rs, int rs_stride,
                   const int8_t* __restrict__ Bt, int ldb,
                   const float* __restrict__ cs,
                   const float* __restrict__ bias,
                   const ResT* __restrict__ res, int ldr,
                   OutT* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[QG_SMEM];
  gemm_s8_tile<EPI, OutT, ResT>(A, lda, rs, rs_stride, Bt, ldb, cs, bias,
                                res, ldr, C, ldc, M, N, K, blockIdx.y * QG_BM,
                                blockIdx.x * QG_BN, smem);
}

// One row, by one warp: [LayerNorm (f32 statistics, eps 1e-5), then] the
// per-row int8 quantization.  Writes q[row] int8 and its scale qs[row].
// The row is read again in each pass (it stays in L1/L2) and every pass
// recomputes the same f32 values.
template <bool LN, typename InT>
__device__ __forceinline__ void rowquant_row(
    const InT* __restrict__ x, int ldx, const float* __restrict__ lns,
    const float* __restrict__ lnb, int8_t* __restrict__ q, int ldq,
    float* __restrict__ qs, int row, int D, int lane) {
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

template <bool LN, typename InT>
__global__ void rowquant_kernel(const InT* __restrict__ x, int ldx,
                                const float* __restrict__ lns,
                                const float* __restrict__ lnb,
                                int8_t* __restrict__ q, int ldq,
                                float* __restrict__ qs, int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row < M)
    rowquant_row<LN, InT>(x, ldx, lns, lnb, q, ldq, qs, row, D,
                          threadIdx.x & 31);
}

// Reads and clears the last CUDA error, so that a failed launch is
// reported once, by the call that made it.
int last_error(cudaError_t e = cudaSuccess) {
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// names a type in a parameter without letting a call deduce it (a null
// residual pointer says nothing of the residual's type)
template <typename T>
struct named {
  using type = T;
};

template <int EPI, typename OutT, typename ResT = bf16>
int gemm_s8(const int8_t* A, int lda, const float* rs, int rs_stride,
            const int8_t* Bt, int ldb, const float* cs, const float* bias,
            const typename named<ResT>::type* res, int ldr, OutT* C, int ldc,
            int M, int N, int K, cudaStream_t st) {
  dim3 grid((N + QG_BN - 1) / QG_BN, (M + QG_BM - 1) / QG_BM);
  gemm_s8_kernel<EPI, OutT, ResT><<<grid, QG_THREADS, 0, st>>>(
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

constexpr auto attention = ptt_attention::attention<float>;

// ---- the whole layer in one cooperative launch

// Row 8's operands.  Every scratch buffer is written by one phase only and
// read only after it, so no block can hold a stale cached line of it.
struct LayerArgs {
  const bf16* x;
  bf16* out;
  int B, S, D, H, F, valid_len;
  const float *ln1s, *ln1b;
  const int8_t* wqkv;
  const float *sq, *bq;
  const int8_t* wout;
  const float *sout, *bout, *ln2s, *ln2b;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  int8_t* hq;      // LN1's codes [M, D] and scales [M]
  float* hs;
  bf16* qkv;       // [M, 3D]
  float* ao;       // attention output [M, D]
  int8_t* aq;      // its codes and scales
  float* as;
  float* x1;       // the f32 mid-layer residual [M, D]
  int8_t* hq2;     // LN2's codes and scales
  float* hs2;
  float* g;        // the MLP hidden [M, F], then its codes and scales
  int8_t* gq;
  float* gs;
};

// every tile of C[M, N], dense A [M, K], C and res [M, N], spread over the
// grid's blocks
template <int EPI, typename OutT, typename ResT>
__device__ void gemm_phase(const int8_t* A, const float* rs, const int8_t* Bt,
                           const float* cs, const float* bias, const ResT* res,
                           OutT* C, int M, int N, int K,
                           unsigned char* smem) {
  const int tn = (N + QG_BN - 1) / QG_BN;
  const int tiles = (M + QG_BM - 1) / QG_BM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_s8_tile<EPI, OutT, ResT>(A, K, rs, 1, Bt, K, cs, bias, res, N, C, N,
                                  M, N, K, t / tn * QG_BM, t % tn * QG_BN,
                                  smem);
}

// every row of x [M, D], one warp per row, spread over the grid's warps
template <bool LN, typename InT>
__device__ void rowquant_phase(const InT* x, const float* lns,
                               const float* lnb, int8_t* q, float* qs, int M,
                               int D) {
  const int warps = blockDim.x >> 5;
  for (int row = blockIdx.x * warps + (threadIdx.x >> 5); row < M;
       row += gridDim.x * warps)
    rowquant_row<LN, InT>(x, D, lns, lnb, q, D, qs, row, D, threadIdx.x & 31);
}

__global__ void __launch_bounds__(QG_THREADS) int8_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = a.B * a.S, D = a.D, F = a.F, S = a.S;

  rowquant_phase<true, bf16>(a.x, a.ln1s, a.ln1b, a.hq, a.hs, M, D);
  grid.sync();
  gemm_phase<QEPI_BIAS, bf16, bf16>(a.hq, a.hs, a.wqkv, a.sq, a.bq, nullptr,
                                    a.qkv, M, 3 * D, D, smem);
  grid.sync();
  const int qtiles = (S + ptt_attention::QT - 1) / ptt_attention::QT;
  const long long img = (long long)S * 3 * D;
  for (int t = blockIdx.x; t < qtiles * a.H * a.B; t += gridDim.x) {
    __syncthreads();          // the last tile's warps are done with smem
    ptt_attention::attention_tile<float>(
        a.qkv, img, 3 * D, S, a.qkv + D, a.qkv + 2 * D, img, 3 * D, a.ao,
        (long long)S * D, D, S, a.valid_len, t % qtiles,
        t / qtiles % a.H, t / (qtiles * a.H), smem);
  }
  grid.sync();
  rowquant_phase<false, float>(a.ao, nullptr, nullptr, a.aq, a.as, M, D);
  grid.sync();
  gemm_phase<QEPI_RES, float, bf16>(a.aq, a.as, a.wout, a.sout, a.bout, a.x,
                                    a.x1, M, D, D, smem);
  grid.sync();
  rowquant_phase<true, float>(a.x1, a.ln2s, a.ln2b, a.hq2, a.hs2, M, D);
  grid.sync();
  gemm_phase<QEPI_GELU, float, bf16>(a.hq2, a.hs2, a.w1, a.s1, a.b1, nullptr,
                                     a.g, M, F, D, smem);
  grid.sync();
  rowquant_phase<false, float>(a.g, nullptr, nullptr, a.gq, a.gs, M, F);
  grid.sync();
  gemm_phase<QEPI_RES, bf16, float>(a.gq, a.gs, a.w2, a.s2, a.b2, a.x1, a.out,
                                    M, D, F, smem);
}

// The cooperative grid: every block that fits on the card at once with
// `smem` bytes of dynamic shared memory (a barrier across blocks needs
// them all resident).
int layer_grid(size_t smem, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_layer_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, int8_layer_kernel, QG_THREADS, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return last_error(e);
}

// ---- the standalone dense layer and MLP, T the type of x and of the output

template <typename T>
int dense(const T* x, T* out, int M, int K, int N, int gelu, const int8_t* w,
          const float* scale, const float* bias, int8_t* xq, float* xs,
          cudaStream_t st) {
  PTT_TRY((rowquant<false, T>(x, K, nullptr, nullptr, xq, K, xs, M, K, st)));
  return gelu ? gemm_s8<QEPI_GELU, T>(xq, K, xs, 1, w, K, scale, bias,
                                      nullptr, 0, out, N, M, N, K, st)
              : gemm_s8<QEPI_BIAS, T>(xq, K, xs, 1, w, K, scale, bias,
                                      nullptr, 0, out, N, M, N, K, st);
}

template <typename T>
int qmlp(const T* x, T* out, int M, int K, int H, int N, const int8_t* w1,
         const float* s1, const float* b1, const int8_t* w2, const float* s2,
         const float* b2, int8_t* xq, float* xs, float* g, int8_t* gq,
         float* gs, cudaStream_t st) {
  PTT_TRY((rowquant<false, T>(x, K, nullptr, nullptr, xq, K, xs, M, K, st)));
  PTT_TRY((gemm_s8<QEPI_GELU, float>(xq, K, xs, 1, w1, K, s1, b1, nullptr, 0,
                                     g, H, M, H, K, st)));
  PTT_TRY((rowquant<false, float>(g, H, nullptr, nullptr, gq, H, gs, M, H,
                                  st)));
  return gemm_s8<QEPI_BIAS, T>(gq, H, gs, 1, w2, H, s2, b2, nullptr, 0, out,
                               N, M, N, H, st);
}

}  // namespace

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
  PTT_TRY((gemm_s8<QEPI_BIAS, bf16>(hq8, D, hsf, 1, (const int8_t*)wqkv_t, D,
                                    (const float*)sq, (const float*)bq,
                                    nullptr, 0, qkvb, 3 * D, M, 3 * D, D, st)));
  PTT_TRY(attention(qkvb, (long long)S * 3 * D, 3 * D, S, qkvb + D,
                    qkvb + 2 * D, (long long)S * 3 * D, 3 * D, aof,
                    (long long)S * D, D, B, H, S, valid_len, st));
  PTT_TRY((rowquant<false, float>(aof, D, nullptr, nullptr, hq8, D, hsf, M, D,
                                  st)));
  return gemm_s8<QEPI_RES, bf16>(hq8, D, hsf, 1, (const int8_t*)wout_t, D,
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
  PTT_TRY((gemm_s8<QEPI_BIAS, bf16>(hq8, D, hsf, 1, w + (size_t)D * D, D,
                                    sqf + D, bqf + D, nullptr, 0, kvb, 2 * D,
                                    M, 2 * D, D, st)));
  // Q for the CLS rows only: row 0 of each image is every S-th row of hq
  PTT_TRY((gemm_s8<QEPI_BIAS, bf16>(hq8, S * D, hsf, S, w, D, sqf, bqf,
                                    nullptr, 0, qcb, D, B, D, D, st)));
  PTT_TRY(attention(qcb, D, D, 1, kvb, kvb + D, (long long)S * 2 * D, 2 * D,
                    aof, D, D, B, H, S, valid_len, st));
  PTT_TRY((rowquant<false, float>(aof, D, nullptr, nullptr, aq8, D, asf, B, D,
                                  st)));
  return gemm_s8<QEPI_RES, bf16>(aq8, D, asf, 1, (const int8_t*)wout_t, D,
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
  PTT_TRY((gemm_s8<QEPI_GELU, float>(hq8, D, hsf, 1, (const int8_t*)w1_t,
                                     D, (const float*)s1, (const float*)b1,
                                     nullptr, 0, gf, F, M, F, D, st)));
  PTT_TRY((rowquant<false, float>(gf, F, nullptr, nullptr, gq8, F, gsf, M, F,
                                  st)));
  return gemm_s8<QEPI_RES, bf16>(gq8, F, gsf, 1, (const int8_t*)w2_t, F,
                                 (const float*)s2, (const float*)b2, xb,
                                 D, (bf16*)out, D, M, D, F, st);
}

// x [B, S, D] bf16 -> out [B, S, D] bf16, one whole layer: the attention
// sub-layer of ptt_int8_attn into the f32 x1, then the MLP sub-layer of
// ptt_int8_mlp on x1, in one cooperative launch.  Weights as those two
// take them (ln1s, ln1b, wqkv_t, sq, bq, wout_t, sout, bout, then ln2s,
// ln2b, w1_t, s1, b1, w2_t, s2, b2); scratch in LayerArgs' order: hq
// [M, D] int8, hs [M] f32, qkv [M, 3D] bf16, ao [M, D] f32, aq [M, D]
// int8, as [M] f32, x1 [M, D] f32, hq2 [M, D] int8, hs2 [M] f32, g [M, F]
// f32, gq [M, F] int8, gs [M] f32 (M = B*S).
int ptt_int8_layer(const void* x, void* out, int B, int S, int D, int H,
                   int F, int valid_len, const void* ln1s, const void* ln1b,
                   const void* wqkv_t, const void* sq, const void* bq,
                   const void* wout_t, const void* sout, const void* bout,
                   const void* ln2s, const void* ln2b, const void* w1_t,
                   const void* s1, const void* b1, const void* w2_t,
                   const void* s2, const void* b2, void* hq, void* hs,
                   void* qkv, void* ao, void* aq, void* as, void* x1,
                   void* hq2, void* hs2, void* g, void* gq, void* gs,
                   void* stream) {
  LayerArgs a{(const bf16*)x, (bf16*)out, B, S, D, H, F, valid_len,
              (const float*)ln1s, (const float*)ln1b, (const int8_t*)wqkv_t,
              (const float*)sq, (const float*)bq, (const int8_t*)wout_t,
              (const float*)sout, (const float*)bout, (const float*)ln2s,
              (const float*)ln2b, (const int8_t*)w1_t, (const float*)s1,
              (const float*)b1, (const int8_t*)w2_t, (const float*)s2,
              (const float*)b2, (int8_t*)hq, (float*)hs, (bf16*)qkv,
              (float*)ao, (int8_t*)aq, (float*)as, (float*)x1, (int8_t*)hq2,
              (float*)hs2, (float*)g, (int8_t*)gq, (float*)gs};
  const size_t smem =
      std::max((size_t)QG_SMEM, ptt_attention::smem_bytes(S));
  int blocks = 0;
  PTT_TRY(layer_grid(smem, &blocks));
  void* args[] = {&a};
  return last_error(cudaLaunchCooperativeKernel(
      (const void*)int8_layer_kernel, dim3(blocks), dim3(QG_THREADS), args,
      smem, (cudaStream_t)stream));
}

// x [M, K] -> out [M, N], both bf16 (f32 == 0) or both f32: row
// quantization of x, then the int8 product with w_t [N, K], dequant, bias
// [+ quick_gelu].  scale, bias [N] f32.  Scratch: xq [M, K] int8, xs [M]
// f32.
int ptt_int8_dense(const void* x, void* out, int M, int K, int N, int f32,
                   int gelu, const void* w_t, const void* scale,
                   const void* bias, void* xq, void* xs, void* stream) {
  const int8_t* w = (const int8_t*)w_t;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return dense<float>((const float*)x, (float*)out, M, K, N, gelu, w,
                        (const float*)scale, (const float*)bias, (int8_t*)xq,
                        (float*)xs, st);
  return dense<bf16>((const bf16*)x, (bf16*)out, M, K, N, gelu, w,
                     (const float*)scale, (const float*)bias, (int8_t*)xq,
                     (float*)xs, st);
}

// x [M, K] -> out [M, N], both bf16 (f32 == 0) or both f32: dense with
// quick_gelu into the f32 hidden g [M, H], its row quantization, dense.
// w1_t [H, K], w2_t [N, H] int8; s1, b1 [H], s2, b2 [N] f32.  Scratch:
// xq [M, K] int8, xs [M] f32, g [M, H] f32, gq [M, H] int8, gs [M] f32.
int ptt_int8_qmlp(const void* x, void* out, int M, int K, int H, int N,
                  int f32, const void* w1_t, const void* s1, const void* b1,
                  const void* w2_t, const void* s2, const void* b2, void* xq,
                  void* xs, void* g, void* gq, void* gs, void* stream) {
  const int8_t *w1 = (const int8_t*)w1_t, *w2 = (const int8_t*)w2_t;
  const float *s1f = (const float*)s1, *b1f = (const float*)b1;
  const float *s2f = (const float*)s2, *b2f = (const float*)b2;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return qmlp<float>((const float*)x, (float*)out, M, K, H, N, w1, s1f, b1f,
                       w2, s2f, b2f, (int8_t*)xq, (float*)xs, (float*)g,
                       (int8_t*)gq, (float*)gs, st);
  return qmlp<bf16>((const bf16*)x, (bf16*)out, M, K, H, N, w1, s1f, b1f, w2,
                    s2f, b2f, (int8_t*)xq, (float*)xs, (float*)g, (int8_t*)gq,
                    (float*)gs, st);
}

}  // extern "C"
