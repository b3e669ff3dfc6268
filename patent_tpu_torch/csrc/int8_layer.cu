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
// in either of their two forms, picked by each entry's `fast` as the JAX
// package's `fast` picks them: the exact-division form (fast=False, the
// XLA fallback's numerics):
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
// fast form (fast=1, JAX's default on its accelerator) takes each of
// those divides as a multiply by recip(x) = f32(bf16(1 / f32(bf16(x))))
// (ptt::recip_bf16; JAX's approximate reciprocal off the TPU): rowquant's
// codes are sat_s8(rint(r * (recip(amax) * 127))), -128 to 127 (r * inv
// reaches 127.74, and XLA's f32 -> s8 convert saturates), with the same
// scale; quick_gelu is g * recip(1 + exp2(...)) (csrc/wgmma_s8.cuh's
// EPI_GELU_FAST, whose row maxima are of those values); the attention's
// normalize is o * recip(sum(p)) (csrc/flash_tile.cuh's FAST).  Each
// function below takes the form as a template flag FAST, and the exact
// form's code and bits are those it had alone.  The
// epilogues use explicitly rounded multiplies and adds (__fmul_rn,
// __fadd_rn) in the oracle's order, so that no fused multiply-add changes
// a rounding against the plain PyTorch version.
//
// What bounds it on the H100: at ViT-B/16 @224, batch 128 (M = 26,624 rows
// of D = 768, MLP 3072) the attention sub-layer is 126 GOP of int8 GEMM
// plus 17 GFLOP of bf16 attention (~0.08 ms at the 1,979 TOP/s int8 and
// 989 TFLOP/s bf16 peaks) and the MLP 251 GOP (~0.13 ms): tensor-core
// bound.  At one image (M = 208) a whole layer is 3.1 GOP against 7.1 MB
// of int8 weights: 2.3 us to read them at 3.35 TB/s, so the latency of
// each step, not arithmetic, sets its time.  Design:
//   * the attention sub-layer (row 5), the MLP sub-layer (row 7) and the
//     whole layer (rows 8, 9) run their GEMMs on csrc/wgmma_s8.cuh (TMA
//     and wgmma m64n128k32 s8, int32 accumulation, the dequant / bias /
//     quick_gelu / residual fused into the epilogue) and their attention
//     on csrc/flash_tile.cuh's tile with an f32 output (K and V of a
//     (head, image) in shared memory once, the scores and p in registers,
//     53 KB at S 208; past the tile's ring, streamed in key blocks within
//     the same bytes, so the cooperative launch's ring holds them at any
//     S and head width);
//   * the CLS variant (row 6) runs its three GEMMs on the same wgmma
//     GEMM: the K/V product over every row, the q product over row 0 of
//     each image only (A read as every S-th row of the LN1 codes, its
//     scales at stride S: csrc/wgmma_s8.cuh's row-scale stride) and the
//     out-projection with the residual read at stride S.  At a batch of
//     128 its K/V product ([26,624 x 768] . [768 x 1,536], 63 GOP) is
//     nearly all of its work and of its ~0.03 ms bound;
//   * the standalone MLP (row 11) is row 7's pieces without LayerNorm or
//     residual: MLP in on the wgmma GEMM with the hidden's row maxima in
//     its epilogue, the one-pass quantization, MLP out with the bias
//     epilogue (an odd output width stores its last column alone).  The
//     standalone dense layer (row 10) is x's row quantization and one
//     GEMM with the bias or quick_gelu epilogue; both rows take the TAIL
//     instance only for an output width that is not a multiple of 16
//     (gemm_any_n).  At a batch of 128 (26,624 x 768 x 2,304) its
//     165 MB of x, weights and output take 0.049 ms at 3.35 TB/s, about
//     as long as its 94 GOP at the int8 peak.  Every int8 product of this
//     file runs on that one GEMM;
//   * LayerNorm and the per-row quantization one warp per row;
//   * the TPU kernels keep ao and the [M, 3072] MLP hidden on chip; here
//     they cross device memory in f32 (a row's quantization needs the
//     whole row).  Row 7's MLP in takes each hidden row's max |g| in its
//     epilogue (csrc/wgmma_s8.cuh's AMAX instance), so the hidden's
//     quantization is one streaming pass: 409 MB a layer at a batch of
//     128, ~0.12 ms at 3.35 TB/s;
//   * the whole layer at a query's batch (B <= 3 at ViT-B/16: MLP in's
//     tiles fit one wave) is ONE cooperative launch, as the TPU kernel is
//     one program: a persistent grid of one block an SM (a four-stage ring,
//     132 KB, so that no two blocks share an SM) runs ten phases with a
//     grid-wide barrier between each: LN1 + quant, the QKV tiles, the
//     attention by (query tiles, head, image) units sized to one round of
//     the grid, quant(ao), the out-projection split over K into int32
//     partial sums, x1 = their sum's epilogue (kept f32, staged in shared
//     memory) with LN2 + quant, the MLP-in tiles, quant(g), MLP out split
//     over K, and the output from its partial sums.  A GEMM phase's unit
//     is a tile and a k-range, so the narrow, long-K phases fill the card;
//     int32 partial sums add exactly in any order; the row phases take a
//     few rows a block at once;
//   * at larger batches the whole layer is the same bodies as a chain of
//     launches with the f32 x1 between the sub-layers: the same bits, each
//     GEMM on the whole card.
// The CLS variant runs LN1 + quant and the K/V projections over every row
// and the rest on row 0 of each image only, through the same GEMM, the
// same per-element operations and the same attention tile (row 0 of a
// query tile depends on row 0 alone), so it equals row 0 of ptt_int8_attn
// bit for bit.

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tile.cuh"
#include "wgmma_s8.cuh"

using ptt::bf16;
namespace s8 = ptt_s8;

namespace {

constexpr float INV127 = (float)(1.0 / 127.0);

// A row's quantization from its amax = max(max|r|, 1e-8): the scale, and
// the code of each value; the exact form divides by the scale, the fast
// form multiplies by recip(amax) * 127 and saturates.
template <bool FAST>
struct RowCode {
  float sc, inv;

  __device__ __forceinline__ explicit RowCode(float amax) {
    sc = __fmul_rn(amax, INV127);
    inv = FAST ? __fmul_rn(ptt::recip_bf16(amax), 127.0f) : 0.0f;
  }

  __device__ __forceinline__ signed char operator()(float v) const {
    if constexpr (FAST)
      return ptt::sat_s8(__fmul_rn(v, inv));
    else
      return (signed char)__float2int_rn(__fdiv_rn(v, sc));
  }
};

// f(std::bool_constant<FAST>()) for the form an entry's `fast` names
template <typename F>
int by_form(int fast, F f) {
  return fast ? f(std::true_type()) : f(std::false_type());
}

// One row, by one warp: [LayerNorm (f32 statistics, eps 1e-5), then] the
// per-row int8 quantization.  Writes q[row] int8 and its scale qs[row].
// The row is read again in each pass (it stays in L1/L2) and every pass
// recomputes the same f32 values.
template <bool LN, typename InT, bool FAST>
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
  const RowCode<FAST> code(fmaxf(ptt::warp_max(amax), 1e-8f));
  int8_t* qr = q + (size_t)row * ldq;
  for (int c = lane; c < D; c += 32) qr[c] = code(val(c));
  if (lane == 0) qs[row] = code.sc;
}

template <bool LN, typename InT, bool FAST>
__global__ void rowquant_kernel(const InT* __restrict__ x, int ldx,
                                const float* __restrict__ lns,
                                const float* __restrict__ lnb,
                                int8_t* __restrict__ q, int ldq,
                                float* __restrict__ qs, int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row < M)
    rowquant_row<LN, InT, FAST>(x, ldx, lns, lnb, q, ldq, qs, row, D,
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

template <bool LN, typename InT, bool FAST>
int rowquant(const InT* x, int ldx, const float* lns, const float* lnb,
             int8_t* q, int ldq, float* qs, int M, int D, cudaStream_t st) {
  rowquant_kernel<LN, InT, FAST><<<(M + 7) / 8, 256, 0, st>>>(
      x, ldx, lns, lnb, q, ldq, qs, M, D);
  return (int)cudaGetLastError();
}

// The per-row quantization of g [M, F] f32 (F % 4 == 0, rows 16-byte
// aligned) given each row's max |g| in amax [M]: one streaming pass, a
// block a row, four values a thread at a time; the scale and codes are
// rowquant_row's, bit for bit (the max is exact in any order).
template <bool FAST>
__global__ void __launch_bounds__(256)
    rowquant_amax_kernel(const float* __restrict__ g,
                         const float* __restrict__ amax,
                         int8_t* __restrict__ q, float* __restrict__ qs,
                         int F) {
  const size_t row = blockIdx.x;
  const RowCode<FAST> code(fmaxf(amax[row], 1e-8f));
  const float4* gr = reinterpret_cast<const float4*>(g + row * F);
  char4* qr = reinterpret_cast<char4*>(q + row * F);
#pragma unroll 4
  for (int c = threadIdx.x; c < F / 4; c += blockDim.x) {
    const float4 v = __ldcs(gr + c);     // read once
    qr[c] = make_char4(code(v.x), code(v.y), code(v.z), code(v.w));
  }
  if (threadIdx.x == 0) qs[row] = code.sc;
}

template <bool FAST>
int rowquant_amax(const float* g, const float* amax, int8_t* q, float* qs,
                  int M, int F, cudaStream_t st) {
  rowquant_amax_kernel<FAST><<<M, 256, 0, st>>>(g, amax, q, qs, F);
  return (int)cudaGetLastError();
}

// s8 GEMM of the sub-layers and the chained layer on csrc/wgmma_s8.cuh: A
// [M, K] and Bt [N, K] dense, C and res [M, N]; AMAX: each row's max |C|
// into amax [M], zeroed by the caller; TAIL: any N
template <int EPI, typename OutT, typename ResT = bf16, bool AMAX = false,
          bool TAIL = false>
int gemm_wg(const int8_t* A, const float* rs, const int8_t* Bt,
            const float* cs, const float* bias,
            const typename named<ResT>::type* res, OutT* C, int M, int N,
            int K, cudaStream_t st, float* amax = nullptr) {
  const s8::Gemm g{rs, cs, bias, res, N, C, N, M, N, K, 1, amax};
  return s8::gemm<EPI, OutT, ResT, AMAX, TAIL>(A, K, Bt, K, g, st);
}

// MLP in with its row maxima, then the hidden's one-pass quantization:
// g = quick_gelu(dequant(A . Bt^T) + bias) [M, N] f32, amax [M] its rows'
// max |g|, gq [M, N] and gs [M] their codes and scales
template <bool FAST>
int gelu_quant(const int8_t* A, const float* rs, const int8_t* Bt,
               const float* cs, const float* bias, float* g, float* amax,
               int8_t* gq, float* gs, int M, int N, int K, cudaStream_t st) {
  PTT_TRY(last_error(cudaMemsetAsync(amax, 0, sizeof(float) * M, st)));
  PTT_TRY((gemm_wg<s8::gelu_epi(FAST), float, bf16, true>(
      A, rs, Bt, cs, bias, nullptr, g, M, N, K, st, amax)));
  return rowquant_amax<FAST>(g, amax, gq, gs, M, N, st);
}

// attention with an f32 output over (heads, images), q, k, v the strided
// thirds of qkv [B, S, 3D]
template <bool FAST>
int attention_f32(const bf16* qkv, float* ao, int B, int S, int D, int H,
                  int valid_len, cudaStream_t st) {
  const long long img = (long long)S * 3 * D;
  return ptt_flash::attention<false, float, FAST>(
      qkv, img, 3 * D, S, qkv + D, qkv + 2 * D, img, 3 * D, ao,
      (long long)S * D, D, B, H, D / H, S, valid_len, 0.0f, st);
}

// ---- the whole layer

// Row 8's operands.  Every scratch buffer but `part` is written by one
// phase only and read only after it, so no block can hold a stale cached
// line of it; `part` is read past L1.
struct LayerArgs {
  const bf16* x;
  bf16* out;
  int B, S, D, H, F, valid_len;
  int tile_width;             // the attention tile's instance for D / H
  int split_out, split_mlp;   // k-ranges a tile: out-projection, MLP out
  const float *ln1s, *ln1b, *sq, *bq, *sout, *bout;
  const float *ln2s, *ln2b, *s1, *b1, *s2, *b2;
  const int8_t *wqkv, *wout, *w1, *w2;
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
  int* part;       // int32 partial sums [split, M, D] of a split GEMM
  long long* stamps;   // null, or block 0's clock64 at the start and at
                       // the end of each of the ten phases
};

// the four GEMMs' operands as TMA reads them
struct LayerMaps {
  CUtensorMap hq, wqkv, aq, wout, hq2, w1, gq, w2;
};

constexpr int LAYER_WARPS = s8::THREADS / 32;
// the whole layer's ring: four stages, 132 KB of shared memory a block, so
// that the cooperative grid is one block an SM, spread over every SM (two
// 98 KB blocks may share an SM and leave another idle), with a deeper ring
// for the weight stream
constexpr int LAYER_STAGES = 4;
constexpr size_t LAYER_SMEM = s8::smem_bytes(LAYER_STAGES);
constexpr size_t LAYER_RING = s8::ring_bytes(LAYER_STAGES);
// the attention tile runs on the ring's bytes at any S and head width
static_assert((size_t)ptt_flash::RING_BYTES <= LAYER_RING,
              "the tile's ring fits the layer's");

// The rows a block takes at once in a row phase: as many as spread M rows
// over the grid in one round, at most a row a warp.
__device__ __forceinline__ int rows_per_block(int M) {
  return max(1, min(LAYER_WARPS, (M + (int)gridDim.x - 1) / (int)gridDim.x));
}

// The per-row quantization (no LayerNorm) of rows r0..r0+n-1 (n <=
// LAYER_WARPS) of an [M, D] matrix by every thread of the block: each
// row's max is exact in any order, so the codes and scales equal
// rowquant_row's.  val(r, c) gives element c of row r; red holds
// LAYER_WARPS^2 floats.
template <bool FAST, typename Val>
__device__ __forceinline__ void rowquant_rows(Val val, int8_t* __restrict__ q,
                                              float* __restrict__ qs, int r0,
                                              int n, int D, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < n; ++r) {
    float amax = 0.0f;
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      amax = fmaxf(amax, fabsf(val(r, c)));
    amax = ptt::warp_max(amax);
    if (lane == 0) red[r * LAYER_WARPS + warp] = amax;
  }
  __syncthreads();
  for (int r = 0; r < n; ++r) {
    float amax = red[r * LAYER_WARPS];
    for (int w = 1; w < LAYER_WARPS; ++w)
      amax = fmaxf(amax, red[r * LAYER_WARPS + w]);
    const RowCode<FAST> code(fmaxf(amax, 1e-8f));
    int8_t* qr = q + (size_t)(r0 + r) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) qr[c] = code(val(r, c));
    if (threadIdx.x == 0) qs[r0 + r] = code.sc;
  }
  __syncthreads();                  // red and val's source are the next's
}

// A grid-wide barrier after this thread's generic writes of global memory
// that TMA (the async proxy) may read after it.
__device__ __forceinline__ void grid_sync(
    cooperative_groups::grid_group& grid) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  grid.sync();
}

// most k-ranges a tile of a split GEMM (the host's plan reads it through
// ptt_int8_layer_grid)
constexpr int SPLIT_MAX = 8;

// the sum of the `splits` (<= SPLIT_MAX) int32 partials of element i of an
// [M, D] product (exact in any order), all loads issued first; read from
// L2 (the buffer is written again by a later phase, so no block may keep
// a line of it in L1)
__device__ __forceinline__ int part_sum(const int* __restrict__ part,
                                        int splits, size_t MD, size_t i) {
  int v[SPLIT_MAX];
#pragma unroll
  for (int s = 0; s < SPLIT_MAX; ++s)
    v[s] = s < splits ? __ldcg(part + s * MD + i) : 0;
  int acc = 0;
#pragma unroll
  for (int s = 0; s < SPLIT_MAX; ++s) acc += v[s];
  return acc;
}

template <bool FAST>
__global__ void __launch_bounds__(s8::THREADS, 1)
    int8_layer_kernel(const LayerArgs a,
                      const __grid_constant__ LayerMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[LAYER_WARPS * LAYER_WARPS];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  s8::Ring ring = s8::ring_init(smem_raw, LAYER_STAGES);
  const int M = a.B * a.S, D = a.D, F = a.F, S = a.S;
  const size_t MD = (size_t)M * D;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * LAYER_WARPS + (threadIdx.x >> 5);
  const int gwarps = gridDim.x * LAYER_WARPS;
  int phase = 0;
  auto stamp = [&]() {
    if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      a.stamps[phase++] = clock64();
  };
  stamp();

  // 1. LN1 + quantization of x, a warp a row
  for (int row = gwarp; row < M; row += gwarps)
    rowquant_row<true, bf16, FAST>(a.x, D, a.ln1s, a.ln1b, a.hq, D, a.hs,
                                   row, D, lane);
  grid_sync(grid);
  stamp();
  // 2. qkv = bf16(dequant(hq . Wqkv^T) + bq), the q columns folded
  s8::gemm_units<s8::EPI_BIAS, bf16, bf16>(
      &maps.hq, &maps.wqkv,
      s8::Gemm{a.hs, a.sq, a.bq, nullptr, 0, a.qkv, 3 * D, M, 3 * D, D, 1},
      blockIdx.x, gridDim.x, ring);
  grid_sync(grid);
  stamp();
  // 3. ao = attention, f32: units of (rows query rows, head, image), a
  //    16-row tile a warp, as few tiles a unit as let the units run in one
  //    round of the grid (a warp's tile is a chain of S / 16 dependent key
  //    steps)
  const int qtiles = (S + 15) / 16;
  int per_unit = 1;
  while (per_unit < LAYER_WARPS &&
         (qtiles + per_unit - 1) / per_unit * a.H * a.B > (int)gridDim.x)
    ++per_unit;
  const int rows = 16 * per_unit;
  const int chunks = (S + rows - 1) / rows;
  const long long img = (long long)S * 3 * D;
  auto tile = [&](auto w) {
    constexpr int HD = decltype(w)::value;
    const bool stream = S > ptt_flash::Layout<HD>::RING;
    for (int t = blockIdx.x; t < chunks * a.H * a.B; t += gridDim.x) {
      __syncthreads();        // the last unit's warps are done with smem
      const int q0 = t % chunks * rows;
      auto run = [&](auto streamed) {
        ptt_flash::flash_tile<HD, false, decltype(streamed)::value, float,
                              LAYER_WARPS, FAST>(
            a.qkv + (size_t)q0 * 3 * D, img, 3 * D, min(rows, S - q0),
            a.qkv + D, a.qkv + 2 * D, img, 3 * D, a.ao + (size_t)q0 * D,
            (long long)S * D, D, S, a.valid_len, D / a.H, 0.0f,
            t / chunks % a.H, t / (chunks * a.H), ring.tiles);
      };
      if (stream)
        run(std::true_type());
      else
        run(std::false_type());
    }
  };
  // the head width's instance: every width layer_coop takes is named, and
  // it refuses the rest before the launch
  switch (a.tile_width) {
    case 16: tile(std::integral_constant<int, 16>()); break;
    case 32: tile(std::integral_constant<int, 32>()); break;
    case 48: tile(std::integral_constant<int, 48>()); break;
    case 64: tile(std::integral_constant<int, 64>()); break;
    case 80: tile(std::integral_constant<int, 80>()); break;
    case 96: tile(std::integral_constant<int, 96>()); break;
    case 112: tile(std::integral_constant<int, 112>()); break;
    case 128: tile(std::integral_constant<int, 128>()); break;
    default: break;
  }
  grid_sync(grid);
  stamp();
  // 4. quantization of ao, a block a few rows
  const int per = rows_per_block(M);
  for (int r0 = blockIdx.x * per; r0 < M; r0 += gridDim.x * per) {
    const float* rows = a.ao + (size_t)r0 * D;
    rowquant_rows<FAST>(
        [&](int r, int c) { return rows[(size_t)r * D + c]; }, a.aq, a.as,
        r0, min(per, M - r0), D, red);
  }
  grid_sync(grid);
  stamp();
  // 5. the out-projection's int32 partial sums, split over K
  s8::gemm_units<s8::EPI_PART, int, int>(
      &maps.aq, &maps.wout,
      s8::Gemm{nullptr, nullptr, nullptr, nullptr, 0, a.part, D, M, D, D,
               a.split_out},
      blockIdx.x, gridDim.x, ring);
  grid_sync(grid);
  stamp();
  // 6. x1 = f32(x) + dequant(aq . Wout^T) + bout, kept f32, a block a few
  //    rows staged in shared memory; then LN2 + quantization of each row
  //    by a warp from there
  float* x1s = reinterpret_cast<float*>(ring.tiles);
  for (int r0 = blockIdx.x * per; r0 < M; r0 += gridDim.x * per) {
    const int n = min(per, M - r0);
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
      const int row = r0 + e / D, c = e % D;
      const size_t i = (size_t)row * D + c;
      x1s[e] = a.x1[i] = s8::epi_value<s8::EPI_RES, bf16>(
          part_sum(a.part, a.split_out, MD, i), a.as[row], a.sout[c],
          a.bout[c], a.x + i);
    }
    __syncthreads();
    const int w = threadIdx.x >> 5;
    if (w < n)
      rowquant_row<true, float, FAST>(x1s + (size_t)w * D, 0, a.ln2s,
                                      a.ln2b, a.hq2, D, a.hs2, r0 + w, D,
                                      lane);
    __syncthreads();
  }
  grid_sync(grid);
  stamp();
  // 7. g = quick_gelu(dequant(hq2 . W1^T) + b1), f32
  s8::gemm_units<s8::gelu_epi(FAST), float, float>(
      &maps.hq2, &maps.w1,
      s8::Gemm{a.hs2, a.s1, a.b1, nullptr, 0, a.g, F, M, F, D, 1},
      blockIdx.x, gridDim.x, ring);
  grid_sync(grid);
  stamp();
  // 8. quantization of g, a block a few rows
  for (int r0 = blockIdx.x * per; r0 < M; r0 += gridDim.x * per) {
    const float* rows = a.g + (size_t)r0 * F;
    rowquant_rows<FAST>(
        [&](int r, int c) { return rows[(size_t)r * F + c]; }, a.gq, a.gs,
        r0, min(per, M - r0), F, red);
  }
  grid_sync(grid);
  stamp();
  // 9. MLP out's int32 partial sums, split over K
  s8::gemm_units<s8::EPI_PART, int, int>(
      &maps.gq, &maps.w2,
      s8::Gemm{nullptr, nullptr, nullptr, nullptr, 0, a.part, D, M, D, F,
               a.split_mlp},
      blockIdx.x, gridDim.x, ring);
  grid_sync(grid);
  stamp();
  // 10. out = bf16(x1 + dequant(gq . W2^T) + b2)
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MD;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(i / D), c = (int)(i % D);
    a.out[i] = __float2bfloat16(s8::epi_value<s8::EPI_RES, float>(
        part_sum(a.part, a.split_mlp, MD, i), a.gs[row], a.s2[c], a.b2[c],
        a.x1 + i));
  }
  stamp();
}

// The cooperative grid: every block of either form's kernel that fits on
// the current card at once (a barrier across blocks needs them all
// resident), asked once a device.
int layer_grid(int* blocks) {
  static int n[ptt::MAX_DEVICES] = {};
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (n[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 1 << 30;
    cudaError_t e =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (const void* kernel : {(const void*)int8_layer_kernel<false>,
                               (const void*)int8_layer_kernel<true>}) {
      int fits = 0;
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)LAYER_SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fits, kernel, s8::THREADS, LAYER_SMEM);
      per_sm = fits < per_sm ? fits : per_sm;
    }
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) return last_error(e);
    n[dev] = per_sm * sms;
  }
  *blocks = n[dev];
  return 0;
}

template <bool FAST>
int layer_coop(const LayerArgs& a, cudaStream_t st) {
  if (a.tile_width == 0 ||         // D / H is not a width the tile takes
      (size_t)LAYER_WARPS * a.D * sizeof(float) > LAYER_RING ||
      a.split_out > SPLIT_MAX || a.split_mlp > SPLIT_MAX)
    return (int)cudaErrorInvalidValue;
  const int M = a.B * a.S, D = a.D, F = a.F;
  LayerMaps maps;
  if (!s8::tensor_map(&maps.hq, a.hq, M, D, D, s8::BM) ||
      !s8::tensor_map(&maps.wqkv, a.wqkv, 3 * D, D, D, s8::BN) ||
      !s8::tensor_map(&maps.aq, a.aq, M, D, D, s8::BM) ||
      !s8::tensor_map(&maps.wout, a.wout, D, D, D, s8::BN) ||
      !s8::tensor_map(&maps.hq2, a.hq2, M, D, D, s8::BM) ||
      !s8::tensor_map(&maps.w1, a.w1, F, D, D, s8::BN) ||
      !s8::tensor_map(&maps.gq, a.gq, M, F, F, s8::BM) ||
      !s8::tensor_map(&maps.w2, a.w2, D, F, F, s8::BN))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  PTT_TRY(layer_grid(&blocks));
  void* args[] = {const_cast<LayerArgs*>(&a), &maps};
  return last_error(cudaLaunchCooperativeKernel(
      (const void*)int8_layer_kernel<FAST>, dim3(blocks), dim3(s8::THREADS),
      args, LAYER_SMEM, st));
}

// the same layer as a chain of launches of the same bodies, x1 f32
template <bool FAST>
int layer_chain(const LayerArgs& a, cudaStream_t st) {
  const int M = a.B * a.S, D = a.D, F = a.F;
  PTT_TRY((rowquant<true, bf16, FAST>(a.x, D, a.ln1s, a.ln1b, a.hq, D, a.hs,
                                      M, D, st)));
  PTT_TRY((gemm_wg<s8::EPI_BIAS, bf16>(a.hq, a.hs, a.wqkv, a.sq, a.bq,
                                       nullptr, a.qkv, M, 3 * D, D, st)));
  PTT_TRY(attention_f32<FAST>(a.qkv, a.ao, a.B, a.S, D, a.H, a.valid_len,
                              st));
  PTT_TRY((rowquant<false, float, FAST>(a.ao, D, nullptr, nullptr, a.aq, D,
                                        a.as, M, D, st)));
  PTT_TRY((gemm_wg<s8::EPI_RES, float, bf16>(a.aq, a.as, a.wout, a.sout,
                                             a.bout, a.x, a.x1, M, D, D,
                                             st)));
  PTT_TRY((rowquant<true, float, FAST>(a.x1, D, a.ln2s, a.ln2b, a.hq2, D,
                                       a.hs2, M, D, st)));
  PTT_TRY((gemm_wg<s8::gelu_epi(FAST), float>(a.hq2, a.hs2, a.w1, a.s1, a.b1,
                                              nullptr, a.g, M, F, D, st)));
  PTT_TRY((rowquant<false, float, FAST>(a.g, F, nullptr, nullptr, a.gq, F,
                                        a.gs, M, F, st)));
  return gemm_wg<s8::EPI_RES, bf16, float>(a.gq, a.gs, a.w2, a.s2, a.b2,
                                           a.x1, a.out, M, D, F, st);
}

// ---- the standalone dense layer and MLP, T the type of x and of the output

// C [M, N] = epi(dequant(A . Bt^T) + bias) for any N: the TAIL instance
// only where N is not a multiple of 16: its per-column checks cost 7% of
// the GEMM at 26,624 x 768 x 2,304 on the H100 (compare_builds.py's "s8
// GEMM bias" against "bias_tail")
template <int EPI, typename T>
int gemm_any_n(const int8_t* A, const float* rs, const int8_t* Bt,
               const float* cs, const float* bias, T* C, int M, int N, int K,
               cudaStream_t st) {
  return N % 16 ? gemm_wg<EPI, T, bf16, false, true>(A, rs, Bt, cs, bias,
                                                     nullptr, C, M, N, K, st)
                : gemm_wg<EPI, T>(A, rs, Bt, cs, bias, nullptr, C, M, N, K,
                                  st);
}

template <typename T, bool FAST>
int dense(const T* x, T* out, int M, int K, int N, int gelu, const int8_t* w,
          const float* scale, const float* bias, int8_t* xq, float* xs,
          cudaStream_t st) {
  PTT_TRY((rowquant<false, T, FAST>(x, K, nullptr, nullptr, xq, K, xs, M, K,
                                    st)));
  return gelu ? gemm_any_n<s8::gelu_epi(FAST), T>(xq, xs, w, scale, bias, out,
                                                  M, N, K, st)
              : gemm_any_n<s8::EPI_BIAS, T>(xq, xs, w, scale, bias, out, M, N,
                                            K, st);
}

// Row 7's pieces without LayerNorm or residual: x's row quantization, MLP
// in with the hidden's row maxima and its one-pass quantization
// (gelu_quant), MLP out with the bias epilogue, both GEMMs on
// csrc/wgmma_s8.cuh
template <typename T, bool FAST>
int qmlp(const T* x, T* out, int M, int K, int H, int N, const int8_t* w1,
         const float* s1, const float* b1, const int8_t* w2, const float* s2,
         const float* b2, int8_t* xq, float* xs, float* g, int8_t* gq,
         float* gs, float* gmax, cudaStream_t st) {
  PTT_TRY((rowquant<false, T, FAST>(x, K, nullptr, nullptr, xq, K, xs, M, K,
                                    st)));
  PTT_TRY(gelu_quant<FAST>(xq, xs, w1, s1, b1, g, gmax, gq, gs, M, H, K,
                           st));
  return gemm_any_n<s8::EPI_BIAS, T>(gq, gs, w2, s2, b2, out, M, N, H, st);
}

}  // namespace

extern "C" {

// x [B, S, D] bf16 -> out [B, S, D] bf16, in the form `fast` names (0
// exact, 1 fast; every entry below takes it).  wqkv_t [3D, D], wout_t
// [D, D] int8 ([out, in]); sq, bq [3D] with the q columns folded; sout,
// bout, lns, lnb [D] f32.  Scratch: hq [M, D] int8 and hs [M] f32 (LN1's
// codes, then ao's), qkv [M, 3D] bf16, ao [M, D] f32 (M = B*S).
int ptt_int8_attn(const void* x, void* out, int B, int S, int D, int H,
                  int valid_len, int fast, const void* lns, const void* lnb,
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

  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    PTT_TRY((rowquant<true, bf16, FAST>(xb, D, (const float*)lns,
                                        (const float*)lnb, hq8, D, hsf, M, D,
                                        st)));
    PTT_TRY((gemm_wg<s8::EPI_BIAS, bf16>(hq8, hsf, (const int8_t*)wqkv_t,
                                         (const float*)sq, (const float*)bq,
                                         nullptr, qkvb, M, 3 * D, D, st)));
    PTT_TRY(attention_f32<FAST>(qkvb, aof, B, S, D, H, valid_len, st));
    PTT_TRY((rowquant<false, float, FAST>(aof, D, nullptr, nullptr, hq8, D,
                                          hsf, M, D, st)));
    return gemm_wg<s8::EPI_RES, bf16>(hq8, hsf, (const int8_t*)wout_t,
                                      (const float*)sout, (const float*)bout,
                                      xb, (bf16*)out, M, D, D, st);
  });
}

// x [B, S, D] bf16 -> out [B, D] bf16, row 0 of ptt_int8_attn.  Scratch:
// hq [M, D] int8, hs [M] f32, kv [M, 2D] bf16, qc [B, D] bf16, ao [B, D]
// f32, aq [B, D] int8, as [B] f32.
int ptt_int8_attn_cls(const void* x, void* out, int B, int S, int D, int H,
                      int valid_len, int fast, const void* lns,
                      const void* lnb,
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

  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    PTT_TRY((rowquant<true, bf16, FAST>(xb, D, (const float*)lns,
                                        (const float*)lnb, hq8, D, hsf, M, D,
                                        st)));
    // K and V over every row: rows D..3D of wqkv_t
    PTT_TRY((s8::gemm<s8::EPI_BIAS, bf16, bf16>(
        hq8, D, w + (size_t)D * D, D,
        s8::Gemm{hsf, sqf + D, bqf + D, nullptr, 0, kvb, 2 * D, M, 2 * D, D,
                 1},
        st)));
    // Q for the CLS rows only: row 0 of each image is every S-th row of hq,
    // its scale every S-th of hs
    PTT_TRY((s8::gemm<s8::EPI_BIAS, bf16, bf16>(
        hq8, (long long)S * D, w, D,
        s8::Gemm{hsf, sqf, bqf, nullptr, 0, qcb, D, B, D, D, 1, nullptr, S},
        st)));
    // the attention tile of ptt_int8_attn, the CLS row in row 0 of its
    // query tile
    PTT_TRY((ptt_flash::attention<false, float, FAST>(
        qcb, D, D, 1, kvb, kvb + D, (long long)S * 2 * D, 2 * D, aof, D, D,
        B, H, D / H, S, valid_len, 0.0f, st)));
    PTT_TRY((rowquant<false, float, FAST>(aof, D, nullptr, nullptr, aq8, D,
                                          asf, B, D, st)));
    // the out-projection, the residual row 0 of each image
    return s8::gemm<s8::EPI_RES, bf16, bf16>(
        aq8, D, (const int8_t*)wout_t, D,
        s8::Gemm{asf, (const float*)sout, (const float*)bout, xb,
                 (long long)S * D, out, D, B, D, D, 1},
        st);
  });
}

// x [M, D] bf16 -> out [M, D] bf16.  w1_t [F, D], w2_t [D, F] int8
// ([out, in]); s1, b1 [F], s2, b2, lns, lnb [D] f32.  Scratch: hq [M, D]
// int8, hs [M] f32, g [M, F] f32, gq [M, F] int8, gs [M] f32, gmax [M]
// f32.  Five steps on the stream: gmax zeroed; LN2 + quantization; MLP in
// on csrc/wgmma_s8.cuh with the hidden's row maxima in its epilogue; the
// hidden's one-pass quantization; MLP out with the residual, on the same
// GEMM.
int ptt_int8_mlp(const void* x, void* out, int M, int D, int F, int fast,
                 const void* lns, const void* lnb, const void* w1_t,
                 const void* s1, const void* b1, const void* w2_t,
                 const void* s2, const void* b2, void* hq, void* hs, void* g,
                 void* gq, void* gs, void* gmax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  int8_t* hq8 = (int8_t*)hq;
  float* hsf = (float*)hs;
  int8_t* gq8 = (int8_t*)gq;
  float* gsf = (float*)gs;

  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    PTT_TRY((rowquant<true, bf16, FAST>(xb, D, (const float*)lns,
                                        (const float*)lnb, hq8, D, hsf, M, D,
                                        st)));
    PTT_TRY(gelu_quant<FAST>(hq8, hsf, (const int8_t*)w1_t, (const float*)s1,
                             (const float*)b1, (float*)g, (float*)gmax, gq8,
                             gsf, M, F, D, st));
    return gemm_wg<s8::EPI_RES, bf16>(gq8, gsf, (const int8_t*)w2_t,
                                      (const float*)s2, (const float*)b2, xb,
                                      (bf16*)out, M, D, F, st);
  });
}

// x [B, S, D] bf16 -> out [B, S, D] bf16, one whole layer: the attention
// sub-layer of ptt_int8_attn into the f32 x1, then the MLP sub-layer of
// ptt_int8_mlp on x1.  coop != 0: one cooperative launch, the
// out-projection and MLP out split over K into split_out and split_mlp
// k-ranges a tile (each at most its K / 128 steps and SPLIT_MAX); coop ==
// 0: a chain of launches.  Weights as those two take them (ln1s, ln1b, wqkv_t, sq, bq,
// wout_t, sout, bout, then ln2s, ln2b, w1_t, s1, b1, w2_t, s2, b2);
// scratch in LayerArgs' order: hq [M, D] int8, hs [M] f32, qkv [M, 3D]
// bf16, ao [M, D] f32, aq [M, D] int8, as [M] f32, x1 [M, D] f32, hq2
// [M, D] int8, hs2 [M] f32, g [M, F] f32, gq [M, F] int8, gs [M] f32, and
// for coop part [max(split_out, split_mlp), M, D] int32 (M = B*S).
// stamps:
// null, or 11 int64 for block 0's clock64 at the start and at the end of
// each of the cooperative launch's ten phases.
int ptt_int8_layer(const void* x, void* out, int B, int S, int D, int H,
                   int F, int valid_len, int coop, int split_out,
                   int split_mlp, int fast, const void* ln1s,
                   const void* ln1b,
                   const void* wqkv_t, const void* sq, const void* bq,
                   const void* wout_t, const void* sout, const void* bout,
                   const void* ln2s, const void* ln2b, const void* w1_t,
                   const void* s1, const void* b1, const void* w2_t,
                   const void* s2, const void* b2, void* hq, void* hs,
                   void* qkv, void* ao, void* aq, void* as, void* x1,
                   void* hq2, void* hs2, void* g, void* gq, void* gs,
                   void* part, void* stamps, void* stream) {
  const LayerArgs a{
      (const bf16*)x, (bf16*)out, B, S, D, H, F, valid_len,
      D % H ? 0 : ptt_flash::tile_width(D / H), split_out, split_mlp,
      (const float*)ln1s, (const float*)ln1b, (const float*)sq,
      (const float*)bq, (const float*)sout, (const float*)bout,
      (const float*)ln2s, (const float*)ln2b, (const float*)s1,
      (const float*)b1, (const float*)s2, (const float*)b2,
      (const int8_t*)wqkv_t, (const int8_t*)wout_t, (const int8_t*)w1_t,
      (const int8_t*)w2_t, (int8_t*)hq, (float*)hs, (bf16*)qkv, (float*)ao,
      (int8_t*)aq, (float*)as, (float*)x1, (int8_t*)hq2, (float*)hs2,
      (float*)g, (int8_t*)gq, (float*)gs, (int*)part, (long long*)stamps};
  cudaStream_t st = (cudaStream_t)stream;
  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    return coop ? layer_coop<FAST>(a, st) : layer_chain<FAST>(a, st);
  });
}

// The cooperative grid of ptt_int8_layer on the current card: *blocks,
// every block that fits on it at once; and *split_max, the most k-ranges
// a tile its split GEMMs take (the host's plan reads it here).
int ptt_int8_layer_grid(int* blocks, int* split_max) {
  *split_max = SPLIT_MAX;
  return layer_grid(blocks);
}

// One s8 GEMM of rows 5, 6, 7 and 8 on its own (csrc/wgmma_s8.cuh), for
// checks and timing: C = epi(f32(A Bt^T) * rs * cs + bias), A [M, K] int8
// read as rows 0, every, 2 every, ... of its buffer with row scales rs at
// the same stride (every 1: dense; row 6's CLS q product: every S), Bt
// [N, K] int8 with column scales cs and bias [N] f32, res and C [M, N]
// dense.  epi: 0 -> bf16 (QKV); 1 quick_gelu -> f32 (MLP in); 2 + bf16 res
// -> bf16 (row 5's out-projection, row 7's MLP out); 3 + bf16 res -> f32
// (row 8's out-projection); 4 + f32 res -> bf16 (row 8's MLP out); 5 ->
// bf16, any N (0's TAIL instance, which rows 10 and 11 take where N is not
// a multiple of 16).  fast: epi 1's quick_gelu in the fast form.
int ptt_int8_gemm(int epi, int fast, const void* A, const void* rs,
                  const void* Bt,
                  const void* cs, const void* bias, const void* res, void* C,
                  int M, int N, int K, int every, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)A;
  const int8_t* b = (const int8_t*)Bt;
  const long long lda = (long long)every * K;
  const s8::Gemm g{(const float*)rs, (const float*)cs, (const float*)bias,
                   res, N, C, N, M, N, K, 1, nullptr, every};
  switch (epi) {
    case 0:
      return s8::gemm<s8::EPI_BIAS, bf16, bf16>(a, lda, b, K, g, st);
    case 1:
      return fast ? s8::gemm<s8::EPI_GELU_FAST, float, bf16>(a, lda, b, K, g,
                                                             st)
                  : s8::gemm<s8::EPI_GELU, float, bf16>(a, lda, b, K, g, st);
    case 2:
      return s8::gemm<s8::EPI_RES, bf16, bf16>(a, lda, b, K, g, st);
    case 3:
      return s8::gemm<s8::EPI_RES, float, bf16>(a, lda, b, K, g, st);
    case 4:
      return s8::gemm<s8::EPI_RES, bf16, float>(a, lda, b, K, g, st);
    case 5:
      return s8::gemm<s8::EPI_BIAS, bf16, bf16, false, true>(a, lda, b, K, g,
                                                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Row 7's MLP in on its own, for checks and timing: g = quick_gelu(f32(A
// Bt^T) * rs * cs + bias) [M, N] f32 with each row's max |g| in amax [M]
// taken in the GEMM's epilogue, then the one-pass quantization of g into
// gq [M, N] int8 and gs [M] f32.
int ptt_int8_gelu_quant(const void* A, const void* rs, const void* Bt,
                        const void* cs, const void* bias, void* g, void* amax,
                        void* gq, void* gs, int M, int N, int K, int fast,
                        void* stream) {
  return by_form(fast, [&](auto form) {
    return gelu_quant<decltype(form)::value>(
        (const int8_t*)A, (const float*)rs, (const int8_t*)Bt,
        (const float*)cs, (const float*)bias, (float*)g, (float*)amax,
        (int8_t*)gq, (float*)gs, M, N, K, (cudaStream_t)stream);
  });
}

// x [M, K] -> out [M, N], both bf16 (f32 == 0) or both f32: row
// quantization of x, then the int8 product with w_t [N, K] on
// csrc/wgmma_s8.cuh, dequant, bias [+ quick_gelu].  scale, bias [N] f32;
// K % 16 == 0, any N.  Scratch: xq [M, K] int8, xs [M] f32.
int ptt_int8_dense(const void* x, void* out, int M, int K, int N, int f32,
                   int gelu, int fast, const void* w_t, const void* scale,
                   const void* bias, void* xq, void* xs, void* stream) {
  const int8_t* w = (const int8_t*)w_t;
  cudaStream_t st = (cudaStream_t)stream;
  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    if (f32)
      return dense<float, FAST>((const float*)x, (float*)out, M, K, N, gelu,
                                w, (const float*)scale, (const float*)bias,
                                (int8_t*)xq, (float*)xs, st);
    return dense<bf16, FAST>((const bf16*)x, (bf16*)out, M, K, N, gelu, w,
                             (const float*)scale, (const float*)bias,
                             (int8_t*)xq, (float*)xs, st);
  });
}

// x [M, K] -> out [M, N], both bf16 (f32 == 0) or both f32: dense with
// quick_gelu into the f32 hidden g [M, H] with its rows' max |g|, their
// one-pass quantization, dense.  w1_t [H, K], w2_t [N, H] int8; s1, b1
// [H], s2, b2 [N] f32; K % 16 == 0, H % 16 == 0, any N.  Scratch: xq
// [M, K] int8, xs [M] f32, g [M, H] f32, gq [M, H] int8, gs [M] f32, gmax
// [M] f32.  Four kernels and a memset on the stream.
int ptt_int8_qmlp(const void* x, void* out, int M, int K, int H, int N,
                  int f32, int fast, const void* w1_t, const void* s1,
                  const void* b1,
                  const void* w2_t, const void* s2, const void* b2, void* xq,
                  void* xs, void* g, void* gq, void* gs, void* gmax,
                  void* stream) {
  const int8_t *w1 = (const int8_t*)w1_t, *w2 = (const int8_t*)w2_t;
  const float *s1f = (const float*)s1, *b1f = (const float*)b1;
  const float *s2f = (const float*)s2, *b2f = (const float*)b2;
  cudaStream_t st = (cudaStream_t)stream;
  return by_form(fast, [&](auto form) {
    constexpr bool FAST = decltype(form)::value;
    if (f32)
      return qmlp<float, FAST>((const float*)x, (float*)out, M, K, H, N, w1,
                               s1f, b1f, w2, s2f, b2f, (int8_t*)xq,
                               (float*)xs, (float*)g, (int8_t*)gq, (float*)gs,
                               (float*)gmax, st);
    return qmlp<bf16, FAST>((const bf16*)x, (bf16*)out, M, K, H, N, w1, s1f,
                            b1f, w2, s2f, b2f, (int8_t*)xq, (float*)xs,
                            (float*)g, (int8_t*)gq, (float*)gs, (float*)gmax,
                            st);
  });
}

}  // extern "C"
