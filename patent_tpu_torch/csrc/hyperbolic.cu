// The two hyperbolic kernels of the Poincaré serving path, in float32.
//
// Row 17, ptt_pairwise_dist, replaces the TPU kernel
// patent_tpu/ops/pallas_kernels.py::_pairwise_kernel (via
// _pairwise_dist_pallas_impl; public entry pairwise_dist_pallas): all-pairs
// Poincaré distance d(x_i, y_j) of x [n, d] and y [m, d],
//
//     gamma = max(1 + 2c max(x2 - 2xy + y2, 0) / (alpha beta), 1 + 1e-7),
//     alpha = max(1 - c x2, MIN_NORM), beta = max(1 - c y2, MIN_NORM),
//     d = log(gamma + sqrt(gamma^2 - 1)) / sqrt(c).
//
// The Gram product runs in float32 FMAs, never TF32: near the boundary
// 1 - c x2 is small and x2 - 2xy + y2 cancels, which is why the TPU kernel
// asks for full precision.  What bounds it on the H100: at the label
// evaluation's n 256 x m 16,059 x d 128 the product is 1.05 GFLOP, 16 us
// at the 67 TFLOP/s of FP32 outside the tensor cores, against 25 MB of
// traffic (7 us), so operations.  Design: a block owns a 64 x 64 output
// tile, 256 threads of 4 x 4 outputs each; the K loop stages 16-wide
// slices of both operands in shared memory (transposed, so a thread reads
// its four rows and four columns as two float4 loads); the squared row
// norms come from a one-warp-per-row pre-pass; the tail is elementwise in
// registers and the [n, m] result is written once.
//
// Row 18, ptt_mobius_dense, replaces
// patent_tpu/ops/pallas_kernels.py::_mobius_dense_kernel (via
// _mobius_dense_pallas_impl; public entry mobius_dense_pallas): the
// Euclidean-input hyperbolic dense layer project(expmap0(x W) (+) b) of
// x [n, K], W [K, D], b [D], with the formulas of
// patent_tpu/models/hyperbolic.py::MobiusDense through ops/poincare.py
// (smoothed norms sqrt(s + MIN_NORM^2), ball_eps 4e-3).  Bound: at the
// engine's batch of 512 rows, 512 x 256 the product is 134 MFLOP (2 us of
// FP32) against 2 MB (0.6 us), so operations.  Design: the norm, <h, b>
// and the projection each need a whole output row, so a block owns 16
// whole rows; thread t holds column t (+256, +512, ...) of every row, the
// K loop stages 32-deep slices of x and W in shared memory, and the
// epilogue takes three block-wide row reductions (|u|^2; |h|^2 and <h, b>
// with |b|^2; |out|^2).  The elementwise steps use __f*_rn intrinsics in
// the plain version's operation order, so no product is contracted into an
// FMA behind its back.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float MIN_NORM = 1e-15f;
constexpr float MIN_NORM_SQ = 1e-30f;

// ------------------------------------------------------------ row 17

constexpr int PD_T = 64;        // rows of x and of y per tile
constexpr int PD_K = 16;        // depth of a shared-memory slice
constexpr int PD_LD = PD_T + 4; // keeps float4 rows 16-byte aligned

// out[r] = sum_k x[r, k]^2, one warp per row
__global__ void row_sq_norms(const float* __restrict__ x, int n, int d,
                             float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) {
    const float v = x[(size_t)row * d + k];
    s = fmaf(v, v, s);
  }
  s = ptt::warp_sum(s);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(256)
    pairwise_dist_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ x2,
                         const float* __restrict__ y2, int n, int m, int d,
                         float c, float two_c, float sqrt_c,
                         float* __restrict__ out) {
  __shared__ __align__(16) float Xs[PD_K][PD_LD];
  __shared__ __align__(16) float Ys[PD_K][PD_LD];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.y * PD_T, c0 = blockIdx.x * PD_T;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += PD_K) {
    for (int e = threadIdx.x; e < PD_T * PD_K; e += blockDim.x) {
      const int r = e / PD_K, kk = e % PD_K, k = k0 + kk;
      const int xr = r0 + r, yr = c0 + r;
      Xs[kk][r] = (xr < n && k < d) ? x[(size_t)xr * d + k] : 0.0f;
      Ys[kk][r] = (yr < m && k < d) ? y[(size_t)yr * d + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PD_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n) continue;
    const float xs = x2[row];
    const float alpha = fmaxf(__fsub_rn(1.0f, __fmul_rn(c, xs)), MIN_NORM);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col >= m) continue;
      const float ys = y2[col];
      const float beta = fmaxf(__fsub_rn(1.0f, __fmul_rn(c, ys)), MIN_NORM);
      const float sq = fmaxf(
          __fadd_rn(__fsub_rn(xs, __fmul_rn(2.0f, acc[i][j])), ys), 0.0f);
      float g = __fadd_rn(1.0f, __fdiv_rn(__fmul_rn(two_c, sq),
                                          __fmul_rn(alpha, beta)));
      g = fmaxf(g, 1.0f + 1e-7f);
      const float t = __fsqrt_rn(__fsub_rn(__fmul_rn(g, g), 1.0f));
      out[(size_t)row * m + col] = __fdiv_rn(logf(__fadd_rn(g, t)), sqrt_c);
    }
  }
}

// ------------------------------------------------------------ row 18

constexpr int MD_BM = 16;       // whole output rows per block
constexpr int MD_KT = 32;       // depth of a shared-memory slice
constexpr int MD_THREADS = 256;
constexpr int MD_WARPS = MD_THREADS / 32;

// Sum each of v[0..N) over the block; every thread gets the totals.
// `red` holds MD_WARPS * N floats.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = ptt::warp_sum(v[i]);
    if (lane == 0) red[warp * N + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < MD_WARPS; ++w) s = __fadd_rn(s, red[w * N + i]);
    v[i] = s;
  }
  __syncthreads();  // red is reused by the next call
}

// CG column groups of 256: D <= 256 * CG
template <int CG>
__global__ void __launch_bounds__(MD_THREADS)
    mobius_dense_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, int n, int K, int D,
                        float c, float two_c, float c2, float sqrt_c,
                        float maxnorm, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WD = CG * MD_THREADS;
  float* Xs = smem;                     // [MD_KT][MD_BM], x transposed
  float* Ws = Xs + MD_KT * MD_BM;       // [MD_KT][WD]
  float* red = Ws + MD_KT * WD;         // [MD_WARPS][2 MD_BM + 1]
  const int t = threadIdx.x, row0 = blockIdx.x * MD_BM;

  float acc[CG][MD_BM];
#pragma unroll
  for (int g = 0; g < CG; ++g)
#pragma unroll
    for (int r = 0; r < MD_BM; ++r) acc[g][r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += MD_KT) {
    for (int e = t; e < MD_BM * MD_KT; e += MD_THREADS) {
      const int r = e / MD_KT, kk = e % MD_KT;
      const bool ok = row0 + r < n && k0 + kk < K;
      Xs[kk * MD_BM + r] = ok ? x[(size_t)(row0 + r) * K + k0 + kk] : 0.0f;
    }
    for (int e = t; e < MD_KT * WD; e += MD_THREADS) {
      const int kk = e / WD, col = e % WD;
      const bool ok = k0 + kk < K && col < D;
      Ws[e] = ok ? w[(size_t)(k0 + kk) * D + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < MD_KT; ++kk) {
      float xv[MD_BM];
#pragma unroll
      for (int r = 0; r < MD_BM; r += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&Xs[kk * MD_BM + r]);
        xv[r] = v4.x;
        xv[r + 1] = v4.y;
        xv[r + 2] = v4.z;
        xv[r + 3] = v4.w;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float wv = Ws[kk * WD + g * MD_THREADS + t];
#pragma unroll
        for (int r = 0; r < MD_BM; ++r) acc[g][r] = fmaf(xv[r], wv, acc[g][r]);
      }
    }
    __syncthreads();
  }

  float bv[CG];
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const int col = g * MD_THREADS + t;
    bv[g] = col < D ? bias[col] : 0.0f;  // columns >= D hold u = h = 0
  }

  // expmap0: h = tanh(sqrt_c |u|) u / (sqrt_c |u|), |u| smoothed
  float s1[MD_BM];
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    s1[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < CG; ++g) s1[r] = fmaf(acc[g][r], acc[g][r], s1[r]);
  }
  block_sums(s1, red);
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    const float un = __fsqrt_rn(__fadd_rn(s1[r], MIN_NORM_SQ));
    const float th = tanhf(__fmul_rn(sqrt_c, un));
    const float den = __fmul_rn(sqrt_c, un);
#pragma unroll
    for (int g = 0; g < CG; ++g)
      acc[g][r] = __fdiv_rn(__fmul_rn(th, acc[g][r]), den);
  }

  // mobius_add(h, b): |h|^2, <h, b> per row and |b|^2
  float s2[2 * MD_BM + 1];
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    s2[r] = 0.0f;
    s2[MD_BM + r] = 0.0f;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      s2[r] = fmaf(acc[g][r], acc[g][r], s2[r]);
      s2[MD_BM + r] = fmaf(acc[g][r], bv[g], s2[MD_BM + r]);
    }
  }
  s2[2 * MD_BM] = 0.0f;
#pragma unroll
  for (int g = 0; g < CG; ++g) s2[2 * MD_BM] = fmaf(bv[g], bv[g], s2[2 * MD_BM]);
  block_sums(s2, red);
  const float b2 = s2[2 * MD_BM];
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    const float h2 = s2[r], hb = s2[MD_BM + r];
    const float one_hb = __fadd_rn(1.0f, __fmul_rn(two_c, hb));
    const float a = __fadd_rn(one_hb, __fmul_rn(c, b2));
    const float bc = __fsub_rn(1.0f, __fmul_rn(c, h2));
    const float den =
        fmaxf(__fadd_rn(one_hb, __fmul_rn(__fmul_rn(c2, h2), b2)), MIN_NORM);
#pragma unroll
    for (int g = 0; g < CG; ++g)
      acc[g][r] = __fdiv_rn(
          __fadd_rn(__fmul_rn(a, acc[g][r]), __fmul_rn(bc, bv[g])), den);
  }

  // project: rows whose smoothed norm passes maxnorm are scaled onto it
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    s1[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < CG; ++g) s1[r] = fmaf(acc[g][r], acc[g][r], s1[r]);
  }
  block_sums(s1, red);
#pragma unroll
  for (int r = 0; r < MD_BM; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    const float norm = __fsqrt_rn(__fadd_rn(s1[r], MIN_NORM_SQ));
    const bool clip = norm > maxnorm;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int col = g * MD_THREADS + t;
      if (col >= D) continue;
      const float o = acc[g][r];
      out[(size_t)row * D + col] =
          clip ? __fmul_rn(__fdiv_rn(o, norm), maxnorm) : o;
    }
  }
}

template <int CG>
int launch_mobius_dense(const float* x, const float* w, const float* bias,
                        int n, int K, int D, float c, float two_c, float c2,
                        float sqrt_c, float maxnorm, float* out,
                        cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (MD_KT * MD_BM + MD_KT * CG * MD_THREADS +
                       MD_WARPS * (2 * MD_BM + 1));
  cudaError_t err = cudaFuncSetAttribute(
      mobius_dense_kernel<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mobius_dense_kernel<CG><<<(n + MD_BM - 1) / MD_BM, MD_THREADS, smem, st>>>(
      x, w, bias, n, K, D, c, two_c, c2, sqrt_c, maxnorm, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, d], y [m, d] f32 -> out [n, m] f32; scratch x2 [n], y2 [m].
// two_c = f32(2 c), sqrt_c = f32(sqrt(c)), both computed by the caller.
int ptt_pairwise_dist(const void* x, const void* y, int n, int m, int d,
                      float c, float two_c, float sqrt_c, void* x2, void* y2,
                      void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  row_sq_norms<<<(n * 32 + 255) / 256, 256, 0, st>>>((const float*)x, n, d,
                                                     (float*)x2);
  row_sq_norms<<<(m * 32 + 255) / 256, 256, 0, st>>>((const float*)y, m, d,
                                                     (float*)y2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + PD_T - 1) / PD_T, (n + PD_T - 1) / PD_T);
  pairwise_dist_kernel<<<grid, 256, 0, st>>>(
      (const float*)x, (const float*)y, (const float*)x2, (const float*)y2, n,
      m, d, c, two_c, sqrt_c, (float*)out);
  return (int)cudaGetLastError();
}

// x [n, K], w [K, D], bias [D] f32 -> out [n, D] f32, D <= 1024.
// two_c = f32(2 c), c2 = f32(c) * f32(c), sqrt_c = sqrt(max(f32(c),
// MIN_NORM)) and maxnorm = f32(0.996) / sqrt_c, all in f32 by the caller.
int ptt_mobius_dense(const void* x, const void* w, const void* bias, int n,
                     int K, int D, float c, float two_c, float c2,
                     float sqrt_c, float maxnorm, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  if (D <= MD_THREADS)
    return launch_mobius_dense<1>(xf, wf, bf, n, K, D, c, two_c, c2, sqrt_c,
                                  maxnorm, of, st);
  if (D <= 2 * MD_THREADS)
    return launch_mobius_dense<2>(xf, wf, bf, n, K, D, c, two_c, c2, sqrt_c,
                                  maxnorm, of, st);
  if (D <= 4 * MD_THREADS)
    return launch_mobius_dense<4>(xf, wf, bf, n, K, D, c, two_c, c2, sqrt_c,
                                  maxnorm, of, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
