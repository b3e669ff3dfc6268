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
// FP32) against 2 MB (0.6 us), so operations.  Design (Hopper): the norm,
// <h, b> and the projection each need a whole output row, but 512 rows
// of whole rows fill only 32 SMs, so a thread-block cluster owns 16 rows
// and its CTAs split their columns (at D 256, 4 CTAs of 64 columns: 128
// CTAs at n 512, one wave on 132 SMs; past D 1024, 8 CTAs each take a
// 128-column slice of every 1024-column group); each of the three row
// reductions (|u|^2; |h|^2 and <h, b> with |b|^2; |out|^2) is summed over
// the row's threads by shuffles, then over the cluster's CTAs through
// distributed shared memory, in rank order, so every CTA of a row gets the
// same bits.
// W's and x's K-slices stream through a four-stage cp.async ring (three
// 64-deep slices in flight during the FMAs).  In the K loop a thread holds a
// register tile of 4 rows x 4 or 8 columns over an eighth of each slice
// (eight groups of threads split it, so that 16 warps hide each other's
// latency; their partial sums meet in shared memory), so each float4
// read from shared memory feeds 16 or 32 FMAs.
// f32 FMAs throughout, no TF32.  The elementwise steps use __f*_rn intrinsics
// in the plain version's operation order, so no product is contracted
// into an FMA behind its back.

#include <cooperative_groups.h>
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

// The cluster shape of each D class: a cluster of CTAs owns MD_BM rows and
// splits their D columns, `cols` a CTA.  D <= 64: one CTA of 64 columns;
// D 65-512: 2-8 CTAs of 64; D 513-1024: 5-8 CTAs of 128 (a portable
// cluster holds at most 8 CTAs, so the slice widens instead); past 1024,
// 8 CTAs of 128 columns in each of `groups` column groups of 1024, up to
// MD_GROUPS: a CTA runs the K loop once a group and keeps every group's
// columns in registers for the row reductions.
constexpr int MD_BM = 16;       // rows a cluster owns
constexpr int MD_KT = 64;       // depth of a K-slice
constexpr int MD_STAGES = 4;    // K-slices in the ring, 3 in flight
constexpr int MD_KG = 8;        // groups of threads that split a K-slice
constexpr int MD_THREADS = 512; // MD_KG x (4 x 16 threads of 4 x TN); a
                                // warp a row in the epilogue
constexpr int MD_XLD = MD_KT + 4;   // x's shared row: float4 reads of rows
                                    // 4 apart fall in different banks
constexpr int MD_CLUSTER_MAX = 8;
constexpr int MD_GROUPS = 8;    // column groups a CTA at most
constexpr int MD_MAX_OUT = MD_GROUPS * MD_CLUSTER_MAX * 128;   // 8192

void mobius_plan(int D, int* cols, int* cluster, int* groups) {
  *cols = D <= MD_CLUSTER_MAX * 64 ? 64 : 128;
  *cluster = (D + *cols - 1) / *cols;
  if (*cluster > MD_CLUSTER_MAX) *cluster = MD_CLUSTER_MAX;
  *groups = (D + *cluster * *cols - 1) / (*cluster * *cols);
}

// The cluster's total of red[i] over its CTAs, in rank order, so that
// every CTA of the cluster gets the same bits: every CTA's value is read
// first, then summed.  The caller has passed a cluster barrier since each
// CTA wrote its red[i].
__device__ __forceinline__ float cluster_total(
    cooperative_groups::cluster_group& cluster, float* red, int i) {
  const unsigned nb = cluster.num_blocks();
  float v[MD_CLUSTER_MAX];
#pragma unroll
  for (unsigned q = 0; q < MD_CLUSTER_MAX; ++q)
    v[q] = q < nb ? cluster.map_shared_rank(red, q)[i] : 0.0f;
  float t = v[0];
#pragma unroll
  for (unsigned q = 1; q < MD_CLUSTER_MAX; ++q)
    if (q < nb) t = __fadd_rn(t, v[q]);
  return t;
}

// One CTA: rows row0 .. row0 + 15 (blockIdx.x) by columns col0 .. col0 +
// BN - 1 (col0 = BN x its rank in the cluster) of each of `groups` (<= G)
// column groups of cluster x BN columns.  In the K loop, thread
// (kg, ty, tx) holds a register tile of rows ty*4 .. ty*4 + 3 by columns
// tx*4 .. tx*4 + 3 (+ 64 when BN is 128) over k-group kg's 8 k of each
// K-slice: per 4 k, 4 float4 of x and TN / 4 x 4 of W from shared memory
// feed 16 x TN FMAs.  The k-groups' partial sums then meet in shared
// memory, and warp r takes row r (EC columns a lane) through the
// epilogue.  vec: x and w rows are 16-byte aligned (K, D multiples of 4),
// so the ring fills by 16-byte cp.async, each thread's chunks at
// addresses fixed up to the slice's offset, else by 4-byte ones.  At BN
// 64 two CTAs fit on an SM (64 registers a thread, 83 KB), so that a
// cluster the GPC cannot place one CTA an SM shares an SM rather than
// waiting for a second wave.
template <int BN, int G>
__global__ void __launch_bounds__(MD_THREADS, BN == 64 ? 2 : 1)
    mobius_dense_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, int n, int K, int D,
                        int groups, int vec, float c, float two_c, float c2,
                        float sqrt_c, float maxnorm, float* __restrict__ out) {
  constexpr int TN = BN / 16, EC = BN / 32;
  constexpr int EV = G * EC;        // the epilogue's values a thread
  constexpr int XS = MD_BM * MD_XLD, WS = MD_KT * BN;  // floats a stage
  constexpr int WCH = WS / 4 / MD_THREADS;  // W's 16-byte chunks a thread
  static_assert(MD_KT % (4 * MD_KG) == 0 && MD_THREADS == 32 * MD_BM &&
                    MD_BM * MD_KT / 4 <= MD_THREADS &&
                    WS / 4 % MD_THREADS == 0,
                "4n k a group, a warp a row, a slice's chunks spread evenly");
  static_assert(MD_KG * MD_BM * BN <= MD_STAGES * (XS + WS),
                "the k-groups' partial sums fit in the ring");
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_u[MD_BM], red_hb[2 * MD_BM + 1], red_o[MD_BM];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int row0 = blockIdx.x * MD_BM;
  const int gstride = (int)cluster.num_blocks() * BN;   // a group's columns
  const int cbase = (int)cluster.block_rank() * BN + lane * EC;
  // the column of the epilogue's value j: group j / EC, EC a lane
  auto col = [&](int j) { return j / EC * gstride + cbase + j % EC; };
  float bv[EV];
#pragma unroll
  for (int j = 0; j < EV; ++j)
    bv[j] = col(j) < D ? bias[col(j)] : 0.0f;   // u = h = 0 there
  int col0 = (int)cluster.block_rank() * BN;    // this group's first column

  // vec: this thread's chunks, the x one (threads < 128) and WCH of W
  const int xr = tid / (MD_KT / 4), xk = tid % (MD_KT / 4) * 4;
  const bool x_ok = tid < MD_BM * MD_KT / 4 && row0 + xr < n;
  const float* xg = x + (x_ok ? (size_t)(row0 + xr) * K + xk : 0);
  int wk[WCH], wc[WCH];
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int e = tid + j * MD_THREADS;
    wk[j] = e / (BN / 4);
    wc[j] = e % (BN / 4) * 4;
  }
  auto load = [&](int kt, int stage) {
    float* Xs = smem + stage * (XS + WS);
    float* Ws = Xs + XS;
    const int k0 = kt * MD_KT;
    if (vec) {
      if (tid < MD_BM * MD_KT / 4) {
        const bool ok = x_ok && k0 + xk < K;
        ptt::cp_async16(&Xs[xr * MD_XLD + xk], ok ? xg + k0 : x, ok);
      }
#pragma unroll
      for (int j = 0; j < WCH; ++j) {
        const bool ok = k0 + wk[j] < K && col0 + wc[j] < D;
        ptt::cp_async16(&Ws[wk[j] * BN + wc[j]],
                        ok ? w + (size_t)(k0 + wk[j]) * D + col0 + wc[j] : w,
                        ok);
      }
    } else {
      for (int e = tid; e < MD_BM * MD_KT; e += MD_THREADS) {
        const int rr = e / MD_KT, kk = e % MD_KT;
        const bool ok = row0 + rr < n && k0 + kk < K;
        ptt::cp_async4(&Xs[rr * MD_XLD + kk],
                       ok ? x + (size_t)(row0 + rr) * K + k0 + kk : x, ok);
      }
      for (int e = tid; e < WS; e += MD_THREADS) {
        const int kk = e / BN, cc = e % BN;
        const bool ok = k0 + kk < K && col0 + cc < D;
        ptt::cp_async4(&Ws[kk * BN + cc],
                       ok ? w + (size_t)(k0 + kk) * D + col0 + cc : w, ok);
      }
    }
  };

  // u = x W, a column group at a time: K-slices through a ring of
  // MD_STAGES, MD_STAGES - 1 in flight while the FMAs run on the oldest
  const int tx = tid & 15, ty = (tid >> 4) & 3, kg = tid >> 6;
  float acc[EV];
#pragma unroll
  for (int j = 0; j < EV; ++j) acc[j] = 0.0f;
  for (int grp = 0; grp < groups; ++grp, col0 += gstride) {
    float tile[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) tile[i][j] = 0.0f;
    const int kts = (K + MD_KT - 1) / MD_KT;
#pragma unroll
    for (int st = 0; st < MD_STAGES - 1; ++st) {
      if (st < kts) load(st, st);
      ptt::cp_async_commit();
    }
    for (int kt = 0; kt < kts; ++kt) {
      ptt::cp_async_wait<MD_STAGES - 2>();
      __syncthreads();      // slice kt is in; slice kt - 1's stage is free
      if (kt + MD_STAGES - 1 < kts)
        load(kt + MD_STAGES - 1, (kt + MD_STAGES - 1) % MD_STAGES);
      ptt::cp_async_commit();
      const float* Xs = smem + kt % MD_STAGES * (XS + WS);
      const float* Ws = Xs + XS;
#pragma unroll
      for (int k4 = 0; k4 < MD_KT / MD_KG; k4 += 4) {
        const int kk = kg * (MD_KT / MD_KG) + k4;
        float xv[4][4];                    // rows ty*4 + i, k kk + q
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x4 = *reinterpret_cast<const float4*>(
              &Xs[(ty * 4 + i) * MD_XLD + kk]);
          xv[i][0] = x4.x;
          xv[i][1] = x4.y;
          xv[i][2] = x4.z;
          xv[i][3] = x4.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                &Ws[(kk + q) * BN + h * 64 + tx * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              tile[i][4 * h] = fmaf(xv[i][q], w4.x, tile[i][4 * h]);
              tile[i][4 * h + 1] = fmaf(xv[i][q], w4.y, tile[i][4 * h + 1]);
              tile[i][4 * h + 2] = fmaf(xv[i][q], w4.z, tile[i][4 * h + 2]);
              tile[i][4 * h + 3] = fmaf(xv[i][q], w4.w, tile[i][4 * h + 3]);
            }
          }
      }
    }
    ptt::cp_async_wait<0>();
    __syncthreads();                  // every thread is done with the ring

    // the k-groups' partial sums [MD_KG][MD_BM][BN] over the ring, then row
    // r's columns lane*EC .. lane*EC + EC - 1 summed in group order
    float* part = smem;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        *reinterpret_cast<float4*>(
            &part[(kg * MD_BM + ty * 4 + i) * BN + h * 64 + tx * 4]) =
            make_float4(tile[i][4 * h], tile[i][4 * h + 1], tile[i][4 * h + 2],
                        tile[i][4 * h + 3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < EC; ++j) {
      const float* pc = &part[r * BN + lane * EC + j];
      float u = pc[0];
#pragma unroll
      for (int g = 1; g < MD_KG; ++g) u = __fadd_rn(u, pc[g * MD_BM * BN]);
#pragma unroll
      for (int gg = 0; gg < G; ++gg)  // static indices keep acc in registers
        if (gg == grp) acc[gg * EC + j] = u;
    }
    __syncthreads();                // part is read: the ring is free again
  }


  // expmap0: h = tanh(sqrt_c |u|) u / (sqrt_c |u|), |u| smoothed; each row
  // reduction is the row's warp, then the cluster's CTAs through
  // distributed shared memory
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < EV; ++j) s = fmaf(acc[j], acc[j], s);
  s = ptt::warp_sum(s);
  if (lane == 0) red_u[r] = s;
  cluster.sync();
  const float un = __fsqrt_rn(__fadd_rn(cluster_total(cluster, red_u, r),
                                        MIN_NORM_SQ));
  const float th = tanhf(__fmul_rn(sqrt_c, un));
  const float den_u = __fmul_rn(sqrt_c, un);
#pragma unroll
  for (int j = 0; j < EV; ++j)
    acc[j] = __fdiv_rn(__fmul_rn(th, acc[j]), den_u);

  // mobius_add(h, b): |h|^2, <h, b> per row and |b|^2
  float h2 = 0.0f, hb = 0.0f, bb = 0.0f;
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    h2 = fmaf(acc[j], acc[j], h2);
    hb = fmaf(acc[j], bv[j], hb);
    bb = fmaf(bv[j], bv[j], bb);
  }
  h2 = ptt::warp_sum(h2);
  hb = ptt::warp_sum(hb);
  bb = ptt::warp_sum(bb);
  if (lane == 0) {
    red_hb[r] = h2;
    red_hb[MD_BM + r] = hb;
    if (r == 0) red_hb[2 * MD_BM] = bb;
  }
  cluster.sync();
  h2 = cluster_total(cluster, red_hb, r);
  hb = cluster_total(cluster, red_hb, MD_BM + r);
  const float b2 = cluster_total(cluster, red_hb, 2 * MD_BM);
  const float one_hb = __fadd_rn(1.0f, __fmul_rn(two_c, hb));
  const float a = __fadd_rn(one_hb, __fmul_rn(c, b2));
  const float bc = __fsub_rn(1.0f, __fmul_rn(c, h2));
  const float den =
      fmaxf(__fadd_rn(one_hb, __fmul_rn(__fmul_rn(c2, h2), b2)), MIN_NORM);
#pragma unroll
  for (int j = 0; j < EV; ++j)
    acc[j] = __fdiv_rn(__fadd_rn(__fmul_rn(a, acc[j]), __fmul_rn(bc, bv[j])),
                       den);

  // project: rows whose smoothed norm passes maxnorm are scaled onto it
  s = 0.0f;
#pragma unroll
  for (int j = 0; j < EV; ++j) s = fmaf(acc[j], acc[j], s);
  s = ptt::warp_sum(s);
  if (lane == 0) red_o[r] = s;
  cluster.sync();
  const float norm = __fsqrt_rn(__fadd_rn(cluster_total(cluster, red_o, r),
                                          MIN_NORM_SQ));
  const bool clip = norm > maxnorm;
  const int row = row0 + r;
  if (row < n) {
#pragma unroll
    for (int j = 0; j < EV; ++j)
      if (col(j) < D)
        out[(size_t)row * D + col(j)] =
            clip ? __fmul_rn(__fdiv_rn(acc[j], norm), maxnorm) : acc[j];
  }
  cluster.sync();     // no CTA leaves while another still reads its red_o
}

template <int BN, int G>
int launch_mobius_dense(const float* x, const float* w, const float* bias,
                        int n, int K, int D, int cluster, int groups, float c,
                        float two_c, float c2, float sqrt_c, float maxnorm,
                        float* out, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * MD_STAGES * (MD_BM * MD_XLD + MD_KT * BN);
  static bool ready[ptt::MAX_DEVICES] = {};   // the attribute, once a device
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        mobius_dense_kernel<BN, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int vec = K % 4 == 0 && D % 4 == 0 &&
                  ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + MD_BM - 1) / MD_BM, cluster);
  cfg.blockDim = dim3(MD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mobius_dense_kernel<BN, G>, x, w, bias, n, K,
                         D, groups, vec, c, two_c, c2, sqrt_c, maxnorm, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
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

// x [n, K], w [K, D], bias [D] f32 -> out [n, D] f32, n >= 1, D <= 8192.
// two_c = f32(2 c), c2 = f32(c) * f32(c), sqrt_c = sqrt(max(f32(c),
// MIN_NORM)) and maxnorm = f32(0.996) / sqrt_c, all in f32 by the caller.
int ptt_mobius_dense(const void* x, const void* w, const void* bias, int n,
                     int K, int D, float c, float two_c, float c2,
                     float sqrt_c, float maxnorm, void* out, void* stream) {
  if (n < 1 || D > MD_MAX_OUT) return (int)cudaErrorInvalidValue;
  if (D < 1) return 0;                      // nothing to write
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  int cols = 0, cluster = 0, groups = 0;
  mobius_plan(D, &cols, &cluster, &groups);
  if (cols == 64)
    return launch_mobius_dense<64, 1>(xf, wf, bf, n, K, D, cluster, 1, c,
                                      two_c, c2, sqrt_c, maxnorm, of, st);
  if (groups == 1)
    return launch_mobius_dense<128, 1>(xf, wf, bf, n, K, D, cluster, 1, c,
                                       two_c, c2, sqrt_c, maxnorm, of, st);
  return launch_mobius_dense<128, MD_GROUPS>(xf, wf, bf, n, K, D, cluster,
                                             groups, c, two_c, c2, sqrt_c,
                                             maxnorm, of, st);
}

// The launch ptt_mobius_dense makes for n rows of D columns: *ctas CTAs in
// clusters of *cluster, *cols columns a CTA in each of its column groups.
int ptt_mobius_dense_shape(int n, int D, int* ctas, int* cluster, int* cols) {
  int groups = 0;
  mobius_plan(D, cols, cluster, &groups);
  *ctas = (n + MD_BM - 1) / MD_BM * *cluster;
  return 0;
}

}  // extern "C"
