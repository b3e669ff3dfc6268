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
// traffic (7 us), so operations.  Design (Hopper), one launch a call:
//   * a block of 256 threads owns a 128 x 128 output tile, a thread 8 x 8
//     outputs (rows ty + 16i, columns tx + 16j), so that each float4 read
//     from shared memory feeds 32 FMAs; at n 256 the grid is 2 x 126
//     blocks, two blocks an SM: one wave on 132 SMs;
//   * the K loop streams 32-deep slices of both operands through a
//     double-buffered cp.async ring (16-byte copies where d % 4 == 0 and
//     the operands are 16-byte aligned, else 4-byte ones), rows kept
//     K-contiguous with a 4-float pad, so the float4 reads of a quarter
//     warp fall in distinct banks;
//   * each block sums the squares of its own 128 x rows and 128 y rows as
//     their slices pass (a thread a row; a slice's 32 squares in a
//     pairwise tree, the slices in order), so every block that holds a
//     row gets the same bits and no pre-pass or norm buffer is needed;
//   * the tail is elementwise in registers, and the [n, m] result is
//     written once.
// The elementwise steps use __f*_rn intrinsics in the plain version's
// operation order, so no product is contracted into an FMA behind its
// back.
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

constexpr int PD_BM = 128;        // x rows (output rows) a block
constexpr int PD_BN = 128;        // y rows (output columns) a block
constexpr int PD_BK = 32;         // depth of a K-slice
constexpr int PD_LD = PD_BK + 4;  // a row's floats in shared memory
constexpr int PD_THREADS = 256;   // 16 x 16 threads of 8 x 8 outputs
constexpr int PD_STAGE = (PD_BM + PD_BN) * PD_LD;   // floats a stage
constexpr size_t PD_SMEM = 2 * PD_STAGE * sizeof(float);
static_assert(PD_BM + PD_BN == PD_THREADS, "a thread a row for the norms");

// the sum of the squares of row[0 .. PD_BK - 1] (16-byte aligned, in
// shared memory): squares rounded, then a pairwise tree
__device__ __forceinline__ float slice_sq_sum(const float* row) {
  float v[PD_BK];
#pragma unroll
  for (int k = 0; k < PD_BK; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + k);
    v[k] = __fmul_rn(q.x, q.x);
    v[k + 1] = __fmul_rn(q.y, q.y);
    v[k + 2] = __fmul_rn(q.z, q.z);
    v[k + 3] = __fmul_rn(q.w, q.w);
  }
#pragma unroll
  for (int w = 1; w < PD_BK; w *= 2)
#pragma unroll
    for (int k = 0; k < PD_BK; k += 2 * w) v[k] = __fadd_rn(v[k], v[k + w]);
  return v[0];
}

__global__ void __launch_bounds__(PD_THREADS, 2)
    pairwise_dist_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, int n, int m, int d,
                         int vec, float c, float two_c, float sqrt_c,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float pd_smem[];
  __shared__ float x2s[PD_BM], y2s[PD_BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * PD_BM, c0 = blockIdx.x * PD_BN;

  // a stage holds the x slice's PD_BM rows, then the y slice's PD_BN
  auto load = [&](int kt, int stage) {
    float* st = pd_smem + stage * PD_STAGE;
    const int k0 = kt * PD_BK;
    if (vec) {
#pragma unroll
      for (int e = tid; e < (PD_BM + PD_BN) * PD_BK / 4; e += PD_THREADS) {
        const int r = e / (PD_BK / 4), kk = e % (PD_BK / 4) * 4;
        const bool is_x = r < PD_BM;
        const int gr = is_x ? r0 + r : c0 + r - PD_BM;
        const bool ok = gr < (is_x ? n : m) && k0 + kk < d;
        const float* src = is_x ? x : y;
        ptt::cp_async16(&st[r * PD_LD + kk],
                        ok ? src + (size_t)gr * d + k0 + kk : src, ok);
      }
    } else {
      for (int e = tid; e < (PD_BM + PD_BN) * PD_BK; e += PD_THREADS) {
        const int r = e / PD_BK, kk = e % PD_BK;
        const bool is_x = r < PD_BM;
        const int gr = is_x ? r0 + r : c0 + r - PD_BM;
        const bool ok = gr < (is_x ? n : m) && k0 + kk < d;
        const float* src = is_x ? x : y;
        ptt::cp_async4(&st[r * PD_LD + kk],
                       ok ? src + (size_t)gr * d + k0 + kk : src, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float sq = 0.0f;   // thread t's row: x row t (t < PD_BM), else y row

  const int kts = (d + PD_BK - 1) / PD_BK;
  if (kts > 0) load(0, 0);
  ptt::cp_async_commit();
  for (int kt = 0; kt < kts; ++kt) {
    if (kt + 1 < kts) load(kt + 1, (kt + 1) & 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();                 // slice kt is in
    const float* Xs = pd_smem + (kt & 1) * PD_STAGE;
    const float* Ys = Xs + PD_BM * PD_LD;
    sq = __fadd_rn(sq, slice_sq_sum(Xs + tid * PD_LD));
#pragma unroll
    for (int k = 0; k < PD_BK; k += 4) {
      float4 yv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        yv[j] = *reinterpret_cast<const float4*>(
            &Ys[(tx + 16 * j) * PD_LD + k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &Xs[(ty + 16 * i) * PD_LD + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(xv.x, yv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.y, yv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv.z, yv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv.w, yv[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();                 // the stage is free for slice kt + 2
  }
  if (tid < PD_BM)
    x2s[tid] = sq;
  else
    y2s[tid - PD_BM] = sq;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
    const float xs = x2s[ty + 16 * i];
    const float alpha = fmaxf(__fsub_rn(1.0f, __fmul_rn(c, xs)), MIN_NORM);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= m) continue;
      const float ys = y2s[tx + 16 * j];
      const float beta = fmaxf(__fsub_rn(1.0f, __fmul_rn(c, ys)), MIN_NORM);
      const float sqd = fmaxf(
          __fadd_rn(__fsub_rn(xs, __fmul_rn(2.0f, acc[i][j])), ys), 0.0f);
      float g = __fadd_rn(1.0f, __fdiv_rn(__fmul_rn(two_c, sqd),
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

// x [n, d], y [m, d] f32 -> out [n, m] f32, n, m >= 1, one launch.
// two_c = f32(2 c), sqrt_c = f32(sqrt(c)), both computed by the caller.
int ptt_pairwise_dist(const void* x, const void* y, int n, int m, int d,
                      float c, float two_c, float sqrt_c, void* out,
                      void* stream) {
  if (n < 1 || m < 1 || d < 0) return (int)cudaErrorInvalidValue;
  static bool ready[ptt::MAX_DEVICES] = {};   // the attribute, once a device
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        pairwise_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)PD_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int vec = d % 4 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  dim3 grid((m + PD_BN - 1) / PD_BN, (n + PD_BM - 1) / PD_BM);
  pairwise_dist_kernel<<<grid, PD_THREADS, PD_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, n, m, d, vec, c, two_c, sqrt_c,
      (float*)out);
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
