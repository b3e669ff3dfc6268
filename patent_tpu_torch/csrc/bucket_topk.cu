// Bucketed top-2 candidate stage of the exact cosine search, over a bf16
// or an int8 gallery.
//
// Replaces the TPU kernel patent_tpu/ops/topk_kernel.py::_bucket_topk_kernel
// (via _bucket_topk_call and _fold_scores; public entries bucket_topk_bf16
// and bucket_topk_int8).  Gallery column j falls in bucket j mod L
// (L = 1024).  For every (query, bucket) the kernel keeps the best two
// (score, column) pairs.  bf16: scores are bf16 query x bf16 gallery dot
// products accumulated in f32; rows with valid == 0 score -inf.  int8:
// scores are f32(int8 query . int8 gallery row) * the row's scale (int32
// accumulation, exact), -inf where the scale is <= 0; the query's own
// scale is one positive factor per row and is applied by the caller.  The
// caller picks the top `pool` of the 2L candidates and re-ranks them
// exactly in f32.
//
// One difference from the TPU kernel, by design: there the grid walks the
// gallery in order, 2048 rows a step, and each step keeps only ONE winner
// per bucket before merging into the running top-2 (topk_kernel.py
// _fold_scores), so for n > 2L its guaranteed capacity is L candidates.
// Here every (query, bucket) keeps the exact top-2 over the whole gallery,
// so the capacity is min(n, 2L) at every n.
//
// What bounds it on the H100: at 1M x 512 the gallery is 1 GB of bf16 and
// Q = 256 queries make 0.27 TFLOP, so one pass over the gallery sits near
// the balance point of bandwidth (~0.3 ms at 3.35 TB/s) and the bf16
// tensor-core rate (~0.3 ms); each 64-query tile makes its own pass.  The
// int8 gallery is half the bytes (~0.15 ms) at twice the tensor-core rate
// (~0.14 ms): still at the balance point.
// Design:
//   * the TPU's sequential grid, with accumulators carried across steps,
//     becomes a partition by bucket: a block owns 32 buckets x 64 queries
//     and walks the gallery rows b, b+L, b+2L, ... of its buckets, which
//     are 32 consecutive rows per step, so every load is contiguous;
//   * the scores of a step come from wmma (bf16, f32 accumulate) or
//     mma.sync m16n8k32 (int8, int32 accumulate) against the query tile
//     held in shared memory, and fold into top-2 registers with a strict
//     '>' so that ties keep the earlier column;
//   * to fill 132 SMs when Q is small, the steps are also split across
//     `splits` blocks (step t goes to split t mod splits); a second kernel
//     merges the per-split top-2 lists in (score desc, column asc) order,
//     which gives exactly the sequential answer.  Nothing carries between
//     blocks.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
using ptt::bf16;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BB = 32;       // buckets per block
constexpr int THREADS = 128; // 4 warps, 16 query rows each
constexpr int SC_LD = BB + 4;
constexpr int PAIRS = BQ * BB / THREADS;

// Elements of padding per shared row: 16 bytes, which also keeps the
// int8 fragment loads free of bank conflicts.
template <typename T>
constexpr int ROW_PAD = 16 / (int)sizeof(T);

template <typename T>
size_t partial_smem_bytes(int D) {
  const size_t ldd = D + ROW_PAD<T>;
  return (BQ + BB) * ldd * sizeof(T) + BQ * SC_LD * sizeof(float) +
         BB * sizeof(float);
}

// T = bf16: scores are bf16 dot products accumulated in f32 (wmma), and
// `valid` is a 0/1 row mask.  T = int8_t: scores are f32(int32 dot) times
// `valid`, the row's dequant scale (mma.sync s8), and a row scores -inf
// where its scale is <= 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bucket_top2_partial(const T* __restrict__ q, int Q,
                        const T* __restrict__ gal,
                        const float* __restrict__ valid, int N, int D, int L,
                        int T_steps, int splits, float* __restrict__ pv1,
                        int* __restrict__ pi1, float* __restrict__ pv2,
                        int* __restrict__ pi2) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int PER16 = 16 / (int)sizeof(T);   // elements per 16 bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldd = D + ROW_PAD<T>;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + (size_t)BQ * ldd;
  float* Sc = reinterpret_cast<float*>(Gs + (size_t)BB * ldd);
  float* Vf = Sc + BQ * SC_LD;

  const int b0 = blockIdx.x * BB, q0 = blockIdx.y * BQ, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = D / PER16;

  for (int c = tid; c < BQ * chunks; c += THREADS) {
    const int r = c / chunks, cc = (c % chunks) * PER16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Q)
      val = *reinterpret_cast<const uint4*>(&q[(size_t)(q0 + r) * D + cc]);
    *reinterpret_cast<uint4*>(&Qs[r * ldd + cc]) = val;
  }

  float v1[PAIRS], v2[PAIRS];
  int i1[PAIRS], i2[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    v1[p] = -INFINITY;
    v2[p] = -INFINITY;
    i1[p] = 0;
    i2[p] = 0;
  }

  for (int t = z; t < T_steps; t += splits) {
    __syncthreads();  // the previous step's fold has read Sc and Vf
    const long long row0 = (long long)t * L + b0;
    for (int c = tid; c < BB * chunks; c += THREADS) {
      const int r = c / chunks, cc = (c % chunks) * PER16;
      const long long row = row0 + r;
      const bool ok = row < N && b0 + r < L;
      ptt::cp_async16(&Gs[r * ldd + cc], ok ? gal + row * D + cc : gal, ok);
    }
    ptt::cp_async_commit();
    if (tid < BB) {
      const long long row = row0 + tid;
      const bool in = row < N && b0 + tid < L;
      if constexpr (INT8)
        Vf[tid] = in ? valid[row] : 0.0f;
      else
        Vf[tid] = (in && valid[row] > 0.0f) ? 1.0f : 0.0f;
    }
    ptt::cp_async_wait<0>();
    __syncthreads();

    if constexpr (INT8) {
      // each warp: its 16 query rows x the 32 buckets, four m16n8k32 tiles
      const int g = lane >> 2, tq = lane & 3;
      int acc[BB / 8][4];
#pragma unroll
      for (int j = 0; j < BB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      const int8_t* qa = reinterpret_cast<const int8_t*>(Qs) + warp * 16 * ldd;
      const int8_t* gb = reinterpret_cast<const int8_t*>(Gs);
      for (int kk = 0; kk < D; kk += 32) {
        uint32_t a[4], b[2];
        a[0] = ptt::ld32(qa + g * ldd + kk + tq * 4);
        a[1] = ptt::ld32(qa + (g + 8) * ldd + kk + tq * 4);
        a[2] = ptt::ld32(qa + g * ldd + kk + 16 + tq * 4);
        a[3] = ptt::ld32(qa + (g + 8) * ldd + kk + 16 + tq * 4);
#pragma unroll
        for (int j = 0; j < BB / 8; ++j) {
          b[0] = ptt::ld32(gb + (j * 8 + g) * ldd + kk + tq * 4);
          b[1] = ptt::ld32(gb + (j * 8 + g) * ldd + kk + 16 + tq * 4);
          ptt::mma_s8(acc[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < BB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = warp * 16 + g + 8 * (e >> 1);
          const int bb = j * 8 + 2 * tq + (e & 1);
          Sc[qq * SC_LD + bb] = __fmul_rn(__int2float_rn(acc[j][e]), Vf[bb]);
        }
    } else {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BB / 16];
#pragma unroll
      for (int j = 0; j < BB / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &Qs[warp * 16 * ldd + kk], ldd);
#pragma unroll
        for (int j = 0; j < BB / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> g;
          wmma::load_matrix_sync(g, &Gs[j * 16 * ldd + kk], ldd);
          wmma::mma_sync(acc[j], a, g, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BB / 16; ++j)
        wmma::store_matrix_sync(&Sc[warp * 16 * SC_LD + j * 16], acc[j], SC_LD,
                                wmma::mem_row_major);
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int pair = tid + p * THREADS;
      const int qq = pair / BB, bb = pair % BB;
      const float s = Vf[bb] > 0.0f ? Sc[qq * SC_LD + bb] : -INFINITY;
      const int col = (int)(row0 + bb);
      if (s > v1[p]) {  // strict: ties keep the earlier column
        v2[p] = v1[p];
        i2[p] = i1[p];
        v1[p] = s;
        i1[p] = col;
      } else if (s > v2[p]) {
        v2[p] = s;
        i2[p] = col;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int pair = tid + p * THREADS;
    const int qr = q0 + pair / BB, b = b0 + pair % BB;
    if (qr < Q && b < L) {
      const size_t o = ((size_t)z * Q + qr) * L + b;
      pv1[o] = v1[p];
      pi1[o] = i1[p];
      pv2[o] = v2[p];
      pi2[o] = i2[p];
    }
  }
}

__device__ __forceinline__ void insert2(float v, int i, float& a1, int& j1,
                                        float& a2, int& j2) {
  if (v == -INFINITY) return;  // empty slot
  if (v > a1 || (v == a1 && i < j1)) {
    a2 = a1;
    j2 = j1;
    a1 = v;
    j1 = i;
  } else if (v > a2 || (v == a2 && i < j2)) {
    a2 = v;
    j2 = i;
  }
}

// Merge the per-split top-2 lists of each (query, bucket) in
// (score desc, column asc) order.
__global__ void bucket_top2_merge(const float* __restrict__ pv1,
                                  const int* __restrict__ pi1,
                                  const float* __restrict__ pv2,
                                  const int* __restrict__ pi2, int splits,
                                  int QL, float* __restrict__ v1,
                                  int* __restrict__ i1, float* __restrict__ v2,
                                  int* __restrict__ i2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= QL) return;
  float a1 = -INFINITY, a2 = -INFINITY;
  int j1 = 0, j2 = 0;
  for (int z = 0; z < splits; ++z) {
    const size_t o = (size_t)z * QL + e;
    insert2(pv1[o], pi1[o], a1, j1, a2, j2);
    insert2(pv2[o], pi2[o], a1, j1, a2, j2);
  }
  v1[e] = a1;
  i1[e] = j1;
  v2[e] = a2;
  i2[e] = j2;
}

// Both kinds of gallery: the per-split top-2 lists, then their merge.
template <typename T>
int bucket_top2(const void* q, int Q, const void* gal, const void* valid,
                int N, int D, int L, int splits, void* pv1, void* pi1,
                void* pv2, void* pi2, void* v1, void* i1, void* v2, void* i2,
                cudaStream_t st) {
  const int T_steps = (N + L - 1) / L;
  const size_t smem = partial_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_top2_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / BB, (Q + BQ - 1) / BQ, splits);
  bucket_top2_partial<T><<<grid, THREADS, smem, st>>>(
      (const T*)q, Q, (const T*)gal, (const float*)valid, N, D, L, T_steps,
      splits, (float*)pv1, (int*)pi1, (float*)pv2, (int*)pi2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int QL = Q * L;
  bucket_top2_merge<<<(QL + 255) / 256, 256, 0, st>>>(
      (const float*)pv1, (const int*)pi1, (const float*)pv2, (const int*)pi2,
      splits, QL, (float*)v1, (int*)i1, (float*)v2, (int*)i2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [Q, D] bf16 (normalized), gal [N, D] bf16, valid [N] f32 -> v1, i1, v2,
// i2 [Q, L].  Scratch: pv1, pi1, pv2, pi2 [splits, Q, L].  D % 16 == 0,
// L % 32 == 0.
int ptt_bucket_top2(const void* q, int Q, const void* gal, const void* valid,
                    int N, int D, int L, int splits, void* pv1, void* pi1,
                    void* pv2, void* pi2, void* v1, void* i1, void* v2,
                    void* i2, void* stream) {
  return bucket_top2<bf16>(q, Q, gal, valid, N, D, L, splits, pv1, pi1, pv2,
                           pi2, v1, i1, v2, i2, (cudaStream_t)stream);
}

// The int8 gallery: q [Q, D] int8, gal [N, D] int8, gal_scale [N] f32 ->
// v1, i1, v2, i2 [Q, L] on the f32(acc) * gal_scale scale (the query scale
// is applied by the caller).  D % 32 == 0, L % 32 == 0.
int ptt_bucket_top2_i8(const void* q, int Q, const void* gal,
                       const void* gal_scale, int N, int D, int L, int splits,
                       void* pv1, void* pi1, void* pv2, void* pi2, void* v1,
                       void* i1, void* v2, void* i2, void* stream) {
  return bucket_top2<int8_t>(q, Q, gal, gal_scale, N, D, L, splits, pv1, pi1,
                             pv2, pi2, v1, i1, v2, i2, (cudaStream_t)stream);
}

}  // extern "C"
