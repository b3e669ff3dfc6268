// Multi-head attention over one (query tile, head, image) with K and V of
// the whole sequence in shared memory, in the TPU kernels' exp2 form:
// q carries log2(e)/sqrt(hd) already, so p = bf16(exp2(clip(s, -100, 80)))
// with no max subtraction; the denominator sums the rounded p over the
// valid keys; output O / sum, an exact f32 divide.  Keys at or past
// valid_len take p = 0, which equals the TPU kernels' zeroed V rows and 0/1
// valid column: the pad keys add exact zeros.  The stream is padded, so
// rows valid_len..S-1 of K and V exist in memory.
//
// Used by the int8 layer kernels (csrc/int8_layer.cu, f32 output).  The
// bf16 serving layer, the standalone attention and the trainable attention
// sub-layer's forward have their own tile, csrc/flash_tile.cuh.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ptt_attention {

using namespace nvcuda;
using ptt::bf16;

constexpr int HD = 64;   // head width this kernel is written for
constexpr int QT = 64;   // query rows per block
constexpr int THREADS = 128;
constexpr int KV_LD = HD + 8;
constexpr float SCORE_LO = -100.0f, SCORE_HI = 80.0f;

__host__ __device__ inline int s_ld(int S) { return (S > HD ? S : HD) + 8; }

inline size_t smem_bytes(int S) {
  const size_t sld = s_ld(S);
  return (2 * (size_t)S + QT) * KV_LD * sizeof(bf16)   // K, V, Q
         + QT * sld * sizeof(float)                      // scores, then O
         + QT * sld * sizeof(bf16)                       // p
         + QT * sizeof(float);                           // row sums
}

// softmax(q k^T) v for one (query tile qt, head h, image b).  q, k, v, o
// are row-major views with their own image and row strides (in elements);
// the head's 64 columns start at h * 64.  S % 16 == 0.  Every thread of
// the block loads; warps 0-3 compute, each owning 16 query rows, and the
// others return after the loads.  The caller that runs several tiles in
// one block syncs the block between them.
template <typename OutT>
__device__ __forceinline__ void attention_tile(
    const bf16* __restrict__ q, long long q_img, int q_row, int n_q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, long long kv_img,
    int kv_row, OutT* __restrict__ o, long long o_img, int o_row, int S,
    int valid_len, int qt, int h, int b, unsigned char* smem) {
  const int sld = s_ld(S);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KV_LD;
  bf16* Qs = Vs + (size_t)S * KV_LD;
  float* Ss = reinterpret_cast<float*>(Qs + QT * KV_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + (size_t)QT * sld);
  float* rsum = reinterpret_cast<float*>(Ps + (size_t)QT * sld);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * q_img + h * HD;
  const bf16* kb = k + b * kv_img + h * HD;
  const bf16* vb = v + b * kv_img + h * HD;

  for (int c = tid; c < S * (HD / 8); c += nthreads) {
    const int r = c >> 3, cc = (c & 7) * 8;
    *reinterpret_cast<uint4*>(&Ks[r * KV_LD + cc]) =
        *reinterpret_cast<const uint4*>(&kb[(size_t)r * kv_row + cc]);
    *reinterpret_cast<uint4*>(&Vs[r * KV_LD + cc]) =
        *reinterpret_cast<const uint4*>(&vb[(size_t)r * kv_row + cc]);
  }
  for (int c = tid; c < QT * (HD / 8); c += nthreads) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const int qr = qt * QT + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qr < n_q) val = *reinterpret_cast<const uint4*>(&qb[(size_t)qr * q_row + cc]);
    *reinterpret_cast<uint4*>(&Qs[r * KV_LD + cc]) = val;
  }
  __syncthreads();
  if (warp >= QT / 16) return;

  // scores: each warp owns 16 query rows
  const int r0 = warp * 16;
  for (int n = 0; n < S; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
    wmma::fill_fragment(sacc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(a, &Qs[r0 * KV_LD + kk], KV_LD);
      wmma::load_matrix_sync(kf, &Ks[n * KV_LD + kk], KV_LD);
      wmma::mma_sync(sacc, a, kf, sacc);
    }
    wmma::store_matrix_sync(&Ss[r0 * sld + n], sacc, sld, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax numerator p (bf16) and the sum of the rounded p
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const float* srow = Ss + (size_t)r * sld;
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32) {
      float p = 0.0f;
      if (c < valid_len) p = exp2f(fminf(fmaxf(srow[c], SCORE_LO), SCORE_HI));
      const bf16 pb = __float2bfloat16(p);
      Ps[r * sld + c] = pb;
      sum += __bfloat162float(pb);
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) rsum[r] = sum;
  }
  __syncwarp();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  for (int kk = 0; kk < S; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, &Ps[r0 * sld + kk], sld);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, &Vs[kk * KV_LD + j * 16], KV_LD);
      wmma::mma_sync(oacc[j], a, vf, oacc[j]);
    }
  }
  // the warp's own score rows are free now: stage O there
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(&Ss[r0 * sld + j * 16], oacc[j], sld,
                            wmma::mem_row_major);
  __syncwarp();
  OutT* ob = o + b * o_img + h * HD;
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = r0 + e / HD, c = e % HD;
    const int qr = qt * QT + r;
    if (qr < n_q)
      ptt::store_f(&ob[(size_t)qr * o_row + c],
                   __fdiv_rn(Ss[r * sld + c], rsum[r]));
  }
}

// One block of THREADS threads per (query tile, head, image).
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    attention_kernel(const bf16* __restrict__ q, long long q_img, int q_row,
                     int n_q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, long long kv_img, int kv_row,
                     OutT* __restrict__ o, long long o_img, int o_row, int S,
                     int valid_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  attention_tile<OutT>(q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img,
                       o_row, S, valid_len, blockIdx.x, blockIdx.y, blockIdx.z,
                       smem);
}

// Launch over (query tiles, heads, images); returns cudaGetLastError().
template <typename OutT>
int attention(const bf16* q, long long q_img, int q_row, int n_q,
              const bf16* k, const bf16* v, long long kv_img, int kv_row,
              OutT* o, long long o_img, int o_row, int B, int H, int S,
              int valid_len, cudaStream_t st) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_q + QT - 1) / QT, H, B);
  attention_kernel<OutT><<<grid, THREADS, smem, st>>>(
      q, q_img, q_row, n_q, k, v, kv_img, kv_row, o, o_img, o_row, S,
      valid_len);
  return (int)cudaGetLastError();
}

}  // namespace ptt_attention
