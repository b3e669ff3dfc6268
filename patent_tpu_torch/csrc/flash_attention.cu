// Standalone multi-head attention softmax(q k^T / sqrt(d)) v on projected
// q, k, v [B, S, H, 64] -> [B, S, H, 64] in q's dtype, the `use_flash`
// tower's attention.
//
// Replaces the TPU kernels of patent_tpu/ops/flash_attention.py
// _attn_kernel (_flash_impl) and _attn_kernel_headbatch
// (_flash_impl_headbatch), public entry flash_attention: one function under
// two tilings, in q's dtype, here ptt_flash_attention (bf16) and
// ptt_flash_attention_f32.
//
// The TPU kernel's function, per (image, head), in q's dtype T:
//   q' = T(f32(q) * scale)              (scale = log2(e)/sqrt(64), f32)
//   p  = T(exp2(clip(q'.k, -100, 80))), keys >= S p = 0
//   o  = T((p v) / sum(p))              (f32 sums, an exact divide)
//
// bf16 (the tower's dtype): csrc/flash_tile.cuh, which says what bounds it
// on the H100 and what its design does about it, with q scaled on load,
// K and V read once per (head, image) and zero-filled from S up to the
// next multiple of 16, and q, k, v read where they lie (image and row
// strides are arguments, so the [B, S, H*64] layout, or slices of one
// [B, S, 3*H*64] qkv tensor, need no copy or transpose).
//
// f32 (JAX's VisionTransformer defaults to f32): a plain kernel on the CUDA
// cores, products and sums in f32 FMAs, no TF32.  One block of 128 threads
// per (128 query rows, head, image) with the head's K and V in shared
// memory as f32; each thread owns one query row, its q' and its 64 output
// sums in registers, and walks the keys (every thread reads the same K and
// V row, a broadcast).  Right before fast: it runs at FP32 FMA rate, and
// at S 197 its 101 KB of shared memory allow two blocks an SM.

#include "common.cuh"
#include "flash_tile.cuh"

using ptt::bf16;

namespace {

constexpr int HD = ptt_flash::HD;
constexpr int F32_ROWS = 128;   // query rows (threads) per block

__global__ void __launch_bounds__(F32_ROWS)
    flash_f32_kernel(const float* __restrict__ q, long long q_img, int q_row,
                     const float* __restrict__ k, const float* __restrict__ v,
                     long long kv_img, int kv_row, float* __restrict__ o,
                     long long o_img, int o_row, int S, float scale) {
  extern __shared__ __align__(16) float kvs[];
  float* Ks = kvs;
  float* Vs = kvs + (size_t)S * HD;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * kv_img + h * HD;
  const float* vb = v + b * kv_img + h * HD;
  for (int c = threadIdx.x; c < S * (HD / 4); c += blockDim.x) {
    const int r = c / (HD / 4), cc = (c % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(&Ks[r * HD + cc]) =
        *reinterpret_cast<const float4*>(&kb[(size_t)r * kv_row + cc]);
    *reinterpret_cast<float4*>(&Vs[r * HD + cc]) =
        *reinterpret_cast<const float4*>(&vb[(size_t)r * kv_row + cc]);
  }
  __syncthreads();
  const int qr = blockIdx.x * F32_ROWS + threadIdx.x;
  if (qr >= S) return;
  const float* qp = q + b * q_img + (size_t)qr * q_row + h * HD;
  float qs[HD], acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    qs[i] = __fmul_rn(qp[i], scale);
    acc[i] = 0.0f;
  }
  float sum = 0.0f;
  for (int j = 0; j < S; ++j) {
    const float* kr = Ks + j * HD;
    const float* vr = Vs + j * HD;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) s = fmaf(qs[i], kr[i], s);
    const float p = exp2f(fminf(fmaxf(s, ptt_flash::SCORE_LO),
                                ptt_flash::SCORE_HI));
    sum += p;
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
  }
  float* op = o + b * o_img + (size_t)qr * o_row + h * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) op[i] = __fdiv_rn(acc[i], sum);
}

}  // namespace

extern "C" {

// q [B, S, H, 64] bf16 with image stride q_img and row stride q_row
// (elements), k and v with kv_img and kv_row, the last two axes packed; o
// [B, S, H, 64] contiguous.  scale = log2(e)/sqrt(64) in f32.
int ptt_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, long long q_img, int q_row,
                        long long kv_img, int kv_row, float scale,
                        void* stream) {
  const int Sp = (S + 15) / 16 * 16;
  return ptt_flash::attention<true>(
      (const bf16*)q, q_img, q_row, S, (const bf16*)k, (const bf16*)v, kv_img,
      kv_row, (bf16*)o, (long long)S * H * HD, H * HD, B, H, Sp, S, scale,
      (cudaStream_t)stream);
}

// The same function on f32 q, k, v, o (strides as above; 16-byte aligned
// rows).
int ptt_flash_attention_f32(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, long long q_img,
                            int q_row, long long kv_img, int kv_row,
                            float scale, void* stream) {
  const size_t smem = 2 * (size_t)S * HD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + F32_ROWS - 1) / F32_ROWS, H, B);
  flash_f32_kernel<<<grid, F32_ROWS, smem, (cudaStream_t)stream>>>(
      (const float*)q, q_img, q_row, (const float*)k, (const float*)v, kv_img,
      kv_row, (float*)o, (long long)S * H * HD, H * HD, S, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
