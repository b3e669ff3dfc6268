// The warp-per-row LayerNorm shared by the serving layer (csrc/bf16_layer.cu)
// and the trainable MLP block (csrc/mlp_grad.cu): f32 statistics (eps
// 1e-5), bf16 output.
#pragma once

#include "common.cuh"

namespace ptt {

// One warp per row.
template <typename InT>
__global__ void layernorm_kernel(const InT* __restrict__ x, int ldx,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ out, int ldo, int M, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const InT* xr = x + (size_t)row * ldx;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + 1e-5f);
  bf16* orow = out + (size_t)row * ldo;
  for (int c = lane; c < D; c += 32)
    orow[c] = __float2bfloat16((to_f(xr[c]) - mu) * rstd * scale[c] + bias[c]);
}

template <typename InT>
void layernorm(const InT* x, int ldx, const float* s, const float* b, bf16* out,
               int M, int D, cudaStream_t st) {
  layernorm_kernel<InT><<<(M + 7) / 8, 256, 0, st>>>(x, ldx, s, b, out, D, M, D);
}

}  // namespace ptt
