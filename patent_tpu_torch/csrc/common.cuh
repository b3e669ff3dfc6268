// Helpers shared by the kernels of patent_tpu_torch/csrc.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// return a nonzero error code of `call` (a launch helper's) to the caller
#define PTT_TRY(call)              \
  do {                             \
    const int err_ = (call);       \
    if (err_ != 0) return err_;    \
  } while (0)

// return the error of the last launch, if any, to the caller
#define PTT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

namespace ptt {

typedef __nv_bfloat16 bf16;

// most devices of a process that the wrappers' per-device caches (an SM
// count, a grid size, a kernel's shared-memory attribute) hold
constexpr int MAX_DEVICES = 64;

// the current device, the one a launch goes to: the key of those caches
inline int current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= MAX_DEVICES))
    e = cudaErrorInvalidDevice;
  return (int)e;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// two outputs at p (an even element): rounded to bf16, or kept f32
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The int8 kernels' fast form (csrc/int8_layer.cu): the reciprocal
// f32(bf16(1 / f32(bf16(x)))), what the JAX kernels' approximate
// reciprocal lowers to off the TPU.  y = bf16(x) has 8 significant bits,
// so 1 / y lies at least 128 f32 ulps from every bf16 rounding midpoint
// (tests/test_torch_int8_fast.py checks each of the 128 mantissas): the
// hardware's approximate reciprocal (rcp.approx.f32, within 1 ulp, one
// instruction; subnormals kept) rounds to the bf16 value the IEEE divide
// rounds to, bit for bit.
__device__ __forceinline__ float recip_bf16(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;"
      : "=f"(r)
      : "f"(__bfloat162float(__float2bfloat16_rn(x))));
  return __bfloat162float(__float2bfloat16_rn(r));
}
// and its int8 code of v: rint, saturated to [-128, 127] as XLA's f32 ->
// s8 convert saturates (x * inv reaches 127.74 there)
__device__ __forceinline__ signed char sat_s8(float v) {
  return (signed char)max(-128, min(127, __float2int_rn(v)));
}

// 16-byte global -> shared copy that bypasses registers; pred == false
// zero-fills the destination (the source address is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
// the same for one 4-byte value (through L1: .cg takes 16 bytes only)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ptt
