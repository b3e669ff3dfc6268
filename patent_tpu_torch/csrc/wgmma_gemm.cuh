// The bf16 GEMM for Hopper, with the serving layer's fused epilogues:
//
//   C[M, N] = epi(A[M, K] . B[K, N] + bias)   bf16 operands, f32 accumulation
//
// shared by the bf16 layer kernels (csrc/bf16_layer.cu: rows 1 and 2), the
// trainable attention block (csrc/fused_attention.cu: rows 12 and 13) and
// the trainable MLP block (csrc/mlp_grad.cu: rows 15 and 16), whose
// backward also takes its MN-major form below (gemm_tn: the weight
// gradients).
// A is row-major with row stride lda (a strided view, such as every S-th
// row of a token stream, is read in place); B is taken as its transpose
// Bt [N, K], row-major, so that both operands are K-major, the layout the
// 128-byte swizzle of TMA and wgmma read without a transpose bit.  The
// serving tower makes Bt once at load time (models/vit.py), which costs
// one copy of the layer's matrices in device memory and keeps one operand
// layout for every instance.
//
// What bounds it on the H100: at the tower's shapes (M = B*208 rows,
// K 768 or 3072, N 768 to 3072) a product does 2*M*N*K operations on
// 2*(M*K + K*N + M*N) bytes, 380-600 operations per byte, above the
// card's ~295: the tensor cores.  Design, as Hopper's tensor cores want:
//   * 128 x 256 output tiles, walked by one persistent block an SM of
//     three warpgroups: warpgroup 0 is the producer, one thread of it
//     issuing TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of the
//     128 x 64 A tile and the 256 x 64 Bt tile into a ring of STAGES
//     stages on mbarriers, running on into the next tile while the
//     consumers finish this one; warpgroups 1 and 2 each own 64 rows and
//     run wgmma.mma_async m64n256k16 from shared memory, one group kept in
//     flight, and give a stage back once the wgmma that read it is done;
//   * setmaxnreg moves registers from the producer (40 a thread) to the
//     consumers (232 a thread, 128 of them the accumulator);
//   * TMA zero-fills rows and columns past M, N and K, and the epilogue
//     masks its stores, so M is ragged (B*208 is not a multiple of 128 at
//     every batch) and N, K need only be multiples of 8 (16-byte rows);
//   * the epilogue runs on the accumulator registers: + bias (f32), then
//     the exp2 quick_gelu in either of the TPU kernels' two forms, or a
//     residual (bf16 or f32) added in either of their two orders, and
//     stores bf16 or f32 pairs.
// Not yet: clusters with the Bt tile multicast to two blocks (a third
// less L2 traffic per product), TMA stores, an epilogue that overlaps the
// next tile's products.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "common.cuh"

namespace ptt_wgmma {

using ptt::bf16;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 384;                 // producer + two consumers
constexpr int A_TILE = BM * BK, B_TILE = BN * BK;   // elements
constexpr uint32_t STAGE_BYTES = (A_TILE + B_TILE) * sizeof(bf16);
// the ring, 1024-byte aligned for the swizzle, then the barriers
constexpr size_t SMEM_BYTES = 1024 + STAGES * (size_t)STAGE_BYTES
                              + 2 * STAGES * sizeof(uint64_t);
constexpr float NEG_1702_LOG2E = (float)(-1.702 * 1.4426950408889634);

enum Epi {
  EPI_BIAS = 0,       // v + bias                      (qkv, K/V, the CLS q)
  EPI_BIAS_GELU = 1,  // g / (1 + exp2(NEG_1702_LOG2E g)), g = v + bias (MLP in)
  EPI_RES_BIAS = 2,   // (res + v) + bias              (out-projection)
  EPI_BIAS_RES = 3,   // res + (v + bias)              (MLP out)
  // the trainable MLP block (rows 15 and 16), the TPU kernel's forms:
  EPI_BIAS_GELU_AUX = 4,  // g = v + bias -> aux (f32);
                          // g * (1 / (1 + exp2(NEG_1702_LOG2E g)))
  EPI_DGELU = 5,      // g = aux; s = 1 / (1 + exp2(NEG_1702_LOG2E g));
                      // dg = v * (s * (1 + 1.702 g (1 - s))), and each
                      // warp's 16-row column sums of the f32 dg -> part
  EPI_NONE = 6,       // v
  EPI_BIAS_QGELU = 7, // EPI_BIAS_GELU_AUX without the aux store (MLP in
                      // of row 15: the same bits as row 16's recompute)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier in shared memory: init with the arrivals a phase takes, and
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// a box of the 2-D tensor map at (c0 along the rows' elements, c1 rows)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart
// (SBO); the leading offset is unused in this layout.  Stepping 16 values
// along K adds 32 bytes (2 in the >> 4 field) to the start address.
__device__ __forceinline__ uint64_t desc_k_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major tile written by TMA with the 128-byte
// swizzle as boxes of BK rows (along K) by 64 values (along M or N, 128
// bytes): K rows 128 bytes apart, 8-row groups 1024 bytes apart (SBO), one
// box to the next along M or N BK * 128 bytes apart (LBO).  Stepping 16
// values along K adds 16 rows, 2048 bytes (128 in the >> 4 field).
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)((BK * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] . Bt[256 x 16]^T, both from shared memory,
// K-major, or with TRANS_A / TRANS_B the MN-major tiles of A stored
// [16, 64] and B stored [16, 256] (wgmma's transpose bits).  Lane l of warp
// w (of the warpgroup) holds, for i = 0..31, d[4i + e] at row 16w + l/4 +
// 8(e/2), column 8i + 2(l%4) + e%2.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));

}

template <int EPI, typename ResT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ bias, const ResT* __restrict__ res,
                long long ldr, OutT* __restrict__ C, long long ldc, int M,
                int N, int K, float* __restrict__ aux,
                float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* As = reinterpret_cast<bf16*>(base);
  bf16* Bs = As + STAGES * A_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_TILE);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntn;
  const int ktiles = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // it counts the k-steps over all of this block's tiles
      for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          // the consumers gave stage s back after reading step it - STAGES
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load(As + s * A_TILE, &map_a, &full[s], kt * BK, m0);
          tma_load(Bs + s * B_TILE, &map_b, &full[s], kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;     // this warpgroup's 64 rows of the tile
    float d[128];
    for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da = desc_k_sw128(As + s * A_TILE + cw * 64 * BK);
        const uint64_t db = desc_k_sw128(Bs + s * B_TILE);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        fence_acc(d);
        // the group of step it - 1 has finished: its stage goes back
        wgmma_wait<1>();
        fence_acc(d);
        if (kt > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(d);
      // and the tile's last stage, so that the producer can refill it while
      // this warpgroup runs the epilogue
      if (tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      const int warp = tid / 32, lane = tid % 32;
      const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
      if constexpr (EPI == EPI_DGELU) {
        // aux and C share C's row stride; the warp's 16 rows are one slab
        // of part ([M rounded up to BM, / 16][N]), rows past M adding 0.
        // The g of G column groups is loaded before any is used, so that
        // their loads are in flight together
        constexpr int G = 8;
        const size_t slab = (size_t)(m0 + cw * 64 + warp * 16) / 16;
#pragma unroll
        for (int i0 = 0; i0 < BN / 8; i0 += G) {
          float2 gv[G][2];
#pragma unroll
          for (int ii = 0; ii < G; ++ii) {
            const int col = n0 + 8 * (i0 + ii) + 2 * (lane % 4);
#pragma unroll
            for (int hlf = 0; hlf < 2; ++hlf) {
              const int row = r0 + 8 * hlf;
              gv[ii][hlf] =
                  row < M && col < N
                      ? *reinterpret_cast<const float2*>(
                            &aux[(size_t)row * ldc + col])
                      : make_float2(0.0f, 0.0f);
            }
          }
#pragma unroll
          for (int ii = 0; ii < G; ++ii) {
            const int i = i0 + ii;
            const int col = n0 + 8 * i + 2 * (lane % 4);
            float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
            for (int hlf = 0; hlf < 2; ++hlf) {
              const int row = r0 + 8 * hlf;
              if (row >= M || col >= N) continue;
              const float2 g = gv[ii][hlf];
              const float s0 = 1.0f / (1.0f + exp2f(NEG_1702_LOG2E * g.x));
              const float s1 = 1.0f / (1.0f + exp2f(NEG_1702_LOG2E * g.y));
              const float v0 = d[4 * i + 2 * hlf] *
                               (s0 * (1.0f + 1.702f * g.x * (1.0f - s0)));
              const float v1 = d[4 * i + 2 * hlf + 1] *
                               (s1 * (1.0f + 1.702f * g.y * (1.0f - s1)));
              ptt::store2(C + (size_t)row * ldc + col, v0, v1);
              c0 += v0;
              c1 += v1;
            }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              c0 += __shfl_xor_sync(0xffffffffu, c0, off);
              c1 += __shfl_xor_sync(0xffffffffu, c1, off);
            }
            if (lane < 4 && col < N)
              *reinterpret_cast<float2*>(&part[slab * N + col]) =
                  make_float2(c0, c1);
          }
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= N) continue;           // N % 8 == 0: col + 1 < N too
        float2 bb = make_float2(0.0f, 0.0f);
        if constexpr (EPI != EPI_NONE)
          bb = *reinterpret_cast<const float2*>(&bias[col]);
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int row = r0 + 8 * hlf;
          if (row >= M) continue;
          float v0 = d[4 * i + 2 * hlf], v1 = d[4 * i + 2 * hlf + 1];
          if constexpr (EPI == EPI_BIAS) {
            v0 += bb.x;
            v1 += bb.y;
          } else if constexpr (EPI == EPI_BIAS_GELU) {
            v0 += bb.x;
            v1 += bb.y;
            v0 = v0 / (1.0f + exp2f(NEG_1702_LOG2E * v0));
            v1 = v1 / (1.0f + exp2f(NEG_1702_LOG2E * v1));
          } else if constexpr (EPI == EPI_BIAS_GELU_AUX ||
                               EPI == EPI_BIAS_QGELU) {
            v0 += bb.x;
            v1 += bb.y;
            if constexpr (EPI == EPI_BIAS_GELU_AUX)
              *reinterpret_cast<float2*>(&aux[(size_t)row * ldc + col]) =
                  make_float2(v0, v1);
            v0 = v0 * (1.0f / (1.0f + exp2f(NEG_1702_LOG2E * v0)));
            v1 = v1 * (1.0f / (1.0f + exp2f(NEG_1702_LOG2E * v1)));
          } else if constexpr (EPI == EPI_RES_BIAS || EPI == EPI_BIAS_RES) {
            float r0v, r1v;
            const ResT* rp = res + (size_t)row * ldr + col;
            if constexpr (std::is_same<ResT, float>::value) {
              const float2 rr = *reinterpret_cast<const float2*>(rp);
              r0v = rr.x;
              r1v = rr.y;
            } else {
              const __nv_bfloat162 rr =
                  *reinterpret_cast<const __nv_bfloat162*>(rp);
              r0v = __bfloat162float(rr.x);
              r1v = __bfloat162float(rr.y);
            }
            if constexpr (EPI == EPI_RES_BIAS) {
              v0 = (r0v + v0) + bb.x;
              v1 = (r1v + v1) + bb.y;
            } else {
              v0 = r0v + (v0 + bb.x);
              v1 = r1v + (v1 + bb.y);
            }
          }
          ptt::store2(C + (size_t)row * ldc + col, v0, v1);
        }
      }
    }
  }
}

// The MN-major form for the weight gradients, split over K:
//
//   part[s] = (A^T B)[M, N] over K rows [s kper BK, (s + 1) kper BK)
//
// A [K, M] and B [K, N] row-major bf16 (the activations and the output
// cotangent as they lie: a reduction over their rows), f32 partials, part
// s at part + s M N.  The TMA boxes are BK rows by 64 columns, two of A
// and four of B a stage, and wgmma reads them with its transpose bits.
// The work units are (output tile, split) pairs, so that the 72 tiles of a
// [3072 x 768] gradient fill the card; each unit's sum runs over its rows
// in one order, and the caller adds the partials in split order, so two
// runs give the same bits.
static __global__ void __launch_bounds__(THREADS, 1)
    gemm_tn_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ part, int M, int N, int K, int splits,
                   int kper) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* As = reinterpret_cast<bf16*>(base);
  bf16* Bs = As + STAGES * A_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_TILE);
  uint64_t* empty = full + STAGES;
  constexpr int BOX = 64 * BK;               // one box, elements

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntn;
  const int units = tiles * splits;
  const int ktiles = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int u = blockIdx.x, it = 0; u < units; u += gridDim.x) {
        const int tile = u % tiles, k0 = u / tiles * kper;
        const int k1 = min(k0 + kper, ktiles);
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int kt = k0; kt < k1; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            tma_load(As + s * A_TILE + j * BOX, &map_a, &full[s],
                     m0 + 64 * j, kt * BK);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(Bs + s * B_TILE + j * BOX, &map_b, &full[s],
                     n0 + 64 * j, kt * BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    float d[128];
    for (int u = blockIdx.x, it = 0; u < units; u += gridDim.x) {
      const int tile = u % tiles, split = u / tiles, k0 = split * kper;
      const int k1 = min(k0 + kper, ktiles);
      const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      for (int kt = k0; kt < k1; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da = desc_mn_sw128(As + s * A_TILE + cw * BOX);
        const uint64_t db = desc_mn_sw128(Bs + s * B_TILE);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16<1, 1>(d, da + 128 * kk, db + 128 * kk, 1);
        wgmma_commit();
        fence_acc(d);
        wgmma_wait<1>();
        fence_acc(d);
        if (kt > k0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      float* out = part + (size_t)split * M * N;
      const int warp = tid / 32, lane = tid % 32;
      const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= N) continue;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int row = r0 + 8 * hlf;
          if (row < M)
            *reinterpret_cast<float2*>(&out[(size_t)row * N + col]) =
                make_float2(d[4 * i + 2 * hlf], d[4 * i + 2 * hlf + 1]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda.so.1, looked up once at run time,
// so that the link line needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a [rows, cols] bf16 matrix with row stride ld (elements), read in boxes
// of box_rows x BK with the 128-byte swizzle; out-of-bounds reads give 0
inline bool tensor_map(CUtensorMap* map, const bf16* p, long long rows,
                       long long cols, long long ld, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the SM count of the current device, asked once a device
inline int sm_count(int* n) {
  static int sms[ptt::MAX_DEVICES] = {};
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (sms[dev] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *n = sms[dev];
  return 0;
}

// C = epi(A . Bt^T + bias).  A [M, K] row stride lda, Bt [N, K] row stride
// ldb, res and C [M, N] with ldr, ldc (elements); K, N, lda, ldb, ldr,
// ldc multiples of 8 and A, Bt 16-byte aligned (checked by the host
// code).  aux: the f32 [M, N] of EPI_BIAS_GELU_AUX and EPI_DGELU (row
// stride ldc); part: EPI_DGELU's column sums, [ceil(M / BM) * BM / 16, N]
// f32.  Returns a CUDA error code, 0 on success.
template <int EPI, typename ResT, typename OutT>
int gemm(const bf16* A, long long lda, const bf16* Bt, long long ldb,
         const float* bias, const ResT* res, long long ldr, OutT* C,
         long long ldc, int M, int N, int K, cudaStream_t st,
         float* aux = nullptr, float* part = nullptr) {
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, A, M, K, lda, BM) ||
      !tensor_map(&map_b, Bt, N, K, ldb, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_kernel<EPI, ResT, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM (the ring takes most of its shared
  // memory), each walking the tiles blockIdx.x, + gridDim.x, ...
  int sms = 0;
  PTT_TRY(sm_count(&sms));
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, st>>>(
      map_a, map_b, bias, res, ldr, C, ldc, M, N, K, aux, part);
  return (int)cudaGetLastError();
}

// most ranges of k-steps that gemm_tn splits K into
constexpr int TN_MAX_SPLITS = 16;

// gemm_tn's plan for an [M, N] output over K rows on the current device:
// of the counts up to TN_MAX_SPLITS of ranges of whole k-steps, every
// range non-empty, the one whose units (output tiles x ranges), in waves
// of one an SM, take the fewest k-steps end to end (waves x k-steps a
// unit); ties to fewer ranges.
inline int tn_splits(int M, int N, int K, int* splits) {
  int sms = 0;
  PTT_TRY(sm_count(&sms));
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ktiles = (K + BK - 1) / BK;
  long long best = -1;
  *splits = 1;
  for (int s = 1; s <= TN_MAX_SPLITS && s <= ktiles; ++s) {
    const int kper = (ktiles + s - 1) / s;
    const int n = (ktiles + kper - 1) / kper;
    const long long cost = (tiles * n + sms - 1) / sms * kper;
    if (best < 0 || cost < best) best = cost, *splits = n;
  }
  return 0;
}

// part[s] = (A^T B) over the K rows of split s (gemm_tn_kernel): A [K, M]
// row stride lda, B [K, N] row stride ldb, bf16, M, N, lda, ldb multiples
// of 8; kper = ceil(ceil(K / BK) / splits) k-steps a split, every split
// non-empty (tn_splits' plan); part [splits, M, N] f32.
inline int gemm_tn(const bf16* A, long long lda, const bf16* B, long long ldb,
                   float* part, int M, int N, int K, int splits,
                   cudaStream_t st) {
  static_assert(BK == 64, "the MN-major boxes are BK rows of 64 values");
  const int ktiles = (K + BK - 1) / BK;
  const int kper = (ktiles + splits - 1) / splits;
  if (splits < 1 || (long long)(splits - 1) * kper >= ktiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, A, K, M, lda, BK) ||
      !tensor_map(&map_b, B, K, N, ldb, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  PTT_TRY(sm_count(&sms));
  const int units = (M + BM - 1) / BM * ((N + BN - 1) / BN) * splits;
  gemm_tn_kernel<<<units < sms ? units : sms, THREADS, SMEM_BYTES, st>>>(
      map_a, map_b, part, M, N, K, splits, kper);
  return (int)cudaGetLastError();
}

}  // namespace ptt_wgmma
