// The int8 GEMM for Hopper, with the int8 serving layer's fused epilogues:
//
//   C[M, N] = epi(f32(A[M, K] . Bt[N, K]^T) * rs[row * rs_stride] * cs[col]
//                 + bias[col])
//
// int8 operands, int32 accumulation, shared by the int8 layer kernels
// (csrc/int8_layer.cu: the attention sub-layer, row 5, its CLS variant,
// row 6, the MLP sub-layer, row 7, the whole layer, rows 8 and 9, and the
// standalone dense layer and MLP, rows 10 and 11, whose output width may
// be odd).
// A may be a strided view (row stride lda, a valid TMA stride) with its
// row scales at the same stride: row 6's CLS q product reads row 0 of
// every image, every S-th row of the LN1 codes and of their scales.  Both operands are K-major,
// as the tensor cores take int8: A is the row-quantized activations [M, K]
// and Bt the weights held [out, in] from load time.  The TMA, mbarrier and
// wgmma helpers are csrc/wgmma_gemm.cuh's (the bf16 GEMM); the 128-byte
// swizzle that holds 64 bf16 there holds 128 int8 values of K here, so the
// descriptors are the same in bytes.
//
// The integer products are exact (K * 127^2 < 2^31), so the output bits
// do not depend on the tile shape, the MMA instruction or how K is split.
// The epilogue runs on the int32 accumulators: __int2float_rn(acc), times
// the row scale, times the column scale, plus the bias, in __fmul_rn /
// __fadd_rn order (no fused multiply-add), then the exp2 quick_gelu or
// the residual (bf16 or f32), stored bf16 or f32 (the fast form's quick_gelu
// multiplies by ptt::recip_bf16 of its denominator); or, split over K, the
// int32 partial sums of one k-range are stored for a later pass to add in
// a fixed order (exact, deterministic) and finish with the same epilogue.
// The AMAX instance (MLP in of row 7) also takes each output row's max |v|
// over the tile, across the four lanes that hold the row, and merges it
// into a [M] f32 buffer with atomicMax on the bits (a max of non-negative
// floats, exact in any order), so that the hidden's row quantization
// needs no pass of its own for the maximum.
//
// What bounds it on the H100: at the int8 tower's batch of 128 (M = 26,624,
// K 768 or 3072, N 768 to 3072) a product does 2*M*N*K operations on
// about M*K + N*K + 2*M*N bytes, ~600-1,000 operations per byte, above the
// card's ~590 for int8: the tensor cores.  At a query's batch (M = 208 to
// 624) the weights dominate (7.1 MB a layer) and the tiles are few, so
// the latency of each k-step and the width of the grid set the time.
// Design:
//   * 128 x 128 output tiles of one block of two warpgroups, 64 rows each,
//     running wgmma.mma_async m64n128k32 s8 from shared memory, K in steps
//     of 128 (one swizzle row);
//   * one thread issues the TMA loads of both operands into a ring of
//     stages on mbarriers, as many steps ahead of the warpgroups and
//     across the boundaries between a block's tiles, so the next tile's
//     loads are in flight during this tile's epilogue; a stage is handed
//     back by a block barrier once both warpgroups' wgmma have read it;
//   * the standalone GEMM: three stages, two blocks an SM (98 KB of shared
//     memory each), so that one block's epilogue overlaps the other's
//     products; the whole layer's cooperative kernel: four, one block an
//     SM (csrc/int8_layer.cu);
//   * a unit of work is one output tile and one k-range of it; the
//     standalone GEMM takes one k-range a tile, the whole layer's narrow
//     phases several (split-K) when M is small.
// Not yet: warp specialisation with setmaxnreg, clusters with the weight
// tile multicast, 256-wide tiles at large M.
#pragma once

#include "wgmma_gemm.cuh"

namespace ptt_s8 {

using ptt::bf16;
namespace wg = ptt_wgmma;

constexpr int BM = 128, BN = 128;
constexpr int BK = 128;                  // int8 values: one 128-byte row
constexpr int STAGES = 3;                // the standalone GEMM's ring
constexpr int THREADS = 256;             // two warpgroups
constexpr int TILE_BYTES = BM * BK;      // the A tile; the Bt tile too
constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
static_assert(BM == BN, "the A and Bt tiles share one box height");

// a ring of `stages` stages, 1024-byte aligned for the swizzle, then its
// barriers
__host__ __device__ constexpr size_t ring_bytes(int stages) {
  return stages * (size_t)STAGE_BYTES;
}
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return 1024 + ring_bytes(stages) + stages * sizeof(uint64_t);
}

enum Epi {
  EPI_BIAS = 0,   // v                                  (QKV)
  EPI_GELU = 1,   // v / (1 + exp2(-1.702 log2(e) v))    (MLP in)
  EPI_RES = 2,    // res + v                            (out-projection, MLP out)
  EPI_PART = 3,   // the int32 sums of the unit's k-range, unscaled
  EPI_GELU_FAST = 4,  // v * recip(1 + exp2(...)), the fast form's MLP in
};

// the MLP in's epilogue of the form FAST (csrc/int8_layer.cu)
__host__ __device__ constexpr int gelu_epi(bool fast) {
  return fast ? EPI_GELU_FAST : EPI_GELU;
}

// v = f32(acc) * rsc * csc + bias, then EPI's step (the residual read from
// *res); the TPU kernels' order, each operation rounded on its own
template <int EPI, typename ResT>
__device__ __forceinline__ float epi_value(int acc, float rsc, float csc,
                                           float bias, const ResT* res) {
  float v = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rsc), csc),
                      bias);
  if constexpr (EPI == EPI_GELU)
    v = __fdiv_rn(v, __fadd_rn(1.0f, exp2f(__fmul_rn(wg::NEG_1702_LOG2E, v))));
  if constexpr (EPI == EPI_GELU_FAST)
    v = __fmul_rn(v, ptt::recip_bf16(__fadd_rn(
                         1.0f, exp2f(__fmul_rn(wg::NEG_1702_LOG2E, v)))));
  if constexpr (EPI == EPI_RES) v = __fadd_rn(ptt::to_f(*res), v);
  return v;
}

// One GEMM: what its epilogue reads and writes.  C is OutT [M, ldc], or
// for EPI_PART int32 [splits, M, ldc], one slice per k-range.
struct Gemm {
  const float* rs;      // [M] row scales
  const float* cs;      // [N] column scales
  const float* bias;    // [N]
  const void* res;      // [M, ldr] (EPI_RES)
  long long ldr;
  void* C;
  long long ldc;
  int M, N, K;
  int splits;           // k-ranges a tile, 1 <= splits <= ceil(K / BK)
  float* amax = nullptr;   // [M] max |C| of each row, zeroed (AMAX)
  int rs_stride = 1;       // row r's scale is rs[r * rs_stride]
};

// The units of a GEMM: unit u is k-range u % splits of tile u / splits;
// the tiles run down M first, so blocks that start together share the
// weight tile.  k-range s of `ksteps` steps is [s*ksteps/splits,
// (s+1)*ksteps/splits): every step of a tile lies in exactly one range.
struct Units {
  int tiles_m, ksteps, splits, count;

  __device__ __forceinline__ explicit Units(const Gemm& g)
      : tiles_m((g.M + BM - 1) / BM), ksteps((g.K + BK - 1) / BK),
        splits(g.splits < 1 ? 1 : g.splits),
        count(tiles_m * ((g.N + BN - 1) / BN) * splits) {}

  __device__ __forceinline__ void at(int u, int& m0, int& n0, int& kb,
                                     int& ke, int& s) const {
    const int t = u / splits;
    s = u % splits;
    m0 = t % tiles_m * BM;
    n0 = t / tiles_m * BN;
    kb = s * ksteps / splits;
    ke = (s + 1) * ksteps / splits;
  }
};

// A block's ring of stages and the k-steps it has consumed so far (every
// thread counts them; the count picks the stage and the barrier parity,
// and carries over from one GEMM to the next in a persistent kernel).
struct Ring {
  unsigned char* tiles;
  uint64_t* full;
  int stages;
  uint32_t it;
};

// Every thread of the block calls it once, at the kernel's start; smem_raw
// holds smem_bytes(stages).
__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw,
                                          int stages) {
  Ring r;
  r.tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  r.full = reinterpret_cast<uint64_t*>(r.tiles + ring_bytes(stages));
  r.stages = stages;
  r.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) wg::mbar_init(&r.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 32] . Bt[128 x 32]^T, int8 from shared memory,
// int32 sums.  Lane l of warp w (of the warpgroup) holds, for i = 0..15,
// d[4i + e] at row 16w + l/4 + 8(e/2), column 8i + 2(l%4) + e%2.
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The units u0, u0 + du, ... of GEMM g, by every thread of the block
// (THREADS), A and Bt read through the tensor maps.  On return the ring
// is empty and every thread of the block has passed a block barrier since
// its last read of shared memory.  AMAX: also merge each row's max |C|
// into g.amax.  TAIL: any N (rows 10 and 11), an odd N's last
// column and the columns of rows of an odd width stored one at a time;
// else N % 8 == 0, every column stored in pairs.
template <int EPI, typename OutT, typename ResT, bool AMAX = false,
          bool TAIL = false>
__device__ void gemm_units(const CUtensorMap* map_a, const CUtensorMap* map_b,
                           const Gemm& g, int u0, int du, Ring& ring) {
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const Units un(g);

  // the loader's cursor (thread 0): k-step lk of [lk, lke) of unit lu
  int lu = u0, lm = 0, ln = 0, lk = 0, lke = 0, ls = 0;
  uint32_t ld = ring.it;
  if (lu < un.count) un.at(lu, lm, ln, lk, lke, ls);
  auto issue = [&]() {
    if (lu >= un.count) return;
    const int st = ld++ % ring.stages;
    unsigned char* a = ring.tiles + st * STAGE_BYTES;
    wg::mbar_expect_tx(&ring.full[st], STAGE_BYTES);
    wg::tma_load(a, map_a, &ring.full[st], lk * BK, lm);
    wg::tma_load(a + TILE_BYTES, map_b, &ring.full[st], lk * BK, ln);
    if (++lk == lke && (lu += du) < un.count) un.at(lu, lm, ln, lk, lke, ls);
  };
  // an earlier phase's generic reads and writes of this shared memory come
  // before TMA's writes to it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < ring.stages; ++i) issue();

  int d[64];
  for (int u = u0; u < un.count; u += du) {
    int m0, n0, kb, ke, s;
    un.at(u, m0, n0, kb, ke, s);
    for (int kt = kb; kt < ke; ++kt) {
      const uint32_t c = ring.it++;
      const int st = c % ring.stages;
      wg::mbar_wait(&ring.full[st], (c / ring.stages) & 1);
      const unsigned char* a = ring.tiles + st * STAGE_BYTES;
      const uint64_t da = wg::desc_k_sw128(a + wgi * 64 * BK);
      const uint64_t db = wg::desc_k_sw128(a + TILE_BYTES);
      fence_acc(d);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_m64n128k32(d, da + 2 * kk, db + 2 * kk, kt > kb || kk > 0);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      fence_acc(d);
      __syncthreads();            // both warpgroups are done with stage st
      if (tid == 0) issue();      // which takes the step `stages` ahead
    }

    const int r0 = m0 + wgi * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      [[maybe_unused]] float vmax = 0.0f;   // AMAX: this lane's max |v|
      if (row < g.M) {
        float rsc = 0.0f;
        if constexpr (EPI != EPI_PART) rsc = g.rs[(size_t)row * g.rs_stride];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * (lane & 3);
          if (col >= g.N) continue;    // !TAIL: N % 8 == 0, col + 1 < N too
          const int a0 = d[4 * i + 2 * h], a1 = d[4 * i + 2 * h + 1];
          if constexpr (EPI == EPI_PART) {
            int* cp = static_cast<int*>(g.C) +
                      ((size_t)s * g.M + row) * g.ldc + col;
            *reinterpret_cast<int2*>(cp) = make_int2(a0, a1);
          } else {
            const ResT* rp =
                static_cast<const ResT*>(g.res) + (size_t)row * g.ldr + col;
            OutT* cp = static_cast<OutT*>(g.C) + (size_t)row * g.ldc + col;
            const float v0 = epi_value<EPI, ResT>(a0, rsc, g.cs[col],
                                                  g.bias[col], rp);
            if constexpr (TAIL) {
              if (col + 1 == g.N) {    // an odd N's last column, alone
                ptt::store_f(cp, v0);
                if constexpr (AMAX) vmax = fmaxf(vmax, fabsf(v0));
                continue;
              }
            }
            const float v1 = epi_value<EPI, ResT>(
                a1, rsc, g.cs[col + 1], g.bias[col + 1], rp + 1);
            if (TAIL && (g.ldc & 1)) {   // rows of an odd width: unaligned
              ptt::store_f(cp, v0);
              ptt::store_f(cp + 1, v1);
            } else {
              ptt::store2(cp, v0, v1);
            }
            if constexpr (AMAX)
              vmax = fmaxf(vmax, fmaxf(fabsf(v0), fabsf(v1)));
          }
        }
      }
      if constexpr (AMAX) {
        // the row's four lanes (every lane of the warp takes part)
        vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 1));
        vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 2));
        if (row < g.M && (lane & 3) == 0)
          atomicMax(reinterpret_cast<int*>(g.amax) + row,
                    __float_as_int(vmax));
      }
    }
  }
}

template <int EPI, typename OutT, typename ResT, bool AMAX, bool TAIL>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Gemm g) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw, STAGES);
  gemm_units<EPI, OutT, ResT, AMAX, TAIL>(&map_a, &map_b, g, blockIdx.x,
                                          gridDim.x, ring);
}

// an int8 [rows, cols] matrix with row stride ld (bytes), read in boxes of
// BK x box_rows with the 128-byte swizzle; out-of-bounds reads give 0
inline bool tensor_map(CUtensorMap* map, const int8_t* p, long long rows,
                       long long cols, long long ld, int box_rows) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)p, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current card's SM count, asked once a device
inline int sm_count(int* sms) {
  static int n[ptt::MAX_DEVICES] = {};
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (n[dev] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = n[dev];
  return 0;
}

// C = epi(...) of g, A [M, K] with row stride lda and Bt [N, K] with ldb
// (bytes); K, N, lda, ldb, ldr, ldc multiples of 16 (TAIL: any N, ldr and
// ldc) and A, Bt 16-byte aligned (the tensor-map encode rejects a
// misaligned A or Bt, and the wrapper raises).  A persistent grid of up to two
// blocks an SM walks the units.  AMAX (f32 C only): also each row's max
// |C| into g.amax, which the caller has zeroed.  Returns a CUDA error
// code, 0 on success.
template <int EPI, typename OutT, typename ResT, bool AMAX = false,
          bool TAIL = false>
int gemm(const int8_t* A, long long lda, const int8_t* Bt, long long ldb,
         const Gemm& g, cudaStream_t st) {
  static_assert(!AMAX || (EPI != EPI_PART && sizeof(OutT) == 4),
                "the row maxima are of an f32 output's values");
  static_assert(!TAIL || EPI != EPI_PART, "split-K sums take N % 8 == 0");
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, A, g.M, g.K, lda, BM) ||
      !tensor_map(&map_b, Bt, g.N, g.K, ldb, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_kernel<EPI, OutT, ResT, AMAX, TAIL>;
  // the attribute, once an instance and device
  static bool ready[ptt::MAX_DEVICES] = {};
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(STAGES));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  int sms = 0;
  PTT_TRY(sm_count(&sms));
  const int units = ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) *
                    (g.splits < 1 ? 1 : g.splits);
  kernel<<<units < 2 * sms ? units : 2 * sms, THREADS, smem_bytes(STAGES),
           st>>>(
      map_a, map_b, g);
  return (int)cudaGetLastError();
}

}  // namespace ptt_s8
