// Bucketed top-2 candidate stage of the exact cosine search, over a bf16
// or an int8 gallery, and of the Poincaré search over an int8 ball
// gallery.
//
// Replaces the TPU kernels patent_tpu/ops/topk_kernel.py::_bucket_topk_kernel
// (via _bucket_topk_call and _fold_scores; public entries bucket_topk_bf16
// and bucket_topk_int8) and ::_bucket_topk_poincare_kernel (via
// _bucket_topk_poincare_call; public entry bucket_topk_poincare).  Gallery
// column j falls in bucket j mod L (L = 1024).  For every (query, bucket)
// the kernel keeps the best two (score, column) pairs.  bf16: scores are
// bf16 query x bf16 gallery dot products accumulated in f32; rows with
// valid == 0 score -inf.  int8: scores are f32(int8 query . int8 gallery
// row) * the row's scale (int32 accumulation, exact), -inf where the scale
// is <= 0; the query's own scale is one positive factor per row and is
// applied by the caller.  Poincaré: the monotone surrogate of -distance,
// s = qs * (f32(acc) * gw2) - q_sq * w - b, with the query's scale qs and
// squared norm q_sq and the row's gw2, w and b, -inf where w <= 0; the
// term q_sq * w mixes query and row, so the whole surrogate is scored here
// in the TPU kernel's operation order, with __fmul_rn / __fsub_rn so that
// no FMA is contracted and the answer equals the plain version's exactly.
// The caller picks the top `pool` of the 2L candidates and re-ranks them
// exactly.
//
// One difference from the TPU kernel, by design: there the grid walks the
// gallery in order, 2048 rows a step, and each step keeps only ONE winner
// per bucket before merging into the running top-2 (topk_kernel.py
// _fold_scores), so for n > 2L its guaranteed capacity is L candidates.
// Here every (query, bucket) keeps the exact top-2 over the whole gallery,
// so the capacity is min(n, 2L) at every n.
//
// What bounds it on the H100: at 1M x 512 the gallery is 1 GB of bf16 and
// Q = 256 queries make 0.27 TFLOP, so one pass over the gallery sits at
// the balance point of bandwidth (~0.3 ms at 3.35 TB/s) and the bf16
// tensor-core rate (~0.27 ms).  The int8 gallery is half the bytes (~0.15
// ms) at twice the tensor-core rate (~0.14 ms): still at the balance
// point.  So the kernel must read the gallery from device memory once and
// keep the tensor cores fed while it streams.  The Poincaré gallery at 1M
// x 128 is 128 MB of int8 plus 12 MB of row terms (~0.04 ms), against
// 0.07 TOP (~0.03 ms).
//
// Design of the cosine stage (bucket_top2_wg):
//   * a block owns 64 buckets and a tile of up to 128 queries; step t
//     brings the gallery rows t*L + b0 .. t*L + b0 + 63 of its buckets,
//     which are consecutive, as 128-byte K-slices into a ring of stages on
//     mbarriers, one producer thread keeping the ring full.  A stage is up
//     to four K-slices brought by ONE TMA request: the tensor map sees
//     the gallery as [slices][rows][128 bytes] (a third dimension of
//     stride 128 bytes), so the box lands slice after slice as the wgmma
//     descriptors read it.  Many one-slice requests, not the ring's depth
//     or device memory, held an SM's intake of the slices far below the
//     memory rate;
//   * the query tile is loaded once by TMA and held in shared memory for
//     the whole walk; two consumer warpgroups of NW queries each (8, 16,
//     32 or 64: the narrowest that takes Q, so one query and 16 run no
//     wider than they need) run wgmma m64nNk16 (bf16, f32 sums) or
//     m64nNk32 (int8, int32 sums) with the gallery slice as A (one row a
//     bucket) and their queries as B;
//   * the fold runs on the accumulator fragment: each element is one
//     (bucket, query) pair of the step and the same thread holds it at
//     every step, so the thread keeps the pair's v1, v2 and the two
//     winning steps (16 bits each, relative to its range, in one register)
//     in registers across the walk, with a strict '>' so that ties keep
//     the earlier column.  Branch-free: v2 = max(v2, min(v1, v)), v1 =
//     max(v1, v) and two selects for the steps.  The sums are copied once a
//     step and the copy is folded while the next step's first two stages
//     run on the tensor cores (a fold reading the sums themselves makes
//     ptxas serialize the wgmma).  No shared-memory round trip and no
//     block barrier beyond the ring's;
//   * at m64n64 a consumer thread holds 32 sums, their copy and 96
//     registers of top-2 state (setmaxnreg: 232 for the consumers, 40 for
//     the producer); m64n128 would need twice that and overflow;
//   * past 128 queries the query tiles of a bucket group are neighbours in
//     the grid, so the later tiles read the group's slices from L2 and
//     the gallery leaves device memory about once.  Clusters of two CTAs
//     with each slice multicast by TMA were measured slower: the
//     handshake that hands each stage back across the cluster cost more
//     than the L2 reads it saves (PERF.md §6);
//   * the steps are split into `splits` contiguous ranges to fill the
//     card (the plan below); a second kernel merges the per-split top-2
//     lists in (score desc, column asc) order, which gives exactly the
//     sequential answer.  Nothing carries between blocks.
// The Poincaré stage (bucket_top2_poincare_partial) keeps its earlier
// design: 32 buckets x 64 queries a block, cp.async loads of 32 rows a
// step, mma.sync m16n8k32 s8, the scores staged in shared memory for the
// fold, the same split ranges by stride and the same merge.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma_gemm.cuh"

using ptt::bf16;
namespace wg = ptt_wgmma;

namespace {

// ---------------------------------------------------------------- cosine

constexpr int CB = 64;               // buckets a block: wgmma's M
constexpr int SLICE = 128;           // bytes of K a slice: one swizzle row
constexpr uint32_t SLICE_BYTES = CB * SLICE;   // one K-slice of a block
constexpr int MAX_SLICES = 24;       // slices the ring holds at most
constexpr int MAX_SPB = 4;           // slices a stage (one TMA request)
// a consumer warpgroup holds up to two stages it has not handed back
// (two stages' products in flight), so the ring needs a third
constexpr int MIN_STAGES = 3;
constexpr int WG_THREADS = 384;    // the producer and two consumers
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on Hopper
constexpr int MAX_STEPS = 65536;     // steps a split: 16 bits of step number

// The shape of one call: two consumer warpgroups of NW queries, so nq =
// 2 NW queries a block; ks K-slices a row, spb of them a stage (one TMA
// request); `stages` of the ring; `tiles` query tiles, the grid's x.
struct Plan {
  int nw, nq, ks, spb, stages, tiles;
  size_t smem;
};

// the block's shared memory: alignment slack, the query tile, the ring,
// then the full, empty and query barriers
__host__ __device__ constexpr size_t plan_smem(int nq, int ks, int stages,
                                               int spb) {
  return 1024 + (size_t)ks * nq * SLICE +
         (size_t)stages * spb * SLICE_BYTES +
         (2 * stages + 1) * sizeof(uint64_t);
}

// Q queries of D values of `elem` bytes: the narrowest warpgroup width
// that takes Q in one tile, narrower while the query tile leaves no room
// for MIN_STAGES stages.  False when even 8 queries a warpgroup leave
// none.
inline bool make_plan(int Q, int D, int elem, Plan* p) {
  p->ks = (D * elem + SLICE - 1) / SLICE;
  p->nw = Q <= 16 ? 8 : Q <= 32 ? 16 : Q <= 64 ? 32 : 64;
  while (p->nw > 8 && plan_smem(2 * p->nw, p->ks, MIN_STAGES, 1) > SMEM_MAX)
    p->nw /= 2;
  p->nq = 2 * p->nw;
  if (plan_smem(p->nq, p->ks, MIN_STAGES, 1) > SMEM_MAX) return false;
  // the most slices a TMA request that divide a row (whose bytes fill
  // whole slices) and leave MIN_STAGES stages
  p->spb = 1;
  for (int s = MAX_SPB; s > 1 && D * elem % SLICE == 0; s /= 2)
    if (p->ks % s == 0 && plan_smem(p->nq, p->ks, MIN_STAGES, s) <= SMEM_MAX) {
      p->spb = s;
      break;
    }
  const size_t base = plan_smem(p->nq, p->ks, 0, p->spb);
  p->stages = (int)((SMEM_MAX - base) / (p->spb * SLICE_BYTES + 16));
  if (p->stages * p->spb > MAX_SLICES) p->stages = MAX_SLICES / p->spb;
  p->smem = plan_smem(p->nq, p->ks, p->stages, p->spb);
  p->tiles = (Q + p->nq - 1) / p->nq;
  return true;
}

// a box of the 3-D tensor map at (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The accumulator fragment of wgmma m64nN: lane l of warp w (of the
// warpgroup) holds d[4i + e] at row 16w + l/4 + 8(e/2), column 8i +
// 2(l%4) + e%2, for i < N/8.
#define PTT_A4(C, d, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define PTT_A8(C, d, i) PTT_A4(C, d, i), PTT_A4(C, d, i + 4)
#define PTT_A16(C, d, i) PTT_A8(C, d, i), PTT_A8(C, d, i + 8)
#define PTT_A32(C, d, i) PTT_A16(C, d, i), PTT_A16(C, d, i + 16)
#define PTT_R4 "{%0, %1, %2, %3}"
#define PTT_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define PTT_R16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define PTT_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
// d (+)= A . B^T, A [64 x K-step] and B [N x K-step] K-major from shared
// memory; R the register list, DA, DB and SC the operands' numbers
#define PTT_WGMMA(INSTR, TAIL, R, DA, DB, SC, ...)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n" INSTR " " R \
               ", " DA ", " DB ", p" TAIL ";\n}\n"                         \
               : __VA_ARGS__                                               \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
using Acc = std::conditional_t<sizeof(T) == 1, int, float>;

// one K-step of 32 bytes: k16 of bf16 or k32 of int8, at N = NW
template <typename T, int NW>
__device__ __forceinline__ void wgmma_step(Acc<T>* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (sizeof(T) == 2) {
#define PTT_BF(N) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16"
    if constexpr (NW == 8)
      PTT_WGMMA(PTT_BF(8), ", 1, 1, 0, 0", PTT_R4, "%4", "%5", "%6",
                PTT_A4("+f", d, 0));
    else if constexpr (NW == 16)
      PTT_WGMMA(PTT_BF(16), ", 1, 1, 0, 0", PTT_R8, "%8", "%9", "%10",
                PTT_A8("+f", d, 0));
    else if constexpr (NW == 32)
      PTT_WGMMA(PTT_BF(32), ", 1, 1, 0, 0", PTT_R16, "%16", "%17", "%18",
                PTT_A16("+f", d, 0));
    else
      PTT_WGMMA(PTT_BF(64), ", 1, 1, 0, 0", PTT_R32, "%32", "%33", "%34",
                PTT_A32("+f", d, 0));
#undef PTT_BF
  } else {
#define PTT_S8(N) "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8"
    if constexpr (NW == 8)
      PTT_WGMMA(PTT_S8(8), "", PTT_R4, "%4", "%5", "%6", PTT_A4("+r", d, 0));
    else if constexpr (NW == 16)
      PTT_WGMMA(PTT_S8(16), "", PTT_R8, "%8", "%9", "%10",
                PTT_A8("+r", d, 0));
    else if constexpr (NW == 32)
      PTT_WGMMA(PTT_S8(32), "", PTT_R16, "%16", "%17", "%18",
                PTT_A16("+r", d, 0));
    else
      PTT_WGMMA(PTT_S8(64), "", PTT_R32, "%32", "%33", "%34",
                PTT_A32("+r", d, 0));
#undef PTT_S8
  }
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
template <int N, typename A>
__device__ __forceinline__ void fence_regs(A* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<A, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// bf16: the row's 0/1 mask; int8: its scale; 0 past the gallery's end
__device__ __forceinline__ float row_term(const float* __restrict__ valid,
                                          long long row, int N) {
  return row < N ? __ldg(valid + row) : 0.0f;
}

// T = bf16 (valid the 0/1 row mask) or int8_t (valid the row scales).
// Grid (query tiles, L / CB bucket groups, splits), WG_THREADS threads:
// warpgroup 0 the producer, 1 and 2 the consumers of NW queries each.
// The query tiles of a bucket group are neighbours in the grid, so all but
// the first read the group's slices from L2.  The split z walks steps
// [z T / splits, (z + 1) T / splits) and writes its lists at z of pv1 ..
// pi2 [splits, Q, L].
template <typename T, int NW>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bucket_top2_wg(const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const float* __restrict__ valid, int Q, int N, int L,
                   int T_steps, int splits, int stages, int ks, int spb,
                   float* __restrict__ pv1, int* __restrict__ pi1,
                   float* __restrict__ pv2, int* __restrict__ pi2) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int NQ = 2 * NW;               // queries a block
  constexpr int NA = NW / 2;               // pairs (sums) a thread
  constexpr int ELEMS = SLICE / (int)sizeof(T);   // values a K-slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qtile = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = qtile + (size_t)ks * NQ * SLICE;
  const uint32_t stage_bytes = spb * SLICE_BYTES;
  const int kst = ks / spb;                // stages a step
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               (size_t)stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q0 = blockIdx.x * NQ, b0 = blockIdx.y * CB, z = blockIdx.z;
  const int t0 = (int)((long long)z * T_steps / splits);
  const int t1 = (int)((long long)(z + 1) * T_steps / splits);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);   // one arrival from each consumer
    }
    wg::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // this CTA's query tile, once; rows past Q read as zeros
      wg::mbar_expect_tx(qbar, (uint32_t)(ks * NQ * SLICE));
      for (int k = 0; k < ks; ++k)
        wg::tma_load(qtile + (size_t)k * NQ * SLICE, &qmap, qbar, k * ELEMS,
                     q0);
      // the gallery slices, rows past N read as zeros
      const uint32_t uses = (uint32_t)(t1 - t0) * kst;
      for (uint32_t u = 0; u < uses; ++u) {
        const int s = u % stages;
        if (u >= (uint32_t)stages)
          wg::mbar_wait(&empty[s], (u / stages - 1) & 1);
        const int t = t0 + (int)(u / kst), k = (int)(u % kst) * spb;
        unsigned char* dst = ring + (size_t)s * stage_bytes;
        wg::mbar_expect_tx(&full[s], stage_bytes);
        if (spb == 1)
          wg::tma_load(dst, &gmap, &full[s], k * ELEMS, t * L + b0);
        else
          tma_load_3d(dst, &gmap, &full[s], 0, t * L + b0, k);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wgi - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = warp * 16 + lane / 4;   // rows r_lo, r_lo + 8
    const long long row_lo = (long long)b0 + r_lo;
    // the sums of the step being multiplied, and a copy of the previous
    // step's, which the fold reads while the next products run (a fold
    // reading the sums themselves would serialize the wgmma)
    Acc<T> acc[NA], snap[NA];
    float term[2], snap_term[2];   // rows r_lo, r_lo + 8's terms
    float v1[NA], v2[NA];
    uint32_t steps[NA];   // winning steps of v1 (low half), v2 (high half)
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      v1[j] = -INFINITY;
      v2[j] = -INFINITY;
      steps[j] = 0;
    }
    // stages go back in order, once this warpgroup's wgmma have read them
    uint32_t freed = 0;
    auto free_upto = [&](uint32_t upto) {
      for (; freed < upto; ++freed)
        if (tid == 0) wg::mbar_arrive(&empty[freed % stages]);
    };
    // the fold of the copied step t0 + rel into the running top-2: a strict
    // '>' keeps the earlier of two equal columns; branch-free, v2 = max(v2,
    // min(v1, v)) and v1 = max(v1, v) are the insertion's values
    auto fold = [&](uint32_t rel) {
      float add[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        add[h] = snap_term[h] > 0.0f ? 0.0f : -INFINITY;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int h = (j >> 1) & 1;
        float v;
        if constexpr (INT8)
          v = __fadd_rn(__fmul_rn(__int2float_rn(snap[j]), snap_term[h]),
                        add[h]);
        else
          v = __fadd_rn(snap[j], add[h]);
        const bool p1 = v > v1[j], p2 = v > v2[j];
        const uint32_t s1 = (steps[j] << 16) | rel;
        const uint32_t s2 = (steps[j] & 0xFFFFu) | (rel << 16);
        steps[j] = p1 ? s1 : (p2 ? s2 : steps[j]);
        v2[j] = fmaxf(v2[j], fminf(v1[j], v));
        v1[j] = fmaxf(v1[j], v);
      }
    };
    const unsigned char* qw = qtile + (size_t)c * NW * SLICE;
    const int kf = kst > 1 ? 1 : 0;   // the stage after which the fold runs
    wg::mbar_wait(qbar, 0);
    uint32_t u = 0;
    for (int t = t0; t < t1; ++t) {
      const long long r = (long long)t * L + row_lo;
      term[0] = row_term(valid, r, N);      // read at the step's fold
      term[1] = row_term(valid, r + 8, N);
      for (int k = 0; k < kst; ++k, ++u) {
        const int s = u % stages;
        wg::mbar_wait(&full[s], (u / stages) & 1);
        fence_regs<NA>(acc);
        wg::wgmma_fence();
        for (int i = 0; i < spb; ++i) {
          const uint64_t da = wg::desc_k_sw128(ring + (size_t)s * stage_bytes +
                                               (size_t)i * SLICE_BYTES);
          const uint64_t db =
              wg::desc_k_sw128(qw + (size_t)(k * spb + i) * NQ * SLICE);
#pragma unroll
          for (int kk = 0; kk < SLICE / 32; ++kk)
            wgmma_step<T, NW>(acc, da + 2 * kk, db + 2 * kk,
                              k > 0 || i > 0 || kk > 0);
        }
        wg::wgmma_commit();
        fence_regs<NA>(acc);
        // the previous step's fold, with this step's first slices running
        if (k == kf && t > t0) fold((uint32_t)(t - 1 - t0));
        if (k > 0) {
          wg::wgmma_wait<1>();
          fence_regs<NA>(acc);
          free_upto(u);
        }
      }
      wg::wgmma_wait<0>();
      fence_regs<NA>(acc);
      free_upto(u);
#pragma unroll
      for (int j = 0; j < NA; ++j) snap[j] = acc[j];
      snap_term[0] = term[0];
      snap_term[1] = term[1];
    }
    if (t1 > t0) fold((uint32_t)(t1 - 1 - t0));
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int qr = q0 + c * NW + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
      const int b = b0 + r_lo + 8 * ((j >> 1) & 1);
      if (qr < Q) {
        const size_t o = ((size_t)z * Q + qr) * L + b;
        pv1[o] = v1[j];
        pi1[o] = v1[j] == -INFINITY
                     ? 0
                     : (t0 + (int)(steps[j] & 0xFFFFu)) * L + b;
        pv2[o] = v2[j];
        pi2[o] = v2[j] == -INFINITY ? 0 : (t0 + (int)(steps[j] >> 16)) * L + b;
      }
    }
  }
}

// a [rows, D] matrix of T read in boxes of one K-slice by box_rows rows
// with the 128-byte swizzle; out-of-bounds reads give 0
template <typename T>
bool slice_map(CUtensorMap* map, const void* p, long long rows, int D,
               int box_rows) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(SLICE / sizeof(T)),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a [rows, D] matrix of T (D * sizeof(T) a multiple of SLICE) seen as
// [D / ELEMS slices][rows][ELEMS] and read in boxes of spb slices by CB rows
// with the 128-byte swizzle: one request brings the K-slices of a stage,
// laid out slice after slice as the wgmma descriptors read them
template <typename T>
bool stage_map(CUtensorMap* map, const void* p, long long rows, int D,
               int spb) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  constexpr int ELEMS = SLICE / (int)sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)ELEMS, (cuuint64_t)rows,
                              (cuuint64_t)(D / ELEMS)};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)SLICE};
  const cuuint32_t box[3] = {(cuuint32_t)ELEMS, (cuuint32_t)CB,
                             (cuuint32_t)spb};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NW>
int launch_wg(const Plan& p, const CUtensorMap& gmap, const CUtensorMap& qmap,
              const float* valid, int Q, int N, int L, int splits, float* pv1,
              int* pi1, float* pv2, int* pi2, cudaStream_t st) {
  auto kernel = bucket_top2_wg<T, NW>;
  static bool ready[ptt::MAX_DEVICES] = {};   // the attribute, once a device
  int dev = 0;
  PTT_TRY(ptt::current_device(&dev));
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  kernel<<<dim3(p.tiles, L / CB, splits), WG_THREADS, p.smem, st>>>(
      gmap, qmap, valid, Q, N, L, (N + L - 1) / L, splits, p.stages, p.ks,
      p.spb, pv1, pi1, pv2, pi2);
  return (int)cudaGetLastError();
}

// The per-split lists of a cosine call (every instance of one T)
template <typename T>
int top2_wg(const Plan& p, const void* q, int Q, const void* gal,
            const float* valid, int N, int D, int L, int splits, float* pv1,
            int* pi1, float* pv2, int* pi2, cudaStream_t st) {
  CUtensorMap gmap, qmap;
  if (!(p.spb == 1 ? slice_map<T>(&gmap, gal, N, D, CB)
                    : stage_map<T>(&gmap, gal, N, D, p.spb)) ||
      !slice_map<T>(&qmap, q, Q, D, p.nq))
    return (int)cudaErrorInvalidValue;
  switch (p.nw) {
    case 8:
      return launch_wg<T, 8>(p, gmap, qmap, valid, Q, N, L, splits, pv1, pi1,
                             pv2, pi2, st);
    case 16:
      return launch_wg<T, 16>(p, gmap, qmap, valid, Q, N, L, splits, pv1,
                              pi1, pv2, pi2, st);
    case 32:
      return launch_wg<T, 32>(p, gmap, qmap, valid, Q, N, L, splits, pv1,
                              pi1, pv2, pi2, st);
    default:
      return launch_wg<T, 64>(p, gmap, qmap, valid, Q, N, L, splits, pv1,
                              pi1, pv2, pi2, st);
  }
}

// The split count of a cosine call on the current card: as many step
// ranges as let the blocks of one wave fill the SMs (one block an SM:
// the ring takes most of its shared memory), at most one a step, and
// enough that no range passes MAX_STEPS steps.
int wg_splits(const Plan& p, int N, int L, int* splits) {
  int sms = 0;
  PTT_TRY(wg::sm_count(&sms));
  const long long steps = (N + (long long)L - 1) / L;
  const long long blocks = (long long)p.tiles * (L / CB);
  long long n = sms / blocks;
  if (n > steps) n = steps;
  if (n < 1) n = 1;
  const long long least = (steps + MAX_STEPS - 1) / MAX_STEPS;
  *splits = (int)(n < least ? least : n);
  return 0;
}

// ---------------------------------------------------------------- Poincaré

constexpr int BQ = 64;       // queries per block
constexpr int BB = 32;       // buckets per block
constexpr int THREADS = 128; // 4 warps, 16 query rows each
constexpr int SC_LD = BB + 4;
constexpr int PAIRS = BQ * BB / THREADS;
// elements of padding per shared row: 16 bytes, which also keeps the
// int8 fragment loads free of bank conflicts
constexpr int ROW_PAD = 16;

size_t poincare_smem_bytes(int D) {
  const size_t ldd = D + ROW_PAD;
  return (BQ + BB) * ldd + BQ * SC_LD * sizeof(float) +
         (3 * BB + 2 * BQ) * sizeof(float);
}

// The Poincaré surrogate's terms: per query qs, q_sq; per row gw2, b (the
// row's w comes in as `w`)
struct PoincareTerms {
  const float* qs;
  const float* q_sq;
  const float* gw2;
  const float* b;
};

// scores are the Poincaré surrogate of `pt` over int8 operands (mma.sync
// s8), -inf where the row's w is <= 0
__global__ void __launch_bounds__(THREADS)
    bucket_top2_poincare_partial(const int8_t* __restrict__ q, int Q,
                                 const int8_t* __restrict__ gal,
                                 const float* __restrict__ w,
                                 PoincareTerms pt, int N, int D, int L,
                                 int T_steps, int splits,
                                 float* __restrict__ pv1,
                                 int* __restrict__ pi1,
                                 float* __restrict__ pv2,
                                 int* __restrict__ pi2) {
  constexpr int PER16 = 16;   // elements per 16 bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldd = D + ROW_PAD;
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Gs = Qs + (size_t)BQ * ldd;
  float* Sc = reinterpret_cast<float*>(Gs + (size_t)BB * ldd);
  float* Vf = Sc + BQ * SC_LD;
  float* Gw = Vf + BB;       // the rows' gw2 and b
  float* Bv = Gw + BB;
  float* Qsc = Bv + BB;      // the queries' qs and q_sq
  float* Qsq = Qsc + BQ;

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
  if (tid < BQ) {
    const bool in = q0 + tid < Q;
    Qsc[tid] = in ? pt.qs[q0 + tid] : 0.0f;
    Qsq[tid] = in ? pt.q_sq[q0 + tid] : 0.0f;
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
      Vf[tid] = in ? w[row] : 0.0f;
      Gw[tid] = in ? pt.gw2[row] : 0.0f;
      Bv[tid] = in ? pt.b[row] : 0.0f;
    }
    ptt::cp_async_wait<0>();
    __syncthreads();

    // each warp: its 16 query rows x the 32 buckets, four m16n8k32 tiles
    const int g = lane >> 2, tq = lane & 3;
    int acc[BB / 8][4];
#pragma unroll
    for (int j = 0; j < BB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    const int8_t* qa = Qs + warp * 16 * ldd;
    for (int kk = 0; kk < D; kk += 32) {
      uint32_t a[4], b[2];
      a[0] = ptt::ld32(qa + g * ldd + kk + tq * 4);
      a[1] = ptt::ld32(qa + (g + 8) * ldd + kk + tq * 4);
      a[2] = ptt::ld32(qa + g * ldd + kk + 16 + tq * 4);
      a[3] = ptt::ld32(qa + (g + 8) * ldd + kk + 16 + tq * 4);
#pragma unroll
      for (int j = 0; j < BB / 8; ++j) {
        b[0] = ptt::ld32(Gs + (j * 8 + g) * ldd + kk + tq * 4);
        b[1] = ptt::ld32(Gs + (j * 8 + g) * ldd + kk + 16 + tq * 4);
        ptt::mma_s8(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < BB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = warp * 16 + g + 8 * (e >> 1);
        const int bb = j * 8 + 2 * tq + (e & 1);
        const float a = __int2float_rn(acc[j][e]);
        // qs * (a * gw2) - q_sq * w - b
        Sc[qq * SC_LD + bb] = __fsub_rn(
            __fsub_rn(__fmul_rn(Qsc[qq], __fmul_rn(a, Gw[bb])),
                      __fmul_rn(Qsq[qq], Vf[bb])),
            Bv[bb]);
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

// ---------------------------------------------------------------- merge

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

int merge(const void* pv1, const void* pi1, const void* pv2, const void* pi2,
          int splits, int Q, int L, void* v1, void* i1, void* v2, void* i2,
          cudaStream_t st) {
  const int QL = Q * L;
  bucket_top2_merge<<<(QL + 255) / 256, 256, 0, st>>>(
      (const float*)pv1, (const int*)pi1, (const float*)pv2, (const int*)pi2,
      splits, QL, (float*)v1, (int*)i1, (float*)v2, (int*)i2);
  return (int)cudaGetLastError();
}

// A cosine call: the per-split lists, then their merge; one split writes
// the answer directly.
template <typename T>
int bucket_top2_cosine(const void* q, int Q, const void* gal,
                       const void* valid, int N, int D, int L, int splits,
                       void* pv1, void* pi1, void* pv2, void* pi2, void* v1,
                       void* i1, void* v2, void* i2, cudaStream_t st) {
  Plan p;
  if (Q < 1 || N < 1 || L % CB || splits < 1 ||
      !make_plan(Q, D, (int)sizeof(T), &p) ||
      (N + (long long)L - 1) / L > (long long)splits * MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    pv1 = v1;
    pi1 = i1;
    pv2 = v2;
    pi2 = i2;
  }
  PTT_TRY(top2_wg<T>(p, q, Q, gal, (const float*)valid, N, D, L, splits,
                     (float*)pv1, (int*)pi1, (float*)pv2, (int*)pi2, st));
  return splits == 1 ? 0
                     : merge(pv1, pi1, pv2, pi2, splits, Q, L, v1, i1, v2, i2,
                             st);
}

}  // namespace

extern "C" {

// The split count `ptt_bucket_top2` and `ptt_bucket_top2_i8` take for Q
// queries over N rows of D values (int8 != 0: int8 operands) into L
// buckets on the current card: the scratch pv1 .. pi2 is [splits, Q, L].
int ptt_bucket_top2_plan(int Q, int N, int D, int L, int int8, int* splits) {
  Plan p;
  if (Q < 1 || N < 1 || L < CB || !make_plan(Q, D, int8 ? 1 : 2, &p))
    return (int)cudaErrorInvalidValue;
  return wg_splits(p, N, L, splits);
}

// q [Q, D] bf16 (normalized), gal [N, D] bf16, valid [N] f32 -> v1, i1, v2,
// i2 [Q, L].  Scratch: pv1, pi1, pv2, pi2 [splits, Q, L] (unused at one
// split); splits from ptt_bucket_top2_plan.  D % 8 == 0, L % 64 == 0.
int ptt_bucket_top2(const void* q, int Q, const void* gal, const void* valid,
                    int N, int D, int L, int splits, void* pv1, void* pi1,
                    void* pv2, void* pi2, void* v1, void* i1, void* v2,
                    void* i2, void* stream) {
  return bucket_top2_cosine<bf16>(q, Q, gal, valid, N, D, L, splits, pv1, pi1,
                                  pv2, pi2, v1, i1, v2, i2,
                                  (cudaStream_t)stream);
}

// The int8 gallery: q [Q, D] int8, gal [N, D] int8, gal_scale [N] f32 ->
// v1, i1, v2, i2 [Q, L] on the f32(acc) * gal_scale scale (the query scale
// is applied by the caller).  D % 16 == 0, L % 64 == 0; splits and
// scratch as ptt_bucket_top2.
int ptt_bucket_top2_i8(const void* q, int Q, const void* gal,
                       const void* gal_scale, int N, int D, int L, int splits,
                       void* pv1, void* pi1, void* pv2, void* pi2, void* v1,
                       void* i1, void* v2, void* i2, void* stream) {
  return bucket_top2_cosine<int8_t>(q, Q, gal, gal_scale, N, D, L, splits,
                                    pv1, pi1, pv2, pi2, v1, i1, v2, i2,
                                    (cudaStream_t)stream);
}

// The Poincaré gallery: q [Q, D] int8 with qs, q_sq [Q] f32; gal [N, D]
// int8 with gw2, w, b [N] f32 (prepare_poincare_gallery) -> v1, i1, v2, i2
// [Q, L] on the surrogate's scale.  Scratch pv1 .. pi2 [splits, Q, L].
// D % 32 == 0, L % 32 == 0.
int ptt_bucket_top2_poincare(const void* q, const void* qs, const void* q_sq,
                             int Q, const void* gal, const void* gw2,
                             const void* w, const void* b, int N, int D,
                             int L, int splits, void* pv1, void* pi1,
                             void* pv2, void* pi2, void* v1, void* i1,
                             void* v2, void* i2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PoincareTerms pt{(const float*)qs, (const float*)q_sq,
                         (const float*)gw2, (const float*)b};
  const size_t smem = poincare_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_top2_poincare_partial,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / BB, (Q + BQ - 1) / BQ, splits);
  bucket_top2_poincare_partial<<<grid, THREADS, smem, st>>>(
      (const int8_t*)q, Q, (const int8_t*)gal, (const float*)w, pt, N, D, L,
      (N + L - 1) / L, splits, (float*)pv1, (int*)pi1, (float*)pv2,
      (int*)pi2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge(pv1, pi1, pv2, pi2, splits, Q, L, v1, i1, v2, i2, st);
}

}  // extern "C"
