// Bucketed top-2 candidate stage of the exact cosine search, over a bf16
// or an int8 gallery, and of the Poincaré search over an int8 ball
// gallery: one kernel template, three operand modes.
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
// 0.07 TOP (~0.03 ms); but its fold forms the surrogate from each of the
// 268M (bucket, query) sums of Q 256 with five f32 operations more than
// the int8 cosine fold, so the consumers' instruction rate, not the bytes
// or the tensor cores, bounds it.
//
// Design (bucket_top2_wg):
//   * a block owns 64 buckets and a tile of up to 128 queries; step t
//     brings the gallery rows t*L + b0 .. t*L + b0 + 63 of its buckets,
//     which are consecutive, as 128-byte K-slices into a ring of stages on
//     mbarriers, one producer thread keeping the ring full.  One TMA
//     request fills a stage, of up to four slices (32 KB), because many
//     small requests, not the ring's depth or device memory, held an SM's
//     intake far below the memory rate.  Where a row fills whole slices
//     (D 512 int8, 256 bf16) a stage is up to four K-slices of one step:
//     the tensor map sees the gallery as [slices][rows][128 bytes] (a third
//     dimension of stride 128 bytes).  Where a row is one slice (D <= 128
//     int8, 64 bf16: the Poincaré gallery at D 128) a stage is up to four
//     steps of the bucket group: the map sees [steps][L][D] (a third
//     dimension of stride L*D), and the consumers take the steps in turn.
//     Either way the box lands slice after slice as the wgmma descriptors
//     read it.  A [steps][L][D] view holds only whole steps, so a group
//     that is short (the end of a split's range) or holds the partial last
//     step (N % L != 0) comes one step a request from the [N][D] map, whose
//     rows past N read as zeros; no request crosses a split's range;
//   * the query tile is loaded once by TMA and held in shared memory for
//     the whole walk, the Poincaré queries' qs and q_sq beside it; two
//     consumer warpgroups of NW queries each (8, 16, 32 or 64: the
//     narrowest that takes Q, so one query and 16 run no wider than they
//     need) run wgmma m64nNk16 (bf16, f32 sums) or m64nNk32 (int8, int32
//     sums) with the gallery slice as A (one row a bucket) and their
//     queries as B;
//   * the fold runs on the accumulator fragment: each element is one
//     (bucket, query) pair of the step and the same thread holds it at
//     every step, so the thread keeps the pair's v1, v2 and the two
//     winning steps (16 bits each, relative to its range, in one register)
//     in registers across the walk, with a strict '>' so that ties keep
//     the earlier column.  Branch-free: v2 = max(v2, min(v1, v)), v1 =
//     max(v1, v) and two selects for the steps.  The sums are copied once a
//     step and the copy is folded while the next step's products run on
//     the tensor cores (a fold reading the sums themselves makes ptxas
//     serialize the wgmma).  No shared-memory round trip and no block
//     barrier beyond the ring's;
//   * at m64n64 a consumer thread holds 32 sums, their copy and 96
//     registers of top-2 state (setmaxnreg: 232 for the consumers, 40 for
//     the producer); m64n128 would need twice that and overflow.  The
//     Poincaré fold adds a thread's six row terms and reads its columns'
//     qs and q_sq from shared memory at each fold (32 more registers at NW
//     64 if held);
//   * past 128 queries the query tiles of a bucket group are neighbours in
//     the grid, so the later tiles read the group's slices from L2 and
//     the gallery leaves device memory about once.  Clusters of two CTAs
//     with each slice multicast by TMA were measured slower: the
//     handshake that hands each stage back across the cluster cost more
//     than the L2 reads it saves (PERF.md §6);
//   * the steps are split into `splits` contiguous ranges to fill the
//     card (the plan below, one rule for the three modes); a second kernel
//     merges the per-split top-2 lists in (score desc, column asc) order,
//     which gives exactly the sequential answer.  Nothing carries between
//     blocks.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma_gemm.cuh"

using ptt::bf16;
namespace wg = ptt_wgmma;

namespace {

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

// The operand modes: what the fold makes of the sums
enum Mode { COS_BF16 = 0, COS_I8 = 1, POINCARE = 2 };

template <int MODE>
using Elem = std::conditional_t<MODE == COS_BF16, bf16, int8_t>;

// The row and query terms the fold reads: `valid` the bf16 row mask, the
// int8 row scales or the Poincaré rows' w; the Poincaré rows' gw2 and b
// and its queries' qs and q_sq (null in the cosine modes)
struct Terms {
  const float* valid;
  const float* gw2;
  const float* b;
  const float* qs;
  const float* q_sq;
};

// The shape of one call: two consumer warpgroups of NW queries, so nq =
// 2 NW queries a block; ks K-slices a row; a stage of spb K-slices of one
// step or of sps steps of one slice (one of the two is 1), one TMA
// request; `stages` of the ring; `tiles` query tiles, the grid's x; qt
// query terms a query in shared memory (2 in the Poincaré mode).
struct Plan {
  int nw, nq, ks, spb, sps, stages, tiles, qt;
  size_t smem;
};

// the block's shared memory: alignment slack, the query tile, the ring,
// the full, empty and query barriers, then the query terms
__host__ __device__ constexpr size_t plan_smem(int nq, int ks, int stages,
                                               int per_stage, int qt) {
  return 1024 + (size_t)ks * nq * SLICE +
         (size_t)stages * per_stage * SLICE_BYTES +
         (2 * stages + 1) * sizeof(uint64_t) + (size_t)qt * nq * sizeof(float);
}

// Q queries of D values of `elem` bytes over `full` whole steps: the
// narrowest warpgroup width that takes Q in one tile, narrower while the
// query tile leaves no room for MIN_STAGES stages.  False when even 8
// queries a warpgroup leave none.
inline bool make_plan(int Q, int D, int mode, long long full, Plan* p) {
  const int elem = mode == COS_BF16 ? 2 : 1;
  p->qt = mode == POINCARE ? 2 : 0;
  p->ks = (D * elem + SLICE - 1) / SLICE;
  p->nw = Q <= 16 ? 8 : Q <= 32 ? 16 : Q <= 64 ? 32 : 64;
  while (p->nw > 8 &&
         plan_smem(2 * p->nw, p->ks, MIN_STAGES, 1, p->qt) > SMEM_MAX)
    p->nw /= 2;
  p->nq = 2 * p->nw;
  if (plan_smem(p->nq, p->ks, MIN_STAGES, 1, p->qt) > SMEM_MAX) return false;
  // the most slices a TMA request that divide a row (whose bytes fill
  // whole slices) and leave MIN_STAGES stages; or, a row of one slice,
  // MAX_SPB steps a request where the gallery has that many whole steps
  p->spb = p->sps = 1;
  for (int s = MAX_SPB; s > 1 && D * elem % SLICE == 0; s /= 2)
    if (p->ks % s == 0 &&
        plan_smem(p->nq, p->ks, MIN_STAGES, s, p->qt) <= SMEM_MAX) {
      p->spb = s;
      break;
    }
  if (p->ks == 1 && full >= MAX_SPB &&
      plan_smem(p->nq, 1, MIN_STAGES, MAX_SPB, p->qt) <= SMEM_MAX)
    p->sps = MAX_SPB;
  const int per_stage = p->spb * p->sps;
  const size_t base = plan_smem(p->nq, p->ks, 0, per_stage, p->qt);
  p->stages = (int)((SMEM_MAX - base) / (per_stage * SLICE_BYTES + 16));
  if (p->stages * per_stage > MAX_SLICES) p->stages = MAX_SLICES / per_stage;
  p->smem = plan_smem(p->nq, p->ks, p->stages, per_stage, p->qt);
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

// a row's term; 0 past the gallery's end (so such a row scores -inf)
__device__ __forceinline__ float row_term(const float* __restrict__ t,
                                          long long row, int N) {
  return row < N ? __ldg(t + row) : 0.0f;
}

// Grid (query tiles, L / CB bucket groups, splits), WG_THREADS threads:
// warpgroup 0 the producer, 1 and 2 the consumers of NW queries each.
// The query tiles of a bucket group are neighbours in the grid, so all but
// the first read the group's slices from L2.  The split z walks steps
// [z T / splits, (z + 1) T / splits) and writes its lists at z of pv1 ..
// pi2 [splits, Q, L].  gmap reads the gallery as [N][D] by one K-slice
// (spb == 1) or as [slices][N][128 bytes] by spb of them; smap (sps > 1)
// as [N / L whole steps][L][D] by sps steps.
template <int MODE, int NW>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bucket_top2_wg(const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap smap,
                   const __grid_constant__ CUtensorMap qmap, const Terms tm,
                   int Q, int N, int L, int T_steps, int splits, int stages,
                   int ks, int spb, int sps, float* __restrict__ pv1,
                   int* __restrict__ pi1, float* __restrict__ pv2,
                   int* __restrict__ pi2) {
  using T = Elem<MODE>;
  constexpr bool HYP = MODE == POINCARE;
  constexpr int NQ = 2 * NW;               // queries a block
  constexpr int NA = NW / 2;               // pairs (sums) a thread
  constexpr int ELEMS = SLICE / (int)sizeof(T);   // values a K-slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qtile = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = qtile + (size_t)ks * NQ * SLICE;
  const uint32_t stage_bytes = spb * sps * SLICE_BYTES;
  const int kst = ks / spb;                // stages a step
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               (size_t)stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;
  float* qterm = reinterpret_cast<float*>(qbar + 1);   // qs [NQ], q_sq [NQ]

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
  if constexpr (HYP)
    for (int i = threadIdx.x; i < NQ; i += blockDim.x) {
      const bool in = q0 + i < Q;
      qterm[i] = in ? tm.qs[q0 + i] : 0.0f;
      qterm[NQ + i] = in ? tm.q_sq[q0 + i] : 0.0f;
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
      // the gallery: a use of the ring is stage k of a step (sps == 1) or
      // a group of up to sps steps; rows past N read as zeros
      const int whole = N / L;
      const uint32_t uses = (uint32_t)((t1 - t0 + sps - 1) / sps) * kst;
      for (uint32_t u = 0; u < uses; ++u) {
        const int s = u % stages;
        if (u >= (uint32_t)stages)
          wg::mbar_wait(&empty[s], (u / stages - 1) & 1);
        const int t = t0 + (int)(u / kst) * sps, k = (int)(u % kst) * spb;
        unsigned char* dst = ring + (size_t)s * stage_bytes;
        if (sps > 1) {
          const int n = min(sps, t1 - t);
          wg::mbar_expect_tx(&full[s], n * SLICE_BYTES);
          if (n == sps && t + sps <= whole)
            tma_load_3d(dst, &smap, &full[s], 0, b0, t);
          else
            for (int i = 0; i < n; ++i)
              wg::tma_load(dst + (size_t)i * SLICE_BYTES, &gmap, &full[s], 0,
                           (t + i) * L + b0);
        } else {
          wg::mbar_expect_tx(&full[s], stage_bytes);
          if (spb == 1)
            wg::tma_load(dst, &gmap, &full[s], k * ELEMS, t * L + b0);
          else
            tma_load_3d(dst, &gmap, &full[s], 0, t * L + b0, k);
        }
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
    // rows r_lo, r_lo + 8's terms: valid (or w), then gw2 and b
    constexpr int NT = HYP ? 6 : 2;
    float term[NT], snap_term[NT];
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
    int freed_slot = 0;   // freed % stages
    auto free_upto = [&](uint32_t upto) {
      for (; freed < upto; ++freed) {
        if (tid == 0) wg::mbar_arrive(&empty[freed_slot]);
        if (++freed_slot == stages) freed_slot = 0;
      }
    };
    // the fold of the copied step t0 + rel into the running top-2: each
    // pair's score (bf16 the masked sum; int8 the sum times the row's
    // scale, masked; Poincaré the surrogate, masked), then a strict '>'
    // that keeps the earlier of two equal columns; branch-free, v2 =
    // max(v2, min(v1, v)) and v1 = max(v1, v) are the insertion's values
    auto fold = [&](uint32_t rel) {
      // the rows' masks, once a fold: -inf added to a masked cosine row's
      // scores; the Poincaré surrogate of a row with w <= 0 replaced
      float add[2];
      bool dead[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        add[h] = snap_term[h] > 0.0f ? 0.0f : -INFINITY;
        dead[h] = snap_term[h] <= 0.0f;
      }
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
        float2 qs = make_float2(0.0f, 0.0f), qsq = qs;
        if constexpr (HYP) {
          // this thread's two query columns 8i + 2(l%4) + {0, 1}
          const int col = c * NW + 8 * i + 2 * (lane % 4);
          qs = *reinterpret_cast<const float2*>(qterm + col);
          qsq = *reinterpret_cast<const float2*>(qterm + NQ + col);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * i + e, h = e >> 1;
          float v;
          if constexpr (HYP) {
            // qs * (f32(acc) * gw2) - q_sq * w - b, each step rounded
            const float dot =
                __fmul_rn(e & 1 ? qs.y : qs.x,
                          __fmul_rn(__int2float_rn(snap[j]), snap_term[2 + h]));
            v = __fsub_rn(__fsub_rn(dot, __fmul_rn(e & 1 ? qsq.y : qsq.x,
                                                   snap_term[h])),
                          snap_term[4 + h]);
            if (dead[h]) v = -INFINITY;
          } else if constexpr (MODE == COS_I8)
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
      }
    };
    const unsigned char* qw = qtile + (size_t)c * NW * SLICE;
    const int kf = kst > 1 ? 1 : 0;   // the stage after which the fold runs
    // the ring use being read, its stage and barrier parity, and the
    // step's place in it (sps > 1), counted as the walk goes
    uint32_t u = 0;
    int slot = 0, parity = 0, pos = 0;
    auto next_use = [&]() {
      ++u;
      if (++slot == stages) {
        slot = 0;
        parity ^= 1;
      }
    };
    wg::mbar_wait(qbar, 0);
    for (int t = t0; t < t1; ++t) {
      const long long r = (long long)t * L + row_lo;
      // read at the step's fold
      term[0] = row_term(tm.valid, r, N);
      term[1] = row_term(tm.valid, r + 8, N);
      if constexpr (HYP) {
        term[2] = row_term(tm.gw2, r, N);
        term[3] = row_term(tm.gw2, r + 8, N);
        term[4] = row_term(tm.b, r, N);
        term[5] = row_term(tm.b, r + 8, N);
      }
      for (int k = 0; k < kst; ++k) {
        if (k > 0) next_use();
        if (pos == 0) wg::mbar_wait(&full[slot], parity);
        fence_regs<NA>(acc);
        wg::wgmma_fence();
        const unsigned char* stage = ring + (size_t)slot * stage_bytes +
                                     (size_t)pos * SLICE_BYTES;
        for (int i = 0; i < spb; ++i) {
          const uint64_t da =
              wg::desc_k_sw128(stage + (size_t)i * SLICE_BYTES);
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
      // a use goes back after its last step
      if (++pos == sps || t == t1 - 1) {
        free_upto(u + 1);
        next_use();
        pos = 0;
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) snap[j] = acc[j];
#pragma unroll
      for (int h = 0; h < NT; ++h) snap_term[h] = term[h];
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

inline CUtensorMapDataType tma_type(int elem) {
  return elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a [rows, D] matrix of `elem`-byte values read in boxes of one K-slice by
// box_rows rows with the 128-byte swizzle; out-of-bounds reads give 0
bool slice_map(CUtensorMap* map, const void* p, long long rows, int D,
               int elem, int box_rows) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(SLICE / elem), (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return encode(map, tma_type(elem), 2, const_cast<void*>(p), dims, strides,
                box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D view of the gallery read in boxes of one K-slice by CB rows by
// `depth`, with the 128-byte swizzle, so that one request lands its K-slices
// one after another as the wgmma descriptors read them: steps == 0, the
// [rows, D] matrix (D * elem a multiple of SLICE) as [D / slice][rows][one
// slice] (a third dimension of stride SLICE bytes), depth slices of one
// step; steps > 0, its first steps * L rows as [steps][L][D] (a third
// dimension of stride L * D), depth steps of one slice.
bool stage_map(CUtensorMap* map, const void* p, long long rows, int D,
               int elem, int L, int steps, int depth) {
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const int slice = SLICE / elem;
  const cuuint64_t dims[3] = {
      (cuuint64_t)(steps ? D : slice), (cuuint64_t)(steps ? L : rows),
      (cuuint64_t)(steps ? steps : D / slice)};
  const cuuint64_t strides[2] = {
      (cuuint64_t)D * elem,
      (cuuint64_t)(steps ? (long long)L * D * elem : SLICE)};
  const cuuint32_t box[3] = {(cuuint32_t)slice, (cuuint32_t)CB,
                             (cuuint32_t)depth};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, tma_type(elem), 3, const_cast<void*>(p), dims, strides,
                box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, int NW>
int launch_wg(const Plan& p, const CUtensorMap& gmap, const CUtensorMap& smap,
              const CUtensorMap& qmap, const Terms& tm, int Q, int N, int L,
              int splits, float* pv1, int* pi1, float* pv2, int* pi2,
              cudaStream_t st) {
  auto kernel = bucket_top2_wg<MODE, NW>;
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
      gmap, smap, qmap, tm, Q, N, L, (N + L - 1) / L, splits, p.stages, p.ks,
      p.spb, p.sps, pv1, pi1, pv2, pi2);
  return (int)cudaGetLastError();
}

// The per-split lists of a call
template <int MODE>
int top2_wg(const Plan& p, const void* q, int Q, const void* gal,
            const Terms& tm, int N, int D, int L, int splits, float* pv1,
            int* pi1, float* pv2, int* pi2, cudaStream_t st) {
  constexpr int elem = (int)sizeof(Elem<MODE>);
  CUtensorMap gmap, smap, qmap;
  if (!(p.spb == 1 ? slice_map(&gmap, gal, N, D, elem, CB)
                    : stage_map(&gmap, gal, N, D, elem, L, 0, p.spb)) ||
      !slice_map(&qmap, q, Q, D, elem, p.nq))
    return (int)cudaErrorInvalidValue;
  if (p.sps == 1)
    smap = gmap;                      // not read
  else if (!stage_map(&smap, gal, N, D, elem, L, N / L, p.sps))
    return (int)cudaErrorInvalidValue;
  switch (p.nw) {
    case 8:
      return launch_wg<MODE, 8>(p, gmap, smap, qmap, tm, Q, N, L, splits,
                                pv1, pi1, pv2, pi2, st);
    case 16:
      return launch_wg<MODE, 16>(p, gmap, smap, qmap, tm, Q, N, L, splits,
                                 pv1, pi1, pv2, pi2, st);
    case 32:
      return launch_wg<MODE, 32>(p, gmap, smap, qmap, tm, Q, N, L, splits,
                                 pv1, pi1, pv2, pi2, st);
    default:
      return launch_wg<MODE, 64>(p, gmap, smap, qmap, tm, Q, N, L, splits,
                                 pv1, pi1, pv2, pi2, st);
  }
}

// The split count of a call on the current card: as many step ranges as
// let the blocks of one wave fill the SMs (one block an SM: the ring takes
// most of its shared memory), at most one a step, and enough that no
// range passes MAX_STEPS steps.
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

// A call: the per-split lists, then their merge; one split writes the
// answer directly.
template <int MODE>
int bucket_top2(const void* q, int Q, const void* gal, const Terms& tm, int N,
                int D, int L, int splits, void* pv1, void* pi1, void* pv2,
                void* pi2, void* v1, void* i1, void* v2, void* i2,
                cudaStream_t st) {
  Plan p;
  if (Q < 1 || N < 1 || L % CB || splits < 1 ||
      !make_plan(Q, D, MODE, N / L, &p) ||
      (N + (long long)L - 1) / L > (long long)splits * MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    pv1 = v1;
    pi1 = i1;
    pv2 = v2;
    pi2 = i2;
  }
  PTT_TRY(top2_wg<MODE>(p, q, Q, gal, tm, N, D, L, splits, (float*)pv1,
                        (int*)pi1, (float*)pv2, (int*)pi2, st));
  return splits == 1 ? 0
                     : merge(pv1, pi1, pv2, pi2, splits, Q, L, v1, i1, v2, i2,
                             st);
}

}  // namespace

extern "C" {

// The split count the three entries below take for Q queries over N rows
// of D values into L buckets on the current card (mode 0: bf16 operands,
// ptt_bucket_top2; 1: int8, ptt_bucket_top2_i8; 2: the Poincaré surrogate,
// ptt_bucket_top2_poincare): the scratch pv1 .. pi2 is [splits, Q, L].
int ptt_bucket_top2_plan(int Q, int N, int D, int L, int mode, int* splits) {
  Plan p;
  if (Q < 1 || N < 1 || L < CB || mode < COS_BF16 || mode > POINCARE ||
      !make_plan(Q, D, mode, N / L, &p))
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
  const Terms tm{(const float*)valid, nullptr, nullptr, nullptr, nullptr};
  return bucket_top2<COS_BF16>(q, Q, gal, tm, N, D, L, splits, pv1, pi1, pv2,
                               pi2, v1, i1, v2, i2, (cudaStream_t)stream);
}

// The int8 gallery: q [Q, D] int8, gal [N, D] int8, gal_scale [N] f32 ->
// v1, i1, v2, i2 [Q, L] on the f32(acc) * gal_scale scale (the query scale
// is applied by the caller).  D % 16 == 0, L % 64 == 0; splits and
// scratch as ptt_bucket_top2.
int ptt_bucket_top2_i8(const void* q, int Q, const void* gal,
                       const void* gal_scale, int N, int D, int L, int splits,
                       void* pv1, void* pi1, void* pv2, void* pi2, void* v1,
                       void* i1, void* v2, void* i2, void* stream) {
  const Terms tm{(const float*)gal_scale, nullptr, nullptr, nullptr, nullptr};
  return bucket_top2<COS_I8>(q, Q, gal, tm, N, D, L, splits, pv1, pi1, pv2,
                             pi2, v1, i1, v2, i2, (cudaStream_t)stream);
}

// The Poincaré gallery: q [Q, D] int8 with qs, q_sq [Q] f32; gal [N, D]
// int8 with gw2, w, b [N] f32 (prepare_poincare_gallery) -> v1, i1, v2, i2
// [Q, L] on the surrogate's scale.  D % 16 == 0, L % 64 == 0; splits (mode
// 2) and scratch as ptt_bucket_top2.
int ptt_bucket_top2_poincare(const void* q, const void* qs, const void* q_sq,
                             int Q, const void* gal, const void* gw2,
                             const void* w, const void* b, int N, int D,
                             int L, int splits, void* pv1, void* pi1,
                             void* pv2, void* pi2, void* v1, void* i1,
                             void* v2, void* i2, void* stream) {
  const Terms tm{(const float*)w, (const float*)gw2, (const float*)b,
                 (const float*)qs, (const float*)q_sq};
  return bucket_top2<POINCARE>(q, Q, gal, tm, N, D, L, splits, pv1, pi1, pv2,
                               pi2, v1, i1, v2, i2, (cudaStream_t)stream);
}

}  // extern "C"
