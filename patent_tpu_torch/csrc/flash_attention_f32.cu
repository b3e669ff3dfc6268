// Row 14's f32 instance: softmax(q k^T / sqrt(d)) v on projected f32
// q, k, v [B, S, H, hd] -> [B, S, H, hd] at any head width hd that is a
// multiple of 8 up to 128 and any S (the bf16 instance is
// csrc/flash_attention.cu, which names the TPU kernels both replace and
// their function; here every step of it is f32).
//
// f32 (JAX's VisionTransformer defaults to f32): products and sums in f32
// FMAs on the CUDA cores, no TF32.  What bounds it on the H100: at
// [128, 197, 12, 64] it does 15.3 GFLOP (q.k and p.v) on 310 MB of q, k,
// v and o, 0.228 ms at the 67 TFLOP/s FP32 rate against 0.093 ms of
// bytes: the FMA units.  An FMA needs its two operands from registers,
// and shared memory delivers 128 bytes a clock an SM against 128 FMAs,
// so each value read from shared memory has to feed several FMAs.  The
// design is an SGEMM's register tiling, applied to both products:
//   * one block of 128 threads per (8*TM query rows, head, image); thread
//     (tx, ty) of a 16 x 8 grid owns query rows ty + 8i (i < TM), and for
//     q.k^T the keys tx + 16j of a 64-key tile (j < 4), for p.v the head
//     dims DV tx .. DV tx + DV - 1, DV = HD / 16 (4 at 64; 1 to 8 at the
//     instance widths 16 to 128, where 3, 5, 6 and 7 are read and written
//     a float at a time; the numbers here are hd 64's).  A q' value read from shared memory feeds 4 FMAs
//     (one per key), a K value TM; a p value 4 (one per dim), a V value
//     TM.  TM, 5 or 8 (each width has those two instances, which keeps
//     the build short), is chosen per launch so that the last query block
//     wastes fewer rows: S 197 takes TM 5, 5 blocks of 40 rows, 200 rows
//     in all; TM changes which thread sums a value, never the order of
//     any sum, so the output is the same bits at either;
//   * with no running max there is nothing to rescale: keys stream
//     through shared memory in tiles of 64, and only the output
//     accumulators and the row sums carry from tile to tile.  K is
//     double-buffered with cp.async (tile t + 1 loads during tile t), V
//     single-buffered (it loads during the tile's q.k^T); the tile's p
//     goes over its K once q.k^T is done, so a row of Q, K and p holds
//     max(HD, 64) + 4 floats: 68 at 64 and below, 84 at 80, up to 132 at
//     128, an odd count of 16-byte chunks, which puts the 8 rows a
//     quarter-warp reads in 8 different bank groups;
//   * the last key tile computes q.k^T only for the key groups that hold
//     a key below S (at S 197 one of four) and p.v over its keys rounded
//     up to 4;
//   * 62-69 KB of shared memory a block at 64: three blocks (12 warps) an
//     SM (134 KB at 128 and TM 8: one);
//   * the kernel is instantiated at the tile's widths, every multiple of 16
//     up to 128; a real width hd of HD - 8 runs on the HD instance with
//     the q, K and V columns past hd zero (zero-filled on load, so the
//     next head's columns are never read), adding exact zeros to every
//     score, and only hd columns stored.
// Each value read from shared memory feeds 2.2 FMAs at TM 5 (2.7 at TM
// 8), so the shared-memory data path caps it below the FMA rate.  Larger
// thread tiles feed more FMAs a value but take more registers and leave
// fewer warps to hide latency: on the H100 they were slower than this
// design (8 x 8 tiles at 254 registers, TM 9 to 13 at two blocks an SM),
// as were p exchanged by warp shuffles instead of shared memory, and
// 64-row blocks with a separate short block for the last rows.

#include <type_traits>

#include "common.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int F32_THREADS = 128;
constexpr int F32_TX = 16;          // thread columns: keys, then head dims
constexpr int F32_TY = 8;           // thread rows: query rows ty + 8i
constexpr int F32_KT = 64;          // keys per tile

// the padded row of Q, K and p (floats) at instance width HD: a K row
// holds HD values and a p row the tile's 64 keys
template <int HD>
struct F32Row {
  static constexpr int LD = (HD > F32_KT ? HD : F32_KT) + 4;
};

template <int TM, int HD>
constexpr size_t f32_smem_bytes() {
  constexpr int LD = F32Row<HD>::LD;
  return ((size_t)F32_TY * TM * LD            // q'
          + 2 * (size_t)F32_KT * LD           // K, two stages (then p)
          + (size_t)F32_KT * HD)              // V
         * sizeof(float);
}

// N (1 to 8) consecutive floats between registers and memory: 4 and 2 as
// one vector (p aligned to it), the others a float at a time
template <int N>
__device__ __forceinline__ void load_vec(float (&r)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// the first n of N floats to memory (n = N: 4 and 2 as one vector)
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[N],
                                          int n) {
  if constexpr (N == 4) {
    if (n >= 4)
      *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    if (n >= 2) *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = r[i];
  }
}

// s[i][j] += q'[ty + 8i] . k[tx + 16j] for the tile's first NJ key groups:
// qs points at row ty, ks at row tx of the tile
template <int TM, int NJ, int HD>
__device__ __forceinline__ void f32_scores(float (&s)[TM][4],
                                           const float* __restrict__ qs,
                                           const float* __restrict__ ks) {
  constexpr int LD = F32Row<HD>::LD;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    float4 kv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      kv[j] = *reinterpret_cast<const float4*>(&ks[16 * j * LD + c]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&qs[F32_TY * i * LD + c]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
      }
    }
  }
}

template <int TM, int HD>
__global__ void __launch_bounds__(F32_THREADS, 3)
    flash_f32_kernel(const float* __restrict__ q, long long q_img, int q_row,
                     const float* __restrict__ k, const float* __restrict__ v,
                     long long kv_img, int kv_row, float* __restrict__ o,
                     long long o_img, int o_row, int S, int hd,
                     float scale) {
  constexpr int BQ = F32_TY * TM;
  constexpr int DV = HD / F32_TX;       // head dims a thread in p.v
  constexpr int LD = F32Row<HD>::LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;                         // [2][F32_KT][LD]
  float* Vs = Ks + 2 * F32_KT * LD;                 // [F32_KT][HD]
  const int tid = threadIdx.x, tx = tid % F32_TX, ty = tid / F32_TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * q_img + h * hd;
  const float* kb = k + b * kv_img + h * hd;
  const float* vb = v + b * kv_img + h * hd;
  const int nt = (S + F32_KT - 1) / F32_KT;

  // rows k0.. of K or V into a tile with row stride ld; rows at or past S
  // and columns past hd are zero-filled (their source is not read)
  auto load_rows = [&](float* dst, int ld, const float* src, int k0) {
    for (int c = tid; c < F32_KT * (HD / 4); c += F32_THREADS) {
      const int r = c / (HD / 4), cc = (c % (HD / 4)) * 4;
      const bool ok = k0 + r < S && cc < hd;
      ptt::cp_async16(&dst[r * ld + cc],
                      ok ? src + (size_t)(k0 + r) * kv_row + cc : src, ok);
    }
    ptt::cp_async_commit();
  };
  load_rows(Ks, LD, kb, 0);
  // q' = f32(q) * scale, rounded once; rows past S and columns past hd
  // are 0.  TM * HD / 64 chunks a thread, unrolled so that their loads are
  // in flight together
  constexpr int QCH = BQ * (HD / 4);
#pragma unroll
  for (int u = 0; u < (QCH + F32_THREADS - 1) / F32_THREADS; ++u) {
    const int c = tid + u * F32_THREADS;
    if (QCH % F32_THREADS && c >= QCH) break;
    const int r = c / (HD / 4), cc = (c % (HD / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < S && cc < hd) {
      x = *reinterpret_cast<const float4*>(&qb[(size_t)(q0 + r) * q_row + cc]);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(&Qs[r * LD + cc]) = x;
  }

  float acc[TM][DV], rsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rsum[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = 0.0f;
  }
  const float* qs = Qs + ty * LD;
  for (int t = 0; t < nt; ++t) {
    float* Kt = Ks + (t & 1) * F32_KT * LD;
    const int k0 = t * F32_KT;
    const int nk = min(F32_KT, S - k0);
    // K(t) has landed; every warp is done with tile t - 1's p and V
    ptt::cp_async_wait<0>();
    __syncthreads();
    load_rows(Vs, HD, vb, k0);
    if (t + 1 < nt)
      load_rows(Ks + ((t + 1) & 1) * F32_KT * LD, LD, kb, k0 + F32_KT);
    else
      ptt::cp_async_commit();        // an empty group keeps the count

    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    const float* ks = Kt + tx * LD;
    switch ((nk + 15) / 16) {        // key groups with a key below S
      case 1: f32_scores<TM, 1, HD>(s, qs, ks); break;
      case 2: f32_scores<TM, 2, HD>(s, qs, ks); break;
      case 3: f32_scores<TM, 3, HD>(s, qs, ks); break;
      default: f32_scores<TM, 4, HD>(s, qs, ks); break;
    }
    __syncthreads();                 // K(t) read by every warp: p goes over it
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = key < nk
                            ? exp2f(fminf(fmaxf(s[i][j], ptt_flash::SCORE_LO),
                                          ptt_flash::SCORE_HI))
                            : 0.0f;
        rsum[i] += p;
        Kt[(ty + F32_TY * i) * LD + key] = p;
      }
    ptt::cp_async_wait<1>();         // V(t); K(t + 1) may still be in flight
    __syncthreads();

    // o += p v over the tile's keys, 4 at a time (p of keys >= nk is 0 and
    // V's rows past S are zero)
    const float* ps = Kt + ty * LD;
    const float* vs = Vs + DV * tx;
    for (int j = 0; j < nk; j += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[F32_TY * i * LD + j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[DV];
        load_vec<DV>(vv, &vs[(j + e) * HD]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int d = 0; d < DV; ++d) acc[i][d] = fmaf(pe, vv[d], acc[i][d]);
        }
      }
    }
  }

  // each row's sum over the 16 threads of its half-warp, then an exact
  // divide; the thread's first hd - DV tx dims stored
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = F32_TX / 2; off > 0; off >>= 1)
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
    const int row = q0 + ty + F32_TY * i;
    float out[DV];
#pragma unroll
    for (int d = 0; d < DV; ++d) out[d] = __fdiv_rn(acc[i][d], rsum[i]);
    if (row < S)
      store_vec<DV>(&o[b * o_img + (size_t)row * o_row + h * hd + DV * tx],
                    out, hd - DV * tx);
  }
}

template <int TM, int HD>
int launch_f32(const float* q, long long q_img, int q_row, const float* k,
               const float* v, long long kv_img, int kv_row, float* o, int B,
               int S, int H, int hd, float scale, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<TM, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<TM, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = F32_TY * TM;
  flash_f32_kernel<TM, HD><<<dim3((S + bq - 1) / bq, H, B), F32_THREADS,
                             smem, st>>>(q, q_img, q_row, k, v, kv_img,
                                         kv_row, o, (long long)S * H * hd,
                                         H * hd, S, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row 14's function on f32 q, k, v [B, S, H, hd] with image strides
// q_img, kv_img and row strides q_row, kv_row (elements; the last two axes
// packed, rows 16-byte aligned), o [B, S, H, hd] contiguous; hd a multiple
// of 8 up to 128, on the instance tile_width(hd); scale = log2(e)/sqrt(hd).
// The query block of 8 * TM rows, TM 5 or 8, that pads S less (8 on a
// tie).
int ptt_flash_attention_f32(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int hd,
                            long long q_img, int q_row, long long kv_img,
                            int kv_row, float scale, void* stream) {
  const bool tm5 = (S + 39) / 40 * 40 < (S + 63) / 64 * 64;
  auto at_hd = [&](auto hd_c) {
    auto run = [&](auto tm_c) {
      return launch_f32<decltype(tm_c)::value, decltype(hd_c)::value>(
          (const float*)q, q_img, q_row, (const float*)k, (const float*)v,
          kv_img, kv_row, (float*)o, B, S, H, hd, scale,
          (cudaStream_t)stream);
    };
    return tm5 ? run(std::integral_constant<int, 5>())
               : run(std::integral_constant<int, 8>());
  };
  switch (ptt_flash::tile_width(hd)) {
    case 16: return at_hd(std::integral_constant<int, 16>());
    case 32: return at_hd(std::integral_constant<int, 32>());
    case 48: return at_hd(std::integral_constant<int, 48>());
    case 64: return at_hd(std::integral_constant<int, 64>());
    case 80: return at_hd(std::integral_constant<int, 80>());
    case 96: return at_hd(std::integral_constant<int, 96>());
    case 112: return at_hd(std::integral_constant<int, 112>());
    case 128: return at_hd(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
