// The trainable attention sub-layer of the fine-tune tower, forward and
// backward.
//
// Replaces the TPU kernels of patent_tpu/ops/flash_attention.py:
//   ptt_fab_fwd   _fused_attn_block_kernel / _fab_group_kernel (public
//                 entry fused_attention_block, its forward)
//   ptt_fab_bwd   _attn_bwd_kernel (the custom VJP's backward kernel),
//                 with the qkv recompute that _fab_bwd does before it
//
// Forward, on a token stream padded to a multiple of 16 with q columns of
// Wqkv' and b' pre-scaled by log2(e)/sqrt(hd) (the caller folds them):
//   qkv = bf16(x Wqkv' + b')                              (f32 accumulate)
//   p   = bf16(exp2(clip(q.k, -100, 80))), keys >= valid_len p = 0
//   ao  = bf16((p v) / sum(p))
//   out = bf16(ao Wout + bout)                             (pre-residual)
// Backward, per (image, head), given da = dout Wout^T (bf16):
//   o = (p v)/den; dn = da/den; dden = -sum(da o)/den      (f32)
//   dp = bf16(dn) v^T + bf16(dden) valid
//   ds = bf16(s < 80 ? ln2 dp p : 0)       (the +80 clamp's gate)
//   dq = ds k, dk = ds^T q, dv = p^T bf16(dn) (pad keys 0); A = bf16(o)
//
// What bounds it on the H100: at ViT-B/16 fine-tune shapes (2B = 128
// images, S = 208, D = 768) the forward is ~143 GFLOP of tensor-core work
// (projections 90%) and the backward ~94 GFLOP of qkv recompute plus
// ~60 GFLOP of attention products against ~330 MB of qkv, da, dqkv and A:
// the tensor cores bound both.  Design:
//   * the forward is the serving layer's Hopper parts (rows 1-2), three
//     launches: the QKV and out-projection GEMMs on csrc/wgmma_gemm.cuh
//     (TMA and wgmma, bias epilogue, bf16 out; the wrapper passes the
//     weights transposed, [out, in], as that GEMM reads them) around
//     csrc/flash_tile.cuh reading q, k, v as strided slices of qkv;
//   * the backward recomputes qkv on the same GEMM, then runs one block of
//     4 warps per (head, image), in the shape of FlashAttention-2's
//     backward, on mma.sync with every score tile in registers:
//     phase 1, the warps over query tiles of 16, is the forward's tile
//     (K and V in shared memory): p, o and the row sums, then A = bf16(o),
//     bf16(dn) into shared memory beside q, and bf16(dden);
//     phase 2, the warps over key tiles of 16, recomputes s^T and p^T once
//     for its keys against every query tile, and keeps dk and dv in
//     registers; dq of a query tile is ds k, the transpose of the ds^T
//     fragments taken in registers (movmatrix), added into an f32 [S, 64]
//     sum in shared memory over the space K and V held.  At each step the
//     warps take distinct query tiles (a diagonal), with a barrier
//     between steps, so dq's sums run in one order and two runs give the
//     same bits.  Shared memory is q, dn, K and V (or dq) and dden, 516
//     bytes a row: 107 KB at S 208, two blocks an SM.
// The forward takes the tile's contract (head widths that are multiples of
// 8 up to 128, any S); the backward is instantiated at head width 64
// (ViT-B/16), 32 and 16 (the CLIs' small tower, D 64 over 4 heads) only,
// its shared memory S x 516 bytes at 64: ptt_fab_bwd names each width and
// refuses the rest.

#include <type_traits>

#include "common.cuh"
#include "flash_tile.cuh"
#include "wgmma_gemm.cuh"

using ptt::bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LN2 = 0.69314718055994531f;
constexpr float LO = ptt_flash::SCORE_LO, HI = ptt_flash::SCORE_HI;

using ptt_flash::ldmatrix_x4;
using ptt_flash::ldmatrix_x4_trans;
using ptt_flash::mma_bf16;
using ptt_flash::pack_bf16;
using ptt_flash::swz;

// q, dn, then K and V (phase 1) or dq (phase 2), then dden: bytes
inline size_t bwd_smem(int S, int hd) {
  return (size_t)S * (4 * hd * sizeof(bf16) + sizeof(float));
}

// the transpose of an 8 x 8 bf16 tile held as mma fragments
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One (head, image) of HD columns: writes A [B, S, D] and dq, dk, dv into
// dqkv [B, S, 3D] (bf16) from qkv [B, S, 3D] and da [B, S, D].  S is a
// multiple of 16.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                    bf16* __restrict__ dqkv, bf16* __restrict__ a, int S,
                    int D, int valid_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* DNs = Qs + (size_t)S * HD;
  bf16* Ks = DNs + (size_t)S * HD;
  bf16* Vs = Ks + (size_t)S * HD;
  float* DQ = reinterpret_cast<float*>(Ks);     // phase 2, over K and V
  float* dden = reinterpret_cast<float*>(Vs + (size_t)S * HD);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D3 = 3 * D, nt = S / 16;
  const bf16* qb = qkv + (size_t)b * S * D3 + h * HD;
  const bf16* kb = qb + D;
  const bf16* vb = qb + 2 * D;
  const bf16* dab = da + (size_t)b * S * D + h * HD;
  bf16* ab = a + (size_t)b * S * D + h * HD;
  bf16* dqb = dqkv + (size_t)b * S * D3 + h * HD;

  // q of every row; K and V zero past valid_len, as the forward's tile
  constexpr int CH = HD / 8;             // 16-byte chunks a row
  for (int c = tid; c < S * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r < valid_len;
    ptt::cp_async16(&Qs[swz<HD>(r, ch)], qb + (size_t)r * D3 + ch * 8, true);
    ptt::cp_async16(&Ks[swz<HD>(r, ch)], ok ? kb + (size_t)r * D3 + ch * 8 : kb,
                    ok);
    ptt::cp_async16(&Vs[swz<HD>(r, ch)], ok ? vb + (size_t)r * D3 + ch * 8 : vb,
                    ok);
  }
  ptt::cp_async_commit();
  ptt::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 1: the forward over query tiles, then the row terms
  for (int qt = warp; qt < nt; qt += WARPS) {
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qa[kk], &Qs[swz<HD>(qt * 16 + (lane & 15), kk * 2 + (lane >> 4))]);
    float oacc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
    float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = 0; n < S; n += 16) {
      float sacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[swz<HD>(n + (lane & 7) + ((lane >> 4) << 3),
                               kk * 2 + ((lane >> 3) & 1))]);
        mma_bf16(sacc[0], qa[kk], kf[0], kf[1]);
        mma_bf16(sacc[1], qa[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key = n + 8 * j + 2 * t + (e & 1) < valid_len;
          sacc[j][e] = key ? exp2f(fminf(fmaxf(sacc[j][e], LO), HI)) : 0.0f;
        }
      const uint32_t pa[4] = {pack_bf16(sacc[0][0], sacc[0][1]),
                              pack_bf16(sacc[0][2], sacc[0][3]),
                              pack_bf16(sacc[1][0], sacc[1][1]),
                              pack_bf16(sacc[1][2], sacc[1][3])};
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[swz<HD>(n + (lane & 7) + (((lane >> 3) & 1) << 3),
                                     jj * 2 + (lane >> 4))]);
        mma_bf16(oacc[2 * jj], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * jj + 1], pa, vf[2], vf[3]);
      }
      mma_bf16(lacc, pa, ptt_flash::BF16_ONES, ptt_flash::BF16_ONES);
    }
    // o = O / den -> A; dn = bf16(da / den) -> DNs; dden = bf16(-(da . o)
    // / den): rows r[0] (den lacc[0]) and r[1] (den lacc[2])
    const int rows[2] = {qt * 16 + g, qt * 16 + g + 8};
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int r = rows[hlf];
        const float den = lacc[2 * hlf];
        const float o0 = __fdiv_rn(oacc[j][2 * hlf], den);
        const float o1 = __fdiv_rn(oacc[j][2 * hlf + 1], den);
        ptt::store2(ab + (size_t)r * D + c, o0, o1);
        const float2 dv2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&dab[(size_t)r * D + c]));
        dot[hlf] += dv2.x * o0;
        dot[hlf] += dv2.y * o1;
        *reinterpret_cast<uint32_t*>(&DNs[swz<HD>(r, j) + 2 * t]) =
            pack_bf16(__fdiv_rn(dv2.x, den), __fdiv_rn(dv2.y, den));
      }
    }
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      dot[hlf] += __shfl_xor_sync(0xffffffffu, dot[hlf], 1);
      dot[hlf] += __shfl_xor_sync(0xffffffffu, dot[hlf], 2);
      if (t == 0)
        dden[rows[hlf]] = round_bf16(__fdiv_rn(-dot[hlf], lacc[2 * hlf]));
    }
  }
  __syncthreads();
  // K and V are done with: their space holds dq's f32 sums, [query tile]
  // [HD / 2 values][32 lanes] in the mma accumulator layout
  for (int i = tid; i < S * HD; i += THREADS) DQ[i] = 0.0f;
  __syncthreads();

  // ---- phase 2: the warps over key tiles of 16, in rounds
  for (int k0 = warp * 16; k0 - warp * 16 < S; k0 += WARPS * 16) {
    const bool active = k0 < S;
    uint32_t ka[HD / 16][4], va[HD / 16][4], kbt[HD / 8][2];
    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
    if (active) {
      // this warp's keys (zero past valid_len): k and v as A fragments
      // (rows = keys), k as the B fragments of ds k
      auto word = [&](const bf16* base, int r, int c) -> uint32_t {
        return r < valid_len
                   ? *reinterpret_cast<const uint32_t*>(&base[(size_t)r * D3 + c])
                   : 0u;
      };
      auto val = [&](int r, int c) -> bf16 {
        return r < valid_len ? kb[(size_t)r * D3 + c] : __float2bfloat16(0.0f);
      };
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        ka[kk][0] = word(kb, k0 + g, c);
        ka[kk][1] = word(kb, k0 + g + 8, c);
        ka[kk][2] = word(kb, k0 + g, c + 8);
        ka[kk][3] = word(kb, k0 + g + 8, c + 8);
        va[kk][0] = word(vb, k0 + g, c);
        va[kk][1] = word(vb, k0 + g + 8, c);
        va[kk][2] = word(vb, k0 + g, c + 8);
        va[kk][3] = word(vb, k0 + g + 8, c + 8);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + g;
        kbt[j][0] = pack_raw(val(k0 + 2 * t, c), val(k0 + 2 * t + 1, c));
        kbt[j][1] = pack_raw(val(k0 + 8 + 2 * t, c), val(k0 + 9 + 2 * t, c));
      }
    }
    for (int step = 0; step < nt; ++step) {
      if (active) {
        const int q0 = (step + warp) % nt * 16;
        // s^T = k q^T: sacc[j][e] at key k0 + g + 8(e/2), query q0 + 8j +
        // 2t + e%2
        float sacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float dpacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                             {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t qf[4], nf[4];
          ldmatrix_x4(qf, &Qs[swz<HD>(q0 + (lane & 7) + ((lane >> 4) << 3),
                                 kk * 2 + ((lane >> 3) & 1))]);
          mma_bf16(sacc[0], ka[kk], qf[0], qf[1]);
          mma_bf16(sacc[1], ka[kk], qf[2], qf[3]);
          // dp^T = v dn^T
          ldmatrix_x4(nf, &DNs[swz<HD>(q0 + (lane & 7) + ((lane >> 4) << 3),
                                  kk * 2 + ((lane >> 3) & 1))]);
          mma_bf16(dpacc[0], va[kk], nf[0], nf[1]);
          mma_bf16(dpacc[1], va[kk], nf[2], nf[3]);
        }
        // p^T = bf16(exp2(clip(s^T))), 0 at pad keys; ds^T = bf16(s < 80 ?
        // (ln2 dp) p : 0), dp = dn v^T + dden at valid keys
        float p[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool key = k0 + g + 8 * (e >> 1) < valid_len;
            const float sv = sacc[j][e];
            p[j][e] = key ? round_bf16(exp2f(fminf(fmaxf(sv, LO), HI))) : 0.0f;
            const float dp =
                key ? dpacc[j][e] + dden[q0 + 8 * j + 2 * t + (e & 1)] : 0.0f;
            ds[j][e] = sv < HI ? (LN2 * dp) * p[j][e] : 0.0f;
          }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                                pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]),
                                pack_bf16(p[1][2], p[1][3])};
        const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                                 pack_bf16(ds[0][2], ds[0][3]),
                                 pack_bf16(ds[1][0], ds[1][1]),
                                 pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
        for (int jj = 0; jj < HD / 16; ++jj) {
          uint32_t nf[4], qf[4];
          // dv += p^T dn
          ldmatrix_x4_trans(nf, &DNs[swz<HD>(q0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        jj * 2 + (lane >> 4))]);
          mma_bf16(dv[2 * jj], pa, nf[0], nf[1]);
          mma_bf16(dv[2 * jj + 1], pa, nf[2], nf[3]);
          // dk += ds^T q
          ldmatrix_x4_trans(qf, &Qs[swz<HD>(q0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       jj * 2 + (lane >> 4))]);
          mma_bf16(dk[2 * jj], dsa, qf[0], qf[1]);
          mma_bf16(dk[2 * jj + 1], dsa, qf[2], qf[3]);
        }
        // dq[q0 .. q0 + 15] += ds k, ds = (ds^T)^T as an A fragment
        const uint32_t dsq[4] = {movmatrix_trans(dsa[0]),
                                 movmatrix_trans(dsa[2]),
                                 movmatrix_trans(dsa[1]),
                                 movmatrix_trans(dsa[3])};
        float* tile = DQ + (size_t)(q0 / 16) * (16 * HD) + lane;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          float acc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = tile[(4 * j + e) * 32];
          mma_bf16(acc, dsq, kbt[j][0], kbt[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) tile[(4 * j + e) * 32] = acc[e];
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const size_t o = (size_t)(k0 + g + 8 * hlf) * D3 + c;
          ptt::store2(dqb + D + o, dk[j][2 * hlf], dk[j][2 * hlf + 1]);
          ptt::store2(dqb + 2 * D + o, dv[j][2 * hlf], dv[j][2 * hlf + 1]);
        }
      }
    }
  }
  // dq, from the f32 sums
  for (int qt = warp; qt < nt; qt += WARPS) {
    const float* tile = DQ + (size_t)qt * (16 * HD) + lane;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf)
        ptt::store2(dqb + (size_t)(qt * 16 + g + 8 * hlf) * D3 + c,
                    tile[(4 * j + 2 * hlf) * 32],
                    tile[(4 * j + 2 * hlf + 1) * 32]);
    }
  }
}

}  // namespace

extern "C" {

// x [B, S, D] bf16 -> out [B, S, D] bf16 (pre-residual).  wqkv_t [3D, D],
// wout_t [D, D] bf16, transposed ([out, in]; q rows of wqkv_t and q
// entries of bqkv pre-scaled); bqkv [3D], bout [D] f32.  Scratch: qkv
// [M, 3D] bf16, ao [M, D] bf16 (M = B*S).
int ptt_fab_fwd(const void* x, void* out, int B, int S, int D, int H,
                int valid_len, const void* wqkv_t, const void* bqkv,
                const void* wout_t, const void* bout, void* qkv, void* ao,
                void* stream) {
  namespace wg = ptt_wgmma;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  bf16* qkvb = (bf16*)qkv;
  bf16* aob = (bf16*)ao;
  const float* nores = nullptr;
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      (const bf16*)x, D, (const bf16*)wqkv_t, D, (const float*)bqkv, nores,
      0, qkvb, 3 * D, M, 3 * D, D, st)));
  PTT_TRY(ptt_flash::attention<false>(
      qkvb, (long long)S * 3 * D, 3 * D, S, qkvb + D, qkvb + 2 * D,
      (long long)S * 3 * D, 3 * D, aob, (long long)S * D, D, B, H, D / H,
      S, valid_len, 0.0f, st));
  return wg::gemm<wg::EPI_BIAS, float, bf16>(
      aob, D, (const bf16*)wout_t, D, (const float*)bout, nores, 0,
      (bf16*)out, D, M, D, D, st);
}

// The attention backward from the saved forward inputs: recompute
// qkv = bf16(x Wqkv' + b') (wqkv_t = Wqkv'^T, [3D, D], as the forward
// takes it), then dqkv [B, S, 3D] and A [B, S, D] (bf16) from da [B, S, D]
// bf16.  Scratch: qkv [M, 3D] bf16.
int ptt_fab_bwd(const void* x, const void* wqkv_t, const void* bqkv,
                const void* da, void* dqkv, void* a, int B, int S, int D,
                int H, int valid_len, void* qkv, void* stream) {
  namespace wg = ptt_wgmma;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  bf16* qkvb = (bf16*)qkv;
  const float* nores = nullptr;
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      (const bf16*)x, D, (const bf16*)wqkv_t, D, (const float*)bqkv, nores,
      0, qkvb, 3 * D, M, 3 * D, D, st)));
  auto run = [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem = bwd_smem(S, HD);
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_kernel<HD><<<dim3(H, B), THREADS, smem, st>>>(
        qkvb, (const bf16*)da, (bf16*)dqkv, (bf16*)a, S, D, valid_len);
    return (int)cudaGetLastError();
  };
  switch (D / H) {
    case 16: return run(std::integral_constant<int, 16>());
    case 32: return run(std::integral_constant<int, 32>());
    case 64: return run(std::integral_constant<int, 64>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
