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
//   * the backward recomputes qkv on the same GEMM, then, where one (head,
//     image)'s whole sequence fits a block's shared memory (the resident
//     path), runs one block of 4 warps per (head, image), in the shape of
//     FlashAttention-2's backward, on mma.sync with every score tile in
//     registers:
//     phase 1, the warps over query tiles of 16, is the forward's tile
//     (K and V in shared memory): p, o and the row sums, then A = bf16(o),
//     bf16(dn) into shared memory beside q, and bf16(dden);
//     phase 2, the warps over key tiles of 16, recomputes s^T and p^T once
//     for its keys against every query tile, and keeps dk and dv in
//     registers; dq of a query tile is ds k, the transpose of the ds^T
//     fragments taken in registers (movmatrix), added into an f32 [S, HD]
//     sum in shared memory over the space K and V held.  At each step the
//     warps take distinct query tiles (a diagonal), with a barrier
//     between steps, so dq's sums run in one order and two runs give the
//     same bits.  Shared memory is q, dn, K and V (or dq) of LD elements a
//     row and dden, 8 LD + 4 bytes a row: 107 KB at S 208 and head width
//     64, two blocks an SM.  Its instances stop at 64 (RESIDENT_MAX_HD):
//     at every width past it the streamed path measured faster on the
//     H100 (PERF.md section 6), and ViT-B/16 (64) keeps its bits;
//   * past that (S 592 at 64: ViT-L/14 @336; every S at widths 72 to
//     128, ViT-H/14's 80 among them), the streamed path, two launches with
//     no float atomics (so two runs give the same bits).  At [128, 592,
//     1,024] its 9 products of S^2 hd a head are 826 GFLOP (0.84 ms at the
//     bf16 peak) beside 476 GFLOP of qkv recompute: the tensor cores bound
//     it, and the work is to keep mma.sync fed; each pass is a block of
//     consumer warps and one producer warp that streams stages of 64 rows
//     with TMA into a ring of mbarrier'd stages (csrc/flash_tile.cuh's
//     4-D maps and layout: columns past hd and rows past valid_len read as
//     zero), so no consumer waits on a block barrier:
//     (a + c) a row pass of RowPass::NW query tiles a block (grid: passes
//     x heads x images, so that a (head, image)'s passes run side by side
//     and share its K and V in L2), K and V streamed through the tile's
//     ring twice: the first sweep is phase 1 (A = bf16(o); bf16(dn) into a
//     [B, S, D] scratch and bf16(dden) into an f32 [B, H, S] one, each
//     also kept in the warp's registers), the second computes s, p, dp
//     and ds again and sums dq = ds k over the key steps in registers,
//     each step's scores for RowPass::KS keys taken before its products so
//     that independent chains of mma overlap;
//     (b) a key pass of KeyPass::NW key tiles a block (grid: key blocks x
//     heads x images): the producer loads the block's K and V once, then
//     q, dn and dden of 64 query rows a stage; a warp reads its keys'
//     fragments from shared memory at each step (registers held for more
//     warps an SM) and takes KeyPass::QT query tiles a step: s^T, p^T,
//     dp^T and ds^T as in phase 2, dk and dv summed in registers.
//     The exp2 form has no running maximum, so a row's p needs nothing
//     from other key blocks, and dn and dden are all the key pass needs
//     of a row; the row pass and FlashAttention-2's separate dq pass are
//     one launch because dn and dden of a row are that block's own.  The
//     split computes s and dp once more than the resident path (9
//     products of S^2 hd a head against 6), the price of holding a few
//     stages of keys or queries in shared memory.  Every sum runs in the
//     order it ran in the resident and the cp.async streamed kernels
//     before them, so the outputs keep their bits; the streamed kernels
//     take the scores' 2^x on ex2.approx.ftz alone (ptt_flash::exp2_score).
// ptt_fab_bwd_plan gives the path; the library's callers ask it rather
// than size the blocks themselves.  Every head width that is a multiple
// of 8 up to 128 runs on the instance ptt_flash::tile_width (16 to 64 on
// either path, 80 to 128 streamed): a real width of HD - 8 runs
// on HD with its q, K, V and dn columns past it zero-filled (cp.async with
// source size 0 or TMA's out-of-bounds fill; a register fragment's words
// past it set to 0), which add exact zeros to every product, and only the
// real width of A, dq, dk and dv is stored.

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
// the most shared memory a block may use on the H100
constexpr size_t SMEM_MAX = 232448;
// the widest instance of the resident kernel
constexpr int RESIDENT_MAX_HD = 64;
// query rows a stage of the key pass's ring
constexpr int QB = 16 * WARPS;

using ptt_flash::Layout;
using ptt_flash::ldmatrix_x4;
using ptt_flash::ldmatrix_x4_trans;
using ptt_flash::mma_bf16;
using ptt_flash::pack_bf16;
using ptt_flash::swz;

// the resident path: q, dn, then K and V (phase 1) or dq (phase 2) of LD
// elements a row, then dden: bytes
template <int HD>
inline size_t bwd_smem(int S) {
  return (size_t)S * (4 * Layout<HD>::LD * sizeof(bf16) + sizeof(float));
}

// whether row 13 streams at instance width HD and padded S
template <int HD>
inline bool bwd_streamed(int S) {
  return HD > RESIDENT_MAX_HD || bwd_smem<HD>(S) > SMEM_MAX;
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

// A warp's keys k0 .. k0 + 15 of a head (zero past valid_len and past the
// real width hd): k and v as the A fragments of s^T = k q^T and dp^T =
// v dn^T, read from device memory (row stride D3)
template <int HD>
__device__ __forceinline__ void load_key_frags(uint32_t (&ka)[HD / 16][4],
                                               uint32_t (&va)[HD / 16][4],
                                               const bf16* __restrict__ kb,
                                               const bf16* __restrict__ vb,
                                               int D3, int k0, int valid_len,
                                               int hd, int g, int t) {
  auto word = [&](const bf16* base, int r, int c) -> uint32_t {
    return r < valid_len && c < hd
               ? *reinterpret_cast<const uint32_t*>(&base[(size_t)r * D3 + c])
               : 0u;
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
}

// A warp's 16 keys as the A fragments of s^T = k q^T (k) and dp^T = v
// dn^T (v), step kk of 16 columns: KeyRegs holds them in registers (the
// resident path), KeySmem reads them from shared memory with ldmatrix
// each time (the key pass: rows r0 .. r0 + 15 of K and V stages in layout
// Lay), which keeps a thread's registers to what more warps an SM allow.
template <int HD>
struct KeyRegs {
  const uint32_t (&ka)[HD / 16][4];
  const uint32_t (&va)[HD / 16][4];
  __device__ __forceinline__ void k(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ka[kk][i];
  }
  __device__ __forceinline__ void v(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = va[kk][i];
  }
};

template <int HD, class Lay>
struct KeySmem {
  const bf16* Kb;
  const bf16* Vb;
  int r0, lane;
  __device__ __forceinline__ void k(int kk, uint32_t (&a)[4]) const {
    ldmatrix_x4(a, &Kb[Lay::off(r0, lane & 15, kk, lane >> 4)]);
  }
  __device__ __forceinline__ void v(int kk, uint32_t (&a)[4]) const {
    ldmatrix_x4(a, &Vb[Lay::off(r0, lane & 15, kk, lane >> 4)]);
  }
};

// QT query tiles q0 .. q0 + 16 QT - 1 (rows of Qs, DNs and dd) against a
// warp's keys k0 .. k0 + 15: s^T = k q^T, p^T = bf16(exp2(clip(s^T))) (0
// at pad keys), dp = dn v^T + dden at valid keys, ds^T = bf16(s < 80 ?
// (ln2 dp) p : 0); dv += p^T dn, dk += ds^T q.  The scores of all QT
// tiles come first (2 QT independent product chains), then the dv and dk
// products a tile at a time in query order, so each sum runs in the order
// of QT 1.  Returns ds^T as A fragments (rows = keys) in dsa.
template <int HD, class Lay = ptt_flash::Swz<HD>, int QT = 1,
          bool RAW = false, class Keys>
__device__ __forceinline__ void key_tile_step(
    const Keys& keys,
    float (&dk)[HD / 8][4], float (&dv)[HD / 8][4], const bf16* Qs,
    const bf16* DNs, const float* dd, int q0, int k0, int valid_len,
    int lane, uint32_t (&dsa)[QT][4]) {
  const int g = lane >> 2, t = lane & 3;
  // s^T: sacc[u][j][e] at key k0 + g + 8(e/2), query q0 + 16u + 8j + 2t +
  // e%2
  float sacc[QT][2][4], dpacc[QT][2][4];
#pragma unroll
  for (int u = 0; u < QT; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[u][j][e] = dpacc[u][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t ka[4], va[4];
    keys.k(kk, ka);
    keys.v(kk, va);
#pragma unroll
    for (int u = 0; u < QT; ++u) {
      const int lr = (lane & 7) + ((lane >> 4) << 3);
      uint32_t qf[4], nf[4];
      ldmatrix_x4(qf, &Qs[Lay::off(q0 + 16 * u, lr, kk, (lane >> 3) & 1)]);
      mma_bf16(sacc[u][0], ka, qf[0], qf[1]);
      mma_bf16(sacc[u][1], ka, qf[2], qf[3]);
      // dp^T = v dn^T
      ldmatrix_x4(nf, &DNs[Lay::off(q0 + 16 * u, lr, kk, (lane >> 3) & 1)]);
      mma_bf16(dpacc[u][0], va, nf[0], nf[1]);
      mma_bf16(dpacc[u][1], va, nf[2], nf[3]);
    }
  }
  uint32_t pa[QT][4];
#pragma unroll
  for (int u = 0; u < QT; ++u) {
    float p[2][4], ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key = k0 + g + 8 * (e >> 1) < valid_len;
        const float sv = sacc[u][j][e];
        p[j][e] = key ? round_bf16(ptt_flash::exp2_score<RAW>(sv)) : 0.0f;
        const float dp =
            key ? dpacc[u][j][e] + dd[q0 + 16 * u + 8 * j + 2 * t + (e & 1)]
                : 0.0f;
        ds[j][e] = sv < HI ? (LN2 * dp) * p[j][e] : 0.0f;
      }
    pa[u][0] = pack_bf16(p[0][0], p[0][1]);
    pa[u][1] = pack_bf16(p[0][2], p[0][3]);
    pa[u][2] = pack_bf16(p[1][0], p[1][1]);
    pa[u][3] = pack_bf16(p[1][2], p[1][3]);
    dsa[u][0] = pack_bf16(ds[0][0], ds[0][1]);
    dsa[u][1] = pack_bf16(ds[0][2], ds[0][3]);
    dsa[u][2] = pack_bf16(ds[1][0], ds[1][1]);
    dsa[u][3] = pack_bf16(ds[1][2], ds[1][3]);
  }
#pragma unroll
  for (int u = 0; u < QT; ++u)
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      const int lr = (lane & 7) + (((lane >> 3) & 1) << 3);
      uint32_t nf[4], qf[4];
      // dv += p^T dn
      ldmatrix_x4_trans(nf, &DNs[Lay::off(q0 + 16 * u, lr, jj, lane >> 4)]);
      mma_bf16(dv[2 * jj], pa[u], nf[0], nf[1]);
      mma_bf16(dv[2 * jj + 1], pa[u], nf[2], nf[3]);
      // dk += ds^T q
      ldmatrix_x4_trans(qf, &Qs[Lay::off(q0 + 16 * u, lr, jj, lane >> 4)]);
      mma_bf16(dk[2 * jj], dsa[u], qf[0], qf[1]);
      mma_bf16(dk[2 * jj + 1], dsa[u], qf[2], qf[3]);
    }
}

// dk and dv of a warp's keys k0 + g and k0 + g + 8, their first hd columns
template <int HD>
__device__ __forceinline__ void store_dkv(bf16* __restrict__ dqb, int D,
                                          const float (&dk)[HD / 8][4],
                                          const float (&dv)[HD / 8][4],
                                          int k0, int hd, int g, int t) {
  const int D3 = 3 * D;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j == HD / 8 - 1 && hd < HD) break;   // the last 8 columns, past hd
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const size_t o = (size_t)(k0 + g + 8 * hlf) * D3 + c;
      ptt::store2(dqb + D + o, dk[j][2 * hlf], dk[j][2 * hlf + 1]);
      ptt::store2(dqb + 2 * D + o, dv[j][2 * hlf], dv[j][2 * hlf + 1]);
    }
  }
}

// The resident path.  One (head, image) at real head width hd (HD or
// HD - 8): writes A [B, S, D] and dq, dk, dv into dqkv [B, S, 3D] (bf16)
// from qkv [B, S, 3D] and da [B, S, D].  S is a multiple of 16.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                    bf16* __restrict__ dqkv, bf16* __restrict__ a, int S,
                    int D, int valid_len, int hd) {
  static_assert(HD <= RESIDENT_MAX_HD, "a resident instance");
  constexpr int LD = Layout<HD>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* DNs = Qs + (size_t)S * LD;
  bf16* Ks = DNs + (size_t)S * LD;
  bf16* Vs = Ks + (size_t)S * LD;
  float* DQ = reinterpret_cast<float*>(Ks);     // phase 2, over K and V
  float* dden = reinterpret_cast<float*>(Vs + (size_t)S * LD);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D3 = 3 * D, nt = S / 16;
  const bool full = hd == HD;              // else the last 8 columns are 0
  const bf16* qb = qkv + (size_t)b * S * D3 + h * hd;
  const bf16* kb = qb + D;
  const bf16* vb = qb + 2 * D;
  const bf16* dab = da + (size_t)b * S * D + h * hd;
  bf16* ab = a + (size_t)b * S * D + h * hd;
  bf16* dqb = dqkv + (size_t)b * S * D3 + h * hd;

  // q of every row; K and V zero past valid_len, as the forward's tile;
  // chunks past hd zero
  constexpr int CH = HD / 8;             // 16-byte chunks a row
  for (int c = tid; c < S * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool col = ch * 8 < hd;
    const bool ok = col && r < valid_len;
    ptt::cp_async16(&Qs[swz<HD>(r, ch)], col ? qb + (size_t)r * D3 + ch * 8 : qb,
                    col);
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
      const bool in = j < HD / 8 - 1 || full;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int r = rows[hlf];
        uint32_t w = 0u;                 // dn past hd is 0
        if (in) {
          const float den = lacc[2 * hlf];
          const float o0 = __fdiv_rn(oacc[j][2 * hlf], den);
          const float o1 = __fdiv_rn(oacc[j][2 * hlf + 1], den);
          ptt::store2(ab + (size_t)r * D + c, o0, o1);
          const float2 dv2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dab[(size_t)r * D + c]));
          dot[hlf] += dv2.x * o0;
          dot[hlf] += dv2.y * o1;
          w = pack_bf16(__fdiv_rn(dv2.x, den), __fdiv_rn(dv2.y, den));
        }
        *reinterpret_cast<uint32_t*>(&DNs[swz<HD>(r, j) + 2 * t]) = w;
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
  // [HD / 2 values][32 lanes] in the mma accumulator layout (S x HD floats
  // within the 2 x S x LD bf16 of K and V)
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
      load_key_frags<HD>(ka, va, kb, vb, D3, k0, valid_len, hd, g, t);
      auto val = [&](int r, int c) -> bf16 {
        return r < valid_len && c < hd ? kb[(size_t)r * D3 + c]
                                       : __float2bfloat16(0.0f);
      };
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
        uint32_t dsa[1][4];
        key_tile_step<HD>(KeyRegs<HD>{ka, va}, dk, dv, Qs, DNs, dden, q0, k0,
                          valid_len, lane, dsa);
        // dq[q0 .. q0 + 15] += ds k, ds = (ds^T)^T as an A fragment
        const uint32_t dsq[4] = {movmatrix_trans(dsa[0][0]),
                                 movmatrix_trans(dsa[0][2]),
                                 movmatrix_trans(dsa[0][1]),
                                 movmatrix_trans(dsa[0][3])};
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
    if (active) store_dkv<HD>(dqb, D, dk, dv, k0, hd, g, t);
  }
  // dq, from the f32 sums
  for (int qt = warp; qt < nt; qt += WARPS) {
    const float* tile = DQ + (size_t)qt * (16 * HD) + lane;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j == HD / 8 - 1 && !full) break;
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf)
        ptt::store2(dqb + (size_t)(qt * 16 + g + 8 * hlf) * D3 + c,
                    tile[(4 * j + 2 * hlf) * 32],
                    tile[(4 * j + 2 * hlf + 1) * 32]);
    }
  }
}

// The streamed pair's blocks.  The row pass: NW consumer warps of one
// 16-row query tile each (a pass of 16 NW rows) over the tile's K/V ring
// (ptt_flash::Stream<HD>'s stages), KS keys a step.  The key pass: NW
// consumer warps of one 16-key tile each, QT query tiles a step, over a
// ring of STAGES stages of QB query rows (q and dn in the tile's TMA
// layout, then their dden).  Each block has one producer warp after its
// consumers, and MINB blocks an SM bound its registers.
template <int HD>
struct RowPass {
  static constexpr int NW = 4;
  static constexpr int KS = HD <= 80 ? 32 : 16;
  static constexpr int MINB = HD <= 80 ? 3 : 2;
  static constexpr int THREADS = 32 * (NW + 1);
};

template <int HD>
struct KeyPass {
  using Rows = ptt_flash::TmaRows<HD, QB>;
  static constexpr int NW = 4;
  static constexpr int QT = 2;
  static constexpr int MINB = 2;
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 32 * (NW + 1);
  static constexpr int STAGE = QB * HD;           // elements of q (or dn)
  static constexpr uint32_t STAGE_BYTES =
      2 * STAGE * sizeof(bf16) + QB * sizeof(float);
  // the block's keys, in blocks of QB rows of K and of V
  static constexpr int KBLOCKS = (16 * NW + QB - 1) / QB;
  static constexpr uint32_t KV_BYTES = 2 * KBLOCKS * STAGE * sizeof(bf16);
  // K and V, then q stages, dn stages, dden stages (1,024-byte aligned by
  // hand), then the full and empty barriers and the keys' barrier
  static constexpr size_t SMEM = 1024 + KV_BYTES +
                                 (size_t)STAGES * STAGE_BYTES +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
};

// Sweep 2 of the row pass, KS keys (a multiple of 16) of a warp's query
// tile: s = q k^T and dp = dn v^T for every key first (2 KS/16
// independent product chains), then ds and dq += ds k 16 keys at a time in
// key order, so dq sums in the order of KS 16.  The keys n..n+KS-1 are
// rows r..r+KS-1 of the ring stage Kst / Vst (layout Lay).  MASK: some of
// them may be at or past valid_len (else none is, and nothing is tested).
template <int HD, int KS, class Lay, bool MASK>
__device__ __forceinline__ void dq_step(const uint32_t (&qa)[HD / 16][4],
                                        const uint32_t (&dna)[HD / 16][4],
                                        const float (&drow)[2],
                                        float (&dq)[HD / 8][4],
                                        const bf16* Kst, const bf16* Vst,
                                        int n, int r, int valid_len,
                                        int lane) {
  constexpr int U = KS / 16;
  const int t = lane & 3;
  // s and dp: [u][j][e] at row g + 8(e/2), key n + 16u + 8j + 2t + e%2
  float sacc[U][2][4], dpacc[U][2][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[u][j][e] = dpacc[u][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int lr = (lane & 7) + ((lane >> 4) << 3);
      uint32_t kf[4], vf[4];
      ldmatrix_x4(kf, &Kst[Lay::off(r + 16 * u, lr, kk, (lane >> 3) & 1)]);
      mma_bf16(sacc[u][0], qa[kk], kf[0], kf[1]);
      mma_bf16(sacc[u][1], qa[kk], kf[2], kf[3]);
      ldmatrix_x4(vf, &Vst[Lay::off(r + 16 * u, lr, kk, (lane >> 3) & 1)]);
      mma_bf16(dpacc[u][0], dna[kk], vf[0], vf[1]);
      mma_bf16(dpacc[u][1], dna[kk], vf[2], vf[3]);
    }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key =
            !MASK || n + 16 * u + 8 * j + 2 * t + (e & 1) < valid_len;
        const float sv = sacc[u][j][e];
        const float p =
            key ? round_bf16(ptt_flash::exp2_score<true>(sv)) : 0.0f;
        const float dp = key ? dpacc[u][j][e] + drow[e >> 1] : 0.0f;
        ds[j][e] = sv < HI ? (LN2 * dp) * p : 0.0f;
      }
    const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]),
                             pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]),
                             pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t kf[4];
      ldmatrix_x4_trans(
          kf, &Kst[Lay::off(r + 16 * u, (lane & 7) + (((lane >> 3) & 1) << 3),
                            jj, lane >> 4)]);
      mma_bf16(dq[2 * jj], dsa, kf[0], kf[1]);
      mma_bf16(dq[2 * jj + 1], dsa, kf[2], kf[3]);
    }
  }
}

// The streamed path, (a + c): one pass of RowPass<HD>::NW query tiles of one
// (head h, image b), a tile a warp (grid: passes x heads x images, so that
// a (head, image)'s passes run side by side and share its K and V in L2).
// The producer warp streams K and V through the tile's TMA ring twice
// (csrc/flash_tile.cuh, produce_kv).  Sweep 1 is phase 1: A, and dn and
// dden into their scratch ([B, S, D] bf16, [B, H, S] f32) and the warp's
// registers; sweep 2 computes dq = ds k, summed in registers over the key
// steps in order.
template <int HD>
__global__ void __launch_bounds__(RowPass<HD>::THREADS, RowPass<HD>::MINB)
    attn_bwd_rows(const __grid_constant__ ptt_flash::PartMaps kmaps,
                  const __grid_constant__ ptt_flash::PartMaps vmaps,
                  const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                  bf16* __restrict__ dqkv, bf16* __restrict__ a,
                  bf16* __restrict__ dn, float* __restrict__ dden, int S,
                  int D, int valid_len, int hd) {
  using SL = ptt_flash::Stream<HD>;
  using Lay = typename SL::Rows;
  constexpr int KB = ptt_flash::STREAM_KB, NW = RowPass<HD>::NW;
  constexpr int KS = RowPass<HD>::KS;
  extern __shared__ unsigned char smem_raw[];
  bf16 *Ks, *Vs;
  uint64_t *full, *empty;
  ptt_flash::ring_init<HD>(smem_raw, Ks, Vs, full, empty, NW);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks = (S + KB - 1) / KB;
  if (warp == NW) {
    if (lane == 0)
      ptt_flash::produce_kv<HD>(kmaps, vmaps, Ks, Vs, full, empty, h, b,
                                blocks, 2 * blocks);
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int D3 = 3 * D;
  const int r0 = (blockIdx.x * NW + warp) * 16 + g, r1 = r0 + 8;
  const bool active = r0 - g < S;
  const bool full_width = hd == HD;
  const bf16* qb = qkv + (size_t)b * S * D3 + h * hd;
  const bf16* dab = da + (size_t)b * S * D + h * hd;
  bf16* ab = a + (size_t)b * S * D + h * hd;
  bf16* dnb = dn + (size_t)b * S * D + h * hd;
  float* ddb = dden + ((size_t)b * H + h) * S;
  bf16* dqb = dqkv + (size_t)b * S * D3 + h * hd;

  uint32_t qa[HD / 16][4];
  ptt_flash::load_q<HD, false>(qa, qb, D3, r0, S, hd, 0.0f, t);
  float oacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.0f;
  float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // ---- sweep 1: the forward, as the tile's streamed pass (ring steps
  // 0 .. blocks - 1)
  for (int i = 0; i < blocks; ++i) {
    const int s = i % SL::STAGES;
    ptt_wgmma::mbar_wait(&full[s], (i / SL::STAGES) & 1);
    if (active) {
      const bf16* Kst = Ks + s * SL::STAGE;
      const bf16* Vst = Vs + s * SL::STAGE;
      const int n0 = i * KB, n1 = min(S, n0 + KB);
      int n = n0;
      for (; n + KS <= n1; n += KS)
        ptt_flash::key_step<HD, Lay, KS, true>(qa, oacc, lacc, Kst, Vst, n,
                                               n - n0, valid_len, lane);
      for (; n < n1; n += 16)        // a last block of fewer keys
        ptt_flash::key_step<HD, Lay, 16, true>(qa, oacc, lacc, Kst, Vst, n,
                                               n - n0, valid_len, lane);
    }
    __syncwarp();
    if (lane == 0) ptt_wgmma::mbar_arrive(&empty[s]);
  }

  // A, dn and dden of rows r0 (den lacc[0]) and r1 (den lacc[2]), in the
  // resident path's order; dn kept as the A fragments of dp = dn v^T
  uint32_t dna[HD / 16][4];
  float drow[2] = {0.0f, 0.0f};
  if (active) {
    const int rows[2] = {r0, r1};
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const bool in = j < HD / 8 - 1 || full_width;
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int r = rows[hlf];
        uint32_t w = 0u;
        if (in) {
          const float den = lacc[2 * hlf];
          const float o0 = __fdiv_rn(oacc[j][2 * hlf], den);
          const float o1 = __fdiv_rn(oacc[j][2 * hlf + 1], den);
          ptt::store2(ab + (size_t)r * D + c, o0, o1);
          const float2 dv2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dab[(size_t)r * D + c]));
          dot[hlf] += dv2.x * o0;
          dot[hlf] += dv2.y * o1;
          w = pack_bf16(__fdiv_rn(dv2.x, den), __fdiv_rn(dv2.y, den));
          *reinterpret_cast<uint32_t*>(&dnb[(size_t)r * D + c]) = w;
        }
        dna[j / 2][(j & 1) * 2 + hlf] = w;
      }
    }
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      dot[hlf] += __shfl_xor_sync(0xffffffffu, dot[hlf], 1);
      dot[hlf] += __shfl_xor_sync(0xffffffffu, dot[hlf], 2);
      drow[hlf] = round_bf16(__fdiv_rn(-dot[hlf], lacc[2 * hlf]));
      if (t == 0) ddb[rows[hlf]] = drow[hlf];
    }
  }

  // ---- sweep 2: dq = ds k over the key blocks again (ring steps blocks
  // .. 2 blocks - 1)
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  for (int i = 0; i < blocks; ++i) {
    const int it = blocks + i, s = it % SL::STAGES;
    ptt_wgmma::mbar_wait(&full[s], (it / SL::STAGES) & 1);
    if (active) {
      const bf16* Kst = Ks + s * SL::STAGE;
      const bf16* Vst = Vs + s * SL::STAGE;
      const int n0 = i * KB, n1 = min(S, n0 + KB);
      int n = n0;
      for (; n + KS <= n1; n += KS)
        if (n + KS <= valid_len)     // every key valid: no mask
            dq_step<HD, KS, Lay, false>(qa, dna, drow, dq, Kst, Vst, n, n - n0,
                                      valid_len, lane);
        else
          dq_step<HD, KS, Lay, true>(qa, dna, drow, dq, Kst, Vst, n, n - n0,
                                     valid_len, lane);
      for (; n < n1; n += 16)        // a last block of fewer keys
        dq_step<HD, 16, Lay, true>(qa, dna, drow, dq, Kst, Vst, n, n - n0,
                                   valid_len, lane);
    }
    __syncwarp();
    if (lane == 0) ptt_wgmma::mbar_arrive(&empty[s]);
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (j == HD / 8 - 1 && !full_width) break;
      const int c = 8 * j + 2 * t;
      ptt::store2(dqb + (size_t)r0 * D3 + c, dq[j][0], dq[j][1]);
      ptt::store2(dqb + (size_t)r1 * D3 + c, dq[j][2], dq[j][3]);
    }
  }
}

// The streamed path, (b): one block of KeyPass<HD>::NW key tiles of one
// (head h, image b), a tile a warp (grid: key blocks x heads x images).
// The producer warp loads the block's K and V once (TMA, the row pass's
// maps: zero past valid_len and past hd), then streams q and dn of QB
// query rows a stage and the rows' dden through a ring of STAGES stages
// (q and dn in the tile's TMA layout, their columns past hd read as zero;
// dden a 2-D map over [B H, S]), the query tiles in order; a warp reads
// its keys' fragments from shared memory at each step and sums dk and dv
// in registers.
template <int HD>
__global__ void __launch_bounds__(KeyPass<HD>::THREADS, KeyPass<HD>::MINB)
    attn_bwd_keys(const __grid_constant__ ptt_flash::PartMaps kmaps,
                  const __grid_constant__ ptt_flash::PartMaps vmaps,
                  const __grid_constant__ ptt_flash::PartMaps qmaps,
                  const __grid_constant__ ptt_flash::PartMaps dnmaps,
                  const __grid_constant__ CUtensorMap ddmap,
                  bf16* __restrict__ dqkv, int S, int D, int valid_len,
                  int hd) {
  using KP = KeyPass<HD>;
  using Lay = typename KP::Rows;
  constexpr int NW = KP::NW, STAGES = KP::STAGES, QT = KP::QT;
  extern __shared__ unsigned char smem_raw[];
  bf16* Kb = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* Vb = Kb + KP::KBLOCKS * KP::STAGE;
  bf16* Qs = Vb + KP::KBLOCKS * KP::STAGE;
  bf16* DNs = Qs + STAGES * KP::STAGE;
  float* dds = reinterpret_cast<float*>(DNs + STAGES * KP::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(dds + STAGES * QB);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      ptt_wgmma::mbar_init(&full[s], 1);
      ptt_wgmma::mbar_init(&empty[s], NW);
    }
    ptt_wgmma::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages = (S + QB - 1) / QB;
  const int kb0 = blockIdx.x * 16 * NW;      // the block's first key
  if (warp == NW) {
    if (lane == 0) {
      ptt_wgmma::mbar_expect_tx(kvbar, KP::KV_BYTES);
#pragma unroll
      for (int j = 0; j < KP::KBLOCKS; ++j) {
        ptt_flash::load_rows<HD, QB>(Kb + j * KP::STAGE, kmaps, kvbar, h,
                                     kb0 + j * QB, b);
        ptt_flash::load_rows<HD, QB>(Vb + j * KP::STAGE, vmaps, kvbar, h,
                                     kb0 + j * QB, b);
      }
      for (int i = 0; i < stages; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) ptt_wgmma::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        ptt_wgmma::mbar_expect_tx(&full[s], KP::STAGE_BYTES);
        ptt_flash::load_rows<HD, QB>(Qs + s * KP::STAGE, qmaps, &full[s], h,
                                     i * QB, b);
        ptt_flash::load_rows<HD, QB>(DNs + s * KP::STAGE, dnmaps, &full[s],
                                     h, i * QB, b);
        ptt_wgmma::tma_load(dds + s * QB, &ddmap, &full[s], i * QB,
                            b * H + h);
      }
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int D3 = 3 * D;
  const int k0 = kb0 + warp * 16;
  const bool active = k0 < S;
  bf16* dqb = dqkv + (size_t)b * S * D3 + h * hd;
  // this warp's keys: rows k0 % QB .. + 15 of key block warp * 16 / QB
  const int kblk = warp * 16 / QB * KP::STAGE;
  const KeySmem<HD, Lay> keys{Kb + kblk, Vb + kblk, warp * 16 % QB, lane};

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  ptt_wgmma::mbar_wait(kvbar, 0);
  for (int i = 0; i < stages; ++i) {
    const int s = i % STAGES;
    ptt_wgmma::mbar_wait(&full[s], (i / STAGES) & 1);
    if (active) {
      const bf16* Qst = Qs + s * KP::STAGE;
      const bf16* DNst = DNs + s * KP::STAGE;
      const float* dd = dds + s * QB;
      const int n = min(QB, S - i * QB);
      int q0 = 0;
      for (; q0 + 16 * QT <= n; q0 += 16 * QT) {
        uint32_t dsa[QT][4];
        key_tile_step<HD, Lay, QT, true>(keys, dk, dv, Qst, DNst, dd, q0,
                                         k0, valid_len, lane, dsa);
      }
      for (; q0 < n; q0 += 16) {     // a last stage of fewer rows
        uint32_t dsa[1][4];
        key_tile_step<HD, Lay, 1, true>(keys, dk, dv, Qst, DNst, dd, q0, k0,
                                        valid_len, lane, dsa);
      }
    }
    __syncwarp();
    if (lane == 0) ptt_wgmma::mbar_arrive(&empty[s]);
  }
  if (active) store_dkv<HD>(dqb, D, dk, dv, k0, hd, g, t);
}

// the key pass's map of dden [B H, S] f32: boxes of QB values of one row
inline bool dden_map(CUtensorMap* map, const float* dden, int rows, int S) {
  ptt_wgmma::EncodeTiled encode = ptt_wgmma::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)S * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)QB, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)dden, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One backward at instance width HD: the resident kernel where
// bwd_streamed is false, else the row pass then the key pass (dn, dden:
// their scratch)
template <int HD>
int attention_bwd(const bf16* qkv, const bf16* da, bf16* dqkv, bf16* a,
                  bf16* dn, float* dden, int B, int S, int D, int H,
                  int valid_len, int hd, cudaStream_t st) {
  if constexpr (HD <= RESIDENT_MAX_HD) {
    if (!bwd_streamed<HD>(S)) {
      const size_t smem = bwd_smem<HD>(S);
      const cudaError_t err = cudaFuncSetAttribute(
          attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      attn_bwd_kernel<HD><<<dim3(H, B), THREADS, smem, st>>>(
          qkv, da, dqkv, a, S, D, valid_len, hd);
      return (int)cudaGetLastError();
    }
  }
  if (dn == nullptr || dden == nullptr) return (int)cudaErrorInvalidValue;
  using SL = ptt_flash::Stream<HD>;
  using RP = RowPass<HD>;
  using KP = KeyPass<HD>;
  const long long img = (long long)S * 3 * D;
  ptt_flash::PartMaps kmaps, vmaps, qmaps, dnmaps;
  CUtensorMap ddmap;
  if (!ptt_flash::part_maps<HD, ptt_flash::STREAM_KB>(
          &kmaps, qkv + D, hd, H, valid_len, B, 3 * D, img) ||
      !ptt_flash::part_maps<HD, ptt_flash::STREAM_KB>(
          &vmaps, qkv + 2 * D, hd, H, valid_len, B, 3 * D, img) ||
      !ptt_flash::part_maps<HD, QB>(&qmaps, qkv, hd, H, S, B, 3 * D, img) ||
      !ptt_flash::part_maps<HD, QB>(&dnmaps, dn, hd, H, S, B, D,
                                    (long long)S * D) ||
      !dden_map(&ddmap, dden, B * H, S))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SL::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_keys<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KP::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int passes = (S + 16 * RP::NW - 1) / (16 * RP::NW);
  attn_bwd_rows<HD><<<dim3(passes, H, B), RP::THREADS, SL::SMEM, st>>>(
      kmaps, vmaps, qkv, da, dqkv, a, dn, dden, S, D, valid_len, hd);
  PTT_CHECK();
  const int tiles = (S + 16 * KP::NW - 1) / (16 * KP::NW);
  attn_bwd_keys<HD><<<dim3(tiles, H, B), KP::THREADS, KP::SMEM, st>>>(
      kmaps, vmaps, qmaps, dnmaps, ddmap, dqkv, S, D, valid_len, hd);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, HD>()) at instance width HD, or
// `otherwise` where there is no instance
template <typename F>
int at_width(int width, int otherwise, F&& f) {
  switch (width) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return otherwise;
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

// Row 13's plan at padded S and head width hd: *streamed 0 for the
// resident kernel, 1 for the streamed pair (which needs ptt_fab_bwd's dn
// and dden scratch); *ring_keys the keys a stage of the streamed row
// pass's ring holds (Layout::KB).  cudaErrorInvalidValue for a width the
// contract does not take.
int ptt_fab_bwd_plan(int S, int hd, int* streamed, int* ring_keys) {
  return at_width(ptt_flash::tile_width(hd), (int)cudaErrorInvalidValue,
                  [&](auto w) {
                    constexpr int HD = decltype(w)::value;
                    *streamed = bwd_streamed<HD>(S) ? 1 : 0;
                    *ring_keys = ptt_flash::STREAM_KB;
                    return 0;
                  });
}

// The attention backward from the saved forward inputs: recompute
// qkv = bf16(x Wqkv' + b') (wqkv_t = Wqkv'^T, [3D, D], as the forward
// takes it), then dqkv [B, S, 3D] and A [B, S, D] (bf16) from da [B, S, D]
// bf16, at head width D / H (a multiple of 8 up to 128) on the instance
// ptt_flash::tile_width, on the path ptt_fab_bwd_plan names.  Scratch:
// qkv [M, 3D] bf16; on the streamed path also dn [B, S, D] bf16 and dden
// [B, H, S] f32 (else they may be null).
int ptt_fab_bwd(const void* x, const void* wqkv_t, const void* bqkv,
                const void* da, void* dqkv, void* a, int B, int S, int D,
                int H, int valid_len, void* qkv, void* dn, void* dden,
                void* stream) {
  namespace wg = ptt_wgmma;
  if (H < 1 || D % H || S % 16 || valid_len < 1 || valid_len > S)
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const int width = ptt_flash::tile_width(hd);
  if (width == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  bf16* qkvb = (bf16*)qkv;
  const float* nores = nullptr;
  PTT_TRY((wg::gemm<wg::EPI_BIAS, float, bf16>(
      (const bf16*)x, D, (const bf16*)wqkv_t, D, (const float*)bqkv, nores,
      0, qkvb, 3 * D, M, 3 * D, D, st)));
  return at_width(width, (int)cudaErrorInvalidValue, [&](auto w) {
    return attention_bwd<decltype(w)::value>(
        qkvb, (const bf16*)da, (bf16*)dqkv, (bf16*)a, (bf16*)dn,
        (float*)dden, B, S, D, H, valid_len, hd, st);
  });
}

}  // extern "C"
