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
// (projections 90%) and the backward's attention part ~43 GFLOP against
// ~330 MB of qkv, da, dqkv and A: the forward is bound by the tensor
// cores, the backward kernel by both about equally.  Design:
//   * the forward is the serving layer's Hopper parts (rows 1-2), three
//     launches: the QKV and out-projection GEMMs on csrc/wgmma_gemm.cuh
//     (TMA and wgmma, bias epilogue, bf16 out; the wrapper passes the
//     weights transposed, [out, in], as that GEMM reads them) around
//     csrc/flash_tile.cuh reading q, k, v as strided slices of qkv;
//   * the backward (right before fast, on csrc/gemm.cuh's wmma GEMM for
//     its qkv recompute) splits the two reductions of attention: kernel 1
//     runs one block per (query tile of 64, head, image), recomputes s,
//     p, o and writes A, dq and the row terms bf16(dn), bf16(dden);
//     kernel 2 runs one block per (key tile of 64, head, image),
//     recomputes s^T and p^T from q and k, and accumulates dk and dv over
//     every query in registers.  Nothing [S, S]-sized leaves shared
//     memory, and nothing is kept from the forward but its inputs.
//   * s is recomputed twice (once per kernel), a third of the backward's
//     products; a fused single pass with dk/dv in shared memory does not
//     fit 227 KB at S = 208 with 64-row tiles, and is later work.

#include "common.cuh"
#include "flash_tile.cuh"
#include "gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace nvcuda;
using ptt::bf16;

namespace {

constexpr int HD = ptt_flash::HD;            // 64
constexpr int T = 64;                        // query or key rows per block
constexpr int THREADS = 128;                 // 4 warps of 16 rows
constexpr int LD = HD + 8;
constexpr float LN2 = 0.69314718055994531f;
constexpr float LO = ptt_flash::SCORE_LO, HI = ptt_flash::SCORE_HI;

__host__ __device__ inline int s_ld(int S) { return S + 8; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [r0, r0 + n) of a [.., 64] head slice (row stride `row`) into a
// shared [n][LD] tile; rows at or past `lim` are zero
__device__ inline void load_rows(bf16* dst, const bf16* src, int row, int r0,
                                 int n, int lim, int tid) {
  for (int c = tid; c < n * (HD / 8); c += THREADS) {
    const int r = c >> 3, cc = (c & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < lim)
      v = *reinterpret_cast<const uint4*>(&src[(size_t)(r0 + r) * row + cc]);
    *reinterpret_cast<uint4*>(&dst[r * LD + cc]) = v;
  }
}

inline size_t smem_q(int S) {
  return (2 * (size_t)S + 3 * T) * LD * sizeof(bf16)    // K, V, Q, dO, dN
         + (size_t)T * s_ld(S) * (sizeof(float) + sizeof(bf16))  // s, p/ds
         + (size_t)T * LD * sizeof(float)               // O, then dq
         + 4 * 256 * sizeof(float)                      // per-warp staging
         + 2 * T * sizeof(float);                       // den, dden
}

// Kernel 1: one (query tile, head, image).  Writes A and dq (bf16, in
// their [B, S, D] / [B, S, 3D] places) and the row terms dn [B, S, D]
// bf16, dden [B, H, S] (bf16 values held as f32).
__global__ void __launch_bounds__(THREADS)
    attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                      bf16* __restrict__ dqkv, bf16* __restrict__ a,
                      bf16* __restrict__ dn_out, float* __restrict__ dden_out,
                      int S, int D, int H, int valid_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sld = s_ld(S);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * LD;
  bf16* Qs = Vs + (size_t)S * LD;
  bf16* DOs = Qs + T * LD;
  bf16* DNs = DOs + T * LD;
  float* Ss = reinterpret_cast<float*>(DNs + T * LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + (size_t)T * sld);
  float* Os = reinterpret_cast<float*>(Ps + (size_t)T * sld);
  float* stage = Os + T * LD;
  float* den = stage + 4 * 256;
  float* dden = den + T;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * T, D3 = 3 * D;
  const bf16* base = qkv + (size_t)b * S * D3 + h * HD;
  load_rows(Ks, base + D, D3, 0, S, S, tid);
  load_rows(Vs, base + 2 * D, D3, 0, S, S, tid);
  load_rows(Qs, base, D3, q0, T, S, tid);
  load_rows(DOs, da + (size_t)b * S * D + h * HD, D, q0, T, S, tid);
  __syncthreads();

  const int r0 = warp * 16;
  // s = q k^T
  for (int n = 0; n < S; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA qa;
      FragBc kb;
      wmma::load_matrix_sync(qa, &Qs[r0 * LD + kk], LD);
      wmma::load_matrix_sync(kb, &Ks[n * LD + kk], LD);
      wmma::mma_sync(acc, qa, kb, acc);
    }
    wmma::store_matrix_sync(&Ss[r0 * sld + n], acc, sld, wmma::mem_row_major);
  }
  __syncwarp();
  // p = bf16(exp2(clip(s))), 0 at pad keys; den = sum of the rounded p
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32) {
      float p = 0.0f;
      if (c < valid_len) p = exp2f(fminf(fmaxf(Ss[r * sld + c], LO), HI));
      const bf16 pb = __float2bfloat16(p);
      Ps[r * sld + c] = pb;
      sum += __bfloat162float(pb);
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) den[r] = sum;
  }
  __syncwarp();
  // O = p v
  {
    FragC acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < S; kk += 16) {
      FragA pa;
      wmma::load_matrix_sync(pa, &Ps[r0 * sld + kk], sld);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        FragBr vb;
        wmma::load_matrix_sync(vb, &Vs[kk * LD + j * 16], LD);
        wmma::mma_sync(acc[j], pa, vb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::store_matrix_sync(&Os[r0 * LD + j * 16], acc[j], LD,
                              wmma::mem_row_major);
  }
  __syncwarp();
  // o = O / den -> A; dn = do / den; dden = -sum(do o) / den
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qr = q0 + r;
    const float dr = den[r];
    float dot = 0.0f;
    for (int c = lane; c < HD; c += 32) {
      const float o = __fdiv_rn(Os[r * LD + c], dr);
      const float dov = __bfloat162float(DOs[r * LD + c]);
      dot += dov * o;
      const bf16 dnb = __float2bfloat16(__fdiv_rn(dov, dr));
      DNs[r * LD + c] = dnb;
      if (qr < S) {
        a[((size_t)b * S + qr) * D + h * HD + c] = __float2bfloat16(o);
        dn_out[((size_t)b * S + qr) * D + h * HD + c] = dnb;
      }
    }
    dot = ptt::warp_sum(dot);
    const float dd = __bfloat162float(__float2bfloat16(__fdiv_rn(-dot, dr)));
    if (lane == 0) {
      dden[r] = dd;
      if (qr < S) dden_out[((size_t)b * H + h) * S + qr] = dd;
    }
  }
  __syncwarp();
  // dp = bf16(dn) v^T + dden valid; ds = bf16(s < 80 ? ln2 dp p : 0),
  // written over p
  float* st = stage + warp * 256;
  for (int n = 0; n < S; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA na;
      FragBc vb;
      wmma::load_matrix_sync(na, &DNs[r0 * LD + kk], LD);
      wmma::load_matrix_sync(vb, &Vs[n * LD + kk], LD);
      wmma::mma_sync(acc, na, vb, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + (e >> 4), c = n + (e & 15);
      const bool valid = c < valid_len;
      const float dp = valid ? st[e] + dden[r] : 0.0f;
      const float s = Ss[r * sld + c];
      const float p = __bfloat162float(Ps[r * sld + c]);
      Ps[r * sld + c] = __float2bfloat16(s < HI ? (LN2 * dp) * p : 0.0f);
    }
    __syncwarp();
  }
  // dq = ds k
  {
    FragC acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < S; kk += 16) {
      FragA da_;
      wmma::load_matrix_sync(da_, &Ps[r0 * sld + kk], sld);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        FragBr kb;
        wmma::load_matrix_sync(kb, &Ks[kk * LD + j * 16], LD);
        wmma::mma_sync(acc[j], da_, kb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wmma::store_matrix_sync(&Os[r0 * LD + j * 16], acc[j], LD,
                              wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = r0 + e / HD, c = e % HD, qr = q0 + r;
    if (qr < S)
      dqkv[((size_t)b * S + qr) * D3 + h * HD + c] =
          __float2bfloat16(Os[r * LD + c]);
  }
}

inline size_t smem_k(int S) {
  return (2 * (size_t)T + 2 * (size_t)S) * LD * sizeof(bf16)  // K, V tile; Q, dN
         + (size_t)T * s_ld(S) * (sizeof(float) + sizeof(bf16))  // s^T, p^T
         + 4 * 256 * sizeof(float)                              // staging
         + (size_t)S * sizeof(float);                           // dden
}

// Kernel 2: one (key tile, head, image).  Writes dk and dv into dqkv.
__global__ void __launch_bounds__(THREADS)
    attn_bwd_kv_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ dn_in,
                       const float* __restrict__ dden_in,
                       bf16* __restrict__ dqkv, int S, int D, int H,
                       int valid_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sld = s_ld(S);
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + T * LD;
  bf16* Qs = Vt + T * LD;
  bf16* DNs = Qs + (size_t)S * LD;
  float* St = reinterpret_cast<float*>(DNs + (size_t)S * LD);
  bf16* Pt = reinterpret_cast<bf16*>(St + (size_t)T * sld);
  float* stage = reinterpret_cast<float*>(Pt + (size_t)T * sld);
  float* dden = stage + 4 * 256;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = kt * T, D3 = 3 * D;
  const bf16* base = qkv + (size_t)b * S * D3 + h * HD;
  load_rows(Kt, base + D, D3, k0, T, S, tid);
  load_rows(Vt, base + 2 * D, D3, k0, T, S, tid);
  load_rows(Qs, base, D3, 0, S, S, tid);
  load_rows(DNs, dn_in + (size_t)b * S * D + h * HD, D, 0, S, S, tid);
  for (int i = tid; i < S; i += THREADS)
    dden[i] = dden_in[((size_t)b * H + h) * S + i];
  __syncthreads();

  const int r0 = warp * 16;            // this warp's 16 keys
  // s^T = k q^T; p^T = bf16(exp2(clip(s^T))), 0 for pad keys
  for (int n = 0; n < S; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA ka;
      FragBc qb;
      wmma::load_matrix_sync(ka, &Kt[r0 * LD + kk], LD);
      wmma::load_matrix_sync(qb, &Qs[n * LD + kk], LD);
      wmma::mma_sync(acc, ka, qb, acc);
    }
    wmma::store_matrix_sync(&St[r0 * sld + n], acc, sld, wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * S; e += 32) {
    const int r = r0 + e / S, c = e % S;
    const float p = k0 + r < valid_len
                        ? exp2f(fminf(fmaxf(St[r * sld + c], LO), HI))
                        : 0.0f;
    Pt[r * sld + c] = __float2bfloat16(p);
  }
  __syncwarp();
  bf16* out = dqkv + (size_t)b * S * D3 + h * HD;
  // dv = p^T bf16(dn)   (pad keys have p = 0: their dv is 0)
  {
    FragC acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < S; kk += 16) {
      FragA pa;
      wmma::load_matrix_sync(pa, &Pt[r0 * sld + kk], sld);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        FragBr nb;
        wmma::load_matrix_sync(nb, &DNs[kk * LD + j * 16], LD);
        wmma::mma_sync(acc[j], pa, nb, acc[j]);
      }
    }
    float* st = stage + warp * 256;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int key = k0 + r0 + (e >> 4), c = j * 16 + (e & 15);
        if (key < S)
          out[(size_t)key * D3 + 2 * D + c] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
  // dp^T = v bf16(dn)^T + dden valid; ds^T = bf16(s < 80 ? ln2 dp p : 0)
  float* st = stage + warp * 256;
  for (int n = 0; n < S; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA va;
      FragBc nb;
      wmma::load_matrix_sync(va, &Vt[r0 * LD + kk], LD);
      wmma::load_matrix_sync(nb, &DNs[n * LD + kk], LD);
      wmma::mma_sync(acc, va, nb, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + (e >> 4), c = n + (e & 15);
      const bool valid = k0 + r < valid_len;
      const float dp = valid ? st[e] + dden[c] : 0.0f;
      const float s = St[r * sld + c];
      const float p = __bfloat162float(Pt[r * sld + c]);
      Pt[r * sld + c] = __float2bfloat16(s < HI ? (LN2 * dp) * p : 0.0f);
    }
    __syncwarp();
  }
  // dk = ds^T q
  {
    FragC acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < S; kk += 16) {
      FragA dsa;
      wmma::load_matrix_sync(dsa, &Pt[r0 * sld + kk], sld);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        FragBr qb;
        wmma::load_matrix_sync(qb, &Qs[kk * LD + j * 16], LD);
        wmma::mma_sync(acc[j], dsa, qb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int key = k0 + r0 + (e >> 4), c = j * 16 + (e & 15);
        if (key < S) out[(size_t)key * D3 + D + c] = __float2bfloat16(st[e]);
      }
      __syncwarp();
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
      (long long)S * 3 * D, 3 * D, aob, (long long)S * D, D, B, H, S,
      valid_len, 0.0f, st));
  return wg::gemm<wg::EPI_BIAS, float, bf16>(
      aob, D, (const bf16*)wout_t, D, (const float*)bout, nores, 0,
      (bf16*)out, D, M, D, D, st);
}

// The attention backward from the saved forward inputs: recompute
// qkv = bf16(x Wqkv' + b'), then dqkv [B, S, 3D] and A [B, S, D] (bf16)
// from da [B, S, D] bf16.  Scratch: qkv [M, 3D] bf16, dn [M, D] bf16,
// dden [B, H, S] f32.
int ptt_fab_bwd(const void* x, const void* wqkv, const void* bqkv,
                const void* da, void* dqkv, void* a, int B, int S, int D,
                int H, int valid_len, void* qkv, void* dn, void* dden,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S;
  bf16* qkvb = (bf16*)qkv;
  const float* nores = nullptr;
  ptt_gemm::gemm<ptt_gemm::EPI_BIAS, float, bf16>(
      (const bf16*)x, D, (const bf16*)wqkv, 3 * D, (const float*)bqkv, nores,
      0, qkvb, 3 * D, M, 3 * D, D, st);
  PTT_CHECK();
  const size_t sq = smem_q(S), sk = smem_k(S);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      attn_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sk);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + T - 1) / T, H, B);
  attn_bwd_q_kernel<<<grid, THREADS, sq, st>>>(
      qkvb, (const bf16*)da, (bf16*)dqkv, (bf16*)a, (bf16*)dn, (float*)dden, S,
      D, H, valid_len);
  PTT_CHECK();
  attn_bwd_kv_kernel<<<grid, THREADS, sk, st>>>(
      qkvb, (const bf16*)dn, (const float*)dden, (bf16*)dqkv, S, D, H,
      valid_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
