// Standalone multi-head attention softmax(q k^T / sqrt(d)) v on projected
// q, k, v [B, S, H, 64] bf16 -> [B, S, H, 64] bf16, the `use_flash` tower's
// attention.
//
// Replaces the TPU kernels of patent_tpu/ops/flash_attention.py:
//   ptt_flash_attention   _attn_kernel (_flash_impl) and
//                         _attn_kernel_headbatch (_flash_impl_headbatch),
//                         public entry flash_attention: one function under
//                         two tilings
//
// The TPU kernel's function, per (image, head):
//   q' = bf16(f32(q) * scale * log2(e))      (scale = 1/sqrt(64))
//   p  = bf16(exp2(clip(q'.k, -100, 80))), keys >= S p = 0
//   o  = bf16((p v) / sum(p))                (f32 sums, an exact divide)
//
// What bounds it on the H100: at the tower's B 128, S 197, H 12 it moves
// 4 x 128 x 197 x 768 bf16 values (q, k, v read, o written; 155 MB, 46 us
// at 3.35 TB/s) for 15.3 GFLOP of products (15 us at the bf16 peak): bytes.
// Design (right before fast): csrc/attention.cuh's tile in its exp2-clamp
// form with RAW_QKV set, so that it scales q on load and zero-fills the K
// and V rows from S up to the next multiple of 16 in shared memory, and
// reads q, k, v where they lie: image and row strides are arguments, so the
// [B, S, H*64] layout, or slices of one [B, S, 3*H*64] qkv tensor, need no
// copy or transpose.  One block of 4 warps per (64 query rows, head, image);
// each block loads the head's whole K and V (152 KB of shared memory at
// S 197, one block per SM), so K and V are read once per query tile.
// Keeping K and V on chip across the query tiles and more blocks per SM are
// later work.

#include "attention.cuh"
#include "common.cuh"

using ptt::bf16;

extern "C" {

// q [B, S, H, 64] with image stride q_img and row stride q_row (elements),
// k and v with kv_img and kv_row, the last two axes packed; o [B, S, H, 64]
// contiguous.  scale = log2(e)/sqrt(64) in f32.
int ptt_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, long long q_img, int q_row,
                        long long kv_img, int kv_row, float scale,
                        void* stream) {
  constexpr int HD = ptt_attention::HD;
  const int Sp = (S + 15) / 16 * 16;
  return ptt_attention::attention<ptt_attention::SOFTMAX_EXP2_CLAMP, bf16,
                                  true>(
      (const bf16*)q, q_img, q_row, S, (const bf16*)k, (const bf16*)v, kv_img,
      kv_row, (bf16*)o, (long long)S * H * HD, H * HD, B, H, Sp, S, scale,
      (cudaStream_t)stream);
}

}  // extern "C"
