// Standalone multi-head attention softmax(q k^T / sqrt(d)) v on projected
// q, k, v [B, S, H, hd] -> [B, S, H, hd] in q's dtype, the `use_flash`
// tower's attention, at any head width hd that is a multiple of 8 up to
// 128 and any S; bf16 here, f32 in csrc/flash_attention_f32.cu.
//
// Replaces the TPU kernels of patent_tpu/ops/flash_attention.py
// _attn_kernel (_flash_impl) and _attn_kernel_headbatch
// (_flash_impl_headbatch), public entry flash_attention: one function under
// two tilings, in q's dtype, here ptt_flash_attention (bf16) and
// ptt_flash_attention_f32.
//
// The TPU kernel's function, per (image, head), in q's dtype T:
//   q' = T(f32(q) * scale)              (scale = log2(e)/sqrt(hd), f32)
//   p  = T(exp2(clip(q'.k, -100, 80))), keys >= S p = 0
//   o  = T((p v) / sum(p))              (f32 sums, an exact divide)
//
// bf16 (the tower's dtype): csrc/flash_tile.cuh, which says what bounds it
// on the H100 and what its design does about it, with q scaled on load,
// K and V read once per (head, image), or once per 64 query rows past
// the tile's ring, and zero-filled from S up to the next multiple of 16,
// and q, k, v read where they lie (image and row
// strides are arguments, so the [B, S, H*64] layout, or slices of one
// [B, S, 3*H*64] qkv tensor, need no copy or transpose).

#include "common.cuh"
#include "flash_tile.cuh"

using ptt::bf16;

extern "C" {

// q [B, S, H, hd] bf16 with image stride q_img and row stride q_row
// (elements), k and v with kv_img and kv_row, the last two axes packed; o
// [B, S, H, hd] contiguous.  hd a multiple of 8 up to 128 (the tile's
// instance tile_width(hd)); scale = log2(e)/sqrt(hd) in f32.
int ptt_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int hd, long long q_img,
                        int q_row, long long kv_img, int kv_row, float scale,
                        void* stream) {
  const int Sp = (S + 15) / 16 * 16;
  return ptt_flash::attention<true>(
      (const bf16*)q, q_img, q_row, S, (const bf16*)k, (const bf16*)v, kv_img,
      kv_row, (bf16*)o, (long long)S * H * hd, H * hd, B, H, hd, Sp, S,
      scale, (cudaStream_t)stream);
}

}  // extern "C"
