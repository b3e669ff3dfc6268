"""Int8 serving layer with dynamic quantization (port of the serving entry
points of patent_tpu/ops/quant_matmul.py).

``quant_attention_block`` runs the pre-LN attention sub-layer of layers
0..N-2 of the int8 tower, ``quant_attention_cls`` the last layer's, for the
CLS row only, and ``quant_mlp_block`` the MLP sub-layer of every layer.
On a CUDA tensor each launches its hand-written kernel (csrc/int8_layer.cu,
which says what bounds it on the H100 and how); on a CPU tensor each runs
its plain PyTorch version below, which is also what the kernel is checked
against on the card.  Both compute the TPU kernels' exact-division form
(``fast=False``):

* weights: per output channel, ``scale = max(max|w|, 1e-8) / 127`` and
  ``clip(round(w / scale), -127, 127)`` (``quantize_weight``);
* activations: per row, ``scale = max(max|x|, 1e-8) * f32(1/127)`` and
  ``round(x / scale)``, half to even (``quant_rows``);
* dequant ``f32(int32 acc) * row_scale * col_scale + bias``, in that order;
* attention in the exp2 form: log2(e)/sqrt(hd) folded into the q columns'
  dequant scale and bias, q/k/v rounded to bf16,
  ``p = bf16(exp2(clip(s, -100, 80)))`` without max subtraction, pad keys
  contributing nothing, the denominator the sum of the rounded p; the
  attention output stays f32 and is row-quantized;
* the residual adds in f32 and the sum is stored in x's dtype (bf16).

Layouts: the int8 matrices are held ``[out, in]`` (``*_t``), K-major as the
tensor cores take them; ``quantize_weight`` returns the JAX ``[in, out]``
layout and the tower transposes once at load time.  ``valid_len``: the
token axis is padded once before the first layer to a multiple of 16; keys
at or past ``valid_len`` are masked, and the pad rows' outputs are junk
that only the CLS read-out discards.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .common import (NEG_1702_LOG2E, check_attention_shape,
                     check_cuda_tensor, layernorm_f32, mm_f32)
from .flash_attention import SCORE_CLAMP_HI, SCORE_CLAMP_LO

_P, _I = _build.P, _build.I
_SIG_ATTN = [_P, _P] + [_I] * 5 + [_P] * 8 + [_P] * 4 + [_P]
_SIG_CLS = [_P, _P] + [_I] * 5 + [_P] * 8 + [_P] * 7 + [_P]
_SIG_MLP = [_P, _P] + [_I] * 3 + [_P] * 8 + [_P] * 5 + [_P]


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float → (int8 [in, out], f32 [out] scale), symmetric per
    output channel."""
    w = w.float()
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [..., K] → (int8 [..., K], f32 [..., 1] scale), per row."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scale = amax * (1.0 / 127.0)
    return torch.round(x / scale).to(torch.int8), scale


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a [..., K] int8 @ b_t [N, K]^T, exactly, returned as f32 (the
    kernels' f32(int32 acc)).  int32 products on the CPU; on the card, where
    PyTorch has no integer matmul, float64, which is exact while
    K * 127^2 < 2^53."""
    wide = torch.float64 if a.is_cuda else torch.int32
    acc = a.reshape(-1, a.shape[-1]).to(wide) @ b_t.to(wide).T
    return acc.float().reshape(*a.shape[:-1], b_t.shape[0])


def fold_q_scale(sqkv: torch.Tensor, bqkv: torch.Tensor,
                 num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The QKV dequant scale and bias with log2(e)/sqrt(head_dim) folded
    into the q columns (the first D), as the TPU kernels fold it."""
    d = sqkv.shape[0] // 3
    f = float(np.log2(np.e) / np.sqrt(d // num_heads))
    return (torch.cat([sqkv[:d] * f, sqkv[d:]]).contiguous(),
            torch.cat([bqkv[:d] * f, bqkv[d:]]).contiguous())


def _attn_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                bout, num_heads: int, valid_len: int,
                cls_only: bool) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // num_heads
    sq, bq = fold_q_scale(sqkv, bqkv, num_heads)

    def heads(t):                    # [B, T, D] → [B·H, T, hd]
        t = t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
        return t.reshape(b * num_heads, -1, hd)

    xf = x.float()
    hq, hs = quant_rows(layernorm_f32(xf, ln_scale, ln_bias))
    kv = (int_mm(hq, wqkv_t[d:]) * hs * sq[d:] + bq[d:]).to(torch.bfloat16)
    rows = slice(0, 1) if cls_only else slice(None)
    q = (int_mm(hq[:, rows], wqkv_t[:d]) * hs[:, rows] * sq[:d]
         + bq[:d]).to(torch.bfloat16)
    k, v = kv.split(d, dim=-1)
    scores = mm_f32(heads(q), heads(k).transpose(-1, -2))
    p = torch.exp2(scores.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI)).to(
        torch.bfloat16)
    p = p.masked_fill(torch.arange(s, device=x.device) >= valid_len, 0.0)
    ao = mm_f32(p, heads(v)) / p.float().sum(dim=-1, keepdim=True)
    ao = ao.reshape(b, num_heads, -1, hd).transpose(1, 2).reshape(b, -1, d)
    aq, a_scale = quant_rows(ao)
    out = xf[:, rows] + (int_mm(aq, wout_t) * a_scale * sout + bout)
    out = out.to(x.dtype)
    return out[:, 0] if cls_only else out


def quant_attention_block_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv,
                                wout_t, sout, bout, num_heads: int,
                                valid_len: int | None = None) -> torch.Tensor:
    """Plain version of ``quant_attention_block``: [B, S, D] → [B, S, D]."""
    return _attn_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                       sout, bout, num_heads,
                       x.shape[1] if valid_len is None else valid_len, False)


def quant_attention_cls_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv,
                              wout_t, sout, bout, num_heads: int,
                              valid_len: int | None = None) -> torch.Tensor:
    """Plain version of ``quant_attention_cls``: [B, S, D] → [B, D]."""
    return _attn_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                       sout, bout, num_heads,
                       x.shape[1] if valid_len is None else valid_len, True)


def quant_mlp_block_plain(x, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2,
                          b2) -> torch.Tensor:
    """Plain version of ``quant_mlp_block``: [..., D] → [..., D].  The
    hidden is quantized from its f32 values."""
    xf = x.float()
    hq, hs = quant_rows(layernorm_f32(xf, ln_scale, ln_bias))
    g = int_mm(hq, w1_t) * hs * s1 + b1
    g = g / (1.0 + torch.exp2(NEG_1702_LOG2E * g))
    gq, g_scale = quant_rows(g)
    return (xf + (int_mm(gq, w2_t) * g_scale * s2 + b2)).to(x.dtype)


def _check_matrix(name, t, rows, cols):
    check_cuda_tensor(name, t, torch.int8, (rows, cols))


def _check_vectors(**vectors):
    for name, (t, n) in vectors.items():
        check_cuda_tensor(name, t, torch.float32, (n,))


def _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
               num_heads, valid_len):
    """Validate a CUDA call (x bf16, matrices int8 [out, in], vectors f32,
    all contiguous on the card) and fold the q scale."""
    check_cuda_tensor("x", x, torch.bfloat16)
    b, s, d = x.shape
    check_attention_shape(d, num_heads, s, valid_len)
    if d % 16:
        raise ValueError(f"width {d} must be a multiple of 16")
    _check_matrix("wqkv_t", wqkv_t, 3 * d, d)
    _check_matrix("wout_t", wout_t, d, d)
    _check_vectors(ln_scale=(ln_scale, d), ln_bias=(ln_bias, d),
                   sqkv=(sqkv, 3 * d), bqkv=(bqkv, 3 * d), sout=(sout, d),
                   bout=(bout, d))
    sq, bq = fold_q_scale(sqkv, bqkv, num_heads)
    return [ln_scale, ln_bias, wqkv_t, sq, bq, wout_t, sout, bout]


def quant_attention_block(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                          sout, bout, num_heads: int,
                          valid_len: int | None = None) -> torch.Tensor:
    """``x + out_proj(MHA(qkv_proj(LayerNorm(x))))`` with int8 projections:
    [B, S, D] → [B, S, D].  CPU tensor: the plain version; CUDA tensor
    (bf16): the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu":
        return quant_attention_block_plain(
            x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
            num_heads, valid_len)
    ws = _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                    bout, num_heads, valid_len)
    b, s, d = x.shape
    m, dev = b * s, x.device
    out = torch.empty_like(x)
    scratch = [torch.empty(m, d, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev),
               torch.empty(m, 3 * d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, d, dtype=torch.float32, device=dev)]
    _build.call("ptt_int8_attn", _SIG_ATTN, _build.ptr(x), _build.ptr(out),
                b, s, d, num_heads, valid_len, *map(_build.ptr, ws),
                *map(_build.ptr, scratch), _build.stream(dev))
    quant_attention_block.launches += 1
    return out


quant_attention_block.launches = 0


def quant_attention_cls(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                        sout, bout, num_heads: int,
                        valid_len: int | None = None) -> torch.Tensor:
    """Row 0 (CLS) of ``quant_attention_block`` → [B, D]: LN1, quant and
    K/V over every row, the rest for the CLS row only.  CPU tensor: the
    plain version; CUDA tensor (bf16): the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu":
        return quant_attention_cls_plain(
            x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
            num_heads, valid_len)
    ws = _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                    bout, num_heads, valid_len)
    b, s, d = x.shape
    m, dev = b * s, x.device
    out = torch.empty(b, d, dtype=x.dtype, device=dev)
    scratch = [torch.empty(m, d, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev),
               torch.empty(m, 2 * d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, d, dtype=torch.float32, device=dev),
               torch.empty(b, d, dtype=torch.int8, device=dev),
               torch.empty(b, dtype=torch.float32, device=dev)]
    _build.call("ptt_int8_attn_cls", _SIG_CLS, _build.ptr(x),
                _build.ptr(out), b, s, d, num_heads, valid_len,
                *map(_build.ptr, ws), *map(_build.ptr, scratch),
                _build.stream(dev))
    quant_attention_cls.launches += 1
    return out


quant_attention_cls.launches = 0


def quant_mlp_block(x, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2,
                    b2) -> torch.Tensor:
    """``x + W2 quant(quick_gelu(W1 quant(LayerNorm(x))))`` with int8
    matmuls: [..., D] → [..., D].  CPU tensor: the plain version; CUDA
    tensor (bf16): the kernel, or an error."""
    if x.device.type == "cpu":
        return quant_mlp_block_plain(x, ln_scale, ln_bias, w1_t, s1, b1,
                                     w2_t, s2, b2)
    check_cuda_tensor("x", x, torch.bfloat16)
    d = x.shape[-1]
    f = w1_t.shape[0]
    if d % 16 or f % 16:
        raise ValueError(f"widths {d} and {f} must be multiples of 16")
    _check_matrix("w1_t", w1_t, f, d)
    _check_matrix("w2_t", w2_t, d, f)
    _check_vectors(ln_scale=(ln_scale, d), ln_bias=(ln_bias, d),
                   s1=(s1, f), b1=(b1, f), s2=(s2, d), b2=(b2, d))
    m, dev = x.numel() // d, x.device
    out = torch.empty_like(x)
    scratch = [torch.empty(m, d, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev),
               torch.empty(m, f, dtype=torch.float32, device=dev),
               torch.empty(m, f, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev)]
    ws = [ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2, b2]
    _build.call("ptt_int8_mlp", _SIG_MLP, _build.ptr(x), _build.ptr(out), m,
                d, f, *map(_build.ptr, ws), *map(_build.ptr, scratch),
                _build.stream(dev))
    quant_mlp_block.launches += 1
    return out


quant_mlp_block.launches = 0
