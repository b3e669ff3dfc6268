"""Whole pre-LN bf16 transformer layer (port of patent_tpu/ops/bf16_layer.py).

``fused_layer_block_bf16`` runs layers 0..N-2 of the serving tower and
``fused_layer_cls_bf16`` the last one, for the CLS row only.  On a CUDA
tensor each launches its hand-written kernel (csrc/bf16_layer.cu, which
says what bounds it on the H100 and how it is built); on a CPU tensor each
runs its plain PyTorch version below, which is also what the kernel is
checked against on the card.

Contracts, as in the JAX package: x [B, S, D]; wqkv [D, 3D], wout [D, D],
w1 [D, F], w2 [F, D] in the Flax [in, out] layout; LayerNorm vectors and
biases 1-D.  The token axis is padded once before the first layer to a
multiple of 16 (``required_seq_pad_bf16``) and ``valid_len`` is the true
length: keys at or past it are masked, and the pad rows' outputs are junk
that only the CLS read-out discards.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .common import (check_attention_shape, check_cuda_tensor,
                     layernorm_f32, mm_f32, round_up)

_P, _I = _build.P, _build.I
_SIG_LAYER = [_P, _P] + [_I] * 6 + [_P] * 12 + [_P] * 5 + [_P]
_SIG_CLS = [_P, _P] + [_I] * 6 + [_P] * 12 + [_P] * 7 + [_P]


def required_seq_pad_bf16(seq: int) -> int:
    """Token-axis padding: a multiple of 16 rows (the tensor-core tile
    height), 197 → 208."""
    return round_up(max(seq, 16), 16)


def _layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                 ln2_bias, w1, b1, w2, b2, num_heads: int, valid_len: int,
                 cls_only: bool) -> torch.Tensor:
    """The layer in plain PyTorch, rounding to x's dtype where the kernels
    do: LayerNorm outputs, q/k/v, the softmax numerator p, the attention
    output and the MLP hidden.  Products and bias adds stay f32 up to
    there, the residual stream is f32, and the softmax subtracts the row
    max and divides by the sum of the rounded p after the p·v product."""
    b, s, d = x.shape
    hd = d // num_heads
    cdt = x.dtype

    def dense(a, w, bias):
        rows = mm_f32(a.reshape(-1, a.shape[-1]).to(cdt), w.to(cdt))
        return rows.reshape(*a.shape[:-1], -1) + bias.float()

    def heads(t):                    # [B, T, D] → [B·H, T, hd]
        t = t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
        return t.reshape(b * num_heads, -1, hd)

    h = layernorm_f32(x, ln1_scale, ln1_bias).to(cdt)
    kv = dense(h, wqkv[:, d:], bqkv[d:]).to(cdt)
    q = dense(h[:, :1] if cls_only else h, wqkv[:, :d], bqkv[:d]).to(cdt)
    k, v = kv.split(d, dim=-1)
    scores = mm_f32(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(hd)
    if valid_len < s:
        key_pad = torch.arange(s, device=x.device) >= valid_len
        scores = scores.masked_fill(key_pad, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).to(cdt)
    ao = mm_f32(p, heads(v)) / p.float().sum(dim=-1, keepdim=True)
    ao = ao.to(cdt).reshape(b, num_heads, -1, hd).transpose(1, 2)
    x1 = (x[:, :1] if cls_only else x).float() + dense(
        ao.reshape(b, -1, d), wout, bout)
    h2 = layernorm_f32(x1, ln2_scale, ln2_bias).to(cdt)
    g = dense(h2, w1, b1)
    a = (g * torch.sigmoid(1.702 * g)).to(cdt)
    out = (x1 + dense(a, w2, b2)).to(cdt)
    return out[:, 0] if cls_only else out


def fused_layer_block_bf16_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout,
                                 bout, ln2_scale, ln2_bias, w1, b1, w2, b2,
                                 num_heads: int,
                                 valid_len: int | None = None) -> torch.Tensor:
    """Plain version of ``fused_layer_block_bf16``: [B, S, D] → [B, S, D]."""
    return _layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                        ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
                        x.shape[1] if valid_len is None else valid_len, False)


def fused_layer_cls_bf16_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                               ln2_scale, ln2_bias, w1, b1, w2, b2,
                               num_heads: int,
                               valid_len: int | None = None) -> torch.Tensor:
    """Plain version of ``fused_layer_cls_bf16``: [B, S, D] → [B, D]."""
    return _layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                        ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
                        x.shape[1] if valid_len is None else valid_len, True)


def _kernel_args(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
                 ln2_bias, w1, b1, w2, b2, num_heads, valid_len):
    """Validate a CUDA call: x and the four matrices bf16, LayerNorm
    vectors and biases f32, all contiguous on the card.  Nothing is cast
    here: the caller holds its weights in these dtypes (the tower does,
    from load time)."""
    check_cuda_tensor("x", x, torch.bfloat16)
    b, s, d = x.shape
    f = w1.shape[1]
    check_attention_shape(d, num_heads, s, valid_len)
    if f % 8:
        raise ValueError(f"MLP width {f} must be a multiple of 8")

    def w(t, shape):
        check_cuda_tensor("weight", t, torch.bfloat16, shape)
        return t

    def vec(t, n):
        check_cuda_tensor("vector", t, torch.float32, (n,))
        return t

    return [vec(ln1_scale, d), vec(ln1_bias, d), w(wqkv, (d, 3 * d)),
            vec(bqkv, 3 * d), w(wout, (d, d)), vec(bout, d),
            vec(ln2_scale, d), vec(ln2_bias, d), w(w1, (d, f)), vec(b1, f),
            w(w2, (f, d)), vec(b2, d)]


def fused_layer_block_bf16(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                           ln2_scale, ln2_bias, w1, b1, w2, b2,
                           num_heads: int,
                           valid_len: int | None = None) -> torch.Tensor:
    """One whole pre-LN layer ``x + attn(LN1(x)); · + mlp(LN2(·))``.
    Inference only.  CPU tensor: the plain version; CUDA tensor (bf16):
    the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu":
        return fused_layer_block_bf16_plain(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
            ln2_bias, w1, b1, w2, b2, num_heads, valid_len)
    ws = _kernel_args(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
                      valid_len)
    b, s, d = x.shape
    f = ws[8].shape[1]
    m = b * s
    dev = x.device
    out = torch.empty_like(x)
    scratch = [torch.empty(m, d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, 3 * d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, d, dtype=torch.float32, device=dev),
               torch.empty(m, f, dtype=torch.bfloat16, device=dev)]
    _build.call("ptt_bf16_layer", _SIG_LAYER, _build.ptr(x), _build.ptr(out),
                b, s, d, num_heads, f, valid_len, *map(_build.ptr, ws),
                *map(_build.ptr, scratch), _build.stream(x.device))
    fused_layer_block_bf16.launches += 1
    return out


fused_layer_block_bf16.launches = 0


def fused_layer_cls_bf16(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                         ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads: int,
                         valid_len: int | None = None) -> torch.Tensor:
    """Row 0 (CLS) of ``fused_layer_block_bf16`` → [B, D]: LN1 and K/V over
    every row, the rest for the CLS row only.  CPU tensor: the plain
    version; CUDA tensor (bf16): the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu":
        return fused_layer_cls_bf16_plain(
            x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
            ln2_bias, w1, b1, w2, b2, num_heads, valid_len)
    ws = _kernel_args(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
                      valid_len)
    b, s, d = x.shape
    f = ws[8].shape[1]
    m = b * s
    dev = x.device
    out = torch.empty(b, d, dtype=x.dtype, device=dev)
    scratch = [torch.empty(m, d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, 2 * d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, d, dtype=torch.float32, device=dev),
               torch.empty(b, d, dtype=torch.bfloat16, device=dev),
               torch.empty(b, f, dtype=torch.bfloat16, device=dev)]
    _build.call("ptt_bf16_layer_cls", _SIG_CLS, _build.ptr(x), _build.ptr(out),
                b, s, d, num_heads, f, valid_len, *map(_build.ptr, ws),
                *map(_build.ptr, scratch), _build.stream(x.device))
    fused_layer_cls_bf16.launches += 1
    return out


fused_layer_cls_bf16.launches = 0
