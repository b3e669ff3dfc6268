"""Int8 serving layer with dynamic quantization (port of the serving entry
points of patent_tpu/ops/quant_matmul.py).

``quant_attention_block`` runs the pre-LN attention sub-layer of layers
0..N-2 of the int8 tower, ``quant_attention_cls`` the last layer's, for the
CLS row only, and ``quant_mlp_block`` the MLP sub-layer of every layer.
``quant_layer_block`` runs a whole layer with the residual between its
two sub-layers kept f32 (the tower's layers at a batch that is not a
multiple of 4), ``quant_layer_group`` the same behind the JAX package's
``group`` dispatch, and ``quant_dense`` / ``quant_mlp`` one int8 dense
layer and a two-layer MLP on their own (no LayerNorm, no residual).
On a CUDA tensor each launches its hand-written kernel (csrc/int8_layer.cu,
which says what bounds it on the H100 and how); on a CPU tensor each runs
its plain PyTorch version below, which is also what the kernel is checked
against on the card.  Both compute either of the TPU kernels' two forms,
picked by ``fast`` as the JAX package picks them:

* weights: per output channel, ``scale = max(max|w|, 1e-8) / 127`` and
  ``clip(round(w / scale), -127, 127)`` (``quantize_weight``);
* activations: per row, ``scale = max(max|x|, 1e-8) * f32(1/127)`` and
  ``round(x / scale)``, half to even (``quant_rows``, the exact form);
* dequant ``f32(int32 acc) * row_scale * col_scale + bias``, in that order;
* attention in the exp2 form: log2(e)/sqrt(hd) folded into the q columns'
  dequant scale and bias, q/k/v rounded to bf16,
  ``p = bf16(exp2(clip(s, -100, 80)))`` without max subtraction, pad keys
  contributing nothing, the denominator the sum of the rounded p; the
  attention output stays f32 and is row-quantized;
* the residual adds in f32 and the sum is stored in x's dtype (bf16);
  ``quant_layer_block`` keeps the attention sub-layer's sum in f32, so
  LN2 and the second residual read it unrounded, and rounds once, at the
  end.  On a bf16 stream that is another function than the attention
  sub-layer then the MLP sub-layer: a rounded mid residual can flip LN2's
  int8 codes.

The fast form (``fast=True``, JAX's default on its accelerator) replaces
each divide of the exact form (``fast=False``) by a multiply with a
reciprocal, ``recip(x) = f32(bf16(1 / f32(bf16(x))))``:

* the row quantization is ``quant_rows_fast``: ``inv = recip(amax) *
  127``, ``q = sat_s8(round(x * inv))``, the same dequant scale
  ``amax * f32(1/127)``; x * inv reaches 127.74, so the cast saturates
  (XLA's f32 → s8 convert does) and codes run from -128 to 127;
* quick_gelu is ``g * recip(1 + exp2(-1.702 log2(e) g))``;
* the attention's normalize is ``o * recip(den)``.

On its TPU JAX takes the hardware's approximate reciprocal (about 2^-12),
which cannot be reproduced or observed off the TPU; ``recip`` is the
definition JAX itself gives elsewhere (``pl.reciprocal(approx=True)``
lowers to a bf16 reciprocal), so the tests pin the fast form in bits.
``fast=None`` reads PATENT_TPU_FAST_KERNELS at call time on a CUDA tensor
("0": exact, anything else or unset: fast) and means exact on a CPU
tensor, which is what JAX's XLA fallback computes off the TPU; an explicit
``fast`` takes that form on either device.

Layouts: the int8 matrices are held ``[out, in]`` (``*_t``), K-major as the
tensor cores take them; ``quantize_weight`` returns the JAX ``[in, out]``
layout and the tower transposes once at load time.  ``valid_len``: the
token axis is padded once before the first layer to a multiple of 16; keys
at or past ``valid_len`` are masked, and the pad rows' outputs are junk
that only the CLS read-out discards.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .common import (NEG_1702_LOG2E, check_attention_shape,
                     check_cuda_tensor, count_tile, layernorm_f32, mm_f32)
from .flash_attention import SCORE_CLAMP_HI, SCORE_CLAMP_LO

_P, _I = _build.P, _build.I
# every entry takes the form as an int, `fast` (0 exact, 1 fast)
_SIG_ATTN = [_P, _P] + [_I] * 6 + [_P] * 8 + [_P] * 4 + [_P]
_SIG_CLS = [_P, _P] + [_I] * 6 + [_P] * 8 + [_P] * 7 + [_P]
_SIG_MLP = [_P, _P] + [_I] * 4 + [_P] * 8 + [_P] * 6 + [_P]
_SIG_LAYER = [_P, _P] + [_I] * 10 + [_P] * 16 + [_P] * 14 + [_P]
_SIG_GEMM = [_I] * 2 + [_P] * 7 + [_I] * 4 + [_P]
_SIG_GELU_QUANT = [_P] * 9 + [_I] * 4 + [_P]
_SIG_DENSE = [_P, _P] + [_I] * 6 + [_P] * 3 + [_P] * 2 + [_P]
_SIG_QMLP = [_P, _P] + [_I] * 6 + [_P] * 6 + [_P] * 6 + [_P]


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


FAST_ENV = "PATENT_TPU_FAST_KERNELS"


def _on_card(x: torch.Tensor) -> bool:
    """The device probe behind ``fast=None``: a CUDA tensor."""
    return x.is_cuda


def resolve_fast(fast: bool | None, x: torch.Tensor) -> bool:
    """``fast``, or for None: on the card the env var read now ("0":
    exact, else fast), on the CPU the exact form."""
    if fast is not None:
        return bool(fast)
    return _on_card(x) and os.environ.get(FAST_ENV, "1") != "0"


def recip(x: torch.Tensor) -> torch.Tensor:
    """The fast form's reciprocal of f32 x: f32(bf16(1 / f32(bf16(x))))."""
    return (1.0 / x.to(torch.bfloat16).float()).to(torch.bfloat16).float()


def quant_rows_fast(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast form of ``quant_rows``: codes ``sat_s8(round(x * (recip(
    amax) * 127)))`` (-128 to 127), the same scale ``amax * f32(1/127)``."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    q = torch.round(x * (recip(amax) * 127.0)).clamp(-128, 127)
    return q.to(torch.int8), amax * (1.0 / 127.0)


def _quant(fast: bool):
    return quant_rows_fast if fast else quant_rows


class FastLaunches:
    """An entry's launches of its fast-form kernels, apart: the entry's own
    ``launches`` counts both forms, ``entry.fast.launches`` the fast ones
    (named ``<entry>_fast``, as the kernels are named where they are
    listed)."""

    def __init__(self, entry: str):
        self.__name__ = entry + "_fast"
        self.launches = 0


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


def _quick_gelu(g: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """``g * sigmoid(1.702 g)`` as ``g / (1 + exp2(-1.702 log2(e) g))``;
    fast: ``g * recip(1 + exp2(...))``."""
    den = 1.0 + torch.exp2(NEG_1702_LOG2E * g)
    return g * recip(den) if fast else g / den


def _folded_q(sqkv, bqkv, num_heads, folded):
    """``folded`` (``fold_q_scale`` of the same vectors, made once by the
    caller), else the fold of this call."""
    return folded if folded is not None else fold_q_scale(sqkv, bqkv,
                                                          num_heads)


def _attn_f32(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
              num_heads: int, valid_len: int, cls_only: bool,
              folded=None, fast: bool = False) -> torch.Tensor:
    """The attention sub-layer with its residual, ``f32(x) + attn(x)``, left
    in f32: [B, S, D] → [B, S, D] (``cls_only``: [B, 1, D])."""
    quant = _quant(fast)
    b, s, d = x.shape
    hd = d // num_heads
    sq, bq = _folded_q(sqkv, bqkv, num_heads, folded)

    def heads(t):                    # [B, T, D] → [B·H, T, hd]
        t = t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
        return t.reshape(b * num_heads, -1, hd)

    xf = x.float()
    hq, hs = quant(layernorm_f32(xf, ln_scale, ln_bias))
    kv = (int_mm(hq, wqkv_t[d:]) * hs * sq[d:] + bq[d:]).to(torch.bfloat16)
    rows = slice(0, 1) if cls_only else slice(None)
    q = (int_mm(hq[:, rows], wqkv_t[:d]) * hs[:, rows] * sq[:d]
         + bq[:d]).to(torch.bfloat16)
    k, v = kv.split(d, dim=-1)
    scores = mm_f32(heads(q), heads(k).transpose(-1, -2))
    p = torch.exp2(scores.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI)).to(
        torch.bfloat16)
    p = p.masked_fill(torch.arange(s, device=x.device) >= valid_len, 0.0)
    den = p.float().sum(dim=-1, keepdim=True)
    ao = mm_f32(p, heads(v))
    ao = ao * recip(den) if fast else ao / den
    ao = ao.reshape(b, num_heads, -1, hd).transpose(1, 2).reshape(b, -1, d)
    aq, a_scale = quant(ao)
    return xf[:, rows] + (int_mm(aq, wout_t) * a_scale * sout + bout)


def _mlp_f32(h, w1_t, s1, b1, w2_t, s2, b2, fast: bool = False
             ) -> torch.Tensor:
    """f32 [..., K] → f32 [..., N]: row quantization, int8 dense, quick_gelu,
    row quantization of the f32 hidden, int8 dense (no LayerNorm, no
    residual)."""
    quant = _quant(fast)
    hq, hs = quant(h)
    g = _quick_gelu(int_mm(hq, w1_t) * hs * s1 + b1, fast)
    gq, g_scale = quant(g)
    return int_mm(gq, w2_t) * g_scale * s2 + b2


def quant_attention_block_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv,
                                wout_t, sout, bout, num_heads: int,
                                valid_len: int | None = None,
                                folded=None, fast: bool | None = None
                                ) -> torch.Tensor:
    """Plain version of ``quant_attention_block``: [B, S, D] → [B, S, D]."""
    return _attn_f32(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                     bout, num_heads,
                     x.shape[1] if valid_len is None else valid_len,
                     False, folded, resolve_fast(fast, x)).to(x.dtype)


def quant_attention_cls_plain(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv,
                              wout_t, sout, bout, num_heads: int,
                              valid_len: int | None = None,
                              folded=None, fast: bool | None = None
                              ) -> torch.Tensor:
    """Plain version of ``quant_attention_cls``: [B, S, D] → [B, D]."""
    return _attn_f32(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                     bout, num_heads,
                     x.shape[1] if valid_len is None else valid_len,
                     True, folded, resolve_fast(fast, x))[:, 0].to(x.dtype)


def quant_mlp_block_plain(x, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2,
                          b2, fast: bool | None = None) -> torch.Tensor:
    """Plain version of ``quant_mlp_block``: [..., D] → [..., D].  The
    hidden is quantized from its f32 values."""
    xf = x.float()
    return (xf + _mlp_f32(layernorm_f32(xf, ln_scale, ln_bias), w1_t, s1,
                          b1, w2_t, s2, b2,
                          resolve_fast(fast, x))).to(x.dtype)


def quant_layer_block_plain(x, ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv,
                            wout_t, sout, bout, ln2_scale, ln2_bias, w1_t, s1,
                            b1, w2_t, s2, b2, num_heads: int,
                            valid_len: int | None = None,
                            folded=None, fast: bool | None = None
                            ) -> torch.Tensor:
    """Plain version of ``quant_layer_block``: [B, S, D] → [B, S, D].  The
    residual between the two sub-layers stays f32 (LN2 reads it unrounded)
    and only the layer's output is cast to x's dtype."""
    fast = resolve_fast(fast, x)
    x1 = _attn_f32(x, ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                   bout, num_heads,
                   x.shape[1] if valid_len is None else valid_len, False,
                   folded, fast)
    return (x1 + _mlp_f32(layernorm_f32(x1, ln2_scale, ln2_bias), w1_t, s1,
                          b1, w2_t, s2, b2, fast)).to(x.dtype)


def _check_act(act: str | None) -> None:
    if act not in (None, "quick_gelu"):
        raise ValueError(f"unknown activation {act!r}")


def quant_dense_plain(x, w_t, scale, bias=None, act: str | None = None,
                      fast: bool | None = None) -> torch.Tensor:
    """Plain version of ``quant_dense``: x [..., K] (bf16 or f32), w_t int8
    [N, K] → ``act(f32(quant(x) @ w) * row_scale * scale + bias)`` in x's
    dtype; ``bias=None`` adds zeros."""
    _check_act(act)
    fast = resolve_fast(fast, x)
    xq, xs = _quant(fast)(x.float())
    out = int_mm(xq, w_t) * xs * scale
    out = out + (torch.zeros_like(scale) if bias is None else bias)
    return (_quick_gelu(out, fast) if act else out).to(x.dtype)


def quant_mlp_plain(x, w1_t, s1, b1, w2_t, s2, b2,
                    fast: bool | None = None) -> torch.Tensor:
    """Plain version of ``quant_mlp``: x [..., K] → [..., N] in x's dtype,
    the [..., H] hidden f32."""
    return _mlp_f32(x.float(), w1_t, s1, b1, w2_t, s2, b2,
                    resolve_fast(fast, x)).to(x.dtype)


def _check_matrix(name, t, rows, cols):
    check_cuda_tensor(name, t, torch.int8, (rows, cols))


def _check_vectors(**vectors):
    for name, (t, n) in vectors.items():
        check_cuda_tensor(name, t, torch.float32, (n,))


def _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
               num_heads, valid_len, folded=None):
    """Validate a CUDA call (x bf16, matrices int8 [out, in], vectors f32,
    all contiguous on the card) and fold the q scale, unless ``folded``
    holds it."""
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
    if folded is not None:
        _check_vectors(folded_sq=(folded[0], 3 * d),
                       folded_bq=(folded[1], 3 * d))
    sq, bq = _folded_q(sqkv, bqkv, num_heads, folded)
    return [ln_scale, ln_bias, wqkv_t, sq, bq, wout_t, sout, bout]


# every slice of a call's workspace starts at a multiple of this many bytes
# (16 would do for the kernels' vector loads and TMA)
WORKSPACE_ALIGN = 256


@functools.lru_cache(maxsize=256)
def workspace_layout(specs: tuple) -> tuple[tuple[int, ...], int]:
    """(byte offset of each (shape, dtype) in ``specs``, total bytes): the
    slices one after another, each at a multiple of WORKSPACE_ALIGN."""
    offsets, total = [], 0
    for shape, dtype in specs:
        offsets.append(total)
        n = math.prod(shape) * dtype.itemsize
        total += -(-n // WORKSPACE_ALIGN) * WORKSPACE_ALIGN
    return tuple(offsets), total


def workspace(device, specs: tuple) -> tuple[torch.Tensor, list[int]]:
    """One allocation for a call's scratch, and the address of each (shape,
    dtype) slice of ``specs`` in it, for a C entry point.  Keep the buffer
    until the launch is enqueued."""
    offsets, total = workspace_layout(specs)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [base + off for off in offsets]


def quant_attention_block(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                          sout, bout, num_heads: int,
                          valid_len: int | None = None,
                          folded=None, fast: bool | None = None
                          ) -> torch.Tensor:
    """``x + out_proj(MHA(qkv_proj(LayerNorm(x))))`` with int8 projections:
    [B, S, D] → [B, S, D].  ``folded``: ``fold_q_scale(sqkv, bqkv,
    num_heads)`` made once by the caller (the tower holds it), else folded
    here.  ``fast``: the form (``resolve_fast``).  CPU tensor: the plain
    version; CUDA tensor (bf16): the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_attention_block_plain(
            x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
            num_heads, valid_len, folded, fast)
    ws = _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                    bout, num_heads, valid_len, folded)
    b, s, d = x.shape
    m, dev = b * s, x.device
    out = torch.empty_like(x)
    _buf, scratch = workspace(dev, (
        ((m, d), torch.int8), ((m,), torch.float32),
        ((m, 3 * d), torch.bfloat16), ((m, d), torch.float32)))
    _build.call("ptt_int8_attn", _SIG_ATTN, _build.ptr(x), _build.ptr(out),
                b, s, d, num_heads, valid_len, int(fast),
                *map(_build.ptr, ws),
                *scratch, _build.stream(dev))
    quant_attention_block.launches += 1
    quant_attention_block.fast.launches += fast
    count_tile(d, num_heads)
    return out


quant_attention_block.launches = 0
quant_attention_block.fast = FastLaunches("quant_attention_block")


def quant_attention_cls(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t,
                        sout, bout, num_heads: int,
                        valid_len: int | None = None,
                        folded=None, fast: bool | None = None
                        ) -> torch.Tensor:
    """Row 0 (CLS) of ``quant_attention_block`` → [B, D]: LN1, quant and
    K/V over every row, the rest for the CLS row only.  ``folded`` and
    ``fast`` as there.  CPU tensor: the plain version; CUDA tensor (bf16):
    the kernel, or an error."""
    valid_len = x.shape[1] if valid_len is None else valid_len
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_attention_cls_plain(
            x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
            num_heads, valid_len, folded, fast)
    ws = _attn_args(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wout_t, sout,
                    bout, num_heads, valid_len, folded)
    b, s, d = x.shape
    m, dev = b * s, x.device
    out = torch.empty(b, d, dtype=x.dtype, device=dev)
    _buf, scratch = workspace(dev, (
        ((m, d), torch.int8), ((m,), torch.float32),
        ((m, 2 * d), torch.bfloat16), ((b, d), torch.bfloat16),
        ((b, d), torch.float32), ((b, d), torch.int8), ((b,), torch.float32)))
    _build.call("ptt_int8_attn_cls", _SIG_CLS, _build.ptr(x),
                _build.ptr(out), b, s, d, num_heads, valid_len, int(fast),
                *map(_build.ptr, ws), *scratch, _build.stream(dev))
    quant_attention_cls.launches += 1
    quant_attention_cls.fast.launches += fast
    count_tile(d, num_heads)
    return out


quant_attention_cls.launches = 0
quant_attention_cls.fast = FastLaunches("quant_attention_cls")


def _mlp_args(d, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2, b2):
    """Validate the MLP sub-layer's parameters of a CUDA call at width d;
    returns the hidden width."""
    f = w1_t.shape[0]
    if d % 16 or f % 16:
        raise ValueError(f"widths {d} and {f} must be multiples of 16")
    _check_matrix("w1_t", w1_t, f, d)
    _check_matrix("w2_t", w2_t, d, f)
    _check_vectors(ln_scale=(ln_scale, d), ln_bias=(ln_bias, d),
                   s1=(s1, f), b1=(b1, f), s2=(s2, d), b2=(b2, d))
    return f


def quant_mlp_block(x, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2,
                    b2, fast: bool | None = None) -> torch.Tensor:
    """``x + W2 quant(quick_gelu(W1 quant(LayerNorm(x))))`` with int8
    matmuls: [..., D] → [..., D].  ``fast``: the form (``resolve_fast``).
    CPU tensor: the plain version; CUDA tensor (bf16): the kernel, or an
    error."""
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_mlp_block_plain(x, ln_scale, ln_bias, w1_t, s1, b1,
                                     w2_t, s2, b2, fast)
    check_cuda_tensor("x", x, torch.bfloat16)
    d = x.shape[-1]
    f = _mlp_args(d, ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2, b2)
    m, dev = x.numel() // d, x.device
    out = torch.empty_like(x)
    # LN2's codes and scales; the hidden, its codes, scales and row maxima
    _buf, scratch = workspace(dev, (
        ((m, d), torch.int8), ((m,), torch.float32), ((m, f), torch.float32),
        ((m, f), torch.int8), ((m,), torch.float32), ((m,), torch.float32)))
    ws = [ln_scale, ln_bias, w1_t, s1, b1, w2_t, s2, b2]
    _build.call("ptt_int8_mlp", _SIG_MLP, _build.ptr(x), _build.ptr(out), m,
                d, f, int(fast), *map(_build.ptr, ws), *scratch,
                _build.stream(dev))
    quant_mlp_block.launches += 1
    quant_mlp_block.fast.launches += fast
    return out


quant_mlp_block.launches = 0
quant_mlp_block.fast = FastLaunches("quant_mlp_block")


# csrc/wgmma_s8.cuh's tile: 128 rows of A, 128 rows of Bt (output
# columns), K in steps of 128
S8_TILE = 128


class LayerGrid(NamedTuple):
    """What row 8's plan needs of the library: the blocks of its
    cooperative grid (all that fit on the card at once), and the most
    k-ranges a tile its split GEMMs take (each adds an [M, D] int32 slice
    that the next phase reads)."""
    blocks: int
    split_max: int


class LayerPlan(NamedTuple):
    """How row 8's kernel runs a layer: one cooperative launch (``coop``)
    with the out-projection and MLP out split over K into ``split_out`` and
    ``split_mlp`` k-ranges a tile, or (not ``coop``) a chain of launches."""
    coop: bool
    split_out: int
    split_mlp: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def layer_plan(m: int, d: int, f: int, grid: LayerGrid) -> LayerPlan:
    """The plan for M = B·S rows at width d, MLP f, on ``grid``: one
    launch while the widest phase (MLP in, M/128 x f/128 tiles) fits in one
    wave of the grid, its narrow, long-K phases (N = d) cut into as many
    k-ranges as fill the grid; else the chain, each GEMM on the whole
    card."""
    tiles_m = _cdiv(m, S8_TILE)
    if tiles_m * _cdiv(f, S8_TILE) > grid.blocks:
        return LayerPlan(False, 1, 1)

    def split(n, k):
        return max(1, min(_cdiv(k, S8_TILE), grid.split_max,
                          grid.blocks // (tiles_m * _cdiv(n, S8_TILE))))

    return LayerPlan(True, split(d, d), split(d, f))


_LAYER_GRID: dict[int, LayerGrid] = {}


def layer_grid() -> LayerGrid:
    """Row 8's grid on the current card (the one a launch goes to), asked
    of the library once a device."""
    dev = torch.cuda.current_device()
    grid = _LAYER_GRID.get(dev)
    if grid is None:
        blocks, split_max = ctypes.c_int(0), ctypes.c_int(0)
        _build.call("ptt_int8_layer_grid", [_P, _P], ctypes.byref(blocks),
                    ctypes.byref(split_max))
        grid = _LAYER_GRID[dev] = LayerGrid(blocks.value, split_max.value)
    return grid


def _layer_kernel(x, params, num_heads: int, valid_len: int, folded=None,
                  stamps: torch.Tensor | None = None,
                  fast: bool | None = None) -> torch.Tensor:
    """Row 8's kernel on a CUDA tensor: validate, plan, allocate the
    scratch of its phases (each buffer written by one phase only, in one
    workspace), launch.  ``stamps``: None, or 11 int64 on the card for the
    cooperative launch's clock at its start and after each phase."""
    fast = resolve_fast(fast, x)
    ws = _attn_args(x, *params[:8], num_heads, valid_len, folded)
    b, s, d = x.shape
    f = _mlp_args(d, *params[8:])
    m, dev = b * s, x.device
    plan = layer_plan(m, d, f, layer_grid())
    out = torch.empty_like(x)
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    specs = (((m, d), i8), ((m,), f32), ((m, 3 * d), bf), ((m, d), f32),
             ((m, d), i8), ((m,), f32), ((m, d), f32), ((m, d), i8),
             ((m,), f32), ((m, f), f32), ((m, f), i8), ((m,), f32))
    if plan.coop:
        specs += (((max(plan.split_out, plan.split_mlp), m, d),
                   torch.int32),)
    _buf, scratch = workspace(dev, specs)
    _build.call("ptt_int8_layer", _SIG_LAYER, _build.ptr(x), _build.ptr(out),
                b, s, d, num_heads, f, valid_len, int(plan.coop),
                plan.split_out, plan.split_mlp, int(fast),
                *map(_build.ptr, ws + list(params[8:])), *scratch,
                *([] if plan.coop else [None]),
                None if stamps is None else _build.ptr(stamps),
                _build.stream(dev))
    count_tile(d, num_heads)
    return out


def quant_layer_block(x, ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t,
                      sout, bout, ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2,
                      b2, num_heads: int, valid_len: int | None = None,
                      folded=None, fast: bool | None = None) -> torch.Tensor:
    """One whole pre-LN int8 layer, ``x1 = f32(x) + attn(x)``, then
    ``x1 + mlp(x1)`` in x's dtype, with the residual between the two
    sub-layers kept f32: [B, S, D] → [B, S, D].  ``folded`` and ``fast``
    as ``quant_attention_block`` takes them.  CPU tensor: the plain
    version; CUDA tensor (bf16): the kernel (one cooperative launch at a
    query's batch, a chain of launches of the same bodies at a larger
    one), or an error."""
    params = (ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
              ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2, b2)
    valid_len = x.shape[1] if valid_len is None else valid_len
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_layer_block_plain(x, *params, num_heads, valid_len,
                                       folded, fast)
    out = _layer_kernel(x, params, num_heads, valid_len, folded, fast=fast)
    quant_layer_block.launches += 1
    quant_layer_block.fast.launches += fast
    return out


quant_layer_block.launches = 0
quant_layer_block.fast = FastLaunches("quant_layer_block")


def _layer_group(x, params, num_heads, valid_len, group, fast, layer, attn,
                 mlp):
    """The dispatch of the JAX ``quant_layer_group``: the whole layer when
    B % group == 0 and ``valid_len`` is given, else the attention then the
    MLP sub-layer, each in form ``fast``."""
    if x.shape[0] % group == 0 and valid_len is not None:
        return layer(x, params, num_heads, valid_len, fast)
    return mlp(attn(x, *params[:8], num_heads, valid_len, fast=fast),
               *params[8:], fast=fast)


def quant_layer_group_plain(x, ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv,
                            wout_t, sout, bout, ln2_scale, ln2_bias, w1_t, s1,
                            b1, w2_t, s2, b2, num_heads: int,
                            valid_len: int | None = None, group: int = 2,
                            mlp_split: int = 2, fast: bool | None = None
                            ) -> torch.Tensor:
    """Plain version of ``quant_layer_group``."""
    params = (ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
              ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2, b2)
    return _layer_group(
        x, params, num_heads, valid_len, group, resolve_fast(fast, x),
        lambda x, p, h, v, f: quant_layer_block_plain(x, *p, h, v, fast=f),
        quant_attention_block_plain, quant_mlp_block_plain)


def quant_layer_group(x, ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t,
                      sout, bout, ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2,
                      b2, num_heads: int, valid_len: int | None = None,
                      group: int = 2, mlp_split: int = 2,
                      fast: bool | None = None) -> torch.Tensor:
    """``quant_layer_block`` for ``group`` images at a time, as the JAX
    package dispatches it: the whole layer (row 8's kernel on a CUDA
    tensor) when B % group == 0 and ``valid_len`` is given, else
    ``quant_attention_block`` then ``quant_mlp_block``.  ``group`` and
    ``mlp_split`` tile the TPU kernel; here ``group`` only picks the path
    and ``mlp_split`` changes nothing.  ``fast``: the form
    (``resolve_fast``).  CPU tensor: the plain versions."""
    params = (ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout,
              ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2, b2)
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_layer_group_plain(x, *params, num_heads, valid_len,
                                       group, fast=fast)

    def layer(x, p, h, v, f):
        out = _layer_kernel(x, p, h, v, fast=f)
        quant_layer_group.launches += 1
        quant_layer_group.fast.launches += f
        return out

    return _layer_group(x, params, num_heads, valid_len, group, fast, layer,
                        quant_attention_block, quant_mlp_block)


quant_layer_group.launches = 0
quant_layer_group.fast = FastLaunches("quant_layer_group")


# The s8 GEMM of rows 5, 7 and 8 (csrc/wgmma_s8.cuh) on its own, by the
# index its C entry takes: the epilogue, the residual's dtype, the output's
# dtype.  "bias": QKV; "gelu": MLP in; "res": row 5's out-projection and
# row 7's MLP out; "res_f32_out": row 8's out-projection (x1 kept f32);
# "res_f32": row 8's MLP out on x1; "bias_tail": "bias" for any N (the
# TAIL instance, which rows 10 and 11 take where N is not a multiple of
# 16).
S8_GEMM_EPILOGUES = {"bias": (0, None, torch.bfloat16),
                     "gelu": (1, None, torch.float32),
                     "res": (2, torch.bfloat16, torch.bfloat16),
                     "res_f32_out": (3, torch.bfloat16, torch.float32),
                     "res_f32": (4, torch.float32, torch.bfloat16),
                     "bias_tail": (5, None, torch.bfloat16)}


def int8_gemm_plain(a, a_scale, w_t, scale, bias, epilogue: str = "bias",
                    res: torch.Tensor | None = None,
                    every: int = 1, fast: bool | None = None
                    ) -> torch.Tensor:
    """Plain version of ``int8_gemm``: ``f32(a · w_tᵀ) * a_scale * scale +
    bias`` (exact integer products) over rows 0, every, 2·every, ... of a
    and a_scale, then the epilogue, in the instance's output dtype."""
    _idx, _rdt, odt = S8_GEMM_EPILOGUES[epilogue]
    a, a_scale = a[::every], a_scale[::every]
    v = int_mm(a, w_t) * a_scale[:, None] * scale + bias
    if epilogue == "gelu":
        v = _quick_gelu(v, resolve_fast(fast, a))
    elif res is not None:
        v = res.float() + v
    return v.to(odt)


def int8_gemm(a, a_scale, w_t, scale, bias, epilogue: str = "bias",
              res: torch.Tensor | None = None,
              every: int = 1, fast: bool | None = None) -> torch.Tensor:
    """One of rows 5, 6, 7 and 8's int8 GEMMs on its own (for checks and
    timing): a [R, K] int8 with row scales a_scale [R], of which rows 0,
    every, 2·every, ... (M = ceil(R / every) rows: row 6's CLS rows at
    every = S) are read in place, w_t [N, K] int8 with scale and bias [N]
    f32, res [M, N] in the instance's residual dtype; ``epilogue`` one of
    ``S8_GEMM_EPILOGUES``; ``fast``: the "gelu" epilogue's form
    (``resolve_fast``).  CPU tensor: the plain version; CUDA tensor: the
    kernel (K a multiple of 16, N too but for "bias_tail"), or an error."""
    fast = resolve_fast(fast, a)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, a_scale, w_t, scale, bias, epilogue, res,
                               every, fast)
    idx, rdt, odt = S8_GEMM_EPILOGUES[epilogue]
    r, k = a.shape
    n = w_t.shape[0]
    if (n % 16 and epilogue != "bias_tail") or k % 16 or every < 1:
        raise ValueError(f"N ({n}) and K ({k}) must be multiples of 16 and "
                         f"every ({every}) at least 1")
    m = -(-r // every)
    _check_matrix("a", a, r, k)
    _check_matrix("w_t", w_t, n, k)
    _check_vectors(a_scale=(a_scale, r), scale=(scale, n), bias=(bias, n))
    if rdt is not None:
        check_cuda_tensor("res", res, rdt, (m, n))
    out = torch.empty(m, n, dtype=odt, device=a.device)
    _build.call("ptt_int8_gemm", _SIG_GEMM, idx, int(fast), _build.ptr(a),
                _build.ptr(a_scale), _build.ptr(w_t), _build.ptr(scale),
                _build.ptr(bias),
                _build.ptr(res) if rdt is not None else None,
                _build.ptr(out), m, n, k, every, _build.stream(a.device))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_gelu_quant_plain(a, a_scale, w_t, scale, bias,
                          fast: bool | None = None):
    """Plain version of ``int8_gelu_quant``: the "gelu" instance of
    ``int8_gemm_plain``, its rows' max |g|, and the row quantization of
    it, each in form ``fast``."""
    fast = resolve_fast(fast, a)
    g = int8_gemm_plain(a, a_scale, w_t, scale, bias, "gelu", fast=fast)
    gq, gs = _quant(fast)(g)
    return g, g.abs().amax(dim=-1), gq, gs[:, 0]


def int8_gelu_quant(a, a_scale, w_t, scale, bias, fast: bool | None = None):
    """Row 7's MLP in and the hidden's quantization on their own (for
    checks and timing): a [M, K] int8 with row scales a_scale [M], w_t
    [N, K] int8, scale and bias [N] f32 → (g [M, N] f32, quick_gelu of the
    dequantized product; its rows' max |g| [M], as the GEMM's epilogue
    takes them; g's int8 codes [M, N] and row scales [M], from the
    one-pass quantization that reads those maxima), in form ``fast``
    (``resolve_fast``).  CPU tensor: the plain version; CUDA tensor: the
    kernels (K and N multiples of 16), or an error."""
    fast = resolve_fast(fast, a)
    if a.device.type == "cpu":
        return int8_gelu_quant_plain(a, a_scale, w_t, scale, bias, fast)
    m, k = a.shape
    n = w_t.shape[0]
    if n % 16 or k % 16:
        raise ValueError(f"N ({n}) and K ({k}) must be multiples of 16")
    _check_matrix("a", a, m, k)
    _check_matrix("w_t", w_t, n, k)
    _check_vectors(a_scale=(a_scale, m), scale=(scale, n), bias=(bias, n))
    dev = a.device
    g = torch.empty(m, n, dtype=torch.float32, device=dev)
    gq = torch.empty(m, n, dtype=torch.int8, device=dev)
    g_max, gs = torch.empty(2, m, dtype=torch.float32, device=dev)
    _build.call("ptt_int8_gelu_quant", _SIG_GELU_QUANT,
                *map(_build.ptr, (a, a_scale, w_t, scale, bias, g, g_max, gq,
                                  gs)),
                m, n, k, int(fast), _build.stream(dev))
    int8_gelu_quant.launches += 1
    return g, g_max, gq, gs


int8_gelu_quant.launches = 0


def _dense_input(x, widths: dict[str, int]):
    """Validate x of a CUDA dense call (bf16 or f32, contiguous) and the
    GEMM's depth constraint; returns (x as [M, K], 1 if f32)."""
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16,
                                                  torch.float32):
        raise ValueError(f"x: expected a bf16 or f32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    check_cuda_tensor("x", x, x.dtype)
    for name, n in widths.items():
        if n % 16:
            raise ValueError(f"{name} = {n}: the int8 GEMM needs its depth "
                             "(K, and H for quant_mlp) a multiple of 16")
    return x.reshape(-1, x.shape[-1]), int(x.dtype == torch.float32)


def quant_dense(x, w_t, scale, bias=None, act: str | None = None,
                fast: bool | None = None) -> torch.Tensor:
    """``act(f32(quant(x) @ w) * row_scale * scale + bias)`` with x's rows
    quantized on the fly: x [..., K] (bf16 or f32), w_t int8 [N, K], scale
    and bias f32 [N] (``bias=None``: zeros), ``act`` None or
    "quick_gelu"; the result in x's dtype; ``fast``: the form
    (``resolve_fast``).  CPU tensor: the plain version; CUDA tensor: the
    kernel (K a multiple of 16), or an error."""
    _check_act(act)
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_dense_plain(x, w_t, scale, bias, act, fast)
    k = x.shape[-1]
    x2, f32 = _dense_input(x, {"K": k})
    n = w_t.shape[0]
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32, device=x.device)
    _check_matrix("w_t", w_t, n, k)
    _check_vectors(scale=(scale, n), bias=(bias, n))
    m, dev = x2.shape[0], x.device
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=dev)
    scratch = [torch.empty(m, k, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev)]
    _build.call("ptt_int8_dense", _SIG_DENSE, _build.ptr(x2), _build.ptr(out),
                m, k, n, f32, int(act is not None), int(fast),
                *map(_build.ptr, (w_t, scale, bias, *scratch)),
                _build.stream(dev))
    quant_dense.launches += 1
    quant_dense.fast.launches += fast
    return out


quant_dense.launches = 0
quant_dense.fast = FastLaunches("quant_dense")


def quant_mlp(x, w1_t, s1, b1, w2_t, s2, b2,
              fast: bool | None = None) -> torch.Tensor:
    """``W2 quant(quick_gelu(W1 quant(x)))`` with int8 matmuls, no
    LayerNorm and no residual: x [..., K] (bf16 or f32), w1_t int8 [H, K],
    w2_t int8 [N, H], scales and biases f32 per output channel; the hidden
    f32, the result in x's dtype; ``fast``: the form (``resolve_fast``).
    CPU tensor: the plain version; CUDA tensor: the kernels (K and H
    multiples of 16, any N), or an error."""
    fast = resolve_fast(fast, x)
    if x.device.type == "cpu":
        return quant_mlp_plain(x, w1_t, s1, b1, w2_t, s2, b2, fast)
    k, h, n = x.shape[-1], w1_t.shape[0], w2_t.shape[0]
    x2, f32 = _dense_input(x, {"K": k, "H": h})
    _check_matrix("w1_t", w1_t, h, k)
    _check_matrix("w2_t", w2_t, n, h)
    _check_vectors(s1=(s1, h), b1=(b1, h), s2=(s2, n), b2=(b2, n))
    m, dev = x2.shape[0], x.device
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=dev)
    # xq, xs, the hidden g, its codes gq, scales gs and row maxima gmax
    scratch = [torch.empty(m, k, dtype=torch.int8, device=dev),
               torch.empty(m, dtype=torch.float32, device=dev),
               torch.empty(m, h, dtype=torch.float32, device=dev),
               torch.empty(m, h, dtype=torch.int8, device=dev),
               *torch.empty(2, m, dtype=torch.float32, device=dev)]
    _build.call("ptt_int8_qmlp", _SIG_QMLP, _build.ptr(x2), _build.ptr(out),
                m, k, h, n, f32, int(fast),
                *map(_build.ptr, (w1_t, s1, b1, w2_t, s2, b2, *scratch)),
                _build.stream(dev))
    quant_mlp.launches += 1
    quant_mlp.fast.launches += fast
    return out


quant_mlp.launches = 0
quant_mlp.fast = FastLaunches("quant_mlp")
