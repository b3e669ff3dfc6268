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

The function is the TPU kernel's: log2(e)/√hd folded into the q columns
of Wqkv and bqkv (``fold_layer``, under JAX's dtype rules), the one-pass
exp2 softmax with scores clamped to [-100, 80] and no max subtraction,
quick_gelu in its exp2 form in f32, and the residual ``(x + ao Wout) +
bout``.  The entries fold unfolded weights per call, as JAX does; a caller
that holds its weights (the tower, models/vit.py) folds them once from f32
at load time and passes them as ``folded``, since folding a bf16 copy
would round twice.

Both entries and their plain versions dispatch on the batch as the JAX
entries do (``group=2``): at an odd batch the JAX package runs no kernel,
on the TPU as well, but its per-op composition, another function (the
mid-layer residual rounded to bf16, the max-subtracted softmax, bf16 bias
adds one at a time).  There the port runs ``layer_composition``, plain
PyTorch on any device, and launches no kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build
from .common import (NEG_1702_LOG2E, check_attention_shape,
                     check_cuda_tensor, count_tile, dense, einsum_attention,
                     layernorm_f32, mm_f32, quick_gelu, round_up,
                     weak_scalar)

SCORE_CLAMP_LO = -100.0
SCORE_CLAMP_HI = 80.0
_P, _I, _L = _build.P, _build.I, _build.L
_SIG_LAYER = [_P, _P] + [_I] * 6 + [_P] * 12 + [_P] * 5 + [_P]
_SIG_CLS = [_P, _P] + [_I] * 6 + [_P] * 12 + [_P] * 7 + [_P]
_SIG_GEMM = [_I, _P, _L, _P, _L, _P, _P, _L, _P, _L, _I, _I, _I, _P]
# images per kernel program in the JAX entries: a batch it does not divide
# runs the composition there
GROUP = 2


class FoldedLayer(NamedTuple):
    """One layer's weights as the kernels take them: the matrices
    transposed to [out, in] in the compute dtype, log2(e)/√hd folded into
    the q rows of ``wqkv_t`` and the q part of ``bqkv``; LayerNorm vectors
    and biases f32."""

    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wqkv_t: torch.Tensor
    bqkv: torch.Tensor
    wout_t: torch.Tensor
    bout: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1_t: torch.Tensor
    b1: torch.Tensor
    w2_t: torch.Tensor
    b2: torch.Tensor


def q_fold_scale(d: int, num_heads: int) -> float:
    """log2(e)/√hd, the score scale and exp2 base change folded into q."""
    return float(math.log2(math.e) / math.sqrt(d // num_heads))


def fold_q_bias(bqkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """bqkv with its q part times log2(e)/√hd in bqkv's dtype (JAX's
    Python scalar takes that dtype), then f32."""
    d = bqkv.shape[0] // 3
    c = weak_scalar(q_fold_scale(d, num_heads), bqkv.dtype)
    return torch.cat([bqkv[:d] * c, bqkv[d:]]).float()


def fold_q_matrix(wqkv: torch.Tensor, num_heads: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """JAX's fold of the Flax [D, 3D] matrix: its q columns times
    log2(e)/√hd in wqkv's own dtype (f32 weights round once, after the
    product; bf16 ones multiply by the scalar rounded to bf16), then cast
    to ``dtype``: [D, 3D]."""
    d = wqkv.shape[0]
    c = weak_scalar(q_fold_scale(d, num_heads), wqkv.dtype)
    return torch.cat([wqkv[:, :d] * c, wqkv[:, d:]], dim=1).to(dtype)


def fold_layer(ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2, num_heads: int,
               dtype: torch.dtype = torch.bfloat16) -> FoldedLayer:
    """Unfolded Flax-layout weights → ``FoldedLayer`` in ``dtype``."""
    def t(w):
        return w.to(dtype).T.contiguous()

    def vec(v):
        return v.float().contiguous()

    return FoldedLayer(
        vec(ln1_scale), vec(ln1_bias),
        fold_q_matrix(wqkv, num_heads, dtype).T.contiguous(),
        fold_q_bias(bqkv, num_heads).contiguous(), t(wout), vec(bout),
        vec(ln2_scale), vec(ln2_bias), t(w1), vec(b1), t(w2), vec(b2))


def required_seq_pad_bf16(seq: int) -> int:
    """Token-axis padding: a multiple of 16 rows (the tensor-core tile
    height), 197 → 208."""
    return round_up(max(seq, 16), 16)


def layer_composition(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads: int,
                      valid_len: int | None = None) -> torch.Tensor:
    """The JAX entries' per-op composition (patent_tpu/ops/bf16_layer.py
    ``fused_layer_block_bf16``'s fallback), which JAX runs at an odd
    batch: [B, S, D] → [B, S, D] in x's dtype.  LayerNorms in f32 (two-pass
    variance) rounded to x's dtype; every product and bias add rounded to
    x's dtype, ``bf16(bf16(h W) + b)``; the scores f32 (JAX scales q by a
    numpy scalar, which promotes them), keys at or past ``valid_len`` set to
    -1e30, an f32 softmax rounded before p·v; the residual adds rounded one
    at a time, ``(x + a Wout) + bout``; quick_gelu in x's dtype."""
    b, s, d = x.shape
    cdt = x.dtype
    h = layernorm_f32(x, ln1_scale, ln1_bias).to(cdt)
    q, k, v = (t.unflatten(-1, (num_heads, d // num_heads))
               for t in dense(h, wqkv, bqkv, cdt).split(d, dim=-1))
    mask = None
    if valid_len is not None and valid_len < s:
        # JAX replaces the masked scores by -1e30; adding it gives the same
        mask = torch.where(torch.arange(s, device=x.device) >= valid_len,
                           -1e30, 0.0)
    ao = einsum_attention(q, k, v, cdt, mask).flatten(-2)
    x1 = x + ao @ wout.to(cdt) + bout.to(cdt)
    h2 = layernorm_f32(x1, ln2_scale, ln2_bias).to(cdt)
    a = quick_gelu(dense(h2, w1, b1, cdt))
    return x1 + a @ w2.to(cdt) + b2.to(cdt)


def quick_gelu_exp2(g: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's quick_gelu on f32 g: g / (1 + exp2(NEG_1702_LOG2E
    · g)), NEG_1702_LOG2E rounded to f32 once."""
    return g / (1.0 + torch.exp2(NEG_1702_LOG2E * g))


def _layer_plain(x, fw: FoldedLayer, num_heads: int, valid_len: int,
                 cls_only: bool) -> torch.Tensor:
    """The TPU kernel's function in plain PyTorch, rounding to x's dtype
    where the kernels do: LayerNorm outputs, q/k/v, the softmax numerator
    p, the attention output and the MLP hidden.  Products and bias adds
    stay f32 up to there and the residual stream is f32.  The scores of
    the pre-folded q are clamped to [-100, 80] and exponentiated with
    exp2, keys at or past ``valid_len`` get p = 0, and the sum of the
    rounded p divides p·v exactly."""
    b, s, d = x.shape
    hd = d // num_heads
    cdt = x.dtype

    def dense_t(a, w_t, bias):       # f32(a · w_tᵀ) + bias, a in x's dtype
        rows = mm_f32(a.reshape(-1, a.shape[-1]).to(cdt), w_t.to(cdt).T)
        return rows.reshape(*a.shape[:-1], -1) + bias.float()

    def heads(t):                    # [B, T, D] → [B·H, T, hd]
        t = t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
        return t.reshape(b * num_heads, -1, hd)

    h = layernorm_f32(x, fw.ln1_scale, fw.ln1_bias).to(cdt)
    kv = dense_t(h, fw.wqkv_t[d:], fw.bqkv[d:]).to(cdt)
    q = dense_t(h[:, :1] if cls_only else h, fw.wqkv_t[:d],
                fw.bqkv[:d]).to(cdt)
    k, v = kv.split(d, dim=-1)
    scores = mm_f32(heads(q), heads(k).transpose(-1, -2))
    p = torch.exp2(scores.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI))
    key_pad = torch.arange(s, device=x.device) >= valid_len
    p = p.masked_fill(key_pad, 0.0).to(cdt)
    ao = mm_f32(p, heads(v)) / p.float().sum(dim=-1, keepdim=True)
    ao = ao.to(cdt).reshape(b, num_heads, -1, hd).transpose(1, 2)
    xr = (x[:, :1] if cls_only else x).float()
    x1 = (xr + mm_f32(ao.reshape(-1, d), fw.wout_t.to(cdt).T).reshape(
        xr.shape)) + fw.bout.float()
    h2 = layernorm_f32(x1, fw.ln2_scale, fw.ln2_bias).to(cdt)
    a = quick_gelu_exp2(dense_t(h2, fw.w1_t, fw.b1)).to(cdt)
    out = (x1 + dense_t(a, fw.w2_t, fw.b2)).to(cdt)
    return out[:, 0] if cls_only else out


def _folded(x, weights, num_heads, folded):
    return folded if folded is not None else fold_layer(
        *weights, num_heads, dtype=x.dtype)


def fused_layer_block_bf16_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout,
                                 bout, ln2_scale, ln2_bias, w1, b1, w2, b2,
                                 num_heads: int, valid_len: int | None = None,
                                 group: int = GROUP,
                                 folded: FoldedLayer | None = None
                                 ) -> torch.Tensor:
    """Plain version of ``fused_layer_block_bf16``: [B, S, D] → [B, S, D];
    ``layer_composition`` when ``group`` does not divide B (``group=1``
    gives the kernel's function at any batch)."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2)
    if x.shape[0] % group:
        return layer_composition(x, *weights, num_heads, valid_len)
    return _layer_plain(x, _folded(x, weights, num_heads, folded), num_heads,
                        x.shape[1] if valid_len is None else valid_len, False)


def fused_layer_cls_bf16_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                               ln2_scale, ln2_bias, w1, b1, w2, b2,
                               num_heads: int, valid_len: int | None = None,
                               group: int = GROUP,
                               folded: FoldedLayer | None = None
                               ) -> torch.Tensor:
    """Plain version of ``fused_layer_cls_bf16``: [B, S, D] → [B, D]; row 0
    of ``layer_composition`` when ``group`` does not divide B."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2)
    if x.shape[0] % group:
        return layer_composition(x, *weights, num_heads, valid_len)[:, 0]
    return _layer_plain(x, _folded(x, weights, num_heads, folded), num_heads,
                        x.shape[1] if valid_len is None else valid_len, True)


def _kernel_check(x, fw: FoldedLayer, num_heads, valid_len) -> None:
    """Raise unless the kernels take this call: x bf16 [B, S, D], the
    folded matrices bf16 [out, in] and the vectors f32, all contiguous on
    the card, and N, K of every product multiples of 8."""
    check_cuda_tensor("x", x, torch.bfloat16)
    b, s, d = x.shape
    f = fw.w1_t.shape[0]
    check_attention_shape(d, num_heads, s, valid_len)
    if f % 8:
        raise ValueError(f"MLP width {f} must be a multiple of 8")
    for name, t, shape in (("wqkv", fw.wqkv_t, (3 * d, d)),
                           ("wout", fw.wout_t, (d, d)),
                           ("w1", fw.w1_t, (f, d)), ("w2", fw.w2_t, (d, f))):
        check_cuda_tensor(name, t, torch.bfloat16, shape)
    for name, t, n in (("ln1_scale", fw.ln1_scale, d),
                       ("ln1_bias", fw.ln1_bias, d), ("bqkv", fw.bqkv, 3 * d),
                       ("bout", fw.bout, d), ("ln2_scale", fw.ln2_scale, d),
                       ("ln2_bias", fw.ln2_bias, d), ("b1", fw.b1, f),
                       ("b2", fw.b2, d)):
        check_cuda_tensor(name, t, torch.float32, (n,))


def _launch(x, fw: FoldedLayer, num_heads: int, valid_len: int,
            cls_only: bool) -> torch.Tensor:
    """Run the row-1 (``cls_only`` False) or row-2 kernel on the card."""
    _kernel_check(x, fw, num_heads, valid_len)
    b, s, d = x.shape
    f = fw.w1_t.shape[0]
    m, dev = b * s, x.device

    def buf(rows, cols, dtype=torch.bfloat16):
        return torch.empty(rows, cols, dtype=dtype, device=dev)

    if cls_only:
        out = torch.empty(b, d, dtype=x.dtype, device=dev)
        scratch = [buf(m, d), buf(m, 2 * d), buf(b, d), buf(b, d),
                   buf(b, d, torch.float32), buf(b, d), buf(b, f)]
        name, sig = "ptt_bf16_layer_cls", _SIG_CLS
    else:
        out = torch.empty_like(x)
        scratch = [buf(m, d), buf(m, 3 * d), buf(m, d),
                   buf(m, d, torch.float32), buf(m, f)]
        name, sig = "ptt_bf16_layer", _SIG_LAYER
    _build.call(name, sig, _build.ptr(x), _build.ptr(out), b, s, d,
                num_heads, f, valid_len, *map(_build.ptr, fw),
                *map(_build.ptr, scratch), _build.stream(dev))
    if cls_only:
        fused_layer_cls_bf16.launches += 1
    else:
        fused_layer_block_bf16.launches += 1
    count_tile(d, num_heads)
    return out


def fused_layer_block_bf16(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                           ln2_scale, ln2_bias, w1, b1, w2, b2,
                           num_heads: int, valid_len: int | None = None,
                           group: int = GROUP,
                           folded: FoldedLayer | None = None) -> torch.Tensor:
    """One whole pre-LN layer ``x + attn(LN1(x)); · + mlp(LN2(·))``.
    Inference only.  The weights are unfolded (Flax layout, f32 or bf16)
    and folded here, unless ``folded`` (``fold_layer`` of the same weights,
    made once by the caller) is given.  CPU tensor, or a batch that
    ``group`` does not divide: the plain version (there
    ``layer_composition``); CUDA tensor (bf16): the kernel, or an error."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2)
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu" or x.shape[0] % group:
        return fused_layer_block_bf16_plain(x, *weights, num_heads, valid_len,
                                            group, folded)
    return _launch(x, _folded(x, weights, num_heads, folded), num_heads,
                   valid_len, False)


fused_layer_block_bf16.launches = 0


def fused_layer_cls_bf16(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout,
                         ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads: int,
                         valid_len: int | None = None, group: int = GROUP,
                         folded: FoldedLayer | None = None) -> torch.Tensor:
    """Row 0 (CLS) of ``fused_layer_block_bf16`` → [B, D]: LN1 and K/V over
    every row, the rest for the CLS row only.  Weights and ``folded`` as
    there.  CPU tensor, or a batch that ``group`` does not divide: the
    plain version; CUDA tensor (bf16): the kernel, or an error."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
               ln2_bias, w1, b1, w2, b2)
    valid_len = x.shape[1] if valid_len is None else valid_len
    if x.device.type == "cpu" or x.shape[0] % group:
        return fused_layer_cls_bf16_plain(x, *weights, num_heads, valid_len,
                                          group, folded)
    return _launch(x, _folded(x, weights, num_heads, folded), num_heads,
                   valid_len, True)


fused_layer_cls_bf16.launches = 0


# The layer's four GEMM instances (csrc/wgmma_gemm.cuh), by the index the C
# entry takes: the epilogue, the residual's dtype, the output's dtype.
GEMM_EPILOGUES = {"bias": (0, None, torch.bfloat16),
                  "bias_gelu": (1, None, torch.bfloat16),
                  "res_bias": (2, torch.bfloat16, torch.float32),
                  "bias_res": (3, torch.float32, torch.bfloat16)}


def layer_gemm_plain(a, w_t, bias, epilogue: str = "bias",
                     res: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``layer_gemm``: f32(a · w_tᵀ) of the bf16 values,
    then the epilogue in f32, rounded to the instance's output dtype."""
    _idx, _rdt, odt = GEMM_EPILOGUES[epilogue]
    v = mm_f32(a, w_t.T)
    if epilogue == "bias":
        v = v + bias
    elif epilogue == "bias_gelu":
        v = quick_gelu_exp2(v + bias)
    elif epilogue == "res_bias":
        v = (res.float() + v) + bias
    else:
        v = res.float() + (v + bias)
    return v.to(odt)


def layer_gemm(a, w_t, bias, epilogue: str = "bias",
               res: torch.Tensor | None = None) -> torch.Tensor:
    """One of the layer's GEMMs on its own (for checks and timing): C =
    epi(a · w_tᵀ + bias), a [M, K] bf16, w_t [N, K] bf16, bias [N] f32, res
    [M, N] in the instance's residual dtype; ``epilogue`` one of
    ``GEMM_EPILOGUES``.  CPU tensor: the plain version; CUDA tensor: the
    kernel, or an error."""
    if a.device.type == "cpu":
        return layer_gemm_plain(a, w_t, bias, epilogue, res)
    idx, rdt, odt = GEMM_EPILOGUES[epilogue]
    check_cuda_tensor("a", a, torch.bfloat16)
    m, k = a.shape
    n = w_t.shape[0]
    check_cuda_tensor("w_t", w_t, torch.bfloat16, (n, k))
    check_cuda_tensor("bias", bias, torch.float32, (n,))
    if n % 8 or k % 8:
        raise ValueError(f"N ({n}) and K ({k}) must be multiples of 8")
    if rdt is not None:
        check_cuda_tensor("res", res, rdt, (m, n))
    out = torch.empty(m, n, dtype=odt, device=a.device)
    _build.call("ptt_wgmma_gemm", _SIG_GEMM, idx, _build.ptr(a), k,
                _build.ptr(w_t), k, _build.ptr(bias),
                _build.ptr(res) if rdt is not None else None, n,
                _build.ptr(out), n, m, n, k, _build.stream(a.device))
    layer_gemm.launches += 1
    return out


layer_gemm.launches = 0
