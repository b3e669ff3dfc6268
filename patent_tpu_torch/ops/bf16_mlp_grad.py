"""The trainable MLP block ``x + mlp(LayerNorm(x))`` of the fine-tune tower
(port of patent_tpu/ops/bf16_mlp_grad.py), a ``torch.autograd.Function``
with a kernel forward and a kernel backward.

* forward (``fused_mlp_fwd``, TPU row 15): f32 LayerNorm → bf16 dot W1 + b1
  → quick_gelu in exp2 form → bf16 dot W2 + b2 → + x;
* backward (``fused_mlp_bwd``, TPU row 16): recomputes the hidden from the
  saved input (the forward saves only its inputs, so activation memory
  holds no [M, 3072] tensor) and returns dx and the six parameter
  cotangents, summed in f32 over all rows.

On a CUDA tensor each launches its kernel (csrc/mlp_grad.cu: every
product on the Hopper GEMM of csrc/wgmma_gemm.cuh, the backward's weight
gradients through its MN-major form, ``weight_grad``) or raises;
on a CPU tensor each runs its plain version below, which rounds where the
kernels do.  Cotangents come back in the dtypes passed in: the caller's
casts (f32 masters to bf16 matrices) are differentiated by autograd.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .common import NEG_1702_LOG2E, check_cuda_tensor, layernorm_f32, mm_f32

_P, _I = _build.P, _build.I
_SIG_FWD = [_P, _P] + [_I] * 3 + [_P] * 8 + [_P]
_SIG_BWD = [_P] * 15 + [_I] * 4 + [_P] * 6 + [_P]
_SIG_WGRAD = [_P] * 3 + [_I] * 3 + [_P, _P]
# rows of the backward's transient hidden ([CHUNK, F] bf16 and f32): the
# fine-tune's 64 pairs (25,216 rows) are one chunk
CHUNK_ROWS = 32768


def weight_grad_plan(rows: int, m: int, n: int) -> int:
    """The ranges of whole 64-row k-steps into which ``weight_grad`` splits
    an [m, n] gradient over ``rows`` rows on the current card
    (csrc/wgmma_gemm.cuh ``tn_splits``)."""
    out = ctypes.c_int(0)
    _build.call("ptt_weight_grad_plan", [_I] * 3 + [_P], m, n, rows,
                ctypes.byref(out))
    return out.value


def _ln_stats(xf, eps: float = 1e-5):
    """(xn, rstd) of the f32 LayerNorm ``layernorm_f32`` computes, which
    its backward needs: ``layernorm_f32(x) == xn * scale + bias``."""
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _gelu_and_sig(g):
    s = 1.0 / (1.0 + torch.exp2(NEG_1702_LOG2E * g))
    return g * s, s


def fused_mlp_block_bf16_plain(x2, lns, lnb, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of row 15: x2 [M, D] (bf16) → [M, D] in x2's dtype."""
    xf = x2.float()
    h = layernorm_f32(xf, lns, lnb)
    g =mm_f32(h.to(torch.bfloat16), w1) + b1.float()
    a, _ = _gelu_and_sig(g)
    out = mm_f32(a.to(torch.bfloat16), w2) + b2.float()
    return (xf + out).to(x2.dtype)


def _mlp_bwd_plain(x2, do2, lns, lnb, w1, b1, w2):
    """Plain version of row 16: (dx in x2's dtype, dls, dlb, dw1, db1, dw2,
    db2 in f32), with the kernel's operand roundings (h, a, do and dg in
    bf16 going into the products)."""
    bf = torch.bfloat16
    lns = lns.float()
    xf = x2.float()
    xn, rstd = _ln_stats(xf)
    h16 = (xn * lns + lnb.float()).to(bf)
    g = mm_f32(h16, w1) + b1.float()
    a, s = _gelu_and_sig(g)
    do = do2.float()
    do16 = do2.to(bf)
    dw2 = mm_f32(a.to(bf).T, do16)
    db2 = do.sum(0)
    da = mm_f32(do16, w2.T)
    dg = da * (s * (1.0 + 1.702 * g * (1.0 - s)))
    dg16 = dg.to(bf)
    dw1 = mm_f32(h16.T, dg16)
    db1 = dg.sum(0)
    dh = mm_f32(dg16, w1.T)
    dls = (dh * xn).sum(0)
    dlb = dh.sum(0)
    dxn = dh * lns
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    dx = (do + (dxn - m1 - xn * m2) * rstd).to(x2.dtype)
    return dx, dls, dlb, dw1, db1, dw2, db2


def _check(x2, lns, lnb, w1, b1, w2, b2=None) -> tuple[int, int, int]:
    """Raise unless the CUDA kernels take this call: x2 [M, D] and the
    matrices bf16, vectors f32, all contiguous on the card; (M, D, F)."""
    check_cuda_tensor("x", x2, torch.bfloat16)
    m, d = x2.shape
    f = w1.shape[1]
    if d % 8 or f % 8:
        raise ValueError(f"widths D={d}, F={f} must be multiples of 8")
    check_cuda_tensor("w1", w1, torch.bfloat16, (d, f))
    check_cuda_tensor("w2", w2, torch.bfloat16, (f, d))
    for name, t, n in (("ln_scale", lns, d), ("ln_bias", lnb, d),
                       ("b1", b1, f), ("b2", b2, d)):
        if t is not None:
            check_cuda_tensor(name, t, torch.float32, (n,))
    return m, d, f


def fused_mlp_fwd(x2, lns, lnb, w1, b1, w2, b2) -> torch.Tensor:
    """Row 15.  CPU tensor: the plain version; CUDA tensor (bf16 x2 and
    matrices, f32 vectors): the kernel, or an error."""
    if x2.device.type == "cpu":
        return fused_mlp_block_bf16_plain(x2, lns, lnb, w1, b1, w2, b2)
    m, d, f = _check(x2, lns, lnb, w1, b1, w2, b2)
    dev = x2.device
    out = torch.empty_like(x2)
    # the GEMM reads its second operand as [N, K]: W1ᵀ [F, D], W2ᵀ [D, F]
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    scratch = [torch.empty(m, d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, f, dtype=torch.bfloat16, device=dev)]
    _build.call("ptt_mlp_fwd", _SIG_FWD, _build.ptr(x2), _build.ptr(out), m,
                d, f, *map(_build.ptr, (lns, lnb, w1t, b1, w2t, b2,
                                        *scratch)),
                _build.stream(dev))
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(x2, do2, lns, lnb, w1, b1, w2):
    """Row 16: (dx, dls, dlb, dw1, db1, dw2, db2).  CPU tensor: the plain
    version; CUDA tensor: the kernel, or an error."""
    if x2.device.type == "cpu":
        return _mlp_bwd_plain(x2, do2, lns, lnb, w1, b1, w2)
    m, d, f = _check(x2, lns, lnb, w1, b1, w2)
    check_cuda_tensor("dout", do2, torch.bfloat16, (m, d))
    dev = x2.device

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x2)
    grads = [zeros(d), zeros(d), zeros(d, f), zeros(f), zeros(f, d),
             zeros(d)]
    c = min(m, CHUNK_ROWS)
    part = ctypes.c_longlong(0)           # the partials' f32 values
    _build.call("ptt_mlp_bwd_part", [_I] * 4 + [_P], m, c, d, f,
                ctypes.byref(part))
    bf = torch.bfloat16
    w1t = w1.t().contiguous()
    scratch = [torch.empty(c, d, dtype=bf, device=dev),
               torch.empty(c, f, dtype=bf, device=dev),
               torch.empty(c, f, dtype=torch.float32, device=dev),
               torch.empty(c, f, dtype=bf, device=dev),
               torch.empty(c, d, dtype=torch.float32, device=dev),
               torch.empty(part.value, dtype=torch.float32, device=dev)]
    _build.call("ptt_mlp_bwd", _SIG_BWD,
                *map(_build.ptr, (x2, do2, lns, lnb, w1, w1t, b1, w2, dx,
                                  *grads)),
                m, d, f, c, *map(_build.ptr, scratch), _build.stream(dev))
    fused_mlp_bwd.launches += 1
    return (dx, *grads)


fused_mlp_bwd.launches = 0


def weight_grad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``weight_grad``: f32 aᵀ b of the bf16 values."""
    return mm_f32(a.T, b)


def weight_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 16's weight-gradient GEMM alone (for checks and timing): aᵀ b
    [M, N] in f32 of a [K, M] and b [K, N] bf16, row-major, a reduction
    over their K rows split as the backward splits it
    (``weight_grad_plan``).  CPU tensor: the plain version; CUDA tensor:
    the kernel, or an error."""
    if a.device.type == "cpu":
        return weight_grad_plain(a, b)
    check_cuda_tensor("a", a, torch.bfloat16)
    k, m = a.shape
    n = b.shape[1]
    check_cuda_tensor("b", b, torch.bfloat16, (k, n))
    if m % 8 or n % 8:
        raise ValueError(f"widths M={m}, N={n} must be multiples of 8")
    dev = a.device
    out = torch.zeros(m, n, dtype=torch.float32, device=dev)
    part = torch.empty(weight_grad_plan(k, m, n), m, n, dtype=torch.float32,
                       device=dev)
    _build.call("ptt_weight_grad", _SIG_WGRAD, _build.ptr(a), _build.ptr(b),
                _build.ptr(out), m, n, k, _build.ptr(part),
                _build.stream(dev))
    weight_grad.launches += 1
    return out


weight_grad.launches = 0


class _FusedMLPBlock(torch.autograd.Function):
    """Rows 15 and 16 on [M, D] rows.  Saves only its inputs."""

    @staticmethod
    def forward(ctx, x2, lns, lnb, w1, b1, w2, b2, kernels):
        ctx.save_for_backward(x2, lns, lnb, w1, b1, w2, b2)
        ctx.kernels = kernels
        fwd = fused_mlp_fwd if kernels else fused_mlp_block_bf16_plain
        return fwd(x2, lns, lnb, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x2, lns, lnb, w1, b1, w2, b2 = ctx.saved_tensors
        bwd = fused_mlp_bwd if ctx.kernels else _mlp_bwd_plain
        dx, dls, dlb, dw1, db1, dw2, db2 = bwd(
            x2, dout.to(x2.dtype).contiguous(), lns, lnb, w1, b1, w2)
        return (dx if ctx.needs_input_grad[0] else None, dls.to(lns.dtype),
                dlb.to(lnb.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None)


def fused_mlp_block_bf16(x, ln_scale, ln_bias, w1, b1, w2, b2,
                         kernels: bool = True) -> torch.Tensor:
    """``x + mlp(LayerNorm(x))``, differentiable.  x [..., D] (bf16); w1
    [D, F], w2 [F, D]; vectors 1-D.  The matrices are cast to bf16 and the
    vectors to f32 here, as the JAX wrapper casts them, and autograd
    carries the cotangents back through the casts.  ``kernels=False`` runs
    the plain versions on any device."""
    *lead, d = x.shape
    out = _FusedMLPBlock.apply(
        x.reshape(-1, d).contiguous(), ln_scale.float(), ln_bias.float(),
        w1.to(torch.bfloat16).contiguous(), b1.float(),
        w2.to(torch.bfloat16).contiguous(), b2.float(), kernels)
    return out.reshape(*lead, d)
