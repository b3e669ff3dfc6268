"""Attention of the JAX package's patent_tpu/ops/flash_attention.py: the
exp2-domain score clamp and one-pass softmax·v the serving layers share,
the standalone attention ``flash_attention`` of the ``use_flash`` tower
(TPU row 14; on a CUDA tensor the kernel of csrc/flash_attention.cu in
bf16 or of csrc/flash_attention_f32.cu in f32, ``flash_attention_plain``
on a CPU tensor; inference only, as the TPU kernel has no VJP), and the
trainable attention sub-layer
``fused_attention_block`` of the fine-tune tower with its backward.

``fused_attention_block`` computes ``(x Wqkv + b) → MHA → @ Wout + b``
(pre-residual) as a ``torch.autograd.Function``.  The fold of
log2(e)/√hd into the q columns, the pad of the token axis to a multiple of
16 and the slice back stay outside the Function, as in JAX, so autograd
differentiates them.  Inside it:

* forward (``fused_attention_fwd``, TPU row 12): on a CUDA tensor the
  kernel of csrc/fused_attention.cu, on a CPU tensor its plain version
  ``fused_attention_block_plain``;
* backward (``_fab_bwd``): recompute qkv, ``da = dout Woutᵀ``, then
  ``fused_attention_bwd`` (TPU row 13: kernel, or ``attention_bwd_plain``
  on the CPU) gives dqkv and the head outputs A, and the five products
  ``dWout = Aᵀ dout``, ``dbout``, ``dx = dqkv W′ᵀ``, ``dW′ = xᵀ dqkv``,
  ``db′`` follow as plain products of bf16 values summed in f32.  Nothing
  [S, S]-sized is kept from the forward: only its inputs.

The exp2 form clamps scores to [-100, 80] and the backward gates the
gradient of scores at or above +80 to zero, so a head whose logits
saturate stops learning; ``attention_saturation`` watches for it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build
from .common import (check_attention_shape, check_cuda_tensor, count_tile,
                     mm_f32, refuse_grad, round_up, tile_width, weak_scalar)

SCORE_CLAMP_LO = -100.0
SCORE_CLAMP_HI = 80.0
_LN2 = math.log(2.0)
_P, _I, _L, _F = _build.P, _build.I, _build.L, _build.F
_SIG_FWD = [_P, _P] + [_I] * 5 + [_P] * 6 + [_P]
_SIG_BWD = [_P] * 6 + [_I] * 5 + [_P] * 3 + [_P]
_SIG_BWD_PLAN = [_I, _I, _P, _P]
_SIG_FLASH = [_P] * 4 + [_I] * 4 + [_L, _I, _L, _I, _F, _P]


def one_pass_softmax_pv(q: torch.Tensor, k: torch.Tensor, v_ext: torch.Tensor,
                        dp: int) -> torch.Tensor:
    """``softmax(q kᵀ) v`` in the TPU kernel's one-pass form.

    q [Sq, dp] carries the score scale and log2(e) already; scores are
    clamped to [SCORE_CLAMP_LO, SCORE_CLAMP_HI] and exponentiated with exp2
    (no max subtraction).  ``v_ext`` [Sk, dp+1] is V with the pad rows zeroed
    and a 0/1 valid-key column appended, so one product delivers the masked
    numerator and denominator; p is rounded to v's dtype for that product.
    """
    s = q.float() @ k.float().T
    p = torch.exp2(s.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI)).to(v_ext.dtype)
    o_ext = p.float() @ v_ext.float()
    return o_ext[:, :dp] / o_ext[:, dp:dp + 1]


def valid_col(sp: int, seq_len: int, dtype: torch.dtype,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """[sp, 1] column: 1 for rows below ``seq_len``, 0 for pad rows."""
    return (torch.arange(sp, device=device)[:, None] < seq_len).to(dtype)


def attention_saturation(x: torch.Tensor, wqkv: torch.Tensor,
                         bqkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Max pre-clamp exp2-domain attention score of one block, to compare
    with ``SCORE_CLAMP_HI``: near it, the gated backward zeroes the
    gradient of the saturated scores.  ``x``: the block's post-LN
    activations [B, S, D]; weights as ``fused_attention_block`` takes
    them."""
    b, s, d = x.shape
    hd = d // num_heads
    qkv = x @ wqkv + bqkv.reshape(-1)
    q = qkv[..., :d].reshape(b, s, num_heads, hd)
    k = qkv[..., d:2 * d].reshape(b, s, num_heads, hd)
    scale2 = math.log2(math.e) / math.sqrt(hd)
    return torch.einsum("bqhd,bkhd->bhqk", q * scale2, k).max()


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, D] → [B·H, S, hd]."""
    b, s, d = t.shape
    return (t.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)
            .reshape(b * num_heads, s, d // num_heads))


def _unheads(t: torch.Tensor, b: int) -> torch.Tensor:
    """[B·H, S, hd] → [B, S, D]."""
    bh, s, hd = t.shape
    return t.reshape(b, bh // b, s, hd).transpose(1, 2).reshape(b, s, -1)


def _qkv(x, wqkv_f, bqkv_f) -> torch.Tensor:
    """bf16(x W′ + b′), f32 accumulation: [B, S, 3D]."""
    b, s, d = x.shape
    return (mm_f32(x.reshape(-1, d), wqkv_f) + bqkv_f.float()).to(
        x.dtype).reshape(b, s, -1)


def _scores_p(q, k, valid_len: int):
    """(s, p): f32 scores q kᵀ [B·H, S, S] and p = bf16(exp2(clip(s))) with
    the pad keys' p set to 0 (what the zeroed V rows and the 0/1 valid
    column of the TPU kernel's V_ext make of them)."""
    s = mm_f32(q, k.transpose(1, 2))
    p = torch.exp2(s.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI))
    key_pad = torch.arange(s.shape[-1], device=s.device) >= valid_len
    return s, p.masked_fill(key_pad, 0.0).to(q.dtype)


def fused_attention_block_plain(x, wqkv_f, bqkv_f, wout, bout, num_heads: int,
                                valid_len: int) -> torch.Tensor:
    """Plain version of the row-12 kernel on the padded stream x [B, S, D]
    with pre-folded weights: qkv rounded after the f32 bias add, p rounded
    before p·v, ``ao = bf16((p v) / sum p)``, then ``bf16(ao Wout + bout)``
    (pre-residual)."""
    b, s, d = x.shape
    qkv = _qkv(x, wqkv_f, bqkv_f)
    q, k, v = (_heads(t.contiguous(), num_heads) for t in qkv.split(d, -1))
    _s, p = _scores_p(q, k, valid_len)
    ao = (mm_f32(p, v) / p.float().sum(-1, keepdim=True)).to(x.dtype)
    out = mm_f32(_unheads(ao, b).reshape(-1, d), wout) + bout.float()
    return out.to(x.dtype).reshape(b, s, d)


def _windows(t: torch.Tensor, d: int, hd: int, w: int,
             sections: int) -> torch.Tensor:
    """[..., sections·D] → [..., sections·H·w]: each head's w columns from
    h·hd of its section, zeros past the row's end."""
    t = F.pad(t, (0, w))
    return torch.cat([t[..., sec * d + h * hd:sec * d + h * hd + w]
                      for sec in range(sections) for h in range(d // hd)], -1)


def attention_bwd_plain(x, wqkv_f, bqkv_f, da, num_heads: int,
                        valid_len: int, gate: bool = True,
                        read_width: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the row-13 kernel: recompute qkv, then (dqkv
    [B, S, 3D] in pre-scaled-q coordinates, A [B, S, D] the head outputs),
    both bf16, from da = dout Woutᵀ [B, S, D] bf16.  Scores at or above the
    +80 clamp get a zero gradient (the gate; ``gate=False`` drops it, a
    control that checks must tell apart); pad keys get dk = dv = 0.
    ``read_width`` (a control too): each head's q, k, v and da read as
    that many columns from h·hd (the next head's first columns, or zeros
    past the row), as a kernel on an instance wider than hd would read
    them without zero-filling its columns past hd, and the outputs cut
    back to hd columns."""
    b, s, d = x.shape
    cdt = x.dtype
    hd = d // num_heads
    w = read_width or hd
    qkv = _qkv(x, wqkv_f, bqkv_f)
    if w != hd:
        qkv, da = _windows(qkv, d, hd, w, 3), _windows(da, d, hd, w, 1)
    q, k, v = (_heads(t.contiguous(), num_heads)
               for t in qkv.split(num_heads * w, -1))
    sc, p = _scores_p(q, k, valid_len)
    valid = (torch.arange(s, device=x.device) < valid_len).float()
    o_ext = mm_f32(p, v)
    den = p.float().sum(-1, keepdim=True)
    o = o_ext / den
    do = _heads(da, num_heads).float()
    dn = (do / den).to(cdt)
    dden = (-(do * o).sum(-1, keepdim=True) / den).to(cdt)
    dp = mm_f32(dn, v.transpose(1, 2)) + dden.float() * valid
    ds = _LN2 * dp * p.float()
    if gate:
        ds = torch.where(sc < SCORE_CLAMP_HI, ds, 0.0)
    ds = ds.to(cdt)
    dq = mm_f32(ds, k)
    dk = mm_f32(ds.transpose(1, 2), q)
    dv = mm_f32(p.transpose(1, 2), dn) * valid[:, None]
    outs = [t[..., :hd] if w != hd else t for t in (dq, dk, dv, o)]
    dqkv = torch.cat([_unheads(t.to(cdt), b) for t in outs[:3]], -1)
    return dqkv, _unheads(outs[3].to(cdt), b)


def _kernel_check(x, num_heads, valid_len, mats, vecs) -> None:
    """Raise unless the CUDA kernel takes this call: x [B, S, D] and the
    matrices bf16, the biases f32, all contiguous on the card, and the
    shape within the attention kernels' contract."""
    check_cuda_tensor("x", x, torch.bfloat16)
    b, s, d = x.shape
    check_attention_shape(d, num_heads, s, valid_len)
    for name, t, shape in mats:
        check_cuda_tensor(name, t, torch.bfloat16, shape)
    for name, t, n in vecs:
        check_cuda_tensor(name, t, torch.float32, (n,))


def fused_attention_fwd(x, wqkv_f, bqkv_f, wout, bout, num_heads: int,
                        valid_len: int) -> torch.Tensor:
    """Row 12: the attention sub-layer forward on the padded stream.  CPU
    tensor: the plain version; CUDA tensor (bf16 x and matrices, f32
    biases): the kernel, or an error.  The kernel's GEMMs read each weight
    transposed, [out, in]; the fine-tune's weights change every step, so
    the transposes (4.7 MB a layer at ViT-B/16) are made per call."""
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, wqkv_f, bqkv_f, wout, bout,
                                           num_heads, valid_len)
    b, s, d = x.shape
    _kernel_check(x, num_heads, valid_len,
                  [("wqkv", wqkv_f, (d, 3 * d)), ("wout", wout, (d, d))],
                  [("bqkv", bqkv_f, 3 * d), ("bout", bout, d)])
    m, dev = b * s, x.device
    out = torch.empty_like(x)
    wqkv_t, wout_t = wqkv_f.t().contiguous(), wout.t().contiguous()
    scratch = [torch.empty(m, 3 * d, dtype=torch.bfloat16, device=dev),
               torch.empty(m, d, dtype=torch.bfloat16, device=dev)]
    _build.call("ptt_fab_fwd", _SIG_FWD, _build.ptr(x), _build.ptr(out), b, s,
                d, num_heads, valid_len,
                *map(_build.ptr, (wqkv_t, bqkv_f, wout_t, bout, *scratch)),
                _build.stream(dev))
    fused_attention_fwd.launches += 1
    count_tile(d, num_heads)
    return out


fused_attention_fwd.launches = 0


def attention_bwd_plan(s: int, hd: int) -> tuple[bool, int]:
    """Row 13's plan on the card at a padded S and head width hd, from the
    kernel library (csrc/fused_attention.cu's ptt_fab_bwd_plan): whether
    it streams (the resident kernel holds one (head, image)'s whole
    sequence in a block's shared memory, at head widths up to 64 where it
    fits; past either it streams), and the keys a stage of the streamed
    row pass's ring holds."""
    streamed, ring = ctypes.c_int(0), ctypes.c_int(0)
    _build.call("ptt_fab_bwd_plan", _SIG_BWD_PLAN, s, hd,
                ctypes.byref(streamed), ctypes.byref(ring))
    return bool(streamed.value), ring.value


def fused_attention_bwd(x, wqkv_f, bqkv_f, da, num_heads: int,
                        valid_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row 13: (dqkv, A) from the saved inputs and da.  CPU tensor: the
    plain version; CUDA tensor (bf16): the kernel, or an error; the
    kernel's qkv recompute reads Wqkv′ transposed, made per call as in
    ``fused_attention_fwd``.  The path is ``attention_bwd_plan``'s.
    Launches are counted in ``launches`` and by instance width and path in
    ``instances`` ("hd64", "hd64_streamed", ...)."""
    if x.device.type == "cpu":
        return attention_bwd_plain(x, wqkv_f, bqkv_f, da, num_heads,
                                   valid_len)
    b, s, d = x.shape
    _kernel_check(x, num_heads, valid_len,
                  [("wqkv", wqkv_f, (d, 3 * d)), ("da", da, (b, s, d))],
                  [("bqkv", bqkv_f, 3 * d)])
    hd = d // num_heads
    streamed, _ring = attention_bwd_plan(s, hd)
    dev = x.device
    dqkv = torch.empty(b, s, 3 * d, dtype=torch.bfloat16, device=dev)
    a = torch.empty_like(x)
    qkv = torch.empty(b * s, 3 * d, dtype=torch.bfloat16, device=dev)
    dn = dden = None
    if streamed:
        dn = torch.empty(b, s, d, dtype=torch.bfloat16, device=dev)
        dden = torch.empty(b, num_heads, s, dtype=torch.float32, device=dev)
    _build.call("ptt_fab_bwd", _SIG_BWD,
                *map(_build.ptr, (x, wqkv_f.t().contiguous(), bqkv_f, da, dqkv,
                                  a)), b, s, d, num_heads, valid_len,
                _build.ptr(qkv),
                *(None if t is None else _build.ptr(t) for t in (dn, dden)),
                _build.stream(dev))
    fused_attention_bwd.launches += 1
    key = f"hd{tile_width(hd)}" + ("_streamed" if streamed else "")
    inst = fused_attention_bwd.instances
    inst[key] = inst.get(key, 0) + 1
    return dqkv, a


fused_attention_bwd.launches = 0
fused_attention_bwd.instances = {}


def _fab_bwd(x, wqkv_f, bqkv_f, wout, dout, num_heads: int, valid_len: int,
             attention_bwd=fused_attention_bwd, need_dx: bool = True):
    """The Function's backward (JAX ``_fab_bwd``): (dx, dW′, db′, dWout,
    dbout), dx None unless ``need_dx``.  The products take bf16 values and
    sum in f32, as JAX's f32 products of the same values do; each result
    is rounded to its primal's dtype (dbout to Wout's, as JAX does)."""
    b, s, d = x.shape
    dout = dout.to(x.dtype).contiguous()
    dout2 = dout.reshape(-1, d)
    da = mm_f32(dout2, wout.T).to(x.dtype).reshape(b, s, d)
    dqkv, a = attention_bwd(x, wqkv_f, bqkv_f.float(), da, num_heads,
                            valid_len)
    dqkv2 = dqkv.reshape(-1, 3 * d)
    dwout = mm_f32(a.reshape(-1, d).T, dout2).to(wout.dtype)
    dbout = dout2.float().sum(0).to(wout.dtype)
    dx = (mm_f32(dqkv2, wqkv_f.T).to(x.dtype).reshape(b, s, d)
          if need_dx else None)
    dwqkv = mm_f32(x.reshape(-1, d).T, dqkv2).to(wqkv_f.dtype)
    dbqkv = dqkv2.float().sum(0).to(bqkv_f.dtype)
    return dx, dwqkv, dbqkv, dwout, dbout


class _FusedAttentionBlock(torch.autograd.Function):
    """Rows 12 and 13 on the padded stream with pre-folded weights.  Saves
    only its inputs."""

    @staticmethod
    def forward(ctx, x, wqkv_f, bqkv_f, wout, bout, num_heads, valid_len,
                kernels):
        ctx.save_for_backward(x, wqkv_f, bqkv_f, wout)
        ctx.num_heads, ctx.valid_len, ctx.kernels = num_heads, valid_len, \
            kernels
        ctx.bout_dtype = bout.dtype
        fwd = fused_attention_fwd if kernels else fused_attention_block_plain
        return fwd(x, wqkv_f, bqkv_f.float(), wout, bout.float(), num_heads,
                   valid_len)

    @staticmethod
    def backward(ctx, dout):
        x, wqkv_f, bqkv_f, wout = ctx.saved_tensors
        dx, dw, db, dwout, dbout = _fab_bwd(
            x, wqkv_f, bqkv_f, wout, dout, ctx.num_heads, ctx.valid_len,
            attention_bwd=(fused_attention_bwd if ctx.kernels
                           else attention_bwd_plain),
            need_dx=ctx.needs_input_grad[0])
        return dx, dw, db, dwout, dbout.to(ctx.bout_dtype), None, None, None


def fused_attention_block(x, wqkv, bqkv, wout, bout, num_heads: int,
                          kernels: bool = True) -> torch.Tensor:
    """Attention sub-layer ``(x Wqkv + b) → MHA → @ Wout + b`` (pre-residual),
    differentiable.  x [B, S, D] (post-LN activations, in the compute
    dtype), wqkv [D, 3D], bqkv [3D], wout [D, D], bout [D] in the compute
    dtype as the tower casts them.  ``kernels=False`` runs the plain
    versions on any device (the card's reference)."""
    b, s, d = x.shape
    scale2 = math.log2(math.e) / math.sqrt(d // num_heads)
    # JAX's fold multiplies by a Python scalar, which takes the weights' dtype
    wqkv_f = torch.cat([wqkv[:, :d] * weak_scalar(scale2, wqkv.dtype),
                        wqkv[:, d:]], dim=1)
    bqkv_f = torch.cat([bqkv[:d] * weak_scalar(scale2, bqkv.dtype), bqkv[d:]])
    sp = round_up(max(s, 16), 16)
    xp = F.pad(x, (0, 0, 0, sp - s)).contiguous()
    out = _FusedAttentionBlock.apply(xp, wqkv_f.contiguous(), bqkv_f, wout,
                                     bout, num_heads, s, kernels)
    return out[:, :s]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          head_batch: bool = True, *,
                          pad_keys_to: int | None = None, scale: bool = True,
                          clamp: bool = True) -> torch.Tensor:
    """The row-14 TPU kernel's function in plain PyTorch: q, k, v
    [B, S, H, D] → [B, S, H, D] in q's dtype.  q times log2(e)/√D in f32,
    rounded back to q's dtype; f32 scores q kᵀ; p = exp2(clip(s, -100,
    80)) rounded to v's dtype; f32 sums of the rounded p over the S keys,
    then an exact f32 divide.  ``head_batch`` picks one of the TPU
    kernel's two tilings of this same function, so it changes nothing.

    Controls that a check must tell apart from the kernel, each off by
    default: ``pad_keys_to`` counts zero keys up to that length (the
    padding without its mask), ``scale=False`` leaves q unscaled,
    ``clamp=False`` exponentiates the scores unclamped."""
    del head_batch
    b, s, h, d = q.shape
    qs = q
    if scale:
        qs = (q.float() * ((1.0 / math.sqrt(d)) * math.log2(math.e))).to(
            q.dtype)
    kf, vf = k.float(), v.float()
    if pad_keys_to is not None:
        kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad_keys_to - s)) for t in (kf, vf))
    sc = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    if clamp:
        sc = sc.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI)
    p = torch.exp2(sc).to(v.dtype).float()
    num = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return (num / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


def _flash_check(q, k, v) -> None:
    """Raise unless the row-14 kernel takes q, k, v: [B, S, H, D] of one
    dtype, bf16 or f32, on the card with each row's [H, D] packed (a
    slice of a wider row, as q, k, v of one qkv tensor are, is read in
    place), 16-byte aligned, k and v with the same strides; in the
    attention kernels' contract (D a multiple of 8 up to 128, any S: the
    f32 kernel streams the keys in tiles too)."""
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in (torch.bfloat16, torch.float32) or \
                t.dtype != q.dtype:
            raise ValueError(f"{name}: the row-14 kernel takes bfloat16 or "
                             f"float32, all three alike; got {t.dtype} "
                             f"(q {q.dtype})")
        if tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"{name}: expected shape {(b, s, h, d)}, got "
                             f"{tuple(t.shape)}")
        st = t.stride()
        per16 = 16 // t.element_size()
        if (st[3] != 1 or st[2] != d or st[1] % per16 or st[0] % per16
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: each row's [H, D] must be packed and "
                             f"16-byte aligned, got strides {st}")
    if k.stride() != v.stride():
        raise ValueError(f"k and v differ in strides: {k.stride()}, "
                         f"{v.stride()}")
    check_attention_shape(h * d, h, round_up(s, 16), s)


def _launch_flash(name: str, q, k, v) -> torch.Tensor:
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    _build.call(name, _SIG_FLASH, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                _build.ptr(out), b, s, h, d, q.stride(0), q.stride(1),
                k.stride(0), k.stride(1),
                (1.0 / math.sqrt(d)) * math.log2(math.e),
                _build.stream(q.device))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    head_batch: bool = True) -> torch.Tensor:
    """softmax(q kᵀ/√D) v for q, k, v [B, S, H, D] → [B, S, H, D], the
    TPU kernel's exp2 form (``flash_attention_plain``) in q's dtype.
    Inference only.  CPU tensor: the plain version; CUDA tensor (head_dim
    a multiple of 8 up to 128): bf16 the kernel, f32
    ``flash_attention_f32``, anything else an error."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, head_batch)
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v)
    _flash_check(q, k, v)
    refuse_grad("flash_attention", q, k, v)
    out = _launch_flash("ptt_flash_attention", q, k, v)
    flash_attention.launches += 1
    count_tile(q.shape[2] * q.shape[3], q.shape[2])
    return out


flash_attention.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Row 14's f32 instance (``flash_attention`` on f32 tensors): the
    plain version's f32 function, products and sums in f32 with no TF32.
    CPU tensor: the plain version; CUDA tensor (f32): the kernel, or an
    error.  Launches are counted in ``launches`` and by instance width in
    ``instances`` ("hd64", "hd80", ...)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _flash_check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_f32 takes float32, got {q.dtype}")
    refuse_grad("flash_attention", q, k, v)
    out = _launch_flash("ptt_flash_attention_f32", q, k, v)
    flash_attention_f32.launches += 1
    key = f"hd{tile_width(q.shape[3])}"
    inst = flash_attention_f32.instances
    inst[key] = inst.get(key, 0) + 1
    return out


flash_attention_f32.launches = 0
flash_attention_f32.instances = {}
