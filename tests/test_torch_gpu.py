"""The CUDA kernels of patent_tpu_torch against their plain PyTorch
versions, on the card.  Every test here is marked ``gpu`` and skips when
``torch.cuda.is_available()`` is false; run them on a CUDA machine with

    python -m pytest tests/test_torch_gpu.py -q -m gpu

This file imports no JAX module of its own, so it runs where only PyTorch
is installed.  ``chip_smoke.py`` repeats the checks at ViT-B/16 shapes.
"""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch

from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
from patent_tpu_torch.ops import bf16_layer
from patent_tpu_torch.ops import pallas_kernels as pk
from patent_tpu_torch.ops import bf16_mlp_grad as mm
from patent_tpu_torch.ops import flash_attention as fa
from patent_tpu_torch.ops import quant_matmul as qm
from patent_tpu_torch.ops import topk_kernel
from patent_tpu_torch.retrieval.cli_actions import select_device
from patent_tpu_torch.retrieval.index import EmbeddingIndex
from patent_tpu_torch.train import evaluate, finetune_clip
from patent_tpu_torch.utils.config import ClipFinetuneConfig

pytestmark = pytest.mark.gpu

# head_dim 64 (what the layer kernel takes) at a small width; most keys
# are pad, so a kernel that ignored valid_len would be far off
D, HEADS, F, S, VALID = 128, 2, 256, 48, 20
# the kernel and the plain version round the same bf16 intermediates and
# differ by f32 summation order, which now and then flips one bf16
# rounding: a relative error of 1.3e-5 or less on the H100.  Dropping the
# key mask or any one bias (std 0.02 or more) moves the output by 1e-2 or
# more.
REL_TOL = 1e-3
BIASES = (1, 3, 5, 7, 9, 11)
# the head widths the attention kernels are instantiated for, at D 128
HEAD_WIDTHS = {"hd64": HEADS, "hd32": 4, "hd16": 8}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return select_device("cuda")


def _layer_case(dev, b=3, seed=0, s=S, d=D, f=F, valid=VALID):
    """Matrices bf16, LayerNorm vectors and biases f32 (what the kernel
    takes); pad rows of random content, not a constant, which LN1 would
    turn into exactly ln1_bias."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def m(*shape):
        return r(*shape, std=shape[0] ** -0.5).to(torch.bfloat16)

    params = (1 + r(d, std=0.1), r(d, std=0.1), m(d, 3 * d),
              r(3 * d, std=0.2), m(d, d), r(d, std=0.02),
              1 + r(d, std=0.1), r(d, std=0.1), m(d, f),
              r(f, std=0.02), m(f, d), r(d, std=0.02))
    x = r(b, s, d, std=1.0)
    x[:, valid:] = 3.0 * x[:, valid:] + 1.0
    return x.to(torch.bfloat16), params


def _min_cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(0, -2), b.float().flatten(0, -2), dim=-1).min())


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().mean() / b.abs().mean())


@pytest.mark.parametrize("hw", sorted(HEAD_WIDTHS))
@pytest.mark.parametrize("b", [2, 4, 16])
@pytest.mark.parametrize("name", ["fused_layer_block_bf16",
                                  "fused_layer_cls_bf16"])
def test_layer_kernel_matches_plain_and_controls_do_not(cuda, name, b, hw):
    """Rows 1 and 2 against the TPU kernel's function in plain PyTorch
    (an odd batch runs no layer kernel); M = B·48 rows cut the GEMMs' 128-
    row tiles raggedly."""
    kernel = getattr(bf16_layer, name)
    plain = getattr(bf16_layer, name + "_plain")
    x, p = _layer_case(cuda, b=b)
    heads = HEAD_WIDTHS[hw]

    def rows(t):                     # the valid rows (CLS: [B, D] already)
        return t[:, :VALID] if t.dim() == 3 else t

    n0 = kernel.launches
    got = rows(kernel(x, *p, heads, valid_len=VALID))
    want = rows(plain(x, *p, heads, valid_len=VALID))
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= REL_TOL
    assert _min_cosine(got, want) > 0.9999
    assert _rel_err(rows(plain(x, *p, heads, valid_len=S)), want) > REL_TOL
    for i in BIASES:
        q = list(p)
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(rows(plain(x, *q, heads, valid_len=VALID)),
                        want) > REL_TOL, i


@pytest.mark.parametrize("b", [2, 4, 16])
def test_cls_kernel_is_row_0_of_the_layer_kernel(cuda, b):
    x, p = _layer_case(cuda, b=b)
    got = bf16_layer.fused_layer_block_bf16(x, *p, HEADS, valid_len=VALID)
    cls = bf16_layer.fused_layer_cls_bf16(x, *p, HEADS, valid_len=VALID)
    torch.cuda.synchronize()
    assert cls.shape == (x.shape[0], D)
    # the CLS kernel repeats row 0's operations of the full kernel in the
    # same order, so it equals row 0 bit for bit
    assert torch.equal(cls, got[:, 0])


def test_layer_kernel_rejects_what_it_does_not_take(cuda):
    x, p = _layer_case(cuda, b=4)
    with pytest.raises(ValueError):
        bf16_layer.fused_layer_block_bf16(x.float(), *p, HEADS, valid_len=VALID)
    with pytest.raises(ValueError, match="head_dim"):    # head_dim 4
        bf16_layer.fused_layer_block_bf16(x, *p, 32, valid_len=VALID)
    with pytest.raises(ValueError):      # token axis not padded to 16
        bf16_layer.fused_layer_block_bf16(x[:, :40].contiguous(), *p, HEADS,
                                          valid_len=VALID)
    with pytest.raises(ValueError):      # f32 matrices: the kernel casts none
        bf16_layer.fused_layer_block_bf16(
            x, *p, HEADS, valid_len=VALID,
            folded=bf16_layer.fold_layer(*p, HEADS, dtype=torch.float32))
    # unfolded f32 weights are folded in f32 and rounded once, as JAX does
    f32 = [t.float() for t in p]
    assert torch.equal(
        bf16_layer.fused_layer_block_bf16(x, *f32, HEADS, valid_len=VALID),
        bf16_layer.fused_layer_block_bf16(
            x, *p, HEADS, valid_len=VALID,
            folded=bf16_layer.fold_layer(*f32, HEADS)))


# The layer's GEMM (csrc/wgmma_gemm.cuh) against the plain f32 product of
# the same bf16 operands: f32 sums in another order, so a bf16 output
# flips a rounding now and then (relative error ~1e-5 or less), an f32 one
# differs by ~1e-7; the bias dropped moves it by 1e-2 or more.
GEMM_REL_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
GEMM_SHAPES = {"bias": (2304, 768), "bias_gelu": (3072, 768),
               "res_bias": (768, 768), "bias_res": (768, 3072)}


@pytest.mark.parametrize("m", [26624, 416, 208])
@pytest.mark.parametrize("epilogue", sorted(GEMM_SHAPES))
def test_layer_gemm_matches_plain(cuda, epilogue, m):
    n, k = GEMM_SHAPES[epilogue]
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w_t = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).to(
        torch.bfloat16)
    bias = 0.1 * torch.randn(n, generator=g, device=cuda)
    rdt = bf16_layer.GEMM_EPILOGUES[epilogue][1]
    res = (None if rdt is None
           else torch.randn(m, n, generator=g, device=cuda).to(rdt))
    n0 = bf16_layer.layer_gemm.launches
    got = bf16_layer.layer_gemm(a, w_t, bias, epilogue, res)
    want = bf16_layer.layer_gemm_plain(a, w_t, bias, epilogue, res)
    no_bias = bf16_layer.layer_gemm_plain(a, w_t, torch.zeros_like(bias),
                                          epilogue, res)
    torch.cuda.synchronize()
    assert bf16_layer.layer_gemm.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == (m, n)
    assert torch.isfinite(got.float()).all()
    tol = GEMM_REL_TOL[got.dtype]
    assert _rel_err(got, want) <= tol
    assert _rel_err(no_bias, want) > tol


def test_bucket_kernel_matches_plain(cuda):
    """Exact per-bucket top-2 beyond 2048 rows, ragged query tile, an
    exact duplicate and invalid rows: values agree to f32 summation noise,
    columns exactly."""
    g = torch.Generator(device=cuda).manual_seed(1)
    n, d, nq = 5000, 64, 70
    gal = torch.randn(n, d, generator=g, device=cuda)
    gal[3000] = gal[1976]                    # same bucket (mod 1024)
    q = torch.randn(nq, d, generator=g, device=cuda)
    q[0] = gal[1976]
    gal16, valid = topk_kernel.prepare_cosine_gallery_bf16(gal)
    valid[::97] = 0.0
    q16 = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16).contiguous()
    got = topk_kernel._bucket_top2_cuda(q16, gal16, valid, 1024)
    want = topk_kernel.bucket_top2_plain(q16, gal16, valid, 1024)
    torch.cuda.synchronize()
    for a, b in zip(got[::2], want[::2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for a, b in zip(got[1::2], want[1::2]):
        assert torch.equal(a, b)


def test_index_takes_the_kernel_path_and_equals_the_scan(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    gal = torch.randn(5000, 64, generator=g, device=cuda)
    q = gal[:16] + 0.3 * torch.randn(16, 64, generator=g, device=cuda)
    names = [f"g{i}" for i in range(5000)]
    n0 = topk_kernel.bucket_topk_bf16.launches
    v, i = EmbeddingIndex(gal, names, device=cuda).search(q, k=10)
    assert topk_kernel.bucket_topk_bf16.launches == n0 + 1
    cv, ci = EmbeddingIndex(gal.cpu(), names).search(q.cpu(), k=10)
    assert (i == ci).all()
    assert abs(v - cv).max() < 1e-5


TOWER_CFG = VisionConfig(image_size=32, patch_size=8, hidden_dim=D,
                         num_layers=3, num_heads=HEADS, mlp_dim=F,
                         projection_dim=32)


def _tower(dev, seed=3, **flags):
    """A 3-layer bf16 tower (head_dim 64) with every parameter mattering."""
    gen = torch.Generator().manual_seed(seed)
    tower = VisionTransformer(TOWER_CFG, generator=gen, **flags)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    return tower.to(dev).eval()


def test_tower_kernels_match_plain_layers(cuda):
    """Three layers compound the per-layer rounding flips: features within
    4e-3 relative error (8e-4 or less measured on the H100), at an even
    batch, where layers 0-1 launch row 1 and the last row 2."""
    tower = _tower(cuda)
    px = torch.randn(4, 32, 32, 3, device=cuda)
    fns = (bf16_layer.fused_layer_block_bf16, bf16_layer.fused_layer_cls_bf16)
    counts = [fn.launches for fn in fns]
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 1]
    assert got.shape == (4, 32)
    assert _rel_err(got, want) <= 4e-3
    assert _min_cosine(got, want) > 0.9999


def test_tower_at_an_odd_batch_launches_no_layer_kernel(cuda):
    """At an odd batch every layer is the JAX entries' per-op composition,
    in PyTorch ops on the card, with and without ``kernels``."""
    tower = _tower(cuda)
    px = torch.randn(5, 32, 32, 3, device=cuda)
    fns = (bf16_layer.fused_layer_block_bf16, bf16_layer.fused_layer_cls_bf16)
    counts = [fn.launches for fn in fns]
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert [fn.launches for fn in fns] == counts
    assert got.shape == (5, 32) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("flags,kernel", [
    ({"use_flash": True}, fa.flash_attention),
    ({"fused_block": True}, fa.fused_attention_fwd)],
    ids=["use_flash", "fused_block"])
def test_per_op_tower_kernels_match_plain(cuda, flags, kernel):
    """The per-op towers launch their attention kernel once a layer; the
    rest is PyTorch ops.  Features within the fused-layer tower's gate of
    the same tower with the plain versions."""
    tower = _tower(cuda, fused_layer=False, **flags)
    px = torch.randn(5, 32, 32, 3, device=cuda)
    n0 = kernel.launches
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert kernel.launches == n0 + TOWER_CFG.num_layers
    assert got.shape == (5, 32) and torch.isfinite(got).all()
    assert _rel_err(got, want) <= 4e-3
    assert _min_cosine(got, want) > 0.9999


def test_f32_use_flash_tower_launches_the_f32_kernel(cuda):
    """JAX's tower defaults to f32: the f32 use_flash tower runs row 14's
    f32 instance once a layer, within f32 noise of its plain version."""
    gen = torch.Generator().manual_seed(5)
    tower = VisionTransformer(TOWER_CFG, dtype=torch.float32, generator=gen,
                              fused_layer=False, use_flash=True)
    tower = tower.to(cuda).eval()
    px = torch.randn(3, 32, 32, 3, device=cuda)
    n0 = fa.flash_attention_f32.launches
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert fa.flash_attention_f32.launches == n0 + TOWER_CFG.num_layers
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel_err(got, want) <= 1e-4


# Row 14: the kernel and the plain version round the same bf16 q and p and
# differ by f32 summation order, which now and then flips one output
# rounding; leaving q unscaled or counting the zero keys up to the next
# multiple of 16 moves the output by 1e-2 or more.
FLASH_REL_TOL = 1e-4


def _flash_case(dev, b, s, heads=2, gain=1.0, seed=11,
                dtype=torch.bfloat16, hd=64):
    """q, k, v [B, S, H, hd] as the per-op tower passes them: slices of
    one [B, S, 3·H·hd] tensor of ``dtype``.  ``gain`` scales q."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * heads * hd, generator=g, device=dev)
    qkv[..., :heads * hd] *= gain
    return tuple(t.unflatten(-1, (heads, hd)) for t in
                 qkv.to(dtype).split(heads * hd, dim=-1))


@pytest.mark.parametrize("hd", [64, 32, 16])
@pytest.mark.parametrize("b,heads", [(3, 2), (1, 12), (3, 1)])
@pytest.mark.parametrize("s", [197, 64, 16, 5])
def test_flash_kernel_matches_plain_and_controls_do_not(cuda, s, b, heads,
                                                        hd):
    q, k, v = _flash_case(cuda, b, s, heads=heads, hd=hd)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, packed)          # strided views read in place
    assert _rel_err(got, want) <= FLASH_REL_TOL
    controls = {"q unscaled": fa.flash_attention_plain(q, k, v, scale=False)}
    if s % 16:
        controls["pad keys counted"] = fa.flash_attention_plain(
            q, k, v, pad_keys_to=-(-s // 16) * 16)
    for name, ctrl in controls.items():
        assert _rel_err(ctrl, want) > FLASH_REL_TOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_clamps_scores_past_80(cuda, dtype):
    """q x 40: ~8% of the exp2-domain scores pass +80; the kernel clamps
    them as the plain version does, and without the clamp the plain
    version is far off (or not finite)."""
    q, k, v = (t.to(dtype) for t in _flash_case(cuda, 2, 197, gain=40.0))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    no_clamp = fa.flash_attention_plain(q, k, v, clamp=False)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= FLASH_REL_TOL
    assert not _rel_err(no_clamp, want) <= FLASH_REL_TOL


# Row 14's f32 instance computes the plain version's f32 function: the
# same products and sums, in another order (no TF32 on either side).  Its
# kernel streams the keys in tiles of 64 and picks a query block of 32 to
# 64 rows by S: S 1, 15, 17, 64, 65 and 197 put the sequence's end at the
# edges of both.
FLASH_F32_REL_TOL = 1e-5


@pytest.mark.parametrize("hd", [64, 32, 16, 48, 72, 80, 88, 96, 112, 128,
                                8, 120])
@pytest.mark.parametrize("s,heads", [(197, 12), (64, 2), (5, 1), (1, 1),
                                     (15, 2), (17, 2), (65, 1)])
def test_flash_kernel_f32_matches_plain(cuda, s, heads, hd):
    """Every instance width; 8, 72, 88 and 120 on the 16, 80, 96 and 128
    instances."""
    q, k, v = _flash_case(cuda, 3, s, heads=heads, dtype=torch.float32,
                          hd=hd)
    n0 = fa.flash_attention_f32.launches
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    torch.cuda.synchronize()
    assert fa.flash_attention_f32.launches == n0 + 2
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, packed)          # strided views read in place
    assert _rel_err(got, want) <= FLASH_F32_REL_TOL
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    # controls: q unscaled (one key's softmax ignores q), and the zero keys
    # up to the end of the last key tile counted
    controls = {}
    if s > 1:
        controls["q unscaled"] = fa.flash_attention_plain(q, k, v,
                                                          scale=False)
    if s % 64:
        controls["pad keys counted"] = fa.flash_attention_plain(
            q, k, v, pad_keys_to=-(-s // 64) * 64)
    for name, ctrl in controls.items():
        assert _rel_err(ctrl, want) > FLASH_F32_REL_TOL, name


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _flash_case(cuda, 2, 20)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):   # 4: not 8's multiple
        fa.flash_attention(*(t.reshape(2, 20, 32, 4) for t in (q, k, v)))
    with pytest.raises(ValueError, match="head_dim"):   # f32 head_dim 4
        fa.flash_attention(*(t.float().reshape(2, 20, 32, 4)
                             for t in (q, k, v)))
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(q, k.contiguous(), v)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.clone().requires_grad_(True), k, v)
    assert fa.flash_attention_plain(q.cpu(), k.cpu(), v.cpu()).shape == \
        q.shape


# int8 sub-layers: the integer products are exact, so the kernel and the
# plain version differ only where a LayerNorm or f32 dot summed in another
# order flips an int8 code (chip_smoke.py's gate, set ~4x above the
# floor measured there at ViT-B/16 widths); dropping the key mask, a bias
# or the per-channel scales moves the output by 1e-2 or more
INT8_REL_TOL = 3e-4
INT8_BIASES = {"attention": (1, 4, 7), "mlp": (1, 4, 7)}
INT8_SCALES = {"attention": (3, 6), "mlp": (3, 6)}
# the int8 kernels' two forms (``fast``), each held to its plain version
# (the fast form is the card's default, PATENT_TPU_FAST_KERNELS unset)
FORMS = pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])


def _int8_case(dev, b=3, seed=0):
    """(x as in _layer_case, attention parameters, MLP parameters): f32
    matrices quantized per output channel and held [out, in]."""
    x, _p = _layer_case(dev, b, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def m(rows, cols):
        q, scale = qm.quantize_weight(r(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    wqkv, sqkv = m(D, 3 * D)
    wout, sout = m(D, D)
    w1, s1 = m(D, F)
    w2, s2 = m(F, D)
    attn = (1 + r(D, std=0.1), r(D, std=0.1), wqkv, sqkv, r(3 * D, std=0.2),
            wout, sout, r(D, std=0.02))
    mlp = (1 + r(D, std=0.1), r(D, std=0.1), w1, s1, r(F, std=0.02), w2, s2,
           r(D, std=0.02))
    return x, attn, mlp


@FORMS
@pytest.mark.parametrize("hw", sorted(HEAD_WIDTHS))
@pytest.mark.parametrize("name", ["quant_attention_block",
                                  "quant_attention_cls", "quant_mlp_block"])
def test_int8_kernel_matches_plain_and_controls_do_not(cuda, name, hw, fast):
    kernel = functools.partial(getattr(qm, name), fast=fast)
    plain = functools.partial(getattr(qm, name + "_plain"), fast=fast)
    x, attn, mlp = _int8_case(cuda)
    heads = HEAD_WIDTHS[hw]
    attention = name != "quant_mlp_block"
    kind = "attention" if attention else "mlp"
    params = attn if attention else mlp

    def run(fn, p, valid=VALID):
        out = fn(x, *p, heads, valid_len=valid) if attention else fn(x, *p)
        return out[:, :VALID] if name == "quant_attention_block" else out

    n0 = kernel.func.launches
    got = run(kernel, params)
    want = run(plain, params)
    torch.cuda.synchronize()
    assert kernel.func.launches == n0 + 1
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= INT8_REL_TOL
    assert _min_cosine(got, want) > 0.9999
    if attention:
        assert _rel_err(run(plain, params, S), want) > INT8_REL_TOL
    for i in INT8_BIASES[kind]:
        q = list(params)
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(run(plain, q), want) > INT8_REL_TOL, i
    for i in INT8_SCALES[kind]:
        q = list(params)
        q[i] = torch.full_like(q[i], float(q[i].mean()))
        assert _rel_err(run(plain, q), want) > INT8_REL_TOL, i


@FORMS
def test_int8_cls_kernel_is_row_0_of_the_attention_kernel(cuda, fast):
    x, attn, _mlp = _int8_case(cuda)
    full = qm.quant_attention_block(x, *attn, HEADS, valid_len=VALID,
                                    fast=fast)
    cls = qm.quant_attention_cls(x, *attn, HEADS, valid_len=VALID, fast=fast)
    torch.cuda.synchronize()
    assert cls.shape == (x.shape[0], D)
    # the same kernels and per-element operations for row 0: equal bits
    assert torch.equal(cls, full[:, 0])


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    x, attn, mlp = _int8_case(cuda)
    with pytest.raises(ValueError):      # f32 tokens
        qm.quant_attention_block(x.float(), *attn, HEADS, valid_len=VALID)
    with pytest.raises(ValueError, match="head_dim"):    # head_dim 4
        qm.quant_attention_block(x, *attn, 32, valid_len=VALID)
    with pytest.raises(ValueError, match="head_dim"):
        qm.quant_layer_block(x, *attn, *mlp, 32, valid_len=VALID)
    with pytest.raises(ValueError):      # weights in the [in, out] layout
        qm.quant_attention_block(x, *attn[:2], attn[2].T, *attn[3:], HEADS,
                                 valid_len=VALID)
    with pytest.raises(ValueError):      # float matrices
        qm.quant_mlp_block(x, *mlp[:2], mlp[2].float(), *mlp[3:])


def test_int8_bucket_kernel_equals_plain(cuda):
    """Exact per-bucket top-2 beyond 2048 rows, ragged query tile, an
    exact duplicate and rows of scale 0: the integer products are exact,
    so every value and column equals the plain version's."""
    dev = cuda
    g = torch.Generator(device=dev).manual_seed(4)
    n, d, nq = 5000, 64, 70
    gal = torch.randn(n, d, generator=g, device=dev)
    gal[3000] = gal[1976]                    # same bucket (mod 1024)
    q = torch.randn(nq, d, generator=g, device=dev)
    q[0] = gal[1976]
    gi8, gscale = (torch.from_numpy(a).to(dev) for a in
                   topk_kernel.quantize_gallery(gal.cpu().numpy()))
    gscale[::97] = 0.0
    qi8, qscale = topk_kernel.quantize_queries(q)
    got = topk_kernel._bucket_top2_cuda(qi8, gi8, gscale, 1024)
    want = topk_kernel.bucket_top2_int8_plain(qi8, gi8, gscale, 1024)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_quantized_index_takes_the_kernel_path_and_equals_the_scan(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    gal = torch.randn(5000, 64, generator=g, device=cuda)
    q = gal[:16] + 0.3 * torch.randn(16, 64, generator=g, device=cuda)
    names = [f"g{i}" for i in range(5000)]
    n0 = topk_kernel.bucket_topk_int8.launches
    v, i = EmbeddingIndex(gal, names, quantized=True).search(q, k=10)
    assert topk_kernel.bucket_topk_int8.launches == n0 + 1
    cv, ci = EmbeddingIndex(gal.cpu(), names).search(q.cpu(), k=10)
    assert (i == ci).all()
    assert abs(v - cv).max() < 1e-5


# The cosine bucket kernels at the shapes their tiles and plan take: one
# query (8 a warpgroup), a ragged tile, past one tile of 128 and three
# tiles; fewer rows than buckets, a few steps and many; the widths the
# index sends (the narrowest, a small tower's, CLIP's: D 512 takes four
# K-slices a TMA request, the others one).  bf16 sums run in another order
# than the plain f32 product (~1e-7 apart), so a column may differ only
# where the plain version's scores of the two columns agree within
# TOPK_VALUE_TOL: a tie within that noise, which either column answers.
TOPK_VALUE_TOL = 1e-5


def _bucket_case(dev, nq, n, d, seed):
    """Gallery rows with exact duplicates in one bucket across steps (a tie
    that must go to the lower column), queries of which the first is the
    duplicated row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gal = torch.randn(n, d, generator=g, device=dev)
    for j, m in ((1976, 1), (1976, 40), (100, 3)):
        if j + 1024 * m < n:
            gal[j + 1024 * m] = gal[j]
    q = torch.randn(nq, d, generator=g, device=dev)
    q[0] = gal[min(1976, n - 1)]
    return gal, q


def _near_tie_columns(got, want, scores) -> bool:
    """Every column of ``got`` that differs from ``want``'s scores, under the
    plain version's ``scores`` [Q, N], within TOPK_VALUE_TOL of the value
    ``want`` holds there."""
    for gi, wi, wv in ((got[1], want[1], want[0]), (got[3], want[3],
                                                    want[2])):
        diff = gi != wi
        if diff.any():
            alt = scores.gather(1, gi.long())[diff]
            if (alt - wv[diff]).abs().max() > TOPK_VALUE_TOL:
                return False
    return True


@pytest.mark.parametrize("n", [700, 5000, 70000])
@pytest.mark.parametrize("nq", [1, 3, 65, 300])
@pytest.mark.parametrize("dtype,d", [("bf16", 16), ("bf16", 64),
                                     ("bf16", 512), ("int8", 32),
                                     ("int8", 512)])
def test_bucket_kernels_match_plain_at_every_tile_shape(cuda, dtype, d, nq,
                                                         n):
    """int8: the integer products are exact, so (v1, i1, v2, i2) equal the
    plain version's; bf16: values within TOPK_VALUE_TOL and columns equal
    but at ties within it.  Invalid rows (mask 0, scale 0 or negative)
    never appear."""
    gal, q = _bucket_case(cuda, nq, n, d, seed=nq + n + d)
    if dtype == "int8":
        gi8, gscale = (torch.from_numpy(a).to(cuda) for a in
                       topk_kernel.quantize_gallery(gal.cpu().numpy()))
        gscale[::97] = 0.0
        gscale[5::101] = -1.0
        qi8, _qscale = topk_kernel.quantize_queries(q)
        got = topk_kernel._bucket_top2_cuda(qi8, gi8, gscale)
        want = topk_kernel.bucket_top2_int8_plain(qi8, gi8, gscale)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        bad = (gscale <= 0).nonzero()[:, 0].to(torch.int32)
    else:
        g16, valid = topk_kernel.prepare_cosine_gallery_bf16(gal)
        valid[::97] = 0.0
        q16 = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
        got = topk_kernel._bucket_top2_cuda(q16.contiguous(), g16, valid)
        want = topk_kernel.bucket_top2_plain(q16, g16, valid)
        torch.cuda.synchronize()
        for a, b in zip(got[::2], want[::2]):
            torch.testing.assert_close(a, b, atol=TOPK_VALUE_TOL, rtol=0)
        scores = (q16.float() @ g16.float().T).masked_fill(
            valid <= 0, float("-inf"))
        assert _near_tie_columns(got, want, scores)
        bad = (valid <= 0).nonzero()[:, 0].to(torch.int32)
    # the duplicated row's earlier copy wins the tie for query 0
    b1976 = min(1976, n - 1) % 1024
    assert int(got[1][0, b1976]) == min(1976, n - 1)
    for i, v in ((got[1], got[0]), (got[3], got[2])):
        live = v > float("-inf")
        assert not torch.isin(i[live], bad).any()
        assert (i[~live] == 0).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8", "poincare"])
def test_bucket_pool_of_two_per_bucket_equals_plain(cuda, dtype):
    """A pool as deep as the capacity, 2L: every candidate of every bucket
    comes back, as the plain version's."""
    pool = 2 * topk_kernel.BUCKETS
    if dtype == "poincare":
        qb, pg, _tie = _poincare_case(cuda, 65, 5000, 128, seed=9)
        got = topk_kernel.bucket_topk_poincare(qb, pg, pool)
        want = topk_kernel.bucket_topk_poincare_plain(qb, pg, pool)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    gal, q = _bucket_case(cuda, 65, 5000, 64, seed=9)
    if dtype == "int8":
        gi8, gscale = (torch.from_numpy(a).to(cuda) for a in
                       topk_kernel.quantize_gallery(gal.cpu().numpy()))
        qi8, qscale = topk_kernel.quantize_queries(q)
        got = topk_kernel.bucket_topk_int8(qi8, qscale, gi8, gscale, pool)
        want = topk_kernel.bucket_topk_int8_plain(qi8, qscale, gi8, gscale,
                                                  pool)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        g16, valid = topk_kernel.prepare_cosine_gallery_bf16(gal)
        got = topk_kernel.bucket_topk_bf16(q, g16, valid, pool)
        want = topk_kernel.bucket_topk_bf16_plain(q, g16, valid, pool)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], atol=TOPK_VALUE_TOL,
                                   rtol=0)
        assert torch.equal(got[1].sort(dim=1).values,
                           want[1].sort(dim=1).values)


def _int8_attention(dev, b, s, d, seed=0):
    """x [B, S, D] bf16 with random pad content and the attention
    sub-layer's int8 parameters, matrices [out, in]."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def m(rows, cols):
        q, scale = qm.quantize_weight(r(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    wqkv, sqkv = m(d, 3 * d)
    wout, sout = m(d, d)
    attn = (1 + r(d, std=0.1), r(d, std=0.1), wqkv, sqkv, r(3 * d, std=0.2),
            wout, sout, r(d, std=0.02))
    return r(b, s, d, std=1.0).to(torch.bfloat16), attn


# Row 6 at the CLS call's batches (4 and a batch of 128) and at each head
# width, on the 224 px stream (S 208) and the CLIs' small tower's (S 80)
@FORMS
@pytest.mark.parametrize("b", [4, 128])
@pytest.mark.parametrize("d,heads,s,valid", [
    (768, 12, 208, 197), (128, 8, 80, 65), (128, 4, 80, 65),
    (128, 2, 80, 65), (128, 8, 208, 197), (128, 4, 208, 197),
    (128, 2, 208, 197)])
def test_int8_cls_kernel_is_row_0_at_every_head_width(cuda, b, d, heads, s,
                                                      valid, fast):
    """The CLS sub-layer runs row 0's operations of the attention sub-layer
    on the same GEMM and tile: equal bits, in either form."""
    x, attn = _int8_attention(cuda, b, s, d, seed=b + s + heads)
    n0 = qm.quant_attention_cls.launches
    cls = qm.quant_attention_cls(x, *attn, heads, valid_len=valid, fast=fast)
    full = qm.quant_attention_block(x, *attn, heads, valid_len=valid,
                                    fast=fast)
    torch.cuda.synchronize()
    assert qm.quant_attention_cls.launches == n0 + 1
    assert torch.equal(cls, full[:, 0])


@pytest.mark.parametrize("epilogue,fast", [("bias", None), ("gelu", False),
                                           ("gelu", True)],
                         ids=["bias", "gelu-exact", "gelu-fast"])
@pytest.mark.parametrize("m,every", [(4, 80), (4, 208), (128, 208)])
def test_s8_gemm_with_a_row_stride_equals_the_gathered_rows(cuda, epilogue,
                                                            m, every, fast):
    """Row 6's CLS q product: A read in place as every S-th row, its row
    scales at the same stride, equals the product of the gathered rows bit
    for bit; reading the first M rows instead must show."""
    n, k = 768, 768
    g = torch.Generator(device=cuda).manual_seed(m + every)
    a = torch.randint(-127, 128, (m * every, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w_t = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                        dtype=torch.int8)
    a_scale = 0.1 * torch.rand(m * every, generator=g, device=cuda)
    scale = 10 * torch.rand(n, generator=g, device=cuda) / 127 / k ** 0.5
    bias = 0.1 * torch.randn(n, generator=g, device=cuda)
    got = qm.int8_gemm(a, a_scale, w_t, scale, bias, epilogue, every=every,
                       fast=fast)
    gathered = qm.int8_gemm(a[::every].contiguous(),
                            a_scale[::every].contiguous(), w_t, scale, bias,
                            epilogue, fast=fast)
    want = qm.int8_gemm_plain(a, a_scale, w_t, scale, bias, epilogue,
                              every=every, fast=fast)
    first = qm.int8_gemm(a[:m].contiguous(), a_scale[:m].contiguous(), w_t,
                         scale, bias, epilogue, fast=fast)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert torch.equal(got, gathered) and torch.equal(got, want)
    assert _rel_err(first, want) > INT8_REL_TOL


@FORMS
def test_int8_tower_kernels_match_plain_layers(cuda, fast, monkeypatch):
    """Each int8 layer agrees with its plain version to an ulp, but an
    int8 code flipped by a rounding difference is a step of 1/127 of its
    row's range, and the layers carry it on: features within 2e-2
    relative error and cosine 0.999 over three layers, at batch 5 (layers
    0-1 as quant_layer_block) and 4 (as the two sub-layers).  The tower
    passes no form: PATENT_TPU_FAST_KERNELS names it on the card, for the
    kernels and the plain versions alike."""
    monkeypatch.setenv(qm.FAST_ENV, "1" if fast else "0")
    cfg = VisionConfig(image_size=32, patch_size=8, hidden_dim=D,
                       num_layers=3, num_heads=HEADS, mlp_dim=F,
                       projection_dim=32)
    gen = torch.Generator().manual_seed(6)
    tower = VisionTransformer(cfg, dtype=torch.float32, generator=gen)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    tower = Int8VisionTransformer.from_float(tower.to(cuda)).eval()
    fns = (qm.quant_layer_block, qm.quant_attention_block,
           qm.quant_attention_cls, qm.quant_mlp_block)
    for batch, launched in ((5, [2, 0, 1, 1]), (4, [0, 2, 1, 3])):
        px = torch.randn(batch, 32, 32, 3, device=cuda)
        counts = [fn.launches for fn in fns]
        with torch.inference_mode():
            got = tower(px)
            tower.kernels = False
            want = tower(px)
            tower.kernels = True
        assert [fn.launches - c for fn, c in zip(fns, counts)] == launched
        assert got.shape == (batch, 32)
        assert _rel_err(got, want) <= 2e-2
        assert _min_cosine(got, want) > 0.999


# Row 8, the whole int8 layer: a code flipped in LN1's quantization reaches
# every row of its image through both sub-layers, so chip_smoke.py's
# whole-layer gate (3.6e-4 measured at B 1 and ViT-B/16 widths on the
# H100).  Its controls add the rows 5 + 7 chain, whose mid-layer residual
# is rounded to bf16: on the CPU it sits 7.5e-3 to 8.1e-3 from the JAX
# kernel in the mean at these widths (tests/test_torch_int8_layer.py).
INT8_LAYER_REL_TOL = 1.5e-3
LAYER_CONTROLS = {"bias": (1, 4, 7, 9, 12, 15), "scale": (3, 6, 11, 14)}


@FORMS
@pytest.mark.parametrize("hw", sorted(HEAD_WIDTHS))
@pytest.mark.parametrize("b", [1, 3, 127], ids=["B1", "B3", "B127"])
def test_int8_layer_kernel_matches_plain_and_controls_do_not(cuda, b, hw,
                                                             fast):
    x, attn, mlp = _int8_case(cuda, b=b)
    params = (*attn, *mlp)
    heads = HEAD_WIDTHS[hw]

    def run(fn, p=params, valid=VALID):
        return fn(x, *p, heads, valid_len=valid, fast=fast)[:, :VALID]

    n0 = qm.quant_layer_block.launches
    got = run(qm.quant_layer_block)
    want = run(qm.quant_layer_block_plain)
    torch.cuda.synchronize()
    assert qm.quant_layer_block.launches == n0 + 1
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= INT8_LAYER_REL_TOL
    assert _min_cosine(got, want) > 0.9999
    chain = qm.quant_mlp_block_plain(
        qm.quant_attention_block_plain(x, *attn, heads, valid_len=VALID,
                                       fast=fast),
        *mlp, fast=fast)[:, :VALID]
    controls = {"no key mask": run(qm.quant_layer_block_plain, valid=S),
                "bf16 mid residual": chain,
                "the other form": qm.quant_layer_block_plain(
                    x, *params, heads, valid_len=VALID,
                    fast=not fast)[:, :VALID]}
    for kind, idx in LAYER_CONTROLS.items():
        for i in idx:
            q = list(params)
            q[i] = (torch.zeros_like(q[i]) if kind == "bias"
                    else torch.full_like(q[i], float(q[i].mean())))
            controls[f"{kind} {i}"] = run(qm.quant_layer_block_plain, q)
    for name, ctrl in controls.items():
        assert _rel_err(ctrl, want) > INT8_LAYER_REL_TOL, name


@FORMS
@pytest.mark.parametrize("hw", sorted(HEAD_WIDTHS))
@pytest.mark.parametrize("b", [1, 3, 127], ids=["B1", "B3", "B127"])
def test_int8_layer_cooperative_launch_equals_the_chain(cuda, b, hw, fast,
                                                        monkeypatch):
    """Row 8 runs one cooperative launch at a query's batch and a chain of
    launches of the same bodies at a larger one: the integer products are
    exact and every other operation the same, so the two give the same
    bits (both forced here at every batch), and the folded vectors change
    nothing."""
    x, attn, mlp = _int8_case(cuda, b=b)
    params = (*attn, *mlp)
    heads = HEAD_WIDTHS[hw]
    folded = qm.fold_q_scale(attn[3], attn[4], heads)
    outs = {}
    for coop in (True, False):
        def plan(m, d, f, blocks, coop=coop):
            return qm.LayerPlan(coop, 1, 2) if coop else qm.LayerPlan(
                False, 1, 1)

        monkeypatch.setattr(qm, "layer_plan", plan)
        outs[coop] = qm.quant_layer_block(x, *params, heads, valid_len=VALID,
                                          fast=fast)
        outs[coop, "folded"] = qm.quant_layer_block(
            x, *params, heads, valid_len=VALID, folded=folded, fast=fast)
    torch.cuda.synchronize()
    for key, got in outs.items():
        assert torch.equal(got, outs[True]), key


# the s8 GEMM's instances (csrc/wgmma_s8.cuh) at ViT-B/16 widths: (N, K)
S8_GEMM_SHAPES = {"bias": (2304, 768), "gelu": (3072, 768), "res": (768, 768),
                  "res_f32_out": (768, 768), "res_f32": (768, 3072)}


@FORMS
@pytest.mark.parametrize("m", [208, 624, 26624])
@pytest.mark.parametrize("epilogue", sorted(S8_GEMM_SHAPES))
def test_s8_gemm_matches_plain(cuda, epilogue, m, fast):
    """Rows 5 and 8's int8 GEMM alone equals its plain epilogue bit for bit
    (the integer products are exact, the epilogue the same operations in
    the same order) at one image's rows, three images' and a batch of
    128's; dropping the bias must show."""
    n, k = S8_GEMM_SHAPES[epilogue]
    g = torch.Generator(device=cuda).manual_seed(m + k)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=cuda,
                             dtype=torch.int8)

    a, w_t = codes(m, k), codes(n, k)
    a_scale = 0.1 * torch.rand(m, generator=g, device=cuda)
    scale = 10 * torch.rand(n, generator=g, device=cuda) / 127 / k ** 0.5
    bias = 0.1 * torch.randn(n, generator=g, device=cuda)
    rdt = qm.S8_GEMM_EPILOGUES[epilogue][1]
    res = (None if rdt is None
           else torch.randn(m, n, generator=g, device=cuda).to(rdt))
    n0 = qm.int8_gemm.launches
    got = qm.int8_gemm(a, a_scale, w_t, scale, bias, epilogue, res,
                       fast=fast)
    want = qm.int8_gemm_plain(a, a_scale, w_t, scale, bias, epilogue, res,
                              fast=fast)
    torch.cuda.synchronize()
    assert qm.int8_gemm.launches == n0 + 1
    assert got.dtype == qm.S8_GEMM_EPILOGUES[epilogue][2]
    assert torch.equal(got, want)
    no_bias = qm.int8_gemm_plain(a, a_scale, w_t, scale,
                                 torch.zeros_like(bias), epilogue, res,
                                 fast=fast)
    assert _rel_err(no_bias, want) > INT8_REL_TOL


# Row 7 (the MLP sub-layer) at the rows the main path gives it: the CLS
# call at M = B (1, 4, a batch of 128's 128) and the tower's 11 layers at
# RetrievalEngine's batch 32 (6,656 rows) and at 128 (26,624), ViT-B/16
# widths.  Its GEMMs are exact and its epilogues the plain version's
# operations, so only an LN2 code flipped by f32 summation order moves it.
@FORMS
@pytest.mark.parametrize("m", [1, 4, 128, 6656, 26624])
def test_int8_mlp_kernel_at_the_main_path_rows(cuda, m, fast):
    d, f = 768, 3072
    g = torch.Generator(device=cuda).manual_seed(m)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=cuda)

    def mat(rows, cols):
        q, scale = qm.quantize_weight(r(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    w1, s1 = mat(d, f)
    w2, s2 = mat(f, d)
    params = (1 + r(d, std=0.1), r(d, std=0.1), w1, s1, r(f, std=0.02), w2,
              s2, r(d, std=0.02))
    x = r(m, d, std=1.0).to(torch.bfloat16)
    n0 = qm.quant_mlp_block.launches
    got = qm.quant_mlp_block(x, *params, fast=fast)
    want = qm.quant_mlp_block_plain(x, *params, fast=fast)
    torch.cuda.synchronize()
    assert qm.quant_mlp_block.launches == n0 + 1
    assert got.shape == x.shape and torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= INT8_REL_TOL
    for i in INT8_BIASES["mlp"]:
        q = list(params)
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(qm.quant_mlp_block_plain(x, *q, fast=fast), want) > \
            INT8_REL_TOL, i
    for i in INT8_SCALES["mlp"]:
        q = list(params)
        q[i] = torch.full_like(q[i], float(q[i].mean()))
        assert _rel_err(qm.quant_mlp_block_plain(x, *q, fast=fast), want) > \
            INT8_REL_TOL, i


@FORMS
@pytest.mark.parametrize("m", [4, 208, 26624])
def test_int8_gelu_quant_row_maxima_and_codes(cuda, m, fast):
    """Row 7's MLP in alone: its hidden equals the plain epilogue bit for
    bit, the row maxima its epilogue takes equal max |g| of its own hidden
    bit for bit, and the one-pass quantization equals quant_rows(g) (the
    fast form: quant_rows_fast, with codes saturated at 127) bit for
    bit."""
    n, k = 3072, 768
    g = torch.Generator(device=cuda).manual_seed(m + 1)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w_t = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                        dtype=torch.int8)
    a_scale = 0.1 * torch.rand(m, generator=g, device=cuda)
    scale = 10 * torch.rand(n, generator=g, device=cuda) / 127 / k ** 0.5
    bias = 0.1 * torch.randn(n, generator=g, device=cuda)
    n0 = qm.int8_gelu_quant.launches
    hid, hid_max, hq, hs = qm.int8_gelu_quant(a, a_scale, w_t, scale, bias,
                                              fast=fast)
    torch.cuda.synchronize()
    assert qm.int8_gelu_quant.launches == n0 + 1
    assert torch.equal(hid, qm.int8_gemm_plain(a, a_scale, w_t, scale, bias,
                                               "gelu", fast=fast))
    assert torch.equal(hid_max, hid.abs().amax(dim=-1))
    want_q, want_s = (qm.quant_rows_fast if fast else qm.quant_rows)(hid)
    assert torch.equal(hq, want_q)
    assert torch.equal(hs, want_s[:, 0])


@FORMS
def test_int8_layer_group_dispatches_as_jax(cuda, fast):
    """Row 9: at B % group == 0 it launches row 8's kernel and equals
    quant_layer_block bit for bit; at a ragged batch, or without
    valid_len, it runs the two sub-layer kernels, each in its form."""
    x, attn, mlp = _int8_case(cuda, b=4)
    fns = (qm.quant_layer_group, qm.quant_layer_block,
           qm.quant_attention_block, qm.quant_mlp_block)
    for xb, group, valid, launched in ((x, 2, VALID, [1, 0, 0, 0]),
                                       (x[:3], 2, VALID, [0, 0, 1, 1]),
                                       (x, 4, None, [0, 0, 1, 1])):
        xb = xb.contiguous()
        counts = [fn.launches for fn in fns]
        got = qm.quant_layer_group(xb, *attn, *mlp, HEADS, valid_len=valid,
                                   group=group, fast=fast)
        if launched[0]:
            want = qm.quant_layer_block(xb, *attn, *mlp, HEADS,
                                        valid_len=valid, fast=fast)
            launched[1] += 1
        else:
            want = qm.quant_mlp_block(qm.quant_attention_block(
                xb, *attn, HEADS, valid_len=valid, fast=fast), *mlp,
                fast=fast)
            launched[2] += 1
            launched[3] += 1
        torch.cuda.synchronize()
        assert [fn.launches - c for fn, c in zip(fns, counts)] == launched
        assert torch.equal(got, want)


# Rows 10 and 11, with no LayerNorm: the kernel quantizes the same f32 rows
# as the plain version (the same codes) and its epilogue repeats the plain
# version's f32 operations in order, so the two differ at most where the
# card's exp2 and PyTorch's round differently (f32 quick_gelu)
DENSE_REL_TOL = 1e-5


@FORMS
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("act", [None, "quick_gelu"], ids=["none", "gelu"])
def test_int8_dense_kernel_matches_plain_and_controls_do_not(cuda, act,
                                                             dtype, fast):
    """Ragged rows (3 x 37) and a ragged N (200)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(3, 37, D, generator=g, device=cuda).to(dtype)
    w, scale = qm.quantize_weight(
        torch.randn(D, 200, generator=g, device=cuda) * D ** -0.5)
    w = w.T.contiguous()
    bias = 0.05 * torch.randn(200, generator=g, device=cuda)
    n0 = qm.quant_dense.launches
    got = qm.quant_dense(x, w, scale, bias, act, fast=fast)
    plain = functools.partial(qm.quant_dense_plain, fast=fast)
    want = plain(x, w, scale, bias, act)
    torch.cuda.synchronize()
    assert qm.quant_dense.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (3, 37, 200)
    assert _rel_err(got, want) <= DENSE_REL_TOL
    controls = {
        "bias=0": plain(x, w, scale, None, act),
        "scale=mean": plain(
            x, w, torch.full_like(scale, float(scale.mean())), bias, act),
        "last 16 of K dropped": plain(
            x[..., :-16].contiguous(), w[:, :-16].contiguous(), scale, bias,
            act),
        "other act": plain(x, w, scale, bias, None if act else "quick_gelu"),
        "the other form": qm.quant_dense_plain(x, w, scale, bias, act,
                                               fast=not fast)}
    for name, ctrl in controls.items():
        assert _rel_err(ctrl, want) > DENSE_REL_TOL, name


def _dense_case(dev, m, n, k=768, seed=10):
    """x [m, k] and quant_dense's weights (w_t [n, k] int8, scale, bias)
    at the tower's width, any output width n."""
    g = torch.Generator(device=dev).manual_seed(seed + m + n)
    w, scale = qm.quantize_weight(
        torch.randn(k, n, generator=g, device=dev) * k ** -0.5)
    return (torch.randn(m, k, generator=g, device=dev),
            (w.T.contiguous(), scale,
             0.05 * torch.randn(n, generator=g, device=dev)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("act", [None, "quick_gelu"], ids=["none", "gelu"])
@pytest.mark.parametrize("n", [8, 13, 768, 2304])
@pytest.mark.parametrize("m", [1, 77, 26624])
@FORMS
def test_int8_dense_kernel_at_the_main_path_widths(cuda, m, n, act, dtype,
                                                   fast):
    """Row 10 at one row, a ragged 77 and a batch of 128's 26,624 rows, at
    output widths 8, 13 (odd: the wgmma epilogue stores its last column
    alone), 768 and QKV's 2,304, K 768."""
    x, w = _dense_case(cuda, m, n)
    x = x.to(dtype)
    n0 = qm.quant_dense.launches
    got = qm.quant_dense(x, *w, act, fast=fast)
    want = qm.quant_dense_plain(x, *w, act, fast=fast)
    torch.cuda.synchronize()
    assert qm.quant_dense.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert _rel_err(got, want) <= DENSE_REL_TOL


def test_int8_dense_runs_on_the_wgmma_kernel(cuda):
    """Row 10's route: its row quantization and the wgmma s8 GEMM, the same
    bits twice; the earlier mma.sync GEMM (gemm_s8) is gone from the built
    library."""
    from torch.profiler import ProfilerActivity, profile

    from patent_tpu_torch import _build

    x, w = _dense_case(cuda, 77, 13)
    first = qm.quant_dense(x, *w, "quick_gelu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = qm.quant_dense(x, *w, "quick_gelu")
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.self_device_time_total > 0]
    assert sum("ptt_s8::gemm_kernel" in k for k in names) == 1, names
    assert any("rowquant_kernel" in k for k in names), names
    assert torch.equal(first, again)
    with open(_build.library().path, "rb") as fh:
        assert b"gemm_s8" not in fh.read()


def _qmlp_case(dev, m, n, k=768, h=3072, seed=11):
    """x [m, k] and quant_mlp's weights (w1_t [h, k], s1, b1, w2_t [n, h],
    s2, b2) at the tower's widths, any output width n."""
    g = torch.Generator(device=dev).manual_seed(seed + m + n)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def mat(rows, cols):
        q, scale = qm.quantize_weight(r(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    w1, s1 = mat(k, h)
    w2, s2 = mat(h, n)
    return r(m, k, std=1.0), (w1, s1, r(h, std=0.02), w2, s2,
                              r(n, std=0.02))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m,n", [(None, None), (1, 8), (1, 13), (1, 768),
                                 (77, 8), (77, 13), (77, 768), (26624, 8),
                                 (26624, 13), (26624, 768)])
@FORMS
def test_int8_qmlp_kernel_matches_plain_and_controls_do_not(cuda, dtype, m,
                                                            n, fast):
    """The int8 case's small MLP (m None), then one row, a ragged 77 and a
    batch of 128's 26,624 rows at output widths 8, 13 (odd: the wgmma
    epilogue stores its last column alone) and 768, K 768 and H 3072."""
    if m is None:
        x, _attn, mlp = _int8_case(cuda)
        w = mlp[2:]                   # w1_t, s1, b1, w2_t, s2, b2
    else:
        x, w = _qmlp_case(cuda, m, n)
    x = x.to(dtype)
    n0 = qm.quant_mlp.launches
    got = qm.quant_mlp(x, *w, fast=fast)
    want = qm.quant_mlp_plain(x, *w, fast=fast)
    torch.cuda.synchronize()
    assert qm.quant_mlp.launches == n0 + 1
    assert got.dtype == dtype
    assert got.shape == (*x.shape[:-1], w[3].shape[0])
    assert _rel_err(got, want) <= DENSE_REL_TOL
    for i in (2, 5):                  # b1, b2
        q = list(w)
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(qm.quant_mlp_plain(x, *q, fast=fast),
                        want) > DENSE_REL_TOL, i
    for i in (1, 4):                  # s1, s2 -> their mean
        q = list(w)
        q[i] = torch.full_like(q[i], float(q[i].mean()))
        assert _rel_err(qm.quant_mlp_plain(x, *q, fast=fast),
                        want) > DENSE_REL_TOL, i
    assert _rel_err(qm.quant_mlp_plain(x, *w, fast=not fast),
                    want) > DENSE_REL_TOL


def test_int8_qmlp_runs_both_gemms_on_the_wgmma_kernel(cuda):
    """Row 11's route: the wgmma s8 GEMM (MLP in with its row maxima, MLP
    out), the one-pass quantization of the hidden, and no launch of the
    earlier mma.sync GEMM; the same bits twice."""
    from torch.profiler import ProfilerActivity, profile

    x, w = _qmlp_case(cuda, 77, 13)
    first = qm.quant_mlp(x, *w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = qm.quant_mlp(x, *w)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.self_device_time_total > 0]
    assert sum("ptt_s8::gemm_kernel" in k for k in names) == 2, names
    assert any("rowquant_amax_kernel" in k for k in names), names
    assert not any("gemm_s8_kernel" in k for k in names), names
    assert torch.equal(first, again)


def test_int8_dense_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(4, 40, device=cuda)
    w = torch.zeros(8, 40, dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.quant_dense(x, w, s)
    assert qm.quant_dense_plain(x.cpu(), w.cpu(), s.cpu()).shape == (4, 8)
    x, w = torch.randn(4, 48, device=cuda), w[:, :32].contiguous()
    with pytest.raises(ValueError):          # w_t [N, K] with K 32 != 48
        qm.quant_dense(x, w, s)
    with pytest.raises(ValueError):          # integer activations
        qm.quant_dense(x.to(torch.int32), w, s)
    w1 = torch.zeros(40, 48, dtype=torch.int8, device=cuda)
    w2 = torch.zeros(8, 40, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):   # H 40
        qm.quant_mlp(x, w1, torch.ones(40, device=cuda),
                     torch.zeros(40, device=cuda), w2, s, torch.zeros_like(s))


# The fine-tune's trainable blocks (rows 12, 13, 15, 16 of PERF.md's
# table).  Forward: the serving layer's gate.  Backward: a flipped bf16
# rounding of p, dn or ds (attention) or dg (MLP) would reach every
# product after it.  At ViT-B/16 widths chip_smoke.py measures 1.5e-7 to
# 3.6e-5 on the H100 (not measured at these widths); every control below
# moves the plain backward by 8.7e-3 or more.
TRAIN_BWD_REL_TOL = 4e-3


def _fold(wqkv, bqkv, gain=1.0, d=D, heads=HEADS):
    """(wqkv, bqkv) as the row-12/13 kernels take them: the q columns
    scaled by log2(e)/sqrt(hd), as fused_attention_block folds them, and
    those of head 0 by ``gain`` besides."""
    col = torch.ones(3 * d, device=wqkv.device)
    col[:d] = math.log2(math.e) / math.sqrt(d // heads)
    col[:d // heads] *= gain
    return ((wqkv.float() * col).to(torch.bfloat16).contiguous(),
            (bqkv.float() * col).contiguous())


# (B, S, D, heads, valid): the narrow layer with most keys pad, at head
# widths 64, 32 and 16; the CLIs' small tower (D 64 over 4 heads, 64 px
# images of 8 px patches: 65 tokens padded to 80); train_end's CLI tower
# (8 pairs of 32 px images of 8 px patches: 17 tokens padded to 32, D 64
# over 4 heads); the fine-tune's step at 64 pairs (128 images of
# ViT-B/16, the token axis padded to 208); a ragged batch at ViT-B/16's
# widths
ATTN_CASES = {"narrow": (3, S, D, HEADS, VALID),
              "narrow-hd32": (3, S, D, 4, VALID),
              "narrow-hd16": (3, S, D, 8, VALID),
              "small-tower": (8, 80, 64, 4, 65),
              "train-end-cli": (16, 32, 64, 4, 17),
              "vit-b16-B128": (128, 208, 768, 12, 197),
              "vit-b16-B3": (3, 208, 768, 12, 197)}


def _attn_case(dev, b, s, d, heads, valid, seed=0):
    """x, the folded (wqkv, bqkv), wout, bout and a cotangent da whose
    pad rows are 0 (as the tower's slice gives it)."""
    x, p = _layer_case(dev, b=b, seed=seed, s=s, d=d, f=8, valid=valid)
    wqkv, bqkv = _fold(p[2], p[3], d=d, heads=heads)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    da = torch.randn(x.shape, generator=g, device=dev)
    da[:, valid:] = 0.0
    return x, wqkv, bqkv, p[4], p[5], da.to(torch.bfloat16)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_trainable_attention_kernels_match_plain_and_controls_do_not(cuda,
                                                                     case):
    b, s, d, heads, valid = ATTN_CASES[case]
    x, wqkv, bqkv, wout, bout, da = _attn_case(cuda, b, s, d, heads, valid)
    n12, n13 = fa.fused_attention_fwd.launches, fa.fused_attention_bwd.launches
    got = fa.fused_attention_fwd(x, wqkv, bqkv, wout, bout, heads, valid)
    want = fa.fused_attention_block_plain(x, wqkv, bqkv, wout, bout, heads,
                                          valid)
    dqkv, a = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    dqkv_p, a_p = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, valid)
    torch.cuda.synchronize()
    assert (fa.fused_attention_fwd.launches, fa.fused_attention_bwd.launches) \
        == (n12 + 1, n13 + 1)
    v = slice(0, valid)
    assert _rel_err(got[:, v], want[:, v]) <= REL_TOL
    assert _rel_err(a[:, v], a_p[:, v]) <= REL_TOL
    assert _rel_err(dqkv[:, v], dqkv_p[:, v]) <= TRAIN_BWD_REL_TOL
    assert not dqkv[:, valid:].any()         # pad queries and pad keys
    zb = torch.zeros_like(bqkv)
    for name, ctrl in (
            ("no key mask", fa.fused_attention_block_plain(
                x, wqkv, bqkv, wout, bout, heads, s)),
            ("bqkv=0", fa.fused_attention_block_plain(
                x, wqkv, zb, wout, bout, heads, valid)),
            ("bout=0", fa.fused_attention_block_plain(
                x, wqkv, bqkv, wout, torch.zeros_like(bout), heads, valid))):
        assert _rel_err(ctrl[:, v], want[:, v]) > REL_TOL, name
    for name, ctrl in (
            ("no key mask", fa.attention_bwd_plain(x, wqkv, bqkv, da, heads,
                                                   s)[0]),
            ("bqkv=0", fa.attention_bwd_plain(x, wqkv, zb, da, heads,
                                              valid)[0])):
        assert _rel_err(ctrl[:, v], dqkv_p[:, v]) > TRAIN_BWD_REL_TOL, name


@pytest.mark.parametrize("d,heads,s,valid", [(768, 12, 208, 197),
                                              (64, 1, 16, 5)],
                         ids=["D768", "D64"])
@pytest.mark.parametrize("b", [1, 2, 3], ids=["B1", "B2", "B3"])
def test_trainable_attention_fwd_at_ragged_batches(cuda, b, d, heads, s,
                                                   valid):
    """Row 12 where B·S is not a multiple of the GEMM's 128-row tile, at
    ViT-B/16's width and at the narrowest D (one head: the GEMM's rows of
    64 values, 128 bytes), with most keys pad in the narrow case."""
    g = torch.Generator(device=cuda).manual_seed(b)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=cuda)

    x = r(b, s, d, std=1.0).to(torch.bfloat16)
    wqkv, bqkv = (r(d, 3 * d, std=d ** -0.5).to(torch.bfloat16),
                  r(3 * d, std=0.2))
    col = torch.ones(3 * d, device=cuda)
    col[:d] = math.log2(math.e) / 8.0
    wqkv, bqkv = (wqkv.float() * col).to(torch.bfloat16), bqkv * col
    wout, bout = r(d, d, std=d ** -0.5).to(torch.bfloat16), r(d, std=0.05)
    n0 = fa.fused_attention_fwd.launches
    got = fa.fused_attention_fwd(x, wqkv, bqkv, wout, bout, heads, valid)
    torch.cuda.synchronize()
    assert fa.fused_attention_fwd.launches == n0 + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()

    def plain(bq=bqkv, bo=bout, v=valid):
        return fa.fused_attention_block_plain(x, wqkv, bq, wout, bo, heads,
                                              v)[:, :valid]

    want = plain()
    assert _rel_err(got[:, :valid], want) <= REL_TOL
    for name, ctrl in (("no key mask", plain(v=s)),
                       ("bqkv=0", plain(bq=torch.zeros_like(bqkv))),
                       ("bout=0", plain(bo=torch.zeros_like(bout)))):
        assert _rel_err(ctrl, want) > REL_TOL, name


def test_trainable_attention_gates_the_clamp_on_the_card(cuda):
    """Head 0's q columns scaled 40x, so that a share of its scores passes
    +80: the five gradients of the whole differentiable block through the
    kernels are finite and agree with the plain versions', and the plain
    backward without the gate is far from the gated one."""
    x, p = _layer_case(cuda, seed=1)
    x = x[:, :VALID].contiguous()            # the block pads per call
    gain = torch.ones(3 * D, device=cuda)
    gain[:D // HEADS] = 40.0
    wqkv = (p[2].float() * gain).to(torch.bfloat16)
    bqkv = (p[3] * gain).to(torch.bfloat16)
    assert float(fa.attention_saturation(x.float(), wqkv.float(),
                                         bqkv.float(), HEADS)) \
        > fa.SCORE_CLAMP_HI
    g = torch.Generator(device=cuda).manual_seed(8)
    cot = torch.randn(x.shape, generator=g, device=cuda)
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, wqkv, bqkv, p[4], p[5].to(torch.bfloat16))]
        out = fa.fused_attention_block(*leaves, HEADS, kernels=kernels)
        (out.float() * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip(("x", "wqkv", "bqkv", "wout", "bout"),
                               *grads):
        assert torch.isfinite(got.float()).all(), name
        assert _rel_err(got, want) <= TRAIN_BWD_REL_TOL, name
    wqkv_f, bqkv_f = _fold(p[2], p[3], gain=40.0)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 32 - VALID))
    da = torch.nn.functional.pad(cot, (0, 0, 0, 32 - VALID)).to(
        torch.bfloat16)
    gated = fa.attention_bwd_plain(xp, wqkv_f, bqkv_f, da, HEADS, VALID)[0]
    ungated = fa.attention_bwd_plain(xp, wqkv_f, bqkv_f, da, HEADS, VALID,
                                     gate=False)[0]
    assert _rel_err(ungated, gated) > 10 * TRAIN_BWD_REL_TOL


@pytest.mark.parametrize(
    "m,d,f", [(64, D, F), (77, D, F), (25216, D, F),
              (2 * mm.CHUNK_ROWS + 77, D, F), (3 * 65, 64, 128),
              (16 * 17, 64, 128), (128 * 592, 1024, 4096),
              (128 * 592, 1280, 5120)],
    ids=["M64", "M77-ragged", "M25216-fine-tune", "three-chunks-ragged",
         "small-tower-M195-ragged", "train-end-cli-M272",
         "vit-l14-336-M75776", "vit-h14-widths-M75776"])
def test_trainable_mlp_kernels_match_plain_and_controls_do_not(cuda, m, d,
                                                                f):
    """Rows 15 and 16 against their plain versions; M 25,216 is the
    fine-tune's 64 pairs in one chunk (the weight gradients split over
    their rows, the last split ragged); the fourth case runs the
    backward's chunk loop (row offsets, the f32 accumulation of dW1 and
    dW2 across chunks, the column sums) with a ragged last chunk; the
    fifth is the CLIs' small tower (D 64, F 128: N narrower than the
    GEMM's 256-wide tile, K 64 one k-step) at B 3 of 65 tokens, the sixth
    train_end's CLI tower, 16 images of 17 tokens; the last two are the
    fine-tune's 64 pairs at ViT-L/14 @336's and ViT-H/14's widths (D
    1,024 / F 4,096 and D 1,280 / F 5,120) over 128 x 592 rows, three
    chunks with their f32 sums across chunks."""
    x, p = _layer_case(cuda, b=-(-m // S), d=d, f=f)
    x2 = x.reshape(-1, d)[:m].contiguous()
    lns, lnb, w1, b1, w2, b2 = p[6:12]
    n15, n16 = mm.fused_mlp_fwd.launches, mm.fused_mlp_bwd.launches
    got = mm.fused_mlp_fwd(x2, lns, lnb, w1, b1, w2, b2)
    want = mm.fused_mlp_block_bf16_plain(x2, lns, lnb, w1, b1, w2, b2)
    g = torch.Generator(device=cuda).manual_seed(9)
    do2 = torch.randn(x2.shape, generator=g, device=cuda).to(torch.bfloat16)
    grads = mm.fused_mlp_bwd(x2, do2, lns, lnb, w1, b1, w2)
    grads_p = mm._mlp_bwd_plain(x2, do2, lns, lnb, w1, b1, w2)
    no_b1 = mm._mlp_bwd_plain(x2, do2, lns, lnb, w1, torch.zeros_like(b1),
                              w2)
    no_tail = mm._mlp_bwd_plain(x2[:-13], do2[:-13], lns, lnb, w1, b1, w2)
    torch.cuda.synchronize()
    assert (mm.fused_mlp_fwd.launches, mm.fused_mlp_bwd.launches) == \
        (n15 + 1, n16 + 1)
    assert got.dtype == torch.bfloat16 and _rel_err(got, want) <= REL_TOL
    for i, name in ((3, "b1"), (5, "b2"), (1, "ln_bias")):
        q = [lns, lnb, w1, b1, w2, b2]
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(mm.fused_mlp_block_bf16_plain(x2, *q), want) \
            > REL_TOL, name
    assert [t.dtype for t in grads] == [torch.bfloat16] + [torch.float32] * 6
    for i, (a, b) in enumerate(zip(grads, grads_p)):
        assert _rel_err(a, b) <= TRAIN_BWD_REL_TOL, i
        if i:          # each cotangent sum: the ragged last rows count
            assert _rel_err(no_tail[i], b) > TRAIN_BWD_REL_TOL, i
    assert _rel_err(do2, grads_p[0]) > TRAIN_BWD_REL_TOL   # dLN dropped
    for i in range(6):
        assert _rel_err(no_b1[i], grads_p[i]) > TRAIN_BWD_REL_TOL, i


# row 16's MN-major GEMM against torch.matmul in f32 of the same bf16
# values: f32 sums of 25,216 exact products in another order, a few 1e-7
# of the sums' scale; dropping the last 64 rows moves them by ~5e-2
WGRAD_REL_TOL = 1e-5


@pytest.mark.parametrize("k", [25216, 25216 + 40], ids=["K25216",
                                                        "K-ragged"])
@pytest.mark.parametrize("m,n", [(3072, 768), (768, 3072)],
                         ids=["dW2", "dW1"])
def test_weight_grad_gemm_matches_matmul(cuda, m, n, k):
    """The weight-gradient GEMM alone (``mm.weight_grad``: aᵀ b over the
    rows, as the backward's dW2 = aᵀ do and dW1 = hᵀ dg) at the
    fine-tune's shapes, split as the backward splits them (on the H100,
    11 ways), the last split ragged."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(k, m, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=cuda).to(torch.bfloat16)
    ktiles, splits = -(-k // 64), mm.weight_grad_plan(k, m, n)
    assert splits > 1 and ktiles % -(-ktiles // splits)   # ragged last split
    n0 = mm.weight_grad.launches
    got = mm.weight_grad(a, b)
    want = torch.matmul(a.float().T, b.float())
    short = torch.matmul(a[:-64].float().T, b[:-64].float())
    torch.cuda.synchronize()
    assert mm.weight_grad.launches == n0 + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= WGRAD_REL_TOL * scale
    assert _rel_err(got, want) <= WGRAD_REL_TOL
    assert _rel_err(short, want) > WGRAD_REL_TOL


def test_redesigned_backward_kernels_give_equal_bits_twice(cuda):
    """Rows 16 and 13 (and row 16's weight-gradient GEMM) sum their
    partials in a fixed order, with no atomics: two runs give the same
    bits."""
    x, p = _layer_case(cuda, b=526)
    x2 = x.reshape(-1, D)[:25216].contiguous()
    lns, lnb, w1, b1, w2, _b2 = p[6:12]
    g = torch.Generator(device=cuda).manual_seed(9)
    do2 = torch.randn(x2.shape, generator=g, device=cuda).to(torch.bfloat16)
    runs = [mm.fused_mlp_bwd(x2, do2, lns, lnb, w1, b1, w2)
            for _ in range(2)]
    for i, (u, w) in enumerate(zip(*runs)):
        assert torch.equal(u, w), i
    b, s, d, heads, valid = ATTN_CASES["vit-b16-B128"]
    xa, wqkv, bqkv, _wo, _bo, da = _attn_case(cuda, b, s, d, heads, valid)
    runs = [fa.fused_attention_bwd(xa, wqkv, bqkv, da, heads, valid)
            for _ in range(2)]
    for u, w in zip(*runs):
        assert torch.equal(u, w)
    a = torch.randn(25216, 768, generator=g, device=cuda).to(torch.bfloat16)
    bm = torch.randn(25216, 3072, generator=g, device=cuda).to(
        torch.bfloat16)
    assert torch.equal(mm.weight_grad(a, bm), mm.weight_grad(a, bm))


def test_trainable_tower_step_kernels_match_plain_blocks(cuda):
    """One fine-tune step of a 3-layer tower (head_dim 64) from the same
    weights and batch, with the kernels and with the plain blocks: the
    step's metrics within 2e-3 relative, the trainable gradients within
    2e-2 in norm (1e-1 for the scalar logit_scale, a sum of cancelling
    terms), and the kernels launched once per layer and block."""
    vc = VisionConfig(image_size=32, patch_size=8, hidden_dim=D,
                      num_layers=3, num_heads=HEADS, mlp_dim=F,
                      projection_dim=32)
    cfg = ClipFinetuneConfig(batch_size=4, trainable_blocks=2)
    vgae = np.random.default_rng(0).standard_normal((10, 16)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8)).to(cuda)
    nodes = torch.from_numpy(rng.integers(0, 10, 4)).to(cuda)
    runs = []
    for kernels in (True, False):
        model, opt = finetune_clip.init_finetune_state(vc, cfg, vgae,
                                                       device=cuda)
        model.vit.kernels = kernels
        step, _ = finetune_clip.make_finetune_step(model, opt)
        counts = [fn.launches for fn in (
            fa.fused_attention_fwd, fa.fused_attention_bwd,
            mm.fused_mlp_fwd, mm.fused_mlp_bwd)]
        metrics = step(images, nodes, 0.05)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {k: t.grad.clone() for k, t in model.named_parameters()
                      if t.grad is not None},
                     [fn.launches - c for fn, c in zip(
                         (fa.fused_attention_fwd, fa.fused_attention_bwd,
                          mm.fused_mlp_fwd, mm.fused_mlp_bwd), counts)]))
    (mk, gk, nk), (mp, gp, np_) = runs
    assert nk == [2, 1, 2, 1] and np_ == [0, 0, 0, 0]
    for key, want in mp.items():
        assert math.isfinite(mk[key])
        assert mk[key] == pytest.approx(want, rel=2e-3), key
    assert set(gk) == set(gp)
    for name, want in gp.items():
        err = float((gk[name] - want).norm() / (want.norm() + 1e-12))
        assert err <= (2e-2 if want.numel() > 1 else 1e-1), (name, err)


def _end_to_end_run(dev, kernels, cfg, vc, batch, cot, label_num):
    """One train_end step from seeded weights (head dropout off): its
    metrics, the tower's trainable gradients given ``cot`` for its
    features, and the launches of rows 12, 13, 15 and 16 in the step."""
    from patent_tpu_torch.train import train_end

    model, opt = train_end.init_end_to_end(vc, cfg, label_num, seed=5,
                                           device=dev)
    model.vit.kernels = kernels
    step, _ = train_end.make_end_to_end_step(model, opt, cfg)
    model.hyp.eval()
    model.vit.zero_grad(set_to_none=True)
    model.vit(batch[0]).backward(cot)
    tower = {n: t.grad.clone() for n, t in model.vit.named_parameters()
             if t.grad is not None}
    entries = (fa.fused_attention_fwd, fa.fused_attention_bwd,
               mm.fused_mlp_fwd, mm.fused_mlp_bwd)
    counts = [e.launches for e in entries]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = {k: float(v) for k, v in step(*batch).items()}
    after = dict(model.named_parameters())
    frozen = [n for n, p in model.vit.named_parameters()
              if not p.requires_grad]
    assert frozen and all(torch.equal(after[f"vit.{n}"],
                                      before[f"vit.{n}"]) for n in frozen)
    c = cfg.curvature
    assert float(after["hyp.label_emb"].detach().norm(dim=1).max()) \
        < c ** -0.5
    return metrics, tower, [e.launches - n for e, n in zip(entries, counts)]


def test_train_end_step_at_full_width_kernels_match_plain_blocks(cuda):
    """One train_end step at ViT-B/16's widths (D 768, 12 heads, F 3072;
    3 layers, the last 2 trained, so block 0 is frozen; 4 pairs of 64 px
    images: S 17) with the kernels and with the plain blocks, from the
    same seeded weights: the metrics within 2e-3 relative (1e-4 absolute
    near 0, where the retrieval hinge may sit), the tower's
    gradients given one cotangent within 2e-2 in norm, the frozen block
    equal in bits after the step, every label row inside the ball, and
    rows 12, 13, 15 and 16 launched (none with the plain blocks)."""
    from patent_tpu_torch.utils.config import EndToEndConfig

    vc = VisionConfig(image_size=64, patch_size=16, num_layers=3)
    cfg = EndToEndConfig(batch_size=4, image_size=64, trainable_blocks=2)
    g = torch.Generator(device=cuda).manual_seed(2)
    label_num = 40
    batch = (torch.randn(8, 64, 64, 3, generator=g, device=cuda),
             torch.randint(0, 20, (4,), generator=g, device=cuda),
             torch.randint(0, 20, (4, 2), generator=g, device=cuda),
             torch.stack([torch.arange(20, device=cuda),
                          20 + torch.arange(20, device=cuda) % 5], 1))
    cot = torch.randn(8, vc.projection_dim, generator=g, device=cuda)
    (mk, tk, nk), (mp, tp, np_) = (
        _end_to_end_run(cuda, k, cfg, vc, batch, cot, label_num)
        for k in (True, False))
    assert nk == [2, 1, 2, 1] and np_ == [0, 0, 0, 0]
    assert list(mk) == list(mp)
    for key, want in mp.items():
        assert math.isfinite(mk[key])
        assert mk[key] == pytest.approx(want, rel=2e-3, abs=1e-4), key
    assert set(tk) == set(tp) and "blocks.0.wqkv" not in tk
    for name, want in tp.items():
        err = float((tk[name] - want).norm() / (want.norm() + 1e-12))
        assert err <= 2e-2, (name, err)


SPMM_REL_TOL = 1e-5


def test_spmm_above_the_sparse_threshold_matches_dense_and_repeats(cuda):
    """``spmm`` on a normalized adjacency of 20,000 nodes (above the
    trainers' 16,384-node switch to the sparse path) against the dense
    product (in f64, rounded to f32), forward and backward, and equal in bits on a second run; the
    control, the last 50 rows' edges dropped, misses the product."""
    import scipy.sparse as sp

    from patent_tpu_torch.models import gcn

    n, d = 20000, 64
    rng = np.random.default_rng(0)
    a = sp.random(n, n, density=2e-4, random_state=rng, format="csr")
    a.data[:] = 1.0
    adj = gcn.normalize_adjacency_sparse(((a + a.T) > 0).astype(np.float32))
    adj = adj.to(cuda)
    dense = torch.zeros(n, n, device=cuda)
    dense[adj.rows, adj.cols] = adj.vals
    g = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randn(n, d, generator=g, device=cuda)
    cot = torch.randn(n, d, generator=g, device=cuda)
    runs = []
    for _ in range(2):
        yy = y.clone().requires_grad_(True)
        out = gcn.spmm(adj, yy)
        out.backward(cot)
        runs.append((out.detach(), yy.grad))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    want = (dense.double() @ y.double()).float()
    want_g = (dense.T.double() @ cot.double()).float()
    assert _rel_err(runs[0][0], want) <= SPMM_REL_TOL
    assert _rel_err(runs[0][1], want_g) <= SPMM_REL_TOL
    keep = (adj.rows < n - 50).cpu().numpy()
    cut = gcn.sparse_adj(*(t.cpu().numpy()[keep] for t in (
        adj.rows, adj.cols, adj.vals)), n).to(cuda)
    assert _rel_err(gcn.spmm(cut, y), want) > SPMM_REL_TOL


def test_evaluate_embeddings_on_the_card_matches_the_host(cuda):
    """``evaluate_embeddings`` runs on the card by default and gives the
    host's report: the cosine ratios within 1e-5 relative (f32 means
    summed in another order), Hit@k equal (no ties among random rows);
    the control, one parent pair moved, changes Hit@1."""
    from patent_tpu_torch.metrics.embedding_quality import \
        evaluate_embeddings

    rng = np.random.default_rng(8)
    # offset from the origin, so that a random pair's cosine (~0.2) is no
    # mean of cancelling terms
    z = (rng.standard_normal((3000, 64)) + 0.5).astype(np.float32)
    parents = rng.integers(0, 3000, (500, 2))
    parents[:100, 1] = np.argsort(((z[parents[:100, 0], None] - z[None])
                                   ** 2).sum(-1), axis=1)[:, 1]
    neigh = rng.integers(0, 3000, (400, 2))
    got = evaluate_embeddings(z, parents, neigh)
    want = evaluate_embeddings(z, parents, neigh, device="cpu")
    assert set(got) == set(want)
    assert got["hierarchical_hit_at_k"] == want["hierarchical_hit_at_k"]
    assert want["hierarchical_hit_at_k"][1] >= 0.2
    for k, v in want.items():
        if k != "hierarchical_hit_at_k":
            assert got[k] == pytest.approx(v, rel=1e-5), k
    moved = parents.copy()
    moved[0, 1] = np.argsort(((z[moved[0, 0]] - z) ** 2).sum(-1))[-1]
    assert evaluate_embeddings(z, moved, neigh)["hierarchical_hit_at_k"][
        1] < got["hierarchical_hit_at_k"][1]


# ------------------------------------------------ hyperbolic kernels

# Rows 17 and 18 against their plain versions: both are f32 throughout
# and differ by the order of their sums (and the kernel's tanh / log
# against PyTorch's), a few 1e-7 of the largest value; the controls (c off
# by 1%, the bias dropped) move the output by 1e-3 or more of it.
HYP_REL_TOL = 1e-4


def _ball(g, n, d, c, dev, r_hi=0.95, r_lo=0.05):
    v = torch.randn(n, d, generator=g, device=dev)
    r = r_lo + (r_hi - r_lo) * torch.rand(n, 1, generator=g, device=dev)
    return (v / v.norm(dim=-1, keepdim=True) * r / math.sqrt(c)).contiguous()


def _max_rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize(
    "n,m,d", [(70, 150, 40), (256, 1000, 128), (256, 16059, 128),
              (1, 300, 128), (70, 1000, 5), (33, 500, 3)],
    ids=["ragged", "eval-like", "label-eval", "n1", "d5-unaligned",
         "d3-unaligned"])
@pytest.mark.parametrize("c", [1.0, 2.0])
def test_pairwise_dist_kernel_matches_plain(cuda, n, m, d, c):
    """Row 17 at the label evaluation's [256, 128] x [16,059, 128], a
    one-figure batch, and widths whose rows are not 16-byte aligned (the
    kernel's 4-byte copies)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x, y = _ball(g, n, d, c, cuda), _ball(g, m, d, c, cuda)
    n0 = pk.pairwise_dist_pallas.launches
    got = pk.pairwise_dist_pallas(x, y, c)
    assert pk.pairwise_dist_pallas.launches == n0 + 1
    ref = pk.pairwise_dist_pallas_plain(x, y, c)
    control = pk.pairwise_dist_pallas_plain(x, y, 1.01 * c)
    torch.cuda.synchronize()
    assert got.shape == (n, m) and bool(torch.isfinite(got).all())
    assert _max_rel(got, ref) <= HYP_REL_TOL
    assert _max_rel(control, ref) > HYP_REL_TOL


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_pairwise_dist_kernel_near_the_boundary(cuda, c):
    """Row 17 on points at radius 0.999/sqrt(c), where 1 - c|x|^2 is ~2e-3
    and the f32 sums of the squares set the error: any two orders differ
    by ~1e-5 of the largest distance there."""
    g = torch.Generator(device=cuda).manual_seed(99)
    x = _ball(g, 256, 128, c, cuda, 0.999, 0.999)
    y = _ball(g, 3000, 128, c, cuda, 0.999, 0.999)
    got = pk.pairwise_dist_pallas(x, y, c)
    ref = pk.pairwise_dist_pallas_plain(x, y, c)
    control = pk.pairwise_dist_pallas_plain(x, y, 1.01 * c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _max_rel(got, ref) <= HYP_REL_TOL
    assert _max_rel(control, ref) > HYP_REL_TOL


def test_pairwise_dist_is_one_launch_a_call(cuda):
    """Row 17 takes its squared norms inside its one kernel: the profiler
    sees one kernel, launched once a call; n 0 launches nothing."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(17)
    x, y = _ball(g, 256, 128, 2.0, cuda), _ball(g, 2000, 128, 2.0, cuda)
    pk.pairwise_dist_pallas(x, y, 2.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pk.pairwise_dist_pallas(x, y, 2.0)
        torch.cuda.synchronize()
    seen = [(e.key, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    assert len(seen) == 1 and seen[0][1] == 3, seen
    n0 = pk.pairwise_dist_pallas.launches
    assert pk.pairwise_dist_pallas(x[:0], y, 2.0).shape == (0, 2000)
    assert pk.pairwise_dist_pallas.launches == n0


@pytest.mark.parametrize("n,k,dout", [(70, 40, 24), (37, 512, 256),
                                      (20, 64, 300)],
                         ids=["ragged", "encoder", "two-groups"])
def test_mobius_dense_kernel_matches_plain(cuda, n, k, dout):
    c = 2.0
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(n, k, generator=g, device=cuda)
    # small enough that rows stay inside the ball: a row saturated onto
    # the boundary absorbs any bias Möbius-added to it
    w = torch.randn(k, dout, generator=g, device=cuda) * (0.05 / math.sqrt(k))
    bias = _ball(g, 1, dout, c, cuda, r_hi=0.3)[0]
    n0 = pk.mobius_dense_pallas.launches
    got = pk.mobius_dense_pallas(x, w, bias, c)
    assert pk.mobius_dense_pallas.launches == n0 + 1
    ref = pk.mobius_dense_pallas_plain(x, w, bias, c)
    control = pk.mobius_dense_pallas_plain(x, w, torch.zeros_like(bias), c)
    torch.cuda.synchronize()
    assert got.shape == (n, dout) and bool(torch.isfinite(got).all())
    assert _max_rel(got, ref) <= HYP_REL_TOL
    assert _max_rel(control, ref) > HYP_REL_TOL
    assert float(got.norm(dim=-1).max()) <= (1 - 4e-3) / math.sqrt(c) * (
        1 + 1e-6)


# Row 18 as thread-block clusters: one CTA (D 24), 4 and 5 CTAs of 64
# columns (D 256, 300), 8 of 128 (D 1024), and 8 of 128 in each of two
# and three column groups (D 2048 as hidden_dims=[2048] gives it; D 3000,
# the last group ragged); one row, a ragged last cluster of rows (37, 513)
# and the engine's batch (512).  The three row reductions are summed in
# another order than the plain version's.
@pytest.mark.parametrize("dout", [24, 256, 300, 1024, 2048, 3000])
@pytest.mark.parametrize("n", [1, 37, 512, 513])
def test_mobius_dense_cluster_kernel_matches_plain(cuda, n, dout):
    c, k = 2.0, 512
    g = torch.Generator(device=cuda).manual_seed(n * 7 + dout)
    x = torch.randn(n, k, generator=g, device=cuda)
    w = torch.randn(k, dout, generator=g, device=cuda) * (0.05 / math.sqrt(k))
    bias = _ball(g, 1, dout, c, cuda, r_hi=0.3)[0]
    got = pk.mobius_dense_pallas(x, w, bias, c)
    ref = pk.mobius_dense_pallas_plain(x, w, bias, c)
    control = pk.mobius_dense_pallas_plain(x, w, torch.zeros_like(bias), c)
    torch.cuda.synchronize()
    assert got.shape == (n, dout) and bool(torch.isfinite(got).all())
    assert _max_rel(got, ref) <= HYP_REL_TOL
    assert _max_rel(control, ref) > HYP_REL_TOL


def test_mobius_dense_unaligned_rows_and_saturated_rows(cuda):
    """K and D not multiples of 4 (the ring fills by 4-byte copies), and
    rows pushed past the projection radius (scaled onto it)."""
    c = 1.0
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(45, 37, generator=g, device=cuda)
    w = torch.randn(37, 27, generator=g, device=cuda)
    bias = _ball(g, 1, 27, c, cuda, r_hi=0.3)[0]
    got = pk.mobius_dense_pallas(x, w, bias, c)
    ref = pk.mobius_dense_pallas_plain(x, w, bias, c)
    torch.cuda.synchronize()
    assert _max_rel(got, ref) <= HYP_REL_TOL
    assert float(got.norm(dim=-1).max()) <= (1 - 4e-3) / math.sqrt(c) * (
        1 + 1e-6)


def test_mobius_dense_launches_clusters(cuda):
    """The encoder's 512 x 256 launches 128 CTAs in clusters of 4 (one
    wave on the H100's 132 SMs); D 1024 takes 8 CTAs of 128 columns, and
    D 2048 the same clusters over two column groups."""
    assert pk.mobius_dense_launch(512, 256) == {"ctas": 128, "cluster": 4,
                                                "cols": 64}
    assert pk.mobius_dense_launch(513, 1024) == {"ctas": 33 * 8,
                                                 "cluster": 8, "cols": 128}
    assert pk.mobius_dense_launch(1, 24) == {"ctas": 1, "cluster": 1,
                                             "cols": 64}
    assert pk.mobius_dense_launch(37, 2048) == {"ctas": 3 * 8, "cluster": 8,
                                                "cols": 128}


def test_hyperbolic_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(8, 16, device=cuda)
    with pytest.raises(ValueError):
        pk.pairwise_dist_pallas(x, torch.randn(4, 8, device=cuda), 1.0)
    with pytest.raises(ValueError):
        pk.pairwise_dist_pallas(x.double(), x.double(), 1.0)
    with pytest.raises(ValueError):
        pk.mobius_dense_pallas(x, torch.randn(16, 8200, device=cuda),
                               torch.zeros(8200, device=cuda), 1.0)
    w = torch.randn(16, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        pk.mobius_dense_pallas(x, w, torch.zeros(8, device=cuda), 1.0)
    gal = topk_kernel.prepare_poincare_gallery(
        torch.randn(100, 48, device=cuda) * 0.01, 1.0)
    with pytest.raises(ValueError, match="D % 32"):
        topk_kernel.bucket_topk_poincare(torch.randn(3, 48, device=cuda),
                                         gal, 16)


def _poincare_case(dev, nq, n, d, c=2.0, seed=7):
    """A ball gallery with copies of row 952 one and two steps later in its
    bucket (a tie that must go to the earliest copy), every 97th row masked
    (w = 0), and queries of which the first is row 952."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gal = _ball(g, n, d, c, dev)
    tie = min(952, n - 1)
    for m in (1, 2):
        if tie + 1024 * m < n:
            gal[tie + 1024 * m] = gal[tie]
    q = _ball(g, nq, d, c, dev)
    q[0] = gal[tie]
    pg = topk_kernel.prepare_poincare_gallery(gal, c)
    pg.w[::97] = 0.0
    return q, pg, tie


@pytest.mark.parametrize("d", [32, 128, 512])
@pytest.mark.parametrize("n", [700, 5000, 70000])
@pytest.mark.parametrize("nq", [1, 3, 65, 256, 300])
def test_poincare_bucket_kernel_equals_plain(cuda, nq, n, d):
    """Every tile width, one step and many (each N ends in a partial
    step; at D 32 and 128 a request brings four steps, so split ranges end
    in short groups), the planted tie and masked rows: the kernel's (v1,
    i1, v2, i2) equal the plain version's bit for bit, the tie goes to the
    earliest copy, no masked row appears and empty slots are (-inf, 0)."""
    q, pg, tie = _poincare_case(cuda, nq, n, d, seed=nq + n + d)
    terms = topk_kernel.quantize_poincare_queries(q)
    got = topk_kernel._bucket_top2_poincare_cuda(*terms, pg)
    want = topk_kernel.bucket_top2_poincare_plain(*terms, pg)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1][0, tie % 1024]) == tie
    bad = (pg.w <= 0).nonzero()[:, 0].to(torch.int32)
    for i, v in ((got[1], got[0]), (got[3], got[2])):
        live = v > float("-inf")
        assert not torch.isin(i[live], bad).any()
        assert (i[~live] == 0).all()


def test_poincare_stage_is_one_launch_and_the_merge(cuda):
    """Row 4 runs the bucket template's Poincaré instance: the profiler
    sees one stage launch and one merge a call (Q 256 over 70,000 rows
    takes several splits), and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, pg, _tie = _poincare_case(cuda, 256, 70000, 128)
    terms = topk_kernel.quantize_poincare_queries(q)
    topk_kernel._bucket_top2_poincare_cuda(*terms, pg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            topk_kernel._bucket_top2_poincare_cuda(*terms, pg)
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}
    stage = [k for k in seen if "bucket_top2_wg<2," in k]
    merge = [k for k in seen if "bucket_top2_merge" in k]
    assert len(stage) == 1 and seen[stage[0]] == 3, seen
    assert len(merge) == 1 and seen[merge[0]] == 3, seen
    assert len(seen) == 2, seen


def test_poincare_index_takes_the_kernel_path_and_equals_the_scan(cuda):
    c = 2.0
    g = torch.Generator(device=cuda).manual_seed(8)
    gal = _ball(g, 5000, 64, c, cuda)
    q = _ball(g, 16, 64, c, cuda)
    names = [f"g{i}" for i in range(5000)]
    n0 = topk_kernel.bucket_topk_poincare.launches
    v, i = EmbeddingIndex(gal, names, similarity="poincare", c=c,
                          quantized=True).search(q, k=10)
    assert topk_kernel.bucket_topk_poincare.launches == n0 + 1
    cv, ci = EmbeddingIndex(gal.cpu(), names, similarity="poincare",
                            c=c).search(q.cpu(), k=10)
    assert (i == ci).all()
    assert abs(v - cv).max() < 1e-4


def test_hyperbolic_model_kernels_match_plain_and_run_the_label_map(cuda):
    """The encoder with row 18 against its plain first layer, and the
    label-retrieval mAP through row 17 against the CPU's plain version."""
    gen = torch.Generator().manual_seed(4)
    model = HyperbolicEmbeddingModel(feature_dim=64, embed_dim=32,
                                     label_num=300, hidden_dims=(48,), c=2.0,
                                     generator=gen)
    x = torch.randn(100, 64, generator=gen)
    fig_pos = {i: [i % 250] for i in range(100)}
    want_map = evaluate.evaluate_retrieval_map(model.eval(), x.numpy(),
                                               range(100), fig_pos, 250,
                                               batch_size=32)
    model = model.to(cuda).eval()
    with torch.no_grad():
        got = model(x.to(cuda))
        model.encoder.first_layer.kernels = False
        ref = model(x.to(cuda))
        model.encoder.first_layer.kernels = True
    assert _max_rel(got, ref) <= HYP_REL_TOL
    n17, n18 = pk.pairwise_dist_pallas.launches, pk.mobius_dense_pallas.launches
    got_map = evaluate.evaluate_retrieval_map(model, x.numpy(), range(100),
                                              fig_pos, 250, batch_size=32)
    assert pk.pairwise_dist_pallas.launches == n17 + 4
    assert pk.mobius_dense_pallas.launches == n18 + 4
    assert got_map == pytest.approx(want_map, abs=1e-4)


def test_hyperbolic_model_trains_on_the_card(cuda):
    """While autograd records, the encoder's first layer takes the plain
    chain (row 18 has no backward), as JAX's model is differentiable: the
    gradients on the card equal the CPU's, and row 18 still launches under
    no_grad."""
    gen = torch.Generator().manual_seed(12)
    model = HyperbolicEmbeddingModel(feature_dim=64, embed_dim=32,
                                     label_num=50, hidden_dims=(48,), c=2.0,
                                     generator=gen).eval()
    x = 0.1 * torch.randn(40, 64, generator=gen)

    def grads(m, xs):
        m.zero_grad(set_to_none=True)
        out = m(xs)
        (out.norm(dim=-1).sum() + m.labels().norm(dim=-1).sum()).backward()
        return {n: p.grad.detach().cpu() for n, p in m.named_parameters()}

    want = grads(model, x)
    model = model.to(cuda)
    n18 = pk.mobius_dense_pallas.launches
    got = grads(model, x.to(cuda))
    assert pk.mobius_dense_pallas.launches == n18
    assert set(got) == set(want)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert float((g - want[name]).norm()) <= 1e-4 * float(
            want[name].norm()) + 1e-7, name
    assert float(got["encoder.first_layer.kernel"].norm()) > 0.0
    with torch.no_grad():
        model(x.to(cuda))
    assert pk.mobius_dense_pallas.launches == n18 + 1


# ------------------------------- the CLIs' small tower and narrow widths
#
# The JAX package serves these calls; so does the port, on its kernels:
# the attention kernels' head_dim-16 instances run the CLIs' small tower
# (D 64 over 4 heads), the index pads its candidate copies to the bucket
# kernels' multiple of columns, and row 18 takes wide layers in column
# groups.

# the metric battery on the card and on the CPU: the same weights, features
# summed in another order (tests/test_torch_pipeline.py holds the port to
# JAX within METRIC_ATOL).  The int8 tower flips an int8 code under such a
# perturbation and carries it on: in one H100 run, gallery features
# 0.99993 apart (min cosine) moved MRR@5 by 0.0108 over the corpus's 80
# queries (one reciprocal-rank step of a query is 0.5 / 80), so the int8
# run is held by its features alone
METRIC_ATOL = 0.01
FEATURE_MIN_COS = 0.9999


def _battery(path):
    with open(os.path.join(path, "results",
                           "evaluation_results_GE.json")) as f:
        summary = json.load(f)["summary_metrics"]
    (npy,) = [f for f in os.listdir(os.path.join(path, "embeddings"))
              if f.endswith(".npy")]
    return summary, torch.from_numpy(np.load(os.path.join(
        path, "embeddings", npy)))


@pytest.mark.parametrize("flags", [[], ["--quantize"]], ids=["bf16", "int8"])
def test_cli_eval_synthetic_runs_on_the_card(cuda, tmp_path, flags,
                                             monkeypatch):
    """``eval --synthetic`` builds the CLI's small tower (D 64, 4 heads:
    head_dim 16) through build_engine on a fresh 64 px corpus.  On the
    default device its attention kernels launch, and the gallery features
    (and, in bf16, the battery) equal the CPU run's.  The CPU computes the
    int8 kernels' exact form, so the card runs it too
    (PATENT_TPU_FAST_KERNELS=0): the card's default, the fast form, is
    another function."""
    from patent_tpu_torch.cli.main import main as cli
    monkeypatch.setenv(qm.FAST_ENV, "0")
    entries = ((qm.quant_attention_block, qm.quant_attention_cls,
                qm.quant_mlp_block) if flags else
               (bf16_layer.fused_layer_block_bf16,
                bf16_layer.fused_layer_cls_bf16))
    launched = [e.launches for e in entries]
    card, cpu = str(tmp_path / "card"), str(tmp_path / "cpu")
    assert cli(["eval", "--path", card, "--synthetic"] + flags) == 0
    assert all(e.launches > n for e, n in zip(entries, launched))
    assert cli(["eval", "--path", cpu, "--synthetic", "--device", "cpu"]
               + flags) == 0
    (want, want_emb), (got, got_emb) = _battery(cpu), _battery(card)
    assert got_emb.shape == want_emb.shape == (160, 64)
    assert _min_cosine(got_emb, want_emb) >= FEATURE_MIN_COS
    assert set(got) == set(want)
    if not flags:
        for key, w in want.items():
            assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key


def test_cli_finetune_runs_on_the_card(cuda, tmp_path):
    """A bare ``finetune --epochs 1`` trains the small tower (head_dim 16)
    on its synthetic corpus: the attention and MLP blocks' kernels, finite
    losses and a checkpoint."""
    from patent_tpu_torch.cli.main import main as cli
    entries = (fa.fused_attention_fwd, fa.fused_attention_bwd,
               mm.fused_mlp_fwd, mm.fused_mlp_bwd)
    launched = [e.launches for e in entries]
    assert cli(["finetune", "--path", str(tmp_path), "--epochs", "1"]) == 0
    assert all(e.launches > n for e, n in zip(entries, launched))
    ckpt = tmp_path / "models" / "clip_finetune_best"
    with open(ckpt / "metadata.json") as f:
        assert math.isfinite(json.load(f)["val_loss"])


@pytest.mark.parametrize("d", [10, 48, 100])
def test_index_bucket_paths_take_any_width(cuda, d):
    """The bf16, int8 and Poincaré candidate stages at widths their kernels
    take only zero-padded: each launches and equals the exact ranking
    index for index (cosine: the f32 scan; Poincaré: the f64 distance)."""
    from patent_tpu_torch.retrieval import index as index_mod
    g = torch.Generator(device=cuda).manual_seed(d)
    n = 3000
    gal = torch.randn(n, d, generator=g, device=cuda)
    q = gal[:16] + 0.3 * torch.randn(16, d, generator=g, device=cuda)
    names = [f"g{i}" for i in range(n)]
    _sv, want = index_mod.topk_search(q, gal, k=10)
    want = want.cpu().numpy()
    for entry, kw in ((topk_kernel.bucket_topk_bf16, {}),
                      (topk_kernel.bucket_topk_int8, {"quantized": True})):
        n0 = entry.launches
        _v, got = EmbeddingIndex(gal, names, device=cuda, **kw).search(q,
                                                                       k=10)
        torch.cuda.synchronize()
        assert entry.launches == n0 + 1, entry.__name__
        assert np.array_equal(got, want), entry.__name__
    c = 2.0
    ball, qb = _ball(g, n, d, c, cuda), _ball(g, 16, d, c, cuda)
    n0 = topk_kernel.bucket_topk_poincare.launches
    _v, got = EmbeddingIndex(ball, names, similarity="poincare", c=c,
                             quantized=True).search(qb, k=10)
    torch.cuda.synchronize()
    assert topk_kernel.bucket_topk_poincare.launches == n0 + 1
    dist = index_mod.poincare_dist_f64(qb, ball.expand(16, -1, -1), c)
    want = torch.sort(dist, dim=1, stable=True).indices[:, :10]
    assert np.array_equal(got, want.cpu().numpy())


def test_mobius_dense_layer_at_2048_columns_and_no_rows(cuda):
    """hidden_dims=[2048] (which both CLIs accept): the first layer runs
    row 18 over two column groups, as close to the plain chain as at any
    width; an empty batch launches nothing and returns [0, 2048]."""
    from patent_tpu_torch.models.hyperbolic import MobiusDense
    gen = torch.Generator().manual_seed(5)
    layer = MobiusDense(64, 2048, c=2.0, hyperbolic_input=False,
                        generator=gen).to(cuda)
    x = 0.02 * torch.randn(37, 64, generator=gen).to(cuda)
    n18 = pk.mobius_dense_pallas.launches
    with torch.no_grad():
        got = layer(x)
        empty = layer(x[:0])
        want = pk.mobius_dense_pallas_plain(x, layer.kernel, layer.hyp_bias,
                                            2.0)
    torch.cuda.synchronize()
    assert pk.mobius_dense_pallas.launches == n18 + 1
    assert got.shape == (37, 2048) and empty.shape == (0, 2048)
    assert _max_rel(got, want) <= HYP_REL_TOL


def test_vit_b16_towers_launch_their_kernels(cuda):
    """At ViT-B/16's shapes every attention entry launches its kernel:
    the counts of each tower are those of its layers."""
    from patent_tpu_torch.models.vit import VIT_B16
    tower = VisionTransformer(VIT_B16, generator=torch.Generator()
                              .manual_seed(0)).to(cuda).eval()
    tower8 = Int8VisionTransformer.from_float(tower).eval()
    flash = VisionTransformer(VIT_B16, fused_layer=False, use_flash=True)
    flash.load_state_dict(tower.state_dict())
    flash = flash.to(cuda).eval()
    entries = (bf16_layer.fused_layer_block_bf16,
               bf16_layer.fused_layer_cls_bf16, qm.quant_attention_block,
               qm.quant_attention_cls, qm.quant_layer_block,
               fa.flash_attention, fa.fused_attention_fwd,
               fa.fused_attention_bwd)
    for e in entries:
        e.launches = 0
    pix = torch.randn(4, 224, 224, 3, device=cuda)
    with torch.inference_mode():
        tower(pix[:2])
        tower8(pix)
        tower8(pix[:3])
        flash(pix[:2])
    torch.cuda.synchronize()
    assert [e.launches for e in entries] == [11, 1, 11, 2, 11, 12, 0, 0]


# ---- the retrieval server over a CUDA index


def _served_index(dev, n=5000, d=64, seed=40):
    """A RetrievalService over a CUDA EmbeddingIndex of n random rows, with
    an engine that only holds it (no tower)."""
    from patent_tpu_torch.retrieval.engine import RetrievalEngine
    from patent_tpu_torch.retrieval.server import RetrievalService

    g = torch.Generator(device=dev).manual_seed(seed)
    gal = torch.randn(n, d, generator=g, device=dev)
    names = [f"figs/g{i}.png" for i in range(n)]
    engine = RetrievalEngine(lambda b: b, dev, batch_size=32, image_size=224)
    engine.index = EmbeddingIndex(gal, names, device=dev)
    return RetrievalService(engine), gal


def _ranked(index, q, k):
    """index.search's answer as the service names it: (basenames, scores)
    a query row."""
    vals, idx = index.search(q, k=k)
    return [([os.path.basename(index.names[j]) for j in ri], rv.tolist())
            for ri, rv in zip(idx, vals)]


def _answers(out):
    return [([r["name"] for r in row], [r["score"] for r in row])
            for row in out["results"]]


def _same_answers(got, want, tol=1e-6):
    return all(gn == wn and np.allclose(gs, ws, rtol=0, atol=tol)
               for (gn, gs), (wn, ws) in zip(got, want, strict=True))


def test_retrieval_service_on_a_cuda_index_equals_index_search(cuda):
    """features (three rows, noisy copies of gallery rows) and name queries
    through the service launch row 3 (the 16-deep k bucket's pool of 128 is
    smaller than the 5,000-row gallery) and answer what index.search
    answers on the card: the same names, scores within 1e-6 (the re-rank's
    f32 dots over another batch); /stats names the index."""
    service, gal = _served_index(cuda)
    index = service.engine.index
    g = torch.Generator(device=cuda).manual_seed(41)
    q = (gal[[3, 700, 4999]] + 0.3 * torch.randn(3, gal.shape[1], generator=g,
                                                 device=cuda)).cpu().numpy()
    n0 = topk_kernel.bucket_topk_bf16.launches
    out = service.search({"features": q.tolist(), "k": 10})
    assert topk_kernel.bucket_topk_bf16.launches > n0
    assert _same_answers(_answers(out), _ranked(index, q, 10))
    assert [row[0][0] for row in _answers(out)] == \
        ["g3.png", "g700.png", "g4999.png"]
    for name, row in (("figs/g17.png", 17), ("g42.png", 42)):
        out = service.search({"name": name, "k": 5})
        want = _ranked(index, gal[row:row + 1].cpu().numpy(), 5)
        assert _same_answers(_answers(out), want)
        assert _answers(out)[0][0][0] == f"g{row}.png"
    assert service.stats() == {
        "gallery_size": 5000, "dim": 64, "similarity": "cosine",
        "curvature": 1.0, "sharded": False, "batch_size": 32,
        "image_size": 224}


def test_retrieval_service_on_a_cuda_index_under_concurrency(cuda):
    """8 threads x 8 single-row requests: every answer equals the same
    request served alone, and the batcher coalesced (fewer dispatches than
    requests)."""
    import threading

    service, gal = _served_index(cuda)
    g = torch.Generator(device=cuda).manual_seed(42)
    q = (gal[:64] + 0.3 * torch.randn(64, gal.shape[1], generator=g,
                                      device=cuda)).cpu().numpy()
    alone = [_answers(service.search({"features": [row.tolist()], "k": 10}))
             for row in q]
    d0, r0 = service.batcher.dispatches, service.batcher.requests
    got: list = [None] * 64
    errs: list = []

    def client(c):
        try:
            for r in range(8):
                i = 8 * c + r
                got[i] = _answers(service.search(
                    {"features": [q[i].tolist()], "k": 10}))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    assert all(_same_answers(a, b) for a, b in zip(got, alone, strict=True))
    assert service.batcher.requests - r0 == 64
    assert service.batcher.dispatches - d0 < 64


# ------------------------------------------ keep-token serving profiles

# The `recommended` and `turbo` serving profiles keep the 175 / 127
# darkest patches of a 224 px image (S 176 / 128 with CLS), at narrow
# widths (head_dim 64)
KT_CFG = VisionConfig(image_size=224, patch_size=16, hidden_dim=D,
                      num_layers=3, num_heads=HEADS, mlp_dim=F,
                      projection_dim=32)


def _kt_pixels(dev, b=4, seed=12):
    """Drawings: a light page with dark strokes, so the ink ranking that
    selects the kept patches varies by patch."""
    g = torch.Generator().manual_seed(seed)
    px = 0.9 + 0.1 * torch.rand(b, 224, 224, 3, generator=g)
    strokes = torch.rand(b, 224, 224, 1, generator=g) < 0.2
    return torch.where(strokes, 0.1 * px, px).to(dev)


def _kt_tower(dev, keep, dtype=torch.bfloat16, cls=VisionTransformer):
    gen = torch.Generator().manual_seed(13)
    kw = {} if cls is not VisionTransformer else {"dtype": dtype}
    tower = cls(KT_CFG, keep_tokens=keep, generator=gen, **kw)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    return tower.to(dev)


@pytest.mark.parametrize("keep", [175, 127], ids=["recommended", "turbo"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_serving_towers_at_keep_tokens_match_plain(cuda, kind, keep):
    """Both serving towers at the profiles' keep-tokens, kernels against
    the plain layers (the bf16 gates of the fused-layer tower; the int8
    tower's, whose flipped codes compound), and the kept tokens matter:
    the same tower with every token is farther from the plain keep-token
    tower than the bf16 gate (1e-2 to 2.4e-2 on the CPU)."""
    if kind == "bf16":
        tower = _kt_tower(cuda, keep).eval()
        full = _kt_tower(cuda, None).eval()
        fns = (bf16_layer.fused_layer_block_bf16,
               bf16_layer.fused_layer_cls_bf16)
        rel, cos = 4e-3, 0.9999
    else:
        tower = Int8VisionTransformer.from_float(
            _kt_tower(cuda, keep, torch.float32)).eval()
        full = Int8VisionTransformer.from_float(
            _kt_tower(cuda, None, torch.float32)).eval()
        fns = (qm.quant_attention_block, qm.quant_attention_cls,
               qm.quant_mlp_block)
        rel, cos = 2e-2, 0.999
    px = _kt_pixels(cuda)
    counts = [fn.launches for fn in fns]
    with torch.inference_mode():
        got = tower(px)
        every = full(px)
        tower.kernels = False
        want = tower(px)
    assert all(fn.launches > c for fn, c in zip(fns, counts))
    assert got.shape == (4, 32) and torch.isfinite(got).all()
    assert _rel_err(got, want) <= rel
    assert _min_cosine(got, want) > cos
    assert _rel_err(every, want) > 4e-3


@pytest.mark.parametrize("keep", [175, 127], ids=["recommended", "turbo"])
def test_trainable_tower_at_keep_tokens_matches_plain(cuda, keep):
    """The fine-tune tower at the profiles' keep-tokens, forward and
    backward, with the kernels (rows 12, 13, 15, 16) against the plain
    blocks: features within 4e-3 relative, every gradient within 2e-2 in
    norm (the step test's gate)."""
    from patent_tpu_torch.models.vit import TrainableVisionTransformer

    px = _kt_pixels(cuda)
    fns = (fa.fused_attention_fwd, fa.fused_attention_bwd, mm.fused_mlp_fwd,
           mm.fused_mlp_bwd)
    runs = []
    for kernels in (True, False):
        tower = _kt_tower(cuda, keep, cls=TrainableVisionTransformer)
        tower.kernels = kernels
        counts = [fn.launches for fn in fns]
        out = tower(px)
        (out.float() ** 2).sum().backward()
        runs.append((out.detach().float(),
                     {n: p.grad.clone() for n, p in tower.named_parameters()
                      if p.grad is not None},
                     [fn.launches - c for fn, c in zip(fns, counts)]))
    (ok, gk, nk), (op, gp, np_) = runs
    assert all(n > 0 for n in nk) and np_ == [0, 0, 0, 0]
    assert _rel_err(ok, op) <= 4e-3 and _min_cosine(ok, op) > 0.9999
    assert set(gk) == set(gp)
    for name, want in gp.items():
        err = float((gk[name] - want).norm() / (want.norm() + 1e-12))
        assert err <= 2e-2, (name, err)


# ------------------------------------------------ the hyperbolic trainer

def _distinct_pairs(rng, n, count):
    a = rng.integers(0, n, count)
    return np.stack([a, (a + rng.integers(1, n, count)) % n], 1)


def test_train_hyp_loss_and_step_on_the_card_match_the_cpu(cuda):
    """One train_hyp step (the loss with a hand-made exclusion set, whose
    disjointedness branch the card's prepared data never reaches, its
    gradients and the Riemannian Adam update) on the card against the same
    step on the CPU: metrics within 1e-4 relative, gradients within 1e-3
    of each leaf's largest entry, the updated params within 1e-6 (the
    card contracts multiply-adds and divides by scalars through their
    reciprocals).  Features x 0.1 keep the first layer inside the ball,
    where its bias's gradient is not f32 noise."""
    from patent_tpu_torch.losses.hierarchy import hierarchical_margin_losses
    from patent_tpu_torch.train import optim
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.utils.config import HypTrainConfig

    cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), use_dropout=False)
    rng = np.random.default_rng(0)
    n_lab, n_fig, b = 60, 200, 24
    x = torch.from_numpy((0.1 * rng.standard_normal((n_fig, 32))).astype(
        np.float32))
    impl = torch.from_numpy(_distinct_pairs(rng, n_lab, 40))
    excl = torch.from_numpy(_distinct_pairs(rng, n_lab, 25))
    valid = np.ones(b, np.float32)
    valid[-4:] = 0.0
    batch = (rng.integers(0, n_fig, b), rng.integers(0, n_lab, b),
             rng.integers(0, n_lab, (b, 2)), rng.integers(0, n_fig, b),
             (rng.random(b) < 0.5).astype(np.float32), valid)
    out = {}
    for dev in ("cpu", cuda):
        model = HyperbolicEmbeddingModel(
            feature_dim=32, embed_dim=16, label_num=n_lab, hidden_dims=(32,),
            c=2.0, generator=torch.Generator().manual_seed(3)).to(dev)
        if dev == "cpu":
            _ins, disjoint = hierarchical_margin_losses(model.label_emb,
                                                        impl, excl, 2.0)
            assert float(disjoint.detach()) > 0.0     # the branch is live
        opt = optim.RiemannianAdam(dict(model.named_parameters()),
                                   cfg.learning_rate, c=2.0)
        tb = tuple(torch.as_tensor(a).to(dev) for a in batch)
        grads, metrics = th.step_grads(model, opt,
                                       th.make_loss_fn(model, cfg), tb,
                                       x.to(dev), impl.to(dev), excl.to(dev))
        opt.step(grads)
        out[str(dev)] = (metrics.cpu(),
                         {n: p.grad.cpu() for n, p in model.named_parameters()},
                         {n: p.detach().cpu()
                          for n, p in model.named_parameters()})
    (mc, gc, pc), (mg, gg, pg) = out["cpu"], out[str(cuda)]
    assert torch.allclose(mg, mc, rtol=1e-4, atol=0)
    for n in gc:
        assert float((gg[n] - gc[n]).abs().max()) <= \
            1e-3 * float(gc[n].abs().max()), n
        assert float((pg[n] - pc[n]).abs().max()) <= 1e-6, n


def _hyp_td(tmp_path):
    from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data

    return ensure_training_data(str(tmp_path / "data"), True)


def test_train_hyp_on_the_card_is_deterministic_and_resumes(cuda, tmp_path):
    """Dropout on: two runs of three epochs give the same history and best
    params in bits, and so does a run of two epochs resumed to three (the
    label table's and the features' gathers sum their gradients by a
    sorted, ordered reduction on the card)."""
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.utils.checkpoint import CheckpointManager
    from patent_tpu_torch.utils.config import HypTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    td = _hyp_td(tmp_path)

    def run(name, epochs, resume=False):
        cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), batch_size=32,
                             epochs=epochs)
        return th.train_hyperbolic_retrieval(
            td, cfg, logger=MetricsLogger(print_every=0),
            ckpt=CheckpointManager(str(tmp_path / name)), resume=resume,
            device=cuda)

    best_a, hist_a = run("a", 3)
    best_b, hist_b = run("b", 3)
    run("c", 2)
    best_c, hist_c = run("c", 3, resume=True)
    for best, hist in ((best_b, hist_b), (best_c, hist_c)):
        assert hist["train_loss"] == hist_a["train_loss"]
        assert hist["val_loss"] == hist_a["val_loss"]
        for k in best_a:
            assert torch.equal(best[k], best_a[k]), k


def test_train_hyp_map_validation_launches_rows_17_and_18(cuda, tmp_path):
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.utils.config import HypTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    td = _hyp_td(tmp_path)
    n17, n18 = pk.pairwise_dist_pallas.launches, pk.mobius_dense_pallas.launches
    _best, hist = th.train_hyperbolic_retrieval(
        td, HypTrainConfig(embed_dim=16, hidden_dims=(32,), batch_size=32,
                           epochs=1, validate_with="map"),
        logger=MetricsLogger(print_every=0), device=cuda)
    assert pk.pairwise_dist_pallas.launches > n17
    assert pk.mobius_dense_pallas.launches > n18
    assert len(hist["val_map"]) == 1 and 0.0 <= hist["val_map"][0] <= 1.0


def test_poincare_index_on_a_crowded_gallery_matches_the_cpu(cuda):
    """A gallery on a narrow band at the projection radius (what a model
    trained on the synthetic corpus encodes): row 4's stage equals its
    plain version in bits there, the quantized index launches it once a
    search, and its answers match the same index on the CPU (scores
    within 1e-6 relative: the f64 re-rank in another summation order)."""
    from patent_tpu_torch.retrieval import index as ix

    rng = np.random.default_rng(0)
    n, d, c = 20000, 32, 2.0
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0][:, :3]
    t = rng.uniform(0.0, 0.3, n)
    pts = np.stack([np.cos(t), np.sin(t), 1e-4 * rng.standard_normal(n)],
                   1) @ basis.T
    radius = (1.0 - 4e-3) / math.sqrt(c)
    gal = torch.from_numpy((pts / np.linalg.norm(pts, axis=1, keepdims=True)
                            * radius).astype(np.float32)).to(cuda)
    q = gal[torch.arange(0, n, 997, device=cuda)] * 0.9999
    names = [str(i) for i in range(n)]
    index = ix.EmbeddingIndex(gal, names, similarity="poincare", c=c,
                              quantized=True)
    terms = topk_kernel._poincare_queries(q, index.emb_gal)
    got = topk_kernel._bucket_top2_poincare_cuda(*terms, index.emb_gal)
    want = topk_kernel.bucket_top2_poincare_plain(*terms, index.emb_gal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n4 = topk_kernel.bucket_topk_poincare.launches
    vals, idx = index.search(q, k=10)
    assert topk_kernel.bucket_topk_poincare.launches == n4 + 1
    cv, ci = ix.EmbeddingIndex(gal.cpu(), names, similarity="poincare", c=c,
                               device="cpu", quantized=True).search(
                                   q.cpu(), k=10)
    np.testing.assert_allclose(vals, cv, rtol=1e-6)
    assert np.mean(idx == ci) >= 0.99


# the text tower on the card against the CPU, f32 on both (no TF32): a
# row's relative error
TEXT_ROW_REL_TOL = 1e-4


def _text_ids(vocab, length, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab - 1, size=(batch, length))
    for row in range(batch):
        eos = 5 + (row * 17) % (length - 5)
        ids[row, eos] = vocab - 1
        ids[row, eos + 1:] = 0
    return torch.from_numpy(ids)


def _row_rel(got, want):
    return float(((got.float().cpu() - want).norm(dim=1)
                  / want.norm(dim=1)).max())


def test_text_tower_b_on_the_card_matches_the_cpu(cuda):
    """TEXT_B (vocab 49,408, context 77, 12 layers of 512) from one seeded
    state dict on the card and on the CPU; without the causal mask (the
    control) the card's features move far past the gate."""
    from patent_tpu_torch.models.vit import (TEXT_B, TextTransformer,
                                             transformer_block)

    cpu = TextTransformer(TEXT_B, generator=torch.Generator().manual_seed(0))
    card = TextTransformer(TEXT_B, device=cuda)
    card.load_state_dict(cpu.state_dict())
    ids = _text_ids(TEXT_B.vocab_size, TEXT_B.context_length, 6)
    with torch.inference_mode():
        want = cpu.eval()(ids)
        got = card.eval()(ids.to(cuda))
        x = card.embed(ids.to(cuda))
        for layer in card.blocks:
            x = transformer_block(x, layer, TEXT_B.num_heads, torch.float32)
        ctrl = card.readout(x, ids.to(cuda))
    assert got.dtype == torch.float32 and got.shape == (6, 512)
    assert _row_rel(got, want) <= TEXT_ROW_REL_TOL
    assert _row_rel(ctrl, want) > TEXT_ROW_REL_TOL


def test_build_text_feature_dicts_runs_on_the_card_by_default(cuda):
    from patent_tpu_torch.data.text_features import build_text_feature_dicts
    from patent_tpu_torch.models.vit import TextConfig, TextTransformer

    cfg = TextConfig(hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
                     projection_dim=64)
    defs = {f"A{i:02d}": f"definition number {i} of a class"
            for i in range(40)}
    titles = {f"USD{i:07d}": f"ornamental design for a lamp {i}"
              for i in range(300)}
    runs = []
    for device in (None, "cpu"):
        model = TextTransformer(cfg, generator=torch.Generator().manual_seed(1))
        runs.append(build_text_feature_dicts(defs, titles, model=model,
                                             device=device))
        if device is None:
            assert model.token_embedding.is_cuda
    for got, want in zip(*runs):
        assert list(got) == list(want)
        g, w = (torch.from_numpy(np.stack(list(d.values())))
                for d in (got, want))
        assert _row_rel(g, w) <= TEXT_ROW_REL_TOL


@pytest.mark.parametrize("flags", [[], ["--quantize"]], ids=["bf16", "int8"])
def test_cli_eval_checkpoint_equals_the_same_weights_as_a_finetune(
        cuda, tmp_path, flags):
    """One seeded small tower served twice on the card through the CLI: as
    ``clip_finetune_best`` and from an HF directory (``pytorch_model.bin``)
    by ``eval --checkpoint``.  The gallery features are equal in bits."""
    from patent_tpu_torch.cli.main import main as cli
    from patent_tpu_torch.models.clip_import import (TORCH_FILE,
                                                     hf_clip_vision_state_dict)
    from patent_tpu_torch.models.weights import params_to_jax
    from patent_tpu_torch.retrieval.cli_actions import write_synthetic_split
    from patent_tpu_torch.utils import checkpoint

    cfg = VisionConfig(image_size=64, patch_size=8, hidden_dim=64,
                       num_layers=2, num_heads=4, mlp_dim=128,
                       projection_dim=64)
    tower = VisionTransformer(cfg, generator=torch.Generator().manual_seed(5))
    path, hf = str(tmp_path / "run"), tmp_path / "hf"
    write_synthetic_split(path, 64, num_patents=10)
    checkpoint.save(os.path.join(path, "models"), "clip_finetune_best",
                    {"params": {"vit": params_to_jax(tower.state_dict())},
                     "step": 0})
    hf.mkdir()
    torch.save(hf_clip_vision_state_dict(tower.state_dict(), cfg),
               hf / TORCH_FILE)
    assert cli(["encode", "--path", path] + flags) == 0
    assert cli(["eval", "--path", path, "--checkpoint", str(hf)]
               + flags) == 0
    tag = "_int8" if flags else ""
    emb = {}
    for kind in ("ft", "hf"):
        (npy,) = [f for f in os.listdir(os.path.join(path, "embeddings"))
                  if f.endswith(".npy") and f"_torch{tag}_{kind}" in f]
        emb[kind] = np.load(os.path.join(path, "embeddings", npy))
    assert emb["ft"].shape == (40, 64)
    assert np.array_equal(emb["ft"], emb["hf"])


# ---- multi-GPU on torch.distributed (patent_tpu_torch/parallel): the card
# box has one card, so a world is one NCCL rank, or two gloo ranks sharing
# the card (NCCL refuses two ranks on one device)

MG_SMALL = dict(n=50_000, d=512, poincare_d=128, queries=16, k=10, c=2.0)
MG_VISION = dict(image_size=32, patch_size=8, hidden_dim=64, num_layers=2,
                 num_heads=4, mlp_dim=128, projection_dim=32)
MG_KERNEL = {"cosine": "bucket_topk_bf16", "quantized": "bucket_topk_int8",
             "poincare": "bucket_topk_poincare",
             "sharded_topk_search_cosine_fast": "bucket_topk_bf16",
             "sharded_topk_search_quantized": "bucket_topk_int8",
             "sharded_topk_search_poincare_fast": "bucket_topk_poincare"}


def _searches_hold(out: dict) -> None:
    for mode, res in out.items():
        assert res["equal"], mode
        if mode in MG_KERNEL:
            assert all(r[MG_KERNEL[mode]] > 0 for r in res["launches"]), mode


def test_sharded_searches_on_one_nccl_rank_launch_the_kernels(cuda):
    """Every sharded search in a one-rank NCCL world equals the
    one-process index, and rows 3, 3′ and 4 launch."""
    from patent_tpu_torch.parallel.launch import run_world
    from torch_worlds import multi_gpu_world

    out = run_world(1, multi_gpu_world, "cuda",
                    {"searches": MG_SMALL, "direct": True}, device="cuda",
                    timeout=300)
    assert out["backend"] == "nccl"
    _searches_hold(out["searches"])


def test_two_gloo_ranks_on_one_card_search_and_finetune(cuda):
    """Two gloo ranks sharing the card: the sharded candidate paths over
    25k rows a rank equal the one-process index on every rank's kernels,
    and a sharded fine-tune step of a small tower (head_dim 16) equals one
    process at twice the batch (metrics within 2e-3), rows 12, 13, 15 and
    16 launching on both ranks."""
    from patent_tpu_torch.parallel.launch import run_world
    from torch_worlds import multi_gpu_world

    out = run_world(2, multi_gpu_world, "cuda",
                    {"searches": MG_SMALL, "finetune": 4,
                     "vision": MG_VISION}, backend="gloo", device="cuda",
                    timeout=300)
    assert out["backend"] == "gloo" and out["ranks"] == 2
    _searches_hold(out["searches"])
    ft = out["finetune"]
    for k, v in ft["single"].items():
        assert ft["sharded"][k] == pytest.approx(v, rel=2e-3), k
    assert all(n > 0 for r in ft["launches"] for n in r.values())


# ------------------------------------------- CUDA graphs of the loops
# The graphed loop (utils/graphs.py) replays what its capture recorded;
# every case below holds it to the eager loop in bits (the same kernels on
# the same inputs in the same order), and the controls show what a state
# that a replay cannot see would do.

class _Replays:
    """Counts ``StepGraph.replay`` calls (the graphed path was taken)."""

    def __init__(self, monkeypatch):
        from patent_tpu_torch.utils import graphs

        self.n = 0
        real = graphs.StepGraph.replay

        def replay(graph):
            self.n += 1
            real(graph)

        monkeypatch.setattr(graphs.StepGraph, "replay", replay)


def _hyp_run(td, tmp_path, name, epochs, graphed, resume=False, **kw):
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.utils.checkpoint import CheckpointManager
    from patent_tpu_torch.utils.config import HypTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), batch_size=32,
                         epochs=epochs, **kw)
    return th.train_hyperbolic_retrieval(
        td, cfg, logger=MetricsLogger(print_every=0),
        ckpt=CheckpointManager(str(tmp_path / name)), resume=resume,
        device="cuda", graphed=graphed)


def _same_run(got, want):
    best, hist = got
    best_w, hist_w = want
    assert hist["train_loss"] == hist_w["train_loss"]
    assert hist["val_loss"] == hist_w["val_loss"]
    for k in best_w:
        assert torch.equal(best[k], best_w[k]), k


def test_train_hyp_graphed_equals_eager_and_resumes_across(cuda, tmp_path,
                                                           monkeypatch):
    """Dropout on, three epochs: the graphed trainer (one replay a batch,
    the dropout generator registered with the graph) equals the eager one
    in bits, and a run resumed from the other kind's ``latest`` equals
    both."""
    td = _hyp_td(tmp_path)
    eager = _hyp_run(td, tmp_path, "eager", 3, graphed=False)
    replays = _Replays(monkeypatch)
    graphed = _hyp_run(td, tmp_path, "graphed", 3, graphed=None)
    assert replays.n > 0
    _same_run(graphed, eager)
    _hyp_run(td, tmp_path, "e2g", 2, graphed=False)
    _same_run(_hyp_run(td, tmp_path, "e2g", 3, graphed=True, resume=True),
              eager)
    _hyp_run(td, tmp_path, "g2e", 2, graphed=True)
    _same_run(_hyp_run(td, tmp_path, "g2e", 3, graphed=False, resume=True),
              eager)


def test_make_train_step_graphed_equals_eager(cuda, tmp_path):
    """JAX's per-batch steps: the graphed step (the batch copied into
    static buffers, dropout on) and the eval step with row 18 equal the
    eager ones in bits over four batches."""
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import HypTrainConfig

    td = _hyp_td(tmp_path)
    cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), batch_size=32)
    packed = th.PackedSupervision(td)
    arrays = th.stack_epoch_batches(packed, np.arange(len(packed.usable)),
                                    32, 2, np.random.default_rng(0))
    packed, widths = th.pack_epoch(arrays)
    batches = [th.unpack_fields(torch.from_numpy(p).to(cuda), widths)
               for p in packed[:4]]
    data = (torch.as_tensor(td.x_figures, device=cuda),
            torch.as_tensor(td.implication, device=cuda).long()
            .reshape(-1, 2),
            torch.zeros(0, 2, dtype=torch.long, device=cuda))
    out = {}
    for graphed in (False, True):
        model = th.build_model(td, cfg, cuda)
        opt = RiemannianAdam(dict(model.named_parameters()),
                             cfg.learning_rate, c=cfg.curvature)
        step, evaluate = th.make_train_step(model, opt, cfg, graphed=graphed)
        gen = torch.Generator(device=cuda).manual_seed(4)
        got = [torch.stack(list(step(b, *data, gen).values())).clone()
               for b in batches]
        got += [torch.stack(list(evaluate(b, *data).values())).clone()
                for b in batches]
        out[graphed] = (got, {k: v.clone() for k, v in
                              model.state_dict().items()})
    assert all(torch.equal(a, b) for a, b in zip(out[True][0], out[False][0]))
    assert all(torch.equal(out[True][1][k], out[False][1][k])
               for k in out[False][1])


def test_eval_epoch_graph_captures_row_18(cuda, tmp_path):
    """The validation epoch under no_grad runs the encoder's first layer
    on row 18: captured, it launches once a replay and gives the eager
    epoch's bits."""
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import HypTrainConfig

    td = _hyp_td(tmp_path)
    cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), batch_size=32)
    packed = th.PackedSupervision(td)
    arrays = th.stack_epoch_batches(packed, np.arange(len(packed.usable)),
                                    32, 2, np.random.default_rng(0))
    data = (torch.as_tensor(td.x_figures, device=cuda),
            torch.as_tensor(td.implication, device=cuda).long()
            .reshape(-1, 2),
            torch.zeros(0, 2, dtype=torch.long, device=cuda))
    out = {}
    for graphed in (False, True):
        model = th.build_model(td, cfg, cuda)
        opt = RiemannianAdam(dict(model.named_parameters()),
                             cfg.learning_rate, c=cfg.curvature)
        _train, evaluate = th.make_epoch_step(model, opt, cfg,
                                              graphed=graphed)
        runs = []
        for _ in range(3):        # warm-up, capture + replay, replay
            n18 = pk.mobius_dense_pallas.launches
            runs.append(torch.stack(list(evaluate(arrays, *data).values())))
            assert pk.mobius_dense_pallas.launches - n18 == len(arrays[0])
        assert all(torch.equal(r, runs[0]) for r in runs)
        out[graphed] = runs[0]
    assert torch.equal(out[True], out[False])


class _RebindingAdam:
    """Controls, Adam's arithmetic written out: ``update`` rebinds the
    moments to new tensors (as the optimizer did before its state moved in
    place), or takes the bias corrections of a Python count."""

    @staticmethod
    def make(kind, params, lr):
        from patent_tpu_torch.train.optim import Adam

        class Control(Adam):
            python_count = 0

            @torch.no_grad()
            def update(self, grads):
                if kind == "frozen_count":
                    self.python_count += 1
                    c32 = np.float32(self.python_count)
                    bc1 = float(np.float32(1) - np.float32(self.b1) ** c32)
                    bc2 = float(np.float32(1) - np.float32(self.b2) ** c32)
                    scale = -self.lr
                else:
                    self.count.add_(1)
                    bc1, bc2, scale = self._rates.index_select(
                        0, (self.count - self._first).view(1))[0]
                for n in self.names:
                    p, g = self.params[n], grads[n]
                    mu = (1 - self.b1) * g + self.b1 * self.mu[n]
                    nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[n]
                    u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                    if kind == "frozen_count":
                        self.mu[n].copy_(mu)
                        self.nu[n].copy_(nu)
                    else:
                        self.mu[n], self.nu[n] = mu, nu
                    p.add_(scale * u)

        return Control(params, lr)


def _optimizer_loop(dev, make_opt, graphed, steps=3):
    from patent_tpu_torch.utils.graphs import ScanLoop

    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.nn.Parameter(torch.randn(8, 4, generator=g, device=dev))
    x = torch.randn(steps, 16, 8, generator=g, device=dev)
    opt = make_opt({"w": w})

    def step(i):
        w.grad = None
        loss = torch.tanh(x.index_select(0, i.view(1))[0] @ w).square().sum()
        loss.backward()
        opt.update({"w": w.grad})
        return torch.cat([loss.detach().view(1), w.detach().flatten()])

    return ScanLoop(step, dev, graphed).run_updates(opt, steps, 33).clone()


@pytest.mark.parametrize("kind", ["rebinding_moments", "frozen_count"])
def test_graph_controls_differ_from_eager_by_the_second_replay(cuda, kind):
    """Step 1 is the eager warm-up, step 2 the first replay, step 3 the
    second: the graph-safe optimizer equals eager at every step; a control
    equals eager through the first replay (it reads what the capture saw)
    and differs by the second."""
    from patent_tpu_torch.train.optim import Adam

    good = {g: _optimizer_loop(cuda, lambda p: Adam(p, 1e-2), g)
            for g in (False, True)}
    assert torch.equal(good[True], good[False])
    ctrl = {g: _optimizer_loop(cuda, lambda p: _RebindingAdam.make(
        kind, p, 1e-2), g) for g in (False, True)}
    if kind == "rebinding_moments":     # eager: the same arithmetic
        assert torch.equal(ctrl[False], good[False])
    assert torch.equal(ctrl[True][:2], ctrl[False][:2])
    assert not torch.equal(ctrl[True][2], ctrl[False][2])


def test_hyperbolic_con_hmi_gcn_vgae_graphed_equal_eager(cuda, tmp_path,
                                                         monkeypatch):
    """train_hyp_con, train_hmi, train_pair_classification (the sparse
    path's segment sums captured) and train_vgae (dense and sampled, the
    negatives' generator registered): graphed equals eager in bits."""
    import scipy.sparse as sp

    from patent_tpu_torch.data import hmi_inputs, synthetic
    from patent_tpu_torch.data.graph_build import build_hetero_graph
    from patent_tpu_torch.train import (train_gcn, train_hmi, train_hyp_con,
                                        train_vgae)
    from patent_tpu_torch.utils.config import (GCNTrainConfig,
                                               HypConTrainConfig)
    from patent_tpu_torch.utils.logging import MetricsLogger

    quiet = MetricsLogger(print_every=0)
    td = _hyp_td(tmp_path)
    recs = synthetic.synthetic_records(num_patents=10, figures_per_patent=3,
                                       seed=0)
    graph = build_hetero_graph(recs)
    inputs = hmi_inputs.generate_hmi_inputs(graph, seed=1)
    feats = np.random.default_rng(2).standard_normal(
        (graph.counts["figures"], 24)).astype(np.float32)
    rng = np.random.default_rng(3)
    a = sp.random(600, 600, density=0.01, random_state=rng, format="csr",
                  dtype=np.float32)
    a.data[:] = 1.0
    adj = sp.csr_matrix(((a + a.T) > 0).astype(np.float32))
    x = rng.standard_normal((600, 16)).astype(np.float32)
    pairs = rng.integers(0, 600, (700, 2)).astype(np.int32)
    labels = rng.integers(0, 5, 700).astype(np.int32)

    runs = {
        "train_hyp_con": lambda g: train_hyp_con.train_hyperbolic_contrastive(
            td, HypConTrainConfig(embed_dim=8, hidden_dims=(16,), epochs=2,
                                  batch_size=16), logger=quiet,
            device="cuda", graphed=g),
        "train_hmi": lambda g: train_hmi.train_hmi(
            feats, inputs, graph.num_nodes - graph.counts["figures"],
            embed_dim=8, epochs=3, batch_size=64, logger=quiet,
            device="cuda", graphed=g),
        "train_gcn": lambda g: train_gcn.train_pair_classification(
            x, adj, pairs, labels, GCNTrainConfig(
                hidden_dim=32, latent_dim=16, num_layers=4, epochs=2,
                batch_size=128, adjacency="sparse"), logger=quiet,
            device="cuda", graphed=g),
        "vgae_dense": lambda g: train_vgae.train_vgae_link_prediction(
            x, adj, hidden_dim=16, latent_dim=8, epochs=7, mode="dense",
            logger=quiet, device="cuda", graphed=g),
        "vgae_sampled": lambda g: train_vgae.train_vgae_link_prediction(
            x, adj, hidden_dim=16, latent_dim=8, epochs=7, mode="sampled",
            logger=quiet, device="cuda", graphed=g),
    }
    replays = _Replays(monkeypatch)
    for name, run in runs.items():
        eager = run(False)
        before = replays.n
        graphed = run(None)
        assert replays.n > before, name
        for e, gr in zip(eager, graphed):
            if isinstance(e, dict) and e and all(
                    isinstance(v, torch.Tensor) for v in e.values()):
                for k in e:
                    assert torch.equal(e[k], gr[k]), (name, k)
            elif not hasattr(e, "test_edges"):
                assert e == gr, name


def test_epoch_loop_with_fresh_inputs_each_epoch_equals_eager(cuda,
                                                              monkeypatch):
    """A fresh dropout generator and a fresh feature table (another shape,
    its predecessor freed first, so the allocator may hand out its
    address) each epoch: the graph is captured again for each, draws from
    the new generator, and equals the eager loop in bits."""
    from patent_tpu_torch.models.hyperbolic import FigureOnlyHyperbolicModel
    from patent_tpu_torch.train import optim, train_hyp_con
    from patent_tpu_torch.utils.config import HypConTrainConfig

    cfg = HypConTrainConfig(embed_dim=8, hidden_dims=(16,), batch_size=16)
    feats = np.random.default_rng(4).standard_normal(
        (80, 24)).astype(np.float32)
    mats = np.random.default_rng(5).integers(0, 64, (3, 2, 4, 16))
    replays = _Replays(monkeypatch)
    out = {}
    for graphed in (False, None):
        model = FigureOnlyHyperbolicModel(
            feature_dim=24, embed_dim=8, hidden_dims=(16,), c=1.0,
            generator=torch.Generator().manual_seed(0)).to(cuda)
        opt = optim.Adam(dict(model.named_parameters()), 1e-3)
        train, _eval = train_hyp_con.make_epoch_step(model, opt, cfg,
                                                     graphed)
        losses = []
        for e, (a_mat, p_mat) in enumerate(mats):
            x = torch.as_tensor(feats[:64 + 8 * e], device=cuda)
            gen = torch.Generator(device=cuda).manual_seed(30 + e)
            losses.append(train(a_mat, p_mat, x, gen).clone())
            del x, gen
        out[graphed] = (torch.stack(losses),
                        {k: v.clone() for k, v in model.state_dict().items()})
    assert replays.n > 0
    assert torch.equal(out[None][0], out[False][0])
    assert all(torch.equal(out[None][1][k], out[False][1][k])
               for k in out[False][1])


def _scan_tower(dev, cls, seed=21):
    cfg = VisionConfig(image_size=64, patch_size=8, hidden_dim=D,
                       num_layers=3, num_heads=HEADS, mlp_dim=F,
                       projection_dim=64)
    gen = torch.Generator().manual_seed(seed)
    tower = VisionTransformer(cfg, generator=gen)
    with torch.no_grad():
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    tower = tower.to(dev)
    return tower if cls is VisionTransformer else Int8VisionTransformer.\
        from_float(tower)


@pytest.mark.parametrize("kind,b", [("bf16", 4), ("int8", 4), ("int8", 3),
                                    ("int8", 6)],
                         ids=["bf16_rows1-2", "int8_rows5+7",
                              "int8_row8_coop", "int8_row8_chain"])
def test_scan_encoder_graph_equals_eager(cuda, kind, b):
    """k = 3 stacked batches through one captured graph of the tower calls
    (rows 1-2; rows 5 + 7; row 8's cooperative launch at B 3 and its
    chain at B 6) equal the eager calls in bits, the folded-u8 tower too,
    and each replay counts its kernels' launches."""
    from patent_tpu_torch.retrieval.engine import make_scan_encoder

    tower = _scan_tower(cuda, VisionTransformer if kind == "bf16"
                        else Int8VisionTransformer)
    px = np.random.default_rng(b).integers(0, 256, (3, b, 64, 64, 3),
                                           dtype=np.uint8)
    fns = ([bf16_layer.fused_layer_block_bf16] if kind == "bf16" else
           [qm.quant_attention_block] if b % 4 == 0 else
           [qm.quant_layer_block])
    for fold in (False, True):
        eager = make_scan_encoder(tower, fold_u8=fold, graphed=False)(px)
        scan = make_scan_encoder(tower, fold_u8=fold)
        for call in range(3):             # warm-up, capture, replay
            before = [f.launches for f in fns]
            got = scan(px)
            assert np.array_equal(got, eager), (fold, call)
            assert all(f.launches - n == 3 * 2 for f, n in zip(fns, before))


# ---- the attention tile at the JAX kernels' contract (csrc/flash_tile.cuh):
# head widths that are multiples of 8 up to 128, on instances every 16 (a
# real width runs on the next one up, its extra columns zero), and any S
# (past the tile's ring, K and V stream through shared memory in key
# blocks).  The tolerances are those at head width 64 above: the same bf16
# q, p and f32 sums in another order.

# (real head width, heads): the instances added beside 16, 32 and 64, the
# padded widths 72 (ViT-B's 64 + 8) and 88 (ViT-g/14's), and 64, which at
# S 577 streams its keys
TILE_CASES = [(48, 4), (64, 4), (72, 2), (80, 4), (88, 2), (96, 2), (112, 2),
              (128, 2)]
TILE_IDS = [f"hd{hd}" for hd, _h in TILE_CASES]


@pytest.mark.parametrize("hd,heads", TILE_CASES, ids=TILE_IDS)
@pytest.mark.parametrize("b", [3, 32])
@pytest.mark.parametrize("s", [257, 577])
def test_tile_widths_match_plain_on_the_full_query_axis(cuda, s, b, hd,
                                                        heads):
    """Row 14 (the tile on every query row) at each new instance and at
    the padded widths, with 257 and 577 keys (past the ring at every
    width from 64 up), against its plain version at the real width."""
    q, k, v = _flash_case(cuda, b, s, heads=heads, hd=hd)
    got = fa.flash_attention(q, k, v)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert torch.equal(got, packed)
    assert _rel_err(got, want) <= FLASH_REL_TOL
    for name, ctrl in (
            ("q unscaled", fa.flash_attention_plain(q, k, v, scale=False)),
            ("pad keys counted", fa.flash_attention_plain(
                q, k, v, pad_keys_to=-(-s // 16) * 16))):
        assert _rel_err(ctrl, want) > FLASH_REL_TOL, name


def _int8_weights(dev, d, f, seed):
    """_int8_case's attention and MLP parameters at width d, MLP f."""
    g = torch.Generator(device=dev).manual_seed(seed + 100)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def m(rows, cols):
        q, scale = qm.quantize_weight(r(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    wqkv, sqkv = m(d, 3 * d)
    wout, sout = m(d, d)
    w1, s1 = m(d, f)
    w2, s2 = m(f, d)
    return ((1 + r(d, std=0.1), r(d, std=0.1), wqkv, sqkv,
             r(3 * d, std=0.2), wout, sout, r(d, std=0.02)),
            (1 + r(d, std=0.1), r(d, std=0.1), w1, s1, r(f, std=0.02), w2,
             s2, r(d, std=0.02)))


@FORMS
@pytest.mark.parametrize("hd,heads", TILE_CASES, ids=TILE_IDS)
@pytest.mark.parametrize("b", [3, 32])
def test_tile_widths_in_the_layers_match_plain(cuda, b, hd, heads, fast):
    """Rows 1 and 2 (bf16 out; group 1, so B 3 runs them too) and rows 5
    and 6 (f32 out) at each new instance, with a full query axis and with
    n_q 1 (the CLS rows), at 272 rows (ViT-H/14's 257 tokens) and, at
    head width 64, 592 (ViT-L/14 @336's 577)."""
    s = 592 if hd == 64 else 272
    valid = s - 15
    d = hd * heads
    x, p = _layer_case(cuda, b=b, s=s, d=d, f=2 * d, valid=valid)
    attn, _mlp = _int8_weights(cuda, d, 2 * d, hd)
    for name, fn, plain, args, kw, tol in (
            ("row 1", bf16_layer.fused_layer_block_bf16,
             bf16_layer.fused_layer_block_bf16_plain, p, dict(group=1),
             REL_TOL),
            ("row 2", bf16_layer.fused_layer_cls_bf16,
             bf16_layer.fused_layer_cls_bf16_plain, p, dict(group=1),
             REL_TOL),
            ("row 5", qm.quant_attention_block,
             qm.quant_attention_block_plain, attn, dict(fast=fast),
             INT8_REL_TOL),
            ("row 6", qm.quant_attention_cls, qm.quant_attention_cls_plain,
             attn, dict(fast=fast), INT8_REL_TOL)):
        got = fn(x, *args, heads, valid_len=valid, **kw)
        want = plain(x, *args, heads, valid_len=valid, **kw)
        if got.dim() == 3:
            got, want = got[:, :valid], want[:, :valid]
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), name
        assert _rel_err(got, want) <= tol, name
        assert _min_cosine(got, want) > 0.9999, name


# Row 8 at ViT-L/14 and ViT-H/14 widths against its plain version: the
# whole layer's int8 codes flip as at ViT-B/16 (INT8_LAYER_REL_TOL above),
# more of them at D 1,024 with F 4,096: measured 1.51e-3 at B 3 there on
# the H100.  The no-key-mask and rows 5 + 7 controls must fail the gate.
INT8_LAYER_WIDE_REL_TOL = 3e-3


@pytest.mark.parametrize("hd,heads,s", [(64, 16, 592), (80, 16, 272),
                                        (72, 4, 272), (128, 2, 592)],
                         ids=["L14-336", "H14", "hd72", "hd128"])
@pytest.mark.parametrize("b", [1, 3])
@FORMS
def test_int8_layer_cooperative_launch_at_the_new_widths(cuda, b, hd, heads,
                                                         s, fast,
                                                         monkeypatch):
    """Row 8's cooperative launch runs the tile on its GEMM ring at every
    new width (K and V streamed past the tile's ring): forced at B 1 and
    3, it equals the chain in bits, and the chain its plain version."""
    d = hd * heads
    valid = s - 15
    x, _p = _layer_case(cuda, b=b, s=s, d=d, f=4 * d, valid=valid)
    attn, mlp = _int8_weights(cuda, d, 4 * d, hd)
    outs = {}
    for coop in (True, False):
        monkeypatch.setattr(qm, "layer_plan", lambda m, d_, f, g, c=coop: (
            qm.LayerPlan(True, 1, 2) if c else qm.LayerPlan(False, 1, 1)))
        outs[coop] = qm.quant_layer_block(x, *attn, *mlp, heads,
                                          valid_len=valid, fast=fast)
    want = qm.quant_layer_block_plain(x, *attn, *mlp, heads,
                                      valid_len=valid, fast=fast)
    torch.cuda.synchronize()
    assert torch.equal(outs[True], outs[False])
    assert _rel_err(outs[True][:, :valid], want[:, :valid]) <= \
        INT8_LAYER_WIDE_REL_TOL
    assert _min_cosine(outs[True][:, :valid], want[:, :valid]) > 0.9999
    controls = {
        "no key mask": qm.quant_layer_block_plain(x, *attn, *mlp, heads,
                                                  valid_len=s, fast=fast),
        "bf16 mid residual": qm.quant_mlp_block_plain(
            qm.quant_attention_block_plain(x, *attn, heads, valid_len=valid,
                                           fast=fast),
            *mlp, fast=fast)}
    for name, ctrl in controls.items():
        assert _rel_err(ctrl[:, :valid], want[:, :valid]) > \
            INT8_LAYER_WIDE_REL_TOL, name


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_tile_past_the_old_limit_equals_the_resident_tile_in_bits(cuda,
                                                                  kind):
    """At head width 64 the tile holds 208 keys resident and streams 592
    in key blocks.  With 197 valid keys the layer's valid rows at 592 rows
    equal those at 208 in bits (pad keys add exact zeros, every other
    step runs in the same order; the GEMMs and LayerNorms are per row);
    counting one more key (valid 198) must differ."""
    d, heads, b = 768, 12, 2
    x, p = _layer_case(cuda, b=b, s=592, d=d, f=2 * d, valid=197)
    attn, _mlp = _int8_weights(cuda, d, 2 * d, 7)
    if kind == "bf16":
        def run(t, valid):
            return bf16_layer.fused_layer_block_bf16(t, *p, heads,
                                                     valid_len=valid)
    else:
        def run(t, valid):
            return qm.quant_attention_block(t, *attn, heads, valid_len=valid)
    short = run(x[:, :208].contiguous(), 197)[:, :197]
    long = run(x, 197)[:, :197]
    control = run(x, 198)[:, :197]
    torch.cuda.synchronize()
    assert torch.equal(long, short)
    assert not torch.equal(control, short)


@pytest.mark.parametrize("hd,heads,s", [(80, 4, 257), (64, 4, 577)],
                         ids=["hd80", "s577"])
def test_row_12_takes_the_tile_contract_only_without_autograd(cuda, hd,
                                                              heads, s):
    """Row 12's forward runs the tile, so with nothing recorded it takes
    head_dim 80 and S past 448 (against its plain version); rows 13 and
    14′ now take the same contract, so while autograd records the block
    runs rows 12 and 13 there too (gradients against ``kernels=False``),
    and row 14's f32 kernel takes those shapes; head_dim 4 still
    raises before any launch."""
    d = hd * heads
    x, p = _layer_case(cuda, b=2, s=s, d=d, f=d, valid=s)
    args = (x, p[2], p[3].to(torch.bfloat16), p[4],
            p[5].to(torch.bfloat16))
    with torch.no_grad():
        got = fa.fused_attention_block(*args, heads)
        want = fa.fused_attention_block(*args, heads, kernels=False)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= REL_TOL
    g = torch.Generator(device=cuda).manual_seed(hd)
    cot = torch.randn(x.shape, generator=g, device=cuda)
    grads = []
    n0 = fa.fused_attention_bwd.launches
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in args]
        out = fa.fused_attention_block(*leaves, heads, kernels=kernels)
        (out.float() * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    assert fa.fused_attention_bwd.launches == n0 + 1
    for name, gk, gp in zip(("x", "wqkv", "bqkv", "wout", "bout"), *grads):
        assert _rel_err(gk, gp) <= TRAIN_BWD_REL_TOL, name
    leaves = [t.clone().requires_grad_(True) for t in args]
    n0 = fa.fused_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa.fused_attention_block(*leaves, d // 4)
    assert fa.fused_attention_fwd.launches == n0
    q = x.float().unflatten(-1, (heads, hd))
    assert _rel_err(fa.flash_attention(q, q, q),
                    fa.flash_attention_plain(q, q, q)) <= 1e-5


# Row 13 at every instance width of the attention kernels' contract, on
# the path each shape takes (ptt_fab_bwd_plan): (B, S, D, heads, valid,
# path).  Head widths 8 to 64 at S 208 (197 valid keys) run on the
# resident kernel, and at the first padded S past its whole-sequence
# block (1,776 rows at 8 and 16, 896 at 32, 528 at 48, 464 at 64) on the
# streamed pair; 72 to 128 stream at every S; 8, 72, 88 and 120 run on
# the 16, 80, 96 and 128 instances with their last 8 columns zero; CLIP
# ViT-L/14 @336's 592 rows of 16 x 64 heads and ViT-H/14's widths
# stream.  The gate is TRAIN_BWD_REL_TOL, measured on the H100 at 0 to
# 5.9e-5 over these shapes; every control below moves the plain backward
# by far more.
BWD_FIRST_STREAMED_S = {8: 1776, 16: 1776, 32: 896, 48: 528, 64: 464}
BWD_WIDTH_CASES = {
    **{f"hd{hd}": (3, 208, 2 * hd, 2, 197,
                   "resident" if hd <= 64 else "streamed")
       for hd in (8, 16, 32, 48, 64, 72, 80, 88, 96, 112, 120, 128)},
    **{f"hd{hd}-s{s}": (2, s, 2 * hd, 2, s - 6, "streamed")
       for hd, s in BWD_FIRST_STREAMED_S.items()},
    "vit-l14-336": (2, 592, 1024, 16, 577, "streamed"),
    "vit-h14-widths": (2, 272, 1280, 16, 257, "streamed")}


def _bwd_path(hd, s):
    """The path row 13 names for this shape, read from the library."""
    return "streamed" if fa.attention_bwd_plan(s, hd)[0] else "resident"


@pytest.mark.parametrize("case", sorted(BWD_WIDTH_CASES))
def test_attention_backward_at_every_width_matches_plain(cuda, case):
    """Row 13 against ``attention_bwd_plain`` at every instance width and on
    the path its shape takes (the launch counted under that path), with
    controls that must fail the same gate: no key mask, bqkv = 0, the keys
    of the last key block dropped (the streamed ring's last, partial
    stage, or its last 16-key step where the keys are one stage; the
    resident path's last 16-key step), and at widths below their
    instance's the zero columns treated as real.  Two runs give the same
    bits."""
    b, s, d, heads, valid, path = BWD_WIDTH_CASES[case]
    hd = d // heads
    assert _bwd_path(hd, s) == path
    x, wqkv, bqkv, _wo, _bo, da = _attn_case(cuda, b, s, d, heads, valid)
    key = f"hd{-(-hd // 16) * 16}" + ("_streamed" if path == "streamed"
                                      else "")
    n0 = fa.fused_attention_bwd.instances.get(key, 0)
    got = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    again = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    want = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, valid)
    torch.cuda.synchronize()
    assert fa.fused_attention_bwd.instances[key] == n0 + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    v = slice(0, valid)
    assert not got[0][:, valid:].any()       # pad queries and pad keys
    assert _rel_err(got[1][:, v], want[1][:, v]) <= REL_TOL
    assert _rel_err(got[0][:, v], want[0][:, v]) <= TRAIN_BWD_REL_TOL
    block = fa.attention_bwd_plan(s, hd)[1] if path == "streamed" else 16
    last = (valid - 1) // block * block or (valid - 1) // 16 * 16
    assert 0 < last < valid
    controls = {
        "no key mask": fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, s),
        "bqkv=0": fa.attention_bwd_plain(x, wqkv, torch.zeros_like(bqkv), da,
                                         heads, valid),
        "last key block dropped": fa.attention_bwd_plain(x, wqkv, bqkv, da,
                                                         heads, last)}
    if hd % 16:
        controls["zero columns as real"] = fa.attention_bwd_plain(
            x, wqkv, bqkv, da, heads, valid, read_width=hd + 8)
    for name, ctrl in controls.items():
        assert _rel_err(ctrl[0][:, v], want[0][:, v]) > TRAIN_BWD_REL_TOL, \
            name


@pytest.mark.parametrize("s,hd,streamed", [
    (208, 64, False),     # ViT-B/16 @224: 107 KB, two blocks an SM
    (448, 64, False),     # the resident block's last S at 64
    (464, 64, True),
    (592, 64, True),      # CLIP ViT-L/14 @336
    (272, 80, True),      # ViT-H/14's widths: no resident instance past 64
    (272, 72, True),      # on the 80 instance
    (1760, 8, False),     # on the 16 instance: its last resident S
    (512, 48, False),     # 48's rows take one chunk more (56 elements)
    (528, 48, True),
    (80, 16, False),      # the CLIs' small tower
], ids=["vit-b16", "s448", "s464", "vit-l14-336", "vit-h14", "hd72",
        "hd8-s1760", "hd48-s512", "hd48-s528", "small-tower"])
def test_attention_backward_takes_the_resident_path_where_it_fits(cuda, s,
                                                                  hd,
                                                                  streamed):
    """Row 13 keeps one (head, image)'s whole sequence in a block's shared
    memory (q, dn, K and V at the tile's row stride, and dden) at head
    widths up to 64 where it fits the 232,448 bytes a block may use, and
    streams past either (the library's plan)."""
    assert fa.attention_bwd_plan(s, hd)[0] is streamed


@pytest.mark.parametrize("hd,heads,s,valid,path", [
    (80, 4, 272, 257, "streamed"), (72, 4, 208, 197, "streamed"),
    (64, 4, 208, 197, "resident"), (32, 4, 896, 890, "streamed"),
    (64, 16, 592, 577, "streamed")],
    ids=["hd80-streamed", "hd72-streamed", "hd64-resident", "hd32-streamed",
         "vit-l14-336-streamed"])
def test_attention_backward_gates_the_clamp_at_every_width(cuda, hd, heads,
                                                          s, valid, path):
    """Head 0's q columns scaled 40x, so that a share of its scores passes
    +80: row 13 on the path its shape takes (both are among the cases)
    agrees with the gated plain backward, and
    the plain backward without the gate fails the same gate."""
    d = hd * heads
    x, p = _layer_case(cuda, b=2, s=s, d=d, f=8, valid=valid)
    wqkv, bqkv = _fold(p[2], p[3], gain=40.0, d=d, heads=heads)
    g = torch.Generator(device=cuda).manual_seed(hd)
    da = torch.randn(x.shape, generator=g, device=cuda)
    da[:, valid:] = 0.0
    da = da.to(torch.bfloat16)
    gain = torch.ones(3 * d, device=cuda)
    gain[:hd] = 40.0
    sat = fa.attention_saturation(x[:, :valid].float(), p[2].float() * gain,
                                  p[3] * gain, heads)
    assert float(sat) > fa.SCORE_CLAMP_HI
    assert _bwd_path(hd, s) == path
    got = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    want = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, valid)
    ungated = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, valid,
                                     gate=False)
    torch.cuda.synchronize()
    v = slice(0, valid)
    assert torch.isfinite(got[0].float()).all()
    assert _rel_err(got[0][:, v], want[0][:, v]) <= TRAIN_BWD_REL_TOL
    assert _rel_err(ungated[0][:, v], want[0][:, v]) > TRAIN_BWD_REL_TOL


# ---- the streamed paths' TMA rings: the tile past its ring
# (csrc/flash_tile.cuh's stream_kernel: passes of 128 query rows up to
# head width 80, 64 past it, over stages of 64 keys) and row 13's streamed
# pair (csrc/fused_attention.cu: passes of 128 query rows, blocks of 128
# keys, stages of 64 keys or query rows), at the rings' edges: a partial
# last stage, valid_len inside it, query rows that are not a multiple of a
# pass, and head x image counts that are not a multiple of anything the
# grid groups.

# (B, S, heads, hd): S past the tile's ring at each instance
TILE_EDGE_CASES = {
    "hd64-s577-b3h3": (3, 577, 3, 64),
    "hd80-s257-b5h1": (5, 257, 1, 80),
    "hd72-s1000-b1h3": (1, 1000, 3, 72),
    "hd48-s290-b3h5": (3, 290, 5, 48),
    "hd128-s200-b3h3": (3, 200, 3, 128),
    "hd96-s129-b7h1": (7, 129, 1, 96),
    "hd112-s161-b2h3": (2, 161, 3, 112),
    "hd32-s465-b3h3": (3, 465, 3, 32),
    "hd16-s913-b3h3": (3, 913, 3, 16)}


@pytest.mark.parametrize("case", sorted(TILE_EDGE_CASES))
def test_streamed_tile_at_the_ring_edges_matches_plain_twice(cuda, case):
    """Row 14 (the tile on every query row) where its keys stream, at the
    ring's edges: against its plain version, two runs equal in bits, the
    same bits on packed copies of q, k, v, and the plain version that
    counts the pad keys failing the same gate."""
    b, s, heads, hd = TILE_EDGE_CASES[case]
    q, k, v = _flash_case(cuda, b, s, heads=heads, hd=hd, seed=s)
    got = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    want = fa.flash_attention_plain(q, k, v)
    counted = fa.flash_attention_plain(q, k, v, pad_keys_to=-(-s // 16) * 16)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again) and torch.equal(got, packed)
    assert _rel_err(got, want) <= FLASH_REL_TOL
    assert _rel_err(counted, want) > FLASH_REL_TOL


@pytest.mark.parametrize("hd,heads,s", [(64, 3, 577), (72, 3, 257),
                                        (88, 2, 257)],
                         ids=["hd64", "hd72", "hd88"])
def test_streamed_tile_reads_no_pad_row_and_no_column_past_its_head(cuda, hd,
                                                                    heads, s):
    """q, k, v slices of a store whose rows past S (the pad rows up to the
    next multiple of 16) and whose 16 columns past the last head are NaN:
    the tile's copies read neither (a row's extent is S, a head's hd), so
    its output is finite and equal in bits to that on packed copies.  As
    controls, the plain version that reads the store's pad rows, and at
    72 and 88 one that reads each head's 8 columns past hd (the next
    head's, and past the last head the NaN ones), turn non-finite."""
    b, sp = 2, -(-s // 16) * 16
    width = heads * hd + 16
    g = torch.Generator(device=cuda).manual_seed(hd)
    store = torch.randn(b, sp, 3, width, generator=g, device=cuda).to(
        torch.bfloat16)
    store[:, s:] = float("nan")
    store[..., heads * hd:] = float("nan")
    q, k, v = (store[:, :s, i, :heads * hd].unflatten(-1, (heads, hd))
               for i in range(3))
    got = fa.flash_attention(q, k, v)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    want = fa.flash_attention_plain(q, k, v)
    kp, vp = (store[:, :, i, :heads * hd].unflatten(-1, (heads, hd))
              for i in (1, 2))
    controls = {"pad rows read": fa.flash_attention_plain(q, kp, vp)}
    if hd % 16:
        st = (sp * 3 * width, 3 * width, hd, 1)
        kw, vw = (torch.as_strided(store[:, :, i], (b, s, heads, hd + 8), st)
                  for i in (1, 2))
        controls["next columns read"] = fa.flash_attention_plain(
            torch.nn.functional.pad(q, (0, 8)), kw, vw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, packed)
    assert _rel_err(got, want) <= FLASH_REL_TOL
    for name, ctrl in controls.items():
        assert not torch.isfinite(ctrl.float()).all(), name


# (B, S, D, heads, valid): row 13 on its streamed pair at the rings' edges
BWD_EDGE_CASES = {
    "hd64-s592-b3h3": (3, 592, 192, 3, 577),
    "hd80-s272-b1h5": (1, 272, 400, 5, 257),
    "hd72-s208-b3h3": (3, 208, 216, 3, 200),
    "hd128-s336-b3h1": (3, 336, 128, 1, 321),
    "hd96-s144-b5h1": (5, 144, 96, 1, 137),
    "hd32-s912-b1h3": (1, 912, 96, 3, 900),
    "hd48-s528-b3h1": (3, 528, 48, 1, 515)}


@pytest.mark.parametrize("case", sorted(BWD_EDGE_CASES))
def test_streamed_attention_backward_at_the_ring_edges(cuda, case):
    """Row 13's streamed pair at the rings' edges against
    ``attention_bwd_plain``, two runs equal in bits, the pad rows of dqkv
    0, and the plain backward without the key mask failing the gate."""
    b, s, d, heads, valid = BWD_EDGE_CASES[case]
    hd = d // heads
    assert _bwd_path(hd, s) == "streamed"
    x, wqkv, bqkv, _wo, _bo, da = _attn_case(cuda, b, s, d, heads, valid)
    got = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    again = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    want = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, valid)
    no_mask = fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, s)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    v = slice(0, valid)
    assert not got[0][:, valid:].any()
    assert _rel_err(got[1][:, v], want[1][:, v]) <= REL_TOL
    assert _rel_err(got[0][:, v], want[0][:, v]) <= TRAIN_BWD_REL_TOL
    assert _rel_err(no_mask[0][:, v], want[0][:, v]) > TRAIN_BWD_REL_TOL
