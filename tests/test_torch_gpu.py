"""The CUDA kernels of patent_tpu_torch against their plain PyTorch
versions, on the card.  Every test here is marked ``gpu`` and skips when
``torch.cuda.is_available()`` is false; run them on a CUDA machine with

    python -m pytest tests/test_torch_gpu.py -q -m gpu

This file imports no JAX module of its own, so it runs where only PyTorch
is installed.  ``chip_smoke.py`` repeats the checks at ViT-B/16 shapes.
"""

import pytest
import torch

from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
from patent_tpu_torch.ops import bf16_layer, topk_kernel
from patent_tpu_torch.ops import quant_matmul as qm
from patent_tpu_torch.retrieval.cli_actions import select_device
from patent_tpu_torch.retrieval.index import EmbeddingIndex

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


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return select_device("cuda")


def _layer_case(dev, b=3, seed=0):
    """Matrices bf16, LayerNorm vectors and biases f32 (what the kernel
    takes); pad rows of random content, not a constant, which LN1 would
    turn into exactly ln1_bias."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=dev)

    def m(*shape):
        return r(*shape, std=shape[0] ** -0.5).to(torch.bfloat16)

    params = (1 + r(D, std=0.1), r(D, std=0.1), m(D, 3 * D),
              r(3 * D, std=0.2), m(D, D), r(D, std=0.02),
              1 + r(D, std=0.1), r(D, std=0.1), m(D, F),
              r(F, std=0.02), m(F, D), r(D, std=0.02))
    x = r(b, S, D, std=1.0)
    x[:, VALID:] = 3.0 * x[:, VALID:] + 1.0
    return x.to(torch.bfloat16), params


def _min_cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(0, -2), b.float().flatten(0, -2), dim=-1).min())


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().mean() / b.abs().mean())


@pytest.mark.parametrize("name", ["fused_layer_block_bf16",
                                  "fused_layer_cls_bf16"])
def test_layer_kernel_matches_plain_and_controls_do_not(cuda, name):
    kernel = getattr(bf16_layer, name)
    plain = getattr(bf16_layer, name + "_plain")
    x, p = _layer_case(cuda)

    def rows(t):                     # the valid rows (CLS: [B, D] already)
        return t[:, :VALID] if t.dim() == 3 else t

    n0 = kernel.launches
    got = rows(kernel(x, *p, HEADS, valid_len=VALID))
    want = rows(plain(x, *p, HEADS, valid_len=VALID))
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, want) <= REL_TOL
    assert _min_cosine(got, want) > 0.9999
    assert _rel_err(rows(plain(x, *p, HEADS, valid_len=S)), want) > REL_TOL
    for i in BIASES:
        q = list(p)
        q[i] = torch.zeros_like(q[i])
        assert _rel_err(rows(plain(x, *q, HEADS, valid_len=VALID)),
                        want) > REL_TOL, i


def test_cls_kernel_is_row_0_of_the_layer_kernel(cuda):
    x, p = _layer_case(cuda)
    got = bf16_layer.fused_layer_block_bf16(x, *p, HEADS, valid_len=VALID)
    cls = bf16_layer.fused_layer_cls_bf16(x, *p, HEADS, valid_len=VALID)
    torch.cuda.synchronize()
    assert cls.shape == (x.shape[0], D)
    # the CLS kernel repeats row 0's operations of the full kernel in the
    # same order, so it equals row 0 bit for bit
    assert torch.equal(cls, got[:, 0])


def test_layer_kernel_rejects_what_it_does_not_take(cuda):
    x, p = _layer_case(cuda)
    with pytest.raises(ValueError):
        bf16_layer.fused_layer_block_bf16(x.float(), *p, HEADS, valid_len=VALID)
    with pytest.raises(ValueError):      # head_dim 32
        bf16_layer.fused_layer_block_bf16(x, *p, 4, valid_len=VALID)
    with pytest.raises(ValueError):      # token axis not padded to 16
        bf16_layer.fused_layer_block_bf16(x[:, :40].contiguous(), *p, HEADS,
                                          valid_len=VALID)
    with pytest.raises(ValueError):      # f32 matrices: the kernel casts none
        bf16_layer.fused_layer_block_bf16(
            x, *[t.float() for t in p], HEADS, valid_len=VALID)


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


def test_tower_kernels_match_plain_layers(cuda):
    """Three layers compound the per-layer rounding flips: features within
    4e-3 relative error (8e-4 or less measured on the H100)."""
    cfg = VisionConfig(image_size=32, patch_size=8, hidden_dim=D,
                       num_layers=3, num_heads=HEADS, mlp_dim=F,
                       projection_dim=32)
    gen = torch.Generator().manual_seed(3)
    tower = VisionTransformer(cfg, generator=gen)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    tower = tower.to(cuda).eval()
    px = torch.randn(5, 32, 32, 3, device=cuda)
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert got.shape == (5, 32)
    assert _rel_err(got, want) <= 4e-3
    assert _min_cosine(got, want) > 0.9999


# int8 sub-layers: the integer products are exact, so the kernel and the
# plain version differ only where a LayerNorm or f32 dot summed in another
# order flips an int8 code (chip_smoke.py's gate, set ~4x above the
# floor measured there at ViT-B/16 widths); dropping the key mask, a bias
# or the per-channel scales moves the output by 1e-2 or more
INT8_REL_TOL = 3e-4
INT8_BIASES = {"attention": (1, 4, 7), "mlp": (1, 4, 7)}
INT8_SCALES = {"attention": (3, 6), "mlp": (3, 6)}


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


@pytest.mark.parametrize("name", ["quant_attention_block",
                                  "quant_attention_cls", "quant_mlp_block"])
def test_int8_kernel_matches_plain_and_controls_do_not(cuda, name):
    kernel = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    x, attn, mlp = _int8_case(cuda)
    attention = name != "quant_mlp_block"
    kind = "attention" if attention else "mlp"
    params = attn if attention else mlp

    def run(fn, p, valid=VALID):
        out = fn(x, *p, HEADS, valid_len=valid) if attention else fn(x, *p)
        return out[:, :VALID] if name == "quant_attention_block" else out

    n0 = kernel.launches
    got = run(kernel, params)
    want = run(plain, params)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
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


def test_int8_cls_kernel_is_row_0_of_the_attention_kernel(cuda):
    x, attn, _mlp = _int8_case(cuda)
    full = qm.quant_attention_block(x, *attn, HEADS, valid_len=VALID)
    cls = qm.quant_attention_cls(x, *attn, HEADS, valid_len=VALID)
    torch.cuda.synchronize()
    assert cls.shape == (x.shape[0], D)
    # the same kernels and per-element operations for row 0: equal bits
    assert torch.equal(cls, full[:, 0])


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    x, attn, mlp = _int8_case(cuda)
    with pytest.raises(ValueError):      # f32 tokens
        qm.quant_attention_block(x.float(), *attn, HEADS, valid_len=VALID)
    with pytest.raises(ValueError):      # head_dim 32
        qm.quant_attention_block(x, *attn, 4, valid_len=VALID)
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


def test_int8_tower_kernels_match_plain_layers(cuda):
    """Each int8 layer agrees with its plain version to an ulp, but an
    int8 code flipped by a rounding difference is a step of 1/127 of its
    row's range, and the layers carry it on: features within 2e-2
    relative error and cosine 0.999 over three layers."""
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
    px = torch.randn(5, 32, 32, 3, device=cuda)
    counts = [fn.launches for fn in (qm.quant_attention_block,
                                     qm.quant_attention_cls,
                                     qm.quant_mlp_block)]
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    assert [fn.launches for fn in (qm.quant_attention_block,
                                   qm.quant_attention_cls,
                                   qm.quant_mlp_block)] == \
        [counts[0] + 2, counts[1] + 1, counts[2] + 3]
    assert got.shape == (5, 32)
    assert _rel_err(got, want) <= 2e-2
    assert _min_cosine(got, want) > 0.999
