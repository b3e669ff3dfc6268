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
from patent_tpu_torch.ops import bf16_layer, topk_kernel
from patent_tpu_torch.retrieval.cli_actions import pick_device
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
    return pick_device()


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
