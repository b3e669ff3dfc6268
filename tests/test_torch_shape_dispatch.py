"""Shapes the JAX package serves that the port's kernels take, on the CPU.

One attention contract.  The tile (csrc/flash_tile.cuh: rows 1, 2, 5, 6,
8, 9, 14 and row 12's forward), row 13's backward and row 14's f32
kernel are instantiated at every multiple of 16 up to 128 and stream
their keys past what a block holds, so they take any head width that is
a multiple of 8 up to 128 at any padded S; their entries ask
``check_attention_shape`` (``attention_kernel_takes``), which raises on
any other shape.  The bucket top-k kernels take
widths that are multiples of 16 (bf16) or 32 (int8, Poincaré), and
``EmbeddingIndex`` zero-pads its candidate copies to them, as the JAX
wrappers pad D.  Row 18 takes up to ``MOBIUS_DENSE_MAX_OUT`` columns in
column groups, and an empty batch without a launch.  These tests hold
what the CPU can show: the predicate and its raise, the exactness of the zero padding on the plain top-2 versions, and
``MobiusDense`` at those widths.  tests/test_torch_gpu.py holds the same
calls on the card.
"""

import numpy as np
import pytest
import torch

from patent_tpu_torch.models.hyperbolic import MobiusDense
from patent_tpu_torch.ops import pallas_kernels as pk
from patent_tpu_torch.ops import topk_kernel as tk
from patent_tpu_torch.ops.common import (attention_kernel_takes,
                                         check_attention_shape)
from patent_tpu_torch.retrieval import index as index_mod


@pytest.mark.parametrize("d,heads,s,valid,takes", [
    (768, 12, 208, 197, True),      # ViT-B/16 @224, the token axis padded
    (128, 2, 48, 20, True),         # the card tests' narrow layer
    (64, 4, 80, 65, True),          # the CLIs' small tower: head_dim 16
    (512, 16, 208, 197, True),      # head_dim 32
    (128, 16, 48, 20, True),        # head_dim 8, on the 16 instance
    (128, 1, 48, 20, True),         # head_dim 128
    (100, 3, 48, 20, False),        # D not a multiple of the heads
    (768, 12, 197, 197, False),     # the token axis not padded to 16
    (768, 12, 208, 0, False),       # no valid key
    (768, 12, 208, 209, False),     # more valid keys than rows
    (768, 12, 448, 400, True),      # the old limit: 231,168 bytes
    (768, 12, 592, 577, True),      # ViT-B/16 @384: K and V streamed
    (1152, 16, 272, 257, True),     # head_dim 72, on the 80 instance
    (1280, 16, 272, 257, True),     # ViT-H/14's widths: head_dim 80
    (1408, 16, 272, 257, True),     # ViT-g/14's head_dim 88, on 96
    (1024, 16, 592, 577, True),     # CLIP ViT-L/14 @336
    (64, 4, 1040, 1025, True),      # 256 px, patch 8: 1,025 tokens
    (96, 8, 48, 20, False),         # head_dim 12: not a multiple of 8
    (136, 1, 48, 20, False),        # head_dim 136: past the widest
    # row 13's shapes, which its own narrower contract took or refused
    # before it met the tile's: the fine-tune's, the CLIs' small tower,
    # its old whole-sequence limit and past it (streamed), head_dim 8,
    # 128, 80 and 72, and an unpadded token axis, which still raises
    (768, 12, 208, 197, True),      # ViT-B/16 @224: the fine-tune's shape
    (64, 4, 80, 65, True),          # the CLIs' small tower
    (768, 12, 448, 400, True),      # the resident block: 231,168 bytes
    (768, 12, 592, 577, True),      # past it: the streamed path
    (1024, 16, 592, 577, True),     # CLIP ViT-L/14 @336
    (128, 16, 48, 20, True),        # head_dim 8
    (128, 1, 48, 20, True),         # head_dim 128
    (1280, 16, 272, 257, True),     # head_dim 80
    (1152, 16, 272, 257, True),     # head_dim 72
    (768, 12, 197, 197, False),     # the token axis not padded to 16
], ids=["vit-b16", "narrow", "small-tower", "hd32", "hd8", "hd128",
        "d-ragged", "unpadded", "valid0", "valid-past-S", "s448", "s592",
        "hd72", "hd80", "hd88", "vit-l14-336", "s1040", "hd12", "hd136",
        "bwd-vit-b16", "bwd-small-tower", "bwd-s448", "bwd-s592",
        "bwd-vit-l14-336", "bwd-hd8", "bwd-hd128", "bwd-hd80", "bwd-hd72",
        "bwd-unpadded"])
def test_attention_predicate_and_its_raise_agree(d, heads, s, valid, takes):
    """``check_attention_shape`` raises exactly where the attention
    kernels' predicate is false, so no entry launches a kernel on a shape
    it does not take."""
    assert attention_kernel_takes(d, heads, s, valid) is takes
    if takes:
        check_attention_shape(d, heads, s, valid)
    else:
        with pytest.raises(ValueError):
            check_attention_shape(d, heads, s, valid)


def test_attention_predicate_names_the_head_dim():
    with pytest.raises(ValueError, match="multiple of 8 up to 128, got "
                                         "D=136 with 1"):
        check_attention_shape(136, 1, 48, 20)
    with pytest.raises(ValueError, match="multiple of 8 up to 128, got "
                                         "D=96 with 8"):
        check_attention_shape(96, 8, 48, 20)
    with pytest.raises(ValueError, match="token axis 592 must be padded"):
        check_attention_shape(768, 12, 592, 593)


def _cosine_case(d, n=2500, nq=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    gal = torch.randn(n, d, generator=g)
    gal[1900] = gal[876]                       # a tie in one bucket
    q = torch.cat([gal[:nq // 2] + 0.3 * torch.randn(nq // 2, d, generator=g),
                   torch.randn(nq - nq // 2, d, generator=g)])
    return gal, q


@pytest.mark.parametrize("d", [10, 100])
def test_zero_columns_leave_the_bf16_top2_unchanged(d):
    gal, q = _cosine_case(d)
    g16, valid = tk.prepare_cosine_gallery_bf16(gal)
    valid[::97] = 0.0
    q16 = tk._query_bf16(q, gal.shape[0], 80)
    g16p, q16p = tk.pad_columns(g16), tk.pad_columns(q16)
    assert g16p.shape[1] == q16p.shape[1] == -(-d // 16) * 16
    assert not g16p[:, d:].any()
    for a, b in zip(tk.bucket_top2_plain(q16p, g16p, valid),
                    tk.bucket_top2_plain(q16, g16, valid)):
        assert torch.equal(a, b)
    # the entry pads the normalized queries to the gallery's width
    for a, b in zip(tk.bucket_topk_bf16(q, g16p, valid, 80),
                    tk.bucket_topk_bf16(q, g16, valid, 80)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [10, 100])
def test_zero_columns_leave_the_int8_top2_unchanged(d):
    gal, q = _cosine_case(d, seed=1)
    gi8, gscale = (torch.from_numpy(a) for a in tk.quantize_gallery(gal))
    qi8, qscale = tk.quantize_queries(q)
    gi8p = tk.pad_columns(gi8)
    assert gi8p.shape[1] == -(-d // 32) * 32 and not gi8p[:, d:].any()
    for a, b in zip(tk.bucket_top2_int8_plain(tk.pad_columns(qi8), gi8p,
                                              gscale),
                    tk.bucket_top2_int8_plain(qi8, gi8, gscale)):
        assert torch.equal(a, b)
    for a, b in zip(tk.bucket_topk_int8(qi8, qscale, gi8p, gscale, 80),
                    tk.bucket_topk_int8(qi8, qscale, gi8, gscale, 80)):
        assert torch.equal(a, b)


def _ball(g, n, d, c):
    v = torch.randn(n, d, generator=g)
    r = torch.rand(n, 1, generator=g) * 0.95 / c ** 0.5
    return v / v.norm(dim=-1, keepdim=True) * r


@pytest.mark.parametrize("d", [10, 100])
def test_zero_columns_leave_the_poincare_top2_unchanged(d):
    """The codes are padded after the queries' quantization and the row
    terms come from the unpadded rows, so the surrogate is unchanged."""
    c = 2.0
    g = torch.Generator().manual_seed(d)
    gal, q = _ball(g, 2500, d, c), _ball(g, 24, d, c)
    pg = tk.prepare_poincare_gallery(gal, c)
    pgp = pg._replace(gal_i8=tk.pad_columns(pg.gal_i8))
    terms = tk.quantize_poincare_queries(q)
    padded = (tk.pad_columns(terms[0], pgp.gal_i8.shape[1]), *terms[1:])
    for a, b in zip(tk.bucket_top2_poincare_plain(*padded, pgp),
                    tk.bucket_top2_poincare_plain(*terms, pg)):
        assert torch.equal(a, b)
    for a, b in zip(tk.bucket_topk_poincare(q, pgp, 80),
                    tk.bucket_topk_poincare(q, pg, 80)):
        assert torch.equal(a, b)


def test_pad_columns_keeps_a_kernel_width_as_it_is():
    t = torch.zeros(3, 64, dtype=torch.int8)
    assert tk.pad_columns(t) is t
    t16 = torch.zeros(3, 48, dtype=torch.bfloat16)
    assert tk.pad_columns(t16) is t16


@pytest.mark.parametrize("d", [10, 100])
def test_quantized_index_at_any_width_equals_the_scan(d):
    """EmbeddingIndex pads its int8 and Poincaré candidate copies at
    build; a search then equals the f32 scan (cosine) and the f64 ranking
    (Poincaré) index for index."""
    gal, q = _cosine_case(d, seed=2)
    names = [f"g{i}" for i in range(gal.shape[0])]
    idx = index_mod.EmbeddingIndex(gal, names, device="cpu", quantized=True)
    assert idx.emb_i8.shape[1] % 32 == 0
    _v, got = idx.search(q, k=10)
    _sv, want = index_mod.topk_search(q, gal, k=10)
    assert np.array_equal(got, want.numpy())
    c = 2.0
    g = torch.Generator().manual_seed(d + 1)
    ball, qb = _ball(g, 2500, d, c), _ball(g, 12, d, c)
    pidx = index_mod.EmbeddingIndex(ball, names, similarity="poincare", c=c,
                                    device="cpu", quantized=True)
    assert pidx.emb_gal.gal_i8.shape[1] % 32 == 0
    _v, got = pidx.search(qb, k=10)
    dist = index_mod.poincare_dist_f64(qb, ball.expand(12, -1, -1), c)
    want = torch.sort(dist, dim=1, stable=True).indices[:, :10]
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("features,n", [(256, 5), (1024, 1), (2048, 7),
                                        (8192, 2), (256, 0)],
                         ids=["D256", "D1024", "D2048", "D8192", "n0"])
def test_mobius_dense_on_the_cpu_is_the_plain_chain(features, n):
    """On a CPU tensor the encoder's first layer is row 18's plain version
    at every width the kernel takes (in column groups past 1024), and at
    no rows."""
    gen = torch.Generator().manual_seed(4)
    layer = MobiusDense(32, features, c=2.0, hyperbolic_input=False,
                        generator=gen)
    assert layer._fused() and features <= pk.MOBIUS_DENSE_MAX_OUT
    x = torch.randn(n, 32, generator=gen)
    with torch.no_grad():
        got = layer(x)
    want = pk.mobius_dense_pallas_plain(x, layer.kernel.detach(),
                                        layer.hyp_bias.detach(), 2.0)
    assert got.shape == (n, features)
    assert torch.equal(got, want)
