"""patent_tpu_torch.ops.bf16_layer (plain PyTorch versions, on the CPU)
held to patent_tpu.ops.bf16_layer.

The same numpy inputs go to both packages: the JAX XLA fallback in f32
(same math, so the tolerance is f32 summation-order noise), and the JAX
Pallas kernel in TPU interpret mode in bf16 (the bf16 rounding floor, as
tests/test_bf16_layer.py holds that kernel to its fallback).  The CUDA
kernels are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.ops import bf16_layer as jax_layer
from patent_tpu.ops import common as jax_common
from patent_tpu_torch.models.vit import quick_gelu
from patent_tpu_torch.ops import bf16_layer as torch_layer
from patent_tpu_torch.ops import common as torch_common
from patent_tpu_torch.ops import flash_attention as torch_fa

# patent_tpu.ops exports a function of the same name as this module
jax_fa = importlib.import_module("patent_tpu.ops.flash_attention")

D, HEADS, MLP, SP, VALID, B = 64, 4, 128, 32, 29, 8


def _layer_params(rng, d, mlp):
    """The distributions of tests/test_bf16_layer.py, as f32 numpy."""
    def n(shape, scale, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    return [n(d, 0.1, 1.0), n(d, 0.1), n((d, 3 * d), 0.05), n(3 * d, 0.05),
            n((d, d), 0.05), n(d, 0.05), n(d, 0.1, 1.0), n(d, 0.1),
            n((d, mlp), 0.05), n(mlp, 0.05), n((mlp, d), 0.05), n(d, 0.05)]


@pytest.fixture()
def case():
    rng = np.random.default_rng(0)
    params = _layer_params(rng, D, MLP)
    x = rng.standard_normal((B, SP, D)).astype(np.float32)
    x[:, VALID:] = 7.0          # pad rows must not affect valid rows
    return x, params


def _torch(x, params, dtype):
    return (torch.from_numpy(x).to(dtype),
            [torch.from_numpy(p) for p in params])


def _np(t):
    return t.float().numpy()


def _min_cosine(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return float(np.min(np.sum(a * b, -1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))))


def test_plain_layer_matches_jax_fallback_f32(case):
    """f32 everywhere: the same composition, so agreement to f32 noise
    (about 1e-5 on activations of magnitude ~5), pad rows included."""
    x, params = case
    want = np.asarray(jax_layer.fused_layer_block_bf16(
        jnp.asarray(x), *map(jnp.asarray, params), HEADS, valid_len=VALID))
    tx, tp = _torch(x, params, torch.float32)
    got = _np(torch_layer.fused_layer_block_bf16(tx, *tp, HEADS,
                                                 valid_len=VALID))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_plain_cls_matches_jax_fallback_f32(case):
    x, params = case
    want = np.asarray(jax_layer.fused_layer_cls_bf16(
        jnp.asarray(x), *map(jnp.asarray, params), HEADS, valid_len=VALID))
    tx, tp = _torch(x, params, torch.float32)
    got = _np(torch_layer.fused_layer_cls_bf16(tx, *tp, HEADS,
                                               valid_len=VALID))
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("cls", [False, True], ids=["layer", "cls"])
def test_plain_matches_pallas_interpret_bf16(case, cls):
    """bf16 operands on both sides, rounded at different points: atol 5e-2
    and cosine > 0.999 on the valid rows, the bf16 floor of
    tests/test_bf16_layer.py."""
    x, params = case
    jfn = jax_layer.fused_layer_cls_bf16 if cls \
        else jax_layer.fused_layer_block_bf16
    tfn = torch_layer.fused_layer_cls_bf16 if cls \
        else torch_layer.fused_layer_block_bf16
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16),
                              *map(jnp.asarray, params), HEADS,
                              valid_len=VALID, group=4, force=True),
                          np.float32)
    tx, tp = _torch(x, params, torch.bfloat16)
    got = _np(tfn(tx, *tp, HEADS, valid_len=VALID))
    if not cls:
        want, got = want[:, :VALID], got[:, :VALID]
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert _min_cosine(got, want) > 0.999


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_plain_cls_equals_row0_of_layer(case, dtype, tol):
    """The CLS layer is row 0 of the full layer: to f32 noise in f32, and
    within bf16 rounding relative to the row's scale in bf16 (its
    matmuls have other shapes)."""
    x, params = case
    tx, tp = _torch(x, params, dtype)
    full = _np(torch_layer.fused_layer_block_bf16(tx, *tp, HEADS,
                                                  valid_len=VALID))
    cls = _np(torch_layer.fused_layer_cls_bf16(tx, *tp, HEADS,
                                               valid_len=VALID))
    row0 = full[:, 0]
    assert np.max(np.abs(cls - row0)) / np.max(np.abs(row0)) < tol


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(case):
    x, params = case
    tx, tp = _torch(x, params, torch.bfloat16)
    before = (torch_layer.fused_layer_block_bf16.launches,
              torch_layer.fused_layer_cls_bf16.launches)
    a = torch_layer.fused_layer_block_bf16(tx, *tp, HEADS, valid_len=VALID)
    b = torch_layer.fused_layer_block_bf16_plain(tx, *tp, HEADS,
                                                 valid_len=VALID)
    torch_layer.fused_layer_cls_bf16(tx, *tp, HEADS, valid_len=VALID)
    assert torch.equal(a, b)
    assert (torch_layer.fused_layer_block_bf16.launches,
            torch_layer.fused_layer_cls_bf16.launches) == before


def test_required_seq_pad_bf16():
    for seq in (3, 16, 29, 197, 208):
        assert torch_layer.required_seq_pad_bf16(seq) == \
            jax_layer.required_seq_pad_bf16(seq)


def test_one_pass_softmax_matches_jax_and_the_max_subtracted_form():
    """The TPU kernel's exp2 softmax·v (clamped, no max subtraction, the
    denominator riding the p·v product) against the JAX helper: the same
    bf16 p and f32 sums in another order, so 1e-5.  Against the
    max-subtracted masked softmax that csrc/bf16_layer.cu uses: within the
    bf16 rounding of p (2^-8 relative, on |v| ≤ ~4), so 2e-2."""
    rng = np.random.default_rng(4)
    dp = 16
    q = rng.standard_normal((SP, dp)).astype(np.float32)
    k = rng.standard_normal((SP, dp)).astype(np.float32)
    v = rng.standard_normal((SP, dp)).astype(np.float32)
    q2 = q * np.float32(np.log2(np.e) / np.sqrt(dp))
    col = torch_fa.valid_col(SP, VALID, torch.float32)
    np.testing.assert_array_equal(
        col.numpy(), np.asarray(jax_fa._valid_col(SP, VALID, jnp.float32)))
    v_ext = torch.cat([torch.from_numpy(v) * col, col], 1).bfloat16()
    got = torch_fa.one_pass_softmax_pv(torch.from_numpy(q2),
                                       torch.from_numpy(k), v_ext, dp)
    want = np.asarray(jax_fa._one_pass_softmax_pv(
        jnp.asarray(q2), jnp.asarray(k),
        jnp.asarray(v_ext.float().numpy(), jnp.bfloat16), dp))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    s = (q @ k.T) / np.float32(np.sqrt(dp))
    s[:, VALID:] = -np.inf
    ref = torch.softmax(torch.from_numpy(s), -1) @ v_ext[:, :dp].float()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-2)
    assert (torch_fa.SCORE_CLAMP_LO, torch_fa.SCORE_CLAMP_HI) == \
        (jax_fa.SCORE_CLAMP_LO, jax_fa.SCORE_CLAMP_HI)


def test_quick_gelu_exp2_constant():
    """g·sigmoid(1.702 g) = g / (1 + exp2(NEG_1702_LOG2E·g)), f32 noise."""
    assert torch_common.NEG_1702_LOG2E == pytest.approx(
        jax_common.NEG_1702_LOG2E, rel=1e-15)
    g = torch.linspace(-8, 8, 101)
    np.testing.assert_allclose(
        (g / (1 + torch.exp2(torch_common.NEG_1702_LOG2E * g))).numpy(),
        quick_gelu(g).numpy(), atol=1e-6)
