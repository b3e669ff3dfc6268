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
import math

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


# The port's plain rows 1-2 against JAX's Pallas kernels in interpret mode,
# bf16 on both sides: mean |got - want| / mean |want| over the valid rows.
# Both compute the TPU kernel's function (the q fold from f32, the exp2
# softmax, the exp2 quick_gelu, f32 residuals) and round at the same points;
# f32 sums in another order flip a rare bf16 rounding.  Measured over seeds
# 0-7 at D 64 / S 32 (29 valid) and D 128 / S 208 (197 valid), layer and
# CLS: 0 to 1.01e-5.  The earlier form (max-subtracted softmax on /√hd
# scores, exp gelu, unfolded q, x + (ao Wout + bout)) sits at 1.04e-4 to
# 5.8e-4 there; the gate is ~3x above the one and ~3.5x below the other.
INTERPRET_MEAN_REL = 3e-5


def _mean_rel(got, want):
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _interpret_case(cls, seed=0, d=D, heads=HEADS, mlp=MLP, sp=SP,
                    valid=VALID, b=B):
    """(port's plain layer or CLS, JAX's interpreted kernel, the inputs)
    on the valid rows, f32 numpy."""
    rng = np.random.default_rng(seed)
    params = _layer_params(rng, d, mlp)
    x = rng.standard_normal((b, sp, d)).astype(np.float32)
    x[:, valid:] = 7.0
    jfn = jax_layer.fused_layer_cls_bf16 if cls \
        else jax_layer.fused_layer_block_bf16
    tfn = torch_layer.fused_layer_cls_bf16 if cls \
        else torch_layer.fused_layer_block_bf16
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16),
                              *map(jnp.asarray, params), heads,
                              valid_len=valid, group=min(b, 4), force=True),
                          np.float32)
    tx, tp = _torch(x, params, torch.bfloat16)
    got = _np(tfn(tx, *tp, heads, valid_len=valid))
    if not cls:
        want, got = want[:, :valid], got[:, :valid]
    return got, want, (tx, tp, heads, valid)


@pytest.mark.parametrize("cls", [False, True], ids=["layer", "cls"])
def test_plain_matches_pallas_interpret_bf16(case, cls):
    """bf16 operands on both sides, the same function and rounding points:
    within INTERPRET_MEAN_REL, and cosine > 0.999, on the valid rows."""
    got, want, _args = _interpret_case(cls)
    assert _mean_rel(got, want) <= INTERPRET_MEAN_REL
    assert _min_cosine(got, want) > 0.999


# the two shapes the gate was set on: this file's, and ViT-B/16's token
# count (208 rows, 197 valid) at head width 64
SHAPES = {"d64": {}, "d128": dict(d=128, heads=2, mlp=256, sp=208, valid=197,
                                  b=2)}


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cls", [False, True], ids=["layer", "cls"])
def test_plain_matches_pallas_interpret_seeds(cls, shape, seed):
    """The same gate over the seeds and shapes it was set on."""
    got, want, _args = _interpret_case(cls, seed, **SHAPES[shape])
    assert _mean_rel(got, want) <= INTERPRET_MEAN_REL


def _maxsub_form(x, ln1_scale, ln1_bias, wqkv, bqkv, wout, bout, ln2_scale,
              ln2_bias, w1, b1, w2, b2, num_heads, valid_len, cls_only):
    """The port's rows 1-2 before they took the TPU kernel's function: q
    unfolded, the scores divided by √hd and softmaxed with the row max
    subtracted, g·sigmoid(1.702 g), and x + (ao Wout + bout)."""
    b, s, d = x.shape
    hd = d // num_heads
    cdt = x.dtype

    def dense(a, w, bias):
        rows = torch_common.mm_f32(a.reshape(-1, a.shape[-1]).to(cdt),
                                   w.to(cdt))
        return rows.reshape(*a.shape[:-1], -1) + bias.float()

    def heads(t):
        t = t.reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)
        return t.reshape(b * num_heads, -1, hd)

    h = torch_common.layernorm_f32(x, ln1_scale, ln1_bias).to(cdt)
    kv = dense(h, wqkv[:, d:], bqkv[d:]).to(cdt)
    q = dense(h[:, :1] if cls_only else h, wqkv[:, :d], bqkv[:d]).to(cdt)
    k, v = kv.split(d, dim=-1)
    scores = torch_common.mm_f32(heads(q), heads(k).transpose(-1, -2)) \
        / math.sqrt(hd)
    scores = scores.masked_fill(torch.arange(s) >= valid_len, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).to(cdt)
    ao = torch_common.mm_f32(p, heads(v)) / p.float().sum(-1, keepdim=True)
    ao = ao.to(cdt).reshape(b, num_heads, -1, hd).transpose(1, 2)
    x1 = (x[:, :1] if cls_only else x).float() + dense(
        ao.reshape(b, -1, d), wout, bout)
    h2 = torch_common.layernorm_f32(x1, ln2_scale, ln2_bias).to(cdt)
    g = dense(h2, w1, b1)
    out = (x1 + dense((g * torch.sigmoid(1.702 * g)).to(cdt), w2, b2)).to(cdt)
    return out[:, 0] if cls_only else out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cls", [False, True], ids=["layer", "cls"])
def test_maxsub_form_fails_the_interpret_gate(cls, shape, seed):
    """The function the port computed before (a control kept here) is
    another one: it fails the gate the port's plain version passes."""
    got, want, (tx, tp, heads, valid) = _interpret_case(cls, seed,
                                                        **SHAPES[shape])
    old = _np(_maxsub_form(tx, *tp, heads, valid, cls))
    if not cls:
        old = old[:, :valid]
    assert _mean_rel(got, want) <= INTERPRET_MEAN_REL
    assert _mean_rel(old, want) > INTERPRET_MEAN_REL


def _jax_fold(wqkv, bqkv, heads):
    """JAX's fold in fused_layer_block_bf16 (patent_tpu/ops/bf16_layer.py):
    the q columns times a Python scalar, then cast to bf16."""
    d = wqkv.shape[0]
    scale2 = float(np.log2(np.e) / np.sqrt(d // heads))
    w = jnp.concatenate([wqkv[:, :d] * scale2, wqkv[:, d:]],
                        axis=1).astype(jnp.bfloat16)
    b = jnp.concatenate([bqkv[:d] * scale2, bqkv[d:]]).astype(jnp.float32)
    return np.asarray(w.astype(jnp.float32)), np.asarray(b)


def test_tower_fold_at_load_equals_jax_fold_from_f32():
    """The tower folds its q block once, from the f32 values of the state
    dict it loads, and rounds once: JAX's fold of the same f32 params, bit
    for bit.  Folding the tower's bf16 copy instead rounds twice and
    differs."""
    from patent_tpu_torch.models.vit import VIT_TINY, VisionTransformer

    tower = VisionTransformer(VIT_TINY)
    rng = np.random.default_rng(3)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32) * (0.2 if v.dim() == 2 else 0.05))
        for k, v in tower.state_dict().items()}
    tower.load_state_dict(sd)
    heads, d = VIT_TINY.num_heads, VIT_TINY.hidden_dim
    for i, layer in enumerate(tower.blocks):
        wqkv, bqkv = sd[f"blocks.{i}.wqkv"], sd[f"blocks.{i}.bqkv"]
        want_w, want_b = _jax_fold(jnp.asarray(wqkv.numpy()),
                                   jnp.asarray(bqkv.numpy()), heads)
        with torch.no_grad():
            fw = layer.folded()
        np.testing.assert_array_equal(fw.wqkv_t.T.float().numpy(), want_w)
        np.testing.assert_array_equal(fw.bqkv.numpy(), want_b)
        for name in ("wout", "w1", "w2"):
            np.testing.assert_array_equal(
                getattr(fw, name + "_t").T.float().numpy(),
                sd[f"blocks.{i}.{name}"].bfloat16().float().numpy())
        twice = torch_layer.fold_q_matrix(layer.wqkv, heads)
        assert not torch.equal(twice[:, :d], fw.wqkv_t.T[:, :d])


def test_entry_fold_follows_jax_dtype_rules():
    """The public entries fold what they are given as JAX does: f32
    weights in f32, rounded once; bf16 weights by the scalar rounded to
    bf16 (a weakly typed Python scalar takes the array's dtype)."""
    rng = np.random.default_rng(5)
    w32 = (rng.standard_normal((D, 3 * D)) * 0.2).astype(np.float32)
    b32 = (rng.standard_normal(3 * D) * 0.2).astype(np.float32)
    w16 = torch.from_numpy(w32).bfloat16()
    for wt, bt, jw, jb in (
            (torch.from_numpy(w32), torch.from_numpy(b32), jnp.asarray(w32),
             jnp.asarray(b32)),
            (w16, w16[0].float(), jnp.asarray(w16.float().numpy(),
                                              jnp.bfloat16),
             jnp.asarray(w16[0].float().numpy()))):
        fw = torch_layer.fold_layer(
            *[torch.ones(D)] * 2, wt, bt, torch.eye(D), torch.zeros(D),
            *[torch.ones(D)] * 2, torch.zeros(D, MLP), torch.zeros(MLP),
            torch.zeros(MLP, D), torch.zeros(D), HEADS)
        want_w, want_b = _jax_fold(jw, jb, HEADS)
        np.testing.assert_array_equal(fw.wqkv_t.T.float().numpy(), want_w)
        np.testing.assert_array_equal(fw.bqkv.numpy(), want_b)
    c = float(np.log2(np.e) / np.sqrt(D // HEADS))
    assert torch_common.weak_scalar(c, torch.bfloat16) != c


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
    max-subtracted masked softmax (the XLA composition's form): within the
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
