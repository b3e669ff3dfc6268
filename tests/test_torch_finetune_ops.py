"""The fine-tune slice's kernels, as their plain PyTorch versions, held to
the JAX package's Pallas kernels run in interpret mode: the trainable
attention sub-layer (rows 12-13 of PERF.md's kernel table) and the
trainable MLP block (rows 15-16), forward and every gradient, plus
``attention_saturation``, the two losses and ``pca_whiten``.

The same numpy-seeded inputs go to both packages.  Where both sides round
the same bf16 intermediates, they differ by f32 summation order, which
now and then flips one bf16 rounding; each tolerance below is stated
relative to the largest value of the JAX result and sits 3-4x above the
error measured here.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.losses import contrastive as jax_losses
from patent_tpu.train import finetune_clip as jax_ft
from patent_tpu_torch.losses import contrastive as torch_losses
from patent_tpu_torch.ops import bf16_mlp_grad as torch_mlp
from patent_tpu_torch.ops import flash_attention as torch_fa
from patent_tpu_torch.train import finetune_clip as torch_ft

# patent_tpu.ops re-exports functions under these modules' names
jax_fa = importlib.import_module("patent_tpu.ops.flash_attention")
jax_mlp = importlib.import_module("patent_tpu.ops.bf16_mlp_grad")

# attention, measured here: forward <= 4.8e-3 (about one bf16 ulp where a
# rounding flips), gradients <= 7.1e-3 of their largest value; the
# gradient gate stays at the JAX tests' own 2e-2
FWD_TOL = 1.6e-2
GRAD_TOL = 2e-2
# MLP block, measured here: forward <= 6e-8, cotangents <= 1.8e-3; the
# forward gate is one bf16 ulp at the largest value
MLP_FWD_TOL = 4e-3
MLP_GRAD_TOL = 8e-3


def _rel_to_max(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _bf16(a):
    """(numpy f32 array of bf16 values, jnp bf16, torch bf16)."""
    j = jnp.asarray(a, jnp.bfloat16)
    n = np.array(j.astype(jnp.float32))
    return n, j, torch.from_numpy(n).to(torch.bfloat16)


def _attention_case(b, s, d, scale_x=0.5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)) * scale_x,
            rng.standard_normal((d, 3 * d)) * d ** -0.5,
            rng.standard_normal(3 * d) * 0.2,
            rng.standard_normal((d, d)) * d ** -0.5,
            rng.standard_normal(d) * 0.1,
            rng.standard_normal((b, s, d))]


def _attention_both(case, heads):
    """(JAX out, JAX grads, torch out, torch grads) of sum(out * cot)."""
    parts = [_bf16(a) for a in case[:5]]
    cot = case[5].astype(np.float32)

    def loss(args):
        out = jax_fa.fused_attention_block(*args, num_heads=heads, force=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(
            tuple(p[1] for p in parts))
    targs = [p[2].clone().requires_grad_(True) for p in parts]
    tout = torch_fa.fused_attention_block(*targs, heads)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(jout.astype(jnp.float32)), jgrads, tout.detach(),
            [t.grad for t in targs])


@pytest.mark.parametrize("b,s,d,heads", [(2, 13, 128, 2), (3, 5, 64, 4),
                                         (3, 16, 128, 2), (2, 13, 128, 4),
                                         (2, 65, 64, 4), (2, 13, 144, 2),
                                         (2, 13, 160, 2), (2, 13, 128, 1),
                                         (1, 470, 64, 1)],
                         ids=["S13", "most-keys-pad", "odd-batch-no-pad",
                              "hd32", "small-tower", "hd72", "hd80",
                              "hd128", "s480-streamed"])
def test_fused_attention_block_matches_jax_pallas(b, s, d, heads):
    """Forward and all five gradients; S = 5 pads to 16, so 11 of 16 keys
    are pad; S = 16 at B 3 pads nothing, and B·S = 48 rows is ragged
    against the card's 128-row GEMM tiles; head widths 72 (on the CUDA
    kernels' 80 instance), 80 and 128; and S 470, padded to 480, past the
    448 rows at which the card's backward streams its keys."""
    jout, jgrads, tout, tgrads = _attention_both(
        _attention_case(b, s, d), heads)
    assert tout.dtype == torch.bfloat16 and tout.shape == (b, s, d)
    assert _rel_to_max(tout.float(), jout) <= FWD_TOL
    for name, jg, tg in zip(("x", "wqkv", "bqkv", "wout", "bout"), jgrads,
                            tgrads):
        assert tg.dtype == torch.bfloat16
        assert _rel_to_max(tg.float(), jg.astype(jnp.float32)) <= GRAD_TOL, \
            name


def test_fused_attention_block_clamp_saturation_gated_like_jax():
    """Scores far past +80: gradients finite and equal to JAX's gated ones
    (the gate zeroes the gradient of every score at the clamp)."""
    b, s, d, heads = 1, 13, 128, 2
    case = _attention_case(b, s, d, seed=3)
    case[0] = np.full((b, s, d), 8.0) + 0.1 * case[0]
    case[1] = case[1] * 4.0
    x = torch.from_numpy(_bf16(case[0])[0]).to(torch.bfloat16)
    wqkv = torch.from_numpy(_bf16(case[1])[0]).to(torch.bfloat16)
    bqkv = torch.from_numpy(_bf16(case[2])[0]).to(torch.bfloat16)
    sat = float(torch_fa.attention_saturation(x.float(), wqkv.float(),
                                              bqkv.float(), heads))
    assert sat > 4 * torch_fa.SCORE_CLAMP_HI
    jout, jgrads, tout, tgrads = _attention_both(case, heads)
    for name, jg, tg in zip(("x", "wqkv", "bqkv", "wout", "bout"), jgrads,
                            tgrads):
        assert torch.isfinite(tg.float()).all(), name
        assert _rel_to_max(tg.float(), jg.astype(jnp.float32)) <= GRAD_TOL, \
            name


def test_attention_backward_gate_changes_the_saturated_gradient():
    """Control: the plain backward without the gate differs from the gated
    one by far more than the tolerances above where scores saturate, so
    the saturation test can see a missing gate."""
    b, s, d, heads = 1, 13, 128, 2
    case = _attention_case(b, s, d, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(8.0 + 0.5 * rng.standard_normal((b, 16, d))).to(
        torch.bfloat16)
    wqkv = torch.from_numpy(case[1] * 4.0).to(torch.bfloat16)
    bqkv = torch.from_numpy(case[2]).float()
    da = torch.from_numpy(rng.standard_normal((b, 16, d))).to(torch.bfloat16)
    gated, _a = torch_fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, s)
    ungated, _a = torch_fa.attention_bwd_plain(x, wqkv, bqkv, da, heads, s,
                                               gate=False)
    assert torch.isfinite(gated.float()).all()
    assert _rel_to_max(ungated.float(), gated.float()) > 10 * GRAD_TOL


def test_attention_saturation_matches_jax():
    rng = np.random.default_rng(5)
    b, s, d, heads = 2, 9, 64, 4
    x, wqkv, bqkv = (rng.standard_normal(sh).astype(np.float32)
                     for sh in ((b, s, d), (d, 3 * d), (3 * d,)))
    want = float(jax_fa.attention_saturation(jnp.asarray(x), jnp.asarray(wqkv),
                                             jnp.asarray(bqkv), heads))
    got = float(torch_fa.attention_saturation(
        torch.from_numpy(x), torch.from_numpy(wqkv), torch.from_numpy(bqkv),
        heads))
    assert got == pytest.approx(want, rel=1e-5)


def _mlp_case(m, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m, d)),
            1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((d, f)) * d ** -0.5,
            0.1 * rng.standard_normal(f),
            rng.standard_normal((f, d)) * f ** -0.5,
            0.1 * rng.standard_normal(d),
            rng.standard_normal((m, d))]


@pytest.mark.parametrize("m", [64, 77, 3 * 65],
                         ids=["M64", "M77-ragged", "M195-small-tower"])
def test_fused_mlp_block_matches_jax_pallas(m):
    """Output and all seven cotangents at the CLIs' small tower's widths
    (D 64, F 128); 77 rows is no multiple of the JAX kernel's 16-row tile
    (it pads; the port takes any M), and 195 is three images of 65
    tokens."""
    d, f = 64, 128
    case = _mlp_case(m, d, f)
    x = _bf16(case[0])
    vecs = [np.asarray(a, np.float32) for a in case[1:]]
    lns, lnb, w1, b1, w2, b2, cot = vecs

    def loss(args):
        out = jax_mlp.fused_mlp_block_bf16(*args, m_tile=16, force=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    jargs = (x[1], *(jnp.asarray(v) for v in (lns, lnb, w1, b1, w2, b2)))
    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(jargs)
    targs = [x[2].clone()] + [torch.from_numpy(v).clone()
                              for v in (lns, lnb, w1, b1, w2, b2)]
    for t in targs:
        t.requires_grad_(True)
    tout = torch_mlp.fused_mlp_block_bf16(*targs)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    assert tout.dtype == torch.bfloat16
    assert _rel_to_max(tout.detach().float(),
                       jout.astype(jnp.float32)) <= MLP_FWD_TOL
    names = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")
    for name, jg, tg in zip(names, jgrads, targs):
        assert tg.grad.dtype == tg.dtype, name
        assert _rel_to_max(tg.grad.float(), jg.astype(jnp.float32)) \
            <= MLP_GRAD_TOL, name


def test_losses_and_pca_whiten_match_jax():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((12, 32)).astype(np.float32)
    graph = rng.standard_normal((6, 32)).astype(np.float32)
    for scale in (1.0, 14.3):
        want = float(jax_losses.multi_positive_nt_xent(jnp.asarray(feats),
                                                       scale))
        got = float(torch_losses.multi_positive_nt_xent(
            torch.from_numpy(feats), torch.tensor(scale)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    want = float(jax_losses.graph_alignment_cosine(jnp.asarray(feats[:6]),
                                                   jnp.asarray(graph)))
    got = float(torch_losses.graph_alignment_cosine(
        torch.from_numpy(feats[:6]), torch.from_numpy(graph)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    vgae = rng.standard_normal((40, 64)).astype(np.float32)
    for dim in (16, 128):
        np.testing.assert_array_equal(torch_ft.pca_whiten(vgae, dim),
                                      jax_ft.pca_whiten(vgae, dim))
