"""The fast form of patent_tpu_torch's int8 kernels (``fast=True``, the
JAX package's default on its accelerator) held to patent_tpu's own
definitions, on the CPU: its reciprocal, its row quantization (codes that
saturate at 127 and reach -128) and its quick_gelu, bit for bit, and the
device rule behind ``fast=None``.  Rows 5-11 and the tower in both forms
are held to JAX's kernels in tests/test_torch_int8.py and
tests/test_torch_int8_layer.py.

JAX's fast reciprocal (``quant_matmul._recip``, ``pl.reciprocal(x,
approx=True)``) is the TPU's hardware reciprocal on the TPU; elsewhere it
lowers to a bf16 reciprocal, which these tests run inside a Pallas kernel
in interpret mode under one jit without excess precision (with it, XLA
may keep the bf16 result in f32).  Inputs come from numpy with a fixed
seed.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.ops import quant_matmul as jqm
from patent_tpu_torch.ops import quant_matmul as tqm

NO_EXCESS = {"xla_allow_excess_precision": False}


def _kernel(body, x, *outs):
    """``body(x_ref, *out_refs)`` as one Pallas kernel over all of x, in
    interpret mode, in one jit without excess precision; numpy outputs of
    the (shape, dtype) ``outs``."""
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(body, out_shape=tuple(
            jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in outs))
        got = jax.jit(call, compiler_options=NO_EXCESS)(jnp.asarray(x))
    return [np.asarray(o) for o in got]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_recip_equals_jax_bit_for_bit():
    """2^20 f32 values from 1e-8 to 1e6 (log-uniform, random mantissas):
    the port's ``recip`` equals JAX's ``_recip`` in its kernels and
    ``jnp.reciprocal`` of the bf16 value in every bit; its error against
    1/x reaches 5.8e-3 (two bf16 roundings), the exact divide's none."""
    rng = np.random.default_rng(3)
    x = np.exp(rng.uniform(np.log(1e-8), np.log(1e6), (1024, 1024)))
    x = x.astype(np.float32)

    def body(x_ref, o_ref):
        o_ref[...] = jqm._recip(x_ref[...])

    (want,) = _kernel(body, x, (x.shape, jnp.float32))
    got = tqm.recip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    eager = jnp.reciprocal(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(got), _bits(eager.astype(jnp.float32)))
    rel = np.abs(got.astype(np.float64) * x - 1.0)
    assert 4e-3 < rel.max() < 6e-3


def test_a_bf16_reciprocal_lies_far_from_every_bf16_midpoint():
    """The card's ``recip`` takes the hardware's approximate reciprocal
    (within 1 f32 ulp) of y = bf16(x) and rounds it to bf16: the IEEE
    divide's result whenever 1 / y lies more than 1 ulp from a bf16
    rounding midpoint.  With 8 significant bits in y it lies at least 128
    ulps away (exact fractions over the 128 mantissas; the binade does not
    matter), and ``recip`` equals a reciprocal perturbed by 64 ulps either
    way."""
    from fractions import Fraction

    gaps = []
    for m in range(129, 256):                  # y = m / 128, 1 / y in (½, 1)
        rem = Fraction(128, m) % Fraction(1, 256)
        gaps.append(abs(rem - Fraction(1, 512)) * 2 ** 24)
    assert min(gaps) > 128
    y = torch.arange(128, 256, dtype=torch.float32) / 128
    y = torch.cat([y * 2.0 ** e for e in (-60, -7, 0, 9, 60)])
    want = tqm.recip(y)
    for ulps in (-64, 64):
        near = (1.0 / y.double()) * (1 + ulps * 2.0 ** -24)
        got = near.float().to(torch.bfloat16).float()
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(want.numpy()))


def _rows(rng, m=4096, k=96):
    """Rows of random widths and signs; about one in forty reaches
    x * inv >= 127.5 at its max |x| (108 of these 4,096), and as many
    -127.5 or less."""
    x = rng.standard_normal((m, k)) * np.exp(rng.uniform(-8, 8, (m, 1)))
    return x.astype(np.float32)


def _jax_quant_rows_k(x):
    def body(x_ref, q_ref, s_ref, v_ref):
        xf = x_ref[...]
        q_ref[...], s_ref[...] = jqm._quant_rows_k(xf)
        amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                           1e-8)
        v_ref[...] = jnp.round(xf * (jqm._recip(amax) * 127.0))

    m, k = x.shape
    return _kernel(body, x, ((m, k), jnp.int8), ((m, 1), jnp.float32),
                   ((m, k), jnp.float32))


def test_quant_rows_fast_equals_jax_and_saturates():
    """The fast row quantization against JAX's ``_quant_rows_k``: the same
    codes and scales, bit for bit, on rows where x * inv rounds to 128
    (saturated to 127, as XLA's f32 → s8 convert saturates) and to -128;
    the scale is the exact form's."""
    x = _rows(np.random.default_rng(5))
    want_q, want_s, rounded = _jax_quant_rows_k(x)
    got_q, got_s = tqm.quant_rows_fast(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    np.testing.assert_array_equal(
        _bits(got_s.numpy()), _bits(tqm.quant_rows(torch.from_numpy(x))[1]))
    saturated = rounded >= 128.0
    assert 20 <= saturated.any(axis=1).sum() < len(x) // 4
    assert (want_q[saturated] == 127).all()
    assert (want_q == -128).any(axis=1).sum() >= 20
    assert rounded.min() >= -128.0 and rounded.max() <= 128.0


def test_exact_codes_and_a_wrapping_cast_fail_the_fast_gate():
    """The controls: the exact form's codes are another function of the
    same rows, and a cast that wraps (``round(x * inv).to(int8)`` in
    PyTorch turns 128 into -128) differs from JAX's saturating one exactly
    at the saturated codes."""
    x = _rows(np.random.default_rng(5))
    want_q, _s, rounded = _jax_quant_rows_k(x)
    exact_q, _ = tqm.quant_rows(torch.from_numpy(x))
    assert not np.array_equal(exact_q.numpy(), want_q)
    xt = torch.from_numpy(x)
    amax = xt.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    wrapped = torch.round(xt * (tqm.recip(amax) * 127.0)).to(torch.int8)
    diff = wrapped.numpy() != want_q
    assert diff.any()
    np.testing.assert_array_equal(diff, rounded >= 128.0)


def test_quick_gelu_fast_equals_jax():
    """``g * recip(1 + exp2(-1.702 log2(e) g))`` against JAX's
    ``_quick_gelu_k``: XLA's exp2 and PyTorch's may differ in the last bit,
    and where that moves the bf16 reciprocal the value moves by its step.
    Measured: 3 of 2^16 values in [-30, 30] differ; gated at one step
    (2^-7 relative) on a thousandth of the values.  The exact quick_gelu
    is more than that off on many values (the control)."""
    g = np.random.default_rng(7).uniform(-30, 30, (256, 256))
    g = g.astype(np.float32)

    def body(g_ref, o_ref):
        o_ref[...] = jqm._quick_gelu_k(g_ref[...])

    (want,) = _kernel(body, g, (g.shape, jnp.float32))
    gt = torch.from_numpy(g)
    got = tqm._quick_gelu(gt, fast=True).numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert (got != want).mean() <= 1e-3 and rel.max() <= 2.0 ** -7
    exact = tqm._quick_gelu(gt).numpy()
    assert (np.abs(exact - want) > 2.0 ** -9 * np.abs(want)).mean() > 0.1


@pytest.mark.parametrize("env,on_card,given,want", [
    (None, False, None, False), ("1", False, None, False),
    (None, True, None, True), ("1", True, None, True),
    ("0", True, None, False), ("yes", True, None, True),
    ("0", True, True, True), ("1", False, False, False),
    (None, False, True, True)])
def test_fast_none_means_the_env_var_on_the_card_and_exact_on_the_cpu(
        monkeypatch, env, on_card, given, want):
    """``resolve_fast`` as JAX's ``_fast``: an explicit flag wins; None
    reads PATENT_TPU_FAST_KERNELS at call time on the card ("0" exact,
    anything else or unset fast) and is the exact form on the CPU."""
    if env is None:
        monkeypatch.delenv(tqm.FAST_ENV, raising=False)
    else:
        monkeypatch.setenv(tqm.FAST_ENV, env)
    with mock.patch.object(tqm, "_on_card", lambda x: on_card):
        assert tqm.resolve_fast(given, torch.zeros(1)) is want


def _layer_params(rng, d=64, f=128):
    def w(k, n):
        q, s = tqm.quantize_weight(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32) * 0.1))
        return q.T.contiguous(), s, torch.from_numpy(
            rng.standard_normal(n).astype(np.float32) * 0.02)

    ln = (torch.ones(d), torch.zeros(d))
    return (*ln, *w(d, 3 * d), *w(d, d), *ln, *w(d, f), *w(f, d))


def test_every_entry_passes_the_form_on_and_the_forms_differ(monkeypatch):
    """On the CPU each entry of rows 5-11 computes the form it is given, or
    for None the one its device probe and the env var name; the two forms
    give other outputs (so the tests of both forms test two functions)."""
    rng = np.random.default_rng(9)
    p = _layer_params(rng)
    x = torch.from_numpy(rng.standard_normal((3, 32, 64)).astype(
        np.float32)).to(torch.bfloat16)
    a, a_s = tqm.quant_rows(x[0].float())
    calls = {
        "attn": lambda **kw: tqm.quant_attention_block(x, *p[:8], 4, 20,
                                                       **kw),
        "cls": lambda **kw: tqm.quant_attention_cls(x, *p[:8], 4, 20, **kw),
        "mlp": lambda **kw: tqm.quant_mlp_block(x, *p[8:], **kw),
        "layer": lambda **kw: tqm.quant_layer_block(x, *p, 4, 20, **kw),
        "group": lambda **kw: tqm.quant_layer_group(x, *p, 4, 20, group=3,
                                                    **kw),
        "dense": lambda **kw: tqm.quant_dense(x, *p[10:13], "quick_gelu",
                                              **kw),
        "qmlp": lambda **kw: tqm.quant_mlp(x, *p[10:], **kw),
        "gemm": lambda **kw: tqm.int8_gemm(a, a_s[:, 0], *p[10:13], "gelu",
                                           **kw),
        "gelu_quant": lambda **kw: tqm.int8_gelu_quant(
            a, a_s[:, 0], *p[10:13], **kw)[2],
    }
    monkeypatch.setenv(tqm.FAST_ENV, "1")
    for name, call in calls.items():
        exact, fast = call(fast=False), call(fast=True)
        assert not torch.equal(exact, fast), name
        assert torch.equal(call(), exact), name
        with mock.patch.object(tqm, "_on_card", lambda t: True):
            assert torch.equal(call(), fast), name
            monkeypatch.setenv(tqm.FAST_ENV, "0")
            assert torch.equal(call(), exact), name
            monkeypatch.setenv(tqm.FAST_ENV, "1")
