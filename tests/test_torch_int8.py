"""patent_tpu_torch int8 serving layer and tower (plain versions, on the
CPU) held to patent_tpu.

The JAX side runs as tests/test_quant_matmul.py runs it: the Pallas
kernels under ``force_tpu_interpret_mode`` with ``force=True`` and, for
the attention sub-layer, ``group=4``, in each of the two forms the port
computes (``fast=False``, the exact-division form, and ``fast=True``,
JAX's default on its accelerator: tests/test_torch_int8_fast.py pins its
reciprocal and codes); the tower with ``quant_matmul._on_tpu`` patched, as
tests/test_torch_pipeline.py does for the bf16 tower, and
PATENT_TPU_FAST_KERNELS set to the form, the port's tower with its device
probe patched for the fast form.  The XLA fallback is the second
reference.  Inputs come from numpy with a fixed seed.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.models import vit as jax_vit
from patent_tpu.models import vit_int8 as jax_vit_int8
from patent_tpu.ops import quant_matmul as jqm
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models import vit_int8 as torch_vit_int8
from patent_tpu_torch.models.weights import (int8_params_from_jax,
                                             params_from_jax)
from patent_tpu_torch.ops import quant_matmul as tqm

D, HEADS, S, VALID, F = 128, 4, 64, 50, 256
# both forms of the int8 kernels (``fast``), by test id
FORMS = pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _weights(rng, k, n, wscale=0.05):
    """(JAX int8 [in, out], scale, bias) and the port's ([out, in], scale,
    bias), from one f32 matrix."""
    w = jnp.asarray(rng.standard_normal((k, n)) * wscale, jnp.float32)
    wq, s = jqm.quantize_weight(w)
    b = jnp.asarray(rng.standard_normal(n) * 0.01, jnp.float32)
    return (wq, s, b), (_t(wq).T.contiguous(), _t(s), _t(b))


def _ln(rng, d=D):
    return (jnp.asarray(1.0 + 0.1 * rng.standard_normal(d), jnp.float32),
            jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32))


def _attn_case(rng, b=4):
    """bf16 tokens [B, S, D] with pad rows of random content, and the
    attention sub-layer's weights in both layouts."""
    x = jnp.asarray(rng.standard_normal((b, S, D)) * 0.3, jnp.bfloat16)
    lns, lnb = _ln(rng)
    jqkv, tqkv = _weights(rng, D, 3 * D)
    jout, tout = _weights(rng, D, D)
    jargs = (lns, lnb, *jqkv, *jout)
    targs = (_t(lns), _t(lnb), *tqkv, *tout)
    return x, _t(np.asarray(x, np.float32), torch.bfloat16), jargs, targs


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` in one jit without excess precision, as f32
    numpy: each bf16 rounding as written (the fast form's reciprocal rounds
    to bf16; with excess precision XLA may keep it f32)."""
    return np.asarray(jax.jit(functools.partial(fn, **static),
                              compiler_options=NO_EXCESS)(*args), np.float32)


def _rel(got, want):
    """max |got - want| / max |want|."""
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _mean_rel(got, want):
    """mean |got - want| / mean |want|."""
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", [(64, 192), (128, 384), (3, 5, 256)],
                         ids=["64x192", "128x384", "3x5x256"])
def test_quantize_weight_and_quant_rows_equal_jax(rng, shape):
    """Same int8 codes and f32 scales, bit for bit: the max is exact, and
    both divide (weights) or multiply by f32(1/127) (rows), then round half
    to even."""
    w = rng.standard_normal(shape[-2:]).astype(np.float32) * 0.05
    wq, ws = jqm.quantize_weight(jnp.asarray(w))
    tq, ts = tqm.quantize_weight(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    x = rng.standard_normal(shape).astype(np.float32)
    xq, xs = jqm._quant_rows(jnp.asarray(x))
    tq, ts = tqm.quant_rows(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(xs))


@FORMS
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
def test_quant_mlp_block_plain_matches_jax_kernel(rng, dtype, fast):
    """Row 7 against the Pallas kernel in the same form at the
    test_quant_matmul.py floor, 1e-4.  Measured (exact form):
    bit-identical in bf16, 2.5e-7 relative in f32 (LayerNorm sums in
    another order)."""
    x = jnp.asarray(rng.standard_normal((3, 40, D)) * 0.3, dtype)
    lns, lnb = _ln(rng)
    j1, t1 = _weights(rng, D, F)
    j2, t2 = _weights(rng, F, D)
    want = _jit(jqm.quant_mlp_block, x, lns, lnb, *j1, *j2, m_tile=64,
                force=True, fast=fast)
    xt = _t(np.asarray(x, np.float32),
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = tqm.quant_mlp_block(xt, _t(lns), _t(lnb), *t1, *t2, fast=fast)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4)


# Row 5 against the Pallas kernel: both round at the same points, so they
# differ only where a LayerNorm or f32 dot summed in another order flips an
# int8 code.  Measured over 5 seeds x 2 valid lengths: identical in 6 of
# 10 cases, else at most 118 of 25,600 elements differ, mean relative
# error 1.0e-5 or less, max 3.1e-3 of the largest |y|.
ATTN_MEAN_REL, ATTN_MAX_REL = 1e-4, 5e-3


@FORMS
@pytest.mark.parametrize("valid", [VALID, S], ids=["valid50", "valid64"])
def test_quant_attention_block_plain_matches_jax_kernel(rng, valid, fast):
    """Row 5 against the Pallas kernel (group=4) in the same form within
    the gate above."""
    x, xt, jargs, targs = _attn_case(rng)
    want = _jit(jqm.quant_attention_block, x, *jargs, num_heads=HEADS,
                valid_len=valid, force=True, fast=fast, group=4)[:, :valid]
    got = tqm.quant_attention_block(xt, *targs, HEADS, valid, fast=fast)
    assert got.dtype == torch.bfloat16 and got.shape == (4, S, D)
    got = _np(got)[:, :valid]
    assert _mean_rel(got, want) <= ATTN_MEAN_REL
    assert _rel(got, want) <= ATTN_MAX_REL


def test_quant_attention_block_plain_within_xla_fallback(rng):
    """Row 5 against the XLA fallback (max-subtracted f32 softmax, no bf16
    p): the test_quant_matmul.py floor, 2e-2 relative; measured 5.9e-3."""
    x, xt, jargs, targs = _attn_case(rng)
    want = np.asarray(jqm.quant_attention_block(x[:, :VALID], *jargs,
                                                num_heads=HEADS), np.float32)
    got = tqm.quant_attention_block(xt, *targs, HEADS, VALID)
    assert _rel(_np(got)[:, :VALID], want) <= 2e-2


@FORMS
def test_quant_attention_cls_plain_is_row_0_and_matches_jax(rng, fast):
    """Row 6 against row 0 of row 5 (both plain) within the
    test_quant_matmul.py reasoning, 2e-3 (CPU BLAS may sum a 1-row product
    in another order; measured: identical), and against the JAX CLS
    kernel, in the same form."""
    x, xt, jargs, targs = _attn_case(rng)
    full = _np(tqm.quant_attention_block(xt, *targs, HEADS, VALID,
                                         fast=fast))
    cls = tqm.quant_attention_cls(xt, *targs, HEADS, VALID, fast=fast)
    assert cls.shape == (4, D) and cls.dtype == torch.bfloat16
    assert _rel(_np(cls), full[:, 0]) <= 2e-3
    want = _jit(jqm.quant_attention_cls, x, *jargs, num_heads=HEADS,
                valid_len=VALID, force=True, fast=fast, group=4)
    assert _rel(_np(cls), want) <= ATTN_MAX_REL


def test_attention_controls_move_the_output(rng):
    """The controls chip_smoke.py uses must be visible on the CPU too: the
    key mask, each bias and the per-channel scales each move row 5's output
    by 10x the gate above or more."""
    _x, xt, _j, targs = _attn_case(rng)
    ref = _np(tqm.quant_attention_block_plain(xt, *targs, HEADS, VALID))

    def gap(args, valid=VALID):
        got = _np(tqm.quant_attention_block_plain(xt, *args, HEADS, valid))
        return _mean_rel(got[:, :VALID], ref[:, :VALID])

    assert gap(targs, S) > 1e-3
    for i in (1, 4, 7):                       # ln1_bias, bqkv, bout
        args = list(targs)
        args[i] = torch.zeros_like(args[i])
        assert gap(args) > 1e-3, i
    for i in (3, 6):                          # sqkv, sout → their mean
        args = list(targs)
        args[i] = torch.full_like(args[i], float(args[i].mean()))
        assert gap(args) > 1e-3, i


def _int8_tower(jcfg, tcfg, keep, seed=0):
    """Flax f32 params (LayerNorms and biases perturbed so every parameter
    matters) → (JAX Int8VisionTransformer params, the port's tower with the
    same int8 weights through the bridge)."""
    model = jax_vit.VisionTransformer(jcfg, dtype=jnp.float32,
                                      fused_layer=True)
    params = model.init(jax.random.key(seed), jnp.zeros(
        (1, jcfg.image_size, jcfg.image_size, 3)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        params)
    qparams = jax_vit_int8.quantize_vit_params(params)
    tower = torch_vit_int8.Int8VisionTransformer(tcfg, keep_tokens=keep)
    tower.load_state_dict(int8_params_from_jax(qparams))
    return params, qparams, tower


GOLDEN64 = dict(image_size=64, patch_size=8, hidden_dim=64, num_layers=2,
                num_heads=4, mlp_dim=128, projection_dim=64)


@FORMS
@pytest.mark.parametrize(
    "name,keep,batch",
    [("tiny", None, 4), ("golden64", None, 4), ("golden64", 40, 4),
     ("tiny", None, 3), ("golden64", None, 3), ("golden64", None, 1)],
    ids=["tiny", "golden64", "golden64-keep40", "tiny-B3", "golden64-B3",
         "golden64-B1"])
def test_int8_tower_matches_jax(monkeypatch, name, keep, batch, fast):
    """The int8 tower against JAX's Int8VisionTransformer (Pallas kernels
    in interpret mode) with the same quantize_vit_params weights, both in
    the form PATENT_TPU_FAST_KERNELS names and no ``fast`` passed, as a
    server runs them (the port's device probe patched for the fast form,
    as JAX's is for its kernels): min feature cosine above 0.9999
    (measured, exact form: 1.0, identical features but for LayerNorm
    summation order).  At batch 4 both run the
    attention and MLP sub-layers; at batch 3 and 1 the JAX tower runs its
    whole-layer kernel (row 8) and the port quant_layer_block: measured
    1 - cosine 1.8e-5 to 3.1e-5 there (the rows 5 + 7 chain in its place
    gives 5.6e-5 to 8.5e-5, which this gate cannot tell apart after the
    post-LN and the projection: tests/test_torch_int8_layer.py does, layer
    by layer)."""
    jcfg, tcfg = {"tiny": (jax_vit.VIT_TINY, torch_vit.VIT_TINY),
                  "golden64": (jax_vit.VisionConfig(**GOLDEN64),
                               torch_vit.VisionConfig(**GOLDEN64))}[name]
    _params, qparams, tower = _int8_tower(jcfg, tcfg, keep)
    px = np.random.default_rng(1).standard_normal(
        (batch, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    monkeypatch.setenv("PATENT_TPU_FAST_KERNELS", "1" if fast else "0")
    with mock.patch.object(jqm, "_on_tpu", lambda: True):
        want = _jit(jax_vit_int8.Int8VisionTransformer(
            jcfg, keep_tokens=keep).apply, {"params": qparams},
            jnp.asarray(px))
    with torch.inference_mode(), mock.patch.object(
            tqm, "_on_card", lambda x: fast):
        got = tower(_t(px)).numpy()
    assert got.shape == want.shape == (batch, tcfg.projection_dim)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                    * np.linalg.norm(want, axis=-1))
    assert float(cos.min()) > 0.9999


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_int8_tower_takes_the_whole_layer_exactly_at_a_ragged_batch(kernels):
    """Layers 0..N-2 run quant_layer_block when B % 4 != 0 and the two
    sub-layers when B % 4 == 0, as the JAX tower does; the last layer is
    the CLS attention and the MLP either way."""
    _p, _q, tower = _int8_tower(jax_vit.VIT_TINY, torch_vit.VIT_TINY, None)
    tower.kernels = kernels
    suffix = "" if kernels else "_plain"
    names = ("quant_layer_block", "quant_attention_block",
             "quant_attention_cls", "quant_mlp_block")
    layers = jax_vit.VIT_TINY.num_layers
    for batch, want in ((3, (layers - 1, 0, 1, 1)), (1, (layers - 1, 0, 1, 1)),
                        (4, (0, layers - 1, 1, layers))):
        spies = {n: mock.patch.object(tqm, n + suffix,
                                      wraps=getattr(tqm, n + suffix))
                 for n in names}
        with contextlib.ExitStack() as stack, torch.inference_mode():
            calls = {n: stack.enter_context(p) for n, p in spies.items()}
            tower(torch.zeros(batch, 32, 32, 3))
        assert tuple(calls[n].call_count for n in names) == want, batch


def test_quantize_vit_params_equals_jax_through_the_bridge():
    """The port quantizes a float state dict to the same int8 weights and
    scales as patent_tpu.models.vit_int8.quantize_vit_params, bit for bit,
    and from_float builds the same tower."""
    params, qparams, tower = _int8_tower(
        jax_vit.VisionConfig(**GOLDEN64), torch_vit.VisionConfig(**GOLDEN64),
        None)
    got = torch_vit_int8.quantize_vit_params(params_from_jax(params))
    want = int8_params_from_jax(qparams)
    assert set(got) == set(want) == set(tower.state_dict())
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    ftower = torch_vit.VisionTransformer(torch_vit.VisionConfig(**GOLDEN64),
                                         dtype=torch.float32)
    ftower.load_state_dict(params_from_jax(params))
    built = torch_vit_int8.Int8VisionTransformer.from_float(ftower)
    for key, value in tower.state_dict().items():
        assert torch.equal(built.state_dict()[key], value), key


def test_cpu_tensors_take_the_plain_versions(rng):
    """On the CPU the wrappers run their plain versions and count no
    launch; the tower with kernels=False gives the same features."""
    _x, xt, _j, targs = _attn_case(rng)
    counters = (tqm.quant_attention_block, tqm.quant_attention_cls,
                tqm.quant_mlp_block)
    before = [fn.launches for fn in counters]
    torch.testing.assert_close(
        tqm.quant_attention_block(xt, *targs, HEADS, VALID),
        tqm.quant_attention_block_plain(xt, *targs, HEADS, VALID),
        rtol=0, atol=0)
    _p, _q, tower = _int8_tower(jax_vit.VIT_TINY, torch_vit.VIT_TINY, None)
    px = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = tower(px)
        tower.kernels = False
        want = tower(px)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before
