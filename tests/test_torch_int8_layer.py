"""patent_tpu_torch's whole int8 layer (``quant_layer_block``), its group
dispatch (``quant_layer_group``) and the standalone int8 dense layer and
MLP (``quant_dense``, ``quant_mlp``): the plain versions, on the CPU, held
to patent_tpu's Pallas kernels.

The JAX side runs as tests/test_torch_int8.py runs rows 5 and 7: under
``force_tpu_interpret_mode`` with ``force=True``, in each of the two forms
the port computes (``fast=False`` and ``fast=True``).  Inputs come from
numpy with a fixed seed, at D 128, 4 heads, MLP 256, S 64 (50 valid).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.models import vit_int8 as jax_vit_int8
from patent_tpu.ops import quant_matmul as jqm
from patent_tpu_torch.models import vit_int8 as torch_vit_int8
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


def _ln(rng):
    return (jnp.asarray(1.0 + 0.1 * rng.standard_normal(D), jnp.float32),
            jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32))


def _stream(x):
    """The port's copy of a JAX token stream, in its dtype."""
    dtype = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
    return _t(np.asarray(x, np.float32), dtype)


def _layer_case(rng, b, dtype=jnp.bfloat16):
    """Tokens [B, S, D] (pad rows random) and one layer's 16 parameters in
    both layouts, in the order ln1, qkv, out, ln2, mlp in, mlp out."""
    x = jnp.asarray(rng.standard_normal((b, S, D)) * 0.3, dtype)
    ln1, (jqkv, tqkv), (jout, tout) = (_ln(rng), _weights(rng, D, 3 * D),
                                       _weights(rng, D, D))
    ln2, (j1, t1), (j2, t2) = (_ln(rng), _weights(rng, D, F),
                               _weights(rng, F, D))
    jargs = (*ln1, *jqkv, *jout, *ln2, *j1, *j2)
    targs = (*map(_t, ln1), *tqkv, *tout, *map(_t, ln2), *t1, *t2)
    return x, _stream(x), jargs, targs


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` in one jit without excess precision, as f32
    numpy (tests/test_torch_int8.py's reasons)."""
    return np.asarray(jax.jit(functools.partial(fn, **static),
                              compiler_options=NO_EXCESS)(*args), np.float32)


def _np(t):
    return t.float().numpy()


def _gaps(got, want):
    """(mean |got - want| / mean |want|, max |got - want| / max |want|)."""
    d = np.abs(got - want)
    return (float(d.mean() / np.abs(want).mean()),
            float(d.max() / np.abs(want).max()))


def _jax_layer(x, jargs, valid, fast=False):
    return _jit(jqm.quant_layer_block, x, *jargs, num_heads=HEADS,
                valid_len=valid, force=True, fast=fast)


def _chain_plain(xt, targs, valid, fast=False):
    """Rows 5 + 7 chained, the port's int8 tower layer before row 8: the
    mid-layer residual stored in the stream's dtype."""
    return tqm.quant_mlp_block_plain(
        tqm.quant_attention_block_plain(xt, *targs[:8], HEADS, valid,
                                        fast=fast),
        *targs[8:], fast=fast)


# Row 8's plain version against the Pallas kernel: both round at the same
# points and differ only where a LayerNorm summed in another order flips an
# int8 code, which the attention can spread over an image's rows.
# Measured on a bf16 stream over seeds 0-9 at B 1 and 3: identical in 13 of
# 20 cases, mean relative error at most 1.2e-3 (one seed; the next largest
# 1.4e-4), max 7.3e-3 of the largest |y|.  Rows 5 + 7 chained, which round
# the mid-layer residual to bf16, are 7.5e-3 to 8.1e-3 off in the mean
# (4 in 5 elements differ): the mean gate sits between the two.
LAYER_MEAN_REL, LAYER_MAX_REL = 3e-3, 2e-2


@pytest.mark.parametrize("b", [1, 3], ids=["B1", "B3"])
def test_rows_5_7_chain_is_not_row_8_on_a_bf16_stream(b):
    """The fault the port's tower had at B % 4 != 0: on a bf16 stream the
    JAX row-8 kernel keeps the residual between its sub-layers in f32, so
    the rows 5 + 7 chain computes another function.  Over seeds 0-9 the
    port's plain row 8 passes the gate above and the chain fails it."""
    for seed in range(10):
        x, xt, jargs, targs = _layer_case(np.random.default_rng(seed), b)
        want = _jax_layer(x, jargs, VALID)[:, :VALID]
        row8 = _np(tqm.quant_layer_block_plain(xt, *targs, HEADS,
                                               VALID))[:, :VALID]
        chain = _np(_chain_plain(xt, targs, VALID))[:, :VALID]
        mean, mx = _gaps(row8, want)
        assert mean <= LAYER_MEAN_REL and mx <= LAYER_MAX_REL, seed
        assert _gaps(chain, want)[0] > LAYER_MEAN_REL, seed


@FORMS
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("valid", [VALID, None], ids=["valid50", "validNone"])
@pytest.mark.parametrize("b", [1, 3], ids=["B1", "B3"])
def test_quant_layer_block_plain_matches_jax_kernel(rng, b, valid, dtype,
                                                    fast):
    """Row 8 against the Pallas kernel in the same form within the gate
    above, on the valid rows; with ``valid_len=None`` every key counts."""
    x, xt, jargs, targs = _layer_case(rng, b, dtype)
    rows = valid or S
    want = _jax_layer(x, jargs, valid, fast)[:, :rows]
    got = tqm.quant_layer_block(xt, *targs, HEADS, valid, fast=fast)
    assert got.dtype == xt.dtype and got.shape == (b, S, D)
    mean, mx = _gaps(_np(got)[:, :rows], want)
    assert mean <= LAYER_MEAN_REL and mx <= LAYER_MAX_REL


@FORMS
@pytest.mark.parametrize("b", [2, 3], ids=["B2-whole-layer", "B3-fallback"])
def test_quant_layer_group_plain_matches_jax(rng, b, fast):
    """Row 9 at group 2: at B 2 the JAX grouped whole-layer kernel, at B 3
    its ragged fallback (rows 5 + 7), each against the port's dispatch,
    which is row 8's plain version or the chain, bit for bit, in the same
    form."""
    x, xt, jargs, targs = _layer_case(rng, b)
    want = _jit(jqm.quant_layer_group, x, *jargs, num_heads=HEADS,
                valid_len=VALID, group=2, force=True, fast=fast)[:, :VALID]
    got = tqm.quant_layer_group(xt, *targs, HEADS, VALID, group=2, fast=fast)
    same = (tqm.quant_layer_block_plain(xt, *targs, HEADS, VALID, fast=fast)
            if b == 2 else _chain_plain(xt, targs, VALID, fast))
    assert torch.equal(got, same)
    mean, mx = _gaps(_np(got)[:, :VALID], want)
    assert mean <= LAYER_MEAN_REL and mx <= LAYER_MAX_REL


# (id, act, dtype, lead, n); the first four keep their earlier ids
_DENSE_CASES = [(f"{tag}{aname}-{dname}", act, dtype, lead, n)
                for tag, lead, n in (("", (3, 5), 192),
                                     ("m77-n13-", (77,), 13))
                for aname, act in (("none", None), ("gelu", "quick_gelu"))
                for dname, dtype in (("bf16", jnp.bfloat16),
                                     ("f32", jnp.float32))]


@FORMS
@pytest.mark.parametrize("act,dtype,lead,n",
                         [case[1:] for case in _DENSE_CASES],
                         ids=[case[0] for case in _DENSE_CASES])
def test_quant_dense_plain_matches_jax_kernel(rng, act, dtype, lead, n, fast):
    """Row 10 against the Pallas kernel, no bias: lead dims (3, 5) at N
    192, and a ragged M (77) at an odd N (13), which the card's epilogue
    stores a column at a time.  The same int8 codes and the same f32
    operations in the same order.  Measured: identical, but for
    quick_gelu's exp2 on an f32 output (XLA's and PyTorch's differ in the
    last bit: 1.8e-7 relative)."""
    x = jnp.asarray(rng.standard_normal((*lead, D)) * 0.5, dtype)
    (wq, s, _b), (wt, ts, _tb) = _weights(rng, D, n)
    want = _jit(jqm.quant_dense, x, wq, s, act=act, m_tile=64, force=True,
                fast=fast)
    got = tqm.quant_dense(_stream(x), wt, ts, act=act, fast=fast)
    assert got.dtype == _stream(x).dtype and got.shape == (*lead, n)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=0)


def test_int8_dense_matches_jax(rng):
    """The port's ``int8_dense`` (row 10's public entry, with a bias)
    against JAX's, bit for bit."""
    x = jnp.asarray(rng.standard_normal((4, 7, D)) * 0.5, jnp.bfloat16)
    (wq, s, b), targs = _weights(rng, D, 64)
    want = np.asarray(jax_vit_int8.int8_dense(x, wq, s, b), np.float32)
    got = torch_vit_int8.int8_dense(_stream(x), *targs)
    np.testing.assert_array_equal(_np(got), want)


def test_quant_dense_refuses_an_unknown_activation(rng):
    (_w, _s, _b), (wt, ts, tb) = _weights(rng, D, 32)
    x = torch.zeros(2, D)
    for fn in (tqm.quant_dense, tqm.quant_dense_plain):
        with pytest.raises(ValueError, match="unknown activation"):
            fn(x, wt, ts, tb, act="gelu")


@pytest.mark.parametrize(
    "dtype,lead,n",
    [(jnp.bfloat16, (3, 40), 96), (jnp.float32, (3, 40), 96),
     (jnp.bfloat16, (77,), 13), (jnp.float32, (77,), 13)],
    ids=["bf16", "f32", "bf16-m77-n13", "f32-m77-n13"])
@FORMS
def test_quant_mlp_plain_matches_jax_kernel(rng, dtype, lead, n, fast):
    """Row 11 against the Pallas kernel: dense, quick_gelu, row quantization
    of the f32 hidden, dense; also at a ragged M (77) and an odd output
    width (13), which the card's epilogue stores a column at a time.
    Measured (seeds 0, 1, 2, 42, at [3, 40] x 96): identical in bf16; on
    an f32 output 4 in 10 elements differ in their last bit (XLA rounds the
    dequant's multiply-add once), at most 2.5e-7 of the largest |y|."""
    x = jnp.asarray(rng.standard_normal((*lead, D)) * 0.5, dtype)
    (j1, t1), (j2, t2) = _weights(rng, D, F), _weights(rng, F, n)
    want = _jit(jqm.quant_mlp, x, *j1, *j2, m_tile=64, force=True,
                fast=fast)
    got = tqm.quant_mlp(_stream(x), *t1, *t2, fast=fast)
    assert got.dtype == _stream(x).dtype and got.shape == (*lead, n)
    assert _gaps(_np(got), want)[1] <= (0 if dtype == jnp.bfloat16 else 1e-6)


def test_cpu_tensors_take_the_plain_versions(rng):
    """On the CPU the four wrappers run their plain versions, bit for bit,
    and count no launch."""
    _x, xt, _j, targs = _layer_case(rng, 2)
    counters = (tqm.quant_layer_block, tqm.quant_layer_group,
                tqm.quant_dense, tqm.quant_mlp)
    before = [fn.launches for fn in counters]
    pairs = (
        (tqm.quant_layer_block(xt, *targs, HEADS, VALID),
         tqm.quant_layer_block_plain(xt, *targs, HEADS, VALID)),
        (tqm.quant_layer_group(xt, *targs, HEADS, VALID),
         tqm.quant_layer_group_plain(xt, *targs, HEADS, VALID)),
        (tqm.quant_dense(xt, *targs[2:5], act="quick_gelu"),
         tqm.quant_dense_plain(xt, *targs[2:5], act="quick_gelu")),
        (tqm.quant_mlp(xt, *targs[10:]), tqm.quant_mlp_plain(xt,
                                                             *targs[10:])))
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before
