"""patent_tpu_torch.ops.flash_attention.flash_attention (TPU row 14) held to
patent_tpu's Pallas kernel on the CPU.

The same numpy q, k, v [B, S, H, D] go to the port's plain version and to
JAX's ``flash_attention(force=True)`` under TPU interpret mode, both of
its tilings (``head_batch``), at the tower's S 197 (padded to 200 inside
JAX) and at S 16, head_dim 64 and 16, and at S 1 and 17, where the f32
CUDA kernel's key tile and query block have their edges.  The CUDA kernel is held to the
same plain version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu_torch.ops import flash_attention as tfa

# patent_tpu.ops exports a function of the same name as this module
jfa = importlib.import_module("patent_tpu.ops.flash_attention")

B, H = 2, 3
# f32: the same function with the denominator summed in another order (JAX
# takes it from the p·[v | valid] product): measured at most 5.1e-7.
F32_TOL = 1e-5
# bf16: the same bf16 q and p on both sides and f32 sums in another order,
# which now and then flips the output's last rounding.  Measured at most
# 0.25 ulp (bf16 ulps at the largest |output|) and a mean relative error
# of 5.7e-7; JAX's off-TPU einsum is 1 ulp and 2.8e-3 off, so it fails
# on the mean.
BF16_MAX_ULPS = 1.0
BF16_MEAN_REL = 1e-3


def _qkv(s, d, seed=0, gain=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, H, d)).astype(np.float32)
               for _ in range(3))
    return q * np.float32(gain), k, v


def _ulps(got, want):
    """max |got - want| in bf16 ulps at the largest |want| (an output near
    0 carries the f32 rounding of its terms, not of itself)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.max(np.abs(got - want)) / ulp)


def _mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _jax(q, k, v, dtype, head_batch):
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                                  force=True, head_batch=head_batch)
    return np.asarray(out, np.float32)


def _port(q, k, v, dtype, head_batch=True, **controls):
    """The port's entry on CPU tensors, or its plain version with
    ``controls``."""
    fn = tfa.flash_attention_plain if controls else tfa.flash_attention
    out = fn(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)), head_batch,
             **controls)
    assert out.dtype == dtype
    return out.float().numpy()


def _bf16_passes(got, want):
    return (_ulps(got, want) <= BF16_MAX_ULPS
            and _mean_rel(got, want) <= BF16_MEAN_REL)


@pytest.mark.parametrize("head_batch", [True, False], ids=["headbatch", "bh"])
@pytest.mark.parametrize("s,d", [(197, 64), (197, 16), (16, 64), (16, 16),
                                 (1, 64), (17, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_pallas_interpret(dtype, s, d, head_batch):
    q, k, v = _qkv(s, d, seed=s + d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax(q, k, v, jdt, head_batch)
    got = _port(q, k, v, dtype, head_batch)
    assert got.shape == (B, s, H, d)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert _bf16_passes(got, want), (_ulps(got, want),
                                         _mean_rel(got, want))


def test_xla_einsum_fallback_fails_the_bf16_gate():
    """JAX's off-TPU ``flash_attention`` (a max-subtracted softmax,
    normalized before its rounding to bf16) is another function: at the
    tower's S 197 it is several ulps from the kernel's."""
    q, k, v = _qkv(197, 64, seed=3)
    want = _jax(q, k, v, jnp.bfloat16, True)
    fallback = np.asarray(jfa.flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))), np.float32)
    assert _bf16_passes(_port(q, k, v, torch.bfloat16), want)
    assert not _bf16_passes(fallback, want), (_ulps(fallback, want),
                                              _mean_rel(fallback, want))


def test_scores_past_the_clamp_match_and_the_controls_do_not():
    """q x 40 drives ~8% of the scores past +80 (the exp2 domain): the
    plain version still equals the kernel's clamped function, and the
    three controls that chip_smoke.py holds against the CUDA kernel (the
    padding's keys counted, q unscaled, the clamp dropped) fail its
    gates."""
    q, k, v = _qkv(197, 64, seed=5, gain=40.0)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * np.log2(np.e) / 8.0
    assert 0.0 < float((s > 80.0).mean()) < 0.5
    want = _jax(q, k, v, jnp.float32, True)
    # p reaches 2^80 here: hold the error at the output's scale
    tol = F32_TOL * np.abs(want).max()
    assert np.abs(_port(q, k, v, torch.float32) - want).max() <= tol
    no_clamp = _port(q, k, v, torch.float32, clamp=False)
    assert not np.abs(no_clamp - want).max() <= tol
    q, k, v = _qkv(197, 64, seed=6)
    want = _jax(q, k, v, jnp.bfloat16, True)
    for kw in ({"pad_keys_to": 208}, {"scale": False}):
        ctrl = _port(q, k, v, torch.bfloat16, **kw)
        assert not _bf16_passes(ctrl, want), kw


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(16, 64))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v))
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v,
                                                      head_batch=False))
    assert tfa.flash_attention.launches == before
