"""The per-op modes of patent_tpu_torch's ViT tower (default einsum
attention, ``use_flash``, ``fused_block``) and the fused-layer tower at an
odd batch, held to patent_tpu on the CPU.

The JAX side runs its Pallas kernels (rows 12 and 14) in TPU interpret
mode, with ``patent_tpu.ops.flash_attention._on_tpu`` patched to True so
that ``Attention`` takes them, and the whole apply under one ``jax.jit``
with XLA's excess precision off: jitted, no eager op is dispatched while an
interpreted kernel's callbacks still run (the two can deadlock), and
without excess precision XLA rounds to bf16 after each op as eager JAX
does, which is where the Flax modules round (with it on, fused elementwise
chains skip those roundings and the jitted tower moves ~5e-3).  Weights
come from one seeded Flax init as jax arrays (numpy leaves would make
``astype`` and the q-scale fold follow numpy's promotion instead of JAX's),
perturbed so that every parameter matters, and reach the port through
``params_from_jax``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.models import vit as jax_vit
from patent_tpu.ops import bf16_layer as jax_layer
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models.weights import params_from_jax
from patent_tpu_torch.ops import bf16_layer as torch_layer

# the golden pipeline's 64 px tower (patent_tpu/retrieval/cli_actions.py)
GOLDEN64 = dict(image_size=64, patch_size=8, hidden_dim=64, num_layers=2,
                num_heads=4, mlp_dim=128, projection_dim=64)
CONFIGS = {"tiny": (jax_vit.VIT_TINY, torch_vit.VIT_TINY),
           "golden64": (jax_vit.VisionConfig(**GOLDEN64),
                        torch_vit.VisionConfig(**GOLDEN64))}
MODES = {"default": {}, "use_flash": {"use_flash": True},
         "fused_block": {"fused_block": True}}
# f32: the same function, f32 summation order; measured at most 1.5e-6.
F32_TOL = 1e-4
# bf16: the same rounding points; measured 1e-7 mean relative on most
# cases, at most 9.1e-4 where an f32 exp or sum in another order flips a
# bf16 rounding that the layers carry on.  The control (the residual
# stream rounded to bf16 between layers, as the fused-layer tower keeps
# it) is 3.7e-3 to 4.6e-3 off, and the fused-layer kernel's function at an
# odd batch 6.9e-3 to 8.5e-3: the gate sits between.
BF16_MEAN_REL = 2e-3
BF16_MIN_COS = 0.99999


def _flax_params(jcfg, seed=0):
    model = jax_vit.VisionTransformer(jcfg, dtype=jnp.float32)
    params = model.init(jax.random.key(seed), jnp.zeros(
        (1, jcfg.image_size, jcfg.image_size, 3)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float32) + 0.05 * rng.
                              standard_normal(a.shape).astype(np.float32)),
        params)


def _pixels(cfg, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _jax_apply(module, params, *args):
    """module.apply in one jit, kernels interpreted, no excess precision."""
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch("patent_tpu.ops.flash_attention._on_tpu",
                       lambda: True):
        fn = jax.jit(module.apply, compiler_options={
            "xla_allow_excess_precision": False})
        return np.asarray(fn({"params": params},
                             *map(jnp.asarray, args)), np.float32)


def _port(tcfg, params, dtype, **flags):
    model = torch_vit.VisionTransformer(tcfg, dtype=dtype, **flags)
    model.load_state_dict(params_from_jax(
        {"params": jax.tree.map(np.asarray, params)}))
    return model


def _run(model, px):
    with torch.inference_mode():
        return model(torch.from_numpy(px)).float().numpy()


def _mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _min_cosine(a, b):
    return float(np.min(np.sum(a * b, -1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))))


def _bf16_passes(got, want):
    return (_mean_rel(got, want) <= BF16_MEAN_REL
            and _min_cosine(got, want) >= BF16_MIN_COS)


def _bf16_stream_control(model, px, flags):
    """The per-op tower with its residual stream rounded to bf16 after each
    layer."""
    cfg = model.config
    with torch.inference_mode():
        x = torch_vit.layernorm_flax(
            model.tokens(torch.from_numpy(px), torch.bfloat16),
            model.pre_ln_scale, model.pre_ln_bias)
        for layer in model.blocks:
            x = torch_vit.transformer_block(x, layer, cfg.num_heads,
                                            torch.bfloat16, **flags)
            x = x.to(torch.bfloat16)
        x = torch_vit.layernorm_flax(x[:, 0], model.post_ln_scale,
                                     model.post_ln_bias)
        return (x @ model.projection.float()).numpy()


@pytest.mark.parametrize("keep", [None, 10], ids=["full", "keep10"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_per_op_tower_matches_jax_f32(name, mode, keep):
    jcfg, tcfg = CONFIGS[name]
    params = _flax_params(jcfg)
    px = _pixels(jcfg)
    want = _jax_apply(jax_vit.VisionTransformer(
        jcfg, dtype=jnp.float32, keep_tokens=keep, **MODES[mode]), params, px)
    got = _run(_port(tcfg, params, torch.float32, fused_layer=False,
                     keep_tokens=keep, **MODES[mode]), px)
    assert got.shape == (4, tcfg.projection_dim)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("keep", [None, 10], ids=["full", "keep10"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_per_op_tower_matches_jax_bf16(name, mode, keep):
    """Within the bf16 gate; the same tower with a bf16 stream fails it."""
    jcfg, tcfg = CONFIGS[name]
    params = _flax_params(jcfg)
    px = _pixels(jcfg)
    want = _jax_apply(jax_vit.VisionTransformer(
        jcfg, dtype=jnp.bfloat16, keep_tokens=keep, **MODES[mode]), params,
        px)
    model = _port(tcfg, params, torch.bfloat16, fused_layer=False,
                  keep_tokens=keep, **MODES[mode])
    got = _run(model, px)
    assert _bf16_passes(got, want), (_mean_rel(got, want),
                                     _min_cosine(got, want))
    ctrl = _bf16_stream_control(model, px, MODES[mode])
    assert not _bf16_passes(ctrl, want), _mean_rel(ctrl, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_with_causal_mask_matches_jax(dtype):
    """The text tower's masked attention: the einsum path with the mask
    added to f32 scores, whatever the kernel flags (JAX takes its kernels
    only without a mask)."""
    rng = np.random.default_rng(2)
    b, s, d, heads = 3, 16, 64, 4
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = {"qkv": {"kernel": 0.1 * rng.standard_normal((d, 3 * d)),
                 "bias": 0.1 * rng.standard_normal(3 * d)},
         "out": {"kernel": 0.1 * rng.standard_normal((d, d)),
                 "bias": 0.1 * rng.standard_normal(d)}}
    w = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), w)
    mask = np.triu(np.full((s, s), -1e9, np.float32), k=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_apply(jax_vit.Attention(heads, dtype=jdt), w, x, mask)
    args = [torch.from_numpy(np.array(a, np.float32)) for a in (
        w["qkv"]["kernel"], w["qkv"]["bias"], w["out"]["kernel"],
        w["out"]["bias"])]
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    got = torch_vit.attention(tx, *args, heads, dtype, mask=tmask)
    for flags in ({"use_flash": True}, {"fused_block": True}):
        assert torch.equal(torch_vit.attention(tx, *args, heads, dtype,
                                               mask=tmask, **flags), got)
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert _mean_rel(got, want) <= 1e-3
    unmasked = torch_vit.attention(tx, *args, heads, dtype).float().numpy()
    assert _mean_rel(unmasked, want) > 1e-2


def test_params_from_jax_serves_every_mode():
    """Every mode of the JAX tower has one param tree, and the bridge maps
    it onto the port's state dict in every mode."""
    jcfg, tcfg = CONFIGS["tiny"]
    zeros = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    trees = [jax_vit.VisionTransformer(jcfg, **flags).init(
        jax.random.key(0), zeros)["params"]
        for flags in ({}, {"use_flash": True}, {"fused_block": True},
                      {"fused_layer": True})]
    assert all(jax.tree.structure(t) == jax.tree.structure(trees[0])
               for t in trees)
    sd = params_from_jax({"params": jax.tree.map(np.asarray, trees[0])})
    for flags in ({"fused_layer": False}, {"fused_layer": False,
                                           "use_flash": True},
                  {"fused_layer": False, "fused_block": True}, {}):
        model = torch_vit.VisionTransformer(tcfg, **flags)
        assert set(model.state_dict()) == set(sd)
        model.load_state_dict(sd)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_layer_tower_at_an_odd_batch_is_jax_composition(name):
    """At B 3 the JAX fused-layer tower runs its per-op composition in
    every layer (on the TPU as well); the port's tower now does the same
    and passes the bf16 gate.  The kernel's function at B 3 (``group=1``)
    fails it: that was the port's tower before."""
    jcfg, tcfg = CONFIGS[name]
    params = _flax_params(jcfg)
    px = _pixels(jcfg, n=3)
    want = _jax_apply(jax_vit.VisionTransformer(
        jcfg, dtype=jnp.bfloat16, fused_layer=True), params, px)
    model = _port(tcfg, params, torch.bfloat16)
    got = _run(model, px)
    assert _bf16_passes(got, want), _mean_rel(got, want)
    with mock.patch.object(torch_layer, "fused_layer_block_bf16",
                           functools.partial(
                               torch_layer.fused_layer_block_bf16, group=1)), \
            mock.patch.object(torch_layer, "fused_layer_cls_bf16",
                              functools.partial(
                                  torch_layer.fused_layer_cls_bf16, group=1)):
        kernel_fn = _run(model, px)
    assert not _bf16_passes(kernel_fn, want), _mean_rel(kernel_fn, want)


D, HEADS, MLP, SP, VALID = 128, 4, 256, 64, 50
# One layer at B 3 against JAX's fallback: the same rounding points, so
# f32 summation-order noise and the bf16 roundings it flips (measured at
# most 2.3e-4 mean relative over seeds 0-3); the kernel's function is
# 4.2e-3 to 4.3e-3 off (its residual between the sub-layers stays f32, its
# softmax is divided after p·v).
LAYER_MEAN_REL = 1e-3


def _layer_case(seed, b=3):
    rng = np.random.default_rng(seed)

    def n(shape, scale, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    params = [n(D, 0.1, 1.0), n(D, 0.1), n((D, 3 * D), 0.05), n(3 * D, 0.05),
              n((D, D), 0.05), n(D, 0.05), n(D, 0.1, 1.0), n(D, 0.1),
              n((D, MLP), 0.05), n(MLP, 0.05), n((MLP, D), 0.05), n(D, 0.05)]
    x = rng.standard_normal((b, SP, D)).astype(np.float32)
    return x, params


def _jax_layer(x, params, dtype):
    fn = jax.jit(functools.partial(jax_layer.fused_layer_block_bf16,
                                   num_heads=HEADS, valid_len=VALID),
                 compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(fn(jnp.asarray(x, dtype), *map(jnp.asarray, params)),
                      np.float32)


def _torch_args(x, params, dtype):
    return (torch.from_numpy(x).to(dtype), [torch.from_numpy(p)
                                            for p in params])


@pytest.mark.parametrize("seed", range(4))
def test_layer_composition_matches_jax_fallback_and_the_kernel_does_not(
        seed):
    x, params = _layer_case(seed)
    want = _jax_layer(x, params, jnp.bfloat16)[:, :VALID]
    tx, tp = _torch_args(x, params, torch.bfloat16)
    got = torch_layer.fused_layer_block_bf16(tx, *tp, HEADS,
                                             valid_len=VALID)
    assert torch.equal(got, torch_layer.layer_composition(
        tx, *tp, HEADS, valid_len=VALID))
    assert _mean_rel(got.float().numpy()[:, :VALID], want) <= LAYER_MEAN_REL
    kernel_fn = torch_layer.fused_layer_block_bf16_plain(
        tx, *tp, HEADS, valid_len=VALID, group=1)
    assert _mean_rel(kernel_fn.float().numpy()[:, :VALID], want) \
        > LAYER_MEAN_REL


def test_layer_composition_matches_jax_fallback_f32():
    x, params = _layer_case(0)
    want = _jax_layer(x, params, jnp.float32)
    tx, tp = _torch_args(x, params, torch.float32)
    got = torch_layer.layer_composition(tx, *tp, HEADS, valid_len=VALID)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_dispatch_on_the_batch():
    """Both entries and their plain versions: the composition (and its row
    0) at an odd batch, the kernel's function at an even one, no launch
    on CPU tensors."""
    x, params = _layer_case(1, b=4)
    tx, tp = _torch_args(x, params, torch.bfloat16)
    launches = (torch_layer.fused_layer_block_bf16.launches,
                torch_layer.fused_layer_cls_bf16.launches)
    for xb in (tx[:3], tx):
        comp = torch_layer.layer_composition(xb, *tp, HEADS, valid_len=VALID)
        kern = torch_layer.fused_layer_block_bf16_plain(
            xb, *tp, HEADS, valid_len=VALID, group=1)
        want = comp if xb.shape[0] % 2 else kern
        for fn in (torch_layer.fused_layer_block_bf16,
                   torch_layer.fused_layer_block_bf16_plain):
            assert torch.equal(fn(xb, *tp, HEADS, valid_len=VALID), want)
        for fn in (torch_layer.fused_layer_cls_bf16,
                   torch_layer.fused_layer_cls_bf16_plain):
            cls = fn(xb, *tp, HEADS, valid_len=VALID)
            if xb.shape[0] % 2:
                assert torch.equal(cls, comp[:, 0])
            else:
                assert cls.shape == (4, D)
    assert (torch_layer.fused_layer_block_bf16.launches,
            torch_layer.fused_layer_cls_bf16.launches) == launches


def test_per_op_tower_on_cpu_launches_no_kernel():
    from patent_tpu_torch.ops import flash_attention as torch_fa

    jcfg, tcfg = CONFIGS["tiny"]
    params = _flax_params(jcfg)
    px = _pixels(jcfg)
    before = (torch_fa.flash_attention.launches,
              torch_fa.fused_attention_fwd.launches)
    feats = {}
    for kernels in (True, False):
        model = _port(tcfg, params, torch.bfloat16, fused_layer=False,
                      use_flash=True)
        model.kernels = kernels
        feats[kernels] = _run(model, px)
    np.testing.assert_array_equal(feats[True], feats[False])
    assert (torch_fa.flash_attention.launches,
            torch_fa.fused_attention_fwd.launches) == before
