"""patent_tpu_torch ViT tower, weight bridge and checkpoint reader held to
patent_tpu on the CPU.

The JAX tower runs ``VisionTransformer(fused_layer=True)``, which on the
CPU is the XLA per-op fallback at every batch (on the TPU only at an odd
one); the port runs its layers' plain versions, which compute that
fallback only at an odd batch and the TPU kernel's function at an even one.
Weights come from one seeded Flax init (biases and LayerNorms perturbed so
that every parameter matters) mapped with ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.models import vit as jax_vit
from patent_tpu.utils.checkpoint import CheckpointManager
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models.weights import params_from_jax, params_to_jax
from patent_tpu_torch.utils import checkpoint as torch_ckpt

# the golden pipeline's 64 px tower (patent_tpu/retrieval/cli_actions.py)
GOLDEN64 = dict(image_size=64, patch_size=8, hidden_dim=64, num_layers=2,
                num_heads=4, mlp_dim=128, projection_dim=64)
CONFIGS = {"tiny": (jax_vit.VIT_TINY, torch_vit.VIT_TINY),
           "golden64": (jax_vit.VisionConfig(**GOLDEN64),
                        torch_vit.VisionConfig(**GOLDEN64))}


def _flax_params(jcfg, seed=0):
    model = jax_vit.VisionTransformer(jcfg, dtype=jnp.float32,
                                      fused_layer=True)
    params = model.init(jax.random.key(seed), jnp.zeros(
        (1, jcfg.image_size, jcfg.image_size, 3)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        params)


def _pixels(cfg, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _features(jcfg, tcfg, params, px, dtype, keep=None):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jax_vit.VisionTransformer(jcfg, dtype=jdt, fused_layer=True,
                                       keep_tokens=keep)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(px)),
                      np.float32)
    tmodel = torch_vit.VisionTransformer(tcfg, dtype=dtype, keep_tokens=keep)
    tmodel.load_state_dict(params_from_jax({"params": params}))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(px)).float().numpy()
    return got, want


def _min_cosine(a, b):
    return float(np.min(np.sum(a * b, -1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("keep", [None, 10], ids=["full", "keep10"])
def test_tower_matches_jax_f32(name, keep):
    """f32 towers: the same function, so features agree to ~1e-4 max-abs
    (f32 noise through a few layers); keep_tokens prunes the same
    patches in both."""
    jcfg, tcfg = CONFIGS[name]
    params = _flax_params(jcfg)
    got, want = _features(jcfg, tcfg, params, _pixels(jcfg), torch.float32,
                          keep)
    assert got.shape == (4, tcfg.projection_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tower_matches_jax_bf16(name):
    """bf16 towers at B 4 round at different points (the port runs the
    kernel's function, which carries the residual in f32 inside each
    layer; the JAX fallback on the CPU keeps it in bf16): cosine > 0.999.
    At an odd batch the port computes the fallback too
    (tests/test_torch_vit_modes.py)."""
    jcfg, tcfg = CONFIGS[name]
    params = _flax_params(jcfg)
    got, want = _features(jcfg, tcfg, params, _pixels(jcfg), torch.bfloat16)
    assert _min_cosine(got, want) > 0.999


def test_ink_topk_indices_match_jax():
    px = _pixels(jax_vit.VIT_TINY, n=6, seed=5)
    px[0, :8, :8] = 0.0                       # equal-brightness patches
    px[0, 8:16, :8] = 0.0
    want = np.asarray(jax_vit.ink_topk_indices(jnp.asarray(px), 8, 7))
    got = torch_vit.ink_topk_indices(torch.from_numpy(px), 8, 7).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_bridge_round_trips():
    params = _flax_params(jax_vit.VIT_TINY)
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    sd = params_from_jax({"params": params})
    model = torch_vit.VisionTransformer(torch_vit.VIT_TINY)
    assert set(sd) == set(model.state_dict())
    assert sd["patch_embed"].shape == (64, 3, 8, 8)


def test_checkpoint_interchanges_with_jax(tmp_path):
    """The port writes and reads the JAX npz checkpoint layout."""
    params = _flax_params(jax_vit.VIT_TINY)
    state = {"params": {"vit": params}, "step": 3}
    CheckpointManager(str(tmp_path / "j")).save("clip_finetune_best", state)
    got = torch_ckpt.restore(str(tmp_path / "j"), "clip_finetune_best")
    assert int(got["step"]) == 3
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(state["params"])):
        np.testing.assert_array_equal(a, b)
    torch_ckpt.save(str(tmp_path / "t"), "clip_finetune_best", state)
    back = CheckpointManager(str(tmp_path / "t")).restore(
        "clip_finetune_best")
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)
