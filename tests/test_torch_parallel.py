"""The port's mesh helpers, per-host path split, data-parallel encoder and
``remat`` (patent_tpu_torch/parallel/mesh.py, input/pipeline.py,
models/vit.py), held to the JAX package on the CPU.

One world of 4 gloo ranks runs every encode (``tests/torch_worlds.py::
encode_world``, started once by a module fixture) with VIT_TINY towers
from one perturbed Flax init.  Tolerances, the towers' own:
* the sharded encode against the port's one-rank encode of the global
  batch: within 1e-6 (measured: equal in bits);
* against JAX's ``encode_sharded`` on 4 virtual devices, which on the CPU
  runs JAX's XLA fallback of each tower: min cosine above 0.999 (the bf16
  tower's gate in tests/test_torch_vit.py; measured 0.99995 bf16, 0.99974
  int8);
* the int8 tower also against JAX's one-device tower with its Pallas
  kernels interpreted (an interpreted kernel cannot run inside a sharded
  jit): min cosine above 0.9999 (tests/test_torch_int8.py's gate).
The dispatch trap: a global batch of 8 over 4 ranks is 2 rows a rank, at
which the int8 tower runs row 8 where JAX runs rows 5 + 7 on the 8; a
global batch of 12 is 3 a rank, odd, at which the bf16 tower runs the
per-op composition where JAX runs rows 1-2.  Each rank pads its block to
the global batch's function (the tower states its multiple as
``batch_multiple``); the control, the one-rank encode of each bare block,
gives the blocks' function instead.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.input.pipeline import shard_paths_per_host as jax_shard_paths
from patent_tpu.models import vit as jax_vit
from patent_tpu.models import vit_int8 as jax_vit_int8
from patent_tpu.ops import quant_matmul as jqm
from patent_tpu.parallel.mesh import encode_sharded as jax_encode_sharded
from patent_tpu.parallel.mesh import make_mesh as jax_make_mesh
from patent_tpu_torch.input.pipeline import shard_paths_per_host
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models.weights import (int8_params_from_jax,
                                             params_from_jax)
from patent_tpu_torch.parallel.launch import run_world
from patent_tpu_torch.parallel.mesh import encode_sharded, local_batch
from patent_tpu_torch.parallel.sharded_train import make_hyp_mesh
from torch_worlds import encode_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
CFG = jax_vit.VIT_TINY
BATCHES = {"b8": 8, "b6": 6, "b12": 12}


def _min_cos(a, b):
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                             * np.linalg.norm(b, axis=-1))))


@pytest.fixture(scope="module")
def weights():
    model = jax_vit.VisionTransformer(CFG, dtype=jnp.float32,
                                      fused_layer=True)
    params = model.init(jax.random.key(0), jnp.zeros(
        (1, CFG.image_size, CFG.image_size, 3)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        params)
    return params, jax_vit_int8.quantize_vit_params(params)


@pytest.fixture(scope="module")
def pixels():
    rng = np.random.default_rng(1)
    return {k: rng.standard_normal((b, CFG.image_size, CFG.image_size, 3)
                                   ).astype(np.float32)
            for k, b in BATCHES.items()}


@pytest.fixture(scope="module")
def world(weights, pixels):
    params, qparams = weights

    def host(state):
        return {k: v.numpy() for k, v in state.items()}

    cfg = dict(image_size=CFG.image_size, patch_size=CFG.patch_size,
               hidden_dim=CFG.hidden_dim, num_layers=CFG.num_layers,
               num_heads=CFG.num_heads, mlp_dim=CFG.mlp_dim,
               projection_dim=CFG.projection_dim)
    return run_world(RANKS, encode_world, "cpu", cfg,
                     host(params_from_jax({"params": params})),
                     host(int8_params_from_jax(qparams)), pixels,
                     device="cpu", timeout=600)


def test_mesh_helpers(world):
    """make_mesh puts every rank on ``data``; the row-block rules, the
    batch split and its guard."""
    assert world["mesh_shape"] == (RANKS, 1)
    assert world["names"] == ("data", "model")
    assert world["sizes"] == (RANKS, 1)
    assert world["bounds10"] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert world["rules"] == {"batch": "data", "params": None,
                              "gallery": "data"}
    assert world["table_rule"] == "model"
    assert world["shard_batch"] == [[2 * r, 2 * r + 1] for r in range(RANKS)]
    assert "does not divide" in world["shard_batch_odd"]


def test_make_hyp_mesh_validation():
    """A device count that model_dim does not divide is refused, before
    any world is asked for."""
    with pytest.raises(ValueError, match="not divisible"):
        make_hyp_mesh(7, model_dim=2)


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_shard_paths_per_host_equals_jax(hosts):
    paths = [f"img_{i:04d}.png" for i in range(31)]
    shards = [shard_paths_per_host(paths, h, hosts) for h in range(hosts)]
    assert shards == [jax_shard_paths(paths, h, hosts) for h in range(hosts)]
    assert sorted(sum(shards, [])) == paths


@pytest.mark.parametrize("b,multiple,want", [
    (8, 4, 4), (8, 2, 2), (6, 4, 2), (6, 2, 2), (12, 4, 4), (12, 2, 4),
    (7, 4, 2), (14, 4, 5), (8, 1, 2)])
def test_local_batch_keeps_the_global_dispatch(b, multiple, want):
    """The local batch divides by the dispatch multiple exactly where the
    global batch does (over 4 ranks; 14 over 4 is 4 a rank, which 4
    divides though it does not divide 14, so one zero row more)."""
    assert local_batch(b, RANKS, multiple) == want
    assert (want % multiple == 0) == (b % multiple == 0)


@pytest.mark.parametrize("tower", ["bf16", "int8"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_encode_sharded_equals_one_rank(world, tower, batch):
    got, one = world[f"{tower}_{batch}"], world[f"{tower}_{batch}_one"]
    assert got.shape == (BATCHES[batch], CFG.projection_dim)
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tower", ["bf16", "int8"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_encode_sharded_equals_jax_encode_sharded(world, weights, pixels,
                                                  tower, batch):
    params, qparams = weights
    mesh = jax_make_mesh((RANKS, 1), devices=jax.devices()[:RANKS])
    if tower == "bf16":
        enc = jax_encode_sharded(mesh, jax_vit.VisionTransformer(
            CFG, dtype=jnp.bfloat16, fused_layer=True).apply,
            {"params": params})
    else:
        enc = jax_encode_sharded(mesh, jax_vit_int8.Int8VisionTransformer(
            CFG).apply, {"params": qparams})
    want = np.asarray(enc(jnp.asarray(pixels[batch])), np.float32)
    assert _min_cos(world[f"{tower}_{batch}"], want) > 0.999


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_int8_encode_sharded_equals_jax_kernels(world, weights, pixels,
                                                monkeypatch, batch):
    _params, qparams = weights
    monkeypatch.setenv("PATENT_TPU_FAST_KERNELS", "0")
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jqm, "_on_tpu", lambda: True):
        want = np.asarray(jax_vit_int8.Int8VisionTransformer(CFG).apply(
            {"params": qparams}, jnp.asarray(pixels[batch])), np.float32)
    assert _min_cos(world[f"int8_{batch}"], want) > 0.9999


@pytest.mark.parametrize("tower,batch", [("int8", "b8"), ("int8", "b12"),
                                         ("bf16", "b12")])
def test_unpadded_blocks_take_another_function(world, tower, batch):
    """The control: encoding each rank's bare block gives what the tower
    computes at the block's batch (row 8, or the bf16 per-op
    composition), not the global batch's function, which the sharded
    encode keeps."""
    key = f"{tower}_{batch}"
    gap = np.abs(world[key + "_blocks"] - world[key + "_one"]).max()
    assert gap > 100 * np.abs(world[key] - world[key + "_one"]).max()
    assert gap > 1e-4


@pytest.mark.parametrize("tower,want", [
    ("int8", 4), ("fused-layer", 2), ("per-op", 1), ("trainable", 1)])
def test_towers_state_their_batch_multiple(tower, want):
    """Each tower states the batch multiple at which it changes function,
    which encode_sharded pads each rank's rows to keep."""
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer

    cfg = torch_vit.VisionConfig(image_size=16, patch_size=8, hidden_dim=32,
                                 num_layers=1, num_heads=2, mlp_dim=64,
                                 projection_dim=16)
    make = {"int8": lambda: Int8VisionTransformer(cfg),
            "fused-layer": lambda: torch_vit.VisionTransformer(cfg),
            "per-op": lambda: torch_vit.VisionTransformer(
                cfg, fused_layer=False),
            "trainable": lambda: torch_vit.TrainableVisionTransformer(cfg)}
    assert make[tower]().batch_multiple == want


def test_encode_sharded_refuses_an_encoder_without_batch_multiple():
    """A bare function or a wrapper does not say at which batches it
    changes function, so a rank's block could take another one."""
    with pytest.raises(TypeError, match="batch_multiple"):
        encode_sharded(None, lambda x: x)


@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["per-op", "fused-layer"])
def test_remat_keeps_outputs_and_gradients(fused_layer):
    """remat=True recomputes each layer in the backward: the forward is
    equal in bits and every gradient equal to remat=False."""
    cfg = torch_vit.VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                                 num_layers=2, num_heads=4, mlp_dim=128,
                                 projection_dim=32)
    towers = [torch_vit.VisionTransformer(
        cfg, dtype=torch.float32, fused_layer=fused_layer, remat=remat,
        generator=torch.Generator().manual_seed(0)) for remat in (False,
                                                                  True)]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    outs = [t(x) for t in towers]
    assert torch.equal(outs[0], outs[1])
    for out in outs:
        out.square().sum().backward()
    grads = [[p.grad for p in t.parameters()] for t in towers]
    assert all(g is not None for g in grads[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_parallel_imports_without_jax():
    """The parallel package, the dry run and the rank functions of
    tests/torch_worlds.py load with JAX and patent_tpu blocked (a rank
    process imports them alone)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['patent_tpu'] = None; sys.path.insert(0, 'tests'); "
            "import patent_tpu_torch.parallel, "
            "patent_tpu_torch.parallel.dryrun, torch_worlds; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
