"""The host side of patent_tpu_torch's int8 layer kernels, on the CPU: the
q scale and bias the int8 tower folds once at load time, the one workspace
a call slices, and the split-K plan of row 8's cooperative launch.

The folded vectors are held to ``fold_q_scale`` bit for bit and the state
dict to the keys that ``quantize_vit_params`` and the JAX bridge write; the
split plan's int32 partial sums, added in any order, to ``int_mm``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.models import vit as jax_vit
from patent_tpu.models import vit_int8 as jax_vit_int8
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models import vit_int8 as torch_vit_int8
from patent_tpu_torch.models.weights import int8_params_from_jax
from patent_tpu_torch.ops import quant_matmul as qm

SMALL = dict(image_size=32, patch_size=8, hidden_dim=128, num_layers=3,
             num_heads=2, mlp_dim=256, projection_dim=32)


def _float_tower(seed=0):
    """A small f32 tower whose LayerNorms and biases are perturbed, so that
    every vector matters."""
    gen = torch.Generator().manual_seed(seed)
    tower = torch_vit.VisionTransformer(torch_vit.VisionConfig(**SMALL),
                                        dtype=torch.float32, generator=gen)
    with torch.no_grad():
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    return tower


def _assert_folded(tower):
    for layer in tower.blocks:
        sq, bq = qm.fold_q_scale(layer.sqkv, layer.bqkv, layer.num_heads)
        assert torch.equal(layer.sq, sq) and torch.equal(layer.bq, bq)
        assert layer.folded() == (layer.sq, layer.bq)


def test_int8_layer_folds_the_q_scale_once_at_init_and_at_load():
    """The folded QKV scale and bias equal fold_q_scale of the layer's
    vectors bit for bit: at init (scales 1, biases 0) and after
    load_state_dict, which refolds from the loaded values."""
    tower = torch_vit_int8.Int8VisionTransformer(
        torch_vit.VisionConfig(**SMALL))
    _assert_folded(tower)
    assert not tower.blocks[0].bq.any()
    tower.load_state_dict(torch_vit_int8.quantize_vit_params(
        _float_tower().state_dict()))
    _assert_folded(tower)
    d = SMALL["hidden_dim"]
    assert not torch.equal(tower.blocks[0].sq[:d], tower.blocks[0].sqkv[:d])
    assert torch.equal(tower.blocks[0].sq[d:], tower.blocks[0].sqkv[d:])


def test_state_dict_keeps_its_keys_and_the_jax_bridge_loads():
    """The folded vectors are not in the state dict: quantize_vit_params'
    keys are exactly the tower's, both it and the JAX bridge's tree load
    strictly, and the bridge's tower folds the same vectors."""
    tower = torch_vit_int8.Int8VisionTransformer.from_float(_float_tower())
    keys = set(tower.state_dict())
    assert not any(k.endswith((".sq", ".bq")) for k in keys)
    assert keys == set(torch_vit_int8.quantize_vit_params(
        _float_tower().state_dict()))
    _assert_folded(tower)

    jcfg = jax_vit.VisionConfig(**SMALL)
    params = jax_vit.VisionTransformer(jcfg, dtype=jnp.float32,
                                       fused_layer=True).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(a.shape).astype(np.float32)),
        params)
    bridged = torch_vit_int8.Int8VisionTransformer(
        torch_vit.VisionConfig(**SMALL))
    state = int8_params_from_jax(jax_vit_int8.quantize_vit_params(params))
    assert set(state) == keys
    bridged.load_state_dict(state, strict=True)
    _assert_folded(bridged)


@pytest.mark.parametrize("batch", [3, 4], ids=["B3-whole-layer",
                                               "B4-sub-layers"])
def test_int8_tower_gives_the_same_bits_with_the_folded_vectors(
        monkeypatch, batch):
    """The tower hands each entry its layer's folded vectors; with
    kernels=False, entries that ignore them (and fold per call, as a
    public call without ``folded`` does) give the same features bit for
    bit, at the whole-layer batch (3) and the sub-layer batch (4)."""
    tower = torch_vit_int8.Int8VisionTransformer.from_float(
        _float_tower()).eval()
    tower.kernels = False
    px = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32))
    seen = []
    with torch.inference_mode():
        got = tower(px)
        for name in ("quant_attention_block_plain",
                     "quant_attention_cls_plain", "quant_layer_block_plain"):
            def unfolded(*args, _fn=getattr(qm, name), folded=None, **kw):
                seen.append(folded is not None)
                return _fn(*args, **kw)

            monkeypatch.setattr(qm, name, unfolded)
        want = tower(px)
    assert seen and all(seen)
    assert torch.equal(got, want)


# row 8's scratch: hq, hs, qkv, ao, aq, as, x1, hq2, hs2, g, gq, gs, part
def _layer_specs(m, d=768, f=3072, splits=8):
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    return (((m, d), i8), ((m,), f32), ((m, 3 * d), bf), ((m, d), f32),
            ((m, d), i8), ((m,), f32), ((m, d), f32), ((m, d), i8),
            ((m,), f32), ((m, f), f32), ((m, f), i8), ((m,), f32),
            ((splits, m, d), torch.int32))


@pytest.mark.parametrize("m", [208, 624, 197 * 3, 26624])
def test_workspace_slices_are_disjoint_and_aligned(m):
    """One allocation, sliced: every slice 16-byte aligned (the kernels'
    vector loads and TMA) and as large as its shape, none overlapping the
    next, all within the buffer."""
    specs = _layer_specs(m)
    offsets, total = qm.workspace_layout(specs)
    ends = [off + np.prod(shape) * dt.itemsize
            for (shape, dt), off in zip(specs, offsets)]
    assert all(off % 16 == 0 for off in offsets)
    assert all(end <= nxt for end, nxt in zip(ends, offsets[1:]))
    assert ends[-1] <= total
    buf, ptrs = qm.workspace("cpu", specs[:4])
    assert buf.numel() == qm.workspace_layout(specs[:4])[1]
    assert [p - buf.data_ptr() for p in ptrs] == list(offsets[:4])


SPLIT_CASES = [(208, 768, 768, 6), (624, 768, 3072, 8), (208, 2304, 768, 1),
               (40, 128, 256, 2), (300, 256, 640, 5)]

# the H100's cooperative grid for row 8 (132 SMs, a block each) and the
# most k-ranges a tile that csrc/int8_layer.cu's SPLIT_MAX allows
H100_GRID = qm.LayerGrid(blocks=132, split_max=8)


def split_units(m, n, k, splits):
    """A model of csrc/wgmma_s8.cuh's ``Units::at``, the units of an s8
    GEMM split over K: (row0, col0, first k-step, end k-step, k-range) of
    each, unit u being k-range u % splits of output tile u // splits
    (M-tiles fastest); k-range s of t steps is [s·t/splits,
    (s+1)·t/splits).  The kernel's own coverage is checked on the card
    (the cooperative launch against the chain, bit for bit)."""
    t = qm.S8_TILE
    tiles_m, tiles_n, steps = -(-m // t), -(-n // t), -(-k // t)
    units = []
    for u in range(tiles_m * tiles_n * splits):
        s, tile = u % splits, u // splits
        units.append((tile % tiles_m * t, tile // tiles_m * t,
                      s * steps // splits, (s + 1) * steps // splits, s))
    return units


@pytest.mark.parametrize("m,n,k,splits", SPLIT_CASES)
def test_split_units_cover_every_tile_and_k_step_once(m, n, k, splits):
    """Every (output tile, k-step) of the GEMM lies in exactly one unit,
    and every unit's k-range is non-empty."""
    t = qm.S8_TILE
    units = split_units(m, n, k, splits)
    seen = {}
    for m0, n0, k0, k1, s in units:
        assert 0 <= s < splits and k0 < k1
        for step in range(k0, k1):
            seen[(m0, n0, step)] = seen.get((m0, n0, step), 0) + 1
    want = {(m0, n0, step) for m0 in range(0, m, t) for n0 in range(0, n, t)
            for step in range(-(-k // t))}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("m,n,k,splits", SPLIT_CASES)
def test_split_partials_reproduce_int_mm_exactly(m, n, k, splits):
    """The int32 partial sums of the plan's k-ranges, one [M, N] slice a
    range as row 8's kernel stores them, add up to int_mm exactly, in any
    order."""
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    t = qm.S8_TILE
    part = torch.zeros(splits, m, n, dtype=torch.int32)
    for m0, n0, k0, k1, s in split_units(m, n, k, splits):
        blk = (a[m0:m0 + t, k0 * t:k1 * t].to(torch.int32)
               @ w[n0:n0 + t, k0 * t:k1 * t].to(torch.int32).T)
        part[s, m0:m0 + t, n0:n0 + t] = blk
    want = qm.int_mm(a, w)
    assert torch.equal(part.sum(0).float(), want)
    assert torch.equal(part.flip(0).cumsum(0)[-1].float(), want)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 6, 127])
def test_layer_plan_picks_the_cooperative_launch_at_a_query_batch(b):
    """At ViT-B/16 widths on the H100's grid (132 SMs, a block each): one
    cooperative launch while MLP in's tiles fit one wave of the grid (B <=
    3, a query's batch), its split GEMMs' k-ranges within their k-steps
    and the kernel's limit and their units within the grid; else the
    chain."""
    m, blocks = b * 208, H100_GRID.blocks
    plan = qm.layer_plan(m, 768, 3072, H100_GRID)
    assert plan.coop == (b <= 3)
    tiles_m = -(-m // qm.S8_TILE)
    if plan.coop:
        for split, n, k in ((plan.split_out, 768, 768),
                            (plan.split_mlp, 768, 3072)):
            assert 1 <= split <= min(k // qm.S8_TILE, H100_GRID.split_max)
            units = tiles_m * (n // qm.S8_TILE) * split
            assert units <= blocks or split == 1
    else:
        assert plan[1:] == (1, 1)
