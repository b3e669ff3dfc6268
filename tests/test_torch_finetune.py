"""The fine-tune slice as a whole: the port's trainer held to the JAX one.

* Two steps from the same weights (a seeded Flax init carried across by
  the weight bridge) on the same u8 batches and node indices, the JAX
  step with its Pallas kernels in interpret mode, the port's with the
  plain versions of its kernels: the metrics of each step, the gradients
  of step 1 and the parameter change after step 2.
* Pad rows of the attention sub-layer's token stream get no cotangent and
  change no gradient; the weight bridge carries the whole fine-tune tree
  both ways.
* The CLI: ``finetune --device cpu`` in a fresh interpreter writes a
  checkpoint that the port's ``eval`` and the JAX CLI's ``eval`` both
  serve, with features that agree, and loads no JAX; a graph-embedding
  pickle that matches no anchor is refused, as the JAX CLI refuses it.
"""

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.cli.main import main as jax_main
from patent_tpu.losses import graph_alignment_cosine as jax_align
from patent_tpu.losses import multi_positive_nt_xent as jax_nt_xent
from patent_tpu.models.vit import VisionConfig
from patent_tpu.ops import bf16_layer as jax_bf16_layer
from patent_tpu.train import finetune_clip as jax_ft
from patent_tpu.utils.config import ClipFinetuneConfig as JaxConfig
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.models.vit import VisionConfig as TorchVisionConfig
from patent_tpu_torch.models.weights import params_from_jax, params_to_jax
from patent_tpu_torch.ops import flash_attention as torch_fa
from patent_tpu_torch.ops.bf16_mlp_grad import fused_mlp_block_bf16
from patent_tpu_torch.train import finetune_clip as torch_ft
from patent_tpu_torch.utils.config import ClipFinetuneConfig as TorchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY64 = VisionConfig(image_size=64, patch_size=8, hidden_dim=64,
                      num_layers=2, num_heads=4, mlp_dim=128,
                      projection_dim=64)
PAIRS = 4
ALPHA = 0.02
# Measured here: metrics within 8e-4 relative.  The step-1 gradients of a
# random tower in bf16 are noisy: JAX's own XLA fallback and its Pallas
# kernels differ by up to 16% (relative to the largest value) on this very
# case; the port differs from the Pallas kernels by at most 4.6% in norm
# on every tensor leaf and 13% on the scalar logit_scale (a sum of
# cancelling terms).  Two AdamW steps turn small gradients into unit
# steps, so the parameter changes agree at cosine >= 0.95 on every matrix
# but only 0.67 on the qkv bias.
METRIC_RTOL = 3e-3
GRAD_TOL = 0.1
SCALAR_GRAD_TOL = 0.25
MIN_UPDATE_COS = 0.6
MIN_MATRIX_UPDATE_COS = 0.95


def _jax_grads(vit, head, params, images, nodes, alpha):
    """JAX's step-1 gradients: the loss of ``make_finetune_step``."""
    from patent_tpu.input.pipeline import device_normalize

    def loss_fn(p):
        feats = vit.apply({"params": p["vit"]}, device_normalize(images))
        z, g, scale = head.apply({"params": p["head"]}, feats, nodes)
        ce = jax_nt_xent(z, scale)
        align = jax_align(z[:nodes.shape[0]], g)
        return (1.0 - alpha) * ce + alpha * align

    return jax.grad(loss_fn)(params)


def two_steps_of(tower: VisionConfig, excess_precision: bool = True):
    """(JAX metrics, port metrics, JAX grads, port grads, JAX params
    before and after, port state dicts before and after, trainable
    names) of two steps at ``tower``.  ``excess_precision=False`` compiles
    JAX's step as tests/test_torch_train_end.py does: XLA's CPU backend
    otherwise keeps the bf16 tower's intermediates in f32 where the port
    rounds them, and at D 144-160 that alone moves step 1's cross loss by
    2.5-2.8e-3 (1.0e-4-1.0e-3 without it)."""
    rng = np.random.default_rng(0)
    vgae = rng.standard_normal((10, 32)).astype(np.float32)
    (vit, head), params, opt, opt_state = jax_ft.init_finetune_state(
        tower, JaxConfig(batch_size=PAIRS), vgae, seed=0)
    step, _ = jax_ft.make_finetune_step(vit, head, opt,
                                        JaxConfig(batch_size=PAIRS))
    model, topt = torch_ft.init_finetune_state(
        TorchVisionConfig(**dataclasses.asdict(tower)),
        TorchConfig(batch_size=PAIRS), vgae)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tstep, _ = torch_ft.make_finetune_step(model, topt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jbefore = params_from_jax(jax.tree.map(np.asarray, params))
    px = tower.image_size
    batches = [(rng.integers(0, 256, (2 * PAIRS, px, px, 3), dtype=np.uint8),
                rng.integers(0, 10, PAIRS).astype(np.int32))
               for _ in range(2)]
    jm, tm = [], []
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch("patent_tpu.ops.flash_attention._on_tpu",
                       lambda: True), \
            mock.patch("patent_tpu.ops.bf16_mlp_grad._on_tpu", lambda: True):
        jgrads = params_from_jax(jax.tree.map(np.asarray, _jax_grads(
            vit, head, params, jnp.asarray(batches[0][0]),
            jnp.asarray(batches[0][1]), ALPHA)))
        if not excess_precision:
            step = step.lower(params, opt_state, jnp.asarray(batches[0][0]),
                              jnp.asarray(batches[0][1]), ALPHA).compile(
                {"xla_allow_excess_precision": False})
        for i, (images, nodes) in enumerate(batches):
            params, opt_state, m = step(params, opt_state,
                                        jnp.asarray(images),
                                        jnp.asarray(nodes), ALPHA)
            jm.append({k: float(v) for k, v in m.items()})
            tm.append({k: float(v) for k, v in tstep(
                torch.from_numpy(images), torch.from_numpy(nodes),
                ALPHA).items()})
            if i == 0:
                tgrads = {k: p.grad.clone() for k, p in
                          model.named_parameters() if p.grad is not None}
    trainable = {k for k, p in model.named_parameters() if p.requires_grad}
    return (jm, tm, jgrads, tgrads, jbefore,
            params_from_jax(jax.tree.map(np.asarray, params)), before,
            model.state_dict(), trainable)


@pytest.fixture(scope="module")
def two_steps():
    return two_steps_of(TINY64)


def test_two_steps_metrics_match_jax(two_steps):
    jm, tm = two_steps[:2]
    for jstep, tstep in zip(jm, tm):
        assert set(tstep) == set(jstep) == {"loss", "cross_loss",
                                            "align_loss", "tau"}
        for k, want in jstep.items():
            assert tstep[k] == pytest.approx(want, rel=METRIC_RTOL), k
    # the second step sees the first's update
    assert jm[1]["tau"] != jm[0]["tau"] and tm[1]["tau"] != tm[0]["tau"]


def test_step_one_gradients_match_jax(two_steps):
    jgrads, tgrads, trainable = two_steps[2], two_steps[3], two_steps[8]
    assert set(tgrads) == trainable
    for name in sorted(trainable):
        want, got = jgrads[name], tgrads[name]
        err = float((got - want).norm() / (want.norm() + 1e-12))
        assert err <= (GRAD_TOL if want.numel() > 1 else SCALAR_GRAD_TOL), \
            (name, err)


def test_two_step_updates_match_jax_and_frozen_leaves_stay(two_steps):
    jbefore, jafter, before, after, trainable = two_steps[4:]
    assert trainable and set(before) - trainable      # both kinds exist
    for name in before:
        if name not in trainable:
            assert torch.equal(after[name], before[name]), name
            assert torch.equal(jafter[name], jbefore[name]), name
            continue
        dt = (after[name] - before[name]).flatten()
        dj = (jafter[name] - jbefore[name]).flatten()
        cos = float(F.cosine_similarity(dt, dj, dim=0))
        assert cos >= (MIN_MATRIX_UPDATE_COS if before[name].dim() == 2
                       else MIN_UPDATE_COS), (name, cos)


def test_pad_rows_get_no_cotangent_and_change_no_gradient():
    """The attention sub-layer pads S = 13 to 16 per call: the pad rows'
    cotangent is exactly 0, and pad content (zeros or junk) leaves every
    gradient bit for bit the same."""
    rng = np.random.default_rng(1)
    b, s, d, heads = 2, 13, 128, 2
    weights = [torch.from_numpy(a).to(torch.bfloat16) for a in (
        rng.standard_normal((d, 3 * d)) * d ** -0.5,
        rng.standard_normal(3 * d) * 0.2,
        rng.standard_normal((d, d)) * d ** -0.5,
        rng.standard_normal(d) * 0.1)]
    scale2 = np.log2(np.e) / np.sqrt(d // heads)
    wqkv_f = torch.cat([weights[0][:, :d] * scale2, weights[0][:, d:]], 1)
    bqkv_f = torch.cat([weights[1][:d] * scale2, weights[1][d:]])
    x = torch.from_numpy(rng.standard_normal((b, s, d))).to(torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal((b, s, d))).float()
    grads = []
    for pad in (torch.zeros(b, 3, d),
                torch.from_numpy(5 * rng.standard_normal((b, 3, d)))):
        xp = torch.cat([x, pad.to(torch.bfloat16)], 1).requires_grad_(True)
        ws = [t.clone().requires_grad_(True)
              for t in (wqkv_f, bqkv_f, weights[2], weights[3])]
        out = torch_fa._FusedAttentionBlock.apply(xp, *ws, heads, s, False)
        (out[:, :s].float() * cot).sum().backward()
        assert torch.equal(xp.grad[:, s:], torch.zeros_like(xp.grad[:, s:]))
        grads.append([xp.grad[:, :s]] + [t.grad for t in ws])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_mlp_block_takes_any_row_count():
    """The MLP block runs on the unpadded B·197-style row count: 3 × 13
    rows give the same rows as 1 × 13 three times."""
    rng = np.random.default_rng(2)
    d, f = 64, 128
    x = torch.from_numpy(rng.standard_normal((3, 13, d))).to(torch.bfloat16)
    p = [torch.from_numpy(a).float() for a in (
        1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, f)) / 8, 0.1 * rng.standard_normal(f),
        rng.standard_normal((f, d)) / 11, 0.1 * rng.standard_normal(d))]
    whole = fused_mlp_block_bf16(x, *p)
    for i in range(3):
        assert torch.equal(whole[i], fused_mlp_block_bf16(x[i], *p))


def test_weights_both_ways_for_the_whole_finetune_tree():
    rng = np.random.default_rng(3)
    vgae = rng.standard_normal((7, 16)).astype(np.float32)
    (_vit, _head), params, _opt, _st = jax_ft.init_finetune_state(
        TINY64, JaxConfig(), vgae, seed=1)
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree)
    assert any(k.startswith("head.img_proj") for k in sd)
    back = params_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    model, _o = torch_ft.init_finetune_state(
        TorchVisionConfig(**dataclasses.asdict(TINY64)), TorchConfig(),
        vgae)
    model.load_state_dict(sd)
    again = params_from_jax(params_to_jax(model.state_dict()))
    assert set(again) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def _features(path, tag):
    emb_dir = os.path.join(path, "embeddings")
    (prefix,) = [f[:-4] for f in os.listdir(emb_dir)
                 if f.endswith(".npy") and ("_torch" in f) == (tag == "torch")]
    return np.load(os.path.join(emb_dir, prefix + ".npy")), prefix


def test_cli_finetune_then_both_clis_serve_the_checkpoint(tmp_path):
    """``finetune --device cpu --epochs 1`` in a fresh interpreter, with
    no JAX module loaded; then ``eval`` through the port's CLI and the JAX
    CLI (its serving kernels in interpret mode) on copies of the
    directory: gallery features within the retrieval slice's bound
    (tests/test_torch_pipeline.py) and the metric battery within its
    METRIC_ATOL."""
    torch_dir = str(tmp_path / "ft")
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            f"rc = main(['finetune', '--path', {torch_dir!r}, '--device',\n"
            "           'cpu', '--epochs', '1'])\n"
            "assert rc == 0, rc\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "pkg = [m for m in sys.modules if m == 'patent_tpu'\n"
            "       or m.startswith('patent_tpu.')]\n"
            "assert not pkg, pkg\n"
            "print('JAX_FREE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_FREE_OK" in proc.stdout
    ckpt = os.path.join(torch_dir, "models", "clip_finetune_best")
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "metadata.json",
                                        "state.npz"]
    with open(os.path.join(ckpt, "metadata.json")) as f:
        assert np.isfinite(json.load(f)["val_loss"])

    jax_dir = str(tmp_path / "jax")
    shutil.copytree(torch_dir, jax_dir)
    assert torch_main(["eval", "--path", torch_dir, "--synthetic",
                       "--device", "cpu"]) == 0
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jax_bf16_layer, "_on_tpu", lambda: True):
        assert jax_main(["eval", "--path", jax_dir, "--synthetic"]) == 0
    temb, tprefix = _features(torch_dir, "torch")
    jemb, _jprefix = _features(jax_dir, "jax")
    assert "_torch_ft" in tprefix
    assert temb.shape == jemb.shape == (160, 64)
    cos = np.sum(temb * jemb, -1) / (np.linalg.norm(temb, axis=-1)
                                     * np.linalg.norm(jemb, axis=-1))
    assert float(cos.min()) > 0.999
    summaries = []
    for path in (torch_dir, jax_dir):
        with open(os.path.join(path, "results",
                               "evaluation_results_GE.json")) as f:
            summaries.append(json.load(f)["summary_metrics"])
    for key, want in summaries[1].items():
        assert summaries[0][key] == pytest.approx(want, abs=0.01), key


@pytest.mark.parametrize("keys,matched", [
    (["not-a-figure.png"], False), (None, True)], ids=["stale", "matching"])
def test_graph_embedding_pickle_matching(tmp_path, capsys, keys, matched):
    """A pickle of another corpus (no anchor among its keys) is refused
    and the run goes on with a random table, as the JAX CLI does; a
    matching one aligns the anchors to its rows."""
    path = tmp_path / "run"
    from patent_tpu_torch.data.synthetic import synthetic_metadata

    names = [m["subfigure_file"] for m in synthetic_metadata(16, 3, 0)]
    ge = {k: np.ones(8, np.float32) * i
          for i, k in enumerate(keys or names)}
    os.makedirs(path / "graph_embeddings")
    with open(path / "graph_embeddings" / "ge.pkl", "wb") as f:
        pickle.dump(ge, f)
    assert torch_main(["finetune", "--path", str(path), "--device", "cpu",
                       "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    if matched:
        assert "aligned to 48 exported graph embeddings" in out
    else:
        assert "matches 0/48 anchors" in out
        assert "training WITHOUT graph alignment" in out
    assert os.path.isdir(path / "models" / "clip_finetune_best")


def test_finetune_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    """``finetune`` with the default ``--device cuda`` and no card fails
    with its message and writes nothing: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_main(["finetune", "--path", str(tmp_path), "--epochs",
                       "1"]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
