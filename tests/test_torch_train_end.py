"""The joint CLIP + hyperbolic trainer (train_end) of the port held to the
JAX package on the CPU.

* Two steps of the CLI's tower (32 px, patch 8: S 17; D 64 over 4 heads;
  8 pairs) from JAX's initial tree (carried by the weight bridge, which
  round-trips in bits), the JAX step with its Pallas kernels in interpret
  mode, compiled without XLA's excess precision, and the head deterministic (an adapter in the test: dropout off on
  both sides), the port's with the plain versions of its kernels: the
  metrics of each step and the parameters after both, and the frozen
  leaves unchanged (with every block trained, as the CLI's config does,
  and with only the last one, so block 0 is frozen).
* The host stream: the batches of ``run_end_to_end_synthetic`` equal JAX's
  in bits.
* The CLI: ``train_end --device cpu`` prints JAX's metric keys, and with
  no card the default ``--device cuda`` exits 1.
"""

import dataclasses
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.cli.main import main as jax_main
from patent_tpu.models.vit import VisionConfig
from patent_tpu.train import train_end as jax_te
from patent_tpu.utils.config import EndToEndConfig as JaxConfig
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.models.vit import VisionConfig as TorchVisionConfig
from patent_tpu_torch.models.weights import (end_to_end_params_from_jax,
                                             end_to_end_params_to_jax)
from patent_tpu_torch.train import train_end as torch_te
from patent_tpu_torch.utils.config import EndToEndConfig as TorchConfig

TOWER = VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                     num_layers=2, num_heads=4, mlp_dim=128,
                     projection_dim=32)
# the port's tolerance for a training step's metrics (test_torch_finetune)
# holds both steps, but for the retrieval hinge at step 2: it is the mean of
# pos_d - neg_d + 0.1, a small difference of distances, which takes the
# noise below (step 2 starts from states it has moved apart) with the
# least cancellation.  Step 2's readings, cli / block0-frozen: clip_loss
# 1.3e-3 / 2.1e-4, hyp_loss 4.0e-4 / 4.1e-5, total_loss 6.2e-5 / 7.4e-5,
# retrieval_loss 3.9e-3 / 4.6e-4; the hinge is held at 5e-3 there
METRIC_RTOL = 3e-3
HINGE_STEP2_RTOL = 5e-3
# the head's first layer saturates at random init (the tower's features,
# of norm ~6, map onto the ball's boundary, where Möbius-adding the bias
# returns the row itself): that bias's gradient is rounding noise in both
# packages (measured 2.4e-6 here, 1.3e-7 in JAX, against its kernel's
# 1.09), which Adam turns into full steps, so its change is not compared
NOISE_LEAVES = {"hyp.encoder.first_layer.hyp_bias"}
NOISE_GRAD_RATIO = 1e-4
# after two steps: an Adam step moves an element by about ±lr (a little
# more on the second step) whatever its gradient's size, so where a small
# gradient element takes opposite signs in the two packages the parameters
# part by up to about 4 · lr of their group (lr_clip 1e-5, lr_euclidean
# 1e-3, lr_label_emb 5e-3; measured 2.3 · lr on post_ln's scale); each
# leaf's change is held to JAX's by cosine as well
PARAM_LR_MULT = 4.0
# the tower's step-1 gradients in bf16 differ from JAX's kernels' by 1.4-3.4%
# in norm; Adam turns small elements into unit steps, so (as in
# test_torch_finetune) matrices' changes agree at cosine >= 0.95 and
# vectors' at >= 0.6 (measured 0.69 on a qkv bias)
MIN_MATRIX_UPDATE_COS = 0.95
MIN_UPDATE_COS = 0.6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the host's cores: two intra-op threads
    each keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class Deterministic:
    """JAX's head applied without dropout: the step's ``deterministic=False``
    and dropout key are dropped (all rates 0)."""

    def __init__(self, hyp):
        self.hyp = hyp

    def apply(self, variables, x, deterministic=True, rngs=None):
        return self.hyp.apply(variables, x, deterministic=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_end"))
    _recs, images_dir, graph, pairs, implication = torch_te.synthetic_setup(
        path, 32)
    batches = list(torch_te.synthetic_batches(list(pairs), images_dir, graph,
                                              1, 8, 32))
    return path, graph, implication, batches


def _lr(name, cfg):
    if name.startswith("vit."):
        return cfg.lr_clip
    return cfg.lr_label_emb if ("label_emb" in name or "hyp_bias" in name) \
        else cfg.lr_euclidean


def two_steps_of(corpus, tower: VisionConfig, trainable_blocks: int):
    """(JAX metrics, port metrics, the starting tree, JAX's and the port's
    trees after two steps, trainable names, the config, the port's step-1
    gradients) of two steps at ``tower`` (32 px) on ``corpus``."""
    _path, graph, implication, batches = corpus
    jcfg = JaxConfig(batch_size=8, image_size=32, embed_dim=16,
                     trainable_blocks=trainable_blocks)
    tcfg = TorchConfig(**dataclasses.asdict(jcfg))
    label_num = graph.num_nodes - len(graph.figure_index)
    (vit, hyp), params, opt, opt_state = jax_te.init_end_to_end(
        tower, jcfg, label_num)
    start = end_to_end_params_from_jax(jax.tree.map(np.asarray, params))
    step = jax_te.make_end_to_end_step(vit, Deterministic(hyp), opt, jcfg)
    model, topt = torch_te.init_end_to_end(
        TorchVisionConfig(**dataclasses.asdict(tower)), tcfg, label_num)
    model.load_state_dict(start)
    tstep, _ = torch_te.make_end_to_end_step(model, topt, tcfg)
    model.hyp.eval()
    impl = jnp.asarray(implication)
    jm, tm = [], []
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch("patent_tpu.ops.flash_attention._on_tpu",
                       lambda: True), \
            mock.patch("patent_tpu.ops.bf16_mlp_grad._on_tpu", lambda: True):
        compiled = None
        grads = None
        for imgs, pos, neg in batches[:2]:
            args = (params, opt_state, jnp.asarray(imgs), jnp.asarray(pos),
                    jnp.asarray(neg), impl, jax.random.key(0))
            # without excess precision, XLA's CPU backend keeps the bf16
            # tower's intermediates in f32 and moves its features by ~6e-3
            compiled = compiled or step.lower(*args).compile(
                {"xla_allow_excess_precision": False})
            params, opt_state, m = compiled(*args)
            jm.append({k: float(v) for k, v in m.items()})
            tm.append({k: float(v) for k, v in tstep(
                *map(torch.from_numpy, (imgs, pos, neg, implication)))
                .items()})
            grads = grads or {n: p.grad.clone()
                              for n, p in model.named_parameters()
                              if p.grad is not None}
    trainable = {n for grp in topt.groups.values() for n in grp.params}
    return (jm, tm, start,
            end_to_end_params_from_jax(jax.tree.map(np.asarray, params)),
            model.state_dict(), trainable, tcfg, grads)


@pytest.fixture(scope="module", params=[9, 1], ids=["cli", "block0-frozen"])
def two_steps(request, corpus):
    return two_steps_of(corpus, TOWER, request.param)


def test_two_steps_metrics_match_jax(two_steps):
    jm, tm = two_steps[:2]
    for step, (js, ts) in enumerate(zip(jm, tm), 1):
        assert list(ts) == list(js) == list(torch_te.METRICS)
        for k, want in js.items():
            tol = HINGE_STEP2_RTOL if (step, k) == (2, "retrieval_loss") \
                else METRIC_RTOL
            assert ts[k] == pytest.approx(want, rel=tol), (step, k)
    assert jm[1]["total_loss"] != jm[0]["total_loss"]


def test_two_steps_params_match_jax_and_frozen_leaves_stay(two_steps):
    _jm, _tm, start, jafter, tafter, trainable, cfg, grads = two_steps
    frozen = set(start) - trainable
    assert set(grads) == trainable
    for name in NOISE_LEAVES:
        kernel = grads[name.replace("hyp_bias", "kernel")]
        assert float(grads[name].norm()) < NOISE_GRAD_RATIO * float(
            kernel.norm())
    assert "vit.patch_embed" in frozen and "hyp.label_emb" in trainable
    if cfg.trainable_blocks == 1:
        assert "vit.blocks.0.wqkv" in frozen
    for name, before in start.items():
        if name in frozen:
            assert torch.equal(tafter[name], before), name
            assert torch.equal(jafter[name], before), name
            continue
        lr = _lr(name, cfg)
        gap = float((tafter[name] - jafter[name]).abs().max())
        assert gap <= PARAM_LR_MULT * lr, (name, gap)
        if name in NOISE_LEAVES:
            continue
        dt = (tafter[name] - before).flatten()
        dj = (jafter[name] - before).flatten()
        cos = float(torch.nn.functional.cosine_similarity(dt, dj, dim=0))
        assert cos >= (MIN_MATRIX_UPDATE_COS if before.dim() == 2
                       else MIN_UPDATE_COS), (name, cos)
    # every label row stays inside the ball of radius 1 / sqrt(c)
    norms = tafter["hyp.label_emb"].norm(dim=1)
    assert float(norms.max()) < 1.0 / np.sqrt(cfg.curvature)


def test_joint_weight_bridge_round_trips_in_bits():
    (_v, _h), params, _o, _s = jax_te.init_end_to_end(
        TOWER, JaxConfig(embed_dim=16), 20)
    tree = jax.tree.map(np.asarray, params)
    sd = end_to_end_params_from_jax(tree)
    model, _opt = torch_te.init_end_to_end(
        TorchVisionConfig(**dataclasses.asdict(TOWER)),
        TorchConfig(embed_dim=16), 20)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = end_to_end_params_to_jax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        assert flat[path].tobytes() == leaf.tobytes(), path


def test_host_stream_equals_jax(corpus, tmp_path):
    """JAX's run, its step replaced by a recorder, sees the port's batches
    and implication pairs in bits (two epochs: shuffles and negatives)."""
    path, graph, implication, _b = corpus
    seen = []

    def recorder(vit, hyp, optimizer, cfg):
        def step(params, opt_state, images, pos, neg, impl, key):
            seen.append(tuple(np.asarray(a) for a in (images, pos, neg,
                                                      impl)))
            return params, opt_state, {"total_loss": jnp.zeros(())}
        return step

    with mock.patch.object(jax_te, "make_end_to_end_step", recorder):
        jax_te.run_end_to_end_synthetic(str(tmp_path), epochs=2)
    _r, images_dir, tgraph, pairs, timpl = torch_te.synthetic_setup(
        str(tmp_path), 32)
    ours = list(torch_te.synthetic_batches(pairs, images_dir, tgraph, 2, 8,
                                           32))
    assert len(ours) == len(seen) == 6
    for (imgs, pos, neg), (jimgs, jpos, jneg, jimpl) in zip(ours, seen):
        for a, b in ((imgs, jimgs), (pos, jpos), (neg, jneg),
                     (timpl, jimpl)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _metric_keys(out: str) -> list[str]:
    line = [ln for ln in out.splitlines() if ln.startswith("step ")][-1]
    return re.findall(r"(\w+)=", line)


def test_cli_train_end_prints_jax_metric_keys(tmp_path, capsys):
    """Both action names of each CLI print the same keys, in JAX's order."""
    keys = []
    for action in ("train_end", "train_end_2"):
        assert torch_main([action, "--path", str(tmp_path / action),
                           "--device", "cpu", "--epochs", "1"]) == 0
        keys.append(_metric_keys(capsys.readouterr().out))
        assert os.path.isfile(tmp_path / action / "logs" / f"{action}.jsonl")
    assert jax_main(["train_end_2", "--path", str(tmp_path / "j"),
                     "--epochs", "1"]) == 0
    assert keys[0] == keys[1] == _metric_keys(capsys.readouterr().out) == \
        list(torch_te.METRICS)


def test_cli_train_end_without_a_card_exits_1(tmp_path, capsys,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for action in ("train_end", "train_class_pro", "train"):
        assert torch_main([action, "--path", str(tmp_path)]) == 1
        assert "no CUDA card" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
