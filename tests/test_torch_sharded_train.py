"""The port's sharded train_hyp and fine-tune steps
(patent_tpu_torch/parallel/sharded_train.py, train/finetune_clip.py) over
worlds of 4 gloo ranks on the CPU, held to the port's one-process steps
and to JAX's sharded steps on 4 devices of the virtual mesh, and the dry
run.

The train_hyp step runs at model_dim 1 (data 4) and 2 (data 2 x model 2)
with an odd label table (padded to 2 at model_dim 2), in
tests/test_torch_hyp_train.py's one-step setting (the CLI's synthetic
corpus, 40 patents x 4 figures, 64 features scaled by ``FEATURE_SCALE`` =
0.1; a batch of 32, embed 16, c 2), one world for every case.
Tolerances:
* against the one-process port step: the loss within 1e-6 relative, the
  other metrics within 1e-5 relative (measured 2.1e-7), every updated
  leaf within ``LEAF_ATOL`` = 1e-7 (measured 1.5e-8: the gradients summed
  in another order), padded rows exactly 0;
* against JAX's ``make_sharded_train_step``: tests/test_torch_hyp_train.py's
  one-step tolerances (metrics 1e-5 relative, updated params within
  ``STEP_ATOL`` x lr);
* dropout on: every rank draws the global batch's masks from the one
  seeded generator, so the sharded step equals the one-process step with
  the same seed within the same tolerances.
The fine-tune step runs at data 2 x model 2 with 21 graph nodes (padded to
22), 8 pairs of 16 px images: against the port's one-process step, two
steps' metrics within 1e-5 relative (measured: equal) and every updated
leaf within ``FT_LEAF_ATOL`` = 2 x lr_clip = 4e-5 (measured 2.5e-5, on the
last block's MLP-out matrix: bf16 products over other batch splits leave
gradient components near zero of either sign, and two AdamW steps turn
each into ±lr_clip); against JAX's sharded step (its XLA fallback on the
CPU), the metrics within tests/test_torch_finetune.py's ``METRIC_RTOL`` =
3e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.models.hyperbolic import HyperbolicEmbeddingModel
from patent_tpu.models.vit import VisionConfig
from patent_tpu.parallel.sharded_train import (make_hyp_mesh,
                                               make_sharded_train_step,
                                               pad_label_table,
                                               shard_hyp_state)
from patent_tpu.train import finetune_clip as jax_ft
from patent_tpu.train.optim import manifold_mask, riemannian_adam
from patent_tpu.train import train_hyp as jax_th
from patent_tpu.utils.config import ClipFinetuneConfig, HypTrainConfig
from patent_tpu_torch.models.weights import (hyperbolic_params_from_jax,
                                             params_from_jax)
from patent_tpu_torch.parallel.dryrun import dryrun_multichip
from patent_tpu_torch.parallel.launch import run_world
from torch_worlds import finetune_world, hyp_train_world
from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data
from patent_tpu_torch.train.train_hyp import METRICS

RANKS = 4
FEATURE_SCALE = 0.1
STEP_ATOL = 1e-4
METRIC_RTOL = 3e-3
LEAF_ATOL = 1e-7
FT_LEAF_ATOL = 4e-5
LR = HypTrainConfig().learning_rate   # the one-step test runs the default
CASES = (("md1", 1, False), ("md2", 2, False), ("drop", 2, True))
# tests/test_torch_hyp_train.py's one-step setting (``_step_cfgs``)
HYP_CFG = dict(embed_dim=16, hidden_dims=(32,), curvature=2.0, batch_size=32,
               learning_rate=LR)
VC = dict(image_size=16, patch_size=8, hidden_dim=16, num_layers=2,
          num_heads=2, mlp_dim=32, projection_dim=16)
FT_CFG = dict(batch_size=8, image_size=16, trainable_blocks=1,
              graph_proj_dim=8, keep_tokens=None)
ALPHA = 0.5


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _hyp_model(label_num):
    return dict(feature_dim=64, embed_dim=16, label_num=label_num,
                hidden_dims=(32,), c=2.0)


@pytest.fixture(scope="module")
def hyp(tmp_path_factory):
    td = ensure_training_data(str(tmp_path_factory.mktemp("td")), True)
    td = dataclasses.replace(td, x_figures=td.x_figures
                             * np.float32(FEATURE_SCALE))
    label_num = td.num_labels | 1   # odd: model_dim 2 must pad
    model = HyperbolicEmbeddingModel(**_hyp_model(label_num))
    params = model.init(jax.random.key(0), jnp.zeros((1, 64)))["params"]
    packed = jax_th.PackedSupervision(td)
    arrays = tuple(a[0] for a in jax_th.stack_epoch_batches(
        packed, np.arange(len(packed.usable)), 32, 1,
        np.random.default_rng(0)))
    data = {"x_figures": td.x_figures, "implication": td.implication,
            "exclusion": np.zeros((0, 2), np.int32), "batch": arrays}
    state = {k: v.numpy() for k, v in
             hyperbolic_params_from_jax(_tree(params)).items()}
    out = run_world(RANKS, hyp_train_world, "cpu", data, state,
                    _hyp_model(label_num), HYP_CFG, CASES, device="cpu",
                    timeout=600)
    return td, params, arrays, label_num, out


@pytest.mark.parametrize("case", ["md1", "md2", "drop"])
def test_sharded_hyp_step_equals_one_process(hyp, case):
    *_rest, label_num, out = hyp
    res = out[case]
    single, sharded = res["single"], res["sharded"]
    assert sharded[0] == pytest.approx(single[0], rel=1e-6)   # total_loss
    for name, a, b in zip(METRICS, sharded, single):
        assert a == pytest.approx(b, rel=1e-5), name
    real, padded = res["real"], res["padded"]
    assert real == label_num
    model_dim = {"md1": 1, "md2": 2, "drop": 2}[case]
    assert padded == -(-real // model_dim) * model_dim
    assert res["block_rows"] == [padded // model_dim] * RANKS
    for k, want in res["single_params"].items():
        got = res["sharded_params"][k]
        if k == "label_emb":
            np.testing.assert_array_equal(got[real:], 0.0)
            got = got[:real]
        np.testing.assert_allclose(got, want, rtol=0, atol=LEAF_ATOL,
                                   err_msg=k)
    if case == "drop":      # dropout changed the step
        assert res["single"][0] != out["md2"]["single"][0]


@pytest.mark.parametrize("case", ["md1", "md2"])
def test_sharded_hyp_step_equals_jax_sharded(hyp, eight_devices, case):
    td, params, arrays, label_num, out = hyp
    model_dim = {"md1": 1, "md2": 2}[case]
    cfg = HypTrainConfig(**HYP_CFG, use_dropout=False)
    optimizer = riemannian_adam(LR, c=2.0, mask=manifold_mask(params))
    mesh = make_hyp_mesh(RANKS, model_dim=model_dim,
                         devices=eight_devices[:RANKS])
    pp, po, real, padded = pad_label_table(params, optimizer.init(params),
                                           model_dim)
    model_p = HyperbolicEmbeddingModel(**_hyp_model(padded))
    step, place_batch, place_static = make_sharded_train_step(
        mesh, model_p, optimizer, cfg, num_real_labels=real)
    sp, so = shard_hyp_state(mesh, pp, po)
    sx, simp, sexc = place_static(td.x_figures, td.implication,
                                  np.zeros((0, 2), np.int32))
    new, _s, metrics = step(sp, so, place_batch(arrays), jax.random.key(0),
                            sx, simp, sexc)
    res = out[case]
    for i, name in enumerate(METRICS):
        if name in metrics:
            assert res["sharded"][i] == pytest.approx(
                float(metrics[name]), rel=1e-5), name
    want = hyperbolic_params_from_jax(_tree(new))
    for k, w in want.items():
        np.testing.assert_allclose(res["sharded_params"][k], w.numpy(),
                                   rtol=0, atol=STEP_ATOL * LR, err_msg=k)


def test_unpadded_table_refused(hyp):
    assert "pad_label_table" in hyp[-1]["refused"]


@pytest.fixture(scope="module")
def finetune():
    cfg = ClipFinetuneConfig(**FT_CFG)
    rng = np.random.default_rng(0)
    vgae = rng.standard_normal((21, 12)).astype(np.float32)   # 21 % 2 != 0
    (vit, head), params, optimizer, opt_state = jax_ft.init_finetune_state(
        VisionConfig(**VC), cfg, vgae, seed=0)
    images = rng.random((16, 16, 16, 3), np.float32)
    node_idx = rng.integers(0, 21, 8).astype(np.int32)
    state = {k: v.numpy() for k, v in params_from_jax(_tree(params)).items()}
    out = run_world(RANKS, finetune_world, "cpu", VC, FT_CFG, vgae, state,
                    images, node_idx, ALPHA, 2, 2, device="cpu", timeout=600)
    return (vit, head, params, optimizer, opt_state, images, node_idx), out


def test_sharded_finetune_step_equals_one_process(finetune):
    _jax, out = finetune
    assert out["real"] == 21 and out["padded"] == 22
    assert out["block_rows"] == [11] * RANKS
    for got, want in zip(out["sharded"], out["single"]):
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-5), k
    for k, v in out["eval"].items():
        assert v == pytest.approx(out["single"][0][k], rel=1e-5), k
    for k, want in out["single_params"].items():
        got = out["sharded_params"][k]
        if k == "head.graph_embedding":
            np.testing.assert_array_equal(got[21:], 0.0)
            got = got[:21]
        np.testing.assert_allclose(got, want, rtol=0, atol=FT_LEAF_ATOL,
                                   err_msg=k)


def test_sharded_finetune_step_equals_jax_sharded(finetune, eight_devices):
    (vit, head, params, optimizer, opt_state, images, node_idx), out = \
        finetune
    mesh = make_hyp_mesh(RANKS, model_dim=2, devices=eight_devices[:RANKS])
    pp, po, real, padded = jax_ft.pad_graph_table(params, opt_state, 2)
    head_p = jax_ft.AlignmentHead(num_nodes=padded, graph_dim=8, proj_dim=8,
                                  init_tau=head.init_tau)
    step, _ev, place = jax_ft.make_sharded_finetune_step(
        mesh, vit, head_p, optimizer, ClipFinetuneConfig(**FT_CFG))
    sp, so = jax_ft.shard_finetune_state(mesh, pp, po)
    si, sn = place(images, node_idx)
    for got in out["sharded"]:
        sp, so, m = step(sp, so, si, sn, ALPHA)
        for k, v in got.items():
            assert v == pytest.approx(float(m[k]), rel=METRIC_RTOL), k


def test_finetune_batch_guard(finetune):
    assert "must divide the data axis" in finetune[1]["guard"]


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """The dry run of __graft_entry__.py, every check in its order, over 4
    gloo ranks; it prints one line."""
    dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): e2e loss=")
    assert line.endswith("— OK")
