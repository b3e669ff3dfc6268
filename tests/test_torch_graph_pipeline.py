"""The reference's composed pipeline on the port: train_class_pro (GCN pair
classification and the graph-embedding export) → finetune (CLIP with graph
alignment, reading that export) → eval (the retrieval.ipynb cell-3
battery), at tests/test_pipeline_golden.py's sizes.

* The port's CLI alone, in a fresh interpreter with no JAX module loaded,
  runs the chain on the CPU and its finetune aligns to its own export.
* The same chain from JAX's initial weights (the GCN's and the fine-tune's,
  carried by the weight bridges; the GCN classifier's dropout off on both
  sides, a Flax attribute in the test) gives exported embeddings close to
  JAX's chain's and a battery within METRIC_ATOL of it; JAX's kernels run
  in interpret mode.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.cli.main import main as jax_main
from patent_tpu.models import gcn as jax_gcn
from patent_tpu.models.vit import VisionConfig as JaxVisionConfig
from patent_tpu.train import finetune_clip as jax_ft
from patent_tpu.train import train_gcn as jax_train_gcn
from patent_tpu.utils.config import ClipFinetuneConfig as JaxFtConfig
from patent_tpu.utils.config import GCNTrainConfig as JaxGCNConfig
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.models import gcn as torch_gcn
from patent_tpu_torch.models.weights import (gcn_variables_from_jax,
                                             params_from_jax)
from patent_tpu_torch.train import finetune_clip as torch_ft
from patent_tpu_torch.train import train_gcn as torch_train_gcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_pipeline.py's bound on the cell-3 battery
METRIC_ATOL = 0.01
# the exported unit rows after 3 epochs (tests/test_torch_graph.py's gate)
EMB_MIN_COS = 0.9999
STEPS = (["train_class_pro", "--epochs", "3"], ["finetune", "--epochs", "2"],
         ["eval", "--synthetic"])


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the host's cores: two intra-op threads
    each keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _battery(path: str) -> dict:
    with open(os.path.join(path, "results",
                           "evaluation_results_GE.json")) as f:
        return json.load(f)["summary_metrics"]


def _embeddings(path: str) -> dict:
    with open(os.path.join(path, "graph_embeddings",
                           "image_ge_embeddings_GE.pkl"), "rb") as f:
        return pickle.load(f)


def test_port_cli_alone_runs_the_composed_pipeline(tmp_path):
    root = str(tmp_path / "run")
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            f"for step in {STEPS!r}:\n"
            f"    rc = main(step[:1] + ['--path', {root!r}, '--device',\n"
            "                          'cpu'] + step[1:])\n"
            "    assert rc == 0, (step, rc)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "pkg = [m for m in sys.modules if m == 'patent_tpu'\n"
            "       or m.startswith('patent_tpu.')]\n"
            "assert not pkg, pkg\n"
            "print('JAX_FREE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_FREE_OK" in proc.stdout
    assert "graph embeddings -> " in proc.stdout
    # finetune read the export train_class_pro wrote
    assert "exported graph embeddings from" in proc.stdout
    emb = _embeddings(root)
    assert len(emb) == 160
    battery = _battery(root)
    assert battery and all(0.0 <= float(v) <= 1.0 for k, v in battery.items()
                           if k != "num_missing_rankings")


class NoDropoutVGAE(jax_gcn.EnhancedVGAE):
    dropout_rate: float = 0.0


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """(JAX's run directory, the port's), each chain from JAX's initial
    weights."""
    base = tmp_path_factory.mktemp("chains")
    jdir, tdir = str(base / "jax"), str(base / "torch")
    interpret = (pltpu.force_tpu_interpret_mode(),
                 mock.patch("patent_tpu.ops.flash_attention._on_tpu",
                            lambda: True),
                 mock.patch("patent_tpu.ops.bf16_mlp_grad._on_tpu",
                            lambda: True),
                 mock.patch("patent_tpu.ops.bf16_layer._on_tpu",
                            lambda: True),
                 mock.patch.object(jax_train_gcn, "EnhancedVGAE",
                                   NoDropoutVGAE))
    for cm in interpret:
        cm.__enter__()
    try:
        for step in STEPS:
            assert jax_main(step[:1] + ["--path", jdir] + step[1:]) == 0
    finally:
        for cm in reversed(interpret):
            cm.__exit__(None, None, None)

    train_pairs = torch_train_gcn.train_pair_classification

    def gcn_from_jax(x, adjacency, pairs, labels, cfg, **kw):
        jcfg = JaxGCNConfig(**dataclasses.asdict(cfg))
        a = jax_train_gcn.prepare_adjacency(adjacency, jcfg.adjacency)
        p0 = pairs[:min(len(pairs), jcfg.batch_size)]
        init = NoDropoutVGAE(hidden_dim=jcfg.hidden_dim,
                             latent_dim=jcfg.latent_dim,
                             num_layers=jcfg.num_layers).init(
            jax.random.key(jcfg.seed), x, a, p0,
            method=jax_gcn.EnhancedVGAE.encode_and_classify)
        start = gcn_variables_from_jax(jax.tree.map(np.asarray, init))
        model_cls = torch_gcn.EnhancedVGAE

        def from_jax(*args, **kwargs):
            model = model_cls(*args, **{**kwargs, "dropout_rate": 0.0})
            model.load_state_dict(start)
            return model

        with mock.patch.object(torch_train_gcn, "EnhancedVGAE", from_jax):
            return train_pairs(x, adjacency, pairs, labels, cfg, **kw)

    init_ft = torch_ft.init_finetune_state

    def finetune_from_jax(vision_config, cfg, vgae_matrix, seed=0,
                          device="cpu"):
        model, opt = init_ft(vision_config, cfg, vgae_matrix, seed, device)
        _m, params, _o, _s = jax_ft.init_finetune_state(
            JaxVisionConfig(**dataclasses.asdict(vision_config)),
            JaxFtConfig(**dataclasses.asdict(cfg)), vgae_matrix, seed=seed)
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
        return model, opt

    with mock.patch.object(torch_train_gcn, "train_pair_classification",
                           gcn_from_jax), \
            mock.patch.object(torch_ft, "init_finetune_state",
                              finetune_from_jax):
        for step in STEPS:
            assert torch_main(step[:1] + ["--path", tdir, "--device", "cpu"]
                              + step[1:]) == 0
    return jdir, tdir


def test_chain_exports_match_jax(chains):
    jemb, temb = (_embeddings(p) for p in chains)
    assert list(temb) == list(jemb)
    got = np.stack([temb[k] for k in jemb])
    want = np.stack([np.asarray(jemb[k]) for k in jemb])
    assert float((got * want).sum(1).min()) >= EMB_MIN_COS


def test_chain_battery_matches_jax(chains):
    want, got = (_battery(p) for p in chains)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key
