"""The retrieval slice as a whole: the port's CLI against the JAX CLI.

One 64 px synthetic corpus and one npz ``clip_finetune_best`` checkpoint
from a seeded Flax init; ``eval --synthetic`` runs through the JAX CLI in
one directory and through the port's CLI in a copy of it.  Both encode in
bf16.  The JAX CLI runs its serving layers through the Pallas kernels of
``patent_tpu.ops.bf16_layer`` in interpret mode (what it serves with on a
TPU; on the CPU it would otherwise take the XLA fallback, which rounds
the residual stream to bf16), the port through its layers' plain
versions, which round where the CUDA kernels do.  Features agree by
cosine and the cell-3 battery agrees within the ranking flips that bf16
noise can cause on the near-duplicate corpus.  Also: the port's CLI never
loads JAX.
"""

import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.cli.main import main as jax_main
from patent_tpu.models.vit import VisionConfig, VisionTransformer
from patent_tpu.ops import bf16_layer as jax_bf16_layer
from patent_tpu.utils.checkpoint import CheckpointManager
from patent_tpu_torch.cli.main import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN64 = VisionConfig(image_size=64, patch_size=8, hidden_dim=64,
                        num_layers=2, num_heads=4, mlp_dim=128,
                        projection_dim=64)
# bf16 feature noise (min cosine ~0.99997) flips a few near-tied ranks on
# the hard corpus: measured differences are at most 0.0065 (mAP); one
# flip moves R@5 by 0.0031, so 0.01 is about three flips
METRIC_ATOL = 0.01


def _summary(path):
    with open(os.path.join(path, "results", "evaluation_results_GE.json")) as f:
        return json.load(f)["summary_metrics"]


def _index(path, tag):
    emb_dir = os.path.join(path, "embeddings")
    (prefix,) = [f[:-4] for f in os.listdir(emb_dir)
                 if f.endswith(".npy") and ("_torch" in f) == (tag == "torch")]
    with open(os.path.join(emb_dir, prefix + ".json")) as f:
        names = json.load(f)
    return np.load(os.path.join(emb_dir, prefix + ".npy")), names, prefix


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_dir = str(tmp_path_factory.mktemp("slice") / "jax")
    model = VisionTransformer(GOLDEN64, dtype=jnp.bfloat16, fused_layer=True)
    params = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    CheckpointManager(os.path.join(jax_dir, "models")).save(
        "clip_finetune_best", {"params": {"vit": params["params"]},
                               "step": 0})
    torch_dir = jax_dir + "_torch"
    shutil.copytree(jax_dir, torch_dir)
    # the layer kernels take the Pallas path off a TPU only when told to:
    # interpret mode, as tests/test_bf16_layer.py runs them
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jax_bf16_layer, "_on_tpu", lambda: True):
        assert jax_main(["eval", "--path", jax_dir, "--synthetic"]) == 0
    assert torch_main(["eval", "--path", torch_dir, "--synthetic"]) == 0
    return jax_dir, torch_dir


def test_gallery_features_match_jax(runs):
    jax_dir, torch_dir = runs
    jemb, jnames, _ = _index(jax_dir, "jax")
    temb, tnames, prefix = _index(torch_dir, "torch")
    assert [os.path.basename(n) for n in tnames] == \
        [os.path.basename(n) for n in jnames]
    assert temb.shape == jemb.shape == (160, 64)
    cos = np.sum(temb * jemb, -1) / (np.linalg.norm(temb, axis=-1)
                                     * np.linalg.norm(jemb, axis=-1))
    assert float(cos.min()) > 0.999
    assert "_torch_ft" in prefix     # backend tag + weights from the npz


def test_metric_battery_matches_jax(runs):
    jax_dir, torch_dir = runs
    want, got = _summary(jax_dir), _summary(torch_dir)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key


def test_cli_never_imports_jax(runs):
    """The port's CLI, in a fresh interpreter, runs eval on the CPU (reusing
    the saved index) without JAX in sys.modules."""
    _jax_dir, torch_dir = runs
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            f"rc = main(['eval', '--path', {torch_dir!r}, '--synthetic'])\n"
            "assert rc == 0, rc\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('JAX_FREE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_FREE_OK" in proc.stdout


@pytest.mark.parametrize("argv", [
    ["finetune"], ["serve"], ["eval", "--quantize"],
    ["eval", "--checkpoint", "/nonexistent/hf_clip"]],
    ids=["finetune", "serve", "quantize", "hf-checkpoint"])
def test_unported_surface_exits_nonzero(argv, tmp_path, capsys):
    assert torch_main(argv + ["--path", str(tmp_path)]) == 2
    assert "not yet ported to patent_tpu_torch" in capsys.readouterr().err
    assert not os.listdir(tmp_path)          # nothing was written
