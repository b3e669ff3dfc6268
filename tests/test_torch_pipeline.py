"""The retrieval slice as a whole: the port's CLI against the JAX CLI.

One 64 px synthetic corpus and one npz ``clip_finetune_best`` checkpoint
from a seeded Flax init; ``eval --synthetic`` runs through the JAX CLI in
one directory and through the port's CLI (``--device cpu``) in a copy of
it, once with the bf16 tower and once with ``--quantize``.  The JAX CLI
runs its serving layers through its Pallas kernels in interpret mode (what
it serves with on a TPU; on the CPU it would otherwise take the XLA
fallbacks): ``patent_tpu.ops.bf16_layer`` for bf16, and
``patent_tpu.ops.quant_matmul`` in the exact-division form
(PATENT_TPU_FAST_KERNELS=0) for int8.  The port runs its layers' plain
versions, which round where the CUDA kernels do.  Features agree by
cosine and the cell-3 battery agrees within the ranking flips that
rounding noise can cause on the near-duplicate corpus.  Also: the port's
CLI never loads JAX or any module of ``patent_tpu``, fails rather than
fall back when asked for a card it does not have, and resolves
``--profile``.
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
from patent_tpu.ops import quant_matmul as jax_quant_matmul
from patent_tpu.utils.checkpoint import CheckpointManager
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.cli.main import parse_args

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


def _slice_runs(root, quantize: bool):
    """``eval --synthetic`` through the JAX CLI in ``root``/jax and the
    port's in ``root``/jax_torch, from one seeded checkpoint."""
    jax_dir = str(root / "jax")
    model = VisionTransformer(GOLDEN64, dtype=jnp.bfloat16, fused_layer=True)
    params = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    CheckpointManager(os.path.join(jax_dir, "models")).save(
        "clip_finetune_best", {"params": {"vit": params["params"]},
                               "step": 0})
    torch_dir = jax_dir + "_torch"
    shutil.copytree(jax_dir, torch_dir)
    flags = ["--quantize"] if quantize else []
    # the serving kernels take the Pallas path off a TPU only when told
    # to: interpret mode, as tests/test_bf16_layer.py and
    # tests/test_quant_matmul.py run them
    kernels = jax_quant_matmul if quantize else jax_bf16_layer
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(kernels, "_on_tpu", lambda: True), \
            mock.patch.dict(os.environ, {"PATENT_TPU_FAST_KERNELS": "0"}):
        assert jax_main(["eval", "--path", jax_dir, "--synthetic"]
                        + flags) == 0
    assert torch_main(["eval", "--path", torch_dir, "--synthetic",
                       "--device", "cpu"] + flags) == 0
    return jax_dir, torch_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _slice_runs(tmp_path_factory.mktemp("slice"), quantize=False)


@pytest.fixture(scope="module")
def runs_int8(tmp_path_factory):
    return _slice_runs(tmp_path_factory.mktemp("slice_int8"), quantize=True)


def _min_cosine(a, b):
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                             * np.linalg.norm(b, axis=-1))))


def test_gallery_features_match_jax(runs):
    jax_dir, torch_dir = runs
    jemb, jnames, _ = _index(jax_dir, "jax")
    temb, tnames, prefix = _index(torch_dir, "torch")
    assert [os.path.basename(n) for n in tnames] == \
        [os.path.basename(n) for n in jnames]
    assert temb.shape == jemb.shape == (160, 64)
    assert _min_cosine(temb, jemb) > 0.999
    assert "_torch_ft" in prefix     # backend tag + weights from the npz


def test_int8_gallery_features_match_jax(runs_int8):
    """The int8 towers quantize the same f32 weights to the same codes and
    round alike; LayerNorm and f32 dots summed in another order flip a few
    int8 codes, which the layers carry on: min feature cosine 0.99987
    measured, held above 0.999 (the bf16 bound).  The battery below then
    differs by at most 0.0094 (measured), within METRIC_ATOL."""
    jax_dir, torch_dir = runs_int8
    jemb, jnames, jprefix = _index(jax_dir, "jax")
    temb, tnames, prefix = _index(torch_dir, "torch")
    assert [os.path.basename(n) for n in tnames] == \
        [os.path.basename(n) for n in jnames]
    assert temb.shape == jemb.shape == (160, 64)
    assert _min_cosine(temb, jemb) > 0.999
    assert "_int8_" in jprefix and "_torch_int8_ft" in prefix


def test_int8_metric_battery_matches_jax(runs_int8):
    jax_dir, torch_dir = runs_int8
    want, got = _summary(jax_dir), _summary(torch_dir)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key


def test_metric_battery_matches_jax(runs):
    jax_dir, torch_dir = runs
    want, got = _summary(jax_dir), _summary(torch_dir)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key


def test_cli_never_imports_jax(runs):
    """The port's CLI, in a fresh interpreter, runs eval on the CPU with
    the bf16 tower (reusing the saved index) and the int8 tower without
    JAX or any module of the JAX package in sys.modules."""
    _jax_dir, torch_dir = runs
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            "for flags in ([], ['--quantize']):\n"
            f"    rc = main(['eval', '--path', {torch_dir!r}, '--synthetic',\n"
            "               '--device', 'cpu', '--model', 'nojax'] + flags)\n"
            "    assert rc == 0, (flags, rc)\n"
            "    assert 'jax' not in sys.modules, 'jax was imported'\n"
            "    pkg = [m for m in sys.modules if m == 'patent_tpu'\n"
            "           or m.startswith('patent_tpu.')]\n"
            "    assert not pkg, pkg\n"
            "print('JAX_FREE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_FREE_OK" in proc.stdout


@pytest.mark.parametrize("argv", [
    ["finetune", "--checkpoint", "/nonexistent/hf_clip"],
    ["train_end", "--checkpoint", "/nonexistent/hf_clip"],
    ["train_gcn", "--checkpoint", "/nonexistent/hf_clip"],
    ["eval", "--checkpoint", "/nonexistent/hf_clip"], ["bench"]],
    ids=["finetune", "train_end", "train_gcn", "hf-checkpoint", "bench"])
def test_unported_surface_exits_nonzero(argv, tmp_path, capsys):
    """What the port does not run yet: HF CLIP checkpoint directories (for
    every action that would load a tower's weights from one) and
    ``bench``."""
    assert torch_main(argv + ["--path", str(tmp_path)]) == 2
    assert "not yet ported to patent_tpu_torch" in capsys.readouterr().err
    assert not os.listdir(tmp_path)          # nothing was written


@pytest.mark.parametrize("action,flags", [("eval", []),
                                          ("eval", ["--quantize"]),
                                          ("serve", ["--port", "0"])],
                         ids=["bf16", "int8", "serve"])
def test_device_cuda_without_a_card_exits_nonzero(action, flags, tmp_path,
                                                  capsys, monkeypatch):
    """``--device cuda`` (the default) with no card fails with a message
    and writes nothing: there is no silent CPU run."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["--device", "cuda"]):
        rc = torch_main([action, "--path", str(tmp_path), "--synthetic"]
                        + device + flags)
        assert rc != 0
        assert "no CUDA card" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv,quantize,keep", [
    (["--profile", "exact"], True, None),
    (["--profile", "recommended"], True, 175),
    (["--profile", "turbo"], True, 127),
    (["--profile", "turbo", "--keep-tokens", "150"], True, 150),
    (["--quantize"], True, None),
    ([], False, None)],
    ids=["exact", "recommended", "turbo", "explicit-wins", "quantize",
         "none"])
def test_profile_sets_quantize_and_keep_tokens(argv, quantize, keep):
    args = parse_args(["eval"] + argv)
    assert (args.quantize, args.keep_tokens) == (quantize, keep)
    assert args.device == "cuda"
