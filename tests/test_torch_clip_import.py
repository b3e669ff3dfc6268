"""HF CLIP checkpoints in the port (models/clip_import.py), held to
``transformers.CLIPModel`` and to patent_tpu on the CPU.

A random-init ``CLIPModel`` (tests/test_clip_parity.py's small config,
then the CLI's 64 px config) is saved with ``save_pretrained`` as
safetensors and as ``pytorch_model.bin``.  The port reads the weight file
itself, so the loaders also run with ``transformers`` and ``safetensors``
blocked; the towers they feed are held to ``get_image_features`` /
``get_text_features`` and to JAX's loaders and towers.  Then the CLI:
``eval --checkpoint DIR`` against the JAX CLI's, the refusals, the weights
tag, and ``finetune --checkpoint DIR``'s starting tower.
"""

import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig,  # noqa: E402
                          CLIPVisionConfig)

from patent_tpu.models import vit as jax_vit  # noqa: E402
from patent_tpu_torch.models import clip_import as ci  # noqa: E402
from patent_tpu_torch.models import vit as torch_vit  # noqa: E402
from patent_tpu_torch.models.vit_int8 import \
    Int8VisionTransformer  # noqa: E402

VISION = dict(image_size=32, patch_size=8, hidden_dim=64, num_layers=2,
              num_heads=4, mlp_dim=128, projection_dim=32)
TEXT = dict(vocab_size=128, context_length=16, hidden_dim=64, num_layers=2,
            num_heads=4, mlp_dim=128, projection_dim=32)
# the CLI's tower for a 64 px corpus (retrieval/cli_actions.py)
CLI_VISION = dict(image_size=64, patch_size=8, hidden_dim=64, num_layers=2,
                  num_heads=4, mlp_dim=128, projection_dim=64)
# against HF: another implementation of the same f32 function (measured
# 5e-7 vision, 1.5e-6 text); against JAX the same conversion
HF_ATOL, JAX_ATOL = 1e-4, 1e-5


def _clip(vision: dict, text: dict = TEXT, seed: int = 0) -> CLIPModel:
    cfg = CLIPConfig(
        vision_config=CLIPVisionConfig(
            image_size=vision["image_size"], patch_size=vision["patch_size"],
            hidden_size=vision["hidden_dim"],
            num_hidden_layers=vision["num_layers"],
            num_attention_heads=vision["num_heads"],
            intermediate_size=vision["mlp_dim"],
            projection_dim=vision["projection_dim"]).to_dict(),
        text_config=CLIPTextConfig(
            vocab_size=text["vocab_size"],
            max_position_embeddings=text["context_length"],
            hidden_size=text["hidden_dim"],
            num_hidden_layers=text["num_layers"],
            num_attention_heads=text["num_heads"],
            intermediate_size=text["mlp_dim"],
            projection_dim=vision["projection_dim"],
            eos_token_id=text["vocab_size"] - 1,
            bos_token_id=text["vocab_size"] - 2, pad_token_id=0).to_dict(),
        projection_dim=vision["projection_dim"])
    torch.manual_seed(seed)
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(model, safetensors dir, .bin dir)."""
    model = _clip(VISION)
    st = tmp_path_factory.mktemp("hf_st")
    model.save_pretrained(st)
    pt = tmp_path_factory.mktemp("hf_bin")
    model.save_pretrained(pt, safe_serialization=False)
    assert os.path.isfile(st / ci.SAFETENSORS_FILE)
    assert os.path.isfile(pt / ci.TORCH_FILE)
    return model, str(st), str(pt)


def _pixels(n, size, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _ids(vocab, length, batch):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab - 2, size=(batch, length))
    for row in range(batch):
        eos = 3 + row % (length - 3)
        ids[row, eos] = vocab - 1
        ids[row, eos + 1:] = 0
    return ids


def _image_features(model, px):
    with torch.no_grad():
        return model.get_image_features(
            pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2)).numpy()


def _port_vision(state, cfg=VISION):
    tower = torch_vit.VisionTransformer(torch_vit.VisionConfig(**cfg),
                                        dtype=torch.float32,
                                        fused_layer=False)
    tower.load_state_dict(state)
    return tower.eval()


def _run(tower, x):
    with torch.no_grad():
        return tower(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_read_hf_state_dict_equals_the_reference_readers(saved, fmt):
    model, st, pt = saved
    if fmt == "safetensors":
        from safetensors.torch import load_file

        want = load_file(os.path.join(st, ci.SAFETENSORS_FILE))
        got = ci.read_hf_state_dict(st)
    else:
        want = torch.load(os.path.join(pt, ci.TORCH_FILE), weights_only=True)
        got = ci.read_hf_state_dict(pt)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v), k


def test_safetensors_dtypes_and_unaligned_offsets(tmp_path):
    """F32, F16, BF16 and integer tensors behind buffers of odd lengths
    (offsets that are not multiples of an element) read back in bits."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a_u8": torch.randint(0, 255, (3,), generator=g,
                                     dtype=torch.uint8),
               "b_f32": torch.randn(5, 7, generator=g),
               "c_bf16": torch.randn(3, 3, generator=g).bfloat16(),
               "d_f16": torch.randn(11, generator=g).half(),
               "e_i64": torch.arange(7),
               "f_empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / ci.SAFETENSORS_FILE),
              metadata={"format": "pt"})
    got = ci.read_hf_state_dict(str(tmp_path))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_unreadable_directories_raise_naming_them(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        ci.read_hf_state_dict(str(tmp_path))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    with pytest.raises(ValueError, match=f"{tmp_path}.*sharded"):
        ci.load_hf_clip_params(str(tmp_path))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_vision_tower_from_hf_matches_clip_and_jax(saved, fmt):
    model, st, pt = saved
    where = st if fmt == "safetensors" else pt
    state = ci.load_hf_clip_params(where, torch_vit.VisionConfig(**VISION))
    px = _pixels(4, 32)
    got = _run(_port_vision(state), px)
    np.testing.assert_allclose(got, _image_features(model, px), atol=HF_ATOL,
                               rtol=0)
    jcfg = jax_vit.VisionConfig(**VISION)
    jparams = jax_vit.load_hf_clip_params(st, jcfg)
    want = np.asarray(jax_vit.VisionTransformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(px)))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    # the converted tree equals JAX's leaf for leaf
    from patent_tpu_torch.models.weights import params_to_jax

    ours = params_to_jax(state)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = ours
        for p in path:
            node = node[p.key]
        assert np.array_equal(node, np.asarray(leaf)), path


def test_text_tower_from_hf_matches_clip_and_jax(saved):
    model, st, _pt = saved
    state = ci.load_hf_clip_text_params(st, torch_vit.TextConfig(**TEXT))
    tower = torch_vit.TextTransformer(torch_vit.TextConfig(**TEXT))
    tower.load_state_dict(state)
    ids = _ids(TEXT["vocab_size"], TEXT["context_length"], 5)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
        want = model.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=0)
    jcfg = jax_vit.TextConfig(**TEXT)
    jparams = jax_vit.load_hf_clip_text_params(st, jcfg)
    jwant = np.asarray(jax_vit.TextTransformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(ids.astype(np.int32))))
    np.testing.assert_allclose(got, jwant, atol=JAX_ATOL, rtol=0)


def test_int8_tower_from_hf_weights_stays_close_to_clip(saved):
    model, st, _pt = saved
    state = ci.load_hf_clip_params(st, torch_vit.VisionConfig(**VISION))
    tower = Int8VisionTransformer.from_float(_port_vision(state))
    px = _pixels(4, 32)
    got, want = _run(tower, px), _image_features(model, px)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                    * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.99, cos


def test_export_round_trip_through_clip_model_load_state_dict():
    """Port weights → HF entries → ``CLIPModel.load_state_dict`` give the
    port's features, image and text, and the inverse converters give the
    port's state dicts back in bits."""
    vcfg, tcfg = torch_vit.VisionConfig(**VISION), torch_vit.TextConfig(
        **TEXT)
    g = torch.Generator().manual_seed(7)
    vision = torch_vit.VisionTransformer(vcfg, dtype=torch.float32,
                                         fused_layer=False, generator=g)
    text = torch_vit.TextTransformer(tcfg, generator=g)
    sd = ci.hf_clip_vision_state_dict(vision.state_dict(), vcfg)
    sd.update(ci.hf_clip_text_state_dict(text.state_dict(), tcfg))
    model = _clip(VISION, seed=1)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and missing == ["logit_scale"]
    px = _pixels(3, 32, seed=2)
    np.testing.assert_allclose(_image_features(model, px), _run(vision, px),
                               atol=HF_ATOL, rtol=0)
    ids = torch.from_numpy(_ids(TEXT["vocab_size"], 16, 4))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.get_text_features(input_ids=ids).numpy(),
            text(ids).numpy(), atol=HF_ATOL, rtol=0)
    for back, want in ((ci.hf_clip_vision_params(sd, vcfg),
                        vision.state_dict()),
                       (ci.hf_clip_text_params(sd, tcfg), text.state_dict())):
        assert set(back) == set(want)
        assert all(torch.equal(back[k], want[k]) for k in want)


def test_loaders_run_without_transformers_and_safetensors(saved,
                                                          monkeypatch):
    _model, st, pt = saved
    want = ci.load_hf_clip_params(st, torch_vit.VisionConfig(**VISION))
    for name in ("transformers", "safetensors", "safetensors.torch"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import transformers  # noqa: F401
    for where in (st, pt):
        got = ci.load_hf_clip_params(where, torch_vit.VisionConfig(**VISION))
        assert all(torch.equal(got[k], want[k]) for k in want)
        text = ci.load_hf_clip_text_params(where, torch_vit.TextConfig(
            **TEXT))
        assert text["token_embedding"].shape == (128, 64)


# ------------------------------------------------------------------ CLI
METRIC_ATOL = 0.01


def _summary(path):
    import json

    with open(os.path.join(path, "results",
                           "evaluation_results_GE.json")) as f:
        return json.load(f)["summary_metrics"]


def _index(path, torch_side: bool):
    import json

    emb_dir = os.path.join(path, "embeddings")
    (prefix,) = [f[:-4] for f in os.listdir(emb_dir)
                 if f.endswith(".npy") and ("_torch" in f) == torch_side]
    with open(os.path.join(emb_dir, prefix + ".json")) as f:
        names = json.load(f)
    return np.load(os.path.join(emb_dir, prefix + ".npy")), names, prefix


@pytest.fixture(scope="module")
def cli_checkpoint(tmp_path_factory):
    """An HF directory in the CLI's config holding the seeded Flax weights
    of tests/test_torch_pipeline.py (``jax.random.key(0)``), exported by
    JAX's ``hf_clip_vision_state_dict`` into a ``CLIPModel`` and saved with
    ``save_pretrained``.  HF's own init is far narrower: it puts every
    gallery feature of the near-duplicate corpus within cosine ~0.99 of
    the others, where the bf16 towers' rounding noise (feature cosine
    0.99999 between the packages) reorders enough near-ties to move
    Recall@5 by 0.019."""
    d = tmp_path_factory.mktemp("hf_cli")
    jcfg = jax_vit.VisionConfig(**CLI_VISION)
    params = jax_vit.VisionTransformer(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    model = _clip(CLI_VISION, seed=3)
    sd = jax_vit.hf_clip_vision_state_dict(params, jcfg)
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=False)
    assert not unexpected
    model.save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("flags", [[], ["--quantize"]], ids=["bf16", "int8"])
def test_cli_eval_checkpoint_matches_jax_cli(cli_checkpoint, tmp_path_factory,
                                             flags):
    """``eval --synthetic --checkpoint DIR`` through the JAX CLI (its layer
    kernels interpreted, the int8 ones in their exact-division form, as
    tests/test_torch_pipeline.py runs them) and through the port's on the
    CPU: gallery features and the battery."""
    from jax.experimental.pallas import tpu as pltpu

    from patent_tpu.cli.main import main as jax_main
    from patent_tpu.ops import bf16_layer as jax_bf16_layer
    from patent_tpu.ops import quant_matmul as jax_quant_matmul
    from patent_tpu_torch.cli.main import main as torch_main

    root = tmp_path_factory.mktemp("cli")
    jax_dir, torch_dir = str(root / "jax"), str(root / "jax_torch")
    kernels = jax_quant_matmul if flags else jax_bf16_layer
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(kernels, "_on_tpu", lambda: True), \
            mock.patch.dict(os.environ, {"PATENT_TPU_FAST_KERNELS": "0"}):
        assert jax_main(["eval", "--path", jax_dir, "--synthetic",
                         "--checkpoint", cli_checkpoint] + flags) == 0
    assert torch_main(["eval", "--path", torch_dir, "--synthetic",
                       "--device", "cpu", "--checkpoint",
                       cli_checkpoint] + flags) == 0
    jemb, jnames, _ = _index(jax_dir, False)
    temb, tnames, prefix = _index(torch_dir, True)
    assert [os.path.basename(n) for n in tnames] == \
        [os.path.basename(n) for n in jnames]
    assert temb.shape == jemb.shape == (160, 64)
    cos = np.sum(temb * jemb, -1) / (np.linalg.norm(temb, axis=-1)
                                     * np.linalg.norm(jemb, axis=-1))
    assert cos.min() > 0.999
    assert ("_torch_int8_hf" if flags else "_torch_hf") in prefix
    want, got = _summary(jax_dir), _summary(torch_dir)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=METRIC_ATOL), key


def test_cli_checkpoint_not_a_directory_raises(tmp_path):
    from patent_tpu_torch.cli.main import parse_args
    from patent_tpu_torch.retrieval.cli_actions import _build_encoder

    args = parse_args(["eval", "--path", str(tmp_path), "--device", "cpu",
                       "--checkpoint", str(tmp_path / "nowhere")])
    with pytest.raises(ValueError, match="not a local directory"):
        _build_encoder(args, 64, torch.device("cpu"))


def test_cli_weights_tag_follows_the_file_bytes(cli_checkpoint, tmp_path):
    """The tag hashes the weight file's bytes: a copy elsewhere, later,
    keeps it; other weights change it."""
    from patent_tpu_torch.cli.main import parse_args
    from patent_tpu_torch.retrieval.cli_actions import _build_encoder

    def tag(where):
        args = parse_args(["eval", "--path", str(tmp_path), "--device",
                           "cpu", "--checkpoint", where])
        return _build_encoder(args, 64, torch.device("cpu"))[1]

    copy = str(tmp_path / "copy")
    shutil.copytree(cli_checkpoint, copy)
    os.utime(os.path.join(copy, ci.SAFETENSORS_FILE), (1, 1))
    first = tag(cli_checkpoint)
    assert first.startswith("hf") and tag(copy) == first
    other = str(tmp_path / "other")
    _clip(CLI_VISION, seed=4).save_pretrained(other)
    assert tag(other) != first


def test_cli_finetune_starts_from_the_checkpoint(cli_checkpoint, tmp_path,
                                                 monkeypatch):
    """``finetune --checkpoint DIR`` on the CLI's 64 px corpus: the tower
    that takes the first step holds the directory's weights in bits."""
    from patent_tpu_torch.cli.main import main as torch_main
    from patent_tpu_torch.train import finetune_clip

    started = {}
    make_step = finetune_clip.make_finetune_step

    def spy(model, optimizer):
        started.update({k: v.detach().clone()
                        for k, v in model.vit.state_dict().items()})
        return make_step(model, optimizer)

    monkeypatch.setattr(finetune_clip, "make_finetune_step", spy)
    assert torch_main(["finetune", "--path", str(tmp_path), "--device",
                       "cpu", "--epochs", "1", "--checkpoint",
                       cli_checkpoint]) == 0
    want = ci.load_hf_clip_params(cli_checkpoint,
                                  torch_vit.VisionConfig(**CLI_VISION))
    assert set(started) == set(want)
    assert all(torch.equal(started[k], want[k]) for k in want)
