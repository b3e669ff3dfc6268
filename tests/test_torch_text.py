"""The port's text path held to patent_tpu on the CPU: the text tower
(``TextTransformer``) and its weight bridge, the CLIP BPE tokenizer, the
hashing tokenizer, the CPC-definition parser, ``embed_texts`` and
``build_text_feature_dicts``, the text features in the graph's feature
matrix, and the synthetic line-art drawings and views corpus.

Inputs are made from numpy seeds; the JAX tower's weights come from one
seeded Flax init, perturbed so that every parameter matters, and reach the
port through ``text_params_from_jax``.  The text tower always passes its
causal mask, so neither package reaches a Pallas kernel here.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.data import bpe as jax_bpe
from patent_tpu.data import graph_build as jax_graph
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.data import text_features as jax_text
from patent_tpu.models import vit as jax_vit
from patent_tpu_torch.data import bpe as torch_bpe
from patent_tpu_torch.data import graph_build as torch_graph
from patent_tpu_torch.data import synthetic as torch_synth
from patent_tpu_torch.data import text_features as torch_text
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models.weights import (text_params_from_jax,
                                             text_params_to_jax)

# f32: the same function, another summation order; measured 1.6e-6 at
# TEXT_TINY (features of magnitude ~3)
F32_ATOL = 1e-5
# bf16: the same rounding points; measured ~1e-7 mean relative
BF16_MEAN_REL = 1e-3
# TEXT_B: 12 layers of width 512, f32
TEXT_B_ATOL = 1e-4
# a vocabulary that holds the synthetic BPE vocabulary's ~200 ids
SMALL = dict(vocab_size=256, context_length=16, hidden_dim=64, num_layers=2,
             num_heads=4, mlp_dim=128, projection_dim=32)


def _flax_params(jcfg, seed=0):
    model = jax_vit.TextTransformer(jcfg)
    params = model.init(jax.random.key(seed), jnp.zeros(
        (1, jcfg.context_length), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float32) + 0.05 * rng.
                              standard_normal(a.shape).astype(np.float32)),
        params)


def _port(tcfg, params, dtype=torch.float32):
    model = torch_vit.TextTransformer(tcfg, dtype=dtype)
    model.load_state_dict(text_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
    return model.eval()


def _ids(vocab, length, batch, seed=0):
    """Random rows with EOS (the vocabulary's largest id) at a varying
    position and zeros after it, as the hashing tokenizer pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab - 1, size=(batch, length))
    for row in range(batch):
        eos = 2 + row % (length - 2)
        ids[row, eos] = vocab - 1
        ids[row, eos + 1:] = 0
    return ids.astype(np.int32)


def _jax_apply(module, params, ids):
    fn = jax.jit(module.apply, compiler_options={
        "xla_allow_excess_precision": False})
    return np.asarray(fn({"params": params}, jnp.asarray(ids)), np.float32)


def _run(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).float().numpy()


def _mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_vit.TEXT_TINY
    params = _flax_params(jcfg)
    ids = _ids(jcfg.vocab_size, jcfg.context_length, 6)
    return jcfg, params, ids


def test_text_tower_f32_matches_jax(tiny):
    jcfg, params, ids = tiny
    want = _jax_apply(jax_vit.TextTransformer(jcfg), params, ids)
    got = _run(_port(torch_vit.TEXT_TINY, params), ids)
    assert got.shape == want.shape == (6, jcfg.projection_dim)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_text_tower_bf16_matches_jax(tiny):
    jcfg, params, ids = tiny
    want = _jax_apply(jax_vit.TextTransformer(jcfg, dtype=jnp.bfloat16),
                      params, ids)
    got = _run(_port(torch_vit.TEXT_TINY, params, torch.bfloat16), ids)
    assert _mean_rel(got, want) <= BF16_MEAN_REL


def test_text_pooling_at_the_last_position_fails_the_gate(tiny):
    """The control: the same stream pooled at the last position, not at
    EOS, is far from JAX's features."""
    jcfg, params, ids = tiny
    want = _jax_apply(jax_vit.TextTransformer(jcfg), params, ids)
    model = _port(torch_vit.TEXT_TINY, params)
    t = torch.from_numpy(ids)
    with torch.no_grad():
        x = model.embed(t)
        mask = torch_vit.causal_mask(x.shape[1])
        for layer in model.blocks:
            x = torch_vit.transformer_block(x, layer, jcfg.num_heads,
                                            torch.float32, mask)
        last = torch.full((len(ids), x.shape[1]), 0, dtype=torch.long)
        last[:, -1] = 1
        ctrl = model.readout(x, last).numpy()
        same = model.readout(x, t).numpy()
    np.testing.assert_allclose(same, want, atol=F32_ATOL, rtol=0)
    assert np.abs(ctrl - want).max() > 100 * F32_ATOL


def test_text_padding_after_eos_changes_nothing(tiny):
    """Under the causal mask the EOS row sees only its prefix."""
    jcfg, params, ids = tiny
    model = _port(torch_vit.TEXT_TINY, params)
    other = ids.copy()
    rng = np.random.default_rng(3)
    for row in range(len(ids)):
        eos = int(np.argmax(ids[row]))
        other[row, eos + 1:] = rng.integers(1, jcfg.vocab_size - 1,
                                            jcfg.context_length - eos - 1)
    assert not np.array_equal(other, ids)
    np.testing.assert_allclose(_run(model, other), _run(model, ids),
                               atol=1e-6, rtol=0)


def test_text_params_round_trip_to_jax(tiny):
    _jcfg, params, _ids_ = tiny
    tree = jax.tree.map(np.asarray, params)
    back = text_params_to_jax(text_params_from_jax({"params": tree}))
    flat, want = (jax.tree_util.tree_leaves_with_path(t) for t in (back,
                                                                     tree))
    assert [p for p, _ in flat] == [p for p, _ in want]
    for (_p, a), (_q, b) in zip(flat, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    model = _port(torch_vit.TEXT_TINY, params)
    assert set(model.state_dict()) == set(text_params_from_jax(tree))


def test_text_b_batch_2_matches_jax():
    """The tower at CLIP's widths (vocab 49,408, context 77, 12 layers of
    512, 8 heads), batch 2, f32; it took ~10 s on the CPU."""
    t0 = time.perf_counter()
    jcfg = jax_vit.TEXT_B
    params = _flax_params(jcfg, seed=1)
    ids = _ids(jcfg.vocab_size, jcfg.context_length, 2, seed=1)
    want = _jax_apply(jax_vit.TextTransformer(jcfg), params, ids)
    got = _run(_port(torch_vit.TEXT_B, params), ids)
    np.testing.assert_allclose(got, want, atol=TEXT_B_ATOL, rtol=0)
    print(f"TEXT_B at batch 2: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- tokenizers
TEXTS = [
    "lower newer",
    "hello hello world",
    "A01G: horticulture; cultivation of vegetables",
    "Display screen with graphical user interface!",
    "x",
    "",
    "  spaced   out\ttabs  ",
    "mix3d 4lphanumer1c t0kens",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """tests/test_bpe.py's vocabulary: every printable ASCII byte symbol,
    its </w> form, a few merges, and the CLIP special tokens."""
    d = tmp_path_factory.mktemp("clip_tok")
    b2u = torch_bpe._bytes_to_unicode()
    syms = [b2u[b] for b in range(33, 127)] + [b2u[ord(" ")]]
    vocab = {}
    for s in syms:
        vocab.setdefault(s, len(vocab))
        vocab.setdefault(s + "</w>", len(vocab))
    merges = ["#version: 0.2", "l o", "lo w</w>", "e r</w>", "l l",
              "h e", "he ll", "hell o</w>"]
    for m in merges[1:]:
        vocab.setdefault("".join(m.split()), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("\n".join(merges) + "\n", encoding="utf-8")
    return d


@pytest.mark.parametrize("pattern", ["regex", "re"])
def test_bpe_ids_match_jax_and_hf(vocab_dir, pattern, monkeypatch):
    import re

    transformers = pytest.importorskip("transformers")
    if pattern == "re":
        # the fallback that runs where the regex package is missing
        monkeypatch.setattr(torch_bpe, "_PAT", re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[^\W\d_]+|\d|[^\s\w]+""", re.IGNORECASE))
    files = (str(vocab_dir / "vocab.json"), str(vocab_dir / "merges.txt"))
    hf = transformers.CLIPTokenizer(*files)
    ours = torch_bpe.ClipBPETokenizer(*files, context_length=16)
    ref = jax_bpe.ClipBPETokenizer(*files, context_length=16)
    for text in TEXTS:
        got = ours.encode(text)
        assert got == ref.encode(text)
        assert got == hf(text, add_special_tokens=False)["input_ids"], text
        row = ours(text)
        assert row.dtype == np.int32 and row.shape == (16,)
        np.testing.assert_array_equal(row, ref(text))
        np.testing.assert_array_equal(row, np.asarray(hf(
            text, padding="max_length", truncation=True,
            max_length=16)["input_ids"]))
    loaded = torch_bpe.load_clip_bpe(str(vocab_dir), 16)
    assert isinstance(loaded, torch_bpe.ClipBPETokenizer)
    assert torch_bpe.load_clip_bpe(str(vocab_dir / "nowhere")) is None


def test_hashing_tokenizer_ids_equal_jax():
    words = np.random.default_rng(0).choice(
        ["chair", "lamp", "Display", "screen", "a01g", "x9", "with", "!"],
        size=(20, 9))
    texts = [" ".join(w) for w in words] + ["", "one", "many " * 100]
    for vocab, ctx in ((49408, 77), (128, 16)):
        ours = torch_text.hashing_tokenizer(vocab, ctx)
        ref = jax_text.hashing_tokenizer(vocab, ctx)
        for text in texts:
            got = ours(text)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref(text))


def test_tokenizer_preference_order(vocab_dir, tmp_path):
    cfg = torch_vit.TextConfig(**SMALL)
    assert isinstance(torch_text.clip_tokenizer_or_fallback(str(vocab_dir),
                                                            cfg),
                      torch_bpe.ClipBPETokenizer)
    for where in (None, str(tmp_path)):
        tok = torch_text.clip_tokenizer_or_fallback(where, cfg)
        assert not isinstance(tok, torch_bpe.ClipBPETokenizer)
        np.testing.assert_array_equal(
            tok("a chair"), jax_text.hashing_tokenizer(256, 16)("a chair"))


def test_parse_cpc_definitions_equals_jax():
    lines = ["A01B    3/14    Ploughs with fixed plough-shares",
             "A01B    3/16    a second title of the same code",
             "B25J            MANIPULATORS",
             "F21     LIGHTING",
             "A       HUMAN NECESSITIES",
             "# comment", "", "a01g  lower case is no code\n",
             "G06F 3/0481 Interaction techniques\n"]
    got = torch_text.parse_cpc_definitions_fixed_width(lines)
    assert got == jax_text.parse_cpc_definitions_fixed_width(lines)
    assert got["A01B"].startswith("Ploughs") and got["F21"] == "LIGHTING"


# ------------------------------------------------ features and the graph
@pytest.fixture(scope="module")
def small():
    jcfg = jax_vit.TextConfig(**SMALL)
    params = _flax_params(jcfg, seed=2)
    return jcfg, params, _port(torch_vit.TextConfig(**SMALL), params)


def test_embed_texts_matches_jax(small, vocab_dir):
    jcfg, params, model = small
    texts = [f"ornamental design for a {w} number {i}"
             for i, w in enumerate(["chair", "lamp", "vehicle", "robot"] * 3)]
    for where in (str(vocab_dir), None):
        tok = torch_text.clip_tokenizer_or_fallback(where, model.config)
        jtok = jax_text.clip_tokenizer_or_fallback(where, jcfg)
        got = torch_text.embed_texts(texts, model, tok, batch_size=5)
        want = jax_text.embed_texts(texts, jax_vit.TextTransformer(jcfg),
                                    {"params": params}, jtok, batch_size=5)
        assert got.dtype == np.float32 and got.shape == (12, 32)
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    empty = torch_text.embed_texts([], model, tok)
    assert empty.shape == (0, 0)


def _text_inputs(records):
    """CPC definitions of the graph's codes at every level and a title per
    patent, seeded."""
    rng = np.random.default_rng(5)
    words = ["ornamental", "design", "chair", "lamp", "vehicle", "display",
             "screen", "robot", "arm", "light", "fixture", "garment"]
    codes = sorted({c for r in records
                    for c in (r.medium_cpc, r.big_cpc, r.main_cpc)})
    cpc = {c: " ".join(rng.choice(words, 4)) for c in codes}
    titles = {r.patent_id: " ".join(rng.choice(words, 6)) for r in records}
    return cpc, titles


def test_text_features_fill_the_graph_as_jax(small, vocab_dir):
    """The slice: definitions and titles through the tokenizer and the
    tower into the patent and CPC rows of the feature matrix, against the
    JAX pipeline with the same weights."""
    jcfg, params, model = small
    records = torch_synth.synthetic_records(num_patents=9,
                                            figures_per_patent=2, seed=0)
    cpc, titles = _text_inputs(records)
    got_cpc, got_pat = torch_text.build_text_feature_dicts(
        cpc, titles, model=model, checkpoint_dir=str(vocab_dir),
        device="cpu")
    want_cpc, want_pat = jax_text.build_text_feature_dicts(
        cpc, titles, model=jax_vit.TextTransformer(jcfg),
        params={"params": params}, checkpoint_dir=str(vocab_dir))
    assert list(got_cpc) == list(want_cpc) and list(got_pat) == \
        list(want_pat)
    figs = jax_synth.synthetic_features(records, dim=32, seed=0)
    mats = []
    for graph_mod, cpc_f, pat_f in ((torch_graph, got_cpc, got_pat),
                                    (jax_graph, want_cpc, want_pat)):
        graph = graph_mod.build_hetero_graph(records)
        levels = [{k: cpc_f[k] for k in idx} for idx in (
            graph.medium_index, graph.big_index, graph.main_index)]
        mats.append(graph_mod.build_feature_matrix(graph, figs, pat_f,
                                                   *levels))
    got, want = mats
    nf = len(records)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.abs(got[nf:]).sum(1) > 0)   # every text row is filled
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_build_text_feature_dicts_defaults(monkeypatch):
    """The default device is the card, and without one it is an error; the
    default model is TEXT_B drawn from the seed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        torch_text.build_text_feature_dicts({"A01G": "horticulture"})
    cpc, pat = torch_text.build_text_feature_dicts(
        {"A01G": "horticulture", "B25J": "manipulators"}, device="cpu")
    assert set(cpc) == {"A01G", "B25J"} and pat == {}
    assert cpc["A01G"].shape == (512,) and np.isfinite(cpc["A01G"]).all()
    assert not np.array_equal(cpc["A01G"], cpc["B25J"])


# ------------------------------------------------- drawings and views
def test_synthetic_drawings_equal_jax_in_bytes():
    for n, size, seed in ((3, 64, 5), (2, 224, 0)):
        got = torch_synth.synthetic_drawing_arrays(n, size, seed=seed)
        want = jax_synth.synthetic_drawing_arrays(n, size, seed=seed)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    img = want[0]
    for k in range(5):
        got = torch_synth.apply_view(img, k)
        assert np.array_equal(got, jax_synth.apply_view(img, k))
    assert not np.array_equal(torch_synth.apply_view(img, 1), img)


def test_synthetic_view_images_equal_jax_in_bytes(tmp_path):
    records = torch_synth.synthetic_records(num_patents=3,
                                            figures_per_patent=4, seed=0)
    # a record whose name has no view index takes a count per patent
    odd = records[0].__class__(figure_id="USD0700000-20180101-fig.png",
                               patent_id=records[0].patent_id,
                               medium_cpc=records[0].medium_cpc,
                               big_cpc=records[0].big_cpc,
                               main_cpc=records[0].main_cpc)
    records = records + [odd]
    got = torch_synth.write_synthetic_view_images(
        records, str(tmp_path / "torch"), image_size=64, seed=3)
    want = jax_synth.write_synthetic_view_images(
        records, str(tmp_path / "jax"), image_size=64, seed=3)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
