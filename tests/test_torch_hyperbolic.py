"""The hyperbolic serving slice of patent_tpu_torch (on the CPU) held to
patent_tpu: the data preparation byte for byte, the models through the
weight bridge, the Poincaré index (scan and quantized), the retrieval
engine's metric battery, the label-retrieval mAP and distance analysis,
and the CLI's ``test`` / ``infer`` / ``dist`` on a checkpoint that the JAX
``train_hyp`` wrote.

Inputs and weights come from numpy and JAX seeds and go through both
packages.  The models agree within 1e-5; the index answers with the
scan's indices, ties to the lower gallery index (the JAX quantized path's
host re-rank breaks ties in pool order, so it is compared only away from
exact duplicates); the CLI prints the JAX CLI's mAP within 1e-4 and its
distance means within 1e-4 relative, in a process that loads no module of
the JAX package.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.cli.main import main as jax_main
from patent_tpu.data import build_feature_matrix as jax_feature_matrix
from patent_tpu.data import build_hetero_graph as jax_hetero_graph
from patent_tpu.data import prepare_training_data as jax_prepare
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.data.prep import TrainingData as JaxTrainingData
from patent_tpu.models import hyperbolic as jax_hyp
from patent_tpu.retrieval import index as jax_index
from patent_tpu.retrieval.hyperbolic_engine import \
    HyperbolicRetrievalEngine as JaxEngine
from patent_tpu.train import evaluate as jax_eval
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.data import synthetic as torch_synth
from patent_tpu_torch.data.graph_build import (build_feature_matrix,
                                               build_hetero_graph)
from patent_tpu_torch.data.prep import TrainingData, prepare_training_data
from patent_tpu_torch.models import hyperbolic as torch_hyp
from patent_tpu_torch.models.weights import (hyperbolic_params_from_jax,
                                             hyperbolic_params_to_jax)
from patent_tpu_torch.ops import topk_kernel as torch_topk
from patent_tpu_torch.retrieval import index as torch_index
from patent_tpu_torch.retrieval.hyperbolic_engine import \
    HyperbolicRetrievalEngine
from patent_tpu_torch.train import evaluate as torch_eval
from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ball(rng, n, d, c, r_hi=0.95):
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(0.05, r_hi, (n, 1)) / np.sqrt(c)).astype(
        np.float32)


# ------------------------------------------------------------------ data

def test_synthetic_features_graph_and_training_data_equal_jax(tmp_path):
    jrec = jax_synth.synthetic_records(num_patents=30, figures_per_patent=3,
                                       seed=4)
    trec = torch_synth.synthetic_records(num_patents=30, figures_per_patent=3,
                                         seed=4)
    jf = jax_synth.synthetic_features(jrec, dim=24, seed=4)
    tf = torch_synth.synthetic_features(trec, dim=24, seed=4)
    assert list(jf) == list(tf)
    for name in jf:
        assert jf[name].tobytes() == tf[name].tobytes()
    jg, tg = jax_hetero_graph(jrec), build_hetero_graph(trec)
    assert (jg.adjacency != tg.adjacency).nnz == 0
    assert jg.offsets == tg.offsets and jg.counts == tg.counts
    assert jg.figure_index == tg.figure_index
    jx = jax_feature_matrix(jg, jf, feature_dim=24)
    tx = build_feature_matrix(tg, tf, feature_dim=24)
    assert jx.tobytes() == tx.tobytes()
    jtd = jax_prepare(jg, jx, neg_ratio=3, fig_pair_ratio=2, seed=4)
    ttd = prepare_training_data(tg, tx, neg_ratio=3, fig_pair_ratio=2, seed=4)
    for field in ("x_figures", "y_pos", "y_neg", "implication", "exclusion",
                  "positive_figure_pairs", "negative_figure_pairs"):
        a, b = getattr(jtd, field), getattr(ttd, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert jtd.label_offsets == ttd.label_offsets
    assert jtd.num_labels == ttd.num_labels
    # the same files: each package loads the other's
    jtd.save(str(tmp_path / "j"))
    ttd.save(str(tmp_path / "t"))
    back = TrainingData.load(str(tmp_path / "j"))
    jback = JaxTrainingData.load(str(tmp_path / "t"))
    assert back.y_neg.tobytes() == jtd.y_neg.tobytes()
    assert jback.label_offsets == jtd.label_offsets
    assert back.num_labels == jback.num_labels == jtd.num_labels


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("hidden", [(32,), (32, 24)], ids=["one", "middle"])
def test_embedding_model_matches_jax_through_the_bridge(hidden):
    c, feat, embed, labels = 2.0, 40, 16, 30
    jm = jax_hyp.HyperbolicEmbeddingModel(feature_dim=feat, embed_dim=embed,
                                          label_num=labels,
                                          hidden_dims=hidden, c=c)
    params = jm.init(jax.random.key(1), jnp.zeros((1, feat)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = torch_hyp.HyperbolicEmbeddingModel(feature_dim=feat, embed_dim=embed,
                                            label_num=labels,
                                            hidden_dims=hidden, c=c)
    sd = hyperbolic_params_from_jax({"params": params})
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    tm.eval()
    x = np.random.default_rng(0).standard_normal((50, feat)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               deterministic=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # and back to the Flax tree, leaf for leaf
    back = hyperbolic_params_to_jax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_figure_only_model_and_dropout_modes():
    c, feat = 1.0, 24
    jm = jax_hyp.FigureOnlyHyperbolicModel(feature_dim=feat, embed_dim=8,
                                           hidden_dims=(16,), c=c)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(2), jnp.zeros((1, feat)))["params"])
    tm = torch_hyp.FigureOnlyHyperbolicModel(feature_dim=feat, embed_dim=8,
                                             hidden_dims=(16,), c=c)
    tm.load_state_dict(hyperbolic_params_from_jax(params))
    x = np.random.default_rng(1).standard_normal((20, feat)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-5, rtol=1e-5)
        tm.train()               # dropout acts in train mode only
        torch.manual_seed(0)
        assert not np.allclose(tm(torch.from_numpy(x)).numpy(), want,
                               atol=1e-3)


def test_initialisers_follow_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    c = 2.0
    m = torch_hyp.HyperbolicEmbeddingModel(feature_dim=512, embed_dim=128,
                                           label_num=4000, c=c,
                                           generator=gen)
    k = m.encoder.first_layer.kernel.detach()
    limit = np.sqrt(6.0 / (512 + 256))
    assert float(k.abs().max()) <= limit
    assert abs(float(k.std()) - limit / np.sqrt(3)) < 0.01 * limit
    # label table: expmap0 of N(0, 0.1²) rows — mean norm ≈ tanh(√c·0.1·√128)/√c
    norms = m.label_emb.detach().norm(dim=-1)
    want = np.tanh(np.sqrt(c) * 0.1 * np.sqrt(128)) / np.sqrt(c)
    assert abs(float(norms.mean()) - want) < 0.01
    b = m.encoder.final_layer.hyp_bias.detach()
    assert 1e-3 * 0.5 < float(b.std()) < 1e-3 * 1.5
    again = torch_hyp.HyperbolicEmbeddingModel(
        feature_dim=512, embed_dim=128, label_num=4000, c=c,
        generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))


# ----------------------------------------------------------------- index

@pytest.fixture(scope="module")
def ball_data():
    c = 2.0
    rng = np.random.default_rng(13)
    return c, _ball(rng, 1500, 32, c), _ball(rng, 11, 32, c)


def _assert_same_ranking(ti, tv, ji, jv, tol=2e-5):
    """The same indices, except where two entries of JAX's ranking lie
    within ``tol`` of each other (a full ranking of f32 surrogates summed
    in another order may swap such a pair); values within ``tol``."""
    np.testing.assert_allclose(tv, jv, atol=tol, rtol=tol)
    for r in range(ti.shape[0]):
        assert set(ti[r]) == set(ji[r]), r
        where = {int(j): p for p, j in enumerate(ji[r])}
        for p in np.flatnonzero(ti[r] != ji[r]):
            assert abs(jv[r, where[int(ti[r, p])]] - jv[r, p]) <= tol, (r, p)


@pytest.mark.parametrize("n,k", [(1500, 10), (1500, 1500), (80, 10),
                                 (5, 10)],
                         ids=["k<n", "k==n", "pool==n", "n<k"])
def test_poincare_index_scan_and_quantized_match_jax(ball_data, n, k):
    """Both of the port's paths against JAX's scan index and JAX's
    quantized index; indices identical whenever k < n."""
    c, gallery, queries = ball_data
    gallery = gallery[:n]
    names = [f"g{i}" for i in range(n)]
    want = [jax_index.EmbeddingIndex(gallery, names, similarity="poincare",
                                     c=c, quantized=q).search(queries, k=k)
            for q in (False, True)]
    for quantized in (False, True):
        idx = torch_index.EmbeddingIndex(gallery, names, similarity="poincare",
                                         c=c, device="cpu",
                                         quantized=quantized)
        tv, ti = idx.search(queries, k=k)
        for jv, ji in want:
            if k < n:
                np.testing.assert_array_equal(ti, ji)
            _assert_same_ranking(ti, tv, ji, jv)


def test_poincare_index_ties_break_to_the_lower_index():
    """8 exact copies of every row: the scan and the quantized path both
    rank a row's copies by gallery index, as JAX's scan does."""
    c = 1.0
    rng = np.random.default_rng(3)
    gallery = np.concatenate([_ball(rng, 64, 32, c)] * 8)
    queries = gallery[[5, 37, 100]] + 0.0
    names = [f"g{i}" for i in range(len(gallery))]
    jv, ji = jax_index.topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                                   k=10, similarity="poincare",
                                   block_size=128, c=c)
    for quantized in (False, True):
        tv, ti = torch_index.EmbeddingIndex(
            gallery, names, similarity="poincare", c=c, device="cpu",
            quantized=quantized).search(queries, k=10)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        assert np.all(np.diff(ti[:, :8], axis=1) == 64)
        np.testing.assert_allclose(tv[:, 8:], np.asarray(jv)[:, 8:],
                                   atol=2e-5, rtol=2e-5)


def test_poincare_fast_near_boundary_returns_the_f64_topk():
    """Radii up to 0.9995/√c in a narrow cone (w near 1e3, where the
    surrogate loses fine ordering): the exact re-rank still returns the
    f64 top-k (tests/test_index.py's stress case)."""
    c = 2.0
    rng = np.random.default_rng(31)
    base = rng.standard_normal(32)
    base /= np.linalg.norm(base)
    dirs = base[None, :] + 0.05 * rng.standard_normal((800, 32))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    gallery = (dirs * rng.uniform(0.99, 0.9995, (800, 1))
               / np.sqrt(c)).astype(np.float32)
    queries = gallery[:5] * 0.999
    gal = torch_topk.prepare_poincare_gallery(torch.from_numpy(gallery), c)
    _v, ti = torch_index.topk_search_poincare_fast(
        torch.from_numpy(queries), gal, torch.from_numpy(gallery), k=5, c=c,
        rerank_mult=16)
    d = torch_index.poincare_dist_f64(
        torch.from_numpy(queries),
        torch.from_numpy(gallery)[None].expand(5, -1, -1), c).numpy()
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ti.numpy(), want)


def test_poincare_index_round_trips_through_files(ball_data, tmp_path):
    c, gallery, _q = ball_data
    names = [f"fig{i}.png" for i in range(200)]
    torch_index.EmbeddingIndex(gallery[:200], names, similarity="poincare",
                               c=c, device="cpu").save(str(tmp_path / "p"))
    back = torch_index.EmbeddingIndex.load(str(tmp_path / "p"), device="cpu",
                                           similarity="poincare", c=c,
                                           quantized=True)
    want = jax_index.EmbeddingIndex.load(str(tmp_path / "p"),
                                         similarity="poincare", c=c)
    assert back.names == want.names == names
    np.testing.assert_array_equal(back.embeddings.numpy(),
                                  np.asarray(want.embeddings))
    np.testing.assert_array_equal(
        back.emb_gal.gal_i8.numpy(),
        np.asarray(jax_index.prepare_poincare_gallery(gallery[:200],
                                                      c).gal_i8))


# ------------------------------------------------- engine and evaluation

@pytest.fixture(scope="module")
def small_model():
    """A JAX-initialised HyperbolicEmbeddingModel on a synthetic corpus,
    and its port through the bridge."""
    records = jax_synth.synthetic_records(num_patents=20, figures_per_patent=4,
                                          seed=3)
    graph = jax_hetero_graph(records)
    feats = jax_synth.synthetic_features(records, dim=32, seed=3, noise=0.3)
    x = jax_feature_matrix(graph, feats, feature_dim=32)
    td = jax_prepare(graph, x, neg_ratio=2, fig_pair_ratio=1, seed=3)
    jm = jax_hyp.HyperbolicEmbeddingModel(feature_dim=32, embed_dim=16,
                                          label_num=td.num_labels,
                                          hidden_dims=(32,), c=1.0)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0),
                                              jnp.zeros((1, 32)))["params"])
    tm = torch_hyp.HyperbolicEmbeddingModel(feature_dim=32, embed_dim=16,
                                            label_num=td.num_labels,
                                            hidden_dims=(32,), c=1.0)
    tm.load_state_dict(hyperbolic_params_from_jax(params))
    return records, td, jm, params, tm.eval()


@pytest.mark.parametrize("quantized", [False, True], ids=["scan", "int8"])
def test_engine_metric_battery_matches_jax(small_model, quantized):
    records, td, jm, params, tm = small_model
    names = [r.figure_id for r in records]
    by_patent: dict = {}
    for i, r in enumerate(records):
        by_patent.setdefault(r.patent_id, []).append(i)
    q_rows = [rows[0] for rows in by_patent.values()]
    g_rows = [i for rows in by_patent.values() for i in rows[1:]]
    gt = {names[q]: {"patent_positives": [
        names[g] for g in g_rows
        if records[g].patent_id == records[q].patent_id],
        "cpc_positives": []} for q in q_rows}
    x = td.x_figures
    want = JaxEngine(jm, params, x[g_rows], [names[g] for g in g_rows],
                     quantized=quantized).evaluate(
        x[q_rows], [names[q] for q in q_rows], gt)
    engine = HyperbolicRetrievalEngine(tm, x[g_rows],
                                       [names[g] for g in g_rows],
                                       device="cpu", quantized=quantized)
    got = engine.evaluate(x[q_rows], [names[q] for q in q_rows], gt)
    assert got.summary_dict() == pytest.approx(want.summary_dict(), abs=1e-9)
    hits = engine.retrieve(x[q_rows[0]], k=5)
    assert len(hits) == 1 and len(hits[0]) == 5
    assert all(score <= 0 for _n, score in hits[0])


def test_label_map_and_distance_analysis_match_jax(small_model):
    _records, td, jm, params, tm = small_model
    fig_pos: dict = {}
    for f, p in td.y_pos.tolist():
        fig_pos.setdefault(f, []).append(p)
    num_patents = td.label_offsets["medium_cpcs"] - td.label_offsets["patents"]
    want = jax_eval.evaluate_retrieval_map(jm, params, td.x_figures,
                                           sorted(fig_pos), fig_pos,
                                           num_patents, batch_size=32)
    got = torch_eval.evaluate_retrieval_map(tm, td.x_figures, sorted(fig_pos),
                                            fig_pos, num_patents,
                                            batch_size=32)
    assert got == pytest.approx(want, abs=1e-6)
    ja = jax_eval.distance_analysis(jm, params, td.x_figures, td.y_pos,
                                    td.label_offsets, td.implication,
                                    num_samples=40, seed=5)
    ta = torch_eval.distance_analysis(tm, td.x_figures, td.y_pos,
                                      td.label_offsets, td.implication,
                                      num_samples=40, seed=5)
    assert set(ta) == set(ja) == {"patent", "medium", "big", "main"}
    for level, want_level in ja.items():
        assert ta[level]["n"] == want_level["n"]
        np.testing.assert_allclose(ta[level]["_true"], want_level["_true"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ta[level]["_random"],
                                   want_level["_random"], rtol=1e-5,
                                   atol=1e-5)


def test_distance_analysis_files_without_matplotlib(small_model, tmp_path,
                                                    monkeypatch, capsys):
    _records, td, _jm, _params, tm = small_model
    analysis = torch_eval.distance_analysis(tm, td.x_figures, td.y_pos,
                                            td.label_offsets, td.implication,
                                            num_samples=16)
    files = torch_eval.save_distance_analysis(analysis, str(tmp_path / "a"))
    assert [os.path.basename(f) for f in files] == [
        "distance_analysis.csv", "distance_boxplot.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    files = torch_eval.save_distance_analysis(analysis, str(tmp_path / "b"))
    assert [os.path.basename(f) for f in files] == ["distance_analysis.csv"]
    assert "was not written" in capsys.readouterr().err
    with open(files[0]) as f:
        assert f.readline().strip() == "level,kind,distance"
    assert "_true" not in json.dumps(torch_eval.strip_raw_samples(analysis))


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """JAX ``train_hyp --synthetic --epochs 2`` on the CPU, then the JAX
    CLI's ``test`` and ``dist`` outputs on its checkpoint."""
    root = tmp_path_factory.mktemp("hyp")
    jax_dir = str(root / "jax")
    assert jax_main(["train_hyp", "--path", jax_dir, "--synthetic",
                     "--epochs", "2"]) == 0
    torch_dir = jax_dir + "_torch"
    shutil.copytree(jax_dir, torch_dir)
    return jax_dir, torch_dir


def _jax_cli(argv, capsys):
    capsys.readouterr()
    assert jax_main(argv) == 0
    return capsys.readouterr().out


def _dist_json(out: str) -> dict:
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def test_cli_test_infer_dist_match_the_jax_cli(jax_trained, capsys):
    jax_dir, torch_dir = jax_trained
    want_map = float(re.search(r"mAP \(label retrieval\): (\S+)", _jax_cli(
        ["test", "--path", jax_dir], capsys)).group(1))
    want_dist = _dist_json(_jax_cli(["dist", "--path", jax_dir], capsys))
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            "for action in ('test', 'infer', 'dist'):\n"
            f"    rc = main([action, '--path', {torch_dir!r},\n"
            "               '--device', 'cpu', 'curvature=2.0',\n"
            "               'hidden_dims=[256]'])\n"
            "    assert rc == 0, (action, rc)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "pkg = [m for m in sys.modules if m == 'patent_tpu'\n"
            "       or m.startswith('patent_tpu.')]\n"
            "assert not pkg, pkg\n"
            "print('JAX_FREE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "JAX_FREE_OK" in out
    maps = [float(m) for m in re.findall(r"mAP \(label retrieval\): (\S+)",
                                         out)]
    assert len(maps) == 2 and all(m == pytest.approx(want_map, abs=1e-4)
                                  for m in maps)
    got_dist = _dist_json(out)
    assert set(got_dist) == set(want_dist)
    for level, w in want_dist.items():
        assert got_dist[level]["n"] == w["n"]
        for key in ("true_mean", "random_mean", "ratio"):
            assert got_dist[level][key] == pytest.approx(w[key], rel=1e-4)
    assert os.path.exists(os.path.join(torch_dir, "analysis",
                                       "distance_analysis.csv"))


def test_cli_needs_a_checkpoint_and_a_card(tmp_path, capsys, monkeypatch):
    assert torch_main(["infer", "--path", str(tmp_path), "--device",
                       "cpu"]) == 1
    err = capsys.readouterr().err
    assert "best_retrieval_model_c2.0_e128" in err and "train_hyp" in err
    assert os.path.exists(os.path.join(tmp_path, "prepared_training_data",
                                       "training_data.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_main(["test", "--path", str(tmp_path / "x")]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")


def test_synthetic_training_data_equals_the_jax_cli(tmp_path):
    """``ensure_training_data`` writes what the JAX CLI's writes."""
    from patent_tpu.cli.main import _ensure_training_data

    want = _ensure_training_data(str(tmp_path / "j"), True)
    got = ensure_training_data(str(tmp_path / "t"), True)
    for field in ("x_figures", "y_pos", "y_neg", "implication",
                  "positive_figure_pairs", "negative_figure_pairs"):
        assert getattr(got, field).tobytes() == getattr(want, field).tobytes()
    again = ensure_training_data(str(tmp_path / "j"), False)   # loads JAX's
    assert again.x_figures.tobytes() == want.x_figures.tobytes()
