"""The graph family of the port held to the JAX package on the CPU.

* The three adjacency normalizations, ``spmm`` and ``adj_rowsum`` against
  JAX's; ``spmm``'s backward against the dense transpose product, and in
  equal bits run to run (it sums each row's edges in a fixed order).
* ``EnhancedVGAE`` forward in train and eval mode from JAX's initial
  variables (carried by the weight bridge), the BatchNorm running
  statistics after a step included: Flax's momentum 0.99 and biased
  variance, which ``torch.nn.BatchNorm1d`` would get wrong (the control).
* ``train_pair_classification``'s history, test report and exported
  embeddings, dense and sparse, from JAX's initial variables with the
  classifier's dropout off on both sides (a Flax attribute in the test).
* The VGAE losses; ``train_vgae_link_prediction`` dense and on the
  sampled objective (its threshold lowered through ``mode``), the sampled
  negatives fed to both packages from numpy.
* ``split_edges``, ``sample_figure_pairs``, the HMI-side metrics
  (classification, embedding quality) equal to JAX's.
"""

import dataclasses
import json
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from patent_tpu.data import edges as jax_edges
from patent_tpu.data import pairs as jax_pairs
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.data.graph_build import build_feature_matrix as jax_features
from patent_tpu.data.graph_build import build_hetero_graph as jax_graph
from patent_tpu.losses import vgae as jax_vgae_losses
from patent_tpu.metrics import classification as jax_cls
from patent_tpu.metrics import embedding_quality as jax_eq
from patent_tpu.models import gcn as jax_gcn
from patent_tpu.train import train_gcn as jax_train_gcn
from patent_tpu.train import train_vgae as jax_train_vgae
from patent_tpu.utils.config import GCNTrainConfig as JaxGCNConfig
from patent_tpu_torch.data import edges as t_edges
from patent_tpu_torch.data import pairs as t_pairs
from patent_tpu_torch.data import synthetic as t_synth
from patent_tpu_torch.data.graph_build import build_feature_matrix, \
    build_hetero_graph
from patent_tpu_torch.losses import vgae as t_vgae_losses
from patent_tpu_torch.metrics import classification as t_cls
from patent_tpu_torch.metrics import embedding_quality as t_eq
from patent_tpu_torch.models import gcn as t_gcn
from patent_tpu_torch.models.weights import (gcn_variables_from_jax,
                                             gcn_variables_to_jax)
from patent_tpu_torch.train import train_gcn as t_train_gcn
from patent_tpu_torch.train import train_vgae as t_train_vgae
from patent_tpu_torch.utils.config import GCNTrainConfig

# f32 forward: the port sums in another order than XLA's CPU backend
FWD_RTOL = 2e-5
FWD_ATOL = 1e-6
# a few epochs of AdamW: losses and reports within 1e-4 relative.  Adam
# turns the gradients' rounding differences into steps of up to lr, so
# after 27 steps at 2e-3 the parameters sit within 1e-3 (measured 3.4e-4)
# and the exported unit rows, which moved by up to 0.56 from their
# initial values (equal within 4e-7), within 5e-3 of JAX's (measured
# 2.5e-3) at cosine >= 0.9999 (measured 0.999988)
HIST_RTOL = 1e-4
PARAM_ATOL = 1e-3
EMB_ATOL = 5e-3
EMB_MIN_COS = 0.9999


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the host's cores: two intra-op threads
    each keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_graph(n, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csr",
                  dtype=np.float32)
    a.data[:] = 1.0
    a = ((a + a.T) > 0).astype(np.float32)
    return sp.csr_matrix(a)


@pytest.fixture(scope="module")
def cli_graph():
    """The CLI's synthetic graph, features and pairs, built by each package
    (the host stream is the same in bits)."""
    recs = t_synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                     seed=0)
    graph = build_hetero_graph(recs)
    x = build_feature_matrix(graph, t_synth.synthetic_features(
        recs, dim=64, seed=0), feature_dim=64)
    pair_data = t_pairs.sample_figure_pairs(recs, num_samples=3000,
                                            cap_per_level=300, seed=0)
    return recs, graph, x, pair_data


# ------------------------------------------------------------ host streams
def test_pairs_and_edges_equal_jax(cli_graph):
    recs, graph, x, pair_data = cli_graph
    jrecs = jax_synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                        seed=0)
    jg = jax_graph(jrecs)
    assert (jg.adjacency != graph.adjacency).nnz == 0
    np.testing.assert_array_equal(jax_features(jg, jax_synth.synthetic_features(
        jrecs, dim=64, seed=0), feature_dim=64), x)
    jp = jax_pairs.sample_figure_pairs(jrecs, num_samples=3000,
                                       cap_per_level=300, seed=0)
    assert json.dumps(jp) == json.dumps(pair_data)
    a = t_edges.split_edges(graph.adjacency, seed=3)
    b = jax_edges.split_edges(graph.adjacency, seed=3)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if sp.issparse(va):
            assert (va != vb).nnz == 0
        else:
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)


def test_pair_connections_round_trip(tmp_path, cli_graph):
    data = cli_graph[3]
    path = str(tmp_path / "figure_pair_connections.json")
    t_pairs.save_figure_pair_connections(data, path)
    got = t_pairs.load_figure_pair_connections(path)
    want = jax_pairs.load_figure_pair_connections(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_link_prediction_scores_equal_jax():
    rng = np.random.default_rng(4)
    z = rng.standard_normal((50, 8)).astype(np.float32)
    e, ne = rng.integers(0, 50, (30, 2)), rng.integers(0, 50, (30, 2))
    rec = rng.random((50, 50)).astype(np.float32)
    assert t_edges.link_prediction_scores(rec, e, ne) == \
        jax_edges.link_prediction_scores(rec, e, ne)
    assert t_edges.link_prediction_scores_from_z(z, e, ne) == \
        jax_edges.link_prediction_scores_from_z(z, e, ne)


# ------------------------------------------------------------ metrics
def test_classification_metrics_equal_jax():
    rng = np.random.default_rng(5)
    pred = rng.random((40, 6))
    tgt = (rng.random((40, 6)) < 0.3).astype(np.float64)
    tgt[:, 2] = 0
    assert t_cls.mean_average_precision(pred, tgt) == \
        jax_cls.mean_average_precision(pred, tgt)
    yt, yp = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    cm = t_cls.confusion_counts(yt, yp, 5)
    np.testing.assert_array_equal(cm, jax_cls.confusion_counts(yt, yp, 5))
    got, want = t_cls.per_class_prf(cm), jax_cls.per_class_prf(cm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_evaluate_embeddings_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.standard_normal((300, 16)).astype(np.float32)
    parents = np.stack([rng.integers(0, 300, 120),
                        rng.integers(0, 300, 120)], 1)
    neigh = rng.integers(0, 300, (80, 2))
    got = t_eq.evaluate_embeddings(z, parents, neigh, device="cpu")
    want = jax_eq.evaluate_embeddings(z, parents, neigh)
    assert set(got) == set(want)
    assert got["hierarchical_hit_at_k"] == want["hierarchical_hit_at_k"]
    for k, v in want.items():
        if k != "hierarchical_hit_at_k":
            assert got[k] == pytest.approx(v, rel=1e-5), k


def test_embedding_quality_runs_on_the_card_or_raises(monkeypatch):
    """The card is the default: without one each function raises rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.ones((4, 2), np.float32)
    pairs = np.asarray([[0, 1]])
    for call in (lambda: t_eq.evaluate_embeddings(z, pairs, pairs),
                 lambda: t_eq.preservation_ratios(z, pairs, None),
                 lambda: t_eq.hierarchical_hits_at_k(z, pairs)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# ------------------------------------------------------------ adjacency ops
def test_normalizations_spmm_and_rowsum_match_jax():
    a = _random_graph(200, 0.03, 0)
    dense = a.toarray()
    want = np.asarray(jax_gcn.normalize_adjacency(jnp.asarray(dense)))
    got = t_gcn.normalize_adjacency(torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    host = t_gcn.normalize_adjacency_host(dense, blk=64)
    assert host.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        host.float().numpy(),
        np.asarray(jax_gcn.normalize_adjacency_host(dense, blk=64),
                   np.float32))
    js = jax_gcn.normalize_adjacency_sparse(a)
    ts = t_gcn.normalize_adjacency_sparse(a)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.n == js.n and ts.shape == (200, 200)
    y = np.random.default_rng(1).standard_normal((200, 24)).astype(np.float32)
    np.testing.assert_allclose(
        t_gcn.spmm(ts, torch.from_numpy(y)).numpy(),
        np.asarray(jax_gcn.spmm(js, jnp.asarray(y))), rtol=1e-5, atol=1e-6)
    for jadj, tadj in ((js, ts), (jnp.asarray(want), torch.from_numpy(got))):
        np.testing.assert_allclose(t_gcn.adj_rowsum(tadj).numpy(),
                                   np.asarray(jax_gcn.adj_rowsum(jadj)),
                                   rtol=1e-6)


def test_spmm_backward_is_the_transpose_product_in_fixed_order():
    """The backward sums each column's edges in order: equal to Aᵀ g, and
    the same bits on every call; rows without edges give zeros."""
    a = _random_graph(120, 0.05, 2).tolil()
    a[7, :] = 0                                  # a row with no edges
    a = a.tocsr()
    a.eliminate_zeros()
    coo = a.tocoo()
    vals = np.random.default_rng(3).random(coo.nnz).astype(np.float32)
    adj = t_gcn.sparse_adj(coo.row, coo.col, vals, 120)
    dense = torch.zeros(120, 120)
    dense[torch.from_numpy(coo.row).long(),
          torch.from_numpy(coo.col).long()] = torch.from_numpy(vals)
    y = torch.randn(120, 9, generator=torch.Generator().manual_seed(0))
    g = torch.randn(120, 9, generator=torch.Generator().manual_seed(1))
    grads = []
    for _ in range(2):
        yy = y.clone().requires_grad_(True)
        out = t_gcn.spmm(adj, yy)
        out.backward(g)
        grads.append(yy.grad)
    torch.testing.assert_close(out, dense @ y, rtol=1e-5, atol=1e-6)
    assert torch.equal(out[7], torch.zeros(9))
    torch.testing.assert_close(grads[0], dense.T @ g, rtol=1e-5, atol=1e-6)
    assert torch.equal(grads[0], grads[1])


# ------------------------------------------------------------ models
class NoDropoutVGAE(jax_gcn.EnhancedVGAE):
    """JAX's model with the classifier's dropout rate 0 (a Flax
    attribute), so both packages train without random masks."""

    dropout_rate: float = 0.0


def starting_from(module, cls, state, **fixed):
    """``module``'s ``cls`` made as the trainer makes it but with the
    keyword arguments ``fixed``, then started from ``state`` (JAX's
    initial variables through the bridge)."""

    def make(*args, **kw):
        model = cls(*args, **{**kw, **fixed})
        model.load_state_dict(state)
        return model

    return mock.patch.object(module, cls.__name__, make)


def _jax_model(cfg):
    return NoDropoutVGAE(hidden_dim=cfg.hidden_dim,
                         latent_dim=cfg.latent_dim,
                         num_layers=cfg.num_layers)


def _jax_init(x, adjacency, pairs, cfg):
    """JAX's initial variables as ``train_pair_classification`` makes them."""
    a = jax_train_gcn.prepare_adjacency(adjacency, cfg.adjacency)
    p0 = jnp.asarray(pairs[:min(len(pairs), cfg.batch_size)], jnp.int32)
    return _np(_jax_model(cfg).init(
        jax.random.key(cfg.seed), jnp.asarray(x), a, p0,
        method=jax_gcn.EnhancedVGAE.encode_and_classify))


@pytest.mark.parametrize("num_layers", [3, 4])
def test_enhanced_vgae_train_and_eval_match_jax(cli_graph, num_layers):
    """One forward in train mode (batch statistics, running statistics
    moved once) and one in eval mode; torch's BatchNorm1d with the same
    momentum misses the running variance (the control)."""
    _recs, graph, x, pair_data = cli_graph
    cfg = JaxGCNConfig(hidden_dim=32, latent_dim=16, num_layers=num_layers,
                       batch_size=64)
    pairs = np.asarray(pair_data["pairs"], np.int32)[:64]
    variables = _jax_init(x, graph.adjacency, pairs, cfg)
    a = jax_train_gcn.prepare_adjacency(graph.adjacency, "dense")
    logits, mut = _jax_model(cfg).apply(
        variables, jnp.asarray(x), a, jnp.asarray(pairs), deterministic=False,
        method=jax_gcn.EnhancedVGAE.encode_and_classify,
        mutable=["batch_stats"])
    model = t_gcn.EnhancedVGAE(64, 32, 16, num_layers, dropout_rate=0.0)
    model.load_state_dict(gcn_variables_from_jax(variables))
    ta = t_train_gcn.prepare_adjacency(graph.adjacency, "dense")
    tlogits = model.encode_and_classify(torch.from_numpy(x), ta,
                                        torch.from_numpy(pairs).long())
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    got = gcn_variables_to_jax(model.state_dict())["batch_stats"]
    want = _np(mut["batch_stats"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_ATOL)
    # eval mode on the moved statistics
    new_vars = {"params": variables["params"], "batch_stats": want}
    z = _jax_model(cfg).apply(new_vars, jnp.asarray(x), a)
    model.eval()
    np.testing.assert_allclose(model(torch.from_numpy(x), ta).detach().numpy(),
                               np.asarray(z), rtol=FWD_RTOL, atol=FWD_ATOL)
    # control: torch's BatchNorm1d at momentum 1 − 0.99 keeps the unbiased
    # variance, so its running variance misses Flax's
    h = torch.randn(40, 8, generator=torch.Generator().manual_seed(0))
    bn, ours = torch.nn.BatchNorm1d(8, momentum=0.01), t_gcn.BatchNorm(8)
    bn(h), ours(h)
    assert torch.allclose(bn.running_mean, ours.mean)
    assert not torch.allclose(bn.running_var, ours.var, rtol=1e-4, atol=0)


def test_gcn_weight_bridge_round_trips_in_bits(cli_graph):
    _recs, graph, x, pair_data = cli_graph
    cfg = JaxGCNConfig(hidden_dim=16, latent_dim=8, num_layers=4)
    variables = _jax_init(x, graph.adjacency,
                          np.asarray(pair_data["pairs"], np.int32), cfg)
    sd = gcn_variables_from_jax(variables)
    model = t_gcn.EnhancedVGAE(64, 16, 8, 4)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = gcn_variables_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    vgae = _np(jax_gcn.VGAE(hidden_dim=16, latent_dim=8).init(
        jax.random.key(0), jnp.asarray(x),
        jax_gcn.normalize_adjacency(jnp.asarray(graph.adjacency.toarray()))))
    tv = t_gcn.VGAE(64, 16, 8)
    tv.load_state_dict(gcn_variables_from_jax(vgae))
    back = gcn_variables_to_jax(tv.state_dict())
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(vgae)):
        assert g.tobytes() == w.tobytes()


# ------------------------------------------------------------ trainers
@pytest.fixture(scope="module", params=["dense", "sparse"])
def pair_runs(request, cli_graph):
    """(JAX's and the port's (variables, history, report), and their
    exported embeddings) from the same initial variables, dropout off."""
    _recs, graph, x, pair_data = cli_graph
    kw = dict(hidden_dim=32, latent_dim=16, num_layers=4, epochs=3,
              batch_size=128, adjacency=request.param)
    jcfg, tcfg = JaxGCNConfig(**kw), GCNTrainConfig(**kw)
    pairs = np.asarray(pair_data["pairs"], np.int32)
    labels = np.asarray(pair_data["labels"], np.int32) - 1
    init = _jax_init(x, graph.adjacency, pairs, jcfg)
    with mock.patch.object(jax_train_gcn, "EnhancedVGAE", NoDropoutVGAE):
        jvars, jhist, jrep = jax_train_gcn.train_pair_classification(
            x, graph.adjacency, pairs, labels, jcfg)
    with starting_from(t_train_gcn, t_gcn.EnhancedVGAE,
                       gcn_variables_from_jax(init), dropout_rate=0.0):
        tvars, thist, trep = t_train_gcn.train_pair_classification(
            x, graph.adjacency, pairs, labels, tcfg, device="cpu")
    jemb = jax_train_gcn.export_graph_embeddings(
        jvars, x, graph.adjacency, 32, 16, 4, graph.figure_index,
        adjacency_mode=request.param)
    temb = t_train_gcn.export_graph_embeddings(
        tvars, x, graph.adjacency, 32, 16, 4, graph.figure_index,
        adjacency_mode=request.param, device="cpu")
    return (_np(jvars), jhist, jrep, tvars, thist, trep, jemb, temb)


def test_pair_classification_history_and_report_match_jax(pair_runs):
    jvars, jhist, jrep, tvars, thist, trep = pair_runs[:6]
    assert set(thist) == set(jhist)
    for k in jhist:
        np.testing.assert_allclose(thist[k], jhist[k], rtol=HIST_RTOL)
    assert set(trep) == set(jrep)
    assert trep["confusion_matrix"] == jrep["confusion_matrix"]
    for k in ("test_loss", "test_acc"):
        assert trep[k] == pytest.approx(jrep[k], rel=HIST_RTOL)
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(trep[k], jrep[k], rtol=HIST_RTOL)
    got = gcn_variables_to_jax(tvars)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jvars)):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL)


def test_exported_embeddings_match_jax_and_pickle_alike(pair_runs, tmp_path):
    jemb, temb = pair_runs[6:]
    assert list(temb) == list(jemb)
    for k in jemb:
        assert temb[k].dtype == np.float32 and temb[k].shape == (16,)
    got = np.stack([temb[k] for k in jemb])
    want = np.stack([np.asarray(jemb[k]) for k in jemb])
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    assert float((got * want).sum(1).min()) >= EMB_MIN_COS
    with open(tmp_path / "ge.pkl", "wb") as f:
        pickle.dump(temb, f)
    with open(tmp_path / "ge.pkl", "rb") as f:
        back = pickle.load(f)
    assert all(type(v) is np.ndarray for v in back.values())


def test_vgae_losses_match_jax():
    rng = np.random.default_rng(7)
    a = (rng.random((30, 30)) < 0.2).astype(np.float32)
    rec = rng.random((30, 30)).astype(np.float32)
    mu = rng.standard_normal((30, 8)).astype(np.float32)
    ls = 4 * rng.standard_normal((30, 8)).astype(np.float32)
    got = t_vgae_losses.recon_kl_loss(*map(torch.from_numpy, (a, rec, mu, ls)))
    want = jax_vgae_losses.recon_kl_loss(*map(jnp.asarray, (a, rec, mu, ls)))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for e in (0, 37, 150):
        assert float(t_vgae_losses.annealed_beta(e)) == pytest.approx(
            float(jax_vgae_losses.annealed_beta(e)), rel=1e-7)
    z = rng.standard_normal((30, 8)).astype(np.float32)
    pp, nn_ = rng.integers(0, 30, (10, 2)), rng.integers(0, 30, (12, 2))
    for got, want in zip(
            t_vgae_losses.pull_losses(torch.from_numpy(z), torch.from_numpy(pp),
                                      torch.from_numpy(nn_)),
            jax_vgae_losses.pull_losses(jnp.asarray(z), jnp.asarray(pp),
                                        jnp.asarray(nn_))):
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    zero = t_vgae_losses.pull_losses(torch.from_numpy(z), None,
                                     torch.zeros((0, 2), dtype=torch.long))
    assert [float(v) for v in zero] == [0.0, 0.0]


def _vgae_init(x, adjacency, mode, seed=42):
    split = jax_edges.split_edges(adjacency, val_ratio=0.05, test_ratio=0.1,
                                  seed=seed)
    model = jax_gcn.VGAE(hidden_dim=16, latent_dim=8)
    if mode == "dense":
        a = jax_gcn.normalize_adjacency(
            jnp.asarray(split.train_adjacency.toarray(), jnp.float32))
        return _np(model.init(jax.random.key(seed), jnp.asarray(x), a))
    a = jax_gcn.normalize_adjacency_sparse(split.train_adjacency)
    return _np(model.init(jax.random.key(seed), jnp.asarray(x), a,
                          method=jax_gcn.VGAE.encode))


@pytest.mark.parametrize("mode", ["dense", "sampled"])
def test_vgae_link_prediction_matches_jax(mode):
    """10 epochs from JAX's initial variables; on the sampled objective
    both packages take the same random pairs a step from numpy (JAX's
    ``jax.random.randint`` replaced for the call)."""
    adjacency = _random_graph(150, 0.04, 9)
    x = np.random.default_rng(9).standard_normal((150, 12)).astype(np.float32)
    init = _vgae_init(x, adjacency, mode)
    draws = np.random.default_rng(11)
    fixed = {}

    def negatives(shape):
        if shape not in fixed:
            fixed[shape] = draws.integers(0, 150, shape).astype(np.int32)
        return fixed[shape]

    patch = mock.patch.object(jax.random, "randint",
                              lambda _key, shape, lo, hi: jnp.asarray(
                                  negatives(tuple(shape)))) \
        if mode == "sampled" else mock.patch.object(jax.random, "key",
                                                    jax.random.key)
    with patch:
        jvars, jsplit, jrep = jax_train_vgae.train_vgae_link_prediction(
            x, adjacency, hidden_dim=16, latent_dim=8, epochs=10, mode=mode)
    with starting_from(t_train_vgae, t_gcn.VGAE,
                       gcn_variables_from_jax(init)), \
            mock.patch.object(t_train_vgae, "draw_negatives",
                              lambda _n, shape, gen: torch.as_tensor(
                                  negatives(shape), device=gen.device).long()):
        tvars, tsplit, trep = t_train_vgae.train_vgae_link_prediction(
            x, adjacency, hidden_dim=16, latent_dim=8, epochs=10, mode=mode,
            device="cpu")
    np.testing.assert_array_equal(tsplit.test_edges, jsplit.test_edges)
    assert set(trep) == set(jrep)
    for k in jrep:
        assert trep[k] == pytest.approx(jrep[k], rel=HIST_RTOL, abs=1e-6), k
    got = gcn_variables_to_jax(tvars)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_np(jvars))):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL)


CLI_FLAGS = ["--device", "cpu", "--epochs", "1", "--hidden_dim", "8",
             "--latent_dim", "4", "batch_size=512"]


def test_cli_graph_actions_train_on_the_cli_graph(tmp_path, cli_graph,
                                                  capsys):
    """train_class_pro trains on the JAX CLI's synthetic graph and exports
    its figures' embeddings; train --model VGAE prints JAX's report keys."""
    from patent_tpu_torch.cli.main import main as torch_main

    _recs, graph, _x, _pairs = cli_graph
    flags = ["--path", str(tmp_path)] + CLI_FLAGS
    assert torch_main(["train_class_pro"] + flags) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{\n"):out.rindex("}") + 1])
    assert 0.0 <= report["test_acc"] <= 1.0
    with open(tmp_path / "graph_embeddings" / "image_ge_embeddings_GE.pkl",
              "rb") as f:
        emb = pickle.load(f)
    assert set(emb) == set(graph.figure_index)
    assert all(v.shape == (4,) for v in emb.values())
    assert torch_main(["train", "--model", "VGAE"] + flags) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.rindex("{\n"):])
    assert set(report) == {"roc_auc", "average_precision", "pos_mean",
                           "neg_mean"}
    assert 0.0 <= report["roc_auc"] <= 1.0


def test_load_and_process_a_saved_graph_match_jax(tmp_path, cli_graph):
    """``load_graph`` / ``process_patent_graph`` on a saved adjacency and
    feature matrix (npz and npy) give JAX's arrays."""
    from patent_tpu.data import graph_build as jax_gb
    from patent_tpu_torch.data import graph_build as t_gb

    _recs, graph, x, _p = cli_graph
    adj_path = str(tmp_path / "adjacency.npz")
    graph.save(adj_path)
    for feats in ("features.npy", "features.npz"):
        path = str(tmp_path / feats)
        if feats.endswith(".npy"):
            np.save(path, x)
        else:
            sp.save_npz(path, sp.csr_matrix(x))
        for got, want in zip(t_gb.load_graph(adj_path, path),
                             jax_gb.load_graph(adj_path, path)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        tx, ta = t_gb.process_patent_graph(adj_path, path)
        jx, ja = jax_gb.process_patent_graph(adj_path, path)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("action", ["train_class", "train_gcn"])
def test_cli_aliases_train_the_pair_classifier(tmp_path, cli_graph, action,
                                               capsys):
    """The JAX CLI's aliases of train_class_pro take its path on the port
    too: a report and the export."""
    from patent_tpu_torch.cli.main import main as torch_main

    assert torch_main([action, "--path", str(tmp_path)] + CLI_FLAGS) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{\n"):out.rindex("}") + 1])
    assert {"test_loss", "test_acc", "precision", "recall", "f1"} == \
        set(report)
    with open(tmp_path / "graph_embeddings" / "image_ge_embeddings_GE.pkl",
              "rb") as f:
        assert set(pickle.load(f)) == set(cli_graph[1].figure_index)
