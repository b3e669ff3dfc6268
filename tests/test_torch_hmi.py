"""HMI (Hyperbolic Multi-label Inference) of the port held to the JAX
package on the CPU: the input generator in equal arrays and its pickle
read by either package, the model's logits from JAX's initial params
(carried by the weight bridge, which round-trips in bits), ``train_hmi``'s
history and params over a few epochs (the regular and the tiny-dataset
branch), and ``hmi_label_scores``.  Also the ``plot`` action on a
``train_hyp`` checkpoint, with and without matplotlib."""

import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.data import hmi_inputs as jax_hmi_inputs
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.data.graph_build import build_hetero_graph as jax_graph
from patent_tpu.models.hyperbolic import HMI as JaxHMI
from patent_tpu.train import train_hmi as jax_train_hmi
from patent_tpu_torch.data import hmi_inputs as t_hmi_inputs
from patent_tpu_torch.data import synthetic as t_synth
from patent_tpu_torch.data.graph_build import build_hetero_graph
from patent_tpu_torch.models.hyperbolic import HMI
from patent_tpu_torch.models.weights import (hyperbolic_params_from_jax,
                                             hyperbolic_params_to_jax)
from patent_tpu_torch.train import train_hmi as t_train_hmi

LOGIT_ATOL = 1e-5
# a few epochs of Riemannian Adam: the per-epoch mean losses within 1e-4
# relative, the params within 1e-4 absolute
HIST_RTOL = 1e-4
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the host's cores: two intra-op threads
    each keep torch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """(graph, HMI inputs, figure features) of a 10-patent corpus."""
    recs = t_synth.synthetic_records(num_patents=10, figures_per_patent=3,
                                     seed=0)
    graph = build_hetero_graph(recs)
    inputs = t_hmi_inputs.generate_hmi_inputs(graph, seed=1)
    feats = np.random.default_rng(2).standard_normal(
        (graph.counts["figures"], 24)).astype(np.float32)
    return recs, graph, inputs, feats


def starting_from(module, cls, state):
    """``module``'s ``cls`` made as the trainer makes it, then started
    from ``state`` (JAX's initial params through the bridge)."""

    def make(*args, **kw):
        model = cls(*args, **kw)
        model.load_state_dict(state)
        return model

    return mock.patch.object(module, cls.__name__, make)


def _jax_init(features, embed_dim, num_labels, seed=42):
    x = features / (np.linalg.norm(features, axis=1, keepdims=True)
                    + 1e-8) * 0.3
    model = JaxHMI(feature_dim=features.shape[1], embed_dim=embed_dim,
                   label_num=num_labels)
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(seed), jnp.asarray(x[:1]),
        method=JaxHMI.encode)["params"])


@pytest.mark.parametrize("max_per_patent", [3, 10],
                         ids=["sampled-partners", "all-partners"])
def test_hmi_inputs_equal_jax_and_pickle_both_ways(data, tmp_path,
                                                   max_per_patent):
    """At 3 partners a patent each patent's 9 partners are sampled (the
    port picks them without listing them), at 10 all are taken."""
    recs, graph, _inputs, _f = data
    inputs = t_hmi_inputs.generate_hmi_inputs(
        graph, max_exclusions_per_patent=max_per_patent, seed=1)
    jinputs = jax_hmi_inputs.generate_hmi_inputs(jax_graph(jax_synth.
        synthetic_records(num_patents=10, figures_per_patent=3, seed=0)),
        max_exclusions_per_patent=max_per_patent, seed=1)
    for name in ("y_pos", "y_neg", "implication", "exclusion"):
        got, want = getattr(inputs, name), getattr(jinputs, name)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name
    assert len(inputs.exclusion) and len(inputs.y_neg)
    inputs.save(str(tmp_path / "port.pkl"))
    jinputs.save(str(tmp_path / "jax.pkl"))
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()
    back = jax_hmi_inputs.HMIInputs.load(str(tmp_path / "port.pkl"))
    again = t_hmi_inputs.HMIInputs.load(str(tmp_path / "jax.pkl"))
    for name in ("y_pos", "y_neg", "implication", "exclusion"):
        assert getattr(back, name).tobytes() == \
            getattr(again, name).tobytes() == getattr(inputs, name).tobytes()


def test_hmi_logits_match_jax_and_weights_round_trip(data):
    _r, graph, _inputs, feats = data
    params = _jax_init(feats, 8, 40)
    model = HMI(feature_dim=24, embed_dim=8, label_num=40)
    sd = hyperbolic_params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = hyperbolic_params_to_jax(model.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb and a.tobytes() == b.tobytes()
    # points at several radii, some past the ball (projected first)
    x = feats[:12] * np.linspace(0.01, 0.5, 12, dtype=np.float32)[:, None]
    want = np.asarray(JaxHMI(feature_dim=24, embed_dim=8, label_num=40).apply(
        {"params": params}, jnp.asarray(x)))
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (12, 40)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("batch_size", [64, 4096], ids=["batches", "tiny"])
def test_train_hmi_matches_jax(data, batch_size):
    """Three epochs from JAX's initial params; at batch 4096 every epoch is
    one batch resampled with replacement (the tiny-dataset branch)."""
    _r, graph, inputs, feats = data
    num_labels = graph.num_nodes - graph.counts["figures"]
    # Y_neg draws figure nodes too, below the table: JAX's gather wraps
    # and clamps their indices, and so must the port
    assert (inputs.y_neg[:, 1] < graph.counts["figures"]).any()
    kw = dict(embed_dim=8, epochs=3, batch_size=batch_size)
    jparams, jhist = jax_train_hmi.train_hmi(feats, inputs, num_labels, **kw)
    start = hyperbolic_params_from_jax(_jax_init(feats, 8, num_labels))
    with starting_from(t_train_hmi, HMI, start):
        tparams, thist = t_train_hmi.train_hmi(
            feats, inputs, num_labels, device="cpu", **kw)
    assert len(thist["train_loss"]) == 3
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=HIST_RTOL)
    want = hyperbolic_params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in want.items():
        np.testing.assert_allclose(tparams[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, err_msg=k)
    scores = t_train_hmi.hmi_label_scores(tparams, feats, 8, num_labels,
                                          batch_size=7, device="cpu")
    jscores = jax_train_hmi.hmi_label_scores(jparams, feats, 8, num_labels)
    assert scores.shape == (feats.shape[0], num_labels)
    np.testing.assert_allclose(scores, jscores, atol=1e-3)


def test_plot_action_draws_a_checkpoint_or_says_it_did_not(tmp_path, capsys,
                                                           monkeypatch):
    """``plot`` after ``train_hyp`` writes the label-embedding and dist0
    figures (dist0 from the port's Poincaré ops, JAX's values); where
    matplotlib cannot be imported it writes nothing, says so and exits
    0; without a checkpoint it fails as JAX's does."""
    from patent_tpu.ops import poincare as jax_poincare
    from patent_tpu_torch.cli.main import main as torch_main
    from patent_tpu_torch.train import plots

    path = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        torch_main(["plot", "--path", path])
    assert torch_main(["train_hyp", "--path", path, "--device", "cpu",
                       "--epochs", "1", "batch_size=64"]) == 0
    capsys.readouterr()
    from threadpoolctl import threadpool_limits

    with threadpool_limits(2):                # t-SNE's OpenMP threads
        assert torch_main(["plot", "--path", path]) == 0
    files = capsys.readouterr().out.split()
    assert [os.path.basename(f) for f in files] == [
        "label_embeddings_tsne.png", "dist0_histograms.png"]
    assert all(os.path.getsize(f) > 0 for f in files)
    emb = np.random.default_rng(3).uniform(-0.3, 0.3, (50, 8)).astype(
        np.float32)
    np.testing.assert_allclose(plots._dist0(emb, 2.0), np.asarray(
        jax_poincare.dist0(jnp.asarray(emb), 2.0)), rtol=1e-6)
    z = np.random.default_rng(4).standard_normal((40, 6))
    assert os.path.isfile(plots.plot_graph_embeddings(
        z, 30, str(tmp_path / "g"), {"p": [0, 1, 99]}))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for f in files:
        os.remove(f)
    assert torch_main(["plot", "--path", path]) == 0
    err = capsys.readouterr().err
    assert "matplotlib is not installed" in err and "were not written" in err
    assert not any(os.path.exists(f) for f in files)
