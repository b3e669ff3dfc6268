"""The hyperbolic trainers of patent_tpu_torch (train_hyp, train_hyp_con,
Riemannian Adam, the batcher, checkpoints, the CLI) held to patent_tpu on
the CPU, at the JAX CLI's synthetic corpus (40 patents x 4 figures, 64
features) or a 24-patent one, with narrow widths.

Tolerances, each for f32 roundings taken in another order:
* Riemannian Adam against ``riemannian_adam`` over 10 updates (the trust
  region's cap binding at lr 4): params and moments within ``OPT_RTOL`` =
  2e-5 of the largest entry (measured 1.3e-5), but the row at the ball's projection radius
  within ``BOUNDARY_RTOL`` = 1e-4 (λ ≈ 250 there: 1 − c‖x‖² carries the
  f32 rounding of ‖x‖², amplified 1/(1 − c‖x‖²) times; measured 3.8e-5);
* ``Adam`` against ``optax.adam``: within ``OPT_RTOL``;
* one train_hyp (or train_hyp_con) step from JAX's initial params:
  metrics within 1e-5 relative, gradients within 1e-4 of the largest
  entry, updated params within ``STEP_ATOL`` = 1e-4 x lr absolute.  The
  features are scaled by ``FEATURE_SCALE`` = 0.1 there: at the corpus's
  own scale (norm ~9) the encoder's first layer saturates at the
  projection radius, where Möbius-adding its bias changes nothing, so
  that bias's gradient is f32 noise (~1e-6, of either sign in either
  package) and Adam's first step turns it into ±lr;
* the cross-package resume (``batch_size=32 use_dropout=False``, 3 epochs,
  the corpus's own features): the loss history within ``HIST_RTOL`` =
  1e-4 relative, the test mAP within 2e-3, the best checkpoint within
  ``PARAM_ATOL`` = 1e-4 leaf by leaf but the saturated first layer's bias
  (the noise above walks it by ±lr a step in each package), which is held
  by what it cannot change: every figure's encoding through either best
  checkpoint within ``PARAM_ATOL``; of the label table, which Adam moves by
  ~lr on any gradient component whose sign is f32 noise, at most
  ``NOISY_SHARE`` = 1% of the entries (measured 0.55%, 39 of 7,040) may
  differ by more, and none by more than lr;
* the batcher, ``figure_pair_maps`` and a resumed port run: equal.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patent_tpu.cli.main import main as jax_main
from patent_tpu.data import build_feature_matrix as jax_feature_matrix
from patent_tpu.data import build_hetero_graph as jax_hetero_graph
from patent_tpu.data import prepare_training_data as jax_prepare
from patent_tpu.data import synthetic as jax_synth
from patent_tpu.data.prep import figure_pair_maps as jax_pair_maps
from patent_tpu.losses import hyperbolic_info_nce as jax_info_nce
from patent_tpu.models import hyperbolic as jax_hyp
from patent_tpu.train import optim as jax_optim
from patent_tpu.train import train_hyp as jax_th
from patent_tpu.utils import checkpoint as jax_ckpt
from patent_tpu.utils import config as jax_config
from patent_tpu_torch.cli.main import main as torch_main
from patent_tpu_torch.data.prep import figure_pair_maps
from patent_tpu_torch.models import hyperbolic as torch_hyp
from patent_tpu_torch.models.weights import (hyperbolic_params_from_jax,
                                             hyperbolic_params_to_jax)
from patent_tpu_torch.train import optim
from patent_tpu_torch.train import train_hyp as th
from patent_tpu_torch.train import train_hyp_con as thc
from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data
from patent_tpu_torch.utils import checkpoint
from patent_tpu_torch.utils import config
from patent_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_RTOL = 2e-5
FEATURE_SCALE = 0.1
BOUNDARY_RTOL = 1e-4
STEP_ATOL = 1e-4
HIST_RTOL = 1e-4
PARAM_ATOL = 1e-4
NOISY_SHARE = 0.01


def quiet():
    return MetricsLogger(print_every=0)


@pytest.fixture(scope="module")
def cli_td(tmp_path_factory):
    """The CLI's synthetic prepared data (40 patents x 4 figures, 64)."""
    return ensure_training_data(str(tmp_path_factory.mktemp("td")), True)


@pytest.fixture(scope="module")
def small_td():
    """test_train_engines.py's corpus: 24 patents x 4 figures, 32 wide."""
    rec = jax_synth.synthetic_records(num_patents=24, figures_per_patent=4,
                                      seed=0)
    g = jax_hetero_graph(rec)
    x = jax_feature_matrix(g, jax_synth.synthetic_features(rec, dim=32,
                                                           seed=0),
                           feature_dim=32)
    return jax_prepare(g, x, neg_ratio=4, fig_pair_ratio=2, seed=0)


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


def _max_gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ------------------------------------------------------------- dropout

@pytest.mark.parametrize("kind", ["embedding", "figure_only"])
def test_seeded_train_mode_forward_is_reproducible(kind):
    """Dropout draws its masks from the generator passed to forward: two
    forwards with one seed are equal, another seed differs, and eval mode
    ignores the generator."""
    if kind == "embedding":
        model = torch_hyp.HyperbolicEmbeddingModel(
            feature_dim=24, embed_dim=8, label_num=10, hidden_dims=(16, 12),
            c=2.0, generator=torch.Generator().manual_seed(0))
    else:
        model = torch_hyp.FigureOnlyHyperbolicModel(
            feature_dim=24, embed_dim=8, hidden_dims=(16, 12), c=2.0,
            generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (20, 24)).astype(np.float32))

    def run(seed):
        torch.manual_seed(1234 + seed)     # the global stream must not matter
        return model(x, torch.Generator().manual_seed(seed))

    model.train()
    a, b, other = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.allclose(a, other, atol=1e-3)
    model.eval()
    assert torch.equal(model(x, torch.Generator().manual_seed(7)),
                       model(x, torch.Generator().manual_seed(8)))
    assert not torch.allclose(model(x), a, atol=1e-3)


# ---------------------------------------------------------- optimizers

def _opt_tree(rng, c):
    """A manifold table with one row at 0.999 of the radius, a hyperbolic
    bias and a Euclidean kernel."""
    table = rng.standard_normal((6, 16))
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    table *= rng.uniform(0.1, 0.9, (6, 1)) / np.sqrt(c)
    table[0] *= 0.999 / (np.linalg.norm(table[0]) * np.sqrt(c))
    return {"label_emb": table.astype(np.float32),
            "enc": {"hyp_bias": (0.01 * rng.standard_normal(16)).astype(
                np.float32),
                    "kernel": rng.standard_normal((16, 16)).astype(
                        np.float32)}}


@pytest.mark.parametrize("lr,c", [(6e-3, 2.0), (4.0, 1e-4)],
                         ids=["lr6e-3", "trust_region"])
def test_riemannian_adam_matches_jax_over_ten_updates(lr, c):
    """At lr 4 the direction (norm ~4 for 16 entries) is cut to 10 / lr;
    c 1e-4 (a ball of radius 100) keeps the capped step off the boundary,
    where the cap would not show."""
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng, c)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 3.0, tree) for _ in range(10)]
    jopt = jax_optim.riemannian_adam(lr, c=c,
                                     mask=jax_optim.manifold_mask(tree))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    names = {"label_emb": ("label_emb",), "enc.hyp_bias": ("enc", "hyp_bias"),
             "enc.kernel": ("enc", "kernel")}

    def leaf(t, path):
        for k in path:
            t = t[k]
        return np.asarray(t)

    def params():
        return {n: torch.nn.Parameter(torch.from_numpy(leaf(tree, p).copy()))
                for n, p in names.items()}

    tp, free = params(), params()
    topt = optim.RiemannianAdam(tp, lr, c=c)
    uncapped = optim.RiemannianAdam(free, lr, c=c)
    uncapped.max_norm = 1e30
    assert topt.mask == {"label_emb": True, "enc.hyp_bias": True,
                         "enc.kernel": False}
    for g in grads:
        up, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        for o in (topt, uncapped):
            o.step({n: torch.from_numpy(leaf(g, p)) for n, p in names.items()})
    for n, p in names.items():
        for got, want in ((tp[n].detach(), leaf(jp, p)),
                          (topt.mu[n], leaf(js.mu, p)),
                          (topt.nu[n], leaf(js.nu, p))):
            scale = max(np.abs(want).max(), 1e-30)
            if n == "label_emb":      # row 0 sits at the projection radius
                assert _max_gap(got[0], want[0]) <= BOUNDARY_RTOL * scale
                got, want = got[1:], want[1:]
            assert _max_gap(got, want) <= OPT_RTOL * scale, (n, lr)
    capped = not torch.allclose(free["label_emb"], tp["label_emb"])
    assert capped == (lr == 4.0)
    assert topt.count == int(js.count) == 10
    # the state flattens as JAX's: count, then mu's and nu's leaves
    leaves = jax.tree_util.tree_leaves(js)
    ours = jax.tree_util.tree_leaves(topt.state_tree())
    assert len(ours) == len(leaves)
    assert all(np.shape(a) == np.shape(b) for a, b in zip(ours, leaves))
    assert np.asarray(ours[0]).dtype == np.int32


def test_riemannian_adam_trust_region_caps_the_step():
    """From the origin of a ball of radius 100 (c 1e-4, λ_0 = 2), a fresh
    step's direction (64 entries of ~1: norm 8) is cut to 10 / lr = 5, a
    tangent step of 10: the point lands at tanh(√c · 10) / √c."""
    c, lr = 1e-4, 2.0
    p = torch.nn.Parameter(torch.zeros(2, 64))
    opt = optim.RiemannianAdam({"label_emb": p}, lr, c=c)
    opt.step({"label_emb": torch.ones(2, 64)})
    want = float(np.tanh(np.sqrt(c) * 10.0) / np.sqrt(c))
    assert p.detach().norm(dim=1).tolist() == pytest.approx([want] * 2,
                                                            rel=1e-5)
    # state restored from its flat leaves continues the same way
    again = optim.RiemannianAdam({"label_emb": torch.nn.Parameter(
        p.detach().clone())}, lr, c=c)
    again.load_state_leaves(jax.tree_util.tree_leaves(opt.state_tree()))
    opt.step({"label_emb": torch.ones(2, 64)})
    again.step({"label_emb": torch.ones(2, 64)})
    assert torch.equal(again.params["label_emb"], p)
    with pytest.raises(ValueError):
        again.load_state_leaves([np.asarray(1, np.int32)])


def test_adam_matches_optax_adam():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    jopt = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in tree.items()}
    topt = optim.Adam(tp, 1e-3)
    for _ in range(10):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tree.items()}
        up, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        topt.step({k: torch.from_numpy(v) for k, v in g.items()})
    for k in tree:
        scale = np.abs(np.asarray(jp[k])).max()
        assert _max_gap(tp[k].detach(), jp[k]) <= OPT_RTOL * scale
        assert _max_gap(topt.mu[k], js[0].mu[k]) <= OPT_RTOL * np.abs(
            np.asarray(js[0].mu[k])).max()


def test_manifold_mask_and_global_norm_match_jax():
    rng = np.random.default_rng(2)
    tree = {"encoder": {"first_layer": {"hyp_bias": rng.standard_normal(3),
                                        "kernel": rng.standard_normal((4, 3))},
                        "final_layer": {"hyp_bias": rng.standard_normal(2),
                                        "kernel": rng.standard_normal((3, 2))}},
            "label_emb": rng.standard_normal((5, 2))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    flat = hyperbolic_params_from_jax(tree)
    want_mask = jax_optim.manifold_mask(tree)
    mask = optim.manifold_mask(flat)
    for n, m in mask.items():
        node = want_mask
        for k in n.split("."):
            node = node[k]
        assert node == m
    assert [k for k in optim.jax_order(flat)] == [
        ".".join(str(getattr(k, "key", k)) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert float(optim.global_norm(flat)) == pytest.approx(
        float(optax.global_norm(tree)), rel=1e-6)


# ------------------------------------------------------------- batcher

def test_figure_pair_maps_and_batches_equal_jax(cli_td):
    assert figure_pair_maps(cli_td) == jax_pair_maps(cli_td)
    jp = jax_th.PackedSupervision(cli_td)
    tp = th.PackedSupervision(cli_td)
    for f in ("usable", "pos_patent", "neg_patents", "neg_patent_len",
              "pos_figs", "pos_fig_len", "neg_figs", "neg_fig_len"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    slots = tp.slots_for(tp.usable[::2])
    assert slots.tobytes() == jp.slots_for(jp.usable[::2]).tobytes()
    for num_neg in (1, 3):
        ja = jax_th.stack_epoch_batches(jp, slots, 32, num_neg,
                                        np.random.default_rng(5))
        ta = th.stack_epoch_batches(tp, slots, 32, num_neg,
                                    np.random.default_rng(5))
        assert len(ja) == len(ta) == 6
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        # the packed copy splits back into the fields
        packed, widths = th.pack_epoch(ta)
        for i, batch in enumerate(th.unpack_fields(torch.from_numpy(p),
                                                   widths) for p in packed):
            for a, b in zip(ta, batch):
                np.testing.assert_array_equal(a[i], b.numpy())
    jb = list(jax_th.make_batches(cli_td, cli_td.y_pos[:50, 0], 16, 2,
                                  np.random.default_rng(6)))
    tb = list(th.make_batches(cli_td, cli_td.y_pos[:50, 0], 16, 2,
                              np.random.default_rng(6)))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        for f in th.BATCH_FIELDS:
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()


# ---------------------------------------------------------- one step

def _step_cfgs(**kw):
    args = dict(embed_dim=16, hidden_dims=(32,), batch_size=32,
                use_dropout=False, curvature=2.0)
    args.update(kw)
    return jax_config.HypTrainConfig(**args), config.HypTrainConfig(**args)


def test_one_train_hyp_step_matches_jax(cli_td):
    """From JAX's initial params through the bridge, use_dropout=False:
    the step's metrics, every gradient and the updated params."""
    jcfg, tcfg = _step_cfgs()
    td = dataclasses.replace(cli_td, x_figures=cli_td.x_figures
                             * np.float32(FEATURE_SCALE))
    jm = jax_hyp.HyperbolicEmbeddingModel(
        feature_dim=64, embed_dim=16, label_num=td.num_labels,
        hidden_dims=(32,), c=2.0)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 64)))["params"]
    packed = jax_th.PackedSupervision(td)
    arrays = jax_th.stack_epoch_batches(packed, np.arange(len(packed.usable)),
                                        32, 1, np.random.default_rng(0))
    batch = tuple(jnp.asarray(a[0]) for a in arrays)
    xf, impl = jnp.asarray(td.x_figures), jnp.asarray(td.implication)
    excl = jnp.zeros((0, 2), jnp.int32)
    loss_fn = jax_th._make_loss_fn(jm, jcfg)
    (_, jmet), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, batch, jax.random.key(0), xf, impl, excl)
    jopt = jax_optim.riemannian_adam(jcfg.learning_rate, c=2.0,
                                     mask=jax_optim.manifold_mask(params))
    up, _ = jopt.update(jgrads, jopt.init(params), params)
    jnew = _jax_tree(optax.apply_updates(params, up))
    jgrads = _jax_tree(jgrads)

    model = th.build_model(td, tcfg, "cpu")
    model.load_state_dict(hyperbolic_params_from_jax(_jax_tree(params)))
    topt = optim.RiemannianAdam(dict(model.named_parameters()),
                                tcfg.learning_rate, c=2.0)
    tloss = th.make_loss_fn(model, tcfg)
    packed, widths = th.pack_epoch(tuple(a[:1] for a in arrays))
    tbatch = th.unpack_fields(torch.from_numpy(packed[0]), widths)
    grads, got = th.step_grads(model, topt, tloss, tbatch,
                               torch.from_numpy(td.x_figures),
                               torch.from_numpy(td.implication).long(),
                               torch.zeros(0, 2, dtype=torch.long))
    topt.step(grads)
    for name, v in zip(th.METRICS, got.tolist()):
        want = (float(optax.global_norm(jgrads)) if name == "grad_norm"
                else float(jmet[name]))
        assert v == pytest.approx(want, rel=1e-5), name
    tgrads = hyperbolic_params_to_jax({n: p.grad for n, p in
                                       model.named_parameters()})
    tnew = hyperbolic_params_to_jax(model.state_dict())
    for (path, want), got_g, got_p, want_p in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree_util.tree_leaves(tgrads),
            jax.tree_util.tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        scale = max(np.abs(want).max(), 1e-30)
        assert _max_gap(got_g, want) <= 1e-4 * scale, path
        assert _max_gap(got_p, want_p) <= STEP_ATOL * tcfg.learning_rate, path


# --------------------------------------------------- resume and best

def _tiny(**kw):
    args = dict(embed_dim=8, hidden_dims=(16,), batch_size=32,
                curvature=1.0, patience=10)
    args.update(kw)
    return config.HypTrainConfig(**args)


def test_port_resume_equals_an_uninterrupted_run(small_td, tmp_path):
    """Dropout on: epochs 1-2, then --resume to 4, equals 4 epochs in one
    run bit for bit (history and best params), because ``latest`` carries
    the batch stream and the dropout generator's state."""
    ref_best, ref_hist = th.train_hyperbolic_retrieval(
        small_td, _tiny(epochs=4), logger=quiet(),
        ckpt=checkpoint.CheckpointManager(str(tmp_path / "ref")),
        device="cpu")
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "res"))
    _b, hist_a = th.train_hyperbolic_retrieval(small_td, _tiny(epochs=2),
                                               logger=quiet(), ckpt=ckpt,
                                               device="cpu")
    best, hist = th.train_hyperbolic_retrieval(
        small_td, _tiny(epochs=4), logger=quiet(), ckpt=ckpt, resume=True,
        device="cpu")
    assert hist_a["train_loss"] == ref_hist["train_loss"][:2]
    assert hist["train_loss"] == ref_hist["train_loss"]
    assert hist["val_loss"] == ref_hist["val_loss"]
    assert hist["test_indices"] == ref_hist["test_indices"]
    for k in ref_best:
        assert torch.equal(best[k], ref_best[k]), k
    saved = ckpt.restore("latest")
    assert th.RNG_KEY in saved and int(saved["epoch"]) == 4


def test_best_checkpoint_keeps_the_best_epochs_weights(cli_td, tmp_path):
    """The optimizer updates the parameters in place: the best params must
    be a copy, or the best checkpoint would hold the last epoch's."""
    cfg = config.HypTrainConfig(embed_dim=16, hidden_dims=(32,), epochs=3,
                                batch_size=32)
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "a"))
    best, hist = th.train_hyperbolic_retrieval(cli_td, cfg, logger=quiet(),
                                               ckpt=ckpt, device="cpu")
    best_epoch = int(np.argmin(hist["val_loss"])) + 1
    assert best_epoch < cfg.epochs, hist["val_loss"]     # trains past it
    name = th.best_checkpoint_name(cfg)
    assert name == "best_retrieval_model_c2.0_e16"
    assert ckpt.metadata(name) == {"val_loss": min(hist["val_loss"]),
                                   "epoch": best_epoch}
    saved = hyperbolic_params_from_jax(ckpt.restore(name)["params"])
    latest = hyperbolic_params_from_jax(ckpt.restore("latest")["params"])
    # a run stopped at the best epoch ends on the same weights
    cut = config.HypTrainConfig(embed_dim=16, hidden_dims=(32,),
                                epochs=best_epoch, batch_size=32)
    ckpt2 = checkpoint.CheckpointManager(str(tmp_path / "b"))
    th.train_hyperbolic_retrieval(cli_td, cut, logger=quiet(), ckpt=ckpt2,
                                  device="cpu")
    at_best = hyperbolic_params_from_jax(ckpt2.restore("latest")["params"])
    for k in saved:
        assert torch.equal(saved[k], at_best[k]), k
        assert torch.equal(best[k], at_best[k]), k
    assert not torch.equal(saved["label_emb"], latest["label_emb"])


def test_map_validation_and_its_argument(small_td):
    _p, hist = th.train_hyperbolic_retrieval(
        small_td, _tiny(epochs=2, validate_with="map"), logger=quiet(),
        device="cpu")
    assert len(hist["val_map"]) == 2
    assert all(0.0 <= m <= 1.0 for m in hist["val_map"])
    assert hist["val_loss"] != [-m for m in hist["val_map"]]   # the loss kept
    with pytest.raises(ValueError):
        th.train_hyperbolic_retrieval(small_td, _tiny(validate_with="nope"),
                                      logger=quiet(), device="cpu")


@pytest.mark.parametrize("trainer", ["train_hyp", "train_hyp_con"])
def test_trainers_run_on_the_card_unless_asked(trainer, small_td,
                                               monkeypatch):
    """No device given: the trainers take the card, and where none is
    visible they stop with an error instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if trainer == "train_hyp":
        run = lambda: th.train_hyperbolic_retrieval(
            small_td, _tiny(epochs=1), logger=quiet())
    else:
        run = lambda: thc.train_hyperbolic_contrastive(
            small_td, config.HypConTrainConfig(embed_dim=8, hidden_dims=(16,),
                                               epochs=1, batch_size=16),
            logger=quiet())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run()


def _history(path):
    latest = jax_ckpt.CheckpointManager(os.path.join(path, "models")
                                        ).restore("latest")
    return [float(v) for v in latest["hist_train_loss"]], \
        [float(v) for v in latest["hist_val_loss"]]


def _test_map(out):
    return float(re.search(r"test mAP \(label retrieval\): (\S+)",
                           out).group(1))


def test_cross_package_resume(tmp_path, capsys):
    """JAX trains 1 epoch; JAX resumes to 3 (its uninterrupted run, as
    JAX's own resume test shows); the port resumes JAX's epoch-1 latest to
    3, and JAX resumes the port's epoch-2 latest to 3: histories, best
    checkpoints and test mAP agree."""
    flags = ["--synthetic", "batch_size=32", "use_dropout=False"]
    j1 = str(tmp_path / "j")
    assert jax_main(["train_hyp", "--path", j1, "--epochs", "1"] + flags) == 0
    t1, t2 = str(tmp_path / "t"), str(tmp_path / "t2")
    shutil.copytree(j1, t1)
    capsys.readouterr()
    assert jax_main(["train_hyp", "--path", j1, "--epochs", "3",
                     "--resume"] + flags) == 0
    want_map = _test_map(capsys.readouterr().out)
    assert torch_main(["train_hyp", "--path", t1, "--epochs", "2",
                       "--resume", "--device", "cpu"] + flags) == 0
    shutil.copytree(t1, t2)
    capsys.readouterr()
    assert torch_main(["train_hyp", "--path", t1, "--epochs", "3",
                       "--resume", "--device", "cpu"] + flags) == 0
    got_map = _test_map(capsys.readouterr().out)
    assert jax_main(["train_hyp", "--path", t2, "--epochs", "3",
                     "--resume"] + flags) == 0
    want_tl, want_vl = _history(j1)
    assert len(want_tl) == 3
    for path in (t1, t2):
        tl, vl = _history(path)
        np.testing.assert_allclose(tl, want_tl, rtol=HIST_RTOL)
        np.testing.assert_allclose(vl, want_vl, rtol=HIST_RTOL)
    assert got_map == pytest.approx(want_map, abs=2e-3)
    name = "best_retrieval_model_c2.0_e128"
    want = jax_ckpt.CheckpointManager(os.path.join(j1, "models")).restore(
        name)
    td = ensure_training_data(j1, False)
    x = torch.from_numpy(td.x_figures)

    def encode(params):
        model = th.build_model(td, config.HypTrainConfig(), "cpu")
        model.load_state_dict(hyperbolic_params_from_jax(params))
        with torch.no_grad():
            return model.eval()(x)

    for path in (t1, t2):
        got = jax_ckpt.CheckpointManager(os.path.join(path, "models")
                                         ).restore(name)
        assert int(got["epoch"]) == int(want["epoch"])
        gp = hyperbolic_params_from_jax(got["params"])
        wp = hyperbolic_params_from_jax(want["params"])
        for k in gp:
            gap = (gp[k] - wp[k]).abs()
            if k == "label_emb":
                assert float((gap > PARAM_ATOL).float().mean()) <= NOISY_SHARE
                assert float(gap.max()) <= 6e-3          # the lr
            elif k != "encoder.first_layer.hyp_bias":
                assert float(gap.max()) <= PARAM_ATOL, k
        assert _max_gap(encode(got["params"]), encode(want["params"])) \
            <= PARAM_ATOL
    # the port's latest restores into JAX's optimizer state structure
    latest = jax_ckpt.CheckpointManager(os.path.join(t1, "models")
                                        ).restore("latest")
    assert isinstance(latest["opt_state"], list)
    assert len(latest["opt_state"]) == 1 + 2 * len(
        jax.tree_util.tree_leaves(latest["params"]))


# ------------------------------------------------------- train_hyp_con

def test_train_hyp_con_loss_step_and_run(small_td):
    """The InfoNCE loss and its gradients at a deterministic forward from
    JAX's params, one Adam update against optax.adam's, and the run: the
    training loss falls (what test_train_engines holds of JAX's)."""
    td = dataclasses.replace(small_td, x_figures=small_td.x_figures
                             * np.float32(FEATURE_SCALE))
    jm = jax_hyp.FigureOnlyHyperbolicModel(feature_dim=32, embed_dim=8,
                                           hidden_dims=(16,), c=1.0)
    params = jm.init(jax.random.key(1), jnp.zeros((1, 32)))["params"]
    a = np.arange(0, 32, 2)
    p = a + 1
    xf = jnp.asarray(td.x_figures)

    def jloss(prm):
        both = jnp.concatenate([xf[a], xf[p]])
        enc = jm.apply({"params": prm}, both, deterministic=True)
        return jax_info_nce(enc[:16], enc[16:], 1.0, 0.07)

    jl, jg = jax.value_and_grad(jloss)(params)
    jopt = optax.adam(1e-3)
    up, _ = jopt.update(jg, jopt.init(params), params)
    jnew = _jax_tree(optax.apply_updates(params, up))
    tcfg = config.HypConTrainConfig(embed_dim=8, hidden_dims=(16,))
    model = torch_hyp.FigureOnlyHyperbolicModel(feature_dim=32, embed_dim=8,
                                                hidden_dims=(16,), c=1.0)
    model.load_state_dict(hyperbolic_params_from_jax(_jax_tree(params)))
    loss_fn = thc.make_loss_fn(model, tcfg)
    tx = torch.from_numpy(td.x_figures)
    ta, tp = torch.from_numpy(a), torch.from_numpy(p)
    tl = loss_fn(ta, tp, tx, deterministic=True)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    topt = optim.Adam(dict(model.named_parameters()), 1e-3)
    model.zero_grad()
    tl.backward()
    grads = {n: q.grad.clone() for n, q in model.named_parameters()}
    topt.step(grads)
    tg = hyperbolic_params_to_jax(grads)
    tnew = hyperbolic_params_to_jax(model.state_dict())
    for g, w, q, wq in zip(jax.tree_util.tree_leaves(tg),
                           jax.tree_util.tree_leaves(_jax_tree(jg)),
                           jax.tree_util.tree_leaves(tnew),
                           jax.tree_util.tree_leaves(jnew)):
        assert _max_gap(g, w) <= 1e-4 * max(np.abs(w).max(), 1e-30)
        assert _max_gap(q, wq) <= STEP_ATOL * 1e-3
    cfg = config.HypConTrainConfig(embed_dim=8, hidden_dims=(16,), epochs=3,
                                   batch_size=16)
    best, hist = thc.train_hyperbolic_contrastive(td, cfg, logger=quiet(),
                                                  device="cpu")
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert set(best) == set(model.state_dict())


def test_configs_equal_jax():
    for name in ("HypTrainConfig", "HypConTrainConfig"):
        assert dataclasses.asdict(getattr(config, name)()) == \
            dataclasses.asdict(getattr(jax_config, name)())


# ---------------------------------------------------- checkpoint, logs

def test_checkpoint_manager_layout_is_jax(tmp_path):
    """Either manager reads the other's checkpoint; a NamedTuple state
    comes back as its flat leaves; metadata beside the directory (the
    manager) or inside it (the module's save)."""
    state = {"params": {"b": np.arange(3, dtype=np.float32),
                        "a": {"k": np.ones((2, 2), np.float32)}},
             "opt_state": optim.RiemannianAdamState(
                 np.asarray(4, np.int32), {"x": np.zeros(2, np.float32)},
                 {"x": np.ones(2, np.float32)}),
             "step": 7, "best_val": float("inf")}
    ours = checkpoint.CheckpointManager(str(tmp_path / "t"))
    ours.save("latest", state, metadata={"epoch": 2})
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "j"))
    theirs.save("latest", state, metadata={"epoch": 2})
    for d in ("t", "j"):
        assert sorted(os.listdir(tmp_path / d)) == ["latest",
                                                    "latest.meta.json"]
        with open(tmp_path / d / "latest" / "manifest.json") as f:
            manifest = json.load(f)
        if d == "t":
            want_manifest = manifest
        else:
            assert manifest == want_manifest
    back = theirs.restore("latest")
    mine = ours.restore("latest")
    assert isinstance(back["opt_state"], list) and len(back["opt_state"]) == 3
    for got in (back, mine):
        assert int(got["opt_state"][0]) == 4
        np.testing.assert_array_equal(got["params"]["a"]["k"], np.ones((2, 2)))
        assert int(got["step"]) == 7 and np.isinf(got["best_val"])
    assert ours.metadata("latest") == {"epoch": 2}
    checkpoint.save(str(tmp_path / "t"), "ft", {"params": {"w": np.zeros(1)}},
                    metadata={"val_loss": 1.5})
    assert ours.metadata("ft") == {"val_loss": 1.5}
    assert ours.metadata("nothing") is None
    assert ours.exists("ft") and not ours.exists("nothing")
    assert ours.latest_step() is None
    name = checkpoint.reference_checkpoint_name("gcn", 512, 256, 0.002, 100)
    assert name == jax_ckpt.reference_checkpoint_name("gcn", 512, 256,
                                                      0.002, 100)
    assert checkpoint.parse_checkpoint_name(name) == \
        jax_ckpt.parse_checkpoint_name(name)
    with pytest.raises(ValueError):
        checkpoint.parse_checkpoint_name("not_encoded")


def test_metrics_logger_writes_jsonl_and_goes_on_without_wandb(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = MetricsLogger(log_dir=str(tmp_path), run_name="r", use_wandb=True,
                        print_every=2)
    log.log(1, {"loss": torch.tensor(0.5)})
    log.log(2, {"loss": 0.25, "note": "x"})
    log.close()
    lines = [json.loads(s) for s in open(tmp_path / "r.jsonl")]
    assert [r["loss"] for r in lines] == [0.5, 0.25]
    assert lines[1]["note"] == "x" and lines[0]["step"] == 1
    out = capsys.readouterr().out
    assert "step 2  loss=0.2500  note=x" in out and "step 1" not in out


# ----------------------------------------------------------------- CLI

def test_cli_trains_without_jax(tmp_path):
    """train_hyp (then test and --resume), train_hyp_con and prep through
    the port's CLI in a process that loads no module of JAX or of the JAX
    package; test serves the port-trained best checkpoint."""
    d = str(tmp_path / "run")
    code = ("import sys\n"
            "from patent_tpu_torch.cli.main import main\n"
            f"d = {d!r}\n"
            "assert main(['prep', '--path', d]) == 0\n"
            "assert main(['train_hyp', '--path', d, '--device', 'cpu',\n"
            "             '--epochs', '1', 'batch_size=64']) == 0\n"
            "assert main(['train_hyp', '--path', d, '--device', 'cpu',\n"
            "             '--epochs', '2', '--resume', 'batch_size=64']) == 0\n"
            "assert main(['test', '--path', d, '--device', 'cpu']) == 0\n"
            "assert main(['train_hyp_con', '--path', d, '--device', 'cpu',\n"
            "             '--epochs', '1', '--learning_rate', '0.002']) == 0\n"
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
    assert "prepared: 160 Y_pos" in out
    assert "resumed_from_epoch=1" in out
    assert re.search(r"test mAP \(label retrieval\): \S+", out)
    assert re.search(r"^mAP \(label retrieval\): \S+", out, re.M)
    logs = sorted(os.listdir(os.path.join(d, "logs")))
    assert logs == ["train_hyp.jsonl", "train_hyp_con.jsonl"]
    assert sorted(os.listdir(os.path.join(d, "models"))) == [
        "best_retrieval_model_c2.0_e128",
        "best_retrieval_model_c2.0_e128.meta.json", "latest"]
