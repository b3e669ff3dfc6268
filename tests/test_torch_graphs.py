"""The port's one-dispatch loops (JAX's jitted ``lax.scan`` epochs and
megabatch encoders, CUDA graphs on the card) and its last public names,
held to patent_tpu on the CPU, where the same functions run their eager
loops.

Tolerances, each for f32 roundings taken in another order:
* ``make_epoch_step`` / ``make_train_step`` against JAX's over two epochs
  from the same weights and batch stream (features scaled by 0.1 as in
  tests/test_torch_hyp_train.py, so that no first-layer bias sits at the
  projection radius where its gradient is f32 noise): the summed metrics
  within ``HIST_RTOL`` = 1e-4 relative and every parameter within
  ``PARAM_ATOL`` = 1e-4, the tolerances tests/test_torch_hyp_train.py
  holds its cross-package resume to;
* the graph-safe optimizer against the Python-number step it replaced:
  equal in bits;
* the scan encoder and ``RetrievalEngine(scan_batches=3)`` at VIT_TINY in
  f32 against JAX's: features within ``FEATURE_ATOL`` = 1e-4 (f32 sums in
  another order through two layers), names and order equal;
* ``fold_u8_normalize_params`` of the f32 and the int8 tower's trees: the
  kernel equal in bits (one f32 product an entry in both), the position
  embedding within 5e-6 (its bias is a 192-term f32 sum in another order,
  entries to ~2; measured 1.1e-6); the folded int8 tower's features
  against the unfolded one's by cosine, at least ``INT8_FOLD_COS`` = 0.999
  (bf16 activations quantized per row to int8; measured 0.99974, the
  JAX package's docstring records 0.9998 for its int8 tower);
* ``PoincareBall``: ``POINT_RTOL`` = 1e-5 relative;
* the eval loss of ``train_hyp_con``'s epoch against JAX's scan: 1e-5
  relative.

The other epoch scans (``train_hmi``, ``train_class_pro``'s GCN,
``train_vgae`` in both objectives) run through the same ``ScanLoop`` and
are held to JAX's trainers in tests/test_torch_hmi.py and
tests/test_torch_graph.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from patent_tpu.input import cache as jax_cache
from patent_tpu.input import native as jax_native
from patent_tpu.models import hyperbolic as jax_hyp
from patent_tpu.models import vit as jax_vit
from patent_tpu.ops import poincare as jax_poincare
from patent_tpu.retrieval import engine as jax_engine
from patent_tpu.train import optim as jax_optim
from patent_tpu.train import train_hyp as jax_th
from patent_tpu.utils import checkpoint as jax_ckpt
from patent_tpu.utils import config as jax_config
from patent_tpu_torch.input import cache as t_cache
from patent_tpu_torch.input import native as t_native
from patent_tpu_torch.models import hyperbolic as torch_hyp
from patent_tpu_torch.models import vit as torch_vit
from patent_tpu_torch.models.weights import (hyperbolic_params_from_jax,
                                             params_from_jax)
from patent_tpu_torch.ops import poincare as t_poincare
from patent_tpu_torch.retrieval import engine as t_engine
from patent_tpu_torch.train import optim
from patent_tpu_torch.train import train_hyp as th
from patent_tpu_torch.train import train_hyp_con as thc
from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data
from patent_tpu_torch.utils import checkpoint
from patent_tpu_torch.utils import config
from patent_tpu_torch.utils import graphs

HIST_RTOL = 1e-4
PARAM_ATOL = 1e-4
FEATURE_ATOL = 1e-4
POINT_RTOL = 1e-5
FEATURE_SCALE = 0.1
INT8_FOLD_COS = 0.999


@pytest.fixture(scope="module")
def cli_td(tmp_path_factory):
    td = ensure_training_data(str(tmp_path_factory.mktemp("td")), True)
    return dataclasses.replace(td, x_figures=td.x_figures
                               * np.float32(FEATURE_SCALE))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- the graph helper

def test_graphed_on_follows_the_device_and_refuses_a_cpu_graph():
    assert graphs.graphed_on("cpu", None) is False
    assert graphs.graphed_on("cuda", None) is True
    assert graphs.graphed_on("cuda", False) is False
    with pytest.raises(ValueError, match="CUDA graph"):
        graphs.graphed_on("cpu", True)
    with pytest.raises(ValueError, match="CUDA graph"):
        th.make_epoch_step(torch.nn.Linear(2, 2), None,
                           config.HypTrainConfig(), graphed=True)


def test_scan_loop_runs_its_steps_in_order_and_keeps_its_buffer():
    seen = []

    def step(i):
        seen.append(int(i))
        return torch.stack([i.float(), 2 * i.float()])

    loop = graphs.ScanLoop(step, "cpu")
    reads = (torch.zeros(3),)
    out = loop.run(4, 2, reads)
    first = loop.out.data_ptr()
    assert out.tolist() == [[0, 0], [1, 2], [2, 4], [3, 6]]
    out = loop.run(3, 2, reads)         # fewer steps: the same buffer
    assert loop.out.data_ptr() == first and out.shape == (3, 2)
    assert seen == [0, 1, 2, 3, 0, 1, 2]


def test_scan_loop_captures_again_for_another_shape_or_generator(
        monkeypatch):
    """The key of what a step reads holds each tensor's address, shape,
    dtype and stride, and the generators by identity (held, so that no
    new one takes a freed one's id): a view of the same storage with
    another shape or stride, or a new generator, drops the capture."""
    loop = graphs.ScanLoop(lambda i: i.float().view(1), "cpu")
    drops = []
    monkeypatch.setattr(loop.graph, "reset", lambda: drops.append(1))
    storage = torch.zeros(6)
    g1, g2 = torch.Generator(), torch.Generator()
    runs = [((storage,), (g1,), 1), ((storage,), (g1,), 0),
            ((storage.view(2, 3),), (g1,), 1),
            ((storage.view(3, 2).t(),), (g1,), 1),
            ((storage.view(3, 2).t(),), (g1,), 0),
            ((storage.view(3, 2).t(),), (g2,), 1),
            ((storage.view(3, 2).t(),), (g2,), 0),
            ((storage.view(3, 2).t(),), (None,), 1),
            ((storage.view(3, 2).t(),), (), 0)]
    for reads, gens, dropped in runs:
        before = len(drops)
        loop.run(2, 1, reads, gens)
        assert len(drops) - before == dropped, (reads[0].shape, gens)
    loop.run(2, 1, (storage,), (g2,))
    assert loop.generators[0] is g2


def test_launch_counters_find_every_kernel_wrapper():
    names = {f.__name__ for f in graphs.launch_counters()}
    int8 = {"quant_attention_block", "quant_attention_cls",
            "quant_mlp_block", "quant_layer_block"}
    assert {"fused_layer_block_bf16", "fused_layer_cls_bf16",
            "bucket_topk_bf16", "bucket_topk_int8", "bucket_topk_poincare",
            "mobius_dense_pallas", "pairwise_dist_pallas", "flash_attention",
            "flash_attention_f32"} | int8 <= names
    # the int8 entries' fast-form counts, which a replay adds to as well
    assert {n + "_fast" for n in int8} <= names


# --------------------------------------------------- graph-safe optimizer

@torch.no_grad()
def _python_number_step(opt, grads, count: int) -> None:
    """The step as it was before the state moved to the device: the count
    a Python int, the bias corrections and the rate Python numbers."""
    c32 = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(opt.b1) ** c32)
    bc2 = float(np.float32(1.0) - np.float32(opt.b2) ** c32)
    scale = -opt.learning_rate(count)
    for n in opt.names:
        p = opt.params[n]
        update, opt.mu[n], opt.nu[n] = opt._leaf(n, p, grads[n], opt.mu[n],
                                                 opt.nu[n], bc1, bc2, scale)
        p.add_(update)


def _opt_params(seed):
    g = torch.Generator().manual_seed(seed)
    ball = t_poincare.project(0.3 * torch.randn(12, 6, generator=g))
    return {"label_emb": torch.nn.Parameter(ball),
            "dense.kernel": torch.nn.Parameter(torch.randn(6, 5,
                                                           generator=g)),
            "dense.bias": torch.nn.Parameter(torch.randn(5, generator=g))}


OPTIMIZERS = {
    "riemannian_adam": lambda p: optim.RiemannianAdam(p, 4e-2, c=1.0),
    "adam": lambda p: optim.Adam(p, 1e-3),
    "adamw": lambda p: optim.AdamW(p, 1e-3, weight_decay=1e-2),
    "adamw_decay": lambda p: optim.AdamW(
        p, 1e-3, weight_decay=1e-2,
        schedule=optim.exponential_decay(1e-3, 7, 0.7, staircase=True)),
    "adamw_smooth_decay": lambda p: optim.AdamW(
        p, 1e-3, schedule=optim.exponential_decay(1e-3, 5, 0.5)),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_graph_safe_optimizer_equals_the_python_number_step(kind):
    """50 steps (the table refilled past its first window) in bits; the
    moments and parameters keep their storage (what a replay reads), the
    count is the device's."""
    make = OPTIMIZERS[kind]
    ours, ref = make(_opt_params(0)), make(_opt_params(0))
    ours.WINDOW = 16
    ptrs = {n: (ours.params[n].data_ptr(), ours.mu[n].data_ptr(),
                ours.nu[n].data_ptr()) for n in ours.names}
    g = torch.Generator().manual_seed(1)
    for count in range(1, 51):
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in ours.params.items()}
        ours.step(grads)
        _python_number_step(ref, grads, count)
        for n in ours.names:
            assert ptrs[n] == (ours.params[n].data_ptr(),
                               ours.mu[n].data_ptr(), ours.nu[n].data_ptr())
    for n in ours.names:
        for a, b in ((ours.params[n], ref.params[n]), (ours.mu[n], ref.mu[n]),
                     (ours.nu[n], ref.nu[n])):
            assert torch.equal(a, b), (kind, n)
    assert int(ours.count) == ours.steps == 50
    assert int(np.asarray(ours.state_tree().count)) == 50


def test_reserve_then_update_equals_step_and_restores_a_count():
    a, b = optim.Adam(_opt_params(2), 1e-3), optim.Adam(_opt_params(2), 1e-3)
    grads = [{n: torch.full_like(p, 0.1 * (k + 1)) for n, p in
              a.params.items()} for k in range(6)]
    assert a.reserve(6) is True and a.reserve(6) is False
    for gr in grads:
        a.update(gr)
    a.advance(6)
    for gr in grads:
        b.step(gr)
    assert all(torch.equal(a.params[n], b.params[n]) for n in a.names)
    c = optim.Adam({n: torch.nn.Parameter(p.detach().clone())
                    for n, p in a.params.items()}, 1e-3)
    c.load_state_leaves(jax.tree_util.tree_leaves(a.state_tree()))
    assert int(c.count) == c.steps == 6
    c.step(grads[0])
    a.step(grads[0])
    assert all(torch.equal(a.params[n], c.params[n]) for n in a.names)


@pytest.mark.parametrize("kind", ["adam", "adamw_decay"])
def test_reserve_refills_every_row_of_a_larger_table(kind):
    """A table reserved for more steps than the window, then a one-step
    refill, then a reserve that the refilled table covers past the
    window: every row is that of its count, in bits against the
    Python-number step."""
    make = OPTIMIZERS[kind]
    ours, ref = make(_opt_params(4)), make(_opt_params(4))
    ours.WINDOW = 16
    g = torch.Generator().manual_seed(6)
    grads = [{n: torch.randn(p.shape, generator=g)
              for n, p in ours.params.items()} for _ in range(51)]
    assert ours.reserve(30) is True
    for gr in grads[:30]:
        ours.update(gr)
    ours.advance(30)
    ours.step(grads[30])
    assert ours.reserve(20) is False     # the refilled table covers them
    for gr in grads[31:51]:
        ours.update(gr)
    ours.advance(20)
    for count, gr in enumerate(grads, start=1):
        _python_number_step(ref, gr, count)
    for n in ours.names:
        for a, b in ((ours.params[n], ref.params[n]), (ours.mu[n], ref.mu[n]),
                     (ours.nu[n], ref.nu[n])):
            assert torch.equal(a, b), (kind, n)


# ------------------------------------------------- train_hyp's epoch steps

def _hyp_pair(td):
    kw = dict(embed_dim=16, hidden_dims=(32,), batch_size=32,
              use_dropout=False, curvature=2.0)
    jcfg, tcfg = jax_config.HypTrainConfig(**kw), config.HypTrainConfig(**kw)
    jm = jax_hyp.HyperbolicEmbeddingModel(
        feature_dim=td.x_figures.shape[1], embed_dim=16,
        label_num=td.num_labels, hidden_dims=(32,), c=2.0)
    params = jm.init(jax.random.key(0),
                     jnp.zeros((1, td.x_figures.shape[1])))["params"]
    jopt = jax_optim.riemannian_adam(jcfg.learning_rate, c=2.0,
                                     mask=jax_optim.manifold_mask(params))
    model = th.build_model(td, tcfg, "cpu")
    model.load_state_dict(hyperbolic_params_from_jax(_np_tree(params)))
    topt = optim.RiemannianAdam(dict(model.named_parameters()),
                                tcfg.learning_rate, c=2.0)
    packed = th.PackedSupervision(td)
    rng = np.random.default_rng(0)
    slots = np.arange(len(packed.usable))
    epochs = [th.stack_epoch_batches(packed, slots, 32, 1, rng)
              for _ in range(3)]
    excl = (td.exclusion.reshape(-1, 2) if td.exclusion.size
            else np.zeros((0, 2), np.int32))
    jdata = (jnp.asarray(td.x_figures), jnp.asarray(td.implication),
             jnp.asarray(excl))
    tdata = (torch.from_numpy(td.x_figures),
             torch.from_numpy(td.implication).long().reshape(-1, 2),
             torch.from_numpy(excl).long())
    return (jm, jcfg, params, jopt, jdata), (model, tcfg, topt, tdata), epochs


def _batches(arrays):
    """The stacked epoch arrays as per-step batches of CPU tensors."""
    packed, widths = th.pack_epoch(arrays)
    return [th.unpack_fields(torch.from_numpy(p), widths) for p in packed]


def _assert_params_close(model, jparams):
    want = hyperbolic_params_from_jax(_np_tree(jparams))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_make_epoch_step_matches_jax(cli_td):
    """Two training epochs and a validation epoch: JAX's whole-epoch scans
    against the port's epoch loop from the same weights and arrays."""
    (jm, jcfg, params, jopt, jdata), (model, tcfg, topt, tdata), epochs = \
        _hyp_pair(cli_td)
    j_train, j_eval = jax_th.make_epoch_step(jm, jopt, jcfg)
    t_train, t_eval = th.make_epoch_step(model, topt, tcfg)
    opt_state = jopt.init(params)
    key = jax.random.key(0)
    for arrays in epochs[:2]:
        params, opt_state, jsum = j_train(
            params, opt_state, tuple(jnp.asarray(a) for a in arrays), key,
            *jdata)
        tsum = t_train(arrays, *tdata)
        assert set(tsum) == set(th.METRICS)
        for k in th.METRICS:
            assert float(tsum[k]) == pytest.approx(float(jsum[k]),
                                                   rel=HIST_RTOL), k
    assert topt.steps == int(topt.count) == 2 * epochs[0][0].shape[0]
    assert int(np.asarray(opt_state.count)) == topt.steps
    _assert_params_close(model, params)
    jv = j_eval(params, tuple(jnp.asarray(a) for a in epochs[2]), *jdata)
    tv = t_eval(epochs[2], *tdata)
    assert set(tv) == set(th.METRICS[:-1])
    for k in tv:
        assert float(tv[k]) == pytest.approx(float(jv[k]), rel=HIST_RTOL), k


def test_make_train_step_matches_jax(cli_td):
    """JAX's per-batch jitted steps against the port's, batch by batch."""
    (jm, jcfg, params, jopt, jdata), (model, tcfg, topt, tdata), epochs = \
        _hyp_pair(cli_td)
    j_step, j_eval = jax_th.make_train_step(jm, jopt, jcfg)
    t_step, t_eval = th.make_train_step(model, topt, tcfg)
    opt_state = jopt.init(params)
    dev = _batches(epochs[0])
    for i, batch in enumerate(dev[:4]):
        jb = tuple(jnp.asarray(a[i]) for a in epochs[0])
        params, opt_state, jm_ = j_step(params, opt_state, jb,
                                        jax.random.key(i), *jdata)
        tm = t_step(batch, *tdata)
        for k in th.METRICS:
            assert float(tm[k]) == pytest.approx(float(jm_[k]),
                                                 rel=HIST_RTOL), k
    _assert_params_close(model, params)
    jv = j_eval(params, tuple(jnp.asarray(a[0]) for a in epochs[1]), *jdata)
    tv = t_eval(_batches(epochs[1])[0], *tdata)
    for k in tv:
        assert float(tv[k]) == pytest.approx(float(jv[k]), rel=HIST_RTOL), k


def test_epoch_step_equals_the_per_step_loop_in_bits(cli_td):
    """Dropout on: the epoch loop (the code the graph captures) against
    the step's gradients and ``optimizer.step`` batch by batch with the
    same generator."""
    cfg = config.HypTrainConfig(embed_dim=16, hidden_dims=(32,),
                                batch_size=32, curvature=2.0)
    runs = []
    for use_epoch in (True, False):
        model = th.build_model(cli_td, cfg, "cpu")
        opt = optim.RiemannianAdam(dict(model.named_parameters()),
                                   cfg.learning_rate, c=2.0)
        gen = torch.Generator().manual_seed(3)
        packed = th.PackedSupervision(cli_td)
        arrays = th.stack_epoch_batches(packed, np.arange(len(packed.usable)),
                                        32, 2, np.random.default_rng(1))
        data = (torch.from_numpy(cli_td.x_figures),
                torch.from_numpy(cli_td.implication).long().reshape(-1, 2),
                torch.zeros(0, 2, dtype=torch.long))
        if use_epoch:
            train, _ = th.make_epoch_step(model, opt, cfg)
            sums = torch.stack(list(train(arrays, *data, gen).values()))
        else:
            loss_fn = th.make_loss_fn(model, cfg)
            metrics = []
            for b in _batches(arrays):
                grads, m = th.step_grads(model, opt, loss_fn, b, *data, gen)
                opt.step(grads)
                metrics.append(m)
            sums = torch.stack(metrics).sum(dim=0)
        runs.append((sums, {k: v.clone() for k, v in
                            model.state_dict().items()}))
    (s1, p1), (s2, p2) = runs
    assert torch.equal(s1, s2)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_train_hyp_con_epochs_match_jax_scans(cli_td):
    """``train_hyp_con``'s eval epoch against JAX's scan from the same
    weights, and its train epoch against one-row epochs in bits (the
    small-corpus step)."""
    cfg = config.HypConTrainConfig(embed_dim=8, hidden_dims=(16,),
                                   batch_size=16)
    jm = jax_hyp.FigureOnlyHyperbolicModel(feature_dim=64, embed_dim=8,
                                           hidden_dims=(16,), c=1.0)
    params = jm.init(jax.random.key(1), jnp.zeros((1, 64)))["params"]
    rng = np.random.default_rng(0)
    a_mat = rng.integers(0, cli_td.x_figures.shape[0], (3, 16))
    p_mat = rng.integers(0, cli_td.x_figures.shape[0], (3, 16))
    xf = jnp.asarray(cli_td.x_figures)

    def jloss(a, p):
        enc = jm.apply({"params": params}, jnp.concatenate([xf[a], xf[p]]),
                       deterministic=True)
        from patent_tpu.losses import hyperbolic_info_nce
        return hyperbolic_info_nce(enc[:16], enc[16:], 1.0, cfg.temperature)

    _, jl = jax.lax.scan(lambda c, ap: (c, jloss(*ap)), None,
                         (jnp.asarray(a_mat), jnp.asarray(p_mat)))
    states = []
    for use_epoch in (True, False):
        model = torch_hyp.FigureOnlyHyperbolicModel(
            feature_dim=64, embed_dim=8, hidden_dims=(16,), c=1.0)
        model.load_state_dict(hyperbolic_params_from_jax(_np_tree(params)))
        opt = optim.Adam(dict(model.named_parameters()), 1e-3)
        x = torch.from_numpy(cli_td.x_figures)
        train, evaluate = thc.make_epoch_step(model, opt, cfg)
        if use_epoch:
            assert float(evaluate(a_mat, p_mat, x)) == pytest.approx(
                float(jnp.mean(jl)), rel=1e-5)
            loss = train(a_mat, p_mat, x, torch.Generator().manual_seed(5))
        else:
            gen = torch.Generator().manual_seed(5)
            loss = torch.stack([train(a[None], p[None], x, gen)
                                for a, p in zip(a_mat, p_mat)]).mean()
        states.append((loss, model.state_dict()))
    assert torch.equal(states[0][0], states[1][0])
    assert all(torch.equal(states[0][1][k], states[1][1][k])
               for k in states[0][1])


# ------------------------------------- the scan encoder and the engine

def _tiny_towers(seed=0):
    jcfg, tcfg = jax_vit.VIT_TINY, torch_vit.VIT_TINY
    jm = jax_vit.VisionTransformer(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.zeros(
        (1, jcfg.image_size, jcfg.image_size, 3)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), params)
    model = torch_vit.VisionTransformer(tcfg, dtype=torch.float32,
                                        fused_layer=False)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return jm, params, model.eval()


def _images(root, n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"fig_{i:03d}.png")
        Image.fromarray(rng.integers(0, 256, (size + 8, size, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("tree", ["f32", "int8"])
def test_fold_u8_normalize_params_matches_jax(tree):
    """The float tower's tree and the int8 tower's (its patch embedding
    unquantized, as in JAX's ``quantize_vit_params``) folded as JAX folds
    them; the folded tower on raw u8 equals the tower on normalized
    pixels."""
    from patent_tpu.models import vit_int8 as jax_vit_int8
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer

    _jm, params, model = _tiny_towers()
    jtree = params["params"]
    if tree == "int8":
        jtree = jax_vit_int8.quantize_vit_params(jtree)
        model = Int8VisionTransformer.from_float(model).eval()
    jfold = jax_vit.fold_u8_normalize_params(jtree)
    # the folded embeddings in the float tree's layout, for the bridge
    want = params_from_jax(_np_tree({"params": {
        **params["params"], "patch_embed": jfold["patch_embed"],
        "position_embedding": jfold["position_embedding"]}}))
    got = torch_vit.fold_u8_normalize_params(model.state_dict())
    assert torch.equal(got["patch_embed"], want["patch_embed"])
    np.testing.assert_allclose(got["position_embedding"].numpy(),
                               want["position_embedding"].numpy(),
                               atol=5e-6, rtol=0)
    assert torch.equal(got["position_embedding"][0],
                       model.state_dict()["position_embedding"][0])
    # the folded tower on raw u8 is the tower on normalized pixels: its
    # f32 token stream within 1e-4, the f32 tower's features within 1e-4,
    # the int8 tower's (bf16 activations quantized per row) by cosine
    px = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    tower = torch_vit.fold_u8_tower(model)
    with torch.no_grad():
        np.testing.assert_allclose(
            tower.tokens(px, torch.float32).numpy(),
            model.tokens(t_engine.device_normalize(px),
                         torch.float32).numpy(), atol=1e-4)
        plain = model(t_engine.device_normalize(px)).float()
        folded = tower(px).float()
    if tree == "f32":
        np.testing.assert_allclose(folded.numpy(), plain.numpy(), atol=1e-4)
    else:
        cos = torch.nn.functional.cosine_similarity(folded, plain, dim=-1)
        assert float(cos.min()) >= INT8_FOLD_COS, float(cos.min())
    assert model.patch_embed.data_ptr() != \
        torch_vit.fold_u8_tower(model).patch_embed.data_ptr()


@pytest.mark.parametrize("fold_u8", [False, True], ids=["u8", "fold_u8"])
def test_scan_encoder_matches_jax(fold_u8):
    jm, params, model = _tiny_towers()
    px = np.random.default_rng(4).integers(0, 256, (3, 2, 32, 32, 3),
                                           dtype=np.uint8)
    want = np.asarray(jax_engine.make_scan_encoder(jm.apply, params,
                                                   fold_u8=fold_u8)(
        jnp.asarray(px)))
    got = t_engine.make_scan_encoder(model, fold_u8=fold_u8)(px)
    assert got.shape == want.shape == (3, 2, 32)
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=0)
    one = t_engine.make_device_normalizing_encoder(model, fold_u8=fold_u8)
    np.testing.assert_allclose(one(px[1]), got[1], atol=1e-6, rtol=0)
    if fold_u8:
        with pytest.raises(ValueError, match="uint8"):
            t_engine.make_scan_encoder(model, fold_u8=True)(
                px.astype(np.float32))


@pytest.mark.parametrize("fold_u8", [False, True], ids=["u8", "fold_u8"])
@pytest.mark.parametrize("n_images", [7, 9], ids=["tail1", "tail2"])
def test_engine_scan_batches_matches_jax(tmp_path, n_images, fold_u8):
    """batch 2, stacks of 3: 7 images leave a last stack of one batch (the
    batch encoder), 9 one of two (padded with a copy of the last)."""
    jm, params, model = _tiny_towers()
    paths = _images(str(tmp_path / "g"), n_images)
    jeng = jax_engine.RetrievalEngine(
        jax_engine.make_device_normalizing_encoder(jm.apply, params,
                                                   fold_u8=fold_u8),
        batch_size=2, num_workers=2, image_size=32, scan_batches=3,
        encode_many_fn=jax_engine.make_scan_encoder(jm.apply, params,
                                                    fold_u8=fold_u8),
        input_dtype="u8")
    calls = {"many": 0, "one": 0}
    many = t_engine.make_scan_encoder(model, fold_u8=fold_u8)
    one = t_engine.make_device_normalizing_encoder(model, fold_u8=fold_u8)

    def count(name, fn):
        def wrapped(b):
            calls[name] += 1
            return fn(b)
        return wrapped

    teng = t_engine.RetrievalEngine(count("one", one), "cpu", batch_size=2,
                                    num_workers=2, image_size=32,
                                    scan_batches=3,
                                    encode_many_fn=count("many", many))
    want, wnames = jeng.encode_paths(paths)
    got, gnames = teng.encode_paths(paths)
    assert gnames == wnames == paths
    assert got.shape == want.shape == (n_images, 32)
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=0)
    assert calls == ({"many": 1, "one": 1} if n_images == 7
                     else {"many": 2, "one": 0})
    with pytest.raises(ValueError, match="encode_many_fn"):
        t_engine.RetrievalEngine(one, "cpu", scan_batches=2)
    with pytest.raises(ValueError, match="input_dtype"):
        t_engine.RetrievalEngine(one, "cpu", input_dtype="f16")


def test_engine_takes_host_normalized_batches(tmp_path):
    """``input_dtype="f32"``: batches normalized on the host pass through
    the encoders, as in JAX's engine."""
    jm, params, model = _tiny_towers()
    paths = _images(str(tmp_path / "g"), 5)
    want, _ = jax_engine.RetrievalEngine(
        jax_engine.make_device_normalizing_encoder(jm.apply, params),
        batch_size=2, num_workers=2, image_size=32, scan_batches=2,
        encode_many_fn=jax_engine.make_scan_encoder(jm.apply, params),
        input_dtype="f32").encode_paths(paths)
    got, _ = t_engine.RetrievalEngine(
        t_engine.make_device_normalizing_encoder(model), "cpu",
        batch_size=2, num_workers=2, image_size=32, scan_batches=2,
        encode_many_fn=t_engine.make_scan_encoder(model),
        input_dtype="f32").encode_paths(paths)
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=0)


# ------------------------------------------------- the last public names

def test_poincare_ball_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 4)) * 0.2).astype(np.float32)
    y = (rng.standard_normal((5, 4)) * 0.2).astype(np.float32)
    v = rng.standard_normal((5, 4)).astype(np.float32)
    m = rng.standard_normal((3, 4)).astype(np.float32)
    jb, tb = jax_poincare.PoincareBall(1.5), t_poincare.PoincareBall(1.5)
    assert repr(tb) == repr(jb) == "PoincareBall(c=1.5)"
    tx, ty, tv, tm = map(torch.from_numpy, (x, y, v, m))
    cases = {
        "projx": ((x * 10,), (tx * 10,)), "expmap0": ((v,), (tv,)),
        "logmap0": ((x,), (tx,)), "expmap": ((x, v * 0.1), (tx, tv * 0.1)),
        "dist": ((x, y), (tx, ty)), "dist0": ((x,), (tx,)),
        "pairwise_dist": ((x, y), (tx, ty)),
        "mobius_add": ((x, y), (tx, ty)),
        "mobius_matvec": ((m, x), (tm, tx)),
        "egrad2rgrad": ((x, v), (tx, tv)), "ptransp": ((x, y, v), (tx, ty, tv)),
        "lambda_x": ((x,), (tx,))}
    for name, (jargs, targs) in cases.items():
        want = np.asarray(getattr(jb, name)(*map(jnp.asarray, jargs)))
        got = getattr(tb, name)(*targs).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=POINT_RTOL, atol=1e-6,
                                   err_msg=name)
    for name, kw in (("dist", {"keepdims": True}), ("dist0", {"keepdims":
                                                             True}),
                     ("lambda_x", {"keepdims": False})):
        args = (x, y) if name == "dist" else (x,)
        want = np.asarray(getattr(jb, name)(*map(jnp.asarray, args), **kw))
        got = getattr(tb, name)(*map(torch.from_numpy, args), **kw).numpy()
        assert got.shape == want.shape, name
    want = np.asarray(jb.mobius_fn_apply(jnp.tanh, jnp.asarray(x)))
    got = tb.mobius_fn_apply(torch.tanh, tx).numpy()
    np.testing.assert_allclose(got, want, rtol=POINT_RTOL, atol=1e-6)


def test_eval_config_equals_jax():
    assert dataclasses.asdict(config.EvalConfig()) == \
        dataclasses.asdict(jax_config.EvalConfig())


def test_save_model_and_load_model_read_each_others(tmp_path):
    state = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
             "step": 3}
    ours = checkpoint.CheckpointManager(str(tmp_path / "t"))
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "j"))
    hp = dict(hidden_dim=64, latent_dim=32, lr=0.001, epochs=20)
    path = checkpoint.save_model(ours, state, "gcn", metadata={"a": 1}, **hp)
    want = jax_ckpt.save_model(theirs, state, "gcn", metadata={"a": 1}, **hp)
    assert os.path.basename(path) == os.path.basename(want) == \
        "gcn_64_d32_l0.001_20"
    for mine, other in ((ours, jax_ckpt.CheckpointManager(str(tmp_path /
                                                              "t"))),
                        (checkpoint.CheckpointManager(str(tmp_path / "j")),
                         theirs)):
        got, ghp = checkpoint.load_model(mine, "gcn_64_d32_l0.001_20")
        exp, ehp = jax_ckpt.load_model(other, "gcn_64_d32_l0.001_20")
        assert ghp == ehp == {"name": "gcn", **hp}
        np.testing.assert_array_equal(got["params"]["w"], exp["params"]["w"])
        assert int(got["step"]) == int(exp["step"]) == 3
    for mod, mgr in ((checkpoint, ours), (jax_ckpt, theirs)):
        mod.save_model(mgr, state, "x", 1, 2, 0.5, 3)
        os.rename(os.path.join(mgr.directory, "x_1_d2_l0.5_3"),
                  os.path.join(mgr.directory, "renamed"))
        with pytest.raises(ValueError, match="not a reference-encoded"):
            mod.load_model(mgr, "renamed")


def test_native_decode_and_probe_match_jax(tmp_path):
    paths = _images(str(tmp_path / "n"), 2, size=40)
    if not (t_native.native_available() and jax_native.native_available()):
        assert t_native.decode_image_native(paths[0]) is None
        assert t_native.probe_native(paths[0]) is None
        pytest.skip("the native decoder did not build here")
    for p in paths:
        assert t_native.probe_native(p) == jax_native.probe_native(p) \
            == (40, 48, 3)
        got = t_native.decode_image_native(p, 32)
        want = jax_native.decode_image_native(p, 32)
        assert got.shape == (32, 32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    bad = str(tmp_path / "n" / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    assert t_native.decode_image_native(bad) is None
    assert t_native.probe_native(bad) is None
    assert jax_native.probe_native(bad) is None


def _cache_rows(tmp_path, n=6, size=16):
    rng = np.random.default_rng(0)
    srcs, rows = [], []
    for i in range(n):
        p = str(tmp_path / f"img_{i}.png")
        with open(p, "wb") as f:
            f.write(b"x" * (i + 1))
        srcs.append(p)
        rows.append(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return srcs, rows


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vacuum_reclaims_dead_rows_and_files_are_shared(tmp_path, pkg):
    """Both packages' vacuum on the same scenario; the compacted cache is
    read by the other package."""
    mod, other = (t_cache, jax_cache) if pkg == "port" else (jax_cache,
                                                             t_cache)
    srcs, rows = _cache_rows(tmp_path)
    cache = mod.DecodedU8Cache(str(tmp_path / "c"), 16)
    for p, r in zip(srcs, rows):
        cache.put(p, r)
    cache.put(srcs[0], rows[0])             # a dead row
    cache.put(srcs[1], rows[1])
    cache.flush()
    before = os.path.getsize(cache.data_path)
    cache.vacuum()
    assert os.path.getsize(cache.data_path) == before - 2 * cache.row_bytes
    cache.put(srcs[2], rows[3])            # after a vacuum, aligned
    cache.flush()
    for p, r in zip(srcs, rows):
        want = rows[3] if p == srcs[2] else r
        np.testing.assert_array_equal(cache.get(p), want)
    cache.close()
    cache.close()
    again = other.DecodedU8Cache(str(tmp_path / "c"), 16)
    assert len(again) == len(srcs)
    np.testing.assert_array_equal(again.get(srcs[4]), rows[4])
    again.close()


def test_vacuum_failure_contract(tmp_path, monkeypatch):
    """A truncated row raises and leaves the cache usable; a failed reopen
    of the compacted file closes the append handle it opened (JAX's
    vacuum leaks it there, cache.py:312)."""
    srcs, rows = _cache_rows(tmp_path)
    cache = t_cache.DecodedU8Cache(str(tmp_path / "c"), 16)
    for p, r in zip(srcs[:4], rows[:4]):
        cache.put(p, r)
    cache.flush()
    with open(cache.data_path, "r+b") as f:
        f.truncate(cache.row_bytes * 2 + 10)
    with pytest.raises(RuntimeError, match="data file inconsistent"):
        cache.vacuum()
    assert not os.path.exists(cache.data_path + ".tmp")
    np.testing.assert_array_equal(cache.get(srcs[1]), rows[1])
    assert cache.get(srcs[3]) is None
    cache.close()

    cache = t_cache.DecodedU8Cache(str(tmp_path / "d"), 16)
    for p, r in zip(srcs, rows):
        cache.put(p, r)
    cache.flush()
    opened = []
    real_open = open

    def tracking_open(path, *a, **kw):
        f = real_open(path, *a, **kw)
        opened.append(f)
        return f

    def refuse(path, flags, *a):
        raise OSError(24, "Too many open files")

    monkeypatch.setattr(t_cache, "open", tracking_open, raising=False)
    monkeypatch.setattr(t_cache.os, "open", refuse)
    with pytest.raises(OSError):
        cache.vacuum()
    monkeypatch.undo()
    appends = [f for f in opened if "ab" in getattr(f, "mode", "")]
    assert appends and all(f.closed for f in appends)
    for p, r in zip(srcs, rows):          # still usable on the old handles
        np.testing.assert_array_equal(cache.get(p), r)
    cache.close()
