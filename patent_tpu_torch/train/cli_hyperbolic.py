"""The hyperbolic actions of the port's CLI (port of their branches of
patent_tpu/cli/main.py): ``train_hyp`` (train/train_hyp.py, with
``--learning_rate``, ``--epochs``, ``--resume`` and the final test mAP),
``train_hyp_con`` (train/train_hyp_con.py), ``prep`` (the synthetic
prepared_training_data), and the serving actions ``test``, ``infer`` and
``dist``.

Data: ``--path``/prepared_training_data (``training_data.npz`` +
``label_offsets.json``) when present and ``--synthetic`` is not given;
else the synthetic one of the JAX CLI (40 patents × 4 figures, features of
64), built and saved there.  Weights: the checkpoint ``--checkpoint`` or
``best_retrieval_model_c{curvature}_e{embed_dim}`` under ``--path``/models,
as ``train_hyp`` (either package's) writes it ({"params", "step",
"epoch"}); without it the action exits 1. ``test`` and ``infer`` print the
label-retrieval mAP over every figure with a positive patent; ``dist``
prints the distance analysis as JSON and the files it wrote under
``--path``/analysis. ``key=value`` overrides set ``HypTrainConfig`` fields
(widths, curvature; ``HypConTrainConfig``'s for train_hyp_con). The
training actions log to ``--path``/logs/<action>.jsonl and keep their
checkpoints under ``--path``/models.
"""

from __future__ import annotations

import json
import os
import sys


def ensure_training_data(path: str, synthetic: bool):
    """Load prepared training data, or build the synthetic one and save it."""
    from ..data import synthetic as synth
    from ..data.graph_build import build_feature_matrix, build_hetero_graph
    from ..data.prep import TrainingData, prepare_training_data

    prep_dir = os.path.join(path, "prepared_training_data")
    if not synthetic and os.path.exists(os.path.join(prep_dir,
                                                     "training_data.npz")):
        return TrainingData.load(prep_dir)
    print(f"[patent_tpu_torch] no prepared data under {prep_dir}; "
          "building synthetic corpus")
    records = synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                      seed=0)
    graph = build_hetero_graph(records)
    feats = synth.synthetic_features(records, dim=64, seed=0)
    x = build_feature_matrix(graph, feats, feature_dim=64)
    td = prepare_training_data(graph, x, neg_ratio=5, fig_pair_ratio=3, seed=0)
    td.save(prep_dir)
    return td


def _train_config(cfg, args):
    """--learning_rate and --epochs where given (the overrides follow)."""
    if args.learning_rate:
        cfg.learning_rate = args.learning_rate
    if args.epochs:
        cfg.epochs = args.epochs
    return cfg


def _logger(args):
    from ..utils.logging import MetricsLogger

    return MetricsLogger(log_dir=os.path.join(args.path, "logs"),
                         run_name=args.action)


def run_train_hyp_action(args) -> int:
    """train_hyp, then the test split's label-retrieval mAP of the best
    params."""
    from ..retrieval.cli_actions import select_device
    from ..utils.checkpoint import CheckpointManager
    from ..utils.config import HypTrainConfig, apply_overrides
    from .evaluate import evaluate_retrieval_map
    from .train_hyp import build_model, train_hyperbolic_retrieval

    device = select_device(args.device)
    cfg = _train_config(HypTrainConfig(), args)
    cfg.embed_dim = args.latent_dim
    apply_overrides(cfg, args.overrides)
    td = ensure_training_data(args.path, args.synthetic)
    ckpt = CheckpointManager(os.path.join(args.path, "models"))
    best_params, history = train_hyperbolic_retrieval(
        td, cfg, logger=_logger(args), ckpt=ckpt, resume=args.resume,
        device=device)
    fig_pos: dict[int, list[int]] = {}
    for f, p in td.y_pos.tolist():
        fig_pos.setdefault(f, []).append(p)
    model = build_model(td, cfg, device)
    model.load_state_dict(best_params)
    num_patents = (td.label_offsets["medium_cpcs"]
                   - td.label_offsets["patents"])
    test_map = evaluate_retrieval_map(model, td.x_figures,
                                      history["test_indices"], fig_pos,
                                      num_patents)
    print(f"test mAP (label retrieval): {test_map:.4f}")
    return 0


def run_train_hyp_con_action(args) -> int:
    from ..retrieval.cli_actions import select_device
    from ..utils.config import HypConTrainConfig, apply_overrides
    from .train_hyp_con import train_hyperbolic_contrastive

    device = select_device(args.device)
    cfg = _train_config(HypConTrainConfig(), args)
    apply_overrides(cfg, args.overrides)
    td = ensure_training_data(args.path, args.synthetic)
    train_hyperbolic_contrastive(td, cfg, logger=_logger(args),
                                 device=device)
    return 0


def run_prep_action(args) -> int:
    """Build and save the synthetic prepared_training_data (host only)."""
    td = ensure_training_data(args.path, synthetic=True)
    print(f"prepared: {len(td.y_pos)} Y_pos, {len(td.y_neg)} Y_neg, "
          f"{len(td.implication)} implications, {td.num_labels} labels")
    return 0


def run_hyperbolic_action(args) -> int:
    from ..models.hyperbolic import HyperbolicEmbeddingModel
    from ..models.weights import hyperbolic_params_from_jax
    from ..retrieval.cli_actions import select_device
    from ..utils import checkpoint
    from ..utils.config import HypTrainConfig, apply_overrides
    from .evaluate import (distance_analysis, evaluate_retrieval_map,
                           save_distance_analysis, strip_raw_samples)

    device = select_device(args.device)
    cfg = HypTrainConfig()
    cfg.embed_dim = args.latent_dim
    apply_overrides(cfg, args.overrides)
    td = ensure_training_data(args.path, args.synthetic)

    models_dir = os.path.join(args.path, "models")
    name = (args.checkpoint or
            f"best_retrieval_model_c{cfg.curvature}_e{cfg.embed_dim}")
    if not os.path.exists(os.path.join(models_dir, name, "manifest.json")):
        print(f"no checkpoint {name!r} under {args.path}/models — "
              "run train_hyp first", file=sys.stderr)
        return 1
    params = checkpoint.restore(models_dir, name)["params"]
    model = HyperbolicEmbeddingModel(
        feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
        label_num=params["label_emb"].shape[0],
        hidden_dims=tuple(cfg.hidden_dims), c=cfg.curvature)
    model.load_state_dict(hyperbolic_params_from_jax(params))
    model = model.to(device).eval()
    if args.action in ("test", "infer"):
        fig_pos: dict[int, list[int]] = {}
        for f, p in td.y_pos.tolist():
            fig_pos.setdefault(f, []).append(p)
        num_patents = (td.label_offsets["medium_cpcs"]
                       - td.label_offsets["patents"])
        test_map = evaluate_retrieval_map(model, td.x_figures, sorted(fig_pos),
                                          fig_pos, num_patents)
        print(f"mAP (label retrieval): {test_map:.4f}")
    if args.action == "dist":
        analysis = distance_analysis(model, td.x_figures, td.y_pos,
                                     td.label_offsets, td.implication)
        files = save_distance_analysis(analysis,
                                       os.path.join(args.path, "analysis"))
        print(json.dumps(strip_raw_samples(analysis), indent=2))
        print("\n".join(files))
    return 0
