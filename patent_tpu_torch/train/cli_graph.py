"""The graph actions of the port's CLI (port of their branch of
patent_tpu/cli/main.py).

``train_class_pro`` (aliases ``train_class``, ``train_gcn``, ``train``):
the GCN pair classifier (train/train_gcn.py) at ``GCNTrainConfig`` with
``--hidden_dim``, ``--latent_dim``, ``--learning_rate`` and ``--epochs``,
on the JAX CLI's synthetic graph (40 patents x 4 figures, features of 64,
5-level figure pairs; ``--input_dim`` is taken from the features, as
there); prints the test report as JSON (without the confusion matrix)
and exports the figures' graph embeddings to
``--path``/graph_embeddings/image_ge_embeddings_{--model}.pkl, which
``finetune`` of either package reads.  ``--model VGAE`` trains the VGAE
link predictor instead (train/train_vgae.py: the sampled objective above
16,384 nodes; 50 epochs at 1e-2 unless ``--epochs``, ``--learning_rate``
or ``key=value`` say otherwise) and prints its test report.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def ensure_graph(path: str, synthetic: bool):
    """(graph, features [N, D], figure-pair data): the JAX CLI's synthetic
    corpus, which is all its graph actions read (``path`` and ``synthetic``
    are taken, and unused, as there)."""
    from ..data import synthetic as synth
    from ..data.graph_build import build_feature_matrix, build_hetero_graph
    from ..data.pairs import sample_figure_pairs

    records = synth.synthetic_records(num_patents=40, figures_per_patent=4,
                                      seed=0)
    graph = build_hetero_graph(records)
    feats = synth.synthetic_features(records, dim=64, seed=0)
    x = build_feature_matrix(graph, feats, feature_dim=64)
    pair_data = sample_figure_pairs(records, num_samples=20000,
                                    cap_per_level=2000, seed=0)
    return graph, x, pair_data


def run_graph_action(args) -> int:
    from ..retrieval.cli_actions import select_device
    from ..utils.config import GCNTrainConfig, apply_overrides
    from .cli_hyperbolic import _logger, _train_config
    from .train_gcn import export_graph_embeddings, train_pair_classification

    device = select_device(args.device)
    cfg = _train_config(GCNTrainConfig(), args)
    cfg.hidden_dim = args.hidden_dim
    cfg.latent_dim = args.latent_dim
    apply_overrides(cfg, args.overrides)
    graph, x, pair_data = ensure_graph(args.path, args.synthetic)
    pairs = np.asarray(pair_data["pairs"], np.int32)
    labels = np.asarray(pair_data["labels"], np.int32) - 1
    cfg.input_dim = x.shape[1]
    logger = _logger(args)
    if args.model.upper() == "VGAE":
        from .train_vgae import train_vgae_link_prediction

        user_set = {ov.split("=", 1)[0] for ov in args.overrides}
        _variables, _split, report = train_vgae_link_prediction(
            x, graph.adjacency, hidden_dim=cfg.hidden_dim,
            latent_dim=cfg.latent_dim,
            epochs=cfg.epochs if (args.epochs or "epochs" in user_set)
            else 50,
            learning_rate=cfg.learning_rate
            if (args.learning_rate or "learning_rate" in user_set) else 1e-2,
            logger=logger, device=device)
        print(json.dumps({k: float(v) for k, v in report.items()}, indent=2))
        return 0
    variables, _history, report = train_pair_classification(
        x, graph.adjacency, pairs, labels, cfg, logger=logger, device=device)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "confusion_matrix"}, indent=2))
    emb = export_graph_embeddings(
        variables, x, graph.adjacency, cfg.hidden_dim, cfg.latent_dim,
        cfg.num_layers, graph.figure_index, adjacency_mode=cfg.adjacency,
        device=device)
    out_dir = os.path.join(args.path, "graph_embeddings")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"image_ge_embeddings_{args.model}.pkl"),
              "wb") as f:
        pickle.dump(emb, f)
    print(f"graph embeddings -> {out_dir}")
    return 0

