#!/usr/bin/env python3
"""End-to-end quickstart of patent_tpu_torch on the synthetic corpus, on
the CUDA card (or the CPU with --cpu).

The pipeline of examples/quickstart.py, through the port's own modules:

  1. build corpus + metadata              (data/synthetic)
  2. ETL: graph, figure features, and text features of the CPC
     definitions and patent titles in the patent and CPC rows
                                           (data/graph_build,
                                            data/text_features)
  3. GCN pair-classifier training + graph-embedding export (train/train_gcn)
  4. hyperbolic retrieval training         (train/train_hyp)
  5. label-retrieval mAP before vs after   (train/evaluate)
  6. image retrieval engine + reference metric battery (retrieval/)

Run:  python examples/quickstart_torch.py [--epochs 8] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from patent_tpu_torch.data import synthetic
    from patent_tpu_torch.data.graph_build import (build_feature_matrix,
                                                   build_hetero_graph)
    from patent_tpu_torch.data.ground_truth import (build_ground_truth,
                                                    split_query_gallery)
    from patent_tpu_torch.data.pairs import sample_figure_pairs
    from patent_tpu_torch.data.prep import prepare_training_data
    from patent_tpu_torch.data.text_features import build_text_feature_dicts
    from patent_tpu_torch.models.vit import (TextConfig, TextTransformer,
                                             VisionConfig, VisionTransformer)
    from patent_tpu_torch.retrieval.cli_actions import select_device
    from patent_tpu_torch.retrieval.engine import (
        RetrievalEngine, make_device_normalizing_encoder)
    from patent_tpu_torch.train.evaluate import evaluate_retrieval_map
    from patent_tpu_torch.train.train_gcn import (export_graph_embeddings,
                                                  train_pair_classification)
    from patent_tpu_torch.train.train_hyp import (build_model,
                                                  train_hyperbolic_retrieval)
    from patent_tpu_torch.utils.config import GCNTrainConfig, HypTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    device = select_device("cpu" if args.cpu else "cuda")
    workdir = args.workdir or tempfile.mkdtemp(prefix="patent_tpu_torch_qs_")
    print(f"== workdir: {workdir}, device: {device}")

    # 1-2: corpus + ETL ----------------------------------------------------
    records = synthetic.synthetic_records(num_patents=40,
                                          figures_per_patent=4, seed=0)
    graph = build_hetero_graph(records)
    print(f"== graph: {graph.counts}")
    feats = synthetic.synthetic_features(records, dim=64, seed=0)
    # a narrow text tower whose projection matches the 64-wide figure
    # features (CLIP's TEXT_B projects to 512, the width of CLIP features)
    text = TextTransformer(
        TextConfig(hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
                   projection_dim=64),
        generator=torch.Generator().manual_seed(0))
    codes = sorted({c for r in records
                    for c in (r.medium_cpc, r.big_cpc, r.main_cpc)})
    cpc_feats, patent_feats = build_text_feature_dicts(
        {c: f"CPC {c}" for c in codes},
        {r.patent_id: f"ornamental design {r.patent_id}" for r in records},
        model=text, device=device)
    levels = [{k: cpc_feats[k] for k in idx} for idx in (
        graph.medium_index, graph.big_index, graph.main_index)]
    x = build_feature_matrix(graph, feats, patent_feats, *levels)
    print(f"== text features: {len(patent_feats)} titles, {len(cpc_feats)} "
          "CPC definitions in the patent and CPC rows")
    td = prepare_training_data(graph, x, neg_ratio=5, fig_pair_ratio=3, seed=0)
    print(f"== training data: {len(td.y_pos)} Y_pos, {len(td.y_neg)} Y_neg, "
          f"{len(td.implication)} implications, {td.num_labels} labels")

    # 3: GCN pair classifier + graph embeddings ----------------------------
    pair_data = sample_figure_pairs(records, num_samples=10000,
                                    cap_per_level=600, seed=0)
    gcn_cfg = GCNTrainConfig(hidden_dim=32, latent_dim=16, epochs=6,
                             batch_size=256, learning_rate=5e-3)
    variables, _hist, report = train_pair_classification(
        x, graph.adjacency.toarray(),
        np.asarray(pair_data["pairs"], np.int32),
        np.asarray(pair_data["labels"], np.int32) - 1,
        gcn_cfg, logger=MetricsLogger(print_every=0), device=device)
    print(f"== GCN pair classifier: test_acc={report['test_acc']:.3f}")
    ge = export_graph_embeddings(variables, x, graph.adjacency.toarray(),
                                 32, 16, 3, graph.figure_index, device=device)
    print(f"== exported {len(ge)} graph embeddings")

    # 4-5: hyperbolic retrieval training + mAP -----------------------------
    hyp_cfg = HypTrainConfig(embed_dim=16, hidden_dims=(32,), curvature=1.0,
                             epochs=args.epochs, batch_size=32,
                             learning_rate=1e-2, patience=max(4, args.epochs),
                             figure_pair_weight=0.5, constraint_penalty=1.0,
                             retrieval_penalty=4.0, use_dropout=False)
    fig_pos: dict[int, list[int]] = {}
    for f, p in td.y_pos.tolist():
        fig_pos.setdefault(f, []).append(p)
    num_patents = td.label_offsets["medium_cpcs"] - td.label_offsets["patents"]
    model = build_model(td, hyp_cfg, device).eval()
    map_before = evaluate_retrieval_map(model, td.x_figures, sorted(fig_pos),
                                        fig_pos, num_patents)
    best, _history = train_hyperbolic_retrieval(
        td, hyp_cfg, logger=MetricsLogger(print_every=0), device=device)
    model.load_state_dict(best)
    map_after = evaluate_retrieval_map(model, td.x_figures, sorted(fig_pos),
                                       fig_pos, num_patents)
    print(f"== label-retrieval mAP: {map_before:.4f} (random init) → "
          f"{map_after:.4f} (trained)")

    # 6: image retrieval engine + reference metrics ------------------------
    img_dir = os.path.join(workdir, "images")
    synthetic.write_synthetic_images(records, img_dir, image_size=64, seed=0)
    q_recs, g_recs = split_query_gallery(records, seed=42)
    gt = build_ground_truth(q_recs, g_recs, max_month=None)
    vc = VisionConfig(image_size=64, patch_size=8, hidden_dim=64, num_layers=2,
                      num_heads=4, mlp_dim=128, projection_dim=64)
    vit = VisionTransformer(vc, generator=torch.Generator().manual_seed(0))
    vit = vit.to(device).eval()
    with RetrievalEngine(make_device_normalizing_encoder(vit, device),
                         device, batch_size=16, image_size=64,
                         num_workers=2) as engine:
        engine.encode_dataset([os.path.join(img_dir, r.figure_id)
                               for r in g_recs])
        metrics = engine.evaluate([os.path.join(img_dir, r.figure_id)
                                   for r in q_recs], gt)
    print("== image retrieval (reference metric battery):")
    print(metrics)
    assert map_after > map_before, "training must improve label retrieval"
    print("== quickstart complete")


if __name__ == "__main__":
    main()
