"""The ``finetune`` action of the port's CLI (port of the ``finetune``
branch of patent_tpu/cli/main.py).

Corpus: ``--path``/metadata.json + images/ when present, else a synthetic
corpus of 16 patents x 3 figures at 64 px under ``--path``/synthetic_corpus.
Each figure with another figure of its patent is an anchor, paired with
the first of them.  Graph alignment uses the first pickle under
``--path``/graph_embeddings (figure name → VGAE vector) when it matches an
anchor; a pickle that matches none is refused with a warning, and the
table is then random, as it is with no pickle.  Images under 224 px train
a small tower (D 64, 2 layers, 4 heads of 16, patch 8); 224 px trains
ViT-B/16.  ``--checkpoint HF_DIR`` starts the tower from a local HF CLIP
directory's weights, at either size (the JAX action means to at 224 px,
but imports a module that its package lacks).  Decoded images are shared
with encode and eval through the decoded-u8 cache under
``--path``/decoded_cache.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def run_finetune_action(args) -> int:
    from ..data.ground_truth import figure_to_pos_figures
    from ..data.schema import records_from_metadata
    from ..data.synthetic import write_synthetic_corpus
    from ..input.cache import DecodedU8Cache
    from ..models.vit import VIT_B16, VisionConfig
    from ..retrieval.cli_actions import _gallery_image_size, select_device
    from ..utils.config import ClipFinetuneConfig, apply_overrides
    from .finetune_clip import run_finetune

    device = select_device(args.device)
    cfg = ClipFinetuneConfig()
    if args.epochs:
        cfg.epochs = args.epochs
    if args.keep_tokens is not None:
        if args.keep_tokens <= 0:
            raise ValueError(
                f"--keep-tokens must be positive, got {args.keep_tokens}")
        cfg.keep_tokens = args.keep_tokens
    apply_overrides(cfg, args.overrides)

    meta_path = os.path.join(args.path, "metadata.json")
    if os.path.exists(meta_path) and os.path.isdir(
            os.path.join(args.path, "images")):
        with open(meta_path) as f:
            records = records_from_metadata(json.load(f))
        images_dir = os.path.join(args.path, "images")
    else:
        print(f"[patent_tpu_torch] no corpus under {args.path}; using "
              "synthetic")
        records, images_dir = write_synthetic_corpus(
            os.path.join(args.path, "synthetic_corpus"), num_patents=16,
            figures_per_patent=3, image_size=64)
    anchors, positives = [], []
    for name, partners in sorted(figure_to_pos_figures(records).items()):
        anchors.append(os.path.join(images_dir, name))
        positives.append(os.path.join(images_dir, partners[0]))

    node_idx = np.arange(len(anchors), dtype=np.int32)
    vgae = None
    ge_dir = os.path.join(args.path, "graph_embeddings")
    pkls = sorted(os.listdir(ge_dir)) if os.path.isdir(ge_dir) else []
    if pkls:
        with open(os.path.join(ge_dir, pkls[0]), "rb") as f:
            ge = pickle.load(f)
        keys = {os.path.basename(a): i for i, a in enumerate(sorted(ge))}
        matched = sum(os.path.basename(a) in keys for a in anchors)
        if matched == 0:
            # a pickle of another corpus would map every anchor to node 0
            print(f"[patent_tpu_torch] WARNING: graph-embedding pickle "
                  f"{pkls[0]} matches 0/{len(anchors)} anchors (different "
                  f"corpus?); training WITHOUT graph alignment")
        else:
            vgae = np.stack([ge[k] for k in sorted(ge)])
            node_idx = np.asarray(
                [keys.get(os.path.basename(a), 0) for a in anchors], np.int32)
            print(f"[patent_tpu_torch] aligned to {len(ge)} exported graph "
                  f"embeddings from {ge_dir} ({matched}/{len(anchors)} "
                  "anchors matched)")
    if vgae is None:
        vgae = np.random.default_rng(0).standard_normal(
            (max(len(anchors), 2), 128)).astype(np.float32)

    probed = _gallery_image_size(images_dir)
    image_size = probed if probed < 224 else cfg.image_size
    if image_size == 224:
        vc = VIT_B16
    else:
        vc = VisionConfig(image_size=image_size, patch_size=8, hidden_dim=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          projection_dim=64)
    init_vit = None
    if args.checkpoint:
        from ..models.clip_import import load_hf_clip_params

        # the reference fine-tunes openai/clip-vit-base-patch16; any tower
        # whose widths the directory's weights have starts from them
        if not os.path.isdir(args.checkpoint):
            raise ValueError(f"--checkpoint {args.checkpoint!r} is not a "
                             "local directory (HF-format CLIP checkpoints "
                             "only)")
        init_vit = load_hf_clip_params(args.checkpoint, vc)
        print(f"[patent_tpu_torch] fine-tuning from CLIP weights at "
              f"{args.checkpoint}")
    if cfg.keep_tokens is not None and cfg.keep_tokens >= vc.num_patches:
        print(f"--keep-tokens {cfg.keep_tokens} >= {vc.num_patches} "
              "patches: training the exact (unpruned) tower")
        cfg.keep_tokens = None
    with DecodedU8Cache(os.path.join(args.path, "decoded_cache"),
                        image_size=image_size) as cache:
        _best, history = run_finetune(
            anchors, positives, node_idx, vgae, vc, cfg,
            ckpt_dir=os.path.join(args.path, "models"),
            image_size=image_size, cache=cache, device=device,
            init_vit=init_vit)
    print(f"finetune done: val_loss trajectory {history['val_loss']}")
    return 0
