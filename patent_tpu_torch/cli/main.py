"""Command-line interface of the port (every action of
patent_tpu/cli/main.py but ``bench``: the retrieval actions, the retrieval
server, the CLIP fine-tune, the hyperbolic trainers and serving actions,
``prep``, the joint CLIP + hyperbolic trainer, ``plot`` and the graph
trainers).

    python -m patent_tpu_torch.cli encode|retrieve|eval --path DIR
        [--device cuda|cpu] [--synthetic] [--k K] [--query IMG]
        [--model NAME] [--positives patent|cpc] [--keep-tokens K]
        [--quantize] [--profile exact|recommended|turbo]
        [--checkpoint HF_DIR]
    python -m patent_tpu_torch.cli serve --path DIR [--port 8777]
        [--device cuda|cpu] [--synthetic] [--quantize]
        [--profile exact|recommended|turbo] [--keep-tokens K]
        [--checkpoint HF_DIR]
    python -m patent_tpu_torch.cli finetune --path DIR [--device cuda|cpu]
        [--epochs N] [--keep-tokens K] [--checkpoint HF_DIR]
        [key=value ...]
    python -m patent_tpu_torch.cli train_hyp --path DIR [--device cuda|cpu]
        [--epochs N] [--learning_rate LR] [--resume] [--latent_dim 128]
        [--synthetic] [key=value ...]
    python -m patent_tpu_torch.cli train_hyp_con --path DIR
        [--device cuda|cpu] [--epochs N] [--learning_rate LR] [key=value ...]
    python -m patent_tpu_torch.cli prep --path DIR
    python -m patent_tpu_torch.cli test|infer|dist --path DIR
        [--checkpoint NAME] [--latent_dim 128] [--synthetic]
        [--device cuda|cpu] [key=value ...]
    python -m patent_tpu_torch.cli train_end|train_end_2 --path DIR
        [--device cuda|cpu] [--epochs 2]
    python -m patent_tpu_torch.cli plot --path DIR [--checkpoint NAME]
    python -m patent_tpu_torch.cli train_class_pro|train_class|train_gcn|train
        --path DIR [--device cuda|cpu] [--model GE|VGAE] [--hidden_dim 512]
        [--latent_dim 128] [--epochs N] [--learning_rate LR] [key=value ...]

``serve`` loads the index that ``encode`` saved for the same corpus and
tower (or encodes the gallery and saves it), then answers HTTP on
127.0.0.1:``--port`` (retrieval/server.py: /healthz, /stats, /search by
features, name or an image under the gallery directory).  ``finetune``
trains on ``DIR``/metadata.json + images/ when present, else
on a generated synthetic corpus, and writes
``DIR``/models/clip_finetune_best, which every retrieval action loads.
``--checkpoint HF_DIR`` names a local HF CLIP directory
(``save_pretrained``: model.safetensors or pytorch_model.bin, read without
``transformers``, models/clip_import.py): the retrieval actions serve its
image tower instead, and ``finetune`` starts from it.
``train_hyp`` trains the hyperbolic model on ``DIR``/prepared_training_data
(or the synthetic corpus, which ``prep`` writes there), keeping ``latest``
and ``best_retrieval_model_c{c}_e{d}`` under ``DIR``/models in the JAX
layout, so ``--resume`` continues a run of either package; ``train_hyp_con``
trains the figure-only model by InfoNCE.  ``test``, ``infer`` and ``dist``
serve a ``train_hyp`` checkpoint of either package
(train/cli_hyperbolic.py).  ``train_end`` trains the joint CLIP +
hyperbolic model on its synthetic corpus; ``plot`` draws a ``train_hyp``
checkpoint's label table under ``DIR``/plots (where matplotlib and
scikit-learn are installed); ``train_class_pro`` and its aliases train
the GCN pair classifier and export graph embeddings for ``finetune``
(``--model VGAE``: the VGAE link predictor) (train/cli_graph.py), on
the JAX CLI's synthetic graph.

``--device`` defaults to the card; without one the command exits non-zero
rather than run on the CPU (``prep`` and ``plot`` run on the host only).
``bench`` exits non-zero with a message: it is not ported yet.  So do a
``--checkpoint`` that is not a local directory and one given to an action
that reads none (the JAX CLI ignores it there).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils.config import SERVING_PROFILES

# the JAX CLI's action set; every one but bench runs here
ACTIONS = ["train", "train_gcn", "train_hyp", "train_hyp_con", "train_end",
           "train_end_2", "train_class", "plot", "train_class_pro", "test",
           "infer", "dist", "prep", "encode", "retrieve", "eval", "bench",
           "finetune", "serve"]
HYPERBOLIC_ACTIONS = ("test", "infer", "dist")
# the actions whose --checkpoint is an HF CLIP directory
HF_CHECKPOINT_ACTIONS = ("encode", "retrieve", "eval", "serve", "finetune")
GRAPH_ACTIONS = ("train_class_pro", "train_class", "train_gcn", "train")
END_TO_END_ACTIONS = ("train_end", "train_end_2")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m patent_tpu_torch.cli",
        description="patent_tpu_torch — patent image retrieval in PyTorch")
    p.add_argument("action", choices=ACTIONS)
    p.add_argument("--model", type=str, default="GE")
    p.add_argument("--path", type=str, default="data")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the tower and the index run (default: the "
                        "CUDA card; without one the command fails)")
    p.add_argument("--query", type=str, default=None,
                   help="query image path (retrieve action)")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="test/infer/dist/plot: the checkpoint's name under "
                        "--path/models (default best_retrieval_model_c"
                        "{curvature}_e{latent_dim}); encode/retrieve/eval/"
                        "serve/finetune: a local HF CLIP checkpoint "
                        "directory")
    p.add_argument("--input_dim", type=int, default=512,
                   help="graph actions: taken and unused, as in the JAX "
                        "CLI (the width is the graph's features')")
    p.add_argument("--hidden_dim", type=int, default=512,
                   help="graph actions: the GCN's hidden width")
    p.add_argument("--latent_dim", type=int, default=128,
                   help="train_hyp/test/infer/dist: the hyperbolic "
                        "embedding width; graph actions: the GCN's "
                        "latent width")
    p.add_argument("--synthetic", action="store_true",
                   help="force the synthetic corpus")
    p.add_argument("--quantize", action="store_true",
                   help="serve the int8 PTQ tower (per-channel weight "
                        "scales, per-row dynamic activation scales)")
    p.add_argument("--keep-tokens", type=int, default=None,
                   dest="keep_tokens",
                   help="serve only the K darkest patches per image (+CLS)")
    p.add_argument("--profile", choices=sorted(SERVING_PROFILES),
                   default=None,
                   help="named serving profile: exact = int8, all tokens; "
                        "recommended = int8 + keep-tokens 175; turbo = "
                        "int8 + keep-tokens 127.  Explicit flags win")
    p.add_argument("--port", type=int, default=8777,
                   help="retrieval server port (serve action)")
    p.add_argument("--positives", choices=["patent", "cpc"],
                   default="patent",
                   help="ground-truth positives for eval: same patent or "
                        "same medium CPC")
    p.add_argument("--epochs", type=int, default=None,
                   help="training epochs (default: the action's config)")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="train_hyp/train_hyp_con: the learning rate "
                        "(default: the action's config)")
    p.add_argument("--resume", action="store_true",
                   help="continue train_hyp from the 'latest' checkpoint "
                        "under --path/models (params, optimizer state, "
                        "epoch, the batch and dropout streams): epoch k+1 "
                        "after the resume equals epoch k+1 of an "
                        "uninterrupted run")
    p.add_argument("overrides", nargs="*",
                   help="config overrides as key=value (ClipFinetuneConfig "
                        "for finetune, HypTrainConfig for train_hyp and "
                        "test/infer/dist, HypConTrainConfig for "
                        "train_hyp_con, GCNTrainConfig for the graph "
                        "actions)")
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The parsed command line, with ``--profile`` resolved into
    ``quantize`` and ``keep_tokens`` where those were left unset.
    ``key=value`` overrides may stand anywhere, options after them too."""
    args = build_parser().parse_intermixed_args(argv)
    if args.profile is not None:
        prof = SERVING_PROFILES[args.profile]
        args.quantize = args.quantize or prof["quantize"]
        if args.keep_tokens is None:
            args.keep_tokens = prof["keep_tokens"]
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.action == "bench":
        print(f"action {args.action!r} is not yet ported to "
              "patent_tpu_torch", file=sys.stderr)
        return 2
    if args.action == "prep":
        from ..train.cli_hyperbolic import run_prep_action

        return run_prep_action(args)
    if args.action == "plot":
        from ..train.plots import run_plot_action

        run_plot_action(args.path, checkpoint=args.checkpoint)
        return 0
    if args.checkpoint and args.action not in HYPERBOLIC_ACTIONS:
        # refused before anything is written; the JAX CLI ignores the flag
        # where no action reads it
        if args.action not in HF_CHECKPOINT_ACTIONS:
            print(f"--checkpoint is not read by {args.action} (it names an "
                  "HF CLIP directory for "
                  f"{'/'.join(HF_CHECKPOINT_ACTIONS)})", file=sys.stderr)
            return 2
        if not os.path.isdir(args.checkpoint):
            print(f"--checkpoint {args.checkpoint!r} is not a local "
                  "directory (HF-format CLIP checkpoints only)",
                  file=sys.stderr)
            return 2
    from ..retrieval.cli_actions import (run_retrieval_action,
                                         run_serve_action, select_device)

    try:
        select_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}", file=sys.stderr)
        return 1
    if args.action == "finetune":
        from ..train.cli_finetune import run_finetune_action

        return run_finetune_action(args)
    if args.action in HYPERBOLIC_ACTIONS:
        from ..train.cli_hyperbolic import run_hyperbolic_action

        return run_hyperbolic_action(args)
    if args.action == "train_hyp":
        from ..train.cli_hyperbolic import run_train_hyp_action

        return run_train_hyp_action(args)
    if args.action == "train_hyp_con":
        from ..train.cli_hyperbolic import run_train_hyp_con_action

        return run_train_hyp_con_action(args)
    if args.action in GRAPH_ACTIONS:
        from ..train.cli_graph import run_graph_action

        return run_graph_action(args)
    if args.action in END_TO_END_ACTIONS:
        from ..train.cli_hyperbolic import run_train_end_action

        return run_train_end_action(args)
    if args.action == "serve":
        run_serve_action(args, block=True)
        return 0
    return run_retrieval_action(args.action, args)


if __name__ == "__main__":
    sys.exit(main())
