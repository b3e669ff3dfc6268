"""Command-line interface of the port (the retrieval actions, the
retrieval server, the CLIP fine-tune and the hyperbolic serving actions of
patent_tpu/cli/main.py).

    python -m patent_tpu_torch.cli encode|retrieve|eval --path DIR
        [--device cuda|cpu] [--synthetic] [--k K] [--query IMG]
        [--model NAME] [--positives patent|cpc] [--keep-tokens K]
        [--quantize] [--profile exact|recommended|turbo]
    python -m patent_tpu_torch.cli serve --path DIR [--port 8777]
        [--device cuda|cpu] [--synthetic] [--quantize]
        [--profile exact|recommended|turbo] [--keep-tokens K]
    python -m patent_tpu_torch.cli finetune --path DIR [--device cuda|cpu]
        [--epochs N] [--keep-tokens K] [key=value ...]
    python -m patent_tpu_torch.cli test|infer|dist --path DIR
        [--checkpoint NAME] [--latent_dim 128] [--synthetic]
        [--device cuda|cpu] [key=value ...]

``serve`` loads the index that ``encode`` saved for the same corpus and
tower (or encodes the gallery and saves it), then answers HTTP on
127.0.0.1:``--port`` (retrieval/server.py: /healthz, /stats, /search by
features, name or an image under the gallery directory).  ``finetune``
trains on ``DIR``/metadata.json + images/ when present, else
on a generated synthetic corpus, and writes
``DIR``/models/clip_finetune_best, which every retrieval action loads.
``test``, ``infer`` and ``dist`` serve a hyperbolic model that the JAX
``train_hyp`` (or the port, in its layout) saved under ``DIR``/models, on
``DIR``/prepared_training_data (train/cli_hyperbolic.py).

``--device`` defaults to the card; without one the command exits non-zero
rather than run on the CPU.  The other actions of the JAX CLI, and HF
``--checkpoint`` directories for the image tower, exit non-zero with a
message: they are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.config import SERVING_PROFILES

# the JAX CLI's action set; RETRIEVAL_ACTIONS, HYPERBOLIC_ACTIONS,
# finetune and serve run here so far
ACTIONS = ["train", "train_gcn", "train_hyp", "train_hyp_con", "train_end",
           "train_end_2", "train_class", "plot", "train_class_pro", "test",
           "infer", "dist", "prep", "encode", "retrieve", "eval", "bench",
           "finetune", "serve"]
RETRIEVAL_ACTIONS = ("encode", "retrieve", "eval")
HYPERBOLIC_ACTIONS = ("test", "infer", "dist")


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
                   help="test/infer/dist: the checkpoint's name under "
                        "--path/models (default best_retrieval_model_c"
                        "{curvature}_e{latent_dim}); other actions: an HF "
                        "CLIP checkpoint directory (not yet ported)")
    p.add_argument("--latent_dim", type=int, default=128,
                   help="test/infer/dist: the hyperbolic embedding width")
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
                   help="fine-tune epochs (default: ClipFinetuneConfig's)")
    p.add_argument("overrides", nargs="*",
                   help="config overrides as key=value (ClipFinetuneConfig "
                        "for finetune, HypTrainConfig for test/infer/dist)")
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
    if args.action not in RETRIEVAL_ACTIONS + HYPERBOLIC_ACTIONS + (
            "finetune", "serve"):
        print(f"action {args.action!r} is not yet ported to "
              "patent_tpu_torch", file=sys.stderr)
        return 2
    if args.checkpoint and args.action not in HYPERBOLIC_ACTIONS:
        print(f"--checkpoint {args.checkpoint!r}: loading HF CLIP "
              "checkpoints needs the transformers package and is not yet "
              "ported to patent_tpu_torch (a JAX fine-tune under "
              "<path>/models/clip_finetune_best is loaded automatically)",
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
    if args.action == "serve":
        run_serve_action(args, block=True)
        return 0
    return run_retrieval_action(args.action, args)


if __name__ == "__main__":
    sys.exit(main())
