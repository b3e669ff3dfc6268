"""CLI glue for the retrieval actions encode / retrieve / eval and the
retrieval server, serve (port of patent_tpu/retrieval/cli_actions.py and
of the serve action of patent_tpu/cli/main.py).

Three differences from the JAX package: the device is named by the caller
(``--device``, the card by default) and a missing card is an error, not a
fall-back to the CPU; index filenames carry a ``_torch`` backend tag, so
neither package loads the other's gallery under the same name; and the
weights tags hash the bytes of the weights, ``state.npz`` of a fine-tune
or the weight file of an HF ``--checkpoint`` directory (the JAX ones hash
directory mtimes, which an in-place re-save can leave unchanged).
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

from ..data.ground_truth import (build_ground_truth, save_ground_truth,
                                 split_query_gallery)
from ..data.schema import records_from_metadata
from ..input.pipeline import list_images

_BACKEND_TAG = "_torch"


def _short_hash(*parts) -> str:
    return hashlib.sha1("|".join(str(p) for p in parts).encode()
                        ).hexdigest()[:8]


def _file_hash(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:8]


def select_device(name: str = "cuda") -> torch.device:
    """The device the caller asked for: "cuda" (the card; RuntimeError when
    there is none, never a silent CPU run) or "cpu".  Float32 matmuls and
    convolutions run in full f32 (no TF32), as the JAX scan's HIGHEST."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible (torch.cuda.is_available()"
                           " is false); pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def index_prefix(path: str, gallery_dir: str, quantize: bool = False,
                 keep_tokens: int | None = None,
                 weights_tag: str = "") -> str:
    """Identity-tagged on-disk index prefix: backend, precision, pruning,
    weights and a hash of the corpus path, so a stale or foreign index is
    never loaded."""
    tag = _BACKEND_TAG
    if quantize:
        tag += "_int8"
    if keep_tokens:
        tag += f"_kt{keep_tokens}"
    if weights_tag:
        tag += f"_{weights_tag}"
    corpus = _short_hash(os.path.abspath(gallery_dir))
    return os.path.join(path, "embeddings",
                        f"index_{os.path.basename(gallery_dir)}"
                        f"_{corpus}{tag}")


def _build_encoder(args, image_size: int, device: torch.device):
    """(encoder, weights tag) for the serving tower at ``image_size``: the
    weights of an HF ``--checkpoint`` directory, else the fine-tune's
    ``clip_finetune_best`` under ``--path``/models, else seeded ones."""
    from ..models.vit import VIT_B16, VisionConfig, VisionTransformer
    from ..models.vit_int8 import Int8VisionTransformer
    from ..models.weights import params_from_jax
    from ..utils import checkpoint
    from .engine import make_device_normalizing_encoder

    if image_size == 224:
        config = VIT_B16
    else:
        config = VisionConfig(image_size=image_size, patch_size=8,
                              hidden_dim=64, num_layers=2, num_heads=4,
                              mlp_dim=128, projection_dim=64)
    keep = getattr(args, "keep_tokens", None)
    if keep is not None:
        if keep <= 0:
            raise ValueError(f"--keep-tokens must be positive, got {keep}")
        if keep >= config.num_patches:
            print(f"--keep-tokens {keep} >= {config.num_patches} patches: "
                  f"serving the exact (unpruned) tower")
            keep = None
        args.keep_tokens = keep
    # the weights are built or loaded in f32: the int8 tower quantizes
    # them from their f32 values (as the JAX package does), the bf16 tower
    # rounds them once
    gen = torch.Generator(device="cpu").manual_seed(0)
    model = VisionTransformer(config, dtype=torch.float32, keep_tokens=keep,
                              generator=gen)
    models_dir = os.path.join(args.path, "models")
    finetuned = os.path.join(models_dir, "clip_finetune_best")
    weights_tag = "rand"
    hf_dir = getattr(args, "checkpoint", None)
    if hf_dir:
        from ..models.clip_import import hf_weight_file, load_hf_clip_params

        if not os.path.isdir(hf_dir):
            # a mistyped path or a hub id must fail, not serve other weights
            raise ValueError(f"--checkpoint {hf_dir!r} is not a local "
                             "directory (HF-format CLIP checkpoints only)")
        model.load_state_dict(load_hf_clip_params(hf_dir, config))
        weights_tag = "hf" + _file_hash(hf_weight_file(hf_dir))
        print(f"loaded CLIP weights from {hf_dir}")
    elif os.path.isdir(finetuned):
        state = checkpoint.restore(models_dir, "clip_finetune_best")
        ft = state["params"]["vit"]
        ft_hidden = ft["patch_embed"]["kernel"].shape[-1]
        if ft_hidden != config.hidden_dim:
            print(f"[patent_tpu_torch] WARNING: {finetuned} was trained with "
                  f"hidden_dim {ft_hidden}, serving config wants "
                  f"{config.hidden_dim} — ignoring the finetuned checkpoint "
                  f"(random init)")
        else:
            model.load_state_dict(params_from_jax(ft))
            weights_tag = "ft" + _file_hash(os.path.join(finetuned,
                                                         "state.npz"))
            print(f"loaded finetuned vision tower from {finetuned}")
    else:
        print("using randomly initialized encoder")
    if getattr(args, "quantize", False):
        model = Int8VisionTransformer.from_float(model)
        print("serving int8-quantized encoder")
    else:
        bf16 = VisionTransformer(config, dtype=torch.bfloat16,
                                 keep_tokens=keep)
        bf16.load_state_dict(model.state_dict())
        model = bf16
    if keep:
        print(f"ink-mass token selection: serving {keep} of "
              f"{config.num_patches} patches per image")
    model = model.to(device).eval()
    return make_device_normalizing_encoder(model, device), weights_tag


def _corpus(args, image_size: int):
    """(gallery_dir, query_dir, ground_truth_path): prepared split dirs
    under --path, else a real corpus (metadata.json + images/) split with
    the reference protocol, else a generated synthetic corpus."""
    force_synth = getattr(args, "synthetic", False)
    gallery = os.path.join(args.path, "test_gallery")
    query = os.path.join(args.path, "test_query")
    gt = os.path.join(args.path, "ground_truth.json")
    if not force_synth and os.path.isdir(gallery) and os.path.isdir(query) \
            and os.path.exists(gt):
        return gallery, query, gt

    meta_path = os.path.join(args.path, "metadata.json")
    images_dir = os.path.join(args.path, "images")
    if not force_synth and os.path.exists(meta_path) \
            and os.path.isdir(images_dir):
        with open(meta_path) as f:
            records = records_from_metadata(json.load(f))
        q_recs, g_recs = split_query_gallery(records, seed=42)
        os.makedirs(gallery, exist_ok=True)
        os.makedirs(query, exist_ok=True)
        for recs, d in ((g_recs, gallery), (q_recs, query)):
            for r in recs:
                src = os.path.join(images_dir, r.figure_id)
                dst = os.path.join(d, r.figure_id)
                if os.path.exists(src) and not os.path.exists(dst):
                    os.symlink(os.path.abspath(src), dst)
        save_ground_truth(build_ground_truth(q_recs, g_recs, max_month=None),
                          gt)
        print(f"[patent_tpu_torch] split real corpus: {len(q_recs)} queries, "
              f"{len(g_recs)} gallery → {args.path}")
        return gallery, query, gt

    root = os.path.join(args.path, "synthetic_retrieval")
    print(f"[patent_tpu_torch] no corpus under {args.path}; generating "
          f"synthetic corpus at {root}")
    write_synthetic_split(root, image_size)
    return (os.path.join(root, "test_gallery"),
            os.path.join(root, "test_query"),
            os.path.join(root, "ground_truth.json"))


def write_synthetic_split(root: str, image_size: int,
                          num_patents: int = 40) -> None:
    """The synthetic retrieval corpus of the JAX CLI (``num_patents`` × 6
    figures, hard=True; 40 patents split into 160 gallery and 80 query
    figures): ``root``/test_gallery, test_query and ground_truth.json."""
    from ..data import synthetic

    records = synthetic.synthetic_records(num_patents=num_patents,
                                          figures_per_patent=6, seed=0)
    q_recs, g_recs = split_query_gallery(records, seed=42)
    for recs, sub in ((g_recs, "test_gallery"), (q_recs, "test_query")):
        synthetic.write_synthetic_images(recs, os.path.join(root, sub),
                                         image_size=image_size, seed=0,
                                         hard=True)
    save_ground_truth(build_ground_truth(q_recs, g_recs, max_month=None),
                      os.path.join(root, "ground_truth.json"))


def _gallery_image_size(gallery_dir: str) -> int:
    """Encoder resolution from the gallery's first image (224 or 64)."""
    from PIL import Image, UnidentifiedImageError

    paths = list_images(gallery_dir)
    if not paths:
        return 224
    try:
        with Image.open(paths[0]) as im:
            return 224 if min(im.size) >= 224 else 64
    except (OSError, UnidentifiedImageError):
        return 224


def build_engine(args):
    """Corpus + encoder + engine + index prefix, shared by every action.
    Returns (gallery_dir, query_dir, gt_path, engine, prefix)."""
    from .engine import RetrievalEngine

    device = select_device(getattr(args, "device", "cuda"))
    gallery_dir, query_dir, gt_path = _corpus(
        args, 64 if args.synthetic else 224)
    image_size = _gallery_image_size(gallery_dir)
    encode, weights_tag = _build_encoder(args, image_size, device)
    engine = RetrievalEngine(encode, device, batch_size=32,
                             image_size=image_size, num_workers=4,
                             cache_dir=os.path.join(args.path,
                                                    "decoded_cache"))
    prefix = index_prefix(args.path, gallery_dir,
                          getattr(args, "quantize", False),
                          getattr(args, "keep_tokens", None),
                          weights_tag=weights_tag)
    return gallery_dir, query_dir, gt_path, engine, prefix


def _load_or_encode(engine, gallery_dir: str, prefix: str) -> None:
    """The index saved under ``prefix``, else the gallery encoded and saved
    there."""
    if os.path.exists(prefix + ".npy"):
        engine.load_embeddings(prefix)
    else:
        engine.encode_dataset(gallery_dir, save_prefix=prefix)


def run_retrieval_action(action: str, args) -> int:
    gallery_dir, query_dir, gt_path, engine, prefix = build_engine(args)
    with engine:
        if action == "encode":
            index = engine.encode_dataset(gallery_dir, save_prefix=prefix)
            print(f"encoded {len(index)} gallery images -> {prefix}.npy")
            return 0

        _load_or_encode(engine, gallery_dir, prefix)

        if action == "retrieve":
            qpath = args.query
            if qpath is None:
                qcands = list_images(query_dir)
                if not qcands:
                    print(f"no --query given and no images under {query_dir}")
                    return 1
                qpath = qcands[0]
                print(f"no --query given; using {qpath}")
            for name, score in engine.retrieve_similar_images(qpath, k=args.k):
                print(f"{score:.4f}  {os.path.basename(name)}")
            return 0

        if action == "eval":
            positives = getattr(args, "positives", "patent") or "patent"
            tag = "" if positives == "patent" else f"_{positives}"
            results_path = os.path.join(
                args.path, "results",
                f"evaluation_results_{args.model}{tag}.json")
            metrics = engine.evaluate(query_dir, gt_path,
                                      positives_key=f"{positives}_positives",
                                      results_path=results_path)
            print(metrics)
            print(f"detailed results -> {results_path}")
            return 0
    return 1


def run_serve_action(args, block: bool = True):
    """The serve action: the engine of ``build_engine``, its saved index
    (or the gallery encoded and saved under the same prefix), then the
    HTTP retrieval server on ``args.port`` (0: a free port), whose
    image_path queries are confined to the gallery directory.  Returns
    the server; ``block=True`` serves until the process ends, else the
    server runs on a daemon thread and the caller ends it with
    ``shutdown()`` and ``server_close()`` and closes its engine
    (``server.RequestHandlerClass.service.engine``)."""
    from .server import serve

    gallery_dir, _query_dir, _gt_path, engine, prefix = build_engine(args)
    try:
        _load_or_encode(engine, gallery_dir, prefix)
        server = serve(engine, port=args.port, block=block,
                       data_root=gallery_dir)
    except BaseException:
        engine.close()
        raise
    if block:
        engine.close()
    return server
