"""Encode → index → retrieve → evaluate (port of
patent_tpu/retrieval/engine.py).

Host side: ``ImageBatcher`` (threaded decode into fixed-shape u8 batches),
``DecodedU8Cache`` and the reference metric battery, the port's own copies
of the JAX package's host modules.  Device side: an encoder of one batch
(``make_device_normalizing_encoder``) or of k stacked batches
(``make_scan_encoder``, JAX's jitted ``lax.scan``: on the card one CUDA
graph of the k tower calls a stack shape, replayed), and the index
(retrieval/index.py).  ``RetrievalEngine(scan_batches=k)`` sends full
stacks of k batches through the stack encoder and pads the tail stack
with copies of its last batch, whose outputs are dropped, as JAX's engine
does.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..input.cache import DecodedU8Cache
from ..input.pipeline import CLIP_MEAN, CLIP_STD, ImageBatcher, list_images
from ..metrics.retrieval_metrics import RetrievalMetrics, evaluate_rankings
from ..models.vit import fold_u8_tower
from ..utils.graphs import StepGraph, graphed_on
from .index import EmbeddingIndex

Encoder = Callable[[np.ndarray], np.ndarray]


def clip_constants(device) -> tuple[torch.Tensor, torch.Tensor]:
    """CLIP's mean and 1/std on ``device`` (made before a CUDA graph's
    capture, which refuses host copies)."""
    return (torch.as_tensor(CLIP_MEAN, device=device),
            torch.as_tensor(1.0 / CLIP_STD, device=device))


def device_normalize(batch: torch.Tensor,
                     constants: tuple | None = None) -> torch.Tensor:
    """CLIP-normalize a uint8 batch on its device, ``(x/255 − mean)/std``;
    float batches pass through (taken as normalized already).
    ``constants``: ``clip_constants`` of the batch's device."""
    if batch.dtype == torch.uint8:
        mean, inv_std = (clip_constants(batch.device) if constants is None
                         else constants)
        batch = (batch.float() / 255.0 - mean) * inv_std
    return batch


def _tower_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _u8_only(batch) -> None:
    if batch.dtype not in (np.uint8, torch.uint8):
        raise ValueError("fold_u8 encoder accepts uint8 batches only "
                         "(weights are normalization-folded)")


def make_device_normalizing_encoder(model: torch.nn.Module,
                                    device: torch.device | str | None = None,
                                    fold_u8: bool = False) -> Encoder:
    """Encoder taking host uint8 (or normalized f32) NHWC batches: the
    batch moves to ``device`` (the model's by default) as it is, is
    normalized there, and the features come back as an f32 numpy array.
    ``fold_u8``: the normalization folded into the tower's patch and
    position embeddings instead (``models.vit.fold_u8_tower``); the
    encoder then takes uint8 batches only."""
    device = _tower_device(model) if device is None else torch.device(device)
    tower = fold_u8_tower(model) if fold_u8 else model
    constants = clip_constants(device)

    def encode(batch: np.ndarray) -> np.ndarray:
        if fold_u8:
            _u8_only(batch)
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        with torch.inference_mode():
            x = x if fold_u8 else device_normalize(x, constants)
            return tower(x).float().cpu().numpy()

    return encode


def make_scan_encoder(model: torch.nn.Module, fold_u8: bool = False,
                      device: torch.device | str | None = None,
                      graphed: bool | None = None) -> Encoder:
    """JAX's ``make_scan_encoder``: [k, B, H, W, 3] (uint8, or normalized
    f32) → [k, B, D] f32 numpy features, the k batches encoded one after
    another.  On the card (``graphed``; see ``utils.graphs.graphed_on``)
    one CUDA graph of the k tower calls per (k, B, H, W, input dtype),
    captured at the second call of that shape (the first is the eager
    warm-up) and replayed from a static input buffer; elsewhere, or with
    ``graphed=False``, the same calls eagerly.  ``fold_u8``: as in
    ``make_device_normalizing_encoder``, uint8 only."""
    device = _tower_device(model) if device is None else torch.device(device)
    tower = fold_u8_tower(model) if fold_u8 else model
    graphed = graphed_on(device, graphed)
    constants = clip_constants(device)
    slots: dict = {}

    @torch.no_grad()
    def encode_stack(x: torch.Tensor) -> torch.Tensor:
        return torch.stack([
            tower(x[j] if fold_u8 else device_normalize(x[j], constants))
            .float() for j in range(x.shape[0])])

    def run(batches) -> np.ndarray:
        if fold_u8:
            _u8_only(batches)
        host = torch.as_tensor(np.ascontiguousarray(batches)) \
            if isinstance(batches, np.ndarray) else batches
        if not graphed:
            return encode_stack(host.to(device)).cpu().numpy()
        key = (tuple(host.shape), host.dtype)
        slot = slots.get(key)
        if slot is None:
            static = torch.empty(host.shape, dtype=host.dtype, device=device)
            slot = slots[key] = (static, StepGraph(
                lambda: encode_stack(static)))
        static, graph = slot
        static.copy_(host)
        return graph().cpu().numpy()

    return run


class RetrievalEngine:
    """Encode → index → retrieve → evaluate on one device.  Images are
    decoded on the host into uint8 batches and normalized on the device.

    Args:
        encode_fn: [B, H, W, 3] numpy batch → [B, D] numpy features.
        device: where the index lives.
        cache_dir: enable the decoded-u8 cache under this directory.
        mesh: hold the index's rows in blocks over ``mesh["data"]``
            (``EmbeddingIndex(mesh=...)``); every rank of the mesh builds
            the engine and calls its index methods alike.
        scan_batches / encode_many_fn: with ``scan_batches`` = k > 1,
            batches go to ``encode_many_fn`` ([k, B, H, W, 3] → [k, B, D],
            ``make_scan_encoder``) in stacks of k; a short last stack of
            two or more batches is padded with copies of its last batch
            (the same stack shape, the same graph) and the copies'
            outputs dropped; a last stack of one batch goes to
            ``encode_fn``.
        input_dtype: "u8" (the default here: raw uint8 batches, normalized
            on the device) or "f32" (normalized on the host); the
            encoders above take both, a ``fold_u8`` one only "u8".
    """

    def __init__(self, encode_fn: Encoder, device: torch.device | str,
                 batch_size: int = 128, num_workers: int = 8,
                 image_size: int = 224, cache_dir: str | None = None,
                 mesh=None, scan_batches: int = 1,
                 encode_many_fn: Encoder | None = None,
                 input_dtype: str = "u8"):
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        self.mesh = mesh
        self.scan_batches = max(1, scan_batches)
        self.encode_many_fn = encode_many_fn
        if self.scan_batches > 1 and encode_many_fn is None:
            raise ValueError("scan_batches > 1 requires encode_many_fn "
                             "(build one with make_scan_encoder)")
        if input_dtype not in ("f32", "u8"):
            raise ValueError(f"input_dtype must be 'f32'|'u8', {input_dtype}")
        self.input_dtype = input_dtype
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.image_size = image_size
        self._cache = (DecodedU8Cache(cache_dir, image_size)
                       if cache_dir is not None else None)
        self.index: EmbeddingIndex | None = None

    def close(self) -> None:
        """Flush and close the engine-owned decoded-u8 cache."""
        if self._cache is not None:
            self._cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def encode_paths(self, image_paths: Sequence[str]
                     ) -> tuple[np.ndarray, list[str]]:
        """Decode + encode images → (embeddings [N, D], kept paths)."""
        batcher = ImageBatcher(image_paths, batch_size=self.batch_size,
                               image_size=self.image_size,
                               num_workers=self.num_workers,
                               out_dtype=self.input_dtype, cache=self._cache)
        embs, names = [], []
        pending: list[tuple[np.ndarray, list[str], int]] = []

        def flush():
            if self.scan_batches > 1 and len(pending) > 1:
                # only full stacks ride the stack encoder: a short last
                # stack is padded with copies of its last batch (one
                # stack shape, one graph) and their outputs dropped; a
                # last stack of one batch takes the batch encoder
                stack = [b for b, _, _ in pending]
                stack += [stack[-1]] * (self.scan_batches - len(stack))
                outs = self.encode_many_fn(np.stack(stack))
                for i, (_b, paths, n_valid) in enumerate(pending):
                    embs.append(outs[i, :n_valid])
                    names.extend(paths)
            else:
                for batch, paths, n_valid in pending:
                    embs.append(self.encode_fn(batch)[:n_valid])
                    names.extend(paths)
            pending.clear()

        for batch, paths, n_valid in batcher:
            if n_valid == 0:
                continue
            pending.append((batch, paths, n_valid))
            if len(pending) >= self.scan_batches:
                flush()
        flush()
        if self._cache is not None:
            self._cache.flush()
        if not embs:
            return np.zeros((0, 0), np.float32), []
        return np.concatenate(embs, axis=0), names

    def encode_dataset(self, gallery_folder_or_paths: str | Sequence[str],
                       save_prefix: str | None = None) -> EmbeddingIndex:
        """Encode the gallery and build the index."""
        if isinstance(gallery_folder_or_paths, str):
            paths = list_images(gallery_folder_or_paths)
        else:
            paths = list(gallery_folder_or_paths)
        emb, names = self.encode_paths(paths)
        self.index = EmbeddingIndex(emb, names, device=self.device,
                                    mesh=self.mesh)
        if save_prefix is not None:
            os.makedirs(os.path.dirname(save_prefix) or ".", exist_ok=True)
            self.index.save(save_prefix)
        return self.index

    def load_embeddings(self, prefix: str) -> EmbeddingIndex:
        """Load a saved index."""
        self.index = EmbeddingIndex.load(prefix, device=self.device,
                                         mesh=self.mesh)
        return self.index

    def retrieve_similar_images(self, query_path: str, k: int = 20
                                ) -> list[tuple[str, float]]:
        """Top-k gallery (name, score) pairs for one query image."""
        if self.index is None:
            raise ValueError("No database embeddings found. "
                             "Please encode dataset first.")
        emb, _names = self.encode_paths([query_path])
        if emb.shape[0] == 0:
            raise ValueError(f"query image failed to decode: {query_path}")
        return self.index.search_names(emb, k=k)[0]

    def rank_queries(self, query_folder_or_paths: str | Sequence[str],
                     k: int | None = None) -> dict[str, list[str]]:
        """Gallery rankings (basenames, best-first) keyed by query
        basename; the whole gallery when ``k`` is None."""
        if self.index is None:
            raise ValueError("No database embeddings found.")
        if isinstance(query_folder_or_paths, str):
            qpaths = list_images(query_folder_or_paths)
        else:
            qpaths = list(query_folder_or_paths)
        qemb, qnames = self.encode_paths(qpaths)
        if not qnames:
            return {}
        _vals, idx = self.index.search(qemb, k=k or len(self.index))
        gallery = [os.path.basename(n) for n in self.index.names]
        out: dict[str, list[str]] = {}
        for q, row in zip(qnames, idx):
            key = os.path.basename(q)
            if key in out:
                raise ValueError(
                    f"duplicate query basename {key!r}: rankings are keyed "
                    "by basename — deduplicate the query set or flatten "
                    "the directory")
            out[key] = [gallery[j] for j in row]
        return out

    def evaluate(self, query_folder_or_paths: str | Sequence[str],
                 ground_truth: Mapping | str,
                 positives_key: str = "patent_positives",
                 results_path: str | None = None) -> RetrievalMetrics:
        """Full-gallery rankings per query scored with the reference battery
        (retrieval.ipynb cell 3); optional JSON dump of the results."""
        if isinstance(ground_truth, str):
            with open(ground_truth) as f:
                ground_truth = json.load(f)
        rankings = self.rank_queries(query_folder_or_paths, k=None)
        metrics = evaluate_rankings(rankings, ground_truth,
                                    positives_key=positives_key)
        if results_path is not None:
            os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
            metrics.save(results_path)
        return metrics
