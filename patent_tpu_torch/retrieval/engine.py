"""Encode → index → retrieve → evaluate (port of
patent_tpu/retrieval/engine.py, one device, no scan batching).

Host side: ``ImageBatcher`` (threaded decode into fixed-shape u8 batches),
``DecodedU8Cache`` and the reference metric battery, the port's own copies
of the JAX package's host modules.
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
from .index import EmbeddingIndex

Encoder = Callable[[np.ndarray], np.ndarray]


def device_normalize(batch: torch.Tensor) -> torch.Tensor:
    """CLIP-normalize a uint8 batch on its device, ``(x/255 − mean)/std``;
    float batches pass through (taken as normalized already)."""
    if batch.dtype == torch.uint8:
        mean = torch.as_tensor(CLIP_MEAN, device=batch.device)
        inv_std = torch.as_tensor(1.0 / CLIP_STD, device=batch.device)
        batch = (batch.float() / 255.0 - mean) * inv_std
    return batch


def make_device_normalizing_encoder(model: torch.nn.Module,
                                    device: torch.device | str) -> Encoder:
    """Encoder taking host uint8 (or normalized f32) NHWC batches: the
    batch moves to ``device`` as it is, is normalized there, and the
    features come back as an f32 numpy array."""
    device = torch.device(device)

    def encode(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        with torch.inference_mode():
            return model(device_normalize(x)).float().cpu().numpy()

    return encode


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
    """

    def __init__(self, encode_fn: Encoder, device: torch.device | str,
                 batch_size: int = 128, num_workers: int = 8,
                 image_size: int = 224, cache_dir: str | None = None,
                 mesh=None):
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        self.mesh = mesh
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
                               out_dtype="u8", cache=self._cache)
        embs, names = [], []
        for batch, paths, n_valid in batcher:
            if n_valid == 0:
                continue
            embs.append(self.encode_fn(batch)[:n_valid])
            names.extend(paths)
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
