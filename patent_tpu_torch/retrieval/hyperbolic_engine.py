"""Hyperbolic retrieval: a Poincaré encoder and a geodesic top-k index
(port of patent_tpu/retrieval/hyperbolic_engine.py).

Gallery feature rows (precomputed CLIP features) are encoded into the ball
by a ``HyperbolicEmbeddingModel`` and indexed by geodesic distance;
queries are encoded the same way.  ``quantized=True`` keeps the gallery as
int8 rows with three f32 row terms and answers through the Poincaré
candidate kernel with an exact f64 re-rank
(``retrieval/index.py::topk_search_poincare_fast``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..metrics.retrieval_metrics import RetrievalMetrics, evaluate_rankings
from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..parallel.mesh import RowBlocks
from .index import EmbeddingIndex


class HyperbolicRetrievalEngine:
    """Exact geodesic-distance retrieval over hyperbolically encoded
    figures.

    Args:
        model: a trained ``HyperbolicEmbeddingModel``; it is moved to
            ``device`` and put in eval mode.
        features: [N, D] Euclidean figure features, numpy or a tensor.
        names: per-row figure names.
        device: where the encoder and the index run.
        mesh: hold the index's rows in blocks over ``mesh["data"]``; each
            rank encodes only its block of the gallery's rows.
    """

    def __init__(self, model: HyperbolicEmbeddingModel, features,
                 names: Sequence[str], device: torch.device | str,
                 batch_size: int = 512, quantized: bool = False,
                 mesh=None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.c = model.c
        self.batch_size = batch_size
        if mesh is not None:
            start, stop = RowBlocks("data").bounds(mesh, len(names))
            features = features[start:stop]
        gallery = self.encode_features(features)
        self.index = EmbeddingIndex(gallery, list(names),
                                    similarity="poincare", c=self.c,
                                    device=self.device, quantized=quantized,
                                    mesh=mesh)

    @torch.no_grad()
    def encode_features(self, features) -> torch.Tensor:
        """[N, D] (or one [D]) features → [N, embed_dim] ball points on
        the device, ``batch_size`` rows at a time."""
        xs = torch.as_tensor(features, dtype=torch.float32)
        xs = xs.reshape(-1, xs.shape[-1])
        out = [self.model(xs[s:s + self.batch_size].to(self.device))
               for s in range(0, xs.shape[0], self.batch_size)]
        return torch.cat(out) if out else torch.zeros(
            0, self.model.label_emb.shape[1], device=self.device)

    def retrieve(self, query_features, k: int = 20
                 ) -> list[list[tuple[str, float]]]:
        """Per query: [(gallery name, −geodesic distance), ...] best-first."""
        q = self.encode_features(query_features)
        return self.index.search_names(q, k=k)

    def rank_all(self, query_features,
                 query_names: Sequence[str]) -> dict[str, list[str]]:
        q = self.encode_features(query_features)
        _vals, idx = self.index.search(q, k=len(self.index))
        return {qn: [self.index.names[j] for j in row]
                for qn, row in zip(query_names, idx)}

    def evaluate(self, query_features, query_names: Sequence[str],
                 ground_truth: Mapping[str, Mapping],
                 positives_key: str = "patent_positives") -> RetrievalMetrics:
        """The reference metric battery (retrieval.ipynb cell 3) over
        geodesic rankings."""
        rankings = self.rank_all(query_features, query_names)
        return evaluate_rankings(rankings, ground_truth,
                                 positives_key=positives_key)
