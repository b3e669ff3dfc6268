"""Exact cosine and Poincaré top-k index on one device (port of the
single-device part of patent_tpu/retrieval/index.py).

``topk_search`` is the oracle: a blockwise f32 scan (plain matmuls, as the
JAX package leaves it to XLA).  For ``similarity="poincare"`` it ranks by
the monotone surrogate of −distance and returns the true −distance of the
k winners.  ``topk_search_cosine_fast`` over-fetches a
``DEFAULT_RERANK_MULT``·k candidate pool with the bucketed bf16 kernel
(ops/topk_kernel) and re-ranks it exactly in f32, so its answer equals the
scan's, ties included; ``topk_search_quantized`` does the same from an
int8 gallery; ``topk_search_poincare_fast`` over-fetches from the int8
Poincaré kernel and re-ranks with the f64 direct distance, which near the
boundary orders more exactly than the scan's f32 surrogate.
``EmbeddingIndex`` takes a candidate path whenever the pool is smaller
than the gallery (the bf16 one on a CUDA device only; the int8 ones,
``quantized=True``, on any device), and the scan otherwise; it reads and
writes the JAX index's ``.npy`` + ``.json`` files, and exports the
reference's feature pickle (``save_feature_pickle``).  Its candidate copies
are zero-padded to the kernels' multiple of columns, as JAX pads D, so
every width reaches the kernels.
"""

from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np
import torch

from ..ops import poincare
from ..ops.topk_kernel import (PoincareGallery, bucket_topk_bf16,
                               bucket_topk_int8, bucket_topk_poincare,
                               bucket_topk_supported, pad_columns,
                               prepare_cosine_gallery_bf16,
                               prepare_poincare_gallery, quantize_gallery,
                               quantize_queries)

DEFAULT_RERANK_MULT = 8
# pool depth of the Poincaré candidate stage (the JAX package's choice)
POINCARE_RERANK_MULT = DEFAULT_RERANK_MULT
SIMILARITIES = ("cosine", "poincare")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _top_sorted(vals: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` per row, best-first, ties to the lower position (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none)."""
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], pos[:, :k]


def _scores_block(q: torch.Tensor, g: torch.Tensor, similarity: str,
                  c: float) -> torch.Tensor:
    """[Q, B] scores (higher is better) of one gallery block.  Cosine: q
    is already normalized.  Poincaré: the monotone surrogate of −distance,

        s(v) = 2·u·(v·w) − |u|²·w − |v|²·w,   w = 1/(1 − c|v|²),

    which orders a query's gallery exactly as the distance does (the
    u-terms of the arcosh form are constants of the query)."""
    if similarity == "cosine":
        return q @ _normalize(g).T
    g_sq = (g * g).sum(dim=-1)
    w = 1.0 / torch.clamp_min(1.0 - c * g_sq, 1e-12)
    q_sq = (q * q).sum(dim=-1, keepdim=True)
    return 2.0 * (q @ (g * w[:, None]).T) - q_sq * w[None, :] \
        - (g_sq * w)[None, :]


def topk_search(queries: torch.Tensor, gallery: torch.Tensor, k: int = 10,
                block_size: int = 8192, similarity: str = "cosine",
                c: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, blockwise over the gallery, in f32.

    Returns (scores [Q, k] f32, indices [Q, k] int64) best-first; ties go
    to the lower gallery index; a gallery smaller than k pads with
    (-inf, 0).  Cosine scores are cosines; Poincaré ones are the true
    −distance of each winner (ranked by the surrogate)."""
    if similarity not in SIMILARITIES:
        raise ValueError(f"unknown similarity {similarity!r}")
    q = queries.float()
    if similarity == "cosine":
        q = _normalize(q)
    g = gallery.float()
    n, nq = g.shape[0], q.shape[0]
    if n <= max(block_size, k):
        vals, idx = _top_sorted(_scores_block(q, g, similarity, c),
                                min(k, n))
        if n < k:
            vals = torch.nn.functional.pad(vals, (0, k - n),
                                           value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, k - n), value=0)
    else:
        vals = torch.full((nq, k), float("-inf"), device=q.device)
        idx = torch.zeros((nq, k), dtype=torch.long, device=q.device)
        for start in range(0, n, block_size):
            blk = g[start:start + block_size]
            s = _scores_block(q, blk, similarity, c)
            col = torch.arange(start, start + blk.shape[0],
                               device=q.device).expand(nq, -1)
            vals, pos = _top_sorted(torch.cat([vals, s], dim=1), k)
            idx = torch.gather(torch.cat([idx, col], dim=1), 1, pos)
    if similarity == "poincare":
        d = poincare.dist(q[:, None, :], g[idx], c)
        vals = torch.where(torch.isfinite(vals), -d, vals)
    return vals, idx


def _cosine_rerank_device(pidx: torch.Tensor, queries: torch.Tensor,
                          gallery: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 cosine re-rank of a candidate pool, with the scan's
    normalization.  The pool is first sorted by gallery index, so the
    stable descending sort breaks exact ties (duplicate rows) to the lower
    gallery index, as the scan does."""
    pidx = torch.sort(pidx, dim=1).values
    qn = _normalize(queries.float())
    cand = _normalize(gallery.float()[pidx])                  # [Q, P, D]
    exact = torch.einsum("qd,qpd->qp", qn, cand)
    vals, pos = _top_sorted(exact, k)
    return vals, torch.gather(pidx, 1, pos)


def fused_cosine_eligible(n: int, k: int, device: torch.device,
                          rerank_mult: int = DEFAULT_RERANK_MULT) -> bool:
    """True iff ``EmbeddingIndex.search`` takes the bucket-kernel path: a
    CUDA device and a candidate pool smaller than the gallery."""
    pool = min(max(k * rerank_mult, k), n)
    return (torch.device(device).type == "cuda" and pool < n
            and bucket_topk_supported(n, pool))


def topk_search_cosine_fast(queries: torch.Tensor, gal_bf16: torch.Tensor,
                            valid: torch.Tensor, gallery_f32: torch.Tensor,
                            k: int = 10, block_size: int = 8192,
                            rerank_mult: int = DEFAULT_RERANK_MULT
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: bucketed bf16 candidate pool of
    ``rerank_mult``·k, then the exact f32 re-rank — the same answer as
    ``topk_search``.  The one reachable difference is a gallery with more
    than two exact duplicates of a row in one bucket (row mod 1024): the
    excess copies are evicted and the tail back-fills with the next rows.
    Falls back to the scan when the pool covers the whole gallery."""
    q = queries.float()
    n = gal_bf16.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size)
    _pv, pidx = bucket_topk_bf16(q, gal_bf16, valid, pool)
    return _cosine_rerank_device(pidx, q, gallery_f32, k)


def topk_search_quantized(queries: torch.Tensor, gal_i8: torch.Tensor,
                          gal_scale: torch.Tensor, gallery_f32: torch.Tensor,
                          k: int = 10, block_size: int = 8192,
                          rerank_mult: int = DEFAULT_RERANK_MULT
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k from an int8 gallery (``quantize_gallery``): the
    queries are normalized and row-quantized, the bucketed int8 stage
    over-fetches a ``rerank_mult``·k pool, and the exact f32 re-rank gives
    the same answer as ``topk_search``, ties included.  The scan answers
    when the pool would cover the gallery or exceed the stage's capacity."""
    q = queries.float()
    n = gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size)
    q_i8, q_scale = quantize_queries(q)
    _pv, pidx = bucket_topk_int8(q_i8, q_scale, gal_i8, gal_scale, pool)
    return _cosine_rerank_device(pidx, q, gallery_f32, k)


def poincare_dist_f64(u: torch.Tensor, v: torch.Tensor,
                      c: float) -> torch.Tensor:
    """f64 Poincaré distance in the cancellation-free direct form,
    arcosh(1 + 2c|u−v|² / ((1−c|u|²)(1−c|v|²))) / √c: u [Q, D], v [Q, P, D]
    → [Q, P]."""
    u, v = u.double(), v.double()
    diff_sq = (u[:, None, :] - v).square().sum(dim=-1)
    den = ((1.0 - c * (u * u).sum(dim=-1))[:, None]
           * (1.0 - c * (v * v).sum(dim=-1)))
    arg = 1.0 + 2.0 * c * diff_sq / torch.clamp_min(den, 1e-15)
    return torch.acosh(torch.clamp_min(arg, 1.0)) / math.sqrt(c)


def _poincare_rerank(pidx: torch.Tensor, queries: torch.Tensor,
                     gallery: torch.Tensor, k: int, c: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f64 re-rank of a candidate pool on its device.  The pool is
    first sorted by gallery index, so the stable ascending sort breaks
    exact ties to the lower gallery index, as the scan does.  Returns
    (−distance f32, indices)."""
    pidx = torch.sort(pidx, dim=1).values
    d = poincare_dist_f64(queries, gallery[pidx], c)
    d, pos = torch.sort(d, dim=1, stable=True)
    return -d[:, :k].float(), torch.gather(pidx, 1, pos[:, :k])


def topk_search_poincare_fast(queries: torch.Tensor, gal: PoincareGallery,
                              gallery_f32: torch.Tensor, k: int = 10,
                              c: float = 1.0, block_size: int = 8192,
                              rerank_mult: int = POINCARE_RERANK_MULT
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Poincaré top-k: the int8 surrogate candidate stage over-fetches a
    ``rerank_mult``·k pool, and the exact f64 distance re-ranks it on the
    gallery's device; values are −distance, as ``topk_search`` returns
    them.  The scan answers when the pool would cover the gallery or
    exceed the stage's capacity."""
    q = queries.float()
    n = gal.gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size,
                           similarity="poincare", c=c)
    _pv, pidx = bucket_topk_poincare(q, gal, pool)
    return _poincare_rerank(pidx, q, gallery_f32, k, c)


def _default_device(embeddings) -> torch.device:
    """A tensor's own device; for anything else the card, which must be
    there (pass ``device="cpu"`` for the CPU)."""
    if isinstance(embeddings, torch.Tensor):
        return embeddings.device
    if not torch.cuda.is_available():
        raise RuntimeError("EmbeddingIndex: no CUDA card is visible; pass "
                           "device='cpu' to index on the CPU")
    return torch.device("cuda")


class EmbeddingIndex:
    """In-memory exact index on one device, cosine or Poincaré (curvature
    ``c``); persistence matches the reference's ``.npy`` + names-JSON
    layout.

    ``device``: where the gallery lives; by default a tensor's own device
    and the card for a numpy array.  ``quantized=True``: the gallery also
    lives as per-row int8 (cosine: ``quantize_gallery``; Poincaré:
    ``prepare_poincare_gallery``, with its three f32 row terms), and
    searches take their candidates from it (``topk_search_quantized``,
    ``topk_search_poincare_fast``); the f32 copy stays for the re-rank and
    persistence."""

    def __init__(self, embeddings, names: list[str],
                 similarity: str = "cosine", c: float = 1.0,
                 device: torch.device | str | None = None,
                 quantized: bool = False):
        if similarity not in SIMILARITIES:
            raise NotImplementedError(
                f"similarity {similarity!r} is not yet ported to "
                f"patent_tpu_torch (one of {SIMILARITIES})")
        if len(names) != int(embeddings.shape[0]):
            raise ValueError(f"names ({len(names)}) and embeddings "
                             f"({embeddings.shape[0]}) disagree")
        self.device = torch.device(device if device is not None
                                   else _default_device(embeddings))
        self.names = list(names)
        self.similarity = similarity
        self.c = c
        self.embeddings = torch.as_tensor(embeddings, dtype=torch.float32,
                                          device=self.device)
        self.quantized = quantized
        # the candidate copies are zero-padded to the kernels' multiple of
        # columns (topk_kernel.pad_columns) once, here; searches pad the
        # queries after normalizing or quantizing them
        if quantized and similarity == "poincare":
            gal = prepare_poincare_gallery(self.embeddings, c)
            self.emb_gal = gal._replace(gal_i8=pad_columns(gal.gal_i8))
        elif quantized:
            i8, scale = quantize_gallery(self.embeddings.cpu().numpy())
            self.emb_i8 = pad_columns(torch.from_numpy(i8).to(self.device))
            self.emb_scale = torch.from_numpy(scale).to(self.device)
        # bf16 candidate copy for the kernel path, built on the first
        # search that takes it (full-ranking callers never pay for it)
        self._gal16 = None
        self._gal16_valid = None

    def __len__(self) -> int:
        return len(self.names)

    def search(self, queries, k: int = 10, block_size: int = 8192
               ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (scores [Q, k], indices [Q, k]) best-first."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        k = min(k, len(self.names))
        if self.similarity == "poincare":
            if self.quantized:
                vals, idx = topk_search_poincare_fast(
                    q, self.emb_gal, self.embeddings, k=k, c=self.c,
                    block_size=block_size)
            else:
                vals, idx = topk_search(q, self.embeddings, k=k,
                                        block_size=block_size,
                                        similarity="poincare", c=self.c)
        elif self.quantized:
            vals, idx = topk_search_quantized(
                q, self.emb_i8, self.emb_scale, self.embeddings, k=k,
                block_size=block_size)
        elif fused_cosine_eligible(len(self.names), k, self.device):
            if self._gal16 is None:
                gal16, self._gal16_valid = \
                    prepare_cosine_gallery_bf16(self.embeddings)
                self._gal16 = pad_columns(gal16)
            vals, idx = topk_search_cosine_fast(
                q, self._gal16, self._gal16_valid, self.embeddings, k=k,
                block_size=block_size)
        else:
            vals, idx = topk_search(q, self.embeddings, k=k,
                                    block_size=block_size)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_names(self, queries, k: int = 10
                     ) -> list[list[tuple[str, float]]]:
        """Per query: [(gallery name, score), ...] best-first."""
        vals, idx = self.search(queries, k=k)
        return [[(self.names[j], float(v)) for j, v in zip(row_i, row_v)]
                for row_i, row_v in zip(idx, vals)]

    def save(self, prefix: str) -> None:
        """Save as ``{prefix}.npy`` + ``{prefix}.json``."""
        np.save(f"{prefix}.npy", self.embeddings.cpu().numpy())
        with open(f"{prefix}.json", "w") as f:
            json.dump(self.names, f)

    @classmethod
    def load(cls, prefix: str, **kwargs) -> "EmbeddingIndex":
        emb = np.load(f"{prefix}.npy")
        with open(f"{prefix}.json") as f:
            names = json.load(f)
        return cls(emb, names, **kwargs)

    def to_feature_dict(self, basename_keys: bool = True
                        ) -> dict[str, np.ndarray]:
        """{figure name: f32 numpy row}, the reference's per-figure
        embedding pickle schema (graph generation cell 17), which the
        feature-matrix builder and the fine-tune's alignment read."""
        emb = self.embeddings.cpu().numpy()
        keyfn = os.path.basename if basename_keys else (lambda s: s)
        return {keyfn(n): emb[i] for i, n in enumerate(self.names)}

    def save_feature_pickle(self, path: str, basename_keys: bool = True
                            ) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_feature_dict(basename_keys), f)
