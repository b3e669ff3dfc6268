"""Exact cosine top-k index on one device (port of the cosine,
single-device part of patent_tpu/retrieval/index.py).

``topk_search`` is the oracle: a blockwise f32 scan (plain matmuls, as the
JAX package leaves it to XLA).  ``topk_search_cosine_fast`` over-fetches a
``DEFAULT_RERANK_MULT``·k candidate pool with the bucketed bf16 kernel
(ops/topk_kernel) and re-ranks it exactly in f32, so its answer equals the
scan's, ties included; ``topk_search_quantized`` does the same from an
int8 gallery.  ``EmbeddingIndex`` takes a candidate path whenever the pool
is smaller than the gallery (the bf16 one on a CUDA device only; the int8
one, ``quantized=True``, on any device), and the scan otherwise; it reads
and writes the JAX index's ``.npy`` + ``.json`` files.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.topk_kernel import (bucket_topk_bf16, bucket_topk_int8,
                               bucket_topk_supported,
                               prepare_cosine_gallery_bf16, quantize_gallery,
                               quantize_queries)

DEFAULT_RERANK_MULT = 8


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _top_sorted(vals: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` per row, best-first, ties to the lower position (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none)."""
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], pos[:, :k]


def topk_search(queries: torch.Tensor, gallery: torch.Tensor, k: int = 10,
                block_size: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k, blockwise over the gallery, in f32.

    Returns (scores [Q, k] f32, indices [Q, k] int64) best-first; ties go
    to the lower gallery index; a gallery smaller than k pads with
    (-inf, 0)."""
    q = _normalize(queries.float())
    g = gallery.float()
    n, nq = g.shape[0], q.shape[0]
    if n <= max(block_size, k):
        vals, idx = _top_sorted(q @ _normalize(g).T, min(k, n))
        if n < k:
            vals = torch.nn.functional.pad(vals, (0, k - n),
                                           value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, k - n), value=0)
        return vals, idx
    best_v = torch.full((nq, k), float("-inf"), device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.long, device=q.device)
    for start in range(0, n, block_size):
        blk = g[start:start + block_size]
        s = q @ _normalize(blk).T
        col = torch.arange(start, start + blk.shape[0],
                           device=q.device).expand(nq, -1)
        best_v, pos = _top_sorted(torch.cat([best_v, s], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, col], dim=1), 1, pos)
    return best_v, best_i


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
    """In-memory exact cosine index on one device; persistence matches the
    reference's ``.npy`` + names-JSON layout.

    ``device``: where the gallery lives; by default a tensor's own device
    and the card for a numpy array.  ``quantized=True``: the gallery also
    lives as per-row int8 (``quantize_gallery``), and searches take their
    candidates from it (``topk_search_quantized``); the f32 copy stays for
    the re-rank and persistence."""

    def __init__(self, embeddings, names: list[str],
                 similarity: str = "cosine",
                 device: torch.device | str | None = None,
                 quantized: bool = False):
        if similarity != "cosine":
            raise NotImplementedError(
                f"similarity {similarity!r} is not yet ported to "
                "patent_tpu_torch (cosine only)")
        if len(names) != int(embeddings.shape[0]):
            raise ValueError(f"names ({len(names)}) and embeddings "
                             f"({embeddings.shape[0]}) disagree")
        self.device = torch.device(device if device is not None
                                   else _default_device(embeddings))
        self.names = list(names)
        self.similarity = similarity
        self.embeddings = torch.as_tensor(embeddings, dtype=torch.float32,
                                          device=self.device)
        self.quantized = quantized
        if quantized:
            i8, scale = quantize_gallery(self.embeddings.cpu().numpy())
            self.emb_i8 = torch.from_numpy(i8).to(self.device)
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
        if self.quantized:
            vals, idx = topk_search_quantized(
                q, self.emb_i8, self.emb_scale, self.embeddings, k=k,
                block_size=block_size)
        elif fused_cosine_eligible(len(self.names), k, self.device):
            if self._gal16 is None:
                self._gal16, self._gal16_valid = \
                    prepare_cosine_gallery_bf16(self.embeddings)
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
