"""Retrieval metrics of the reference protocol (the port's copy of
patent_tpu/metrics/retrieval_metrics.py).

The formulas replicate ``notebooks/retrieval.ipynb`` cell 3, including its
non-standard choices, because the published baseline numbers came from
them: AP sums precision-at-hit over ``len(positives)``; NDCG uses binary
gains with IDCG over ``len(positives)``; MRR@k is 0 when no positive is in
the top k; Precision@k divides by k and is 0.0 when fewer than k items were
retrieved; queries absent from the ground truth are skipped and counted.
Computed on the host in numpy from ranked name lists.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence

import numpy as np


def mrr_at_k(retrieved: Sequence[str], positives: set[str], k: int) -> float:
    """Reciprocal rank of the first positive within the top ``k`` (cell 3)."""
    for rank, name in enumerate(retrieved[:k], 1):
        if name in positives:
            return 1.0 / rank
    return 0.0


def precision_at_k(retrieved: Sequence[str], positives: set[str], k: int) -> float:
    """|top-k ∩ positives| / k; 0.0 if fewer than k items were retrieved (cell 3)."""
    if k > len(retrieved):
        return 0.0
    retrieved_at_k = retrieved[:k]
    return len(set(retrieved_at_k).intersection(positives)) / k


def recall_at_k(retrieved: Sequence[str], positives: set[str], k: int) -> float:
    """|top-k ∩ positives| / |positives| (cell 3 Recall@k)."""
    if not positives:
        return 0.0
    return len(set(retrieved[:k]).intersection(positives)) / len(positives)


def _hit_ranks(retrieved: Sequence[str], positives: set[str]) -> np.ndarray:
    """0-based ranks of the positives within the full ranking — the one
    pass over the ranking that AP and NDCG both consume (the per-item
    Python loops cost ~two full gallery walks per query at eval scale)."""
    return np.asarray([j for j, name in enumerate(retrieved)
                       if name in positives], np.int64)


def average_precision_reference(retrieved: Sequence[str], positives: set[str]) -> float:
    """AP normalized by |positives| over the FULL ranking (cell 3 "AP
    calculation") — vectorized, identical output to the per-item loop."""
    if not positives:
        return 0.0
    hits = _hit_ranks(retrieved, positives)
    if hits.size == 0:
        return 0.0
    prec_at_hits = np.arange(1, hits.size + 1, dtype=np.float64) / (hits + 1)
    return float(prec_at_hits.sum() / len(positives))


def ndcg_reference(retrieved: Sequence[str], positives: set[str]) -> float:
    """Binary-gain NDCG with IDCG over |positives| (cell 3 "NDCG
    calculation") — vectorized, identical output to the per-item loop."""
    n_pos = len(positives)
    if n_pos == 0:
        return 0.0
    idcg = float(np.sum(1.0 / np.log2(np.arange(n_pos, dtype=np.float64)
                                      + 2.0)))
    if idcg <= 0:
        return 0.0
    hits = _hit_ranks(retrieved, positives)
    dcg = float(np.sum(1.0 / np.log2(hits + 2.0))) if hits.size else 0.0
    return dcg / idcg


@dataclasses.dataclass
class RetrievalMetrics:
    """Summary + query-wise metrics, serialized in the reference's JSON schema
    (cell 3 ``detailed_results``)."""

    mrr: float = 0.0
    mrr_5: float = 0.0
    mrr_20: float = 0.0
    map: float = 0.0
    ndcg: float = 0.0
    recall_5: float = 0.0
    recall_10: float = 0.0
    recall_20: float = 0.0
    precision_5: float = 0.0
    precision_10: float = 0.0
    precision_20: float = 0.0
    num_queries: int = 0
    num_skipped: int = 0
    # ground-truth queries with NO ranking (query failed to decode or was
    # dropped upstream): the means above cover a SMALLER query set than
    # the ground truth — visible here instead of vanishing silently
    num_missing_rankings: int = 0
    query_wise: dict = dataclasses.field(default_factory=dict)

    def summary_dict(self) -> dict:
        return {
            "MRR": self.mrr,
            "MRR@5": self.mrr_5,
            "MRR@20": self.mrr_20,
            "mAP": self.map,
            "mNDCG": self.ndcg,
            "Recall@5": self.recall_5,
            "Recall@10": self.recall_10,
            "Recall@20": self.recall_20,
            "Precision@5": self.precision_5,
            "Precision@10": self.precision_10,
            "Precision@20": self.precision_20,
        }

    def detailed_dict(self) -> dict:
        return {"query_wise_metrics": self.query_wise,
                "summary_metrics": self.summary_dict()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.detailed_dict(), f, indent=2)

    def __str__(self) -> str:  # mirrors the cell 3 print block
        s = self.summary_dict()
        lines = ["Retrieval Metrics:"]
        lines += [f"{k}: {v:.3f}" for k, v in s.items()]
        return "\n".join(lines)


def evaluate_rankings(
    rankings: Mapping[str, Sequence[str]],
    ground_truth: Mapping[str, Mapping[str, Sequence[str]]],
    positives_key: str = "patent_positives",
) -> RetrievalMetrics:
    """Compute the full metric battery from per-query ranked gallery names.

    Args:
        rankings: query image name -> gallery image names ranked best-first
            (full ranking, not truncated — overall MRR/AP/NDCG walk all of it).
        ground_truth: query name -> {"patent_positives": [...], "cpc_positives": [...]}
            exactly as produced by the ground-truth builder
            (reference split_query.ipynb cells 2/5/10).
        positives_key: which positive set to evaluate against.
    """
    rr, rr5, rr20 = [], [], []
    ap_scores, ndcg_scores = [], []
    r5, r10, r20 = [], [], []
    p5, p10, p20 = [], [], []
    skipped = 0

    for query_name, retrieved in rankings.items():
        if query_name not in ground_truth:
            skipped += 1
            continue
        positives = set(ground_truth[query_name][positives_key])
        retrieved = list(retrieved)

        rr.append(mrr_at_k(retrieved, positives, len(retrieved)))
        rr5.append(mrr_at_k(retrieved, positives, 5))
        rr20.append(mrr_at_k(retrieved, positives, 20))
        p5.append(precision_at_k(retrieved, positives, 5))
        p10.append(precision_at_k(retrieved, positives, 10))
        p20.append(precision_at_k(retrieved, positives, 20))
        ap_scores.append(average_precision_reference(retrieved, positives))
        ndcg_scores.append(ndcg_reference(retrieved, positives))
        r5.append(recall_at_k(retrieved, positives, 5))
        r10.append(recall_at_k(retrieved, positives, 10))
        r20.append(recall_at_k(retrieved, positives, 20))

    def m(xs):
        return float(np.mean(xs)) if xs else 0.0

    missing = sum(1 for q in ground_truth if q not in rankings)
    if missing:
        import logging

        logging.getLogger(__name__).warning(
            "%d ground-truth queries have no ranking (of %d) — metrics "
            "cover a smaller query set", missing, len(ground_truth))
    return RetrievalMetrics(
        num_missing_rankings=missing,
        mrr=m(rr), mrr_5=m(rr5), mrr_20=m(rr20),
        map=m(ap_scores), ndcg=m(ndcg_scores),
        recall_5=m(r5), recall_10=m(r10), recall_20=m(r20),
        precision_5=m(p5), precision_10=m(p10), precision_20=m(p20),
        num_queries=len(rr), num_skipped=skipped,
        query_wise={
            "reciprocal_ranks": rr,
            "reciprocal_ranks@5": rr5,
            "reciprocal_ranks@20": rr20,
            "ap_scores": ap_scores,
            "ndcg_scores": ndcg_scores,
            "recall_5": r5,
            "recall_10": r10,
            "recall_20": r20,
            "precision_5": p5,
            "precision_10": p10,
            "precision_20": p20,
        },
    )
