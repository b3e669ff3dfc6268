"""Average precision of one binary ranking, on the host in numpy (the
port's copy of ``_binary_average_precision`` in
patent_tpu/metrics/classification.py), for the label-retrieval mAP."""

from __future__ import annotations

import numpy as np


def _binary_average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    """sklearn-compatible ``average_precision_score`` for one binary class.

    AP = Σ_n (R_n − R_{n−1}) · P_n over the ranked scores (step interpolation).
    """
    order = np.argsort(-scores, kind="stable")
    t = targets[order]
    n_pos = t.sum()
    if n_pos == 0:
        return 0.0
    tp = np.cumsum(t)
    fp = np.cumsum(1 - t)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / n_pos
    # step changes in recall happen exactly at positives
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_recall) * precision))
