"""Classification metrics on the host in numpy (the port's copy of
patent_tpu/metrics/classification.py): the average precision of one binary
ranking (the label-retrieval mAP), the multi-label mean average precision
(reference src/auxiliary.py:200-224), and the confusion matrix with
per-class precision, recall and F1 of the 5-level pair classifier
(reference src/train.py:332-375)."""

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


def mean_average_precision(predictions: np.ndarray, targets: np.ndarray) -> float:
    """Mean over classes (with ≥1 positive) of binary AP (auxiliary.py:200-224)."""
    predictions = np.asarray(predictions)
    targets = np.asarray(targets)
    aps = []
    for i in range(targets.shape[1]):
        if targets[:, i].sum() > 0:
            aps.append(_binary_average_precision(targets[:, i], predictions[:, i]))
    return float(np.mean(aps)) if aps else 0.0


def confusion_counts(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> np.ndarray:
    """[num_classes, num_classes] confusion matrix, rows = true class."""
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true), np.asarray(y_pred)), 1)
    return cm


def per_class_prf(cm: np.ndarray) -> dict:
    """Per-class precision/recall/F1 from a confusion matrix (train.py:332-375)."""
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    predicted = cm.sum(axis=0).astype(np.float64)
    precision = np.divide(tp, predicted, out=np.zeros_like(tp), where=predicted > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support.astype(np.int64),
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
    }
