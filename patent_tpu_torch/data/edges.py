"""Edge splitting and non-edge sampling for link prediction (the port's
copy of patent_tpu/data/edges.py, numpy and scipy: the same split for a
seed).

Re-implementation of ``remove_edges_and_sample_optimized`` (reference
src/process_graph.py:17-98): split the upper-triangular edges of a
symmetric adjacency into train/val/test, batch-sample an equal number of
non-edges per split, and return the training adjacency with val/test
edges removed (symmetrically).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class EdgeSplit:
    train_adjacency: sp.csr_matrix     # val/test edges removed (symmetric)
    train_edges: np.ndarray            # [Et, 2]
    val_edges: np.ndarray              # [Ev, 2]
    test_edges: np.ndarray             # [Es, 2]
    val_non_edges: np.ndarray          # [Ev, 2]
    test_non_edges: np.ndarray         # [Es, 2]


def split_edges(adjacency: sp.spmatrix, val_ratio: float = 0.05,
                test_ratio: float = 0.1, seed: int = 42,
                exclude_self_loops: bool = True) -> EdgeSplit:
    """Deterministic edge split + vectorized non-edge rejection sampling."""
    rng = np.random.default_rng(seed)
    coo = sp.triu(adjacency, k=1 if exclude_self_loops else 0).tocoo()
    edges = np.stack([coo.row, coo.col], axis=1)
    n_edges = len(edges)
    n = adjacency.shape[0]
    perm = rng.permutation(n_edges)
    n_val = int(n_edges * val_ratio)
    n_test = int(n_edges * test_ratio)
    val_e = edges[perm[:n_val]]
    test_e = edges[perm[n_val:n_val + n_test]]
    train_e = edges[perm[n_val + n_test:]]

    # training adjacency: remove val/test edges symmetrically
    removed = np.concatenate([val_e, test_e], axis=0)
    adj = adjacency.tolil(copy=True)
    if len(removed):
        adj[removed[:, 0], removed[:, 1]] = 0
        adj[removed[:, 1], removed[:, 0]] = 0
    train_adj = adj.tocsr()
    train_adj.eliminate_zeros()

    # batched non-edge sampling (the reference samples in chunks and filters
    # against the edge set — same approach, vectorized)
    edge_keys = set(map(tuple, edges.tolist()))

    def sample_non_edges(count: int) -> np.ndarray:
        out: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        while len(out) < count:
            cand = rng.integers(0, n, (max(count * 2, 64), 2))
            for a, b in cand:
                if len(out) >= count:
                    break
                a, b = (int(min(a, b)), int(max(a, b)))
                if a == b or (a, b) in edge_keys or (a, b) in seen:
                    continue
                seen.add((a, b))
                out.append((a, b))
        return np.asarray(out, edges.dtype).reshape(-1, 2)

    return EdgeSplit(train_adjacency=train_adj, train_edges=train_e,
                     val_edges=val_e, test_edges=test_e,
                     val_non_edges=sample_non_edges(n_val),
                     test_non_edges=sample_non_edges(n_test))


def link_prediction_scores(a_reconstructed: np.ndarray, edges: np.ndarray,
                           non_edges: np.ndarray) -> dict:
    """ROC-AUC + AP of reconstructed edge probabilities vs held-out edges."""
    pos = a_reconstructed[edges[:, 0], edges[:, 1]]
    neg = a_reconstructed[non_edges[:, 0], non_edges[:, 1]]
    return _pos_neg_metrics(pos, neg)


def link_prediction_scores_from_z(z: np.ndarray, edges: np.ndarray,
                                  non_edges: np.ndarray) -> dict:
    """Same metrics computed from latents directly — scores only the E
    held-out pairs (sigmoid(z_i·z_j)), never the [N, N] reconstruction, so
    evaluation scales with the big-graph sampled-edge VGAE trainer."""
    z = np.asarray(z, np.float32)

    def pair_scores(p):
        return 1.0 / (1.0 + np.exp(-np.sum(z[p[:, 0]] * z[p[:, 1]], axis=1)))

    return _pos_neg_metrics(pair_scores(edges), pair_scores(non_edges))


def _pos_neg_metrics(pos: np.ndarray, neg: np.ndarray) -> dict:
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    order = np.argsort(-scores, kind="stable")
    l = labels[order]
    tp = np.cumsum(l)
    fp = np.cumsum(1 - l)
    tpr = tp / max(l.sum(), 1)
    fpr = fp / max((1 - l).sum(), 1)
    auc = float(np.trapezoid(tpr, fpr))
    precision = tp / np.maximum(tp + fp, 1)
    prev_recall = np.concatenate([[0.0], tpr[:-1]])
    ap = float(np.sum((tpr - prev_recall) * precision))
    return {"roc_auc": auc, "average_precision": ap,
            "pos_mean": float(pos.mean()) if len(pos) else 0.0,
            "neg_mean": float(neg.mean()) if len(neg) else 0.0}
