"""Embedding-quality diagnostics: preservation ratios and Hit@k (port of
patent_tpu/metrics/embedding_quality.py; reference src/auxiliary.py:
274-383): the cosine of child-parent and same-CPC neighbour pairs against
random pairs, and hierarchical Hit@k from one pairwise top-k per chunk of
children.  Torch in f32 on ``device``: the card unless the caller asks for
the CPU (``select_device``: an error where there is no card)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _cosine_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / torch.clamp_min(torch.linalg.norm(a, dim=1, keepdim=True), 1e-12)
    bn = b / torch.clamp_min(torch.linalg.norm(b, dim=1, keepdim=True), 1e-12)
    return (an * bn).sum(dim=1)


def _mean_cosine(z: torch.Tensor, pairs: np.ndarray) -> float:
    idx = torch.as_tensor(np.asarray(pairs, np.int64), device=z.device)
    return float(_cosine_rows(z[idx[:, 0]], z[idx[:, 1]]).mean())


def _on(device: str, z: np.ndarray) -> torch.Tensor:
    from ..retrieval.cli_actions import select_device

    return torch.as_tensor(np.asarray(z, np.float32),
                           device=select_device(device))


def preservation_ratios(z: np.ndarray, parent_pairs: np.ndarray | None,
                        neighbor_pairs: np.ndarray | None,
                        num_random: int = 1000, seed: int = 0,
                        device: str = "cuda") -> dict:
    """Mean child-parent / same-CPC cosine against the random-pair cosine."""
    rng = np.random.default_rng(seed)
    zt = _on(device, z)
    n = z.shape[0]
    rnd = rng.integers(0, n, (min(num_random, max(n, 2)), 2))
    random_sim = _mean_cosine(zt, rnd)
    out = {"random_pair_cosine": random_sim}
    if parent_pairs is not None and len(parent_pairs):
        hier = _mean_cosine(zt, parent_pairs)
        out["child_parent_cosine"] = hier
        out["hierarchical_preservation_ratio"] = hier / random_sim \
            if random_sim else float("nan")
    if neighbor_pairs is not None and len(neighbor_pairs):
        neigh = _mean_cosine(zt, neighbor_pairs)
        out["same_cpc_cosine"] = neigh
        out["neighborhood_preservation_ratio"] = neigh / random_sim \
            if random_sim else float("nan")
    return out


def hierarchical_hits_at_k(z: np.ndarray, parent_pairs: np.ndarray,
                           k_values: Sequence[int] = (1, 5, 10, 20),
                           batch_size: int = 1024,
                           device: str = "cuda") -> dict[int, float]:
    """Hit@k: the share of (child, parent) pairs whose parent is among the
    child's k nearest Euclidean neighbours (itself excluded)."""
    parent_pairs = np.asarray(parent_pairs)
    if len(parent_pairs) == 0:
        return {k: 0.0 for k in k_values}
    zt = _on(device, z)
    sq = (zt * zt).sum(dim=1)
    kmax = min(max(k_values) + 1, zt.shape[0])
    hits = {k: 0 for k in k_values}
    for s in range(0, len(parent_pairs), batch_size):
        chunk = parent_pairs[s:s + batch_size]
        children = torch.as_tensor(chunk[:, 0].astype(np.int64),
                                   device=zt.device)
        q = zt[children]
        d = sq[children, None] - 2.0 * (q @ zt.T) + sq[None, :]
        d[torch.arange(len(chunk), device=zt.device), children] = torch.inf
        idx = torch.topk(-d, kmax, dim=1).indices.cpu().numpy()
        for row, (_child, parent) in enumerate(chunk):
            for k in k_values:
                if parent in idx[row, :k]:
                    hits[k] += 1
    total = len(parent_pairs)
    return {k: hits[k] / total for k in k_values}


def evaluate_embeddings(z: np.ndarray, parent_pairs: np.ndarray | None,
                        neighbor_pairs: np.ndarray | None,
                        k_values: Sequence[int] = (1, 5, 10, 20),
                        seed: int = 0, device: str = "cuda") -> dict:
    """The auxiliary.py:274-383 report as a dict."""
    report = preservation_ratios(z, parent_pairs, neighbor_pairs, seed=seed,
                                 device=device)
    if parent_pairs is not None and len(parent_pairs):
        report["hierarchical_hit_at_k"] = hierarchical_hits_at_k(
            z, parent_pairs, k_values, device=device)
    return report
