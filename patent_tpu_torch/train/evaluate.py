"""Label-retrieval evaluation and distance analysis of a hyperbolic model
(port of patent_tpu/train/evaluate.py).

``evaluate_retrieval_map`` encodes the evaluation figures in batches on
the model's device, computes the Poincaré distance of each batch to every
patent label with ``pairwise_dist_pallas`` (row 17: the CUDA kernel on
the card), and takes the average precision of each figure's ranking of
the labels on the host in numpy.  ``distance_analysis`` compares each
sampled figure's distance to its true label with a random label of the
same hierarchy level, with the JAX package's sampling stream, so both
packages sample the same figures and labels for a seed.
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from ..metrics.classification import _binary_average_precision
from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..ops import poincare
from ..ops.pallas_kernels import pairwise_dist_pallas


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def label_distance_batches(model: HyperbolicEmbeddingModel,
                           x_figures: np.ndarray, eval_indices: Sequence[int],
                           num_patents: int, batch_size: int = 256
                           ) -> Iterator[tuple[list[int], np.ndarray]]:
    """(figure indices, their distances [b, num_patents] on the host) for
    each batch of ``eval_indices``: the device part of
    ``evaluate_retrieval_map``."""
    model.eval()
    dev = _device(model)
    patents = model.label_emb[:num_patents].contiguous()
    xs = np.asarray(x_figures)
    for start in range(0, len(eval_indices), batch_size):
        chunk = list(eval_indices[start:start + batch_size])
        enc = model(torch.as_tensor(xs[chunk], dtype=torch.float32,
                                    device=dev))
        yield chunk, pairwise_dist_pallas(enc, patents, model.c).cpu().numpy()


def evaluate_retrieval_map(model: HyperbolicEmbeddingModel,
                           x_figures: np.ndarray,
                           eval_indices: Sequence[int],
                           figure_to_pos_patents: Mapping[int, Sequence[int] | int],
                           num_patents: int,
                           batch_size: int = 256) -> float:
    """Mean AP of ranking patent labels by −distance for each eval figure.

    ``figure_to_pos_patents`` maps figure idx → relative patent idx (or
    list); patents occupy label-table rows [0, num_patents).  Figures
    without a positive, or with a non-finite distance, are skipped."""
    eval_indices = [int(i) for i in eval_indices]
    if not eval_indices:
        return 0.0
    ap_scores = []
    for chunk, dists in label_distance_batches(model, x_figures, eval_indices,
                                               num_patents, batch_size):
        for row, fig_idx in enumerate(chunk):
            pos = figure_to_pos_patents.get(fig_idx, [])
            if isinstance(pos, (int, np.integer)):
                pos = [pos] if pos != -1 else []
            pos = [p for p in pos if 0 <= p < num_patents]
            if not pos:
                continue
            d = dists[row]
            if not np.all(np.isfinite(d)):
                continue
            target = np.zeros(num_patents, np.float32)
            target[np.asarray(pos, np.int64)] = 1.0
            ap = _binary_average_precision(target, -d)
            if not np.isnan(ap):
                ap_scores.append(ap)
    return float(np.mean(ap_scores)) if ap_scores else 0.0


@torch.no_grad()
def distance_analysis(model: HyperbolicEmbeddingModel, x_figures: np.ndarray,
                      y_pos: np.ndarray, label_offsets: Mapping[str, int],
                      implication: np.ndarray, num_samples: int = 512,
                      seed: int = 0) -> dict:
    """For sampled figures, the Poincaré distance to the TRUE
    patent / medium / big / main label against a RANDOM label of the same
    level: per level the mean true and random distances, their ratio, the
    count, and the raw samples (``_true``, ``_random``)."""
    model.eval()
    rng = np.random.default_rng(seed)
    c = model.c
    dev = _device(model)
    label_emb = model.label_emb
    p0 = label_offsets["patents"]
    level_bounds = {
        "patent": (0, label_offsets["medium_cpcs"] - p0),
        "medium": (label_offsets["medium_cpcs"] - p0,
                   label_offsets["big_cpcs"] - p0),
        "big": (label_offsets["big_cpcs"] - p0,
                label_offsets["main_cpcs"] - p0),
        "main": (label_offsets["main_cpcs"] - p0, label_emb.shape[0]),
    }
    # figure → true label chain via y_pos + implication parent maps
    parent = dict(map(tuple, implication.tolist()))
    fig_to_patent: dict[int, int] = {}
    for f, p in y_pos.tolist():
        fig_to_patent.setdefault(f, p)
    figs = rng.choice(np.asarray(sorted(fig_to_patent)), size=min(
        num_samples, len(fig_to_patent)), replace=False)
    enc = model(torch.as_tensor(np.asarray(x_figures)[figs],
                                dtype=torch.float32, device=dev))
    out: dict[str, dict] = {}
    for level, (lo, hi) in level_bounds.items():
        true_idx, enc_rows = [], []
        for row, f in enumerate(figs):
            node = fig_to_patent[int(f)]
            # walk up the hierarchy to the requested level
            while not (lo <= node < hi):
                if node not in parent:
                    node = None
                    break
                node = parent[node]
            if node is not None:
                true_idx.append(node)
                enc_rows.append(row)
        if not true_idx:
            continue
        e = enc[torch.as_tensor(enc_rows, device=dev)]
        t = label_emb[torch.as_tensor(true_idx, device=dev)]
        r = label_emb[torch.as_tensor(rng.integers(lo, hi, len(true_idx)),
                                      device=dev)]
        d_true = poincare.dist(e, t, c).cpu().numpy()
        d_rand = poincare.dist(e, r, c).cpu().numpy()
        out[level] = {
            "true_mean": float(d_true.mean()),
            "random_mean": float(d_rand.mean()),
            "ratio": float(d_true.mean() / max(d_rand.mean(), 1e-9)),
            "n": len(true_idx),
            "_true": d_true,       # raw samples for CSV/plots (stripped on dump)
            "_random": d_rand,
        }
    return out


def save_distance_analysis(analysis: dict, out_dir: str) -> list[str]:
    """Write the distance analysis as a CSV and, where matplotlib is
    installed, a box plot; returns the paths written.  Without matplotlib
    it says on stderr that the plot was not written."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "distance_analysis.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["level", "kind", "distance"])
        for level, d in analysis.items():
            for v in np.asarray(d.get("_true", [])):
                w.writerow([level, "true", float(v)])
            for v in np.asarray(d.get("_random", [])):
                w.writerow([level, "random", float(v)])
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: distance_boxplot.png was not "
              "written", file=sys.stderr)
        return [csv_path]
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5))
    labels, series = [], []
    for level, d in analysis.items():
        if "_true" in d:
            labels += [f"{level}\ntrue", f"{level}\nrandom"]
            series += [np.asarray(d["_true"]), np.asarray(d["_random"])]
    if series:
        ax.boxplot(series, tick_labels=labels)
        ax.set_ylabel("Poincaré distance")
        ax.set_title("true vs random label distances by hierarchy level")
    plot_path = os.path.join(out_dir, "distance_boxplot.png")
    fig.savefig(plot_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [csv_path, plot_path]


def strip_raw_samples(analysis: dict) -> dict:
    """Drop the raw sample arrays (for JSON printing)."""
    return {lvl: {k: v for k, v in d.items() if not k.startswith("_")}
            for lvl, d in analysis.items()}
