"""Visualization and analysis: the CLI ``plot`` action (port of
patent_tpu/train/plots.py).

matplotlib and scikit-learn are imported inside the functions that draw:
where either is missing, ``run_plot_action`` says on stderr that no figure
was written and returns no paths.

Re-design of the reference's plotting layer (src/train.py:3642-3726
plot_embeddings_tsne/_enhanced, 4726-4763 dist0 histograms; src/plot.py):
t-SNE / PCA projections of the label table styled by hierarchy level, and
hyperbolic-radius (dist0) histograms per label type.  Written headless
(Agg backend) to PNG files.
"""

from __future__ import annotations

import os

import sys

import numpy as np
import torch

from ..ops import poincare


def _level_slices(label_offsets: dict[str, int], num_labels: int
                  ) -> dict[str, tuple[int, int]]:
    """Relative [start, end) ranges of each label level in the table."""
    p0 = label_offsets["patents"]
    edges = [("patents", label_offsets["patents"]),
             ("medium_cpcs", label_offsets["medium_cpcs"]),
             ("big_cpcs", label_offsets["big_cpcs"]),
             ("main_cpcs", label_offsets["main_cpcs"])]
    out = {}
    for (name, start), (_n2, end) in zip(edges, edges[1:] + [("end", p0 + num_labels)]):
        out[name] = (start - p0, end - p0)
    return out


def _dist0(points, c: float) -> np.ndarray:
    """Hyperbolic radius of each row, on the host in f32."""
    return poincare.dist0(torch.as_tensor(np.asarray(points, np.float32)),
                          c).numpy()


def plot_label_embeddings(label_emb: np.ndarray, label_offsets: dict[str, int],
                          out_dir: str, method: str = "auto",
                          figure_emb: np.ndarray | None = None,
                          seed: int = 0) -> list[str]:
    """2-D projection of the label table colored by hierarchy level
    (reference plot_embeddings_tsne_enhanced, train.py:3642-3726).

    ``method``: 'tsne', 'pca', or 'auto' (tsne below 5k points, else pca).
    Returns written file paths.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    label_emb = np.asarray(label_emb)
    n = label_emb.shape[0]
    slices = _level_slices(label_offsets, n)

    stacked = label_emb if figure_emb is None else np.concatenate(
        [label_emb, np.asarray(figure_emb)], axis=0)
    if method == "auto":
        method = "tsne" if len(stacked) <= 5000 else "pca"
    if method == "tsne":
        from sklearn.manifold import TSNE

        proj = TSNE(n_components=2, random_state=seed,
                    perplexity=min(30, max(2, len(stacked) // 4))
                    ).fit_transform(stacked)
    else:
        from sklearn.decomposition import PCA

        proj = PCA(n_components=2, random_state=seed).fit_transform(stacked)

    fig, ax = plt.subplots(figsize=(9, 8))
    styles = {"patents": dict(s=4, alpha=0.3, marker="."),
              "medium_cpcs": dict(s=24, alpha=0.8, marker="^"),
              "big_cpcs": dict(s=48, alpha=0.9, marker="s"),
              "main_cpcs": dict(s=90, alpha=1.0, marker="*")}
    for name, (lo, hi) in slices.items():
        if hi > lo:
            ax.scatter(proj[lo:hi, 0], proj[lo:hi, 1], label=name,
                       **styles.get(name, {}))
    if figure_emb is not None:
        ax.scatter(proj[n:, 0], proj[n:, 1], s=2, alpha=0.2, marker=".",
                   label="figures")
    ax.legend()
    ax.set_title(f"label embeddings ({method})")
    path = os.path.join(out_dir, f"label_embeddings_{method}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [path]


def plot_dist0_histograms(label_emb: np.ndarray, label_offsets: dict[str, int],
                          out_dir: str, c: float = 1.0,
                          figure_emb: np.ndarray | None = None) -> list[str]:
    """Hyperbolic radius (dist0) histograms per label level
    (reference train.py:4726-4763)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    n = np.asarray(label_emb).shape[0]
    slices = _level_slices(label_offsets, n)
    d0 = _dist0(label_emb, c)

    fig, ax = plt.subplots(figsize=(9, 5))
    for name, (lo, hi) in slices.items():
        if hi > lo:
            ax.hist(d0[lo:hi], bins=40, alpha=0.5, label=name, density=True)
    if figure_emb is not None:
        fd0 = _dist0(figure_emb, c)
        ax.hist(fd0, bins=40, alpha=0.4, label="figures", density=True)
    ax.set_xlabel("dist0 (hyperbolic radius)")
    ax.legend()
    ax.set_title("hyperbolic radius by label level")
    path = os.path.join(out_dir, "dist0_histograms.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [path]


def plot_graph_embeddings(z: np.ndarray, figure_count: int, out_dir: str,
                          highlight_patent_rows: dict[str, list[int]] | None = None,
                          method: str = "pca", seed: int = 0) -> str:
    """2-D projection of GCN/VGAE node embeddings with figures vs labels
    distinguished and optional highlighted patents (reference
    src/plot.py:10-78 visualize_patent_embeddings, with its broken imports
    fixed by taking embeddings directly)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    z = np.asarray(z)
    if method == "tsne" and len(z) <= 5000:
        from sklearn.manifold import TSNE

        proj = TSNE(n_components=2, random_state=seed,
                    perplexity=min(30, max(2, len(z) // 4))).fit_transform(z)
    else:
        from sklearn.decomposition import PCA

        proj = PCA(n_components=2, random_state=seed).fit_transform(z)
    fig, ax = plt.subplots(figsize=(9, 8))
    ax.scatter(proj[:figure_count, 0], proj[:figure_count, 1], s=4, alpha=0.3,
               marker=".", label="figures")
    ax.scatter(proj[figure_count:, 0], proj[figure_count:, 1], s=14, alpha=0.7,
               marker="^", label="label nodes")
    for name, rows in (highlight_patent_rows or {}).items():
        rows = [r for r in rows if r < len(proj)]
        ax.scatter(proj[rows, 0], proj[rows, 1], s=60, marker="*", label=name)
    ax.legend()
    ax.set_title(f"graph embeddings ({method})")
    path = os.path.join(out_dir, f"graph_embeddings_{method}.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def run_plot_action(path: str, checkpoint: str | None = None) -> list[str]:
    """CLI ``plot``: the label table of the trained hyperbolic checkpoint
    (``checkpoint``, else the first ``best_retrieval_model*`` under
    ``path``/models) as a 2-D projection and dist0 histograms under
    ``path``/plots.  Without matplotlib or scikit-learn nothing is drawn:
    a line on stderr says so and no paths are returned."""
    from ..data.prep import TrainingData
    from ..utils.checkpoint import CheckpointManager

    prep_dir = os.path.join(path, "prepared_training_data")
    if not os.path.exists(os.path.join(prep_dir, "training_data.npz")):
        raise FileNotFoundError(
            f"no prepared data under {prep_dir}; run `prep` first")
    td = TrainingData.load(prep_dir)
    ckpt = CheckpointManager(os.path.join(path, "models"))
    label_emb = None
    if checkpoint and ckpt.exists(checkpoint):
        label_emb = np.asarray(ckpt.restore(checkpoint)["params"]["label_emb"])
    else:
        for name in sorted(os.listdir(ckpt.directory)):
            if name.startswith("best_retrieval_model") and \
                    os.path.isdir(os.path.join(ckpt.directory, name)):
                label_emb = np.asarray(
                    ckpt.restore(name)["params"]["label_emb"])
                break
    if label_emb is None:
        raise FileNotFoundError("no trained checkpoint found; run train_hyp")
    try:
        import matplotlib  # noqa: F401
        import sklearn  # noqa: F401
    except ImportError as e:
        print(f"{e.name} is not installed: the label-embedding and dist0 "
              "plots were not written", file=sys.stderr)
        return []
    out_dir = os.path.join(path, "plots")
    files = plot_label_embeddings(label_emb, td.label_offsets, out_dir)
    files += plot_dist0_histograms(label_emb, td.label_offsets, out_dir)
    print("\n".join(files))
    return files
