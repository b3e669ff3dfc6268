"""Hyperbolic training-data preparation: Y_pos / Y_neg / implication /
figure-pairs with the reference's exact index conventions (the port's copy
of ``TrainingData`` and ``prepare_training_data`` in
patent_tpu/data/prep.py, with ``figure_pair_maps``, the train_hyp
batcher's per-figure lookups).

Framework-module re-implementation of ``prepare_training_data`` (graph
generation (1).ipynb cell 69, with the hierarchical-exclusivity negative
sampling of cell 73).  Edge extraction is vectorized over the sparse
adjacency; the two rejection-sampling loops are host loops (one draw per
attempt — kept scalar so their RNG stream, and thus saved datasets, stay
stable across versions):

Index conventions (the behavioral contract the eval numbers depend on):
* ``Y_pos[i] = (figure_absolute_idx, patent_RELATIVE_idx)`` — patent indices
  are relative to the label table (offset by ``idx_patents_start``).
* ``implication[i] = (child_rel, parent_rel)`` — BOTH relative to
  ``idx_patents_start``, across all three CPC levels (cell 69's
  ``- idx_patents_start`` on every level).
* Negative sampling rejects candidate patents sharing a Big or Main CPC with
  any of the figure's positive patents (cell 69 "hierarchical exclusivity").
* Positive figure pairs = all same-patent pairs; negative pairs = sampled
  cross-patent pairs (no shared patent), deduplicated.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict

import numpy as np
import scipy.sparse as sp

from .graph_build import HeteroGraph


@dataclasses.dataclass
class TrainingData:
    """The prepared arrays, mirroring training_data.npz keys (cell 69)."""

    x_figures: np.ndarray            # [F, D] figure features
    y_pos: np.ndarray                # [P, 2] (figure_abs, patent_rel)
    y_neg: np.ndarray                # [N, 2] (figure_abs, patent_rel)
    implication: np.ndarray          # [I, 2] (child_rel, parent_rel)
    exclusion: np.ndarray            # [E, 2]
    positive_figure_pairs: np.ndarray  # [Pp, 2] (figure_abs, figure_abs)
    negative_figure_pairs: np.ndarray  # [Pn, 2]
    label_offsets: dict[str, int]
    num_labels: int = 0  # patents + all CPC levels (LABEL_NUM in the reference)

    @property
    def label_num(self) -> int:
        return self.num_labels

    def save(self, output_dir: str,
             npz_name: str = "training_data.npz",
             offsets_name: str = "label_offsets.json") -> None:
        os.makedirs(output_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(output_dir, npz_name),
            X_figures=self.x_figures, Y_pos=self.y_pos, Y_neg=self.y_neg,
            implication=self.implication, exclusion=self.exclusion,
            positive_figure_pairs=self.positive_figure_pairs,
            negative_figure_pairs=self.negative_figure_pairs)
        with open(os.path.join(output_dir, offsets_name), "w") as f:
            json.dump({**self.label_offsets, "num_labels": self.num_labels},
                      f, indent=4)

    @classmethod
    def load(cls, output_dir: str,
             npz_name: str = "training_data.npz",
             offsets_name: str = "label_offsets.json") -> "TrainingData":
        z = np.load(os.path.join(output_dir, npz_name))
        with open(os.path.join(output_dir, offsets_name)) as f:
            offsets = json.load(f)
        num_labels = offsets.pop("num_labels", 0)
        return cls(x_figures=z["X_figures"], y_pos=z["Y_pos"], y_neg=z["Y_neg"],
                   implication=z["implication"], exclusion=z["exclusion"],
                   positive_figure_pairs=z["positive_figure_pairs"],
                   negative_figure_pairs=z["negative_figure_pairs"],
                   label_offsets=offsets, num_labels=num_labels)


def _block_edges(coo: sp.coo_matrix, r0: int, r1: int, c0: int, c1: int
                 ) -> np.ndarray:
    """[K, 2] (row, col) edges with r0≤row<r1, c0≤col<c1 — vectorized."""
    m = (coo.row >= r0) & (coo.row < r1) & (coo.col >= c0) & (coo.col < c1)
    return np.stack([coo.row[m], coo.col[m]], axis=1)


def prepare_training_data(graph: HeteroGraph, features: np.ndarray,
                          neg_ratio: int = 20, fig_pair_ratio: int = 15,
                          max_negative_figure_pairs: int | None = None,
                          seed: int = 42) -> TrainingData:
    """Build the training arrays from the built graph (cells 69/73 semantics,
    counts derived from ``graph``; deterministic under ``seed``)."""
    rng = np.random.default_rng(seed)
    counts = graph.counts
    nf = counts["figures"]
    npat = counts["patents"]
    off = graph.offsets
    p0, m0, b0, mn0 = (off["patents"], off["medium_cpcs"], off["big_cpcs"],
                       off["main_cpcs"])
    end = graph.num_nodes
    coo = graph.adjacency.tocoo()

    # --- positive figure-patent pairs (relative patent idx) ---------------
    fp = _block_edges(coo, 0, nf, p0, p0 + npat)
    y_pos = np.stack([fp[:, 0], fp[:, 1] - p0], axis=1).astype(np.int32)

    # --- hierarchical implications (all relative to p0) -------------------
    pm = _block_edges(coo, p0, m0, m0, b0)
    mb = _block_edges(coo, m0, b0, b0, mn0)
    bmn = _block_edges(coo, b0, mn0, mn0, end)
    implication = np.concatenate([pm, mb, bmn], axis=0) - p0
    implication = implication.astype(np.int32)

    # hierarchy maps for exclusivity-aware negatives (relative indices).
    # patent → mediums is a MULTIMAP: a patent whose figures carry
    # different CPCs has several patent→medium edges, and dict(zip(...))
    # kept only the last one — a candidate negative sharing a Big/Main
    # CPC through any DROPPED chain then slipped past the exclusivity
    # filter (found in review).  medium→big and big→main stay functional
    # (big/main are string prefixes of medium).
    patent_to_mediums: dict[int, list[int]] = defaultdict(list)
    for child, parent in pm - p0:
        patent_to_mediums[int(child)].append(int(parent))
    medium_to_big = dict(zip(mb[:, 0] - p0, mb[:, 1] - p0))
    big_to_main = dict(zip(bmn[:, 0] - p0, bmn[:, 1] - p0))

    def _chains(p_rel: int) -> tuple[set, set]:
        """All (big, main) CPC ancestors of one patent, across every
        medium it carries."""
        bigs, mains = set(), set()
        for medium in patent_to_mediums.get(p_rel, ()):
            big = medium_to_big.get(medium)
            if big is not None:
                bigs.add(big)
                main = big_to_main.get(big)
                if main is not None:
                    mains.add(main)
        return bigs, mains

    # --- figure pairs ------------------------------------------------------
    patent_to_figures: dict[int, list[int]] = defaultdict(list)
    figure_to_patents: dict[int, set[int]] = defaultdict(set)
    for f_idx, pat_rel in y_pos:
        patent_to_figures[int(pat_rel)].append(int(f_idx))
        figure_to_patents[int(f_idx)].add(int(pat_rel))

    positive_figure_pairs = []
    for figs in patent_to_figures.values():
        for i in range(len(figs)):
            for j in range(i + 1, len(figs)):
                positive_figure_pairs.append((figs[i], figs[j]))
    pos_fig = (np.asarray(positive_figure_pairs, np.int32)
               if positive_figure_pairs else np.empty((0, 2), np.int32))

    target_neg_pairs = len(positive_figure_pairs) * fig_pair_ratio
    if max_negative_figure_pairs is not None:
        target_neg_pairs = min(target_neg_pairs, max_negative_figure_pairs)
    neg_pairs: set[tuple[int, int]] = set()
    attempts = 0
    max_attempts = target_neg_pairs * 10
    while len(neg_pairs) < target_neg_pairs and attempts < max_attempts:
        a, b = int(rng.integers(0, nf)), int(rng.integers(0, nf))
        attempts += 1
        if a == b:
            continue
        if figure_to_patents[a] & figure_to_patents[b]:
            continue
        neg_pairs.add((min(a, b), max(a, b)))
    neg_fig = (np.asarray(sorted(neg_pairs), np.int32)
               if neg_pairs else np.empty((0, 2), np.int32))

    # --- exclusivity-aware figure-patent negatives ------------------------
    y_neg = []
    for fig_idx, pos_rel_set in figure_to_patents.items():
        pos_big, pos_main = set(), set()
        for p_rel in pos_rel_set:
            bigs, mains = _chains(p_rel)
            pos_big |= bigs
            pos_main |= mains
        target = len(pos_rel_set) * neg_ratio
        got, attempts = 0, 0
        max_att = target * 20
        while got < target and attempts < max_att:
            cand = int(rng.integers(0, npat))
            attempts += 1
            if cand in pos_rel_set:
                continue
            cand_bigs, cand_mains = _chains(cand)
            if cand_bigs & pos_big or cand_mains & pos_main:
                continue
            y_neg.append((fig_idx, cand))
            got += 1
    y_neg_arr = (np.asarray(y_neg, np.int32)
                 if y_neg else np.empty((0, 2), np.int32))

    offsets = {"patents": p0, "medium_cpcs": m0, "big_cpcs": b0,
               "main_cpcs": mn0}
    num_labels = graph.num_nodes - nf  # patents + all CPC levels
    return TrainingData(
        x_figures=np.asarray(features[:nf], np.float32),
        y_pos=y_pos, y_neg=y_neg_arr, implication=implication,
        exclusion=np.empty((0, 2), np.int32),
        positive_figure_pairs=pos_fig, negative_figure_pairs=neg_fig,
        label_offsets=offsets, num_labels=num_labels)


def figure_pair_maps(td: TrainingData) -> tuple[dict, dict, dict, dict]:
    """The train_hyp batcher's per-figure lookups: figure → positive patent
    (the first), figure → negative patents, figure → positive figures,
    figure → negative figures (pairs counted both ways)."""
    fig_to_pos_patent: dict[int, int] = {}
    for f, p in td.y_pos:
        fig_to_pos_patent.setdefault(int(f), int(p))
    fig_to_neg_patents: dict[int, list[int]] = defaultdict(list)
    for f, p in td.y_neg:
        fig_to_neg_patents[int(f)].append(int(p))
    fig_to_pos_figures: dict[int, list[int]] = defaultdict(list)
    for a, b in td.positive_figure_pairs:
        fig_to_pos_figures[int(a)].append(int(b))
        fig_to_pos_figures[int(b)].append(int(a))
    fig_to_neg_figures: dict[int, list[int]] = defaultdict(list)
    for a, b in td.negative_figure_pairs:
        fig_to_neg_figures[int(a)].append(int(b))
        fig_to_neg_figures[int(b)].append(int(a))
    return (fig_to_pos_patent, dict(fig_to_neg_patents),
            dict(fig_to_pos_figures), dict(fig_to_neg_figures))
