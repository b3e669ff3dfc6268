"""HMI input generation: hierarchy-expanded positives, negatives, exclusions
(the port's copy of patent_tpu/data/hmi_inputs.py, numpy only: the same
arrays for a seed).

Re-implementation of ``generate_hyperbolic_inputs``
(graph generation (1).ipynb cells 86-88) feeding the HMI model:

* ``Y_pos`` — (figure_idx, ABSOLUTE label idx) pairs expanded through the
  FULL hierarchy: patent, its medium CPC, big CPC, and main CPC (the cell-87
  convention; note these are absolute node indices offset by num_figures,
  unlike training_data.npz's patent-relative convention — prep.py).
* ``Y_neg`` — per figure, a fixed number of sampled non-positive labels.
* ``implication`` — absolute-index (child, parent) pairs across all levels.
* ``exclusion`` — sampled mutually-exclusive pairs: patents (≤10 partners
  each) and medium CPCs with disjoint patent-parent sets (≤5 partners each).
"""

from __future__ import annotations

import dataclasses
import pickle
from collections import defaultdict

import numpy as np

from .graph_build import HeteroGraph
from .prep import _block_edges


@dataclasses.dataclass
class HMIInputs:
    y_pos: np.ndarray        # [P, 2] (figure_idx, absolute label idx)
    y_neg: np.ndarray        # [N, 2]
    implication: np.ndarray  # [I, 2] absolute (child, parent)
    exclusion: np.ndarray    # [E, 2] absolute

    def save(self, path: str) -> None:
        """Pickle in the reference's hyperbolic_inputs.pkl schema
        (loaded by src/auxiliary.py:254-273 load_hyperbolic_inputs)."""
        with open(path, "wb") as f:
            pickle.dump({"Y_pos": self.y_pos.tolist(),
                         "Y_neg": self.y_neg.tolist(),
                         "implication": self.implication.tolist(),
                         "exclusion": self.exclusion.tolist()}, f)

    @classmethod
    def load(cls, path: str) -> "HMIInputs":
        with open(path, "rb") as f:
            d = pickle.load(f)
        to = lambda k: (np.asarray(d[k], np.int64).reshape(-1, 2)
                        if len(d[k]) else np.empty((0, 2), np.int64))
        return cls(y_pos=to("Y_pos"), y_neg=to("Y_neg"),
                   implication=to("implication"), exclusion=to("exclusion"))


def generate_hmi_inputs(graph: HeteroGraph,
                        neg_samples_per_figure: int = 5,
                        max_exclusions_per_patent: int = 10,
                        max_exclusions_per_medium: int = 5,
                        seed: int = 42) -> HMIInputs:
    """Build the four arrays from the built graph (counts data-derived)."""
    rng = np.random.default_rng(seed)
    counts = graph.counts
    nf = counts["figures"]
    off = graph.offsets
    p0, m0, b0, mn0 = (off["patents"], off["medium_cpcs"], off["big_cpcs"],
                       off["main_cpcs"])
    end = graph.num_nodes
    num_labels = end  # label space includes every node type (cell 87)
    coo = graph.adjacency.tocoo()

    fp = _block_edges(coo, 0, nf, p0, m0)      # figure → patent (absolute)
    pm = _block_edges(coo, p0, m0, m0, b0)     # patent → medium
    mb = _block_edges(coo, m0, b0, b0, mn0)    # medium → big
    bmn = _block_edges(coo, b0, mn0, mn0, end)  # big → main

    pm_map = defaultdict(list)
    for a, b in pm:
        pm_map[int(a)].append(int(b))
    mb_map = defaultdict(list)
    for a, b in mb:
        mb_map[int(a)].append(int(b))
    bm_map = defaultdict(list)
    for a, b in bmn:
        bm_map[int(a)].append(int(b))

    # hierarchy-expanded positives per figure
    y_pos = []
    fig_pos_sets: dict[int, set[int]] = defaultdict(set)
    for fig, pat in fp:
        fig, pat = int(fig), int(pat)
        chain = [pat]
        for med in pm_map.get(pat, []):
            chain.append(med)
            for big in mb_map.get(med, []):
                chain.append(big)
                for main in bm_map.get(big, []):
                    chain.append(main)
        for lbl in chain:
            y_pos.append((fig, lbl))
            fig_pos_sets[fig].add(lbl)

    # balanced negatives: k sampled non-positive labels per figure
    y_neg = []
    for fig in range(nf):
        pos = fig_pos_sets.get(fig, set())
        got = 0
        attempts = 0
        while got < neg_samples_per_figure and attempts < 50 * neg_samples_per_figure:
            cand = int(rng.integers(0, num_labels))
            attempts += 1
            if cand in pos or cand == fig:
                continue
            y_neg.append((fig, cand))
            got += 1

    # absolute-index implications across all levels
    implication = np.concatenate([pm, mb, bmn], axis=0) if len(pm) else \
        np.empty((0, 2), np.int64)

    # exclusions: sampled patent pairs + disjoint-parent medium pairs
    exclusion = []
    npat = counts["patents"]
    # the partners of patent i are the other npat − 1 patents: position s
    # among them is patent s, or s + 1 from i on, so no list of them is
    # built (the same draws as JAX's, in O(npat) per patent at most)
    for i in range(npat):
        if npat - 1 > max_exclusions_per_patent:
            sel = rng.choice(npat - 1, max_exclusions_per_patent,
                             replace=False)
            others = np.where(sel < i, sel, sel + 1).tolist()
        else:
            others = [j for j in range(npat) if j != i]
        for j in others:
            exclusion.append((p0 + i, p0 + j))

    # medium CPCs: exclusive when their patent-parent sets are disjoint
    medium_parents: dict[int, set[int]] = defaultdict(set)
    for pat, med in pm:
        medium_parents[int(med)].add(int(pat))
    mediums = sorted(medium_parents)
    for mi in mediums:
        candidates = [mj for mj in mediums
                      if mj != mi and not (medium_parents[mi] &
                                           medium_parents[mj])]
        if len(candidates) > max_exclusions_per_medium:
            sel = rng.choice(len(candidates), max_exclusions_per_medium,
                             replace=False)
            candidates = [candidates[int(s)] for s in sel]
        exclusion.extend((mi, mj) for mj in candidates)

    def arr(lst):
        return (np.asarray(lst, np.int64).reshape(-1, 2)
                if len(lst) else np.empty((0, 2), np.int64))

    return HMIInputs(y_pos=arr(y_pos), y_neg=arr(y_neg),
                     implication=np.asarray(implication, np.int64),
                     exclusion=arr(exclusion))
