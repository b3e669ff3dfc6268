"""5-level figure-pair sampler for the GCN pair classifier (the port's copy
of patent_tpu/data/pairs.py, numpy only: the same pairs for a seed).

Re-implementation of graph generation (1).ipynb cell 77: sample figure
pairs and label them by connection level —
  1: same patent, 2: share medium CPC, 3: share big CPC, 4: share main CPC,
  5: no connection —
capped per level, serialized as ``figure_pair_connections.json``
(consumed by train_class_pro: src/train.py:3841-3845, 152-156).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Sequence

import numpy as np

from .schema import FigureRecord


def connection_level(a: FigureRecord, b: FigureRecord) -> int:
    if a.patent_id == b.patent_id:
        return 1
    if a.medium_cpc == b.medium_cpc:
        return 2
    if a.big_cpc == b.big_cpc:
        return 3
    if a.main_cpc == b.main_cpc:
        return 4
    return 5


def sample_figure_pairs(records: Sequence[FigureRecord],
                        num_samples: int = 200_000,
                        cap_per_level: int = 28_000,
                        seed: int = 42,
                        figure_to_row: dict[str, int] | None = None
                        ) -> dict[str, list]:
    """Sample pairs and label by level; returns the reference's JSON schema:
    ``{"pairs": [[i, j], ...], "labels": [level, ...]}`` with row indices
    into ``figure_to_row`` (defaults to record order).

    Same-patent pairs are additionally enumerated exhaustively before random
    sampling so level 1 is never starved (cell 77 samples enough to hit its
    caps; small corpora need the enumeration).
    """
    rng = np.random.default_rng(seed)
    if figure_to_row is None:
        figure_to_row = {r.figure_id: i for i, r in enumerate(records)}
    n = len(records)
    counts = defaultdict(int)
    pairs: list[list[int]] = []
    labels: list[int] = []
    seen: set[tuple[int, int]] = set()

    def add(ai: int, bi: int) -> None:
        lvl = connection_level(records[ai], records[bi])
        if counts[lvl] >= cap_per_level:
            return
        key = (min(ai, bi), max(ai, bi))
        if key in seen:
            return
        seen.add(key)
        ra, rb = records[ai], records[bi]
        pairs.append([figure_to_row[ra.figure_id], figure_to_row[rb.figure_id]])
        labels.append(lvl)
        counts[lvl] += 1

    # exhaustive same-patent pairs (level 1)
    by_patent: dict[str, list[int]] = defaultdict(list)
    for i, r in enumerate(records):
        by_patent[r.patent_id].append(i)
    for idxs in by_patent.values():
        for i in range(len(idxs)):
            for j in range(i + 1, len(idxs)):
                add(idxs[i], idxs[j])

    # random sampling for the rest
    for _ in range(num_samples):
        ai, bi = int(rng.integers(0, n)), int(rng.integers(0, n))
        if ai != bi:
            add(ai, bi)

    return {"pairs": pairs, "labels": labels,
            "level_counts": {str(k): v for k, v in sorted(counts.items())}}


def save_figure_pair_connections(data: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(data, f)


def load_figure_pair_connections(path: str) -> tuple[np.ndarray, np.ndarray]:
    """→ (pairs [P, 2] int32, labels [P] int32 zero-based classes)."""
    with open(path) as f:
        data = json.load(f)
    pairs = np.asarray(data["pairs"], np.int32)
    labels = np.asarray(data["labels"], np.int32) - 1  # levels 1..5 → 0..4
    return pairs, labels
