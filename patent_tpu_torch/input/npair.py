"""N-pair batches for contrastive image training (the port's copy of
patent_tpu/input/npair.py): positives grouped by anchor, one positive
sampled per anchor, and fixed-size index batches in the anchors ∥
positives layout the contrastive losses take, or interleaved.  Index
arithmetic on the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, Mapping, Sequence

import numpy as np


def build_anchor_positives(pairs: Sequence[tuple[int, int]]
                           ) -> dict[int, list[int]]:
    """(anchor, positive) pairs → anchor → positives list (the reference's
    models.py:104-109)."""
    out: dict[int, list[int]] = defaultdict(list)
    for a, p in pairs:
        out[int(a)].append(int(p))
    return dict(out)


def npair_batches(anchor_to_positives: Mapping[int, Sequence[int]],
                  batch_pairs: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_remainder: bool = False
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (anchor_idx [B], positive_idx [B]) with one sampled positive
    per anchor (models.py:111-145 semantics; the interleaved flat layout of
    collate_npairs is ``np.stack([a, p]).T.ravel()`` if needed)."""
    anchors = np.asarray(sorted(anchor_to_positives), np.int64)
    if shuffle:
        anchors = anchors[rng.permutation(len(anchors))]
    for s in range(0, len(anchors), batch_pairs):
        chunk = anchors[s:s + batch_pairs]
        if drop_remainder and len(chunk) < batch_pairs:
            return
        pos = np.asarray([
            anchor_to_positives[int(a)][
                int(rng.integers(len(anchor_to_positives[int(a)])))]
            for a in chunk], np.int64)
        yield chunk, pos


def interleave(anchors: np.ndarray, positives: np.ndarray) -> np.ndarray:
    """[a1, p1, a2, p2, ...] — the reference's batch layout
    (models.py:128-131)."""
    return np.stack([anchors, positives], axis=1).ravel()


def stacked(anchors: np.ndarray, positives: np.ndarray) -> np.ndarray:
    """[a1..aB, p1..pB] — the layout used by multi_positive_nt_xent."""
    return np.concatenate([anchors, positives])
