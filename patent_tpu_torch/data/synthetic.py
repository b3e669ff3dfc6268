"""Synthetic DeepPatent-like retrieval corpus (the port's copy of the parts
of patent_tpu/data/synthetic.py that the retrieval actions call).

Records follow the real corpus's naming and CPC hierarchy; figures of one
patent share a base drawing, so the ground truth is learnable.  For one
seed the records and PNG bytes equal the JAX package's, byte for byte.
"""

from __future__ import annotations

import os
import zlib
from typing import Sequence

import numpy as np

from .schema import FigureRecord, records_from_metadata

# a small CPC hierarchy: sections → classes → subclasses
_SUBCLASSES = {"A01": ["A01G", "A01K"], "A41": ["A41D"],
               "B25": ["B25J"], "B60": ["B60R", "B60Q"], "F21": ["F21S"]}


def synthetic_metadata(num_patents: int = 20, figures_per_patent: int = 4,
                       seed: int = 0, year: int = 2018) -> list[dict]:
    """Metadata JSON records in the corpus schema."""
    rng = np.random.default_rng(seed)
    subclasses = [s for subs in _SUBCLASSES.values() for s in subs]
    out = []
    for p in range(num_patents):
        sub = subclasses[int(rng.integers(0, len(subclasses)))]
        month = int(rng.integers(1, 13))
        day = int(rng.integers(1, 29))
        patent = f"USD{700000 + p:07d}"
        nfig = int(figures_per_patent if figures_per_patent > 0
                   else rng.integers(2, 6))
        for f in range(nfig):
            name = f"{patent}-{year}{month:02d}{day:02d}-D{f + 1:05d}_1.png"
            out.append({"patentID": f"{patent}-{year}{month:02d}{day:02d}",
                        "subfigure_file": name, "cpc": [sub]})
    return out


def synthetic_records(num_patents: int = 20, figures_per_patent: int = 4,
                      seed: int = 0, max_month: int | None = None
                      ) -> list[FigureRecord]:
    return records_from_metadata(
        synthetic_metadata(num_patents, figures_per_patent, seed),
        max_month=max_month)


def _entity_rng(seed: int, kind: str, name: str) -> np.random.Generator:
    """A generator keyed on (seed, entity): the same stream whatever was
    generated before, so query and gallery written by separate calls
    share each patent's base drawing."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode()),
                                zlib.crc32(name.encode())]))


def write_synthetic_images(records: Sequence[FigureRecord], root: str,
                           image_size: int = 64, seed: int = 0,
                           noise: int = 20, hard: bool = False) -> list[str]:
    """Write one PNG per record under ``root``; returns the paths.

    ``hard=False``: each patent has its own random base drawing.
    ``hard=True``: patents of one medium-CPC subclass derive from one
    subclass drawing with a small per-patent delta, and per-figure noise is
    of the same order, so same-subclass distractors are near-duplicates of
    the true positives and the metrics land mid-range."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    bases: dict[str, np.ndarray] = {}
    sub_bases: dict[str, np.ndarray] = {}
    shape = (image_size, image_size, 3)
    paths = []
    for r in records:
        if r.patent_id not in bases:
            if hard:
                if r.medium_cpc not in sub_bases:
                    sub_bases[r.medium_cpc] = _entity_rng(
                        seed, "sub", r.medium_cpc).integers(
                        0, 255, shape, np.int64)
                bases[r.patent_id] = np.clip(
                    sub_bases[r.medium_cpc]
                    + _entity_rng(seed, "pat", r.patent_id).normal(
                        0.0, 18.0, shape),
                    0, 255)
            else:
                bases[r.patent_id] = _entity_rng(
                    seed, "pat", r.patent_id).integers(0, 255, shape, np.int64)
        frng = _entity_rng(seed, "fig", r.figure_id)
        if hard:
            img = np.clip(bases[r.patent_id] + frng.normal(0.0, 28.0, shape),
                          0, 255).astype(np.uint8)
        else:
            img = np.clip(bases[r.patent_id]
                          + frng.integers(-noise, noise + 1, shape),
                          0, 255).astype(np.uint8)
        path = os.path.join(root, r.figure_id)
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths
