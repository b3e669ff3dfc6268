"""Synthetic DeepPatent-like corpus (the port's copy of
patent_tpu/data/synthetic.py).

Records follow the real corpus's naming and CPC hierarchy; figures of one
patent share a base drawing, so the ground truth is learnable.  Besides the
noise corpus there is patent-drawing-like line art
(``synthetic_drawing_arrays``) and a corpus of its geometric views
(``write_synthetic_view_images``).  For one seed the records, arrays, PNG
bytes and feature vectors equal the JAX package's, byte for byte.
"""

from __future__ import annotations

import json
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


def synthetic_features(records: Sequence[FigureRecord], dim: int = 64,
                       seed: int = 0, noise: float = 0.15
                       ) -> dict[str, np.ndarray]:
    """figure name → feature vector; same-patent figures cluster, and patents
    sharing a CPC subclass are closer than unrelated ones."""
    rng = np.random.default_rng(seed)
    cpc_centers: dict[str, np.ndarray] = {}
    patent_centers: dict[str, np.ndarray] = {}
    out = {}
    for r in records:
        if r.medium_cpc not in cpc_centers:
            cpc_centers[r.medium_cpc] = rng.standard_normal(dim)
        if r.patent_id not in patent_centers:
            patent_centers[r.patent_id] = (cpc_centers[r.medium_cpc] +
                                           0.5 * rng.standard_normal(dim))
        out[r.figure_id] = (patent_centers[r.patent_id] +
                            noise * rng.standard_normal(dim)).astype(np.float32)
    return out


def synthetic_drawing_arrays(n: int, size: int = 224, seed: int = 0,
                             line_width: float = 0.10) -> np.ndarray:
    """[n, size, size, 3] float32 in [0, 1]: patent-drawing-like line art,
    white paper with thin dark strokes.  The strokes are level-set bands
    (|f| < eps) of two smoothed random fields, plus a 2 px frame at a random
    inset, as a figure border."""
    def box1d(x: np.ndarray, k: int, axis: int) -> np.ndarray:
        """Moving average, window 2k+1, edge-padded, via cumsum."""
        pad_width = [(0, 0)] * x.ndim
        pad_width[axis] = (k, k)
        xp = np.pad(x, pad_width, mode="edge")
        zero_shape = list(xp.shape)
        zero_shape[axis] = 1
        c = np.concatenate([np.zeros(zero_shape, x.dtype),
                            np.cumsum(xp, axis=axis, dtype=np.float32)], axis)
        m = x.shape[axis]
        hi = np.take(c, np.arange(m) + 2 * k + 1, axis=axis)
        lo = np.take(c, np.arange(m), axis=axis)
        return (hi - lo) / np.float32(2 * k + 1)

    rng = np.random.default_rng(seed)
    low_res = size // 8 + 1
    canvas = np.ones((n, size, size), np.float32)
    for _ in range(2):
        field = rng.standard_normal((n, low_res, low_res)).astype(np.float32)
        up = np.repeat(np.repeat(field, 8, axis=1), 8, axis=2)[:, :size, :size]
        smooth = box1d(box1d(up, 9, 1), 9, 2)
        band = np.abs(smooth) < line_width * smooth.std(axis=(1, 2),
                                                        keepdims=True)
        canvas = np.where(band, 0.0, canvas)
    inset = rng.integers(4, 20, n)
    for i in range(n):
        a = int(inset[i])
        b = size - a
        canvas[i, a:a + 2, a:b] = 0.0
        canvas[i, b - 2:b, a:b] = 0.0
        canvas[i, a:b, a:a + 2] = 0.0
        canvas[i, a:b, b - 2:b] = 0.0
    return np.repeat(canvas[..., None], 3, axis=-1)


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


def apply_view(img: np.ndarray, view_index: int) -> np.ndarray:
    """View ``view_index`` % 4 of a drawing [H, W, C]: itself, flipped left
    to right, turned 90°, or shifted by (4, 12) pixels, which is not a
    multiple of a patch."""
    k = view_index % 4
    if k == 0:
        return img
    if k == 1:
        return img[:, ::-1]
    if k == 2:
        return np.rot90(img, 1, (0, 1))
    return np.roll(img, (4, 12), (0, 1))


def write_synthetic_view_images(records: Sequence[FigureRecord], root: str,
                                image_size: int = 64, seed: int = 0,
                                noise: float = 8.0) -> list[str]:
    """The views corpus: figure k of a patent is ``apply_view`` k of the
    patent's one line-art drawing, with per-figure ink contrast in [0.35,
    1) and pixel noise, so positives share structure but not pixels.  The
    view index comes from the '-D<k>_' part of a synthetic name, else from
    a count per patent.  Writes one PNG per record; returns the paths."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    bases: dict[str, np.ndarray] = {}
    view_counter: dict[str, int] = {}
    paths = []
    for r in records:
        if r.patent_id not in bases:
            s = int(_entity_rng(seed, "viewbase", r.patent_id)
                    .integers(0, 2**31 - 1))
            bases[r.patent_id] = (
                synthetic_drawing_arrays(1, image_size, seed=s)[0] * 255.0)
        try:
            fidx = int(r.figure_id.split("-D")[1].split("_")[0]) - 1
        except (IndexError, ValueError):
            fidx = view_counter.get(r.patent_id, 0)
        view_counter[r.patent_id] = fidx + 1
        img = apply_view(bases[r.patent_id], fidx)
        frng = _entity_rng(seed, "fig", r.figure_id)
        c = frng.uniform(0.35, 1.0)
        img = 255.0 - (255.0 - img) * c
        img = np.clip(img + frng.normal(0.0, noise, img.shape), 0, 255)
        path = os.path.join(root, r.figure_id)
        Image.fromarray(img.astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def write_synthetic_corpus(root: str, num_patents: int = 20,
                           figures_per_patent: int = 4, image_size: int = 64,
                           seed: int = 0) -> tuple[list[FigureRecord], str]:
    """A corpus on disk, ``root``/images/ and ``root``/metadata.json, as the
    fine-tune reads a real one; → (records, images_dir)."""
    meta = synthetic_metadata(num_patents, figures_per_patent, seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    records = records_from_metadata(meta)
    images_dir = os.path.join(root, "images")
    write_synthetic_images(records, images_dir, image_size=image_size,
                           seed=seed)
    return records, images_dir
