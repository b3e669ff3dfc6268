"""Query/gallery split and ground truth of the reference protocol (the
port's copy of the parts of patent_tpu/data/ground_truth.py that the
retrieval and fine-tune actions call).

``split_query_gallery``: patents with at least 3 figures give 2 random
figures to the query set, the rest to the gallery (seed 42).
``build_ground_truth``: per query figure, the gallery figures of the same
patent and those sharing its medium CPC, with the grant-month filter.
``figure_to_pos_figures``: the fine-tune's anchor → positives map.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Mapping, Sequence

from .schema import FigureRecord, parse_figure_name


def split_query_gallery(records: Sequence[FigureRecord], seed: int = 42,
                        queries_per_patent: int = 2, min_figures: int = 3
                        ) -> tuple[list[FigureRecord], list[FigureRecord]]:
    """(query_records, gallery_records)."""
    rng = random.Random(seed)
    by_patent: dict[str, list[FigureRecord]] = defaultdict(list)
    for r in records:
        by_patent[r.patent_id].append(r)
    queries, gallery = [], []
    for _patent, items in sorted(by_patent.items()):
        if len(items) >= min_figures:
            q = rng.sample(items, queries_per_patent)
            queries.extend(q)
            q_ids = {r.figure_id for r in q}
            gallery.extend(r for r in items if r.figure_id not in q_ids)
        else:
            gallery.extend(items)
    return queries, gallery


def build_ground_truth(query_records: Sequence[FigureRecord],
                       gallery_records: Sequence[FigureRecord],
                       max_month: int | None = 5) -> dict[str, dict]:
    """query figure name → {"patent_positives": [...], "cpc_positives":
    [...]}; queries granted after ``max_month`` are left out."""
    gallery_by_patent: dict[str, list[str]] = defaultdict(list)
    gallery_by_cpc: dict[str, list[str]] = defaultdict(list)
    for r in gallery_records:
        gallery_by_patent[r.patent_id].append(r.figure_id)
        gallery_by_cpc[r.medium_cpc].append(r.figure_id)

    out: dict[str, dict] = {}
    for q in query_records:
        if max_month is not None:
            parsed = parse_figure_name(q.figure_id)
            if parsed is None or parsed[2] > max_month:
                continue
        out[q.figure_id] = {
            "patent_positives": sorted(gallery_by_patent.get(q.patent_id, [])),
            "cpc_positives": sorted(gallery_by_cpc.get(q.medium_cpc, [])),
        }
    return out


def save_ground_truth(ground_truth: Mapping[str, dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(dict(ground_truth), f, indent=2)


def figure_to_pos_figures(records: Sequence[FigureRecord]
                          ) -> dict[str, list[str]]:
    """figure name → the other figures of its patent, sorted (figures of a
    one-figure patent are left out)."""
    by_patent: dict[str, list[str]] = defaultdict(list)
    for r in records:
        by_patent[r.patent_id].append(r.figure_id)
    out: dict[str, list[str]] = {}
    for figs in by_patent.values():
        for f in figs:
            others = [g for g in figs if g != f]
            if others:
                out[f] = sorted(others)
    return out
