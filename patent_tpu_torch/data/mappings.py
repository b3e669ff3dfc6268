"""Mapping utilities (the port's copy of patent_tpu/data/mappings.py):
figure → patent from the file-name pattern, patent → dense label index,
same-patent figure pairs, the index maps of a built graph as JSON, and the
image-index schema (figure name → row).  Host code, no torch.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Mapping, Sequence

from .graph_build import HeteroGraph
from .schema import FigureRecord, parse_figure_name


def figure_to_patent_map(figure_names: Sequence[str]) -> dict[str, str]:
    """figure filename → patent id via the name pattern (train.py:762-776
  uses a regex on the filename; unparseable names are skipped)."""
    out: dict[str, str] = {}
    for name in figure_names:
        parsed = parse_figure_name(name)
        if parsed is not None:
            out[name] = parsed[0]
    return out


def patent_to_label_map(records: Sequence[FigureRecord]) -> dict[str, int]:
    """patent id → dense label index (first-appearance order, deterministic —
    replacing the reference's hash fallback, train.py:787-800)."""
    out: dict[str, int] = {}
    for r in records:
        if r.patent_id not in out:
            out[r.patent_id] = len(out)
    return out


def positive_figure_pairs_by_patent(records: Sequence[FigureRecord]
                                    ) -> list[tuple[str, str]]:
    """All same-patent figure-name pairs (train.py:820-850)."""
    by_patent: dict[str, list[str]] = defaultdict(list)
    for r in records:
        by_patent[r.patent_id].append(r.figure_id)
    pairs = []
    for figs in by_patent.values():
        for i in range(len(figs)):
            for j in range(i + 1, len(figs)):
                pairs.append((figs[i], figs[j]))
    return pairs


def mappings_from_graph(graph: HeteroGraph) -> dict:
    """Index maps + figure→patent(row) from a built graph, JSON-serializable
    (the reference saves similar mapping JSONs, train.py:800-815)."""
    coo = graph.adjacency.tocoo()
    nf = graph.counts["figures"]
    p0 = graph.offsets["patents"]
    m0 = graph.offsets["medium_cpcs"]
    fig_to_patent_row = {}
    inv_fig = {v: k for k, v in graph.figure_index.items()}
    inv_pat = {v: k for k, v in graph.patent_index.items()}
    for i, j in zip(coo.row, coo.col):
        if i < nf and p0 <= j < m0:
            fig_to_patent_row[inv_fig[int(i)]] = inv_pat[int(j) - p0]
    return {
        "figure_to_patent": fig_to_patent_row,
        "figure_index": graph.figure_index,
        "patent_index": graph.patent_index,
        "medium_index": graph.medium_index,
        "big_index": graph.big_index,
        "main_index": graph.main_index,
        "counts": graph.counts,
    }


def save_mappings(mappings: Mapping, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dict(mappings), f)


def image_index(figure_names: Sequence[str]) -> dict[str, int]:
    """figure filename → row index, the image_index_*.pkl schema
    (notebooks/image_index_2018.pkl: dict name → row, SURVEY §0)."""
    return {name: i for i, name in enumerate(figure_names)}
