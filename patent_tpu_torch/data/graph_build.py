"""Heterogeneous graph construction: 5 node types → block adjacency + features
(the port's copy of patent_tpu/data/graph_build.py: ``HeteroGraph``,
``build_hetero_graph``, ``build_feature_matrix``, and ``load_graph`` /
``process_patent_graph``, which load a saved graph and normalize it with
``models/gcn.normalize_adjacency``).

Framework-module re-implementation of the reference's notebook ETL
(graph generation (1).ipynb cells 48-65): node-index maps per type, bipartite
COO blocks Figure–Patent / Patent–Medium / Medium–Big / Big–Main, a symmetric
block matrix with identity self-loop blocks, and a feature matrix aligned to
node order.  Node counts are DERIVED FROM THE DATA — the reference hardcodes
them per era (27101/13552/578/126/9 etc., SURVEY §2.3) which this framework
deliberately avoids.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import scipy.sparse as sp

from .schema import FigureRecord


@dataclasses.dataclass
class HeteroGraph:
    """The built graph: symmetric [N, N] adjacency + node index maps.

    Node order is figures, patents, medium CPCs, big CPCs, main CPCs —
    the block layout of graph gen cell 55.
    """

    adjacency: sp.csr_matrix
    figure_index: dict[str, int]
    patent_index: dict[str, int]
    medium_index: dict[str, int]
    big_index: dict[str, int]
    main_index: dict[str, int]

    @property
    def counts(self) -> dict[str, int]:
        return {
            "figures": len(self.figure_index),
            "patents": len(self.patent_index),
            "medium_cpcs": len(self.medium_index),
            "big_cpcs": len(self.big_index),
            "main_cpcs": len(self.main_index),
        }

    @property
    def num_nodes(self) -> int:
        return sum(self.counts.values())

    @property
    def offsets(self) -> dict[str, int]:
        c = self.counts
        patents = c["figures"]
        medium = patents + c["patents"]
        big = medium + c["medium_cpcs"]
        main = big + c["big_cpcs"]
        return {"patents": patents, "medium_cpcs": medium,
                "big_cpcs": big, "main_cpcs": main}

    def save(self, adjacency_path: str) -> None:
        sp.save_npz(adjacency_path, self.adjacency.tocoo())


def _index_map(values: Sequence[str]) -> dict[str, int]:
    """First-appearance-order index map (graph gen cell 48 uses
    ``pd.unique``-order enumeration)."""
    out: dict[str, int] = {}
    for v in values:
        if v not in out:
            out[v] = len(out)
    return out


def build_hetero_graph(records: Sequence[FigureRecord]) -> HeteroGraph:
    """Records → symmetric block adjacency (graph gen cells 48-58).

    Block layout (cell 55): diagonal = identity self-loops per type;
    off-diagonal = the 4 bipartite relations and their transposes.
    """
    fig_idx = _index_map([r.figure_id for r in records])
    pat_idx = _index_map([r.patent_id for r in records])
    med_idx = _index_map([r.medium_cpc for r in records])
    big_idx = _index_map([r.big_cpc for r in records])
    main_idx = _index_map([r.main_cpc for r in records])

    def bipartite(pairs: set[tuple[int, int]], nrows: int, ncols: int) -> sp.coo_matrix:
        if not pairs:
            return sp.coo_matrix((nrows, ncols))
        rows, cols = zip(*sorted(pairs))
        return sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                             shape=(nrows, ncols))

    fp = bipartite({(fig_idx[r.figure_id], pat_idx[r.patent_id]) for r in records},
                   len(fig_idx), len(pat_idx))
    pm = bipartite({(pat_idx[r.patent_id], med_idx[r.medium_cpc]) for r in records},
                   len(pat_idx), len(med_idx))
    mb = bipartite({(med_idx[r.medium_cpc], big_idx[r.big_cpc]) for r in records},
                   len(med_idx), len(big_idx))
    bm = bipartite({(big_idx[r.big_cpc], main_idx[r.main_cpc]) for r in records},
                   len(big_idx), len(main_idx))

    def eye(n):
        return sp.identity(n, format="coo")

    def zeros(n, m):
        return sp.coo_matrix((n, m))

    nf, np_, nm, nb, nmain = (len(fig_idx), len(pat_idx), len(med_idx),
                              len(big_idx), len(main_idx))
    rows = [
        sp.hstack([eye(nf), fp, zeros(nf, nm), zeros(nf, nb), zeros(nf, nmain)]),
        sp.hstack([fp.T, eye(np_), pm, zeros(np_, nb), zeros(np_, nmain)]),
        sp.hstack([zeros(nm, nf), pm.T, eye(nm), mb, zeros(nm, nmain)]),
        sp.hstack([zeros(nb, nf), zeros(nb, np_), mb.T, eye(nb), bm]),
        sp.hstack([zeros(nmain, nf), zeros(nmain, np_), zeros(nmain, nm),
                   bm.T, eye(nmain)]),
    ]
    adj = sp.vstack(rows).tocsr()
    # symmetry invariant (graph gen cell 56's check)
    assert (adj != adj.T).nnz == 0, "adjacency must be symmetric"
    return HeteroGraph(adjacency=adj, figure_index=fig_idx, patent_index=pat_idx,
                       medium_index=med_idx, big_index=big_idx, main_index=main_idx)


def build_feature_matrix(graph: HeteroGraph,
                         figure_features: Mapping[str, np.ndarray],
                         patent_features: Mapping[str, np.ndarray] | None = None,
                         medium_features: Mapping[str, np.ndarray] | None = None,
                         big_features: Mapping[str, np.ndarray] | None = None,
                         main_features: Mapping[str, np.ndarray] | None = None,
                         feature_dim: int | None = None) -> np.ndarray:
    """Align per-type feature dicts to node order; zeros for missing nodes
    (graph gen cells 61-65 ``align_features``)."""
    if feature_dim is None:
        for d in (figure_features, patent_features, medium_features,
                  big_features, main_features):
            if d:
                feature_dim = len(next(iter(d.values())))
                break
    if feature_dim is None:
        raise ValueError("cannot infer feature_dim from empty feature dicts")

    x = np.zeros((graph.num_nodes, feature_dim), np.float32)
    offsets = [0] + list(graph.offsets.values())
    index_maps = [graph.figure_index, graph.patent_index, graph.medium_index,
                  graph.big_index, graph.main_index]
    dicts = [figure_features, patent_features, medium_features,
             big_features, main_features]
    for offset, idx_map, feats in zip(offsets, index_maps, dicts):
        if not feats:
            continue
        for key, row in idx_map.items():
            vec = feats.get(key)
            if vec is not None:
                x[offset + row] = np.asarray(vec, np.float32)
    return x


def load_graph(adjacency_path: str, features_path: str
               ) -> tuple[np.ndarray, np.ndarray]:
    """(features, adjacency) of a saved graph as dense float32 arrays
    (reference ``load_patent_graph``, src/process_graph.py:101-130)."""
    adj = sp.load_npz(adjacency_path).toarray().astype(np.float32)
    feats = sp.load_npz(features_path).toarray().astype(np.float32) \
        if features_path.endswith(".npz") else np.load(features_path)
    return feats.astype(np.float32), adj


def process_patent_graph(adjacency_path: str, features_path: str
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Load and symmetric-normalize in one call (reference
    ``process_patent_graph``, src/process_graph.py:133-167): (X float32,
    A_tilde float32) for the GCN trainers."""
    import torch

    from ..models.gcn import normalize_adjacency

    x, adj = load_graph(adjacency_path, features_path)
    return x, normalize_adjacency(torch.from_numpy(adj)).numpy()
