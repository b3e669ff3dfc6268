"""Exact cosine, dot-product and Poincaré top-k index, on one device or
with the gallery's rows in blocks over a mesh (port of
patent_tpu/retrieval/index.py).

``topk_search`` is the oracle: a blockwise f32 scan (plain matmuls, as the
JAX package leaves it to XLA); ``similarity="dot"`` ranks by the raw f32
dot product, which only the scan serves, as in JAX.  For ``similarity="poincare"`` it ranks by
the monotone surrogate of −distance and returns the true −distance of the
k winners.  ``topk_search_cosine_fast`` over-fetches a
``DEFAULT_RERANK_MULT``·k candidate pool with the bucketed bf16 kernel
(ops/topk_kernel) and re-ranks it exactly in f32, so its answer equals the
scan's, ties included; ``topk_search_quantized`` does the same from an
int8 gallery; ``topk_search_poincare_fast`` over-fetches from the int8
Poincaré kernel and re-ranks with the f64 direct distance, which near the
boundary orders more exactly than the scan's f32 surrogate.
``EmbeddingIndex`` takes a candidate path whenever the pool is smaller
than the gallery (the bf16 one on a CUDA device only; the int8 ones,
``quantized=True``, on any device), and the scan otherwise; it reads and
writes the JAX index's ``.npy`` + ``.json`` files, and exports the
reference's feature pickle (``save_feature_pickle``).  Its candidate copies
are zero-padded to the kernels' multiple of columns, as JAX pads D, so
every width reaches the kernels.  The sharded searches (``sharded_*``,
``EmbeddingIndex(mesh=...)``) are described where they start, below.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import typing

import numpy as np
import torch
import torch.distributed as dist

from ..ops import poincare
from ..ops.topk_kernel import (PoincareGallery, bucket_topk_bf16,
                               bucket_topk_int8, bucket_topk_poincare,
                               bucket_topk_supported, pad_columns,
                               prepare_cosine_gallery_bf16,
                               prepare_poincare_gallery, quantize_gallery,
                               quantize_queries)
from ..parallel.mesh import (all_gather_rows, axis_group, axis_rank,
                             axis_size, mesh_device)

DEFAULT_RERANK_MULT = 8
# pool depth of the Poincaré candidate stage (the JAX package's choice)
POINCARE_RERANK_MULT = DEFAULT_RERANK_MULT
SIMILARITIES = ("cosine", "dot", "poincare")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _top_sorted(vals: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` per row, best-first, ties to the lower position (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none)."""
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], pos[:, :k]


def _scores_block(q: torch.Tensor, g: torch.Tensor, similarity: str,
                  c: float) -> torch.Tensor:
    """[Q, B] scores (higher is better) of one gallery block.  Cosine: q
    is already normalized; dot: the raw f32 products.  Poincaré: the
    monotone surrogate of −distance,

        s(v) = 2·u·(v·w) − |u|²·w − |v|²·w,   w = 1/(1 − c|v|²),

    which orders a query's gallery exactly as the distance does (the
    u-terms of the arcosh form are constants of the query)."""
    if similarity == "cosine":
        return q @ _normalize(g).T
    if similarity == "dot":
        return q @ g.T
    g_sq = (g * g).sum(dim=-1)
    w = 1.0 / torch.clamp_min(1.0 - c * g_sq, 1e-12)
    q_sq = (q * q).sum(dim=-1, keepdim=True)
    return 2.0 * (q @ (g * w[:, None]).T) - q_sq * w[None, :] \
        - (g_sq * w)[None, :]


def topk_search(queries: torch.Tensor, gallery: torch.Tensor, k: int = 10,
                block_size: int = 8192, similarity: str = "cosine",
                c: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, blockwise over the gallery, in f32.

    Returns (scores [Q, k] f32, indices [Q, k] int64) best-first; ties go
    to the lower gallery index; a gallery smaller than k pads with
    (-inf, 0).  Cosine scores are cosines, dot ones dot products; Poincaré
    ones are the true
    −distance of each winner (ranked by the surrogate)."""
    if similarity not in SIMILARITIES:
        raise ValueError(f"unknown similarity {similarity!r}")
    q = queries.float()
    if similarity == "cosine":
        q = _normalize(q)
    g = gallery.float()
    n, nq = g.shape[0], q.shape[0]
    if n <= max(block_size, k):
        vals, idx = _top_sorted(_scores_block(q, g, similarity, c),
                                min(k, n))
        if n < k:
            vals = torch.nn.functional.pad(vals, (0, k - n),
                                           value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, k - n), value=0)
    else:
        vals = torch.full((nq, k), float("-inf"), device=q.device)
        idx = torch.zeros((nq, k), dtype=torch.long, device=q.device)
        for start in range(0, n, block_size):
            blk = g[start:start + block_size]
            s = _scores_block(q, blk, similarity, c)
            col = torch.arange(start, start + blk.shape[0],
                               device=q.device).expand(nq, -1)
            vals, pos = _top_sorted(torch.cat([vals, s], dim=1), k)
            idx = torch.gather(torch.cat([idx, col], dim=1), 1, pos)
    if similarity == "poincare":
        d = poincare.dist(q[:, None, :], g[idx], c)
        vals = torch.where(torch.isfinite(vals), -d, vals)
    return vals, idx


def _cosine_rerank_device(pidx: torch.Tensor, queries: torch.Tensor,
                          gallery: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 cosine re-rank of a candidate pool, with the scan's
    normalization.  The pool is first sorted by gallery index, so the
    stable descending sort breaks exact ties (duplicate rows) to the lower
    gallery index, as the scan does."""
    pidx = torch.sort(pidx, dim=1).values
    qn = _normalize(queries.float())
    cand = _normalize(gallery.float()[pidx])                  # [Q, P, D]
    exact = torch.einsum("qd,qpd->qp", qn, cand)
    vals, pos = _top_sorted(exact, k)
    return vals, torch.gather(pidx, 1, pos)


def fused_cosine_eligible(n: int, k: int, device: torch.device,
                          rerank_mult: int = DEFAULT_RERANK_MULT) -> bool:
    """True iff ``EmbeddingIndex.search`` takes the bucket-kernel path: a
    CUDA device and a candidate pool smaller than the gallery."""
    pool = min(max(k * rerank_mult, k), n)
    return (torch.device(device).type == "cuda" and pool < n
            and bucket_topk_supported(n, pool))


def topk_search_cosine_fast(queries: torch.Tensor, gal_bf16: torch.Tensor,
                            valid: torch.Tensor, gallery_f32: torch.Tensor,
                            k: int = 10, block_size: int = 8192,
                            rerank_mult: int = DEFAULT_RERANK_MULT
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: bucketed bf16 candidate pool of
    ``rerank_mult``·k, then the exact f32 re-rank — the same answer as
    ``topk_search``.  The one reachable difference is a gallery with more
    than two exact duplicates of a row in one bucket (row mod 1024): the
    excess copies are evicted and the tail back-fills with the next rows.
    Falls back to the scan when the pool covers the whole gallery."""
    q = queries.float()
    n = gal_bf16.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size)
    _pv, pidx = bucket_topk_bf16(q, gal_bf16, valid, pool)
    return _cosine_rerank_device(pidx, q, gallery_f32, k)


def topk_search_quantized(queries: torch.Tensor, gal_i8: torch.Tensor,
                          gal_scale: torch.Tensor, gallery_f32: torch.Tensor,
                          k: int = 10, block_size: int = 8192,
                          rerank_mult: int = DEFAULT_RERANK_MULT
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k from an int8 gallery (``quantize_gallery``): the
    queries are normalized and row-quantized, the bucketed int8 stage
    over-fetches a ``rerank_mult``·k pool, and the exact f32 re-rank gives
    the same answer as ``topk_search``, ties included.  The scan answers
    when the pool would cover the gallery or exceed the stage's capacity."""
    q = queries.float()
    n = gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size)
    q_i8, q_scale = quantize_queries(q)
    _pv, pidx = bucket_topk_int8(q_i8, q_scale, gal_i8, gal_scale, pool)
    return _cosine_rerank_device(pidx, q, gallery_f32, k)


def poincare_dist_f64(u: torch.Tensor, v: torch.Tensor,
                      c: float) -> torch.Tensor:
    """f64 Poincaré distance in the cancellation-free direct form,
    arcosh(1 + 2c|u−v|² / ((1−c|u|²)(1−c|v|²))) / √c: u [Q, D], v [Q, P, D]
    → [Q, P]."""
    u, v = u.double(), v.double()
    diff_sq = (u[:, None, :] - v).square().sum(dim=-1)
    den = ((1.0 - c * (u * u).sum(dim=-1))[:, None]
           * (1.0 - c * (v * v).sum(dim=-1)))
    arg = 1.0 + 2.0 * c * diff_sq / torch.clamp_min(den, 1e-15)
    return torch.acosh(torch.clamp_min(arg, 1.0)) / math.sqrt(c)


def _poincare_rerank(pidx: torch.Tensor, queries: torch.Tensor,
                     gallery: torch.Tensor, k: int, c: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f64 re-rank of a candidate pool on its device.  The pool is
    first sorted by gallery index, so the stable ascending sort breaks
    exact ties to the lower gallery index, as the scan does.  Returns
    (−distance f32, indices)."""
    pidx = torch.sort(pidx, dim=1).values
    d = poincare_dist_f64(queries, gallery[pidx], c)
    d, pos = torch.sort(d, dim=1, stable=True)
    return -d[:, :k].float(), torch.gather(pidx, 1, pos[:, :k])


def topk_search_poincare_fast(queries: torch.Tensor, gal: PoincareGallery,
                              gallery_f32: torch.Tensor, k: int = 10,
                              c: float = 1.0, block_size: int = 8192,
                              rerank_mult: int = POINCARE_RERANK_MULT
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Poincaré top-k: the int8 surrogate candidate stage over-fetches a
    ``rerank_mult``·k pool, and the exact f64 distance re-ranks it on the
    gallery's device; values are −distance, as ``topk_search`` returns
    them.  The scan answers when the pool would cover the gallery or
    exceed the stage's capacity."""
    q = queries.float()
    n = gal.gal_i8.shape[0]
    pool = min(max(k * rerank_mult, k), n)
    if pool >= n or not bucket_topk_supported(n, pool):
        return topk_search(q, gallery_f32, k=k, block_size=block_size,
                           similarity="poincare", c=c)
    _pv, pidx = bucket_topk_poincare(q, gal, pool)
    return _poincare_rerank(pidx, q, gallery_f32, k, c)


# ---------------------------------------------------------------- sharded
# The gallery's rows in blocks over one axis of a mesh (port of the mesh
# half of patent_tpu/retrieval/index.py).  Each rank holds per_shard =
# ceil(n / shards) rows of each copy (its candidate copy zero-padded to
# per_shard rows that the stage never chooses), runs the single-device
# candidate stage on them, offsets its indices and marks every filler
# (a -inf candidate) with index -1; one all-gather merges the pools, ties
# to the lower global index.  The exact re-rank scores each pooled row on
# the rank that owns it, 0 elsewhere, and one all-reduce completes the
# scores on every rank (each sum has one nonzero term, so it is exact).
# A filler never reaches the re-rank (the JAX functions let a filler's
# index, 0 of its shard, into the pool, where it can repeat a row).


class _Shard(typing.NamedTuple):
    start: int          # this rank's first gallery row
    stop: int           # one past its last
    per: int            # rows a shard (the blocks' stride)
    n: int              # gallery rows
    group: object       # the mesh axis's process group


def _shard_of(mesh, axis: str, n: int) -> _Shard:
    per = -(-n // axis_size(mesh, axis))
    start = min(axis_rank(mesh, axis) * per, n)
    return _Shard(start, min(start + per, n), per, n, axis_group(mesh, axis))


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t with zero rows appended up to ``rows`` (zero is each copy's
    never-chosen row: a 0 valid flag, a 0 int8 scale, a 0 Poincaré w)."""
    extra = rows - t.shape[0]
    return torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))]) \
        if extra else t


def _gather_cols(t: torch.Tensor, group) -> torch.Tensor:
    """[Q, p] on each rank → [Q, shards·p], shard after shard."""
    parts = all_gather_rows(t[None], group)
    return parts.permute(1, 0, 2).reshape(t.shape[0], -1)


def _merge_pool(vals: torch.Tensor, idx: torch.Tensor, sh: _Shard,
                pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's candidates (local indices) → the top ``pool`` of every
    shard's, global indices, fillers -1 and -inf, ties to the lower
    global index."""
    idx = idx.long() + sh.start
    real = torch.isfinite(vals) & (idx < sh.n)
    vals = torch.where(real, vals, float("-inf"))
    idx = torch.where(real, idx, -1)
    all_v, all_i = _gather_cols(vals, sh.group), _gather_cols(idx, sh.group)
    order = torch.sort(all_i, dim=1, stable=True).indices
    all_v, all_i = all_v.gather(1, order), all_i.gather(1, order)
    v, pos = _top_sorted(all_v, pool)
    return v, all_i.gather(1, pos)


def _owned_rows(block: torch.Tensor, pidx: torch.Tensor, sh: _Shard):
    """(rows of ``block`` at the pooled global indices, the owned mask):
    rows this rank does not own are block row 0 (masked by the caller)."""
    local = pidx - sh.start
    owned = (local >= 0) & (local < sh.stop - sh.start)
    if sh.stop == sh.start:      # an empty shard owns nothing
        return block.new_zeros(pidx.shape + block.shape[1:]), owned
    return block[torch.where(owned, local, 0)], owned


def _cosine_rerank_sharded(pidx: torch.Tensor, queries: torch.Tensor,
                           block: torch.Tensor, sh: _Shard, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_cosine_rerank_device`` of a merged pool over the blocks."""
    pidx = torch.sort(pidx, dim=1).values
    cand, owned = _owned_rows(block.float(), pidx, sh)
    exact = torch.einsum("qd,qpd->qp", _normalize(queries.float()),
                         _normalize(cand))
    exact = torch.where(owned, exact, 0.0)
    dist.all_reduce(exact, group=sh.group)
    exact = torch.where(pidx >= 0, exact, float("-inf"))
    vals, pos = _top_sorted(exact, k)
    return vals, torch.gather(pidx, 1, pos)


def _poincare_rerank_sharded(pidx: torch.Tensor, queries: torch.Tensor,
                             block: torch.Tensor, sh: _Shard, k: int,
                             c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``_poincare_rerank`` of a merged pool over the blocks (f64)."""
    pidx = torch.sort(pidx, dim=1).values
    cand, owned = _owned_rows(block, pidx, sh)
    d = torch.where(owned, poincare_dist_f64(queries, cand, c), 0.0)
    dist.all_reduce(d, group=sh.group)
    d = torch.where(pidx >= 0, d, float("inf"))
    d, pos = torch.sort(d, dim=1, stable=True)
    return -d[:, :k].float(), torch.gather(pidx, 1, pos[:, :k])


def _scan_shard(q: torch.Tensor, block: torch.Tensor, sh: _Shard, k: int,
                block_size: int, similarity: str, c: float):
    vals, idx = topk_search(q, block, k=k, block_size=block_size,
                            similarity=similarity, c=c)
    return _merge_pool(vals, idx, sh, k)


def _cosine_fast_shard(q, gal16, valid, block, sh: _Shard, k: int,
                       block_size: int, rerank_mult: int):
    """Cosine top-k from this rank's bf16 copy (``per`` rows) and f32
    block; the bf16 stage is row 3 on the card."""
    pool = min(max(k * rerank_mult, k), sh.n)
    local = min(pool, sh.per)
    if bucket_topk_supported(sh.per, local):
        vals, idx = bucket_topk_bf16(q, gal16, valid, local)
    else:
        vals, idx = topk_search(q, block, k=local, block_size=block_size)
    _pv, pidx = _merge_pool(vals, idx, sh, pool)
    return _cosine_rerank_sharded(pidx, q, block, sh, k)


def _quantized_shard(q, gal_i8, gal_scale, block, sh: _Shard, k: int,
                     block_size: int, rerank_mult: int):
    """Cosine top-k from this rank's int8 copy; the stage is row 3′ on the
    card."""
    pool = min(max(k * rerank_mult, k), sh.n)
    local = min(pool, sh.per)
    if bucket_topk_supported(sh.per, local):
        q_i8, q_scale = quantize_queries(q)
        vals, idx = bucket_topk_int8(q_i8, q_scale, gal_i8, gal_scale, local)
    else:
        vals, idx = topk_search(q, block, k=local, block_size=block_size)
    _pv, pidx = _merge_pool(vals, idx, sh, pool)
    return _cosine_rerank_sharded(pidx, q, block, sh, k)


def _poincare_fast_shard(q, gal: PoincareGallery, block, sh: _Shard, k: int,
                         c: float, block_size: int, rerank_mult: int):
    """Poincaré top-k from this rank's int8 ball copy; the stage is row 4
    on the card."""
    pool = min(max(k * rerank_mult, k), sh.n)
    local = min(pool, sh.per)
    if bucket_topk_supported(sh.per, local):
        vals, idx = bucket_topk_poincare(q, gal, local)
    else:
        vals, idx = topk_search(q, block, k=local, block_size=block_size,
                                similarity="poincare", c=c)
    _pv, pidx = _merge_pool(vals, idx, sh, pool)
    return _poincare_rerank_sharded(pidx, q, block, sh, k, c)


def _block(x, sh: _Shard, device, dtype=None) -> torch.Tensor:
    """This rank's rows of a full array (numpy or a tensor) on
    ``device``."""
    return torch.as_tensor(x[sh.start:sh.stop], dtype=dtype, device=device)


def sharded_topk_search(mesh, queries, gallery, k: int = 10,
                        similarity: str = "cosine", block_size: int = 8192,
                        c: float = 1.0, axis: str = "data"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the gallery's rows in blocks over ``mesh[axis]``:
    each rank scans its block (``topk_search``) for k candidates, and one
    all-gather merges them.  Every rank passes the same queries and the
    whole gallery and keeps only its block; every rank gets the answer
    (scores [Q, k], indices [Q, k]) on its device."""
    sh = _shard_of(mesh, axis, gallery.shape[0])
    dev = mesh_device(mesh)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return _scan_shard(q, _block(gallery, sh, dev, torch.float32), sh, k,
                       block_size, similarity, c)


def sharded_topk_search_cosine_fast(mesh, queries, gal_bf16, valid,
                                    gallery_f32, k: int = 10,
                                    block_size: int = 8192,
                                    rerank_mult: int = DEFAULT_RERANK_MULT,
                                    axis: str = "data"
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_search_cosine_fast`` with the gallery's rows in blocks over
    ``mesh[axis]`` (``gal_bf16`` / ``valid`` from
    ``prepare_cosine_gallery_bf16``): each rank's bucketed bf16 stage over
    its block (row 3 on the card), the merge, the exact f32 re-rank over
    the blocks.  Each rank keeps only its block of the arguments."""
    n = gal_bf16.shape[0]
    sh = _shard_of(mesh, axis, n)
    dev = mesh_device(mesh)
    gal16 = _pad_rows(pad_columns(_block(gal_bf16, sh, dev)), sh.per)
    vmask = _pad_rows(_block(valid, sh, dev, torch.float32), sh.per)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return _cosine_fast_shard(q, gal16, vmask,
                              _block(gallery_f32, sh, dev, torch.float32),
                              sh, k, block_size, rerank_mult)


def sharded_topk_search_quantized(mesh, queries, gal_i8, gal_scale,
                                  gallery_f32, k: int = 10,
                                  block_size: int = 8192,
                                  rerank_mult: int = DEFAULT_RERANK_MULT,
                                  axis: str = "data"
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_search_quantized`` with the int8 gallery's rows in blocks
    over ``mesh[axis]``: each rank's int8 stage (row 3′ on the card), the
    merge, the exact f32 re-rank over the blocks."""
    sh = _shard_of(mesh, axis, gal_i8.shape[0])
    dev = mesh_device(mesh)
    i8 = _pad_rows(pad_columns(_block(gal_i8, sh, dev)), sh.per)
    scale = _pad_rows(_block(gal_scale, sh, dev, torch.float32), sh.per)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return _quantized_shard(q, i8, scale,
                            _block(gallery_f32, sh, dev, torch.float32),
                            sh, k, block_size, rerank_mult)


def _pad_poincare(gal: PoincareGallery, rows: int) -> PoincareGallery:
    """A prepared ball gallery padded to ``rows`` rows with w = 0 (never
    chosen) and to the kernel's columns."""
    return PoincareGallery(_pad_rows(pad_columns(gal.gal_i8), rows),
                           *(_pad_rows(t, rows) for t in gal[1:]))


def _poincare_block(gal: PoincareGallery, sh: _Shard, dev) -> PoincareGallery:
    """This rank's rows of a prepared ball gallery, padded to ``per``."""
    return _pad_poincare(PoincareGallery(*(_block(t, sh, dev) for t in gal)),
                         sh.per)


def sharded_topk_search_poincare_fast(mesh, queries, gal: PoincareGallery,
                                      gallery_f32, k: int = 10,
                                      c: float = 1.0, block_size: int = 8192,
                                      rerank_mult: int = POINCARE_RERANK_MULT,
                                      axis: str = "data"
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_search_poincare_fast`` with the int8 ball gallery's rows in
    blocks over ``mesh[axis]``: each rank's surrogate stage (row 4 on the
    card), the merge, the exact f64 re-rank over the blocks."""
    sh = _shard_of(mesh, axis, gal.gal_i8.shape[0])
    dev = mesh_device(mesh)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return _poincare_fast_shard(q, _poincare_block(gal, sh, dev),
                                _block(gallery_f32, sh, dev, torch.float32),
                                sh, k, c, block_size, rerank_mult)


def _default_device(embeddings) -> torch.device:
    """A tensor's own device; for anything else the card, which must be
    there (pass ``device="cpu"`` for the CPU)."""
    if isinstance(embeddings, torch.Tensor):
        return embeddings.device
    if not torch.cuda.is_available():
        raise RuntimeError("EmbeddingIndex: no CUDA card is visible; pass "
                           "device='cpu' to index on the CPU")
    return torch.device("cuda")


# the requests a sharded index's leader sends its followers (``follow``)
_STOP, _SEARCH, _ROW = 0, 1, 2


class EmbeddingIndex:
    """In-memory exact index, cosine, dot product or Poincaré (curvature
    ``c``), on one device or with its rows in blocks over ``mesh[axis]``; persistence
    matches the reference's ``.npy`` + names-JSON layout.

    ``device``: where the gallery lives; by default a tensor's own device
    and the card for a numpy array (with a mesh, the rank's device).
    ``quantized=True``: the gallery also lives as per-row int8 (cosine:
    ``quantize_gallery``; Poincaré: ``prepare_poincare_gallery``, with its
    three f32 row terms), and searches take their candidates from it
    (``topk_search_quantized``, ``topk_search_poincare_fast``); the f32
    copy stays for the re-rank and persistence.

    ``mesh``: every rank of the axis builds the index from the same
    arguments and keeps a copy of only its block of rows (``embeddings``
    is then the block, ``offset`` its first row); the argument may be the
    whole gallery or this rank's block alone (rows ``RowBlocks(axis).
    bounds(mesh, len(names))``), so that no rank need hold the whole
    gallery.  ``search``, ``row``, ``save`` and
    ``to_feature_dict`` are collective: every rank of the axis calls them
    with the same arguments, or the axis's rank 0 calls them between
    ``lead()`` and ``release()`` while the others run ``follow()``.
    Routing is JAX's: the sharded candidate paths where the pool
    (``rerank_mult``·k) is smaller than the gallery, the sharded scan
    otherwise."""

    def __init__(self, embeddings, names: list[str],
                 similarity: str = "cosine", c: float = 1.0,
                 device: torch.device | str | None = None,
                 quantized: bool = False, mesh=None, axis: str = "data"):
        if similarity not in SIMILARITIES:
            raise ValueError(f"unknown similarity {similarity!r} (one of "
                             f"{SIMILARITIES})")
        if quantized and similarity == "dot":
            raise ValueError(
                "quantized index supports cosine and poincare only")
        n, rows = len(names), int(embeddings.shape[0])
        shard = _shard_of(mesh, axis, n) if mesh is not None else None
        if rows != n and (shard is None or rows != shard.stop - shard.start):
            raise ValueError(f"names ({n}) and embeddings ({rows}) disagree")
        self.mesh, self.axis = mesh, axis
        if device is None:
            device = (mesh_device(mesh) if mesh is not None
                      else _default_device(embeddings))
        self.device = torch.device(device)
        self.names = list(names)
        self.similarity = similarity
        self.c = c
        self.quantized = quantized
        self._leading = False
        self.offset = 0
        self.embeddings = torch.as_tensor(
            embeddings if shard is None or rows != n else
            embeddings[shard.start:shard.stop], dtype=torch.float32,
            device=self.device)
        if shard is not None:
            self._shard, self.offset = shard, shard.start
            # a copy: a slice of the caller's gallery would hold its whole
            # storage (or its numpy buffer) on this rank
            self.embeddings = self.embeddings.clone()
        rows = self._shard.per if mesh is not None else len(self.names)
        # the candidate copies are zero-padded to the kernels' multiple of
        # columns (topk_kernel.pad_columns) once, here, and a shard's to
        # ``per`` rows that the stage never chooses; searches pad the
        # queries after normalizing or quantizing them
        if quantized and similarity == "poincare":
            self.emb_gal = _pad_poincare(
                prepare_poincare_gallery(self.embeddings, c), rows)
        elif quantized:
            i8, scale = quantize_gallery(self.embeddings.cpu().numpy())
            self.emb_i8 = _pad_rows(pad_columns(
                torch.from_numpy(i8).to(self.device)), rows)
            self.emb_scale = _pad_rows(torch.from_numpy(scale).to(
                self.device), rows)
        # bf16 candidate copy for the kernel path, built on the first
        # search that takes it (full-ranking callers never pay for it)
        self._gal16 = None
        self._gal16_valid = None

    def __len__(self) -> int:
        return len(self.names)

    def _bf16_copy(self, rows: int):
        if self._gal16 is None:
            gal16, valid = prepare_cosine_gallery_bf16(self.embeddings)
            self._gal16 = _pad_rows(pad_columns(gal16), rows)
            self._gal16_valid = _pad_rows(valid, rows)
        return self._gal16, self._gal16_valid

    def search(self, queries, k: int = 10, block_size: int = 8192
               ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (scores [Q, k], indices [Q, k]) best-first."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        k = min(k, len(self.names))
        if self.mesh is not None:
            if self._leading:
                self._announce(_SEARCH, k, block_size, q)
            vals, idx = self._search_sharded(q, k, block_size)
        elif self.similarity == "poincare":
            if self.quantized:
                vals, idx = topk_search_poincare_fast(
                    q, self.emb_gal, self.embeddings, k=k, c=self.c,
                    block_size=block_size)
            else:
                vals, idx = topk_search(q, self.embeddings, k=k,
                                        block_size=block_size,
                                        similarity="poincare", c=self.c)
        elif self.quantized:
            vals, idx = topk_search_quantized(
                q, self.emb_i8, self.emb_scale, self.embeddings, k=k,
                block_size=block_size)
        elif self.similarity == "cosine" and fused_cosine_eligible(
                len(self.names), k, self.device):
            gal16, valid = self._bf16_copy(len(self.names))
            vals, idx = topk_search_cosine_fast(
                q, gal16, valid, self.embeddings, k=k, block_size=block_size)
        else:
            vals, idx = topk_search(q, self.embeddings, k=k,
                                    block_size=block_size,
                                    similarity=self.similarity)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _search_sharded(self, q, k: int, block_size: int):
        """JAX's routing over the mesh: the candidate paths (rows 3, 3′, 4
        on the card) where the pool is smaller than the gallery, the
        sharded scan otherwise."""
        sh, n = self._shard, len(self.names)
        narrows = k * DEFAULT_RERANK_MULT < n
        if self.quantized and self.similarity == "poincare" \
                and k * POINCARE_RERANK_MULT < n:
            return _poincare_fast_shard(q, self.emb_gal, self.embeddings, sh,
                                        k, self.c, block_size,
                                        POINCARE_RERANK_MULT)
        if self.quantized and self.similarity == "cosine" and narrows:
            return _quantized_shard(q, self.emb_i8, self.emb_scale,
                                    self.embeddings, sh, k, block_size,
                                    DEFAULT_RERANK_MULT)
        if self.similarity == "cosine" and narrows:
            gal16, valid = self._bf16_copy(sh.per)
            return _cosine_fast_shard(q, gal16, valid, self.embeddings, sh,
                                      k, block_size, DEFAULT_RERANK_MULT)
        return _scan_shard(q, self.embeddings, sh, k, block_size,
                           self.similarity, self.c)

    def row(self, i: int) -> np.ndarray:
        """Gallery row ``i`` (f32 numpy); collective on a sharded index."""
        if self.mesh is None:
            return self.embeddings[i].detach().cpu().numpy()
        if self._leading:
            self._announce(_ROW, i, 0)
        sh = self._shard
        out = torch.zeros(self.embeddings.shape[1], device=self.device)
        if sh.start <= i < sh.stop:
            out += self.embeddings[i - sh.start]
        dist.all_reduce(out, group=sh.group)
        return out.cpu().numpy()

    # -------------------------------------------- serving a sharded index
    def _announce(self, op: int, a: int, b: int, q=None) -> None:
        """The leader's request to the followers: [op, a, b, rows, cols],
        then the query rows."""
        shape = q.shape if q is not None else (0, 0)
        head = torch.tensor([op, a, b, *shape], dtype=torch.long,
                            device=self.device)
        src = dist.get_global_rank(self._shard.group, 0)
        dist.broadcast(head, src, group=self._shard.group)
        if q is not None:
            dist.broadcast(q.contiguous(), src, group=self._shard.group)

    def lead(self) -> None:
        """On the axis's rank 0: from now on each search or row request
        is first sent to the followers."""
        if self.mesh is None or dist.get_rank(self._shard.group) != 0:
            raise RuntimeError("lead() is for rank 0 of a sharded index")
        self._leading = True

    def release(self) -> None:
        """On the leader: stop the followers' loops."""
        if self._leading:
            self._announce(_STOP, 0, 0)
            self._leading = False

    def follow(self) -> int:
        """On the axis's other ranks: take part in each request the leader
        sends until it releases them; returns the requests served."""
        src = dist.get_global_rank(self._shard.group, 0)
        served = 0
        while True:
            head = torch.empty(5, dtype=torch.long, device=self.device)
            dist.broadcast(head, src, group=self._shard.group)
            op, a, b, rows, cols = head.tolist()
            if op == _STOP:
                return served
            if op == _SEARCH:
                q = torch.empty(rows, cols, device=self.device)
                dist.broadcast(q, src, group=self._shard.group)
                self.search(q, k=a, block_size=b)
            else:
                self.row(a)
            served += 1

    # -------------------------------------------------------- persistence
    def _full_embeddings(self) -> torch.Tensor:
        """The whole f32 gallery (gathered from the blocks on a sharded
        index: collective)."""
        if self.mesh is None:
            return self.embeddings
        sh = self._shard
        return all_gather_rows(_pad_rows(self.embeddings, sh.per),
                               sh.group)[:sh.n]

    def search_names(self, queries, k: int = 10
                     ) -> list[list[tuple[str, float]]]:
        """Per query: [(gallery name, score), ...] best-first."""
        vals, idx = self.search(queries, k=k)
        return [[(self.names[j], float(v)) for j, v in zip(row_i, row_v)]
                for row_i, row_v in zip(idx, vals)]

    def save(self, prefix: str) -> None:
        """Save as ``{prefix}.npy`` + ``{prefix}.json`` (a sharded index:
        the whole index, written by the axis's rank 0)."""
        emb = self._full_embeddings().cpu().numpy()
        if self.mesh is not None and dist.get_rank(self._shard.group) != 0:
            return
        np.save(f"{prefix}.npy", emb)
        with open(f"{prefix}.json", "w") as f:
            json.dump(self.names, f)

    @classmethod
    def load(cls, prefix: str, **kwargs) -> "EmbeddingIndex":
        emb = np.load(f"{prefix}.npy")
        with open(f"{prefix}.json") as f:
            names = json.load(f)
        return cls(emb, names, **kwargs)

    def to_feature_dict(self, basename_keys: bool = True
                        ) -> dict[str, np.ndarray]:
        """{figure name: f32 numpy row}, the reference's per-figure
        embedding pickle schema (graph generation cell 17), which the
        feature-matrix builder and the fine-tune's alignment read."""
        emb = self._full_embeddings().cpu().numpy()
        keyfn = os.path.basename if basename_keys else (lambda s: s)
        return {keyfn(n): emb[i] for i, n in enumerate(self.names)}

    def save_feature_pickle(self, path: str, basename_keys: bool = True
                            ) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_feature_dict(basename_keys), f)
