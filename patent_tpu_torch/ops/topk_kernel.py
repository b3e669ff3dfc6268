"""Bucketed top-2 cosine candidate stage (port of the bf16 and int8 parts
of patent_tpu/ops/topk_kernel.py).

``bucket_topk_bf16`` streams the L2-normalized bf16 gallery against the
queries, ``bucket_topk_int8`` the per-row quantized int8 gallery against
int8 queries; each returns the top ``pool`` of the 2·``buckets``
per-bucket candidates, and the caller re-ranks them exactly in f32.  On a
CUDA tensor each launches the hand-written kernel (csrc/bucket_topk.cu);
on a CPU tensor each runs its plain version below.

Semantics differ from the TPU kernel in one way, deliberately: for
n > 2·buckets the TPU kernel keeps one winner per bucket in each 2048-row
step, so it guarantees only ``buckets`` candidates; here every (query,
bucket) keeps the exact top-2 over the whole gallery, so the capacity is
min(n, 2·buckets) at every n.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .common import check_cuda_tensor
from .quant_matmul import int_mm

_P, _I = _build.P, _build.I
_SIG = [_P, _I, _P, _P, _I, _I, _I, _I] + [_P] * 8 + [_P]   # both entries
_BQ, _BB = 64, 32   # queries and buckets per block (csrc/bucket_topk.cu)
BUCKETS = 1024      # gallery column j falls in bucket j mod BUCKETS


def prepare_cosine_gallery_bf16(embeddings: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-time index-build transform: gallery [N, D] → (L2-normalized
    bf16 rows [N, D], valid-row mask [N] f32 of ones)."""
    g = embeddings.float()
    gn = g / g.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return (gn.to(torch.bfloat16).contiguous(),
            torch.ones(g.shape[0], dtype=torch.float32, device=g.device))


def bucket_topk_supported(n: int, pool: int) -> bool:
    """Whether the candidate capacity, min(n, 2·BUCKETS), covers a
    ``pool``-deep request."""
    return pool <= min(n, 2 * BUCKETS)


def _bucket_top2_of_scores(s: torch.Tensor, buckets: int):
    """Exact per-bucket top-2 of a [Q, N] score matrix (-inf: never
    chosen): (v1, i1, v2, i2), each [Q, buckets]; ties go to the lower
    column, empty slots are (-inf, 0)."""
    nq, n = s.shape
    steps = -(-n // buckets)
    s = torch.nn.functional.pad(s, (0, steps * buckets - n),
                                value=float("-inf"))
    s = s.view(nq, steps, buckets)
    base = torch.arange(buckets, device=s.device)
    v1, t1 = s.max(dim=1)                 # first maximum: the lower column
    s = s.scatter(1, t1[:, None, :], float("-inf"))
    v2, t2 = s.max(dim=1)
    ninf = float("-inf")
    i1 = torch.where(v1 == ninf, 0, t1 * buckets + base).to(torch.int32)
    i2 = torch.where(v2 == ninf, 0, t2 * buckets + base).to(torch.int32)
    return v1, i1, v2, i2


def bucket_top2_plain(q16: torch.Tensor, gal16: torch.Tensor,
                      valid: torch.Tensor, buckets: int = BUCKETS):
    """Exact per-bucket top-2 of the bf16 scores in plain PyTorch: (v1,
    i1, v2, i2), each [Q, buckets]; ties go to the lower column, empty
    slots are (-inf, 0)."""
    s = q16.float() @ gal16.float().T
    return _bucket_top2_of_scores(
        s.masked_fill(valid[None, :] <= 0, float("-inf")), buckets)


def bucket_top2_int8_plain(q_i8: torch.Tensor, gal_i8: torch.Tensor,
                           gal_scale: torch.Tensor, buckets: int = BUCKETS):
    """The int8 kernel's (v1, i1, v2, i2) in plain PyTorch: scores
    ``f32(int32 q·g) * gal_scale``, -inf where the scale is <= 0.  The
    integer products are exact, so the kernel must equal this."""
    s = int_mm(q_i8, gal_i8) * gal_scale
    return _bucket_top2_of_scores(
        s.masked_fill(gal_scale[None, :] <= 0, float("-inf")), buckets)


def _bucket_top2_cuda(q, gal, valid, buckets: int = BUCKETS):
    """The kernel's (v1, i1, v2, i2), as ``bucket_top2_plain`` (bf16 q and
    gallery, ``valid`` the 0/1 row mask) or ``bucket_top2_int8_plain``
    (int8, ``valid`` the row scales) returns them."""
    int8 = q.dtype == torch.int8
    dtype = torch.int8 if int8 else torch.bfloat16
    check_cuda_tensor("queries", q, dtype)
    check_cuda_tensor("gallery", gal, dtype)
    check_cuda_tensor("valid", valid, torch.float32, (gal.shape[0],))
    nq, d = q.shape
    n = gal.shape[0]
    if d % (32 if int8 else 16) or d != gal.shape[1] or buckets % _BB:
        raise ValueError(f"bucket kernel needs D % {32 if int8 else 16} == 0 "
                         f"(got {d}, gallery {gal.shape[1]}) and buckets % "
                         f"{_BB} == 0")
    if n >= 2 ** 31 or nq * buckets >= 2 ** 31:
        raise ValueError("gallery or query count too large for int32 indices")
    dev = q.device
    # split the gallery walk until ~4 blocks per SM are in flight
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = -(-n // buckets)
    blocks = (buckets // _BB) * (-(-nq // _BQ))
    splits = max(1, min(steps, -(-4 * sms // blocks)))
    part = [torch.empty(splits, nq, buckets, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out = [torch.empty(nq, buckets, dtype=dt, device=dev)
           for dt in (torch.float32, torch.int32) * 2]
    _build.call("ptt_bucket_top2_i8" if int8 else "ptt_bucket_top2", _SIG,
                _build.ptr(q), nq, _build.ptr(gal), _build.ptr(valid), n, d,
                buckets, splits, *map(_build.ptr, part),
                *map(_build.ptr, out), _build.stream(dev))
    return tuple(out)


def _check_pool(n: int, pool: int) -> None:
    if not bucket_topk_supported(n, pool):
        raise ValueError(f"pool={pool} exceeds candidate capacity "
                         f"{min(n, 2 * BUCKETS)} (N={n})")


def _query_bf16(queries: torch.Tensor, n: int, pool: int) -> torch.Tensor:
    """Check the pool against the capacity; queries normalized in f32,
    then cast to bf16."""
    _check_pool(n, pool)
    qf = queries.float()
    return (qf / qf.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(
        torch.bfloat16).contiguous()


def _select_pool(v1, i1, v2, i2, pool: int, row_scale=None):
    """Top ``pool`` of the 2L candidates (glue outside the kernel body, as
    in the TPU wrapper), after multiplying by the per-query ``row_scale``
    where given; the stable sort keeps ``lax.top_k``'s lower-position
    tie-break."""
    vals2 = torch.cat([v1, v2], dim=1)
    if row_scale is not None:
        vals2 = vals2 * row_scale
    idx2 = torch.cat([i1, i2], dim=1).long()
    vals, pos = torch.sort(vals2, dim=1, descending=True, stable=True)
    pos = pos[:, :pool]
    return vals[:, :pool], torch.gather(idx2, 1, pos)


def bucket_topk_bf16_plain(queries: torch.Tensor, gal_bf16: torch.Tensor,
                           valid: torch.Tensor, pool: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bucket_topk_bf16``, on any device."""
    q16 = _query_bf16(queries, gal_bf16.shape[0], pool)
    return _select_pool(*bucket_top2_plain(q16, gal_bf16, valid), pool)


def bucket_topk_bf16(queries: torch.Tensor, gal_bf16: torch.Tensor,
                     valid: torch.Tensor, pool: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool`` bf16-cosine candidates over the whole gallery.

    queries [Q, D] (normalized in f32 here, then cast to bf16); ``gal_bf16``
    / ``valid`` from ``prepare_cosine_gallery_bf16``.  Returns (vals
    [Q, pool] f32 on the bf16-score scale, idx [Q, pool] int64) best-first,
    ties to the lower candidate position.  Callers re-rank in f32.
    CPU tensors: the plain version; CUDA tensors: the kernel, or an error."""
    if queries.device.type == "cpu":
        return bucket_topk_bf16_plain(queries, gal_bf16, valid, pool)
    q16 = _query_bf16(queries, gal_bf16.shape[0], pool)
    top2 = _bucket_top2_cuda(q16, gal_bf16, valid)
    bucket_topk_bf16.launches += 1
    return _select_pool(*top2, pool)


bucket_topk_bf16.launches = 0


def quantize_gallery(embeddings) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of the L2-normalized gallery
    rows → (int8 [N, D], f32 [N] scales), on the host in numpy, with the
    JAX package's exact arithmetic (patent_tpu/retrieval/index.py)."""
    emb = np.asarray(embeddings, np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    scale = np.maximum(np.abs(emb).max(axis=-1), 1e-8) / 127.0
    q = np.clip(np.round(emb / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_queries(queries: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries normalized in f32 and row-quantized: (int8 [Q, D], f32
    [Q, 1] scale), ``clip(round(qn / s), -127, 127)`` with
    ``s = max(max|qn|, 1e-8) / 127``."""
    qf = queries.float()
    qn = qf / qf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = qn.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return (torch.round(qn / scale).clamp(-127, 127).to(torch.int8)
            .contiguous(), scale)


def bucket_topk_int8_plain(q_i8: torch.Tensor, q_scale: torch.Tensor,
                           gal_i8: torch.Tensor, gal_scale: torch.Tensor,
                           pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bucket_topk_int8``, on any device."""
    _check_pool(gal_i8.shape[0], pool)
    return _select_pool(*bucket_top2_int8_plain(q_i8, gal_i8, gal_scale),
                        pool, q_scale)


def bucket_topk_int8(q_i8: torch.Tensor, q_scale: torch.Tensor,
                     gal_i8: torch.Tensor, gal_scale: torch.Tensor,
                     pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool`` int8-cosine candidates over the whole gallery.

    q_i8 [Q, D] int8 and q_scale [Q, 1] f32 (``quantize_queries``); gal_i8
    [N, D] int8 and gal_scale [N] f32 (``quantize_gallery``; a row with a
    scale <= 0 is never chosen).  Returns (vals [Q, pool] f32 on the
    ``acc · q_scale · gal_scale`` scale, idx [Q, pool] int64) best-first,
    ties to the lower candidate position.  Callers re-rank in f32.  CPU
    tensors: the plain version; CUDA tensors: the kernel, or an error."""
    if q_i8.device.type == "cpu":
        return bucket_topk_int8_plain(q_i8, q_scale, gal_i8, gal_scale, pool)
    _check_pool(gal_i8.shape[0], pool)
    top2 = _bucket_top2_cuda(q_i8, gal_i8, gal_scale)
    bucket_topk_int8.launches += 1
    return _select_pool(*top2, pool, q_scale)


bucket_topk_int8.launches = 0
