"""Bucketed top-2 cosine candidate stage (port of the bf16 part of
patent_tpu/ops/topk_kernel.py).

``bucket_topk_bf16`` streams the L2-normalized bf16 gallery against the
queries and returns the top ``pool`` of the 2·``buckets`` per-bucket
candidates; the caller re-ranks them exactly in f32.  On a CUDA tensor it
launches the hand-written kernel (csrc/bucket_topk.cu); on a CPU tensor it
runs the plain version below.

Semantics differ from the TPU kernel in one way, deliberately: for
n > 2·buckets the TPU kernel keeps one winner per bucket in each 2048-row
step, so it guarantees only ``buckets`` candidates; here every (query,
bucket) keeps the exact top-2 over the whole gallery, so the capacity is
min(n, 2·buckets) at every n.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import check_cuda_tensor

_P, _I = _build.P, _build.I
_SIG = [_P, _I, _P, _P, _I, _I, _I, _I] + [_P] * 8 + [_P]
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


def bucket_top2_plain(q16: torch.Tensor, gal16: torch.Tensor,
                      valid: torch.Tensor, buckets: int = BUCKETS):
    """Exact per-bucket top-2 in plain PyTorch: (v1, i1, v2, i2), each
    [Q, buckets]; ties go to the lower column, empty slots are (-inf, 0)."""
    n = gal16.shape[0]
    nq = q16.shape[0]
    steps = -(-n // buckets)
    s = q16.float() @ gal16.float().T
    s = s.masked_fill(valid[None, :] <= 0, float("-inf"))
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


def _bucket_top2_cuda(q16, gal16, valid, buckets: int = BUCKETS):
    """The kernel's (v1, i1, v2, i2), as ``bucket_top2_plain`` returns."""
    check_cuda_tensor("queries", q16, torch.bfloat16)
    check_cuda_tensor("gallery", gal16, torch.bfloat16)
    check_cuda_tensor("valid", valid, torch.float32, (gal16.shape[0],))
    nq, d = q16.shape
    n = gal16.shape[0]
    if d % 16 or d != gal16.shape[1] or buckets % _BB:
        raise ValueError(f"bucket kernel needs D % 16 == 0 (got {d}, "
                         f"gallery {gal16.shape[1]}) and buckets % {_BB} == 0")
    if n >= 2 ** 31 or nq * buckets >= 2 ** 31:
        raise ValueError("gallery or query count too large for int32 indices")
    dev = q16.device
    # split the gallery walk until ~4 blocks per SM are in flight
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = -(-n // buckets)
    blocks = (buckets // _BB) * (-(-nq // _BQ))
    splits = max(1, min(steps, -(-4 * sms // blocks)))
    part = [torch.empty(splits, nq, buckets, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out = [torch.empty(nq, buckets, dtype=dt, device=dev)
           for dt in (torch.float32, torch.int32) * 2]
    _build.call("ptt_bucket_top2", _SIG, _build.ptr(q16), nq,
                _build.ptr(gal16), _build.ptr(valid), n, d, buckets, splits,
                *map(_build.ptr, part), *map(_build.ptr, out),
                _build.stream(dev))
    return tuple(out)


def _query_bf16(queries: torch.Tensor, n: int, pool: int) -> torch.Tensor:
    """Check the pool against the capacity; queries normalized in f32,
    then cast to bf16."""
    if not bucket_topk_supported(n, pool):
        raise ValueError(f"pool={pool} exceeds candidate capacity "
                         f"{min(n, 2 * BUCKETS)} (N={n})")
    qf = queries.float()
    return (qf / qf.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(
        torch.bfloat16).contiguous()


def _select_pool(v1, i1, v2, i2, pool: int):
    """Top ``pool`` of the 2L candidates (glue outside the kernel body, as
    in the TPU wrapper); the stable sort keeps ``lax.top_k``'s
    lower-position tie-break."""
    vals2 = torch.cat([v1, v2], dim=1)
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
