"""Bucketed top-2 candidate stages (port of patent_tpu/ops/topk_kernel.py).

``bucket_topk_bf16`` streams the L2-normalized bf16 gallery against the
queries, ``bucket_topk_int8`` the per-row quantized int8 gallery against
int8 queries, and ``bucket_topk_poincare`` an int8 Poincaré-ball gallery
against int8 queries, scored by the monotone surrogate of −distance; each
returns the top ``pool`` of the 2·``buckets`` per-bucket candidates, and
the caller re-ranks them exactly.  On a CUDA tensor each launches the
hand-written kernel (csrc/bucket_topk.cu); on a CPU tensor each runs its
plain version below.

Semantics differ from the TPU kernel in one way, deliberately: for
n > 2·buckets the TPU kernel keeps one winner per bucket in each 2048-row
step, so it guarantees only ``buckets`` candidates; here every (query,
bucket) keeps the exact top-2 over the whole gallery, so the capacity is
min(n, 2·buckets) at every n.
"""

from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from .. import _build
from .common import check_cuda_tensor
from .quant_matmul import int_mm

_P, _I = _build.P, _build.I
_SIG = [_P, _I, _P, _P, _I, _I, _I, _I] + [_P] * 8 + [_P]   # bf16 and int8
_SIG_POINCARE = [_P] * 3 + [_I] + [_P] * 4 + [_I] * 4 + [_P] * 9
_SIG_PLAN = [_I] * 5 + [_P]
# buckets a block of the stages (csrc/bucket_topk.cu)
_BLOCK_BUCKETS = 64
# the operand modes of the kernel's split plan (ptt_bucket_top2_plan)
_PLAN_MODES = {"bf16": 0, "int8": 1, "poincare": 2}
BUCKETS = 1024      # gallery column j falls in bucket j mod BUCKETS


# the gallery and query widths the kernels take a multiple of, by operand
# dtype (the Poincaré stage's operands are int8 too)
KERNEL_COLUMNS = {torch.bfloat16: 16, torch.int8: 32}


def pad_columns(t: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """t [N, D] with zero columns appended up to ``width`` (by default the
    next multiple of ``KERNEL_COLUMNS`` for t's dtype), as the JAX wrappers
    pad D.  Exact: a zero column adds 0 to every dot product, so the
    kernels' scores, row terms and rankings are those of the unpadded rows.
    A tensor already that wide is returned as it is."""
    if width is None:
        width = -(-t.shape[1] // KERNEL_COLUMNS[t.dtype]) * \
            KERNEL_COLUMNS[t.dtype]
    extra = width - t.shape[1]
    return torch.nn.functional.pad(t, (0, extra)).contiguous() if extra \
        else t


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


def step_requests(t0: int, t1: int, whole: int,
                  group: int) -> list[tuple[int, int, bool]]:
    """The gallery requests of one split of the bucket kernels' walk over
    steps [t0, t1), in the order the producer sends them, where a request
    of a row of one K-slice brings up to ``group`` steps of a bucket group
    (csrc/bucket_topk.cu): (first step, steps, grouped).  A group of
    ``group`` steps that lies within the ``whole`` steps of N // L comes
    as one request of the [steps][L][D] view (grouped); a short group (the
    end of the range) or one that holds the partial last step comes one
    step a request of the [N][D] view."""
    out = []
    for t in range(t0, t1, group):
        n = min(group, t1 - t)
        if group > 1 and n == group and t + group <= whole:
            out.append((t, n, True))
        else:
            out += [(t + i, 1, False) for i in range(n)]
    return out


def bucket_top2_walk(s: torch.Tensor, buckets: int = BUCKETS,
                     splits: int = 1, strict: bool = True,
                     skip: int | None = None, group: int = 1):
    """The bucket kernels' walk over a [Q, N] score matrix (-inf: never
    chosen), step by step: split z folds steps [z·T/splits, (z+1)·T/splits)
    of the T = ceil(N / buckets) steps, in the order its requests
    (``step_requests`` with ``group`` steps a request) bring them, into
    each (query, bucket)'s (v1, step1, v2, step2) with a strict '>'
    (``strict=False``: '>=', ties to the later column), leaving out step
    ``skip``; then the splits' lists are merged in (score desc, column asc)
    order.  Returns (v1, i1, v2, i2) as ``_bucket_top2_of_scores`` does,
    which it equals when strict and nothing is skipped, at any split count
    and grouping: the model of the kernel that the tests hold to the plain
    version, and its controls."""
    nq, n = s.shape
    steps = -(-n // buckets)
    ninf = float("-inf")
    s = torch.nn.functional.pad(s, (0, steps * buckets - n),
                                value=ninf).view(nq, steps, buckets)
    base = torch.arange(buckets, device=s.device)
    vals, cols = [], []
    for z in range(splits):
        v1 = torch.full((nq, buckets), ninf, device=s.device)
        v2 = v1.clone()
        t1 = torch.zeros(nq, buckets, dtype=torch.int64, device=s.device)
        t2 = t1.clone()
        requests = step_requests(z * steps // splits,
                                 (z + 1) * steps // splits, n // buckets,
                                 group)
        for t in (f + i for f, k, _grouped in requests for i in range(k)):
            if t == skip:
                continue
            v = s[:, t]
            up1 = v > v1 if strict else v >= v1
            up2 = ~up1 & (v > v2 if strict else v >= v2)
            v2 = torch.where(up1, v1, torch.where(up2, v, v2))
            t2 = torch.where(up1, t1, torch.where(up2, t, t2))
            v1 = torch.where(up1, v, v1)
            t1 = torch.where(up1, t, t1)
        vals += [v1, v2]
        cols += [t1 * buckets + base, t2 * buckets + base]
    vals, cols = torch.stack(vals, -1), torch.stack(cols, -1)
    order = torch.argsort(cols, dim=-1, stable=True)
    vals, cols = vals.gather(-1, order), cols.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)[..., :2]
    vals, cols = vals.gather(-1, order), cols.gather(-1, order)
    cols = torch.where(vals == ninf, 0, cols).to(torch.int32)
    return vals[..., 0], cols[..., 0], vals[..., 1], cols[..., 1]


def bucket_top2_int8_plain(q_i8: torch.Tensor, gal_i8: torch.Tensor,
                           gal_scale: torch.Tensor, buckets: int = BUCKETS):
    """The int8 kernel's (v1, i1, v2, i2) in plain PyTorch: scores
    ``f32(int32 q·g) * gal_scale``, -inf where the scale is <= 0.  The
    integer products are exact, so the kernel must equal this."""
    s = int_mm(q_i8, gal_i8) * gal_scale
    return _bucket_top2_of_scores(
        s.masked_fill(gal_scale[None, :] <= 0, float("-inf")), buckets)


def _check_top2_operands(q, gal, valid, buckets: int,
                         block_buckets: int) -> None:
    int8 = q.dtype == torch.int8
    dtype = torch.int8 if int8 else torch.bfloat16
    check_cuda_tensor("queries", q, dtype)
    check_cuda_tensor("gallery", gal, dtype)
    check_cuda_tensor("valid", valid, torch.float32, (gal.shape[0],))
    nq, d = q.shape
    n = gal.shape[0]
    if (d % KERNEL_COLUMNS[dtype] or d != gal.shape[1]
            or buckets % block_buckets):
        raise ValueError(f"bucket kernel needs D % {KERNEL_COLUMNS[dtype]} "
                         f"== 0 (got {d}, gallery {gal.shape[1]}) and "
                         f"buckets % {block_buckets} == 0")
    if n + buckets >= 2 ** 31 or nq * buckets >= 2 ** 31:
        raise ValueError("gallery or query count too large for int32 indices")


def _splits(mode: str, nq: int, n: int, d: int, buckets: int) -> int:
    """The kernel's split count for a call on the current card (its plan,
    one rule for the three operand modes)."""
    splits = ctypes.c_int(0)
    _build.call("ptt_bucket_top2_plan", _SIG_PLAN, nq, n, d, buckets,
                _PLAN_MODES[mode], ctypes.byref(splits))
    return splits.value


def _top2_launch(entry: str, argtypes: list, args: list, nq: int, n: int,
                 d: int, dev, buckets: int, splits: int):
    """Launch a bucket top-2 entry (its leading ``args``, then N, D, L,
    splits and the buffers) and return (v1, i1, v2, i2)."""
    part = [torch.empty(splits, nq, buckets, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * 2]
    out = [torch.empty(nq, buckets, dtype=dt, device=dev)
           for dt in (torch.float32, torch.int32) * 2]
    _build.call(entry, argtypes, *args, n, d, buckets, splits,
                *map(_build.ptr, part), *map(_build.ptr, out),
                _build.stream(dev))
    return tuple(out)


def _bucket_top2_cuda(q, gal, valid, buckets: int = BUCKETS):
    """The kernel's (v1, i1, v2, i2), as ``bucket_top2_plain`` (bf16 q and
    gallery, ``valid`` the 0/1 row mask) or ``bucket_top2_int8_plain``
    (int8, ``valid`` the row scales) returns them."""
    _check_top2_operands(q, gal, valid, buckets, _BLOCK_BUCKETS)
    int8 = q.dtype == torch.int8
    (nq, d), n = q.shape, gal.shape[0]
    entry = "ptt_bucket_top2_i8" if int8 else "ptt_bucket_top2"
    return _top2_launch(entry, _SIG,
                        [_build.ptr(q), nq, _build.ptr(gal),
                         _build.ptr(valid)], nq, n, d, q.device, buckets,
                        _splits("int8" if int8 else "bf16", nq, n, d,
                                buckets))


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
    q16 = pad_columns(_query_bf16(queries, gal_bf16.shape[0], pool),
                      gal_bf16.shape[1])
    return _select_pool(*bucket_top2_plain(q16, gal_bf16, valid), pool)


def bucket_topk_bf16(queries: torch.Tensor, gal_bf16: torch.Tensor,
                     valid: torch.Tensor, pool: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool`` bf16-cosine candidates over the whole gallery.

    queries [Q, D] (normalized in f32 here, then cast to bf16); ``gal_bf16``
    / ``valid`` from ``prepare_cosine_gallery_bf16``.  Returns (vals
    [Q, pool] f32 on the bf16-score scale, idx [Q, pool] int64) best-first,
    ties to the lower candidate position.  Callers re-rank in f32.  A
    gallery wider than the queries (``pad_columns``, as ``EmbeddingIndex``
    builds it) takes the normalized queries zero-padded to its width.
    CPU tensors: the plain version; CUDA tensors: the kernel (D % 16 == 0),
    or an error."""
    if queries.device.type == "cpu":
        return bucket_topk_bf16_plain(queries, gal_bf16, valid, pool)
    q16 = pad_columns(_query_bf16(queries, gal_bf16.shape[0], pool),
                      gal_bf16.shape[1])
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
    q_i8 = pad_columns(q_i8, gal_i8.shape[1])
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
    ties to the lower candidate position.  Callers re-rank in f32.  A
    gallery wider than the queries (``pad_columns``) takes q_i8
    zero-padded to its width.  CPU tensors: the plain version; CUDA
    tensors: the kernel (D % 32 == 0), or an error."""
    if q_i8.device.type == "cpu":
        return bucket_topk_int8_plain(q_i8, q_scale, gal_i8, gal_scale, pool)
    _check_pool(gal_i8.shape[0], pool)
    top2 = _bucket_top2_cuda(pad_columns(q_i8, gal_i8.shape[1]), gal_i8,
                             gal_scale)
    bucket_topk_int8.launches += 1
    return _select_pool(*top2, pool, q_scale)


bucket_topk_int8.launches = 0


# ---------------------------------------------------------------- Poincaré
# The hyperbolic candidate stage ranks gallery rows v for a query u by the
# monotone surrogate of −distance (retrieval/index.py::_scores_block),
#
#     s(v) = w·(2·u·v − |u|²) − |v|²·w,   w = 1/(1 − c·|v|²),
#
# from an int8 gallery with a per-row symmetric scale: the dot product runs
# on int8 operands, and the dequantization folds into the row terms as
# gw2 = 2·scale·w.  The query's scale multiplies only the dot term, and
# |u|²·w mixes query and row, so the kernel scores the whole surrogate:
# s = qs·(acc·gw2) − q_sq·w − b.  Near the boundary (w large) every
# low-precision score loses fine ordering to cancellation, so the caller
# over-fetches a pool and re-ranks it with the exact distance.


class PoincareGallery(typing.NamedTuple):
    """Prepared operands of one ball gallery (``prepare_poincare_gallery``)."""
    gal_i8: torch.Tensor   # [N, D] int8, row-scaled ball points
    gw2: torch.Tensor      # [N] f32, 2 · row_scale · w
    w: torch.Tensor        # [N] f32, 1/(1−c·|v|²); 0 marks a row never chosen
    b: torch.Tensor        # [N] f32, |v|²·w


def _chunk_width(d: int) -> int:
    """Width of the chunks that XLA's CPU row reduction sums one after
    another: 32 where 32 divides the row, else d / p for the fewest p
    chunks of at most 32 where p divides it.  Measured to match at every
    multiple of 32 and at d = 16, 24, 40 and 48; at other widths the sums
    may differ from JAX's in the last bit."""
    p = -(-d // 32)
    return d // p if d % p == 0 else 32


def row_sq_norms(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Σ x² over the last axis in the JAX package's CPU summation order:
    each chunk of ``_chunk_width`` columns summed left to right, then the
    chunk sums left to right.  The Poincaré operands depend on these sums
    through w, so this order makes them equal to JAX's bit for bit.  The
    chunks are summed side by side: a 128-wide row takes 34 additions."""
    width = _chunk_width(x.shape[-1])
    # a ragged last chunk ends in zeros, which change no sum of squares
    sq = torch.nn.functional.pad(x * x, (0, -x.shape[-1] % width))
    chunks = sq.reshape(*sq.shape[:-1], -1, width)      # [..., p, width]
    s = chunks[..., 0]
    for k in range(1, width):
        s = s + chunks[..., k]
    total = s[..., 0]
    for j in range(1, s.shape[-1]):
        total = total + s[..., j]
    return total.unsqueeze(-1) if keepdim else total


def prepare_poincare_gallery(gallery: torch.Tensor,
                             c: float) -> PoincareGallery:
    """One-time index-build transform, on the gallery's device: ball
    points [N, D] → ``PoincareGallery``, row i quantized symmetrically to
    its own max (scaleᵢ = max|vᵢ|/127, round half to even, no clip), with

        gw2ᵢ = 2 · scaleᵢ · wᵢ,   wᵢ = 1/max(1 − c·|vᵢ|², 1e-12),
        bᵢ = |vᵢ|²·wᵢ,

    all from the f32 rows; equal to JAX's bit for bit."""
    g = gallery.float()
    g_sq = row_sq_norms(g)
    w = 1.0 / torch.clamp_min(1.0 - c * g_sq, 1e-12)
    scale = g.abs().amax(dim=-1) / 127.0
    safe = torch.clamp_min(scale, 1e-30)
    gal_i8 = torch.round(g / safe[:, None]).to(torch.int8).contiguous()
    return PoincareGallery(gal_i8, 2.0 * scale * w, w, g_sq * w)


def quantize_poincare_queries(queries: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Per-row symmetric int8 quantization of query ball points → (q_i8
    [Q, D], q_scale [Q, 1] f32, q_sq [Q, 1] f32), q_sq from the f32 rows;
    equal to JAX's bit for bit."""
    qf = queries.float()
    q_sq = row_sq_norms(qf, keepdim=True)
    qscale = qf.abs().amax(dim=-1, keepdim=True) / 127.0
    q_i8 = torch.round(qf / torch.clamp_min(qscale, 1e-30)).to(torch.int8)
    return q_i8.contiguous(), qscale, q_sq


def bucket_top2_poincare_plain(q_i8, qs, q_sq, gal: PoincareGallery,
                               buckets: int = BUCKETS):
    """The Poincaré kernel's (v1, i1, v2, i2) in plain PyTorch: the
    surrogate ``qs * (f32(int32 q·g) * gw2) - q_sq * w - b`` in that
    order, -inf where w <= 0.  Each step rounds once in f32, as the kernel
    does, so the kernel must equal this."""
    gal_i8, gw2, w, b = gal
    s = qs * (int_mm(q_i8, gal_i8) * gw2) - q_sq * w - b
    return _bucket_top2_of_scores(
        s.masked_fill(w[None, :] <= 0, float("-inf")), buckets)


def _bucket_top2_poincare_cuda(q_i8, qs, q_sq, gal: PoincareGallery,
                               buckets: int = BUCKETS):
    """The Poincaré kernel's (v1, i1, v2, i2), as
    ``bucket_top2_poincare_plain`` returns them."""
    gal_i8, gw2, w, b = gal
    _check_top2_operands(q_i8, gal_i8, w, buckets, _BLOCK_BUCKETS)
    (nq, d), n = q_i8.shape, gal_i8.shape[0]
    for name, t, shape in (("q_scale", qs, (nq, 1)), ("q_sq", q_sq, (nq, 1)),
                           ("gw2", gw2, (n,)), ("b", b, (n,))):
        check_cuda_tensor(name, t, torch.float32, shape)
    return _top2_launch("ptt_bucket_top2_poincare", _SIG_POINCARE,
                        [_build.ptr(q_i8), _build.ptr(qs), _build.ptr(q_sq),
                         nq, _build.ptr(gal_i8), _build.ptr(gw2),
                         _build.ptr(w), _build.ptr(b)],
                        nq, n, d, q_i8.device, buckets,
                        _splits("poincare", nq, n, d, buckets))


def _poincare_queries(queries: torch.Tensor, gal: PoincareGallery):
    """``quantize_poincare_queries`` of the unpadded rows, the codes then
    zero-padded to the gallery's width."""
    q_i8, qscale, q_sq = quantize_poincare_queries(queries)
    return pad_columns(q_i8, gal.gal_i8.shape[1]), qscale, q_sq


def bucket_topk_poincare_plain(queries: torch.Tensor, gal: PoincareGallery,
                               pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bucket_topk_poincare``, on any device."""
    _check_pool(gal.gal_i8.shape[0], pool)
    return _select_pool(*bucket_top2_poincare_plain(
        *_poincare_queries(queries, gal), gal), pool)


def bucket_topk_poincare(queries: torch.Tensor, gal: PoincareGallery,
                         pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool`` Poincaré-surrogate candidates over the whole gallery.

    queries [Q, D] f32 ball points (quantized here with
    ``quantize_poincare_queries``); ``gal`` from
    ``prepare_poincare_gallery``.  Returns (vals [Q, pool] f32 on the
    surrogate's scale, idx [Q, pool] int64) best-first, ties to the lower
    candidate position.  Callers re-rank the pool with the exact
    distance.  A gallery wider than the queries (``gal_i8`` through
    ``pad_columns``) takes the codes zero-padded to its width, the row
    terms from the unpadded rows.  CPU tensors: the plain version; CUDA
    tensors: the kernel (D % 32 == 0), or an error."""
    if queries.device.type == "cpu":
        return bucket_topk_poincare_plain(queries, gal, pool)
    _check_pool(gal.gal_i8.shape[0], pool)
    top2 = _bucket_top2_poincare_cuda(*_poincare_queries(queries, gal), gal)
    bucket_topk_poincare.launches += 1
    return _select_pool(*top2, pool)


bucket_topk_poincare.launches = 0
