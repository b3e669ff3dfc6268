"""The cosine bucket kernels' walk (csrc/bucket_topk.cu: a fold with a
strict '>' over contiguous step ranges, then a merge of the ranges' lists
in (score desc, column asc) order), modelled step by step in
``topk_kernel.bucket_top2_walk`` and held to the plain per-bucket top-2 on
scores full of ties and empty rows, at the split counts the kernel's plan
takes; and the controls that ``chip_smoke.py`` uses: a fold with '>=' and
a fold that drops a step must each be told apart from the plain answer."""

import numpy as np
import pytest
import torch

from patent_tpu_torch.ops import topk_kernel as tk


def _scores(nq, n, seed, levels=7):
    """Scores on a few levels, so that most (query, bucket) lists hold ties
    across steps, with about a tenth of the rows empty (-inf)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, levels, size=(nq, n)).astype(np.float32)
    s[:, rng.random(n) < 0.1] = -np.inf
    return torch.from_numpy(s)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("nq,n,buckets", [(3, 700, 64), (5, 5000, 64),
                                          (2, 5000, 1024), (1, 70000, 1024)])
def test_walk_equals_the_plain_top2(nq, n, buckets, splits):
    s = _scores(nq, n, seed=n + splits)
    splits = min(splits, -(-n // buckets))
    got = tk.bucket_top2_walk(s, buckets, splits)
    want = tk._bucket_top2_of_scores(s, buckets)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("splits", [1, 2])
def test_walk_controls_fail_the_tie_and_pool_checks(splits):
    """'>=' keeps the later of two tied columns, so the columns differ
    where the plain answer keeps the earlier (a range must hold several
    steps for two of them to tie); dropping a step loses its candidates,
    so the 2L-deep pool differs."""
    s = _scores(4, 5000, seed=11)
    want = tk._bucket_top2_of_scores(s, 1024)
    ties = tk.bucket_top2_walk(s, 1024, splits, strict=False)
    assert torch.equal(ties[0], want[0]) and torch.equal(ties[2], want[2])
    assert not torch.equal(ties[1], want[1])
    dropped = tk.bucket_top2_walk(s, 1024, splits, skip=2)
    pool = tk._select_pool(*want, 2048)[1].sort(dim=1).values
    pool_dropped = tk._select_pool(*dropped, 2048)[1].sort(dim=1).values
    assert not torch.equal(pool, pool_dropped)


def test_walk_on_real_scores_equals_the_plain_stage():
    """On bf16 cosine scores with an exact duplicate in one bucket and
    invalid rows, as the card tests build them."""
    g = torch.Generator().manual_seed(4)
    gal = torch.randn(5000, 64, generator=g)
    gal[3000] = gal[1976]                    # same bucket (mod 1024)
    q = torch.randn(70, 64, generator=g)
    q[0] = gal[1976]
    gal16, valid = tk.prepare_cosine_gallery_bf16(gal)
    valid[::97] = 0.0
    q16 = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    s = (q16.float() @ gal16.float().T).masked_fill(valid <= 0,
                                                     float("-inf"))
    got = tk.bucket_top2_walk(s, 1024, splits=3)
    want = tk.bucket_top2_plain(q16, gal16, valid, 1024)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("n,splits", [(700, 1), (5000, 3), (25000, 7),
                                      (24 * 1024, 7), (70000, 3)])
def test_step_requests_bring_each_step_once(n, splits, group):
    """The producer's requests of every split bring each step of its range
    once, in order; a grouped request holds ``group`` whole steps and
    neither crosses the range's end nor reaches the partial last step."""
    steps, whole = -(-n // 1024), n // 1024
    for z in range(splits):
        t0, t1 = z * steps // splits, (z + 1) * steps // splits
        reqs = tk.step_requests(t0, t1, whole, group)
        got = [f + i for f, k, _g in reqs for i in range(k)]
        assert got == list(range(t0, t1))
        for first, k, grouped in reqs:
            assert k == (group if grouped else 1)
            assert not grouped or first + k <= min(t1, whole)


def _poincare_case(n, nq=5, d=32, c=2.0, seed=3):
    """A ball gallery of n rows drawn from three points a bucket (so a
    (query, bucket)'s scores tie across steps), every 97th row masked (w =
    0), and its quantized queries; the Poincaré surrogate's [Q, N] scores
    as bucket_top2_poincare_plain forms them."""
    rng = np.random.default_rng(seed)

    def ball(m):
        v = rng.standard_normal((m, d))
        v *= (0.9 * rng.random((m, 1)) / np.sqrt(c)
              / np.linalg.norm(v, axis=1, keepdims=True))
        return torch.from_numpy(v.astype(np.float32))

    points = ball(3 * 1024).view(1024, 3, d)
    pick = torch.from_numpy(rng.integers(0, 3, n))
    gal = points[torch.arange(n) % 1024, pick]
    pg = tk.prepare_poincare_gallery(gal, c)
    pg.w[::97] = 0.0
    q_i8, qs, q_sq = tk.quantize_poincare_queries(ball(nq))
    s = qs * (tk.int_mm(q_i8, pg.gal_i8) * pg.gw2) - q_sq * pg.w - pg.b
    scores = s.masked_fill(pg.w[None, :] <= 0, float("-inf"))
    return scores, tk.bucket_top2_poincare_plain(q_i8, qs, q_sq, pg)


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_walk_on_poincare_scores_with_grouped_steps(splits):
    """Row 4's walk as the kernel takes it at D 32 (a row of one K-slice:
    four steps a request), over 25,000 rows (24 whole steps and a partial
    last one, so some ranges end in a short or partial group): equal to the
    plain Poincaré stage; a '>=' fold and a dropped step are not."""
    scores, want = _poincare_case(25000)
    got = tk.bucket_top2_walk(scores, 1024, splits, group=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ties = tk.bucket_top2_walk(scores, 1024, splits, strict=False, group=4)
    assert torch.equal(ties[0], want[0])
    assert not torch.equal(ties[1], want[1])
    dropped = tk.bucket_top2_walk(scores, 1024, splits, skip=0, group=4)
    assert not all(torch.equal(a, b) for a, b in zip(dropped, want))
