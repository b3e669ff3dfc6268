"""patent_tpu_torch's Poincaré geometry and its three hyperbolic kernels'
plain versions (on the CPU) held to patent_tpu.

Inputs come from numpy seeds and go through both packages.  The manifold
operations agree to f32 rounding, near the boundary included.  The JAX
Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them: row 17 (``pairwise_dist_pallas``) within 2e-3 atol/rtol and
row 18 (``mobius_dense_pallas``) within 2e-4 atol / 2e-3 rtol, JAX's own
tolerances for them; row 4 (``bucket_topk_poincare``) by pool membership,
with its operands (``prepare_poincare_gallery``,
``quantize_poincare_queries``) equal to JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patent_tpu.ops import pallas_kernels as jax_pk
from patent_tpu.ops import poincare as jax_pm
from patent_tpu.ops import topk_kernel as jax_topk
from patent_tpu_torch.ops import pallas_kernels as torch_pk
from patent_tpu_torch.ops import poincare as torch_pm
from patent_tpu_torch.ops import topk_kernel as torch_topk


def _ball(rng, n, d, c, r_lo=0.05, r_hi=0.95):
    """n points of the ball of curvature c: uniform directions, radii in
    [r_lo, r_hi] of the radius 1/√c."""
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(r_lo, r_hi, (n, 1)) / np.sqrt(c)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# f32 rounding, amplified near the boundary (artanh' = 1/(1-x²) ~ 500 at
# 0.999 of the radius): the two packages' transcendentals and sums differ
# by an ulp or two
ATOL, RTOL = 2e-5, 2e-5


@pytest.fixture(params=[(1.0, 0.95), (2.0, 0.95), (2.0, 0.999)],
                ids=["c1", "c2", "c2-boundary"])
def points(request):
    c, r_hi = request.param
    rng = np.random.default_rng(7)
    return c, _ball(rng, 24, 16, c, r_hi=r_hi), _ball(rng, 24, 16, c,
                                                      r_hi=r_hi)


def test_constants():
    assert torch_pm.MIN_NORM == jax_pm.MIN_NORM
    assert torch_pm.ball_eps(torch.float32) == jax_pm.ball_eps(jnp.float32)
    assert torch_pm.ball_eps(torch.float64) == jax_pm.ball_eps(jnp.float64)


@pytest.mark.parametrize("name", ["expmap0", "logmap0", "project", "dist0"])
def test_pointwise_ops_match_jax(points, name):
    c, x, _y = points
    got = getattr(torch_pm, name)(_t(x), c).numpy()
    want = np.asarray(getattr(jax_pm, name)(jnp.asarray(x), c))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["mobius_add", "dist"])
def test_pair_ops_match_jax(points, name):
    c, x, y = points
    got = getattr(torch_pm, name)(_t(x), _t(y), c).numpy()
    want = np.asarray(getattr(jax_pm, name)(jnp.asarray(x), jnp.asarray(y),
                                           c))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_pairwise_dist_and_broadcast_dist_match_jax(points):
    c, x, y = points
    np.testing.assert_allclose(
        torch_pm.pairwise_dist(_t(x), _t(y), c).numpy(),
        np.asarray(jax_pm.pairwise_dist(jnp.asarray(x), jnp.asarray(y), c)),
        atol=1e-4, rtol=1e-4)
    got = torch_pm.dist(_t(x)[:, None, :], _t(y)[None, :4, :], c,
                        keepdim=True).numpy()
    want = np.asarray(jax_pm.dist(jnp.asarray(x)[:, None, :],
                                  jnp.asarray(y)[None, :4, :], c,
                                  keepdims=True))
    assert got.shape == want.shape == (24, 4, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_smoothed_norm_and_clamps_match_jax():
    x = np.array([[0.0, 0.0], [3e-16, 0.0], [0.6, 0.8]], np.float32)
    np.testing.assert_array_equal(torch_pm._norm(_t(x)).numpy(),
                                  np.asarray(jax_pm._norm(jnp.asarray(x))))
    edge = np.array([-1.0, -0.9999999, 0.0, 0.5, 0.9999999, 1.0, 2.0],
                    np.float32)
    np.testing.assert_allclose(torch_pm.artanh(_t(edge)).numpy(),
                               np.asarray(jax_pm.artanh(jnp.asarray(edge))),
                               rtol=1e-6)
    up = np.array([0.0, 1.0, 1.0000001, 1.5, 40.0], np.float32)
    np.testing.assert_allclose(torch_pm.arcosh(_t(up)).numpy(),
                               np.asarray(jax_pm.arcosh(jnp.asarray(up))),
                               rtol=1e-5, atol=1e-6)


def test_mobius_matvec_and_fn_apply_match_jax(points):
    c, x, _y = points
    rng = np.random.default_rng(3)
    m = (0.3 * rng.standard_normal((12, 16))).astype(np.float32)
    m[5] = 0.0
    xs = x.copy()
    xs[2] = 0.0                                    # the origin
    got = torch_pm.mobius_matvec(_t(m), _t(xs), c).numpy()
    want = np.asarray(jax_pm.mobius_matvec(jnp.asarray(m), jnp.asarray(xs),
                                           c))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # a zero row of M x maps to the origin in both
    zero = np.zeros((16, 16), np.float32)
    assert not torch_pm.mobius_matvec(_t(zero), _t(x), c).any()
    got = torch_pm.mobius_fn_apply(torch.tanh, _t(x), c).numpy()
    want = np.asarray(jax_pm.mobius_fn_apply(jnp.tanh, jnp.asarray(x), c))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.fixture()
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("c", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(40, 30, 16), (100, 300, 64),
                                   (64, 260, 128), (1, 130, 128),
                                   (20, 40, 5)])
def test_pairwise_dist_plain_matches_pallas(interpret, c, shape):
    """Row 17's plain version against the TPU kernel, with a one-figure
    batch and a width whose rows are not 16-byte aligned among the
    shapes (the CUDA kernel's edge cases)."""
    n, m, d = shape
    rng = np.random.default_rng(n + m)
    x, y = _ball(rng, n, d, c), _ball(rng, m, d, c)
    want = np.asarray(jax_pk.pairwise_dist_pallas(
        jnp.asarray(x), jnp.asarray(y), c, block_n=128, block_m=128,
        force=True))
    before = torch_pk.pairwise_dist_pallas.launches
    got = torch_pk.pairwise_dist_pallas(_t(x), _t(y), c)
    assert torch_pk.pairwise_dist_pallas.launches == before   # CPU: plain
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("c", [1.0, 2.0])
@pytest.mark.parametrize("shape,scale", [((100, 48, 24), 0.3),
                                         ((64, 512, 256), 1.0)],
                         ids=["small", "encoder-widths"])
def test_mobius_dense_plain_matches_pallas(interpret, c, shape, scale):
    """At 512 → 256 with unit features the layer saturates at the
    projection radius, as the encoder's first layer does."""
    n, din, dout = shape
    rng = np.random.default_rng(din)
    x = (rng.standard_normal((n, din)) * scale).astype(np.float32)
    w = (rng.standard_normal((din, dout)) * 0.2 / np.sqrt(din / 48)
         ).astype(np.float32)
    bias = np.asarray(jax_pm.expmap0(jnp.asarray(
        rng.standard_normal(dout) * 1e-3, jnp.float32), c))
    want = np.asarray(jax_pk.mobius_dense_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), c, block_n=64,
        force=True))
    got = torch_pk.mobius_dense_pallas(_t(x), _t(w), _t(bias), c)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)
    # and MobiusDense's own jnp composition, which the plain version follows
    h = jax_pm.expmap0(jnp.dot(jnp.asarray(x), jnp.asarray(w),
                               precision=jax.lax.Precision.HIGHEST), c)
    comp = np.asarray(jax_pm.project(jax_pm.mobius_add(h, jnp.asarray(bias),
                                                       c), c))
    np.testing.assert_allclose(got.numpy(), comp, atol=1e-5, rtol=1e-5)
    norms = np.linalg.norm(got.numpy(), axis=-1)
    assert norms.max() <= (1 - 4e-3) / np.sqrt(c) * (1 + 1e-6)


@pytest.mark.parametrize("d", [48, 64, 128])
def test_poincare_operands_equal_jax_bit_for_bit(d):
    c = 2.0
    rng = np.random.default_rng(d)
    gallery = _ball(rng, 2000, d, c, r_hi=0.999)
    gallery[7] = 0.0                   # a zero row: scale 0, w 1
    queries = _ball(rng, 33, d, c)
    want = jax_topk.prepare_poincare_gallery(gallery, c)
    got = torch_topk.prepare_poincare_gallery(_t(gallery), c)
    for name in ("gal_i8", "gw2", "w", "b"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(torch_topk.quantize_poincare_queries(_t(queries)),
                    jax_topk.quantize_poincare_queries(jnp.asarray(queries))):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _f64_topk(q, g, c, k):
    q64, g64 = q.astype(np.float64), g.astype(np.float64)
    diff_sq = np.sum((q64[:, None, :] - g64[None]) ** 2, axis=-1)
    den = ((1 - c * np.sum(q64 * q64, -1))[:, None]
           * (1 - c * np.sum(g64 * g64, -1))[None, :])
    d = np.arccosh(np.maximum(1 + 2 * c * diff_sq / den, 1.0)) / np.sqrt(c)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("c", [1.0, 2.0])
def test_poincare_bucket_plain_matches_pallas(c):
    """n 1,500 <= 2·1024: every row keeps its own slot in both versions,
    so the pools are the same sets with the same surrogate values; and
    both hold the exact (f64) top-10."""
    rng = np.random.default_rng(23)
    gallery = _ball(rng, 1500, 64, c)
    queries = _ball(rng, 9, 64, c)
    jgal = jax_topk.prepare_poincare_gallery(gallery, c)
    jv, ji = jax_topk.bucket_topk_poincare(jnp.asarray(queries), jgal, 80,
                                           interpret=True)
    tgal = torch_topk.prepare_poincare_gallery(_t(gallery), c)
    before = torch_topk.bucket_topk_poincare.launches
    tv, ti = torch_topk.bucket_topk_poincare(_t(queries), tgal, 80)
    assert torch_topk.bucket_topk_poincare.launches == before
    assert ti.dtype == torch.int64 and tv.shape == (9, 80)
    exact = _f64_topk(queries, gallery, c, 10)
    for r in range(9):
        assert set(np.asarray(ji)[r]) == set(ti[r].tolist()), r
        assert set(exact[r]) <= set(ti[r].tolist()), r
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)


def test_poincare_bucket_pools_hold_the_exact_topk_beyond_one_step():
    """3,000 rows (several 1,024-row steps of the port's buckets, and of
    the JAX kernel's 512-row steps of 256 buckets): both pools hold every
    exact top-10 member."""
    c = 2.0
    rng = np.random.default_rng(29)
    gallery = _ball(rng, 3000, 64, c)
    queries = _ball(rng, 9, 64, c)
    jgal = jax_topk.prepare_poincare_gallery(gallery, c)
    _jv, ji = jax_topk.bucket_topk_poincare(jnp.asarray(queries), jgal, 80,
                                            buckets=256, rows=512,
                                            interpret=True)
    _tv, ti = torch_topk.bucket_topk_poincare(
        _t(queries), torch_topk.prepare_poincare_gallery(_t(gallery), c), 80)
    exact = _f64_topk(queries, gallery, c, 10)
    for r in range(9):
        assert set(exact[r]) <= set(np.asarray(ji)[r].tolist()), r
        assert set(exact[r]) <= set(ti[r].tolist()), r


def test_poincare_bucket_top2_is_exact_per_bucket():
    """For every (query, bucket) the exact best two columns of the
    surrogate, ties to the lower column, rows with w <= 0 never chosen;
    checked against a loop."""
    rng = np.random.default_rng(5)
    n, d, buckets, c = 700, 32, 64, 2.0
    gallery = _ball(rng, n, d, c)
    gallery[300] = gallery[44]                 # an exact tie in bucket 44
    gal = torch_topk.prepare_poincare_gallery(_t(gallery), c)
    gal = gal._replace(w=gal.w.clone())
    gal.w[108] = 0.0                           # a masked row in bucket 44
    q_i8, qs, q_sq = torch_topk.quantize_poincare_queries(
        _t(np.concatenate([gallery[44:45], _ball(rng, 2, d, c)])))
    v1, i1, v2, i2 = torch_topk.bucket_top2_poincare_plain(q_i8, qs, q_sq,
                                                           gal, buckets)
    acc = (q_i8.numpy().astype(np.int64)
           @ gal.gal_i8.numpy().astype(np.int64).T).astype(np.float32)
    s = (qs.numpy() * (acc * gal.gw2.numpy()) - q_sq.numpy() * gal.w.numpy()
         - gal.b.numpy())
    for r in range(3):
        for b in range(buckets):
            cols = [j for j in range(b, n, buckets) if gal.w[j] > 0]
            order = sorted(cols, key=lambda j: (-s[r, j], j))[:2]
            assert [int(i1[r, b]), int(i2[r, b])] == order
            assert [float(v1[r, b]), float(v2[r, b])] == list(s[r, order])
