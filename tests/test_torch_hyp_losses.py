"""The hyperbolic trainers' geometry and losses in patent_tpu_torch held to
patent_tpu on the CPU: the Riemannian calculus of ops/poincare.py,
ops/horosphere.py, losses/hierarchy.py, losses/prototype.py and the graph
/ hyperbolic losses of losses/contrastive.py.

The same f32 inputs, drawn from numpy seeds (ball points up to 0.95 of the
radius, one set near the boundary), go through both packages.  Values
agree within ``RTOL`` = 2e-5 relative (``ATOL`` = 1e-6); the losses'
gradients, ``jax.grad`` against autograd, within ``GRAD_RTOL`` = 2e-4
relative to the largest entry (f32 roundings in another order, through
artanh and the horosphere radii's 1/‖p‖).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.losses import contrastive as jax_con
from patent_tpu.losses import hierarchy as jax_hier
from patent_tpu.losses import prototype as jax_proto
from patent_tpu.ops import horosphere as jax_horo
from patent_tpu.ops import poincare as jax_pc
from patent_tpu_torch.losses import contrastive as t_con
from patent_tpu_torch.losses import hierarchy as t_hier
from patent_tpu_torch.losses import prototype as t_proto
from patent_tpu_torch.ops import horosphere as t_horo
from patent_tpu_torch.ops import poincare as t_pc

RTOL, ATOL = 2e-5, 1e-6
GRAD_RTOL = 2e-4
C = 2.0


def _ball(rng, n, d, c=C, r_lo=0.05, r_hi=0.95):
    v = rng.standard_normal((n, d))
    r = rng.uniform(r_lo, r_hi, (n, 1))
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * r
            / np.sqrt(c)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got, np.float64), np.asarray(want, np.float64),
        rtol=rtol, atol=atol)


def _grad_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= GRAD_RTOL * scale, \
        (np.abs(got - want).max(), scale)


def _value_and_grads(jfn, tfn, arrays, diff):
    """Both packages' scalar value and gradients w.r.t. the arrays whose
    positions are in ``diff``."""
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.tensor(a, requires_grad=i in diff) for i, a in
          enumerate(arrays)]
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(diff))(*jx)
    tv = tfn(*tx)
    tg = torch.autograd.grad(tv, [tx[i] for i in diff], allow_unused=True)
    _close(tv, jv)
    for i, g, w in zip(diff, tg, jg):
        # an input that a term does not read: JAX's gradient is 0
        g = torch.zeros_like(tx[i]) if g is None else g
        _grad_close(g.numpy(), w)


# ------------------------------------------------------------- Poincaré

def _points(seed, near_boundary=False):
    rng = np.random.default_rng(seed)
    lo, hi = (0.99, 0.999) if near_boundary else (0.05, 0.95)
    x = _ball(rng, 64, 16, r_lo=lo, r_hi=hi)
    y = _ball(rng, 64, 16, r_lo=lo, r_hi=hi)
    w = (0.3 * rng.standard_normal((64, 16))).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("near", [False, True], ids=["interior", "boundary"])
@pytest.mark.parametrize("name", ["lambda_x", "mobius_neg", "expmap",
                                  "mobius_scalar_mul", "egrad2rgrad",
                                  "gyration", "ptransp", "inner"])
def test_riemannian_calculus_matches_jax(name, near):
    x, y, w = _points(1, near)
    cases = {
        "lambda_x": lambda m, a, b, v: m.lambda_x(a, C),
        "mobius_neg": lambda m, a, b, v: m.mobius_neg(a),
        "expmap": lambda m, a, b, v: m.expmap(a, v, C),
        "mobius_scalar_mul": lambda m, a, b, v: m.mobius_scalar_mul(0.7, a, C),
        "egrad2rgrad": lambda m, a, b, v: m.egrad2rgrad(a, v, C),
        "gyration": lambda m, a, b, v: m.gyration(a, b, v, C),
        "ptransp": lambda m, a, b, v: m.ptransp(a, b, v, C),
        "inner": lambda m, a, b, v: m.inner(a[0], v[0], b[0], C),
    }
    fn = cases[name]
    want = fn(jax_pc, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    got = fn(t_pc, torch.from_numpy(x), torch.from_numpy(y),
             torch.from_numpy(w))
    assert tuple(got.shape) == tuple(want.shape)
    # λ_x near the boundary is ~1e3: 1 − c‖x‖² carries the f32 rounding of
    # ‖x‖², so both packages' values move by that rounding
    rtol = 2e-4 if near and name in ("lambda_x", "egrad2rgrad", "ptransp",
                                     "inner") else RTOL
    _close(got, want, rtol=rtol)


def test_gyration_is_the_composition_and_transport_keeps_the_norm():
    """gyr[u, v]w = ⊖(u ⊕ v) ⊕ (u ⊕ (v ⊕ w)); parallel transport keeps the
    Riemannian norm (float64)."""
    rng = np.random.default_rng(2)
    u, v, w = (torch.from_numpy(_ball(rng, 8, 6, r_hi=0.6)).double()
               for _ in range(3))
    comp = t_pc.mobius_add(-t_pc.mobius_add(u, v, C),
                           t_pc.mobius_add(u, t_pc.mobius_add(v, w, C), C), C)
    assert torch.allclose(t_pc.gyration(u, v, w, C), comp, atol=1e-12)
    t = torch.randn(8, 6, dtype=torch.float64)
    moved = t_pc.ptransp(u, v, t, C)
    n0 = t_pc.lambda_x(u, C)[:, 0] ** 2 * (t * t).sum(-1)
    n1 = t_pc.lambda_x(v, C)[:, 0] ** 2 * (moved * moved).sum(-1)
    assert torch.allclose(n0, n1, rtol=1e-10)


# ------------------------------------------------------------ horosphere

@pytest.mark.parametrize("name", ["insideness", "disjointedness",
                                  "insideness_unit", "disjointedness_unit"])
def test_horosphere_predicates_and_grads_match_jax(name):
    rng = np.random.default_rng(4)
    c = 1.0 if name.endswith("_unit") else C
    a, b = _ball(rng, 48, 12, c=c), _ball(rng, 48, 12, c=c)
    jf, tf = getattr(jax_horo, name), getattr(t_horo, name)
    args = () if name.endswith("_unit") else (c,)
    want = jf(jnp.asarray(a), jnp.asarray(b), *args)
    got = tf(torch.from_numpy(a), torch.from_numpy(b), *args)
    assert tuple(got.shape) == tuple(want.shape) == (48, 1)
    _close(got, want, rtol=1e-4, atol=1e-5)
    assert tuple(tf(torch.from_numpy(a), torch.from_numpy(b), *args,
                    keepdim=False).shape) == (48,)
    _value_and_grads(lambda x, y: jnp.sum(jf(x, y, *args)),
                     lambda x, y: tf(x, y, *args).sum(), [a, b], [0, 1])


def test_hmi_logit_matches_jax():
    rng = np.random.default_rng(5)
    p, lab = _ball(rng, 10, 8, c=1.0), _ball(rng, 30, 8, c=1.0)
    want = jax_horo.hmi_logit(jnp.asarray(p), jnp.asarray(lab))
    got = t_horo.hmi_logit(torch.from_numpy(p), torch.from_numpy(lab))
    assert tuple(got.shape) == (10, 30)
    _close(got, want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- losses

def _pairs(rng, n, count):
    """``count`` pairs of distinct labels (a label's pair with itself is
    the norm's singular point: NaN gradients in JAX, 0 in PyTorch)."""
    a = rng.integers(0, n, count)
    b = (a + rng.integers(1, n, count)) % n
    return np.stack([a, b], 1).astype(np.int32)


def _label_case(seed=6, labels=40, d=12):
    rng = np.random.default_rng(seed)
    emb = _ball(rng, labels, d, r_lo=0.3, r_hi=0.97)
    impl = _pairs(rng, labels, 30)
    excl = _pairs(rng, labels, 20)
    enc = _ball(rng, 16, d, r_lo=0.1, r_hi=0.999)
    return emb, impl, excl, enc


@pytest.mark.parametrize("which", ["inside", "disjoint"])
@pytest.mark.parametrize("exclusion", [True, False],
                         ids=["with_exclusion", "no_exclusion"])
def test_hierarchical_margin_losses_match_jax(which, exclusion):
    emb, impl, excl, _ = _label_case()
    excl = excl if exclusion else np.zeros((0, 2), np.int32)
    k = 0 if which == "inside" else 1

    def jf(e):
        return jax_hier.hierarchical_margin_losses(
            e, jnp.asarray(impl), jnp.asarray(excl), C)[k]

    def tf(e):
        return t_hier.hierarchical_margin_losses(
            e, torch.from_numpy(impl).long(), torch.from_numpy(excl).long(),
            C)[k]

    if which == "disjoint" and not exclusion:
        assert float(tf(torch.from_numpy(emb))) == 0.0
        return
    _value_and_grads(jf, tf, [emb], [0])


@pytest.mark.parametrize("num_valid", [None, 30], ids=["all", "padded"])
@pytest.mark.parametrize("which", ["label_reg", "instance_reg"])
def test_dist0_band_regularizers_match_jax(which, num_valid):
    emb, _, _, enc = _label_case()
    # spread the labels over the band's both edges and the figures past 8
    emb = np.concatenate([emb * 0.2, emb[:20]]).astype(np.float32)
    k = 0 if which == "label_reg" else 1
    _value_and_grads(
        lambda e, f: jax_hier.dist0_band_regularizers(
            e, f, C, num_valid_labels=num_valid)[k],
        lambda e, f: t_hier.dist0_band_regularizers(
            e, f, C, num_valid_labels=num_valid)[k],
        [emb, enc], [0, 1])


@pytest.mark.parametrize("term", ["inside_loss", "disjoint_loss",
                                  "label_reg", "instance_reg"])
def test_hmi_losses_match_jax(term):
    rng = np.random.default_rng(7)
    emb = _ball(rng, 40, 12, c=1.0, r_lo=0.1, r_hi=0.9)
    enc = _ball(rng, 16, 12, c=1.0, r_lo=0.05, r_hi=0.999)
    impl, excl = _pairs(rng, 40, 30), _pairs(rng, 40, 20)
    _value_and_grads(
        lambda f, e: jax_hier.hmi_losses(f, e, jnp.asarray(impl),
                                         jnp.asarray(excl))[term],
        lambda f, e: t_hier.hmi_losses(f, e, torch.from_numpy(impl).long(),
                                       torch.from_numpy(excl).long())[term],
        [enc, emb], [0, 1])


@pytest.mark.parametrize("name", ["sample_to_prototype_triplet",
                                  "sample_to_prototype_ce", "figure_pair_bce"])
def test_prototype_losses_match_jax(name):
    rng = np.random.default_rng(8)
    s, pos = _ball(rng, 16, 10), _ball(rng, 16, 10)
    neg = _ball(rng, 48, 10).reshape(16, 3, 10)
    if name == "figure_pair_bce":
        lab = (rng.random(16) < 0.5).astype(np.float32)
        arrays, diff = [s, pos, lab], [0, 1]

        def jf(a, b, y):
            return jax_proto.figure_pair_bce(a, b, y, C)

        def tf(a, b, y):
            return t_proto.figure_pair_bce(a, b, y, C)
    else:
        arrays, diff = [s, pos, neg], [0, 1, 2]

        def jf(a, b, n):
            return getattr(jax_proto, name)(a, b, n, C)

        def tf(a, b, n):
            return getattr(t_proto, name)(a, b, n, C)
    _value_and_grads(jf, tf, arrays, diff)


def test_hyperbolic_info_nce_matches_jax():
    rng = np.random.default_rng(9)
    a, p = _ball(rng, 24, 16, c=1.0), _ball(rng, 24, 16, c=1.0)
    _value_and_grads(lambda x, y: jax_con.hyperbolic_info_nce(x, y, 1.0, 0.07),
                     lambda x, y: t_con.hyperbolic_info_nce(x, y, 1.0, 0.07),
                     [a, p], [0, 1])


def test_graph_losses_match_jax():
    rng = np.random.default_rng(10)
    n = 20
    z = rng.standard_normal((n, 8)).astype(np.float32)
    pairs = rng.integers(0, n, (15, 2)).astype(np.int32)
    neg1 = rng.integers(0, n, 15).astype(np.int32)
    neg5 = rng.integers(0, n, (15, 5)).astype(np.int32)
    jm = jax_con.pairs_to_mask(jnp.asarray(pairs), n)
    tm = t_con.pairs_to_mask(torch.from_numpy(pairs).long(), n)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    mask = np.asarray(jm)
    tp = torch.from_numpy(pairs).long()
    _value_and_grads(
        lambda x: jax_con.neighborhood_nce(x, jnp.asarray(mask)),
        lambda x: t_con.neighborhood_nce(x, torch.from_numpy(mask)), [z], [0])
    neg1[:3] = pairs[:3, 1]          # collisions with the parent are masked
    _value_and_grads(
        lambda x: jax_con.hierarchical_triplet(x, jnp.asarray(pairs),
                                               jnp.asarray(neg1)),
        lambda x: t_con.hierarchical_triplet(x, tp,
                                             torch.from_numpy(neg1).long()),
        [z], [0])
    _value_and_grads(
        lambda x: jax_con.infonce_parent_neighbor(x, jnp.asarray(pairs),
                                                  jnp.asarray(neg5)),
        lambda x: t_con.infonce_parent_neighbor(
            x, tp, torch.from_numpy(neg5).long()), [z], [0])
