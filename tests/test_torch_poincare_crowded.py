"""The quantized Poincaré index of patent_tpu_torch against the JAX
package's on the CPU, on a spread gallery and on one crowded at the ball's
projection radius, as a ``train_hyp`` model trained on the synthetic
corpus encodes one.

Both packages take their candidates from the same int8 stage (row 4; the
JAX package's kernel in interpret mode, as its own tests run it) and
re-rank the pool in f64, so they answer the same rows.  On the spread
gallery that is the exact top-10 (an f64 scan here in the test); on the
crowded one the int8 codes cannot tell neighbours apart and both miss
most of it (printed, a measured property of the stage, held to no
threshold).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from patent_tpu.retrieval import index as jax_index
from patent_tpu_torch.retrieval import index as ix

C = 2.0


def _crowded(n=20000, d=32, seed=0):
    """Rows on a narrow band of a great circle, clipped to the projection
    radius (1 − 4e-3)/√c as ``poincare.project`` leaves them, in a random
    rotation; queries are rows moved along the band and off it a little."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0][:, :3]
    t = rng.uniform(0.0, 0.3, n)
    off = 1e-4 * rng.standard_normal(n)
    pts = np.stack([np.cos(t), np.sin(t), off], 1) @ basis.T
    radius = (1.0 - 4e-3) / np.sqrt(C)
    gal = (pts / np.linalg.norm(pts, axis=1, keepdims=True) * radius)
    q = gal[rng.integers(0, n, 24)] + 2e-5 * rng.standard_normal((24, d))
    q = q / np.linalg.norm(q, axis=1, keepdims=True) * radius * 0.9999
    return gal.astype(np.float32), q.astype(np.float32)


def _spread(n=20000, d=32, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    gal = (v * rng.uniform(0.05, 0.95, (n, 1)) / np.sqrt(C)).astype(
        np.float32)
    q = np.concatenate([gal[:16] + 1e-3 * rng.standard_normal((16, d)),
                        gal[1000:1016] * 0.9]).astype(np.float32)
    return gal, q


def _exact_top10(q, gal):
    """The f64 Poincaré distance to every row, ties to the lower index."""
    u, g = q.astype(np.float64), gal.astype(np.float64)
    sq = ((u[:, None, :] - g[None]) ** 2).sum(-1)
    den = np.outer(1 - C * (u * u).sum(-1), 1 - C * (g * g).sum(-1))
    d = np.arccosh(1 + 2 * C * sq / den)
    return np.argsort(d, axis=1, kind="stable")[:, :10]


def _recall(got, want) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(got, want)]))


@pytest.mark.parametrize("case", ["crowded", "spread"])
def test_quantized_poincare_search_matches_jax(case, monkeypatch):
    """Indices equal to JAX's, scores within 1e-6 relative; on the spread
    gallery both are the exact top-10."""
    monkeypatch.setenv("PATENT_TPU_FUSED_TOPK", "force")
    gal, q = _crowded() if case == "crowded" else _spread()
    names = [str(i) for i in range(len(gal))]
    vals, idx = ix.EmbeddingIndex(gal, names, similarity="poincare", c=C,
                                  device="cpu", quantized=True
                                  ).search(q, k=10)
    jv, ji = jax_index.EmbeddingIndex(
        jnp.asarray(gal), names, similarity="poincare", c=C,
        quantized=True).search(jnp.asarray(q), k=10)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(vals, np.asarray(jv), rtol=1e-6)
    exact = _exact_top10(q, gal)
    print(f"{case}: recall@10 against the exact f64 ranking "
          f"{_recall(idx, exact):.4f} (both packages)")
    if case == "spread":
        np.testing.assert_array_equal(idx, exact)
