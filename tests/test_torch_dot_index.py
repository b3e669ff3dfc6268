"""The port's dot-product index (``similarity="dot"``,
patent_tpu_torch/retrieval/index.py) on one device, held to JAX's
``topk_search`` and ``EmbeddingIndex`` on the CPU: indices equal, scores
within 1e-5 (f32 products summed in another order).  The sharded index is
held to JAX's in tests/test_torch_sharded_index.py.  Inputs come from
numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.retrieval import index as jax_index
from patent_tpu_torch.retrieval import index as ix

TOL = 1e-5


def _case(seed=5, n=700, d=48, q=9):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    # rows of other norms, so that dot and cosine rank differently
    g *= rng.uniform(0.2, 3.0, (n, 1)).astype(np.float32)
    return g, rng.standard_normal((q, d)).astype(np.float32)


@pytest.mark.parametrize("k,block_size", [(10, 8192), (10, 64), (700, 128),
                                          (705, 8192)],
                         ids=["k10", "k10-blocks", "all-blocks", "k>N"])
def test_dot_scan_equals_jax(k, block_size):
    """``topk_search(similarity="dot")`` against JAX's, in one block and
    blockwise, and with k past the gallery (padded with -inf, index 0)."""
    g, q = _case()
    want_v, want_i = jax_index.topk_search(
        jnp.asarray(q), jnp.asarray(g), k=k, similarity="dot",
        block_size=block_size)
    vals, idx = ix.topk_search(torch.from_numpy(q), torch.from_numpy(g),
                               k=k, block_size=block_size,
                               similarity="dot")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k", [1, 10, 700])
def test_dot_index_equals_jax_and_differs_from_cosine(k):
    """``EmbeddingIndex(similarity="dot")`` answers as JAX's; the cosine
    index over the same rows ranks them otherwise (the control)."""
    g, q = _case()
    names = [f"g{i}" for i in range(len(g))]
    want_v, want_i = jax_index.EmbeddingIndex(
        g, names, similarity="dot").search(q, k=k)
    index = ix.EmbeddingIndex(g, names, similarity="dot", device="cpu")
    vals, idx = index.search(q, k=k)
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    np.testing.assert_allclose(vals, np.asarray(want_v), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vals[:, 0], np.max(q @ g.T, axis=1),
                               rtol=TOL, atol=TOL)
    if k < len(g):
        _cv, cidx = ix.EmbeddingIndex(g, names, device="cpu").search(q, k=k)
        assert not np.array_equal(cidx, idx)


def test_quantized_dot_index_is_refused_as_jax_refuses_it():
    g, _q = _case(n=40)
    names = [f"g{i}" for i in range(len(g))]
    msg = "quantized index supports cosine and poincare only"
    with pytest.raises(ValueError, match=msg):
        jax_index.EmbeddingIndex(g, names, similarity="dot", quantized=True)
    with pytest.raises(ValueError, match=msg):
        ix.EmbeddingIndex(g, names, similarity="dot", quantized=True,
                          device="cpu")
    with pytest.raises(ValueError, match="unknown similarity"):
        ix.EmbeddingIndex(g, names, similarity="euclid", device="cpu")


def test_dot_index_save_and_load_across_packages(tmp_path):
    """An index saved by either package loads into the other's dot index
    and answers as before: the same files, the same rows and names."""
    g, q = _case()
    names = [f"g{i}.png" for i in range(len(g))]
    ix.EmbeddingIndex(g, names, similarity="dot",
                      device="cpu").save(str(tmp_path / "port"))
    jax_index.EmbeddingIndex(g, names, similarity="dot").save(
        str(tmp_path / "jax"))
    want = jax_index.EmbeddingIndex(g, names, similarity="dot").search(
        q, k=10)
    for prefix in ("port", "jax"):
        loaded = ix.EmbeddingIndex.load(str(tmp_path / prefix),
                                        similarity="dot", device="cpu")
        assert loaded.names == names and loaded.similarity == "dot"
        np.testing.assert_array_equal(loaded.embeddings.numpy(), g)
        vals, idx = loaded.search(q, k=10)
        np.testing.assert_array_equal(idx, np.asarray(want[1]))
        np.testing.assert_allclose(vals, np.asarray(want[0]), rtol=TOL,
                                   atol=TOL)
        back = jax_index.EmbeddingIndex.load(str(tmp_path / prefix),
                                             similarity="dot")
        np.testing.assert_array_equal(np.asarray(back.search(q, k=10)[1]),
                                      idx)
