"""patent_tpu_torch quantized cosine index and its int8 bucket candidate
stage (plain versions, on the CPU) held to patent_tpu.

The JAX int8 bucket kernel runs in interpret mode.  The f32 scan is the
oracle for the quantized index's answers: indices identical to the scan's
(the tie case to the JAX scan's directly), values within 1e-6 of the JAX
scan's (f32 dots summed in another order), including the duplicate-row,
k == n and pool == n cases of tests/test_index.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.ops import topk_kernel as jax_topk
from patent_tpu.retrieval import index as jax_index
from patent_tpu_torch.ops import topk_kernel as torch_topk
from patent_tpu_torch.retrieval import index as torch_index


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    gallery = rng.standard_normal((1500, 64)).astype(np.float32)
    queries = np.concatenate([
        gallery[:8] + 0.3 * rng.standard_normal((8, 64)),
        rng.standard_normal((9, 64))]).astype(np.float32)
    return queries, gallery


def _jax_queries(queries):
    """The JAX index's query quantization (index.py _topk_scores_int8_fused)."""
    q = jnp.asarray(queries)
    qn = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    scale = jnp.maximum(jnp.max(jnp.abs(qn), axis=-1, keepdims=True),
                        1e-8) / 127.0
    return jnp.clip(jnp.round(qn / scale), -127, 127).astype(jnp.int8), scale


def test_quantize_gallery_equals_jax(data):
    _q, gallery = data
    gallery = gallery.copy()
    gallery[3] = 0.0                           # a zero row: scale 1e-8/127
    wq, ws = jax_index.quantize_gallery(gallery)
    tq, ts = torch_topk.quantize_gallery(gallery)
    np.testing.assert_array_equal(tq, wq)
    np.testing.assert_array_equal(ts, ws)
    assert tq.dtype == np.int8 and ts.dtype == np.float32


def test_quantize_queries_matches_jax(data):
    """Codes agree except where the f32 norm, summed in another order,
    moves a value across a rounding boundary: at most one code in a
    thousand, by one step."""
    queries, _g = data
    jq, js = _jax_queries(queries)
    tq, ts = torch_topk.quantize_queries(torch.from_numpy(queries))
    diff = np.abs(tq.numpy().astype(int) - np.asarray(jq, int))
    assert diff.max() <= 1 and diff.mean() <= 1e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("n", [1500, 2048], ids=["n1500", "n2048"])
def test_int8_bucket_plain_matches_jax_interpret(data, n):
    """n <= 2048: every column keeps its own slot in both versions, so the
    pools are the same sets; the int8 scores are exact integers times the
    same scales, so the values agree to f32 rounding."""
    queries, gallery = data
    if n > gallery.shape[0]:
        rng = np.random.default_rng(n)
        gallery = np.concatenate([gallery, rng.standard_normal(
            (n - gallery.shape[0], gallery.shape[1])).astype(np.float32)])
    gi8, gs = jax_index.quantize_gallery(gallery)
    qi8, qs = _jax_queries(queries)
    jv, ji = jax_topk.bucket_topk_int8(qi8, qs, jnp.asarray(gi8),
                                       jnp.asarray(gs), 80, interpret=True)
    tv, ti = torch_topk.bucket_topk_int8(
        torch.from_numpy(np.array(qi8)), torch.from_numpy(np.array(qs)),
        torch.from_numpy(gi8), torch.from_numpy(gs), 80)
    assert ti.dtype == torch.int64 and tv.shape == (queries.shape[0], 80)
    for r in range(queries.shape[0]):
        assert set(np.asarray(ji)[r]) == set(ti[r].tolist()), r
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)


def test_int8_bucket_top2_is_exact_per_bucket_beyond_2048():
    """For every (query, bucket) the exact best two columns of
    f32(int32 dot) * scale, ties to the lower column, rows of scale <= 0
    never chosen; checked against a loop."""
    rng = np.random.default_rng(2)
    n, d, buckets = 700, 32, 64
    g = rng.integers(-127, 128, (n, d)).astype(np.int8)
    g[300] = g[44]                           # an exact tie in bucket 44
    q = rng.integers(-127, 128, (3, d)).astype(np.int8)
    q[0] = g[44]
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    scale[300] = scale[44]
    scale[108] = 0.0                         # an invalid row in bucket 44
    v1, i1, v2, i2 = torch_topk.bucket_top2_int8_plain(
        torch.from_numpy(q), torch.from_numpy(g), torch.from_numpy(scale),
        buckets)
    s = (q.astype(np.int64) @ g.astype(np.int64).T).astype(np.float32) * scale
    for r in range(3):
        for b in range(buckets):
            cols = [c for c in range(b, n, buckets) if scale[c] > 0]
            order = sorted(cols, key=lambda c: (-s[r, c], c))[:2]
            assert [int(i1[r, b]), int(i2[r, b])] == order
            assert [float(v1[r, b]), float(v2[r, b])] == list(s[r, order])


@pytest.mark.parametrize("n,k", [(1500, 10), (3000, 10), (1500, 1500),
                                 (80, 10), (5, 10)],
                         ids=["k<n", "n3000", "k==n", "pool==n", "n<k"])
def test_quantized_index_equals_the_f32_scan(data, n, k):
    """EmbeddingIndex(quantized=True).search: int8 candidates (plain
    version on the CPU) and the exact re-rank give the f32 scan's indices
    (the port's ``topk_search``, itself held to JAX's in
    tests/test_torch_topk.py) and the JAX scan's values; k == n and
    pool == n rank through the scan."""
    queries, gallery = data
    if n > gallery.shape[0]:
        rng = np.random.default_rng(n)
        gallery = np.concatenate([gallery, rng.standard_normal(
            (n - gallery.shape[0], gallery.shape[1])).astype(np.float32)])
    gallery = gallery[:n]
    names = [f"g{i}" for i in range(n)]
    sv, _si = jax_index.topk_search(jnp.asarray(queries),
                                    jnp.asarray(gallery), k=min(k, n),
                                    block_size=256)
    idx = torch_index.EmbeddingIndex(gallery, names, device="cpu",
                                     quantized=True)
    before = torch_topk.bucket_topk_int8.launches
    tv, ti = idx.search(queries, k=k)
    assert torch_topk.bucket_topk_int8.launches == before   # CPU: plain
    _v, scan = torch_index.topk_search(torch.from_numpy(queries),
                                       torch.from_numpy(gallery), k=min(k, n))
    np.testing.assert_array_equal(ti, scan.numpy())
    np.testing.assert_allclose(tv, np.asarray(sv), atol=1e-6)
    assert idx.emb_i8.dtype == torch.int8 and idx._gal16 is None


def test_quantized_index_tie_break_matches_the_scan():
    """8 exact duplicates of every row (tests/test_index.py tie case):
    equal cosines break to the lower gallery index, as the scan does."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((64, 32)).astype(np.float32)
    gallery = np.concatenate([base] * 8, axis=0)
    queries = gallery[[5, 37, 100]] + 0.0
    sv, si = jax_index.topk_search(jnp.asarray(queries),
                                   jnp.asarray(gallery), k=10,
                                   block_size=128)
    tv, ti = torch_index.EmbeddingIndex(
        gallery, [f"g{i}" for i in range(512)], device="cpu",
        quantized=True).search(queries, k=10)
    np.testing.assert_array_equal(ti, np.asarray(si))
    np.testing.assert_allclose(tv, np.asarray(sv), atol=1e-6)


def test_quantized_index_round_trips_through_files(data, tmp_path):
    _q, gallery = data
    names = [f"fig{i}.png" for i in range(300)]
    torch_index.EmbeddingIndex(gallery[:300], names, device="cpu",
                               quantized=True).save(str(tmp_path / "q"))
    back = torch_index.EmbeddingIndex.load(str(tmp_path / "q"), device="cpu",
                                           quantized=True)
    assert back.names == names
    np.testing.assert_array_equal(back.embeddings.numpy(), gallery[:300])
    np.testing.assert_array_equal(back.emb_i8.numpy(),
                                  jax_index.quantize_gallery(gallery[:300])[0])
