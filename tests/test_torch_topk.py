"""patent_tpu_torch cosine index and bucket candidate stage (plain
versions, on the CPU) held to patent_tpu.

The JAX bucket kernel runs in interpret mode; the JAX ``topk_search`` scan
is the oracle for indices (identical) and values (within 1e-6: f32 dots
summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.ops import topk_kernel as jax_topk
from patent_tpu.retrieval import index as jax_index
from patent_tpu_torch.ops import topk_kernel as torch_topk
from patent_tpu_torch.retrieval import index as torch_index


def brute_force_cosine(q, g, k):
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    sims = qn.astype(np.float64) @ gn.T.astype(np.float64)
    return np.argsort(-sims, axis=1, kind="stable")[:, :k]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    gallery = rng.standard_normal((1500, 64)).astype(np.float32)
    queries = np.concatenate([
        gallery[:8] + 0.3 * rng.standard_normal((8, 64)),
        rng.standard_normal((9, 64))]).astype(np.float32)
    return queries, gallery


def _jax_scan(queries, gallery, k, block_size=256):
    v, i = jax_index.topk_search(jnp.asarray(queries), jnp.asarray(gallery),
                                 k=k, block_size=block_size)
    return np.asarray(v), np.asarray(i)


def test_bucket_plain_matches_jax_interpret(data):
    """n ≤ 2048: every column keeps its own slot in both versions, so the
    candidate pools are the same sets; values agree to f32 noise."""
    queries, gallery = data
    gal16_j, valid_j = jax_topk.prepare_cosine_gallery_bf16(gallery)
    jv, ji = jax_topk.bucket_topk_bf16(jnp.asarray(queries), gal16_j,
                                       valid_j, 80, interpret=True)
    gal16_t = torch.from_numpy(np.asarray(gal16_j, np.float32)).bfloat16()
    tv, ti = torch_topk.bucket_topk_bf16(
        torch.from_numpy(queries), gal16_t,
        torch.from_numpy(np.array(valid_j)), 80)
    for r in range(queries.shape[0]):
        assert set(np.asarray(ji)[r]) == set(ti[r].tolist())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert ti.dtype == torch.int64 and tv.shape == (queries.shape[0], 80)


def test_bucket_pool_holds_bruteforce_top10(data):
    queries, gallery = data
    gal16, valid = torch_topk.prepare_cosine_gallery_bf16(
        torch.from_numpy(gallery))
    _v, pidx = torch_topk.bucket_topk_bf16(torch.from_numpy(queries), gal16,
                                           valid, 80)
    bi = brute_force_cosine(queries, gallery, 10)
    for r in range(queries.shape[0]):
        assert set(bi[r]) <= set(pidx[r].tolist()), r


def test_bucket_top2_is_exact_per_bucket_beyond_2048():
    """The port's contract (unlike the TPU kernel's one winner per 2048-row
    step): for every (query, bucket) the exact best two columns, ties to
    the lower column, invalid rows never chosen; checked against a loop."""
    rng = np.random.default_rng(1)
    n, d, buckets = 700, 16, 64
    gal = rng.standard_normal((n, d)).astype(np.float32)
    gal[300] = gal[44]                       # an exact tie in bucket 44
    q = rng.standard_normal((3, d)).astype(np.float32)
    q[0] = gal[44]
    valid = np.ones(n, np.float32)
    valid[108] = 0.0                         # an invalid row in bucket 44
    q16 = torch.from_numpy(q).bfloat16()
    g16 = torch.from_numpy(gal).bfloat16()
    v1, i1, v2, i2 = torch_topk.bucket_top2_plain(
        q16, g16, torch.from_numpy(valid), buckets)
    s = q16.float().numpy() @ g16.float().numpy().T
    for r in range(3):
        for b in range(buckets):
            cols = [c for c in range(b, n, buckets) if valid[c] > 0]
            order = sorted(cols, key=lambda c: (-s[r, c], c))[:2]
            assert [int(i1[r, b]), int(i2[r, b])] == order
            np.testing.assert_allclose([float(v1[r, b]), float(v2[r, b])],
                                       s[r, order], rtol=1e-6)
    assert torch_topk.bucket_topk_supported(5000, 2048)
    assert not torch_topk.bucket_topk_supported(5000, 2049)
    assert not torch_topk.bucket_topk_supported(100, 101)


@pytest.mark.parametrize("n", [1500, 3000])
def test_cosine_fast_matches_jax_scan(data, n):
    queries, gallery = data
    if n > gallery.shape[0]:
        rng = np.random.default_rng(n)
        gallery = np.concatenate([gallery, rng.standard_normal(
            (n - gallery.shape[0], gallery.shape[1])).astype(np.float32)])
    sv, si = _jax_scan(queries, gallery, 10)
    g = torch.from_numpy(gallery)
    gal16, valid = torch_topk.prepare_cosine_gallery_bf16(g)
    fv, fi = torch_index.topk_search_cosine_fast(torch.from_numpy(queries),
                                                 gal16, valid, g, k=10)
    np.testing.assert_array_equal(fi.numpy(), si)
    np.testing.assert_allclose(fv.numpy(), sv, atol=1e-6)


def test_cosine_fast_tie_break_matches_jax_scan():
    """8 exact duplicates of every row (tests/test_index.py tie case): the
    scan breaks equal cosines to the lower gallery index, and so must the
    re-rank of a pool that arrives in bucket order."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((64, 32)).astype(np.float32)
    gallery = np.concatenate([base] * 8, axis=0)
    queries = gallery[[5, 37, 100]] + 0.0
    sv, si = _jax_scan(queries, gallery, 10, block_size=128)
    g = torch.from_numpy(gallery)
    gal16, valid = torch_topk.prepare_cosine_gallery_bf16(g)
    fv, fi = torch_index.topk_search_cosine_fast(torch.from_numpy(queries),
                                                 gal16, valid, g, k=10)
    np.testing.assert_array_equal(fi.numpy(), si)
    np.testing.assert_allclose(fv.numpy(), sv, atol=1e-6)
    tv, ti = torch_index.topk_search(torch.from_numpy(queries), g, k=10,
                                     block_size=128)
    np.testing.assert_array_equal(ti.numpy(), si)


@pytest.mark.parametrize("n,k", [(1500, 10), (1500, 1500), (80, 10),
                                 (5, 10)],
                         ids=["k<n", "k==n", "pool==n", "n<k"])
def test_embedding_index_search_matches_jax_index(data, n, k):
    """EmbeddingIndex.search (the scan on the CPU) against the JAX index:
    k == n ranks the whole gallery, pool == n (80 rows, k = 10) cannot use
    the candidate stage, and a gallery smaller than k returns n columns."""
    queries, gallery = data
    gallery = gallery[:n]
    names = [f"g{i}" for i in range(n)]
    jv, ji = jax_index.EmbeddingIndex(gallery, names).search(queries, k=k)
    idx = torch_index.EmbeddingIndex(gallery, names, device="cpu")
    tv, ti = idx.search(queries, k=k)
    assert ti.shape == (queries.shape[0], min(k, n))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    assert idx._gal16 is None                # CPU: no bf16 copy is built
    hits = idx.search_names(queries[:1], k=3)[0]
    assert [h[0] for h in hits] == [names[j] for j in ji[0, :3]]


def test_topk_search_pads_small_gallery_like_jax(data):
    queries, gallery = data
    sv, si = _jax_scan(queries, gallery[:5], 10)
    tv, ti = torch_index.topk_search(torch.from_numpy(queries),
                                     torch.from_numpy(gallery[:5]), k=10)
    np.testing.assert_array_equal(ti.numpy(), si)
    np.testing.assert_allclose(tv.numpy(), sv, atol=1e-6)
    assert np.all(np.isneginf(tv.numpy()[:, 5:]))


def test_fused_cosine_eligible_needs_cuda_and_a_narrower_pool():
    assert not torch_index.fused_cosine_eligible(10_000, 10, "cpu")
    assert torch_index.fused_cosine_eligible(10_000, 10, "cuda")
    assert not torch_index.fused_cosine_eligible(80, 10, "cuda")
    assert not torch_index.fused_cosine_eligible(100_000, 300, "cuda")


def test_index_files_interchange_with_jax(data, tmp_path):
    """Both packages read and write the same .npy + .json layout."""
    _q, gallery = data
    names = [f"fig{i}.png" for i in range(50)]
    torch_index.EmbeddingIndex(gallery[:50], names, device="cpu").save(
        str(tmp_path / "t"))
    j = jax_index.EmbeddingIndex.load(str(tmp_path / "t"))
    assert j.names == names
    np.testing.assert_array_equal(np.asarray(j.embeddings), gallery[:50])
    jax_index.EmbeddingIndex(gallery[:50], names).save(str(tmp_path / "j"))
    t = torch_index.EmbeddingIndex.load(str(tmp_path / "j"), device="cpu")
    assert t.names == names
    np.testing.assert_array_equal(t.embeddings.numpy(), gallery[:50])
