"""The port's sharded searches (patent_tpu_torch/retrieval/index.py) over a
world of 4 gloo ranks on the CPU, held to JAX's sharded functions on 4
devices of the virtual mesh, and the sharded ``EmbeddingIndex`` and its
follower-loop service held to the one-process index.

One world runs every case (``tests/torch_worlds.py::index_world``, started
once by a module fixture); the tests read its answers.  Tolerances:
indices equal, scores within 1e-6 (f32 re-ranks summed in another order;
the Poincaré scan's −distance within 1e-6 relative).  On the CPU each
rank's candidate stage is its kernel's plain version (rows 3, 3′, 4),
JAX's the XLA scan twin; both pools hold the exact top-k, so the re-ranks
agree.  JAX lets a filler candidate's index (−inf, index 0 of its shard)
into the merged pool, where it can repeat a row; the port marks fillers
−1, and the filler case holds it to the exact answer (JAX's duplicate is
not pinned).  JAX's ``sharded_topk_search`` pads its last shard with zero
rows and masks them only after each shard's top-k; in the Poincaré ball a
zero row is the origin, which outranks real rows for a query near it, so
that shard can return fewer than k real candidates (``scan_poincare``'s
fifth query loses its fifth neighbour that way).  The port's shards hold
only real rows; that case is held to JAX's one-device ``topk_search``,
which agrees with the f64 distance, and JAX's sharded answer is not
pinned.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from patent_tpu.ops.topk_kernel import (prepare_cosine_gallery_bf16 as
                                        jax_prepare_bf16,
                                        prepare_poincare_gallery as
                                        jax_prepare_poincare)
from patent_tpu.retrieval import index as jax_index
from patent_tpu_torch.parallel.launch import run_world
from torch_worlds import index_world

RANKS = 4


def _ball(rng, n, d, c, r_max):
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    r = rng.uniform(0.0, r_max, (n, 1)) / np.sqrt(c)
    return (v * r).astype(np.float32)


def _cases():
    rng = np.random.default_rng(7)
    g1000 = rng.standard_normal((1000, 64)).astype(np.float32)
    q17 = rng.standard_normal((17, 64)).astype(np.float32)
    rng = np.random.default_rng(11)
    g1003 = rng.standard_normal((1003, 32)).astype(np.float32)
    q5 = rng.standard_normal((5, 32)).astype(np.float32)
    rng = np.random.default_rng(0)
    g301 = rng.standard_normal((301, 32)).astype(np.float32)
    q6 = rng.standard_normal((6, 32)).astype(np.float32)
    g317 = rng.standard_normal((317, 32)).astype(np.float32)
    p203 = rng.standard_normal((203, 16))
    p203 = (p203 / np.linalg.norm(p203, axis=-1, keepdims=True)
            * rng.uniform(0.1, 0.8, (203, 1))).astype(np.float32)
    rng = np.random.default_rng(17)
    p301 = _ball(rng, 301, 16, 1.5, 0.85)
    pq301 = _ball(rng, 6, 16, 1.5, 0.85)
    rng = np.random.default_rng(29)
    p300 = _ball(rng, 300, 16, 1.0, 0.8)
    pq300 = _ball(rng, 5, 16, 1.0, 0.8)
    rng = np.random.default_rng(3)
    g40 = rng.standard_normal((40, 16)).astype(np.float32)
    q40 = rng.standard_normal((4, 16)).astype(np.float32)
    valid40 = np.zeros(40, np.float32)
    valid40[[0, 1, 13, 20, 21, 39]] = 1.0
    g200 = rng.standard_normal((200, 16)).astype(np.float32)
    return {
        "scan_1000": dict(kind="scan", gallery=g1000, queries=q17, k=10,
                          block_size=64),
        "scan_uneven": dict(kind="scan", gallery=g1003, queries=q5, k=7),
        "scan_dot": dict(kind="scan", gallery=g1003, queries=q5, k=7,
                         similarity="dot", block_size=64),
        "scan_poincare": dict(kind="scan", gallery=p301, queries=pq301, k=5,
                              similarity="poincare", c=1.5, block_size=64),
        "cosine_fast_317": dict(kind="cosine_fast", gallery=g317,
                                queries=q6, k=5, block_size=64),
        "cosine_fast_901": dict(kind="cosine_fast", gallery=g1000[:901],
                                queries=q17, k=10, block_size=64),
        "quantized_301": dict(kind="quantized", gallery=g301, queries=q6,
                              k=5, block_size=64),
        "poincare_203": dict(kind="poincare_fast", gallery=p203,
                             queries=p203[:5] * 0.99, k=5, c=1.0,
                             block_size=64),
        "poincare_301": dict(kind="poincare_fast", gallery=p301,
                             queries=pq301, k=5, c=1.5, block_size=64),
        "filler": dict(kind="cosine_fast", gallery=g40, queries=q40, k=3,
                       valid=valid40),
        "index_cosine": dict(kind="index", gallery=g1000, queries=q17,
                             k=None, ks=(1000, 10)),
        "index_dot": dict(kind="index", gallery=g1000, queries=q17,
                          k=None, ks=(10, 1000), similarity="dot"),
        "index_quantized": dict(kind="index", gallery=g1000, queries=q17,
                                k=None, ks=(10, 200), quantized=True),
        "index_poincare_q": dict(kind="index", gallery=p300, queries=pq300,
                                 k=None, ks=(6, 40), quantized=True,
                                 similarity="poincare", c=1.0),
        "index_poincare": dict(kind="index", gallery=p300, queries=pq300,
                               k=None, ks=(6,), similarity="poincare",
                               c=1.0),
        "service": dict(kind="service", gallery=g200, queries=q40),
        "hyp_engine": dict(kind="hyp_engine", gallery=g1003[:301] * 0.1,
                           queries=q5 * 0.1, k=6, embed_dim=8, hidden=16,
                           c=1.0, batch_size=64),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    tmp = str(tmp_path_factory.mktemp("sharded_index"))
    return cases, run_world(RANKS, index_world, "cpu", cases, tmp,
                            device="cpu", timeout=600), tmp


@pytest.fixture(scope="module")
def mesh4(eight_devices):
    return Mesh(np.array(eight_devices[:RANKS]), ("data",))


def _jax_answer(mesh, case):
    kind, g, q, k = case["kind"], case["gallery"], case["queries"], case["k"]
    bs = case.get("block_size", 8192)
    if kind == "scan" and case.get("similarity") == "poincare":
        vals, idx = jax_index.topk_search(
            jnp.asarray(q), jnp.asarray(g), k=k, similarity="poincare",
            c=case["c"], block_size=bs)
    elif kind == "scan":
        vals, idx = jax_index.sharded_topk_search(
            mesh, jnp.asarray(q), jnp.asarray(g), k=k,
            similarity=case.get("similarity", "cosine"),
            c=case.get("c", 1.0), block_size=bs)
    elif kind == "cosine_fast":
        gal16, valid = jax_prepare_bf16(g)
        vals, idx = jax_index.sharded_topk_search_cosine_fast(
            mesh, q, gal16, valid, jnp.asarray(g), k=k, block_size=bs)
    elif kind == "quantized":
        i8, scale = jax_index.quantize_gallery(g)
        vals, idx = jax_index.sharded_topk_search_quantized(
            mesh, jnp.asarray(q), jnp.asarray(i8), jnp.asarray(scale), g,
            k=k, block_size=bs)
    else:
        gal = jax_prepare_poincare(g, case["c"])
        vals, idx = jax_index.sharded_topk_search_poincare_fast(
            mesh, q, gal, g, k=k, c=case["c"], block_size=bs)
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("name", [
    "scan_1000", "scan_uneven", "scan_dot", "scan_poincare",
    "cosine_fast_317",
    "cosine_fast_901", "quantized_301", "poincare_203", "poincare_301"])
def test_sharded_search_equals_jax(world, mesh4, name):
    """Each sharded search over 4 ranks against JAX's over 4 devices (the
    Poincaré scan against JAX's one-device scan, see above): indices
    equal, scores within 1e-6."""
    cases, out, _ = world
    vals, idx = out[name]
    want_v, want_i = _jax_answer(mesh4, cases[name])
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_allclose(vals, want_v, rtol=1e-6, atol=1e-6)


def test_filler_candidates_never_reach_the_rerank(world):
    """Six valid rows of 40 over 4 shards (a pool of 24 from shards of 10):
    the merged pool holds fillers, which the port marks −1, so the answer
    has no repeated row and is the exact top-3 of the valid rows."""
    cases, out, _ = world
    case = cases["filler"]
    vals, idx = out["filler"]
    assert all(len(set(row)) == len(row) for row in idx.tolist())
    keep = np.flatnonzero(case["valid"])
    qn = case["queries"] / np.linalg.norm(case["queries"], axis=-1,
                                          keepdims=True)
    gn = case["gallery"][keep] / np.linalg.norm(case["gallery"][keep],
                                                axis=-1, keepdims=True)
    sims = qn @ gn.T
    order = np.argsort(-sims, axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(idx, keep[order])
    np.testing.assert_allclose(vals, np.take_along_axis(sims, order, 1),
                               atol=1e-6)


@pytest.mark.parametrize("name,k,bf16", [
    ("index_cosine", 10, True), ("index_cosine", 1000, False),
    ("index_dot", 10, False), ("index_dot", 1000, False),
    ("index_quantized", 10, False), ("index_quantized", 200, False),
    ("index_poincare_q", 6, False), ("index_poincare_q", 40, False),
    ("index_poincare", 6, False)])
def test_sharded_index_routes_and_equals_one_process(world, name, k, bf16):
    """EmbeddingIndex(mesh=...) against the index of one process: the same
    indices, scores within 1e-6 (2e-4 for Poincaré −distances, which the
    one-process scan takes in f32 and the sharded candidate path in f64).
    The bf16 candidate copy is built only where the cosine pool narrows
    the gallery (k · 8 < N), as JAX routes."""
    _cases_, out, _ = world
    res = out[name]
    (sv, si), (ov, oi), built = res[k]
    np.testing.assert_array_equal(si, oi)
    tol = 2e-4 if "poincare" in name else 1e-6
    np.testing.assert_allclose(sv, ov, rtol=tol, atol=tol)
    assert not res["bf16_before"]
    assert built == bf16


@pytest.mark.parametrize("k", [10, 1000])
def test_sharded_dot_index_equals_jax(world, mesh4, k):
    """EmbeddingIndex(similarity="dot", mesh=...) over 4 ranks against
    JAX's over 4 devices of the virtual mesh: indices equal, dot products
    within 1e-5."""
    cases, out, _ = world
    case = cases["index_dot"]
    names = [f"g{i}" for i in range(len(case["gallery"]))]
    want_v, want_i = jax_index.EmbeddingIndex(
        case["gallery"], names, similarity="dot",
        mesh=mesh4).search(case["queries"], k=k)
    (vals, idx), _single, _built = out["index_dot"][k]
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    np.testing.assert_allclose(vals, np.asarray(want_v), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["index_cosine", "index_quantized",
                                  "index_poincare_q"])
def test_sharded_index_holds_a_block_a_rank(world, name):
    """Each rank holds ceil(N / 4) rows of its candidate copy and its own
    rows of the f32 gallery (the capacity argument); rows and the feature
    dict come back whole."""
    cases, out, _ = world
    n = len(cases[name]["gallery"])
    per = -(-n // RANKS)
    rows = out[name]["local_rows"]
    assert [r[0] for r in rows] == [min(per, n - i * per)
                                    for i in range(RANKS)]
    if name != "index_cosine":
        assert {r[1] for r in rows} == {per}
    np.testing.assert_array_equal(out[name]["row5"],
                                  cases[name]["gallery"][5])
    np.testing.assert_array_equal(out[name]["features"],
                                  cases[name]["gallery"][7])


@pytest.mark.parametrize("name", ["index_cosine", "index_quantized",
                                  "index_poincare_q"])
@pytest.mark.parametrize("src", ["numpy", "tensor"])
def test_sharded_index_keeps_no_storage_of_the_gallery(world, name, src):
    """Built from a numpy gallery or from an f32 tensor on the rank's
    device (which a slice would view), each rank's f32 rows are a copy of
    its block: storage of its rows' bytes alone, none of the gallery's."""
    cases, out, _ = world
    n, d = cases[name]["gallery"].shape
    per = -(-n // RANKS)
    held = [r[["numpy", "tensor"].index(src)] for r in out[name]["held"]]
    assert [h[0] for h in held] == [4 * d * min(per, n - i * per)
                                    for i in range(RANKS)]
    assert not any(h[1] for h in held)


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_hyperbolic_engine_encodes_a_block_a_rank(world, quantized):
    """HyperbolicRetrievalEngine(mesh=...) answers as one process's engine
    (names equal, −distances within 2e-4 as the sharded index's), each
    rank encoding and holding only its block of the gallery."""
    cases, out, _ = world
    res = out["hyp_engine"][quantized]
    for got, want in zip(res["sharded"], res["single"]):
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=2e-4,
                                   atol=2e-4)
    n = len(cases["hyp_engine"]["gallery"])
    per = -(-n // RANKS)
    assert res["bytes"] == [4 * 8 * min(per, n - i * per)
                            for i in range(RANKS)]


def test_follower_loop_service_and_stats(world):
    """Rank 0 serves the sharded index over HTTP while ranks 1-3 follow:
    /stats says sharded, a features search and a name search answer as the
    exact scan does, every follower joined both searches and the row
    fetch, and the index saved from rank 0 is the whole gallery."""
    cases, out, tmp = world
    res = out["service"]
    g, q = cases["service"]["gallery"], cases["service"]["queries"]
    assert res["stats"]["sharded"] is True
    assert res["stats"]["gallery_size"] == len(g)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=-1, keepdims=True)
    want = np.argsort(-(qn @ gn.T), axis=1, kind="stable")[:, :5]
    got = [[int(r["name"][1:-4]) for r in row]
           for row in res["features"]["results"]]
    assert got == want.tolist()
    by_name = [int(r["name"][1:-4]) for r in res["name"]["results"][0]]
    assert by_name == np.argsort(-(gn[9] @ gn.T), kind="stable")[:4].tolist()
    assert res["served"][0] == -1 and res["served"][1:] == [3] * (RANKS - 1)
    np.testing.assert_array_equal(np.load(f"{tmp}/sharded.npy"), g)
