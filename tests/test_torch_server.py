"""The port's retrieval server (patent_tpu_torch/retrieval/server.py and
the CLI's serve action) on the CPU.

Every case of tests/test_server.py runs here against the port: a live
server over the port's ``RetrievalEngine`` with the JAX fixture's tiny
tower shape, and the ``MicroBatcher`` cases with the same stub index.
Then the parity with the JAX package: one seeded gallery of features
through both packages' ``RetrievalService.search`` (no HTTP), and the
``image_path`` mode of both over one synthetic gallery with one set of
tower weights.  Last, the serve action through the helper the CLI calls
(``run_serve_action``), on the CLI's synthetic corpus, twice: the second
start, in a fresh interpreter that must not load JAX or the JAX package,
loads the saved index instead of encoding.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patent_tpu.data import synthetic as jax_synthetic
from patent_tpu.models.vit import VisionConfig as JaxVisionConfig
from patent_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from patent_tpu.retrieval import RetrievalEngine as JaxRetrievalEngine
from patent_tpu.retrieval.index import EmbeddingIndex as JaxEmbeddingIndex
from patent_tpu.retrieval.server import RetrievalService as JaxService
from patent_tpu_torch.cli.main import parse_args
from patent_tpu_torch.data import synthetic
from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
from patent_tpu_torch.models.weights import params_from_jax
from patent_tpu_torch.retrieval.cli_actions import run_serve_action
from patent_tpu_torch.retrieval.engine import (RetrievalEngine,
                                               make_device_normalizing_encoder)
from patent_tpu_torch.retrieval.index import EmbeddingIndex
from patent_tpu_torch.retrieval.server import (MicroBatcher,
                                               RetrievalService, serve)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_server.py's tower
TINY = dict(image_size=32, patch_size=8, hidden_dim=32, num_layers=1,
            num_heads=4, mlp_dim=64, projection_dim=16)


def _tiny_engine(seed=0):
    model = VisionTransformer(VisionConfig(**TINY), dtype=torch.float32,
                              generator=torch.Generator().manual_seed(seed))
    return RetrievalEngine(make_device_normalizing_encoder(model.eval(),
                                                           "cpu"),
                           "cpu", batch_size=4, image_size=32, num_workers=2)


@pytest.fixture(scope="module")
def live_server(tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    _records, images_dir = synthetic.write_synthetic_corpus(
        str(root), num_patents=5, figures_per_patent=3, image_size=32)
    engine = _tiny_engine()
    paths = sorted(os.path.join(images_dir, f) for f in os.listdir(images_dir))
    engine.encode_dataset(paths)
    server = serve(engine, port=0, block=False,   # ephemeral port
                   data_root=images_dir)
    host, port = server.server_address
    yield f"http://{host}:{port}", engine, paths
    server.shutdown()
    server.server_close()
    engine.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_and_stats(live_server):
    base, engine, _ = live_server
    status, body = _get(base + "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["gallery_size"] == len(engine.index)
    status, stats = _get(base + "/stats")
    assert status == 200 and stats["similarity"] == "cosine"
    assert stats["sharded"] is False and stats["dim"] == 16


def test_search_by_features(live_server):
    base, engine, _ = live_server
    q = engine.index.embeddings[0].numpy()
    status, body = _post(base + "/search", {"features": q.tolist(), "k": 3})
    assert status == 200
    results = body["results"][0]
    assert len(results) == 3
    # nearest neighbor of an indexed vector is itself
    assert results[0]["name"] == os.path.basename(engine.index.names[0])
    assert results[0]["score"] == pytest.approx(1.0, abs=1e-4)


def test_search_by_image_path(live_server):
    base, _engine, paths = live_server
    status, body = _post(base + "/search", {"image_path": paths[0], "k": 2})
    assert status == 200
    assert len(body["results"][0]) == 2
    # relative paths resolve against data_root
    status, body = _post(base + "/search",
                         {"image_path": os.path.basename(paths[0]), "k": 2})
    assert status == 200


def test_image_path_disabled_without_data_root():
    """With no data_root the image_path mode is off regardless of payload."""
    class _FakeIndex:
        embeddings = np.zeros((1, 8), np.float32)

        def __len__(self):
            return 1

    class _FakeEngine:
        index = _FakeIndex()

    svc = RetrievalService(_FakeEngine())
    out = svc.search({"image_path": "/etc/hostname"})
    assert out["_status"] == 400 and "unavailable" in out["error"]


def test_search_by_name_and_errors(live_server):
    base, engine, _ = live_server
    name = engine.index.names[1]
    status, body = _post(base + "/search", {"name": name, "k": 2})
    assert status == 200
    assert body["results"][0][0]["name"] == os.path.basename(name)
    # unknown name → 404
    status, body = _post(base + "/search", {"name": "nope.png"})
    assert status == 404 and "unknown gallery item" in body["error"]
    # missing file → 400
    status, body = _post(base + "/search", {"image_path": "/no/such.png"})
    assert status == 400
    missing_err = body["error"]
    # containment: a file that exists outside data_root is refused with the
    # same error as a missing one (no existence oracle)
    status, body = _post(base + "/search",
                         {"image_path": "../../../../etc/hostname"})
    assert status == 400 and body["error"] == missing_err
    status, body = _post(base + "/search", {"image_path": "/etc/hostname"})
    assert status == 400 and body["error"] == missing_err
    # empty body → 400
    status, body = _post(base + "/search", {})
    assert status == 400
    # garbage JSON → 400
    req = urllib.request.Request(base + "/search", data=b"not json",
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        raised = False
    except urllib.error.HTTPError as e:
        raised = e.code == 400
    assert raised
    status, _ = _get(base + "/healthz")  # still alive after the error barrage
    assert status == 200


# ------------------------------------------------------- micro-batching

class _CountingIndex:
    """Index stub with a fixed per-dispatch cost, so batching wins are
    deterministic: serialized throughput is bounded by the dispatch count,
    and coalescing N requests into one dispatch shows up directly."""

    def __init__(self, n=64, dim=8, dispatch_s=0.01):
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((n, dim)).astype(np.float32)
        self.embeddings = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        self.names = [f"g{i}.png" for i in range(n)]
        self.dispatch_s = dispatch_s
        self.calls = 0
        self._mu = threading.Lock()

    def __len__(self):
        return len(self.names)

    def search(self, queries, k=10):
        with self._mu:
            self.calls += 1
        time.sleep(self.dispatch_s)    # the per-dispatch overhead stand-in
        q = np.asarray(queries, np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        s = q @ self.embeddings.T
        idx = np.argsort(-s, axis=1)[:, :k]
        return np.take_along_axis(s, idx, axis=1), idx


def test_microbatch_correctness_under_concurrency():
    """N threads hammering the batcher get exactly the answers a lone
    serial search would produce, per request, regardless of coalescing."""
    idx = _CountingIndex(n=128, dim=16, dispatch_s=0.002)
    batcher = MicroBatcher(idx, max_wait_s=0.002)
    rng = np.random.default_rng(1)
    queries = rng.standard_normal((24, 2, 16)).astype(np.float32)
    ks = [int(k) for k in rng.integers(1, 9, 24)]
    got: list = [None] * 24
    errs: list = []

    def worker(i):
        try:
            got[i] = batcher.search(queries[i], ks[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    for i in range(24):
        vals, res = got[i]
        oracle = _CountingIndex(n=128, dim=16)
        want_vals, want_idx = oracle.search(queries[i], k=ks[i])
        assert res.shape == (2, ks[i])
        np.testing.assert_array_equal(res, want_idx)
        np.testing.assert_allclose(vals, want_vals, rtol=1e-5)
    # concurrency must have coalesced: far fewer dispatches than requests
    assert idx.calls < 24


def test_microbatch_throughput_vs_serialized():
    """N concurrent clients through the micro-batcher sustain ≥ 3× the
    serialized (a dispatch a request) QPS.  The stub charges a fixed 10 ms
    a dispatch, so the serialized baseline is deterministic (~100 QPS) and
    the batched run's gain comes only from coalescing."""
    n_clients, n_reqs = 8, 6
    rng = np.random.default_rng(2)
    queries = rng.standard_normal((n_clients, n_reqs, 1, 8)).astype(
        np.float32)

    # serialized baseline: one dispatch a request under a single lock
    idx0 = _CountingIndex(dispatch_s=0.01)
    lock = threading.Lock()
    t0 = time.perf_counter()
    for c in range(n_clients):
        for r in range(n_reqs):
            with lock:
                idx0.search(queries[c, r], k=5)
    serial_qps = (n_clients * n_reqs) / (time.perf_counter() - t0)

    idx1 = _CountingIndex(dispatch_s=0.01)
    batcher = MicroBatcher(idx1, max_wait_s=0.002)
    errs: list = []

    def client(c):
        try:
            for r in range(n_reqs):
                batcher.search(queries[c, r], k=5)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batched_qps = (n_clients * n_reqs) / (time.perf_counter() - t0)
    assert not errs
    assert idx1.calls < idx0.calls / 2, \
        f"no coalescing: {idx1.calls} vs {idx0.calls} dispatches"
    assert batched_qps >= 3.0 * serial_qps, \
        f"batched {batched_qps:.0f} QPS < 3x serialized {serial_qps:.0f}"


def test_microbatch_k_exceeding_gallery_clamps():
    idx = _CountingIndex(n=8, dim=8)
    batcher = MicroBatcher(idx, max_wait_s=0.0)
    _vals, res = batcher.search(np.ones((1, 8), np.float32), k=50)
    assert res.shape[1] == 8      # clamped to gallery size


def test_microbatch_drains_truncated_batch_leftovers():
    """Requests past the max_rows cap must not be left in the queue with
    no dispatcher: the dispatching caller drains the queue, so an over-cap
    burst completes promptly."""
    idx = _CountingIndex(n=64, dim=8, dispatch_s=0.001)
    # cap at 4 rows; 6 concurrent 3-row requests => at least one truncation
    batcher = MicroBatcher(idx, max_wait_s=0.01, max_rows=4)
    rng = np.random.default_rng(2)
    queries = rng.standard_normal((6, 3, 8)).astype(np.float32)
    got: list = [None] * 6
    errs: list = []

    def worker(i):
        try:
            got[i] = batcher.search(queries[i], 5)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    wall = time.perf_counter() - t0
    assert not errs
    assert all(g is not None for g in got), "leftover request stalled"
    assert wall < 10.0, f"drain took {wall:.1f}s — leftovers had no leader"
    oracle = _CountingIndex(n=64, dim=8)
    for i in range(6):
        vals, res = got[i]
        want_vals, want_idx = oracle.search(queries[i], k=5)
        np.testing.assert_array_equal(res, want_idx)
        np.testing.assert_allclose(vals, want_vals, rtol=1e-5)


def test_microbatch_rejects_malformed_before_enqueue():
    """A bad request (wrong feature width, ragged rows, k < 1) fails alone
    with ValueError; a concurrent valid request in the same window still
    gets its answer (no batch poisoning through np.concatenate)."""
    idx = _CountingIndex(n=64, dim=8, dispatch_s=0.002)
    batcher = MicroBatcher(idx, max_wait_s=0.02)
    results: dict = {}

    def good():
        results["good"] = batcher.search(np.ones((2, 8), np.float32), 4)

    def bad():
        try:
            batcher.search(np.ones((1, 3), np.float32), 4)   # wrong dim
        except ValueError as e:
            results["bad"] = str(e)

    threads = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert "features must be [q, 8]" in results["bad"]
    _vals, res = results["good"]
    assert res.shape == (2, 4)
    with pytest.raises(ValueError):
        batcher.search(np.ones((2, 2, 8), np.float32), 4)    # not 2-D
    with pytest.raises(ValueError):
        batcher.search(np.ones((1, 8), np.float32), 0)       # k < 1


def test_microbatch_error_propagates_to_all_waiters():
    class _Boom(_CountingIndex):
        def search(self, queries, k=10):
            raise RuntimeError("device on fire")

    batcher = MicroBatcher(_Boom(), max_wait_s=0.005)
    errs = []

    def worker():
        try:
            batcher.search(np.ones((1, 8), np.float32), k=3)
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(errs) == 4 and all("device on fire" in e for e in errs)


def test_microbatch_solo_requests_skip_wait():
    """With no concurrency sighted, a leader skips the follower wait: a
    solo request's latency is about the un-batched dispatch, and a serial
    client stream pays no wait either."""
    idx = _CountingIndex(n=64, dim=8, dispatch_s=0.0)
    # a wait window that would dominate latency if not skipped
    batcher = MicroBatcher(idx, max_wait_s=0.25)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 8)).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(4):                  # serial stream: never concurrent
        batcher.search(q, 5)
    elapsed = time.perf_counter() - t0
    assert elapsed < 0.25, f"serial stream paid the wait tax: {elapsed:.3f}s"
    assert batcher.solo_fastpaths == 4
    assert idx.calls == 4


def test_microbatch_wait_rearms_under_concurrency():
    """Once a follower is sighted, later leaders inside the idle window
    wait again (coalescing preserved); after the window passes idle,
    leaders go back to the fast path."""
    idx = _CountingIndex(n=64, dim=8, dispatch_s=0.02)
    batcher = MicroBatcher(idx, max_wait_s=0.01, idle_gap_s=0.2)
    rng = np.random.default_rng(6)
    queries = rng.standard_normal((12, 1, 8)).astype(np.float32)

    def worker(i):
        batcher.search(queries[i], 5)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the burst coalesced, and followers were sighted (re-arming the wait
    # for later leaders)
    assert idx.calls < 12
    assert batcher._last_follower > float("-inf")
    # past the idle window, a solo request takes the fast path again
    time.sleep(0.25)
    before = batcher.solo_fastpaths
    batcher.search(queries[0], 5)
    assert batcher.solo_fastpaths == before + 1


def test_search_by_name_accepts_response_basenames(live_server):
    """/search answers with basenames, so a name search must resolve a
    returned name back to its gallery row: the exact stored name first, a
    unique basename second."""
    base, engine, _ = live_server
    full = engine.index.names[2]
    status, body = _post(base + "/search", {"name": full, "k": 2})
    assert status == 200
    returned = body["results"][0][0]["name"]        # a basename
    assert returned == os.path.basename(full)
    status2, body2 = _post(base + "/search", {"name": returned, "k": 2})
    assert status2 == 200, body2
    assert body2["results"][0][0]["name"] == returned


def test_malformed_payloads_get_http_responses(live_server):
    """Valid JSON of the wrong shape gets a 400 (or a 500 from the
    handler's guard), never a dropped connection."""
    base, _engine, _ = live_server
    for payload, expect in [
        ([1, 2, 3], 400),                       # array, not object
        ({"k": "abc", "name": "x"}, 400),       # non-int k
        ({"k": None, "name": "x"}, 400),
        ({"k": -1, "features": [[0.0] * 8]}, 400),
        ({"features": None}, 400),
        ({"features": {"a": 1}}, 400),
        ({"features": [[0.0] * 8] * 5000}, 400),  # > max_rows single req
    ]:
        status, body = _post(base + "/search", payload)
        assert status == expect, (payload, status, body)
        assert "error" in body
    status, _ = _get(base + "/healthz")
    assert status == 200


# ------------------------------------------------------- JAX parity

N_GALLERY, DIM = 40, 16
PARITY_PAYLOADS = {
    "features-1": {"features": "row 3 + noise", "k": 5},
    "features-3": {"features": "rows 0, 7, 21 + noise", "k": 4},
    "features-flat": {"features": "row 9, 1-D", "k": 3},
    "features-default-k": {"features": "row 11 + noise"},
    "name-full": {"name": "set_b/g5.png", "k": 6},
    "name-basename": {"name": "g17.png", "k": 2},
    "name-ambiguous": {"name": "dup.png", "k": 2},
    "name-unknown": {"name": "nope.png"},
    "k-past-gallery": {"features": "row 2 + noise", "k": 100},
    "name-k-past-gallery": {"name": "g30.png", "k": 64},
    "not-an-object": [1, 2, 3],
    "k-not-int": {"k": "abc", "name": "g1.png"},
    "k-none": {"k": None, "name": "g1.png"},
    "k-negative": {"k": -1, "features": "row 1"},
    "k-zero": {"k": 0, "features": "row 1"},
    "features-none": {"features": None},
    "features-dict": {"features": {"a": 1}},
    "features-wrong-width": {"features": [[0.0] * 8]},
    "features-ragged": {"features": [[1.0, 2.0], [3.0]]},
    "features-3-d": {"features": [[[0.0] * DIM]]},
    "features-too-many-rows": {"features": [[0.0] * DIM] * 1025},
    "empty": {},
    "image-path-disabled": {"image_path": "g1.png"},
}


def _parity_gallery():
    """A seeded gallery: 40 rows of 16 under two directories, one
    basename (dup.png) stored twice."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N_GALLERY, DIM)).astype(np.float32)
    names = [f"set_{'ab'[i % 2]}/g{i}.png" for i in range(N_GALLERY)]
    names[12], names[13] = "set_a/dup.png", "set_b/dup.png"
    return emb, names


def _payload(key, emb):
    """PARITY_PAYLOADS[key] with its feature rows made from the gallery."""
    payload = PARITY_PAYLOADS[key]
    if not isinstance(payload, dict) or not isinstance(
            payload.get("features"), str):
        return payload
    rng = np.random.default_rng(len(key))
    rows = [int(t) for t in payload["features"].replace(",", " ").split()
            if t.isdigit()]
    feats = emb[rows]
    if "noise" in payload["features"]:
        feats = feats + 0.3 * rng.standard_normal(feats.shape).astype(
            np.float32)
    feats = feats[0] if "1-D" in payload["features"] else feats
    return {**payload, "features": feats.tolist()}


@pytest.fixture(scope="module")
def services():
    emb, names = _parity_gallery()
    jengine = JaxRetrievalEngine(lambda b: b, batch_size=4, image_size=32)
    jengine.index = JaxEmbeddingIndex(emb, names)
    tengine = RetrievalEngine(lambda b: b, "cpu", batch_size=4,
                              image_size=32)
    tengine.index = EmbeddingIndex(emb, names, device="cpu")
    return emb, JaxService(jengine), RetrievalService(tengine)


@pytest.mark.parametrize("key", list(PARITY_PAYLOADS))
def test_service_search_matches_jax(services, key):
    """One payload through both packages' ``RetrievalService.search``: the
    same status and error message, or the same names in the same order
    with scores within 1e-6 (both rank by an f32 cosine scan here)."""
    emb, jsvc, tsvc = services
    payload = _payload(key, emb)
    want, got = jsvc.search(payload), tsvc.search(payload)
    assert got.get("_status", 200) == want.get("_status", 200)
    assert got.get("error") == want.get("error")
    assert set(got) == set(want)
    if "results" in want:
        assert len(got["results"]) == len(want["results"]) > 0
        for grow, wrow in zip(got["results"], want["results"]):
            assert [r["name"] for r in grow] == [r["name"] for r in wrow]
            np.testing.assert_allclose([r["score"] for r in grow],
                                       [r["score"] for r in wrow],
                                       rtol=0, atol=1e-6)


def test_service_stats_and_health_match_jax(services):
    _emb, jsvc, tsvc = services
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.healthz() == jsvc.healthz()


# both towers in f32 from one Flax init: the per-op towers (JAX's default)
# differ by summation order only.  Measured: min feature cosine 1 - 1.2e-7,
# and the closest two cosines of one query's ranking 1.1e-6 apart
IMAGE_PATH_MIN_COS = 0.9999


def test_image_path_mode_matches_jax(tmp_path):
    """A JAX tiny ``VisionTransformer`` and its port (``params_from_jax``)
    encode one synthetic gallery and serve the same query file by
    ``image_path``: gallery features within IMAGE_PATH_MIN_COS by cosine,
    the query's ranking of the whole gallery in the identical order."""
    _records, images_dir = jax_synthetic.write_synthetic_corpus(
        str(tmp_path), num_patents=5, figures_per_patent=3, image_size=32)
    paths = sorted(os.path.join(images_dir, f) for f in os.listdir(images_dir))
    jcfg = JaxVisionConfig(**TINY)
    jmodel = JaxVisionTransformer(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    apply_jit = jax.jit(jmodel.apply)
    jengine = JaxRetrievalEngine(lambda b: apply_jit(params, b), batch_size=4,
                                 image_size=32, num_workers=2)
    jengine.encode_dataset(paths)
    tmodel = VisionTransformer(VisionConfig(**TINY), dtype=torch.float32,
                               fused_layer=False)
    tmodel.load_state_dict(params_from_jax(params))
    tengine = RetrievalEngine(make_device_normalizing_encoder(tmodel.eval(),
                                                              "cpu"),
                              "cpu", batch_size=4, image_size=32,
                              num_workers=2)
    tengine.encode_dataset(paths)
    jemb = np.asarray(jengine.index.embeddings)
    temb = tengine.index.embeddings.numpy()
    assert tengine.index.names == jengine.index.names
    cos = np.sum(jemb * temb, -1) / (np.linalg.norm(jemb, axis=-1)
                                     * np.linalg.norm(temb, axis=-1))
    assert cos.min() >= IMAGE_PATH_MIN_COS
    jsvc = JaxService(jengine, data_root=images_dir)
    tsvc = RetrievalService(tengine, data_root=images_dir)
    for query in (paths[4], os.path.basename(paths[9])):
        payload = {"image_path": query, "k": len(paths)}
        want, got = jsvc.search(payload), tsvc.search(payload)
        assert "results" in got and "results" in want
        assert [r["name"] for r in got["results"][0]] == \
            [r["name"] for r in want["results"][0]]
        assert got["results"][0][0]["name"] == os.path.basename(query)
    tengine.close()


# ------------------------------------------------------- the serve action

# the second start runs in a fresh interpreter: it must load the saved
# index (encoding raises), serve a search, and load nothing of JAX
_SECOND_START = """
import json, sys, urllib.request
from patent_tpu_torch.cli.main import parse_args
from patent_tpu_torch.retrieval import engine as engine_mod
from patent_tpu_torch.retrieval.cli_actions import run_serve_action

def refuse(*a, **k):
    raise AssertionError("the second start encoded the gallery")

engine_mod.RetrievalEngine.encode_dataset = refuse
args = parse_args(["serve", "--path", sys.argv[1], "--synthetic",
                   "--device", "cpu", "--port", "0"])
server = run_serve_action(args, block=False)
host, port = server.server_address
with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
    health = json.loads(r.read())
req = urllib.request.Request(
    f"http://{host}:{port}/search", method="POST",
    data=json.dumps({"name": "FIRST", "k": 3}).encode())
with urllib.request.urlopen(req) as r:
    top = json.loads(r.read())["results"][0][0]["name"]
server.shutdown()
server.server_close()
server.RequestHandlerClass.service.engine.close()
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "patent_tpu" or m.startswith("patent_tpu.")]
print(json.dumps({"health": health, "top": top, "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve"))
    args = parse_args(["serve", "--path", path, "--synthetic", "--device",
                       "cpu", "--port", "0"])
    assert args.port == 0
    server = run_serve_action(args, block=False)
    host, port = server.server_address
    yield path, f"http://{host}:{port}", server.RequestHandlerClass.service
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.service.engine.close()


def test_serve_action_serves_the_cli_corpus(served):
    """``serve --synthetic --device cpu --port 0`` through the helper the
    CLI calls: the CLI corpus's 160 gallery figures, encoded and saved
    under the action's index prefix; a search by a stored row answers with
    that row first."""
    path, base, service = served
    status, body = _get(base + "/healthz")
    assert status == 200 and body == {"status": "ok", "gallery_size": 160}
    saved = [f for f in os.listdir(os.path.join(path, "embeddings"))
             if f.endswith(".npy")]
    assert len(saved) == 1 and "_torch_rand" in saved[0]
    index = service.engine.index
    q = index.embeddings[5].numpy()
    status, body = _post(base + "/search", {"features": q.tolist(), "k": 4})
    assert status == 200 and len(body["results"][0]) == 4
    assert body["results"][0][0]["name"] == os.path.basename(index.names[5])
    status, stats = _get(base + "/stats")
    assert status == 200 and stats["gallery_size"] == 160
    assert stats["image_size"] == 64 and stats["batch_size"] == 32


def test_serve_action_second_start_loads_the_saved_index(served):
    """A second start (a fresh interpreter, with encoding refused) loads
    the index the first one saved and answers; it loads nothing of JAX or
    of the JAX package."""
    path, _base, service = served
    first = os.path.basename(service.engine.index.names[0])
    code = _SECOND_START.replace("FIRST", first)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["health"] == {"status": "ok", "gallery_size": 160}
    assert out["top"] == first
    assert out["loaded"] == []
