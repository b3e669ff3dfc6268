"""Retrieval HTTP server: production serving of the index (port of
patent_tpu/retrieval/server.py; numpy and the standard library only).

A threaded stdlib HTTP server over the port's ``RetrievalEngine`` and
``EmbeddingIndex``.

Endpoints:
  GET  /healthz           → {"status": "ok", "gallery_size": N}
  GET  /stats             → index + engine configuration
  POST /search            → body {"features": [[...]] | "image_path": str |
                                  "name": str, "k": int}
                            → ranked [{name, score}] lists
  POST /search_by_name    → the same body, by an already-indexed item

One writer on the device, with cross-request micro-batching: concurrent
feature and name searches coalesce into one top-k dispatch of the index
(``MicroBatcher`` below) instead of one dispatch per request, since at
serving rates the per-dispatch overhead, not the scoring product, bounds
serialized throughput.  Every touch of the card (a coalesced search, an
``image_path`` encode and search, a gallery row) happens under the
service's one device lock, on the thread's current stream.

Over a sharded index (``EmbeddingIndex(mesh=...)``) the mesh axis's rank 0
serves HTTP and leads: each search or row request it makes is first
broadcast to the other ranks, which run ``follow(engine)`` and join the
collective search, until ``RetrievalService.close()`` releases them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _bucket(n: int) -> int:
    """Next power of two ≥ n.  A coalesced batch pads its rows and its k to
    these buckets, as the JAX package does.  There the buckets bound the
    set of compiled shapes; here the k bucket is kept because it is part
    of the function: it sets the index's candidate pool (``rerank_mult`` ·
    k), and the pool decides the one case in which the candidate stage
    answers otherwise than the exact scan (more than two exact duplicates
    of a row in one bucket, ``index.topk_search_cosine_fast``).  With the
    same buckets a request gets the answer JAX's server gives it.  Zero
    pad rows are harmless: the index clamps their norm."""
    b = 1
    while b < n:
        b <<= 1
    return b


class _Req:
    __slots__ = ("feats", "k", "done", "vals", "idx", "error")

    def __init__(self, feats: np.ndarray, k: int):
        self.feats = feats
        self.k = k
        self.done = False            # guarded by the batcher's condition
        self.vals = None
        self.idx = None
        self.error: Exception | None = None


class MicroBatcher:
    """Coalesce concurrent searches into single device dispatches.

    An elected dispatcher, no thread of its own: a caller that finds no
    active dispatcher elects itself, dispatches ONE ``index.search`` per
    coalesced batch of stacked feature rows, and keeps dispatching only
    until its own request is served, then hands off (a pending caller
    wakes and elects itself).  Requests that arrive while a batch holds
    the device join the next batch.  Query rows and k are padded to
    power-of-two buckets (``_bucket``).

    Hand-off matters as much as gathering: a dispatcher that drains until
    the queue is empty gets trapped serving other clients' waves while its
    own client cannot resubmit, and that client then runs every later
    request alone, outside the waves.

    The gather is adaptive: the bounded follower wait (``max_wait_s``,
    2 ms by default) runs only when concurrency has been seen recently (a
    request arrived while another was pending or dispatching within the
    last ``idle_gap_s``, 2 s by default) or is visible in the queue now.
    A lone request, or one client issuing requests back to back, pays only
    a 0.3 ms micro-gather, which tells a true solo from the front of a
    simultaneous burst: a burst's siblings enqueue within it, the full
    wait re-engages, and the first wave forms whole.

    The gather happens after the device lock is taken, just before the
    batch is taken, so waves stay phase-aligned: when a dispatch
    completes, its clients resubmit while the next dispatcher takes the
    lock, and a wait under the lock lets every just-woken client catch
    that dispatch.
    """

    def __init__(self, index, device_lock: threading.Lock | None = None,
                 max_wait_s: float = 0.002, max_rows: int = 1024,
                 idle_gap_s: float | None = None):
        self.index = index
        self.dim = int(index.embeddings.shape[1])
        self.max_wait_s = max_wait_s
        self.max_rows = max_rows
        # the gather wait runs only if a follower was sighted (a request
        # arrived while another was pending) within this window; None →
        # 2 s (the cost of a stale True is one gather, the cost of a
        # premature False a splintered wave)
        self.idle_gap_s = idle_gap_s if idle_gap_s is not None else 2.0
        self._cv = threading.Condition()
        self._device_lock = device_lock or threading.Lock()
        self._pending: list[_Req] = []
        self._dispatcher_active = False
        self._last_follower = float("-inf")
        self.dispatches = 0           # device calls (observability + tests)
        self.requests = 0
        self.solo_fastpaths = 0       # dispatches that skipped the gather

    def search(self, feats: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Blocking per-request API; thread-safe.  Returns (vals [q, k],
        idx [q, k]) for this request's rows only.

        Validates the shape before enqueueing: a malformed request must
        fail alone, not poison the concatenation of everyone sharing its
        coalesced batch."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[0] < 1 or feats.shape[1] != self.dim:
            raise ValueError(
                f"features must be [q, {self.dim}], got {feats.shape}")
        if feats.shape[0] > self.max_rows:
            # max_rows bounds single requests too: one oversized payload
            # would otherwise drive an unbounded padded concatenation and a
            # dispatch whose failure lands on every coalesced request
            raise ValueError(
                f"request rows {feats.shape[0]} exceed max_rows "
                f"{self.max_rows}; split the query batch")
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        req = _Req(feats, int(k))
        with self._cv:
            if self._pending or self._dispatcher_active:
                self._last_follower = time.monotonic()   # concurrency seen
            self._pending.append(req)
            self.requests += 1
        while True:
            # election and dispatch are exception-atomic: `elected` is set
            # in the locked region that sets the flag, and the finally
            # always releases an election this thread won, so no exception
            # can leave _dispatcher_active set with no dispatcher
            elected = False
            try:
                with self._cv:
                    if req.done:
                        break
                    if self._dispatcher_active:
                        # wake on hand-off or completion; the timeout
                        # re-checks, so a dead dispatcher is replaced
                        self._cv.wait(timeout=1.0)
                        continue
                    elected = True
                    self._dispatcher_active = True
                self._dispatch_until_served(req)
            finally:
                if elected:
                    with self._cv:
                        self._dispatcher_active = False
                        self._cv.notify_all()   # next dispatcher elects
        if req.error is not None:
            raise req.error
        return req.vals, req.idx

    def _dispatch_until_served(self, own: _Req) -> None:
        """Dispatch coalesced batches until ``own`` is served, then hand
        off (not drain-until-empty: see the class docstring).  The caller's
        finally block wakes a pending follower to take over."""
        while True:
            with self._device_lock:
                # gather under the device lock: just-woken clients of the
                # previous dispatch catch this one.  Skipped when no
                # concurrency was sighted within idle_gap_s and none is
                # queued: a solo or serial stream pays no wait
                if self.max_wait_s > 0:
                    with self._cv:
                        armed = (len(self._pending) > 1
                                 or (time.monotonic() - self._last_follower
                                     <= self.idle_gap_s))
                    if armed:
                        time.sleep(self.max_wait_s)
                    else:
                        # the first request out of idle may be a true solo
                        # or the front of a simultaneous burst: a burst's
                        # siblings enqueue within the micro-gather
                        time.sleep(min(3e-4, self.max_wait_s))
                        with self._cv:
                            burst = len(self._pending) > 1
                        if burst:
                            time.sleep(self.max_wait_s)
                        else:
                            self.solo_fastpaths += 1
                with self._cv:
                    take = 0
                    rows = 0
                    while take < len(self._pending) and rows < self.max_rows:
                        rows += self._pending[take].feats.shape[0]
                        take += 1
                    batch = self._pending[:take]
                    self._pending = self._pending[take:]
                if not batch:
                    return
                try:
                    feats = np.concatenate([r.feats for r in batch], axis=0)
                    n_rows = feats.shape[0]
                    pad_rows = _bucket(n_rows)
                    if pad_rows != n_rows:
                        feats = np.pad(feats,
                                       ((0, pad_rows - n_rows), (0, 0)))
                    kmax = min(_bucket(max(r.k for r in batch)),
                               len(self.index))
                    vals, idx = self.index.search(feats, k=kmax)
                    self.dispatches += 1
                    row = 0
                    for r in batch:
                        q = r.feats.shape[0]
                        kk = min(r.k, kmax)
                        r.vals = vals[row:row + q, :kk]
                        r.idx = idx[row:row + q, :kk]
                        row += q
                except Exception as e:  # deliver to all waiters, don't wedge
                    for r in batch:
                        r.error = e
                finally:
                    with self._cv:
                        for r in batch:
                            r.done = True
                        self._cv.notify_all()
            with self._cv:
                if own.done or not self._pending:
                    return


class RetrievalService:
    """The request-serving core (separate from HTTP so it is testable).

    ``data_root`` bounds the filesystem surface of the ``image_path`` search
    mode: only files under this directory (after symlink resolution) may be
    read.  With ``data_root=None`` the mode is disabled: a server reachable
    beyond localhost must never read arbitrary files.
    """

    def __init__(self, engine, data_root: str | None = None,
                 batch_wait_s: float = 0.002):
        self.engine = engine
        self.data_root = (os.path.realpath(data_root)
                          if data_root is not None else None)
        self._device_lock = threading.Lock()
        if engine.index is None:
            raise ValueError("engine has no index; encode_dataset first")
        # any object with the index's search surface can be served; only
        # an EmbeddingIndex over a mesh leads followers
        self._sharded = getattr(engine.index, "mesh", None) is not None
        if self._sharded:
            engine.index.lead()
        # feature and name searches coalesce across requests; image_path
        # searches (encode + search) share the same device lock, so the two
        # modes never race on the card
        self.batcher = MicroBatcher(engine.index,
                                    device_lock=self._device_lock,
                                    max_wait_s=batch_wait_s)
        self._base_map: dict[str, int] | None = None   # lazy, _resolve_name

    def _resolve_image_path(self, path: str) -> str | None:
        """realpath-prefix containment check; None = denied or missing.
        Denied and missing return the same caller-visible error, so the
        endpoint cannot probe for a file's existence."""
        if self.data_root is None:
            return None
        real = os.path.realpath(os.path.join(self.data_root, path))
        if not (real == self.data_root
                or real.startswith(self.data_root + os.sep)):
            return None
        return real if os.path.isfile(real) else None

    def close(self) -> None:
        """Release the followers of a sharded index (a no-op otherwise)."""
        if self._sharded:
            with self._device_lock:
                self.engine.index.release()

    def healthz(self) -> dict:
        return {"status": "ok", "gallery_size": len(self.engine.index)}

    def stats(self) -> dict:
        idx = self.engine.index
        return {
            "gallery_size": len(idx),
            "dim": int(idx.embeddings.shape[1]),
            "similarity": idx.similarity,
            "curvature": idx.c,
            "sharded": idx.mesh is not None,
            "batch_size": self.engine.batch_size,
            "image_size": self.engine.image_size,
        }

    def _named(self, vals: np.ndarray, idx: np.ndarray) -> list:
        names = self.engine.index.names
        return [[(names[j], float(v)) for j, v in zip(ri, rv)]
                for ri, rv in zip(idx, vals)]

    def _resolve_name(self, name: str) -> int | None:
        """Gallery row for a name: the exact stored name first, then a
        unique basename, since /search answers with basenames and a client
        must be able to feed one back.  None if unknown, −1 if the basename
        is ambiguous.  The basename map is built once (the index is
        static)."""
        names = self.engine.index.names
        try:
            return names.index(name)
        except ValueError:
            pass
        if self._base_map is None:
            # benign if two threads race here: the maps are identical
            base_map: dict[str, int] = {}
            for i, n in enumerate(names):
                b = os.path.basename(n)
                base_map[b] = -1 if b in base_map else i
            self._base_map = base_map
        return self._base_map.get(name)

    def search(self, payload: dict) -> dict:
        # validate the envelope before any branch: valid JSON of the wrong
        # shape (an array, a string or None k, a negative k) gets a 400,
        # not an uncaught exception that drops the connection
        if not isinstance(payload, dict):
            return {"error": "body must be a JSON object", "_status": 400}
        try:
            k = int(payload.get("k", 10))
        except (TypeError, ValueError):
            return {"error": f"k must be an integer, got "
                             f"{payload.get('k')!r}", "_status": 400}
        if k < 1:
            return {"error": f"k must be >= 1, got {k}", "_status": 400}
        if "features" in payload:
            try:
                feats = np.asarray(payload["features"], np.float32)
                if feats.ndim == 1:
                    feats = feats[None]
                results = self._named(*self.batcher.search(feats, k))
            except (ValueError, TypeError) as e:
                # ragged rows, wrong width, bad k: this request alone gets
                # a 400 (the batcher validates before enqueueing)
                return {"error": str(e), "_status": 400}
        elif "name" in payload:
            row = self._resolve_name(str(payload["name"]))
            if row is None:
                return {"error": f"unknown gallery item: {payload['name']}",
                        "_status": 404}
            if row < 0:
                return {"error": f"ambiguous gallery item (basename "
                                 f"matches multiple rows): "
                                 f"{payload['name']}", "_status": 400}
            # the stored row, copied to the host (a sharded index fetches
            # it from the rank that holds it, a collective)
            with self._device_lock:
                q = self.engine.index.row(row)
            results = self._named(*self.batcher.search(q[None], k))
        elif "image_path" in payload:
            real = self._resolve_image_path(str(payload["image_path"]))
            if real is None:
                return {"error": "image_path unavailable (must name an "
                                 "existing file under the configured "
                                 "data root)", "_status": 400}
            # decode + encode + search under the shared lock; the engine's
            # decoded-image cache is touched only here
            try:
                with self._device_lock:
                    results = [self.engine.retrieve_similar_images(real,
                                                                   k=k)]
            except ValueError as e:
                # an existing but undecodable file: a 400, not a 500
                return {"error": str(e), "_status": 400}
        else:
            return {"error": "body needs 'features', 'image_path' or "
                             "'name'", "_status": 400}
        return {"results": [[{"name": os.path.basename(n), "score": s}
                             for n, s in row] for row in results]}


class _Handler(BaseHTTPRequestHandler):
    service: RetrievalService = None  # set by serve()
    # socket timeout: a client that stalls mid-body (or never sends one)
    # must not pin a server thread forever
    timeout = 120
    _MAX_BODY = 64 * 1024 * 1024      # 64 MB JSON cap

    def _send(self, obj: dict, status: int = 200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(self.service.healthz())
        elif self.path == "/stats":
            self._send(self.service.stats())
        else:
            self._send({"error": "unknown endpoint"}, 404)

    def do_POST(self):
        if self.path not in ("/search", "/search_by_name"):
            self._send({"error": "unknown endpoint"}, 404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length < 0 or length > self._MAX_BODY:
                # a negative length would make read(-1) block until the
                # client's EOF; a huge body is refused before it is read
                self._send({"error": f"bad Content-Length: {length}"}, 400)
                return
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send({"error": f"bad JSON body: {e}"}, 400)
            return
        try:
            out = self.service.search(payload)
        except Exception as e:   # the client always gets a response, never
            # a dropped connection (search 400s the known malformed shapes)
            self._send({"error": f"{type(e).__name__}: {e}"}, 500)
            return
        status = out.pop("_status", 200)
        self._send(out, status)

    def log_message(self, fmt, *args):  # quiet by default
        pass


def serve(engine, host: str = "127.0.0.1", port: int = 8777,
          block: bool = True,
          data_root: str | None = None) -> ThreadingHTTPServer:
    """Start the retrieval server; returns the server object (with
    ``block=False`` it runs on a daemon thread; ``server.service.close()``
    after ``server.shutdown()`` releases a sharded index's followers).
    ``data_root`` opts in to the image_path search mode, restricted to
    that directory (see ``RetrievalService``)."""
    service = RetrievalService(engine, data_root=data_root)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.service = service
    if block:
        print(f"[patent_tpu_torch] serving retrieval on http://{host}:{port}",
              flush=True)
        try:
            server.serve_forever()
        finally:
            service.close()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server


def follow(engine) -> int:
    """On a rank other than 0 of a sharded index's axis: join every
    search the serving rank makes until its service closes; returns the
    requests served."""
    return engine.index.follow()
