"""Decoded-u8 image cache: one decode, many encode passes (the port's copy
of patent_tpu/input/cache.py, without its ``vacuum``).

Post-resize RGB rows, [S, S, 3] uint8, live in ONE append-only file,
``decoded_<S>.u8``, beside a JSON manifest keyed by absolute source path
and its (mtime_ns, size) signature; a changed source file misses and is
decoded again.  The files are the JAX package's, so both packages share a
cache directory: a manifest whose generation disagrees with the
``decoded_<S>.gen`` sidecar (left by a vacuum that did not finish) is
dropped.  One writer process at a time; reads are ``os.pread`` and safe
from any thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import numpy as np

log = logging.getLogger(__name__)

_MANIFEST_FLUSH_EVERY = 512


class DecodedU8Cache:
    """``get(path)`` → the cached row or None; ``put(path, row)`` appends;
    ``flush()`` writes the manifest; ``close()`` flushes and closes."""

    def __init__(self, cache_dir: str, image_size: int):
        self.image_size = int(image_size)
        self.row_bytes = self.image_size * self.image_size * 3
        os.makedirs(cache_dir, exist_ok=True)
        stem = os.path.join(cache_dir, f"decoded_{self.image_size}")
        self.data_path = stem + ".u8"
        self.manifest_path = stem + ".json"
        self._generation = self._read_generation(stem + ".gen")
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._appends_since_flush = 0
        self._closed = False
        size = (os.path.getsize(self.data_path)
                if os.path.exists(self.data_path) else 0)
        if size % self.row_bytes:
            # a partial trailing row (crash mid-append) would misalign
            # every later append
            size -= size % self.row_bytes
            log.warning("cache data file %s has a partial trailing row; "
                        "truncating to %d bytes", self.data_path, size)
            os.truncate(self.data_path, size)
        try:
            with open(self.manifest_path) as f:
                manifest = json.load(f)
            if (manifest.get("image_size") == self.image_size
                    and int(manifest.get("generation", 0)) == self._generation):
                self._entries = {
                    k: {"row": int(v["row"]), "sig": list(v["sig"])}
                    for k, v in manifest.get("entries", {}).items()}
        except FileNotFoundError:
            pass
        except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
            self._entries = {}
            log.warning("unreadable cache manifest %s (%s); rebuilding",
                        self.manifest_path, e)
        # rows past the manifest (crash between append and flush) are dead
        # space; new rows land after them
        self._n_rows = size // self.row_bytes
        self._entries = {k: v for k, v in self._entries.items()
                         if v["row"] < self._n_rows}
        self._append_f = open(self.data_path, "ab")
        self._read_fd = os.open(self.data_path, os.O_RDONLY)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _read_generation(path: str) -> int:
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return 0

    @staticmethod
    def _sig(path: str) -> list[int] | None:
        try:
            st = os.stat(path)
            return [st.st_mtime_ns, st.st_size]
        except OSError:
            return None

    def get(self, path: str) -> np.ndarray | None:
        """The cached [S, S, 3] uint8 row of ``path``; None on a miss or a
        stale entry."""
        key = os.path.abspath(path)
        sig = self._sig(key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry["sig"] != sig:
                self.misses += 1
                return None
            offset = entry["row"] * self.row_bytes
        buf = os.pread(self._read_fd, self.row_bytes, offset)
        with self._lock:
            if len(buf) != self.row_bytes:      # truncated file: a miss
                self.misses += 1
                return None
            self.hits += 1
        return np.frombuffer(buf, np.uint8).reshape(
            self.image_size, self.image_size, 3)

    def put(self, path: str, arr: np.ndarray) -> None:
        """Append a decoded row (thread-safe; the last writer wins)."""
        if arr.shape != (self.image_size, self.image_size, 3) \
                or arr.dtype != np.uint8:
            raise ValueError(f"expected [{self.image_size}, "
                             f"{self.image_size}, 3] uint8, got "
                             f"{arr.shape} {arr.dtype}")
        key = os.path.abspath(path)
        sig = self._sig(key)
        if sig is None:
            return
        data = np.ascontiguousarray(arr).tobytes()
        with self._lock:
            self._append_f.write(data)
            self._entries[key] = {"row": self._n_rows, "sig": sig}
            self._n_rows += 1
            self._appends_since_flush += 1
            if self._appends_since_flush >= _MANIFEST_FLUSH_EVERY:
                self._flush_locked()

    def _flush_locked(self) -> None:
        self._append_f.flush()
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"image_size": self.image_size,
                       "generation": self._generation,
                       "entries": self._entries}, f)
        os.replace(tmp, self.manifest_path)
        self._appends_since_flush = 0

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        """Flush and close; a second call does nothing."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._flush_locked()
            self._append_f.close()
            os.close(self._read_fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return len(self._entries)
