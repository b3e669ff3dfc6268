"""Host-side image decode into fixed-shape batches (the port's copy of the
serving part of patent_tpu/input/pipeline.py).

Semantics of the reference loader: decode, grayscale and RGBA to RGB,
bilinear resize to ``image_size`` squared, CLIP normalization; a file that
fails to decode is skipped with a warning.  ``ImageBatcher`` decodes on a
thread pool (or the native C++ decoder of ``native/patent_io.cc`` when it
is built) into NHWC numpy batches of one fixed shape; the last partial
batch is zero-padded and carries its count of valid rows.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
from collections import deque
from typing import Iterator, Sequence

import numpy as np

log = logging.getLogger(__name__)

# CLIP preprocessing constants (retrieval.ipynb cell 2)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGE_SIZE = 224

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG"}


def list_images(folder: str) -> list[str]:
    """Image files under ``folder``, recursively, in one global sort."""
    out = []
    for root, _dirs, files in os.walk(folder):
        for f in files:
            if os.path.splitext(f)[1] in VALID_EXTENSIONS:
                out.append(os.path.join(root, f))
    return sorted(out)


def decode_image_u8(path: str, image_size: int = IMAGE_SIZE
                    ) -> np.ndarray | None:
    """One image → [H, W, 3] uint8 RGB, not normalized; None on failure."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            im = im.resize((image_size, image_size), Image.BILINEAR)
            return np.asarray(im, np.uint8)
    except Exception as e:  # failed decode → skip (reference policy)
        log.warning("failed to decode %s: %s", path, e)
        return None


def normalize_array(img: np.ndarray) -> np.ndarray:
    """CLIP-normalize a decoded [H, W, C] uint8 or [0, 1] float array."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[:, :, :3]
    return (img - CLIP_MEAN) / CLIP_STD


def decode_image(path: str, image_size: int = IMAGE_SIZE) -> np.ndarray | None:
    """One image → [H, W, 3] float32, CLIP-normalized; None on failure."""
    arr = decode_image_u8(path, image_size)
    return None if arr is None else normalize_array(arr)


class ImageBatcher:
    """Threaded decode into fixed-shape NHWC batches.

    ``out_dtype``: "f32" yields CLIP-normalized float32 batches, "u8" raw
    uint8 RGB (the encoder normalizes on its device).  ``cache``: an
    optional ``input.cache.DecodedU8Cache``; misses are decoded and
    appended, hits skip the decoder.  The caller owns the cache."""

    def __init__(self, image_paths: Sequence[str], batch_size: int = 128,
                 image_size: int = IMAGE_SIZE, num_workers: int = 8,
                 prefetch: int = 4, use_native: bool | None = None,
                 out_dtype: str = "f32", cache=None):
        self.image_paths = list(image_paths)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        if out_dtype not in ("f32", "u8"):
            raise ValueError(f"out_dtype must be 'f32' or 'u8', got {out_dtype}")
        self.out_dtype = out_dtype
        self._np_dtype = np.uint8 if out_dtype == "u8" else np.float32
        if use_native is None:
            from . import native

            use_native = native.native_available()
        self.use_native = use_native
        self.cache = cache
        if cache is not None and cache.image_size != image_size:
            raise ValueError(f"cache stores {cache.image_size}px rows, "
                             f"batcher wants {image_size}px")

    def __len__(self) -> int:
        return -(-len(self.image_paths) // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, list[str], int]]:
        """Yields (batch [B, S, S, 3], valid paths, n_valid).  Decodes run
        ahead of the consumer through a window of prefetch·batch_size."""
        if self.use_native:
            yield from self._iter_native()
            return
        paths = self.image_paths
        n = len(paths)
        window = max(self.batch_size * self.prefetch, self.batch_size)
        if self.cache is not None:
            decode = self._decode_cached
        else:
            decode = decode_image_u8 if self.out_dtype == "u8" else decode_image
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures: deque[tuple[cf.Future, str]] = deque()
            submitted = 0

            def top_up():
                nonlocal submitted
                while submitted < n and len(futures) < window:
                    p = paths[submitted]
                    futures.append((pool.submit(decode, p, self.image_size), p))
                    submitted += 1

            top_up()
            consumed = 0
            while consumed < n:
                take = min(self.batch_size, n - consumed)
                batch = np.zeros(
                    (self.batch_size, self.image_size, self.image_size, 3),
                    self._np_dtype)
                names: list[str] = []
                for _ in range(take):
                    fut, p = futures.popleft()
                    top_up()
                    im = fut.result()
                    if im is not None:
                        batch[len(names)] = im
                        names.append(p)
                consumed += take
                yield batch, names, len(names)

    def _decode_cached(self, path: str, image_size: int) -> np.ndarray | None:
        """Cache first; a miss is decoded and appended."""
        arr = self.cache.get(path)
        if arr is None:
            arr = decode_image_u8(path, image_size)
            if arr is not None:
                self.cache.put(path, arr)
        if arr is None or self.out_dtype == "u8":
            return arr
        return normalize_array(arr)

    def _iter_native(self):
        """Batches from the native decoder, one chunk decoding ahead of the
        one being consumed."""
        paths, n = self.image_paths, len(self.image_paths)
        chunks = [paths[s:s + self.batch_size]
                  for s in range(0, n, self.batch_size)]
        with cf.ThreadPoolExecutor(1) as executor:
            pending = None
            for chunk in chunks + [None]:
                nxt = (executor.submit(self._native_decode_chunk, chunk)
                       if chunk is not None else None)
                if pending is not None:
                    yield self._emit(*pending[1].result(), pending[0])
                pending = (chunk, nxt) if chunk is not None else None

    def _native_decode_chunk(self, chunk: list[str]
                             ) -> tuple[np.ndarray, list[int]]:
        """(images [len(chunk), S, S, 3], positions that decoded).  Files
        the native decoder refuses go through PIL; with a cache, only the
        misses are decoded."""
        from . import native

        size = self.image_size
        if self.cache is not None:
            rows = [self.cache.get(p) for p in chunk]
            miss = [i for i, r in enumerate(rows) if r is None]
            if miss:
                sub, ok = native.decode_batch_native_u8(
                    [chunk[i] for i in miss], size, self.num_workers)
                for j, i in enumerate(miss):
                    r = sub[j] if ok[j] else decode_image_u8(chunk[i], size)
                    if r is not None:
                        rows[i] = r
                        self.cache.put(chunk[i], r)
            batch = np.zeros((len(chunk), size, size, 3), np.uint8)
            survivors = []
            for i, r in enumerate(rows):
                if r is not None:
                    batch[i] = r
                    survivors.append(i)
            if self.out_dtype != "u8":
                batch = (batch.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
            return batch, survivors
        if self.out_dtype == "u8":
            batch, ok = native.decode_batch_native_u8(chunk, size,
                                                      self.num_workers)
            retry = decode_image_u8
        else:
            batch, ok = native.decode_batch_native(chunk, size,
                                                   self.num_workers)
            retry = decode_image
        survivors = []
        for i, good in enumerate(ok):
            if not good:
                im = retry(chunk[i], size)      # non-PNG / exotic → PIL
                if im is None:
                    continue
                batch[i] = im
            survivors.append(i)
        return batch, survivors

    def _emit(self, batch, survivors, chunk):
        out = np.zeros((self.batch_size, self.image_size, self.image_size, 3),
                       self._np_dtype)
        names = []
        for slot, pos in enumerate(survivors):
            out[slot] = batch[pos]
            names.append(chunk[pos])
        return out, names, len(survivors)
