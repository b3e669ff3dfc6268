"""ctypes bindings for the native PNG decoder (``native/patent_io.cc`` at
the repository root, shared with the JAX package; the port's copy of
patent_tpu/input/native.py).

``native_available()`` builds ``native/libpatent_io.so`` with
``native/build.sh`` on first use when g++ is there, and says whether the
library loaded.  Files the decoder refuses (non-PNG, exotic) report
failure, and the caller decodes them with PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .pipeline import CLIP_MEAN, CLIP_STD

_LIB = None
_TRIED = False

_MEAN = np.ascontiguousarray(CLIP_MEAN, np.float32)
_INV_STD = np.ascontiguousarray(1.0 / CLIP_STD, np.float32)
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_NATIVE_DIR, "libpatent_io.so")
    build = os.path.join(_NATIVE_DIR, "build.sh")
    if not os.path.exists(path) and os.path.exists(build):
        try:
            subprocess.run(["/bin/sh", build], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    strs = ctypes.POINTER(ctypes.c_char_p)
    try:
        lib = ctypes.CDLL(path)
        lib.patent_io_decode_batch.restype = None
        lib.patent_io_decode_batch.argtypes = [
            strs, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, i32p,
            ctypes.c_int]
        lib.patent_io_decode_batch_u8.restype = None
        lib.patent_io_decode_batch_u8.argtypes = [
            strs, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            i32p, ctypes.c_int]
        lib.patent_io_decode.restype = ctypes.c_int
        lib.patent_io_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, f32p,
                                         f32p, f32p]
        ip = ctypes.POINTER(ctypes.c_int)
        lib.patent_io_probe.restype = ctypes.c_int
        lib.patent_io_probe.argtypes = [ctypes.c_char_p, ip, ip, ip]
    except (OSError, AttributeError):    # missing, or built from older sources
        return None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def decode_image_native(path: str, image_size: int = 224
                        ) -> np.ndarray | None:
    """Native decode of one PNG → [S, S, 3] CLIP-normalized float32; None
    where the library is missing or the decode fails (the caller decodes
    with PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.patent_io_decode(path.encode(), image_size,
                              _MEAN.ctypes.data_as(f32p),
                              _INV_STD.ctypes.data_as(f32p),
                              out.ctypes.data_as(f32p))
    return out if rc == 0 else None


def probe_native(path: str) -> tuple[int, int, int] | None:
    """(width, height, channels) of a PNG from its header; None where the
    library is missing or the file is not one it reads."""
    lib = _load()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.patent_io_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c))
    return (w.value, h.value, c.value) if rc == 0 else None


def _c_paths(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def decode_batch_native(paths: list[str], image_size: int = 224,
                        num_threads: int = 4
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded decode → ([n, S, S, 3] CLIP-normalized float32, [n] ok
    mask); rows that failed are zero."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.zeros((n, image_size, image_size, 3), np.float32)
    status = np.empty(n, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.patent_io_decode_batch(
        _c_paths(paths), n, image_size, _MEAN.ctypes.data_as(f32p),
        _INV_STD.ctypes.data_as(f32p), out.ctypes.data_as(f32p),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return out, status == 0


def decode_batch_native_u8(paths: list[str], image_size: int = 224,
                           num_threads: int = 4
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded decode → ([n, S, S, 3] uint8 RGB, [n] ok mask)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.zeros((n, image_size, image_size, 3), np.uint8)
    status = np.empty(n, np.int32)
    lib.patent_io_decode_batch_u8(
        _c_paths(paths), n, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return out, status == 0
