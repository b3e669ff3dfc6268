"""Build and load the hand-written CUDA kernels of ``patent_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles, with ``nvcc`` for Hopper (``sm_90a``), to
an object file, all of them at once in parallel processes, and the objects
link into ONE shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/patent_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the earlier build.  A plain C
interface keeps the build to seconds: nothing includes PyTorch's headers.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``call`` raises when that is not 0.  Nothing here
runs at import time: the first ``library()`` call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "patent_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int


class _Lib:
    """The loaded library and the seconds its build took (0 when an
    earlier build with the same hash was loaded)."""

    def __init__(self, cdll: ctypes.CDLL, build_seconds: float, path: str):
        self.cdll = cdll
        self.build_seconds = build_seconds
        self.path = path


_LIB: _Lib | None = None


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                       "patent_tpu_torch CUDA kernels cannot be built")


def _check(cmd: list[str], returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{output}")


def library() -> _Lib:
    """Build (if needed) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    path = os.path.join(BUILD_DIR, f"libpatent_tpu_torch_{h.hexdigest()[:16]}.so")
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        try:
            for cmd, proc in procs:
                out = proc.communicate()[0]
                _check(cmd, proc.returncode, out)
            done = subprocess.run(link, capture_output=True, text=True)
            _check(link, done.returncode, done.stdout + done.stderr)
        finally:
            for _cmd, proc in procs:     # a failed build stops the others
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
    _LIB = _Lib(ctypes.CDLL(path), seconds, path)
    return _LIB


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry point."""
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C entry point."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def call(name: str, argtypes: list, *args) -> None:
    """Call C entry point ``name`` (declared with ``argtypes``); raise if it
    reports a CUDA error."""
    fn = getattr(library().cdll, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
