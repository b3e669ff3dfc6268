"""Profiling and numerical guards (port of patent_tpu/utils/profiling.py).

* ``profile_trace`` — a context manager around ``torch.profiler`` (CPU
  activity, and CUDA where a card is visible) that writes a Chrome trace
  under ``log_dir`` and returns the profiler, whose ``key_averages()`` and
  ``launches()`` read the device time and the kernel launches.
* ``StepTimer`` — per-step wall time with percentile summaries (call
  ``mark`` after a host sync point, e.g. ``torch.cuda.synchronize()``).
* ``assert_all_finite`` — a host-side finite check over nested dicts,
  lists and tuples of tensors or arrays (a state dict too) that names the
  path of the first non-finite leaf.
* ``debug_nan_guard`` — zeroes non-finite entries and warns with their
  count (the framework's form of the reference's silent NaN fall-backs).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Any, Iterator

import numpy as np
import torch


class _Trace:
    """What ``profile_trace`` yields: the profiler once the block ends."""

    def __init__(self, path: str):
        self.path = path
        self.profiler: torch.profiler.profile | None = None

    def launches(self) -> int:
        """The CUDA kernel launches the trace saw (0 on the CPU)."""
        return sum(e.count for e in self.profiler.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[_Trace]:
    """``with profile_trace('/tmp/trace') as t: step(...)`` → a Chrome trace
    at ``t.path`` (``log_dir``/trace_<pid>_<ns>.json), ``t.profiler``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace = _Trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    with torch.profiler.profile(activities=acts) as prof:
        yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace.profiler = prof
    prof.export_chrome_trace(trace.path)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def mark(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming ``name`` + the path of the first
    floating leaf with a non-finite value, and the count of them."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf.detach())).sum())
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            bad = int(np.sum(~np.isfinite(arr)))
        if bad:
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite values")


def debug_nan_guard(value: torch.Tensor, label: str = "value"
                    ) -> torch.Tensor:
    """``value`` with its non-finite entries replaced by 0; warns with their
    count when there are any."""
    bad = ~torch.isfinite(value)
    n_bad = int(bad.sum())
    if n_bad:
        warnings.warn(f"[patent_tpu_torch] {n_bad} non-finite in {label}",
                      RuntimeWarning, stacklevel=2)
    return torch.where(bad, torch.zeros_like(value), value)
