"""Start a ``torch.distributed`` world of n ranks and run one function in
each (the port's counterpart of JAX's one-process view of a device mesh).

``run_world(n, fn, *args)`` spawns n processes (the ``spawn`` start
method: a rank imports only ``fn``'s module and what it imports), each of
which joins one process group, NCCL on ``device="cuda"`` and gloo on
``"cpu"`` unless ``backend`` is given, and calls ``fn(*args)``.  The ranks
meet through a file in a fresh temporary directory, so worlds started at
the same time never share a port.  ``run_world`` returns rank 0's result
and raises if any rank raises, dies, or the world outlives ``timeout``;
the other ranks are then killed.  Under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` in the environment) the calling process is the rank: it
joins the group from the environment and returns its own result.

``fn`` must be importable by name (a module-level function) and its
arguments and result picklable.  On the card each rank takes device
``rank % device_count``, so ranks may share one card (NCCL refuses that:
pass ``backend="gloo"``).  On the CPU each rank runs one thread.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def _default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _take_device(device: str, rank: int) -> None:
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_world: device='cuda' but no CUDA card "
                               "is visible; pass device='cpu'")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)


def _rank_main(rank: int, n: int, backend: str, device: str, init: str,
               timeout: float, fn, args, results) -> None:
    try:
        _take_device(device, rank)
        dist.init_process_group(
            backend, init_method=init, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def under_torchrun() -> bool:
    """Whether this process is a rank that ``torchrun`` started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _run_here(n: int, fn, args, backend: str | None, device: str,
              timeout: float):
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"run_world({n}) under torchrun with WORLD_SIZE "
                         f"{world}")
    rank = int(os.environ["RANK"])
    _take_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not dist.is_initialized():
        dist.init_process_group(backend or _default_backend(device),
                                timeout=datetime.timedelta(seconds=timeout))
    return fn(*args)


def run_world(n: int, fn, *args, backend: str | None = None,
              device: str = "cuda", timeout: float = 600.0):
    """Run ``fn(*args)`` on every rank of an n-rank world; rank 0's result.

    Raises ``RuntimeError`` with the rank's traceback if a rank raises,
    if a rank process exits without a result, or after ``timeout``
    seconds."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if under_torchrun():
        return _run_here(n, fn, args, backend, device, timeout)
    backend = backend or _default_backend(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ptt_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, backend, device, init, timeout, fn,
                                   args, results), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)


def _collect(procs, results, timeout: float):
    """Rank 0's result once every rank has reported; raises on the first
    failure, on a rank that died silently, or at the deadline."""
    deadline = time.monotonic() + timeout
    done: dict[int, object] = {}
    while len(done) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(f"world of {len(procs)} ranks timed out after "
                               f"{timeout:.0f} s; ranks done: {sorted(done)}")
        try:
            rank, ok, payload = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if not dead:
                continue
            try:    # its result may still be in the pipe: one last look
                rank, ok, payload = results.get(timeout=2.0)
            except queue.Empty:
                raise RuntimeError(
                    f"rank {dead[0]} exited with code "
                    f"{procs[dead[0]].exitcode} and no result") from None
        if not ok:
            raise RuntimeError(f"rank {rank} of {len(procs)} raised:\n"
                               f"{payload}")
        done[rank] = payload
    return done[0]
