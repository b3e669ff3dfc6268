"""CUDA graphs: the port's counterpart of the JAX package's one-dispatch
loops.

JAX runs a whole training epoch, or k encoder batches, as one jitted
``lax.scan``: one host dispatch.  Here the counterpart is a CUDA graph of
one step (or of k tower calls), captured once and replayed from static
buffers: one ``cudaGraphLaunch`` a step instead of one launch a kernel.

* ``StepGraph`` runs its body eagerly on a side stream at its first call
  (the warm-up: libraries load, kernels set their attributes and
  workspaces are allocated outside the capture; the call is a real one,
  so nothing has to be undone), captures the body at its second call and
  replays the capture, and replays at every later call.
* ``ScanLoop`` is a loop of n steps over static epoch buffers: a device
  step index selects each step's batch, and each step's outputs go to row
  i of an [n, m] buffer, the same code eagerly and in the graph.
* ``graphed_on``: the device decides (a graph on the card, the eager loop
  elsewhere) unless the caller says; a graph on the CPU raises.

A failed capture raises; nothing falls back to the eager loop.  A kernel
wrapper of the port counts a launch where it launches its kernel; under a
capture it records the launch instead, so the capture's counts are taken
back and each replay adds them again (``launch_counters``).
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import numpy as np
import torch


def graphed_on(device, graphed: bool | None) -> bool:
    """Whether a loop on ``device`` runs as a CUDA graph: ``None`` means by
    the device (a graph on CUDA, the eager loop elsewhere)."""
    kind = torch.device(device).type
    if graphed is None:
        return kind == "cuda"
    if graphed and kind != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {kind!r}")
    return bool(graphed)


def launch_counters() -> list:
    """Every kernel wrapper of the port that counts its launches (a
    function with an int ``launches`` attribute), and the int8 entries'
    counts of their fast form apart (``entry.fast``)."""
    from ..ops import (bf16_layer, bf16_mlp_grad, flash_attention,
                       pallas_kernels, quant_matmul, topk_kernel)

    found = {}
    for mod in (bf16_layer, bf16_mlp_grad, flash_attention, pallas_kernels,
                quant_matmul, topk_kernel):
        for obj in vars(mod).values():
            if callable(obj) and type(getattr(obj, "launches", None)) is int:
                found[id(obj)] = obj
                fast = getattr(obj, "fast", None)
                if fast is not None:
                    found[id(fast)] = fast
    return list(found.values())


def on_side_stream(fn: Callable):
    """``fn()`` on a new stream ordered after the current one, the current
    stream then ordered after it (PyTorch's warm-up before a capture)."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def upload(buf: torch.Tensor | None, host: np.ndarray,
           device) -> torch.Tensor:
    """``host`` on ``device``: copied into ``buf`` where it has the same
    shape and dtype (a static buffer keeps its address), else a new
    tensor."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if (buf is not None and buf.shape == src.shape
            and buf.dtype == src.dtype):
        return buf.copy_(src)
    return src.to(device, copy=True)


class StepGraph:
    """``body()`` as a CUDA graph.  The first call runs ``body`` eagerly
    on a side stream (the warm-up, a real call); the second captures it
    and replays the capture; later calls replay.  ``body`` takes no
    argument and reads and writes tensors that outlive the graph; what it
    returns at the capture is the graph's output, which every replay
    overwrites.  ``generators``: the ``torch.Generator``s ``body`` draws
    from, registered with the graph so that each replay draws the numbers
    an eager call would have drawn next."""

    def __init__(self, body: Callable,
                 generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.generators = tuple(g for g in generators if g is not None)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.output = None
        self.warm = False
        self.counts: list[tuple] = []

    def __call__(self):
        if self.graph is None:
            if not self.warm:
                self.warm = True
                return on_side_stream(self.body)
            self.capture()
        self.replay()
        return self.output

    def capture(self) -> None:
        counters = launch_counters()
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # no garbage collection inside the capture: torch.cuda.graph
        # collects on entry, and a collection during the capture can run a
        # finalizer that calls CUDA (an earlier loop's graph, held in a
        # ScanLoop <-> StepGraph cycle, destroyed), which invalidates the
        # capture; seen on the H100 as cudaErrorStreamCaptureInvalidated
        # in 4 of 5 runs of the card tests at one allocation history
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.body()
        finally:
            if collecting:
                gc.enable()
        self.counts = [(f, f.launches - n) for f, n in zip(counters, before)
                       if f.launches != n]
        for f, n in zip(counters, before):     # a capture launches nothing
            f.launches = n
        self.graph, self.output = graph, out

    def replay(self) -> None:
        self.graph.replay()
        for f, n in self.counts:
            f.launches += n

    def reset(self) -> None:
        """Drop the capture (a buffer it reads has moved); the next call
        warms up and captures again."""
        self.graph = self.output = None
        self.warm = False
        self.counts = []


class ScanLoop:
    """n calls of ``step(i)`` as JAX's ``lax.scan`` over an epoch:
    ``step`` takes the step index as an int64 0-dim device tensor (it
    selects the step's rows from static epoch buffers) and returns a 1-D
    tensor of m outputs, written to row i of the loop's [n, m] output.
    Graphed (``graphed_on``), one ``StepGraph`` of the step, replayed n
    times; eager, the same code n times."""

    def __init__(self, step: Callable[[torch.Tensor], torch.Tensor],
                 device, graphed: bool | None = None):
        self.step = step
        self.device = torch.device(device)
        self.graphed = graphed_on(self.device, graphed)
        self.i = torch.zeros((), dtype=torch.long, device=self.device)
        self.out: torch.Tensor | None = None
        self.key = None
        self.generators: tuple = ()
        self.graph = StepGraph(self._body)

    def _body(self) -> None:
        row = self.step(self.i)
        self.out.index_copy_(0, self.i.view(1), row.reshape(1, -1))
        self.i.add_(1)

    def reset(self) -> None:
        self.graph.reset()

    def run(self, n: int, m: int, reads: Sequence[torch.Tensor] = (),
            generators: Sequence[torch.Generator | None] = ()
            ) -> torch.Tensor:
        """The [n, m] outputs of n steps (a view of a static buffer,
        overwritten by the next run).  ``reads``: the tensors the step
        reads besides the loop's own buffers; ``generators``: those it
        draws from.  A tensor at another address or of another shape,
        dtype or stride, another generator object, or more steps than the
        output buffer holds, captures again."""
        key = (m,) + tuple((t.data_ptr(), tuple(t.shape), t.dtype,
                            t.stride()) for t in reads)
        generators = tuple(g for g in generators if g is not None)
        same_gens = (len(generators) == len(self.generators)
                     and all(a is b for a, b in zip(generators,
                                                    self.generators)))
        if key != self.key or not same_gens or self.out.shape[0] < n:
            self.out = torch.empty(n, m, device=self.device)
            self.key = key
            # held, so that no other generator can take one's identity
            self.generators = generators
            self.graph.reset()
            self.graph.generators = generators
        self.i.zero_()
        for _ in range(n):
            if self.graphed:
                self.graph()
            else:
                self._body()
        return self.out[:n]

    def run_updates(self, optimizer, n: int, m: int,
                    reads: Sequence[torch.Tensor] = (),
                    generators: Sequence[torch.Generator | None] = ()
                    ) -> torch.Tensor:
        """``run`` of n steps that each call ``optimizer.update``
        (train/optim.py): its rate table reserved for them first (a table
        that moved captures again), its host count advanced after."""
        if optimizer.reserve(n):
            self.reset()
        out = self.run(n, m, reads, generators)
        optimizer.advance(n)
        return out
