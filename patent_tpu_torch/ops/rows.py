"""Row gathers with a deterministic backward.

``table[idx]``'s backward accumulates the gradients of repeated rows with
atomics on the card and in parallel on the CPU, so its bits change from
run to run, and a resumed training run drifts from an uninterrupted one.
``take_rows`` gathers the same rows; its backward sums each row's
gradients in a fixed order: a stable sort of the indices, then one segment
sum per table row (``torch.segment_reduce``, one pass a segment), with
the segment lengths counted in integers (exact in any order).  Nothing in
it reads a value back to the host.
"""

from __future__ import annotations

import torch


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        n = ctx.shape[0]
        flat = idx.reshape(-1).long()
        g = grad.reshape(flat.numel(), -1)
        order = torch.sort(flat, stable=True).indices
        counts = torch.zeros(n, dtype=torch.long, device=flat.device
                             ).index_add_(0, flat, torch.ones_like(flat))
        out = torch.segment_reduce(g[order], "sum", lengths=counts, axis=0,
                                   unsafe=True)
        return out.reshape(ctx.shape), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (idx of any shape, into the first axis), with the
    fixed-order backward above."""
    return _TakeRows.apply(table, idx)
