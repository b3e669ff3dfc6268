"""The CLIP fine-tune's losses (port of ``multi_positive_nt_xent`` and
``graph_alignment_cosine`` of patent_tpu/losses/contrastive.py).  Both
run in f32; the caller keeps TF32 off (``select_device`` does)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def multi_positive_nt_xent(features: torch.Tensor,
                           logit_scale: torch.Tensor | float,
                           group_labels: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Multi-positive NT-Xent over a [2B, D] anchor∥positive batch:
    L2-normalize, scaled similarity logits with the diagonal masked to
    −1e9, row-normalized soft targets over same-group entries, and the
    mean of the row-wise and column-wise soft cross-entropies.
    ``group_labels`` [2B] defaults to ``arange(2B) % B`` (pair i with
    i + B)."""
    n = features.shape[0]
    z = _l2n(features)
    logits = (z @ z.T) * logit_scale
    if group_labels is None:
        group_labels = torch.arange(n, device=z.device) % (n // 2)
    p = (group_labels[:, None] == group_labels[None, :]).to(z.dtype)
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    p = p.masked_fill(eye, 0.0)
    logits = logits.masked_fill(eye, -1e9)
    p = p / torch.clamp(p.sum(dim=1, keepdim=True), min=1e-8)
    loss_row = -(p * F.log_softmax(logits, dim=1)).sum(dim=1).mean()
    loss_col = -(p.T * F.log_softmax(logits.T, dim=1)).sum(dim=1).mean()
    return (loss_row + loss_col) / 2.0


def graph_alignment_cosine(image_proj: torch.Tensor,
                           graph_proj: torch.Tensor) -> torch.Tensor:
    """1 − mean cosine(image projection, graph projection)."""
    return 1.0 - (_l2n(image_proj) * _l2n(graph_proj)).sum(dim=1).mean()
