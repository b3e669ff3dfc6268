"""Contrastive losses (port of patent_tpu/losses/contrastive.py): the
CLIP fine-tune's ``multi_positive_nt_xent`` and ``graph_alignment_cosine``,
train_hyp_con's ``hyperbolic_info_nce``, and the graph losses
``neighborhood_nce``, ``hierarchical_triplet`` and
``infonce_parent_neighbor`` with ``pairs_to_mask``.  All run in f32; the
caller keeps TF32 off (``select_device`` does)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import poincare


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


def hyperbolic_info_nce(anchors: torch.Tensor, positives: torch.Tensor,
                        c=1.0, temperature: float = 0.07) -> torch.Tensor:
    """Bidirectional InfoNCE over −pairwise_dist / τ with the diagonal as
    the targets."""
    sims = -poincare.pairwise_dist(anchors, positives, c) / temperature
    loss_a2p = -F.log_softmax(sims, dim=1).diagonal().mean()
    loss_p2a = -F.log_softmax(sims.T, dim=1).diagonal().mean()
    return (loss_a2p + loss_p2a) / 2.0


def neighborhood_nce(z: torch.Tensor, pos_mask: torch.Tensor,
                     temperature: float = 0.07,
                     eps: float = 1e-8) -> torch.Tensor:
    """Masked InfoNCE over the cosine similarities (logits clamped to
    ±20); rows without a positive are left out."""
    zn = _l2n(z)
    sim = torch.clamp((zn @ zn.T) / temperature, -20.0, 20.0)
    n = z.shape[0]
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    pos_mask = pos_mask * (1.0 - eye)
    exp_sim = torch.exp(sim)
    pos_sim = (exp_sim * pos_mask).sum(dim=1) + eps
    total_sim = (exp_sim * (1.0 - eye)).sum(dim=1) + eps
    log_prob = torch.log(pos_sim / total_sim)
    has_pos = (pos_mask.sum(dim=1) > 0).to(z.dtype)
    return -(log_prob * has_pos).sum() / (has_pos.sum() + eps)


def pairs_to_mask(pairs: torch.Tensor, n: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[P, 2] index pairs → symmetric [n, n] 0/1 mask."""
    mask = torch.zeros((n, n), dtype=dtype, device=pairs.device)
    mask[pairs[:, 0], pairs[:, 1]] = 1.0
    mask[pairs[:, 1], pairs[:, 0]] = 1.0
    return mask


def hierarchical_triplet(z: torch.Tensor, parent_pairs: torch.Tensor,
                         neg_idx: torch.Tensor,
                         margin: float = 0.1) -> torch.Tensor:
    """Child–parent against child–negative squared distances of the
    L2-normalized rows, with a margin; a negative equal to the parent is
    left out."""
    zn = _l2n(z)
    child = zn[parent_pairs[:, 0]]
    parent = zn[parent_pairs[:, 1]]
    neg = zn[neg_idx]
    pos_d = ((child - parent) ** 2).sum(dim=1)
    neg_d = ((child - neg) ** 2).sum(dim=1)
    valid = (neg_idx != parent_pairs[:, 1]).to(z.dtype)
    per = torch.relu(pos_d - neg_d + margin) * valid
    return per.sum() / torch.clamp_min(valid.sum(), 1.0)


def infonce_parent_neighbor(z: torch.Tensor, pairs: torch.Tensor,
                            neg_idx: torch.Tensor,
                            temp: float = 0.1) -> torch.Tensor:
    """InfoNCE of each pair against the mean similarity of its K sampled
    negatives, on L2-normalized rows: z [N, D], pairs [P, 2], neg_idx
    [P, K]."""
    zn = _l2n(z)
    a = zn[pairs[:, 0]]
    b = zn[pairs[:, 1]]
    pos_sim = (a * b).sum(dim=1)
    neg_sim = torch.einsum("pd,pkd->pk", a, zn[neg_idx]).mean(dim=1)
    return -(pos_sim / temp - torch.log(torch.exp(pos_sim / temp)
                                        + torch.exp(neg_sim / temp))).mean()
