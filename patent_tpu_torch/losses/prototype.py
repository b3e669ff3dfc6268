"""Sample → prototype losses in hyperbolic space (port of
patent_tpu/losses/prototype.py): the triplet form that train_hyp uses, the
cross-entropy form, and the figure-pair BCE over −d / τ."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import poincare


def sample_to_prototype_triplet(samples: torch.Tensor,
                                pos_prototypes: torch.Tensor,
                                neg_prototypes: torch.Tensor, c=1.0,
                                margin: float = 0.1) -> torch.Tensor:
    """mean relu(d(s, pos) − mean_j d(s, neg_j) + margin): samples and
    positives [B, D], negatives [B, N, D]."""
    pos_d = poincare.dist(samples, pos_prototypes, c)
    neg_d = poincare.dist(samples[:, None, :], neg_prototypes, c)
    return torch.relu(pos_d - neg_d.mean(dim=1) + margin).mean()


def sample_to_prototype_ce(samples: torch.Tensor, pos_prototypes: torch.Tensor,
                           neg_prototypes: torch.Tensor, c=1.0,
                           temperature: float = 0.07) -> torch.Tensor:
    """Cross-entropy over −d / τ against [pos, neg_1..neg_N] per sample."""
    pos_d = poincare.dist(samples, pos_prototypes, c)
    neg_d = poincare.dist(samples[:, None, :], neg_prototypes, c)
    logits = -torch.cat([pos_d[:, None], neg_d], dim=1) / temperature
    return (-F.log_softmax(logits, dim=1)[:, 0]).mean()


def figure_pair_bce(embeddings_a: torch.Tensor, embeddings_b: torch.Tensor,
                    labels: torch.Tensor, c=1.0,
                    temperature: float = 0.07) -> torch.Tensor:
    """BCE with logits −d(a_i, b_i) / τ; labels 1 for a positive pair."""
    logits = -poincare.dist(embeddings_a, embeddings_b, c) / temperature
    return -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits)).mean()
