"""VGAE reconstruction and KL losses (port of patent_tpu/losses/vgae.py;
reference src/auxiliary.py:36-79).  ``pull_losses`` is the working core
of the reference's ``enhanced_loss_function`` (auxiliary.py:82-111):
squared-distance pulls toward parents and same-CPC neighbours."""

from __future__ import annotations

import torch


def recon_kl_loss(a: torch.Tensor, a_reconstructed: torch.Tensor,
                  mu: torch.Tensor, log_sigma: torch.Tensor,
                  beta: float = 0.001) -> torch.Tensor:
    """Clamped BCE reconstruction (mean over elements) + β·KL (per node)."""
    eps = 1e-7
    a_rec = torch.clamp(a_reconstructed, eps, 1.0 - eps)
    recon = -(a * torch.log(a_rec) + (1.0 - a) * torch.log(1.0 - a_rec))
    recon_loss = recon.sum() / a.numel()
    ls = torch.clamp(log_sigma, -10.0, 10.0)
    kl = -0.5 * (1.0 + ls - mu ** 2 - torch.exp(ls)).sum() / mu.shape[0]
    return recon_loss + beta * kl


def annealed_beta(epoch, max_epochs: int = 200, beta_min: float = 0.0001,
                  beta_max: float = 0.001) -> torch.Tensor:
    """KL annealing: β_min → β_max linearly over the first half."""
    frac = torch.clamp(torch.as_tensor(epoch, dtype=torch.float32)
                       / (max_epochs * 0.5), max=1.0)
    return beta_min + (beta_max - beta_min) * frac


def pull_losses(z: torch.Tensor, parent_pairs: torch.Tensor | None,
                neighbor_pairs: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean squared distances of (child, parent) and (neighbour,
    neighbour) pairs of rows of z; 0 for an empty set."""
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    h = n = zero
    if parent_pairs is not None and parent_pairs.shape[0] > 0:
        d = z[parent_pairs[:, 0]] - z[parent_pairs[:, 1]]
        h = (d * d).sum(dim=1).mean()
    if neighbor_pairs is not None and neighbor_pairs.shape[0] > 0:
        d = z[neighbor_pairs[:, 0]] - z[neighbor_pairs[:, 1]]
        n = (d * d).sum(dim=1).mean()
    return h, n
