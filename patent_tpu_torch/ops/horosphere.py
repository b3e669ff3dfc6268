"""Horosphere geometry on the Poincaré ball: insideness and disjointedness
(port of patent_tpu/ops/horosphere.py).

Each point p defines a sphere tangent to the ball's boundary along the
ray through p; a label hierarchy is enforced by nesting (the child's
sphere inside the parent's) and exclusion by disjointness.  Two forms:

* ``insideness`` / ``disjointedness``: curvature-corrected, with k = −c,
      r_p = (1 + k‖p‖²) / (2 √(−k) ‖p‖),  center_p = p (1 + r_p √(−k)/‖p‖),
  on points first projected into the ball;
* ``insideness_unit`` / ``disjointedness_unit``: the unit ball (c = 1),
      r_p = (1 − ‖p‖²) / (2‖p‖),  center_p = p (1 + r_p/‖p‖),
  without the projection (the HMI model's form).

Norms are floored at ``NORM_FLOOR``: the radius grows as 1/‖p‖ and its
gradient as 1/‖p‖², so a smaller floor overflows f32 gradients near the
origin.
"""

from __future__ import annotations

import torch

from .poincare import project

NORM_FLOOR = 1e-6


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                           NORM_FLOOR)


def _radius_center(p: torch.Tensor, c) -> tuple[torch.Tensor, torch.Tensor]:
    """The curvature-corrected tangent sphere's radius and center."""
    p = project(p, c)
    n = _norm(p)
    k = -torch.as_tensor(c, dtype=p.dtype, device=p.device)
    sqrt_neg_k = torch.sqrt(-k)
    radius = (1.0 + k * n * n) / (2.0 * sqrt_neg_k * n)
    center = p * (1.0 + radius * sqrt_neg_k / n)
    return radius, center


def _squeeze(out: torch.Tensor, keepdim: bool) -> torch.Tensor:
    return out if keepdim else out[..., 0]


def insideness(point_a: torch.Tensor, point_b: torch.Tensor, c=1.0, *,
               keepdim: bool = True) -> torch.Tensor:
    """(r_b − r_a) − ‖center_a − center_b‖; > 0 when a's sphere lies
    inside b's."""
    r_a, c_a = _radius_center(point_a, c)
    r_b, c_b = _radius_center(point_b, c)
    center_dist = torch.clamp_min(
        torch.linalg.norm(c_a - c_b, dim=-1, keepdim=True), 0.0)
    return _squeeze((r_b - r_a) - center_dist, keepdim)


def disjointedness(point_a: torch.Tensor, point_b: torch.Tensor, c=1.0, *,
                   keepdim: bool = True) -> torch.Tensor:
    """‖center_a − center_b‖ − (r_a + r_b); > 0 when the spheres are
    disjoint."""
    r_a, c_a = _radius_center(point_a, c)
    r_b, c_b = _radius_center(point_b, c)
    center_dist = torch.linalg.norm(c_a - c_b, dim=-1, keepdim=True)
    return _squeeze(center_dist - (r_a + r_b), keepdim)


def _radius_center_unit(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The unit-ball form, without projection."""
    n = _norm(p)
    radius = (1.0 - n * n) / (2.0 * n)
    center = p * (1.0 + radius / n)
    return radius, center


def insideness_unit(point_a: torch.Tensor, point_b: torch.Tensor, *,
                    keepdim: bool = True) -> torch.Tensor:
    r_a, c_a = _radius_center_unit(point_a)
    r_b, c_b = _radius_center_unit(point_b)
    center_dist = torch.linalg.norm(c_a - c_b, dim=-1, keepdim=True)
    return _squeeze((r_b - r_a) - center_dist, keepdim)


def disjointedness_unit(point_a: torch.Tensor, point_b: torch.Tensor, *,
                        keepdim: bool = True) -> torch.Tensor:
    r_a, c_a = _radius_center_unit(point_a)
    r_b, c_b = _radius_center_unit(point_b)
    center_dist = torch.linalg.norm(c_a - c_b, dim=-1, keepdim=True)
    return _squeeze(center_dist - (r_a + r_b), keepdim)


def hmi_logit(points: torch.Tensor, label_emb: torch.Tensor) -> torch.Tensor:
    """The HMI classifier's logit, insideness − disjointedness of each of
    the n points [n, d] against each of the L labels [L, d]: [n, L]."""
    p = points[:, None, :]
    lab = label_emb[None, :, :]
    return insideness_unit(p, lab)[..., 0] - disjointedness_unit(p, lab)[..., 0]
