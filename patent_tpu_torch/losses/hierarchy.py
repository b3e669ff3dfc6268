"""Label-hierarchy and regularization losses on the Poincaré ball (port of
patent_tpu/losses/hierarchy.py).

* ``hierarchical_margin_losses``: relu(−insideness + 0.05) over the
  implication pairs (child, parent), relu(−disjointedness + 0.1) over the
  exclusion pairs;
* ``dist0_band_regularizers``: labels kept in the band [2, 8] of
  hyperbolic distance from the origin, figures below 8;
* ``hmi_losses``: the HMI model's terms on the unit ball.
"""

from __future__ import annotations

import torch

from ..ops import poincare
from ..ops.horosphere import (disjointedness, disjointedness_unit,
                              insideness, insideness_unit)
from ..ops.rows import take_rows

INSIDE_MARGIN = 0.05
DISJOINT_MARGIN = 0.1
LABEL_DIST0_MIN = 2.0
LABEL_DIST0_MAX = 8.0
INSTANCE_DIST0_MAX = 8.0


def _pair_rows(label_emb: torch.Tensor, pairs: torch.Tensor | None):
    """The two label rows of each pair, or None for no pairs (the shape is
    known on the host: no device sync)."""
    if pairs is None or pairs.shape[0] == 0:
        return None
    return take_rows(label_emb, pairs[:, 0]), take_rows(label_emb, pairs[:, 1])


def hierarchical_margin_losses(label_emb: torch.Tensor,
                               implication_pairs: torch.Tensor | None,
                               exclusion_pairs: torch.Tensor | None,
                               c=1.0, inside_margin: float = INSIDE_MARGIN,
                               disjoint_margin: float = DISJOINT_MARGIN
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(inside_loss, disjoint_loss) over (child, parent) and (left, right)
    pairs of label indices [P, 2]; 0 for an empty set."""
    zero = torch.zeros((), dtype=label_emb.dtype, device=label_emb.device)
    inside_loss = disjoint_loss = zero
    rows = _pair_rows(label_emb, implication_pairs)
    if rows is not None:
        ins = insideness(rows[0], rows[1], c)
        inside_loss = torch.relu(-ins + inside_margin).mean()
    rows = _pair_rows(label_emb, exclusion_pairs)
    if rows is not None:
        dis = disjointedness(rows[0], rows[1], c)
        disjoint_loss = torch.relu(-dis + disjoint_margin).mean()
    return inside_loss, disjoint_loss


def dist0_band_regularizers(label_emb: torch.Tensor,
                            encoded_figures: torch.Tensor, c=1.0,
                            label_min: float = LABEL_DIST0_MIN,
                            label_max: float = LABEL_DIST0_MAX,
                            instance_max: float = INSTANCE_DIST0_MAX,
                            num_valid_labels: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(label_reg, instance_reg) by hyperbolic distance from the origin.
    ``num_valid_labels`` leaves the rows from it on out of the label term
    (a table zero-padded for row sharding)."""
    label_d0 = torch.clamp_min(poincare.dist0(label_emb, c, keepdim=True),
                               poincare.MIN_NORM)
    per_label = (torch.relu(label_min - label_d0)
                 + torch.relu(label_d0 - label_max))
    if num_valid_labels is not None and num_valid_labels < label_emb.shape[0]:
        valid = (torch.arange(label_emb.shape[0], device=label_emb.device)
                 < num_valid_labels)[:, None].to(per_label.dtype)
        label_reg = (per_label * valid).sum() / num_valid_labels
    else:
        label_reg = per_label.mean()
    fig_d0 = torch.clamp_min(poincare.dist0(encoded_figures, c, keepdim=True),
                             poincare.MIN_NORM)
    instance_reg = torch.relu(fig_d0 - instance_max).mean()
    return label_reg, instance_reg


def hmi_losses(encoded: torch.Tensor, label_emb: torch.Tensor,
               implication: torch.Tensor | None,
               exclusion: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """The HMI model's loss terms on the unit ball: relu(−insideness) over
    the implication pairs, relu(−disjointedness) over the exclusion pairs,
    mean | ‖label‖ − 0.5 |, and mean relu(‖enc‖ − 0.99) + relu(0.2 − ‖enc‖)."""
    zero = torch.zeros((), dtype=encoded.dtype, device=encoded.device)
    inside_loss = disjoint_loss = zero
    rows = _pair_rows(label_emb, implication)
    if rows is not None:
        inside_loss = torch.relu(-insideness_unit(*rows)).mean()
    rows = _pair_rows(label_emb, exclusion)
    if rows is not None:
        disjoint_loss = torch.relu(-disjointedness_unit(*rows)).mean()
    label_norm = torch.linalg.norm(label_emb, dim=1, keepdim=True)
    label_reg = (label_norm - 0.5).abs().mean()
    enc_norm = torch.linalg.norm(encoded, dim=1, keepdim=True)
    instance_reg = (torch.relu(enc_norm - 0.99)
                    + torch.relu(0.2 - enc_norm)).mean()
    return {"inside_loss": inside_loss, "disjoint_loss": disjoint_loss,
            "label_reg": label_reg, "instance_reg": instance_reg}
