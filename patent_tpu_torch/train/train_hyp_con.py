"""train_hyp_con: hyperbolic contrastive (InfoNCE) training of the
figure-only model (port of patent_tpu/train/train_hyp_con.py).

Anchors and their sampled positive partners are encoded in one forward
(dropout on in training, masks from a ``torch.Generator`` on the device
seeded from ``cfg.seed``) and scored with ``hyperbolic_info_nce``; Adam
with optax's arithmetic (train/optim.py ``Adam``).  The epoch's anchor and
positive indices come from JAX's numpy stream, as [steps, B] matrices
copied to the device once; the per-step losses stay on the device until
the epoch's mean is read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.prep import TrainingData, figure_pair_maps
from ..losses.contrastive import hyperbolic_info_nce
from ..models.hyperbolic import FigureOnlyHyperbolicModel
from ..retrieval.cli_actions import select_device
from ..utils.config import HypConTrainConfig
from ..utils.logging import MetricsLogger
from .optim import Adam


def make_loss_fn(model: FigureOnlyHyperbolicModel, cfg: HypConTrainConfig):
    """``loss(anchor_idx, pos_idx, x_figures, generator, deterministic)``:
    InfoNCE of the anchors' encodings against their positives'."""

    def loss(anchor_idx, pos_idx, x_figures, generator=None,
             deterministic=False):
        both = torch.cat([x_figures[anchor_idx], x_figures[pos_idx]])
        model.train(not deterministic)
        enc = model(both, generator)
        n = anchor_idx.shape[0]
        return hyperbolic_info_nce(enc[:n], enc[n:], cfg.curvature,
                                   cfg.temperature)

    return loss


def train_step(optimizer: Adam, loss_fn, anchor_idx, pos_idx, x_figures,
               generator=None) -> torch.Tensor:
    """One Adam step on the training loss; returns the loss (on the
    device)."""
    for p in optimizer.params.values():
        p.grad = None
    loss = loss_fn(anchor_idx, pos_idx, x_figures, generator)
    loss.backward()
    optimizer.step({n: p.grad for n, p in optimizer.params.items()})
    return loss.detach()


def train_hyperbolic_contrastive(td: TrainingData, cfg: HypConTrainConfig,
                                 logger: MetricsLogger | None = None,
                                 device=None) -> tuple[dict, dict]:
    """Returns (best params as a state dict of copies, history).
    ``device``: the card when not given (``select_device``: an error where
    there is none); pass "cpu" for the CPU."""
    logger = logger or MetricsLogger(print_every=20)
    device = select_device() if device is None else torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    model = FigureOnlyHyperbolicModel(
        feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
        hidden_dims=tuple(cfg.hidden_dims), c=cfg.curvature,
        generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    optimizer = Adam(dict(model.named_parameters()), cfg.learning_rate)
    loss_fn = make_loss_fn(model, cfg)
    x_figures = torch.as_tensor(td.x_figures, dtype=torch.float32,
                                device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    # anchor → its positive figures, padded so that an epoch's positive
    # sampling is one vectorized draw
    _pp, _np, fig_to_pos_figures, _nf = figure_pair_maps(td)
    anchors = np.asarray(sorted(fig_to_pos_figures), np.int64)
    if len(anchors) < 2:
        raise ValueError("need at least 2 figures with positive partners")
    max_pos = max(len(fig_to_pos_figures[int(a)]) for a in anchors)
    pos_pad = np.zeros((len(anchors), max_pos), np.int64)
    pos_cnt = np.zeros(len(anchors), np.int64)
    row_of = {int(a): i for i, a in enumerate(anchors)}
    for i, a in enumerate(anchors):
        lst = fig_to_pos_figures[int(a)]
        pos_pad[i, :len(lst)] = lst
        pos_cnt[i] = len(lst)
    n_val = max(1, int(0.1 * len(anchors)))
    val_anchors = anchors[:n_val]
    train_anchors = anchors[n_val:]

    def epoch_mats(pool: np.ndarray):
        n_steps = len(pool) // cfg.batch_size
        if n_steps == 0:
            return None
        take = pool[rng.permutation(len(pool))[:n_steps * cfg.batch_size]]
        rows = np.asarray([row_of[int(f)] for f in take])
        p = pos_pad[rows, rng.integers(0, pos_cnt[rows])]
        both = torch.from_numpy(np.stack([take.reshape(n_steps, -1),
                                          p.reshape(n_steps, -1)])).to(device)
        return both[0], both[1]

    best_val = float("inf")
    best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    patience_left = cfg.patience
    history: dict[str, list] = {"train_loss": [], "val_loss": []}
    step = 0
    for epoch in range(1, cfg.epochs + 1):
        mats = epoch_mats(train_anchors)
        if mats is not None:
            losses = torch.stack([
                train_step(optimizer, loss_fn, a, p, x_figures, gen)
                for a, p in zip(*mats)])
            nb = int(mats[0].shape[0])
            step += nb
            tot = float(losses.mean()) * nb
        else:
            # a small corpus: one step on the first batch-size anchors
            a = train_anchors[:cfg.batch_size]
            p = np.asarray([fig_to_pos_figures[int(f)][0] for f in a])
            loss = train_step(optimizer, loss_fn,
                              torch.as_tensor(a, device=device),
                              torch.as_tensor(p, device=device), x_figures,
                              gen)
            tot, nb = float(loss), 1
            step += 1
        vmats = epoch_mats(val_anchors)
        if vmats is not None:
            with torch.no_grad():
                val_loss = float(torch.stack([
                    loss_fn(a, p, x_figures, deterministic=True)
                    for a, p in zip(*vmats)]).mean())
        else:
            val_loss = tot / nb
        history["train_loss"].append(tot / nb)
        history["val_loss"].append(val_loss)
        logger.log(step, {"epoch": epoch, "train_loss": tot / nb,
                          "val_loss": val_loss}, force_print=True)
        if val_loss < best_val:
            best_val = val_loss
            best_params = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
            patience_left = cfg.patience
        else:
            patience_left -= 1
            if patience_left <= 0:
                break
    return best_params, history
