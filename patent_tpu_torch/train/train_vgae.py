"""VGAE link prediction (port of patent_tpu/train/train_vgae.py): train
the VGAE (reference src/models.py:881-903) on the training adjacency of a
seeded edge split (data/edges.py) and validate by the ROC-AUC and AP of
held-out edges against sampled non-edges, every 5 epochs and at the end;
the best validation AUC's weights give the test report.

Two objectives: ``"dense"`` reconstructs sigmoid(Z Zᵀ) and takes the
class-balanced BCE over all N² entries (the reference's, auxiliary.py:
36-58); ``"sampled"`` takes the BCE of every training edge against as
many random pairs drawn afresh each step, scored from the latents alone,
over the sparse adjacency: O(E·d) a step.  ``"auto"`` samples above
16,384 nodes.  Adam with optax's arithmetic.  The steps between two
validations run as JAX's chunks of 5 do (one ``lax.scan``): on the card
one CUDA graph of a step (utils/graphs.py ``ScanLoop``) replayed once an
epoch, the negatives' generator registered with it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..data.edges import (EdgeSplit, _pos_neg_metrics, link_prediction_scores,
                          split_edges)
from ..models.gcn import VGAE, normalize_adjacency, normalize_adjacency_sparse
from ..ops.rows import take_rows
from ..utils.graphs import ScanLoop
from ..utils.logging import MetricsLogger
from .optim import Adam

SAMPLED_ABOVE = 16384


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _update(model, optimizer, loss_fn) -> torch.Tensor:
    """One step in train mode, the optimizer's device half (after its
    ``reserve``); returns the loss on the device."""
    model.train()
    for p in optimizer.params.values():
        p.grad = None
    loss = loss_fn()
    loss.backward()
    optimizer.update({n: p.grad for n, p in optimizer.params.items()})
    return loss.detach()


def _chunks(epochs: int, every: int = 5) -> list[tuple[int, int]]:
    """(first, last) epochs of each run of steps between validations
    (every ``every`` epochs and after the last), as JAX's chunks."""
    ends = sorted(set(range(every, epochs + 1, every))
                  | ({epochs} if epochs > 0 else set()))
    return [(a + 1, b) for a, b in zip([0] + ends[:-1], ends)]


def _train_chunks(model, optimizer, loss_fn, epochs: int, device,
                  graphed, generators, validate) -> None:
    """The training loop: each chunk of epochs (one step each) as one
    ``ScanLoop`` run, then ``validate(epoch, last loss)``."""
    loop = ScanLoop(lambda _i: _update(model, optimizer, loss_fn), device,
                    graphed)
    for first, last in _chunks(epochs):
        losses = loop.run_updates(optimizer, last - first + 1, 1, (),
                                  generators)
        validate(last, float(losses[-1, 0]))


def train_vgae_link_prediction(x: np.ndarray, adjacency,
                               hidden_dim: int = 64, latent_dim: int = 32,
                               epochs: int = 50, learning_rate: float = 1e-2,
                               val_ratio: float = 0.05,
                               test_ratio: float = 0.1, seed: int = 42,
                               logger: MetricsLogger | None = None,
                               mode: str = "auto",
                               device: torch.device | str = "cuda",
                               graphed: bool | None = None
                               ) -> tuple[dict, EdgeSplit, dict]:
    """Returns (state dict, edge split, test report).  ``graphed``: the
    training steps as CUDA graphs (by default on the card)."""
    import scipy.sparse as sp

    device = torch.device(device)
    logger = logger or MetricsLogger(print_every=10)
    if not sp.issparse(adjacency):
        adjacency = sp.csr_matrix(adjacency)
    split = split_edges(adjacency, val_ratio=val_ratio,
                        test_ratio=test_ratio, seed=seed)
    if mode == "auto":
        mode = "sampled" if adjacency.shape[0] > SAMPLED_ABOVE else "dense"
    model = VGAE(x.shape[1], hidden_dim, latent_dim,
                 generator=torch.Generator().manual_seed(seed)).to(device)
    optimizer = Adam(dict(model.named_parameters()), learning_rate)
    x_dev = torch.as_tensor(np.asarray(x, np.float32), device=device)
    if mode == "sampled":
        return _train_vgae_sampled(model, optimizer, x_dev, split, epochs,
                                   seed, logger, graphed)

    a_np = split.train_adjacency.toarray()
    a_tilde = normalize_adjacency(torch.as_tensor(a_np, dtype=torch.float32,
                                                  device=device))
    a_target = torch.as_tensor((a_np > 0).astype(np.float32), device=device)
    n_pos = torch.clamp_min(a_target.sum(), 1.0)
    n_neg = torch.clamp_min(a_target.numel() - n_pos, 1.0)
    w_pos = a_target.numel() / (2.0 * n_pos)
    w_neg = a_target.numel() / (2.0 * n_neg)

    def loss_fn():
        _z, a_rec = model(x_dev, a_tilde)
        a_rec = torch.clamp(a_rec, 1e-7, 1.0 - 1e-7)
        bce = -(w_pos * a_target * torch.log(a_rec)
                + w_neg * (1 - a_target) * torch.log(1 - a_rec))
        return bce.sum() / a_target.numel()

    @torch.no_grad()
    def reconstruction():
        model.eval()
        return model(x_dev, a_tilde)[1].cpu().numpy()

    best = {"auc": 0.0, "params": _snapshot(model)}

    def validate(epoch, loss):
        val = link_prediction_scores(reconstruction(), split.val_edges,
                                     split.val_non_edges)
        logger.log(epoch, {"loss": loss, "val_auc": val["roc_auc"],
                           "val_ap": val["average_precision"]},
                   force_print=True)
        if val["roc_auc"] > best["auc"]:
            best["auc"], best["params"] = val["roc_auc"], _snapshot(model)

    _train_chunks(model, optimizer, loss_fn, epochs, device, graphed, (),
                  validate)
    best = best["params"]
    model.load_state_dict(best)
    test = link_prediction_scores(reconstruction(), split.test_edges,
                                  split.test_non_edges)
    return best, split, test


def sampled_loss(model: VGAE, x_dev, a_tilde, train_edges: torch.Tensor,
                 neg: torch.Tensor) -> torch.Tensor:
    """The sampled objective: (mean softplus(−z_i·z_j) over the training
    edges + mean softplus(z_i·z_j) over the random pairs) / 2."""
    z = model.encode(x_dev, a_tilde)

    def logits(pairs):
        return (take_rows(z, pairs[:, 0]) * take_rows(z, pairs[:, 1])).sum(1)

    return (F.softplus(-logits(train_edges)).mean()
            + F.softplus(logits(neg)).mean()) * 0.5


def draw_negatives(n: int, shape: tuple, generator: torch.Generator
                   ) -> torch.Tensor:
    """The sampled objective's random pairs of a step: node indices below
    ``n`` of ``shape``, from ``generator`` on its device."""
    return torch.randint(0, n, shape, generator=generator,
                         device=generator.device)


def _train_vgae_sampled(model, optimizer, x_dev, split: EdgeSplit,
                        epochs: int, seed: int, logger: MetricsLogger,
                        graphed: bool | None = None
                        ) -> tuple[dict, EdgeSplit, dict]:
    """The sampled-edge objective over the sparse adjacency; a random pair
    (i, i) is rerolled to (i, i + 1 mod n), whose logit would be exactly 1
    on normalized latents."""
    device = x_dev.device
    a_tilde = normalize_adjacency_sparse(split.train_adjacency).to(device)
    n = split.train_adjacency.shape[0]
    train_edges = torch.as_tensor(split.train_edges.astype(np.int64),
                                  device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    @torch.no_grad()
    def eval_split(edges, non_edges) -> dict:
        model.eval()
        z = model.encode(x_dev, a_tilde)

        def scores(p):
            p = torch.as_tensor(p.astype(np.int64), device=device)
            return torch.sigmoid((z[p[:, 0]] * z[p[:, 1]]).sum(1)).cpu(
            ).numpy()

        return _pos_neg_metrics(scores(edges), scores(non_edges))

    def loss_fn():
        neg = draw_negatives(n, tuple(train_edges.shape), gen)
        neg[:, 1] = torch.where(neg[:, 0] == neg[:, 1], (neg[:, 1] + 1) % n,
                                neg[:, 1])
        return sampled_loss(model, x_dev, a_tilde, train_edges, neg)

    best = {"auc": 0.0, "params": _snapshot(model)}

    def validate(epoch, loss):
        val = eval_split(split.val_edges, split.val_non_edges)
        logger.log(epoch, {"loss": loss, "val_auc": val["roc_auc"],
                           "val_ap": val["average_precision"]},
                   force_print=True)
        if val["roc_auc"] > best["auc"]:
            best["auc"], best["params"] = val["roc_auc"], _snapshot(model)

    _train_chunks(model, optimizer, loss_fn, epochs, device, graphed, (gen,),
                  validate)
    best = best["params"]
    model.load_state_dict(best)
    return best, split, eval_split(split.test_edges, split.test_non_edges)
