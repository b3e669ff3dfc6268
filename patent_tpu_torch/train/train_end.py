"""train_end / train_end_2: joint CLIP + hyperbolic training (port of
patent_tpu/train/train_end.py; reference train.py:2415-3106).

* images (anchors ∥ positives) through the trainable ViT
  (``TrainableVisionTransformer``: rows 12, 13, 15 and 16 on the card, the
  last block the plain ``cls_last_layer``; the last ``trainable_blocks``
  blocks, post-LN and the projection trained) → features;
* CLIP-style multi-positive NT-Xent on the features at scale 1 / 0.07;
* the hyperbolic head (``HyperbolicEmbeddingModel``) encodes the same
  features; hyperbolic loss = the margin retrieval term on the Poincaré
  distance to the patents' label rows + 3 · the hierarchy margins + 0.01 ·
  the dist0 bands + the hyperbolic InfoNCE of anchors against positives;
* total = w · clip + (1 − w) · hyperbolic;
* three optimizer groups, as JAX's ``optax.multi_transform``: AdamW at
  ``lr_clip`` (optax's arithmetic, weight decay 1e-4) on the trained tower
  leaves, Adam at ``lr_euclidean`` on the head's Euclidean leaves,
  Riemannian Adam at ``lr_label_emb`` on its points of the ball
  (``label_emb``, ``hyp_bias``); frozen leaves take no gradient.

The head's dropout draws its masks from a seeded ``torch.Generator`` on
the device.  ``run_end_to_end_synthetic`` draws JAX's host stream: the
same corpus, pairs, shuffles and negatives, so both packages train on the
same batches.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch
from torch import nn

from ..losses.contrastive import hyperbolic_info_nce, multi_positive_nt_xent
from ..losses.hierarchy import (dist0_band_regularizers,
                                hierarchical_margin_losses)
from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..models.vit import (TrainableVisionTransformer, VisionConfig,
                          finetune_param_names)
from ..ops import poincare
from ..ops.rows import take_rows
from ..utils.config import EndToEndConfig
from ..utils.logging import MetricsLogger
from .optim import Adam, AdamW, RiemannianAdam, manifold_mask

# in the order JAX's step returns them (a dict leaves jit sorted by key)
METRICS = ("clip_loss", "hyp_loss", "retrieval_loss", "total_loss")


class EndToEndModel(nn.Module):
    """The tower and the hyperbolic head; its state dict (``vit.*``,
    ``hyp.*``) maps to JAX's ``{"vit", "hyp"}`` tree through
    ``models.weights.end_to_end_params_from_jax`` / ``_to_jax``."""

    def __init__(self, vit: TrainableVisionTransformer,
                 hyp: HyperbolicEmbeddingModel):
        super().__init__()
        self.vit = vit
        self.hyp = hyp


class GroupOptimizer:
    """Disjoint optimizers over named parameters, stepped together from
    the parameters' ``.grad`` (a leaf that got none takes a zero
    gradient, as under ``jax.grad``)."""

    def __init__(self, groups: dict):
        self.groups = groups

    def zero_grad(self) -> None:
        for opt in self.groups.values():
            for p in opt.params.values():
                p.grad = None

    def step(self) -> None:
        for opt in self.groups.values():
            opt.step({n: p.grad if p.grad is not None else
                      torch.zeros_like(p) for n, p in opt.params.items()})


def init_end_to_end(vision_config: VisionConfig, cfg: EndToEndConfig,
                    label_num: int, seed: int = 0,
                    device: torch.device | str = "cpu"
                    ) -> tuple[EndToEndModel, GroupOptimizer]:
    """(model, optimizer): a seeded random tower and head (or load weights
    into ``model`` afterwards: the optimizer holds the same Parameters),
    the frozen tower leaves without gradients, and the three groups."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    vit = TrainableVisionTransformer(vision_config, generator=gen)
    hyp = HyperbolicEmbeddingModel(
        feature_dim=vision_config.projection_dim, embed_dim=cfg.embed_dim,
        label_num=label_num, c=cfg.curvature, generator=gen)
    model = EndToEndModel(vit, hyp).to(device)
    trainable = finetune_param_names(vit, cfg.trainable_blocks,
                                     vision_config.num_layers)
    clip = {}
    for name, prm in vit.named_parameters():
        prm.requires_grad_(name in trainable)
        if name in trainable:
            clip[f"vit.{name}"] = prm
    head = {f"hyp.{n}": p for n, p in hyp.named_parameters()}
    mask = manifold_mask(head)
    riemann = {n: p for n, p in head.items() if mask[n]}
    euclid = {n: p for n, p in head.items() if not mask[n]}
    optimizer = GroupOptimizer({
        "clip": AdamW(clip, cfg.lr_clip, weight_decay=1e-4),
        "euclid": Adam(euclid, cfg.lr_euclidean),
        "riemann": RiemannianAdam(riemann, cfg.lr_label_emb, c=cfg.curvature,
                                  mask=dict.fromkeys(riemann, True))})
    return model, optimizer


def make_end_to_end_step(model: EndToEndModel, optimizer: GroupOptimizer,
                         cfg: EndToEndConfig):
    """(step, loss_fn): ``loss_fn(images [2B], pos_patents [B], neg_patents
    [B, K], implication [I, 2], generator) → (total, metrics)``; ``step``
    takes the same arguments, updates the parameters and returns the
    metrics (0-d tensors, before the update).  The head's dropout follows
    its mode (``model.train()`` / ``.eval()``, the caller's), its masks
    drawn from ``generator``."""
    c, w = cfg.curvature, cfg.clip_weight

    def loss_fn(images, pos_patents, neg_patents, implication,
                generator=None):
        feats = model.vit(images)
        b = pos_patents.shape[0]
        clip_loss = multi_positive_nt_xent(feats, 1.0 / 0.07)
        enc = model.hyp(feats, generator)
        anchors = enc[:b]
        label_emb = model.hyp.label_emb
        pos_d = poincare.dist(anchors, take_rows(label_emb, pos_patents), c)
        neg_d = poincare.dist(anchors[:, None, :],
                              take_rows(label_emb, neg_patents), c).mean(1)
        retrieval = torch.relu(pos_d - neg_d + 0.1).mean()
        inside, disjoint = hierarchical_margin_losses(label_emb, implication,
                                                      None, c)
        label_reg, inst_reg = dist0_band_regularizers(label_emb, anchors, c)
        hyp_contrastive = hyperbolic_info_nce(anchors, enc[b:], c)
        hyp_loss = (retrieval + 3.0 * (inside + disjoint)
                    + 0.01 * (label_reg + inst_reg) + hyp_contrastive)
        total = w * clip_loss + (1 - w) * hyp_loss
        return total, {"clip_loss": clip_loss, "hyp_loss": hyp_loss,
                       "retrieval_loss": retrieval, "total_loss": total}

    def step(images, pos_patents, neg_patents, implication, generator=None):
        optimizer.zero_grad()
        total, metrics = loss_fn(images, pos_patents, neg_patents,
                                 implication, generator)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step, loss_fn


def synthetic_setup(path: str, image_size: int = 32):
    """The CLI's corpus as JAX's ``run_end_to_end_synthetic`` builds it:
    (records, images_dir, graph, pairs, implication [I, 2] int32), the
    pairs the consecutive figures of each patent, the implication pairs
    patent → medium CPC relative to the label table, in COO order."""
    from ..data import synthetic
    from ..data.graph_build import build_hetero_graph

    records, images_dir = synthetic.write_synthetic_corpus(
        os.path.join(path, "synthetic_corpus"), num_patents=12,
        figures_per_patent=3, image_size=image_size)
    graph = build_hetero_graph(records)
    by_patent: dict[str, list] = {}
    for r in records:
        by_patent.setdefault(r.patent_id, []).append(r)
    pairs = []
    for figs in by_patent.values():
        for i in range(len(figs) - 1):
            pairs.append((figs[i], figs[i + 1]))
    off = graph.offsets
    p0 = off["patents"]
    coo = graph.adjacency.tocoo()
    implication = [(i - p0, j - p0) for i, j in zip(coo.row, coo.col)
                   if p0 <= i < off["medium_cpcs"] <= j < off["big_cpcs"]]
    return (records, images_dir, graph, pairs,
            np.asarray(implication, np.int32).reshape(-1, 2))


def synthetic_batches(pairs: list, images_dir: str, graph, epochs: int,
                      batch_size: int, image_size: int
                      ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """JAX's host stream: per epoch ``rng.shuffle(pairs)`` (in place), then
    for each full batch the anchors' then the positives' decoded images,
    the anchors' patent indices and two negatives a row from
    ``rng.integers``; one ``np.random.default_rng(0)`` throughout."""
    from ..input.pipeline import decode_image

    rng = np.random.default_rng(0)
    for _epoch in range(epochs):
        rng.shuffle(pairs)
        for s in range(0, len(pairs) - batch_size + 1, batch_size):
            chunk = pairs[s:s + batch_size]
            imgs = np.stack(
                [decode_image(os.path.join(images_dir, r.figure_id),
                              image_size) for r, _ in chunk] +
                [decode_image(os.path.join(images_dir, r2.figure_id),
                              image_size) for _, r2 in chunk])
            pos = np.asarray([graph.patent_index[r.patent_id]
                              for r, _ in chunk], np.int32)
            neg = rng.integers(0, len(graph.patent_index),
                               (len(chunk), 2)).astype(np.int32)
            yield imgs, pos, neg


def run_end_to_end_synthetic(path: str, epochs: int = 2,
                             logger: MetricsLogger | None = None,
                             image_size: int = 32,
                             device: torch.device | str = "cuda") -> dict:
    """The joint trainer for a few epochs on the synthetic corpus, the CLI
    ``train_end``/``train_end_2`` action's path: 12 patents x 3 figures at
    32 px, the tower of D 64 over 4 heads (patch 8: S 17), 8 pairs a step.
    Returns {"params": state dict, "metrics": the last step's, "steps"}."""
    device = torch.device(device)
    logger = logger or MetricsLogger(print_every=5)
    cfg = EndToEndConfig(batch_size=8, image_size=image_size, embed_dim=16)
    vision_config = VisionConfig(image_size=image_size, patch_size=8,
                                 hidden_dim=64, num_layers=2, num_heads=4,
                                 mlp_dim=128, projection_dim=32)
    _records, images_dir, graph, pairs, implication = synthetic_setup(
        path, image_size)
    label_num = graph.num_nodes - len(graph.figure_index)
    model, optimizer = init_end_to_end(vision_config, cfg, label_num,
                                       device=device)
    step, _loss_fn = make_end_to_end_step(model, optimizer, cfg)
    model.train()
    impl = torch.from_numpy(implication).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    n_steps, last = 0, {}
    for imgs, pos, neg in synthetic_batches(pairs, images_dir, graph, epochs,
                                            cfg.batch_size, image_size):
        metrics = step(torch.from_numpy(imgs).to(device),
                       torch.from_numpy(pos).to(device),
                       torch.from_numpy(neg).to(device), impl, gen)
        n_steps += 1
        last = {k: float(v) for k, v in metrics.items()}
        logger.log(n_steps, last)
    logger.log(n_steps, last, force_print=True)
    return {"params": model.state_dict(), "metrics": last, "steps": n_steps}
