"""CLIP fine-tuning with graph alignment (port of
patent_tpu/train/finetune_clip.py; retrieval.ipynb cell 20).

* anchors ∥ positives in one [2B] u8 batch, normalized on the device, go
  through the trainable ViT (``TrainableVisionTransformer``: the attention
  and MLP blocks as autograd Functions over the CUDA kernels);
* ``AlignmentHead``: a learnable graph-node embedding table (initialized
  from the PCA-whitened VGAE matrix), a learnable temperature
  (``logit_scale``, exp-clamped at 100) and image / graph projectors;
* loss (1 − α)·NT-Xent + α·(1 − cos), α warmed up over 5 epochs;
* ``torch.optim.AdamW`` in four groups (CLIP 2e-5, projectors 2e-4,
  embedding table 1e-4, logit_scale 5e-4, weight decay 1e-2), the CLIP
  group the last N vision blocks; frozen parameters take no gradient and
  no update (optax's ``set_to_zero``).

The sharded step over a (data, model) mesh (``pad_graph_table``,
``shard_finetune_state``, ``make_sharded_finetune_step``): each ``data``
rank runs its block of the [2B] images through the tower, the features
are all-gathered (the backward keeps this rank's slice) and every rank
computes the single-device loss on the global batch; the graph table is
zero-padded and row-sharded over ``model``, its rows gathered from their
owners.  The tower's gradients, taken before the gather, are summed over
``data`` before AdamW; the projectors', ``logit_scale``'s and the table's,
taken after it, are already whole.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..losses.contrastive import graph_alignment_cosine, multi_positive_nt_xent
from ..models.vit import (TrainableVisionTransformer, VisionConfig,
                          finetune_param_names)
from ..utils.config import ClipFinetuneConfig


class AlignmentHead(nn.Module):
    """Graph-embedding table, ``logit_scale`` and the two projectors, each
    a Linear followed by ReLU (Flax names ``Dense_0``: image, ``Dense_1``:
    graph)."""

    def __init__(self, num_nodes: int, graph_dim: int = 128,
                 proj_dim: int = 128, init_tau: float = 0.10,
                 image_dim: int = 512, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.graph_embedding = nn.Parameter(0.02 * torch.randn(
            (num_nodes, graph_dim), generator=generator, device=device))
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1.0 / init_tau), device=device))

        def proj(fan_in):
            lin = nn.Linear(fan_in, proj_dim, device=device)
            with torch.no_grad():
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=generator,
                                             device=device)
                                 / math.sqrt(fan_in))
                lin.bias.zero_()
            return nn.Sequential(lin, nn.ReLU())

        self.img_proj = proj(image_dim)
        self.graph_proj = proj(graph_dim)

    def forward(self, image_features: torch.Tensor, node_idx: torch.Tensor):
        """→ (projected image feats [2B], projected graph feats [B],
        logit scale)."""
        return self.project(image_features,
                            self.graph_embedding[node_idx.long()])

    def project(self, image_features: torch.Tensor,
                graph_rows: torch.Tensor):
        """``forward`` from the graph table's rows of the batch."""
        z = self.img_proj(image_features)
        g = self.graph_proj(graph_rows)
        scale = torch.clamp(torch.exp(self.logit_scale), max=100.0)
        return z, g, scale


class FinetuneModel(nn.Module):
    """The tower and the head; its state dict (``vit.*``, ``head.*``) maps
    to the JAX fine-tune tree ``{"vit", "head"}`` through
    ``models.weights``."""

    def __init__(self, vit: TrainableVisionTransformer, head: AlignmentHead):
        super().__init__()
        self.vit = vit
        self.head = head

    def forward(self, images: torch.Tensor, node_idx: torch.Tensor):
        return self.head(self.vit(images), node_idx)


def pca_whiten(matrix: np.ndarray, dim: int = 128) -> np.ndarray:
    """PCA-whiten the VGAE embedding matrix to ``dim`` columns (cell 19)."""
    x = matrix - matrix.mean(axis=0, keepdims=True)
    u, s, _vt = np.linalg.svd(x, full_matrices=False)
    k = min(dim, s.shape[0])
    white = u[:, :k] * np.sqrt(x.shape[0] - 1)
    if k < dim:
        white = np.pad(white, ((0, 0), (0, dim - k)))
    return white.astype(np.float32)


def init_finetune_state(vision_config: VisionConfig, cfg: ClipFinetuneConfig,
                        vgae_matrix: np.ndarray, seed: int = 0,
                        device: torch.device | str = "cpu"
                        ) -> tuple[FinetuneModel, torch.optim.Optimizer]:
    """(model, optimizer): a seeded random tower (or load weights into
    ``model`` afterwards: the optimizer holds the same Parameters), the
    head with the PCA-whitened table, and AdamW in four groups."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    vit = TrainableVisionTransformer(vision_config,
                                     keep_tokens=cfg.keep_tokens,
                                     generator=gen)
    white = pca_whiten(vgae_matrix, cfg.graph_proj_dim)
    head = AlignmentHead(white.shape[0], cfg.graph_proj_dim,
                         cfg.graph_proj_dim, cfg.init_tau,
                         vision_config.projection_dim, generator=gen)
    with torch.no_grad():
        head.graph_embedding.copy_(torch.from_numpy(white))
    model = FinetuneModel(vit, head).to(device)

    trainable = finetune_param_names(vit, cfg.trainable_blocks,
                                     vision_config.num_layers)
    clip = []
    for name, prm in vit.named_parameters():
        prm.requires_grad_(name in trainable)
        if name in trainable:
            clip.append(prm)
    proj = [*head.img_proj.parameters(), *head.graph_proj.parameters()]
    groups = [(clip, cfg.lr_clip), (proj, cfg.lr_proj),
              ([head.graph_embedding], cfg.lr_embed),
              ([head.logit_scale], cfg.lr_logit_scale)]
    optimizer = torch.optim.AdamW(
        [{"params": p, "lr": lr} for p, lr in groups],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return model, optimizer


def _ft_loss(z, g, scale, alpha):
    ce = multi_positive_nt_xent(z, scale)
    align = graph_alignment_cosine(z[:g.shape[0]], g)
    loss = (1.0 - alpha) * ce + alpha * align
    return loss, {"loss": loss, "cross_loss": ce, "align_loss": align,
                  "tau": 1.0 / scale}


def make_finetune_step(model: FinetuneModel, optimizer):
    """(step, eval_step), each ``(images [2B] u8 or normalized f32 on the
    model's device, node_idx [B], alpha) → metrics`` (0-d tensors:
    ``loss``, ``cross_loss``, ``align_loss``, ``tau``).  ``step`` also
    takes one optimizer step; the metrics are those before it."""
    from ..retrieval.engine import device_normalize

    def loss_fn(images, node_idx, alpha):
        return _ft_loss(*model(device_normalize(images), node_idx), alpha)

    def step(images, node_idx, alpha):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(images, node_idx, alpha)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(images, node_idx, alpha):
        with torch.no_grad():
            return loss_fn(images, node_idx, alpha)[1]

    return step, eval_step


def pad_graph_table(model: FinetuneModel, optimizer, model_size: int):
    """Zero-pad the head's ``graph_embedding`` table (and its AdamW
    moments, where a step made them) to a multiple of ``model_size`` rows,
    so it can be row-sharded.  Padded rows are inert: no ``node_idx``
    gathers them, so their gradient and their AdamW update are exactly
    zero.  Returns (model, optimizer, real rows, padded rows)."""
    from ..parallel.sharded_train import pad_table_rows

    real, padded = pad_table_rows(model, optimizer, "graph_embedding",
                                  model_size)
    return model, optimizer, real, padded


def shard_finetune_state(mesh, model: FinetuneModel, optimizer):
    """Keep this ``model`` rank's row block of the graph table (and of its
    moments); the tower and the projectors stay on every rank.  A table
    that does not divide the axis goes through ``pad_graph_table``
    first."""
    from ..parallel.sharded_train import shard_table_rows

    shard_table_rows(mesh, model, optimizer, "graph_embedding",
                     "pad_graph_table")
    return model, optimizer


def make_sharded_finetune_step(mesh, model: FinetuneModel, optimizer):
    """The fine-tune step over a (data, model) mesh: (step, eval_step,
    place_batch).

    ``place_batch(images [2B], node_idx [B])``: this rank's blocks of the
    global batch (host arrays) on its device; both must divide the
    ``data`` axis.  ``step`` / ``eval_step(images, node_idx, alpha)`` take
    the placed blocks and return the metrics of the global batch, as the
    single-device step computes them."""
    import torch.distributed as dist

    from ..parallel.mesh import (RowBlocks, all_gather_rows, axis_group,
                                 axis_rank, axis_size, gather_rows_grad,
                                 mesh_device, take_owned_rows)
    from ..retrieval.engine import device_normalize

    device = mesh_device(mesh)
    data_g, model_g = axis_group(mesh, "data"), axis_group(mesh, "model")
    n_data = axis_size(mesh, "data")
    tower = [p for p in model.vit.parameters() if p.requires_grad]

    def place_batch(images, node_idx):
        # both arrays: 3 pairs on data=2 divide the 6 images but not the
        # 3 node indices
        if images.shape[0] % n_data or node_idx.shape[0] % n_data:
            raise ValueError(
                f"global image batch ({images.shape[0]}) and pair count "
                f"({node_idx.shape[0]}) must divide the data axis "
                f"({n_data})")
        rule = RowBlocks("data")
        return (torch.as_tensor(rule.local(mesh, images)).to(device),
                torch.as_tensor(rule.local(mesh, node_idx)).to(device))

    def loss_fn(images, node_idx, alpha):
        feats = gather_rows_grad(model.vit(device_normalize(images)), data_g)
        nodes = all_gather_rows(node_idx, data_g).long()
        table = model.head.graph_embedding
        rows = take_owned_rows(table, nodes,
                               axis_rank(mesh, "model") * table.shape[0],
                               model_g)
        return _ft_loss(*model.head.project(feats, rows), alpha)

    def step(images, node_idx, alpha):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(images, node_idx, alpha)
        loss.backward()
        for p in tower:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=data_g)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(images, node_idx, alpha):
        with torch.no_grad():
            return loss_fn(images, node_idx, alpha)[1]

    return step, eval_step, place_batch


def alpha_schedule(epoch: int, cfg: ClipFinetuneConfig) -> float:
    """α warm-up over the first ``warmup_epochs`` epochs (cell 20)."""
    if epoch < cfg.warmup_epochs:
        return cfg.alpha_max * (epoch + 1) / cfg.warmup_epochs
    return cfg.alpha_max


def _log(step: int, metrics: dict, force: bool = False,
         every: int = 10) -> None:
    if force or step % every == 0:
        print("  ".join([f"step {step}"] + [
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()]), flush=True)


def run_finetune(anchor_paths, positive_paths, graph_node_idx, vgae_matrix,
                 vision_config: VisionConfig, cfg: ClipFinetuneConfig,
                 val_fraction: float = 0.1, ckpt_dir: str | None = None,
                 image_size: int | None = None, cache=None,
                 device: torch.device | str = "cuda",
                 init_vit: dict[str, torch.Tensor] | None = None
                 ) -> tuple[dict, dict]:
    """The fine-tuning loop (cell 20 ``fine_tune_clip``), as the JAX one:
    the seeded split holds out a random ``val_fraction`` of the pairs, each
    epoch walks a fresh permutation of the rest (the same
    ``np.random.default_rng(cfg.seed)`` draws, so the same pairs meet at
    each step), α is warmed up per epoch, validation runs every
    ``cfg.val_every`` steps and at each epoch's end, and the best
    validation state is saved as ``clip_finetune_best`` under
    ``ckpt_dir`` ({"params": {"vit", "head"}, "step"} with its
    metadata).  ``init_vit``: a tower state dict to start from (CLIP's
    weights: ``clip_import.load_hf_clip_params``) instead of the seeded
    one.  Returns (best state dict, history)."""
    from ..input.pipeline import PairBatcher
    from ..models.weights import params_to_jax
    from ..utils import checkpoint

    device = torch.device(device)
    image_size = image_size or cfg.image_size
    rng = np.random.default_rng(cfg.seed)
    n = len(anchor_paths)
    assert len(positive_paths) == n and len(graph_node_idx) == n
    n_val = max(1, int(n * val_fraction))
    order = rng.permutation(n)
    val_ids, train_ids = order[:n_val], order[n_val:]

    model, optimizer = init_finetune_state(vision_config, cfg, vgae_matrix,
                                           seed=cfg.seed, device=device)
    if init_vit is not None:
        model.vit.load_state_dict(init_vit)
    step, eval_step = make_finetune_step(model, optimizer)
    batcher = PairBatcher(anchor_paths, positive_paths, graph_node_idx,
                          batch_size=cfg.batch_size, image_size=image_size,
                          num_workers=cfg.num_workers, cache=cache)

    def to_device(images, nodes):
        return (torch.from_numpy(images).to(device),
                torch.from_numpy(nodes).to(device))

    def validate(alpha):
        tot, nb = 0.0, 0
        for images, nodes in batcher.epoch(val_ids):
            tot += float(eval_step(*to_device(images, nodes), alpha)["loss"])
            nb += 1
        return tot / nb if nb else float("inf")

    best_val = float("inf")
    best = None
    history: dict[str, list] = {"train_loss": [], "val_loss": []}
    it = 0

    def keep_best(val_loss, metadata):
        nonlocal best_val, best
        if val_loss < best_val:
            best_val = val_loss
            best = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
            if ckpt_dir is not None:
                checkpoint.save(ckpt_dir, "clip_finetune_best",
                                {"params": params_to_jax(best), "step": it},
                                metadata={"val_loss": best_val, **metadata})

    try:
        for epoch in range(cfg.epochs):
            alpha = alpha_schedule(epoch, cfg)
            perm = rng.permutation(train_ids)
            tot, nb = 0.0, 0
            for images, nodes in batcher.epoch(perm):
                metrics = step(*to_device(images, nodes), alpha)
                metrics = {k: float(v) for k, v in metrics.items()}
                tot += metrics["loss"]
                nb += 1
                it += 1
                _log(it, metrics)
                if cfg.val_every and it % cfg.val_every == 0:
                    vl = validate(alpha)
                    _log(it, {"val_loss": vl}, force=True)
                    keep_best(vl, {})
            val_loss = validate(alpha)
            history["train_loss"].append(tot / max(nb, 1))
            history["val_loss"].append(val_loss)
            _log(it, {"epoch": epoch + 1, "train_loss": tot / max(nb, 1),
                      "val_loss": val_loss, "alpha": alpha}, force=True)
            keep_best(val_loss, {"epoch": epoch + 1})
    finally:
        batcher.close()
    return best, history
