"""train_class_pro: GCN figure-pair classification (port of
patent_tpu/train/train_gcn.py; reference src/train.py:124-377).

``EnhancedVGAE`` over the whole heterogeneous graph, 5-way cross-entropy
over the pairs' connection levels, a 0.8 / 0.1 / 0.1 split, AdamW with
optax's arithmetic (weight decay on every leaf) at a staircase
exponential decay (×0.7 every 200 steps), patience on the validation
loss, and a test report with the confusion matrix and per-class
precision, recall and F1.  Each step encodes the whole graph (BatchNorm
over the nodes, its running statistics moved once a step) and classifies
one batch of pairs; an epoch's ragged tail is padded cyclically from the
pool with weight 0 (the padded rows pass through the classifier but add
nothing to the loss).  The host stream (split, shuffles, padding) is
JAX's, from one ``np.random.default_rng(cfg.seed)``; the dropout masks
come from a seeded ``torch.Generator`` on the device.  An epoch runs as
JAX's one-dispatch scan does: on the card one CUDA graph of a step
(utils/graphs.py ``ScanLoop``), replayed once a batch, the generator
registered with it, BatchNorm's running statistics and the optimizer's
state updated in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.classification import confusion_counts, per_class_prf
from ..models.gcn import (EnhancedVGAE, normalize_adjacency,
                          normalize_adjacency_host,
                          normalize_adjacency_sparse)
from ..utils.config import GCNTrainConfig
from ..utils.graphs import ScanLoop, upload
from ..utils.logging import MetricsLogger
from .optim import AdamW, exponential_decay

SPARSE_ABOVE = 16384


def prepare_adjacency(adjacency, mode: str = "auto",
                      device: torch.device | str = "cpu"):
    """The adjacency the GCN runs on, on ``device``: ``"sparse"`` a sorted
    ``SparseAdj`` (gather + segment sums, O(E·D)); ``"dense"`` the [N, N]
    matrix, normalized on the host and kept in bf16 above 16,384 nodes;
    ``"auto"`` sparse for a scipy matrix above 16,384 nodes, else dense."""
    import scipy.sparse as sp

    is_sp = sp.issparse(adjacency)
    n = adjacency.shape[0]
    if mode == "auto":
        mode = "sparse" if (is_sp and n > SPARSE_ABOVE) else "dense"
    if mode == "sparse":
        return normalize_adjacency_sparse(
            adjacency if is_sp else sp.csr_matrix(adjacency)).to(device)
    dense = adjacency.toarray() if is_sp else np.asarray(adjacency)
    if n > SPARSE_ABOVE:
        return normalize_adjacency_host(dense).to(device)
    return normalize_adjacency(torch.as_tensor(dense, dtype=torch.float32,
                                               device=device))


def train_pair_classification(x: np.ndarray, adjacency,
                              pairs: np.ndarray, labels: np.ndarray,
                              cfg: GCNTrainConfig,
                              logger: MetricsLogger | None = None,
                              device: torch.device | str = "cuda",
                              graphed: bool | None = None
                              ) -> tuple[dict, dict, dict]:
    """Returns (state dict of the best epoch, history, test report).
    ``adjacency``: dense or scipy-sparse (``prepare_adjacency``).
    ``graphed``: the training epochs as CUDA graphs (by default on the
    card)."""
    device = torch.device(device)
    logger = logger or MetricsLogger(print_every=20)
    rng = np.random.default_rng(cfg.seed)
    a_tilde = prepare_adjacency(adjacency, cfg.adjacency, device)
    x_dev = torch.as_tensor(np.asarray(x, np.float32), device=device)
    model = EnhancedVGAE(x.shape[1], cfg.hidden_dim, cfg.latent_dim,
                         cfg.num_layers,
                         generator=torch.Generator().manual_seed(cfg.seed)
                         ).to(device)
    params = dict(model.named_parameters())
    optimizer = AdamW(params, cfg.learning_rate,
                      weight_decay=cfg.weight_decay,
                      schedule=exponential_decay(cfg.learning_rate, 200, 0.7,
                                                 staircase=True))
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    perm = rng.permutation(len(pairs))
    n_train = int(len(pairs) * cfg.train_ratio)
    n_val = int(len(pairs) * cfg.val_ratio)
    tr, va, te = (perm[:n_train], perm[n_train:n_train + n_val],
                  perm[n_train + n_val:])
    pairs_dev = torch.as_tensor(np.asarray(pairs, np.int64), device=device)
    labels_np = np.asarray(labels, np.int64)
    labels_dev = torch.as_tensor(labels_np, device=device)

    def epoch_batches(idx_pool: np.ndarray, shuffle: bool):
        """[n_steps, B] indices and {0, 1} weights: the ragged tail padded
        cyclically from the pool (np.resize) with weight 0."""
        order = rng.permutation(idx_pool) if shuffle else np.asarray(idx_pool)
        n_steps = max(1, -(-len(order) // cfg.batch_size))
        pad = n_steps * cfg.batch_size - len(order)
        wt = np.ones(len(order), np.float32)
        if pad:
            order = np.resize(order, n_steps * cfg.batch_size)
            wt = np.concatenate([wt, np.zeros(pad, np.float32)])
        return (order.reshape(n_steps, cfg.batch_size),
                wt.reshape(n_steps, cfg.batch_size))

    def batch_loss(logits, idx, wt):
        ce = F.cross_entropy(logits, labels_dev[idx], reduction="none")
        return (ce * wt).sum() / torch.clamp_min(wt.sum(), 1.0)

    buf: dict = {"mats": None}

    def step(i):
        mats = buf["mats"].index_select(1, i.view(1))
        idx, wt = mats[0, 0].long(), mats[1, 0].view(torch.float32)
        for p in params.values():
            p.grad = None
        logits = model.encode_and_classify(x_dev, a_tilde, pairs_dev[idx],
                                           gen)
        loss = batch_loss(logits, idx, wt)
        loss.backward()
        optimizer.update({n: p.grad for n, p in params.items()})
        return loss.detach()

    loop = ScanLoop(step, device, graphed)

    def train_epoch(idx_mat, wt_mat) -> float:
        model.train()
        # indices and weights (by their bits) in one int32 copy
        buf["mats"] = upload(buf["mats"], np.stack(
            [idx_mat.astype(np.int32), wt_mat.view(np.int32)]), device)
        losses = loop.run_updates(optimizer, idx_mat.shape[0], 1,
                                  (buf["mats"],), (gen,))
        return float(losses.mean())

    @torch.no_grad()
    def evaluate(idx_pool) -> tuple[float, float, np.ndarray]:
        model.eval()
        idx_mat, wt_mat = epoch_batches(idx_pool, shuffle=False)
        z = model(x_dev, a_tilde)
        losses, preds = [], []
        for idx, wt in zip(torch.as_tensor(idx_mat, device=device),
                           torch.as_tensor(wt_mat, device=device)):
            pi = pairs_dev[idx]
            logits = model.classify_pair(z[pi[:, 0]], z[pi[:, 1]])
            losses.append(batch_loss(logits, idx, wt))
            preds.append(logits.argmax(dim=-1))
        valid = wt_mat.reshape(-1) > 0.0
        preds_all = torch.cat(preds).cpu().numpy()[valid]
        trues_all = labels_np[idx_mat.reshape(-1)[valid]]
        return (float(torch.stack(losses).mean()),
                float((preds_all == trues_all).mean()),
                confusion_counts(trues_all, preds_all, 5))

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_val, best = float("inf"), snapshot()
    patience_left = cfg.patience
    history: dict[str, list] = {"train_loss": [], "val_loss": [],
                                "val_acc": []}
    step = 0
    for epoch in range(1, cfg.epochs + 1):
        idx_mat, wt_mat = epoch_batches(tr, shuffle=True)
        tot = train_epoch(idx_mat, wt_mat)
        step += idx_mat.shape[0]
        val_loss, val_acc, _ = evaluate(va)
        history["train_loss"].append(tot)
        history["val_loss"].append(val_loss)
        history["val_acc"].append(val_acc)
        logger.log(step, {"epoch": epoch, "train_loss": tot,
                          "val_loss": val_loss, "val_acc": val_acc},
                   force_print=True)
        if val_loss < best_val:
            best_val, best = val_loss, snapshot()
            patience_left = cfg.patience
        else:
            patience_left -= 1
            if patience_left <= 0:
                break

    model.load_state_dict(best)
    test_loss, test_acc, cm = evaluate(te)
    prf = per_class_prf(cm)
    report = {"test_loss": test_loss, "test_acc": test_acc,
              "confusion_matrix": cm.tolist(),
              "precision": prf["precision"].tolist(),
              "recall": prf["recall"].tolist(), "f1": prf["f1"].tolist()}
    return best, history, report


@torch.no_grad()
def export_graph_embeddings(variables: dict, x: np.ndarray, adjacency,
                            hidden_dim: int, latent_dim: int,
                            num_layers: int, figure_index: dict[str, int],
                            adjacency_mode: str = "auto",
                            device: torch.device | str = "cuda"
                            ) -> dict[str, np.ndarray]:
    """Whole-graph inference → {figure name: its L2-normalized embedding}
    (reference compute_graph_embeddings.py:16-62), the adjacency prepared
    as the trainer prepares it; numpy rows on the host."""
    device = torch.device(device)
    model = EnhancedVGAE(x.shape[1], hidden_dim, latent_dim, num_layers)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in variables.items()})
    model = model.to(device).eval()
    a_tilde = prepare_adjacency(adjacency, adjacency_mode, device)
    z = model(torch.as_tensor(np.asarray(x, np.float32), device=device),
              a_tilde).cpu().numpy()
    return {name: z[idx] for name, idx in figure_index.items()}
