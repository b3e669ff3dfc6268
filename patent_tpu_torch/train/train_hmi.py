"""HMI (Hyperbolic Multi-label Inference) training (port of
patent_tpu/train/train_hmi.py).

The reference uses a trained HMI as its "GE" graph-embedding model but
ships no training code for it.  This trains HMI on the inputs of
``data/hmi_inputs.generate_hmi_inputs``:

* features L2-normalized, then scaled by 0.3 (points well inside the unit
  ball), projected and mapped by one Möbius layer;
* BCE on the insideness − disjointedness logit of each sampled (figure,
  label) pair of Y_pos (target 1) and Y_neg (target 0), label indices
  taken relative to the table (minus the figure count; one that falls
  outside it is read as JAX's gather reads it: ``_table_index``);
* implication insideness and exclusion disjointedness hinges and the HMI
  regularizers (``losses/hierarchy.hmi_losses``);
* Riemannian Adam at c = 1 on the label table and the hyperbolic bias.

JAX runs each epoch's steps as one ``lax.scan``; here the epoch is one
``ScanLoop`` (utils/graphs.py): on the card a CUDA graph of a step,
replayed once a batch, the batch's rows picked by a device index from the
epoch's index matrix (one copy to the device into a static buffer) and
the losses written to a device buffer, read once an epoch as their mean.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..data.hmi_inputs import HMIInputs
from ..losses.hierarchy import hmi_losses
from ..models.hyperbolic import HMI
from ..ops.horosphere import disjointedness_unit, insideness_unit
from ..ops.rows import take_rows
from ..utils.graphs import ScanLoop, upload
from ..utils.logging import MetricsLogger
from .optim import RiemannianAdam


def _table_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Label indices as JAX's gather reads them: a negative index counts
    from the end, and one still out of range is clamped to the table.
    Y_neg draws from every node, figures too, whose index less the figure
    count is negative."""
    idx = np.where(idx < 0, idx + n, idx)
    return np.clip(idx, 0, n - 1)


def _scaled(features: np.ndarray) -> np.ndarray:
    x = np.asarray(features, np.float32)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8) * 0.3


def train_hmi(features: np.ndarray, inputs: HMIInputs, num_labels: int,
              embed_dim: int = 64, epochs: int = 50, batch_size: int = 256,
              learning_rate: float = 2e-3,
              inside_weight: float = 1.0, disjoint_weight: float = 1.0,
              reg_weight: float = 0.01, seed: int = 42,
              logger: MetricsLogger | None = None,
              device: torch.device | str = "cuda",
              graphed: bool | None = None) -> tuple[dict, dict]:
    """Returns (state dict, history {"train_loss": per-epoch means}).

    ``features``: [num_figures, D] Euclidean figure features.
    ``inputs.y_pos/y_neg``: (figure index, absolute label index) pairs.
    ``graphed``: the epochs as CUDA graphs (by default on the card)."""
    device = torch.device(device)
    logger = logger or MetricsLogger(print_every=10)
    rng = np.random.default_rng(seed)
    nf = features.shape[0]
    model = HMI(feature_dim=features.shape[1], embed_dim=embed_dim,
                label_num=num_labels,
                generator=torch.Generator().manual_seed(seed))
    # eval mode: no weight dropout, as JAX's apply runs deterministic
    model = model.to(device).eval()
    optimizer = RiemannianAdam(dict(model.named_parameters()), learning_rate,
                               c=1.0)

    y_pos = inputs.y_pos.copy()
    y_pos[:, 1] = _table_index(y_pos[:, 1] - nf, num_labels)
    y_neg = inputs.y_neg.copy()
    y_neg[:, 1] = _table_index(y_neg[:, 1] - nf, num_labels)
    impl = torch.from_numpy(_table_index(inputs.implication - nf,
                                         num_labels)).to(device)
    excl = torch.from_numpy(_table_index(inputs.exclusion - nf,
                                         num_labels)).to(device)
    x_dev = torch.from_numpy(_scaled(features)).to(device)

    def loss_fn(fig_idx, lbl_idx, target):
        enc = model.encode(x_dev[fig_idx])
        lbl = take_rows(model.label_emb, lbl_idx)
        logit = (insideness_unit(enc, lbl)
                 - disjointedness_unit(enc, lbl))[..., 0]
        bce = -(target * F.logsigmoid(logit)
                + (1.0 - target) * F.logsigmoid(-logit)).mean()
        terms = hmi_losses(enc, model.label_emb, impl, excl)
        return (bce + inside_weight * terms["inside_loss"]
                + disjoint_weight * terms["disjoint_loss"]
                + reg_weight * (terms["label_reg"] + terms["instance_reg"]))

    pairs = np.concatenate([y_pos, y_neg], axis=0)
    targets = np.concatenate([np.ones(len(y_pos), np.float32),
                              np.zeros(len(y_neg), np.float32)])
    pairs_dev = torch.from_numpy(pairs).to(device)
    targets_dev = torch.from_numpy(targets).to(device)
    history: dict[str, list] = {"train_loss": []}
    n = len(pairs)
    it = 0
    buf: dict = {"idx": None}

    def step(i):
        for p in optimizer.params.values():
            p.grad = None
        rows = buf["idx"].index_select(0, i.view(1))[0]
        loss = loss_fn(pairs_dev[rows, 0], pairs_dev[rows, 1],
                       targets_dev[rows])
        loss.backward()
        optimizer.update({k: p.grad for k, p in optimizer.params.items()})
        return loss.detach()

    loop = ScanLoop(step, device, graphed)
    for epoch in range(1, epochs + 1):
        n_steps = n // batch_size
        if n_steps:
            idx = rng.permutation(n)[:n_steps * batch_size]
        else:  # a tiny dataset: one full batch, resampled up to size
            n_steps = 1
            idx = rng.choice(n, size=min(batch_size, n),
                             replace=n < batch_size)
        buf["idx"] = upload(buf["idx"], idx.reshape(n_steps, -1), device)
        losses = loop.run_updates(optimizer, n_steps, 1,
                                  (buf["idx"],))
        it += n_steps
        tot = float(losses.mean())
        history["train_loss"].append(tot)
        logger.log(it, {"epoch": epoch, "train_loss": tot})
    return {k: v.detach() for k, v in model.state_dict().items()}, history


@torch.no_grad()
def hmi_label_scores(model_params: dict, features: np.ndarray,
                     embed_dim: int, num_labels: int,
                     batch_size: int = 512,
                     device: torch.device | str = "cuda") -> np.ndarray:
    """[n, num_labels] classification logits (reference HMI.classifier,
    models.py:374-378), in batches of ``batch_size`` rows, on the host."""
    device = torch.device(device)
    model = HMI(feature_dim=features.shape[1], embed_dim=embed_dim,
                label_num=num_labels)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           model_params.items()})
    model = model.to(device).eval()
    x = torch.from_numpy(_scaled(features))
    out = [model(x[s:s + batch_size].to(device)).cpu().numpy()
           for s in range(0, len(x), batch_size)]
    return np.concatenate(out, axis=0)
