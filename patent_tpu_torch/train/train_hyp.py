"""train_hyp: the hyperbolic retrieval trainer (port of
patent_tpu/train/train_hyp.py).

One step computes every loss term of the JAX trainer from one forward of
the batch figures and their pair partners (2B rows, one dropout draw):

* retrieval: relu(d(f, pos) − mean d(f, neg) + margin) over valid rows;
* hierarchy: the horosphere margins over the implication and exclusion
  pairs of the label table;
* regularizers: the dist0 bands of the labels and the figures;
* figure pair: BCE over −d(f, partner) / τ;

weighted as JAX weighs them (``retrieval_penalty`` multiplies), then one
Riemannian Adam update (train/optim.py).  JAX's autograd ops run on the
device as PyTorch ops; the encoder's first layer takes its plain chain
while autograd records (models/hyperbolic.py), so a training step launches
no kernel of the port.  ``validate_with="map"`` and the final test mAP run
``evaluate_retrieval_map``, whose no-grad encode and label ranking launch
rows 18 and 17 on the card.

The epoch keeps what JAX's one-dispatch ``lax.scan`` buys without a scan:
the batches are sampled on the host with JAX's numpy stream
(``stack_epoch_batches``, the same arrays), copied to the device once an
epoch; the features and the pair sets stay on the device; the metrics are
summed on the device and read once an epoch.  Dropout draws from a
``torch.Generator`` on the device seeded from ``cfg.seed``, and the label
table's gathers sum their gradients in a fixed order (ops/rows.py), so a
run gives the same bits every time on the same device, and a resumed run
those of an uninterrupted one.

Checkpoints use the JAX layout and names (``latest``,
``best_retrieval_model_c{c}_e{d}``), so ``--resume`` continues a run of
either package: params under the JAX tree's names, the optimizer state as
``RiemannianAdamState`` flattens, the numpy batch stream as JSON bytes,
the f64 histories, and the dropout generator's state under
``dropout_generator_state`` (JAX writes its key as ``key_data``, which
the port does not read).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..data.prep import TrainingData, figure_pair_maps
from ..losses.hierarchy import (dist0_band_regularizers,
                                hierarchical_margin_losses)
from ..models.hyperbolic import HyperbolicEmbeddingModel
from ..models.weights import hyperbolic_params_from_jax, hyperbolic_params_to_jax
from ..ops import poincare
from ..ops.rows import take_rows
from ..retrieval.cli_actions import select_device
from ..utils.checkpoint import CheckpointManager
from ..utils.config import HypTrainConfig
from ..utils.logging import MetricsLogger
from .optim import RiemannianAdam, global_norm

METRICS = ("total_loss", "retrieval_loss", "hierarchical_loss", "reg_loss",
           "figure_pair_loss", "grad_norm")
BATCH_FIELDS = ("figure_idx", "pos_patent", "neg_patents", "pair_b_figure",
                "pair_label", "valid")
RNG_KEY = "dropout_generator_state"


@dataclasses.dataclass
class HypBatch:
    """A fixed-shape batch: figures and their supervision indices."""

    figure_idx: np.ndarray       # [B] int32 into x_figures
    pos_patent: np.ndarray       # [B] int32 label index
    neg_patents: np.ndarray      # [B, num_neg] int32 label indices
    pair_b_figure: np.ndarray    # [B] int32 into x_figures (the partner)
    pair_label: np.ndarray       # [B] float: 1 positive pair, 0 negative
    valid: np.ndarray            # [B] float: 1 a real row, 0 padding


class PackedSupervision:
    """The per-figure negative patents and positive / negative partner
    figures packed into padded int32 matrices once, so an epoch's sampling
    is vectorized numpy."""

    def __init__(self, td: TrainingData, maps=None):
        if maps is None:
            maps = figure_pair_maps(td)
        fig_to_pos_patent, fig_to_neg_patents, fig_to_pos_figures, \
            fig_to_neg_figures = maps
        self.usable = np.asarray(
            sorted(set(fig_to_pos_patent) & set(fig_to_neg_patents)), np.int64)
        n = len(self.usable)

        def pack(d):
            lens = np.asarray([len(d.get(int(f), ())) for f in self.usable],
                              np.int32)
            width = max(int(lens.max()) if n else 0, 1)
            mat = np.zeros((n, width), np.int32)
            for i, f in enumerate(self.usable):
                row = d.get(int(f), ())
                mat[i, :len(row)] = row
            return mat, lens

        self.pos_patent = np.asarray(
            [fig_to_pos_patent[int(f)] for f in self.usable], np.int32)
        self.neg_patents, self.neg_patent_len = pack(fig_to_neg_patents)
        self.pos_figs, self.pos_fig_len = pack(fig_to_pos_figures)
        self.neg_figs, self.neg_fig_len = pack(fig_to_neg_figures)
        self.fig_to_slot = {int(f): i for i, f in enumerate(self.usable)}

    def slots_for(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray([self.fig_to_slot[int(f)] for f in indices
                           if int(f) in self.fig_to_slot], np.int64)


def make_batches_packed(packed: PackedSupervision, slots: np.ndarray,
                        batch_size: int, num_neg: int,
                        rng: np.random.Generator) -> Iterator[HypBatch]:
    """Shuffle the slots; per row one positive patent, ``num_neg`` sampled
    negatives and one partner figure (a negative with probability 1/2
    where one exists, else a positive, else the figure itself), padded to
    ``batch_size`` with masked rows.  The numpy draws are JAX's, in its
    order."""
    perm = rng.permutation(len(slots))
    shuffled = slots[perm]
    for start in range(0, len(shuffled), batch_size):
        sl = shuffled[start:start + batch_size]
        b = len(sl)
        figure_idx = packed.usable[sl].astype(np.int32)
        pos_patent = packed.pos_patent[sl]
        u = rng.random((b, num_neg))
        col = (u * packed.neg_patent_len[sl][:, None]).astype(np.int64)
        neg_patents = packed.neg_patents[sl[:, None], col]
        has_neg = packed.neg_fig_len[sl] > 0
        has_pos = packed.pos_fig_len[sl] > 0
        coin = rng.random(b) < 0.5
        use_neg = has_neg & (~has_pos | coin)
        use_pos = ~use_neg & has_pos
        pcol_neg = (rng.random(b) * np.maximum(packed.neg_fig_len[sl], 1)
                    ).astype(np.int64)
        pcol_pos = (rng.random(b) * np.maximum(packed.pos_fig_len[sl], 1)
                    ).astype(np.int64)
        partner = np.where(
            use_neg, packed.neg_figs[sl, pcol_neg],
            np.where(use_pos, packed.pos_figs[sl, pcol_pos],
                     figure_idx)).astype(np.int32)
        pair_label = np.where(use_neg, 0.0, 1.0).astype(np.float32)
        pad = batch_size - b
        if pad:
            figure_idx = np.pad(figure_idx, (0, pad))
            pos_patent = np.pad(pos_patent, (0, pad))
            neg_patents = np.pad(neg_patents, ((0, pad), (0, 0)))
            partner = np.pad(partner, (0, pad))
            pair_label = np.pad(pair_label, (0, pad))
        valid = np.asarray([1.0] * b + [0.0] * pad, np.float32)
        yield HypBatch(figure_idx=figure_idx, pos_patent=pos_patent,
                       neg_patents=neg_patents, pair_b_figure=partner,
                       pair_label=pair_label, valid=valid)


def make_batches(td: TrainingData, indices: np.ndarray, batch_size: int,
                 num_neg: int, rng: np.random.Generator,
                 maps=None) -> Iterator[HypBatch]:
    """The per-figure batch stream of the reference (a loop over figures;
    the trainer uses ``make_batches_packed``): figures without a positive
    and a negative patent are dropped; a self pair only where a figure has
    no partner of either kind."""
    if maps is None:
        maps = figure_pair_maps(td)
    fig_to_pos_patent, fig_to_neg_patents, fig_to_pos_figures, \
        fig_to_neg_figures = maps
    indices = np.asarray(indices)
    perm = rng.permutation(len(indices))
    shuffled = indices[perm]
    for start in range(0, len(shuffled), batch_size):
        rows = []
        for f in shuffled[start:start + batch_size]:
            f = int(f)
            if f not in fig_to_pos_patent or f not in fig_to_neg_patents:
                continue
            negs = fig_to_neg_patents[f]
            neg_sel = rng.choice(len(negs), size=num_neg,
                                 replace=len(negs) < num_neg)
            pos_figs = fig_to_pos_figures.get(f)
            neg_figs = fig_to_neg_figures.get(f)
            want_neg = neg_figs and (not pos_figs or rng.random() < 0.5)
            if want_neg:
                partner = int(neg_figs[int(rng.integers(len(neg_figs)))])
                plabel = 0.0
            elif pos_figs:
                partner = int(pos_figs[int(rng.integers(len(pos_figs)))])
                plabel = 1.0
            else:
                partner, plabel = f, 1.0
            rows.append((f, fig_to_pos_patent[f],
                         [negs[int(i)] for i in np.atleast_1d(neg_sel)],
                         partner, plabel))
        if not rows:
            continue
        b = len(rows)
        pad = batch_size - b
        yield HypBatch(
            figure_idx=np.asarray([r[0] for r in rows] + [0] * pad, np.int32),
            pos_patent=np.asarray([r[1] for r in rows] + [0] * pad, np.int32),
            neg_patents=np.asarray([r[2] for r in rows]
                                   + [[0] * num_neg] * pad, np.int32),
            pair_b_figure=np.asarray([r[3] for r in rows] + [0] * pad,
                                     np.int32),
            pair_label=np.asarray([r[4] for r in rows] + [0.0] * pad,
                                  np.float32),
            valid=np.asarray([1.0] * b + [0.0] * pad, np.float32))


def stack_epoch_batches(packed: PackedSupervision, slots: np.ndarray,
                        batch_size: int, num_neg: int,
                        rng: np.random.Generator):
    """One epoch of ``make_batches_packed`` as stacked [nb, ...] arrays in
    ``BATCH_FIELDS`` order, or None when the split gives no batch."""
    batches = list(make_batches_packed(packed, slots, batch_size, num_neg,
                                       rng))
    if not batches:
        return None
    return tuple(np.stack([getattr(b, f) for b in batches])
                 for f in BATCH_FIELDS)


def epoch_to_device(arrays, device) -> list[tuple[torch.Tensor, ...]]:
    """The stacked epoch arrays as per-step batches on ``device`` after one
    host → device copy: every field is packed as int32 columns of one
    array (the float fields by their bits) and split on the device."""
    idx = [a.reshape(a.shape[0], a.shape[1], -1) for a in arrays[:4]]
    flt = [a.reshape(a.shape[0], a.shape[1], 1).view(np.int32)
           for a in arrays[4:]]
    packed = torch.from_numpy(np.concatenate(idx + flt, axis=2)).to(device)
    widths = [a.shape[2] for a in idx + flt]
    cols = torch.split(packed, widths, dim=2)
    fields = [cols[0][..., 0].long(), cols[1][..., 0].long(), cols[2].long(),
              cols[3][..., 0].long(),
              cols[4][..., 0].contiguous().view(torch.float32),
              cols[5][..., 0].contiguous().view(torch.float32)]
    return [tuple(f[i] for f in fields) for i in range(packed.shape[0])]


def make_loss_fn(model: HyperbolicEmbeddingModel, cfg: HypTrainConfig,
                 num_real_labels: int | None = None):
    """``loss_fn(batch, x_figures, implication, exclusion, generator,
    deterministic=False) -> (total, metrics)`` over the model's own
    parameters, with dropout in training (``cfg.use_dropout`` and not
    ``deterministic``), masks drawn from ``generator``."""
    c = cfg.curvature

    def loss_fn(batch, x_figures, implication, exclusion, generator=None,
                deterministic=False):
        (figure_idx, pos_patent, neg_patents, pair_b_figure, pair_label,
         valid) = batch
        all_x = torch.cat([x_figures[figure_idx], x_figures[pair_b_figure]])
        model.train(cfg.use_dropout and not deterministic)
        encoded_all = model(all_x, generator)
        bsz = figure_idx.shape[0]
        encoded, partner_enc = encoded_all[:bsz], encoded_all[bsz:]
        label_emb = model.label_emb
        n_valid = torch.clamp_min(valid.sum(), 1.0)

        pos_d = poincare.dist(encoded, take_rows(label_emb, pos_patent), c)
        neg_d = poincare.dist(encoded[:, None, :],
                              take_rows(label_emb, neg_patents), c).mean(dim=1)
        per = torch.relu(pos_d - neg_d + cfg.margin) * valid
        retrieval_loss = per.sum() / n_valid

        inside, disjoint = hierarchical_margin_losses(label_emb, implication,
                                                      exclusion, c)
        hierarchical_loss = inside + disjoint
        label_reg, instance_reg = dist0_band_regularizers(
            label_emb, encoded, c, num_valid_labels=num_real_labels)
        reg_loss = label_reg + instance_reg

        logits = -poincare.dist(encoded, partner_enc, c) / cfg.temperature
        bce = -(pair_label * F.logsigmoid(logits)
                + (1 - pair_label) * F.logsigmoid(-logits)) * valid
        figure_pair_loss = bce.sum() / n_valid

        total = (cfg.retrieval_penalty * retrieval_loss
                 + cfg.constraint_penalty * hierarchical_loss
                 + cfg.reg_penalty * reg_loss
                 + cfg.figure_pair_weight * figure_pair_loss)
        return total, {"total_loss": total, "retrieval_loss": retrieval_loss,
                       "hierarchical_loss": hierarchical_loss,
                       "reg_loss": reg_loss,
                       "figure_pair_loss": figure_pair_loss}

    return loss_fn


def train_step(model, optimizer: RiemannianAdam, loss_fn, batch, x_figures,
               implication, exclusion, generator=None) -> torch.Tensor:
    """One step: the loss, its gradients, their global norm (before the
    update, as optax takes it), the update.  Returns the metrics stacked
    in ``METRICS`` order, on the device (no host sync)."""
    params = optimizer.params
    for p in params.values():
        p.grad = None
    total, metrics = loss_fn(batch, x_figures, implication, exclusion,
                             generator)
    total.backward()
    grads = {n: p.grad for n, p in params.items()}
    metrics["grad_norm"] = global_norm(grads)
    optimizer.step(grads)
    return torch.stack([metrics[k].detach() for k in METRICS])


def train_epoch(model, optimizer: RiemannianAdam, loss_fn, batches,
                x_figures, implication, exclusion,
                generator=None) -> torch.Tensor:
    """``train_step`` over the epoch's device batches; the metrics [nb,
    len(METRICS)] stay on the device."""
    acc = torch.empty(len(batches), len(METRICS), device=x_figures.device)
    for i, batch in enumerate(batches):
        acc[i] = train_step(model, optimizer, loss_fn, batch, x_figures,
                            implication, exclusion, generator)
    return acc


@torch.no_grad()
def eval_step(loss_fn, batch, x_figures, implication,
              exclusion) -> torch.Tensor:
    """The deterministic loss's metrics (no grad norm), stacked."""
    _, metrics = loss_fn(batch, x_figures, implication, exclusion,
                         deterministic=True)
    return torch.stack([metrics[k] for k in METRICS[:-1]])


def _rng_state_bytes(rng: np.random.Generator) -> np.ndarray:
    """The numpy Generator's state as uint8 JSON bytes (a checkpoint leaf,
    JAX's format)."""
    return np.frombuffer(
        json.dumps(rng.bit_generator.state).encode(), np.uint8).copy()


def best_checkpoint_name(cfg: HypTrainConfig) -> str:
    return f"best_retrieval_model_c{cfg.curvature}_e{cfg.embed_dim}"


def build_model(td: TrainingData, cfg: HypTrainConfig, device,
                seed: int | None = None) -> HyperbolicEmbeddingModel:
    """The HypTrainConfig model for ``td``, its initial weights drawn from
    a CPU generator seeded with ``seed`` (default ``cfg.seed``)."""
    model = HyperbolicEmbeddingModel(
        feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
        label_num=cfg.label_num or td.num_labels,
        hidden_dims=tuple(cfg.hidden_dims), c=cfg.curvature,
        generator=torch.Generator().manual_seed(
            cfg.seed if seed is None else seed))
    return model.to(device)


def _load(model, params: dict) -> None:
    model.load_state_dict(hyperbolic_params_from_jax(params))


def _snapshot(model) -> dict[str, torch.Tensor]:
    """A copy of the parameters (the optimizer updates them in place)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_hyperbolic_retrieval(td: TrainingData, cfg: HypTrainConfig,
                               logger: MetricsLogger | None = None,
                               ckpt: CheckpointManager | None = None,
                               resume: bool = False, device=None,
                               init_params: dict | None = None
                               ) -> tuple[dict, dict]:
    """Split, epochs, validation, best checkpoint, early stop, as the JAX
    trainer runs them.  ``resume`` continues from ``ckpt``'s ``latest``
    (params, optimizer state, epoch, the RNG streams, the histories, the
    best params from the best checkpoint).  ``init_params``: a JAX-layout
    param tree to start from instead of the seeded initialisation.
    ``device``: the card when not given (``select_device``: an error
    where there is none); pass "cpu" for the CPU.

    Returns (best params as a state dict of copies, history)."""
    from .evaluate import evaluate_retrieval_map

    logger = logger or MetricsLogger(print_every=50)
    device = select_device() if device is None else torch.device(device)
    rng = np.random.default_rng(cfg.seed)
    model = build_model(td, cfg, device)
    if init_params is not None:
        _load(model, init_params)
    optimizer = RiemannianAdam(dict(model.named_parameters()),
                               cfg.learning_rate, c=cfg.curvature)
    loss_fn = make_loss_fn(model, cfg)

    x_figures = torch.as_tensor(td.x_figures, dtype=torch.float32,
                                device=device)
    implication = torch.as_tensor(td.implication, dtype=torch.long,
                                  device=device).reshape(-1, 2)
    exclusion = torch.as_tensor(td.exclusion, dtype=torch.long,
                                device=device).reshape(-1, 2)

    # 0.8 / 0.1 / 0.1 split over the figures with supervision
    packed = PackedSupervision(td, figure_pair_maps(td))
    usable = packed.usable
    perm = rng.permutation(len(usable))
    n_train = int(len(usable) * cfg.train_ratio)
    n_val = int(len(usable) * cfg.val_ratio)
    train_idx = usable[perm[:n_train]]
    val_idx = usable[perm[n_train:n_train + n_val]]
    test_idx = usable[perm[n_train + n_val:]]

    fig_pos: dict[int, list[int]] = {}
    num_patents = 0
    if cfg.validate_with == "map":
        for f, p in td.y_pos.tolist():
            fig_pos.setdefault(int(f), []).append(int(p))
        num_patents = (td.label_offsets["medium_cpcs"]
                       - td.label_offsets["patents"])
    elif cfg.validate_with != "loss":
        raise ValueError(f"validate_with must be 'loss' or 'map', "
                         f"got {cfg.validate_with!r}")

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    best_val = float("inf")
    best_params = _snapshot(model)
    patience_left = cfg.patience
    history: dict[str, list] = {"train_loss": [], "val_loss": []}
    step = 0
    start_epoch = 1
    best_name = best_checkpoint_name(cfg)
    if resume and ckpt is not None and ckpt.exists("latest"):
        saved = ckpt.restore("latest")
        _load(model, saved["params"])
        optimizer.load_state_leaves(saved["opt_state"])
        step = int(saved["step"])
        start_epoch = int(saved["epoch"]) + 1
        best_val = float(saved.get("best_val", best_val))
        # the best params of the best checkpoint, else the restored ones:
        # a resumed run that never improves returns what an uninterrupted
        # run would
        if ckpt.exists(best_name):
            best_model = build_model(td, cfg, device)
            _load(best_model, ckpt.restore(best_name)["params"])
            best_params = _snapshot(best_model)
        else:
            best_params = _snapshot(model)
        patience_left = int(saved.get("patience_left", patience_left))
        if "rng_state" in saved:
            rng.bit_generator.state = json.loads(
                bytes(np.asarray(saved["rng_state"], np.uint8)).decode())
        if RNG_KEY in saved:
            gen.set_state(torch.from_numpy(
                np.asarray(saved[RNG_KEY], np.uint8).copy()))
        for hk in ("train_loss", "val_loss", "val_map"):
            if f"hist_{hk}" in saved:
                history[hk] = [float(v)
                               for v in np.asarray(saved[f"hist_{hk}"])]
        logger.log(step, {"resumed_from_epoch": start_epoch - 1},
                   force_print=True)
    for epoch in range(start_epoch, cfg.epochs + 1):
        arrays = stack_epoch_batches(packed, packed.slots_for(train_idx),
                                     cfg.batch_size, cfg.num_neg_samples,
                                     rng)
        if arrays is None:
            raise RuntimeError("no usable training batches")
        batches = epoch_to_device(arrays, device)
        nb = len(batches)
        acc = train_epoch(model, optimizer, loss_fn, batches, x_figures,
                          implication, exclusion, gen)
        step += nb
        epoch_metrics = dict(zip(METRICS, acc.sum(dim=0).tolist()))
        train_loss = epoch_metrics["total_loss"] / nb
        if not np.isfinite(train_loss):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch} "
                f"(metrics: { {k: v / nb for k, v in epoch_metrics.items()} }); "
                "reduce learning_rate or check input feature scale")

        val_arrays = stack_epoch_batches(packed, packed.slots_for(val_idx),
                                         cfg.batch_size,
                                         cfg.num_neg_samples, rng)
        if val_arrays is not None:
            vbatches = epoch_to_device(val_arrays, device)
            vacc = torch.stack([eval_step(loss_fn, b, x_figures, implication,
                                          exclusion) for b in vbatches])
            val_loss = float(vacc[:, 0].sum()) / len(vbatches)
        else:
            val_loss = train_loss

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        log_extra = {}
        if cfg.validate_with == "map":
            if len(val_idx) == 0:
                if epoch == start_epoch:
                    logger.log(step, {"warning": "validate_with=map with "
                                      "an empty validation split; falling "
                                      "back to loss-based selection"},
                               force_print=True)
            else:
                val_map = evaluate_retrieval_map(
                    model, td.x_figures, val_idx.tolist(), fig_pos,
                    num_patents)
                history.setdefault("val_map", []).append(val_map)
                val_loss = -val_map
                log_extra["val_map"] = val_map
        logger.log(step, {"epoch": epoch, "train_loss": train_loss,
                          "val_loss": val_loss, **log_extra},
                   force_print=True)

        early_stop = False
        if val_loss < best_val:
            best_val = val_loss
            best_params = _snapshot(model)
            patience_left = cfg.patience
            if ckpt is not None:
                ckpt.save(best_name,
                          {"params": hyperbolic_params_to_jax(best_params),
                           "step": step, "epoch": epoch},
                          metadata={"val_loss": best_val, "epoch": epoch})
        else:
            patience_left -= 1
            early_stop = patience_left <= 0
        if ckpt is not None:
            hist_payload = {
                f"hist_{hk}": np.asarray(history[hk], np.float64)
                for hk in ("train_loss", "val_loss", "val_map")
                if history.get(hk)}
            ckpt.save("latest", {
                "params": hyperbolic_params_to_jax(model.state_dict()),
                "opt_state": optimizer.state_tree(), "step": step,
                "epoch": epoch, "best_val": best_val,
                "patience_left": patience_left, **hist_payload,
                "rng_state": _rng_state_bytes(rng),
                RNG_KEY: gen.get_state().numpy()})
        if early_stop:
            logger.log(step, {"early_stop_epoch": epoch}, force_print=True)
            break

    history["test_indices"] = test_idx.tolist()
    return best_params, history
