"""Sharded training of the hyperbolic retrieval model over a (data, model)
mesh (port of patent_tpu/parallel/sharded_train.py).

* batch index arrays split over ``data``: each rank encodes its rows of
  the batch (figures and partners) with the replicated encoder;
* the figure feature matrix padded and row-sharded over ``data``; a
  step's feature rows come from their owners (a masked local gather and a
  sum over ``data``);
* the hyperbolic label table, the one parameter that grows with the
  corpus, zero-padded (``pad_label_table``) and row-sharded over
  ``model`` (``shard_hyp_state``), with its Riemannian Adam moments; label
  rows come from their owners the same way, over ``model``;
* the pair lists replicated.

The loss is the single-device one, computed alike on every rank: the
encodings are all-gathered over ``data`` (the backward keeps this rank's
slice), so the gradients of the encoder, used before the gather, are this
rank's share and are summed over ``data``, while the table's rows, used
after it, get their whole gradient on their owner and are not summed.
The terms that do not depend on the batch (the hierarchy margins over the
pairs, the table's dist0 band, the padded rows masked) are computed once,
on the whole table.  With dropout on, every rank draws the global batch's
masks from the one seeded generator and keeps its rows
(``models.hyperbolic.RowSlice``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..losses.hierarchy import hierarchical_margin_losses, label_band
from ..models.hyperbolic import HyperbolicEmbeddingModel, RowSlice
from ..train.optim import global_norm
from ..train.train_hyp import METRICS, loss_from_encodings
from ..utils.config import HypTrainConfig
from .mesh import (RowBlocks, all_gather_rows, all_reduce_grad, axis_group,
                   axis_rank, axis_size, gather_rows_grad, make_mesh,
                   mesh_device, take_owned_rows)


def make_hyp_mesh(n_devices: int | None = None, model_dim: int = 1,
                  device: str = "cuda"):
    """A (data, model) mesh of ``n_devices`` ranks (the world by default;
    a mesh covers the whole world) with ``model_dim`` ranks on
    ``model``."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % model_dim:
        raise ValueError(f"{n} devices not divisible by model_dim={model_dim}")
    if n != dist.get_world_size():
        raise ValueError(f"a mesh covers the world's {dist.get_world_size()} "
                         f"ranks, not {n}")
    return make_mesh((n // model_dim, model_dim), device=device)


def _optimizers(optimizer) -> list:
    """The port's optimizers inside ``optimizer`` (a ``GroupOptimizer``'s
    groups, or itself)."""
    groups = getattr(optimizer, "groups", None)
    return list(groups.values()) if groups is not None else [optimizer]


def _moments(optimizer, param: torch.nn.Parameter) -> list[tuple]:
    """(dict, key) of each moment tensor ``optimizer`` keeps for
    ``param``: the port's Adam family (``mu`` / ``nu`` by name) or a
    ``torch.optim`` optimizer's state (after its first step)."""
    found = []
    if isinstance(optimizer, torch.optim.Optimizer):
        state = optimizer.state.get(param, {})
        found += [(state, k) for k in ("exp_avg", "exp_avg_sq") if k in state]
        return found
    for opt in _optimizers(optimizer):
        for name, p in opt.params.items():
            if p is param:
                found += [(opt.mu, name), (opt.nu, name)]
    return found


def _table(module: torch.nn.Module, marker: str) -> torch.nn.Parameter:
    for name, p in module.named_parameters():
        if marker in name and p.ndim >= 1:
            return p
    raise ValueError(f"no {marker} leaf found in params")


def pad_table_rows(module: torch.nn.Module, optimizer, marker: str,
                   model_size: int) -> tuple[int, int]:
    """Zero-pad the table parameter named ``marker`` (and its optimizer
    moments) along axis 0 to the next multiple of ``model_size``, in
    place.  Returns (real rows, padded rows)."""
    p = _table(module, marker)
    real = p.shape[0]
    padded = -(-real // model_size) * model_size

    def pad(t):
        return torch.cat([t, t.new_zeros((padded - real,) + t.shape[1:])])

    if padded != real:
        for store, key in _moments(optimizer, p):
            store[key] = pad(store[key])
        p.data = pad(p.data)
    return real, padded


def shard_table_rows(mesh, module: torch.nn.Module, optimizer, marker: str,
                     hint: str) -> None:
    """Keep this ``model`` rank's row block of the table named ``marker``
    and of its moments; the table must divide the axis."""
    size = axis_size(mesh, "model")
    p = _table(module, marker)
    if p.shape[0] % size:
        raise ValueError(f"{marker} rows ({p.shape[0]}) must divide the "
                         f"model axis ({size}); use {hint} first")
    rule = RowBlocks("model")
    for store, key in _moments(optimizer, p):
        store[key] = rule.local(mesh, store[key]).clone()
    p.data = rule.local(mesh, p.data).clone()


def pad_label_table(model: HyperbolicEmbeddingModel, optimizer,
                    model_size: int):
    """Zero-pad ``label_emb`` and its Riemannian Adam moments to a multiple
    of ``model_size`` rows, so the table can be row-sharded (never
    replicated).  Padded rows are inert: no batch gathers them and the
    dist0 band masks them (``num_real_labels``), so they stay at the
    origin.  Returns (model, optimizer, real rows, padded rows)."""
    real, padded = pad_table_rows(model, optimizer, "label_emb", model_size)
    return model, optimizer, real, padded


def shard_hyp_state(mesh, model: HyperbolicEmbeddingModel, optimizer):
    """Keep this ``model`` rank's row block of ``label_emb`` and of its
    moments; everything else stays on every rank.  The table must divide
    the axis: ``pad_label_table`` first."""
    shard_table_rows(mesh, model, optimizer, "label_emb", "pad_label_table")
    return model, optimizer


def table_band_mean(block: torch.Tensor, start: int, total_rows: int,
                    num_real: int | None, c: float, group) -> torch.Tensor:
    """``label_band_mean`` of a row-sharded table: this block's rows below
    ``num_real`` summed, the sum completed over ``group``, divided once."""
    per = label_band(block, c)
    real = total_rows if num_real is None else num_real
    keep = (torch.arange(block.shape[0], device=block.device) + start
            < real)[:, None].to(per.dtype)
    return all_reduce_grad((per * keep).sum(), group) / real


def _sharded_global_norm(grads: dict, table: str, group) -> torch.Tensor:
    """``global_norm`` of a gradient set whose ``table`` leaf is a row
    block over ``group``."""
    sq = global_norm({n: g for n, g in grads.items()
                      if n != table}).square()
    tab = grads[table].square().sum()
    dist.all_reduce(tab, group=group)
    return torch.sqrt(sq + tab)


def make_sharded_train_step(mesh, model: HyperbolicEmbeddingModel,
                            optimizer, cfg: HypTrainConfig,
                            num_real_labels: int | None = None):
    """The train_hyp step over the mesh: (step, place_batch,
    place_static).

    ``place_batch(batch_arrays)``: this rank's rows of the six batch
    arrays (``train_hyp.BATCH_FIELDS`` order, the global batch, which the
    ``data`` axis must divide) on its device.  ``place_static(x_figures,
    implication, exclusion)``: this rank's block of the feature rows
    (padded to the axis) and the pair lists.  ``step(batch, x_block,
    implication, exclusion, generator=None)`` takes one Riemannian Adam
    step and returns the metrics stacked in ``train_hyp.METRICS`` order
    (the loss the single-device step computes on the global batch).
    ``num_real_labels``: the table's rows before ``pad_label_table``."""
    device = mesh_device(mesh)
    data_g, model_g = axis_group(mesh, "data"), axis_group(mesh, "model")
    n_data, d_rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    c = cfg.curvature
    table_name = next(n for n, p in optimizer.params.items()
                      if p is model.label_emb)

    def place_batch(batch_arrays):
        b = batch_arrays[0].shape[0]
        if b % n_data:
            raise ValueError(f"batch of {b} rows does not divide the data "
                             f"axis ({n_data})")
        out = []
        for i, a in enumerate(batch_arrays):
            t = torch.as_tensor(RowBlocks("data").local(mesh, a))
            out.append(t.to(device, torch.float32 if i >= 4 else torch.long))
        return tuple(out)

    def place_static(x_figures, implication, exclusion):
        x = torch.as_tensor(x_figures, dtype=torch.float32)
        target = -(-x.shape[0] // n_data) * n_data
        x = torch.cat([x, x.new_zeros(target - x.shape[0], x.shape[1])])
        return (RowBlocks("data").local(mesh, x).to(device),
                torch.as_tensor(implication).long().to(device),
                torch.as_tensor(exclusion).long().to(device))

    def step(batch, x_block, implication, exclusion, generator=None):
        params = optimizer.params
        for p in params.values():
            p.grad = None
        glob = tuple(all_gather_rows(t, data_g) for t in batch)
        big_b, b = glob[0].shape[0], batch[0].shape[0]
        # the batch's feature rows from their owners, then this rank's
        with torch.no_grad():
            want = torch.cat([glob[0], glob[3]])
            x_all = take_owned_rows(x_block, want, d_rank * x_block.shape[0],
                                    data_g)
        mine = torch.cat([torch.arange(d_rank * b, (d_rank + 1) * b),
                          torch.arange(big_b + d_rank * b,
                                       big_b + (d_rank + 1) * b)]).to(device)
        model.train(cfg.use_dropout)
        gen = RowSlice(generator, mine, 2 * big_b) \
            if generator is not None else None
        enc = gather_rows_grad(model(x_all[mine], gen), data_g)
        enc = enc.view(n_data, 2, b, -1)
        encoded = enc[:, 0].reshape(big_b, -1)
        partner = enc[:, 1].reshape(big_b, -1)
        block = model.label_emb
        start = axis_rank(mesh, "model") * block.shape[0]
        rows = block.shape[0] * axis_size(mesh, "model")

        def take(table, idx):
            return take_owned_rows(table, idx, start, model_g)

        total, metrics = loss_from_encodings(
            cfg, encoded, partner, glob, lambda idx: take(block, idx),
            lambda: hierarchical_margin_losses(block, implication, exclusion,
                                               c, take=take),
            lambda: table_band_mean(block, start, rows, num_real_labels, c,
                                    model_g))
        total.backward()
        grads = {}
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if n != table_name:
                dist.all_reduce(g, group=data_g)
            grads[n] = g
        metrics["grad_norm"] = _sharded_global_norm(grads, table_name,
                                                    model_g)
        optimizer.step(grads)
        return torch.stack([metrics[k].detach() for k in METRICS])

    return step, place_batch, place_static
