"""Device meshes and the row-block rules on ``torch.distributed`` (port of
patent_tpu/parallel/mesh.py).

A mesh is a ``DeviceMesh`` over the ranks of the world, with at most two
named axes:

* ``data``: batch-parallel encoding and training, and the gallery axis of
  the sharded index (each rank holds a block of the gallery's rows and the
  candidates merge with one all-gather, retrieval/index.py);
* ``model``: the row axis of the tables that grow with the corpus (the
  hyperbolic label table, the fine-tune's graph table).

JAX states where an array lives with a ``NamedSharding`` and lets XLA
insert the collectives.  Here each rank holds its own block, named by a
``RowBlocks`` rule, and the code that uses a block calls the collectives
itself (the helpers below).  ``encode_sharded`` is the data-parallel
serving encoder: each ``data`` rank encodes its rows of the global batch,
padded so that its tower takes the function the global batch would take
(see ``local_batch``), and an all-gather returns the global features on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape=None, axis_names=("data", "model"),
              device: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the initialized world.  By default all
    ranks sit on ``data`` and ``model`` has size 1."""
    if shape is None:
        shape = (dist.get_world_size(), 1)
    shape = tuple(int(s) for s in shape)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """The ranks along ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """The leading axis cut into blocks of ceil(n / size) rows along
    ``axis``, block i on the rank at coordinate i (the last blocks may be
    short or empty); ``axis=None``: every rank holds every row."""

    axis: str | None

    def bounds(self, mesh: DeviceMesh | None, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's rows of an n-row axis."""
        if self.axis is None:
            return 0, n
        per = -(-n // axis_size(mesh, self.axis))
        start = min(axis_rank(mesh, self.axis) * per, n)
        return start, min(start + per, n)

    def local(self, mesh: DeviceMesh | None, x):
        start, stop = self.bounds(mesh, x.shape[0])
        return x[start:stop]


def data_parallel_sharding(mesh: DeviceMesh) -> dict[str, RowBlocks]:
    """The encode path's rules: batch rows over ``data``, parameters on
    every rank, the gallery's rows over ``data``."""
    return {"batch": RowBlocks("data"), "params": RowBlocks(None),
            "gallery": RowBlocks("data")}


def label_table_sharding(mesh: DeviceMesh) -> RowBlocks:
    """The hyperbolic label table's rows over ``model`` (the one parameter
    that grows with the corpus)."""
    return RowBlocks("model")


def shard_batch(mesh: DeviceMesh, batch, axis: str = "data"):
    """This rank's rows of a global batch's leading axis, which the axis
    must divide (as a ``device_put`` over ``P(axis)`` requires)."""
    size = axis_size(mesh, axis)
    if batch.shape[0] % size:
        raise ValueError(f"batch of {batch.shape[0]} rows does not divide "
                         f"the {axis!r} axis ({size})")
    return RowBlocks(axis).local(mesh, batch)


# ------------------------------------------------------------ collectives
# The list form of all_gather: NCCL and gloo take it, for CPU and CUDA
# tensors, in every supported torch.

def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` stacked along dim 0, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.rows = t.shape[0]
        ctx.rank = dist.get_rank(group)
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad):
        r = ctx.rows
        return grad[ctx.rank * r:(ctx.rank + 1) * r], None


def gather_rows_grad(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_rows`` under autograd, for a loss that every rank of
    ``group`` computes alike from the gathered rows: the backward keeps
    this rank's slice of the (equal) cotangent, with no collective, so the
    gradient of what produced ``t`` is this rank's share of the whole."""
    return _GatherRows.apply(t, group)


class _SumSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` under autograd, for a loss that
    every rank computes alike: the cotangent of the sum is the same on
    every rank, so each rank's term takes it as it is (no collective)."""
    return _SumSame.apply(t, group)


def take_owned_rows(block: torch.Tensor, idx: torch.Tensor, start: int,
                    group) -> torch.Tensor:
    """Rows ``idx`` (global, of any shape) of a table held in row blocks
    over ``group``: each rank gathers the rows of its block [start, start +
    len(block)) and zeros elsewhere, and a sum over ``group`` completes
    them (one term of each sum is nonzero, so the rows are exact).  Under
    autograd the cotangent reaches only the rows this rank owns (the
    fixed-order gather of ops/rows.py), for a loss every rank computes
    alike."""
    from ..ops.rows import take_rows

    local = idx.long() - start
    owned = (local >= 0) & (local < block.shape[0])
    rows = take_rows(block, torch.where(owned, local, 0))
    rows = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    return all_reduce_grad(rows, group)


# ------------------------------------------------------------- encoding

def local_batch(global_batch: int, ranks: int, multiple: int) -> int:
    """Rows each rank encodes (its block of ceil(B / ranks) rows, then zero
    rows) so that its tower takes the function of the global batch B: a
    multiple of ``multiple`` where ``multiple`` divides B, and a count it
    does not divide where it does not divide B.  A global batch of 8 over
    4 ranks is 2 rows a rank; the int8 tower would run row 8 on 2 rows
    where JAX runs rows 5 + 7 on 8, so each rank encodes 4."""
    per = -(-global_batch // ranks)
    if multiple == 1:
        return per
    if global_batch % multiple == 0:
        return -(-per // multiple) * multiple
    return per if per % multiple else per + 1


def encode_sharded(mesh: DeviceMesh, encode_fn: Callable,
                   batch_axis: str = "data"):
    """Data-parallel encoder over ``mesh[batch_axis]``: ``enc(batch)``
    takes the global batch [B, ...] (numpy or a tensor, the same on every
    rank), encodes this rank's block of rows padded to ``local_batch``
    rows with zeros (a zero row changes no other row: the towers encode
    each image alone), and returns the global features [B, D] on every
    rank.  ``encode_fn`` states the batch multiple at which it changes
    function as ``encode_fn.batch_multiple`` (the towers of
    models/vit.py and models/vit_int8.py do; 1 for a function that takes
    one function at every batch); without it the local batch could pick
    another function than the global batch, so it is refused."""
    multiple = getattr(encode_fn, "batch_multiple", None)
    if multiple is None:
        raise TypeError(
            f"encode_sharded: {type(encode_fn).__name__} states no "
            "batch_multiple (the batch multiple at which it changes "
            "function; 1 if none)")
    group = axis_group(mesh, batch_axis)
    ranks = axis_size(mesh, batch_axis)
    device = mesh_device(mesh)

    def enc(batch) -> torch.Tensor:
        x = torch.as_tensor(batch)
        b = x.shape[0]
        rows = local_batch(b, ranks, multiple)
        mine = RowBlocks(batch_axis).local(mesh, x).to(device)
        pad = torch.zeros((rows - mine.shape[0],) + tuple(x.shape[1:]),
                          dtype=mine.dtype, device=device)
        with torch.inference_mode():
            feats = encode_fn(torch.cat([mine, pad]))
        per = -(-b // ranks)
        return all_gather_rows(feats[:per].contiguous(), group)[:b]

    return enc
