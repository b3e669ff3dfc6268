"""Graph convolutional models of the VGAE family (port of
patent_tpu/models/gcn.py; reference src/models.py:187-245, 840-903).

* ``SparseAdj``: the normalized adjacency in sorted COO form with its row
  lengths and the column-sorted order of its edges; ``spmm`` (A @ y) and
  ``adj_rowsum`` sum each row's edges in a fixed order
  (``torch.segment_reduce`` over the sorted rows, one pass a segment), and
  so does ``spmm``'s backward (Aᵀ @ g over the edges in column order), so
  two runs on the card give the same bits; ``index_add_`` and the backward
  of a gather accumulate with atomics and do not.
* ``normalize_adjacency`` (dense tensor), ``normalize_adjacency_host``
  (numpy, for graphs too big to normalize on the device) and
  ``normalize_adjacency_sparse`` (scipy): self-loops, D^-1/2 A D^-1/2,
  then (M + Mᵀ) / 2.
* ``GCNLayer``, ``ResidualGCNEncoder`` (BatchNorm with Flax's semantics:
  ``BatchNorm``), ``VGAE`` and ``EnhancedVGAE`` (the 5-way pair
  classifier, dropout 0.3).  Parameter and statistic names are the Flax
  tree's (``encoder.gcn_in.kernel``, ``encoder.bn_in.scale`` / ``.mean``
  / ``.var``, ``linear.kernel`` ...), kernels [in, out], so the weight
  bridge maps leaf to leaf.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from .hyperbolic import dropout


@dataclasses.dataclass
class SparseAdj:
    """Sorted-COO adjacency: ``rows`` ascending, ``lengths`` [n] the edges
    of each row, ``t_order`` the edges sorted stably by column and
    ``t_lengths`` [n] the edges of each column (the transpose's rows)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int
    lengths: torch.Tensor
    t_order: torch.Tensor
    t_lengths: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    def to(self, device) -> "SparseAdj":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "n"})


def sparse_adj(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int) -> SparseAdj:
    """A SparseAdj from COO arrays whose rows are sorted ascending."""
    rows = torch.as_tensor(np.asarray(rows, np.int64))
    cols = torch.as_tensor(np.asarray(cols, np.int64))
    return SparseAdj(rows=rows, cols=cols,
                     vals=torch.as_tensor(np.asarray(vals)), n=n,
                     lengths=torch.bincount(rows, minlength=n),
                     t_order=torch.sort(cols, stable=True).indices,
                     t_lengths=torch.bincount(cols, minlength=n))


def _segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                unsafe=True)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, adj: SparseAdj) -> torch.Tensor:
        ctx.adj = adj
        return _segment_sum(adj.vals[:, None] * y[adj.cols], adj.lengths)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        adj = ctx.adj
        t = adj.t_order
        return _segment_sum(adj.vals[t, None] * g[adj.rows[t]],
                            adj.t_lengths), None


def spmm(adj: SparseAdj, y: torch.Tensor) -> torch.Tensor:
    """A @ y [n, D] for a SparseAdj, each row's edges summed in order."""
    return _Spmm.apply(y, adj)


def adj_rowsum(a_tilde) -> torch.Tensor:
    """Row sums [n] (f32) of either adjacency representation."""
    if isinstance(a_tilde, SparseAdj):
        return _segment_sum(a_tilde.vals.float(), a_tilde.lengths)
    return a_tilde.float().sum(dim=1)


def normalize_adjacency(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Self-loops + symmetric D^-1/2 A D^-1/2 + re-symmetrization
    (reference src/auxiliary.py:12-34)."""
    a = a + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    d_inv_sqrt = 1.0 / torch.sqrt(1e-10 + a.sum(dim=1))
    normalized = a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    out = (normalized + normalized.T) / 2.0
    return out.to(out_dtype) if out_dtype is not None else out


def normalize_adjacency_host(a: np.ndarray,
                             out_dtype: torch.dtype = torch.bfloat16,
                             blk: int = 4096) -> torch.Tensor:
    """``normalize_adjacency`` on the host in numpy (in place where it
    can), for graphs whose f32 intermediates would not fit the device:
    the same re-symmetrization, blocked so the transposed reads stay in
    cache; returns a CPU tensor of ``out_dtype``."""
    a = np.array(a, np.float32, copy=True)
    n = a.shape[0]
    np.fill_diagonal(a, a.diagonal() + 1.0)
    d = 1.0 / np.sqrt(1e-10 + a.sum(axis=1))
    a *= d[:, None]
    a *= d[None, :]
    for i0 in range(0, n, blk):
        i1 = min(i0 + blk, n)
        diag = a[i0:i1, i0:i1]
        a[i0:i1, i0:i1] = 0.5 * (diag + diag.T)
        for j0 in range(i1, n, blk):
            j1 = min(j0 + blk, n)
            avg = 0.5 * (a[i0:i1, j0:j1] + a[j0:j1, i0:i1].T)
            a[i0:i1, j0:j1] = avg
            a[j0:j1, i0:i1] = avg.T
    return torch.from_numpy(a).to(out_dtype)


def normalize_adjacency_sparse(a, out_dtype=None) -> SparseAdj:
    """The sparse (scipy) twin of ``normalize_adjacency``, the same math
    on any scipy.sparse matrix; returns a sorted-COO ``SparseAdj`` on the
    CPU."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a, dtype="float32", copy=True)
    n = a.shape[0]
    a = a + sp.identity(n, dtype="float32", format="csr")
    d = np.asarray(a.sum(axis=1)).ravel()
    dmat = sp.diags(1.0 / np.sqrt(1e-10 + d))
    m = dmat @ a @ dmat
    m = (m + m.T) * 0.5
    coo = m.tocsr().tocoo()                 # CSR round trip sorts by row
    vals = coo.data.astype(out_dtype if out_dtype is not None else "float32")
    return sparse_adj(coo.row, coo.col, vals, n)


def _xavier(fan_in: int, fan_out: int, generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(fan_in, fan_out, generator=generator) * 2.0
            - 1.0) * limit


class GCNLayer(nn.Module):
    """A_tilde @ (X @ W), W [in, out] Xavier-uniform.  A bf16 dense
    A_tilde multiplies X·W rounded to bf16, accumulated and returned in
    f32 (JAX's ``preferred_element_type``); a ``SparseAdj`` runs
    ``spmm``."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_xavier(in_features, features, generator))

    def forward(self, x: torch.Tensor, a_tilde) -> torch.Tensor:
        xw = x @ self.kernel
        if isinstance(a_tilde, SparseAdj):
            return spmm(a_tilde, xw)
        if a_tilde.dtype == torch.float32:
            return a_tilde @ xw
        return a_tilde.float() @ xw.to(a_tilde.dtype).float()


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over axis 0: in training, the batch's mean
    and its biased variance E[x²] − E[x]² (clipped at 0) normalize the
    batch, and the running statistics move by ``momentum`` = 0.99 toward
    them (torch's ``BatchNorm1d`` would take momentum 0.01 and keep the
    unbiased variance); in evaluation the running statistics normalize.
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias``."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class ResidualGCNEncoder(nn.Module):
    """Input GCN + BN + ReLU, ``num_layers`` − 3 residual GCN + BN + ReLU
    blocks, a linear GCN out; each GCN's output divided by A's row sums
    (the reference row-normalizes A on the fly, models.py:233)."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int,
                 num_layers: int = 3, generator=None):
        super().__init__()
        self.num_hidden = max(num_layers - 3, 0)
        self.gcn_in = GCNLayer(input_dim, hidden_dim, generator)
        self.bn_in = BatchNorm(hidden_dim)
        for i in range(self.num_hidden):
            setattr(self, f"gcn_h{i}", GCNLayer(hidden_dim, hidden_dim,
                                                generator))
            setattr(self, f"bn_h{i}", BatchNorm(hidden_dim))
        self.gcn_out = GCNLayer(hidden_dim, latent_dim, generator)

    def forward(self, x: torch.Tensor, a_tilde) -> torch.Tensor:
        inv_row = 1.0 / (adj_rowsum(a_tilde)[:, None] + 1e-8)
        h = torch.relu(self.bn_in(self.gcn_in(x, a_tilde) * inv_row))
        for i in range(self.num_hidden):
            hn = getattr(self, f"gcn_h{i}")(h, a_tilde) * inv_row
            h = h + torch.relu(getattr(self, f"bn_h{i}")(hn))
        return self.gcn_out(h, a_tilde) * inv_row


def _l2_rows(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp_min(torch.linalg.norm(z, dim=1, keepdim=True),
                               1e-12)


class VGAE(nn.Module):
    """GCN encoder, L2-normalized latents, sigmoid(Z Zᵀ) reconstruction
    (reference src/models.py:881-903).  ``encode`` gives the latents alone
    (the sampled-edge trainer scores pairs from them)."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int,
                 num_layers: int = 3, generator=None):
        super().__init__()
        self.encoder = ResidualGCNEncoder(input_dim, hidden_dim, latent_dim,
                                          num_layers, generator)

    def encode(self, x: torch.Tensor, a_tilde) -> torch.Tensor:
        return _l2_rows(self.encoder(x, a_tilde))

    def forward(self, x: torch.Tensor, a_tilde):
        z = self.encode(x, a_tilde)
        return z, torch.sigmoid(z @ z.T)


class Dense(nn.Module):
    """Flax ``nn.Dense``: kernel [in, out] (LeCun normal), bias zeros."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        std = 1.0 / math.sqrt(in_features)
        self.kernel = nn.Parameter(torch.clamp(torch.randn(
            in_features, features, generator=generator), -2.0, 2.0)
            * (std / 0.87962566))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class EnhancedVGAE(nn.Module):
    """Residual GCN encoder with L2-normalized latents, and an MLP pair
    classifier over concatenated pairs of them → 5 CPC-connection levels
    (reference src/models.py:840-879)."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int,
                 num_layers: int = 3, num_classes: int = 5,
                 dropout_rate: float = 0.3, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.encoder = ResidualGCNEncoder(input_dim, hidden_dim, latent_dim,
                                          num_layers, generator)
        self.linear = Dense(2 * latent_dim, latent_dim, generator)
        self.linear2 = Dense(latent_dim, latent_dim // 2, generator)
        self.classifier = Dense(latent_dim // 2, num_classes, generator)

    def forward(self, x: torch.Tensor, a_tilde) -> torch.Tensor:
        return _l2_rows(self.encoder(x, a_tilde))

    def classify_pair(self, z1: torch.Tensor, z2: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        rate, train = self.dropout_rate, self.training
        h = torch.relu(self.linear(torch.cat([z1, z2], dim=1)))
        h = dropout(h, rate, train, generator)
        h = torch.relu(self.linear2(h))
        h = dropout(h, rate, train, generator)
        return self.classifier(h)

    def encode_and_classify(self, x, a_tilde, pair_idx,
                            generator: torch.Generator | None = None
                            ) -> torch.Tensor:
        """Full-graph encode, then classify the [P, 2] node-index pairs
        (the rows gathered with a fixed-order backward)."""
        from ..ops.rows import take_rows

        z = self(x, a_tilde)
        return self.classify_pair(take_rows(z, pair_idx[:, 0]),
                                  take_rows(z, pair_idx[:, 1]), generator)
