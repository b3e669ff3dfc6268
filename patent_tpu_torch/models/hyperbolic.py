"""Hyperbolic (Poincaré-ball) models as ``nn.Module``s (port of
patent_tpu/models/hyperbolic.py: ``MobiusDense``, ``HyperbolicEncoder``,
``HyperbolicEmbeddingModel``, ``FigureOnlyHyperbolicModel``).

Parameter names and layouts are the Flax tree's, so the weight bridge
(``models/weights.py``) maps leaf to leaf: ``label_emb`` [L, D],
``encoder.{first_layer, middle_i, final_layer}.kernel`` [in, out] and
``.hyp_bias`` [out] (``.bias`` without a hyperbolic bias).  Dropout acts
in train mode only, as ``deterministic=False`` does in Flax, and draws its
masks (the input, the encoder's and the hyperbolic layers' weight dropout)
from the ``generator`` passed to ``forward``, so a seeded generator gives
the same masks run to run and across a resumed run.  Initialisers
draw the JAX distributions from an explicit ``torch.Generator``: kernels
Xavier-uniform, the label table expmap0(0.1·N(0, 1)), hyperbolic biases
expmap0(1e-3·N(0, 1)).

``MobiusDense`` with Euclidean input and a hyperbolic bias, the encoder's
first layer, runs ``ops/pallas_kernels.py::mobius_dense_pallas`` (the
CUDA kernel on the card; ``kernels = False`` runs its plain version
there instead) when autograd is not recording, and the plain version,
which is differentiable, when it is; every other layer is plain PyTorch,
as JAX computes it outside any kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from ..ops import poincare
from ..ops.pallas_kernels import mobius_dense_pallas, mobius_dense_pallas_plain

DROPOUT_RATE = 0.1


def _normal(shape, std: float, generator) -> torch.Tensor:
    return std * torch.randn(*shape, generator=generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each element with probability 1 − rate
    (a mask drawn from ``generator``, which lives on ``x``'s device) and
    scale the kept ones by 1 / (1 − rate); the identity outside training."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MobiusDense(nn.Module):
    """Hyperbolic dense layer: ``hyperbolic_input=True`` takes points on
    the ball (weight dropout in train mode, then mobius_matvec);
    ``hyperbolic_input=False`` takes Euclidean rows (expmap0(x @ W)).
    Then the optional bias (Möbius-added), the optional Möbius
    nonlinearity and the projection into the ball."""

    def __init__(self, in_features: int, features: int, c: float = 1.0,
                 hyperbolic_input: bool = True, hyperbolic_bias: bool = True,
                 use_bias: bool = True,
                 nonlin: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 weight_dropout_rate: float = DROPOUT_RATE,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c = c
        self.hyperbolic_input = hyperbolic_input
        self.hyperbolic_bias = hyperbolic_bias
        self.use_bias = use_bias
        self.nonlin = nonlin
        self.weight_dropout_rate = weight_dropout_rate
        self.kernels = True
        limit = math.sqrt(6.0 / (in_features + features))
        self.kernel = nn.Parameter(
            (torch.rand(in_features, features, generator=generator) * 2.0
             - 1.0) * limit)
        if use_bias and hyperbolic_bias:
            self.hyp_bias = nn.Parameter(poincare.expmap0(
                _normal((features,), 1e-3, generator), c))
        elif use_bias:
            self.bias = nn.Parameter(torch.zeros(features))

    def _fused(self) -> bool:
        """Whether this layer is row 18's function: Euclidean input, a
        hyperbolic bias, no nonlinearity."""
        return (not self.hyperbolic_input and self.use_bias
                and self.hyperbolic_bias and self.nonlin is None)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        c = self.c
        if self._fused():
            # row 18 has no backward: while autograd records, the plain
            # chain (differentiable, as JAX's model is) takes the call
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, self.kernel, self.hyp_bias))
            fn = mobius_dense_pallas if self.kernels and not grad else \
                mobius_dense_pallas_plain
            return fn(x, self.kernel, self.hyp_bias, c)
        if self.hyperbolic_input:
            w = dropout(self.kernel, self.weight_dropout_rate, self.training,
                        generator)
            out = poincare.mobius_matvec(w.T, x, c)
        else:
            out = poincare.expmap0(x @ self.kernel, c)
        if self.use_bias:
            bias = (self.hyp_bias if self.hyperbolic_bias
                    else poincare.expmap0(self.bias, c))
            out = poincare.mobius_add(out, bias, c)
        if self.nonlin is not None:
            out = poincare.mobius_fn_apply(self.nonlin, out, c)
        return poincare.project(out, c)


class HyperbolicEncoder(nn.Module):
    """Euclidean features → Poincaré ball: dropout, a Euclidean-input
    first layer, Möbius tanh, then for each further hidden width dropout,
    a hyperbolic layer and Möbius tanh, and a final hyperbolic layer to
    ``output_dim`` after dropout; projected."""

    def __init__(self, feature_dim: int, hidden_dims: Sequence[int] = (256,),
                 output_dim: int = 128, c: float = 1.0,
                 dropout_rate: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c = c
        self.dropout_rate = dropout_rate
        self.first_layer = MobiusDense(feature_dim, hidden_dims[0], c=c,
                                       hyperbolic_input=False,
                                       generator=generator)
        self.num_middle = len(hidden_dims) - 1
        for i, (a, b) in enumerate(zip(hidden_dims[:-1], hidden_dims[1:])):
            setattr(self, f"middle_{i}",
                    MobiusDense(a, b, c=c, generator=generator))
        self.final_layer = MobiusDense(hidden_dims[-1], output_dim, c=c,
                                       generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        c, rate, train = self.c, self.dropout_rate, self.training
        x = self.first_layer(dropout(x, rate, train, generator))
        x = poincare.mobius_fn_apply(torch.tanh, x, c)
        for i in range(self.num_middle):
            x = getattr(self, f"middle_{i}")(
                dropout(x, rate, train, generator), generator)
            x = poincare.mobius_fn_apply(torch.tanh, x, c)
        x = self.final_layer(dropout(x, rate, train, generator), generator)
        return poincare.project(x, c)


class HyperbolicEmbeddingModel(nn.Module):
    """Figure encoder plus a learnable hyperbolic label table (patents,
    then the CPC levels).  ``forward`` encodes figures: input dropout, then
    the encoder (whose own first dropout follows, as in JAX)."""

    def __init__(self, feature_dim: int = 512, embed_dim: int = 128,
                 label_num: int = 1024, hidden_dims: Sequence[int] = (256,),
                 c: float = 1.0, dropout_rate: float = DROPOUT_RATE,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c = c
        self.label_emb = nn.Parameter(poincare.expmap0(
            _normal((label_num, embed_dim), 0.1, generator), c))
        self.encoder = HyperbolicEncoder(feature_dim, hidden_dims, embed_dim,
                                         c=c, dropout_rate=0.3,
                                         generator=generator)
        self.dropout_rate = dropout_rate

    def forward(self, features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.encode_figures(features, generator)

    def encode_figures(self, features: torch.Tensor,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
        x = dropout(features, self.dropout_rate, self.training, generator)
        return self.encoder(x, generator)

    def labels(self) -> torch.Tensor:
        return self.label_emb


class FigureOnlyHyperbolicModel(nn.Module):
    """Encoder-only variant: dropout, then ``HyperbolicEncoder``."""

    def __init__(self, feature_dim: int = 512, embed_dim: int = 128,
                 hidden_dims: Sequence[int] = (256,), c: float = 1.0,
                 dropout_rate: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c = c
        self.dropout_rate = dropout_rate
        self.encoder = HyperbolicEncoder(feature_dim, hidden_dims, embed_dim,
                                         c=c, dropout_rate=dropout_rate,
                                         generator=generator)

    def forward(self, features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(features, self.dropout_rate, self.training, generator)
        return self.encoder(x, generator)
