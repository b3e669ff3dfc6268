"""The two hyperbolic kernels (port of patent_tpu/ops/pallas_kernels.py;
the file keeps the JAX module's name so that its counterpart is easy to
find).

* ``pairwise_dist_pallas``: all-pairs Poincaré distance [n, m], one f32
  Gram product and the arcosh tail per tile.  The label-retrieval
  evaluation (``train/evaluate.py``) calls it for every batch of figures
  against every patent label.
* ``mobius_dense_pallas``: project(expmap0(x W) ⊕ b), the first layer of
  ``HyperbolicEncoder`` (``MobiusDense`` with Euclidean input).

On a CUDA tensor each launches its hand-written kernel
(csrc/hyperbolic.cu) or raises; on a CPU tensor each runs its plain
version below.  The plain versions are float32 throughout and set
``torch.backends.cuda.matmul.allow_tf32 = False`` when they run on the
card: a TF32 Gram product is not the reference.  Neither kernel has a
backward, so a CUDA input that requires a gradient is refused;
``MobiusDense`` takes the plain version while autograd records.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from . import poincare
from .common import check_cuda_tensor, refuse_grad

_P, _I, _F = _build.P, _build.I, _build.F
# csrc/hyperbolic.cu: a cluster of at most 8 CTAs of 128 columns, in at
# most 8 column groups
MOBIUS_DENSE_MAX_OUT = 8192


def _full_f32(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def pairwise_dist_pallas_plain(x: torch.Tensor, y: torch.Tensor,
                               c: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 Gram product, then the
    tail max(1 + 2c·max(x² − 2xy + y², 0)/(αβ), 1 + 1e-7) →
    log(γ + √(γ² − 1))/√c, α = max(1 − c‖x‖², MIN_NORM) and β likewise."""
    x, y = x.float(), y.float()
    _full_f32(x)
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True)
    sq_diff = torch.clamp_min(x2 - 2.0 * (x @ y.T) + y2.T, 0.0)
    alpha = torch.clamp_min(1.0 - c * x2, poincare.MIN_NORM)
    beta = torch.clamp_min(1.0 - c * y2, poincare.MIN_NORM)
    gamma = torch.clamp_min(1.0 + 2.0 * c * sq_diff / (alpha * beta.T),
                            1.0 + 1e-7)
    return torch.log(gamma + torch.sqrt(gamma * gamma - 1.0)) / math.sqrt(c)


def pairwise_dist_pallas(x: torch.Tensor, y: torch.Tensor,
                         c: float = 1.0) -> torch.Tensor:
    """All-pairs Poincaré distance [n, m] of x [n, d] and y [m, d], f32.
    CPU tensors: the plain version; CUDA tensors: the kernel (contiguous
    f32 operands; one launch, none when n or m is 0), or an error."""
    if x.device.type == "cpu":
        return pairwise_dist_pallas_plain(x, y, c)
    check_cuda_tensor("x", x, torch.float32)
    check_cuda_tensor("y", y, torch.float32)
    refuse_grad("pairwise_dist_pallas", x, y)
    n, d = x.shape
    m = y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"x [{n}, {d}] and y {tuple(y.shape)} differ in "
                         "width")
    if c <= 0:
        raise ValueError(f"curvature must be positive, got {c}")
    out = torch.empty(n, m, dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    _build.call("ptt_pairwise_dist",
                [_P, _P, _I, _I, _I, _F, _F, _F, _P, _P],
                _build.ptr(x), _build.ptr(y), n, m, d, float(np.float32(c)),
                float(np.float32(2.0 * c)), float(np.float32(math.sqrt(c))),
                _build.ptr(out), _build.stream(x.device))
    pairwise_dist_pallas.launches += 1
    return out


pairwise_dist_pallas.launches = 0


def mobius_dense_pallas_plain(x: torch.Tensor, w: torch.Tensor,
                              bias: torch.Tensor,
                              c: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, through ``ops/poincare.py``
    as ``MobiusDense`` computes it: project(mobius_add(expmap0(x @ w),
    bias)), f32."""
    x = x.float()
    _full_f32(x)
    h = poincare.expmap0(x @ w.float(), c)
    return poincare.project(poincare.mobius_add(h, bias.float(), c), c)


def mobius_dense_pallas(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        c: float = 1.0) -> torch.Tensor:
    """The Euclidean-input hyperbolic dense layer project(expmap0(x W) ⊕
    bias) of x [n, K], w [K, D] (the Flax kernel layout), bias [D]
    (a point on the ball), f32.  CPU tensors: the plain version; CUDA
    tensors: the kernel (contiguous f32, D <= MOBIUS_DENSE_MAX_OUT; no
    launch at n = 0), or an error."""
    if x.device.type == "cpu":
        return mobius_dense_pallas_plain(x, w, bias, c)
    n, k = x.shape
    dout = w.shape[1]
    check_cuda_tensor("x", x, torch.float32)
    check_cuda_tensor("w", w, torch.float32, (k, dout))
    check_cuda_tensor("bias", bias, torch.float32, (dout,))
    refuse_grad("mobius_dense_pallas", x, w, bias)
    if dout > MOBIUS_DENSE_MAX_OUT or c <= 0:
        raise ValueError(f"mobius_dense kernel needs 0 < D <= "
                         f"{MOBIUS_DENSE_MAX_OUT} and c > 0 (got D={dout}, "
                         f"c={c})")
    out = torch.empty(n, dout, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _build.call("ptt_mobius_dense",
                [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P],
                _build.ptr(x), _build.ptr(w), _build.ptr(bias), n, k, dout,
                *_curvature_terms(c), _build.ptr(out),
                _build.stream(x.device))
    mobius_dense_pallas.launches += 1
    return out


mobius_dense_pallas.launches = 0


@functools.lru_cache(maxsize=16)
def _curvature_terms(c: float) -> tuple[float, ...]:
    """The plain version's curvature terms, each rounded to f32 as there:
    c, 2c, c², √max(c, MIN_NORM) and the projection radius (1 − ball_eps)
    / √c, made once a curvature."""
    c32 = np.float32(c)
    sqrt_c = np.sqrt(np.maximum(c32, np.float32(poincare.MIN_NORM)))
    maxnorm = np.float32(1.0 - poincare.ball_eps(torch.float32)) / sqrt_c
    return (float(c32), float(c32 * np.float32(2.0)), float(c32 * c32),
            float(sqrt_c), float(maxnorm))


def mobius_dense_launch(n: int, dout: int) -> dict[str, int]:
    """The launch ``mobius_dense_pallas`` makes on the card for n rows of
    dout columns: its CTAs, the CTAs of a thread-block cluster and the
    columns of a CTA (asked of the kernel library, which builds it)."""
    ctas, cluster, cols = (ctypes.c_int(0) for _ in range(3))
    _build.call("ptt_mobius_dense_shape", [_I, _I, _P, _P, _P], n, dout,
                ctypes.byref(ctas), ctypes.byref(cluster), ctypes.byref(cols))
    return {"ctas": ctas.value, "cluster": cluster.value, "cols": cols.value}
