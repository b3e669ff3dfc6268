"""Poincaré-ball geometry in plain PyTorch (port of
patent_tpu/ops/poincare.py: the manifold operations and the Riemannian
calculus that Riemannian Adam uses).

Curvature is ``c > 0`` (a ball of radius 1/√c); every operation works on
the last axis and broadcasts over the leading ones.  The formulas, their
clamps and the order of their floating-point operations follow the JAX
package, so the two agree to rounding on the same inputs:

* ``_norm`` is the smoothed norm sqrt(‖x‖² + MIN_NORM²), not a max-clamp;
* ``project`` keeps points ``ball_eps`` inside the boundary: 4e-3 of the
  radius in float32, 1e-5 in float64;
* ``artanh`` clamps into (−1 + 1e-7, 1 − 1e-7), ``arcosh`` to ≥ 1 + 1e-7;
* ``pairwise_dist`` is the arcosh closed form, one Gram product plus an
  elementwise tail; the product runs in full float32 (no TF32), since
  1 − c‖x‖² is small near the boundary and x² − 2xy + y² cancels.
"""

from __future__ import annotations

from typing import Callable

import torch

MIN_NORM = 1e-15

_BALL_EPS = {torch.float32: 4e-3, torch.float64: 1e-5}


def ball_eps(dtype: torch.dtype) -> float:
    """Relative distance ``project`` keeps from the boundary."""
    return _BALL_EPS.get(dtype, 4e-3)


def _c(c, x: torch.Tensor) -> torch.Tensor:
    """The curvature as a 0-d tensor of ``x``'s dtype and device (a number
    is filled in on the device: no host copy, which a CUDA graph's capture
    refuses)."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=x.dtype, device=x.device)
    return torch.full((), c, dtype=x.dtype, device=x.device)


def _sqrt_c(c: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(c, MIN_NORM))


def _sq_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return (x * x).sum(dim=-1, keepdim=keepdim)


def _norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Smoothed Euclidean norm sqrt(‖x‖² + MIN_NORM²): finite gradients at
    0, and a value that differs from ‖x‖ only below 1e-15."""
    return torch.sqrt(_sq_norm(x, keepdim) + MIN_NORM * MIN_NORM)


def artanh(x: torch.Tensor) -> torch.Tensor:
    return torch.atanh(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def arcosh(x: torch.Tensor) -> torch.Tensor:
    return torch.acosh(torch.clamp_min(x, 1.0 + 1e-7))


def project(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Clip points into the open ball of radius (1 − eps)/√c."""
    c = _c(c, x)
    norm = _norm(x)
    maxnorm = (1.0 - ball_eps(x.dtype)) / _sqrt_c(c)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def lambda_x(x: torch.Tensor, c=1.0, *, keepdim: bool = True) -> torch.Tensor:
    """Conformal factor λ_x = 2 / (1 − c‖x‖²)."""
    c = _c(c, x)
    return 2.0 / torch.clamp_min(1.0 - c * _sq_norm(x, keepdim), MIN_NORM)


def mobius_add(x: torch.Tensor, y: torch.Tensor, c=1.0) -> torch.Tensor:
    """Möbius addition x ⊕_c y."""
    c = _c(c, x)
    x2 = _sq_norm(x)
    y2 = _sq_norm(y)
    xy = (x * y).sum(dim=-1, keepdim=True)
    num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
    denom = 1.0 + 2.0 * c * xy + c * c * x2 * y2
    return num / torch.clamp_min(denom, MIN_NORM)


def mobius_neg(x: torch.Tensor) -> torch.Tensor:
    return -x


def expmap0(u: torch.Tensor, c=1.0) -> torch.Tensor:
    """Exponential map at the origin."""
    sqrt_c = _sqrt_c(_c(c, u))
    u_norm = _norm(u)
    return torch.tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def logmap0(y: torch.Tensor, c=1.0) -> torch.Tensor:
    """Logarithmic map at the origin."""
    sqrt_c = _sqrt_c(_c(c, y))
    y_norm = _norm(y)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def expmap(x: torch.Tensor, u: torch.Tensor, c=1.0) -> torch.Tensor:
    """Exponential map at x: x ⊕ tanh(√c λ_x ‖u‖ / 2) u / (√c ‖u‖)."""
    sqrt_c = _sqrt_c(_c(c, x))
    u_norm = _norm(u)
    second = (torch.tanh(sqrt_c / 2.0 * lambda_x(x, c) * u_norm) * u
              / (sqrt_c * u_norm))
    return mobius_add(x, second, c)


def dist(x: torch.Tensor, y: torch.Tensor, c=1.0, *,
         keepdim: bool = False) -> torch.Tensor:
    """Geodesic distance 2/√c · artanh(√c ‖(−x) ⊕ y‖), broadcasting over
    the leading axes."""
    sqrt_c = _sqrt_c(_c(c, x))
    diff_norm = _norm(mobius_add(-x, y, c), keepdim=keepdim)
    return 2.0 / sqrt_c * artanh(sqrt_c * diff_norm)


def dist0(x: torch.Tensor, c=1.0, *, keepdim: bool = False) -> torch.Tensor:
    """Distance to the origin."""
    sqrt_c = _sqrt_c(_c(c, x))
    return 2.0 / sqrt_c * artanh(sqrt_c * _norm(x, keepdim=keepdim))


def pairwise_dist(x: torch.Tensor, y: torch.Tensor, c=1.0) -> torch.Tensor:
    """All-pairs geodesic distances [n, m] of x [n, d] and y [m, d]:
    arcosh(1 + 2c‖x−y‖² / ((1−c‖x‖²)(1−c‖y‖²))) / √c."""
    c = _c(c, x)
    x2 = _sq_norm(x)                                  # [n, 1]
    y2 = _sq_norm(y)                                  # [m, 1]
    xy = x @ y.T                                      # [n, m]
    sq_diff = torch.clamp_min(x2 - 2.0 * xy + y2.T, 0.0)
    alpha = torch.clamp_min(1.0 - c * x2, MIN_NORM)
    beta = torch.clamp_min(1.0 - c * y2, MIN_NORM)
    gamma = 1.0 + 2.0 * c * sq_diff / (alpha * beta.T)
    return arcosh(gamma) / _sqrt_c(c)


def mobius_matvec(m: torch.Tensor, x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Möbius matrix-vector product M ⊗_c x, m [out, in] (the nn.Linear
    layout), x [..., in]; rows whose product is 0 map to the origin."""
    sqrt_c = _sqrt_c(_c(c, x))
    x_norm = _norm(x)
    mx = x @ m.T
    mx_norm = _norm(mx)
    res = (torch.tanh(mx_norm / x_norm * artanh(sqrt_c * x_norm)) * mx
           / (mx_norm * sqrt_c))
    zero = (mx == 0).all(dim=-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(res), res)


def mobius_fn_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Apply a Euclidean function in the tangent space at the origin."""
    return project(expmap0(fn(logmap0(x, c)), c), c)


def mobius_scalar_mul(r, x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Möbius scalar multiplication r ⊗_c x."""
    sqrt_c = _sqrt_c(_c(c, x))
    x_norm = _norm(x)
    return torch.tanh(r * artanh(sqrt_c * x_norm)) * x / (x_norm * sqrt_c)


# ---------------------------------------------------------------------------
# Riemannian calculus (for Riemannian Adam, train/optim.py)
# ---------------------------------------------------------------------------

def egrad2rgrad(x: torch.Tensor, grad: torch.Tensor, c=1.0) -> torch.Tensor:
    """Euclidean → Riemannian gradient: g / λ_x²."""
    lam = lambda_x(x, c)
    return grad / torch.clamp_min(lam * lam, MIN_NORM)


def gyration(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             c=1.0) -> torch.Tensor:
    """Gyration gyr[u, v]w in Ungar's closed form, equal to
    ⊖(u ⊕ v) ⊕ (u ⊕ (v ⊕ w))."""
    c = _c(c, u)
    u2 = _sq_norm(u)
    v2 = _sq_norm(v)
    uv = (u * v).sum(dim=-1, keepdim=True)
    uw = (u * w).sum(dim=-1, keepdim=True)
    vw = (v * w).sum(dim=-1, keepdim=True)
    c2 = c * c
    a = -c2 * uw * v2 + c * vw + 2.0 * c2 * uv * vw
    b = -c2 * vw * u2 - c * uw
    d = 1.0 + 2.0 * c * uv + c2 * u2 * v2
    return w + 2.0 * (a * u + b * v) / torch.clamp_min(d, MIN_NORM)


def ptransp(x: torch.Tensor, y: torch.Tensor, v: torch.Tensor,
            c=1.0) -> torch.Tensor:
    """Parallel transport of the tangent vector v from x to y."""
    lam_x = lambda_x(x, c)
    lam_y = lambda_x(y, c)
    return gyration(y, -x, v, c) * (lam_x / lam_y)


def inner(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor | None = None,
          c=1.0, *, keepdim: bool = False) -> torch.Tensor:
    """Riemannian inner product λ_x² ⟨u, v⟩ at x (λ_x keeps its last axis,
    as in the JAX function, so it broadcasts the same way)."""
    if v is None:
        v = u
    lam = lambda_x(x, c)
    return lam * lam * (u * v).sum(dim=-1, keepdim=keepdim)



class PoincareBall:
    """A stateless handle bundling the curvature with the ops above (port
    of JAX's ``PoincareBall``; the reference's ``geoopt.PoincareBall(c)``).
    The JAX names and keywords (``keepdims``)."""

    def __init__(self, c: float = 1.0):
        self.c = float(c)

    # point ops
    def projx(self, x):
        return project(x, self.c)

    def expmap0(self, u):
        return expmap0(u, self.c)

    def logmap0(self, y):
        return logmap0(y, self.c)

    def expmap(self, x, u):
        return expmap(x, u, self.c)

    def dist(self, x, y, *, keepdims=False):
        return dist(x, y, self.c, keepdim=keepdims)

    def dist0(self, x, *, keepdims=False):
        return dist0(x, self.c, keepdim=keepdims)

    def pairwise_dist(self, x, y):
        return pairwise_dist(x, y, self.c)

    def mobius_add(self, x, y):
        return mobius_add(x, y, self.c)

    def mobius_matvec(self, m, x):
        return mobius_matvec(m, x, self.c)

    def mobius_fn_apply(self, fn, x):
        return mobius_fn_apply(fn, x, self.c)

    # tangent ops
    def egrad2rgrad(self, x, g):
        return egrad2rgrad(x, g, self.c)

    def ptransp(self, x, y, v):
        return ptransp(x, y, v, self.c)

    def lambda_x(self, x, *, keepdims=True):
        return lambda_x(x, self.c, keepdim=keepdims)

    def __repr__(self):
        return f"PoincareBall(c={self.c})"
