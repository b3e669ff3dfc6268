"""Riemannian Adam and Adam over named parameters (port of
patent_tpu/train/optim.py and of optax.adam's arithmetic).

For a Poincaré-ball parameter p with Euclidean gradient g:

    r     = egrad2rgrad(p, g) = g / λ_p²
    m     = β₁ m + (1 − β₁) r
    v     = β₂ v + (1 − β₂) r ⊙ r
    dir   = (m / bc₁) / (√(v / bc₂) + ε), its norm capped at 10 / lr
    p_new = project(expmap_p(−lr · dir))
    m     ← ptransp(p → p_new, m)

and the update is p_new − p, added back to p, so p takes the same two f32
roundings as JAX's ``optax.apply_updates``.  Every other parameter takes
Adam as JAX's ``riemannian_adam`` writes it (:113-117), or, in ``Adam``,
as ``optax.adam`` does; the two differ in the order of their roundings.
``AdamW`` is ``optax.adamw``: Adam's direction plus ``weight_decay`` times
the parameter (every leaf, biases and BatchNorm scales too), times the
learning rate, which a schedule may give per step (optax's count, from 0).
bc = 1 − β^count, with the count after this step's increment.

Which parameters are points of the ball: those whose name contains
``label_emb`` or ``hyp_bias``, as JAX's ``manifold_mask`` marks them.  The
optimizer state goes to a checkpoint as JAX's
``RiemannianAdamState(count, mu, nu)`` flattens (``state_tree``), with the
moments under the JAX tree's names, so either package resumes the other's.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..ops import poincare

MANIFOLD_PARAM_NAMES = ("label_emb", "hyp_bias")


class RiemannianAdamState(NamedTuple):
    count: np.ndarray
    mu: dict
    nu: dict


def jax_order(names) -> list[str]:
    """Dotted parameter names in the order JAX flattens their tree (the
    keys of each level sorted)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def manifold_mask(names, markers: tuple[str, ...] = MANIFOLD_PARAM_NAMES
                  ) -> dict[str, bool]:
    """True for each name that contains one of ``markers``."""
    return {n: any(m in n for m in markers) for n in names}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: √(Σ‖g‖²) over the leaves in JAX's order."""
    return torch.sqrt(sum((grads[n] * grads[n]).sum()
                          for n in jax_order(grads)))


def _tree(flat: Mapping[str, torch.Tensor]) -> dict:
    """Dotted names → nested dicts of numpy arrays (the JAX tree)."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


class _Adam:
    """The state and the step shared by both optimizers; ``_leaf`` gives a
    parameter's update and its new moments."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.names = jax_order(self.params)
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One update of every parameter in place from ``grads``."""
        self.count += 1
        c32 = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c32)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c32)
        for n in self.names:
            p = self.params[n]
            update, self.mu[n], self.nu[n] = self._leaf(
                n, p, grads[n], self.mu[n], self.nu[n], bc1, bc2)
            p.add_(update)

    def state_tree(self) -> RiemannianAdamState:
        """The state as JAX's optimizer state flattens: the count (int32),
        then the moments as trees of the JAX names."""
        return RiemannianAdamState(np.asarray(self.count, np.int32),
                                   _tree(self.mu), _tree(self.nu))

    def load_state_leaves(self, leaves) -> None:
        """Restore from the flat leaves of a checkpoint's ``opt_state``:
        the count, then the moments' leaves in JAX's order."""
        n = len(self.names)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                             f"want {1 + 2 * n}")
        self.count = int(np.asarray(leaves[0]))
        for i, name in enumerate(self.names):
            p = self.params[name]
            for moments, leaf in ((self.mu, leaves[1 + i]),
                                  (self.nu, leaves[1 + n + i])):
                leaf = torch.as_tensor(np.asarray(leaf, np.float32))
                if leaf.shape != p.shape:
                    raise ValueError(f"optimizer state of {name}: shape "
                                     f"{tuple(leaf.shape)}, want "
                                     f"{tuple(p.shape)}")
                moments[name] = leaf.to(p.device)


class RiemannianAdam(_Adam):
    """JAX's ``riemannian_adam``: Riemannian steps for the parameters that
    ``mask`` marks (default ``manifold_mask``), Adam for the others (JAX's
    optional weight decay, which no trainer sets, is left out)."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 c: float = 1.0, mask: Mapping[str, bool] | None = None):
        super().__init__(params, lr, b1, b2, eps)
        self.c = c
        self.mask = dict(mask) if mask is not None else manifold_mask(
            self.params)
        # the trust region's cap on the direction's norm, in f32 as JAX
        # computes 10 / max(lr, 1e-12)
        self.max_norm = float(np.float32(10.0)
                              / np.float32(max(self.lr, 1e-12)))

    def _leaf(self, name, p, g, mu, nu, bc1, bc2):
        b1, b2, eps, lr, c = self.b1, self.b2, self.eps, self.lr, self.c
        if self.mask[name]:
            r = poincare.egrad2rgrad(p, g, c)
            mu_new = b1 * mu + (1.0 - b1) * r
            nu_new = b2 * nu + (1.0 - b2) * r * r
            direction = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
            dir_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
            direction = direction * torch.clamp(
                self.max_norm / torch.clamp_min(dir_norm, 1e-12), max=1.0)
            p_new = poincare.project(poincare.expmap(p, -lr * direction, c),
                                     c)
            mu_new = poincare.ptransp(p, p_new, mu_new, c)
            return p_new - p, mu_new, nu_new
        mu_new = b1 * mu + (1.0 - b1) * g
        nu_new = b2 * nu + (1.0 - b2) * g * g
        step = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        return step, mu_new, nu_new


class Adam(_Adam):
    """optax.adam: scale_by_adam then the learning rate, in optax's order
    of roundings."""

    def _leaf(self, name, p, g, mu, nu, bc1, bc2):
        mu_new = (1 - self.b1) * g + self.b1 * mu
        nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
        u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
        return -self.lr * u, mu_new, nu_new


class AdamW(Adam):
    """optax.adamw: scale_by_adam, add_decayed_weights, then the learning
    rate, or ``schedule(count)`` with the count before this step, as
    ``optax.scale_by_schedule`` takes it."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 schedule: Callable[[int], float] | None = None):
        super().__init__(params, lr, b1, b2, eps)
        self.weight_decay = weight_decay
        self.schedule = schedule

    def _leaf(self, name, p, g, mu, nu, bc1, bc2):
        mu_new = (1 - self.b1) * g + self.b1 * mu
        nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
        u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
        u = u + self.weight_decay * p
        lr = self.lr if self.schedule is None else self.schedule(
            self.count - 1)
        return -lr * u, mu_new, nu_new


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False
                      ) -> Callable[[int], float]:
    """optax.exponential_decay in f32: init · rate^(count / steps), the
    exponent floored with ``staircase``."""
    def schedule(count: int) -> float:
        e = np.float32(count) / np.float32(transition_steps)
        if staircase:
            e = np.floor(e)
        return float(np.float32(init_value)
                     * np.power(np.float32(decay_rate), np.float32(e)))
    return schedule
