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
    parameter's update and its new moments.

    The state is graph-safe: a CUDA graph of a step (utils/graphs.py)
    replays what it captured, so nothing a step reads may be a Python
    number or a tensor the step rebinds.  The count is an int32 device
    tensor; the bias corrections and the learning rate of each count come
    from an f32 table on the device (``reserve``), computed on the host in
    numpy as optax computes them; moments and parameters are updated in
    place.  ``step`` = ``reserve(1)`` + ``update`` + ``advance(1)``; a
    graphed loop reserves its steps, replays ``update`` and advances."""

    WINDOW = 256        # the table's rows at least (steps ahead)

    def __init__(self, params: Mapping[str, torch.nn.Parameter], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.names = jax_order(self.params)
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        device = next(iter(self.params.values())).device \
            if self.params else torch.device("cpu")
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.steps = 0            # the count, on the host
        self._rates: torch.Tensor | None = None   # [rows, 3] bc1, bc2, −lr
        self._first = torch.zeros((), dtype=torch.int32, device=device)
        self._first_host = 0      # the count of the table's row 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    def learning_rate(self, count: int) -> float:
        """The learning rate of the step that makes the count ``count``."""
        return self.lr

    def rates(self, count: int) -> tuple:
        """(bc1, bc2, −lr) of the step that makes the count ``count``: bc =
        1 − β^count in f32, as optax takes it, and the update's scale."""
        c32 = np.float32(count)
        return (np.float32(1.0) - np.float32(self.b1) ** c32,
                np.float32(1.0) - np.float32(self.b2) ** c32,
                -np.float32(self.learning_rate(count)))

    def reserve(self, n: int) -> bool:
        """Make the table cover the next ``n`` steps (one host → device
        copy where it does not yet).  A refill rewrites every row of the
        table from the new base, so that each row it covers is that of its
        count.  True where the table moved, so that a graph captured
        before must be captured again."""
        lo = self.steps + 1
        held = 0 if self._rates is None else self._rates.shape[0]
        if (held and self._first_host <= lo
                and lo + n <= self._first_host + held):
            return False
        rows = max(n, self.WINDOW, held)
        table = torch.from_numpy(np.asarray(
            [self.rates(lo + i) for i in range(rows)], np.float32))
        moved = held < rows
        if moved:
            self._rates = table.to(self.count.device)
        else:
            self._rates.copy_(table)
        self._first.fill_(lo)
        self._first_host = lo
        return moved

    def advance(self, n: int) -> None:
        """``n`` steps ran (``update`` n times, eagerly or replayed)."""
        self.steps += n

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One update of every parameter in place from ``grads``."""
        self.reserve(1)
        self.update(grads)
        self.advance(1)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """The step's device work alone, after ``reserve``: no host
        number, no host read, every state tensor updated in place (``_leaf``
        writes the moments into their tensors where it can)."""
        self.count.add_(1)
        bc1, bc2, scale = self._rates.index_select(
            0, (self.count - self._first).view(1))[0]
        for n in self.names:
            p, mu, nu = self.params[n], self.mu[n], self.nu[n]
            update, mu_new, nu_new = self._leaf(n, p, grads[n], mu, nu, bc1,
                                                bc2, scale)
            if mu_new is not mu:
                mu.copy_(mu_new)
            if nu_new is not nu:
                nu.copy_(nu_new)
            p.add_(update)

    def state_tree(self) -> RiemannianAdamState:
        """The state as JAX's optimizer state flattens: the count (int32),
        then the moments as trees of the JAX names."""
        return RiemannianAdamState(np.asarray(self.count.item(), np.int32),
                                   _tree(self.mu), _tree(self.nu))

    def load_state_leaves(self, leaves) -> None:
        """Restore from the flat leaves of a checkpoint's ``opt_state``:
        the count, then the moments' leaves in JAX's order (copied into
        the state tensors in place)."""
        n = len(self.names)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                             f"want {1 + 2 * n}")
        for i, name in enumerate(self.names):
            p = self.params[name]
            for moments, leaf in ((self.mu, leaves[1 + i]),
                                  (self.nu, leaves[1 + n + i])):
                leaf = torch.as_tensor(np.asarray(leaf, np.float32))
                if leaf.shape != p.shape:
                    raise ValueError(f"optimizer state of {name}: shape "
                                     f"{tuple(leaf.shape)}, want "
                                     f"{tuple(p.shape)}")
                moments[name].copy_(leaf)
        self.steps = int(np.asarray(leaves[0]))
        self.count.fill_(self.steps)
        self._rates = None      # the next reserve fills it from the count


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

    def _leaf(self, name, p, g, mu, nu, bc1, bc2, scale):
        b1, b2, eps, c = self.b1, self.b2, self.eps, self.c
        if self.mask[name]:
            r = poincare.egrad2rgrad(p, g, c)
            mu_new = torch.add(b1 * mu, (1.0 - b1) * r, out=mu)
            nu_new = torch.add(b2 * nu, (1.0 - b2) * r * r, out=nu)
            direction = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
            dir_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
            direction = direction * torch.clamp(
                self.max_norm / torch.clamp_min(dir_norm, 1e-12), max=1.0)
            p_new = poincare.project(poincare.expmap(p, scale * direction,
                                                     c), c)
            mu_new = poincare.ptransp(p, p_new, mu_new, c)
            return p_new - p, mu_new, nu_new
        mu_new = torch.add(b1 * mu, (1.0 - b1) * g, out=mu)
        nu_new = torch.add(b2 * nu, (1.0 - b2) * g * g, out=nu)
        step = scale * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        return step, mu_new, nu_new


class Adam(_Adam):
    """optax.adam: scale_by_adam then the learning rate, in optax's order
    of roundings."""

    def _leaf(self, name, p, g, mu, nu, bc1, bc2, scale):
        mu_new = torch.add((1 - self.b1) * g, self.b1 * mu, out=mu)
        nu_new = torch.add((1 - self.b2) * (g * g), self.b2 * nu, out=nu)
        u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
        return scale * u, mu_new, nu_new


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

    def learning_rate(self, count: int) -> float:
        return self.lr if self.schedule is None else self.schedule(count - 1)

    def _leaf(self, name, p, g, mu, nu, bc1, bc2, scale):
        mu_new = torch.add((1 - self.b1) * g, self.b1 * mu, out=mu)
        nu_new = torch.add((1 - self.b2) * (g * g), self.b2 * nu, out=nu)
        u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
        u = u + self.weight_decay * p
        return scale * u, mu_new, nu_new


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
