"""Early stopping on the validation loss with the best state kept (port of
patent_tpu/train/early_stopping.py, the reference's ``EarlyStopping``).

The JAX class keeps ``jax.tree.map(lambda x: x, state)``, which is a safe
snapshot only because JAX arrays are immutable.  Tensors are not: an
optimizer step updates parameters in place, so the port keeps a clone of
every tensor of the state (``detach().clone()``; numpy arrays are
copied), walking nested dicts, lists and tuples; other leaves are kept as
they are.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def snapshot(state: Any) -> Any:
    """A copy of ``state`` whose tensors and numpy arrays no later in-place
    update reaches."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return type(state)((k, snapshot(v)) for k, v in state.items())
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(snapshot(v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(snapshot(v) for v in state)
    return state


class EarlyStopping:
    def __init__(self, patience: int = 7, delta: float = 0.0,
                 save_fn: Callable[[Any], None] | None = None,
                 verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.save_fn = save_fn
        self.verbose = verbose
        self.counter = 0
        self.best_score: float | None = None
        self.best_state: Any = None
        self.early_stop = False

    def __call__(self, val_loss: float, state: Any) -> bool:
        """Record a validation result; returns True if training should
        stop."""
        score = -val_loss
        if self.best_score is None or score >= self.best_score + self.delta:
            self.best_score = score
            self.best_state = snapshot(state)
            self.counter = 0
            if self.save_fn is not None:
                self.save_fn(state)
            if self.verbose:
                print(f"EarlyStopping: new best val_loss {val_loss:.6f}")
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / "
                      f"{self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
