"""Read and write the JAX package's npz checkpoint layout without JAX
(port of patent_tpu/utils/checkpoint.py: its npz format,
``CheckpointManager`` and the reference's name-encoded checkpoint names).

A checkpoint ``<directory>/<name>/`` holds

    state.npz       leaf arrays keyed L00000, L00001, ... in pytree
                    flatten order (dict keys sorted, a NamedTuple's
                    fields in their order)
    manifest.json   {"paths": [path spec per leaf], "n": count}

where a path spec is a list of ["d", key] (dict) / ["s", index] (sequence)
/ ["a", name] (attribute: a NamedTuple field) segments.  What the writer
says of it (e.g. the validation loss) goes to ``<name>.meta.json`` beside
the directory (``CheckpointManager.save``, the JAX manager's layout) or to
``metadata.json`` inside it (the module's ``save``, the fine-tune's
layout); ``CheckpointManager.metadata`` reads either.  No pickle: loading
never runs code.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np


def _lists_from_int_keys(node):
    """{0: a, 1: b} dicts (from sequence keys) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in sorted(out)]
    return out


def _rebuild(paths: list, leaves: list) -> dict:
    """Nested dicts/lists from path specs; a top-level group holding an
    attribute segment (a custom pytree node) comes back as the flat list of
    its leaves, as the JAX reader returns it."""
    root: dict = {}
    groups: dict[str, list] = {}
    for p, leaf in zip(paths, leaves):
        groups.setdefault(p[0][1], []).append((p[1:], leaf))
    for key, items in groups.items():
        if len(items) == 1 and not items[0][0]:
            root[key] = items[0][1]
        elif any(seg[0] == "a" for p, _ in items for seg in p):
            root[key] = [leaf for _, leaf in items]
        else:
            node: dict = {}
            for p, leaf in items:
                cur = node
                for seg in p[:-1]:
                    cur = cur.setdefault(seg[1], {})
                cur[p[-1][1]] = leaf
            root[key] = _lists_from_int_keys(node)
    return root


def restore(directory: str, name: str) -> dict:
    """Load checkpoint ``name`` under ``directory`` as nested dicts of numpy
    arrays."""
    path = os.path.join(directory, name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as npz:
        leaves = [npz[f"L{i:05d}"] for i in range(manifest["n"])]
    return _rebuild(manifest["paths"], leaves)


def _flatten(node: Any, prefix: list, out: list) -> None:
    if hasattr(node, "_fields"):          # a NamedTuple, as JAX flattens it
        for name in node._fields:
            _flatten(getattr(node, name), prefix + [["a", name]], out)
    elif isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], prefix + [["d", str(k)]], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, prefix + [["s", i]], out)
    else:
        out.append((prefix, np.asarray(node)))


def _write(path: str, state: dict) -> None:
    os.makedirs(path, exist_ok=True)
    flat: list = []
    _flatten(state, [], flat)
    np.savez_compressed(os.path.join(path, "state.npz"),
                        **{f"L{i:05d}": leaf for i, (_, leaf) in enumerate(flat)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"paths": [p for p, _ in flat], "n": len(flat)}, f)


def save(directory: str, name: str, state: dict,
         metadata: dict | None = None) -> str:
    """Write ``state`` (nested dicts/lists/NamedTuples of arrays and
    numbers) as checkpoint ``name`` in the layout above, with ``metadata``
    (default {}) in metadata.json inside it; returns its directory."""
    path = os.path.join(directory, name)
    _write(path, state)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2)
    return path


class CheckpointManager:
    """Checkpoints under one directory in the JAX ``CheckpointManager``'s
    npz layout, so either package resumes or serves what the other
    wrote: ``save`` writes ``<name>/`` and, given metadata,
    ``<name>.meta.json`` beside it."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, name: str, state: dict,
             metadata: dict | None = None) -> str:
        path = os.path.join(self.directory, name)
        _write(path, state)
        if metadata is not None:
            with open(os.path.join(self.directory, f"{name}.meta.json"),
                      "w") as f:
                json.dump(metadata, f, indent=2)
        return path

    def restore(self, name: str) -> dict:
        """Nested dicts of numpy arrays; a NamedTuple group (an optimizer
        state) comes back as the flat list of its leaves in order."""
        return restore(self.directory, name)

    def metadata(self, name: str) -> dict | None:
        """What the writer said of checkpoint ``name``: its
        ``<name>.meta.json`` beside it, else its ``metadata.json``, else
        None."""
        for path in (os.path.join(self.directory, f"{name}.meta.json"),
                     os.path.join(self.directory, name, "metadata.json")):
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        return None

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.directory, name))

    def latest_step(self) -> int | None:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None


def reference_checkpoint_name(name: str, hidden_dim: int, latent_dim: int,
                              lr: float, epochs: int) -> str:
    """The reference's name-encoded hyperparameters,
    ``{name}_{hidden}_d{latent}_l{lr}_{epochs}``."""
    return f"{name}_{hidden_dim}_d{latent_dim}_l{lr}_{epochs}"


def parse_checkpoint_name(encoded: str) -> dict:
    """The inverse of ``reference_checkpoint_name``."""
    m = re.match(r"^(?P<name>.+)_(?P<hidden>\d+)_d(?P<latent>\d+)"
                 r"_l(?P<lr>[\d.e-]+)_(?P<epochs>\d+)$", encoded)
    if not m:
        raise ValueError(f"not a reference-encoded checkpoint name: {encoded}")
    return {"name": m.group("name"), "hidden_dim": int(m.group("hidden")),
            "latent_dim": int(m.group("latent")), "lr": float(m.group("lr")),
            "epochs": int(m.group("epochs"))}


def save_model(manager: CheckpointManager, state: dict, name: str,
               hidden_dim: int, latent_dim: int, lr: float, epochs: int,
               metadata: dict | None = None) -> str:
    """The reference's ``save_model`` (train.py:94-110): ``state`` saved
    under the name-encoded hyperparameters
    (``reference_checkpoint_name``); returns what the manager's ``save``
    returns."""
    encoded = reference_checkpoint_name(name, hidden_dim, latent_dim, lr,
                                        epochs)
    return manager.save(encoded, state, metadata=metadata)


def load_model(manager: CheckpointManager, encoded_name: str
               ) -> tuple[dict, dict]:
    """The reference's ``load_model`` (train.py:56-91) without its fixed
    node counts: (the restored state, the hyperparameters parsed from
    the name)."""
    return manager.restore(encoded_name), parse_checkpoint_name(encoded_name)
