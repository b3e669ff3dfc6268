"""Read and write the JAX package's npz checkpoint layout without JAX
(port of patent_tpu/utils/checkpoint.py, ``CheckpointManager`` npz format).

A checkpoint ``<directory>/<name>/`` holds

    state.npz       leaf arrays keyed L00000, L00001, ... in pytree
                    flatten order (dict keys sorted)
    manifest.json   {"paths": [path spec per leaf], "n": count}
    metadata.json   what the writer says of it (e.g. the validation loss);
                    the JAX manager writes it as <name>.meta.json beside
                    the directory

where a path spec is a list of ["d", key] (dict) / ["s", index] (sequence)
/ ["a", name] (attribute) segments.  No pickle: loading never runs code.
"""

from __future__ import annotations

import json
import os
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
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], prefix + [["d", str(k)]], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, prefix + [["s", i]], out)
    else:
        out.append((prefix, np.asarray(node)))


def save(directory: str, name: str, state: dict,
         metadata: dict | None = None) -> str:
    """Write ``state`` (nested dicts/lists of arrays and numbers) as
    checkpoint ``name`` in the layout above, with ``metadata`` (default {})
    in metadata.json; returns its directory."""
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    flat: list = []
    _flatten(state, [], flat)
    np.savez_compressed(os.path.join(path, "state.npz"),
                        **{f"L{i:05d}": leaf for i, (_, leaf) in enumerate(flat)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"paths": [p for p, _ in flat], "n": len(flat)}, f)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2)
    return path
