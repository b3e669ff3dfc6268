"""Map between the Flax ``VisionTransformer`` param tree of the JAX package
and the state dict of ``patent_tpu_torch.models.vit.VisionTransformer``.

The tree is nested dicts of numpy arrays, with or without the
``{"params": ...}`` wrapper.  Only the patch embedding changes layout
(Flax conv kernel [kh, kw, in, out] ↔ torch conv weight [out, in, kh, kw]);
every other leaf maps one to one, [in, out] dense kernels included.
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path within block_i, torch name within blocks.i)
_LAYER_LEAVES = [
    (("ln1", "scale"), "ln1_scale"), (("ln1", "bias"), "ln1_bias"),
    (("attn", "qkv", "kernel"), "wqkv"), (("attn", "qkv", "bias"), "bqkv"),
    (("attn", "out", "kernel"), "wout"), (("attn", "out", "bias"), "bout"),
    (("ln2", "scale"), "ln2_scale"), (("ln2", "bias"), "ln2_bias"),
    (("mlp_in", "kernel"), "w1"), (("mlp_in", "bias"), "b1"),
    (("mlp_out", "kernel"), "w2"), (("mlp_out", "bias"), "b2"),
]
_TOP_LEAVES = [
    (("class_embedding",), "class_embedding"),
    (("position_embedding",), "position_embedding"),
    (("pre_ln", "scale"), "pre_ln_scale"), (("pre_ln", "bias"), "pre_ln_bias"),
    (("post_ln", "scale"), "post_ln_scale"),
    (("post_ln", "bias"), "post_ln_bias"),
    (("projection", "kernel"), "projection"),
]


def _num_layers(tree: dict) -> int:
    return sum(1 for k in tree if k.startswith("block_"))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) → torch state dict (f32)."""
    if "params" in tree and "patch_embed" not in tree:
        tree = tree["params"]

    def get(node, path):
        for key in path:
            node = node[key]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    sd = {"patch_embed": get(tree, ("patch_embed", "kernel")).permute(
        3, 2, 0, 1).contiguous()}
    for path, name in _TOP_LEAVES:
        sd[name] = get(tree, path)
    for i in range(_num_layers(tree)):
        for path, name in _LAYER_LEAVES:
            sd[f"blocks.{i}.{name}"] = get(tree[f"block_{i}"], path)
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Torch state dict → Flax param tree of f32 numpy arrays (no wrapper),
    the inverse of ``params_from_jax``."""
    def put(node, path, value):
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().float().cpu().numpy()

    tree: dict = {}
    put(tree, ("patch_embed", "kernel"),
        state_dict["patch_embed"].permute(2, 3, 1, 0))
    for path, name in _TOP_LEAVES:
        put(tree, path, state_dict[name])
    n = 1 + max(int(k.split(".")[1]) for k in state_dict
                if k.startswith("blocks."))
    for i in range(n):
        for path, name in _LAYER_LEAVES:
            put(tree, (f"block_{i}",) + path, state_dict[f"blocks.{i}.{name}"])
    return tree
