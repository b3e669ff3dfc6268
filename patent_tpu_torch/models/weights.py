"""Map between the Flax param trees of the JAX package and the state dicts
of the port's towers: ``VisionTransformer`` (``params_from_jax`` /
``params_to_jax``) and ``Int8VisionTransformer`` (``int8_params_from_jax``,
the tree ``patent_tpu.models.vit_int8.quantize_vit_params`` returns).

The tree is nested dicts of numpy arrays, with or without the
``{"params": ...}`` wrapper.  The patch embedding changes layout (Flax conv
kernel [kh, kw, in, out] ↔ torch conv weight [out, in, kh, kw]), and the
int8 matrices go from [in, out] to the port's K-major [out, in]; every
other leaf maps one to one, the float [in, out] dense kernels included.
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


# (flax path within block_i of the int8 tree, torch name within blocks.i);
# the int8 matrices are transposed to [out, in]
_INT8_LAYER_LEAVES = [
    (("ln1", "scale"), "ln1_scale"), (("ln1", "bias"), "ln1_bias"),
    (("attn", "qkv_w"), "wqkv_t"), (("attn", "qkv_s"), "sqkv"),
    (("attn", "qkv_b"), "bqkv"), (("attn", "out_w"), "wout_t"),
    (("attn", "out_s"), "sout"), (("attn", "out_b"), "bout"),
    (("ln2", "scale"), "ln2_scale"), (("ln2", "bias"), "ln2_bias"),
    (("mlp_in_w",), "w1_t"), (("mlp_in_s",), "s1"), (("mlp_in_b",), "b1"),
    (("mlp_out_w",), "w2_t"), (("mlp_out_s",), "s2"), (("mlp_out_b",), "b2"),
]


def _num_layers(tree: dict) -> int:
    return sum(1 for k in tree if k.startswith("block_"))


def _get(node, path) -> torch.Tensor:
    """The leaf at ``path``: int8 kept, everything else as f32."""
    for key in path:
        node = node[key]
    a = np.asarray(node)
    return torch.from_numpy(np.array(
        a, dtype=np.int8 if a.dtype == np.int8 else np.float32))


def _top_from_jax(tree: dict) -> tuple[dict, dict[str, torch.Tensor]]:
    """(the unwrapped tree, the state dict of its non-layer leaves)."""
    if "params" in tree and "patch_embed" not in tree:
        tree = tree["params"]
    sd = {"patch_embed": _get(tree, ("patch_embed", "kernel")).permute(
        3, 2, 0, 1).contiguous()}
    for path, name in _TOP_LEAVES:
        sd[name] = _get(tree, path)
    return tree, sd


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` param tree (numpy leaves) → torch state
    dict (f32)."""
    tree, sd = _top_from_jax(tree)
    for i in range(_num_layers(tree)):
        for path, name in _LAYER_LEAVES:
            sd[f"blocks.{i}.{name}"] = _get(tree[f"block_{i}"], path)
    return sd


def int8_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ``Int8VisionTransformer`` param tree → state dict of the port's
    ``Int8VisionTransformer`` (int8 matrices [out, in], the rest f32)."""
    tree, sd = _top_from_jax(tree)
    for i in range(_num_layers(tree)):
        for path, name in _INT8_LAYER_LEAVES:
            leaf = _get(tree[f"block_{i}"], path)
            sd[f"blocks.{i}.{name}"] = (leaf.T.contiguous() if name.endswith(
                "_t") else leaf)
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
