"""Map between the Flax param trees of the JAX package and the state dicts
of the port's towers: ``VisionTransformer`` (and the trainable tower, which
has its names; ``params_from_jax`` / ``params_to_jax``), the whole
fine-tune tree ``{"vit": ..., "head": ...}`` of the fine-tune's
``FinetuneModel`` (the same two functions: keys ``vit.*`` and ``head.*``),
``TextTransformer`` (``text_params_from_jax`` / ``text_params_to_jax``:
``token_embedding``, ``position_embedding``, the layers as the vision
tower's, ``final_ln`` and ``projection/kernel``),
``Int8VisionTransformer`` (``int8_params_from_jax``, the tree
``patent_tpu.models.vit_int8.quantize_vit_params`` returns), and the
hyperbolic models of ``models/hyperbolic.py`` (``hyperbolic_params_from_jax``
/ ``hyperbolic_params_to_jax``: ``label_emb`` and
``encoder/{first_layer,middle_i,final_layer}/{kernel,hyp_bias}``, whose
names and [in, out] kernels the port keeps, so each leaf maps to the state
dict key of its path joined by dots; ``HMI`` too: ``label_emb`` and
``encoder/{kernel,hyp_bias}``), the joint tree ``{"vit": ..., "hyp": ...}``
of train_end's ``EndToEndModel`` (``end_to_end_params_from_jax`` /
``end_to_end_params_to_jax``: keys ``vit.*`` and ``hyp.*``), and the graph
models of ``models/gcn.py`` (``gcn_variables_from_jax`` /
``gcn_variables_to_jax``: the Flax variables ``{"params", "batch_stats"}``
of ``EnhancedVGAE`` or ``VGAE``, whose BatchNorm statistics ``mean`` and
``var`` are the port's buffers of those names).

The tree is nested dicts of numpy arrays, with or without the
``{"params": ...}`` wrapper.  The patch embedding changes layout (Flax conv
kernel [kh, kw, in, out] ↔ torch conv weight [out, in, kh, kw]), and the
int8 matrices go from [in, out] to the port's K-major [out, in], and the
alignment head's Flax ``Dense_0`` (image projector) and ``Dense_1`` (graph
projector) kernels become ``nn.Linear`` weights [out, in]; every other
leaf maps one to one, the tower's float [in, out] dense kernels included.
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
# the text tower's leaves outside its layers
_TEXT_TOP_LEAVES = [
    (("token_embedding",), "token_embedding"),
    (("position_embedding",), "position_embedding"),
    (("final_ln", "scale"), "final_ln_scale"),
    (("final_ln", "bias"), "final_ln_bias"),
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


# (flax path within the alignment head, torch name within head.,
# transposed)
_HEAD_LEAVES = [
    (("graph_embedding",), "graph_embedding", False),
    (("logit_scale",), "logit_scale", False),
    (("Dense_0", "kernel"), "img_proj.0.weight", True),
    (("Dense_0", "bias"), "img_proj.0.bias", False),
    (("Dense_1", "kernel"), "graph_proj.0.weight", True),
    (("Dense_1", "bias"), "graph_proj.0.bias", False),
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


def _layers_from_jax(tree: dict, sd: dict[str, torch.Tensor]) -> None:
    for i in range(_num_layers(tree)):
        for path, name in _LAYER_LEAVES:
            sd[f"blocks.{i}.{name}"] = _get(tree[f"block_{i}"], path)


def _layers_to_jax(state_dict: dict[str, torch.Tensor], tree: dict) -> None:
    n = 1 + max(int(k.split(".")[1]) for k in state_dict
                if k.startswith("blocks."))
    for i in range(n):
        for path, name in _LAYER_LEAVES:
            _put(tree, (f"block_{i}",) + path,
                 state_dict[f"blocks.{i}.{name}"])


def text_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ``TextTransformer`` param tree (numpy leaves, with or without
    the ``{"params": ...}`` wrapper) → the state dict of the port's
    ``TextTransformer`` (f32)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {name: _get(tree, path) for path, name in _TEXT_TOP_LEAVES}
    _layers_from_jax(tree, sd)
    return sd


def text_params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``text_params_from_jax`` (f32 numpy, no wrapper)."""
    tree: dict = {}
    for path, name in _TEXT_TOP_LEAVES:
        _put(tree, path, state_dict[name])
    _layers_to_jax(state_dict, tree)
    return tree


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` param tree (numpy leaves) → torch state
    dict (f32); a fine-tune tree ``{"vit", "head"}`` → the state dict of a
    ``FinetuneModel`` (``vit.*`` and ``head.*``)."""
    if "params" in tree and "vit" not in tree and "patch_embed" not in tree:
        tree = tree["params"]
    if "vit" in tree:
        sd = {f"vit.{k}": v for k, v in params_from_jax(tree["vit"]).items()}
        for path, name, transpose in _HEAD_LEAVES:
            leaf = _get(tree["head"], path)
            sd[f"head.{name}"] = leaf.T.contiguous() if transpose else leaf
        return sd
    tree, sd = _top_from_jax(tree)
    _layers_from_jax(tree, sd)
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


def _put(node, path, value):
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value.detach().float().cpu().numpy()


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Torch state dict → Flax param tree of f32 numpy arrays (no wrapper),
    the inverse of ``params_from_jax``: a tower's, or a ``FinetuneModel``'s
    → ``{"vit": ..., "head": ...}``."""
    if any(k.startswith("vit.") for k in state_dict):
        head: dict = {}
        for path, name, transpose in _HEAD_LEAVES:
            leaf = state_dict[f"head.{name}"]
            _put(head, path, leaf.T if transpose else leaf)
        return {"vit": params_to_jax({k[4:]: v for k, v in state_dict.items()
                                      if k.startswith("vit.")}),
                "head": head}
    tree: dict = {}
    _put(tree, ("patch_embed", "kernel"),
         state_dict["patch_embed"].permute(2, 3, 1, 0))
    for path, name in _TOP_LEAVES:
        _put(tree, path, state_dict[name])
    _layers_to_jax(state_dict, tree)
    return tree


def hyperbolic_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax tree of a hyperbolic model (``HyperbolicEmbeddingModel``,
    ``FigureOnlyHyperbolicModel``; numpy leaves, with or without the
    ``{"params": ...}`` wrapper) → its torch state dict (f32)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + key + ".")
            else:
                sd[prefix + key] = torch.from_numpy(
                    np.array(val, dtype=np.float32))

    walk(tree, "")
    return sd


def hyperbolic_params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Torch state dict of a hyperbolic model → its Flax param tree of f32
    numpy arrays (no wrapper), the inverse of
    ``hyperbolic_params_from_jax``."""
    tree: dict = {}
    for name, leaf in state_dict.items():
        _put(tree, tuple(name.split(".")), leaf)
    return tree


def _walk(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dicts of arrays → {dotted path: f32 tensor}."""
    sd: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            sd.update(_walk(val, prefix + key + "."))
        else:
            sd[prefix + key] = torch.from_numpy(np.array(val, np.float32))
    return sd


def end_to_end_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's train_end tree ``{"vit", "hyp"}`` (with or without the
    ``{"params": ...}`` wrapper) → the state dict of an ``EndToEndModel``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {f"vit.{k}": v for k, v in params_from_jax(tree["vit"]).items()}
    sd.update({f"hyp.{k}": v for k, v in
               hyperbolic_params_from_jax(tree["hyp"]).items()})
    return sd


def end_to_end_params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``end_to_end_params_from_jax`` (no wrapper)."""
    return {"vit": params_to_jax({k[4:]: v for k, v in state_dict.items()
                                  if k.startswith("vit.")}),
            "hyp": hyperbolic_params_to_jax({
                k[4:]: v for k, v in state_dict.items()
                if k.startswith("hyp.")})}


def gcn_variables_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax variables ``{"params", "batch_stats"}`` of ``EnhancedVGAE`` or
    ``VGAE`` → the port model's state dict (parameters and the BatchNorm
    buffers ``mean`` / ``var``)."""
    sd = _walk(variables["params"])
    sd.update(_walk(variables.get("batch_stats", {})))
    return sd


def gcn_variables_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``gcn_variables_from_jax``: the BatchNorm buffers go
    to ``batch_stats``, everything else to ``params``."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, leaf in state_dict.items():
        kind = ("batch_stats" if name.rsplit(".", 1)[-1] in ("mean", "var")
                else "params")
        _put(out[kind], tuple(name.split(".")), leaf)
    return out
