"""HF CLIP checkpoints for the port's towers, read without ``transformers``
or ``safetensors`` (port of the converters of patent_tpu/models/vit.py).

An HF ``CLIPModel`` directory (``save_pretrained``) holds its weights in
``model.safetensors`` or, from older writers, ``pytorch_model.bin``.
``read_hf_state_dict`` reads either: the safetensors file by its own
format (8 bytes of little-endian header length, a JSON header of dtype,
shape and ``data_offsets`` a tensor, then the raw little-endian buffer),
the ``.bin`` with ``torch.load(weights_only=True)``.  A sharded checkpoint
(``*.index.json``) is refused.

``hf_clip_vision_params`` / ``hf_clip_text_params`` map an HF state dict
onto the state dicts of ``VisionTransformer`` (and the trainable and int8
towers, which take the same names) and ``TextTransformer``: each Linear
weight [out, in] is transposed to the port's [in, out], q, k and v are
concatenated into ``wqkv`` / ``bqkv``, and the patch convolution keeps its
[out, in, kh, kw] layout, which is the port's.  HF's ``position_ids``
buffers and ``logit_scale`` are not read.  ``hf_clip_vision_state_dict``
and ``hf_clip_text_state_dict`` are the inverses: their keys load into
``CLIPModel.load_state_dict(sd, strict=False)``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from .vit import TEXT_B, VIT_B16, TextConfig, VisionConfig

SAFETENSORS_FILE = "model.safetensors"
TORCH_FILE = "pytorch_model.bin"
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def hf_weight_file(checkpoint_dir: str) -> str:
    """The weight file of an HF checkpoint directory: ``model.safetensors``,
    else ``pytorch_model.bin``.  Raises for a sharded checkpoint or a
    directory with neither file."""
    for name in (SAFETENSORS_FILE, TORCH_FILE):
        path = os.path.join(checkpoint_dir, name)
        if os.path.isfile(path):
            return path
    for name in (SAFETENSORS_FILE, TORCH_FILE):
        if os.path.isfile(os.path.join(checkpoint_dir, name + ".index.json")):
            raise ValueError(f"{checkpoint_dir}: sharded HF checkpoints "
                             f"({name}.index.json) are not supported")
    raise FileNotFoundError(f"{checkpoint_dir}: neither {SAFETENSORS_FILE} "
                            f"nor {TORCH_FILE} found")


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}.  The tensors share one
    buffer with the file's bytes (a tensor whose offset is not a multiple
    of its element size gets a copy of its own)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(buf)
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not read")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        item = torch.empty((), dtype=dtype).element_size()
        if end == start:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=(end - start) // item,
                                 offset=start)
            if start % item:
                t = t.clone()
        out[name] = t.reshape(info["shape"])
    return out


def read_hf_state_dict(checkpoint_dir: str) -> dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory (``hf_weight_file``),
    CPU tensors in the file's dtypes."""
    path = hf_weight_file(checkpoint_dir)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, weights_only=True, map_location="cpu")


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _hf_layers(sd: dict, prefix: str, num_layers: int
               ) -> dict[str, torch.Tensor]:
    """HF encoder layers ``prefix``.i → the port's ``blocks.i.*``."""
    out = {}
    for i in range(num_layers):
        enc, blk = f"{prefix}.{i}", f"blocks.{i}"

        def w(name):
            return _f32(sd[f"{enc}.{name}.weight"])

        def b(name):
            return _f32(sd[f"{enc}.{name}.bias"])

        qkv = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
        out.update({
            f"{blk}.ln1_scale": w("layer_norm1"),
            f"{blk}.ln1_bias": b("layer_norm1"),
            f"{blk}.wqkv": torch.cat([w(n).T for n in qkv], 1).contiguous(),
            f"{blk}.bqkv": torch.cat([b(n) for n in qkv]),
            f"{blk}.wout": w("self_attn.out_proj").T.contiguous(),
            f"{blk}.bout": b("self_attn.out_proj"),
            f"{blk}.ln2_scale": w("layer_norm2"),
            f"{blk}.ln2_bias": b("layer_norm2"),
            f"{blk}.w1": w("mlp.fc1").T.contiguous(),
            f"{blk}.b1": b("mlp.fc1"),
            f"{blk}.w2": w("mlp.fc2").T.contiguous(),
            f"{blk}.b2": b("mlp.fc2"),
        })
    return out


def _hf_layers_inverse(state: dict, prefix: str, num_layers: int,
                       d: int) -> dict[str, torch.Tensor]:
    out = {}
    for i in range(num_layers):
        enc, blk = f"{prefix}.{i}", f"blocks.{i}"

        def lin(name, w, b):
            out[f"{enc}.{name}.weight"] = _f32(state[f"{blk}.{w}"]).T
            out[f"{enc}.{name}.bias"] = _f32(state[f"{blk}.{b}"])

        for ln in ("1", "2"):
            out[f"{enc}.layer_norm{ln}.weight"] = _f32(
                state[f"{blk}.ln{ln}_scale"])
            out[f"{enc}.layer_norm{ln}.bias"] = _f32(
                state[f"{blk}.ln{ln}_bias"])
        wqkv, bqkv = _f32(state[f"{blk}.wqkv"]), _f32(state[f"{blk}.bqkv"])
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            cols = slice(j * d, (j + 1) * d)
            out[f"{enc}.self_attn.{name}.weight"] = wqkv[:, cols].T
            out[f"{enc}.self_attn.{name}.bias"] = bqkv[cols]
        lin("self_attn.out_proj", "wout", "bout")
        lin("mlp.fc1", "w1", "b1")
        lin("mlp.fc2", "w2", "b2")
    return {k: v.contiguous() for k, v in out.items()}


def hf_clip_vision_params(sd: dict, config: VisionConfig = VIT_B16
                          ) -> dict[str, torch.Tensor]:
    """HF ``CLIPModel`` state dict (tensors or numpy arrays) → the state
    dict of ``VisionTransformer`` at ``config`` (f32): ``vision_model.*``
    and ``visual_projection``."""
    vm = "vision_model"
    out = {
        "patch_embed": _f32(sd[f"{vm}.embeddings.patch_embedding.weight"]),
        "class_embedding": _f32(sd[f"{vm}.embeddings.class_embedding"]),
        "position_embedding": _f32(
            sd[f"{vm}.embeddings.position_embedding.weight"]),
        # HF's key is spelt so
        "pre_ln_scale": _f32(sd[f"{vm}.pre_layrnorm.weight"]),
        "pre_ln_bias": _f32(sd[f"{vm}.pre_layrnorm.bias"]),
        "post_ln_scale": _f32(sd[f"{vm}.post_layernorm.weight"]),
        "post_ln_bias": _f32(sd[f"{vm}.post_layernorm.bias"]),
        "projection": _f32(sd["visual_projection.weight"]).T.contiguous(),
    }
    out.update(_hf_layers(sd, f"{vm}.encoder.layers", config.num_layers))
    return out


def hf_clip_text_params(sd: dict, config: TextConfig = TEXT_B
                        ) -> dict[str, torch.Tensor]:
    """HF ``CLIPModel`` state dict → the state dict of ``TextTransformer``
    at ``config`` (f32): ``text_model.*`` and ``text_projection``."""
    tm = "text_model"
    out = {
        "token_embedding": _f32(sd[f"{tm}.embeddings.token_embedding.weight"]),
        "position_embedding": _f32(
            sd[f"{tm}.embeddings.position_embedding.weight"]),
        "final_ln_scale": _f32(sd[f"{tm}.final_layer_norm.weight"]),
        "final_ln_bias": _f32(sd[f"{tm}.final_layer_norm.bias"]),
        "projection": _f32(sd["text_projection.weight"]).T.contiguous(),
    }
    out.update(_hf_layers(sd, f"{tm}.encoder.layers", config.num_layers))
    return out


def hf_clip_vision_state_dict(state: dict, config: VisionConfig = VIT_B16
                              ) -> dict[str, torch.Tensor]:
    """The port's vision state dict → HF ``CLIPModel`` entries
    (``vision_model.*``, ``visual_projection.weight``; f32), the inverse of
    ``hf_clip_vision_params``."""
    vm = "vision_model"
    out = {
        f"{vm}.embeddings.patch_embedding.weight": _f32(state["patch_embed"]),
        f"{vm}.embeddings.class_embedding": _f32(state["class_embedding"]),
        f"{vm}.embeddings.position_embedding.weight": _f32(
            state["position_embedding"]),
        f"{vm}.pre_layrnorm.weight": _f32(state["pre_ln_scale"]),
        f"{vm}.pre_layrnorm.bias": _f32(state["pre_ln_bias"]),
        f"{vm}.post_layernorm.weight": _f32(state["post_ln_scale"]),
        f"{vm}.post_layernorm.bias": _f32(state["post_ln_bias"]),
        "visual_projection.weight": _f32(state["projection"]).T.contiguous(),
    }
    out.update(_hf_layers_inverse(state, f"{vm}.encoder.layers",
                                  config.num_layers, config.hidden_dim))
    return out


def hf_clip_text_state_dict(state: dict, config: TextConfig = TEXT_B
                            ) -> dict[str, torch.Tensor]:
    """The port's text state dict → HF ``CLIPModel`` entries
    (``text_model.*``, ``text_projection.weight``; f32), the inverse of
    ``hf_clip_text_params``."""
    tm = "text_model"
    out = {
        f"{tm}.embeddings.token_embedding.weight": _f32(
            state["token_embedding"]),
        f"{tm}.embeddings.position_embedding.weight": _f32(
            state["position_embedding"]),
        f"{tm}.final_layer_norm.weight": _f32(state["final_ln_scale"]),
        f"{tm}.final_layer_norm.bias": _f32(state["final_ln_bias"]),
        "text_projection.weight": _f32(state["projection"]).T.contiguous(),
    }
    out.update(_hf_layers_inverse(state, f"{tm}.encoder.layers",
                                  config.num_layers, config.hidden_dim))
    return out


def load_hf_clip_params(checkpoint_dir: str,
                        config: VisionConfig = VIT_B16
                        ) -> dict[str, torch.Tensor]:
    """A local HF CLIP directory → the vision tower's state dict."""
    return hf_clip_vision_params(read_hf_state_dict(checkpoint_dir), config)


def load_hf_clip_text_params(checkpoint_dir: str,
                             config: TextConfig = TEXT_B
                             ) -> dict[str, torch.Tensor]:
    """A local HF CLIP directory → the text tower's state dict."""
    return hf_clip_text_params(read_hf_state_dict(checkpoint_dir), config)
