"""Int8 post-training-quantized ViT tower for serving (port of
patent_tpu/models/vit_int8.py).

The dense layers of every transformer layer run as int8 x int8 → int32
matmuls with per-output-channel weight scales (static, from the float
weights) and per-row activation scales (dynamic), through
``ops/quant_matmul``.  The patch embedding (bf16), the LayerNorms, the
softmax and the projection (f32) stay in floating point.

The stack: the token axis padded once to a multiple of 16 (197 → 208,
``keep_tokens=127`` → 128), layers 0..N-2 as ``quant_attention_block``
then ``quant_mlp_block`` with ``valid_len``, the last layer as
``quant_attention_cls`` then ``quant_mlp_block`` on the [B, D] CLS rows,
then post-LN and the projection in f32.  The residual stream between the
sub-layers is bf16, as the TPU kernels store it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import quant_matmul as qm
from .vit import VIT_B16, TowerBase, VisionConfig

# (float state-dict name, int8 [out, in] name, scale name) per matrix
QUANTIZED_MATRICES = (("wqkv", "wqkv_t", "sqkv"), ("wout", "wout_t", "sout"),
                      ("w1", "w1_t", "s1"), ("w2", "w2_t", "s2"))
FLOAT_VECTORS = ("ln1_scale", "ln1_bias", "bqkv", "bout", "ln2_scale",
                 "ln2_bias", "b1", "b2")


class Int8Layer(nn.Module):
    """Buffers of one int8 layer: matrices int8 [out, in] (K-major, as the
    tensor cores take them), scales, biases and LayerNorm vectors f32."""

    def __init__(self, d: int, mlp: int, device=None):
        super().__init__()
        shapes = {"wqkv_t": (3 * d, d), "wout_t": (d, d), "w1_t": (mlp, d),
                  "w2_t": (d, mlp)}
        for _f, name, scale in QUANTIZED_MATRICES:
            rows = shapes[name][0]
            self.register_buffer(name, torch.zeros(
                shapes[name], dtype=torch.int8, device=device))
            self.register_buffer(scale, torch.ones(rows, device=device))
        for name in FLOAT_VECTORS:
            n = {"bqkv": 3 * d, "b1": mlp}.get(name, d)
            self.register_buffer(name, torch.zeros(n, device=device))

    def attn_weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln1_scale, self.ln1_bias, self.wqkv_t, self.sqkv,
                self.bqkv, self.wout_t, self.sout, self.bout)

    def mlp_weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln2_scale, self.ln2_bias, self.w1_t, self.s1, self.b1,
                self.w2_t, self.s2, self.b2)


def quantize_vit_params(state_dict: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """Float ``VisionTransformer`` state dict → ``Int8VisionTransformer``
    state dict: each layer matrix through ``quantize_weight`` (from its f32
    values) and transposed to [out, in]; everything else as f32."""
    out = {}
    for key, value in state_dict.items():
        prefix, _, name = key.rpartition(".")
        matrix = {f: (q, s) for f, q, s in QUANTIZED_MATRICES}.get(name)
        if key.startswith("blocks.") and matrix is not None:
            q, scale = qm.quantize_weight(value)
            out[f"{prefix}.{matrix[0]}"] = q.T.contiguous()
            out[f"{prefix}.{matrix[1]}"] = scale
        else:
            out[key] = value.detach().float().clone()
    return out


class Int8VisionTransformer(TowerBase):
    """Int8 serving twin of ``VisionTransformer`` (same config, embeddings
    and read-out).  ``kernels=False`` runs the sub-layers' plain PyTorch
    versions on any device; ``kernels=True`` lets each call dispatch on
    the tensor's device.  Build one from a float tower with
    ``from_float``."""

    def __init__(self, config: VisionConfig = VIT_B16,
                 keep_tokens: int | None = None, kernels: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(config, torch.bfloat16, keep_tokens, kernels,
                         device, generator)

    def _blocks(self, device, generator) -> nn.ModuleList:
        cfg = self.config
        return nn.ModuleList(Int8Layer(cfg.hidden_dim, cfg.mlp_dim, device)
                             for _ in range(cfg.num_layers))

    @classmethod
    def from_float(cls, tower: TowerBase) -> "Int8VisionTransformer":
        """The int8 tower of a float tower's weights (quantized from their
        values as held: f32 weights give the JAX package's int8 weights),
        on the float tower's device, with its keep_tokens and kernels."""
        model = cls(tower.config, keep_tokens=tower.keep_tokens,
                    kernels=tower.kernels,
                    device=tower.patch_embed.device)
        model.load_state_dict(quantize_vit_params(tower.state_dict()))
        return model

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → [B, projection]."""
        cfg = self.config
        x, seq = self.embed(pixel_values)
        if self.kernels:
            attn, attn_cls, mlp = (qm.quant_attention_block,
                                   qm.quant_attention_cls, qm.quant_mlp_block)
        else:
            attn, attn_cls, mlp = (qm.quant_attention_block_plain,
                                   qm.quant_attention_cls_plain,
                                   qm.quant_mlp_block_plain)
        for i, layer in enumerate(self.blocks):
            fn = attn_cls if i == cfg.num_layers - 1 else attn
            x = fn(x, *layer.attn_weights(), cfg.num_heads, valid_len=seq)
            x = mlp(x, *layer.mlp_weights())
        return self.readout(x)
