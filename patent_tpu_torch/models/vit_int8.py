"""Int8 post-training-quantized ViT tower for serving (port of
patent_tpu/models/vit_int8.py).

The dense layers of every transformer layer run as int8 x int8 → int32
matmuls with per-output-channel weight scales (static, from the float
weights) and per-row activation scales (dynamic), through
``ops/quant_matmul``.  The patch embedding (bf16), the LayerNorms, the
softmax and the projection (f32) stay in floating point.

The stack: the token axis padded once to a multiple of 16 (197 → 208,
``keep_tokens=127`` → 128), then layers 0..N-2 with ``valid_len``, the
last layer as ``quant_attention_cls`` then ``quant_mlp_block`` on the
[B, D] CLS rows, then post-LN and the projection in f32.  Layers 0..N-2
depend on the batch, as the JAX tower's do
(patent_tpu/models/vit_int8.py:245):

* B % 4 == 0: ``quant_attention_block`` then ``quant_mlp_block``, with the
  residual between the two sub-layers stored in bf16;
* otherwise: ``quant_layer_block``, the whole layer, with that residual
  kept in f32 (LN2 reads it unrounded).

This split is a numerical contract of the JAX tower, not a tiling dial:
on a bf16 stream the two compute different functions (a rounded mid
residual flips LN2's int8 codes; tests/test_torch_int8_layer.py measures
the gap), so the port makes the same choice although it ports none of the
TPU kernels' ``group`` tiling.  Pad rows do not matter to it: the JAX
tower pads 197 tokens to 224 at a ragged batch, the port to 208, and the
valid rows see the same keys.
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
    tensor cores take them), scales, biases and LayerNorm vectors f32.

    It also holds the QKV dequant scale and bias with log2(e)/√hd folded
    into the q columns (``quant_matmul.fold_q_scale``), as buffers that the
    state dict leaves out: made at init and again in each
    ``load_state_dict``, so the kernels need not fold per call.  Edit the
    vectors through ``load_state_dict``."""

    def __init__(self, d: int, mlp: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
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
        for name, t in zip(("sq", "bq"), qm.fold_q_scale(
                self.sqkv, self.bqkv, num_heads)):
            self.register_buffer(name, t, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        with torch.no_grad():
            for name, t in zip(("sq", "bq"), qm.fold_q_scale(
                    self.sqkv, self.bqkv, self.num_heads)):
                getattr(self, name).copy_(t)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded QKV scale and bias, for the entries' ``folded``."""
        return self.sq, self.bq

    def attn_weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln1_scale, self.ln1_bias, self.wqkv_t, self.sqkv,
                self.bqkv, self.wout_t, self.sout, self.bout)

    def mlp_weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln2_scale, self.ln2_bias, self.w1_t, self.s1, self.b1,
                self.w2_t, self.s2, self.b2)


def int8_dense(x: torch.Tensor, w_t: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
    """Per-row dynamic int8 quantization of x, the int8 product with w_t
    ([out, in]) and the dequant + bias, in x's dtype
    (``ops/quant_matmul.quant_dense``)."""
    return qm.quant_dense(x, w_t, w_scale, bias)


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
    the tensor's device.  Its int8 kernels' form is the entries' default
    (``ops/quant_matmul.py``): on the card the fast form unless
    PATENT_TPU_FAST_KERNELS=0, as JAX's tower on its TPU; on the CPU the
    exact form.  Build one from a float tower with ``from_float``."""

    batch_multiple = 4        # rows 5 + 7 where 4 divides B, else row 8

    def __init__(self, config: VisionConfig = VIT_B16,
                 keep_tokens: int | None = None, kernels: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(config, torch.bfloat16, keep_tokens, kernels,
                         device, generator)

    def _blocks(self, device, generator) -> nn.ModuleList:
        cfg = self.config
        return nn.ModuleList(Int8Layer(cfg.hidden_dim, cfg.mlp_dim,
                                       cfg.num_heads, device)
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
            attn, attn_cls, mlp, whole = (
                qm.quant_attention_block, qm.quant_attention_cls,
                qm.quant_mlp_block, qm.quant_layer_block)
        else:
            attn, attn_cls, mlp, whole = (
                qm.quant_attention_block_plain, qm.quant_attention_cls_plain,
                qm.quant_mlp_block_plain, qm.quant_layer_block_plain)
        ragged = x.shape[0] % self.batch_multiple != 0
        for i, layer in enumerate(self.blocks):
            last = i == cfg.num_layers - 1
            if ragged and not last:
                x = whole(x, *layer.attn_weights(), *layer.mlp_weights(),
                          cfg.num_heads, valid_len=seq,
                          folded=layer.folded())
            else:
                x = (attn_cls if last else attn)(
                    x, *layer.attn_weights(), cfg.num_heads, valid_len=seq,
                    folded=layer.folded())
                x = mlp(x, *layer.mlp_weights())
        return self.readout(x)
