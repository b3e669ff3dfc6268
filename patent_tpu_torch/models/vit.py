"""CLIP ViT image tower for serving (port of the image path of
patent_tpu/models/vit.py with ``fused_layer=True``), and the parts it
shares with the int8 tower (models/vit_int8.py).

Layouts follow the JAX package at the public surface: pixels NHWC
[B, H, W, 3], weights [in, out] as in the Flax tree, activations [B, S, D].
The patch embedding is a strided convolution (``F.conv2d``); the stack runs
``ops/bf16_layer``: the token axis is padded once to a multiple of 16,
layers 0..N-2 run ``fused_layer_block_bf16`` with ``valid_len``, and the
last layer runs ``fused_layer_cls_bf16``, which returns [B, D].
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bf16_layer
from ..ops.common import layernorm_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    projection_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# ViT-B/16 (openai/clip-vit-base-patch16)
VIT_B16 = VisionConfig()
VIT_TINY = VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                        num_layers=2, num_heads=4, mlp_dim=128,
                        projection_dim=32)


def ink_topk_indices(pixel_values: torch.Tensor, patch_size: int,
                     keep: int) -> torch.Tensor:
    """[B, H, W, C] pixels → [B, keep] indices of the darkest patches,
    ascending (spatial order kept).  Ties go to the lower patch index, as
    ``lax.top_k`` breaks them."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch_size, w // patch_size
    x = pixel_values.float().reshape(b, gh, patch_size, gw, patch_size, c)
    brightness = x.sum(dim=(2, 4, 5)).reshape(b, gh * gw)
    order = torch.sort(brightness, dim=1, stable=True).indices
    return torch.sort(order[:, :keep], dim=1).values


def assemble_token_stream(x: torch.Tensor, pixel_values: torch.Tensor,
                          cfg: VisionConfig, cls_row: torch.Tensor,
                          pos: torch.Tensor,
                          keep_tokens: int | None) -> torch.Tensor:
    """CLS + position embeddings.  x [B, P, D] patch embeddings, pos
    [P+1, D] (row 0 is CLS's), cls_row [B, 1, D].  With ``keep_tokens`` <
    P only the darkest patches (``ink_topk_indices``) are kept."""
    if keep_tokens is not None and keep_tokens < cfg.num_patches:
        idx = ink_topk_indices(pixel_values, cfg.patch_size, keep_tokens)
        gathered = torch.gather(
            x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        gpos = pos[idx + 1]
        return torch.cat([cls_row + pos[None, :1], gathered + gpos], dim=1)
    return torch.cat([cls_row, x], dim=1) + pos


class EncoderLayer(nn.Module):
    """Parameters of one pre-LN layer, in the Flax layout.  The four
    matrices are held in ``dtype`` (what the layer computes with, so the
    kernels take them without a cast); LayerNorm vectors and biases in
    f32."""

    def __init__(self, d: int, mlp: int, dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        super().__init__()

        def dense(fan_in, shape):
            return nn.Parameter((torch.randn(
                shape, generator=generator, device=device)
                / math.sqrt(fan_in)).to(dtype))

        def vec(n, fill):
            return nn.Parameter(torch.full((n,), fill, device=device))

        self.ln1_scale, self.ln1_bias = vec(d, 1.0), vec(d, 0.0)
        self.wqkv, self.bqkv = dense(d, (d, 3 * d)), vec(3 * d, 0.0)
        self.wout, self.bout = dense(d, (d, d)), vec(d, 0.0)
        self.ln2_scale, self.ln2_bias = vec(d, 1.0), vec(d, 0.0)
        self.w1, self.b1 = dense(d, (d, mlp)), vec(mlp, 0.0)
        self.w2, self.b2 = dense(mlp, (mlp, d)), vec(d, 0.0)

    def weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln1_scale, self.ln1_bias, self.wqkv, self.bqkv,
                self.wout, self.bout, self.ln2_scale, self.ln2_bias,
                self.w1, self.b1, self.w2, self.b2)


class TowerBase(nn.Module):
    """What the bf16 and the int8 towers share: the patch embedding, CLS
    and position embeddings, pre-LN, the token stream padded once to a
    multiple of 16, post-LN and the projection, in the Flax layout.
    Subclasses build ``self.blocks`` in ``_blocks`` and run them in
    ``forward``.  Weights are random (from ``generator``) until a state
    dict is loaded."""

    def __init__(self, config: VisionConfig, dtype: torch.dtype,
                 keep_tokens: int | None, kernels: bool, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.keep_tokens = keep_tokens
        self.kernels = kernels
        d, p = config.hidden_dim, config.patch_size
        self.patch_embed = nn.Parameter(torch.randn(
            (d, 3, p, p), generator=generator, device=device)
            / math.sqrt(3 * p * p))
        self.class_embedding = nn.Parameter(0.02 * torch.randn(
            (d,), generator=generator, device=device))
        self.position_embedding = nn.Parameter(0.01 * torch.randn(
            (config.num_patches + 1, d), generator=generator, device=device))
        self.pre_ln_scale = nn.Parameter(torch.ones(d, device=device))
        self.pre_ln_bias = nn.Parameter(torch.zeros(d, device=device))
        self.blocks = self._blocks(device, generator)
        self.post_ln_scale = nn.Parameter(torch.ones(d, device=device))
        self.post_ln_bias = nn.Parameter(torch.zeros(d, device=device))
        self.projection = nn.Parameter(torch.randn(
            (d, config.projection_dim), generator=generator, device=device)
            / math.sqrt(d))

    def _blocks(self, device, generator) -> nn.ModuleList:
        raise NotImplementedError

    def embed(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, int]:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → (token stream
        [B, S, D] in ``dtype``, the token axis padded to a multiple of 16;
        the true length S)."""
        cfg, cdt = self.config, self.dtype
        p = cfg.patch_size
        x = F.conv2d(pixel_values.to(cdt).permute(0, 3, 1, 2),
                     self.patch_embed.to(cdt), stride=p)   # [B, D, gh, gw]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                   # [B, P, D]
        cls_row = self.class_embedding.to(cdt).expand(b, 1, -1)
        x = assemble_token_stream(x, pixel_values, cfg, cls_row,
                                  self.position_embedding.to(cdt),
                                  self.keep_tokens)
        x = layernorm_f32(x, self.pre_ln_scale, self.pre_ln_bias)
        seq = x.shape[1]
        x = F.pad(x.to(cdt), (0, 0, 0, bf16_layer.required_seq_pad_bf16(seq)
                              - seq)).contiguous()
        return x, seq

    def readout(self, cls: torch.Tensor) -> torch.Tensor:
        """CLS rows [B, D] → features [B, projection] (post-LN and the
        projection in f32)."""
        x = layernorm_f32(cls, self.post_ln_scale, self.post_ln_bias)
        return x @ self.projection.float()


class VisionTransformer(TowerBase):
    """CLIP vision tower → projected image features.

    ``dtype``: the compute dtype of the stack (bf16 for serving; the CUDA
    layer kernels take bf16 only).  ``kernels=False`` runs the layers'
    plain PyTorch versions on any device (the card's reference for timing
    and checks); ``kernels=True`` lets each layer call dispatch on the
    tensor's device (kernel on CUDA, plain version on the CPU).
    ``keep_tokens``: serve only the K darkest patches plus CLS.  The
    layers' matrices are held in ``dtype`` and ``load_state_dict`` casts
    f32 ones on the way in, once."""

    def __init__(self, config: VisionConfig = VIT_B16,
                 dtype: torch.dtype = torch.bfloat16,
                 keep_tokens: int | None = None, kernels: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(config, dtype, keep_tokens, kernels, device,
                         generator)

    def _blocks(self, device, generator) -> nn.ModuleList:
        cfg = self.config
        return nn.ModuleList(
            EncoderLayer(cfg.hidden_dim, cfg.mlp_dim, self.dtype, device,
                         generator)
            for _ in range(cfg.num_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → [B, projection]."""
        cfg = self.config
        x, seq = self.embed(pixel_values)
        if self.kernels:
            block, last = (bf16_layer.fused_layer_block_bf16,
                           bf16_layer.fused_layer_cls_bf16)
        else:
            block, last = (bf16_layer.fused_layer_block_bf16_plain,
                           bf16_layer.fused_layer_cls_bf16_plain)
        for i, layer in enumerate(self.blocks):
            fn = last if i == cfg.num_layers - 1 else block
            x = fn(x, *layer.weights(), cfg.num_heads, valid_len=seq)
        return self.readout(x)
