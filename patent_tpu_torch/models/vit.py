"""CLIP towers (port of patent_tpu/models/vit.py): the serving tower
``VisionTransformer`` in its fused-layer mode and its per-op modes, the
parts it shares with the int8 tower (models/vit_int8.py), the trainable
tower of the fine-tune (``TrainableVisionTransformer``) and the text tower
(``TextTransformer``).  The HF CLIP checkpoint converters are in
models/clip_import.py.

Layouts follow the JAX package at the public surface: pixels NHWC
[B, H, W, 3], weights [in, out] as in the Flax tree, activations [B, S, D].
The patch embedding is a strided convolution (``F.conv2d``).  The
fused-layer stack (``fused_layer=True``, the port's default) runs
``ops/bf16_layer``: the token axis is padded once to a multiple of 16,
layers 0..N-2 run ``fused_layer_block_bf16`` with ``valid_len``, and the
last layer runs ``fused_layer_cls_bf16``, which returns [B, D].  The per-op
stack (``fused_layer=False``, the JAX module's default) runs
``transformer_block`` on every layer, with the attention of ``attention``:
an einsum softmax, ``flash_attention`` (``use_flash``, TPU row 14) or
``fused_attention_block`` (``fused_block``, row 12's forward).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import bf16_layer
from ..ops import flash_attention as fa
from ..ops.common import (dense, einsum_attention, layernorm_f32,
                          quick_gelu)


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


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_dim: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    projection_dim: int = 512


# ViT-B/16 (openai/clip-vit-base-patch16) and its text tower
VIT_B16 = VisionConfig()
TEXT_B = TextConfig()
VIT_TINY = VisionConfig(image_size=32, patch_size=8, hidden_dim=64,
                        num_layers=2, num_heads=4, mlp_dim=128,
                        projection_dim=32)
TEXT_TINY = TextConfig(vocab_size=128, context_length=16, hidden_dim=64,
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
    f32.

    With ``num_heads`` the layer also holds its matrices in the fused-layer
    kernels' form (``bf16_layer.fold_layer``: transposed, log2(e)/√hd
    folded into the q rows) as buffers that the state dict leaves out.
    They are made from the f32 values, once at init and once in each
    ``load_state_dict``, since folding the ``dtype`` copy would round
    twice; edit the matrices through ``load_state_dict``.  The q bias is
    folded per call from the f32 ``bqkv`` (``folded``)."""

    _MATRICES = ("wqkv_t", "wout_t", "w1_t", "w2_t")

    def __init__(self, d: int, mlp: int, dtype: torch.dtype = torch.float32,
                 device=None, generator=None, num_heads: int | None = None):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads

        def dense(fan_in, shape):
            return torch.randn(shape, generator=generator,
                               device=device) / math.sqrt(fan_in)

        def vec(n, fill):
            return nn.Parameter(torch.full((n,), fill, device=device))

        def mat(w):
            return nn.Parameter(w.to(dtype))

        wqkv, wout = dense(d, (d, 3 * d)), dense(d, (d, d))
        w1, w2 = dense(d, (d, mlp)), dense(mlp, (mlp, d))
        self.ln1_scale, self.ln1_bias = vec(d, 1.0), vec(d, 0.0)
        self.wqkv, self.bqkv = mat(wqkv), vec(3 * d, 0.0)
        self.wout, self.bout = mat(wout), vec(d, 0.0)
        self.ln2_scale, self.ln2_bias = vec(d, 1.0), vec(d, 0.0)
        self.w1, self.b1 = mat(w1), vec(mlp, 0.0)
        self.w2, self.b2 = mat(w2), vec(d, 0.0)
        if num_heads is not None:
            for name, t in zip(self._MATRICES,
                               self._fold(wqkv, wout, w1, w2)):
                self.register_buffer(name, t, persistent=False)

    def _fold(self, wqkv, wout, w1, w2) -> tuple[torch.Tensor, ...]:
        """The kernels' matrices from these (f32) values."""
        def t(w):
            return w.detach().to(self.dtype).T.contiguous()

        return (bf16_layer.fold_q_matrix(wqkv.detach(), self.num_heads,
                                         self.dtype).T.contiguous(),
                t(wout), t(w1), t(w2))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        mats = [state_dict.get(prefix + n) for n in ("wqkv", "wout", "w1",
                                                     "w2")]
        if self.num_heads is not None and all(m is not None for m in mats):
            with torch.no_grad():
                for name, t in zip(self._MATRICES, self._fold(*mats)):
                    getattr(self, name).copy_(t)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def weights(self) -> tuple[torch.Tensor, ...]:
        return (self.ln1_scale, self.ln1_bias, self.wqkv, self.bqkv,
                self.wout, self.bout, self.ln2_scale, self.ln2_bias,
                self.w1, self.b1, self.w2, self.b2)

    def folded(self) -> bf16_layer.FoldedLayer:
        """The weights in the fused-layer kernels' form (``num_heads``)."""
        return bf16_layer.FoldedLayer(
            self.ln1_scale, self.ln1_bias, self.wqkv_t,
            bf16_layer.fold_q_bias(self.bqkv, self.num_heads), self.wout_t,
            self.bout, self.ln2_scale, self.ln2_bias, self.w1_t, self.b1,
            self.w2_t, self.b2)


class TowerBase(nn.Module):
    """What the bf16 and the int8 towers share: the patch embedding, CLS
    and position embeddings, pre-LN, the token stream padded once to a
    multiple of 16, post-LN and the projection, in the Flax layout.
    Subclasses build ``self.blocks`` in ``_blocks`` and run them in
    ``forward``.  Weights are random (from ``generator``) until a state
    dict is loaded."""

    # the batch multiple at which the tower changes function (JAX's towers
    # dispatch on the batch): a sharded encode pads each rank's rows to
    # keep the global batch's (parallel/mesh.py::encode_sharded)
    batch_multiple = 1

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

    def tokens(self, pixel_values: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → the token stream
        [B, S, D] in ``dtype`` before pre-LN: patch embeddings, CLS and the
        position embeddings (``keep_tokens`` applied)."""
        cfg = self.config
        x = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2),
                     self.patch_embed.to(dtype),
                     stride=cfg.patch_size)                # [B, D, gh, gw]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                   # [B, P, D]
        cls_row = self.class_embedding.to(dtype).expand(b, 1, -1)
        return assemble_token_stream(x, pixel_values, cfg, cls_row,
                                     self.position_embedding.to(dtype),
                                     self.keep_tokens)

    def embed(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, int]:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → (token stream
        [B, S, D] in ``dtype`` after pre-LN, the token axis padded to a
        multiple of 16; the true length S)."""
        cdt = self.dtype
        x = layernorm_f32(self.tokens(pixel_values, cdt), self.pre_ln_scale,
                          self.pre_ln_bias)
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
    kernels take bf16 only).  ``kernels=False`` runs the layers'
    plain PyTorch versions on any device (the card's reference for timing
    and checks); ``kernels=True`` lets each layer call dispatch on the
    tensor's device (kernel on CUDA, plain version on the CPU).
    ``keep_tokens``: serve only the K darkest patches plus CLS.  The
    layers' matrices are held in ``dtype`` and ``load_state_dict`` casts
    f32 ones on the way in, once; the fused-layer stack reads its folded
    copies (``EncoderLayer.folded``), made from the same f32 values.

    Modes, with the JAX module's flags and precedence: ``fused_layer``
    (the default here; JAX's default is the per-op stack) beats the
    per-op stack, and in the per-op attention ``fused_block`` beats
    ``use_flash``.  The per-op stack keeps the residual stream in f32 (its
    LayerNorms are Flax's, in f32, and each dense layer returns
    ``dtype``), runs every layer over every row of the unpadded stream, and
    reads out CLS after the last.  Every mode has the same parameters.

    ``remat`` (training only, as in JAX): while autograd records, each
    layer runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward instead of keeping its activations; the outputs and the
    gradients are those of ``remat=False``."""

    def __init__(self, config: VisionConfig = VIT_B16,
                 dtype: torch.dtype = torch.bfloat16,
                 keep_tokens: int | None = None, kernels: bool = True,
                 device=None, generator: torch.Generator | None = None,
                 use_flash: bool = False, fused_block: bool = False,
                 fused_layer: bool = True, remat: bool = False):
        super().__init__(config, dtype, keep_tokens, kernels, device,
                         generator)
        self.use_flash = use_flash
        self.fused_block = fused_block
        self.fused_layer = fused_layer
        self.remat = remat

    @property
    def batch_multiple(self) -> int:
        """The fused-layer pair runs at even batches only (an odd batch
        takes the per-op composition); the per-op stack at any batch."""
        return bf16_layer.GROUP if self.fused_layer else 1

    def _layer(self, fn, *args, **kwargs) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return fn(*args, **kwargs)

    def _blocks(self, device, generator) -> nn.ModuleList:
        cfg = self.config
        return nn.ModuleList(
            EncoderLayer(cfg.hidden_dim, cfg.mlp_dim, self.dtype, device,
                         generator, num_heads=cfg.num_heads)
            for _ in range(cfg.num_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → [B, projection]."""
        if not self.fused_layer:
            return self._per_op(pixel_values)
        cfg = self.config
        x, seq = self.embed(pixel_values)
        # both pairs dispatch on the batch as JAX does: at an odd batch
        # every layer is the per-op composition (no kernel)
        if self.kernels:
            block, last = (bf16_layer.fused_layer_block_bf16,
                           bf16_layer.fused_layer_cls_bf16)
        else:
            block, last = (bf16_layer.fused_layer_block_bf16_plain,
                           bf16_layer.fused_layer_cls_bf16_plain)
        for i, layer in enumerate(self.blocks):
            fn = last if i == cfg.num_layers - 1 else block
            x = self._layer(fn, x, *layer.weights(), cfg.num_heads,
                            valid_len=seq, folded=layer.folded())
        return self.readout(x)

    def _per_op(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = layernorm_flax(self.tokens(pixel_values, self.dtype),
                           self.pre_ln_scale, self.pre_ln_bias)
        for layer in self.blocks:
            x = self._layer(transformer_block, x, layer, cfg.num_heads,
                            self.dtype, use_flash=self.use_flash,
                            fused_block=self.fused_block,
                            kernels=self.kernels)
        x = layernorm_flax(x[:, 0], self.post_ln_scale, self.post_ln_bias)
        return x @ self.projection.float()


def attention(x: torch.Tensor, wqkv, bqkv, wout, bout, num_heads: int,
              dtype: torch.dtype, mask: torch.Tensor | None = None,
              use_flash: bool = False, fused_block: bool = False,
              kernels: bool = True) -> torch.Tensor:
    """The per-op attention sub-layer (port of the JAX ``Attention``
    module): x [B, S, D] → [B, S, D] in ``dtype``, pre-residual.  Without
    a mask, ``fused_block`` runs ``fused_attention_block`` (row 12) and
    ``use_flash`` runs ``flash_attention`` (row 14) on q, k, v [B, S, H,
    hd]; otherwise an einsum softmax: scores in f32 (JAX scales q by a
    numpy scalar, which promotes them), ``mask`` added, an f32 softmax
    rounded to ``dtype`` before p·v.  ``kernels=False`` takes the kernels'
    plain versions on any device."""
    d = x.shape[-1]
    if fused_block and mask is None:
        return fa.fused_attention_block(
            x.to(dtype), wqkv.to(dtype), bqkv.to(dtype), wout.to(dtype),
            bout.to(dtype), num_heads, kernels=kernels)
    q, k, v = (t.unflatten(-1, (num_heads, d // num_heads))
               for t in dense(x, wqkv, bqkv, dtype).split(d, dim=-1))
    if use_flash and mask is None and q.dim() == 4:
        out = (fa.flash_attention if kernels else fa.flash_attention_plain)(
            q, k, v)
    else:
        out = einsum_attention(q, k, v, dtype, mask)
    return dense(out.flatten(-2), wout, bout, dtype)


def transformer_block(x: torch.Tensor, layer: EncoderLayer, num_heads: int,
                      dtype: torch.dtype, mask: torch.Tensor | None = None,
                      use_flash: bool = False, fused_block: bool = False,
                      kernels: bool = True) -> torch.Tensor:
    """One per-op pre-LN layer (port of the JAX ``TransformerBlock``'s
    default path): ``x + attn(LN1(x))``, then ``· + mlp(LN2(·))``, with
    Flax's f32 LayerNorms, dense layers in ``dtype`` and quick_gelu in
    ``dtype``; each residual add promotes to x's dtype or wider."""
    h = layernorm_flax(x, layer.ln1_scale, layer.ln1_bias)
    x = x + attention(h, layer.wqkv, layer.bqkv, layer.wout, layer.bout,
                      num_heads, dtype, mask, use_flash, fused_block,
                      kernels)
    h = layernorm_flax(x, layer.ln2_scale, layer.ln2_bias)
    h = quick_gelu(dense(h, layer.w1, layer.b1, dtype))
    return x + dense(h, layer.w2, layer.b2, dtype)


def layernorm_flax(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Flax ``nn.LayerNorm(dtype=float32)`` as the JAX tower computes it:
    f32 statistics with the fast variance E[x²] − E[x]² (clipped at 0),
    then ``(x − mean) · (rsqrt(var + eps) · scale) + bias``, in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()


def cls_last_layer(x, ln1_s, ln1_b, wqkv, bqkv, wout, bout, ln2_s, ln2_b,
                   w1, b1, w2, b2, num_heads: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The trainable last layer for the CLS row only (port of
    patent_tpu/models/vit.py ``_cls_last_layer``): [B, S, D] → [B, 1, D].
    LN1 and the K/V projections run over every row, the rest for row 0;
    gradient-exact, since only row 0 reaches the read-out.  Plain PyTorch
    with autograd (the TPU package has no kernel here): f32 LayerNorms and
    residual, products in ``dtype``."""
    b, s, d = x.shape
    hd = d // num_heads
    h = layernorm_f32(x, ln1_s, ln1_b).to(dtype)
    kv = h @ wqkv[:, d:].to(dtype) + bqkv[d:].to(dtype)
    q = h[:, :1] @ wqkv[:, :d].to(dtype) + bqkv[:d].to(dtype)
    k, v = kv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, -1, num_heads, hd)

    # the JAX layer scales q by a numpy scalar, which promotes the scores
    # to f32
    attn = torch.einsum("bqhd,bkhd->bhqk",
                        heads(q).float() * (1.0 / math.sqrt(hd)),
                        heads(k).float())
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, heads(v)).reshape(b, 1, d)
    x1 = x[:, :1] + o @ wout.to(dtype) + bout.to(dtype)
    h2 = layernorm_f32(x1, ln2_s, ln2_b).to(dtype)
    g = (h2 @ w1.to(dtype)).float() + b1.float()
    a = (g * torch.sigmoid(1.702 * g)).to(dtype)
    out = (a @ w2.to(dtype)).float() + b2.float()
    return (x1.float() + out).to(x.dtype)


class TrainableVisionTransformer(TowerBase):
    """The fine-tune tower (the JAX ``VisionTransformer`` with
    ``fused_block=True, fused_mlp=True, cls_last=True``): the serving
    tower's parameters and state-dict names, held as f32 masters and cast
    to bf16 each step where the Flax modules cast them.

    Layers 0..N-2 run ``fused_attention_block`` on LN1(x) plus the
    residual, then ``fused_mlp_block_bf16``; the last layer is
    ``cls_last_layer``.  The token stream is not padded here: the attention
    sub-layer pads per call and slices back, so pad rows get no cotangent.
    ``kernels=False`` runs the plain versions of the four kernels on any
    device; ``kernels=True`` dispatches on the tensor's device (kernel on
    CUDA, plain version on the CPU)."""

    def __init__(self, config: VisionConfig = VIT_B16,
                 keep_tokens: int | None = None, kernels: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(config, torch.float32, keep_tokens, kernels, device,
                         generator)
        self.compute_dtype = torch.bfloat16

    def _blocks(self, device, generator) -> nn.ModuleList:
        cfg = self.config
        return nn.ModuleList(
            EncoderLayer(cfg.hidden_dim, cfg.mlp_dim, torch.float32, device,
                         generator)
            for _ in range(cfg.num_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (NHWC, normalized) → [B, projection]
        (f32)."""
        from ..ops.bf16_mlp_grad import fused_mlp_block_bf16

        cfg, cdt = self.config, self.compute_dtype
        x = layernorm_flax(self.tokens(pixel_values, cdt), self.pre_ln_scale,
                           self.pre_ln_bias)
        for layer in self.blocks[:-1]:
            h = layernorm_flax(x, layer.ln1_scale, layer.ln1_bias)
            x = x + fa.fused_attention_block(
                h.to(cdt), layer.wqkv.to(cdt), layer.bqkv.to(cdt),
                layer.wout.to(cdt), layer.bout.to(cdt), cfg.num_heads,
                kernels=self.kernels)
            x = fused_mlp_block_bf16(x.to(cdt), layer.ln2_scale,
                                     layer.ln2_bias, layer.w1, layer.b1,
                                     layer.w2, layer.b2,
                                     kernels=self.kernels)
        x = cls_last_layer(x, *self.blocks[-1].weights(), cfg.num_heads, cdt)
        x = layernorm_flax(x[:, 0], self.post_ln_scale, self.post_ln_bias)
        return x @ self.projection


def causal_mask(length: int, device=None) -> torch.Tensor:
    """The text tower's additive mask [L, L]: -1e9 above the diagonal, in
    f32 (added to the f32 scores)."""
    return torch.triu(torch.full((length, length), -1e9, device=device), 1)


class TextTransformer(nn.Module):
    """CLIP text tower → projected text features (port of the JAX
    ``TextTransformer``, ``get_text_features``): CPC definitions and
    patent titles become node features of the graph.

    ``token_embedding[ids]`` plus ``position_embedding[:L]``, both in
    ``dtype``; ``num_layers`` per-op pre-LN layers (``transformer_block``)
    under the causal mask, which sends every attention to the einsum path
    (the JAX tower reaches no Pallas kernel either); Flax's f32 final
    LayerNorm; pooling at the first maximal id of each row (EOS); the
    projection in f32, without a bias.  Weights are random (from
    ``generator``: normal 0.02 and 0.01 for the embeddings, 1/√fan_in for
    the dense layers) until a state dict is loaded
    (``weights.text_params_from_jax``, ``clip_import.hf_clip_text_params``).
    """

    def __init__(self, config: TextConfig = TEXT_B,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_dim
        self.token_embedding = nn.Parameter(0.02 * torch.randn(
            (config.vocab_size, d), generator=generator, device=device))
        self.position_embedding = nn.Parameter(0.01 * torch.randn(
            (config.context_length, d), generator=generator, device=device))
        self.blocks = nn.ModuleList(
            EncoderLayer(d, config.mlp_dim, dtype, device, generator)
            for _ in range(config.num_layers))
        self.final_ln_scale = nn.Parameter(torch.ones(d, device=device))
        self.final_ln_bias = nn.Parameter(torch.zeros(d, device=device))
        self.projection = nn.Parameter(torch.randn(
            (d, config.projection_dim), generator=generator, device=device)
            / math.sqrt(d))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] → the token stream [B, L, D] in ``dtype``."""
        ids = input_ids.long()
        return (self.token_embedding[ids].to(self.dtype)
                + self.position_embedding[:ids.shape[1]].to(self.dtype))

    def readout(self, x: torch.Tensor, input_ids: torch.Tensor
                ) -> torch.Tensor:
        """The stream after the last layer → [B, projection]: each row's
        EOS position (argmax of its ids), the final LayerNorm, the
        projection."""
        eos = input_ids.long().argmax(-1)
        x = x[torch.arange(x.shape[0], device=x.device), eos]
        x = layernorm_flax(x, self.final_ln_scale, self.final_ln_bias)
        return x @ self.projection.float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, L] (EOS = the largest id of each row) → [B,
        projection] f32."""
        cfg = self.config
        x = self.embed(input_ids)
        mask = causal_mask(x.shape[1], x.device)
        for layer in self.blocks:
            x = transformer_block(x, layer, cfg.num_heads, self.dtype, mask)
        return self.readout(x, input_ids)


def finetune_param_names(model: nn.Module, num_trainable_blocks: int = 9,
                         num_layers: int = 12) -> set[str]:
    """The trainable parameter names (port of ``finetune_param_labels``):
    the last ``num_trainable_blocks`` blocks, post-LN and the projection."""
    first = num_layers - num_trainable_blocks
    out = set()
    for name, _prm in model.named_parameters():
        if name.startswith("blocks."):
            if int(name.split(".")[1]) >= first:
                out.add(name)
        elif name.startswith(("post_ln", "projection")):
            out.add(name)
    return out


def fold_u8_normalize_params(state: dict[str, torch.Tensor]
                             ) -> dict[str, torch.Tensor]:
    """Fold CLIP's ``(x/255 − mean)/std`` input normalization into the
    patch embedding and the position embedding (port of JAX's
    ``fold_u8_normalize_params``), so raw uint8 pixels feed the tower.

    The normalization is affine per input channel and the patch embedding
    is linear, so it folds exactly:

        conv(x·a + b) = conv(x)·a_folded + Σ_{c,h,w} K[:, c, h, w]·b[c]

    with ``a = 1/(255·std)`` scaling the kernel's input-channel slices and
    the per-output-channel constant added to the patch rows of the
    position embedding (the CLS row takes no conv output).  ``state``: a
    ``VisionTransformer``'s or an ``Int8VisionTransformer``'s state dict
    (the patch embedding is unquantized in both), or any mapping with
    ``patch_embed`` [D, 3, p, p] and ``position_embedding`` [P+1, D].
    Returns a new dict, the other entries shared; the folded weights must
    only see raw-u8-scale inputs."""
    from ..input.pipeline import CLIP_MEAN, CLIP_STD

    kernel = state["patch_embed"]
    pos = state["position_embedding"]
    k32 = kernel.float()
    a = torch.as_tensor(1.0 / (255.0 * CLIP_STD), dtype=torch.float32,
                        device=kernel.device)
    b = torch.as_tensor(-CLIP_MEAN / CLIP_STD, dtype=torch.float32,
                        device=kernel.device)
    bias = torch.einsum("dchw,c->d", k32, b)
    folded_pos = pos.float().clone()
    folded_pos[1:] += bias
    out = dict(state)
    out["patch_embed"] = (k32 * a[None, :, None, None]).to(kernel.dtype)
    out["position_embedding"] = folded_pos.to(pos.dtype)
    return out


def fold_u8_tower(model: TowerBase) -> TowerBase:
    """A tower that takes raw uint8 pixels: a shallow copy of ``model``
    whose patch and position embeddings are ``fold_u8_normalize_params``'s
    (new tensors); every other parameter and every layer is shared."""
    import copy

    folded = fold_u8_normalize_params(
        {"patch_embed": model.patch_embed.detach(),
         "position_embedding": model.position_embedding.detach()})
    tower = copy.copy(model)
    tower._parameters = dict(model._parameters)
    for name in ("patch_embed", "position_embedding"):
        tower._parameters[name] = nn.Parameter(folded[name],
                                               requires_grad=False)
    return tower
