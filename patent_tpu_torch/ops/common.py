"""Helpers shared by the kernel modules (port of patent_tpu/ops/common.py)."""

from __future__ import annotations

import math

import torch

# quick_gelu(g) = g * sigmoid(1.702 g) in exp2 form:
# sigmoid(1.702 g) = 1 / (1 + exp2(NEG_1702_LOG2E * g))
NEG_1702_LOG2E = float(-1.702 * math.log2(math.e))


# The attention kernels' one contract: the tile (csrc/flash_tile.cuh: rows
# 1, 2, 5, 6, 8, 9, 14 and row 12's forward), row 13's backward
# (csrc/fused_attention.cu) and row 14's f32 kernel take every head width
# that is a multiple of 8 up to TILE_MAX_HEAD_DIM, on instances every 16,
# at any padded S: each streams its keys past what a block holds.
TILE_MAX_HEAD_DIM = 128


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """The Python scalar c as JAX applies it to an array of ``dtype``:
    weakly typed, so rounded to that dtype first."""
    return float(torch.tensor(c, dtype=dtype))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's x·sigmoid(1.702 x) as the JAX package computes it in x's
    dtype: 1.702 takes x's dtype (1.703125 in bf16), and XLA expands the
    sigmoid to 1 / (1 + exp(-t)), each step rounded to x's dtype."""
    t = x * weak_scalar(1.702, x.dtype)
    return x * (1 / (1 + torch.exp(-t)))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=dtype)`` (and the JAX layer composition's
    ``h @ cast(w) + cast(b)``): input, kernel and bias cast to ``dtype``,
    then ``(x W) + b``, each rounded to ``dtype``."""
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dtype: torch.dtype,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's einsum attention on q, k, v [..., S, H, hd]:
    scores in f32 (q times the numpy scalar 1/√hd, which promotes), the
    additive ``mask``, ``jax.nn.softmax``'s exp(s − max) / sum in f32
    rounded to ``dtype``, then p·v in ``dtype``."""
    attn = torch.einsum("...qhd,...khd->...hqk",
                        q.float() * (1.0 / math.sqrt(q.shape[-1])), k.float())
    if mask is not None:
        attn = attn + mask
    attn = torch.exp(attn - attn.amax(-1, keepdim=True))
    attn = (attn / attn.sum(-1, keepdim=True)).to(dtype)
    return torch.einsum("...hqk,...khd->...qhd", attn, v)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D or batched 3-D) with f32 products and sums, the result
    unrounded: bf16 operands are exact in f32, so this is the kernels'
    bf16 x bf16 → f32.  On the card, cuBLAS's bf16 GEMM with an f32
    output; elsewhere an f32 matmul."""
    if a.is_cuda and a.dtype != torch.float32:
        return (torch.mm if a.dim() == 2 else torch.bmm)(
            a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def layernorm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 whatever ``x`` is
    (bf16 statistics lose ~2 decimal digits on the residual stream)."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``) — what the kernels' C entry points take."""
    if (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and (shape is None or t.shape == tuple(shape))):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record this call: for a kernel that has no
    backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() or with tensors that need "
                           "no gradient")


# the attention tile's launches by instance width, counted by every entry
# that launches it (rows 1, 2, 5, 6, 8, 9, 12, 14), beside its own count
TILE_LAUNCHES: dict[int, int] = {}


def tile_width(hd: int) -> int:
    """The tile's instance for a real head width: the next multiple of 16
    (csrc/flash_tile.cuh's tile_width)."""
    return round_up(hd, 16)


def count_tile(d: int, num_heads: int) -> None:
    """One launch of the tile at D / num_heads, in TILE_LAUNCHES."""
    w = tile_width(d // num_heads)
    TILE_LAUNCHES[w] = TILE_LAUNCHES.get(w, 0) + 1


def _tile_width_ok(d: int, num_heads: int) -> bool:
    hd = d // num_heads
    return d % num_heads == 0 and hd % 8 == 0 and 0 < hd <= TILE_MAX_HEAD_DIM


def _token_axis_ok(s: int, valid_len: int) -> bool:
    return s % 16 == 0 and 1 <= valid_len <= s


def attention_kernel_takes(d: int, num_heads: int, s: int,
                           valid_len: int) -> bool:
    """Whether the attention kernels take this shape: a head width that is
    a multiple of 8 up to TILE_MAX_HEAD_DIM, the token axis padded to a
    multiple of 16 with 1 <= valid_len <= S, any S."""
    return _tile_width_ok(d, num_heads) and _token_axis_ok(s, valid_len)


def check_attention_shape(d: int, num_heads: int, s: int,
                          valid_len: int) -> None:
    """Raise unless ``attention_kernel_takes`` this shape, saying why: what
    every entry that launches an attention kernel asks first."""
    if not _tile_width_ok(d, num_heads):
        raise ValueError(f"CUDA attention needs a head_dim that is a "
                         f"multiple of 8 up to {TILE_MAX_HEAD_DIM}, got "
                         f"D={d} with {num_heads} heads")
    if not _token_axis_ok(s, valid_len):
        raise ValueError(f"token axis {s} must be padded to a multiple of "
                         f"16 with 1 <= valid_len ({valid_len}) <= {s}")
