"""Helpers shared by the kernel modules (port of patent_tpu/ops/common.py)."""

from __future__ import annotations

import math

import torch

# quick_gelu(g) = g * sigmoid(1.702 g) in exp2 form:
# sigmoid(1.702 g) = 1 / (1 + exp2(NEG_1702_LOG2E * g))
NEG_1702_LOG2E = float(-1.702 * math.log2(math.e))


# the head width csrc/attention.cuh is written for, and the shared memory
# a block may use on the H100
ATTENTION_HEAD_DIM = 64
SMEM_LIMIT = 232448


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_attention_shape(d: int, num_heads: int, s: int,
                          valid_len: int) -> None:
    """Raise unless csrc/attention.cuh takes this shape: head_dim 64, the
    token axis padded to a multiple of 16 with 1 <= valid_len <= S, and K,
    V and the score tile of one (image, head) within shared memory."""
    hd = ATTENTION_HEAD_DIM
    if d % num_heads or d // num_heads != hd:
        raise ValueError(f"CUDA attention needs head_dim {hd}, got D={d} "
                         f"with {num_heads} heads")
    if s % 16 or not 1 <= valid_len <= s:
        raise ValueError(f"token axis {s} must be padded to a multiple of "
                         f"16 with 1 <= valid_len ({valid_len}) <= {s}")
    sld = max(s, hd) + 8
    if (2 * s + 64) * (hd + 8) * 2 + 64 * sld * 6 + 64 * 4 > SMEM_LIMIT:
        raise ValueError(f"sequence {s} exceeds the attention kernel's "
                         f"shared memory")
