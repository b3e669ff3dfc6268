"""Helpers shared by the kernel modules (port of patent_tpu/ops/common.py)."""

from __future__ import annotations

import math

import torch

# quick_gelu(g) = g * sigmoid(1.702 g) in exp2 form:
# sigmoid(1.702 g) = 1 / (1 + exp2(NEG_1702_LOG2E * g))
NEG_1702_LOG2E = float(-1.702 * math.log2(math.e))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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
