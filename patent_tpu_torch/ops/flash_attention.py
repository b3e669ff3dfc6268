"""The parts of patent_tpu/ops/flash_attention.py that the serving layer
shares: the exp2-domain score clamp and the plain one-pass softmax·v.

The CUDA layer kernel (csrc/bf16_layer.cu) uses the usual max-subtracted
softmax instead; ``one_pass_softmax_pv`` stays as the plain statement of
the TPU kernel's form, for tests and comparison.
"""

from __future__ import annotations

import torch

SCORE_CLAMP_LO = -100.0
SCORE_CLAMP_HI = 80.0


def one_pass_softmax_pv(q: torch.Tensor, k: torch.Tensor, v_ext: torch.Tensor,
                        dp: int) -> torch.Tensor:
    """``softmax(q kᵀ) v`` in the TPU kernel's one-pass form.

    q [Sq, dp] carries the score scale and log2(e) already; scores are
    clamped to [SCORE_CLAMP_LO, SCORE_CLAMP_HI] and exponentiated with exp2
    (no max subtraction).  ``v_ext`` [Sk, dp+1] is V with the pad rows zeroed
    and a 0/1 valid-key column appended, so one product delivers the masked
    numerator and denominator; p is rounded to v's dtype for that product.
    """
    s = q.float() @ k.float().T
    p = torch.exp2(s.clamp(SCORE_CLAMP_LO, SCORE_CLAMP_HI)).to(v_ext.dtype)
    o_ext = p.float() @ v_ext.float()
    return o_ext[:, :dp] / o_ext[:, dp:dp + 1]


def valid_col(sp: int, seq_len: int, dtype: torch.dtype,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """[sp, 1] column: 1 for rows below ``seq_len``, 0 for pad rows."""
    return (torch.arange(sp, device=device)[:, None] < seq_len).to(dtype)
