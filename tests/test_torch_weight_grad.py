"""Row 16's weight gradients on the CPU: the plain versions the MN-major
GEMM (csrc/wgmma_gemm.cuh ``gemm_tn``) is held to.  Its split plan lives
in C beside the GEMM (``tn_splits``); tests/test_torch_gpu.py asks it
through ``weight_grad_plan`` and holds the kernel to ``torch.matmul`` on
the card."""

import numpy as np
import pytest
import torch

from patent_tpu_torch.ops import bf16_mlp_grad as mm


@pytest.mark.parametrize("k,m,n", [(300, 24, 40), (77, 256, 128),
                                   (64, 128, 256), (1, 8, 8)])
def test_weight_grad_on_the_cpu_is_the_f32_product(k, m, n):
    g = np.random.default_rng(k)
    a = torch.from_numpy(g.standard_normal((k, m), np.float32)).to(
        torch.bfloat16)
    b = torch.from_numpy(g.standard_normal((k, n), np.float32)).to(
        torch.bfloat16)
    want = a.double().T @ b.double()
    got = mm.weight_grad(a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("m", [90, 64, 77])
def test_plain_backward_weight_gradients_are_the_weight_grad_products(m):
    """dW2 = aᵀ do and dW1 = hᵀ bf16(dg) of the plain row 16 are the
    MN-major products of its own bf16 operands."""
    g = np.random.default_rng(m)
    d, f = 32, 64

    def r(*shape, std=1.0):
        return torch.from_numpy((std * g.standard_normal(shape)).astype(
            np.float32))

    x2 = r(m, d).to(torch.bfloat16)
    do2 = r(m, d).to(torch.bfloat16)
    lns, lnb = 1 + r(d, std=0.1), r(d, std=0.1)
    w1 = r(d, f, std=d ** -0.5).to(torch.bfloat16)
    w2 = r(f, d, std=f ** -0.5).to(torch.bfloat16)
    b1 = r(f, std=0.02)
    _dx, _dls, _dlb, dw1, _db1, dw2, _db2 = mm._mlp_bwd_plain(
        x2, do2, lns, lnb, w1, b1, w2)
    xn, _rstd = mm._ln_stats(x2.float())
    h16 = (xn * lns + lnb).to(torch.bfloat16)
    gl = mm.mm_f32(h16, w1) + b1
    a, s = mm._gelu_and_sig(gl)
    dg = mm.mm_f32(do2, w2.T) * (s * (1.0 + 1.702 * gl * (1.0 - s)))
    assert torch.equal(dw2, mm.weight_grad(a.to(torch.bfloat16), do2))
    assert torch.equal(dw1, mm.weight_grad(h16, dg.to(torch.bfloat16)))
