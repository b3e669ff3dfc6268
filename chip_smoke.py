#!/usr/bin/env python3
"""Smoke test of patent_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels of patent_tpu_torch/csrc, from source;
3. kernels against their plain PyTorch versions at ViT-B/16 @224 shapes:
   the bf16 layer and CLS layer, and the int8 attention, CLS attention and
   MLP sub-layers, at B=16, S=208 with 197 and 96 valid rows and the pad
   rows random, each beside controls that must fail its gate (the plain
   version without the key mask, with each bias zeroed, with each
   matrix's per-channel scales replaced by their mean); each CLS kernel
   equal to row 0 of its full kernel bit for bit; the bf16 and the int8
   bucket top-k at Q=64 on 1M x 512 and 1,000 x 512 galleries (the int8
   stage equal to its plain version), re-ranked top-10 against the f32
   scan; the bf16 and the int8 towers with kernels against the same
   towers with plain layers, and the int8 tower against the bf16 tower;
4. the slice end to end through the CLI: encode, retrieve --k 20 and eval
   on a 224 px synthetic corpus (60 patents x 6 figures) with seeded
   ViT-B/16 weights saved as a clip_finetune_best checkpoint, first with
   the bf16 tower and then with --quantize, and an
   EmbeddingIndex(quantized=True) over the int8-encoded gallery; every
   kernel's launch count over its path must be > 0;
5. times (CUDA events): the bf16 and the int8 tower img/s at batch 128,
   cosine top-k QPS at 1M x 512, Q=256, k=10 through the bf16 kernel
   path, the quantized path and the f32 scan, and every kernel against
   its plain version at the main path's shapes.

The line before the last is a JSON object with one entry per kernel
(its launches on the main path, error against the plain version, times
and the least time the card could take); the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before either
is printed.  Needs one CUDA card; without one it exits 1.
"""

from __future__ import annotations

import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke_run")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, plain, kernel) -> tuple[float, float]:
    """(plain ms, kernel ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def kernel_breakdown(torch, fn, iters: int = 3) -> list[tuple[str, float]]:
    """(kernel name, device ms per call) of every kernel ``fn`` launches,
    largest first, from torch.profiler over ``iters`` calls after one
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / iters / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def min_row_cosine(torch, a, b) -> float:
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def rel_err(a, b) -> float:
    """mean |a - b| / mean |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().mean() / b.abs().mean())


# Layer gate: the kernel and the plain version round the same bf16
# intermediates, so they differ by f32 summation order, which now and then
# flips one bf16 rounding.  Measured on the H100: relative error 1.7e-4 to
# 3.8e-4, max-abs 1 ulp (chip_smoke's own output shows it); dropping the
# key mask or one bias of std 0.02 gives 1.1e-2 or more, and the controls
# below must fail the gate.
LAYER_REL_TOL = 1.5e-3
LAYER_MAX_ULPS = 2
BIASES = ((1, "ln1_bias"), (3, "bqkv"), (5, "bout"), (7, "ln2_bias"),
          (9, "b1"), (11, "b2"))


# f32 sums of 512 bf16 products of unit vectors, in two orders
TOPK_VALUE_TOL = 1e-5
# 12 layers compound the per-layer rounding flips
TOWER_REL_TOL = 2e-2
TOWER_MIN_COS = 0.9999


# int8 sub-layers: the kernel and the plain version compute the same int8
# codes except where a LayerNorm or an f32 dot summed in another order
# flips one, and the integer products are exact.  Measured on the H100 at
# B = 16, S = 208, 197 valid: relative error 3.4e-5 (attention), 6.9e-5
# (CLS), 4.2e-7 (MLP), at most 1 ulp; the gate sits ~4x above, as the bf16
# layer's does, and every control must fail it.
INT8_REL_TOL = 3e-4
INT8_MAX_ULPS = 2
# The int8 tower is far more sensitive than the bf16 one: a perturbation
# that moves one LayerNorm or hidden value across a rounding boundary flips
# an int8 code, a step of 1/127 of the row's range, and 12 random layers
# carry it on.  Each layer, given the same input, agrees with its plain
# version to 1 ulp, yet the towers drift apart by about as much as the
# plain tower moves when its pixels get noise of std 1e-3 (the yardstick
# this script prints); the gate sits ~2x above that.
INT8_TOWER_REL_TOL = 4e-2
INT8_TOWER_MIN_COS = 0.9995
# the int8 tower against the bf16 tower: quantization error, printed and
# held only far from garbage
INT8_VS_BF16_MIN_COS = 0.9

# H100 SXM datasheet peaks (dense) and memory rate, for bound_ms
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound(nbytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over their
    type's peak."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def layer_bounds(b, s, valid, d, f, int8: bool) -> dict[str, tuple]:
    """bound() of the four layer kernels of one family at [B, S, D] with
    `valid` keys: each input read once and each output written once
    (activations bf16, int8 or bf16 matrices, f32 vectors), the products
    each does, and the attention over the valid keys only."""
    m, w = b * s, (1 if int8 else 2)
    vec = 4 * (9 * d + f)
    attn_w = w * 4 * d * d
    mlp_w = w * 2 * d * f
    if int8:
        return {
            "quant_attention_block": bound(
                2 * 2 * m * d + attn_w + vec,
                {"int8": 2 * m * d * 4 * d, "bf16": 4 * b * s * valid * d}),
            "quant_attention_cls": bound(
                2 * m * d + 2 * b * d + attn_w + vec,
                {"int8": 2 * m * d * 2 * d + 4 * b * d * d,
                 "bf16": 4 * b * valid * d}),
            "quant_mlp_block": bound(
                2 * 2 * m * d + mlp_w + vec, {"int8": 4 * m * d * f})}
    return {
        "fused_layer_block_bf16": bound(
            2 * 2 * m * d + attn_w + mlp_w + vec,
            {"bf16": 2 * m * d * 4 * d + 4 * m * d * f
             + 4 * b * s * valid * d}),
        "fused_layer_cls_bf16": bound(
            2 * m * d + 2 * b * d + attn_w + mlp_w + vec,
            {"bf16": 2 * m * d * 2 * d + 4 * b * d * d + 4 * b * d * f
             + 4 * b * valid * d})}


def topk_bound(nq, n, d, pool, int8: bool) -> tuple[float, str]:
    """bound() of a bucket candidate stage: the gallery, its per-row
    vector and the queries read once, the [Q, pool] values and indices
    written once, 2·Q·N·D products."""
    e = 1 if int8 else 2
    return bound(n * d * e + 4 * n + nq * d * 4 + nq * pool * 12,
                 {"int8" if int8 else "bf16": 2 * nq * n * d})


def layer_gap(torch, got, ref) -> tuple[float, float]:
    """(relative error, max-abs error in bf16 ulps at the largest |ref|)."""
    ulp = 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)
    return (rel_err(got, ref),
            float((got.float() - ref.float()).abs().max()) / ulp)


def layer_passes(gap: tuple[float, float], rel_tol: float = LAYER_REL_TOL,
                 max_ulps: float = LAYER_MAX_ULPS) -> bool:
    return gap[0] <= rel_tol and gap[1] <= max_ulps


def gate(torch, name, got, ref, controls: dict, rel_tol: float,
         max_ulps: float) -> float:
    """Hold a kernel's output to its plain version's (rel err <= rel_tol,
    <= max_ulps bf16 ulps at the largest |ref|) and require every control
    to fail the same gate.  Returns the max-abs error."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    gap = layer_gap(torch, got, ref)
    cgaps = {c: layer_gap(torch, t, ref) for c, t in controls.items()}
    print(f"[kernel] {name} vs plain: rel err {gap[0]:.3g}, max-abs "
          f"{gap[1]:.3g} ulp, min cosine {min_row_cosine(torch, got, ref):.6f}"
          "; controls (must fail): "
          + ", ".join(f"{c} {g[0]:.3g} / {g[1]:.3g} ulp"
                      for c, g in cgaps.items()))
    check(layer_passes(gap, rel_tol, max_ulps), f"{name} disagrees with its "
          f"plain version (gate: rel err <= {rel_tol}, <= {max_ulps} ulp)")
    for c, g in cgaps.items():
        check(not layer_passes(g, rel_tol, max_ulps),
              f"{name}: control '{c}' passes the gate, so the gate cannot "
              "tell a wrong kernel from a right one")
    return float((got.float() - ref.float()).abs().max())


def layer_params(torch, d, f, gen, dev):
    """One layer's parameters as the kernel takes them: matrices bf16,
    LayerNorm vectors and biases f32, every bias large enough to matter."""
    def randn(*shape, std):
        return std * torch.randn(*shape, generator=gen, device=dev)

    def mat(*shape):
        return randn(*shape, std=shape[0] ** -0.5).to(torch.bfloat16)

    return (1 + randn(d, std=0.1), randn(d, std=0.1),
            mat(d, 3 * d), randn(3 * d, std=0.2),
            mat(d, d), randn(d, std=0.02),
            1 + randn(d, std=0.1), randn(d, std=0.1),
            mat(d, f), randn(f, std=0.02),
            mat(f, d), randn(d, std=0.02))


def layer_input(torch, b, s, d, valid, gen, dev):
    """[B, S, D] bf16 tokens; the pad rows (>= valid) hold random content
    of another scale.  A constant pad row would reach attention as exactly
    ln1_bias after LN1 and hide a key mask that does not work."""
    x = torch.randn(b, s, d, generator=gen, device=dev)
    x[:, valid:] = 3.0 * x[:, valid:] + 1.0
    return x.to(torch.bfloat16)


def check_layer(torch, bf16_layer, name, x, p, heads, valid) -> float:
    """Hold one bf16 layer kernel (``name``: the block or the CLS wrapper)
    to its plain version on the valid rows, with controls that must fail
    the same gate: the plain version without the key mask, and with each
    bias zeroed.  Returns the max-abs error."""
    kernel = getattr(bf16_layer, name)
    plain = getattr(bf16_layer, name + "_plain")
    s = x.shape[1]
    rows = (slice(None), slice(0, valid)) if x.dim() == 3 else (slice(None),)

    def valid_rows(t):
        return t[rows] if t.dim() == 3 else t

    ref = valid_rows(plain(x, *p, heads, valid))
    got = valid_rows(kernel(x, *p, heads, valid))
    controls = {"no key mask": valid_rows(plain(x, *p, heads, s))}
    for i, bname in BIASES:
        q = list(p)
        q[i] = torch.zeros_like(q[i])
        controls[bname + "=0"] = valid_rows(plain(x, *q, heads, valid))
    return gate(torch, f"{name} valid {valid}/{s}", got, ref, controls,
                LAYER_REL_TOL, LAYER_MAX_ULPS)


# (index, name) of the biases and the per-channel scales in the int8
# attention (ln1_scale, ln1_bias, wqkv_t, sqkv, bqkv, wout_t, sout, bout)
# and MLP (ln2_scale, ln2_bias, w1_t, s1, b1, w2_t, s2, b2) parameters
INT8_CONTROLS = {
    "attention": ((1, "ln1_bias"), (4, "bqkv"), (7, "bout")),
    "attention scales": ((3, "sqkv"), (6, "sout")),
    "mlp": ((1, "ln2_bias"), (4, "b1"), (7, "b2")),
    "mlp scales": ((3, "s1"), (6, "s2")),
}


def int8_params(torch, qm, d, f, gen, dev):
    """(attention, MLP) parameters of one int8 layer as the kernels take
    them: f32 matrices quantized per output channel and held [out, in],
    vectors f32, every bias large enough to matter."""
    def randn(*shape, std):
        return std * torch.randn(*shape, generator=gen, device=dev)

    def mat(rows, cols):
        q, scale = qm.quantize_weight(randn(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    wqkv, sqkv = mat(d, 3 * d)
    wout, sout = mat(d, d)
    w1, s1 = mat(d, f)
    w2, s2 = mat(f, d)
    attn = (1 + randn(d, std=0.1), randn(d, std=0.1), wqkv, sqkv,
            randn(3 * d, std=0.2), wout, sout, randn(d, std=0.02))
    mlp = (1 + randn(d, std=0.1), randn(d, std=0.1), w1, s1,
           randn(f, std=0.02), w2, s2, randn(d, std=0.02))
    return attn, mlp


def check_int8(torch, qm, name, x, p, heads, valid) -> float:
    """Hold one int8 kernel (``name``: quant_attention_block,
    quant_attention_cls or quant_mlp_block) to its plain version on the
    valid rows (every row for the MLP, which is row-independent), with
    controls that must fail the same gate.  Returns the max-abs error."""
    kernel = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    s = x.shape[1]
    attention = name != "quant_mlp_block"
    kind = "attention" if attention else "mlp"

    def run(fn, q, v=valid):
        out = fn(x, *q, heads, v) if attention else fn(x, *q)
        return out[:, :valid] if name == "quant_attention_block" else out

    ref = run(plain, p)
    got = run(kernel, p)
    controls = {"no key mask": run(plain, p, s)} if attention else {}
    for i, bname in INT8_CONTROLS[kind]:
        q = list(p)
        q[i] = torch.zeros_like(q[i])
        controls[bname + "=0"] = run(plain, q)
    for i, sname in INT8_CONTROLS[kind + " scales"]:
        q = list(p)
        q[i] = torch.full_like(q[i], float(q[i].mean()))
        controls[sname + "=mean"] = run(plain, q)
    return gate(torch, f"{name} valid {valid}/{s}", got, ref, controls,
                INT8_REL_TOL, INT8_MAX_ULPS)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "patent_tpu_torch")):
        fail(f"no patent_tpu_torch package next to {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, ROOT)
    import numpy as np

    from patent_tpu_torch import _build
    from patent_tpu_torch.cli.main import main as cli
    from patent_tpu_torch.models.vit import VIT_B16, VisionTransformer
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
    from patent_tpu_torch.models.weights import params_to_jax
    from patent_tpu_torch.ops import bf16_layer, topk_kernel
    from patent_tpu_torch.ops import quant_matmul as qm
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.retrieval.cli_actions import (select_device,
                                                        write_synthetic_split)
    from patent_tpu_torch.utils import checkpoint

    # ---- 1. device
    dev = select_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; {torch.cuda.device_count()} card(s); "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")
    print(smi)
    label = f"({smi})"

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"[build] {os.path.relpath(lib.path, ROOT)}: nvcc "
          f"{lib.build_seconds:.1f} s, ready after "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, valid, d, heads, f = 16, 208, 197, 768, 12, 3072
    p = layer_params(torch, d, f, gen, dev)
    ip_attn, ip_mlp = int8_params(torch, qm, d, f, gen, dev)
    errs = dict.fromkeys(("fused_layer_block_bf16", "fused_layer_cls_bf16",
                          "quant_attention_block", "quant_attention_cls",
                          "quant_mlp_block"), 0.0)
    # the main path's 197 of 208 rows, then a case where most keys are pad
    for v in (valid, 96):
        x = layer_input(torch, b, s, d, v, gen, dev)
        for kname in ("fused_layer_block_bf16", "fused_layer_cls_bf16"):
            errs[kname] = max(errs[kname], check_layer(
                torch, bf16_layer, kname, x, p, heads, v))
        for kname, ip in (("quant_attention_block", ip_attn),
                          ("quant_attention_cls", ip_attn),
                          ("quant_mlp_block", ip_mlp)):
            errs[kname] = max(errs[kname], check_int8(
                torch, qm, kname, x, ip, heads, v))
        # each CLS kernel runs row 0's operations of its full kernel in the
        # same order, so it equals row 0 bit for bit
        for full, cls, args in (
                (bf16_layer.fused_layer_block_bf16,
                 bf16_layer.fused_layer_cls_bf16, p),
                (qm.quant_attention_block, qm.quant_attention_cls, ip_attn)):
            got = full(x, *args, heads, v)
            got_c = cls(x, *args, heads, v)
            torch.cuda.synchronize()
            check(got_c.shape == (b, d) and bool(torch.equal(got_c, got[:, 0])),
                  f"{cls.__name__} differs from row 0 of {full.__name__} "
                  f"(valid {v})")
    print("[kernel] fused_layer_cls_bf16 equals row 0 of "
          "fused_layer_block_bf16, and quant_attention_cls row 0 of "
          "quant_attention_block, bit for bit")

    n_big, dg, nq, k = 1_000_000, 512, 64, 10
    gal = torch.randn(n_big, dg, generator=gen, device=dev)
    pick = torch.randint(0, n_big, (nq // 2,), generator=gen, device=dev)
    queries = torch.cat([
        gal[pick] + 0.5 * torch.randn(nq // 2, dg, generator=gen, device=dev),
        torch.randn(nq - nq // 2, dg, generator=gen, device=dev)])
    err_topk = 0.0
    for n in (n_big, 1000):
        g = gal[:n]
        g16, gvalid = topk_kernel.prepare_cosine_gallery_bf16(g)
        pool = k * index_mod.DEFAULT_RERANK_MULT
        kv, ki = topk_kernel.bucket_topk_bf16(queries, g16, gvalid, pool)
        pv, pi = topk_kernel.bucket_topk_bf16_plain(queries, g16, gvalid, pool)
        sv, si = index_mod.topk_search(queries, g, k=k)
        fv, fi = index_mod.topk_search_cosine_fast(queries, g16, gvalid, g,
                                                   k=k)
        torch.cuda.synchronize()
        # both sum the same bf16 products in f32, in another order: values
        # agree to ~1e-6, and a pool may differ from the plain one only by
        # candidates tied with the pool's last value within that noise
        err = float((kv - pv).abs().max())
        err_topk = max(err_topk, err)
        same = edge_ties = 0
        for qk, qp, vk, vp in zip(ki.tolist(), pi.tolist(), kv.tolist(),
                                  pv.tolist()):
            swapped = {**dict(zip(qk, vk)), **dict(zip(qp, vp))}
            diff = set(qk) ^ set(qp)
            same += not diff
            edge_ties += bool(diff) and all(
                abs(swapped[c] - vp[-1]) <= TOPK_VALUE_TOL for c in diff)
        held = all(set(a.tolist()) <= set(c.tolist()) for a, c in zip(si, ki))
        exact = bool(torch.equal(fi, si))
        val_err = float((fv - sv).abs().max())
        print(f"[kernel] bucket_topk_bf16 n={n}: pool values vs plain "
              f"max_abs_err {err:.3g}, pool sets equal for {same} of {nq} "
              f"queries ({edge_ties} differ by a tie at the pool's edge), "
              f"pool holds exact top-{k}: {held}, re-ranked top-{k} == "
              f"scan: {exact} (max |value diff| {val_err:.3g})")
        check(err <= TOPK_VALUE_TOL and same + edge_ties == nq and held
              and exact and val_err <= TOPK_VALUE_TOL,
              f"bucket kernel check failed at n={n}")
        del g16, gvalid

        # the int8 stage: integer products are exact, so the kernel's
        # (v1, i1, v2, i2) must equal the plain version's
        gi8, gscale = (torch.from_numpy(a).to(dev) for a in
                       topk_kernel.quantize_gallery(g.cpu().numpy()))
        qi8, qscale = topk_kernel.quantize_queries(queries)
        top2 = topk_kernel._bucket_top2_cuda(qi8, gi8, gscale)
        top2_plain = topk_kernel.bucket_top2_int8_plain(qi8, gi8, gscale)
        kv, ki = topk_kernel.bucket_topk_int8(qi8, qscale, gi8, gscale, pool)
        pv, pi = topk_kernel.bucket_topk_int8_plain(qi8, qscale, gi8, gscale,
                                                    pool)
        qv, qi = index_mod.topk_search_quantized(queries, gi8, gscale, g, k=k)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, c)) for a, c in zip(top2, top2_plain))
        pool_equal = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
        held = all(set(a.tolist()) <= set(c.tolist()) for a, c in zip(si, ki))
        exact = bool(torch.equal(qi, si))
        val_err = float((qv - sv).abs().max())
        err = float((kv - pv).abs().max())
        errs["bucket_topk_int8"] = max(errs.get("bucket_topk_int8", 0.0), err)
        print(f"[kernel] bucket_topk_int8 n={n}: (v1, i1, v2, i2) equal to "
              f"plain: {equal}, pool equal: {pool_equal}, pool holds exact "
              f"top-{k}: {held}, re-ranked top-{k} == scan: {exact} (max "
              f"|value diff| {val_err:.3g})")
        check(equal and pool_equal and held and exact
              and val_err <= TOPK_VALUE_TOL,
              f"int8 bucket kernel check failed at n={n}")
        del gi8, gscale
    del gal, g

    tgen = torch.Generator(device="cpu").manual_seed(1234)
    tower = VisionTransformer(VIT_B16, generator=tgen)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=tgen))
    tower = tower.to(dev).eval()
    tower8 = Int8VisionTransformer.from_float(tower).eval()
    pix = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    noisy = pix + 1e-3 * torch.randn(pix.shape, generator=gen, device=dev)
    feats = {}
    with torch.inference_mode():
        for tname, model in (("bf16", tower), ("int8", tower8)):
            feats[tname] = model(pix)
            model.kernels = False
            feats[tname + " plain"] = model(pix)
            feats[tname + " noisy"] = model(noisy)
            model.kernels = True
    torch.cuda.synchronize()
    for tname, rel_tol, min_cos in (
            ("bf16", TOWER_REL_TOL, TOWER_MIN_COS),
            ("int8", INT8_TOWER_REL_TOL, INT8_TOWER_MIN_COS)):
        feat_k, feat_p = feats[tname], feats[tname + " plain"]
        cos_tower = min_row_cosine(torch, feat_k, feat_p)
        rel_tower = rel_err(feat_k, feat_p)
        prefix = "" if tname == "bf16" else "int8 "
        print(f"[kernel] ViT-B/16 {prefix}tower, kernels vs plain layers: "
              f"feature rel err {rel_tower:.3g}, min cosine {cos_tower:.6f}"
              f" (yardstick, plain vs plain on pixels + 1e-3 noise: rel err "
              f"{rel_err(feats[tname + ' noisy'], feat_p):.3g}, min cosine "
              f"{min_row_cosine(torch, feats[tname + ' noisy'], feat_p):.6f})")
        check(feat_k.shape == (8, 512) and bool(torch.isfinite(feat_k).all())
              and rel_tower <= rel_tol and cos_tower >= min_cos,
              f"{tname} tower with kernels disagrees with plain")
    cos_i8 = min_row_cosine(torch, feats["int8"], feats["bf16"])
    print(f"[kernel] ViT-B/16 int8 tower vs bf16 tower (kernels): min "
          f"feature cosine {cos_i8:.6f}, rel err "
          f"{rel_err(feats['int8'], feats['bf16']):.3g}")
    check(cos_i8 >= INT8_VS_BF16_MIN_COS, "int8 tower far from the bf16 tower")

    # ---- 4. the slice end to end
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    # 60 patents: the CLI's 40 give a 160-row gallery, which a k=20
    # search (pool 160) would rank whole with the scan
    write_synthetic_split(RUN_DIR, 224, num_patents=60)
    checkpoint.save(os.path.join(RUN_DIR, "models"), "clip_finetune_best",
                    {"params": {"vit": params_to_jax(tower.state_dict())},
                     "step": 0})
    n_gallery = len(os.listdir(os.path.join(RUN_DIR, "test_gallery")))
    check(n_gallery > 20 * index_mod.DEFAULT_RERANK_MULT,
          f"gallery of {n_gallery} rows is too small to reach the kernel")
    launches = {}

    def run_path(what, counters, run):
        """Run one path with its kernels' counts set to 0 just before and
        read just after; every kernel of the path must have launched."""
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        print(f"[slice] {what} in {time.perf_counter() - t0:.1f} s; "
              f"launches {got}")
        check(all(v > 0 for v in got.values()),
              f"a kernel of the path '{what}' was never launched")
        launches.update(got)

    def cli_slice(flags, model):
        check(cli(["encode", "--path", RUN_DIR] + flags) == 0,
              f"encode {flags} failed")
        check(cli(["retrieve", "--path", RUN_DIR, "--k", "20"] + flags) == 0,
              f"retrieve {flags} failed")
        check(cli(["eval", "--path", RUN_DIR, "--model", model] + flags) == 0,
              f"eval {flags} failed")
        tag = "_int8" if flags else ""
        npys = glob.glob(os.path.join(RUN_DIR, "embeddings",
                                      f"*_torch{tag}_ft*.npy"))
        check(len(npys) == 1, f"expected one saved index, found {npys}")
        emb = np.load(npys[0])
        check(emb.shape == (n_gallery, 512) and bool(np.isfinite(emb).all()),
              f"gallery embeddings {emb.shape} not finite [{n_gallery}, 512]")
        with open(os.path.join(RUN_DIR, "results",
                               f"evaluation_results_{model}.json")) as fh:
            summary = json.load(fh)["summary_metrics"]
        check(all(0.0 <= float(v) <= 1.0 for key, v in summary.items()
                  if key != "num_missing_rankings"),
              f"metric battery out of range: {summary}")
        slice_out[model] = emb

    slice_out = {}
    run_path("encode + retrieve --k 20 + eval",
             (bf16_layer.fused_layer_block_bf16,
              bf16_layer.fused_layer_cls_bf16, topk_kernel.bucket_topk_bf16),
             lambda: cli_slice([], "GE"))
    run_path("encode + retrieve --k 20 + eval, --quantize",
             (qm.quant_attention_block, qm.quant_attention_cls,
              qm.quant_mlp_block),
             lambda: cli_slice(["--quantize"], "GE_int8"))
    emb8 = slice_out["GE_int8"]
    names = [f"g{i}" for i in range(n_gallery)]
    q_emb = emb8[:32] + 0.05 * np.random.default_rng(0).standard_normal(
        (32, 512)).astype(np.float32)
    qidx = index_mod.EmbeddingIndex(emb8, names, device=dev, quantized=True)
    run_path("EmbeddingIndex(quantized=True).search, k=20",
             (topk_kernel.bucket_topk_int8,),
             lambda: slice_out.update(qsearch=qidx.search(q_emb, k=20)))
    _sv, si = index_mod.topk_search(torch.from_numpy(q_emb).to(dev),
                                    qidx.embeddings, k=20)
    check(bool(np.array_equal(slice_out["qsearch"][1], si.cpu().numpy())),
          "quantized index top-20 differs from the f32 scan")
    print("[slice] quantized index top-20 over the int8-encoded gallery "
          "equals the f32 scan")

    # ---- 5. times
    times = {}
    bt = 128
    pix = torch.randn(bt, 224, 224, 3, generator=gen, device=dev)

    def run_tower(model, kernels):
        def go():
            model.kernels = kernels
            with torch.inference_mode():
                model(pix)
        return go

    for tname, model in (("bf16", tower), ("int8", tower8)):
        tp, tk = in_turns(torch, run_tower(model, False),
                          run_tower(model, True))
        model.kernels = True
        print(f"[time] ViT-B/16 @224 {tname} tower, batch {bt}: kernels "
              f"{bt / tk * 1e3:.1f} img/s ({tk:.2f} ms), plain "
              f"{bt / tp * 1e3:.1f} img/s ({tp:.2f} ms) {label}")
        # where the time goes: device time by kernel, against the wall
        rows = kernel_breakdown(torch, run_tower(model, True))
        busy = sum(ms for _k, ms in rows)
        print(f"[time] {tname} tower with kernels, device time by kernel "
              f"(torch.profiler, 3 batches): {busy:.2f} ms busy of "
              f"{tk:.2f} ms wall ({100 * busy / tk:.1f}%); "
              + "; ".join(f"{ms:.2f} ms {100 * ms / tk:.1f}% {kname[:90]}"
                          for kname, ms in rows[:8]))

    xb = torch.randn(bt, s, d, generator=gen, device=dev).to(torch.bfloat16)
    for kname, module, args in (
            ("fused_layer_block_bf16", bf16_layer, (*p, heads, valid)),
            ("fused_layer_cls_bf16", bf16_layer, (*p, heads, valid)),
            ("quant_attention_block", qm, (*ip_attn, heads, valid)),
            ("quant_attention_cls", qm, (*ip_attn, heads, valid)),
            ("quant_mlp_block", qm, ip_mlp)):
        kernel = getattr(module, kname)
        plain = getattr(module, kname + "_plain")
        times[kname] = in_turns(torch, lambda: plain(xb, *args),
                                lambda: kernel(xb, *args))
    del xb
    bounds = {**layer_bounds(bt, s, valid, d, f, int8=False),
              **layer_bounds(bt, s, valid, d, f, int8=True)}

    gal = torch.randn(n_big, dg, generator=gen, device=dev)
    g16, gvalid = topk_kernel.prepare_cosine_gallery_bf16(gal)
    gi8, gscale = (torch.from_numpy(a).to(dev) for a in
                   topk_kernel.quantize_gallery(gal.cpu().numpy()))
    q256 = torch.randn(256, dg, generator=gen, device=dev)
    qi8, qscale = topk_kernel.quantize_queries(q256)
    pool = k * index_mod.DEFAULT_RERANK_MULT
    times["bucket_topk_bf16"] = in_turns(
        torch,
        lambda: topk_kernel.bucket_topk_bf16_plain(q256, g16, gvalid, pool),
        lambda: topk_kernel.bucket_topk_bf16(q256, g16, gvalid, pool))
    times["bucket_topk_int8"] = in_turns(
        torch,
        lambda: topk_kernel.bucket_topk_int8_plain(qi8, qscale, gi8, gscale,
                                                   pool),
        lambda: topk_kernel.bucket_topk_int8(qi8, qscale, gi8, gscale, pool))
    bounds["bucket_topk_bf16"] = topk_bound(256, n_big, dg, pool, int8=False)
    bounds["bucket_topk_int8"] = topk_bound(256, n_big, dg, pool, int8=True)
    sp, sk = in_turns(
        torch, lambda: index_mod.topk_search(q256, gal, k=k),
        lambda: index_mod.topk_search_cosine_fast(q256, g16, gvalid, gal, k=k))
    sp2, sq = in_turns(
        torch, lambda: index_mod.topk_search(q256, gal, k=k),
        lambda: index_mod.topk_search_quantized(q256, gi8, gscale, gal, k=k))
    print(f"[time] cosine top-{k} at {n_big} x {dg}, Q=256: kernel path "
          f"{256 / sk * 1e3:.0f} QPS ({sk:.2f} ms), quantized path "
          f"{256 / sq * 1e3:.0f} QPS ({sq:.2f} ms), plain scan "
          f"{256 / sp * 1e3:.0f} QPS ({sp:.2f} ms; {sp2:.2f} ms in the "
          f"second pair) {label}")
    for kname, (pm, km) in times.items():
        print(f"[time] {kname}: kernel {km:.3f} ms, plain {pm:.3f} ms, "
              f"bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}) "
              f"{label}")

    src = "patent_tpu_torch/csrc/"
    rows = [("fused_layer_block_bf16", "bf16_layer.cu",
             "patent_tpu/ops/bf16_layer.py:151"),
            ("fused_layer_cls_bf16", "bf16_layer.cu",
             "patent_tpu/ops/bf16_layer.py:261"),
            ("bucket_topk_bf16", "bucket_topk.cu",
             "patent_tpu/ops/topk_kernel.py:147"),
            ("bucket_topk_int8", "bucket_topk.cu",
             "patent_tpu/ops/topk_kernel.py:147"),
            ("quant_attention_block", "int8_layer.cu",
             "patent_tpu/ops/quant_matmul.py:722"),
            ("quant_attention_cls", "int8_layer.cu",
             "patent_tpu/ops/quant_matmul.py:960"),
            ("quant_mlp_block", "int8_layer.cu",
             "patent_tpu/ops/quant_matmul.py:1069")]
    errs["bucket_topk_bf16"] = err_topk
    # no single PyTorch call computes any of these functions, so there is
    # no library time to set beside them
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src + source,
         "replaces": replaces, "launches": launches[kname],
         "max_abs_err": errs[kname], "ms": times[kname][1],
         "plain_ms": times[kname][0], "bound_ms": bounds[kname][0],
         "bound_by": bounds[kname][1], "library_ms": None}
        for kname, source, replaces in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
