#!/usr/bin/env python3
"""Smoke test of patent_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels of patent_tpu_torch/csrc, from source;
3. kernels against their plain PyTorch versions at ViT-B/16 @224 shapes
   (layer and CLS layer at B=16, S=208 with 197 valid and the pad rows
   poisoned; bucket top-k at Q=64, k=10 on 1M x 512 and 1,000 x 512
   galleries, re-ranked top-10 against the f32 scan), and the whole tower
   with kernels against the tower with plain layers;
4. the slice end to end through the CLI: encode, retrieve --k 20 and eval
   on a 224 px synthetic corpus (60 patents x 6 figures) with seeded
   ViT-B/16 weights saved as a clip_finetune_best checkpoint; every
   kernel's launch count must be > 0;
5. times (CUDA events): tower img/s at batch 128 and cosine top-k QPS at
   1M x 512, Q=256, k=10, each kernel path against its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failure exits non-zero
before either is printed.  Needs one CUDA card; without one it exits 1.
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


def layer_gap(torch, got, ref) -> tuple[float, float]:
    """(relative error, max-abs error in bf16 ulps at the largest |ref|)."""
    ulp = 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)
    return (rel_err(got, ref),
            float((got.float() - ref.float()).abs().max()) / ulp)


def layer_passes(gap: tuple[float, float]) -> bool:
    return gap[0] <= LAYER_REL_TOL and gap[1] <= LAYER_MAX_ULPS


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
    """Hold one layer kernel (``name``: the block or the CLS wrapper) to its
    plain version on the valid rows, with controls that must fail the same
    gate: the plain version without the key mask, and with each bias
    zeroed.  Returns the max-abs error."""
    kernel = getattr(bf16_layer, name)
    plain = getattr(bf16_layer, name + "_plain")
    s = x.shape[1]
    rows = (slice(None), slice(0, valid)) if x.dim() == 3 else (slice(None),)

    def valid_rows(t):
        return t[rows] if t.dim() == 3 else t

    ref = valid_rows(plain(x, *p, heads, valid))
    got = valid_rows(kernel(x, *p, heads, valid))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    gap = layer_gap(torch, got, ref)
    controls = {"no key mask": valid_rows(plain(x, *p, heads, s))}
    for i, bname in BIASES:
        q = list(p)
        q[i] = torch.zeros_like(q[i])
        controls[bname + "=0"] = valid_rows(plain(x, *q, heads, valid))
    cgaps = {c: layer_gap(torch, t, ref) for c, t in controls.items()}
    print(f"[kernel] {name} valid {valid}/{s} vs plain: rel err "
          f"{gap[0]:.3g}, max-abs {gap[1]:.3g} ulp, min cosine "
          f"{min_row_cosine(torch, got, ref):.6f}; controls (must fail): "
          + ", ".join(f"{c} {g[0]:.3g} / {g[1]:.3g} ulp"
                      for c, g in cgaps.items()))
    check(layer_passes(gap), f"{name} disagrees with its plain version "
          f"(gate: rel err <= {LAYER_REL_TOL}, <= {LAYER_MAX_ULPS} ulp)")
    for c, g in cgaps.items():
        check(not layer_passes(g), f"{name}: control '{c}' passes the gate, "
              "so the gate cannot tell a wrong kernel from a right one")
    return float((got.float() - ref.float()).abs().max())


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
    from patent_tpu_torch import _build
    from patent_tpu_torch.cli.main import main as cli
    from patent_tpu_torch.models.vit import VIT_B16, VisionTransformer
    from patent_tpu_torch.models.weights import params_to_jax
    from patent_tpu_torch.ops import bf16_layer, topk_kernel
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.retrieval.cli_actions import (pick_device,
                                                        write_synthetic_split)
    from patent_tpu_torch.utils import checkpoint

    # ---- 1. device
    dev = pick_device()
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
    # the main path's 197 of 208 rows, then a case where most keys are pad
    err_layer = err_cls = 0.0
    for v in (valid, 96):
        x = layer_input(torch, b, s, d, v, gen, dev)
        err_layer = max(err_layer, check_layer(
            torch, bf16_layer, "fused_layer_block_bf16", x, p, heads, v))
        err_cls = max(err_cls, check_layer(
            torch, bf16_layer, "fused_layer_cls_bf16", x, p, heads, v))
        got = bf16_layer.fused_layer_block_bf16(x, *p, heads, v)
        got_c = bf16_layer.fused_layer_cls_bf16(x, *p, heads, v)
        torch.cuda.synchronize()
        # the CLS kernel runs row 0's operations of the layer kernel in the
        # same order, so it equals row 0 bit for bit
        check(got_c.shape == (b, d) and bool(torch.equal(got_c, got[:, 0])),
              f"CLS kernel differs from row 0 of the layer kernel "
              f"(valid {v})")
    print("[kernel] fused_layer_cls_bf16 equals row 0 of "
          "fused_layer_block_bf16 bit for bit")

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
    del gal, g, g16

    tgen = torch.Generator(device="cpu").manual_seed(1234)
    tower = VisionTransformer(VIT_B16, generator=tgen)
    with torch.no_grad():        # init leaves them 0 and 1: make each matter
        for prm in tower.parameters():
            if prm.dim() == 1:
                prm.add_(0.05 * torch.randn(prm.shape, generator=tgen))
    tower = tower.to(dev).eval()
    pix = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    with torch.inference_mode():
        feat_k = tower(pix)
        tower.kernels = False
        feat_p = tower(pix)
        tower.kernels = True
    torch.cuda.synchronize()
    cos_tower = min_row_cosine(torch, feat_k, feat_p)
    rel_tower = rel_err(feat_k, feat_p)
    print(f"[kernel] ViT-B/16 tower, kernels vs plain layers: feature rel "
          f"err {rel_tower:.3g}, min cosine {cos_tower:.6f}")
    check(feat_k.shape == (8, 512) and bool(torch.isfinite(feat_k).all())
          and rel_tower <= TOWER_REL_TOL and cos_tower >= TOWER_MIN_COS,
          "tower with kernels disagrees with plain")

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
    counters = (bf16_layer.fused_layer_block_bf16,
                bf16_layer.fused_layer_cls_bf16, topk_kernel.bucket_topk_bf16)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    check(cli(["encode", "--path", RUN_DIR]) == 0, "encode failed")
    check(cli(["retrieve", "--path", RUN_DIR, "--k", "20"]) == 0,
          "retrieve failed")
    check(cli(["eval", "--path", RUN_DIR]) == 0, "eval failed")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[slice] encode + retrieve --k 20 + eval in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    npys = glob.glob(os.path.join(RUN_DIR, "embeddings", "*.npy"))
    check(len(npys) == 1, f"expected one saved index, found {npys}")
    import numpy as np

    emb = np.load(npys[0])
    check(emb.shape == (n_gallery, 512) and bool(np.isfinite(emb).all()),
          f"gallery embeddings {emb.shape} not finite [{n_gallery}, 512]")
    with open(os.path.join(RUN_DIR, "results",
                           "evaluation_results_GE.json")) as fh:
        summary = json.load(fh)["summary_metrics"]
    check(all(0.0 <= float(v) <= 1.0 for key, v in summary.items()
              if key != "num_missing_rankings"),
          f"metric battery out of range: {summary}")

    # ---- 5. times
    times = {}
    bt = 128
    pix = torch.randn(bt, 224, 224, 3, generator=gen, device=dev)

    def run_tower(kernels):
        def go():
            tower.kernels = kernels
            with torch.inference_mode():
                tower(pix)
        return go

    tp, tk = in_turns(torch, run_tower(False), run_tower(True))
    tower.kernels = True
    print(f"[time] ViT-B/16 @224 bf16 tower, batch {bt}: kernels "
          f"{bt / tk * 1e3:.1f} img/s ({tk:.2f} ms), plain "
          f"{bt / tp * 1e3:.1f} img/s ({tp:.2f} ms) {label}")

    xb = torch.randn(bt, s, d, generator=gen, device=dev).to(torch.bfloat16)
    times["fused_layer_block_bf16"] = in_turns(
        torch,
        lambda: bf16_layer.fused_layer_block_bf16_plain(xb, *p, heads, valid),
        lambda: bf16_layer.fused_layer_block_bf16(xb, *p, heads, valid))
    times["fused_layer_cls_bf16"] = in_turns(
        torch,
        lambda: bf16_layer.fused_layer_cls_bf16_plain(xb, *p, heads, valid),
        lambda: bf16_layer.fused_layer_cls_bf16(xb, *p, heads, valid))
    del xb

    gal = torch.randn(n_big, dg, generator=gen, device=dev)
    g16, gvalid = topk_kernel.prepare_cosine_gallery_bf16(gal)
    q256 = torch.randn(256, dg, generator=gen, device=dev)
    pool = k * index_mod.DEFAULT_RERANK_MULT
    times["bucket_topk_bf16"] = in_turns(
        torch,
        lambda: topk_kernel.bucket_topk_bf16_plain(q256, g16, gvalid, pool),
        lambda: topk_kernel.bucket_topk_bf16(q256, g16, gvalid, pool))
    sp, sk = in_turns(
        torch, lambda: index_mod.topk_search(q256, gal, k=k),
        lambda: index_mod.topk_search_cosine_fast(q256, g16, gvalid, gal, k=k))
    print(f"[time] cosine top-{k} at {n_big} x {dg}, Q=256: kernel path "
          f"{256 / sk * 1e3:.0f} QPS ({sk:.2f} ms), plain scan "
          f"{256 / sp * 1e3:.0f} QPS ({sp:.2f} ms) {label}")
    for kname, (pm, km) in times.items():
        print(f"[time] {kname}: kernel {km:.3f} ms, plain {pm:.3f} ms "
              f"{label}")

    src = "patent_tpu_torch/csrc/"
    rows = [("fused_layer_block_bf16", src + "bf16_layer.cu",
             "patent_tpu/ops/bf16_layer.py:151", err_layer),
            ("fused_layer_cls_bf16", src + "bf16_layer.cu",
             "patent_tpu/ops/bf16_layer.py:261", err_cls),
            ("bucket_topk_bf16", src + "bucket_topk.cu",
             "patent_tpu/ops/topk_kernel.py:147", err_topk)]
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[kname],
         "max_abs_err": err, "ms": times[kname][1],
         "plain_ms": times[kname][0]}
        for kname, source, replaces, err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
