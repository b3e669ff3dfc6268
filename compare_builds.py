#!/usr/bin/env python3
"""Compare two checkouts of patent_tpu_torch on one CUDA card: the bits and
the times of the int8 MLP sub-layer (row 7), the Möbius dense layer (row
18), the pairwise distance (row 17), the bf16 and int8 ViT-B/16 towers,
the int8 attention sub-layer and its CLS variant (rows 5 and 6), the int8
layer group, dense layer and MLP (rows 9-11), the bucketed candidate
stages (rows 3, 3′ and 4) and both cosine top-10 paths, the fine-tune's
MLP block forward and backward (rows 15 and 16) and attention backward
(row 13), the f32 attention (row 14′), the fine-tune's and
train_end's training steps, and the streamed attention paths at the wide
towers' shapes.

    python3 compare_builds.py run ROOT OUT.pt
    python3 compare_builds.py compare A.pt B.pt [C.pt ...]

``run`` imports patent_tpu_torch from the checkout at ROOT (its kernels
build there, under ROOT/build), makes every input from a seed, and saves
to OUT.pt the outputs and the wall time a call (``chip_smoke.cuda_ms``:
CUDA events, 20 calls after 3 of warm-up) of:

* row 7, ``quant_mlp_block``, on the tokens of a batch of 128 ([128, 208,
  768]) and on the CLS rows of batches of 4 and 1 ([4, 768], [1, 768]);
* row 18, ``mobius_dense_pallas``, at the hyperbolic encoder's [512, 512] x
  [512, 256] (c = 2), on unit features and on features x 0.02; row 17,
  ``pairwise_dist_pallas``, at [256, 128] x [16,059, 128], with its
  device time; the hyperbolic encoder (512 -> 256 -> 128, row 18 its
  first layer) over 20 batches of 512 rows, with its device busy share
  (torch.profiler);
* the bf16 fused-layer tower (seeded ViT-B/16 weights) at B 128 (rows 1
  and 2), then the int8 tower from the same weights at B 128 (rows 5 +
  7), 127, 3 and 1 (row 8, then rows 6 + 7 on the CLS rows);
* rows 5 and 6 on [128, 208, 768] (197 valid keys) and row 6 on [4, 208,
  768]; row 9, ``quant_layer_group``, at B 128; rows 10 and 11,
  ``quant_dense`` (x [26,624 x 768] x [768 x 2,304]; also x [768 x
  3,072] with quick_gelu, and on f32 rows) and ``quant_mlp`` (hidden
  3,072), each with its device time; row 10's s8 GEMM alone at [26,624 x
  768] x [768 x 2,304] in its instance for N % 16 == 0 and its TAIL
  instance (where the checkout has both); row 10 at M 1, 77 and 26,624,
  N 8, 13, 768 and 2,304, bf16 and f32, with and without quick_gelu, its
  outputs saved as SHA-256 digests of their bytes;
* on a seeded 1M x 512 gallery (bf16 and int8 copies): rows 3 and 3′'s
  candidate pools (80 deep) at Q 1, 16 and 256, and the bf16 and the
  quantized top-10 paths at Q 256, each with its device time; row 4's
  pool, its stage's (v1, i1, v2, i2) and the Poincaré top-10 path at 1M x
  128 ball points, Q 256 (c = 2), each with its device time;
* rows 15 and 16, ``fused_mlp_fwd`` and ``fused_mlp_bwd``, on the 128 x
  197 unpadded rows of a fine-tune step at 64 pairs (M 25,216, D 768, F
  3072), and row 13,
  ``fused_attention_bwd``, on its padded stream [128, 208, 768] (12
  heads, 197 valid keys), each output apart, with the device time a call
  (torch.profiler, the sum over kernels);
* one fine-tune step at 64 pairs (ClipFinetuneConfig's defaults, seeded
  ViT-B/16 weights, u8 batches on the card) and one train_end step at 32
  pairs (EndToEndConfig's defaults, seeded labels, pairs and implication
  rows): each first step's metrics, the wall time of a step (10 after 2
  of warm-up) and its device time;
* the streamed attention paths at the wide towers' shapes, as SHA-256
  digests of their outputs: the tile alone at [32, 577, 16, 64] (CLIP
  ViT-L/14 @336), [32, 257, 16, 80] (ViT-H/14's widths) and [32, 257,
  16, 72]; rows 1 and 5 on [32, 592, 1,024]; row 8's cooperative launch,
  forced, on [3, 592, 1,024]; row 13 on [128, 592, 1,024] and [128, 272,
  1,280] (the fine-tune's streams at 64 pairs), each with its device time;

with the card's name and power limit, and the int8 kernels' form it asked
for (PATENT_TPU_FAST_KERNELS, which ``run`` passes on to the checkout: it
runs in this process).  Run each checkout in its own
process: two builds of the kernel library cannot share one.  ``compare``
prints, for each output, whether the first two files hold the same bits
(else the largest difference relative to the largest value) and how many
of the outputs both hold are equal, then every file's times side by
side.  A run of the parent lacks the outputs this checkout added.  To compare a parent commit with a change,
run parent, change, change, parent one after another on the same card,
each from a ``git archive`` of its commit, and compare the four files;
with PATENT_TPU_FAST_KERNELS=0 set for all four, a change that adds the
fast form keeps every output of its parent's exact one.
"""

from __future__ import annotations

import os
import subprocess
import sys

from chip_smoke import cuda_ms, kernel_breakdown, launch_times

SEARCH_ROWS = 1_000_000     # the galleries of rows 3, 3′ and 4


def form() -> str:
    """The int8 kernels' form this process asks for: the checkout's entries
    read PATENT_TPU_FAST_KERNELS from the environment it inherits (a
    checkout from before the fast form computes the exact one whatever it
    says)."""
    return ("PATENT_TPU_FAST_KERNELS="
            + os.environ.get("PATENT_TPU_FAST_KERNELS", "unset"))


def busy_share(torch, fn, wall_ms: float, iters: int = 3) -> float:
    """Device time (torch.profiler, the sum over kernels) of ``iters`` calls
    of ``fn`` over their wall time, ``wall_ms`` a call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages())
    return device / 1e3 / iters / wall_ms


def run(root: str, out_path: str) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_builds.py run needs a CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.models.vit import VIT_B16, VisionTransformer
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import poincare
    from patent_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(10)
    d, f, s, bt = 768, 3072, 208, 128

    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device=dev)

    def mat(rows, cols):
        q, scale = qm.quantize_weight(randn(rows, cols, std=rows ** -0.5))
        return q.T.contiguous(), scale

    w1, s1 = mat(d, f)
    w2, s2 = mat(f, d)
    mlp = (1 + randn(d, std=0.1), randn(d, std=0.1), w1, s1,
           randn(f, std=0.02), w2, s2, randn(d, std=0.02))
    xb = randn(bt, s, d).to(torch.bfloat16)
    outs, times, busy = {}, {}, {}
    for name, x in (("row 7, [128, 208, 768]", xb),
                    ("row 7, CLS rows [4, 768]", xb[:4, 0].contiguous()),
                    ("row 7, CLS rows [1, 768]", xb[:1, 0].contiguous())):
        outs[name] = qm.quant_mlp_block(x, *mlp)
        times[name] = cuda_ms(torch, lambda x=x: qm.quant_mlp_block(x, *mlp))

    c, n, k, dh = 2.0, 512, 512, 256
    lim = (6.0 / (k + dh)) ** 0.5
    w18 = (2.0 * torch.rand(k, dh, generator=gen, device=dev) - 1.0) * lim
    b18 = poincare.expmap0(randn(dh, std=1e-3), c).contiguous()
    x18 = randn(n, k)
    for name, x in (("row 18, unit features", x18),
                    ("row 18, features x 0.02", 0.02 * x18)):
        outs[name] = pk.mobius_dense_pallas(x, w18, b18, c)
        times[name] = cuda_ms(
            torch, lambda x=x: pk.mobius_dense_pallas(x, w18, b18, c))
    # ball points, radii up to 0.95 of the ball's
    x17, y17 = (randn(m, 128) for m in (256, 16059))
    x17, y17 = (v / v.norm(dim=-1, keepdim=True) * 0.95 / c ** 0.5
                * torch.rand(v.shape[0], 1, generator=gen, device=dev)
                for v in (x17, y17))
    name = "row 17"
    outs[name] = pk.pairwise_dist_pallas(x17, y17, c)
    times[name] = cuda_ms(torch, lambda: pk.pairwise_dist_pallas(x17, y17, c))
    device = {name: sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: pk.pairwise_dist_pallas(x17, y17, c), 30))}
    model = HyperbolicEmbeddingModel(
        feature_dim=k, embed_dim=128, hidden_dims=(dh,), c=c,
        generator=torch.Generator().manual_seed(2018)).to(dev).eval()
    feats = randn(20 * n, k)

    def encode():
        with torch.no_grad():
            return torch.cat([model(feats[i:i + n])
                              for i in range(0, feats.shape[0], n)])

    name = "hyperbolic encoder, 20 batches of 512 rows"
    outs[name] = encode()
    times[name] = cuda_ms(torch, encode, iters=10)
    busy[name] = busy_share(torch, encode, times[name])

    tower = VisionTransformer(VIT_B16, generator=torch.Generator()
                              .manual_seed(2018)).to(dev).eval()
    pix = randn(bt, 224, 224, 3)
    name = f"bf16 tower, B {bt}"

    def bf16_tower():
        with torch.inference_mode():
            return tower(pix)

    outs[name] = bf16_tower()
    times[name] = cuda_ms(torch, bf16_tower)
    tower8 = Int8VisionTransformer.from_float(tower).eval()
    del tower
    for b in (bt, bt - 1, 3, 1):
        name = f"int8 tower, B {b}"

        def tower_at(pv=pix[:b]):
            with torch.inference_mode():
                return tower8(pv)

        outs[name] = tower_at()
        times[name] = cuda_ms(torch, tower_at)
    del tower8, pix
    device.update(int8_family(torch, randn, mat, outs, times))
    device.update(search(torch, dev, gen, outs, times))
    device.update(fine_tune(torch, dev, randn, outs, times))
    device.update(attention_rows(torch, dev, outs, times))
    device.update(wide_attention(torch, dev, outs, times))
    torch.cuda.synchronize()
    torch.save({"root": os.path.abspath(root), "card": smi, "form": form(),
                "outputs": {key: v.cpu() for key, v in outs.items()},
                "times": times, "busy": busy, "device": device}, out_path)
    print(f"{root}: {smi}; {form()}; " + "; ".join(
        f"{key} {ms:.4f} ms" for key, ms in times.items()))


def timed(torch, name: str, fn, outs: dict, times: dict, device: dict,
          iters: int = 20) -> None:
    """``fn``'s output (or outputs) into ``outs``, its wall time a call into
    ``times`` and its device time a call (torch.profiler, the sum over
    kernels) into ``device``."""
    got = fn()
    for i, v in enumerate(got if isinstance(got, tuple) else (got,)):
        outs[name if not isinstance(got, tuple) else f"{name} [{i}]"] = v
    times[name] = cuda_ms(torch, fn, iters=iters)
    device[name] = sum(ms for _k, ms in kernel_breakdown(torch, fn))


def attention_rows(torch, dev, outs: dict, times: dict) -> dict:
    """The entries of csrc/flash_tile.cuh's tile alone at ViT-B/16 @224:
    rows 1 and 2 on [128, 208, 768] (197 valid keys, seeded weights), row
    12's forward on the same stream and row 14 on the use_flash tower's
    q, k, v [128, 197, 12, 64] (slices of one qkv tensor), bf16; and row
    14′, the f32 kernel, on the same q, k, v in f32; returns the device
    time a call of each."""
    from patent_tpu_torch.ops import bf16_layer
    from patent_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(21)
    d, f, s, bt, valid, heads = 768, 3072, 208, 128, 197, 12

    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device=dev)

    def m(rows, cols):
        return randn(rows, cols, std=rows ** -0.5).to(torch.bfloat16)

    p = (1 + randn(d, std=0.1), randn(d, std=0.1), m(d, 3 * d),
         randn(3 * d, std=0.2), m(d, d), randn(d, std=0.02),
         1 + randn(d, std=0.1), randn(d, std=0.1), m(d, f),
         randn(f, std=0.02), m(f, d), randn(d, std=0.02))
    folded = bf16_layer.fold_layer(*p, heads)
    x = randn(bt, s, d).to(torch.bfloat16)
    wqkv = bf16_layer.fold_q_matrix(p[2].float(), heads).to(torch.bfloat16)
    bqkv = randn(3 * d, std=0.2)
    qkv = randn(bt, valid, 3 * d).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (heads, d // heads))
               for t in qkv.split(d, dim=-1))
    device = {}
    for name, fn in (
            ("row 1, [128, 208, 768]", lambda: bf16_layer.
             fused_layer_block_bf16(x, *p, heads, valid_len=valid,
                                    folded=folded)),
            ("row 2, [128, 208, 768]", lambda: bf16_layer.
             fused_layer_cls_bf16(x, *p, heads, valid_len=valid,
                                  folded=folded)),
            ("row 12 forward, [128, 208, 768]", lambda: fa.
             fused_attention_fwd(x, wqkv, bqkv, p[4], p[5], heads, valid)),
            ("row 14, [128, 197, 12, 64] bf16",
             lambda: fa.flash_attention(q, k, v))):
        timed(torch, name, fn, outs, times, device)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    timed(torch, "row 14′, [128, 197, 12, 64] f32",
          lambda: fa.flash_attention(q32, k32, v32), outs, times, device)
    return device


def wide_attention(torch, dev, outs: dict, times: dict) -> dict:
    """The streamed attention paths at the wide towers' shapes, their
    outputs as SHA-256 digests: the tile alone (row 14's entry) on q, k, v
    slices of one qkv tensor at [32, 577, 16, 64] (CLIP ViT-L/14 @336),
    [32, 257, 16, 80] (ViT-H/14's widths) and [32, 257, 16, 72] (8 zero
    columns); rows 1 and 5 on [32, 592, 1,024] (577 valid keys, seeded
    weights); row 8's cooperative launch, forced, on [3, 592, 1,024]; row
    13 on the fine-tune's streams at 64 pairs, [128, 592, 1,024] and
    [128, 272, 1,280]; returns the device time a call of each."""
    import math
    from unittest import mock

    from patent_tpu_torch.ops import bf16_layer
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device=dev)

    device = {}

    def timed_digest(name, fn, iters=20):
        got = fn()
        for i, v in enumerate(got if isinstance(got, tuple) else (got,)):
            key = name if not isinstance(got, tuple) else f"{name} [{i}]"
            outs[f"{key} (sha256)"] = sha256(torch, v)
        del got
        times[name] = cuda_ms(torch, fn, iters=iters)
        device[name] = sum(ms for _k, ms in kernel_breakdown(torch, fn))

    for b, s, heads, hd in ((32, 577, 16, 64), (32, 257, 16, 80),
                            (32, 257, 16, 72)):
        d = heads * hd
        q, k, v = (t.unflatten(-1, (heads, hd))
                   for t in randn(b, s, 3 * d).to(bf).split(d, dim=-1))
        timed_digest(f"tile, [{b}, {s}, {heads}, {hd}]",
                     lambda: fa.flash_attention(q, k, v))
        del q, k, v
    d, heads, s, valid = 1024, 16, 592, 577

    def m(rows, cols):
        return randn(rows, cols, std=rows ** -0.5).to(bf)

    def q8(rows, cols):
        w, scale = qm.quantize_weight(randn(rows, cols, std=rows ** -0.5))
        return w.T.contiguous(), scale

    p = (1 + randn(d, std=0.1), randn(d, std=0.1), m(d, 3 * d),
         randn(3 * d, std=0.2), m(d, d), randn(d, std=0.02),
         1 + randn(d, std=0.1), randn(d, std=0.1), m(d, 4 * d),
         randn(4 * d, std=0.02), m(4 * d, d), randn(d, std=0.02))
    folded = bf16_layer.fold_layer(*p, heads)
    wqkv, sqkv = q8(d, 3 * d)
    wout, sout = q8(d, d)
    w1, s1 = q8(d, 4 * d)
    w2, s2 = q8(4 * d, d)
    attn = (p[0], p[1], wqkv, sqkv, p[3], wout, sout, p[5])
    mlp = (p[6], p[7], w1, s1, p[9], w2, s2, p[11])
    x = randn(32, s, d).to(bf)
    timed_digest("row 1, [32, 592, 1024]", lambda: bf16_layer.
                 fused_layer_block_bf16(x, *p, heads, valid_len=valid,
                                        folded=folded))
    timed_digest("row 5, [32, 592, 1024]", lambda: qm.quant_attention_block(
        x, *attn, heads, valid_len=valid))
    with mock.patch.object(qm, "layer_plan",
                           lambda *a: qm.LayerPlan(True, 1, 2)):
        timed_digest("row 8 cooperative launch, [3, 592, 1024]",
                     lambda: qm.quant_layer_block(x[:3], *attn, *mlp, heads,
                                                  valid_len=valid))
    del p, folded, attn, mlp, x
    for b, s, d, heads, valid in ((128, 592, 1024, 16, 577),
                                  (128, 272, 1280, 16, 257)):
        col = torch.ones(3 * d, device=dev)
        col[:d] = math.log2(math.e) / math.sqrt(d // heads)
        wq = (randn(d, 3 * d, std=d ** -0.5) * col).to(bf)
        bq = randn(3 * d, std=0.2) * col
        xa = randn(b, s, d).to(bf)
        da = randn(b, s, d)
        da[:, valid:] = 0.0
        da = da.to(bf)
        timed_digest(f"row 13, [{b}, {s}, {d}]", lambda: fa.
                     fused_attention_bwd(xa, wq, bq, da, heads, valid))
        del wq, xa, da
        torch.cuda.empty_cache()
    return device


def sha256(torch, t):
    """The SHA-256 digest of a tensor's bytes, as 32 uint8."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return torch.frombuffer(bytearray(hashlib.sha256(raw).digest()),
                            dtype=torch.uint8)


def int8_family(torch, randn, mat, outs: dict, times: dict) -> dict:
    """Rows 5, 6, 9, 10 and 11 at a batch of 128's shapes: their outputs
    and wall times into ``outs`` and ``times``; returns the device time a
    call of each."""
    from patent_tpu_torch.ops import quant_matmul as qm

    d, f, s, bt, valid, heads = 768, 3072, 208, 128, 197, 12
    device = {}
    wqkv, sqkv = mat(d, 3 * d)
    wout, sout = mat(d, d)
    w1, s1 = mat(d, f)
    w2, s2 = mat(f, d)
    attn = (1 + randn(d, std=0.1), randn(d, std=0.1), wqkv, sqkv,
            randn(3 * d, std=0.2), wout, sout, randn(d, std=0.02))
    mlp = (1 + randn(d, std=0.1), randn(d, std=0.1), w1, s1,
           randn(f, std=0.02), w2, s2, randn(d, std=0.02))
    x = randn(bt, s, d).to(torch.bfloat16)
    timed(torch, "row 5, [128, 208, 768]",
          lambda: qm.quant_attention_block(x, *attn, heads, valid), outs,
          times, device)
    for b in (bt, 4):
        timed(torch, f"row 6, [{b}, 208, 768]",
              lambda b=b: qm.quant_attention_cls(x[:b], *attn, heads, valid),
              outs, times, device)
    timed(torch, "row 9, B 128",
          lambda: qm.quant_layer_group(x, *attn, *mlp, heads, valid), outs,
          times, device)
    x2 = x.reshape(-1, d)
    timed(torch, "row 10, [26,624 x 768] x [768 x 2,304]",
          lambda: qm.quant_dense(x2, wqkv, sqkv, attn[4]), outs, times,
          device)
    # the larger outputs below are kept as digests (see sha256)
    x2f = x2.float()
    for name, fn in (
            ("row 10, [26,624 x 768] x [768 x 3,072], quick_gelu",
             lambda: qm.quant_dense(x2, w1, s1, mlp[4], "quick_gelu")),
            ("row 10, f32 rows [26,624 x 768] x [768 x 2,304]",
             lambda: qm.quant_dense(x2f, wqkv, sqkv, attn[4]))):
        timed(torch, name, fn, outs, times, device)
        outs[f"{name} (sha256)"] = sha256(torch, outs.pop(name))
    del x2f
    # the GEMM alone at row 10's main shape: the instance for N % 16 == 0
    # and the TAIL instance (any N), on the same codes
    if "bias_tail" in qm.S8_GEMM_EPILOGUES:
        xq, xs = qm.quant_rows(x2.float())
        xs = xs.reshape(-1)
        for epi in ("bias", "bias_tail"):
            name = f"s8 GEMM {epi}, [26,624 x 768] x [768 x 2,304]"
            timed(torch, name, lambda epi=epi: qm.int8_gemm(
                xq, xs, wqkv, sqkv, attn[4], epi), outs, times, device)
            outs[f"{name} (sha256)"] = sha256(torch, outs.pop(name))
        print("s8 GEMM at row 10's main shape: the TAIL instance's output "
              "equals the N % 16 == 0 instance's bit for bit: " + str(
                  torch.equal(*(outs[f"s8 GEMM {epi}, [26,624 x 768] x "
                                     "[768 x 2,304] (sha256)"]
                                for epi in ("bias", "bias_tail")))))
        del xq, xs
    # row 10 at every shape of the card tests, its outputs as SHA-256
    # digests of their bytes (equal digests: equal bits)
    for m in (1, 77, 26624):
        for n in (8, 13, 768, 2304):
            w, ws = wqkv[:n].contiguous(), sqkv[:n].contiguous()
            b = attn[4][:n].contiguous()
            for dname, dtype in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32)):
                for act in (None, "quick_gelu"):
                    out = qm.quant_dense(x2[:m].to(dtype), w, ws, b, act)
                    outs[f"row 10, M {m}, N {n}, {dname}, {act} (sha256)"] = \
                        sha256(torch, out)
    timed(torch, "row 11, [26,624 x 768], hidden 3,072",
          lambda: qm.quant_mlp(x2, w1, s1, mlp[4], w2, s2, mlp[7]), outs,
          times, device)
    return device


def search(torch, dev, gen, outs: dict, times: dict) -> dict:
    """Rows 3, 3′ and 4 and the two cosine top-10 paths on seeded
    galleries: outputs and wall times into ``outs`` and ``times``; returns
    the device time a call of each."""
    from patent_tpu_torch.ops import topk_kernel as tk
    from patent_tpu_torch.retrieval import index as index_mod

    n, dg, pool, k = SEARCH_ROWS, 512, 80, 10
    device = {}
    gal = torch.randn(n, dg, generator=gen, device=dev)
    g16, gvalid = tk.prepare_cosine_gallery_bf16(gal)
    gi8, gscale = (torch.from_numpy(a).to(dev) for a in
                   tk.quantize_gallery(gal.cpu().numpy()))
    q256 = torch.randn(256, dg, generator=gen, device=dev)
    for nq in (256, 16, 1):
        q = q256[:nq]
        qi8, qscale = tk.quantize_queries(q)
        timed(torch, f"row 3, Q {nq}",
              lambda q=q: tk.bucket_topk_bf16(q, g16, gvalid, pool), outs,
              times, device)
        timed(torch, f"row 3′, Q {nq}",
              lambda qi8=qi8, qscale=qscale: tk.bucket_topk_int8(
                  qi8, qscale, gi8, gscale, pool), outs, times, device)
    timed(torch, "bf16 top-10 path, Q 256",
          lambda: index_mod.topk_search_cosine_fast(q256, g16, gvalid, gal,
                                                    k=k), outs, times,
          device)
    timed(torch, "quantized top-10 path, Q 256",
          lambda: index_mod.topk_search_quantized(q256, gi8, gscale, gal,
                                                  k=k), outs, times, device)
    del gal, g16, gvalid, gi8, gscale
    c, dh = 2.0, 128
    ball = torch.randn(n, dh, generator=gen, device=dev)
    ball = (ball / ball.norm(dim=-1, keepdim=True) * 0.95 / c ** 0.5
            * torch.rand(n, 1, generator=gen, device=dev))
    qb = ball[:256] * 0.99
    pgal = tk.prepare_poincare_gallery(ball, c)
    timed(torch, "row 4, 1M x 128, Q 256",
          lambda: tk.bucket_topk_poincare(qb, pgal, pool), outs, times,
          device)
    terms = tk.quantize_poincare_queries(qb)
    name = "row 4's stage (v1, i1, v2, i2), 1M x 128, Q 256"
    timed(torch, name, lambda: tk._bucket_top2_poincare_cuda(*terms, pgal),
          outs, times, device)
    # the stage kernel's mean over the launches the trace saw (a sum over
    # calls undercounts when the trace drops a launch)
    device[f"{name}, the stage kernel a launch"] = next(
        ms for kname, ms, _n in launch_times(
            torch, lambda: tk._bucket_top2_poincare_cuda(*terms, pgal), 30)
        if "bucket_top2" in kname and "merge" not in kname)
    timed(torch, "Poincaré top-10 path, Q 256",
          lambda: index_mod.topk_search_poincare_fast(qb, pgal, ball, k=k,
                                                      c=c), outs, times,
          device)
    return device


def fine_tune(torch, dev, randn, outs: dict, times: dict) -> dict:
    """Rows 15, 16 and 13 at a fine-tune step's shapes, then the step and a
    train_end step (EndToEndConfig's 32 pairs, seeded labels and pairs):
    their outputs and wall times into ``outs`` and ``times``; returns the
    device time a call of each (torch.profiler)."""
    import math

    import numpy as np

    from patent_tpu_torch.models.vit import VIT_B16
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.train import train_end as te
    from patent_tpu_torch.train.finetune_clip import (init_finetune_state,
                                                      make_finetune_step)
    from patent_tpu_torch.utils.config import (ClipFinetuneConfig,
                                               EndToEndConfig)

    bf = torch.bfloat16
    d, f, s, bt, valid, heads = 768, 3072, 208, 128, 197, 12
    device = {}
    x2 = randn(bt * valid, d).to(bf)
    do2 = randn(bt * valid, d).to(bf)
    mlp = (1 + randn(d, std=0.1), randn(d, std=0.1),
           randn(d, f, std=d ** -0.5).to(bf), randn(f, std=0.02),
           randn(f, d, std=f ** -0.5).to(bf))
    b2 = randn(d, std=0.02)
    name = "row 15, M 25,216"
    outs[name] = mm.fused_mlp_fwd(x2, *mlp, b2)
    times[name] = cuda_ms(torch, lambda: mm.fused_mlp_fwd(x2, *mlp, b2))
    device[name] = sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: mm.fused_mlp_fwd(x2, *mlp, b2)))
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for key, v in zip(names, mm.fused_mlp_bwd(x2, do2, *mlp)):
        outs[f"row 16, {key}"] = v
    name = "row 16, M 25,216"
    times[name] = cuda_ms(torch, lambda: mm.fused_mlp_bwd(x2, do2, *mlp))
    device[name] = sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: mm.fused_mlp_bwd(x2, do2, *mlp)))
    del x2, do2
    col = torch.ones(3 * d, device=dev)
    col[:d] = math.log2(math.e) / 8.0        # the fold of log2(e)/sqrt(64)
    wqkv = (randn(d, 3 * d, std=d ** -0.5) * col).to(bf)
    bqkv = randn(3 * d, std=0.2) * col
    xa = randn(bt, s, d).to(bf)
    da = randn(bt, s, d)
    da[:, valid:] = 0.0
    da = da.to(bf)
    for key, v in zip(("dqkv", "A"), fa.fused_attention_bwd(
            xa, wqkv, bqkv, da, heads, valid)):
        outs[f"row 13, {key}"] = v
    name = "row 13, [128, 208, 768]"
    times[name] = cuda_ms(torch, lambda: fa.fused_attention_bwd(
        xa, wqkv, bqkv, da, heads, valid))
    device[name] = sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: fa.fused_attention_bwd(xa, wqkv, bqkv, da, heads,
                                              valid)))
    del xa, da
    cfg = ClipFinetuneConfig()
    table = np.random.default_rng(0).standard_normal((192, 128)).astype(
        np.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (2 * cfg.batch_size, 224, 224, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    nodes = torch.randint(0, 192, (cfg.batch_size,), generator=gen,
                          device=dev)
    model, opt = init_finetune_state(VIT_B16, cfg, table, seed=0,
                                     device=dev)
    step, _eval_step = make_finetune_step(model, opt)
    metrics = step(images, nodes, cfg.alpha_max)
    outs["fine-tune step, first step's metrics"] = torch.tensor(
        [float(metrics[key]) for key in sorted(metrics)])
    name = f"fine-tune step, {cfg.batch_size} pairs"
    times[name] = cuda_ms(torch, lambda: step(images, nodes, cfg.alpha_max),
                          warmup=2, iters=10)
    device[name] = sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: step(images, nodes, cfg.alpha_max)))
    del model, opt, step, images
    ecfg = EndToEndConfig()
    labels, patents = 2048, 1024
    model, opt = te.init_end_to_end(VIT_B16, ecfg, labels, seed=0,
                                    device=dev)
    estep, _loss = te.make_end_to_end_step(model, opt, ecfg)
    pix = torch.randn(2 * ecfg.batch_size, 224, 224, 3, generator=gen,
                      device=dev)
    pos = torch.randint(0, patents, (ecfg.batch_size,), generator=gen,
                        device=dev)
    neg = torch.randint(0, patents, (ecfg.batch_size, 2), generator=gen,
                        device=dev)
    impl = torch.randint(patents, labels, (4096, 2), generator=gen,
                         device=dev)
    dgen = torch.Generator(device=dev).manual_seed(3)
    metrics = estep(pix, pos, neg, impl, dgen)
    outs["train_end step, first step's metrics"] = torch.tensor(
        [float(metrics[key]) for key in sorted(metrics)])
    name = f"train_end step, {ecfg.batch_size} pairs"
    times[name] = cuda_ms(torch, lambda: estep(pix, pos, neg, impl, dgen),
                          warmup=2, iters=10)
    device[name] = sum(ms for _k, ms in kernel_breakdown(
        torch, lambda: estep(pix, pos, neg, impl, dgen)))
    return device


def compare(paths: list[str]) -> None:
    import torch

    runs = [torch.load(p) for p in paths]
    a, b = runs[0]["outputs"], runs[1]["outputs"]
    print(f"[compare] {paths[0]} against {paths[1]} ({runs[0]['card']}; "
          + ", ".join(r.get("form", "PATENT_TPU_FAST_KERNELS=unset")
                      for r in runs[:2]) + ")")
    differ = []
    for key in a:
        if key not in b:
            print(f"[compare] {key}: only in {paths[0]}")
            continue
        x, y = a[key].float(), b[key].float()
        if torch.equal(a[key], b[key]):
            print(f"[compare] {key}: equal bit for bit")
        elif key.endswith("(sha256)"):
            differ.append(key)
            print(f"[compare] {key}: differs")
        else:
            differ.append(key)
            gap = float((x - y).abs().max() / y.abs().max())
            print(f"[compare] {key}: differs, max |a - b| / max |b| "
                  f"{gap:.3g}")
    shared = sum(key in b for key in a)
    print(f"[compare] {shared - len(differ)} of {shared} shared outputs "
          f"equal bit for bit" + (f"; differ: {differ}" if differ else ""))
    for key in runs[0]["times"]:
        print(f"[compare] {key} ms a call: " + ", ".join(
            f"{os.path.basename(p)} {r['times'][key]:.4f}"
            for p, r in zip(paths, runs) if key in r["times"]))
    for key in runs[0].get("device", {}):
        print(f"[compare] {key} device ms a call: " + ", ".join(
            f"{os.path.basename(p)} {r['device'][key]:.4f}"
            for p, r in zip(paths, runs) if key in r["device"]))
    for key in runs[0]["busy"]:
        print(f"[compare] {key}, device busy share: " + ", ".join(
            f"{os.path.basename(p)} {100 * r['busy'][key]:.1f}%"
            for p, r in zip(paths, runs)))


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif len(sys.argv) >= 4 and sys.argv[1] == "compare":
        compare(sys.argv[2:])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
