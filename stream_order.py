#!/usr/bin/env python3
"""Whether the streamed attention paths lose their time to the order of
their grids: the streamed tile (csrc/flash_tile.cuh, row 14's entry) at
[B, 577, 16, 64] for B 4 and 32, and row 13's streamed pair
(csrc/fused_attention.cu) at [16, 592, 1,024] and [128, 592, 1,024],
ViT-L/14 @336's sequence, with 577 valid keys.

    python3 stream_order.py variant SRC DST
    python3 stream_order.py run ROOT OUT.pt
    python3 stream_order.py compare A.pt B.pt [C.pt ...]

``variant`` copies the checkout SRC to DST and reorders two grids there,
and nothing else: the streamed tile's and row 13's row pass, launched as
(heads, images, passes), become (passes, heads, images), so that the
passes of one (head, image) run next to each other and share its K and V
through L2.  It applies to a checkout whose kernels still launch those
grids with 64 query rows a block and two-stage cp.async rings, and says
so where a line it rewrites is missing.  The outputs keep their bits by
construction: every block computes what it did.

``run`` imports patent_tpu_torch from ROOT (its kernels build under
ROOT/build), makes every input from a seed, and saves to OUT.pt the
SHA-256 digest of each output, the CUDA-event wall time a call (20 calls
after 3 of warm-up) and the device time a call by kernel
(torch.profiler), with the card's name and power limit.  At B 4 the
tile's K and V (9.7 MB) fit the 50 MB L2; at B 32 (77.6 MB) they do not,
so a grid that runs every pass 0 before any pass 1 reads them from device
memory once a pass.  ``compare`` prints whether the files hold the same
bits and each file's times and ms per image side by side.  Run each
checkout in its own process (two builds of the kernel library cannot
share one), in turns: parent, variant, variant, parent.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

from chip_smoke import cuda_ms, kernel_breakdown

# (file under patent_tpu_torch/csrc, old text, new text): the two grids
GRID_REORDER = (
    ("flash_tile.cuh",
     "    const int q0 = blockIdx.z * 16 * WARPS;",
     "    const int q0 = blockIdx.x * 16 * WARPS;"),
    ("flash_tile.cuh",
     "        valid_len, hd, scale, blockIdx.x, blockIdx.y, smem);\n"
     "  } else {",
     "        valid_len, hd, scale, blockIdx.y, blockIdx.z, smem);\n"
     "  } else {"),
    ("flash_tile.cuh",
     "      <<<dim3(H, B, passes), THREADS, smem, st>>>(",
     "      <<<STREAM ? dim3(passes, H, B) : dim3(H, B, 1), THREADS, smem, "
     "st>>>("),
    ("fused_attention.cu",
     "  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;\n"
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  const int g = lane >> 2, t = lane & 3;\n"
     "  const int D3 = 3 * D;\n"
     "  const int r0 = (blockIdx.z * WARPS + warp) * 16 + g, r1 = r0 + 8;",
     "  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;\n"
     "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "  const int g = lane >> 2, t = lane & 3;\n"
     "  const int D3 = 3 * D;\n"
     "  const int r0 = (blockIdx.x * WARPS + warp) * 16 + g, r1 = r0 + 8;"),
    ("fused_attention.cu",
     "  attn_bwd_rows<HD><<<dim3(H, B, tiles), THREADS, ring, st>>>(",
     "  attn_bwd_rows<HD><<<dim3(tiles, H, B), THREADS, ring, st>>>("))

TILE_BATCHES = (4, 32)
ROW13_BATCHES = (16, 128)
S, VALID, HEADS, HD = 592, 577, 16, 64


def variant(src: str, dst: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "build", ".git", "__pycache__"))
    csrc = os.path.join(dst, "patent_tpu_torch", "csrc")
    for name, old, new in GRID_REORDER:
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            sys.exit(f"{path}: the line to reorder is not there once:\n{old}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    print(f"{dst}: {src} with the streamed grids' passes on the fastest "
          "axis")


def digest(torch, t) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def run(root: str, out_path: str) -> None:
    import math

    import torch

    if not torch.cuda.is_available():
        sys.exit("stream_order.py run needs a CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from patent_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    d = HEADS * HD
    outs, times, device = {}, {}, {}
    for b in TILE_BATCHES:
        qkv = torch.randn(b, VALID, 3 * d, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v = (t.unflatten(-1, (HEADS, HD)) for t in qkv.split(d, -1))
        name = f"tile, [{b}, {VALID}, {HEADS}, {HD}]"
        with torch.inference_mode():
            outs[name] = digest(torch, fa.flash_attention(q, k, v))
            times[name] = cuda_ms(torch, lambda: fa.flash_attention(q, k, v))
            device[name] = dict(kernel_breakdown(
                torch, lambda: fa.flash_attention(q, k, v)))
        del qkv, q, k, v
    col = torch.ones(3 * d, device=dev)
    col[:d] = math.log2(math.e) / math.sqrt(HD)
    for b in ROW13_BATCHES:
        x = torch.randn(b, S, d, generator=gen, device=dev).to(torch.bfloat16)
        wqkv = (torch.randn(d, 3 * d, generator=gen, device=dev) * d ** -0.5
                * col).to(torch.bfloat16)
        bqkv = 0.2 * torch.randn(3 * d, generator=gen, device=dev) * col
        da = torch.randn(b, S, d, generator=gen, device=dev)
        da[:, VALID:] = 0.0
        da = da.to(torch.bfloat16)
        args = (x, wqkv, bqkv, da, HEADS, VALID)
        name = f"row 13, [{b}, {S}, {d}]"
        for key, t in zip(("dqkv", "A"), fa.fused_attention_bwd(*args)):
            outs[f"{name} {key}"] = digest(torch, t)
        times[name] = cuda_ms(torch, lambda: fa.fused_attention_bwd(*args))
        device[name] = dict(kernel_breakdown(
            torch, lambda: fa.fused_attention_bwd(*args)))
        del x, wqkv, bqkv, da, args
        torch.cuda.empty_cache()
    torch.save({"root": os.path.abspath(root), "card": smi, "outputs": outs,
                "times": times, "device": device}, out_path)
    print(f"{root}: {smi}; " + "; ".join(f"{key} {ms:.4f} ms"
                                         for key, ms in times.items()))


def batch_of(key: str) -> int:
    return int(key.split("[")[1].split(",")[0])


def compare(paths: list[str]) -> None:
    import torch

    runs = [torch.load(p) for p in paths]
    a, b = runs[0]["outputs"], runs[1]["outputs"]
    same = [key for key in a if a[key] == b.get(key)]
    print(f"[order] {paths[0]} against {paths[1]} ({runs[0]['card']}): "
          f"{len(same)} of {len(a)} outputs equal bit for bit")
    for key in runs[0]["times"]:
        print(f"[order] {key} ms a call (ms an image): " + ", ".join(
            f"{os.path.basename(p)} {r['times'][key]:.4f} "
            f"({r['times'][key] / batch_of(key):.5f})"
            for p, r in zip(paths, runs)))
        for kname in runs[0]["device"][key]:
            print(f"[order]   {kname[:60]} device ms: " + ", ".join(
                f"{os.path.basename(p)} {r['device'][key].get(kname, 0):.4f}"
                for p, r in zip(paths, runs)))


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "variant":
        variant(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif len(sys.argv) >= 4 and sys.argv[1] == "compare":
        compare(sys.argv[2:])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
