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
   matrix's per-channel scales replaced by their mean; for the bf16
   layers the earlier max-subtracted form, with exp gelu); each
   CLS kernel
   equal to row 0 of its full kernel bit for bit (the int8 one also at B 4
   and 128); the bf16 and the int8
   bucket top-k at Q=64 on 1M x 512 and 1,000 x 512 galleries (the int8
   stage equal to its plain version), re-ranked top-10 against the f32
   scan, then both stages at Q = 1, 3, 65, 256 and 300 on the same two
   galleries with masked rows and planted ties (int8 equal to its plain
   version; bf16 values within 1e-5, columns equal but at ties within it;
   the capacity; the tie to the earlier copy; top-10 at Q 256 against the
   scan), with a fold with '>=' and one that drops a step as controls that
   must fail the tie and the pool checks; the bf16 and the int8 towers with kernels against the same
   towers with plain layers, and the int8 tower against the bf16 tower;
   the fine-tune's trainable attention sub-layer and MLP block, forward
   and backward (given the same cotangent), at a training step's shapes
   (B=128; the MLP on 128 x 197 rows, several backward chunks) and with
   most keys pad, with their controls (no key mask, a bias zeroed, no
   clamp gate where scores pass +80, the LayerNorm's term of dx dropped,
   the ragged last rows or the last chunk's rows dropped; row 16 on the
   25,216 rows in one chunk, its weight gradients split over the rows;
   row 15 also at 64 and 77 rows and at the CLIs' small tower's D 64,
   F 128);
   the hyperbolic
   kernels at the Poincaré path's shapes: the Möbius dense layer at
   [512, 512] x [512, 256] (control: no bias), the pairwise distance at
   [256, 128] x [16,059, 128] (control: c off by 1%), there at n 1 and at
   d 5 (rows not 16-byte aligned), and on points at radius 0.999/sqrt(c)
   held to the f64 distance, the Poincaré bucket
   stage at 1M x 128, Q=256, pool 80, equal to its plain version (control:
   no b term), and at Q = 1, 3, 65, 256 and 300 over 1,000 and 1M rows
   with masked rows (w = 0) and a planted tie, equal to its plain version
   with the capacity and the tie to the earliest copy (control: a fold
   with '>='); the whole int8 layer at B=1 and 3 (one cooperative launch)
   and 127 (a chain of launches) and its group dispatch at
   B=2 (whole layer) and 3 (the sub-layers), with the controls of both
   sub-layers and the other mid-layer residual (rows 5 + 7 chained, bf16,
   must fail the whole layer's gate); the int8 dense layer at [26,624 x
   768] x [768 x 2304] and x [768 x 3072] with quick_gelu, and on f32
   rows, at one row, and at an output width of 13;
   the int8 MLP at [26,624 x 768], hidden 3072, and at one row and an
   output width of 13; the int8 MLP sub-layer
   (row 7) at the CLS call's 1, 3, 4 and 128 rows and at 26,624, and its
   MLP in alone, whose hidden, row maxima (taken in the GEMM's epilogue)
   and one-pass codes must equal the plain epilogue's and quant_rows' of
   its own hidden bit for bit; the standalone attention
   (row 14) on q, k, v [16, 197, 12, 64] and [16, 64, 12, 64] read as
   slices of one qkv tensor (controls: q unscaled, the zero keys up to the
   next multiple of 16 counted) and with q x 40, where ~8% of the scores
   pass +80 (control: no clamp), and its f32 instance on f32 q, k, v
   (control: q unscaled); the int8 layers' GEMM (csrc/wgmma_s8.cuh)
   alone, each of its five epilogues at 208, 624 and 26,624 rows, equal to
   its plain epilogue bit for bit (control: the bias dropped); the bf16
   layers' GEMM (csrc/wgmma_gemm.cuh) alone, each of its four epilogues at
   26,624 and 416 rows (control: the bias dropped);
4. the slices end to end through the CLI: encode, retrieve --k 20 and
   eval on a 224 px synthetic corpus (60 patents x 6 figures) with seeded
   ViT-B/16 weights saved as a clip_finetune_best checkpoint, first with
   the bf16 tower and then with --quantize, then eval --profile
   recommended (int8, the 175 darkest patches: S 176), and an
   EmbeddingIndex(quantized=True) over the int8-encoded gallery; then
   the CLI's small tower and a narrow index, which the JAX package
   serves: eval --synthetic, bf16 and --quantize, on a 64 px corpus (D 64
   over 4 heads: the attention kernels' head_dim-16 instances) held to
   the same run on the CPU by gallery features (bf16: and the battery),
   and an EmbeddingIndex at D 100 over 200,000 rows (bf16, int8,
   Poincaré; the candidate copies zero-padded to the kernels' widths)
   equal to the exact rankings; the serve action over the 224 px corpus,
   bf16 and then --quantize, in this process through the helper the CLI
   calls: /healthz and /stats, features of three gallery rows (each top-1
   itself, equal to EmbeddingIndex.search), a name and an image_path
   query of a gallery file (each top-1 itself), 8 concurrent clients x 8
   requests (each answer equal to the same request alone, fewer
   dispatches than requests), a malformed body (400); then the CLI's
   serve as a process of its own, which must answer /healthz and a
   search; then the composed pipeline on the port alone:
   train_class_pro --epochs 3 on the CLI's graph, exporting its figures'
   graph embeddings, finetune --epochs 1, ViT-B/16 on a 224 px corpus
   (48 patents x 4 figures: two steps of 64 pairs) aligned to that
   export and started by --checkpoint from an HF CLIP directory (its
   starting tower equal in bits to the directory's weights), and eval
   serving the checkpoint it wrote (before it, the HF directory: the
   seeded ViT-B/16 weights of the slice and a seeded TEXT_B tower written
   as model.safetensors and as pytorch_model.bin, each read back equal in
   bits, and eval --checkpoint, bf16 and --quantize, whose gallery
   features must equal in bits those of the same weights served as
   clip_finetune_best); then the hyperbolic
   serving path: infer and dist on a
   DeepPatent-2018-scale prepared_training_data (16,059 patents x 2
   figures, CLIP-width features of 512) with a seeded checkpoint of the
   HypTrainConfig model (512 -> 256 -> 128, c = 2) in the JAX layout, and
   a HyperbolicRetrievalEngine(quantized=True) over 1M feature rows
   answering 256 queries at k = 10, held by recall to the exact f64
   ranking over the whole gallery; then the hyperbolic trainers through
   the CLI on the same prepared data at HypTrainConfig's defaults:
   train_hyp --epochs 2, then --resume --epochs 3, against a fresh
   --epochs 3 (histories, latest and best params equal in bits), one
   validate_with=map epoch (rows 17 and 18 inside the trainer), row 17 on
   the trained label table against the f64 distance, infer and a
   quantized HyperbolicRetrievalEngine over the trained checkpoint
   (recall@10 against the exact f64 ranking beside the seeded model's),
   and train_hyp_con --epochs 2 (its loss finite and
   falling); then the one-dispatch loops as CUDA graphs
   (patent_tpu_torch/utils/graphs.py), each against its eager loop in
   bits: train_hyp's make_epoch_step at HypTrainConfig's defaults over
   the 2018-scale table (dropout on, row 18 captured in the validation
   epoch), train_hyp_con at its defaults, train_hmi, the GCN pair
   classifier (sparse) and train_vgae (dense, sampled) on small graphs,
   and the scan encoder through RetrievalEngine(batch_size=128,
   scan_batches=4) at ViT-B/16 over 672 images (a full stack and a tail of
   2 batches), bf16 (rows 1-2) and int8 (rows 5 + 7), beside the eager
   stack and the per-batch engine, and the int8 scan at B 3 (row 8's
   cooperative launch captured); then the
   joint CLIP + hyperbolic trainer at EndToEndConfig's defaults (ViT-B/16
   @224, 32 pairs, the last 9 blocks, a head of 256 over the 16,074
   labels): one step with the kernels (rows 12, 13, 15, 16) against one
   with the plain blocks from the same weights and dropout generator
   (metrics within 2e-3, the tower's gradients given one cotangent
   within 2e-2 beside a pixel-noise yardstick, blocks 0-2 equal in bits
   after the step, every label row inside the ball), train_end --epochs
   2 through the CLI (its 32 px tower: S 17, head_dim 16), train_hmi on
   the hyperbolic data's graph (2 epochs: the loss finite and falling;
   label scores), the same graph (48,192 nodes): train_class_pro's
   trainer for 2 epochs at GCNTrainConfig's widths (the sparse path) and
   its export, evaluate_embeddings of the exported rows on the card held
   to the host's (cosine ratios within 1e-4 relative, Hit@k within 1e-2),
   spmm against the dense product of 8,192 rows and equal in bits twice,
   train_vgae_link_prediction on the sampled objective; train --model
   VGAE through the CLI on the CLI's graph, and plot on a train_hyp
   checkpoint (without matplotlib it says no figure was written); then
   the text stage: TEXT_B (vocab 49,408, context 77, 12 layers of 512,
   f32) from the HF directory on the card against the same weights on the
   CPU (row relative error within 1e-4; the tower without its causal mask
   as a control that must fail), a BPE vocabulary directory through
   build_text_feature_dicts (the regex module's pattern or the re
   fallback, printed), USPTO-style fixed-width CPC lines of the graph's
   codes through parse_cpc_definitions_fixed_width, the 2018-scale
   graph's patent and CPC rows filled from the tower (16,059 titles) and
   one train_class_pro epoch on that matrix; the int8
   tower through a
   RetrievalEngine at batch_size 3 (the whole-layer kernel) over the 224 px
   gallery, held to the same gallery at batch 32 by min feature cosine
   beside a pixel-noise yardstick, and with PATENT_TPU_FAST_KERNELS=0 at
   batch 3 and 128 (the exact form) against the card's default, the fast
   form, by min feature cosine; the int8 family's public entries
   (quant_layer_group, int8_dense, quant_mlp) on the tower's tokens, in
   each form; the
   per-op towers (VisionTransformer(fused_layer=False) with use_flash, row
   14, and with fused_block, row 12's forward) through a RetrievalEngine
   at batch 32 (encode_dataset, rank_queries, evaluate), each held to the
   same tower with kernels=False and by min cosine to the fused-layer
   tower; the f32 use_flash tower (row 14's f32 instance) through a
   RetrievalEngine, held to itself with kernels=False and by min cosine
   to the bf16 fused-layer tower; the bf16 fused-layer tower through a
   RetrievalEngine at batch_size 3, where every layer is JAX's per-op
   composition and rows 1 and 2 must launch 0 times, held to batch 32 by min cosine; a backward
   through HyperbolicEmbeddingModel on the card (finite gradients, row 18
   not launched under grad, launched under no_grad); every other kernel's
   launch count over its path must be > 0;
4b. multi-GPU (patent_tpu_torch/parallel; the machine has one card): a
   one-rank NCCL world, in which every sharded search (the four
   functions and EmbeddingIndex(mesh=...)) equals EmbeddingIndex.search
   at 200k rows and rows 3, 3′ and 4 launch; then two gloo ranks sharing
   the card (NCCL refuses two ranks on one device): the three candidate
   paths at 1M x 512 and 1M x 128, 500k rows a rank, equal to the
   one-process index, each rank's launches printed; encode_sharded of
   the bf16 and int8 ViT-B/16 towers at global B 128 and 6, equal in bits
   to one process or within the tower gate, with the function each
   rank's padded block took; the sharded fine-tune step at 2 x 16 pairs
   against one process at 32 (metrics within 2e-3, the tower's updates
   by cosine); the sharded train_hyp step (model 1 and 2, dropout on)
   within the CPU tests' tolerances; the ranks' launches join the kernels
   line;
5. times (CUDA events): the bf16 and the int8 tower img/s at batch 128
   (the int8 tower in both forms in turns, and at 1, 3 and 127),
   the three per-op bf16 towers and the f32 use_flash tower (row 14's f32
   instance) at batch 128, the fused-layer bf16 tower
   at batch 3 (composition) and 127, row 14 at [128, 197, 12, 64] in bf16
   and f32 against its plain version and F.scaled_dot_product_attention,
   rows 1-2 on weights folded once, row 1's four GEMM instances beside
   torch.matmul of the same bf16 product (a yardstick),
   row 7's device time by kernel at batch 128 (LN2 + quantization, MLP
   in, the hidden's quantization, MLP out),
   rows 11 and 4's device time by kernel at their main-path shapes,
   the int8 tower at batch 1 (ms), 3 and 127 (img/s), each with its
   profile, one int8 layer at B=1, 3 and 127 through the whole-layer
   kernel (with its bound, and at B 1 and 3 the share of each phase of
   the cooperative launch), the rows 5 + 7 kernels and the plain version,
   the int8 GEMM's five instances beside torch._int_mm of the same int8
   product (a yardstick),
   rows 13, 15 and 16 at a training step's shapes and row 17 at the
   label evaluation's, their device time by kernel and the launches the
   trace saw,
   cosine top-k QPS at 1M x 512, Q=256, k=10 through the bf16 kernel
   path, the quantized path and the f32 scan, rows 3 and 3′ at Q = 1 and
   16 beside their plain versions and bounds, served top-10 QPS at 1M x
   512 (16 client threads x 32 single-row requests, in this process and
   through HTTP, beside a serialized index.search loop; the dispatches,
   the rows a dispatch coalesced, sampled answers held to index.search),
   every kernel against its
   plain version at the main path's shapes, and one fine-tune step at 64
   pairs with kernels against plain blocks (first held to them: metrics
   and every trainable gradient, from the same seeded weights), with its
   profile; the hyperbolic encoder over 1M rows with row 18 against its
   plain first layer, row 18's launch (CTAs, cluster shape) and device
   time, the label-retrieval mAP over a quarter of the 32k figures (device
   and host parts), and Poincaré top-10 QPS at 1M x 128 through the kernel
   path against the scan; the scan encoder's img/s at ViT-B/16, B 128
   (per-batch, and stacks of 4 and 8 eager and graphed); train_hyp's
   step eager and graphed (ms, steps/s, busy share, kernels and host
   launch calls a step), the graphed epoch as the trainer runs it, and a
   map validation with rows 17 and 18's share of it; the
   train_end step at 32 pairs (ms, img/s, its profile: busy share, rows
   12, 13, 15 and 16's kernels' share, launches a step), a
   train_class_pro epoch at the 2018 scale and a train_hmi epoch, each
   eager and graphed; the
   text encode at TEXT_B, batch 256, over the 2018 scale's titles
   (texts/s, and the tower alone with its profile) and the HF load of
   ViT-B/16 from each format;
6. the wide towers (csrc/flash_tile.cuh at the JAX kernels' contract:
   head widths to 128, keys streamed past shared memory), seeded weights
   at published widths: CLIP ViT-L/14 @336 (openai/clip-vit-large-
   patch14-336: D 1,024, 24 layers, 16 x 64 heads, MLP 4,096, 577 tokens
   padded to 592, projection 768) and the repo's quick_gelu tower at
   OpenCLIP ViT-H/14's widths (D 1,280, 32 layers, 16 x 80 heads, MLP
   5,120, 257 tokens padded to 272, projection 1,024): the bf16
   fused-layer tower at B 32 (rows 1-2) and 3 (JAX's per-op composition,
   no kernel) and the int8 tower at B 32 (rows 5 + 7, 6) and 3 (row 8),
   and at ViT-L/14 the use_flash (row 14) and fused_block (row 12)
   per-op towers at B 32, each held to itself with kernels=False (bf16
   and per-op: min row cosine 0.9999; int8: the ViT-B/16 gate) and the
   int8 tower printed against the bf16 one; one int8 layer at B 3 through
   the cooperative launch, forced, equal in bits to the chain; then each
   tower's img/s (the int8 tower's ms at B 3), and the tile at each
   instance width (48 to 128, 72 and 88 on 80 and 96) on q, k, v [32,
   257, H, hd] and at the two towers' shapes beside its plain version,
   F.scaled_dot_product_attention and its bound; the towers' tile
   launches by instance width join the kernels line as
   flash_tile_hd64_streamed and flash_tile_hd80;
6b. the wide trainers (row 13, the attention backward, and row 14′, the
   f32 attention, at the attention kernels' one contract): rows 12 and 13
   and row 14′ at every instance width (16 to 128; 8, 72, 88 and 120 on
   16, 80, 96 and 128) against their plain versions, row 13 on the path
   its shape takes (the resident kernel at widths up to 64 where the
   sequence fits a block, else the streamed pair: at S 208, and at the
   resident widths also at the first S that streams), with controls that
   must fail each gate (no key mask, a bias zeroed, the last key block's
   keys dropped, below an instance's width the zero columns read as
   real; for row 14′ q unscaled and the pad keys counted), and the
   streamed path equal in bits twice; then at each
   wide tower rows 12 and 13 on its fine-tune stream (also with scores
   past the +80 clamp and the ungated backward as the control), rows 15
   and 16 on a 64-pair step's rows, one fine-tune step and one train_end
   step at 16 pairs with the kernels against the plain blocks
   (check_train_step, beside each metric's pixel-noise yardstick; the
   train_end hinge there held to a multiple of its own yardstick, with a
   planted fault that must fail that gate), and
   the main path: the fine-tune at ClipFinetuneConfig's 64 pairs and
   train_end at EndToEndConfig's 32 through their library entries, timed
   (ms/step, img/s, busy share, launches a step, peak memory; a batch
   that does not fit is halved until it does, and said so); row 13 at
   the fine-tune's stream beside its bound and the backward of
   F.scaled_dot_product_attention (a yardstick, not the same function);
   the f32 use_flash tower at ViT-H/14's widths against kernels=False,
   timed; rows 13 and 14′ timed at each instance width and path.  Row
   13's launches in the main path by instance and path join the kernels
   line as fused_attention_bwd_hd64_streamed and
   fused_attention_bwd_hd80_streamed,
   the f32 tower's as flash_attention_f32_hd80.

Rows 5-11 (the int8 entries) are checked in phase 3 in both of their
forms (``fast``; rows 5 and 6 also at ViT-L/14 @336's streamed rows)
and timed in both in phase 5; the kernels line lists the fast form's
instances as <entry>_fast.  The line before the last is a JSON object
with one entry per kernel
(its launches on the main path, error against the plain version, times
and the least time the card could take); the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before either
is printed.  Needs one CUDA card; without one it exits 1.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke_run")
FT_DIR = os.path.join(ROOT, "build", "chip_smoke_finetune")
HYP_DIR = os.path.join(ROOT, "build", "chip_smoke_hyperbolic")
SYN_DIR = os.path.join(ROOT, "build", "chip_smoke_synthetic")


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


def in_turns(torch, plain, kernel, iters: int = 20) -> tuple[float, float]:
    """(plain ms, kernel ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, iters=iters)
    k1 = cuda_ms(torch, kernel, iters=iters)
    k2 = cuda_ms(torch, kernel, iters=iters)
    p2 = cuda_ms(torch, plain, iters=iters)
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


def launch_times(torch, fn, iters: int = 30) -> list[tuple[str, float, int]]:
    """(kernel name, mean device ms a launch, launches the profiler saw) of
    every kernel ``fn`` launches, over ``iters`` calls after one warm-up
    call.  A mean over
    the launches seen, so a launch the trace dropped does not shrink it;
    for a ``fn`` that launches each kernel once, the device time a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / e.count / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]


def print_breakdown(torch, what: str, fn) -> None:
    """Print the device time by kernel of one call of ``fn`` against its
    CUDA-event wall time."""
    wall = cuda_ms(torch, fn, warmup=1, iters=3)
    rows = kernel_breakdown(torch, fn)
    busy = sum(ms for _k, ms in rows)
    print(f"[time] {what}: device time by kernel (torch.profiler, 3 calls) "
          f"{busy:.3f} ms busy of {wall:.3f} ms wall "
          f"({100 * busy / wall:.1f}%); "
          + "; ".join(f"{ms:.3f} ms {kname[:70]}" for kname, ms in rows[:6]))


def min_row_cosine(torch, a, b) -> float:
    a, b = (t.float().reshape(-1, t.shape[-1]) for t in (a, b))
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def rel_err(a, b) -> float:
    """mean |a - b| / mean |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().mean() / b.abs().mean())


# Layer gate: the kernel and the plain version round the same bf16
# intermediates, so they differ by f32 summation order, which now and then
# flips one bf16 rounding.  Measured on the H100 (rows 1-2 on the wgmma GEMM
# and the flash tile): relative error 2.1e-4 to 3.4e-4, max-abs 1 ulp
# (chip_smoke's own output shows it); dropping the key mask or one bias of
# std 0.02 gives 1.1e-2 or more.  The earlier form of rows 1-2
# (max-subtracted softmax, exp gelu, unfolded q) sits at 1.49e-3 to 1.69e-3
# and within 1 ulp, so the relative error alone tells it apart: the gate
# sits 3.2x above the kernel's largest reading and 1.35x below the earlier
# form's smallest, and every control must fail it.  The CPU test against JAX's
# interpreted kernel (tests/test_torch_bf16_layer.py) holds the function
# with more margin.
LAYER_REL_TOL = 1.1e-3
LAYER_MAX_ULPS = 2
# The layer's GEMM alone against the plain f32 product of the same bf16
# operands: f32 sums in another order (bf16 outputs flip a rare rounding);
# the bias dropped must fail.
GEMM_REL_TOL, GEMM_MAX_ULPS = 1e-4, 1
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
# The whole int8 layer (rows 8, 9): a code flipped in LN1's quantization
# reaches every row of its image through the attention and then the MLP
# sub-layer, and at B = 1 nothing averages it out.  Measured on the H100
# at B = 1: relative error 3.6e-4, max-abs 1 ulp; the nearest control, the
# rows 5 + 7 chain (bf16 mid residual), at 7.1e-3.  The gate sits ~4x
# above the one and ~5x below the other.
INT8_LAYER_REL_TOL = 1.5e-3
# the phases of row 8's cooperative launch (csrc/int8_layer.cu)
LAYER_PHASES = ("LN1 + quant", "QKV", "attention", "quant(ao)",
                "out-projection", "x1 + LN2 + quant", "MLP in", "quant(g)",
                "MLP out", "output")
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
# the int8 tower at batch 3 (layers 0..10 as the whole layer, f32 mid
# residual) against batch 32 (rows 5 + 7, bf16 mid residual): two
# functions, whose features differ by about what pixel noise of std 1e-3
# moves (the yardstick printed beside).  Measured on the H100: min cosine
# 0.999764 against the yardstick's 0.999757; the gate sits ~4x farther
# from 1.
INT8_RAGGED_MIN_COS = 0.999
# the int8 tower in its fast form (the card's default) against its exact
# form (PATENT_TPU_FAST_KERNELS=0) at one batch: two functions, the fast
# form's reciprocals off by up to 5.8e-3 each, about 1% of a layer's
# output apart (tests/test_torch_int8_fast.py); held as the ragged batch is
INT8_FORMS_MIN_COS = 0.999
# the int8 entries (rows 5-11) whose kernels have both forms: the kernels
# line names the fast form's instances <entry>_fast
INT8_ENTRIES = ("quant_attention_block", "quant_attention_cls",
                "quant_mlp_block", "quant_layer_block", "quant_layer_group",
                "quant_dense", "quant_mlp")
# Row 14 against its plain version: the same bf16 q and p, f32 sums in
# another order, so now and then one output rounding flips (as row 12's
# forward, 0 to 2.3e-6); leaving q unscaled, counting the zero keys up to
# the next multiple of 16 or dropping the clamp where scores pass +80 move
# the output by 1e-2 or more.
FLASH_REL_TOL, FLASH_MAX_ULPS = 1e-4, 2
# Row 14's f32 instance against its plain version in f32 (no TF32): the
# same products and sums in another order, held to 1e-5 relative (mean and
# max-abs over the largest |ref|); q unscaled must fail
FLASH_F32_REL_TOL = 1e-5
# q x 40 puts ~8% of the exp2-domain scores past +80
FLASH_SATURATING_GAIN = 40.0
# The per-op towers against the fused-layer tower, and the fused-layer
# tower at batch 3 (every layer the per-op composition) against batch 32:
# other functions (an f32 against a bf16 stream between layers; a bf16
# against an f32 mid-layer residual), held by min cosine beside the
# pixel-noise yardstick, as the int8 tower at a ragged batch is.
PER_OP_MIN_COS = 0.999
BF16_ODD_MIN_COS = 0.999

# the layer's four GEMM instances at ViT-B/16 widths: (N, K)
GEMM_SHAPES = {"bias": (2304, 768), "bias_gelu": (3072, 768),
               "res_bias": (768, 768), "bias_res": (768, 3072)}

# the s8 GEMM's instances (csrc/wgmma_s8.cuh) at ViT-B/16 widths: (N, K)
S8_GEMM_SHAPES = {"bias": (2304, 768), "gelu": (3072, 768), "res": (768, 768),
                  "res_f32_out": (768, 768), "res_f32": (768, 3072)}
# H100 SXM datasheet peaks (dense) and memory rate, for bound_ms; fp32 is
# the rate outside the tensor cores (rows 17 and 18 exclude TF32)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
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


def maxsub_layer(torch, x, p, heads, valid, cls_only):
    """The earlier form of rows 1-2, a control: q
    unfolded, scores divided by sqrt(hd), the row max subtracted, exp,
    g * sigmoid(1.702 g), and x + (ao Wout + bout)."""
    from patent_tpu_torch.ops.common import layernorm_f32, mm_f32

    (ln1s, ln1b, wqkv, bqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2) = p
    b, s, d = x.shape
    hd = d // heads
    cdt = x.dtype

    def dense(a, w, bias):
        rows = mm_f32(a.reshape(-1, a.shape[-1]).to(cdt), w.to(cdt))
        return rows.reshape(*a.shape[:-1], -1) + bias.float()

    def split(t):
        t = t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)
        return t.reshape(b * heads, -1, hd)

    h = layernorm_f32(x, ln1s, ln1b).to(cdt)
    kv = dense(h, wqkv[:, d:], bqkv[d:]).to(cdt)
    q = dense(h[:, :1] if cls_only else h, wqkv[:, :d], bqkv[:d]).to(cdt)
    k, v = kv.split(d, dim=-1)
    sc = mm_f32(split(q), split(k).transpose(-1, -2)) / math.sqrt(hd)
    sc = sc.masked_fill(torch.arange(s, device=x.device) >= valid,
                        float("-inf"))
    pr = torch.exp(sc - sc.amax(dim=-1, keepdim=True)).to(cdt)
    ao = mm_f32(pr, split(v)) / pr.float().sum(-1, keepdim=True)
    ao = ao.to(cdt).reshape(b, heads, -1, hd).transpose(1, 2)
    x1 = (x[:, :1] if cls_only else x).float() + dense(
        ao.reshape(b, -1, d), wout, bout)
    g = dense(layernorm_f32(x1, ln2s, ln2b).to(cdt), w1, b1)
    out = (x1 + dense((g * torch.sigmoid(1.702 * g)).to(cdt), w2, b2)).to(cdt)
    return out[:, 0] if cls_only else out


def check_layer(torch, bf16_layer, name, x, p, heads, valid) -> float:
    """Hold one bf16 layer kernel (``name``: the block or the CLS wrapper)
    to its plain version on the valid rows, with controls that must fail
    the same gate: the plain version without the key mask, with each bias
    zeroed, and the earlier max-subtracted form.  Returns the max-abs
    error."""
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
    controls["max-subtracted form"] = valid_rows(maxsub_layer(
        torch, x, p, heads, valid, name.endswith("cls_bf16")))
    return gate(torch, f"{name} valid {valid}/{s}", got, ref, controls,
                LAYER_REL_TOL, LAYER_MAX_ULPS)


def check_layer_gemm(torch, bf16_layer, epilogue, m, n, k, gen, dev) -> float:
    """Hold one of the layer's GEMM instances (csrc/wgmma_gemm.cuh) alone to
    the plain f32 product of the same bf16 operands at [m x k] x [k x n];
    control: the bias dropped.  Returns the max-abs error."""
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w_t = (torch.randn(n, k, generator=gen, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    bias = 0.1 * torch.randn(n, generator=gen, device=dev)
    rdt = bf16_layer.GEMM_EPILOGUES[epilogue][1]
    res = (None if rdt is None
           else torch.randn(m, n, generator=gen, device=dev).to(rdt))
    ref = bf16_layer.layer_gemm_plain(a, w_t, bias, epilogue, res)
    got = bf16_layer.layer_gemm(a, w_t, bias, epilogue, res)
    controls = {"bias=0": bf16_layer.layer_gemm_plain(
        a, w_t, torch.zeros_like(bias), epilogue, res)}
    return gate(torch, f"layer GEMM {epilogue} [{m} x {k}] x [{k} x {n}] -> "
                f"{str(got.dtype)[6:]}", got, ref, controls, GEMM_REL_TOL,
                GEMM_MAX_ULPS)


def s8_gemm_case(torch, qm, epilogue, m, n, k, gen, dev):
    """int8_gemm's operands at [m x k] x [k x n]: random int8 codes, row
    and column scales of the tower's size, a bias, the residual."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # scales such that the product's part of each output is O(0.1-1), as
    # large as the bias's
    rdt = qm.S8_GEMM_EPILOGUES[epilogue][1]
    return (codes(m, k), 0.1 * torch.rand(m, generator=gen, device=dev),
            codes(n, k),
            10 * torch.rand(n, generator=gen, device=dev) / 127 / k ** 0.5,
            0.1 * torch.randn(n, generator=gen, device=dev),
            None if rdt is None
            else torch.randn(m, n, generator=gen, device=dev).to(rdt))


def form_name(fast: bool) -> str:
    return "fast form" if fast else "exact form"


@contextlib.contextmanager
def kernel_form(fast: bool):
    """PATENT_TPU_FAST_KERNELS for the block, as a user sets it: "1" (the
    int8 kernels' fast form, the card's default) or "0" (the exact form);
    the int8 entries read it at each call."""
    env = "PATENT_TPU_FAST_KERNELS"
    old = os.environ.get(env)
    os.environ[env] = "1" if fast else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(env)
        else:
            os.environ[env] = old


def check_s8_gemm(torch, qm, epilogue, m, n, k, gen, dev,
                  fast: bool = False) -> float:
    """Hold one of rows 5 and 8's int8 GEMM instances (csrc/wgmma_s8.cuh)
    alone to its plain epilogue on the same integer product at [m x k] x
    [k x n] (the products are exact, so they should agree bit for bit; the
    "gelu" epilogue in the form ``fast``); control: the bias dropped.
    Returns the max-abs error."""
    a, a_scale, w_t, scale, bias, res = s8_gemm_case(torch, qm, epilogue, m,
                                                     n, k, gen, dev)
    got = qm.int8_gemm(a, a_scale, w_t, scale, bias, epilogue, res,
                       fast=fast)
    ref = qm.int8_gemm_plain(a, a_scale, w_t, scale, bias, epilogue, res,
                             fast=fast)
    controls = {"bias=0": qm.int8_gemm_plain(
        a, a_scale, w_t, scale, torch.zeros_like(bias), epilogue, res,
        fast=fast)}
    what = (f"s8 GEMM {epilogue}" + (", fast form" if fast else "")
            + f" [{m} x {k}] x [{k} x {n}]")
    err = gate(torch, f"{what} -> {str(got.dtype)[6:]}", got, ref, controls,
               INT8_REL_TOL, INT8_MAX_ULPS)
    print(f"[kernel] {what} equals its plain epilogue bit for bit: "
          f"{bool(torch.equal(got, ref))}")
    return err


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


def check_int8(torch, qm, name, x, p, heads, valid, fast: bool = False
               ) -> float:
    """Hold one int8 kernel (``name``: quant_attention_block,
    quant_attention_cls or quant_mlp_block) in the form ``fast`` to its
    plain version in that form on the valid rows (every row for the MLP,
    which is row-independent and takes x [..., D] of any row count), with
    controls that must fail the same gate, the other form among them.
    Returns the max-abs error."""
    kernel = functools.partial(getattr(qm, name), fast=fast)
    plain = functools.partial(getattr(qm, name + "_plain"), fast=fast)
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
    controls[form_name(not fast)] = run(functools.partial(
        getattr(qm, name + "_plain"), fast=not fast), p)
    rows = (f"valid {valid}/{s}" if attention
            else f"[{x.numel() // x.shape[-1]} x {x.shape[-1]}]")
    return gate(torch, f"{name} {rows}, {form_name(fast)}", got, ref,
                controls, INT8_REL_TOL, INT8_MAX_ULPS)


def check_gelu_quant(torch, qm, x, p, fast: bool = False) -> None:
    """Row 7's MLP in alone on the row codes of x [M, D], in the form
    ``fast``: its hidden g equal to the plain epilogue's, the row maxima
    its epilogue takes equal to max |g| of its own g, and the one-pass
    quantization equal to quant_rows(g) (fast: quant_rows_fast, whose codes
    saturate at 127), each bit for bit."""
    a, a_scale = qm.quant_rows(x.float())
    a_scale = a_scale[:, 0].contiguous()
    g, g_max, gq, gs = qm.int8_gelu_quant(a, a_scale, *p[2:5], fast=fast)
    want_q, want_s = (qm.quant_rows_fast if fast else qm.quant_rows)(g)
    torch.cuda.synchronize()
    same = {"hidden": torch.equal(g, qm.int8_gemm_plain(
                a, a_scale, *p[2:5], "gelu", fast=fast)),
            "row maxima": torch.equal(g_max, g.abs().amax(dim=-1)),
            "codes": torch.equal(gq, want_q),
            "scales": torch.equal(gs, want_s[:, 0])}
    print(f"[kernel] row 7's MLP in alone, {form_name(fast)}, [{x.shape[0]} "
          f"x {x.shape[1]}] x [{x.shape[1]} x {p[2].shape[0]}]: equal bit for "
          "bit to the plain epilogue and to the row quantization of its own "
          "hidden: "
          + ", ".join(f"{key} {v}" for key, v in same.items()))
    check(all(same.values()), "row 7's MLP in or the hidden's one-pass "
          "quantization differs from its plain version")


# the kernels row 7 launches, named by the phase each runs
ROW7_PHASES = (("rowquant_amax", "the hidden's quantization"),
               ("rowquant_kernel", "LN2 + quantization"),
               ("gemm_kernel<1", "MLP in + row maxima"),
               ("gemm_kernel<2", "MLP out"),
               ("emset", "row maxima zeroed"))


def row7_phase(kname: str) -> str:
    return next((phase for key, phase in ROW7_PHASES if key in kname),
                kname[:60])


def check_int8_layer(torch, qm, name, x, p, heads, valid,
                     fast: bool = False, **kw) -> float:
    """Hold the whole int8 layer (``name``: quant_layer_block, or
    quant_layer_group with ``kw`` its group) in the form ``fast`` to its
    plain version in that form on the valid rows, with the controls of
    both sub-layers (the key mask, each bias, each matrix's scales), the
    other form and the other mid-layer residual: rows 5 + 7 chained (bf16)
    against the whole layer, the whole layer (f32) against the group
    dispatch's ragged fallback.  Returns the max-abs error."""
    kernel = getattr(qm, name)
    plain = getattr(qm, name + "_plain")
    s = x.shape[1]

    def run(fn, q, v=valid, form=fast):
        return fn(x, *q, heads, v, fast=form, **kw)[:, :valid]

    ref = run(plain, p)
    got = run(kernel, p)
    controls = {"no key mask": run(plain, p, s)}
    for kind, offset in (("attention", 0), ("mlp", 8)):
        for i, bname in INT8_CONTROLS[kind]:
            q = list(p)
            q[offset + i] = torch.zeros_like(q[offset + i])
            controls[bname + "=0"] = run(plain, q)
        for i, sname in INT8_CONTROLS[kind + " scales"]:
            q = list(p)
            q[offset + i] = torch.full_like(q[offset + i],
                                            float(q[offset + i].mean()))
            controls[sname + "=mean"] = run(plain, q)
    controls[form_name(not fast)] = run(plain, p, form=not fast)
    chain = qm.quant_mlp_block_plain(
        qm.quant_attention_block_plain(x, *p[:8], heads, valid, fast=fast),
        *p[8:], fast=fast)
    whole = x.shape[0] % kw.get("group", 1) == 0
    controls["rows 5 + 7, bf16 mid residual" if whole
             else "whole layer, f32 mid residual"] = (
        chain if whole else qm.quant_layer_block_plain(x, *p, heads, valid,
                                                       fast=fast)
    )[:, :valid]
    return gate(torch, f"{name} B {x.shape[0]}, valid {valid}/{s}"
                + (f", group {kw['group']}" if kw else "")
                + f", {form_name(fast)}", got, ref, controls,
                INT8_LAYER_REL_TOL, INT8_MAX_ULPS)


def check_int8_dense(torch, qm, tag, x, w, scale, bias, act,
                     fast: bool = False) -> float:
    """Hold quant_dense in the form ``fast`` to its plain version in that
    form, with controls that must fail the same gate: the bias zeroed, the
    scales replaced by their mean, the other activation, the other form.
    Returns the max-abs error."""
    plain = functools.partial(qm.quant_dense_plain, fast=fast)
    other = None if act else "quick_gelu"
    return gate(torch, f"quant_dense {tag}, {form_name(fast)}",
                qm.quant_dense(x, w, scale, bias, act, fast=fast),
                plain(x, w, scale, bias, act),
                {"bias=0": plain(x, w, scale, None, act),
                 "scale=mean": plain(x, w, torch.full_like(
                     scale, float(scale.mean())), bias, act),
                 f"act {other}": plain(x, w, scale, bias, other),
                 form_name(not fast): qm.quant_dense_plain(
                     x, w, scale, bias, act, fast=not fast)},
                INT8_REL_TOL, INT8_MAX_ULPS)


def check_int8_qmlp(torch, qm, tag, x, w, fast: bool = False) -> float:
    """Hold quant_mlp in the form ``fast`` to its plain version in that
    form (w: w1_t, s1, b1, w2_t, s2, b2), with each bias zeroed, each
    scale vector replaced by its mean and the other form as the controls.
    Returns the max-abs error."""
    plain = functools.partial(qm.quant_mlp_plain, fast=fast)
    controls = {}
    for i, cname in ((2, "b1=0"), (5, "b2=0"), (1, "s1=mean"),
                     (4, "s2=mean")):
        q = list(w)
        q[i] = (torch.zeros_like(q[i]) if cname.endswith("0")
                else torch.full_like(q[i], float(q[i].mean())))
        controls[cname] = plain(x, *q)
    controls[form_name(not fast)] = qm.quant_mlp_plain(x, *w, fast=not fast)
    return gate(torch, f"quant_mlp {tag}, {form_name(fast)}",
                qm.quant_mlp(x, *w, fast=fast), plain(x, *w), controls,
                INT8_REL_TOL, INT8_MAX_ULPS)


def int8_family_bounds(b_layer, b_group, s, valid, d, f, m) -> dict:
    """bound() of rows 8 and 9 (one whole layer at [B, S, D], B = b_layer,
    b_group), row 10 (bf16 [m, d] x int8 [d, 3d], the QKV projection) and
    row 11 (bf16 [m, d], hidden f, out d): each input read once and each
    output written once (activations bf16, matrices int8, vectors f32:
    LayerNorms, biases and scales of the four matrices), the int8 products
    and the attention over the valid keys."""
    vec = 4 * (14 * d + 2 * f)

    def layer(b):
        mb = b * s
        return bound(2 * 2 * mb * d + 4 * d * d + 2 * d * f + vec,
                     {"int8": 2 * mb * d * 4 * d + 4 * mb * d * f,
                      "bf16": 4 * b * s * valid * d})

    return {"quant_layer_block": layer(b_layer),
            "quant_layer_group": layer(b_group),
            "quant_dense": bound(2 * m * d + 3 * d * d + 8 * 3 * d
                                 + 2 * m * 3 * d,
                                 {"int8": 2 * m * d * 3 * d}),
            "quant_mlp": bound(2 * m * d + 2 * d * f + 8 * (f + d)
                               + 2 * m * d, {"int8": 4 * m * d * f})}


# eval --synthetic's small tower on the card against the same run on the
# CPU (tests/test_torch_gpu.py's bounds): the same weights, features summed
# in another order.  The bf16 battery is held to METRIC_ATOL
# (tests/test_torch_pipeline.py's bound on the port against JAX); the int8
# tower flips a code under such a perturbation and carries it on (gallery
# features 0.99993 apart moved MRR@5 by 0.0108 over the corpus's 80
# queries in one H100 run), so its battery gap is printed and the int8 run
# is held by its features alone
METRIC_ATOL = 0.01
SYNTH_MIN_COS = 0.9999

# The fine-tune's trainable blocks (rows 12, 13, 15, 16): the kernel and
# the plain version round the same bf16 intermediates and differ by f32
# summation order only (the cotangent sums by the order of their
# partials).  Measured on the H100 (this script's output): relative error
# 0 to 2.3e-6 forward, 0 to 5.3e-5 backward (B 128, the MLP on 25,216
# rows), at most 1 ulp; the gates sit 3-4x above, and the nearest control
# (b1 = 0, on dx) is at 8.7e-3.
TRAIN_FWD_REL_TOL, TRAIN_FWD_MAX_ULPS = 1e-5, 2
TRAIN_BWD_REL_TOL, TRAIN_BWD_MAX_ULPS = 1.5e-4, 2
# the q columns of every fourth head scaled by this, so that a share of
# their scores passes the +80 clamp and the backward's gate matters
SATURATED_Q_GAIN = 25.0
MLP_GRADS = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


def fold_q(torch, wqkv, bqkv, d, heads, gain: float = 1.0):
    """(wqkv, bqkv) as the row-12/13 kernels take them: the q columns
    scaled by log2(e)/sqrt(hd), as ``fused_attention_block`` folds them,
    and those of every fourth head by ``gain`` besides."""
    hd = d // heads
    col = torch.full((3 * d,), 1.0, device=wqkv.device)
    col[:d] = math.log2(math.e) / math.sqrt(hd)
    col[:d].view(heads, hd)[::4] *= gain
    return ((wqkv.float() * col).to(wqkv.dtype).contiguous(),
            (bqkv.float() * col).contiguous())


def saturated_share(torch, x, wqkv, bqkv, heads, valid) -> float:
    """Share of the valid (query, key) scores of the gained heads at or
    above the +80 clamp."""
    b, s, d = x.shape
    qkv = (x.float() @ wqkv.float() + bqkv).reshape(b, s, 3, heads, -1)
    q, k = qkv[:, :, 0, ::4], qkv[:, :, 1, ::4]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k)[..., :valid, :valid]
    return float((sc >= 80.0).float().mean())


def last_key_block(s: int, hd: int, valid: int) -> int:
    """The first key of the last key block that holds a valid key, on the
    path row 13 takes at padded S and head width hd (the library's plan):
    the streamed ring's last stage (its last 16-key step where the keys are
    one stage), the resident path's last 16-key step."""
    from patent_tpu_torch.ops import flash_attention as fa

    streamed, ring = fa.attention_bwd_plan(s, hd)
    block = ring if streamed else 16
    return (valid - 1) // block * block or (valid - 1) // 16 * 16


def first_streamed_s(hd: int) -> int:
    """The first padded S at which row 13 streams at head width hd (the
    library's plan)."""
    from patent_tpu_torch.ops import flash_attention as fa

    s = 16
    while not fa.attention_bwd_plan(s, hd)[0]:
        s += 16
    return s


def check_train_attention(torch, fa, x, p, heads, valid, gen,
                          saturate: bool = False) -> tuple[float, float]:
    """Hold rows 12 and 13 to their plain versions on x [B, S, D] with
    `valid` keys (row 13 given a cotangent whose pad rows are 0, as the
    tower's slice gives it, on the path its shape takes), with controls
    that must fail the same gates: the
    plain version without the key mask, with each bias zeroed, with the
    last key block's keys dropped (the path's last stage of keys) and, at
    a head width below its instance's, reading the instance's width of
    columns; with ``saturate``, every fourth head's scores partly past the
    +80 clamp and the control the plain backward without the clamp's gate.
    Returns the max-abs errors (forward, backward)."""
    b, s, d = x.shape
    hd = d // heads
    streamed = fa.attention_bwd_plan(s, hd)[0]
    wqkv, bqkv = fold_q(torch, p[2], p[3], d, heads,
                        SATURATED_Q_GAIN if saturate else 1.0)
    wout, bout = p[4], p[5]
    zb = torch.zeros_like(bqkv)
    tag = (f"[{b}, {s}, {heads} x {hd}] valid {valid}"
           + (", streamed" if streamed else "")
           + (", saturated" if saturate else ""))
    e12 = 0.0
    if not saturate:
        def fwd(fn, bq=bqkv, bo=bout, v=valid):
            return fn(x, wqkv, bq, wout, bo, heads, v)[:, :valid]

        plain = fa.fused_attention_block_plain
        e12 = gate(torch, f"fused_attention_fwd {tag}",
                   fwd(fa.fused_attention_fwd), fwd(plain),
                   {"no key mask": fwd(plain, v=s), "bqkv=0": fwd(plain, zb),
                    "bout=0": fwd(plain, bo=torch.zeros_like(bout))},
                   TRAIN_FWD_REL_TOL, TRAIN_FWD_MAX_ULPS)
    keep = (torch.arange(s, device=x.device) < valid)[:, None]
    da = (torch.randn(b, s, d, generator=gen, device=x.device)
          * keep).to(torch.bfloat16)

    def bwd(bq=bqkv, v=valid, gate_on=True, read_width=None):
        return fa.attention_bwd_plain(x, wqkv, bq, da, heads, v, gate_on,
                                      read_width)

    got = fa.fused_attention_bwd(x, wqkv, bqkv, da, heads, valid)
    ref = bwd()
    torch.cuda.synchronize()
    # pad queries have a zero cotangent and pad keys no gradient: those
    # rows of dqkv are 0 exactly; the gates below read the valid rows
    check(not bool(got[0][:, valid:].any()),
          f"fused_attention_bwd {tag}: pad rows of dqkv are not 0")
    if saturate:
        share = saturated_share(torch, x, wqkv, bqkv, heads, valid)
        print(f"[kernel] saturated case: {100 * share:.2f}% of the gained "
              "heads' valid scores at or above +80")
        check(0.0 < share < 0.5, "the saturated case does not saturate "
              "a share of the scores")
        controls = [{"no clamp gate": bwd(gate_on=False)}, {}]
    else:
        no_mask, no_bias = bwd(v=s), bwd(bq=zb)
        dropped = bwd(v=last_key_block(s, hd, valid))
        controls = [{"no key mask": no_mask, "bqkv=0": no_bias,
                     "last key block dropped": dropped},
                    {"no key mask": no_mask, "bqkv=0": no_bias}]
        if hd % 16:
            controls[0]["zero columns as real"] = bwd(read_width=hd + 8)
    e13 = gate(torch, f"fused_attention_bwd dqkv {tag}", got[0][:, :valid],
               ref[0][:, :valid],
               {c: t[0][:, :valid] for c, t in controls[0].items()},
               TRAIN_BWD_REL_TOL, TRAIN_BWD_MAX_ULPS)
    if controls[1]:
        e13 = max(e13, gate(torch, f"fused_attention_bwd A {tag}",
                            got[1][:, :valid], ref[1][:, :valid],
                            {c: t[1][:, :valid]
                             for c, t in controls[1].items()},
                            TRAIN_FWD_REL_TOL, TRAIN_FWD_MAX_ULPS))
    return e12, e13


def check_mlp_fwd(torch, mm, x2, p) -> float:
    """Hold row 15 to its plain version on x2 [M, D] with the MLP
    parameters p[6:12], each bias zeroed as a control that must fail the
    same gate.  Returns the max-abs error."""
    m, d = x2.shape
    args = list(p[6:12])

    def with_zero(i):
        q = list(args)
        q[i] = torch.zeros_like(q[i])
        return q

    plain = mm.fused_mlp_block_bf16_plain
    return gate(torch, f"fused_mlp_fwd M {m}, D {d}, F {args[2].shape[1]}",
                mm.fused_mlp_fwd(x2, *args), plain(x2, *args),
                {"ln2_bias=0": plain(x2, *with_zero(1)),
                 "b1=0": plain(x2, *with_zero(3)),
                 "b2=0": plain(x2, *with_zero(5))},
                TRAIN_FWD_REL_TOL, TRAIN_FWD_MAX_ULPS)


def check_train_mlp(torch, mm, x2, p, gen) -> tuple[float, float]:
    """Hold rows 15 and 16 to their plain versions on x2 [M, D] (the
    unpadded rows of a token stream), with controls that must fail the
    same gates: the forward with each bias zeroed; the backward with b1
    zeroed, dx without the LayerNorm's term (dx = dout), and each
    cotangent sum without the ragged last tile of rows and without the
    rows of the backward's last chunk.  Returns the max-abs errors
    (forward, backward)."""
    m = x2.shape[0]
    lns, lnb, w1, b1, w2, b2 = p[6:12]
    args = [lns, lnb, w1, b1, w2, b2]

    def with_zero(i):
        q = list(args)
        q[i] = torch.zeros_like(q[i])
        return q

    e15 = check_mlp_fwd(torch, mm, x2, p)
    do2 = torch.randn(x2.shape, generator=gen, device=x2.device).to(
        torch.bfloat16)
    got = mm.fused_mlp_bwd(x2, do2, *args[:5])
    ref = mm._mlp_bwd_plain(x2, do2, *args[:5])
    no_b1 = mm._mlp_bwd_plain(x2, do2, *with_zero(3)[:5])
    # the ragged last tile of rows, and the last of the backward's chunks
    tails = {m % 128 or 128, (m - 1) % mm.CHUNK_ROWS + 1}
    no_tail = {t: mm._mlp_bwd_plain(x2[:-t], do2[:-t], *args[:5])
               for t in tails if t < m}
    e16 = 0.0
    for i, gname in enumerate(MLP_GRADS):
        if i == 0:
            controls = {"dLN dropped": do2, "b1=0": no_b1[0]}
        else:
            controls = {f"last {t} rows dropped": g[i]
                        for t, g in no_tail.items()}
            if gname != "db2":         # sum(dout) does not depend on b1
                controls["b1=0"] = no_b1[i]
        e16 = max(e16, gate(torch, f"fused_mlp_bwd {gname} M {m}", got[i],
                            ref[i], controls, TRAIN_BWD_REL_TOL,
                            TRAIN_BWD_MAX_ULPS))
    return e15, e16


def check_flash_f32(torch, fa, b, s, heads, gen, dev, hd: int = 64) -> float:
    """Hold row 14's f32 instance to its plain version in f32 on q, k, v
    [B, S, H, hd] slices of one f32 qkv tensor: within FLASH_F32_REL_TOL
    (mean and max-abs relative), with controls that must fail: q unscaled
    and, where S ends inside a 64-key tile, the zero keys up to its end
    counted.  Returns the max-abs error."""
    d = heads * hd
    qkv = torch.randn(b, s, 3 * d, generator=gen, device=dev)
    q, k, v = (t.unflatten(-1, (heads, hd)) for t in qkv.split(d, dim=-1))
    ref = fa.flash_attention_plain(q, k, v)
    got = fa.flash_attention(q, k, v)
    controls = {"q unscaled": fa.flash_attention_plain(q, k, v, scale=False)}
    if s % 64:
        controls["pad keys counted"] = fa.flash_attention_plain(
            q, k, v, pad_keys_to=-(-s // 64) * 64)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    gaps = (rel_err(got, ref), err / scale)
    cgaps = {c: (rel_err(t, ref), float((t - ref).abs().max()) / scale)
             for c, t in controls.items()}
    print(f"[kernel] flash_attention f32 [{b}, {s}, {heads}, {hd}] vs plain: "
          f"rel err {gaps[0]:.3g}, max-abs / max|ref| {gaps[1]:.3g}; controls "
          "(must fail) " + ", ".join(f"{c} {g[0]:.3g} / {g[1]:.3g}"
                                     for c, g in cgaps.items()))
    check(bool(torch.isfinite(got).all()) and max(gaps) <= FLASH_F32_REL_TOL,
          f"flash_attention f32 disagrees with its plain version (gate "
          f"{FLASH_F32_REL_TOL})")
    for c, g in cgaps.items():
        check(max(g) > FLASH_F32_REL_TOL, f"flash_attention f32: the control "
              f"'{c}' passes the gate")
    return err


def check_flash(torch, fa, b, s, heads, gen, dev, gain: float = 1.0) -> float:
    """Hold row 14 to its plain version on q, k, v [B, S, H, 64], slices of
    one [B, S, 3·H·64] bf16 tensor as the per-op tower passes them, with
    controls that must fail the same gate: q unscaled and, where S is not
    a multiple of 16, the zero keys up to the next one counted; with
    ``gain`` (q scaled so that scores pass +80) the clamp dropped.  Returns
    the max-abs error."""
    d = heads * 64
    qkv = torch.randn(b, s, 3 * d, generator=gen, device=dev)
    qkv[..., :d] *= gain
    q, k, v = (t.unflatten(-1, (heads, 64))
               for t in qkv.to(torch.bfloat16).split(d, dim=-1))
    plain = fa.flash_attention_plain
    ref = plain(q, k, v)
    got = fa.flash_attention(q, k, v)
    tag = f"flash_attention [{b}, {s}, {heads}, 64]"
    if gain != 1.0:
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
            math.log2(math.e) / 8.0)
        share = float((sc >= 80.0).float().mean())
        del sc
        print(f"[kernel] {tag}, q x {gain:g}: {100 * share:.2f}% of the "
              "exp2-domain scores at or above +80")
        check(0.0 < share < 0.5, "the saturated case does not saturate a "
              "share of the scores")
        tag += f", q x {gain:g}"
        controls = {"no clamp": plain(q, k, v, clamp=False)}
    else:
        controls = {"q unscaled": plain(q, k, v, scale=False)}
        if s % 16:
            controls["pad keys counted"] = plain(q, k, v,
                                                 pad_keys_to=-(-s // 16) * 16)
    return gate(torch, tag, got, ref, controls, FLASH_REL_TOL, FLASH_MAX_ULPS)


def hyperbolic_backward(torch, dev, z: dict) -> None:
    """A backward through HyperbolicEmbeddingModel on the card at the
    HypTrainConfig widths, on 512 feature rows in train mode: while
    autograd records, the first layer takes its plain chain (row 18 has no
    backward), so row 18 launches 0 times and every gradient is finite;
    under no_grad the same model launches row 18."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import poincare

    gen = torch.Generator().manual_seed(7)
    model = HyperbolicEmbeddingModel(
        feature_dim=z["k_in"], embed_dim=z["d_emb"], label_num=1024,
        hidden_dims=(z["d_hid"],), c=z["c"], generator=gen).to(dev).train()
    x = torch.randn(z["n_enc"], z["k_in"], generator=gen).to(dev)
    n18 = pk.mobius_dense_pallas.launches
    out = model(x)
    labels = model.labels()[torch.arange(x.shape[0], device=dev) % 1024]
    loss = poincare.dist(out, labels, z["c"]).mean()
    loss.backward()
    torch.cuda.synchronize()
    under_grad = pk.mobius_dense_pallas.launches - n18
    grads = {n: p.grad for n, p in model.named_parameters()}
    with torch.no_grad():
        model.eval()(x)
    torch.cuda.synchronize()
    print(f"[slice] HyperbolicEmbeddingModel backward on the card "
          f"({z['n_enc']} rows, {z['k_in']} -> {z['d_hid']} -> "
          f"{z['d_emb']}): loss {float(loss):.6f}, {len(grads)} gradients, "
          f"first layer's norm {float(grads['encoder.first_layer.kernel'].norm()):.4g}"
          f"; row 18 launches under grad {under_grad}, under no_grad "
          f"{pk.mobius_dense_pallas.launches - n18 - under_grad}")
    check(math.isfinite(float(loss)) and under_grad == 0
          and all(g is not None and bool(torch.isfinite(g).all())
                  for g in grads.values())
          and float(grads["encoder.first_layer.kernel"].norm()) > 0.0
          and pk.mobius_dense_pallas.launches == n18 + 1,
          "the hyperbolic model's backward on the card failed")


# One fine-tune step with the kernels against one with the plain blocks,
# from the same weights on the same batch.  The step's metrics must agree
# within STEP_METRIC_REL_TOL relative, and the tower's gradients, given one
# cotangent of its features for both, within STEP_GRAD_REL_TOL in norm for
# every trainable leaf (as tests/test_torch_gpu.py holds a 3-layer tower).
# Measured on the H100: metrics 4e-5 apart, tower gradients at most 1.05e-2
# (the last blocks' w1, whose inputs carry eleven layers' rounding
# differences, as the serving tower's features differ by 6.5e-3).  The
# step's own gradients are printed but not gated: with random weights the
# 128 features nearly coincide (the contrastive loss sits at ln(127)), so
# the loss's cotangent is a small difference of large terms and moves far
# more than the features do (measured 4.9e-2 apart, and bias gradients
# that sum it over the batch up to 0.17 apart).
STEP_METRIC_REL_TOL = 2e-3
STEP_GRAD_REL_TOL = 2e-2
# train_end's retrieval hinge, mean(relu(pos_d - neg_d + 0.1)), is a small
# difference of large Poincaré distances to label rows near the ball's
# boundary, so a relative gap in it is the features' rounding difference
# magnified: at the wide towers its move when the plain blocks' pixels get
# noise of std 1e-3 reaches 2e-3 by itself.  There (and only there: the
# ViT-B/16 step keeps STEP_METRIC_REL_TOL) the hinge is held to
# HINGE_NOISE_MULT times the root mean square of that move over
# HINGE_NOISE_DRAWS draws, measured in the same run, and never to less
# than STEP_METRIC_REL_TOL; a planted fault, every attention of the plain
# blocks seeing its first 16 keys only, must fail that gate.  PERF.md
# section 6 gives the readings over seeds at both wide towers.
STEP_HINGE = "retrieval_loss"
HINGE_NOISE_DRAWS = 8
HINGE_NOISE_MULT = 3.0


def rel_gap(a, b) -> float:
    """||a - b|| / ||b||."""
    return float((a - b).norm() / b.norm())


def grad_gaps(gk: dict, gp: dict) -> dict[str, float]:
    """Per-leaf rel_gap of two gradients (name → tensor)."""
    return {n: rel_gap(gk[n], g) for n, g in gp.items()}


def check_train_step(torch, metrics, tower, step, dz, yardstick,
                     what: str = "fine-tune step, ViT-B/16",
                     metric_yardstick: dict | None = None,
                     metric_tols: dict | None = None) -> None:
    """Hold one training step with the kernels to one with the plain
    blocks; each of the first four arguments is a (kernels, plain) pair:
    the step's metrics, the tower's gradients given one cotangent, the
    step's gradients, and the loss's cotangent of the tower's features.
    ``yardstick``: per-leaf gaps of the plain tower's gradients when its
    pixels get noise of std 1e-3, printed beside the tower's gaps;
    ``metric_yardstick``: the same for the loss's metrics (the plain
    blocks' relative gaps), printed beside the metrics' gaps;
    ``metric_tols``: a metric's gate where it is not STEP_METRIC_REL_TOL."""
    (mk, mp), (tk, tp), (sk, sp) = metrics, tower, step
    metric_gaps = {key: abs(mk[key] - want) / abs(want)
                   for key, want in mp.items()}
    tols = {key: STEP_METRIC_REL_TOL for key in mp} | (metric_tols or {})
    check(set(tk) == set(tp) and set(sk) == set(sp) and tp,
          "the kernels and the plain blocks train different leaves")
    tgaps, sgaps = grad_gaps(tk, tp), grad_gaps(sk, sp)

    def largest(gaps):
        return ", ".join(f"{n} {g:.3g}" for n, g in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:3])

    print(f"[kernel] {what}, kernels vs plain blocks: "
          + ", ".join(f"{key} {mk[key]:.6f} vs {mp[key]:.6f}"
                      for key in mp)
          + "; relative gaps " + ", ".join(
              f"{key} {g:.2g}" + (f" (yardstick {metric_yardstick[key]:.2g})"
                                  if metric_yardstick else "")
              for key, g in metric_gaps.items())
          + f"; tower gradients given one cotangent, {len(tp)} trainable "
          f"leaves, largest gaps: {largest(tgaps)} (yardstick, plain vs "
          f"plain on pixels + 1e-3 noise: {largest(yardstick)}); the "
          "step's gradients "
          f"({len(sp)} leaves), largest gaps: {largest(sgaps)}, with the "
          f"loss's cotangent of the features {rel_gap(*dz):.3g} "
          "apart")
    check(all(math.isfinite(v) for v in mk.values())
          and all(g <= tols[key] for key, g in metric_gaps.items()),
          f"training step metrics with kernels {mk} differ from the plain "
          f"blocks' {mp} by more than {tols} relative")
    check(all(bool(torch.isfinite(g).all()) for g in sk.values()),
          "the step's gradients with kernels are not finite")
    for name, gap in tgaps.items():
        check(math.isfinite(gap) and gap <= STEP_GRAD_REL_TOL,
              f"tower gradient of {name} with kernels differs from the "
              f"plain blocks' by {gap:.3g} in norm (gate "
              f"{STEP_GRAD_REL_TOL})")


def train_bounds(b, s, valid, d, f) -> dict[str, tuple]:
    """bound() of rows 12, 13, 15, 16 on the fine-tune's shapes: attention
    on the padded stream [B, S, D] over the valid keys, the MLP on the
    B·valid unpadded rows; each input read once and each output written
    once (activations bf16, matrices bf16, vectors and the MLP's parameter
    cotangents f32)."""
    m, mv = b * s, b * valid
    attn = 4 * b * s * valid * d               # q kᵀ and p v, valid keys
    return {
        "fused_attention_fwd": bound(
            2 * 2 * m * d + 2 * 4 * d * d + 4 * 4 * d,
            {"bf16": 2 * m * d * 3 * d + attn + 2 * m * d * d}),
        # the wrapper recomputes qkv from x, then the six products of the
        # attention backward (s, p v, dp, dq, dk, dv)
        "fused_attention_bwd": bound(
            2 * m * d + 2 * 3 * d * d + 4 * 3 * d + 2 * m * d
            + 2 * m * 3 * d + 2 * m * d,
            {"bf16": 2 * m * d * 3 * d + 3 * attn}),
        "fused_mlp_fwd": bound(
            2 * 2 * mv * d + 2 * 2 * d * f + 4 * (3 * d + f),
            {"bf16": 4 * mv * d * f}),
        # recompute g, then dW2, da, dW1, dh: five products of 2·M·D·F
        "fused_mlp_bwd": bound(
            3 * 2 * mv * d + 2 * 2 * d * f + 4 * (2 * d + f)
            + 4 * (2 * d * f + 3 * d + f),
            {"bf16": 10 * mv * d * f})}


# Rows 17 and 18 against their plain versions: both are f32 throughout
# and differ by the order of their sums and by their tanh / log, so the
# gate is on max |kernel - plain| / max |plain|.  Measured on the H100:
# 4.1e-7 (row 17), 1.0e-6 (row 18); the gates sit at 5x and 4x, and the
# nearest control (the bias dropped from row 18) is at 2.4e-2.
HYP_REL_TOL = {"pairwise_dist_pallas": 2e-6, "mobius_dense_pallas": 4e-6}
# the kernel path's top-10 at 1M x 128 against the exact f64 ranking over
# the whole gallery
POINCARE_MIN_RECALL = 0.999


def max_rel(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def hyp_gate(torch, kname, tag, got, ref, controls: dict) -> float:
    """Hold a hyperbolic kernel's output to its plain version's within
    HYP_REL_TOL[kname] and require every control to fail the same gate.
    Returns the max-abs error."""
    torch.cuda.synchronize()
    tol = HYP_REL_TOL[kname]
    check(bool(torch.isfinite(got).all()), f"{kname} {tag}: non-finite")
    err = max_rel(got, ref)
    cerr = {c: max_rel(t, ref) for c, t in controls.items()}
    print(f"[kernel] {kname} {tag} vs plain: max rel err {err:.3g} (gate "
          f"{tol}); controls (must fail): "
          + ", ".join(f"{c} {e:.3g}" for c, e in cerr.items()))
    check(err <= tol, f"{kname} {tag} disagrees with its plain version "
          f"(gate: max rel err <= {tol})")
    for c, e in cerr.items():
        check(e > tol, f"{kname} {tag}: control '{c}' passes the gate")
    return float((got - ref).abs().max())


def ball_points(torch, n, d, c, gen, dev, r_hi=0.95, r_lo=0.05):
    """n points of the ball of curvature c: uniform directions, radii
    from r_lo to r_hi of its radius."""
    v = torch.randn(n, d, generator=gen, device=dev)
    r = r_lo + (r_hi - r_lo) * torch.rand(n, 1, generator=gen, device=dev)
    return (v / v.norm(dim=-1, keepdim=True) * r / math.sqrt(c)).contiguous()


def pairwise_dist_f64(x, y, c: float):
    """Row 17's function in float64 on the same float32 points: the
    exact distance that the kernel and its plain version both round."""
    x, y = x.double(), y.double()
    x2 = (x * x).sum(1, keepdim=True)
    y2 = (y * y).sum(1, keepdim=True)
    sq = (x2 - 2.0 * (x @ y.T) + y2.T).clamp_min(0.0)
    gamma = (1.0 + 2.0 * c * sq / ((1.0 - c * x2).clamp_min(1e-15)
                                  * (1.0 - c * y2.T).clamp_min(1e-15))
             ).clamp_min(1.0 + 1e-7)
    return (gamma + (gamma * gamma - 1.0).sqrt()).log() / math.sqrt(c)


# Row 17 near the boundary (radius 0.999/sqrt(c)): 1 - c|x|^2 is ~2e-3
# there, so an ulp of |x|^2 moves the distance by ~1e-5 of its largest
# value, and any two f32 sums of the squares (the plain version's and the
# kernel's) differ by more than HYP_REL_TOL.  The gate there is the exact
# f64 distance of the same points: the kernel's max rel error against it
# within NEAR_BOUNDARY_FACTOR times the plain version's own.
NEAR_BOUNDARY_FACTOR = 2.0


def check_pairwise_near_boundary(torch, pk, x, y, c: float,
                                 tag: str = "radius 0.999/sqrt(c)") -> float:
    """Hold row 17 on near-boundary points to the f64 distance of the
    same points, within NEAR_BOUNDARY_FACTOR times the plain version's
    error, with c off by 1% as the control.  Returns the max-abs error
    against the plain version."""
    got = pk.pairwise_dist_pallas(x, y, c)
    ref = pk.pairwise_dist_pallas_plain(x, y, c)
    exact = pairwise_dist_f64(x, y, c)
    control = pk.pairwise_dist_pallas_plain(x, y, 1.01 * c)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "pairwise_dist_pallas near the "
          "boundary: non-finite")
    e_got, e_ref = max_rel(got.double(), exact), max_rel(ref.double(), exact)
    e_ctl = max_rel(control.double(), exact)
    tol = NEAR_BOUNDARY_FACTOR * e_ref
    print(f"[kernel] pairwise_dist_pallas [{x.shape[0]}, {x.shape[1]}] x "
          f"[{y.shape[0]}, {y.shape[1]}], {tag}: max rel err "
          f"vs the f64 distance {e_got:.3g} (plain version {e_ref:.3g}; gate "
          f"{tol:.3g}); vs plain {max_rel(got, ref):.3g}; control (must "
          f"fail): c x 1.01 {e_ctl:.3g}")
    check(e_got <= tol, f"pairwise_dist_pallas ({tag}) is farther from the "
          f"f64 distance than {NEAR_BOUNDARY_FACTOR}x the plain version")
    check(e_ctl > tol, f"pairwise_dist_pallas ({tag}): control 'c x 1.01' "
          "passes the gate")
    return float((got - ref).abs().max())


def hyperbolic_bounds(n_enc, k_in, d_hid, n_fig, n_pat, d_emb, nq, n_gal,
                      pool) -> dict[str, tuple]:
    """bound() of rows 18, 17 and 4 at the path's shapes: each input read
    once and each output written once; f32 FMAs for 18 and 17, int8
    products for 4 (whose rows carry three f32 terms, its queries two)."""
    return {
        "mobius_dense_pallas": bound(
            4 * (n_enc * k_in + k_in * d_hid + d_hid + n_enc * d_hid),
            {"fp32": 2 * n_enc * k_in * d_hid}),
        "pairwise_dist_pallas": bound(
            4 * (n_fig * d_emb + n_pat * d_emb + n_fig * n_pat),
            {"fp32": 2 * n_fig * n_pat * d_emb}),
        "bucket_topk_poincare": bound(
            n_gal * d_emb + 12 * n_gal + nq * (d_emb + 8) + nq * pool * 12,
            {"int8": 2 * nq * n_gal * d_emb})}


def exact_poincare_topk(torch, q, gal, c, k, chunk: int = 32):
    """The exact top-k by f64 distance over the whole gallery: the arcosh
    argument 1 + 2c|u-v|²/((1-c|u|²)(1-c|v|²)) is monotone in the
    distance; |u-v|² from an f64 Gram product."""
    g = gal.double()
    g2 = (g * g).sum(-1)
    beta = 1.0 - c * g2
    out = []
    for s in range(0, q.shape[0], chunk):
        u = q[s:s + chunk].double()
        u2 = (u * u).sum(-1, keepdim=True)
        sq = (u2 - 2.0 * (u @ g.T) + g2).clamp_min(0.0)
        arg = sq / ((1.0 - c * u2) * beta)
        out.append(torch.topk(arg, k, dim=1, largest=False).indices)
    return torch.cat(out)


# The hyperbolic path's shapes: the HypTrainConfig model (512 -> 256 ->
# 128, c = 2); the engine's batch of 512 feature rows; one evaluation batch
# of 256 figures against DeepPatent 2018's 16,059 patents (two figures
# each); a gallery of 1M rows and 256 queries.
HYP_SIZES = {"c": 2.0, "n_enc": 512, "k_in": 512, "d_hid": 256,
             "d_emb": 128, "n_fig": 256, "patents": 16059,
             "n_gal": 1_000_000, "nq": 256, "map_subset": 2048}


def hyperbolic_kernel_checks(torch, dev, errs: dict, z: dict) -> dict:
    """Rows 18, 17 and 4 against their plain versions at the path's
    shapes, on a generator of their own: row 18 on unit features (which
    saturate the layer at the projection radius, as the encoder's first
    layer is) and on features x 0.02 (inside the ball), row 17 on ball
    points up to 0.95/sqrt(c), row 4 over a 1M-row ball gallery (equal to
    its plain version).  Returns the inputs the times reuse."""
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import poincare, topk_kernel

    gen = torch.Generator(device=dev).manual_seed(5)
    c, k_in, d_hid, d_emb = z["c"], z["k_in"], z["d_hid"], z["d_emb"]
    lim = math.sqrt(6.0 / (k_in + d_hid))
    w18 = (2.0 * torch.rand(k_in, d_hid, generator=gen, device=dev) - 1.0
           ) * lim
    b18 = poincare.expmap0(1e-3 * torch.randn(d_hid, generator=gen,
                                              device=dev), c).contiguous()
    x18 = torch.randn(z["n_enc"], k_in, generator=gen, device=dev)
    plain18 = pk.mobius_dense_pallas_plain
    for tag, xs in (("unit features", x18), ("features x 0.02", 0.02 * x18)):
        # a saturated row sits on the boundary, where Möbius-adding any
        # bias returns the row itself: there only the K-loop control bites
        controls = {"last 32 of K dropped": plain18(xs[:, :-32], w18[:-32],
                                                    b18, c)}
        if tag != "unit features":
            controls["no bias"] = plain18(xs, w18, torch.zeros_like(b18), c)
        errs["mobius_dense_pallas"] = max(
            errs.get("mobius_dense_pallas", 0.0),
            hyp_gate(torch, "mobius_dense_pallas", f"[{z['n_enc']}, {k_in}] "
                     f"x [{k_in}, {d_hid}], {tag}",
                     pk.mobius_dense_pallas(xs, w18, b18, c),
                     plain18(xs, w18, b18, c), controls))
    x17 = ball_points(torch, z["n_fig"], d_emb, c, gen, dev)
    y17 = ball_points(torch, z["patents"], d_emb, c, gen, dev)
    errs["pairwise_dist_pallas"] = hyp_gate(
        torch, "pairwise_dist_pallas", f"[{z['n_fig']}, {d_emb}] x "
        f"[{z['patents']}, {d_emb}], radii to 0.95/sqrt(c)",
        pk.pairwise_dist_pallas(x17, y17, c),
        pk.pairwise_dist_pallas_plain(x17, y17, c),
        {"c x 1.01": pk.pairwise_dist_pallas_plain(x17, y17, 1.01 * c)})
    # the last evaluation batch can hold one figure; rows of 5 floats are
    # not 16-byte aligned (the kernel's 4-byte copies)
    x5 = ball_points(torch, z["n_fig"], 5, c, gen, dev)
    y5 = ball_points(torch, z["patents"], 5, c, gen, dev)
    for tag, xs, ys in (("n 1", x17[:1], y17), ("d 5", x5, y5)):
        errs["pairwise_dist_pallas"] = max(
            errs["pairwise_dist_pallas"],
            hyp_gate(torch, "pairwise_dist_pallas",
                     f"[{xs.shape[0]}, {xs.shape[1]}] x [{ys.shape[0]}, "
                     f"{ys.shape[1]}], {tag}", pk.pairwise_dist_pallas(
                         xs, ys, c), pk.pairwise_dist_pallas_plain(xs, ys, c),
                     {"c x 1.01": pk.pairwise_dist_pallas_plain(
                         xs, ys, 1.01 * c)}))
    errs["pairwise_dist_pallas"] = max(
        errs["pairwise_dist_pallas"], check_pairwise_near_boundary(
            torch, pk, ball_points(torch, z["n_fig"], d_emb, c, gen, dev,
                                   0.999, 0.999),
            ball_points(torch, z["patents"], d_emb, c, gen, dev, 0.999,
                        0.999), c))
    nq = z["nq"]
    gal = ball_points(torch, z["n_gal"], d_emb, c, gen, dev)
    for m in TIE_STEPS:
        gal[TIE_ROW + m * topk_kernel.BUCKETS] = gal[TIE_ROW]
    hq = torch.cat([gal[:nq // 2] * 0.999,
                    ball_points(torch, nq - nq // 2, d_emb, c, gen, dev)])
    pgal = topk_kernel.prepare_poincare_gallery(gal, c)
    check_poincare_shapes(torch, topk_kernel, pgal, gal, c, gen, dev)
    terms = topk_kernel.quantize_poincare_queries(hq)
    top2 = topk_kernel._bucket_top2_poincare_cuda(*terms, pgal)
    top2_plain = topk_kernel.bucket_top2_poincare_plain(*terms, pgal)
    no_b = topk_kernel.bucket_top2_poincare_plain(
        *terms, pgal._replace(b=torch.zeros_like(pgal.b)))
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(a, b)) for a, b in zip(top2, top2_plain))
    control = any(not torch.equal(a, b) for a, b in zip(no_b, top2_plain))
    print(f"[kernel] bucket_topk_poincare n={z['n_gal']}, D={d_emb}, Q={nq}: "
          f"(v1, i1, v2, i2) equal to plain: {equal}; control without the "
          f"b term differs: {control}")
    check(equal and control, "Poincaré bucket kernel check failed")
    errs["bucket_topk_poincare"] = 0.0
    return {"gen": gen, "w18": w18, "b18": b18, "x18": x18, "x17": x17,
            "y17": y17, "hq": hq, "pgal": pgal}


def check_poincare_shapes(torch, tk, pgal, gal, c, gen, dev) -> None:
    """Row 4 at every count of TOPK_QUERY_COUNTS over the first 1,000 rows
    of the prepared ball gallery ``pgal`` (of ``gal``) and over all of it,
    every 97th row masked (w = 0), with query 0 a copy of TIE_ROW, which
    the gallery repeats TIE_STEPS steps later in its bucket: (v1, i1, v2,
    i2) equal to the plain version's, the capacity min(live rows, 2L), no
    masked row, the tie to the earliest copy.  Then a fold with '>=' on
    the surrogate's scores (topk_kernel.bucket_top2_walk) as a control,
    which must fail the tie check."""
    L = tk.BUCKETS
    w = pgal.w.clone()
    w[::97] = 0.0
    masked = pgal._replace(w=w)
    for n in (1000, gal.shape[0]):
        g = tk.PoincareGallery(*(t[:n] for t in masked))
        tie = min(TIE_ROW, n - 1)
        n_live = int((g.w > 0).sum())
        bad = (g.w <= 0).nonzero()[:, 0].to(torch.int32)
        for nq in TOPK_QUERY_COUNTS:
            q = ball_points(torch, nq, gal.shape[1], c, gen, dev)
            q[0] = gal[tie]
            terms = tk.quantize_poincare_queries(q)
            top2 = tk._bucket_top2_poincare_cuda(*terms, g)
            want = tk.bucket_top2_poincare_plain(*terms, g)
            torch.cuda.synchronize()
            equal = all(bool(torch.equal(a, b)) for a, b in zip(top2, want))
            cap = live_candidates(torch, top2)
            clean = not any(bool(torch.isin(i[v > float("-inf")], bad).any())
                            for i, v in ((top2[1], top2[0]),
                                         (top2[3], top2[2])))
            tied = int(top2[1][0, tie % L])
            print(f"[kernel] Poincaré bucket stage n={n}, Q={nq}: (v1, i1, "
                  f"v2, i2) equal to plain: {equal}; candidates a query "
                  f"{cap} (capacity {min(n_live, 2 * L)}); masked rows "
                  f"absent: {clean}; planted tie to column {tied} (want "
                  f"{tie})")
            check(equal and cap == min(n_live, 2 * L) and clean
                  and tied == tie,
                  f"Poincaré bucket stage check failed at n={n}, Q={nq}")
    # the control: '>=' keeps the latest copy of the planted tie
    q = ball_points(torch, 65, gal.shape[1], c, gen, dev)
    q[0] = gal[TIE_ROW]
    q_i8, qs, q_sq = tk.quantize_poincare_queries(q)
    scores = (qs * (tk.int_mm(q_i8, masked.gal_i8) * masked.gw2)
              - q_sq * masked.w - masked.b).masked_fill(
                  masked.w[None, :] <= 0, float("-inf"))
    got = tk._bucket_top2_poincare_cuda(q_i8, qs, q_sq, masked)
    ties = tk.bucket_top2_walk(scores, L, strict=False)
    tie_ok = [int(t[1][0, TIE_ROW % L]) == TIE_ROW for t in (got, ties)]
    print(f"[kernel] Poincaré bucket stage control at n={gal.shape[0]}, "
          f"Q=65: tie check (kernel, '>=' fold) {tie_ok}")
    check(tie_ok == [True, False], "the Poincaré stage's tie check cannot "
          "tell a '>=' fold from the kernel's")


def hyperbolic_slice(torch, dev, z: dict, h: dict, run_path, cli) -> None:
    """The hyperbolic serving path: a prepared_training_data of z["patents"]
    patents with two figures each and CLIP-width features, the
    HypTrainConfig model from seeded weights saved as the JAX train_hyp
    saves its best checkpoint (the actions read no negatives, so the
    negative ratios are small); ``infer`` and ``dist`` through the CLI; the
    mAP on a subset with the kernels against the plain versions on the
    CPU; then HyperbolicRetrievalEngine(quantized=True) over z["n_gal"]
    seeded feature rows answering z["nq"] queries at k = 10, held by
    recall to the exact f64 ranking.  Adds what the times reuse to h."""
    import numpy as np

    from patent_tpu_torch.data import synthetic as synth
    from patent_tpu_torch.data.graph_build import (build_feature_matrix,
                                                   build_hetero_graph)
    from patent_tpu_torch.data.prep import prepare_training_data
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.models.weights import hyperbolic_params_to_jax
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import topk_kernel
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.retrieval.hyperbolic_engine import \
        HyperbolicRetrievalEngine
    from patent_tpu_torch.train import evaluate as hyp_eval
    from patent_tpu_torch.utils import checkpoint

    c, gen, nq, n_gal = z["c"], h["gen"], z["nq"], z["n_gal"]
    shutil.rmtree(HYP_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    records = synth.synthetic_records(num_patents=z["patents"],
                                      figures_per_patent=2, seed=0)
    graph = build_hetero_graph(records)
    xf = build_feature_matrix(graph, synth.synthetic_features(
        records, dim=z["k_in"], seed=0), feature_dim=z["k_in"])
    td = prepare_training_data(graph, xf, neg_ratio=1, fig_pair_ratio=1,
                               seed=0)
    td.save(os.path.join(HYP_DIR, "prepared_training_data"))
    model = HyperbolicEmbeddingModel(
        feature_dim=z["k_in"], embed_dim=z["d_emb"], label_num=td.num_labels,
        hidden_dims=(z["d_hid"],), c=c,
        generator=torch.Generator().manual_seed(2018))
    checkpoint.save(os.path.join(HYP_DIR, "models"),
                    f"best_retrieval_model_c{c}_e{z['d_emb']}",
                    {"params": hyperbolic_params_to_jax(model.state_dict()),
                     "step": 0, "epoch": 0})
    num_patents = td.label_offsets["medium_cpcs"] - td.label_offsets["patents"]
    print(f"[slice] hyperbolic data: {td.x_figures.shape[0]} figures, "
          f"{num_patents} patents, {td.num_labels} labels, written in "
          f"{time.perf_counter() - t0:.1f} s")
    log = io.StringIO()

    def infer_dist():
        with contextlib.redirect_stdout(log):
            rcs = [cli([action, "--path", HYP_DIR, "--device", dev.type,
                        "--latent_dim", str(z["d_emb"]),
                        f"hidden_dims=[{z['d_hid']}]", f"curvature={c}"])
                   for action in ("infer", "dist")]
        print(log.getvalue(), end="")
        check(rcs == [0, 0], f"infer / dist failed: {rcs}")

    run_path(f"infer + dist ({z['patents']} patents x 2 figures, "
             "HypTrainConfig widths)",
             (pk.pairwise_dist_pallas, pk.mobius_dense_pallas), infer_dist)
    out = log.getvalue()
    maps = re.findall(r"mAP \(label retrieval\): (\S+)", out)
    dist_json = json.loads(out[out.index("{"):out.rindex("}") + 1])
    check(len(maps) == 1 and 0.0 <= float(maps[0]) <= 1.0
          and set(dist_json) == {"patent", "medium", "big", "main"}
          and all(math.isfinite(v["true_mean"])
                  and math.isfinite(v["random_mean"]) and v["n"] > 0
                  for v in dist_json.values()),
          f"infer / dist output out of range: {maps}, {dist_json}")
    fig_pos: dict = {}
    for f_, p_ in td.y_pos.tolist():
        fig_pos.setdefault(f_, []).append(p_)
    sub = sorted(fig_pos)[:z["map_subset"]]
    model = model.to(dev).eval()
    map_k = hyp_eval.evaluate_retrieval_map(model, td.x_figures, sub,
                                            fig_pos, num_patents)
    map_p = hyp_eval.evaluate_retrieval_map(model.cpu(), td.x_figures, sub,
                                            fig_pos, num_patents)
    model = model.to(dev)
    print(f"[slice] infer mAP {maps[0]} over {len(fig_pos)} figures; on "
          f"{len(sub)} of them {map_k:.6f} with kernels, {map_p:.6f} with "
          "the plain versions on the CPU")
    check(abs(map_k - map_p) <= 1e-4, "label mAP with kernels differs from "
          "the plain versions'")

    # half the queries are gallery rows with noise
    feats = torch.randn(n_gal, z["k_in"], generator=gen, device=dev)
    qfeat = torch.cat([feats[:nq // 2] + 0.05 * torch.randn(
        nq // 2, z["k_in"], generator=gen, device=dev),
        torch.randn(nq - nq // 2, z["k_in"], generator=gen, device=dev)])
    names = [f"g{i}" for i in range(n_gal)]
    got = {}

    def engine_path():
        engine = HyperbolicRetrievalEngine(model, feats, names, device=dev,
                                           quantized=True)
        q_enc = engine.encode_features(qfeat)
        got.update(engine=engine, q=q_enc,
                   top=engine.index.search(q_enc, k=10))

    run_path(f"HyperbolicRetrievalEngine(quantized=True), {n_gal} rows, "
             f"{nq} queries at k=10",
             (pk.mobius_dense_pallas, topk_kernel.bucket_topk_poincare),
             engine_path)
    emb = got["engine"].index.embeddings
    radius = emb.norm(dim=-1) * math.sqrt(c)
    exact = exact_poincare_topk(torch, got["q"], emb, c, 10).cpu().numpy()
    _sv, scan_i = index_mod.topk_search(got["q"], emb, k=10,
                                        similarity="poincare", c=c)

    def recall(idx) -> float:
        return float(np.mean([len(set(a) & set(b)) / 10.0
                              for a, b in zip(idx, exact)]))

    rec_k, rec_s = recall(got["top"][1]), recall(scan_i.cpu().numpy())
    print(f"[slice] Poincaré top-10 at {n_gal} x {z['d_emb']} (encoded radii "
          f"{float(radius.min()):.4f}-{float(radius.max()):.4f} of "
          f"1/sqrt(c)): recall@10 against the exact f64 ranking, kernel "
          f"path {rec_k:.5f}, f32 surrogate scan {rec_s:.5f}")
    check(rec_k >= POINCARE_MIN_RECALL, f"Poincaré kernel path recall@10 "
          f"{rec_k} < {POINCARE_MIN_RECALL}")
    h.update(model=model, td=td, fig_pos=fig_pos, num_patents=num_patents,
             engine=got["engine"], feats=feats, q=got["q"], qfeat=qfeat,
             recall=rec_k, records=records, graph=graph, xf=xf)


def hyperbolic_times(torch, z: dict, h: dict, times: dict, bounds: dict,
                     label: str, k: int, pool: int) -> None:
    """The encoder over z["n_gal"] rows with row 18 against the plain first
    layer, the label mAP over a quarter of the figures (its device and
    host parts),
    Poincaré top-k QPS through the kernel path against the scan, and rows
    18, 17 and 4 against their plain versions at the path's shapes."""
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import topk_kernel
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.train import evaluate as hyp_eval

    c, n_gal, nq, engine = z["c"], z["n_gal"], z["nq"], h["engine"]
    first = h["model"].encoder.first_layer

    def encode(kernels):
        def go():
            first.kernels = kernels
            engine.encode_features(h["feats"])
        return go

    # one pass each, in turns: the engine has just encoded the same rows
    ms = [cuda_ms(torch, encode(kern), warmup=0, iters=1)
          for kern in (False, True, True, False)]
    ep, ek = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    first.kernels = True
    print(f"[time] hyperbolic encoder {z['k_in']} -> {z['d_hid']} -> "
          f"{z['d_emb']} over {n_gal} rows (batches of 512): row 18 "
          f"{n_gal / ek * 1e3:.0f} rows/s ({ek:.1f} ms), plain first layer "
          f"{n_gal / ep * 1e3:.0f} rows/s ({ep:.1f} ms) {label}")
    part = h["feats"][:20 * 512]
    print_breakdown(torch, "hyperbolic encoder with row 18, 20 batches of "
                    "512 rows", lambda: engine.encode_features(part))
    td, fig_pos = h["td"], h["fig_pos"]
    # a quarter of the figures: phase 4's infer runs the whole evaluation
    # through the CLI; this reads its device and host parts
    eval_idx = sorted(fig_pos)[:len(fig_pos) // 4]
    t0 = time.perf_counter()
    for _chunk, _d in hyp_eval.label_distance_batches(
            h["model"], td.x_figures, eval_idx, h["num_patents"]):
        pass
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyp_eval.evaluate_retrieval_map(h["model"], td.x_figures, eval_idx,
                                    fig_pos, h["num_patents"])
    t_all = time.perf_counter() - t0
    print(f"[time] label-retrieval mAP over {len(eval_idx)} of the "
          f"{len(fig_pos)} figures x {h['num_patents']} patents: "
          f"{t_all:.2f} s, of which encode + row "
          f"17 + copy to the host {t_dev:.2f} s and host AP "
          f"{t_all - t_dev:.2f} s {label}")
    q, emb = h["q"], engine.index.embeddings
    psp, psk = in_turns(
        torch, lambda: index_mod.topk_search(q, emb, k=k,
                                             similarity="poincare", c=c),
        lambda: index_mod.topk_search_poincare_fast(
            q, engine.index.emb_gal, emb, k=k, c=c))
    print(f"[time] Poincaré top-{k} at {n_gal} x {z['d_emb']}, Q={nq}: "
          f"kernel path {nq / psk * 1e3:.0f} QPS ({psk:.2f} ms), f32 scan "
          f"{nq / psp * 1e3:.0f} QPS ({psp:.2f} ms) {label}")
    print_breakdown(torch, f"Poincaré top-{k} through the kernel path",
                    lambda: index_mod.topk_search_poincare_fast(
                        q, engine.index.emb_gal, emb, k=k, c=c))
    w18, b18, x18 = h["w18"], h["b18"], h["x18"]
    x17, y17, hq, pgal = h["x17"], h["y17"], h["hq"], h["pgal"]
    times["mobius_dense_pallas"] = in_turns(
        torch, lambda: pk.mobius_dense_pallas_plain(x18, w18, b18, c),
        lambda: pk.mobius_dense_pallas(x18, w18, b18, c))
    shape = pk.mobius_dense_launch(z["n_enc"], z["d_hid"])
    dev18 = launch_times(
        torch, lambda: pk.mobius_dense_pallas(x18, w18, b18, c), 100)
    print(f"[time] row 18 (mobius_dense_pallas) at [{z['n_enc']}, "
          f"{z['k_in']}] x [{z['k_in']}, {z['d_hid']}]: "
          f"{times['mobius_dense_pallas'][1]:.4f} ms a call (wall); device "
          "time a launch (torch.profiler, 100 calls) "
          + ", ".join(f"{ms:.4f} ms ({n} launches seen) {kname[:40]}"
                      for kname, ms, n in dev18)
          + f"; {shape['ctas']} CTAs in thread-block clusters of "
          f"{shape['cluster']}, {shape['cols']} columns a CTA {label}")
    times["pairwise_dist_pallas"] = in_turns(
        torch, lambda: pk.pairwise_dist_pallas_plain(x17, y17, c),
        lambda: pk.pairwise_dist_pallas(x17, y17, c))
    dev17 = launch_times(torch, lambda: pk.pairwise_dist_pallas(x17, y17, c),
                         100)
    print(f"[time] row 17 (pairwise_dist_pallas) at [{z['n_fig']}, "
          f"{z['d_emb']}] x [{z['patents']}, {z['d_emb']}]: "
          f"{times['pairwise_dist_pallas'][1]:.4f} ms a call (wall); device "
          "time a launch (torch.profiler, 100 calls) "
          + ", ".join(f"{ms:.4f} ms ({n} launches seen) {kname[:40]}"
                      for kname, ms, n in dev17) + f" {label}")
    times["bucket_topk_poincare"] = in_turns(
        torch, lambda: topk_kernel.bucket_topk_poincare_plain(hq, pgal, pool),
        lambda: topk_kernel.bucket_topk_poincare(hq, pgal, pool))
    dev4 = launch_times(
        torch, lambda: topk_kernel.bucket_topk_poincare(hq, pgal, pool), 30)
    print(f"[time] row 4 (bucket_topk_poincare) at {n_gal} x {z['d_emb']}, "
          f"Q={nq}, pool {pool}: {times['bucket_topk_poincare'][1]:.4f} ms a "
          "call (wall); device time by kernel (torch.profiler, 30 calls) "
          + ", ".join(f"{ms:.4f} ms a launch ({n} launches seen) "
                      f"{kname[:60]}" for kname, ms, n in
                      sorted(dev4, key=lambda r: -r[1] * r[2])[:6])
          + f"; {sum(ms * n for _k, ms, n in dev4) / 30:.4f} ms a call "
          f"{label}")
    bounds.update(hyperbolic_bounds(z["n_enc"], z["k_in"], z["d_hid"],
                                    z["n_fig"], z["patents"], z["d_emb"], nq,
                                    n_gal, pool))
    h.clear()


# ---- the hyperbolic trainers (train/train_hyp.py, train/train_hyp_con.py)

TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")


def read_latest(path: str) -> dict:
    from patent_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(path, "models")).restore("latest")


def read_best(path: str, name: str) -> dict:
    from patent_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(path, "models")).restore(
        name)["params"]


def leaves_equal(np, a: dict, b: dict) -> bool:
    """Nested dicts of arrays equal leaf for leaf, in bits."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(leaves_equal(np, a[k], b[k])
                                        for k in a)
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def hyperbolic_training(torch, dev, z: dict, h: dict, run_path, cli,
                        errs: dict) -> None:
    """train_hyp through the CLI on the card at HypTrainConfig's defaults
    on the hyperbolic slice's prepared data: --epochs 2 then --resume
    --epochs 3, against a fresh --epochs 3 (history, latest and best params
    equal in bits); one validate_with=map epoch (rows 17 and 18 inside the
    trainer); row 17 on the trained label table against the f64 distance;
    infer and a quantized HyperbolicRetrievalEngine over the trained
    checkpoint (row 4's stage against its plain version on the trained
    gallery; recall@10 against the exact f64 ranking printed beside the
    seeded model's); train_hyp_con --epochs 2, whose loss must be finite
    and fall.  Adds the trained params to h."""
    import numpy as np

    from patent_tpu_torch.models.weights import hyperbolic_params_from_jax
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import topk_kernel
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.retrieval.hyperbolic_engine import \
        HyperbolicRetrievalEngine
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.utils.config import HypTrainConfig

    t_phase = time.perf_counter()
    c, d_emb = z["c"], z["d_emb"]
    cfg = HypTrainConfig()
    check((cfg.curvature, cfg.embed_dim, cfg.hidden_dims, cfg.feature_dim)
          == (c, d_emb, (z["d_hid"],), z["k_in"]),
          "HYP_SIZES are not HypTrainConfig's defaults")
    prep = os.path.join(HYP_DIR, "prepared_training_data")
    dirs = {k: os.path.join(TRAIN_DIR, k)
            for k in ("resumed", "fresh", "map", "con")}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    for d in dirs.values():
        shutil.copytree(prep, os.path.join(d, "prepared_training_data"))
    rows = (pk.pairwise_dist_pallas, pk.mobius_dense_pallas)
    outs = {}

    def action(key, name, *flags):
        def go():
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = cli([name, "--path", dirs[key], "--device", dev.type]
                         + list(flags))
            print(log.getvalue(), end="")
            check(rc == 0, f"{name} {' '.join(flags)} in {key} failed: {rc}")
            outs[(key, name) + flags] = log.getvalue()
        return go

    run_path("train_hyp --epochs 2 (HypTrainConfig defaults)", rows,
             action("resumed", "train_hyp", "--epochs", "2"))
    run_path("train_hyp --resume --epochs 3", rows,
             action("resumed", "train_hyp", "--resume", "--epochs", "3"))
    run_path("train_hyp --epochs 3 (uninterrupted)", rows,
             action("fresh", "train_hyp", "--epochs", "3"))
    best_name = th.best_checkpoint_name(cfg)
    la, lb = read_latest(dirs["resumed"]), read_latest(dirs["fresh"])
    hist = {k: (np.asarray(la[k]), np.asarray(lb[k]))
            for k in ("hist_train_loss", "hist_val_loss")}
    same_hist = all(a.tobytes() == b.tobytes() for a, b in hist.values())
    same_latest = leaves_equal(np, la["params"], lb["params"])
    best_a = read_best(dirs["resumed"], best_name)
    best_b = read_best(dirs["fresh"], best_name)
    same_best = leaves_equal(np, best_a, best_b)
    maps = {k: re.findall(r"test mAP \(label retrieval\): (\S+)", v)
            for k, v in outs.items()}
    print(f"[slice] train_hyp resumed after epoch 2 vs uninterrupted, 3 "
          f"epochs: train loss {hist['hist_train_loss'][0].tolist()} / "
          f"{hist['hist_train_loss'][1].tolist()}, val loss "
          f"{hist['hist_val_loss'][0].tolist()}; history equal in bits "
          f"{same_hist}, latest params {same_latest}, best params "
          f"{same_best}; test mAP {maps}")
    check(same_hist and same_latest and same_best,
          "train_hyp resumed after epoch 2 differs from the uninterrupted run")
    check(bool(np.isfinite(hist["hist_train_loss"][1]).all()),
          "train_hyp loss is not finite")

    run_path("train_hyp validate_with=map, 1 epoch", rows,
             action("map", "train_hyp", "--epochs", "1", "validate_with=map"))
    vmap = float(read_latest(dirs["map"])["hist_val_map"][0])
    print(f"[slice] train_hyp validate_with=map: val mAP {vmap:.6f}")
    check(0.0 <= vmap <= 1.0, f"val mAP {vmap} out of range")

    # the trained model on the card: row 17 on its label table
    td = h["td"]
    params = hyperbolic_params_from_jax(best_b)
    model = th.build_model(td, cfg, dev)
    model.load_state_dict(params)
    model.eval()
    num_patents = h["num_patents"]
    with torch.no_grad():
        enc = model(torch.as_tensor(td.x_figures[:z["n_fig"]], device=dev))
    labels = model.label_emb.detach()[:num_patents].contiguous()
    radius = labels.norm(dim=-1) * math.sqrt(c)
    errs["pairwise_dist_pallas"] = max(
        errs["pairwise_dist_pallas"], check_pairwise_near_boundary(
            torch, pk, enc, labels, c, "the trained label table (radii "
            f"{float(radius.min()):.4f}-{float(radius.max()):.4f} of "
            "1/sqrt(c))"))

    run_path("infer on the trained checkpoint", rows,
             action("fresh", "infer"))
    got = {}

    def engine_path():
        engine = HyperbolicRetrievalEngine(model, h["feats"],
                                           [f"g{i}" for i in range(
                                               z["n_gal"])], device=dev,
                                           quantized=True)
        q = engine.encode_features(h["qfeat"])
        got.update(top=engine.index.search(q, k=10), q=q, index=engine.index)

    run_path(f"HyperbolicRetrievalEngine(quantized=True) on the trained "
             f"model, {z['n_gal']} rows",
             (pk.mobius_dense_pallas, topk_kernel.bucket_topk_poincare),
             engine_path)
    index = got["index"]
    emb, q = index.embeddings, got["q"]
    vals, idx = got["top"]
    check(np.isfinite(vals).all() and idx.shape == (q.shape[0], 10)
          and 0 <= idx.min() and idx.max() < z["n_gal"],
          "the engine's answers on the trained model are malformed")
    # row 4's stage on the trained gallery, whose rows crowd the
    # projection radius, against its plain version
    terms = topk_kernel._poincare_queries(q, index.emb_gal)
    top2 = topk_kernel._bucket_top2_poincare_cuda(*terms, index.emb_gal)
    top2_plain = topk_kernel.bucket_top2_poincare_plain(*terms,
                                                        index.emb_gal)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(a, b)) for a, b in zip(top2, top2_plain))
    check(equal, "row 4's stage differs from its plain version on the "
          "trained gallery")
    exact = exact_poincare_topk(torch, q, emb, c, 10).cpu().numpy()

    def recall(idx) -> float:
        return float(np.mean([len(set(a) & set(b)) / 10.0
                              for a, b in zip(idx, exact)]))

    _v, scan = index_mod.topk_search(q, emb, k=10, similarity="poincare",
                                     c=c)
    gr = emb.norm(dim=-1) * math.sqrt(c)
    clipped = float((gr >= (1.0 - 4e-3) * (1.0 - 1e-6)).float().mean())
    # a measured finding, held to no threshold: the int8 stage cannot order
    # a gallery crowded at the projection radius (the JAX path misses there
    # as well); POINCARE_MIN_RECALL holds the seeded gallery above
    print(f"[slice] Poincaré top-10 at {z['n_gal']} x {d_emb} on the trained "
          f"model (radii {float(gr.min()):.4f}-{float(gr.max()):.4f} of "
          f"1/sqrt(c), {100 * clipped:.2f}% at the projection radius): row "
          f"4's stage equal to its plain version: {equal}; recall@10 "
          f"against the exact f64 ranking: the engine (int8 stage, row 4) "
          f"{recall(idx):.5f}, the f32 surrogate scan "
          f"{recall(scan.cpu().numpy()):.5f} (seeded model: the engine "
          f"{h['recall']:.5f})")
    del got

    action("con", "train_hyp_con", "--epochs", "2")()
    with open(os.path.join(dirs["con"], "logs", "train_hyp_con.jsonl")) as f:
        con = [json.loads(line)["train_loss"] for line in f
               if '"epoch"' in line]
    print(f"[slice] train_hyp_con --epochs 2 (HypConTrainConfig defaults): "
          f"train loss {con}")
    check(len(con) == 2 and all(math.isfinite(v) for v in con)
          and con[1] < con[0], f"train_hyp_con loss did not fall: {con}")
    h.update(trained=params)
    print(f"[slice] hyperbolic training phase: "
          f"{time.perf_counter() - t_phase:.1f} s")


def hyperbolic_train_times(torch, dev, z: dict, h: dict, label: str) -> None:
    """train_hyp's epoch on the card at HypTrainConfig's defaults from the
    trained weights, eager and as CUDA graphs (``make_epoch_step``): ms a
    step (CUDA events over the epoch / its steps) and steps/s; an epoch as
    the trainer runs it (sampling, the copy, the steps, the validation
    loss, the metrics read) in seconds; the device busy share, the top
    kernels, the kernels a step and the host's launch calls a step
    (torch.profiler over PROFILE_STEPS steps); a map validation's seconds
    and rows 17 and 18's share of it."""
    import numpy as np

    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.evaluate import evaluate_retrieval_map
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import HypTrainConfig

    t_all = time.perf_counter()
    cfg = HypTrainConfig()
    td = h["td"]
    x = torch.as_tensor(td.x_figures, device=dev)
    impl = torch.as_tensor(td.implication, dtype=torch.long, device=dev)
    excl = torch.as_tensor(td.exclusion, dtype=torch.long,
                           device=dev).reshape(-1, 2)
    rng = np.random.default_rng(cfg.seed)
    packed = th.PackedSupervision(td)
    perm = rng.permutation(len(packed.usable))
    n_train = int(len(packed.usable) * cfg.train_ratio)
    n_val = int(len(packed.usable) * cfg.val_ratio)
    train_slots = packed.slots_for(packed.usable[perm[:n_train]])
    val_idx = packed.usable[perm[n_train:n_train + n_val]]
    val_slots = packed.slots_for(val_idx)
    arrays = th.stack_epoch_batches(packed, train_slots, cfg.batch_size,
                                    cfg.num_neg_samples, rng)
    nb = len(arrays[0])
    for graphed in (False, True):
        kind = "graphed" if graphed else "eager"
        model = th.build_model(td, cfg, dev)
        model.load_state_dict(h["trained"])
        opt = RiemannianAdam(dict(model.named_parameters()),
                             cfg.learning_rate, c=cfg.curvature)
        train, evaluate = th.make_epoch_step(model, opt, cfg,
                                             graphed=graphed)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        def epoch():
            train(arrays, x, impl, excl, gen)

        if graphed:
            epoch()             # the warm-up and the capture
        ms = cuda_ms(torch, epoch, warmup=0, iters=1)
        line = (f"[time] train_hyp at HypTrainConfig's defaults, {kind} "
                f"({len(train_slots)} training figures, batch "
                f"{cfg.batch_size}: {nb} steps an epoch): {ms / nb:.3f} ms a "
                f"step, {nb / ms * 1e3:.1f} steps/s (CUDA events over an "
                f"epoch)")
        if graphed:
            # an epoch as the trainer runs it: sampling, the copy, the
            # steps, the validation epoch, the metrics read
            t0 = time.perf_counter()
            sums = train(th.stack_epoch_batches(
                packed, train_slots, cfg.batch_size, cfg.num_neg_samples,
                rng), x, impl, excl, gen)
            evaluate(th.stack_epoch_batches(
                packed, val_slots, cfg.batch_size, cfg.num_neg_samples, rng),
                x, impl, excl)["total_loss"].item()
            torch.stack(list(sums.values())).tolist()
            line += (f"; an epoch with its sampling, copy and validation "
                     f"loss {time.perf_counter() - t0:.3f} s")
        print(f"{line} {label}")
        # the profiles over the epoch's first PROFILE_STEPS steps (a new
        # shape, captured before it is profiled): a whole epoch's 340k
        # kernel events take the profiler minutes to reduce
        short = tuple(a[:PROFILE_STEPS] for a in arrays)

        def short_epoch():
            train(short, x, impl, excl, gen)

        rows = launch_times(torch, short_epoch, iters=1)
        busy = sum(t * n for _k, t, n in rows) / PROFILE_STEPS
        launches = sum(n for _k, _t, n in rows) / PROFILE_STEPS
        host = host_launch_calls(torch, short_epoch) / PROFILE_STEPS
        top = sorted(rows, key=lambda r: -r[1] * r[2])[:6]
        print(f"[time] train_hyp step profile, {kind} (torch.profiler, "
              f"{PROFILE_STEPS} steps): {busy:.3f} ms busy a step of "
              f"{ms / nb:.3f} ms wall ({100 * busy * nb / ms:.1f}%), "
              f"{launches:.0f} kernels and {host:.1f} host launch calls a "
              f"step; top kernels (ms a step): "
              + "; ".join(f"{t * n / PROFILE_STEPS:.3f} ({n // PROFILE_STEPS}"
                          f" launches) {k[:60]}" for k, t, n in top)
              + f" {label}")
    fig_pos = h["fig_pos"]
    val = [int(f) for f in val_idx]

    def map_validation():
        evaluate_retrieval_map(model, td.x_figures, val, fig_pos,
                               h["num_patents"])

    t0 = time.perf_counter()
    map_validation()
    t_map = time.perf_counter() - t0
    mrows = launch_times(torch, map_validation, iters=1)
    names = {"pairwise": "row 17", "mobius_dense": "row 18"}
    own = {v: sum(t * n for k, t, n in mrows if key in k)
           for key, v in names.items()}
    mbusy = sum(t * n for _k, t, n in mrows)
    print(f"[time] train_hyp map validation over {len(val)} figures x "
          f"{h['num_patents']} patents: {t_map:.2f} s wall, device "
          f"{mbusy:.1f} ms busy, of it row 17 {own['row 17']:.2f} ms and "
          f"row 18 {own['row 18']:.2f} ms; rows 17 + 18 are "
          f"{100 * (own['row 17'] + own['row 18']) / (t_map * 1e3 + ms):.3f}%"
          f" of a graphed epoch with map validation ({t_map + ms / 1e3:.2f} "
          f"s) "
          f"{label}")
    check(own["row 17"] > 0 and own["row 18"] > 0,
          "the map validation's trace shows no row 17 or 18 launch")
    print(f"[time] (train_hyp's times took {time.perf_counter() - t_all:.1f}"
          " s)")


# ---- the one-dispatch loops as CUDA graphs (utils/graphs.py): JAX's
# jitted lax.scan epochs and megabatch encoders
# ---- 6. the wide towers

# CLIP ViT-L/14 @336 (openai/clip-vit-large-patch14-336's vision tower,
# quick_gelu as the repo's) and the repo's quick_gelu tower at OpenCLIP
# ViT-H/14's widths (laion/CLIP-ViT-H-14-laion2B-s32B-b79K, whose own
# tower uses exact GELU): VisionConfig's fields, full depth
WIDE_TOWERS = {
    "ViT-L/14 @336": dict(image_size=336, patch_size=14, hidden_dim=1024,
                          num_layers=24, num_heads=16, mlp_dim=4096,
                          projection_dim=768),
    "ViT-H/14 widths @224": dict(image_size=224, patch_size=14,
                                 hidden_dim=1280, num_layers=32,
                                 num_heads=16, mlp_dim=5120,
                                 projection_dim=1024)}
# the kernels line's tile entries: (name, tower, head width)
WIDE_TILES = (("flash_tile_hd64_streamed", "ViT-L/14 @336", 64),
              ("flash_tile_hd80", "ViT-H/14 widths @224", 80))
# the instance widths timed alone (72 and 88 on the 80 and 96 instances)
TILE_TIMED_WIDTHS = (48, 64, 72, 80, 88, 96, 112, 128)
WIDE_BATCH = 32


def tile_bound(b, s, heads, hd) -> tuple[float, str]:
    """bound() of the tile on q, k, v [B, S, H, hd] bf16: each read once
    and o written once; q kᵀ and p v, 2 operations a multiply-add."""
    return bound(4 * 2 * b * s * heads * hd,
                 {"bf16": 4 * b * heads * s * s * hd})


def time_tile(torch, fa, b, s, heads, hd, gen, dev) -> dict:
    """Row 14 (the tile on every query row) on q, k, v [B, S, H, hd],
    slices of one qkv tensor: its max |error| against the plain version,
    (plain ms, kernel ms) in turns, F.scaled_dot_product_attention's ms
    on contiguous [B, H, S, hd] copies (the transposes not timed) and the
    bound."""
    qkv = torch.randn(b, s, 3 * heads * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = (t.unflatten(-1, (heads, hd))
               for t in qkv.split(heads * hd, dim=-1))
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(rel_err(got, want) <= FLASH_REL_TOL,
              f"the tile at [{b}, {s}, {heads}, {hd}] disagrees with plain")
        times = in_turns(torch, lambda: fa.flash_attention_plain(q, k, v),
                         lambda: fa.flash_attention(q, k, v), iters=10)
        sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = cuda_ms(torch, lambda: torch.nn.functional.
                       scaled_dot_product_attention(sq, sk, sv), iters=10)
    return {"err": err, "times": times, "sdpa": sdpa,
            "bound": tile_bound(b, s, heads, hd)}


def wide_towers_phase(torch, dev, run_path, launches: dict, errs: dict,
                      times: dict, bounds: dict, library: dict,
                      label: str) -> None:
    """Phase 6 (see the module docstring): the serving towers at ViT-L/14
    @336 and ViT-H/14's widths on the tile's instances."""
    from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
    from patent_tpu_torch.models.vit_int8 import Int8VisionTransformer
    from patent_tpu_torch.ops import bf16_layer, common
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.ops import quant_matmul as qm

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    bt = WIDE_BATCH
    counters = {"bf16": (bf16_layer.fused_layer_block_bf16,
                         bf16_layer.fused_layer_cls_bf16),
                "int8": (qm.quant_attention_block, qm.quant_attention_cls,
                         qm.quant_mlp_block),
                "int8 B3": (qm.quant_layer_block, qm.quant_attention_cls,
                            qm.quant_mlp_block),
                "use_flash": (fa.flash_attention,),
                "fused_block": (fa.fused_attention_fwd,)}
    tile_launches = {}
    for tname, fields in WIDE_TOWERS.items():
        cfg = VisionConfig(**fields)
        hd = cfg.hidden_dim // cfg.num_heads
        tower = VisionTransformer(cfg, device=dev, generator=gen)
        with torch.no_grad():     # init leaves them 0 and 1: make each matter
            for prm in tower.parameters():
                if prm.dim() == 1:
                    prm.add_(0.05 * torch.randn(prm.shape, generator=gen,
                                                device=dev))
        tower.eval()
        tower8 = Int8VisionTransformer.from_float(tower).eval()
        models = {"bf16": tower, "int8": tower8}
        if tname == "ViT-L/14 @336":
            for mode in ("use_flash", "fused_block"):
                m = VisionTransformer(cfg, fused_layer=False, device=dev,
                                      **{mode: True})
                m.load_state_dict(tower.state_dict())
                models[mode] = m.eval()
        px = torch.randn(bt, cfg.image_size, cfg.image_size, 3,
                         generator=gen, device=dev)
        feats = {}

        def run(name, model, pix, key):
            def go():
                with torch.inference_mode():
                    feats[key] = model(pix)
            run_path(f"{tname} {name} tower, B {pix.shape[0]}",
                     counters[name if pix.shape[0] == bt or name == "bf16"
                              else name + " B3"], go)

        common.TILE_LAUNCHES.clear()
        for name, model in models.items():
            run(name, model, px, name)
        run("int8", tower8, px[:3], "int8 B3")
        tile_launches[tname] = dict(common.TILE_LAUNCHES)
        with torch.inference_mode():
            for key, model in list(models.items()) + [("int8 B3", tower8)]:
                model.kernels = False
                feats[key + " plain"] = model(px[:3] if key == "int8 B3"
                                              else px)
                model.kernels = True
        torch.cuda.synchronize()
        for key in ("bf16", "int8", "int8 B3", "use_flash", "fused_block"):
            if key not in feats:
                continue
            got, ref = feats[key], feats[key + " plain"]
            cos, rel = min_row_cosine(torch, got, ref), rel_err(got, ref)
            int8 = key.startswith("int8")
            print(f"[kernel] {tname} {key} tower, kernels vs plain layers: "
                  f"feature rel err {rel:.3g}, min cosine {cos:.6f}")
            check(got.shape == (ref.shape[0], cfg.projection_dim)
                  and bool(torch.isfinite(got).all())
                  and rel <= (INT8_TOWER_REL_TOL if int8 else TOWER_REL_TOL)
                  and cos >= (INT8_TOWER_MIN_COS if int8
                              else TOWER_MIN_COS),
                  f"the {tname} {key} tower disagrees with its plain layers")
        cos_i8 = min_row_cosine(torch, feats["int8"], feats["bf16"])
        print(f"[kernel] {tname} int8 tower vs bf16 tower (kernels): min "
              f"feature cosine {cos_i8:.6f}, rel err "
              f"{rel_err(feats['int8'], feats['bf16']):.3g}")
        check(cos_i8 >= INT8_VS_BF16_MIN_COS,
              f"the {tname} int8 tower is far from the bf16 tower")
        # one int8 layer at B 3 through the cooperative launch, forced (the
        # plan takes the chain at these widths: MLP in's tiles pass one
        # wave), against the chain in bits
        with torch.inference_mode():
            x3, seq = tower8.embed(px[:3])
        layer = tower8.blocks[0]
        plan = qm.layer_plan(3 * x3.shape[1], cfg.hidden_dim, cfg.mlp_dim,
                             qm.layer_grid())
        outs = {}
        with torch.inference_mode():
            for coop in (True, False):
                with mock.patch.object(qm, "layer_plan", lambda *a, c=coop: (
                        qm.LayerPlan(True, 1, 2) if c
                        else qm.LayerPlan(False, 1, 1))):
                    outs[coop] = qm.quant_layer_block(
                        x3, *layer.attn_weights(), *layer.mlp_weights(),
                        cfg.num_heads, valid_len=seq, folded=layer.folded())
        torch.cuda.synchronize()
        print(f"[kernel] {tname} int8 layer, B 3: the plan takes "
              f"{'the cooperative launch' if plan.coop else 'the chain'}; "
              f"the cooperative launch forced equals the chain in bits: "
              f"{torch.equal(outs[True], outs[False])}")
        check(torch.equal(outs[True], outs[False]),
              f"{tname}: row 8's cooperative launch differs from the chain")

        # times
        def tower_ms(model, pix):
            def go():
                with torch.inference_mode():
                    model(pix)
            return cuda_ms(torch, go, warmup=2, iters=5)

        for key, model in models.items():
            ms = tower_ms(model, px)
            print(f"[time] {tname} {key} tower, batch {bt}: "
                  f"{bt / ms * 1e3:.1f} img/s ({ms:.2f} ms) {label}")
        for key, model in (("bf16", tower), ("int8", tower8)):
            ms = tower_ms(model, px[:3])
            print(f"[time] {tname} {key} tower, batch 3: {ms:.2f} ms "
                  f"({3 / ms * 1e3:.1f} img/s) {label}")
        del models, tower, tower8, feats, outs, x3, px
        torch.cuda.empty_cache()

    print(f"[slice] wide towers' tile launches by instance width: "
          f"{tile_launches}")
    for kname, tname, hd in WIDE_TILES:
        n = tile_launches[tname].get(hd, 0)
        check(n > 0, f"the tile's {hd} instance never ran in the {tname} "
                     "towers")
        launches[kname] = n
        cfg = VisionConfig(**WIDE_TOWERS[tname])
        seq = cfg.num_patches + 1
        r = time_tile(torch, fa, bt, seq, cfg.num_heads, hd, gen, dev)
        errs[kname], times[kname] = r["err"], r["times"]
        bounds[kname], library[kname] = r["bound"], r["sdpa"]
        print(f"[time] {kname} at [{bt}, {seq}, {cfg.num_heads}, {hd}] "
              f"({tname}): kernel {r['times'][1]:.3f} ms, plain "
              f"{r['times'][0]:.3f} ms, F.scaled_dot_product_attention "
              f"{r['sdpa']:.3f} ms (kernel / SDPA "
              f"{r['times'][1] / r['sdpa']:.2f}), bound "
              f"{r['bound'][0]:.3f} ms ({r['bound'][1]}) {label}")
        if kname == "flash_tile_hd64_streamed":
            # per image at a batch whose K and V (9.7 MB) fit the 50 MB L2
            # against the batch of 32 (77.6 MB), which does not
            small = time_tile(torch, fa, 4, seq, cfg.num_heads, hd, gen, dev)
            per = [t["times"][1] / n for t, n in ((small, 4), (r, bt))]
            print(f"[time] {kname} per image at [B, {seq}, "
                  f"{cfg.num_heads}, {hd}]: B 4 {per[0]:.5f} ms, B {bt} "
                  f"{per[1]:.5f} ms, ratio B {bt} / B 4 "
                  f"{per[1] / per[0]:.3f}; SDPA B 4 "
                  f"{small['sdpa'] / 4:.5f}, B {bt} {r['sdpa'] / bt:.5f} "
                  f"{label}")
    for hd in TILE_TIMED_WIDTHS:
        heads = 1024 // hd if 1024 % hd == 0 else 16
        r = time_tile(torch, fa, bt, 257, heads, hd, gen, dev)
        print(f"[time] tile instance {common.tile_width(hd)} at head width "
              f"{hd}, [{bt}, 257, {heads}, {hd}]: kernel "
              f"{r['times'][1]:.3f} ms, plain {r['times'][0]:.3f} ms, "
              f"F.scaled_dot_product_attention {r['sdpa']:.3f} ms, bound "
              f"{r['bound'][0]:.3f} ms ({r['bound'][1]}), max |err| "
              f"{r['err']:.3g} {label}")
    print(f"[slice] wide towers phase: {time.perf_counter() - t_phase:.1f} s")


# ---- 6b. the wide trainers: rows 13 and 14′ at the attention kernels'
# one contract, the fine-tune and train_end at both wide towers

# pairs of each kernels-against-plain-blocks step check at the wide towers
# (the plain attention keeps [B·H, S, S] f32 scores: 1.4 GB a tensor at 32
# images of ViT-L/14 @336), and of the trainers' own steps
# (ClipFinetuneConfig's and EndToEndConfig's defaults)
WIDE_CHECK_PAIRS = 16
WIDE_TRAIN_PAIRS = {"fine-tune": 64, "train_end": 32}
# the kernels line's entries of rows 13 and 14′ at the wide towers' main
# path: (name, tower, instance key)
WIDE_BWD_ENTRIES = (
    ("fused_attention_bwd_hd64_streamed", "ViT-L/14 @336", "hd64_streamed"),
    ("fused_attention_bwd_hd80_streamed", "ViT-H/14 widths @224",
     "hd80_streamed"))
WIDE_F32_ENTRY = ("flash_attention_f32_hd80", "ViT-H/14 widths @224", "hd80")
# the f32 use_flash tower's batch (JAX's VisionTransformer defaults to f32)
WIDE_F32_BATCH = 8
# the head widths at which rows 13 and 14′ are checked and timed alone (8,
# 72, 88 and 120 on the 16, 80, 96 and 128 instances); the streamed row
# 13 is last, for the check that two runs give the same bits
BWD_WIDTHS = (8, 16, 32, 48, 64, 72, 80, 88, 96, 112, 120, 128)


def fitting_pairs(torch, pairs: int, what: str, run):
    """run(pairs) at the largest power of two of pairs, from ``pairs`` down,
    whose step fits the card's memory; says so where it cuts.  Returns
    (pairs, run's result)."""
    while True:
        try:
            return pairs, run(pairs)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            check(pairs > 1, f"{what}: one pair does not fit the card")
            gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
            print(f"[slice] {what}: {pairs} pairs do not fit the card's "
                  f"memory ({gib:.0f} GiB); cut to {pairs // 2}")
            pairs //= 2


def sdpa_backward_ms(torch, b, s, heads, hd, gen, dev) -> float:
    """A yardstick, not the same function (a max-subtracted softmax, no
    clamp, no recompute of qkv): the backward of
    F.scaled_dot_product_attention on q, k, v [B, H, S, hd] bf16, ms a
    call (CUDA events)."""
    q, k, v = (torch.randn(b, heads, s, hd, generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    dout = torch.randn_like(out)
    return cuda_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), dout, retain_graph=True), iters=10)


def trainer_times(torch, run_path, kind, tname, pairs, one_step,
                  label: str) -> dict:
    """One step of a trainer through run_path (the main path), then a few
    timed: ms/step and img/s (CUDA events), busy share, rows 12, 13, 15
    and 16's share and launches a step (torch.profiler) and peak memory.
    Returns row 13's launches by instance in that one step."""
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa

    fa.fused_attention_bwd.instances.clear()
    run_path(f"{kind} step, {tname}, {pairs} pairs",
             (fa.fused_attention_fwd, fa.fused_attention_bwd,
              mm.fused_mlp_fwd, mm.fused_mlp_bwd), one_step)
    instances = dict(fa.fused_attention_bwd.instances)
    ms = cuda_ms(torch, one_step, warmup=1, iters=3)
    rows = launch_times(torch, one_step, iters=2)
    busy = sum(t * n for _k, t, n in rows) / 2
    ours = sum(t * n for k, t, n in rows if TRAIN_KERNELS_RE.search(k)) / 2
    n_img = 2 * pairs
    print(f"[time] {kind} step, {tname}, {pairs} pairs ({n_img} images, "
          f"last 9 blocks trained): {ms:.2f} ms/step, "
          f"{n_img / ms * 1e3:.1f} img/s forward + backward; busy "
          f"{busy:.2f} ms ({100 * busy / ms:.1f}%), rows 12, 13, 15 and 16's "
          f"kernels {ours:.2f} ms ({100 * ours / ms:.1f}%), "
          f"{sum(n for _k, _t, n in rows) / 2:.0f} launches a step; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
          f"{label}")
    return instances


def wide_finetune(torch, dev, run_path, vcfg, tname, gen, label) -> dict:
    """The fine-tune at ``vcfg`` from one seeded init: a step with the
    kernels against one with the plain blocks from the same weights (the
    state restored, AdamW's moments cleared), at WIDE_CHECK_PAIRS:
    check_train_step's gates (phase 3's ViT-B/16 check at this tower);
    then, from the same weights again, the main path at
    ClipFinetuneConfig's 64 pairs (cut to the largest power of two that
    fits, where it must) through trainer_times.  Returns row 13's
    launches by instance in the main path's step."""
    import numpy as np

    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.retrieval.engine import device_normalize
    from patent_tpu_torch.train.finetune_clip import (init_finetune_state,
                                                      make_finetune_step)
    from patent_tpu_torch.utils.config import ClipFinetuneConfig

    cfg = ClipFinetuneConfig()
    table = np.random.default_rng(0).standard_normal((192, 128)).astype(
        np.float32)
    model, opt = init_finetune_state(vcfg, cfg, table, seed=0, device=dev)
    step, eval_step = make_finetune_step(model, opt)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restart(kernels):
        model.load_state_dict(start)
        opt.state.clear()
        model.vit.kernels = kernels

    def batch(pairs):
        px = vcfg.image_size
        return (torch.randint(0, 256, (2 * pairs, px, px, 3), generator=gen,
                              device=dev, dtype=torch.uint8),
                torch.randint(0, 192, (pairs,), generator=gen, device=dev))

    pairs = WIDE_CHECK_PAIRS
    images, nodes = batch(pairs)
    cot = torch.randn(2 * pairs, vcfg.projection_dim, generator=gen,
                      device=dev)
    x = device_normalize(images)
    noisy = x + 1e-3 * torch.randn(x.shape, generator=gen, device=dev)

    def tower_grads(pix):
        model.vit.zero_grad(set_to_none=True)
        model.vit(pix).backward(cot)
        return {k: t.grad.clone() for k, t in model.vit.named_parameters()
                if t.grad is not None}

    runs = []
    for kernels in (True, False):
        restart(kernels)
        tower = tower_grads(x)
        if not kernels:
            yardstick = grad_gaps(tower_grads(noisy), tower)
            clean, shaken = ({k: float(v) for k, v in eval_step(
                pix, nodes, cfg.alpha_max).items()} for pix in (x, noisy))
            metric_yardstick = {k: abs(shaken[k] - v) / abs(v)
                                for k, v in clean.items()}
        kept, metrics = {}, {}

        def keep_dz(_module, _inputs, out):
            out.register_hook(lambda g: kept.update(dz=g.clone()))

        def go():
            metrics.update(step(images, nodes, cfg.alpha_max))

        hook = model.vit.register_forward_hook(keep_dz)
        if kernels:
            run_path(f"fine-tune step, {tname}, {pairs} pairs",
                     (fa.fused_attention_fwd, fa.fused_attention_bwd,
                      mm.fused_mlp_fwd, mm.fused_mlp_bwd), go, False)
        else:
            go()
        hook.remove()
        runs.append(({k: float(v) for k, v in metrics.items()}, tower,
                     {k: t.grad.clone() for k, t in model.named_parameters()
                      if t.grad is not None}, kept["dz"]))
    check_train_step(torch, *zip(*runs), yardstick,
                     what=f"fine-tune step, {tname}",
                     metric_yardstick=metric_yardstick)
    del runs, x, noisy, images, nodes, cot, tower

    def main_path(n_pairs):
        restart(True)
        torch.cuda.reset_peak_memory_stats()
        imgs, idx = batch(n_pairs)
        return trainer_times(torch, run_path, "fine-tune", tname, n_pairs,
                             lambda: step(imgs, idx, cfg.alpha_max), label)

    return fitting_pairs(torch, WIDE_TRAIN_PAIRS["fine-tune"],
                         f"the fine-tune at {tname}", main_path)[1]


def wide_train_end(torch, dev, run_path, vcfg, tname, e2e, gen,
                   label) -> dict:
    """train_end at ``vcfg``: end_to_end_step_check at WIDE_CHECK_PAIRS
    (a step with the kernels against one with the plain blocks), then the
    main path at EndToEndConfig's 32 pairs (cut to the largest power of
    two that fits, where it must) through trainer_times.  Returns row 13's
    launches by instance in the main path's step."""
    from patent_tpu_torch.train import train_end as te
    from patent_tpu_torch.utils.config import EndToEndConfig

    px, n = vcfg.image_size, 2 * WIDE_CHECK_PAIRS
    images = torch.randn(n, px, px, 3, generator=gen, device=dev)
    e_w = {"cfg": EndToEndConfig(batch_size=WIDE_CHECK_PAIRS),
           "label_num": e2e["label_num"], "images": images,
           "pos": e2e["pos"][:WIDE_CHECK_PAIRS],
           "neg": e2e["neg"][:WIDE_CHECK_PAIRS], "impl": e2e["impl"],
           "cot": torch.randn(n, vcfg.projection_dim, generator=gen,
                              device=dev),
           "noisy": images + 1e-3 * torch.randn(images.shape, generator=gen,
                                                device=dev)}
    end_to_end_step_check(torch, dev, run_path, e_w, vcfg, tname,
                          record=False)
    del e_w, images
    torch.cuda.empty_cache()

    def main_path(pairs):
        torch.cuda.reset_peak_memory_stats()
        cfg = EndToEndConfig(batch_size=pairs)
        model, opt = te.init_end_to_end(vcfg, cfg, e2e["label_num"], seed=0,
                                        device=dev)
        step, _loss = te.make_end_to_end_step(model, opt, cfg)
        imgs = torch.randn(2 * pairs, px, px, 3, generator=gen, device=dev)
        pos, neg = e2e["pos"][:pairs], e2e["neg"][:pairs]
        dgen = torch.Generator(device=dev).manual_seed(3)
        return trainer_times(torch, run_path, "train_end", tname, pairs,
                             lambda: step(imgs, pos, neg, e2e["impl"], dgen),
                             label)

    return fitting_pairs(torch, WIDE_TRAIN_PAIRS["train_end"],
                         f"train_end at {tname}", main_path)[1]


def wide_trainers_phase(torch, dev, run_path, launches: dict, errs: dict,
                        times: dict, bounds: dict, library: dict, e2e: dict,
                        label: str) -> None:
    """Phase 6b (see the module docstring): rows 13 and 14′ at every
    instance width and path against their plain versions, then at each
    wide tower rows 12, 13, 15 and 16 at its fine-tune shapes, one
    fine-tune and one train_end step against plain blocks, the f32
    use_flash tower at ViT-H/14's widths, the trainers timed, and rows 13
    and 14′ timed by instance."""
    from patent_tpu_torch.models.vit import VisionConfig, VisionTransformer
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.ops.common import round_up

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(22)
    # rows 13 and 14′ alone at every instance width: row 13 at S 208 on the
    # path that takes it, and where that is the resident kernel also at the
    # first S at which it streams
    for hd in BWD_WIDTHS:
        d = 2 * hd
        p = layer_params(torch, d, d, gen, dev)
        shapes = [(4, 208, 197)]
        if not fa.attention_bwd_plan(208, hd)[0]:
            sl = first_streamed_s(hd)
            shapes.append((2, sl, sl - 6))
        for b, s, valid in shapes:
            x = layer_input(torch, b, s, d, valid, gen, dev)
            e12, _e13 = check_train_attention(torch, fa, x, p, 2, valid, gen)
            errs["fused_attention_fwd"] = max(errs["fused_attention_fwd"],
                                              e12)
        check_flash_f32(torch, fa, 4, 257, 2, gen, dev, hd=hd)
    # two runs of the streamed path give the same bits
    check(fa.attention_bwd_plan(x.shape[1], hd)[0],
          f"row 13 does not stream at head width {hd}, S {x.shape[1]}")
    wq, bq = fold_q(torch, p[2], p[3], d, 2)
    da = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    runs = [fa.fused_attention_bwd(x, wq, bq, da, 2, 197)
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "row 13's streamed path differs between two runs")
    del p, x, wq, bq, da, runs

    t_alone = time.perf_counter()
    print(f"[slice] rows 13 and 14′ alone at every instance width in "
          f"{t_alone - t_phase:.1f} s")
    instances = {}
    for tname, fields in WIDE_TOWERS.items():
        t_tower = time.perf_counter()
        vcfg = VisionConfig(**fields)
        d, heads, f = vcfg.hidden_dim, vcfg.num_heads, vcfg.mlp_dim
        hd, seq = d // heads, vcfg.num_patches + 1
        sp = round_up(seq, 16)
        # rows 12 and 13 at the tower's fine-tune stream (16 images), also
        # with scores past the clamp; rows 15 and 16 on a fine-tune step's
        # unpadded rows (64 pairs)
        p = layer_params(torch, d, f, gen, dev)
        x = layer_input(torch, WIDE_CHECK_PAIRS, sp, d, seq, gen, dev)
        e12, e13 = check_train_attention(torch, fa, x, p, heads, seq, gen)
        errs["fused_attention_fwd"] = max(errs["fused_attention_fwd"], e12)
        _e, e13s = check_train_attention(torch, fa, x, p, heads, seq, gen,
                                         saturate=True)
        for kname, tn, _key in WIDE_BWD_ENTRIES:
            if tn == tname:
                errs[kname] = max(e13, e13s)
        x2 = layer_input(torch, 2 * WIDE_TRAIN_PAIRS["fine-tune"], seq, d,
                         seq, gen, dev).reshape(-1, d)
        e15, e16 = check_train_mlp(torch, mm, x2, p, gen)
        errs["fused_mlp_fwd"] = max(errs["fused_mlp_fwd"], e15)
        errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], e16)
        del p, x, x2
        torch.cuda.empty_cache()
        t_check = time.perf_counter()
        print(f"[slice] {tname}: rows 12, 13, 15 and 16 at its fine-tune "
              f"shapes in {t_check - t_tower:.1f} s")
        # each trainer: one step with the kernels against plain blocks,
        # then the main path timed
        for run in (wide_finetune, wide_train_end):
            args = (e2e,) if run is wide_train_end else ()
            for key, n in run(torch, dev, run_path, vcfg, tname, *args, gen,
                              label).items():
                instances[key] = instances.get(key, 0) + n
            torch.cuda.empty_cache()
        t_train = time.perf_counter()
        print(f"[slice] {tname}: the trainers' checks and times in "
              f"{t_train - t_check:.1f} s")
        # row 13 alone at the fine-tune's stream of 64 pairs
        b = 2 * WIDE_TRAIN_PAIRS["fine-tune"]
        p = layer_params(torch, d, f, gen, dev)
        wq, bq = fold_q(torch, p[2], p[3], d, heads)
        xb = layer_input(torch, b, sp, d, seq, gen, dev)
        da = torch.randn(b, sp, d, generator=gen, device=dev)
        da[:, seq:] = 0.0
        da = da.to(torch.bfloat16)
        args = (xb, wq, bq, da, heads, seq)
        tm = in_turns(torch, lambda: fa.attention_bwd_plain(*args),
                      lambda: fa.fused_attention_bwd(*args), iters=3)
        bnd = train_bounds(b, sp, seq, d, f)["fused_attention_bwd"]
        sdpa = sdpa_backward_ms(torch, b, sp, heads, hd, gen, dev)
        path = ("streamed" if fa.attention_bwd_plan(sp, hd)[0]
                else "resident")
        print(f"[time] fused_attention_bwd ({path}) at [{b}, {sp}, {d}], "
              f"{heads} x {hd} heads, {seq} valid ({tname}, the fine-tune's "
              f"64 pairs): kernel {tm[1]:.3f} ms, plain {tm[0]:.3f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}); yardstick, not the same function:"
              f" the backward of F.scaled_dot_product_attention on [{b}, "
              f"{heads}, {sp}, {hd}] {sdpa:.3f} ms {label}")
        for kname, tn, _key in WIDE_BWD_ENTRIES:
            if tn == tname:
                times[kname], bounds[kname] = tm, bnd
                library[kname] = None
        del p, wq, bq, xb, da, args
        torch.cuda.empty_cache()

    t_f32 = time.perf_counter()
    # the f32 use_flash tower at ViT-H/14's widths (row 14′ at head width
    # 80 in every layer) against its plain layers
    kname, tname, key = WIDE_F32_ENTRY
    vcfg = VisionConfig(**WIDE_TOWERS[tname])
    tower = VisionTransformer(vcfg, dtype=torch.float32, fused_layer=False,
                              use_flash=True, device=dev, generator=gen)
    tower.eval()
    bt = WIDE_F32_BATCH
    px = torch.randn(bt, vcfg.image_size, vcfg.image_size, 3, generator=gen,
                     device=dev)
    feats = {}

    def f32_tower():
        with torch.inference_mode():
            feats["kernels"] = tower(px)

    fa.flash_attention_f32.instances.clear()
    run_path(f"{tname} f32 use_flash tower, B {bt}", (fa.flash_attention_f32,),
             f32_tower)
    launches[kname] = fa.flash_attention_f32.instances.get(key, 0)
    check(launches[kname] == vcfg.num_layers,
          f"row 14′'s {key} instance ran {launches[kname]} times in the "
          f"{vcfg.num_layers}-layer f32 tower")
    tower.kernels = False
    with torch.inference_mode():
        feats["plain"] = tower(px)
    tower.kernels = True
    got, ref = feats["kernels"], feats["plain"]
    print(f"[kernel] {tname} f32 use_flash tower, kernels vs plain layers: "
          f"feature rel err {rel_err(got, ref):.3g}, min cosine "
          f"{min_row_cosine(torch, got, ref):.7f}")
    check(got.shape == (bt, vcfg.projection_dim)
          and bool(torch.isfinite(got).all())
          and rel_err(got, ref) <= FLASH_F32_REL_TOL * 10,
          f"the {tname} f32 use_flash tower disagrees with its plain layers")
    ms = cuda_ms(torch, f32_tower, warmup=1, iters=3)
    print(f"[time] {tname} f32 use_flash tower, batch {bt}: "
          f"{bt / ms * 1e3:.1f} img/s ({ms:.1f} ms) {label}")
    del tower, feats, got, ref
    # row 14′ at that tower's attention shapes
    heads, hd, seq = vcfg.num_heads, vcfg.hidden_dim // vcfg.num_heads, \
        vcfg.num_patches + 1
    d = heads * hd
    qkv = torch.randn(bt, seq, 3 * d, generator=gen, device=dev)
    q, k, v = (t.unflatten(-1, (heads, hd)) for t in qkv.split(d, dim=-1))
    errs[kname] = float((fa.flash_attention(q, k, v)
                         - fa.flash_attention_plain(q, k, v)).abs().max())
    times[kname] = in_turns(torch, lambda: fa.flash_attention_plain(q, k, v),
                            lambda: fa.flash_attention(q, k, v), iters=5)
    sq, sk_, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library[kname] = cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk_, sv))
    bounds[kname] = bound(4 * 4 * bt * seq * d,
                          {"fp32": 4 * bt * seq * seq * d})
    print(f"[time] {kname} at [{bt}, {seq}, {heads}, {hd}] ({tname}): "
          f"kernel {times[kname][1]:.3f} ms, plain {times[kname][0]:.3f} ms, "
          f"F.scaled_dot_product_attention f32 {library[kname]:.3f} ms, "
          f"bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}) {label}")
    del qkv, q, k, v, sq, sk_, sv

    print(f"[slice] wide trainers' row 13 launches by instance and path: "
          f"{instances}")
    for kname, tname, key in WIDE_BWD_ENTRIES:
        check(instances.get(key, 0) > 0, f"row 13's {key} instance never ran "
              f"in the {tname} trainers")
        launches[kname] = instances[key]

    t_widths = time.perf_counter()
    print(f"[slice] the f32 use_flash tower and row 14′ at its shapes in "
          f"{t_widths - t_f32:.1f} s")
    # rows 13 and 14′ by instance width, row 13 on the path each shape
    # takes: 32 images of 208 rows and, at the resident instances, about as
    # many rows at the first S at which it streams
    for hd in BWD_WIDTHS:
        heads = 1024 // hd if 1024 % hd == 0 else 16
        d = heads * hd
        p = layer_params(torch, d, d, gen, dev)
        wq, bq = fold_q(torch, p[2], p[3], d, heads)
        shapes = [(32, 208, 197)]
        if hd % 16 == 0 and not fa.attention_bwd_plan(208, hd)[0]:
            sl = first_streamed_s(hd)
            shapes.append((max(1, 32 * 208 // sl), sl, sl - 6))
        for b, s, valid in shapes:
            xb = layer_input(torch, b, s, d, valid, gen, dev)
            da = torch.randn(b, s, d, generator=gen, device=dev)
            da[:, valid:] = 0.0
            da = da.to(torch.bfloat16)
            bnd = train_bounds(b, s, valid, d, d)["fused_attention_bwd"]
            plain = cuda_ms(torch, lambda: fa.attention_bwd_plain(
                xb, wq, bq, da, heads, valid), iters=5)
            kms = cuda_ms(torch, lambda: fa.fused_attention_bwd(
                xb, wq, bq, da, heads, valid), iters=10)
            path = ("streamed" if fa.attention_bwd_plan(s, hd)[0]
                    else "resident")
            print(f"[time] fused_attention_bwd instance {-(-hd // 16) * 16}"
                  f" ({path}) at head width {hd}, [{b}, {s}, {heads} x {hd}],"
                  f" {valid} valid: kernel {kms:.3f} ms, plain {plain:.3f} "
                  f"ms, bound {bnd[0]:.3f} ms ({bnd[1]}) {label}")
            del xb, da
        qkv = torch.randn(32, 257, 3 * d, generator=gen, device=dev)
        q, k, v = (t.unflatten(-1, (heads, hd))
                   for t in qkv.split(d, dim=-1))
        ftm = in_turns(torch, lambda: fa.flash_attention_plain(q, k, v),
                       lambda: fa.flash_attention(q, k, v), iters=5)
        sq, sk_, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = cuda_ms(torch, lambda: torch.nn.functional.
                       scaled_dot_product_attention(sq, sk_, sv), iters=10)
        fb = bound(4 * 4 * 32 * 257 * d, {"fp32": 4 * 32 * 257 * 257 * d})
        print(f"[time] flash_attention_f32 instance {-(-hd // 16) * 16} at "
              f"head width {hd}, [32, 257, {heads}, {hd}]: kernel "
              f"{ftm[1]:.3f} ms, plain {ftm[0]:.3f} ms, "
              f"F.scaled_dot_product_attention f32 {sdpa:.3f} ms, bound "
              f"{fb[0]:.3f} ms ({fb[1]}) {label}")
        del p, wq, bq, qkv, q, k, v, sq, sk_, sv
    print(f"[slice] rows 13 and 14′ timed by instance in "
          f"{time.perf_counter() - t_widths:.1f} s; wide trainers phase: "
          f"{time.perf_counter() - t_phase:.1f} s")


SCAN_DIR = os.path.join(ROOT, "build", "chip_smoke_scan")
# the scan encoder's stack and batch; 168 patents x 4 figures = 672
# images, 6 batches of 128: one full stack of 4 and a tail of 2 batches
SCAN_K, SCAN_B, SCAN_PATENTS = 4, 128, 168
# train_hyp's profiled steps (phase 5)
PROFILE_STEPS = 20
HOST_LAUNCH_RE = re.compile(r"^cu(da)?(Graph)?Launch|LaunchKernel|"
                            r"LaunchCooperativeKernel")


def host_launch_calls(torch, fn) -> int:
    """The launch calls the host makes in one call of ``fn``
    (torch.profiler's runtime events: a kernel launch each, a graph's
    replay one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if HOST_LAUNCH_RE.search(e.key))


def state_equal(a: dict, b: dict) -> bool:
    import torch

    return set(a) == set(b) and all(bool(torch.equal(a[k], b[k]))
                                    for k in a)


def same_result(got, want) -> bool:
    """A trainer's returns equal: state dicts in bits, the rest by ==."""
    import torch

    if isinstance(got, dict) and got and all(isinstance(v, torch.Tensor)
                                             for v in got.values()):
        return state_equal(got, want)
    if hasattr(got, "test_edges"):       # an edge split: the host's
        return True
    return got == want


def graph_loops_slice(torch, dev, h: dict, run_path, tower, tower8) -> None:
    """Each one-dispatch loop as a CUDA graph against its eager loop, in
    bits: train_hyp's training and validation epochs at HypTrainConfig's
    defaults over the 2018-scale table (dropout on; row 18 captured in the
    validation epoch), train_hyp_con at its defaults on the same data,
    train_hmi, train_pair_classification (the sparse adjacency's segment
    sums) and train_vgae (dense and sampled) on small graphs, and the scan
    encoder through RetrievalEngine(scan_batches=4) at ViT-B/16, B 128
    over a gallery whose last stack is 2 batches (rows 1-2; rows 5 + 7),
    beside the per-batch engine, then the int8 tower's scan at B 3 (row
    8's cooperative launch captured)."""
    import numpy as np
    import scipy.sparse as sp

    from patent_tpu_torch.data import hmi_inputs, synthetic
    from patent_tpu_torch.data.graph_build import build_hetero_graph
    from patent_tpu_torch.input.pipeline import list_images
    from patent_tpu_torch.ops import bf16_layer
    from patent_tpu_torch.ops import pallas_kernels as pk
    from patent_tpu_torch.ops import quant_matmul as qm
    from patent_tpu_torch.retrieval.engine import (
        RetrievalEngine, make_device_normalizing_encoder, make_scan_encoder)
    from patent_tpu_torch.train import (train_gcn, train_hmi, train_hyp_con,
                                        train_vgae)
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import (GCNTrainConfig,
                                               HypConTrainConfig,
                                               HypTrainConfig)
    from patent_tpu_torch.utils.logging import MetricsLogger

    t_phase = time.perf_counter()
    quiet = MetricsLogger(print_every=0)
    cfg = HypTrainConfig()
    td = h["td"]
    packed = th.PackedSupervision(td)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(packed.usable))
    n_train = int(len(packed.usable) * cfg.train_ratio)
    n_val = int(len(packed.usable) * cfg.val_ratio)
    train_slots = packed.slots_for(packed.usable[perm[:n_train]])
    val_slots = packed.slots_for(packed.usable[perm[n_train:n_train + n_val]])
    epochs = [th.stack_epoch_batches(packed, train_slots, cfg.batch_size,
                                     cfg.num_neg_samples, rng)]
    varr = th.stack_epoch_batches(packed, val_slots, cfg.batch_size,
                                  cfg.num_neg_samples, rng)
    data = (torch.as_tensor(td.x_figures, device=dev),
            torch.as_tensor(td.implication, dtype=torch.long,
                            device=dev).reshape(-1, 2),
            torch.as_tensor(td.exclusion, dtype=torch.long,
                            device=dev).reshape(-1, 2))
    out = {}
    for graphed in (False, True):
        def go(graphed=graphed):
            model = th.build_model(td, cfg, dev)
            opt = RiemannianAdam(dict(model.named_parameters()),
                                 cfg.learning_rate, c=cfg.curvature)
            train, evaluate = th.make_epoch_step(model, opt, cfg,
                                                 graphed=graphed)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            sums = [torch.stack(list(train(a, *data, gen).values()))
                    for a in epochs]
            val = torch.stack(list(evaluate(varr, *data).values()))
            out[graphed] = (sums, val, {k: v.clone() for k, v in
                                        model.state_dict().items()})

        run_path(f"train_hyp's make_epoch_step at HypTrainConfig's defaults, "
                 f"a training epoch of {len(epochs[0][0])} steps + a "
                 f"validation epoch of {len(varr[0])}, "
                 f"{'graphed' if graphed else 'eager'}",
                 (pk.mobius_dense_pallas,), go, record=graphed)
    (se, ve, pe), (sg, vg, pg) = out[False], out[True]
    same = (all(bool(torch.equal(a, b)) for a, b in zip(se, sg))
            and bool(torch.equal(ve, vg)) and state_equal(pe, pg))
    print(f"[slice] train_hyp graphed vs eager (dropout on; {td.num_labels} "
          f"labels): epoch sums {[s.tolist() for s in sg]}, validation "
          f"{vg.tolist()}; equal in bits: {same}")
    check(same, "train_hyp's graphed epochs differ from the eager ones")

    # the other trainers: train_hyp_con at its defaults on the same data,
    # the rest on small graphs (their 2018-scale epochs are timed in 5)
    recs = synthetic.synthetic_records(num_patents=10, figures_per_patent=3,
                                       seed=0)
    graph = build_hetero_graph(recs)
    inputs = hmi_inputs.generate_hmi_inputs(graph, seed=1)
    feats = np.random.default_rng(2).standard_normal(
        (graph.counts["figures"], 24)).astype(np.float32)
    grng = np.random.default_rng(3)
    a = sp.random(600, 600, density=0.01, random_state=grng, format="csr",
                  dtype=np.float32)
    a.data[:] = 1.0
    adj = sp.csr_matrix(((a + a.T) > 0).astype(np.float32))
    xg = grng.standard_normal((600, 16)).astype(np.float32)
    pairs = grng.integers(0, 600, (700, 2)).astype(np.int32)
    labels = grng.integers(0, 5, 700).astype(np.int32)
    trainers = {
        "train_hyp_con (HypConTrainConfig defaults, 1 epoch)":
            lambda g: train_hyp_con.train_hyperbolic_contrastive(
                td, HypConTrainConfig(epochs=1), logger=quiet, device=dev,
                graphed=g),
        "train_hmi (10 patents, 3 epochs)": lambda g: train_hmi.train_hmi(
            feats, inputs, graph.num_nodes - graph.counts["figures"],
            embed_dim=8, epochs=3, batch_size=64, logger=quiet, device=dev,
            graphed=g),
        "train_pair_classification (600 nodes, sparse, 2 epochs)":
            lambda g: train_gcn.train_pair_classification(
                xg, adj, pairs, labels, GCNTrainConfig(
                    hidden_dim=32, latent_dim=16, num_layers=4, epochs=2,
                    batch_size=128, adjacency="sparse"), logger=quiet,
                device=dev, graphed=g),
        "train_vgae dense (600 nodes, 7 epochs)":
            lambda g: train_vgae.train_vgae_link_prediction(
                xg, adj, hidden_dim=16, latent_dim=8, epochs=7,
                mode="dense", logger=quiet, device=dev, graphed=g),
        "train_vgae sampled (600 nodes, 7 epochs)":
            lambda g: train_vgae.train_vgae_link_prediction(
                xg, adj, hidden_dim=16, latent_dim=8, epochs=7,
                mode="sampled", logger=quiet, device=dev, graphed=g)}
    for what, run in trainers.items():
        t0 = time.perf_counter()
        eager = run(False)
        t1 = time.perf_counter()
        graphed = run(None)
        t2 = time.perf_counter()
        same = all(same_result(g, e) for g, e in zip(graphed, eager))
        print(f"[slice] {what}: graphed equals eager in bits: {same} "
              f"(eager {t1 - t0:.2f} s, graphed {t2 - t1:.2f} s with its "
              "warm-up and capture)")
        check(same, f"{what}: the graphed loop differs from the eager one")

    # the scan encoder through the engine: a full stack of 4 and a tail
    # of 2 batches padded to 4, graphed and eager, and the per-batch engine
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    _recs, images = synthetic.write_synthetic_corpus(
        SCAN_DIR, num_patents=SCAN_PATENTS, figures_per_patent=4,
        image_size=224)
    gallery = list_images(images)
    n_batches = -(-len(gallery) // SCAN_B)
    check(n_batches % SCAN_K == 2, f"{n_batches} batches do not leave a "
          f"tail of 2 batches in stacks of {SCAN_K}")
    for kind, model, kernels in (
            ("bf16", tower, (bf16_layer.fused_layer_block_bf16,
                             bf16_layer.fused_layer_cls_bf16)),
            ("int8", tower8, (qm.quant_attention_block,
                              qm.quant_attention_cls, qm.quant_mlp_block))):
        feats_by = {}

        def engine_run(key, model=model, feats_by=feats_by):
            one = make_device_normalizing_encoder(model, dev)
            many = (None if key == "per-batch" else make_scan_encoder(
                model, graphed=key == "graphed"))
            with RetrievalEngine(one, dev, batch_size=SCAN_B,
                                 scan_batches=1 if many is None else SCAN_K,
                                 encode_many_fn=many) as engine:
                feats_by[key] = engine.encode_paths(gallery)[0]

        for key in ("eager", "graphed", "per-batch"):
            run_path(f"RetrievalEngine(batch_size={SCAN_B}, scan_batches="
                     f"{SCAN_K if key != 'per-batch' else 1}), {kind} "
                     f"ViT-B/16, {len(gallery)} images ({n_batches} batches)"
                     f", {key}", kernels, lambda key=key: engine_run(key),
                     record=key == "graphed")
        same = {k: bool(np.array_equal(v, feats_by["graphed"]))
                for k, v in feats_by.items()}
        print(f"[slice] scan encoder, {kind}: features of the graphed stack "
              f"engine equal in bits to {same}; shape "
              f"{feats_by['graphed'].shape}")
        check(all(same.values()), f"the {kind} scan encoder's graph "
              "differs from the eager encoders")
    px = np.random.default_rng(5).integers(0, 256, (SCAN_K, 3, 224, 224, 3),
                                           dtype=np.uint8)
    eager = make_scan_encoder(tower8, graphed=False)(px)
    scan = make_scan_encoder(tower8)
    got = {}

    def row8_scan():
        for i in range(3):            # warm-up, capture + replay, replay
            got[i] = scan(px)

    run_path(f"int8 scan encoder at B 3, k {SCAN_K} (row 8's cooperative "
             "launch captured)", (qm.quant_layer_block,), row8_scan)
    same = all(np.array_equal(v, eager) for v in got.values())
    print(f"[slice] int8 scan encoder at B 3: graphed equals eager in bits: "
          f"{same}")
    check(same, "the int8 scan at B 3 differs from the eager calls")
    print(f"[slice] CUDA graph phase: {time.perf_counter() - t_phase:.1f} s")


def scan_encoder_times(torch, dev, tower, tower8, label: str) -> None:
    """Encode img/s at ViT-B/16, B 128 through the host API (u8 numpy in,
    features out): the per-batch encoder a batch at a time, against the
    scan encoder over stacks of 4 and 8 batches, eager and graphed (CUDA
    events; the graph warmed up and captured first)."""
    import numpy as np

    from patent_tpu_torch.retrieval.engine import (
        make_device_normalizing_encoder, make_scan_encoder)

    px = np.random.default_rng(6).integers(0, 256, (8, SCAN_B, 224, 224, 3),
                                           dtype=np.uint8)
    t_all = time.perf_counter()
    for kind, model in (("bf16", tower), ("int8", tower8)):
        one = make_device_normalizing_encoder(model, dev)
        ms_one = cuda_ms(torch, lambda: one(px[0]), warmup=2, iters=8)
        parts = [f"per-batch {SCAN_B / ms_one * 1e3:.1f} img/s "
                 f"({ms_one:.2f} ms a batch)"]
        for k in (4, 8):
            for graphed in (False, True):
                scan = make_scan_encoder(model, graphed=graphed)
                ms = cuda_ms(torch, lambda: scan(px[:k]), warmup=2, iters=3)
                parts.append(f"k {k} {'graphed' if graphed else 'eager'} "
                             f"{k * SCAN_B / ms * 1e3:.1f} img/s "
                             f"({ms / k:.2f} ms a batch)")
        print(f"[time] scan encoder, {kind} ViT-B/16 @224, B {SCAN_B}, host "
              f"u8 in, features out: " + "; ".join(parts) + f" {label}")
    print(f"[time] (the scan encoder's times took "
          f"{time.perf_counter() - t_all:.1f} s)")


# ---- the joint trainer (train/train_end.py), HMI (train/train_hmi.py) and
# the graph family (train/train_gcn.py, train/train_vgae.py, models/gcn.py)
TE_DIR = os.path.join(ROOT, "build", "chip_smoke_train_end")
GRAPH_DIR = os.path.join(ROOT, "build", "chip_smoke_graph")
# the kernels of rows 12, 13, 15 and 16 in a profile: the wgmma GEMMs,
# the flash tile, the attention backward, the LayerNorms and the MLP
# backward's reductions (csrc/fused_attention.cu, mlp_grad.cu and the
# headers they include)
TRAIN_KERNELS_RE = re.compile(
    r"gemm_kernel|gemm_tn_kernel|flash_kernel|attn_bwd_|"
    r"layernorm_kernel|ln_bwd_kernel|colsum_parts_kernel|sum_splits_kernel")
# spmm on the card against the dense product of a block of rows (in f64,
# rounded to f32): f32 sums of a few products a row
SPMM_REL_TOL = 1e-5
# the DeepPatent-2018-scale graph trainers' widths and cuts
GRAPH_EPOCHS, VGAE_EPOCHS, HMI_EPOCHS = 2, 5, 2
# evaluate_embeddings on the card against the host on the exported rows:
# the first EVAL_PAIRS same-patent and same-CPC pairs; the cosine ratios
# are f32 means summed in another order, Hit@k may move where two
# neighbours of a child tie at the k-th place (a share of a pair each)
EVAL_PAIRS = 2048
EVAL_RATIO_RTOL, EVAL_HIT_ATOL = 1e-4, 1e-2


def end_to_end_setup(torch, dev, h: dict) -> dict:
    """train_end at EndToEndConfig's defaults (ViT-B/16 @224, 32 pairs, the
    last 9 blocks trained, the head of 256 at c 2) on the hyperbolic
    slice's label table (h["td"]): seeded pixels, patents, negatives, the
    table's implication pairs, a cotangent of the features and the pixels
    with noise of std 1e-3 (the yardstick)."""
    from patent_tpu_torch.models.vit import VIT_B16
    from patent_tpu_torch.utils.config import EndToEndConfig

    cfg = EndToEndConfig()
    td = h["td"]
    n_pat = td.label_offsets["medium_cpcs"] - td.label_offsets["patents"]
    gen = torch.Generator(device=dev).manual_seed(17)
    b, px = cfg.batch_size, VIT_B16.image_size
    images = torch.randn(2 * b, px, px, 3, generator=gen, device=dev)
    return {"cfg": cfg, "label_num": td.num_labels, "images": images,
            "pos": torch.randint(0, n_pat, (b,), generator=gen, device=dev),
            "neg": torch.randint(0, n_pat, (b, 2), generator=gen, device=dev),
            "impl": torch.as_tensor(td.implication, dtype=torch.long,
                                    device=dev),
            "cot": torch.randn(2 * b, VIT_B16.projection_dim, generator=gen,
                               device=dev),
            "noisy": images + 1e-3 * torch.randn(images.shape, generator=gen,
                                                 device=dev)}


def end_to_end_step_check(torch, dev, run_path, e: dict, vcfg=None,
                          tname: str = "ViT-B/16 @224",
                          record: bool = True) -> None:
    """One train_end step at full width with the kernels (the main path:
    its launches recorded unless ``record`` is False) against one with the
    plain blocks, from the same seeded weights and dropout generator, at
    the tower ``vcfg`` (ViT-B/16 by default): check_train_step's gates;
    the frozen blocks equal in bits after the step and every label row
    inside the ball; at a tower other than ViT-B/16 the hinge held to
    hinge_gate's gate."""
    from patent_tpu_torch.models.vit import VIT_B16
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.train import train_end as te

    cfg = e["cfg"]
    vcfg = vcfg or VIT_B16
    n_frozen = vcfg.num_layers - cfg.trainable_blocks
    counters = (fa.fused_attention_fwd, fa.fused_attention_bwd,
                mm.fused_mlp_fwd, mm.fused_mlp_bwd)

    def tower_grads(vit, x):
        vit.zero_grad(set_to_none=True)
        vit(x).backward(e["cot"])
        return {n: t.grad.clone() for n, t in vit.named_parameters()
                if t.grad is not None}

    runs = []
    for kernels in (True, False):
        model, opt = te.init_end_to_end(vcfg, cfg, e["label_num"], seed=0,
                                        device=dev)
        model.vit.kernels = kernels
        step, loss_fn = te.make_end_to_end_step(model, opt, cfg)
        tower = tower_grads(model.vit, e["images"])
        if not kernels:
            yardstick = grad_gaps(tower_grads(model.vit, e["noisy"]), tower)

            def loss_metrics(pix):
                with torch.no_grad():
                    return {k: float(v) for k, v in loss_fn(
                        pix, e["pos"], e["neg"], e["impl"],
                        torch.Generator(device=dev).manual_seed(3))[
                            1].items()}

            clean, shaken = (loss_metrics(pix)
                             for pix in (e["images"], e["noisy"]))
            metric_yardstick = {k: abs(shaken[k] - v) / abs(v)
                                for k, v in clean.items()}
            metric_tols = (None if vcfg is VIT_B16 else
                           {STEP_HINGE: hinge_gate(torch, dev, loss_metrics,
                                                   e["images"], tname)})
        kept, out = {}, {}

        def keep_dz(_module, _inputs, feats):
            feats.register_hook(lambda g: kept.update(dz=g.clone()))

        frozen = {n: p.detach().clone() for n, p in
                  model.vit.named_parameters() if not p.requires_grad}
        hook = model.vit.register_forward_hook(keep_dz)
        dgen = torch.Generator(device=dev).manual_seed(3)

        def go():
            out.update(step(e["images"], e["pos"], e["neg"], e["impl"],
                            dgen))

        if kernels:
            run_path(f"train_end step, {tname}, {cfg.batch_size} pairs",
                     counters, go, record)
        else:
            go()
        hook.remove()
        torch.cuda.synchronize()
        params = dict(model.vit.named_parameters())
        check({f"blocks.{i}.wqkv" for i in range(n_frozen)} <= set(frozen)
              and all(torch.equal(params[n], t) for n, t in frozen.items()),
              "a frozen leaf of the train_end tower moved in a step")
        radius = float(model.hyp.label_emb.detach().norm(dim=1).max()) \
            * math.sqrt(cfg.curvature)
        check(radius < 1.0, f"a label row left the ball: radius {radius}")
        runs.append(({k: float(v) for k, v in out.items()}, tower,
                     {n: t.grad for n, t in model.named_parameters()
                      if t.grad is not None}, kept["dz"]))
        del model, opt
    check_train_step(torch, *zip(*runs), yardstick,
                     what=f"train_end step, {tname}",
                     metric_yardstick=metric_yardstick,
                     metric_tols=metric_tols)
    print(f"[slice] train_end step, {tname}: the {len(frozen)} frozen tower "
          f"leaves (blocks 0-{n_frozen - 1}, the embeddings, pre-LN) equal "
          f"in bits after it; label rows inside the ball (largest radius "
          f"{radius:.6f} of 1/sqrt(c))")


def hinge_gate(torch, dev, loss_metrics, images, tname: str) -> float:
    """The gate of train_end's hinge at a wide tower: HINGE_NOISE_MULT
    times the root mean square of its relative move over
    HINGE_NOISE_DRAWS draws of pixel noise of std 1e-3 (loss_metrics: the
    plain blocks' metrics of a batch of pixels), never below
    STEP_METRIC_REL_TOL.  A planted fault must fail it: the plain blocks
    with every attention seeing its first 16 keys only."""
    from patent_tpu_torch.ops import flash_attention as fa

    clean = loss_metrics(images)[STEP_HINGE]
    gen = torch.Generator(device=dev).manual_seed(23)

    def move(pix):
        return abs(loss_metrics(pix)[STEP_HINGE] - clean) / abs(clean)

    moves = [move(images + 1e-3 * torch.randn(images.shape, generator=gen,
                                              device=dev))
             for _ in range(HINGE_NOISE_DRAWS)]
    rms = math.sqrt(sum(m * m for m in moves) / len(moves))
    tol = max(STEP_METRIC_REL_TOL, HINGE_NOISE_MULT * rms)
    plain = fa.fused_attention_block_plain
    # the Function's forward looks the plain block up by name at each call
    fa.fused_attention_block_plain = lambda *a: plain(*a[:-1], 16)
    try:
        fault = move(images)
    finally:
        fa.fused_attention_block_plain = plain
    print(f"[kernel] train_end step, {tname}: the hinge's pixel-noise "
          f"moves over {len(moves)} draws "
          + ", ".join(f"{m:.2g}" for m in moves)
          + f" (rms {rms:.3g}); its gate max({STEP_METRIC_REL_TOL}, "
          f"{HINGE_NOISE_MULT} x rms) = {tol:.3g}; planted fault (the plain "
          f"blocks, every attention seeing its first 16 keys only) moves it "
          f"{fault:.3g}, which must fail that gate")
    check(fault > tol, f"train_end at {tname}: the planted fault moves the "
          f"hinge by {fault:.3g}, within its gate {tol:.3g}")
    return tol


def end_to_end_slice(torch, dev, run_path, cli, h: dict) -> None:
    """train_end --epochs 2 through the CLI (its 32 px tower: S 17, D 64
    over 4 heads, 16 images a step); train_hmi on the hyperbolic slice's
    graph (h["graph"]: DeepPatent-2018 scale) with its 512-wide figure
    features, HMI_EPOCHS epochs (the loss finite and falling) and its
    label scores on the card; then the graph family at the same scale:
    train_class_pro's trainer, GRAPH_EPOCHS epochs at GCNTrainConfig's
    widths (512 → 512 → 256, 512 pairs a step; the sparse path above
    16,384 nodes), and its export, evaluate_embeddings of the exported
    rows on the card held to the host's, spmm against the dense product
    of a block of rows and equal in bits twice (forward and backward),
    the VGAE on the sampled objective; train --model VGAE through the CLI
    on the CLI's graph, and plot on a train_hyp checkpoint."""
    import numpy as np

    from patent_tpu_torch.data.hmi_inputs import generate_hmi_inputs
    from patent_tpu_torch.data.pairs import sample_figure_pairs
    from patent_tpu_torch.models import gcn
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.metrics.embedding_quality import \
        evaluate_embeddings
    from patent_tpu_torch.train.train_gcn import (export_graph_embeddings,
                                                  train_pair_classification)
    from patent_tpu_torch.train.train_hmi import hmi_label_scores, train_hmi
    from patent_tpu_torch.train.train_vgae import train_vgae_link_prediction
    from patent_tpu_torch.utils.config import GCNTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    t_phase = time.perf_counter()
    shutil.rmtree(TE_DIR, ignore_errors=True)
    log = io.StringIO()

    def cli_train_end():
        with contextlib.redirect_stdout(log):
            rc = cli(["train_end", "--path", TE_DIR, "--epochs", "2"])
        check(rc == 0, "train_end failed")

    run_path("train_end --epochs 2 (the CLI's tower: 32 px, S 17, head_dim "
             "16, 8 pairs a step)",
             (fa.fused_attention_fwd, fa.fused_attention_bwd,
              mm.fused_mlp_fwd, mm.fused_mlp_bwd), cli_train_end)
    losses = [float(v) for v in re.findall(r"total_loss=(\S+)",
                                           log.getvalue())]
    check(losses and all(math.isfinite(v) for v in losses),
          f"train_end losses not finite: {losses}")
    print(f"[slice] train_end --epochs 2: total_loss {losses[-1]:.4f} after "
          f"6 steps")

    graph, td = h["graph"], h["td"]
    nf = graph.counts["figures"]
    num_labels = graph.num_nodes - nf
    t0 = time.perf_counter()
    inputs = generate_hmi_inputs(graph, seed=42)
    t_inputs = time.perf_counter() - t0
    t0 = time.perf_counter()
    hmi_params, hist = train_hmi(td.x_figures, inputs, num_labels,
                                 epochs=HMI_EPOCHS, device=dev,
                                 logger=MetricsLogger(print_every=0))
    torch.cuda.synchronize()
    t_hmi = time.perf_counter() - t0
    scores = hmi_label_scores(hmi_params, td.x_figures[:64], 64, num_labels,
                              batch_size=16, device=dev)
    loss = hist["train_loss"]
    print(f"[slice] train_hmi on {nf} figures x {num_labels} labels "
          f"({len(inputs.y_pos)} Y_pos + {len(inputs.y_neg)} Y_neg pairs, "
          f"{len(inputs.implication)} implications, {len(inputs.exclusion)} "
          f"exclusions; inputs built in {t_inputs:.1f} s): {HMI_EPOCHS} "
          f"epochs in {t_hmi:.1f} s, loss {' -> '.join(f'{v:.4f}' for v in loss)}"
          f"; label scores {scores.shape} on the card")
    check(all(math.isfinite(v) for v in loss) and loss[-1] < loss[0]
          and scores.shape == (64, num_labels)
          and bool(np.isfinite(scores).all()),
          f"train_hmi loss not finite and falling, or scores bad: {loss}")
    h.update(hmi_inputs=inputs, hmi_params=hmi_params)

    # the graph at the same scale: train_class_pro's trainer and export
    t0 = time.perf_counter()
    pair_data = sample_figure_pairs(h["records"], num_samples=100_000,
                                    seed=0)
    print(f"[slice] graph: {graph.num_nodes} nodes, {graph.adjacency.nnz} "
          f"edges, features {h['xf'].shape}, {len(pair_data['pairs'])} "
          f"figure pairs {pair_data['level_counts']}, sampled in "
          f"{time.perf_counter() - t0:.1f} s")
    check(graph.num_nodes > 16384, "the graph is too small for the sparse "
          "path")
    gcfg = GCNTrainConfig(epochs=GRAPH_EPOCHS, latent_dim=256)
    pairs = np.asarray(pair_data["pairs"], np.int32)
    t0 = time.perf_counter()
    variables, ghist, report = train_pair_classification(
        h["xf"], graph.adjacency, pairs,
        np.asarray(pair_data["labels"], np.int32) - 1, gcfg, device=dev,
        logger=MetricsLogger(print_every=0))
    emb = export_graph_embeddings(
        variables, h["xf"], graph.adjacency, gcfg.hidden_dim,
        gcfg.latent_dim, gcfg.num_layers, graph.figure_index,
        adjacency_mode=gcfg.adjacency, device=dev)
    torch.cuda.synchronize()
    t_gcn = time.perf_counter() - t0
    rows = np.stack(list(emb.values()))
    check(len(emb) == nf and rows.shape[1] == 256
          and all(type(v) is np.ndarray for v in emb.values())
          and bool(np.isfinite(rows).all())
          and all(math.isfinite(v) for v in ghist["train_loss"])
          and math.isfinite(report["test_loss"])
          and 0.0 <= report["test_acc"] <= 1.0,
          f"train_class_pro report or export bad: {report}, {rows.shape}")
    print(f"[slice] train_class_pro's trainer, {GRAPH_EPOCHS} epochs "
          f"(GCNTrainConfig widths 512 -> 512 -> 256, {gcfg.batch_size} "
          f"pairs a step, sparse adjacency) and its export in {t_gcn:.1f} s: "
          f"train_loss {' -> '.join(f'{v:.4f}' for v in ghist['train_loss'])}"
          f", test_loss {report['test_loss']:.4f}, test_acc "
          f"{report['test_acc']:.4f}; {len(emb)} figure embeddings of 256 "
          f"exported, norms {float(np.linalg.norm(rows, axis=1).min()):.6f}-"
          f"{float(np.linalg.norm(rows, axis=1).max()):.6f}")
    h["gcn_pairs"] = pair_data

    # evaluate_embeddings on the exported rows, on the card and on the host
    z = np.zeros((nf, rows.shape[1]), np.float32)
    for name, vec in emb.items():
        z[graph.figure_index[name]] = vec
    levels = np.asarray(pair_data["labels"])
    same_patent = pairs[levels == 1][:EVAL_PAIRS]
    same_cpc = pairs[levels == 2][:EVAL_PAIRS]
    t0 = time.perf_counter()
    on_card = evaluate_embeddings(z, same_patent, same_cpc, device="cuda")
    t_eval = time.perf_counter() - t0
    on_host = evaluate_embeddings(z, same_patent, same_cpc, device="cpu")
    cos_gap = max(abs(on_card[k] - v) / max(abs(v), 1e-12)
                  for k, v in on_host.items() if k != "hierarchical_hit_at_k")
    hit_gap = max(abs(on_card["hierarchical_hit_at_k"][k] - v)
                  for k, v in on_host["hierarchical_hit_at_k"].items())
    print(f"[slice] evaluate_embeddings on the card ({len(same_patent)} "
          f"same-patent and {len(same_cpc)} same-CPC pairs over {nf} "
          f"figures) in {t_eval:.2f} s: {json.dumps(on_card)}; against the "
          f"host's: ratios rel {cos_gap:.3g} (gate {EVAL_RATIO_RTOL}), "
          f"Hit@k abs {hit_gap:.3g} (gate {EVAL_HIT_ATOL})")
    check(set(on_card) == set(on_host) and cos_gap <= EVAL_RATIO_RTOL
          and hit_gap <= EVAL_HIT_ATOL,
          "evaluate_embeddings on the card differs from the host's")

    # spmm against the dense product of the first rows, and its bits
    adj = gcn.normalize_adjacency_sparse(graph.adjacency).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    y = torch.randn(graph.num_nodes, 256, generator=g, device=dev)
    cot = torch.randn(graph.num_nodes, 256, generator=g, device=dev)
    runs = []
    for _ in range(2):
        yy = y.clone().requires_grad_(True)
        prod = gcn.spmm(adj, yy)
        prod.backward(cot)
        runs.append((prod.detach(), yy.grad))
    torch.cuda.synchronize()
    m = 8192
    sel = adj.rows < m
    block = torch.zeros(m, graph.num_nodes, device=dev)
    block[adj.rows[sel], adj.cols[sel]] = adj.vals[sel]
    want = (block.double() @ y.double()).float()
    err = rel_err(runs[0][0][:m], want)
    # the backward's first rows get the cotangents of every row, so its
    # reference is the transposed block's rows among the first m only
    sel_t = adj.cols < m
    back_want = torch.zeros(m, 256, device=dev)
    back_want.index_add_(0, adj.cols[sel_t], adj.vals[sel_t, None]
                         * cot[adj.rows[sel_t]])
    err_g = rel_err(runs[0][1][:m], back_want)
    del block
    bits = (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1]))
    print(f"[kernel] spmm on the {graph.num_nodes}-node graph ({len(adj.vals)}"
          f" edges) x 256: rows 0-{m - 1} vs the dense product, rel err "
          f"{err:.3g} (gate {SPMM_REL_TOL}), backward {err_g:.3g}; two runs "
          f"equal in bits (forward and backward): {bits}")
    check(err <= SPMM_REL_TOL and err_g <= SPMM_REL_TOL and bits,
          "spmm on the card differs from the dense product or between runs")
    del adj, y, cot, runs, want, back_want

    t0 = time.perf_counter()
    _v, _split, vrep = train_vgae_link_prediction(
        h["xf"], graph.adjacency, hidden_dim=512, latent_dim=128,
        epochs=VGAE_EPOCHS, mode="sampled", device=dev,
        logger=MetricsLogger(print_every=0))
    print(f"[slice] train_vgae_link_prediction, {VGAE_EPOCHS} epochs (the "
          f"sampled objective, {graph.num_nodes} nodes, 512 -> 128) in "
          f"{time.perf_counter() - t0:.1f} s: {vrep}")
    check(0.0 <= vrep["roc_auc"] <= 1.0 and math.isfinite(
        vrep["average_precision"]), f"VGAE report out of range: {vrep}")
    # the CLI's graph actions on the CLI's own graph (the composed
    # pipeline's phase runs train_class_pro)
    shutil.rmtree(GRAPH_DIR, ignore_errors=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli(["train", "--model", "VGAE", "--path", GRAPH_DIR,
                  "--epochs", str(VGAE_EPOCHS)])
    out = log.getvalue()
    check(rc == 0, f"train --model VGAE failed: {out[-2000:]}")
    vrep = json.loads(out[out.rindex("{\n"):out.rindex("}") + 1])
    print(f"[slice] train --model VGAE --epochs {VGAE_EPOCHS} (the CLI's "
          f"graph) in {time.perf_counter() - t0:.1f} s: {vrep}")
    check(0.0 <= vrep["roc_auc"] <= 1.0 and math.isfinite(
        vrep["average_precision"]), f"VGAE report out of range: {vrep}")

    # plot: on a box without matplotlib or scikit-learn it writes nothing
    # and says so
    err_log = io.StringIO()
    plot_dir = os.path.join(TRAIN_DIR, "fresh")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err_log):
        rc = cli(["plot", "--path", plot_dir])
    pngs = glob.glob(os.path.join(plot_dir, "plots", "*.png"))
    said = err_log.getvalue().strip()
    check(rc == 0 and (bool(pngs) or "were not written" in said),
          f"plot failed: rc {rc}, {said}")
    print(f"[slice] plot: {len(pngs)} figures written"
          + (f"; {said}" if said else ""))
    print(f"[slice] joint trainer, HMI and graph phase: "
          f"{time.perf_counter() - t_phase:.1f} s")


def end_to_end_times(torch, dev, e: dict, h: dict, label: str) -> None:
    """train_end's step at 32 pairs with the kernels: ms a step and img/s
    (CUDA events), its profile (busy share, rows 12, 13, 15 and 16's
    kernels' share, launches a step); a train_class_pro epoch at the 2018
    scale (its trainer's own loop, in seconds) and a train_hmi epoch."""
    from patent_tpu_torch.models.vit import VIT_B16
    from patent_tpu_torch.train import train_end as te
    from patent_tpu_torch.train.train_gcn import train_pair_classification
    from patent_tpu_torch.train.train_hmi import train_hmi
    from patent_tpu_torch.utils.config import GCNTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    import numpy as np

    t_all = time.perf_counter()
    cfg = e["cfg"]
    model, opt = te.init_end_to_end(VIT_B16, cfg, e["label_num"], seed=0,
                                    device=dev)
    step, _loss = te.make_end_to_end_step(model, opt, cfg)
    dgen = torch.Generator(device=dev).manual_seed(3)

    def one_step():
        step(e["images"], e["pos"], e["neg"], e["impl"], dgen)

    ms = cuda_ms(torch, one_step, warmup=2, iters=10)
    n_img = 2 * cfg.batch_size
    rows = launch_times(torch, one_step, iters=3)
    busy = sum(t * n for _k, t, n in rows) / 3
    ours = sum(t * n for k, t, n in rows if TRAIN_KERNELS_RE.search(k)) / 3
    launches = sum(n for _k, _t, n in rows) / 3
    top = sorted(rows, key=lambda r: -r[1] * r[2])[:8]
    print(f"[time] train_end step, ViT-B/16 @224, {cfg.batch_size} pairs "
          f"({n_img} images, last {cfg.trainable_blocks} blocks trained, "
          f"head of {cfg.embed_dim} over {e['label_num']} labels): "
          f"{ms:.2f} ms/step, {n_img / ms * 1e3:.1f} img/s forward + "
          f"backward {label}")
    print(f"[time] train_end step profile (torch.profiler, 3 steps): "
          f"{busy:.2f} ms busy of {ms:.2f} ms wall ({100 * busy / ms:.1f}%)"
          f", rows 12, 13, 15 and 16's kernels {ours:.2f} ms "
          f"({100 * ours / ms:.1f}% of the step), {launches:.0f} launches a "
          f"step; top kernels: " + "; ".join(
              f"{t * n / 3:.2f} ms ({n // 3} a step) {k[:60]}"
              for k, t, n in top) + f" {label}")
    del model, opt

    graph, x, pair_data = h["graph"], h["xf"], h["gcn_pairs"]
    pairs = np.asarray(pair_data["pairs"], np.int32)
    labels = np.asarray(pair_data["labels"], np.int32) - 1
    gcfg = GCNTrainConfig(epochs=1, latent_dim=256)
    n_steps = -(-int(len(pairs) * gcfg.train_ratio) // gcfg.batch_size)
    td, inputs = h["td"], h["hmi_inputs"]
    nf = graph.adjacency.shape[0] - (td.num_labels)
    n_pairs = len(inputs.y_pos) + len(inputs.y_neg)
    for graphed in (False, True):
        kind = "graphed" if graphed else "eager"
        t0 = time.perf_counter()
        train_pair_classification(
            x, graph.adjacency, pairs, labels, gcfg, device=dev,
            logger=MetricsLogger(print_every=0), graphed=graphed)
        torch.cuda.synchronize()
        t_gcn = time.perf_counter() - t0
        print(f"[time] train_class_pro, one epoch at the 2018 scale, {kind} "
              f"({graph.adjacency.shape[0]} nodes, {n_steps} steps of "
              f"{gcfg.batch_size} pairs at 512 -> 512 -> 256, the validation "
              f"and test passes, the adjacency's preparation and a graph's "
              f"warm-up and capture included): {t_gcn:.2f} s {label}")
        t0 = time.perf_counter()
        train_hmi(td.x_figures, inputs, td.num_labels, epochs=1, device=dev,
                  logger=MetricsLogger(print_every=0), graphed=graphed)
        torch.cuda.synchronize()
        t_hmi = time.perf_counter() - t0
        print(f"[time] train_hmi, one epoch, {kind} ({n_pairs} pairs, "
              f"{n_pairs // 256} steps of 256; {nf} figures): {t_hmi:.2f} s "
              f"{label}")
    print(f"[time] (the train_end, train_class_pro and train_hmi times took "
          f"{time.perf_counter() - t_all:.1f} s)")


TEXT_DIR = os.path.join(ROOT, "build", "chip_smoke_text")
# an HF CLIP directory of the seeded ViT-B/16 and TEXT_B weights in each
# of the two formats save_pretrained writes
HF_DIR = os.path.join(ROOT, "build", "chip_smoke_hf")
HF_BIN_DIR = os.path.join(ROOT, "build", "chip_smoke_hf_bin")
# TEXT_B on the card against the same weights on the CPU, f32 on both (no
# TF32): ||card - cpu|| / ||cpu|| a row.  Without the causal mask the
# features move by far more
TEXT_ROW_REL_TOL = 1e-4
TEXT_ROWS, TEXT_BATCH = 16, 256
# the CPC sections' titles (the main rows' definitions; the USPTO title
# lists hold classes and subclasses)
CPC_SECTIONS = {
    "A": "HUMAN NECESSITIES",
    "B": "PERFORMING OPERATIONS; TRANSPORTING",
    "C": "CHEMISTRY; METALLURGY",
    "D": "TEXTILES; PAPER",
    "E": "FIXED CONSTRUCTIONS",
    "F": "MECHANICAL ENGINEERING; LIGHTING; HEATING; WEAPONS; BLASTING",
    "G": "PHYSICS",
    "H": "ELECTRICITY",
    "Y": "GENERAL TAGGING OF NEW TECHNOLOGICAL DEVELOPMENTS"}
TITLE_WORDS = ("chair", "lamp", "vehicle", "display screen", "graphical user "
               "interface", "robot", "arm", "light fixture", "garment",
               "bottle", "container", "handle", "wheel", "icon", "housing",
               "speaker", "watch", "shoe", "table", "planter")


def write_safetensors(path: str, tensors: dict) -> None:
    """f32 tensors → a .safetensors file: 8 bytes of little-endian header
    length, the JSON header (dtype, shape, data_offsets; padded with spaces
    to 8 bytes), the raw buffer."""
    import struct

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        blob = t.detach().float().contiguous().cpu().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def write_vocab(root: str) -> str:
    """A CLIP BPE vocabulary of every printable ASCII byte symbol, its
    </w> form, a few merges and the special tokens (vocab.json +
    merges.txt under ``root``/vocab); → the directory."""
    from patent_tpu_torch.data import bpe

    d = os.path.join(root, "vocab")
    os.makedirs(d, exist_ok=True)
    b2u = bpe._bytes_to_unicode()
    vocab: dict = {}
    for sym in [b2u[c] for c in range(33, 127)] + [b2u[ord(" ")]]:
        vocab.setdefault(sym, len(vocab))
        vocab.setdefault(sym + "</w>", len(vocab))
    merges = ["#version: 0.2", "o r", "a n", "i n", "e r</w>", "t h",
              "th e</w>", "a r", "in g</w>", "an d</w>", "d e", "s i"]
    for m in merges[1:]:
        vocab.setdefault("".join(m.split()), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return d


def hf_checkpoint_slice(torch, np, run_path, cli, counters: dict,
                        vision_state: dict, slice_out: dict) -> None:
    """An HF CLIP directory written from the seeded ViT-B/16 weights (the
    ones served above as clip_finetune_best) and a seeded TEXT_B tower:
    model.safetensors by write_safetensors, pytorch_model.bin by
    torch.save, each read back by the port's reader equal in bits; then
    eval --checkpoint through the CLI, bf16 and --quantize, whose gallery
    features must equal in bits those of the same weights served from
    clip_finetune_best (slice_out["GE"], slice_out["GE_int8"])."""
    from patent_tpu_torch.models.clip_import import (
        SAFETENSORS_FILE, TORCH_FILE, hf_clip_text_state_dict,
        hf_clip_vision_state_dict, read_hf_state_dict)
    from patent_tpu_torch.models.vit import TEXT_B, TextTransformer

    t0 = time.perf_counter()
    text = TextTransformer(TEXT_B,
                           generator=torch.Generator().manual_seed(77))
    sd = hf_clip_vision_state_dict(vision_state)
    sd.update(hf_clip_text_state_dict(text.state_dict()))
    del text
    for d in (HF_DIR, HF_BIN_DIR):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    write_safetensors(os.path.join(HF_DIR, SAFETENSORS_FILE), sd)
    torch.save(sd, os.path.join(HF_BIN_DIR, TORCH_FILE))
    a, b = read_hf_state_dict(HF_DIR), read_hf_state_dict(HF_BIN_DIR)
    same = set(a) == set(b) == set(sd) and all(
        torch.equal(a[k], sd[k]) and torch.equal(b[k], sd[k]) for k in sd)
    mb = os.path.getsize(os.path.join(HF_DIR, SAFETENSORS_FILE)) / 2**20
    print(f"[slice] HF CLIP directories from the seeded ViT-B/16 and TEXT_B "
          f"weights ({len(sd)} tensors, {mb:.0f} MiB as {SAFETENSORS_FILE} "
          f"and as {TORCH_FILE}) written in {time.perf_counter() - t0:.1f} "
          f"s; each read back equal in bits: {same}")
    check(same, "an HF checkpoint read back differs from what was written")
    del a, b, sd
    for flags, ref in (([], "GE"), (["--quantize"], "GE_int8")):
        tag = "_int8" if flags else ""
        run_path(f"eval --checkpoint (HF, {'int8' if flags else 'bf16'})",
                 counters[ref], lambda flags=flags: check(cli(
                     ["eval", "--path", RUN_DIR, "--model", "HF" + tag,
                      "--checkpoint", HF_DIR] + flags) == 0,
                     f"eval --checkpoint {flags} failed"))
        npys = glob.glob(os.path.join(RUN_DIR, "embeddings",
                                      f"*_torch{tag}_hf*.npy"))
        check(len(npys) == 1, f"expected one _hf index, found {npys}")
        emb = np.load(npys[0])
        equal = bool(np.array_equal(emb, slice_out[ref]))
        print(f"[slice] eval --checkpoint {' '.join(flags) or '(bf16)'}: "
              f"gallery features {emb.shape} equal in bits to the same "
              f"weights served as clip_finetune_best: {equal}")
        check(equal, f"eval --checkpoint {flags} features differ from the "
              "clip_finetune_best run's")


def text_slice(torch, dev, h: dict) -> None:
    """The text stage on the card: TEXT_B from the HF directory on the card
    against the same weights on the CPU (and the card's tower without the
    causal mask, a control that must fail the gate); a BPE vocabulary
    through build_text_feature_dicts; USPTO-style fixed-width CPC lines of
    the 2018-scale graph's codes through parse_cpc_definitions_fixed_width;
    the graph's patent and CPC rows filled from the tower (a title per
    patent, a definition per code) and one train_class_pro epoch on that
    feature matrix, beside the figure-only run.  Adds what the times reuse
    to h["text"]."""
    import numpy as np

    from patent_tpu_torch.data import bpe
    from patent_tpu_torch.data.graph_build import build_feature_matrix
    from patent_tpu_torch.data.text_features import (
        build_text_feature_dicts, clip_tokenizer_or_fallback,
        parse_cpc_definitions_fixed_width)
    from patent_tpu_torch.models.clip_import import load_hf_clip_text_params
    from patent_tpu_torch.models.vit import (TEXT_B, TextTransformer,
                                             transformer_block)
    from patent_tpu_torch.train.train_gcn import train_pair_classification
    from patent_tpu_torch.utils.config import GCNTrainConfig
    from patent_tpu_torch.utils.logging import MetricsLogger

    t_phase = time.perf_counter()
    shutil.rmtree(TEXT_DIR, ignore_errors=True)
    vocab_dir = write_vocab(TEXT_DIR)
    state = load_hf_clip_text_params(HF_DIR, TEXT_B)
    towers = []
    for where in ("cpu", dev):
        tower = TextTransformer(TEXT_B, device=where)
        tower.load_state_dict(state)
        towers.append(tower.eval())
    cpu_tower, card = towers
    graph = h["graph"]
    rng = np.random.default_rng(18)
    titles = {p: "Ornamental design for a " + " and ".join(
        rng.choice(TITLE_WORDS, 2)) for p in sorted(graph.patent_index)}
    # the USPTO title list's fixed-width lines for the graph's classes and
    # subclasses; the sections' titles for its main rows
    codes = sorted(graph.medium_index) + sorted(graph.big_index)
    lines = ["# CPC titles (fixed width)"] + [
        f"{code:<8}{'':8}" + " ".join(rng.choice(TITLE_WORDS, 3)).upper()
        for code in codes]
    defs = parse_cpc_definitions_fixed_width(lines)
    check(sorted(defs) == sorted(codes), f"parsed CPC codes {sorted(defs)} "
          f"differ from the graph's {codes}")
    defs.update({c: CPC_SECTIONS[c] for c in graph.main_index})
    tok = clip_tokenizer_or_fallback(vocab_dir, TEXT_B)
    check(isinstance(tok, bpe.ClipBPETokenizer),
          "the vocabulary directory did not give the CLIP BPE tokenizer")
    ids = torch.from_numpy(np.stack([tok(titles[p])
                                     for p in sorted(titles)[:TEXT_ROWS]]))

    def row_err(got, want):
        return float(((got.cpu() - want).norm(dim=1)
                      / want.norm(dim=1)).max())

    with torch.inference_mode():
        want = cpu_tower(ids)
        got = card(ids.to(dev))
        x = card.embed(ids.to(dev))
        for layer in card.blocks:
            x = transformer_block(x, layer, TEXT_B.num_heads, torch.float32)
        ctrl = card.readout(x, ids.to(dev))
    err, err_ctrl = row_err(got, want), row_err(ctrl, want)
    print(f"[kernel] TEXT_B (vocab {TEXT_B.vocab_size}, context "
          f"{TEXT_B.context_length}, {TEXT_B.num_layers} x {TEXT_B.hidden_dim}"
          f", f32) on the card vs the CPU, {TEXT_ROWS} BPE-tokenized titles: "
          f"largest row rel err {err:.3g} (gate {TEXT_ROW_REL_TOL}); "
          f"control without the causal mask {err_ctrl:.3g} (must fail)")
    check(err <= TEXT_ROW_REL_TOL < err_ctrl,
          "TEXT_B on the card differs from the CPU, or the control passed")
    del cpu_tower

    t0 = time.perf_counter()
    cpc_feats, pat_feats = build_text_feature_dicts(
        defs, titles, model=card, checkpoint_dir=vocab_dir, device=dev)
    t_text = time.perf_counter() - t0
    first = torch.from_numpy(np.stack([pat_feats[p]
                                       for p in sorted(titles)[:TEXT_ROWS]]))
    err_b = row_err(first, want)
    print(f"[slice] build_text_feature_dicts on the card: {len(titles)} "
          f"titles and {len(defs)} CPC definitions ({len(codes)} parsed from "
          f"fixed-width lines), the BPE pattern of the {bpe._re.__name__!r} "
          f"module, batches of {TEXT_BATCH}, in {t_text:.1f} s; its first "
          f"{TEXT_ROWS} titles vs the CPU tower: row rel err {err_b:.3g}")
    check(err_b <= TEXT_ROW_REL_TOL, "embed_texts on the card differs from "
          "the CPU tower")
    xf = h["xf"]
    figs = {name: xf[row] for name, row in graph.figure_index.items()}
    levels = [{k: cpc_feats[k] for k in idx} for idx in (
        graph.medium_index, graph.big_index, graph.main_index)]
    x_text = build_feature_matrix(graph, figs, pat_feats, *levels)
    nf = graph.counts["figures"]
    filled = int((np.abs(x_text[nf:]).sum(1) > 0).sum())
    check(np.array_equal(x_text[:nf], xf[:nf])
          and bool(np.isfinite(x_text).all())
          and filled == graph.num_nodes - nf,
          f"text rows of the feature matrix not filled: {filled} of "
          f"{graph.num_nodes - nf}")
    pairs = np.asarray(h["gcn_pairs"]["pairs"], np.int32)
    labels = np.asarray(h["gcn_pairs"]["labels"], np.int32) - 1
    gcfg = GCNTrainConfig(epochs=1, latent_dim=256)
    t0 = time.perf_counter()
    _v, hist, report = train_pair_classification(
        x_text, graph.adjacency, pairs, labels, gcfg, device=dev,
        logger=MetricsLogger(print_every=0))
    torch.cuda.synchronize()
    print(f"[slice] train_class_pro's trainer, 1 epoch on the text-filled "
          f"matrix ({nf} figure rows, {filled} patent and CPC rows from "
          f"TEXT_B) in {time.perf_counter() - t0:.1f} s: train_loss "
          f"{hist['train_loss'][0]:.4f}, test_loss "
          f"{report['test_loss']:.4f}, test_acc {report['test_acc']:.4f}")
    check(all(math.isfinite(v) for v in hist["train_loss"])
          and math.isfinite(report["test_loss"])
          and 0.0 <= report["test_acc"] <= 1.0,
          f"train_class_pro on the text-filled matrix: {report}")
    h["text"] = {"model": card, "tok": tok,
                 "titles": [titles[p] for p in sorted(titles)]}
    print(f"[slice] text phase: {time.perf_counter() - t_phase:.1f} s")


def text_flops(cfg) -> float:
    """Multiply-adds x 2 of one row through the text tower: the dense
    layers, the attention products over all L x L scores, the projection
    of the EOS row."""
    d, f, n = cfg.hidden_dim, cfg.mlp_dim, cfg.context_length
    dense = n * (3 * d * d + d * d + 2 * d * f)
    attn = 2 * n * n * d
    return 2.0 * (cfg.num_layers * (dense + attn) + d * cfg.projection_dim)


def text_times(torch, dev, h: dict, label: str) -> None:
    """Texts a second through embed_texts at TEXT_B, batch 256, over the
    2018 scale's titles (tokenizing included, then alone), and the tower
    alone on 2,048 tokenized titles with its profile (busy share, top
    kernels, the f32 rate)."""
    import numpy as np

    from patent_tpu_torch.data.text_features import embed_texts
    from patent_tpu_torch.models.vit import TEXT_B

    t = h.pop("text")
    model, tok, texts = t["model"], t["tok"], t["titles"]
    embed_texts(texts[:TEXT_BATCH], model, tok, batch_size=TEXT_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = embed_texts(texts, model, tok, batch_size=TEXT_BATCH)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = np.stack([tok(x) for x in texts])
    t_tok = time.perf_counter() - t0
    check(emb.shape == (len(texts), TEXT_B.projection_dim)
          and bool(np.isfinite(emb).all()), "text features not finite")
    n = 2048
    sub = torch.from_numpy(ids[:n]).to(dev)

    def go():
        with torch.inference_mode():
            for s in range(0, n, TEXT_BATCH):
                model(sub[s:s + TEXT_BATCH])

    ms = cuda_ms(torch, go, warmup=1, iters=3)
    rows = kernel_breakdown(torch, go)
    busy = sum(v for _k, v in rows)
    tflops = n * text_flops(TEXT_B) / (ms * 1e-3) / 1e12
    print(f"[time] text encode, TEXT_B f32 at batch {TEXT_BATCH}: "
          f"{len(texts)} titles in {wall:.3f} s, {len(texts) / wall:.1f} "
          f"texts/s through embed_texts (tokenizing alone {t_tok:.3f} s); "
          f"the tower alone on {n} titles {n / ms * 1e3:.1f} texts/s "
          f"({ms:.2f} ms, {tflops:.1f} TFLOP/s of f32 products), "
          f"torch.profiler {busy:.2f} ms busy ({100 * busy / ms:.1f}%): "
          + "; ".join(f"{v:.2f} ms {k[:60]}" for k, v in rows[:4])
          + f" {label}")
    del model, sub


def hf_load_times(torch, dev, label: str) -> None:
    """ViT-B/16 from the HF directories: read and convert
    (load_hf_clip_params), then load_state_dict into the serving tower and
    the copy to the card; the files were just written (a warm read)."""
    from patent_tpu_torch.models.clip_import import (SAFETENSORS_FILE,
                                                     TORCH_FILE,
                                                     hf_weight_file,
                                                     load_hf_clip_params)
    from patent_tpu_torch.models.vit import VIT_B16, VisionTransformer

    model = VisionTransformer(VIT_B16, dtype=torch.float32)
    for where, fmt in ((HF_DIR, SAFETENSORS_FILE), (HF_BIN_DIR, TORCH_FILE)):
        mb = os.path.getsize(hf_weight_file(where)) / 2**20
        t0 = time.perf_counter()
        sd = load_hf_clip_params(where, VIT_B16)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.load_state_dict(sd)
        model.to(dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        model.to("cpu")
        print(f"[time] HF CLIP load, ViT-B/16 from {fmt} ({mb:.0f} MiB with "
              f"the text tower, warm read): read and convert {t_read:.3f} s, "
              f"load_state_dict and the copy to the card {t_load:.3f} s "
              f"{label}")


# The bucket stage at the query counts its tiles take: one query, a ragged
# tile, past one tile of 128 (a bucket group's later tiles reading its
# slices from L2), the serving batch and three tiles
TOPK_QUERY_COUNTS = (1, 3, 65, 256, 300)
# exact copies of row TIE_ROW in its bucket, 1 and 300 steps of 1,024 rows
# later: the earlier copy must win, then the next
TIE_ROW, TIE_STEPS = 1976, (1, 300)


# ---- multi-GPU (patent_tpu_torch/parallel): worlds of ranks on this card

MG_DIR = os.path.join(ROOT, "build", "chip_smoke_multigpu")
# (a) one NCCL rank: every sharded search against the one-process index
MG_SEARCH_ONE = dict(n=200_000, d=512, poincare_d=128, queries=64, k=10,
                     c=2.0)
# (b) two gloo ranks sharing the card: 500k rows a rank
MG_SEARCH_TWO = dict(n=1_000_000, d=512, poincare_d=128, queries=256, k=10,
                     c=2.0)
MG_FT_PAIRS = 16                 # a rank; one process takes 32
# the sharded fine-tune step against one process at twice the batch:
# metrics within STEP_METRIC_REL_TOL; each trained tower leaf's update at
# cosine MG_FT_MIN_UPDATE_COS or more with the one-process update (AdamW's
# first step turns the sign of a gradient component near zero, which the
# batch split decides, into ±lr_clip, so the largest gap is printed in
# units of lr_clip and not gated)
MG_FT_MIN_UPDATE_COS = 0.9
# the sharded train_hyp step against one process, (loss relative, metrics
# relative, every updated leaf absolute): on the CLI corpus at the CPU
# tests' widths, their tolerances (tests/test_torch_sharded_train.py); at
# the main path's size (HypTrainConfig's model over the 2018-scale label
# table) tolerances measured on the card at that size (PERF.md, PR 19)
MG_HYP_TOL = {"cli": (1e-6, 1e-5, 1e-7), "2018": (1e-6, 1e-5, 1e-7)}
MG_HYP_CASES = (("md1", 1, False), ("md2", 2, False), ("drop", 2, True))
# At the 2018 size the one-process step is itself sensitive: its first
# layer saturates at the projection radius on the trainer's features, and
# Adam's first step turns the sign of a near-zero gradient component into
# +-lr, so features 2 ulp apart move the loss by ~1e-6 relative, the
# retrieval loss by ~3e-5 and an encoder leaf by up to 2 lr
# (mg_hyp_yardstick, printed beside).  Where the batch is split over data
# (md1) each rank encodes half of it at another GEMM tiling, and the step
# is held to tolerances measured at that size on the card (PERF.md, PR
# 19): loss, metrics (grad_norm among them) relative; the label table's
# leaf; every encoder leaf within MG_HYP_SPLIT_LR x lr (Adam's bound).
MG_HYP_SPLIT_TOL = (1e-5, 2e-4, {"label_emb": 1e-3})
MG_HYP_SPLIT_LR = 2.5
# the kernel each sharded search must launch
MG_SEARCH_KERNEL = {
    "cosine": "bucket_topk_bf16", "quantized": "bucket_topk_int8",
    "poincare": "bucket_topk_poincare", "sharded_topk_search": None,
    "sharded_topk_search_cosine_fast": "bucket_topk_bf16",
    "sharded_topk_search_quantized": "bucket_topk_int8",
    "sharded_topk_search_poincare_fast": "bucket_topk_poincare"}


def mg_hyp_args(np, torch) -> tuple:
    """hyp_train_world's arguments: the CLI's synthetic corpus (features
    scaled by 0.1, as the CPU tests), one batch of 32, a seeded model with
    an odd label table, and the three cases."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.train.cli_hyperbolic import ensure_training_data
    from patent_tpu_torch.train.train_hyp import (PackedSupervision,
                                                  stack_epoch_batches)

    td = ensure_training_data(MG_DIR, True)
    packed = PackedSupervision(td)
    arrays = tuple(a[0] for a in stack_epoch_batches(
        packed, np.arange(len(packed.usable)), 32, 1,
        np.random.default_rng(0)))
    mk = dict(feature_dim=td.x_figures.shape[1], embed_dim=16,
              label_num=td.num_labels | 1, hidden_dims=(32,), c=2.0)
    state = {k: v.numpy() for k, v in HyperbolicEmbeddingModel(
        **mk, generator=torch.Generator().manual_seed(0)
    ).state_dict().items()}
    data = {"x_figures": td.x_figures * np.float32(0.1),
            "implication": td.implication,
            "exclusion": np.zeros((0, 2), np.int32), "batch": arrays}
    return (data, state, mk,
            dict(embed_dim=16, hidden_dims=(32,), curvature=2.0,
                 batch_size=32, learning_rate=6e-3), MG_HYP_CASES)


def mg_hyp_2018_args(np, torch, td) -> tuple:
    """hyp_train_world's arguments at the main path's size: the
    HypTrainConfig model (512 -> 256 -> 128, c = 2) from seeded weights
    over the hyperbolic slice's label table (``td``, 16,074 labels for
    DeepPatent 2018's 16,059 patents), its features and exclusions as the
    trainer reads them, one batch of HypTrainConfig's 128."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.train.train_hyp import (PackedSupervision,
                                                  stack_epoch_batches)
    from patent_tpu_torch.utils.config import HypTrainConfig

    cfg = HypTrainConfig()
    arrays = tuple(a[0] for a in stack_epoch_batches(
        PackedSupervision(td), np.arange(cfg.batch_size), cfg.batch_size,
        cfg.num_neg_samples, np.random.default_rng(0)))
    mk = dict(feature_dim=td.x_figures.shape[1], embed_dim=cfg.embed_dim,
              label_num=td.num_labels, hidden_dims=cfg.hidden_dims,
              c=cfg.curvature)
    state = {k: v.numpy() for k, v in HyperbolicEmbeddingModel(
        **mk, generator=torch.Generator().manual_seed(2018)
    ).state_dict().items()}
    data = {"x_figures": td.x_figures, "implication": td.implication,
            "exclusion": np.asarray(td.exclusion).reshape(-1, 2),
            "batch": arrays}
    return (data, state, mk, dict(learning_rate=cfg.learning_rate),
            MG_HYP_CASES)


def mg_hyp_yardstick(torch, np, args, dev) -> tuple:
    """(metrics' relative gaps, {leaf: largest gap}) between two
    one-process train_hyp steps on ``dev`` from ``args``'s state
    (``mg_hyp_2018_args``), one on the features and one on them with
    each element moved by 2 ulp, up or down at random (seeded): the
    unstructured rounding a GEMM of another tiling leaves."""
    from patent_tpu_torch.models.hyperbolic import HyperbolicEmbeddingModel
    from patent_tpu_torch.train import train_hyp as th
    from patent_tpu_torch.train.optim import RiemannianAdam
    from patent_tpu_torch.utils.config import HypTrainConfig

    data, state, mk, cfg_kwargs, _cases = args
    cfg = HypTrainConfig(**cfg_kwargs, use_dropout=False)
    x = torch.as_tensor(data["x_figures"], device=dev)
    impl, excl = (torch.as_tensor(data[k], dtype=torch.long, device=dev)
                  for k in ("implication", "exclusion"))
    batch = tuple(torch.as_tensor(np.asarray(a)).to(
        dev, torch.float32 if i >= 4 else torch.long)
        for i, a in enumerate(data["batch"]))

    def step(xs):
        model = HyperbolicEmbeddingModel(**mk).to(dev)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               state.items()})
        opt = RiemannianAdam(dict(model.named_parameters()),
                             cfg.learning_rate, c=mk["c"])
        _grads, met = th.step_grads(model, opt, th.make_loss_fn(model, cfg),
                                    batch, xs, impl, excl)
        opt.step(_grads)
        return met.cpu().numpy(), {k: v.detach() for k, v in
                                   model.state_dict().items()}

    sign = torch.from_numpy(np.random.default_rng(22).choice(
        np.float32([-1.0, 1.0]), x.shape)).to(dev)
    (m0, p0), (m1, p1) = step(x), step(x * (1.0 + 2.0 ** -22 * sign))
    rel = np.abs(m1 - m0) / np.maximum(np.abs(m0), 1e-30)
    return rel, {k: float((p1[k] - p0[k]).abs().max()) for k in p0}


def mg_searches(out: dict, what: str, launches: dict) -> None:
    """Each search equal to the one-process index, its kernel launched on
    every rank; the launches recorded."""
    for mode, res in out.items():
        kname = MG_SEARCH_KERNEL[mode]
        per_rank = [r.get(kname, 0) if kname else 0 for r in res["launches"]]
        times = ("" if res.get("sharded_s") is None else
                 f", one search {1e3 * res['sharded_s']:.1f} ms sharded, "
                 f"{1e3 * res['one_s']:.1f} ms in one process")
        print(f"[slice] multi-GPU {what}: {mode} equal to the one-process "
              f"index: {res['equal']}; {kname or 'the scan'} launches by "
              f"rank {per_rank}{times}")
        check(res["equal"], f"{what}: {mode} differs from the one-process "
                            "index")
        if kname:
            check(all(n > 0 for n in per_rank),
                  f"{what}: {mode} did not launch {kname} on every rank")
        for counts in res["launches"]:
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n


def multi_gpu_slice(torch, np, launches: dict, label: str, td) -> None:
    """The multi-GPU phase: (a) a one-rank NCCL world, every sharded
    search equal to EmbeddingIndex.search; (b) two gloo ranks sharing the
    card (NCCL refuses two ranks on one device): the three sharded
    candidate paths at 1M rows, encode_sharded (bf16 and int8, global B
    128 and 6), the sharded fine-tune step at ViT-B/16 and the sharded
    train_hyp step (on the CLI corpus, and at HypTrainConfig's widths
    over the 2018-scale label table ``td``), each against one process.
    Two ranks on one card measure the collectives' cost, not scaling: no
    speed is claimed."""
    from patent_tpu_torch.parallel.launch import run_world

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_worlds import multi_gpu_world

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[slice] multi-GPU: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB of the card")
    a = run_world(1, multi_gpu_world, "cuda",
                  {"searches": MG_SEARCH_ONE, "direct": True},
                  device="cuda", timeout=300)
    check(a["backend"] == "nccl", f"world (a) ran on {a['backend']}")
    mg_searches(a["searches"], f"(a) {a['backend']}, 1 rank, "
                f"{MG_SEARCH_ONE['n']:,} rows", launches)
    print(f"[slice] multi-GPU (a) in {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    hyp_2018 = mg_hyp_2018_args(np, torch, td)
    b = run_world(2, multi_gpu_world, "cuda",
                  {"searches": MG_SEARCH_TWO, "encode": True,
                   "finetune": MG_FT_PAIRS,
                   "hyp": {"cli": mg_hyp_args(np, torch),
                           "2018": hyp_2018}},
                  backend="gloo", device="cuda", timeout=600)
    check(b["backend"] == "gloo" and b["ranks"] == 2,
          f"world (b): {b['backend']}, {b['ranks']} ranks")
    mg_searches(b["searches"], f"(b) gloo, 2 ranks on one card, "
                f"{MG_SEARCH_TWO['n']:,} rows (500k a rank)", launches)
    for case, res in b["encode"].items():
        tower, batch = case.split("_B")
        counts = [{k: v for k, v in r.items() if v} for r in res["launches"]]
        how = ("equal in bits" if res["bits"] else
               f"within the tower gate (min cosine {res['min_cos']:.7f}, "
               f"largest relative error {res['max_rel']:.2e})")
        print(f"[slice] multi-GPU (b) encode_sharded {tower} ViT-B/16, "
              f"global B {batch} over 2 ranks: {how} against one process; "
              f"launches by rank {counts}")
        check(res["bits"] or res["min_cos"] >= TOWER_MIN_COS,
              f"encode_sharded {case} differs from one process")
        ragged = tower == "int8" and int(batch) % 4
        want = ({"quant_layer_block", "quant_attention_cls",
                 "quant_mlp_block"} if ragged else
                {"quant_attention_block", "quant_attention_cls",
                 "quant_mlp_block"} if tower == "int8" else
                {"fused_layer_block_bf16", "fused_layer_cls_bf16"})
        if tower == "int8":     # the card's default form, counted apart too
            want |= {k + "_fast" for k in want}
        check(all(set(r) == want for r in counts),
              f"encode_sharded {case} took another function: {counts}")
        for r in res["launches"]:
            for k, n in r.items():
                launches[k] = launches.get(k, 0) + n
    ft = b["finetune"]
    metric_gaps = {k: abs(ft["sharded"][k] - v) / abs(v)
                   for k, v in ft["single"].items()}
    print(f"[slice] multi-GPU (b) fine-tune step, ViT-B/16 @224, 2 ranks x "
          f"{MG_FT_PAIRS} pairs against one process at "
          f"{2 * MG_FT_PAIRS}: metrics {ft['sharded']} vs {ft['single']} "
          f"(relative gaps {metric_gaps}); the trained tower's largest gap "
          f"{ft['gap_lr']:.3f} x lr_clip ({ft['gap_leaf']}), least update "
          f"cosine {ft['min_update_cos']:.5f} ({ft['min_cos_leaf']}); "
          f"launches by rank {ft['launches']} {label}")
    check(all(g <= STEP_METRIC_REL_TOL for g in metric_gaps.values()),
          f"sharded fine-tune metrics differ: {metric_gaps}")
    check(ft["min_update_cos"] >= MG_FT_MIN_UPDATE_COS,
          f"sharded fine-tune update cosine {ft['min_update_cos']}")
    check(all(n > 0 for r in ft["launches"] for n in r.values()),
          "a fine-tune kernel did not launch on every rank")
    for r in ft["launches"]:
        for k, n in r.items():
            launches[k] = launches.get(k, 0) + n
    yard_rel, yard_gaps = mg_hyp_yardstick(torch, np, hyp_2018,
                                           torch.device("cuda"))
    print(f"[slice] multi-GPU train_hyp yardstick, 2018 size, one process "
          f"on features 2 ulp apart: metrics' relative gaps "
          f"{yard_rel.tolist()}, leaves' gaps {yard_gaps}")
    for setting, cases in b["hyp"].items():
        for case, md, _drop in MG_HYP_CASES:
            loss_tol, metric_tol, leaf_tol = MG_HYP_TOL[setting]
            res = cases[case]
            single, sharded = res["single"], res["sharded"]
            rel = np.abs(sharded - single) / np.maximum(np.abs(single),
                                                        1e-30)
            gaps = {}
            for k, want in res["single_params"].items():
                got = res["sharded_params"][k]
                if k == "label_emb":
                    check(bool((got[res["real"]:] == 0).all()),
                          f"hyp {setting} {case}: padded label rows moved "
                          "off zero")
                    got = got[:res["real"]]
                gaps[k] = float(np.abs(got - want).max())
            gap_tol = dict.fromkeys(gaps, leaf_tol)
            split = setting == "2018" and md == 1
            if split:
                loss_tol, metric_tol, table_tol = MG_HYP_SPLIT_TOL
                lr = hyp_2018[3]["learning_rate"]
                gap_tol = {k: table_tol.get(k, MG_HYP_SPLIT_LR * lr)
                           for k in gaps}
            rel_tol = np.full(rel.shape, metric_tol)
            rel_tol[0] = loss_tol
            print(f"[slice] multi-GPU (b) train_hyp step {setting} {case} "
                  f"(labels {res['real']}→{res['padded']}, blocks "
                  f"{res['block_rows']}): loss {sharded[0]:.6f} vs "
                  f"{single[0]:.6f}, metrics' relative gaps "
                  f"{rel.tolist()}, leaves' gaps {gaps}"
                  + (" (the split tolerances)" if split else ""))
            check(bool((rel <= rel_tol).all())
                  and all(gaps[k] <= gap_tol[k] for k in gaps),
                  f"sharded train_hyp {setting} {case} differs from one "
                  "process")
    print(f"[slice] multi-GPU (b) in {time.perf_counter() - t0:.1f} s "
          f"(searches {b['searches_s']:.1f}, encode {b['encode_s']:.1f}, "
          f"fine-tune {b['finetune_s']:.1f}, train_hyp {b['hyp_s']:.1f}); "
          f"[slice] multi-GPU phase: {time.perf_counter() - t_phase:.1f} s")


# ---- the retrieval server (patent_tpu_torch/retrieval/server.py)

# the service answers a request from a padded batch (rows and k to powers
# of two, others' rows beside it), index.search from the request alone:
# the same candidates, f32 re-rank dots over other batch shapes, so the
# scores may differ in their last bits
SERVE_SCORE_TOL = 1e-6
# a gallery image served by image_path against its own stored row: the
# same tower on a batch of 32 either way
SERVE_SELF_MIN_COS = 0.999


def http_json(url: str, payload=None, timeout: float = 120.0):
    """(status, JSON body) of a GET (payload None) or of a POST of payload
    (JSON, or raw bytes)."""
    import urllib.error
    import urllib.request

    data = (None if payload is None else payload
            if isinstance(payload, bytes) else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranked(index, q, k: int) -> list:
    """index.search's answer as the server names it: per query row, the
    gallery basenames and the scores."""
    vals, idx = index.search(q, k=k)
    return [([os.path.basename(index.names[j]) for j in ri], rv.tolist())
            for ri, rv in zip(idx, vals)]


def answers(body: dict) -> list:
    """A /search answer as ranked() gives one."""
    return [([r["name"] for r in row], [r["score"] for r in row])
            for row in body["results"]]


def answer_gap(got: list, want: list) -> float:
    """The largest score difference of two answers with the same names in
    the same order; inf when a name or the count differs."""
    if len(got) != len(want):
        return math.inf
    gap = 0.0
    for (gn, gs), (wn, ws) in zip(got, want):
        if gn != wn:
            return math.inf
        gap = max(gap, max(abs(a - b) for a, b in zip(gs, ws)))
    return gap


def clients(n_threads: int, per_thread: int, ask) -> tuple[list, float]:
    """``ask(i)`` for requests 0 .. n_threads * per_thread - 1, thread t
    asking t * per_thread + r in turn: (the answers in request order, the
    seconds the whole run took)."""
    import threading

    got: list = [None] * (n_threads * per_thread)
    errs: list = []

    def client(t):
        try:
            for r in range(per_thread):
                i = t * per_thread + r
                got[i] = ask(i)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(not errs and all(g is not None for g in got),
          f"a client failed or stalled: {errs[:1]}")
    return got, seconds


def serve_slice(np, run_serve_action, parse_args, flags: list[str],
                tag: str) -> None:
    """The serve action over the slice's corpus, in this process through the
    helper the CLI calls (block=False): /healthz and /stats; features of
    three gallery rows, each top-1 itself, equal to index.search; a name
    and an image_path query of gallery files, each top-1 itself; 8
    concurrent clients x 8 requests, each answer equal to the same request
    served alone; a malformed body gets 400."""
    server = run_serve_action(parse_args(["serve", "--path", RUN_DIR,
                                          "--port", "0"] + flags),
                              block=False)
    service = server.RequestHandlerClass.service
    index = service.engine.index
    host, port = server.server_address
    base = f"http://{host}:{port}"
    try:
        n = len(index)
        st, health = http_json(base + "/healthz")
        st2, stats = http_json(base + "/stats")
        check(st == st2 == 200 and health == {"status": "ok",
                                              "gallery_size": n}
              and stats["gallery_size"] == n and stats["dim"] == 512
              and stats["sharded"] is False and stats["image_size"] == 224,
              f"serve {tag}: /healthz {health} or /stats {stats}")
        rows = [0, n // 2, n - 1]
        q = index.embeddings[rows].cpu().numpy()
        st, body = http_json(base + "/search", {"features": q.tolist(),
                                                "k": 10})
        got = answers(body) if st == 200 else []
        # the server's own dispatch: 3 rows padded to 4, k to 16
        padded = np.concatenate([q, np.zeros((1, q.shape[1]), np.float32)])
        exact = [(names[:10], scores[:10]) for names, scores in
                 ranked(index, padded, 16)[:3]]
        alone_gap = answer_gap(got, ranked(index, q, 10))
        selves = [os.path.basename(index.names[r]) for r in rows]
        check(st == 200 and got == exact and alone_gap <= SERVE_SCORE_TOL
              and [names[0] for names, _s in got] == selves,
              f"serve {tag}: features of gallery rows {rows} answered "
              f"{got[:1]}, not index.search's (gap {alone_gap})")
        name = os.path.basename(index.names[7])
        st, body = http_json(base + "/search", {"name": name, "k": 10})
        by_name = answers(body)[0] if st == 200 else ([], [])
        st2, body = http_json(base + "/search", {"image_path": name,
                                                 "k": 10})
        by_path = answers(body)[0] if st2 == 200 else ([], [])
        check(st == st2 == 200 and by_name[0][:1] == by_path[0][:1] == [name]
              and by_name[1][0] > SERVE_SELF_MIN_COS
              and by_path[1][0] > SERVE_SELF_MIN_COS,
              f"serve {tag}: {name} by name {by_name} or by image_path "
              f"{by_path} is not top-1 itself")
        rng = np.random.default_rng(15)
        qs = index.embeddings[rng.choice(n, 64, replace=False)].cpu().numpy()
        qs = qs + 0.05 * rng.standard_normal(qs.shape).astype(np.float32)

        def ask(i):
            st, body = http_json(base + "/search",
                                 {"features": [qs[i].tolist()], "k": 10})
            check(st == 200, f"serve {tag}: request {i} got {st}: {body}")
            return answers(body)

        alone = [ask(i) for i in range(64)]
        d0, r0 = service.batcher.dispatches, service.batcher.requests
        together, _s = clients(8, 8, ask)
        dispatches = service.batcher.dispatches - d0
        gap = max(answer_gap(a, b) for a, b in zip(together, alone))
        bad = [http_json(base + "/search", b"not json")[0],
               http_json(base + "/search", {"features": [[0.0] * 8]})[0],
               http_json(base + "/search", {"k": "x", "name": name})[0]]
        print(f"[slice] serve {tag} over {n} gallery rows: /healthz and "
              f"/stats; features of rows {rows} top-1 themselves, equal to "
              f"index.search (score gap {alone_gap:.3g}); "
              f"{name} by name and by image_path top-1 at {by_name[1][0]:.6f}"
              f" / {by_path[1][0]:.6f}; 8 clients x 8 requests in "
              f"{dispatches} dispatches ({service.batcher.requests - r0} "
              f"requests), each equal to itself alone (score gap {gap:.3g}); "
              f"malformed bodies {bad}")
        check(gap <= SERVE_SCORE_TOL and dispatches < 64
              and bad == [400, 400, 400],
              f"serve {tag}: concurrent answers differ from alone ({gap}), "
              f"no coalescing ({dispatches} dispatches) or a malformed body "
              f"not refused ({bad})")
    finally:
        server.shutdown()
        server.server_close()
        service.engine.close()


def cli_server() -> None:
    """``python -m patent_tpu_torch.cli serve`` as a process of its own on a
    free port over the slice's corpus: it must answer /healthz and a search
    by a stored name; it is terminated in any case."""
    port = free_port()
    log = os.path.join(ROOT, "build", "chip_smoke_serve.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "patent_tpu_torch.cli", "serve", "--path",
             RUN_DIR, "--port", str(port)], cwd=ROOT, stdout=fh,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=ROOT))
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    try:
        health = None
        while health is None and time.perf_counter() - t0 < 300:
            check(proc.poll() is None, f"the serve process exited "
                  f"({proc.returncode}): {open(log).read()[-2000:]}")
            try:
                health = http_json(base + "/healthz", timeout=5)
            except OSError:
                time.sleep(1.0)
        check(health is not None and health[0] == 200,
              f"the serve process did not answer /healthz: {health}")
        up = time.perf_counter() - t0
        name = sorted(os.listdir(os.path.join(RUN_DIR, "test_gallery")))[0]
        st, body = http_json(base + "/search", {"name": name, "k": 5})
        top = answers(body)[0][0] if st == 200 else body
        print(f"[slice] python -m patent_tpu_torch.cli serve --port {port}: "
              f"/healthz {health[1]} after {up:.1f} s; a search by name "
              f"{name} answered {st}: {top}")
        check(st == 200 and top[0] == name and len(top) == 5,
              "the serve process did not answer a search")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def served_qps(torch, np, dev, gen, serve, RetrievalEngine, EmbeddingIndex,
               label: str, n: int, d: int, k: int) -> None:
    """Served top-k QPS on an n x d bf16-path index: 16 client threads x 32
    single-row requests in this process (RetrievalService.search) and
    through HTTP, beside a serialized loop of index.search, a dispatch a
    request; the dispatches and the mean rows a dispatch coalesced; a
    sample of answers held to index.search."""
    gal = torch.randn(n, d, generator=gen, device=dev)
    engine = RetrievalEngine(lambda b: b, dev, batch_size=32, image_size=224)
    engine.index = index = EmbeddingIndex(gal, [f"g{i}.png"
                                                for i in range(n)], device=dev)
    rng = np.random.default_rng(5)
    pick = rng.choice(n, 512, replace=False)
    qs = (gal[torch.from_numpy(pick).to(dev)].cpu().numpy()
          + 0.3 * rng.standard_normal((512, d)).astype(np.float32))
    del gal
    index.search(qs[:1], k=k)          # the bf16 candidate copy, once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [index.search(qs[i:i + 1], k=k) for i in range(512)]
    serial_s = time.perf_counter() - t0
    server = serve(engine, port=0, block=False)
    service = server.RequestHandlerClass.service
    base = "http://{}:{}".format(*server.server_address)
    runs = {}
    try:
        for how, ask in (
                ("in-process", lambda i: answers(service.search(
                    {"features": [qs[i].tolist()], "k": k}))),
                ("HTTP", lambda i: answers(http_json(
                    base + "/search",
                    {"features": [qs[i].tolist()], "k": k})[1]))):
            ask(0)                    # warm-up
            d0, r0 = service.batcher.dispatches, service.batcher.requests
            got, seconds = clients(16, 32, ask)
            runs[how] = (got, seconds, service.batcher.dispatches - d0,
                         service.batcher.requests - r0)
    finally:
        server.shutdown()
        server.server_close()
    sample = range(0, 512, 37)
    want = {i: [([f"g{j}.png" for j in serial[i][1][0]],
                 serial[i][0][0].tolist())] for i in sample}
    gaps = {how: max(answer_gap(run[0][i], want[i]) for i in sample)
            for how, run in runs.items()}
    print(f"[time] served top-{k} QPS at {n} x {d} (bf16 candidate path), "
          "16 client threads x 32 single-row requests: " + "; ".join(
              f"{how} {512 / s:.0f} QPS ({s:.3f} s, {disp} dispatches for "
              f"{req} requests, {req / disp:.2f} rows a dispatch)"
              for how, (_g, s, disp, req) in runs.items())
          + f"; serialized index.search loop {512 / serial_s:.0f} QPS "
          f"({serial_s:.3f} s, 512 dispatches); {len(sample)} sampled "
          f"answers vs index.search: score gap {gaps} {label}")
    check(all(g <= SERVE_SCORE_TOL for g in gaps.values()),
          f"served answers differ from index.search: {gaps}")


def near_tie_columns(torch, got, want, scores) -> tuple[int, bool]:
    """(columns of ``got`` that differ from ``want``'s, whether each such
    column's score under the plain version's ``scores`` [Q, N] lies within
    TOPK_VALUE_TOL of the value ``want`` holds there: a tie within the
    noise of two f32 summation orders, which either column answers)."""
    n_diff, ok = 0, True
    for gi, wi, wv in ((got[1], want[1], want[0]), (got[3], want[3],
                                                    want[2])):
        diff = gi != wi
        n_diff += int(diff.sum())
        if diff.any():
            alt = scores.gather(1, gi.long())[diff]
            ok = ok and float((alt - wv[diff]).abs().max()) <= TOPK_VALUE_TOL
    return n_diff, ok


def live_candidates(torch, top2) -> int:
    """The fewest (query's) candidates that the top-2 lists hold."""
    return int(((top2[0] > float("-inf")).sum(1)
                + (top2[2] > float("-inf")).sum(1)).min())


def check_bucket_shapes(torch, tk, index_mod, gal, dev, k: int) -> float:
    """Rows 3 and 3′ at every count of TOPK_QUERY_COUNTS over the first
    1,000 rows of ``gal`` and over all of it, with rows masked out (bf16:
    valid 0; int8: scale 0 or negative) and planted ties: int8 (v1, i1,
    v2, i2) equal to the plain version's; bf16 values within
    TOPK_VALUE_TOL and columns equal but at ties within it; the capacity
    min(valid rows, 2L); the planted tie to the earlier copy; at Q 256 the
    re-ranked top-k equal to the scan.  Then the controls on the int8
    scores, which must fail: a fold with '>=' (the tie check) and one that
    drops a step (the check of the 2L-deep pool).  Returns the bf16 stage's
    max-abs value error."""
    bgen = torch.Generator(device=dev).manual_seed(13)
    L, err16 = tk.BUCKETS, 0.0
    for m in TIE_STEPS:
        gal[TIE_ROW + m * L] = gal[TIE_ROW]
    for n in (1000, gal.shape[0]):
        g = gal[:n]
        tie = min(TIE_ROW, n - 1)
        g16, gvalid = tk.prepare_cosine_gallery_bf16(g)
        gi8, gscale = (torch.from_numpy(a).to(dev) for a in
                       tk.quantize_gallery(g.cpu().numpy()))
        clean = (gvalid.clone(), gscale.clone())
        gvalid[::97] = 0.0
        gscale[::97] = 0.0
        gscale[5::101] = -1.0
        n_live = (int((gvalid > 0).sum()), int((gscale > 0).sum()))
        for nq in TOPK_QUERY_COUNTS:
            q = torch.randn(nq, g.shape[1], generator=bgen, device=dev)
            q[0] = g[tie]
            q16 = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
            top2 = tk._bucket_top2_cuda(q16.contiguous(), g16, gvalid)
            want = tk.bucket_top2_plain(q16, g16, gvalid)
            qi8, _qs = tk.quantize_queries(q)
            top8 = tk._bucket_top2_cuda(qi8, gi8, gscale)
            want8 = tk.bucket_top2_int8_plain(qi8, gi8, gscale)
            torch.cuda.synchronize()
            # empty slots (-inf) in the same places, values alike elsewhere
            err = max(float(torch.where(torch.isfinite(b), a - b, 0.0)
                            .abs().max())
                      if bool(torch.equal(torch.isinf(a), torch.isinf(b)))
                      else float("inf")
                      for a, b in zip(top2[::2], want[::2]))
            err16 = max(err16, err)
            scores = (q16.float() @ g16.float().T).masked_fill(
                gvalid <= 0, float("-inf"))
            n_diff, ties_ok = near_tie_columns(torch, top2, want, scores)
            equal8 = all(bool(torch.equal(a, b)) for a, b in zip(top8, want8))
            cap = (live_candidates(torch, top2), live_candidates(torch, top8))
            tied = [int(t[1][0, tie % L]) for t in (top2, top8)]
            print(f"[kernel] bucket stage n={n}, Q={nq}: bf16 values vs "
                  f"plain max_abs_err {err:.3g}, {n_diff} columns differ "
                  f"(each a tie within {TOPK_VALUE_TOL}: {ties_ok}); int8 "
                  f"(v1, i1, v2, i2) equal to plain: {equal8}; candidates "
                  f"a query {cap} (capacities "
                  f"{[min(c, 2 * L) for c in n_live]}); planted "
                  f"tie to column {tied} (want {tie})")
            check(err <= TOPK_VALUE_TOL and ties_ok and equal8
                  and list(cap) == [min(c, 2 * L) for c in n_live]
                  and tied == [tie, tie],
                  f"bucket stage check failed at n={n}, Q={nq}")
        # the re-ranked top-k of both paths against the scan, at the
        # serving batch, on the unmasked gallery
        q = torch.randn(256, g.shape[1], generator=bgen, device=dev)
        sv, si = index_mod.topk_search(q, g, k=k)
        fv, fi = index_mod.topk_search_cosine_fast(q, g16, clean[0], g, k=k)
        qv, qi = index_mod.topk_search_quantized(q, gi8, clean[1], g, k=k)
        torch.cuda.synchronize()
        exact = (bool(torch.equal(fi, si)), bool(torch.equal(qi, si)))
        print(f"[kernel] bucket stage n={n}, Q=256: re-ranked top-{k} == "
              f"scan (bf16, int8): {exact}")
        check(all(exact), f"re-ranked top-{k} differs from the scan at "
              f"n={n}")
    # the controls, on the int8 scores over the whole gallery: '>=' keeps
    # the later copy of the planted tie; a dropped step loses candidates
    q = torch.randn(65, gal.shape[1], generator=bgen, device=dev)
    q[0] = gal[TIE_ROW]
    qi8, _qs = tk.quantize_queries(q)
    scores = (tk.int_mm(qi8, gi8) * gscale).masked_fill(
        gscale <= 0, float("-inf"))
    got = tk._bucket_top2_cuda(qi8, gi8, gscale)
    ties = tk.bucket_top2_walk(scores, L, strict=False)
    dropped = tk.bucket_top2_walk(scores, L, skip=TIE_STEPS[1])

    def pool(top2):
        return tk._select_pool(*top2, 2 * L)[1].sort(dim=1).values

    tie_ok = [int(t[1][0, TIE_ROW % L]) == TIE_ROW for t in (got, ties)]
    pool_ok = [bool(torch.equal(pool(t), pool(tk.bucket_top2_int8_plain(
        qi8, gi8, gscale)))) for t in (got, dropped)]
    print(f"[kernel] bucket stage controls at n={gal.shape[0]}, Q=65: tie "
          f"check (kernel, '>=' fold) {tie_ok}; 2L pool check (kernel, "
          f"step {TIE_STEPS[1]} dropped) {pool_ok}")
    check(tie_ok == [True, False] and pool_ok == [True, False],
          "the bucket stage's checks cannot tell a wrong fold from a right "
          "one")
    return err16


def int8_family_slice(torch, qm, tower8, int8_dense, px2, heads, run_path,
                      form: str) -> None:
    """The int8 family's public entries on ViT-B/16 tokens, in the form
    PATENT_TPU_FAST_KERNELS names (``form`` says which): layers 0..10 of
    ``tower8`` as quant_layer_group(group=2) at batch 2 (row 9: row 8's
    kernel), then int8_dense (row 10) and quant_mlp (row 11) with layer
    0's weights on the stack's output; the stack equal in bits to the
    quant_layer_block stack, rows 10 and 11 within their gate of their
    plain versions."""
    fam = {}

    def family():
        with torch.inference_mode():
            xt, seq = tower8.embed(px2)
            fam["x0"] = xt
            for layer in tower8.blocks[:-1]:
                xt = qm.quant_layer_group(xt, *layer.attn_weights(),
                                          *layer.mlp_weights(), heads,
                                          valid_len=seq, group=2)
            l0 = tower8.blocks[0]
            fam.update(x=xt, seq=seq, qkv=int8_dense(xt, l0.wqkv_t, l0.sqkv,
                                                     l0.bqkv),
                       mlp=qm.quant_mlp(xt, *l0.mlp_weights()[2:]))

    run_path(f"int8 family entries, {form}: 11 x quant_layer_group(group=2) "
             "at batch 2, int8_dense and quant_mlp on its output",
             (qm.quant_layer_group, qm.quant_dense, qm.quant_mlp), family)
    with torch.inference_mode():
        ref = fam["x0"]
        for layer in tower8.blocks[:-1]:
            ref = qm.quant_layer_block(ref, *layer.attn_weights(),
                                       *layer.mlp_weights(), heads,
                                       valid_len=fam["seq"])
        l0 = tower8.blocks[0]
        dense_gap = layer_gap(torch, fam["qkv"], qm.quant_dense_plain(
            fam["x"], l0.wqkv_t, l0.sqkv, l0.bqkv))
        mlp_gap = layer_gap(torch, fam["mlp"], qm.quant_mlp_plain(
            fam["x"], *l0.mlp_weights()[2:]))
    torch.cuda.synchronize()
    print(f"[slice] {form}: the quant_layer_group stack equals the "
          f"quant_layer_block stack bit for bit: "
          f"{bool(torch.equal(ref, fam['x']))}; on its output int8_dense vs "
          f"plain rel err {dense_gap[0]:.3g}, quant_mlp {mlp_gap[0]:.3g}")
    check(bool(torch.equal(ref, fam["x"]))
          and layer_passes(dense_gap, INT8_REL_TOL, INT8_MAX_ULPS)
          and layer_passes(mlp_gap, INT8_REL_TOL, INT8_MAX_ULPS),
          f"the int8 family's entries disagree on the tower's tokens ({form})")


def main() -> None:
    t_run = time.perf_counter()
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
    from patent_tpu_torch.cli.main import parse_args
    from patent_tpu_torch.models.clip_import import load_hf_clip_params
    from patent_tpu_torch.models.vit import VIT_B16, VisionTransformer
    from patent_tpu_torch.models.vit_int8 import (Int8VisionTransformer,
                                                  int8_dense)
    from patent_tpu_torch.input.pipeline import ImageBatcher, list_images
    from patent_tpu_torch.models.weights import params_to_jax
    from patent_tpu_torch.data.synthetic import write_synthetic_corpus
    from patent_tpu_torch.ops import bf16_layer, topk_kernel
    from patent_tpu_torch.ops import bf16_mlp_grad as mm
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.ops import quant_matmul as qm
    from patent_tpu_torch.train.finetune_clip import (init_finetune_state,
                                                      make_finetune_step)
    from patent_tpu_torch.utils.config import ClipFinetuneConfig
    from patent_tpu_torch.retrieval import index as index_mod
    from patent_tpu_torch.retrieval.engine import (
        RetrievalEngine, device_normalize, make_device_normalizing_encoder)
    from patent_tpu_torch.retrieval.cli_actions import (run_serve_action,
                                                        select_device,
                                                        write_synthetic_split)
    from patent_tpu_torch.retrieval.server import serve
    from patent_tpu_torch.utils import checkpoint

    # ---- 1. device
    dev = select_device("cuda")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {device_name}; {torch.cuda.device_count()} card(s); "
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
    print(f"[phase] 3. kernels from {time.perf_counter() - t_run:.0f} s")
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
        # the int8 kernels in both forms (the fast form's errors under
        # <name>_fast), on the same inputs
        for kname, ip in (("quant_attention_block", ip_attn),
                          ("quant_attention_cls", ip_attn),
                          ("quant_mlp_block", ip_mlp)):
            for fast in (False, True):
                key = kname + "_fast" * fast
                errs[key] = max(errs.get(key, 0.0), check_int8(
                    torch, qm, kname, x, ip, heads, v, fast=fast))
        # each CLS kernel runs row 0's operations of its full kernel in the
        # same order, so it equals row 0 bit for bit
        for full, cls, args, kw in (
                (bf16_layer.fused_layer_block_bf16,
                 bf16_layer.fused_layer_cls_bf16, p, {}),
                (qm.quant_attention_block, qm.quant_attention_cls, ip_attn,
                 {"fast": False}),
                (qm.quant_attention_block, qm.quant_attention_cls, ip_attn,
                 {"fast": True})):
            got = full(x, *args, heads, v, **kw)
            got_c = cls(x, *args, heads, v, **kw)
            torch.cuda.synchronize()
            check(got_c.shape == (b, d) and bool(torch.equal(got_c, got[:, 0])),
                  f"{cls.__name__} {kw} differs from row 0 of "
                  f"{full.__name__} (valid {v})")
    # row 6 at the CLS call's batches of the int8 tower (B % 4 == 0): 4 and
    # a batch of 128's, on a generator of its own, in both forms
    cgen = torch.Generator(device=dev).manual_seed(6)
    for bv in (4, 128):
        x = layer_input(torch, bv, s, d, valid, cgen, dev)
        for fast in (False, True):
            got = qm.quant_attention_block(x, *ip_attn, heads, valid,
                                           fast=fast)
            got_c = qm.quant_attention_cls(x, *ip_attn, heads, valid,
                                           fast=fast)
            torch.cuda.synchronize()
            check(bool(torch.equal(got_c, got[:, 0])), "quant_attention_cls "
                  f"differs from row 0 of quant_attention_block at B {bv}, "
                  f"{form_name(fast)}")
    print("[kernel] fused_layer_cls_bf16 equals row 0 of "
          "fused_layer_block_bf16, and quant_attention_cls row 0 of "
          "quant_attention_block (also at B 4 and 128) in both forms, bit "
          "for bit")
    # row 5 (and its CLS row) at CLIP ViT-L/14 @336's stream, [4, 592,
    # 1,024] with 577 valid keys: the tile past its ring (stream_kernel),
    # in both forms, on a generator of its own
    lgen = torch.Generator(device=dev).manual_seed(336)
    wide_attn, _wide_mlp = int8_params(torch, qm, 1024, 4096, lgen, dev)
    xw = layer_input(torch, 4, 592, 1024, 577, lgen, dev)
    for fast in (False, True):
        for kname in ("quant_attention_block", "quant_attention_cls"):
            key = kname + "_fast" * fast
            errs[key] = max(errs.get(key, 0.0), check_int8(
                torch, qm, kname, xw, wide_attn, 16, 577, fast=fast))
    del xw, wide_attn, _wide_mlp

    # the whole int8 layer (row 8) at the int8 tower's ragged batches, its
    # group dispatch (row 9) on both of its paths, the int8 dense layer (row
    # 10) at a batch of 128's QKV and MLP-in shapes and on f32 rows, and the
    # int8 MLP (row 11), on a generator of their own
    igen = torch.Generator(device=dev).manual_seed(8)
    ip = (*ip_attn, *ip_mlp)
    forms = (("", False), ("_fast", True))
    for lname, batches, kw in (("quant_layer_block", (1, 3, 127), {}),
                               ("quant_layer_group", (2, 3), {"group": 2})):
        for bv in batches:
            x = layer_input(torch, bv, s, d, valid, igen, dev)
            for sfx, fast in forms:
                errs[lname + sfx] = max(errs.get(lname + sfx, 0.0),
                                        check_int8_layer(
                    torch, qm, lname, x, ip, heads, valid, fast=fast, **kw))
    x2 = layer_input(torch, 128, s, d, valid, igen, dev).reshape(-1, d)
    m = x2.shape[0]
    # row 10 at a batch of 128's QKV and MLP-in shapes, on f32 rows, at one
    # row, and at an odd output width (the wgmma epilogue stores the last
    # column alone): QKV's first 13 channels
    q13 = tuple(t[:13].contiguous() for t in ip_attn[2:5])
    dense_cases = (
        (f"[{m} x {d}] x [{d} x {3 * d}] bf16", x2, ip_attn[2:5], None),
        (f"[{m} x {d}] x [{d} x {f}] bf16, quick_gelu", x2, ip_mlp[2:5],
         "quick_gelu"),
        (f"[{3 * valid} x {d}] x [{d} x {f}] f32, quick_gelu",
         x2[:3 * valid].float(), ip_mlp[2:5], "quick_gelu"),
        (f"[1 x {d}] x [{d} x {3 * d}] bf16", x2[:1], ip_attn[2:5], None),
        (f"[{m} x {d}] x [{d} x 13] bf16, quick_gelu", x2, q13,
         "quick_gelu"),
        (f"[1 x {d}] x [{d} x 13] f32", x2[:1].float(), q13, None))
    # row 11 at a batch of 128's rows, at one row, and at an odd output
    # width: MLP out's first 13 channels
    w13 = (*ip_mlp[2:5], *(t[:13].contiguous() for t in ip_mlp[5:]))
    mlp_cases = ((f"[{m} x {d}], H {f}", x2, ip_mlp[2:]),
                 (f"[1 x {d}], H {f}", x2[:1], ip_mlp[2:]),
                 (f"[{m} x {d}], H {f}, N 13", x2, w13),
                 (f"[1 x {d}], H {f}, N 13", x2[:1], w13))
    for sfx, fast in forms:
        errs["quant_dense" + sfx] = max(
            check_int8_dense(torch, qm, tag, xv, *wv, act, fast=fast)
            for tag, xv, wv, act in dense_cases)
        errs["quant_mlp" + sfx] = max(
            check_int8_qmlp(torch, qm, tag, xv, wv, fast=fast)
            for tag, xv, wv in mlp_cases)
        # row 7 at the other rows the main path gives it: the CLS call at
        # M = B (1 and 3 at a ragged batch, 4 and 128 at B % 4 = 0) and a
        # batch of 128's tokens (the cases above hold B 16's 3,328); and its
        # MLP in alone, whose epilogue takes the hidden's row maxima
        for mv in (1, 3, 4, 128, m):
            errs["quant_mlp_block" + sfx] = max(
                errs["quant_mlp_block" + sfx], check_int8(
                    torch, qm, "quant_mlp_block", x2[:mv], ip_mlp, heads,
                    valid, fast=fast))
        for mv in (4, m):
            check_gelu_quant(torch, qm, x2[:mv], ip_mlp, fast=fast)
    del x2

    # the fine-tune's trainable blocks, on a generator of their own so that
    # the draws above and below stay those of the serving checks: at the
    # main path's shapes (64 pairs are 128 images: attention on the stream
    # padded to 208, the MLP on the 128 x 197 unpadded rows, which the
    # backward takes in several chunks), then with most keys pad, then
    # with scores past the clamp
    fgen = torch.Generator(device=dev).manual_seed(3)
    bt = 128
    for bv, v in ((bt, valid), (b, 96)):
        x = layer_input(torch, bv, s, d, v, fgen, dev)
        e12, e13 = check_train_attention(torch, fa, x, p, heads, v, fgen)
        errs["fused_attention_fwd"] = max(errs.get("fused_attention_fwd", 0.0),
                                          e12)
        errs["fused_attention_bwd"] = max(errs.get("fused_attention_bwd", 0.0),
                                          e13)
    _e, e13 = check_train_attention(torch, fa, x, p, heads, 96, fgen,
                                    saturate=True)
    errs["fused_attention_bwd"] = max(errs["fused_attention_bwd"], e13)
    x = layer_input(torch, bt, s, d, valid, fgen, dev)
    x2 = x[:, :valid].reshape(-1, d).contiguous()
    errs["fused_mlp_fwd"], errs["fused_mlp_bwd"] = check_train_mlp(
        torch, mm, x2, p, fgen)
    # row 15 at ragged row counts and at the CLIs' small tower's widths
    # (D 64, F 128: three images of 65 tokens), on a generator of its own
    mgen = torch.Generator(device=dev).manual_seed(15)
    small = (layer_input(torch, 3, 65, 64, 65, mgen, dev).reshape(-1, 64),
             layer_params(torch, 64, 128, mgen, dev))
    for xm, pm in ((x2[:64], p), (x2[:77], p), small):
        errs["fused_mlp_fwd"] = max(errs["fused_mlp_fwd"],
                                    check_mlp_fwd(torch, mm, xm, pm))
    del x, x2, small

    # row 14, the use_flash tower's attention, on a generator of its own:
    # the per-op stream's unpadded 197 tokens, 64 tokens, and scores past
    # the clamp
    agen = torch.Generator(device=dev).manual_seed(14)
    errs["flash_attention"] = max(
        check_flash(torch, fa, b, valid, heads, agen, dev),
        check_flash(torch, fa, b, 64, heads, agen, dev),
        check_flash(torch, fa, b, valid, heads, agen, dev,
                    gain=FLASH_SATURATING_GAIN))
    errs["flash_attention_f32"] = max(
        check_flash_f32(torch, fa, b, valid, heads, agen, dev),
        check_flash_f32(torch, fa, b, 64, heads, agen, dev))

    # rows 5 and 8's int8 GEMM alone, each of its five instances at one
    # image's rows, three images' and a batch of 128's, on a generator of
    # its own
    sgen = torch.Generator(device=dev).manual_seed(22)
    for epi, (gn, gk) in S8_GEMM_SHAPES.items():
        for gm in (s, 3 * s, 128 * s):
            check_s8_gemm(torch, qm, epi, gm, gn, gk, sgen, dev)
    # and its fast form's MLP-in instance (quick_gelu times the bf16
    # reciprocal), on a generator of its own
    fsgen = torch.Generator(device=dev).manual_seed(24)
    for gm in (s, 3 * s, 128 * s):
        check_s8_gemm(torch, qm, "gelu", gm, *S8_GEMM_SHAPES["gelu"], fsgen,
                      dev, fast=True)

    # the layer's GEMM alone, each of its four instances at a batch of
    # 128's rows and at B 2's ragged 416, on a generator of its own
    ggen = torch.Generator(device=dev).manual_seed(21)
    for epi, (gn, gk) in GEMM_SHAPES.items():
        for gm in (128 * s, 2 * s):
            check_layer_gemm(torch, bf16_layer, epi, gm, gn, gk, ggen, dev)

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
    err_topk = max(err_topk, check_bucket_shapes(torch, topk_kernel,
                                                 index_mod, gal, dev, k))
    del gal, g

    hyp = hyperbolic_kernel_checks(torch, dev, errs, HYP_SIZES)

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
    print(f"[phase] 4. the slices from {time.perf_counter() - t_run:.0f} s")
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

    def run_path(what, counters, run, record: bool = True):
        """Run one path with its kernels' counts set to 0 just before and
        read just after; every kernel of the path must have launched.  An
        int8 entry counts both forms, and its fast form apart
        (``<entry>_fast``), in the form PATENT_TPU_FAST_KERNELS names.
        ``record``: the counts are those of the kernels' main path."""
        fast = [fn.fast for fn in counters if hasattr(fn, "fast")]
        for fn in (*counters, *fast):
            fn.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        of_fast = {fn.__name__: fn.launches for fn in fast}
        print(f"[slice] {what} in {time.perf_counter() - t0:.1f} s; "
              f"launches {got}" + (f", of them in the fast form {of_fast}"
                                   if fast else ""))
        check(all(v > 0 for v in got.values()),
              f"a kernel of the path '{what}' was never launched")
        if record:
            for kname, n in (*got.items(), *of_fast.items()):
                launches[kname] = launches.get(kname, 0) + n

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

    def profile_slice():
        """eval --profile recommended: int8, the 175 darkest patches."""
        check(cli(["eval", "--path", RUN_DIR, "--model", "GE_kt175",
                   "--profile", "recommended"]) == 0,
              "eval --profile recommended failed")
        npys = glob.glob(os.path.join(RUN_DIR, "embeddings",
                                      "*_torch_int8_kt175_ft*.npy"))
        check(len(npys) == 1, f"expected one kt175 index, found {npys}")
        with open(os.path.join(RUN_DIR, "results",
                               "evaluation_results_GE_kt175.json")) as fh:
            summary = json.load(fh)["summary_metrics"]
        emb = np.load(npys[0])
        check(emb.shape == slice_out["GE_int8"].shape
              and bool(np.isfinite(emb).all())
              and all(0.0 <= float(v) <= 1.0 for key, v in summary.items()
                      if key != "num_missing_rankings"),
              f"kt175 index {emb.shape} or metrics out of range: {summary}")
        slice_out["GE_kt175"] = emb

    run_path("eval --profile recommended (int8, keep-tokens 175: S 176)",
             (qm.quant_attention_block, qm.quant_attention_cls,
              qm.quant_mlp_block), profile_slice)
    cos_kt = (slice_out["GE_kt175"] * slice_out["GE_int8"]).sum(1) / (
        np.linalg.norm(slice_out["GE_kt175"], axis=1)
        * np.linalg.norm(slice_out["GE_int8"], axis=1))
    print(f"[slice] eval --profile recommended: gallery features against "
          f"the all-token int8 tower's, min cosine {cos_kt.min():.5f}, mean "
          f"{cos_kt.mean():.5f}")
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

    # the serve action over the same corpus and the indexes encode saved:
    # in this process through the helper the CLI calls, bf16 then
    # --quantize (image_path queries encode at the engine's batch of 32:
    # rows 1-2, or 5-7; every search takes row 3), then the CLI itself as a
    # process of its own
    for flags, tag, counters in (
            ([], "bf16", (bf16_layer.fused_layer_block_bf16,
                          bf16_layer.fused_layer_cls_bf16,
                          topk_kernel.bucket_topk_bf16)),
            (["--quantize"], "--quantize", (qm.quant_attention_block,
                                            qm.quant_attention_cls,
                                            qm.quant_mlp_block,
                                            topk_kernel.bucket_topk_bf16))):
        run_path(f"serve {tag}: /healthz, /stats, /search by features, name "
                 "and image_path, 8 clients x 8 requests", counters,
                 lambda flags=flags, tag=tag: serve_slice(
                     np, run_serve_action, parse_args, flags, tag))
    cli_server()

    # the CLI's small tower, which the JAX package serves: eval
    # --synthetic writes a 64 px corpus, for which the CLI builds a tower
    # of D 64 over 4 heads, its attention on the kernels' head_dim-16
    # instances; held to the same run on the CPU by the gallery features
    # (and the bf16 battery)
    synth = {}

    def synthetic_eval(flags, where):
        path = os.path.join(SYN_DIR, where + "".join(flags))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["eval", "--path", path, "--synthetic", "--device",
                      where] + flags)
        check(rc == 0, f"eval --synthetic {flags} --device {where} failed")
        with open(os.path.join(path, "results",
                               "evaluation_results_GE.json")) as fh:
            summary = json.load(fh)["summary_metrics"]
        (npy,) = glob.glob(os.path.join(path, "embeddings", "*.npy"))
        synth[(tuple(flags), where)] = (summary, torch.from_numpy(
            np.load(npy)))

    shutil.rmtree(SYN_DIR, ignore_errors=True)
    for flags, tag, counters in (
            ([], "bf16", (bf16_layer.fused_layer_block_bf16,
                          bf16_layer.fused_layer_cls_bf16)),
            (["--quantize"], "int8", (qm.quant_attention_block,
                                      qm.quant_attention_cls,
                                      qm.quant_mlp_block))):
        # the CPU computes the int8 kernels' exact form: the card runs it
        # too here (its default, the fast form, is another function)
        with kernel_form(False):
            run_path(f"eval --synthetic ({tag}; 64 px: the small tower, "
                     "head_dim 16)", counters,
                     lambda flags=flags: synthetic_eval(flags, "cuda"),
                     record=False)
        synthetic_eval(flags, "cpu")
        (got, got_emb), (want, want_emb) = (synth[(tuple(flags), w)]
                                            for w in ("cuda", "cpu"))
        gap = max(abs(float(got[key]) - float(v)) for key, v in want.items())
        cos = min_row_cosine(torch, got_emb, want_emb)
        print(f"[slice] eval --synthetic {tag} on the card vs the CPU: "
              f"gallery {tuple(got_emb.shape)} min cosine {cos:.6f}, largest "
              f"metric gap {gap:.4f} (gate "
              f"{METRIC_ATOL if tag == 'bf16' else 'none'}); MRR "
              f"{float(got['MRR']):.4f} vs {float(want['MRR']):.4f}")
        check(set(got) == set(want) and cos >= SYNTH_MIN_COS
              and (tag != "bf16" or gap <= METRIC_ATOL),
              f"eval --synthetic {tag} on the card differs from the CPU's")

    # the bucket paths at a width their kernels take only zero-padded
    # (the index pads its candidate copies at build, the queries per
    # search), each equal to the exact ranking index for index
    n_w, d_w, q_w = 200_000, 100, 64
    g_w = torch.randn(n_w, d_w, generator=gen, device=dev)
    q_w_emb = torch.cat([g_w[:q_w // 2] + 0.3 * torch.randn(
        q_w // 2, d_w, generator=gen, device=dev),
        torch.randn(q_w - q_w // 2, d_w, generator=gen, device=dev)])
    ball_w = ball_points(torch, n_w, d_w, HYP_SIZES["c"], gen, dev)
    qball_w = ball_points(torch, q_w, d_w, HYP_SIZES["c"], gen, dev)
    names_w = [f"g{i}" for i in range(n_w)]
    width = {}

    def width_paths():
        for tag, kw in (("bf16", {}), ("int8", {"quantized": True})):
            width[tag] = index_mod.EmbeddingIndex(
                g_w, names_w, device=dev, **kw).search(q_w_emb, k=10)[1]
        width["poincare"] = index_mod.EmbeddingIndex(
            ball_w, names_w, similarity="poincare", c=HYP_SIZES["c"],
            quantized=True).search(qball_w, k=10)[1]

    run_path(f"EmbeddingIndex at D {d_w} over {n_w} rows, k=10 (bf16, int8, "
             "Poincaré)", (topk_kernel.bucket_topk_bf16,
                           topk_kernel.bucket_topk_int8,
                           topk_kernel.bucket_topk_poincare),
             width_paths, record=False)
    exact = index_mod.topk_search(q_w_emb, g_w, k=10)[1].cpu().numpy()
    exact_p = exact_poincare_topk(torch, qball_w, ball_w, HYP_SIZES["c"],
                                  10).cpu().numpy()
    same = {tag: bool(np.array_equal(got, exact_p if tag == "poincare"
                                     else exact))
            for tag, got in width.items()}
    print(f"[slice] EmbeddingIndex at D {d_w}: top-10 equal to the exact "
          f"ranking (f32 scan; Poincaré: f64 distance): {same}")
    check(all(same.values()), f"an index path at D {d_w} differs from the "
          "exact ranking")
    del g_w, ball_w, names_w

    # the int8 tower at a ragged batch through a normal entry point: a
    # RetrievalEngine at batch_size 3 pads every batch to 3 images, so
    # layers 0..10 run the whole int8 layer (row 8); at batch 32 the same
    # gallery runs rows 5 + 7.  The two compute other functions (an f32
    # against a bf16 mid-layer residual), so their features are held by
    # min cosine, beside the yardstick of the int8 tower on 32 decoded
    # images against the same with pixel noise of std 1e-3.
    gallery = list_images(os.path.join(RUN_DIR, "test_gallery"))
    encode8 = make_device_normalizing_encoder(tower8, dev)
    by_batch = {}

    def engine_encode(bs):
        with RetrievalEngine(encode8, dev, batch_size=bs) as engine:
            by_batch[bs] = engine.encode_paths(gallery)[0]

    run_path(f"RetrievalEngine(batch_size=3).encode_paths, int8 tower, "
             f"{len(gallery)} images", (qm.quant_layer_block,),
             lambda: engine_encode(3))
    n_row8 = qm.quant_layer_block.launches
    engine_encode(32)
    check(qm.quant_layer_block.launches == n_row8,
          "the int8 tower at batch 32 ran the whole-layer kernel")
    for batch, _paths, _n in ImageBatcher(gallery[:32], batch_size=32,
                                          out_dtype="u8"):
        px32 = device_normalize(torch.from_numpy(batch).to(dev))
    with torch.inference_mode():
        f32_clean = tower8(px32)
        f32_noisy = tower8(px32 + 1e-3 * torch.randn(
            px32.shape, generator=igen, device=dev))
    f3, f32b = (torch.from_numpy(by_batch[bs]) for bs in (3, 32))
    # the same gallery in the int8 kernels' exact form, as a user asks for
    # it (PATENT_TPU_FAST_KERNELS=0): batch 3 (row 8) and 128 (rows 5, 6
    # and 7), and batch 128 in the fast form; each batch's two forms held
    # by min cosine
    by_form = {}
    for fast in (False, True):
        for bs in ((3, 128) if not fast else (128,)):
            with kernel_form(fast):
                run_path(f"RetrievalEngine(batch_size={bs}).encode_paths, "
                         f"int8 tower, {form_name(fast)}, {len(gallery)} "
                         "images", (qm.quant_layer_block,) if bs == 3 else
                         (qm.quant_attention_block, qm.quant_attention_cls,
                          qm.quant_mlp_block),
                         lambda bs=bs: engine_encode(bs))
            by_form[bs, fast] = torch.from_numpy(by_batch[bs])
    by_form[3, True] = f3
    for bs in (3, 128):
        cos_forms = min_row_cosine(torch, by_form[bs, True],
                                   by_form[bs, False])
        print(f"[slice] int8 gallery features, fast form (the card's "
              f"default) vs exact form (PATENT_TPU_FAST_KERNELS=0), batch "
              f"{bs}, {f3.shape[0]} images: min cosine {cos_forms:.6f}, rel "
              f"err {rel_err(by_form[bs, True], by_form[bs, False]):.3g} "
              f"(gate {INT8_FORMS_MIN_COS})")
        check(bool(torch.isfinite(by_form[bs, False]).all())
              and cos_forms >= INT8_FORMS_MIN_COS,
              f"the int8 tower's two forms far apart at batch {bs}: min "
              f"cosine {cos_forms} < {INT8_FORMS_MIN_COS}")
    cos_engine = min_row_cosine(torch, f3, f32b)
    print(f"[slice] int8 gallery features at batch 3 (whole layer) vs batch "
          f"32 (rows 5 + 7), {f3.shape[0]} images: min cosine "
          f"{cos_engine:.6f}, rel err {rel_err(f3, f32b):.3g} (yardstick, "
          f"batch 32 on 32 images vs the same + 1e-3 pixel noise: min cosine "
          f"{min_row_cosine(torch, f32_noisy, f32_clean):.6f}, rel err "
          f"{rel_err(f32_noisy, f32_clean):.3g})")
    check(f3.shape == (n_gallery, 512) and bool(torch.isfinite(f3).all())
          and cos_engine >= INT8_RAGGED_MIN_COS,
          f"int8 features at batch 3 far from batch 32's: min cosine "
          f"{cos_engine} < {INT8_RAGGED_MIN_COS}")

    # the int8 family's public entries on ViT-B/16 tokens: layers 0..10 as
    # quant_layer_group(group=2) at batch 2 (row 9: row 8's kernel), then
    # int8_dense (row 10) and quant_mlp (row 11) with layer 0's weights on
    # the stack's output, in the card's default form and then with
    # PATENT_TPU_FAST_KERNELS=0
    px2 = torch.randn(2, 224, 224, 3, generator=igen, device=dev)
    for fast in (True, False):
        with kernel_form(fast):
            int8_family_slice(torch, qm, tower8, int8_dense, px2, heads,
                              run_path, form_name(fast))

    # the bf16 towers at batch 32 over the same gallery: the fused-layer
    # the bf16 towers at batch 32 over the same gallery: the fused-layer
    # tower (rows 1-2), then the per-op towers of JAX's VisionTransformer
    # (fused_layer=False) from the same weights through a RetrievalEngine:
    # encode_dataset, rank_queries and evaluate.  use_flash runs row 14 in
    # every layer (12 launches a batch), fused_block row 12's forward.
    # Each is held to the same tower with kernels=False (the same function)
    # and by min cosine to the fused-layer tower (another function: its
    # stream is bf16 between layers), beside the yardstick of the
    # fused-layer tower on 32 decoded images against the same with pixel
    # noise of std 1e-3.
    query_dir = os.path.join(RUN_DIR, "test_query")
    gt_path = os.path.join(RUN_DIR, "ground_truth.json")
    bf16_feats = {}

    def encode_bf16(model, bs, key):
        with RetrievalEngine(make_device_normalizing_encoder(model, dev), dev,
                             batch_size=bs) as engine:
            bf16_feats[key] = torch.from_numpy(engine.encode_paths(gallery)[0])

    encode_bf16(tower, 32, "fused_layer")
    with torch.inference_mode():
        y_clean = tower(px32)
        y_noisy = tower(px32 + 1e-3 * torch.randn(px32.shape, generator=igen,
                                                  device=dev))
    yard = (f"yardstick, fused-layer tower on 32 images vs the same + 1e-3 "
            f"pixel noise: min cosine {min_row_cosine(torch, y_noisy, y_clean):.6f}"
            f", rel err {rel_err(y_noisy, y_clean):.3g}")
    per_op_towers = {}
    for mode, kernel in (("use_flash", fa.flash_attention),
                         ("fused_block", fa.fused_attention_fwd)):
        model = VisionTransformer(VIT_B16, fused_layer=False, **{mode: True})
        model.load_state_dict(tower.state_dict())
        model = per_op_towers[mode] = model.to(dev).eval()
        got = {}

        def per_op_slice(model=model, got=got):
            with RetrievalEngine(make_device_normalizing_encoder(model, dev),
                                 dev, batch_size=32) as engine:
                index = engine.encode_dataset(gallery)
                got["ranks"] = engine.rank_queries(query_dir, k=20)
                got["metrics"] = engine.evaluate(query_dir, gt_path)
            got["emb"] = index.embeddings.cpu()

        run_path(f"RetrievalEngine(batch_size=32), VisionTransformer("
                 f"fused_layer=False, {mode}=True): encode_dataset, "
                 "rank_queries --k 20, evaluate", (kernel,), per_op_slice)
        n_launch = kernel.launches
        model.kernels = False
        encode_bf16(model, 32, mode + " plain")
        model.kernels = True
        emb, plain_emb = got["emb"], bf16_feats[mode + " plain"]
        summary = got["metrics"].summary_dict()
        cos_plain = min_row_cosine(torch, emb, plain_emb)
        cos_fl = min_row_cosine(torch, emb, bf16_feats["fused_layer"])
        print(f"[slice] {mode} tower over {emb.shape[0]} images: kernels vs "
              f"plain rel err {rel_err(emb, plain_emb):.3g}, min cosine "
              f"{cos_plain:.6f}; vs the fused-layer tower min cosine "
              f"{cos_fl:.6f}, rel err "
              f"{rel_err(emb, bf16_feats['fused_layer']):.3g} ({yard}); "
              f"{len(got['ranks'])} queries ranked; MRR "
              f"{summary['MRR']:.4f}, mAP {summary['mAP']:.4f}")
        check(emb.shape == (n_gallery, 512) and bool(torch.isfinite(emb).all())
              and rel_err(emb, plain_emb) <= TOWER_REL_TOL
              and cos_plain >= TOWER_MIN_COS and cos_fl >= PER_OP_MIN_COS
              and (mode != "use_flash" or n_launch % VIT_B16.num_layers == 0)
              and got["ranks"]
              and all(0.0 <= float(v) <= 1.0 for key, v in summary.items()
                      if key != "num_missing_rankings"),
              f"the {mode} tower's slice disagrees or is out of range")

    # JAX's VisionTransformer defaults to f32: the f32 use_flash tower from
    # the same weights runs row 14's f32 instance in every layer
    f32_tower = VisionTransformer(VIT_B16, dtype=torch.float32,
                                  fused_layer=False, use_flash=True)
    f32_tower.load_state_dict(tower.state_dict())
    f32_tower = f32_tower.to(dev).eval()
    run_path("RetrievalEngine(batch_size=32).encode_paths, VisionTransformer("
             "dtype=float32, fused_layer=False, use_flash=True)",
             (fa.flash_attention_f32,),
             lambda: encode_bf16(f32_tower, 32, "use_flash f32"))
    f32_tower.kernels = False
    encode_bf16(f32_tower, 32, "use_flash f32 plain")
    f32_tower.kernels = True
    e32, p32 = bf16_feats["use_flash f32"], bf16_feats["use_flash f32 plain"]
    print(f"[slice] use_flash f32 tower over {e32.shape[0]} images: kernels "
          f"vs plain rel err {rel_err(e32, p32):.3g}, min cosine "
          f"{min_row_cosine(torch, e32, p32):.7f}; vs the bf16 fused-layer "
          f"tower min cosine "
          f"{min_row_cosine(torch, e32, bf16_feats['fused_layer']):.6f}")
    check(e32.shape == (n_gallery, 512) and bool(torch.isfinite(e32).all())
          and rel_err(e32, p32) <= FLASH_F32_REL_TOL * 10
          and min_row_cosine(torch, e32, bf16_feats["fused_layer"])
          >= PER_OP_MIN_COS,
          "the f32 use_flash tower disagrees with its plain version or the "
          "bf16 tower")

    # the fused-layer tower at an odd batch: a RetrievalEngine at batch_size
    # 3 pads every batch to 3 images, where JAX runs no layer kernel but its
    # per-op composition in every layer; so must the port (rows 1 and 2
    # launch 0 times)
    layer_fns = (bf16_layer.fused_layer_block_bf16,
                 bf16_layer.fused_layer_cls_bf16)
    for fn in layer_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    encode_bf16(tower, 3, "fused_layer B3")
    torch.cuda.synchronize()
    odd = {fn.__name__: fn.launches for fn in layer_fns}
    f3, f32b = bf16_feats["fused_layer B3"], bf16_feats["fused_layer"]
    cos_odd = min_row_cosine(torch, f3, f32b)
    print(f"[slice] RetrievalEngine(batch_size=3).encode_paths, bf16 "
          f"fused-layer tower, {len(gallery)} images in "
          f"{time.perf_counter() - t0:.1f} s; launches {odd} (every layer the "
          f"per-op composition); vs batch 32 (rows 1-2): min cosine "
          f"{cos_odd:.6f}, rel err {rel_err(f3, f32b):.3g} ({yard})")
    check(all(n == 0 for n in odd.values()), "the bf16 tower at batch 3 "
          "launched a layer kernel")
    check(f3.shape == (n_gallery, 512) and bool(torch.isfinite(f3).all())
          and cos_odd >= BF16_ODD_MIN_COS,
          f"bf16 features at batch 3 far from batch 32's: min cosine "
          f"{cos_odd} < {BF16_ODD_MIN_COS}")

    # the same seeded weights as an HF CLIP directory, served through
    # eval --checkpoint
    hf_checkpoint_slice(
        torch, np, run_path, cli,
        {"GE": (bf16_layer.fused_layer_block_bf16,
                bf16_layer.fused_layer_cls_bf16),
         "GE_int8": (qm.quant_attention_block, qm.quant_attention_cls,
                     qm.quant_mlp_block)}, tower.state_dict(), slice_out)

    # the composed pipeline, the port alone: train_class_pro exports the
    # CLI graph's figure embeddings into the fine-tune's directory; the
    # fine-tune (ViT-B/16 started from the HF directory's weights on a 224
    # px corpus: 192 anchors, 19 held out, two steps of 64 pairs and one
    # validation batch) aligns to that export; eval serves its checkpoint
    # through the bf16 kernels
    shutil.rmtree(FT_DIR, ignore_errors=True)
    write_synthetic_corpus(FT_DIR, num_patents=48, figures_per_patent=4,
                           image_size=224)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli(["train_class_pro", "--path", FT_DIR, "--epochs", "3"])
    check(rc == 0 and os.path.isfile(os.path.join(
        FT_DIR, "graph_embeddings", "image_ge_embeddings_GE.pkl")),
        f"train_class_pro failed: {log.getvalue()[-2000:]}")
    gcn_report = json.loads(log.getvalue()[log.getvalue().index("{\n"):
                                           log.getvalue().rindex("}") + 1])
    print(f"[slice] train_class_pro --epochs 3 (the CLI's graph) in "
          f"{time.perf_counter() - t0:.1f} s: test_acc "
          f"{gcn_report['test_acc']:.4f}; graph embeddings exported for the "
          "fine-tune")
    log = io.StringIO()
    started = {}

    def spy(model, optimizer):
        """The tower as the first step takes it."""
        started.update({k: v.detach().cpu().clone()
                        for k, v in model.vit.state_dict().items()})
        return make_finetune_step(model, optimizer)

    def finetune():
        with contextlib.redirect_stdout(log), mock.patch(
                "patent_tpu_torch.train.finetune_clip.make_finetune_step",
                spy):
            rc = cli(["finetune", "--path", FT_DIR, "--epochs", "1",
                      "--checkpoint", HF_DIR])
        print(log.getvalue(), end="")
        check(rc == 0, "finetune failed")

    run_path("finetune --epochs 1 --checkpoint (ViT-B/16 from the HF "
             "directory, 64 pairs a step)",
             (fa.fused_attention_fwd, fa.fused_attention_bwd,
              mm.fused_mlp_fwd, mm.fused_mlp_bwd), finetune)
    loaded = load_hf_clip_params(HF_DIR, VIT_B16)
    same = set(started) == set(loaded) and all(
        torch.equal(started[k], v) for k, v in loaded.items())
    print(f"[slice] finetune --checkpoint: the starting tower's "
          f"{len(started)} tensors equal in bits to the HF directory's: "
          f"{same}")
    check(same, "the fine-tune did not start from the HF weights")
    del started, loaded
    losses = [float(t) for t in re.findall(r"train_loss=(\S+)",
                                           log.getvalue())]
    aligned = re.search(r"aligned to (\d+) exported graph embeddings",
                        log.getvalue())
    check(aligned is not None, "the fine-tune did not read the graph "
          "embeddings train_class_pro exported")
    ckpt = os.path.join(FT_DIR, "models", "clip_finetune_best")
    with open(os.path.join(ckpt, "metadata.json")) as fh:
        val_loss = json.load(fh)["val_loss"]
    check(len(losses) == 1 and math.isfinite(losses[0])
          and math.isfinite(val_loss),
          f"fine-tune losses not finite: train {losses}, val {val_loss}")
    run_path("eval on the fine-tuned checkpoint",
             (bf16_layer.fused_layer_block_bf16,
              bf16_layer.fused_layer_cls_bf16),
             lambda: check(cli(["eval", "--path", FT_DIR, "--model", "FT"])
                           == 0, "eval of the fine-tuned tower failed"),
             record=False)
    npys = glob.glob(os.path.join(FT_DIR, "embeddings", "*_torch_ft*.npy"))
    check(len(npys) == 1, f"expected one _ft index, found {npys}")
    emb = np.load(npys[0])
    with open(os.path.join(FT_DIR, "results",
                           "evaluation_results_FT.json")) as fh:
        summary = json.load(fh)["summary_metrics"]
    check(emb.shape[1] == 512 and bool(np.isfinite(emb).all())
          and all(0.0 <= float(v) <= 1.0 for key, v in summary.items()
                  if key != "num_missing_rankings"),
          f"fine-tuned index {emb.shape} or metrics out of range: {summary}")
    print(f"[slice] fine-tune aligned to {aligned.group(1)} exported graph "
          f"embeddings; train loss {losses[0]:.4f}, val loss "
          f"{val_loss:.4f}; eval served {os.path.basename(npys[0])} "
          f"{emb.shape}: {summary}")

    hyperbolic_slice(torch, dev, HYP_SIZES, hyp, run_path, cli)
    hyperbolic_backward(torch, dev, HYP_SIZES)
    hyperbolic_training(torch, dev, HYP_SIZES, hyp, run_path, cli, errs)
    graph_loops_slice(torch, dev, hyp, run_path, tower, tower8)
    e2e = end_to_end_setup(torch, dev, hyp)
    end_to_end_step_check(torch, dev, run_path, e2e)
    end_to_end_slice(torch, dev, run_path, cli, hyp)
    text_slice(torch, dev, hyp)
    print(f"[phase] 4b. multi-GPU from {time.perf_counter() - t_run:.0f} s")
    multi_gpu_slice(torch, np, launches, label, hyp["td"])

    # ---- 5. times
    print(f"[phase] 5. times from {time.perf_counter() - t_run:.0f} s")
    times = {}
    pix =torch.randn(bt, 224, 224, 3, generator=gen, device=dev)

    def run_tower(model, kernels):
        def go():
            model.kernels = kernels
            with torch.inference_mode():
                model(pix)
        return go

    def in_form(fn, fast):
        def go():
            with kernel_form(fast):
                fn()
        return go

    # the int8 tower in both forms, in turns: the card's default, the fast
    # form, and PATENT_TPU_FAST_KERNELS=0, the exact form
    te, tf = in_turns(torch, in_form(run_tower(tower8, True), False),
                      in_form(run_tower(tower8, True), True))
    print(f"[time] ViT-B/16 @224 int8 tower, batch {bt}, in turns: fast form "
          f"{bt / tf * 1e3:.1f} img/s ({tf:.2f} ms), exact form "
          f"{bt / te * 1e3:.1f} img/s ({te:.2f} ms) {label}")
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

    # the per-op bf16 towers (the default one runs no kernel), then the
    # fused-layer tower at batch 3 (every layer the per-op composition) and
    # 127 (rows 1-2)
    per_op_towers["default"] = VisionTransformer(VIT_B16, fused_layer=False)
    per_op_towers["default"].load_state_dict(tower.state_dict())
    per_op_towers["default"].to(dev).eval()
    ms_fl = cuda_ms(torch, run_tower(tower, True), iters=10)
    for mode, model in per_op_towers.items():
        ms = cuda_ms(torch, run_tower(model, True), iters=10)
        print(f"[time] ViT-B/16 @224 bf16 per-op tower, {mode}, batch {bt}: "
              f"{bt / ms * 1e3:.1f} img/s ({ms:.2f} ms); fused-layer tower "
              f"{bt / ms_fl * 1e3:.1f} img/s ({ms_fl:.2f} ms) {label}")
    print_breakdown(torch, "bf16 per-op tower, use_flash, batch 128",
                    run_tower(per_op_towers["use_flash"], True))
    del per_op_towers
    # the f32 use_flash tower (row 14's f32 instance in every layer)
    ms = cuda_ms(torch, run_tower(f32_tower, True), iters=5)
    print(f"[time] ViT-B/16 @224 f32 per-op tower, use_flash, batch {bt}: "
          f"{bt / ms * 1e3:.1f} img/s ({ms:.2f} ms) {label}")
    print_breakdown(torch, "f32 per-op tower, use_flash, batch 128",
                    run_tower(f32_tower, True))
    del f32_tower
    scan_encoder_times(torch, dev, tower, tower8, label)
    for bv in (3, bt - 1):
        def fused_layer_at(pv=pix[:bv]):
            with torch.inference_mode():
                tower(pv)

        ms = cuda_ms(torch, fused_layer_at, iters=10)
        print(f"[time] ViT-B/16 @224 bf16 fused-layer tower, batch {bv} ("
              + ("per-op composition" if bv % 2 else "rows 1-2")
              + f"): {ms:.3f} ms, {bv / ms * 1e3:.1f} img/s {label}")

    # the int8 tower at ragged batches (layers 0..10 through row 8): the
    # latency of one image, and img/s at 3 and 127, in both forms in turns
    for bv in (1, 3, bt - 1):
        def ragged(pv=pix[:bv]):
            with torch.inference_mode():
                tower8(pv)

        me, ms = in_turns(torch, in_form(ragged, False), in_form(ragged, True))
        print(f"[time] ViT-B/16 @224 int8 tower, batch {bv} (whole-layer "
              f"kernel): fast form {ms:.3f} ms, {bv / ms * 1e3:.1f} img/s; "
              f"exact form {me:.3f} ms, {bv / me * 1e3:.1f} img/s {label}")
        print_breakdown(torch, f"int8 tower, batch {bv}", ragged)

    xb = torch.randn(bt, s, d, generator=gen, device=dev).to(torch.bfloat16)
    # rows 1-2 on weights folded once, as the tower holds them
    fold_kw = {"folded": bf16_layer.fold_layer(*p, heads)}
    for kname in ("fused_layer_block_bf16", "fused_layer_cls_bf16"):
        kernel = getattr(bf16_layer, kname)
        plain = getattr(bf16_layer, kname + "_plain")
        times[kname] = in_turns(
            torch, lambda: plain(xb, *p, heads, valid, **fold_kw),
            lambda: kernel(xb, *p, heads, valid, **fold_kw))
    # row 1's four GEMM instances alone, beside torch.matmul of the same
    # bf16 product (cuBLAS, no epilogue): a yardstick only
    fw = fold_kw["folded"]
    m = bt * s
    ga = {"bias": xb.reshape(m, d), "res_bias": xb.reshape(m, d),
          "bias_gelu": xb.reshape(m, d),
          "bias_res": torch.randn(m, f, generator=gen, device=dev).to(
              torch.bfloat16)}
    gw = {"bias": (fw.wqkv_t, fw.bqkv), "res_bias": (fw.wout_t, fw.bout),
          "bias_gelu": (fw.w1_t, fw.b1), "bias_res": (fw.w2_t, fw.b2)}
    gres = {"res_bias": xb.reshape(m, d),
            "bias_res": torch.randn(m, d, generator=gen, device=dev)}
    for epi in GEMM_SHAPES:
        wt, bias = gw[epi]
        n_, k_ = wt.shape
        ms = cuda_ms(torch, lambda: bf16_layer.layer_gemm(
            ga[epi], wt, bias, epi, gres.get(epi)))
        lib = cuda_ms(torch, lambda: torch.matmul(ga[epi], wt.T))
        tf = 2 * m * n_ * k_ / 1e9
        print(f"[time] layer GEMM {epi} [{m} x {k_}] x [{k_} x {n_}]: "
              f"{ms:.3f} ms ({tf / ms:.0f} TFLOP/s); torch.matmul of the same "
              f"bf16 product {lib:.3f} ms ({tf / lib:.0f} TFLOP/s) {label}")
    del ga, gres
    for kname, module, args in (
            ("quant_attention_block", qm, (*ip_attn, heads, valid)),
            ("quant_attention_cls", qm, (*ip_attn, heads, valid)),
            ("quant_mlp_block", qm, ip_mlp)):
        kernel = getattr(module, kname)
        plain = getattr(module, kname + "_plain")
        for fast in (False, True):
            times[kname + "_fast" * fast] = in_turns(
                torch, lambda: plain(xb, *args, fast=fast),
                lambda: kernel(xb, *args, fast=fast))
    # row 7 at a batch of 128, exact form: where its device time goes (each
    # of its kernels launches once a call)
    rows7 = sorted(launch_times(torch, lambda: qm.quant_mlp_block(
        xb, *ip_mlp, fast=False)), key=lambda row: -row[1])
    print(f"[time] row 7 (quant_mlp_block) at [{bt}, {s}, {d}], hidden {f}, "
          "exact form: "
          f"device time by kernel (torch.profiler, 30 calls) "
          f"{sum(ms for _k, ms, _n in rows7):.4f} ms a call; "
          + "; ".join(f"{row7_phase(kname)} {ms:.4f} ms ({n} launches seen)"
                      for kname, ms, n in rows7) + f" {label}")
    # one int8 layer at the ragged batches: the whole-layer kernel, the rows
    # 5 + 7 chain of kernels and row 8's plain version; then rows 9-11
    # against their plain versions at a batch of 128
    fold8 = qm.fold_q_scale(ip_attn[3], ip_attn[4], heads)
    layer_times = {}
    for bv in (1, 3, bt - 1):
        xl = xb[:bv]
        for fast in (False, True):
            pl, kl = in_turns(
                torch, lambda: qm.quant_layer_block_plain(
                    xl, *ip, heads, valid, fast=fast),
                lambda: qm.quant_layer_block(xl, *ip, heads, valid,
                                             fast=fast))

            def folded_call(xl=xl, fast=fast):
                return qm.quant_layer_block(xl, *ip, heads, valid,
                                            folded=fold8, fast=fast)

            kf = cuda_ms(torch, folded_call)
            # the kernels line keeps a call's wall time, on the clock of
            # every other row and of its plain time; at a query's batch much
            # of it is the host's, and the device time says how much is the
            # kernel's
            kd = sum(ms for _k, ms in kernel_breakdown(torch, folded_call,
                                                       10))
            chain = cuda_ms(torch, lambda: qm.quant_mlp_block(
                qm.quant_attention_block(xl, *ip_attn, heads, valid,
                                         fast=fast), *ip_mlp, fast=fast))
            layer_times[bv, fast] = (pl, kl)
            b8 = int8_family_bounds(bv, bt, s, valid, d, f, bt * s)
            plan = qm.layer_plan(bv * s, d, f, qm.layer_grid())
            print(f"[time] one int8 layer, {form_name(fast)}, B {bv}, S {s} "
                  f"({valid} valid): whole-layer kernel {kd:.4f} ms of "
                  f"device time ({'one cooperative launch, split '
                  f'{plan.split_out} / {plan.split_mlp}' if plan.coop else
                  'a chain of launches'}), a call {kl:.3f} ms of wall time "
                  f"({kf:.3f} ms on folded vectors), rows 5 + 7 kernels "
                  f"{chain:.3f} ms, plain {pl:.3f} ms, bound "
                  f"{b8['quant_layer_block'][0]:.4f} ms "
                  f"({b8['quant_layer_block'][1]}) {label}")
        if plan.coop:
            # where the cooperative launch's time goes (exact form): block
            # 0's clock at the end of each phase, over three launches
            stamps = torch.zeros(11, dtype=torch.int64, device=dev)
            for _ in range(3):
                qm._layer_kernel(xl, ip, heads, valid, fold8, stamps=stamps,
                                 fast=False)
            torch.cuda.synchronize()
            c = stamps.tolist()
            print(f"[time] one int8 layer, B {bv}: the cooperative launch's "
                  "phases (share of block 0's clock): " + ", ".join(
                      f"{name} {100 * (c[i + 1] - c[i]) / (c[-1] - c[0]):.1f}%"
                      for i, name in enumerate(LAYER_PHASES)))
    # row 8's launches on the main path are at B 3 (RetrievalEngine at
    # batch_size 3)
    x2d = xb.reshape(-1, d)
    m = x2d.shape[0]
    for sfx, fast in (("", False), ("_fast", True)):
        times["quant_layer_block" + sfx] = layer_times[3, fast]
        times["quant_layer_group" + sfx] = in_turns(
            torch, lambda: qm.quant_layer_group_plain(xb, *ip, heads, valid,
                                                      fast=fast),
            lambda: qm.quant_layer_group(xb, *ip, heads, valid, fast=fast))
        times["quant_dense" + sfx] = in_turns(
            torch, lambda: qm.quant_dense_plain(x2d, *ip_attn[2:5],
                                                fast=fast),
            lambda: qm.quant_dense(x2d, *ip_attn[2:5], fast=fast))
        times["quant_mlp" + sfx] = in_turns(
            torch, lambda: qm.quant_mlp_plain(x2d, *ip_mlp[2:], fast=fast),
            lambda: qm.quant_mlp(x2d, *ip_mlp[2:], fast=fast))
    dev11 = launch_times(torch, lambda: qm.quant_mlp(x2d, *ip_mlp[2:],
                                                     fast=False), 10)
    print(f"[time] row 11 (quant_mlp) at [{m} x {d}], H {f}, exact form: "
          f"{times['quant_mlp'][1]:.4f} ms a call (wall); device time by "
          "kernel (torch.profiler, 10 calls) "
          + ", ".join(f"{ms:.4f} ms a launch ({n} launches seen) "
                      f"{kname[:60]}" for kname, ms, n in
                      sorted(dev11, key=lambda r: -r[1] * r[2]))
          + f"; {sum(ms * n for _k, ms, n in dev11) / 10:.4f} ms a call "
          f"{label}")
    # rows 5 and 8's int8 GEMM instances alone at a batch of 128's rows,
    # beside torch._int_mm of the same int8 product (cuBLASLt, no
    # epilogue): a yardstick only
    for epi, (gn, gk) in S8_GEMM_SHAPES.items():
        a, a_scale, w_t, scale, bias, res = s8_gemm_case(
            torch, qm, epi, m, gn, gk, igen, dev)
        ms = cuda_ms(torch, lambda: qm.int8_gemm(a, a_scale, w_t, scale, bias,
                                                 epi, res))
        lib = cuda_ms(torch, lambda: torch._int_mm(a, w_t.T))
        tops = 2 * m * gn * gk / 1e9
        print(f"[time] s8 GEMM {epi} [{m} x {gk}] x [{gk} x {gn}]: {ms:.3f} ms "
              f"({tops / ms:.0f} TOP/s); torch._int_mm of the same int8 "
              f"product {lib:.3f} ms ({tops / lib:.0f} TOP/s) {label}")
        del a, w_t, res
    # a yardstick for later work, not the same function (no quantization,
    # no epilogue): cuBLASLt's int8 products of rows 10 and 11's shapes
    xq = qm.quant_rows(x2d.float())[0]
    gq = torch.randint(-127, 128, (m, f), generator=igen, device=dev,
                       dtype=torch.int8)
    mm_qkv = cuda_ms(torch, lambda: torch._int_mm(xq, ip_attn[2].T))
    mm_mlp = cuda_ms(torch, lambda: (torch._int_mm(xq, ip_mlp[2].T),
                                     torch._int_mm(gq, ip_mlp[5].T)))
    print(f"[time] note: torch._int_mm alone, [{m} x {d}] x [{d} x {3 * d}] "
          f"{mm_qkv:.3f} ms; the MLP's two products {mm_mlp:.3f} ms {label}")
    del xq, gq, x2d
    # the trainable blocks at one training step's shapes: 64 pairs are
    # 128 images, attention on the stream padded to 208, the MLP on the
    # 128 x 197 unpadded rows
    wqkv_f, bqkv_f = fold_q(torch, p[2], p[3], d, heads)
    attn_args = (wqkv_f, bqkv_f, p[4], p[5], heads, valid)
    da = torch.randn(bt, s, d, generator=fgen, device=dev)
    da[:, valid:] = 0.0
    da = da.to(torch.bfloat16)
    x2 = xb[:, :valid].reshape(-1, d).contiguous()
    do2 = torch.randn(x2.shape, generator=fgen, device=dev).to(torch.bfloat16)
    for kname, plain, kernel, args in (
            ("fused_attention_fwd", fa.fused_attention_block_plain,
             fa.fused_attention_fwd, (xb, *attn_args)),
            ("fused_attention_bwd", fa.attention_bwd_plain,
             fa.fused_attention_bwd, (xb, wqkv_f, bqkv_f, da, heads, valid)),
            ("fused_mlp_fwd", mm.fused_mlp_block_bf16_plain, mm.fused_mlp_fwd,
             (x2, *p[6:12])),
            ("fused_mlp_bwd", mm._mlp_bwd_plain, mm.fused_mlp_bwd,
             (x2, do2, *p[6:11]))):
        times[kname] = in_turns(torch, lambda: plain(*args),
                                lambda: kernel(*args))
    # the redesigned kernels: device time by kernel a call, and the
    # launches the trace saw (30 calls)
    for kname, kernel, args in (
            ("fused_attention_bwd", fa.fused_attention_bwd,
             (xb, wqkv_f, bqkv_f, da, heads, valid)),
            ("fused_mlp_fwd", mm.fused_mlp_fwd, (x2, *p[6:12])),
            ("fused_mlp_bwd", mm.fused_mlp_bwd, (x2, do2, *p[6:11]))):
        rows_k = sorted(launch_times(torch, lambda: kernel(*args)),
                        key=lambda row: -row[1] * row[2])
        device_ms = sum(ms * n for _k, ms, n in rows_k) / 30
        print(f"[time] {kname} at the fine-tune step's shapes: wall "
              f"{times[kname][1]:.3f} ms, device {device_ms:.4f} ms a call "
              f"(torch.profiler, 30 calls); by kernel, mean ms a launch "
              f"(launches seen): " + "; ".join(
                  f"{kn[:60]} {ms:.4f} ({n})" for kn, ms, n in rows_k)
              + f" {label}")
    del xb, da, x2, do2
    # row 14 at the use_flash tower's shapes, q, k, v slices of one qkv
    # tensor; F.scaled_dot_product_attention (PyTorch's own kernel, a
    # yardstick the port never calls) on contiguous [B, H, S, D] copies,
    # the transposes not timed
    qkv = torch.randn(bt, valid, 3 * d, generator=agen, device=dev).to(
        torch.bfloat16)
    fq, fk, fv = (t.unflatten(-1, (heads, 64)) for t in qkv.split(d, dim=-1))
    times["flash_attention"] = in_turns(
        torch, lambda: fa.flash_attention_plain(fq, fk, fv),
        lambda: fa.flash_attention(fq, fk, fv))
    sq, sk_, sv = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))
    library = {"flash_attention": cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk_, sv))}
    # the f32 instance at the same shapes; SDPA on f32 as its yardstick
    fq, fk, fv, sq, sk_, sv = (t.float() for t in (fq, fk, fv, sq, sk_, sv))
    times["flash_attention_f32"] = in_turns(
        torch, lambda: fa.flash_attention_plain(fq, fk, fv),
        lambda: fa.flash_attention(fq, fk, fv), iters=5)
    library["flash_attention_f32"] = cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk_, sv))
    del qkv, fq, fk, fv, sq, sk_, sv
    bounds = {**layer_bounds(bt, s, valid, d, f, int8=False),
              **layer_bounds(bt, s, valid, d, f, int8=True),
              **train_bounds(bt, s, valid, d, f),
              **int8_family_bounds(3, bt, s, valid, d, f, bt * s),
              # q, k, v read and o written once (bf16); q kᵀ and p v
              "flash_attention": bound(4 * 2 * bt * valid * d,
                                       {"bf16": 4 * bt * valid * valid * d}),
              # the f32 instance runs on the FP32 units (no tensor cores)
              "flash_attention_f32": bound(
                  4 * 4 * bt * valid * d,
                  {"fp32": 4 * bt * valid * valid * d})}
    # the same work in either form
    bounds.update({k + "_fast": bounds[k] for k in INT8_ENTRIES})

    # one training step at 64 pairs (ClipFinetuneConfig's defaults), u8
    # batches already on the card: first one step with the kernels against
    # one with the plain blocks, each from the same seeded weights, then
    # the times of both
    cfg = ClipFinetuneConfig()
    n_nodes = 192
    table = np.random.default_rng(0).standard_normal((n_nodes, 128)).astype(
        np.float32)
    images = torch.randint(0, 256, (2 * cfg.batch_size, 224, 224, 3),
                           generator=fgen, device=dev, dtype=torch.uint8)
    nodes = torch.randint(0, n_nodes, (cfg.batch_size,), generator=fgen,
                          device=dev)
    cot = torch.randn(2 * cfg.batch_size, VIT_B16.projection_dim,
                      generator=fgen, device=dev)
    x_ft = device_normalize(images)
    x_noisy = x_ft + 1e-3 * torch.randn(x_ft.shape, generator=fgen,
                                        device=dev)

    def tower_grads(vit, x):
        """The tower's gradients given ``cot`` for the features of x."""
        vit.zero_grad(set_to_none=True)
        vit(x).backward(cot)
        return {n: t.grad.clone() for n, t in vit.named_parameters()
                if t.grad is not None}

    runs = []
    for kernels in (True, False):
        model, opt = init_finetune_state(VIT_B16, cfg, table, seed=0,
                                         device=dev)
        model.vit.kernels = kernels
        step, _eval_step = make_finetune_step(model, opt)
        # the tower alone, given one cotangent for both runs; the plain
        # tower on pixels with noise of std 1e-3 is the yardstick
        tower = tower_grads(model.vit, x_ft)
        if not kernels:
            yardstick = grad_gaps(tower_grads(model.vit, x_noisy), tower)
        # the whole step (it sets the gradients to None first), keeping
        # the loss's cotangent of the tower's features
        kept = {}

        def keep_dz(_module, _inputs, out):
            out.register_hook(lambda g: kept.update(dz=g.clone()))

        hook = model.vit.register_forward_hook(keep_dz)
        metrics = step(images, nodes, cfg.alpha_max)
        hook.remove()
        runs.append(({k: float(v) for k, v in metrics.items()}, tower,
                     {n: t.grad for n, t in model.named_parameters()
                      if t.grad is not None}, kept["dz"]))
    check_train_step(torch, *zip(*runs), yardstick)
    del runs, tower, x_ft, x_noisy
    metrics = {}

    def train_step(kernels):
        def go():
            model.vit.kernels = kernels
            metrics.update(step(images, nodes, cfg.alpha_max))
        return go

    step_p, step_k = in_turns(torch, train_step(False), train_step(True),
                              iters=10)
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"training step metrics not finite: {metrics}")
    n_img = 2 * cfg.batch_size
    print(f"[time] fine-tune step, ViT-B/16 @224, {cfg.batch_size} pairs "
          f"({n_img} images, last {cfg.trainable_blocks} blocks trained): "
          f"kernels {step_k:.2f} ms/step ({n_img / step_k * 1e3:.1f} img/s "
          f"forward + backward), plain blocks {step_p:.2f} ms/step "
          f"({n_img / step_p * 1e3:.1f} img/s) {label}")
    rows = kernel_breakdown(torch, train_step(True))
    busy = sum(ms for _k, ms in rows)
    print(f"[time] fine-tune step with kernels, device time by kernel "
          f"(torch.profiler, 3 steps): {busy:.2f} ms busy of {step_k:.2f} ms "
          f"wall ({100 * busy / step_k:.1f}%); "
          + "; ".join(f"{ms:.2f} ms {100 * ms / step_k:.1f}% {kname[:90]}"
                      for kname, ms in rows[:12]))
    del model, opt, images

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
    # rows 3 and 3′ at a single query and at 16 (the kernels line keeps the
    # serving batch of 256)
    for nq in (1, 16):
        qn = q256[:nq]
        qn8, qnscale = topk_kernel.quantize_queries(qn)
        for kname, plain, kernel, int8 in (
                ("bucket_topk_bf16",
                 lambda: topk_kernel.bucket_topk_bf16_plain(qn, g16, gvalid,
                                                            pool),
                 lambda: topk_kernel.bucket_topk_bf16(qn, g16, gvalid, pool),
                 False),
                ("bucket_topk_int8",
                 lambda: topk_kernel.bucket_topk_int8_plain(
                     qn8, qnscale, gi8, gscale, pool),
                 lambda: topk_kernel.bucket_topk_int8(qn8, qnscale, gi8,
                                                      gscale, pool),
                 True)):
            pm, km = in_turns(torch, plain, kernel)
            bq = topk_bound(nq, n_big, dg, pool, int8)
            print(f"[time] {kname} at {n_big} x {dg}, Q={nq}: kernel "
                  f"{km:.3f} ms, plain {pm:.3f} ms, bound {bq[0]:.3f} ms "
                  f"({bq[1]}) {label}")
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
    del gal, g16, gvalid, gi8, gscale
    served_qps(torch, np, dev, gen, serve, RetrievalEngine,
               index_mod.EmbeddingIndex, label, n_big, dg, k)

    hyperbolic_train_times(torch, dev, HYP_SIZES, hyp, label)
    # before hyperbolic_times, which releases what hyp holds
    end_to_end_times(torch, dev, e2e, hyp, label)
    text_times(torch, dev, hyp, label)
    hf_load_times(torch, dev, label)
    hyperbolic_times(torch, HYP_SIZES, hyp, times, bounds, label, k, pool)
    for kname, (pm, km) in times.items():
        lib = (f", one PyTorch call {library[kname]:.3f} ms"
               if kname in library else "")
        print(f"[time] {kname}: kernel {km:.3f} ms, plain {pm:.3f} ms{lib}, "
              f"bound {bounds[kname][0]:.3f} ms ({bounds[kname][1]}) "
              f"{label}")

    print(f"[phase] 6. wide towers from {time.perf_counter() - t_run:.0f} s")
    wide_towers_phase(torch, dev, run_path, launches, errs, times, bounds,
                      library, label)
    print(f"[phase] 6b. wide trainers from {time.perf_counter() - t_run:.0f} "
          "s")
    wide_trainers_phase(torch, dev, run_path, launches, errs, times, bounds,
                        library, e2e, label)

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
             "patent_tpu/ops/quant_matmul.py:1069"),
            ("fused_attention_fwd", "fused_attention.cu",
             "patent_tpu/ops/flash_attention.py:258"),
            ("fused_attention_bwd", "fused_attention.cu",
             "patent_tpu/ops/flash_attention.py:360"),
            ("fused_mlp_fwd", "mlp_grad.cu",
             "patent_tpu/ops/bf16_mlp_grad.py:157"),
            ("fused_mlp_bwd", "mlp_grad.cu",
             "patent_tpu/ops/bf16_mlp_grad.py:182"),
            ("bucket_topk_poincare", "bucket_topk.cu",
             "patent_tpu/ops/topk_kernel.py:391"),
            ("pairwise_dist_pallas", "hyperbolic.cu",
             "patent_tpu/ops/pallas_kernels.py:93"),
            ("mobius_dense_pallas", "hyperbolic.cu",
             "patent_tpu/ops/pallas_kernels.py:167"),
            ("quant_layer_block", "int8_layer.cu",
             "patent_tpu/ops/quant_matmul.py:1165"),
            ("quant_layer_group", "int8_layer.cu",
             "patent_tpu/ops/quant_matmul.py:1278"),
            ("quant_dense", "wgmma_s8.cuh",
             "patent_tpu/ops/quant_matmul.py:185"),
            ("quant_mlp", "wgmma_s8.cuh",
             "patent_tpu/ops/quant_matmul.py:266"),
            ("flash_attention", "flash_attention.cu",
             "patent_tpu/ops/flash_attention.py:187"),
            ("flash_attention_f32", "flash_attention_f32.cu",
             "patent_tpu/ops/flash_attention.py:187"),
            ("flash_tile_hd64_streamed", "flash_tile.cuh",
             "patent_tpu/ops/flash_attention.py:187"),
            ("flash_tile_hd80", "flash_tile.cuh",
             "patent_tpu/ops/flash_attention.py:187"),
            ("fused_attention_bwd_hd64_streamed", "fused_attention.cu",
             "patent_tpu/ops/flash_attention.py:360"),
            ("fused_attention_bwd_hd80_streamed", "fused_attention.cu",
             "patent_tpu/ops/flash_attention.py:360"),
            ("flash_attention_f32_hd80", "flash_attention_f32.cu",
             "patent_tpu/ops/flash_attention.py:187")]
    # rows 5-11's fast form (the card's default, JAX's on its TPU): the same
    # sources and TPU kernels; an entry's own count holds both forms
    rows += [(kname + "_fast", source, replaces)
             for kname, source, replaces in rows if kname in INT8_ENTRIES]
    for kname in INT8_ENTRIES:
        launches[kname] -= launches.get(kname + "_fast", 0)
    errs["bucket_topk_bf16"] = err_topk
    print(f"[phase] done at {time.perf_counter() - t_run:.0f} s")
    # one PyTorch call computes row 14's function in each dtype (up to its
    # exp2 form and roundings); none computes any of the others
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src + source,
         "replaces": replaces, "launches": launches[kname],
         "max_abs_err": errs[kname], "ms": times[kname][1],
         "plain_ms": times[kname][0], "bound_ms": bounds[kname][0],
         "bound_by": bounds[kname][1], "library_ms": library.get(kname)}
        for kname, source, replaces in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
