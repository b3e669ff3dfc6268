"""How far train_end's step metrics resolve the attention kernels at the
wide towers: readings over seeds on an NVIDIA card.

For each of chip_smoke.py's WIDE_TOWERS (seeded weights, 16 pairs, the
last 9 blocks trained) and each of six seeded batches, the loss's metrics
(no update) with the kernels and with the plain blocks, then with the
plain blocks on the pixels plus noise of std 1e-3 (HINGE_NOISE_DRAWS
draws: the yardstick) and with planted faults in every attention of the
plain blocks: the first 16 keys only (the fault chip_smoke.py's
hinge_gate plants), the last valid key dropped, and p = exp(s) where the
kernels take exp2(s).  Each line gives a metric's relative gap and, for a
fault, that gap over the root mean square of the metric's noise moves,
beside the tower features' relative gap.

    python3 hinge_seeds.py            # needs one CUDA card, ~2 minutes
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

import chip_smoke as cs

SEEDS = 6
LABELS, PATENTS = 16074, 8192
LOG2E = math.log2(math.e)


def faults(plain):
    """Planted faults, each a stand-in for the plain attention block."""
    def exp_for_exp2(x, wqkv, bqkv, wout, bout, heads, valid):
        d = x.shape[-1]
        return plain(x, torch.cat([wqkv[:, :d] * LOG2E, wqkv[:, d:]], 1),
                     torch.cat([bqkv[:d] * LOG2E, bqkv[d:]]), wout, bout,
                     heads, valid)

    return {"first 16 keys only": lambda *a: plain(*a[:-1], 16),
            "last key dropped": lambda *a: plain(*a[:-1], a[-1] - 1),
            "exp for exp2": exp_for_exp2}


def main() -> int:
    if not torch.cuda.is_available():
        print("hinge_seeds: needs a CUDA card", file=sys.stderr)
        return 1
    from patent_tpu_torch import _build
    from patent_tpu_torch.models.vit import VisionConfig
    from patent_tpu_torch.ops import flash_attention as fa
    from patent_tpu_torch.train import train_end as te
    from patent_tpu_torch.utils.config import EndToEndConfig

    _build.library()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    pairs, plain = cs.WIDE_CHECK_PAIRS, fa.fused_attention_block_plain
    for tname, fields in cs.WIDE_TOWERS.items():
        vcfg = VisionConfig(**fields)
        cfg = EndToEndConfig(batch_size=pairs)
        model, opt = te.init_end_to_end(vcfg, cfg, LABELS, seed=0,
                                        device=dev)
        _step, loss_fn = te.make_end_to_end_step(model, opt, cfg)
        for seed in range(SEEDS):
            g = torch.Generator(device=dev).manual_seed(100 + seed)
            px = vcfg.image_size
            images = torch.randn(2 * pairs, px, px, 3, generator=g,
                                 device=dev)
            pos = torch.randint(0, PATENTS, (pairs,), generator=g,
                                device=dev)
            neg = torch.randint(0, PATENTS, (pairs, 2), generator=g,
                                device=dev)
            impl = torch.randint(PATENTS, LABELS, (8192, 2), generator=g,
                                 device=dev)

            def run(pix, kernels=False):
                model.vit.kernels = kernels
                with torch.no_grad():
                    m = loss_fn(pix, pos, neg, impl, torch.Generator(
                        device=dev).manual_seed(3))[1]
                    f = model.vit(pix)
                model.vit.kernels = True
                return {k: float(v) for k, v in m.items()}, f

            ref, fref = run(images)

            def gaps(m, f):
                return ({k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ref},
                        float((f - fref).norm() / fref.norm()))

            km, kf = gaps(*run(images, True))
            noise = [gaps(*run(images + 1e-3 * torch.randn(
                images.shape, generator=g, device=dev)))
                for _ in range(cs.HINGE_NOISE_DRAWS)]
            rms = {k: math.sqrt(sum(n[0][k] ** 2 for n in noise)
                                / len(noise)) for k in ref}
            print(f"{tname} seed {seed}: features, kernels {kf:.3g}, noise "
                  f"{sum(n[1] for n in noise) / len(noise):.3g}; kernels "
                  "gap / noise rms: " + ", ".join(
                      f"{k} {km[k]:.2g} / {rms[k]:.2g} "
                      f"({km[k] / rms[k]:.2f}x)" for k in ref), flush=True)
            for name, fn in faults(plain).items():
                fa.fused_attention_block_plain = fn
                try:
                    fm, ff = gaps(*run(images))
                finally:
                    fa.fused_attention_block_plain = plain
                print(f"  fault '{name}': features {ff:.3g}; " + ", ".join(
                    f"{k} {fm[k]:.2g} ({fm[k] / rms[k]:.1f}x)"
                    for k in ref), flush=True)
        del model, opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
