"""Configuration of the port (the parts of patent_tpu/utils/config.py that
its actions use, copied without JAX).

Named serving profiles (``--profile``):

    exact        int8 tower, all tokens
    recommended  int8 tower, the 175 darkest patches (+CLS)
    turbo        int8 tower, the 127 darkest patches (+CLS): S = 128

A profile sets ``--quantize`` and ``--keep-tokens`` where the command line
left them unset; explicit flags win.  ``ClipFinetuneConfig`` holds the
fine-tune's defaults (retrieval.ipynb cell 20), and ``apply_overrides``
applies ``key=value`` command-line overrides to it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

SERVING_PROFILES: dict[str, dict] = {
    "exact": {"quantize": True, "keep_tokens": None},
    "recommended": {"quantize": True, "keep_tokens": 175},
    "turbo": {"quantize": True, "keep_tokens": 127},
}


@dataclasses.dataclass
class ClipFinetuneConfig:
    """CLIP fine-tune with graph alignment (retrieval.ipynb cell 20).

    The attention kernels clamp exp2-domain scores at +80 and zero the
    gradient of saturated scores; if fine-tuning drives attention entropy
    collapse, learning through those heads stops.  Probe with
    ``ops.flash_attention.attention_saturation`` if the validation loss
    stalls.  The tower is the JAX one with ``fused_mlp`` and ``cls_last``
    set, the only one the port trains, so neither is a field here."""

    epochs: int = 8
    batch_size: int = 64           # anchors per batch (2B images on device)
    image_size: int = 224
    alpha_max: float = 0.1         # alignment weight, warm-up over 5 epochs
    warmup_epochs: int = 5
    init_tau: float = 0.10
    lr_clip: float = 2e-5
    lr_proj: float = 2e-4
    lr_embed: float = 1e-4
    lr_logit_scale: float = 5e-4
    weight_decay: float = 1e-2
    trainable_blocks: int = 9      # last 9 vision layers (cell 20)
    graph_proj_dim: int = 128
    val_every: int = 60            # batches (cell 20)
    num_workers: int = 8           # decode threads
    seed: int = 42
    # ink-mass token selection during fine-tuning (models/vit.py
    # keep_tokens): the top-k indices are constants of the data, the
    # gather passes gradients
    keep_tokens: int | None = None


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key=value`` CLI overrides to a config dataclass in place:
    each value takes its field's type (int or float); an Optional field
    takes an int, or none/null to clear it."""
    types = {f.name: str(f.type) for f in dataclasses.fields(cfg)}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        if key not in types:
            raise ValueError(
                f"unknown config field {key!r} for {type(cfg).__name__}; "
                f"valid: {sorted(types)}")
        if "None" in types[key] and val.strip().lower() in ("none", "null"):
            setattr(cfg, key, None)
        elif isinstance(getattr(cfg, key), float):
            setattr(cfg, key, float(val))
        else:
            setattr(cfg, key, int(val))
    return cfg
