"""Configuration of the port (the parts of patent_tpu/utils/config.py that
its actions use, copied without JAX).

Named serving profiles (``--profile``):

    exact        int8 tower, all tokens
    recommended  int8 tower, the 175 darkest patches (+CLS)
    turbo        int8 tower, the 127 darkest patches (+CLS): S = 128

A profile sets ``--quantize`` and ``--keep-tokens`` where the command line
left them unset; explicit flags win.  ``ClipFinetuneConfig`` holds the
fine-tune's defaults (retrieval.ipynb cell 20), ``HypTrainConfig`` the
hyperbolic model's and train_hyp's (the serving actions test / infer / dist
read its widths and curvature), ``HypConTrainConfig`` train_hyp_con's, and
``apply_overrides`` applies ``key=value`` command-line overrides to any of
them.
"""

from __future__ import annotations

import dataclasses
import json
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


@dataclasses.dataclass
class HypTrainConfig:
    """The hyperbolic retrieval model and train_hyp (reference
    train.py:4008-4055): CLIP features of 512, one hidden layer of 256, an
    embedding of 128, curvature 2.  ``retrieval_penalty`` multiplies the
    retrieval loss (the reference adds it as a constant by mistake);
    ``validate_with`` selects the best epoch by validation "loss" or by the
    label-retrieval "map"."""

    feature_dim: int = 512
    embed_dim: int = 128           # --latent_dim
    hidden_dims: tuple[int, ...] = (256,)
    curvature: float = 2.0
    label_num: int | None = None   # derived from data unless forced
    epochs: int = 150
    batch_size: int = 128
    learning_rate: float = 6e-3
    num_neg_samples: int = 1
    margin: float = 0.1
    temperature: float = 0.07
    figure_pair_weight: float = 2.0
    constraint_penalty: float = 3.0
    retrieval_penalty: float = 2.0
    reg_penalty: float = 0.01
    patience: int = 10
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    seed: int = 42
    data_dir: str = "prepared_training_data"
    model_dir: str = "models"
    use_dropout: bool = True
    validate_with: str = "loss"


@dataclasses.dataclass
class HypConTrainConfig:
    """train_hyp_con: hyperbolic InfoNCE training of the figure-only model
    (reference train.py:1792-1910)."""

    feature_dim: int = 512
    embed_dim: int = 128
    hidden_dims: tuple[int, ...] = (256,)
    curvature: float = 1.0
    epochs: int = 100
    batch_size: int = 128
    learning_rate: float = 1e-3
    temperature: float = 0.07
    patience: int = 7
    seed: int = 42
    data_dir: str = "prepared_training_data"
    model_dir: str = "models"


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key=value`` CLI overrides to a config dataclass in place:
    each value takes its field's type (bool from 1/true/yes, int, float, a
    tuple from a JSON list, str); an Optional field takes an int, or
    none/null to clear it."""
    types = {f.name: str(f.type) for f in dataclasses.fields(cfg)}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        if key not in types:
            raise ValueError(
                f"unknown config field {key!r} for {type(cfg).__name__}; "
                f"valid: {sorted(types)}")
        current = getattr(cfg, key)
        if "None" in types[key] and val.strip().lower() in ("none", "null"):
            setattr(cfg, key, None)
        elif isinstance(current, bool):
            setattr(cfg, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(current, float):
            setattr(cfg, key, float(val))
        elif isinstance(current, tuple):
            setattr(cfg, key, tuple(json.loads(val)))
        elif isinstance(current, str):
            setattr(cfg, key, val)
        else:
            setattr(cfg, key, int(val))
    return cfg
