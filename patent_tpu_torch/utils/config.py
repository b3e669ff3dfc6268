"""Named serving profiles (``--profile``), as in patent_tpu/utils/config.py.

    exact        int8 tower, all tokens
    recommended  int8 tower, the 175 darkest patches (+CLS)
    turbo        int8 tower, the 127 darkest patches (+CLS): S = 128

A profile sets ``--quantize`` and ``--keep-tokens`` where the command line
left them unset; explicit flags win.
"""

from __future__ import annotations

SERVING_PROFILES: dict[str, dict] = {
    "exact": {"quantize": True, "keep_tokens": None},
    "recommended": {"quantize": True, "keep_tokens": 175},
    "turbo": {"quantize": True, "keep_tokens": 127},
}
