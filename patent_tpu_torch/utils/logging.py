"""Training metrics to stdout and JSONL (port of
patent_tpu/utils/logging.py): ``log(step, metrics)`` appends a JSON line
to ``<log_dir>/<run_name>.jsonl`` and prints a compact line every
``print_every`` steps or when asked; with ``use_wandb`` it also forwards
to wandb in offline mode where the package is installed, and goes on
without it where it is not."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class MetricsLogger:
    def __init__(self, log_dir: str | None = None, run_name: str = "run",
                 use_wandb: bool = False, wandb_project: str | None = None,
                 print_every: int = 10):
        self.print_every = print_every
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project or run_name, name=run_name,
                           mode=os.environ.get("WANDB_MODE", "offline"))
                self._wandb = wandb
            except Exception:   # absent or unusable: log without it
                self._wandb = None
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, Any], *, prefix: str = "",
            force_print: bool = False) -> None:
        record = {f"{prefix}{k}": (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}
        record["step"] = step
        record["wall_time"] = round(time.time() - self._t0, 3)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=step)
        if force_print or (self.print_every and step % self.print_every == 0):
            parts = [f"step {step}"]
            parts += [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in record.items()
                      if k not in ("step", "wall_time")]
            print("  ".join(parts), flush=True)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
