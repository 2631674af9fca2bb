"""Metrics log of a run: one JSON object a line in ``metrics.jsonl`` under
the run dir, always; mirrored to Weights & Biases when ``wandb`` imports
and ``wandb_mode`` is not "disabled" (offline by default, to be synced
later with ``wandb sync``).  Copy of gdkvm_tpu/io/metrics_log.py; in a
process group only rank 0 writes (on the other ranks the logger opens
nothing and ``log`` does nothing).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from gdkvm_tpu_torch.parallel.distributed import is_main_process


class MetricsLogger:
    """Append-only JSONL metrics writer with optional wandb mirror."""

    def __init__(self, run_dir: str, wandb_mode: str = "offline",
                 config: Optional[Dict[str, Any]] = None,
                 filename: str = "metrics.jsonl"):
        self.path = os.path.join(run_dir, filename)
        self._t0 = time.time()
        self._fh = None
        self._wandb = None
        if not is_main_process():
            return
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        if wandb_mode != "disabled":
            try:
                import wandb  # optional
                self._wandb = wandb.init(mode=wandb_mode, dir=run_dir,
                                         config=config or {})
            except Exception:
                self._wandb = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
