"""Metrics logging (counterpart of `xggm_tpu/training/metrics.py`).

Writes `metrics.jsonl` always, and TensorBoard scalars when
`torch.utils.tensorboard` imports, under the same scalar names. A logger
made with no output directory is muted: the trainers give every rank but
rank 0 one, so that one process writes the run's files.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from xggm_tpu_torch.utils.guard import host_scalar


class MetricsLogger:
    SCALAR_MAP = {
        "clean_loss": "Train/batch_loss",
        "ggm_loss": "Train/ggm_loss",
        "d_loss": "Train/d_loss",
        "loss_grad": "Train/loss_grad",
        "loss_sm": "Train/loss_sm",
    }

    def __init__(self, output_dir: Optional[str]):
        self.output_dir = output_dir
        self.jsonl = self.tb = None
        if output_dir is None:
            return
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self.tb = SummaryWriter(os.path.join(output_dir, "logs"))

    def log_step(self, step: int, metrics: Dict, branch: str = "") -> None:
        if self.jsonl is None:
            return
        rec = {"step": step, "branch": branch, "ts": time.time()}
        for k, v in metrics.items():
            if k == "preds":
                continue
            try:
                rec[k] = host_scalar(v)
            except (TypeError, ValueError):
                continue
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k in self.SCALAR_MAP:
                    self.tb.add_scalar(self.SCALAR_MAP[k], v, step)

    def log_scalar(self, name: str, value: float, step: int) -> None:
        if self.jsonl is None:
            return
        self.jsonl.write(json.dumps(
            {"step": step, name: float(value), "ts": time.time()}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(name, value, step)

    def dump_config(self, cfg_dict: Dict, name: str = "args.json") -> None:
        """Write `cfg_dict` as `name` in the output directory (JSON, indent
        2, any other value as its str); a muted logger writes nothing."""
        if self.output_dir is None:
            return
        with open(os.path.join(self.output_dir, name), "w") as f:
            json.dump(cfg_dict, f, indent=2, default=str)
