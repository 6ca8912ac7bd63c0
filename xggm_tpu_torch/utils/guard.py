"""Training failure detection (counterpart of `xggm_tpu/utils/guard.py`).

Every trainer loop checks the step's scalar metrics, which it reads back for
logging anyway, and stops the moment one is not finite: a NaN loss would
otherwise corrupt every later update and surface as a useless checkpoint.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class TrainingDiverged(RuntimeError):
    """Raised when a training step produces non-finite metrics."""


def host_scalar(x) -> float:
    """The host float of a scalar metric (a one-element tensor, numpy value
    or number). Raises TypeError or ValueError for anything else."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise TypeError("a tensor of more than one element is not a "
                            "scalar metric")
        return float(x.detach().reshape(()).item())
    return float(np.asarray(x).reshape(()))


def check_step_finite(step: int, branch: str, metrics: Dict) -> None:
    """Raise TrainingDiverged listing every non-finite scalar in `metrics`;
    entries that are not scalars (e.g. 'preds') are skipped."""
    bad = {}
    for k, v in metrics.items():
        try:
            f = host_scalar(v)
        except (TypeError, ValueError):
            continue  # non-scalar (preds etc.)
        if not np.isfinite(f):
            bad[k] = f
    if bad:
        detail = ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
        raise TrainingDiverged(
            f"non-finite metrics at step {step} (branch={branch!r}): "
            f"{detail}. Common causes: lr too high for the schedule, fp16/"
            "bf16 overflow in a custom loss, or corrupt input features. "
            "The last good checkpoint is unaffected - resume with --resume "
            "after fixing the cause.")
