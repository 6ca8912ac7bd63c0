"""Tracing and step timing (counterpart of `xggm_tpu/utils/profiling.py`).

* `trace(logdir)`: a context manager around `torch.profiler.profile` (host
  activity, and the card's when one is present) that writes a
  TensorBoard-viewable trace file into `logdir` on exit;
* `annotate(name)`: `torch.profiler.record_function`, so that a named
  region shows in the trace;
* `StepTimer`: rolling wall time per step; `sync_tick(x)` waits for the
  card that holds x's first tensor before it ticks, since CUDA launches
  return before the device finishes.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock stats. Call .tick() once per step, or .sync_tick(x)
    to wait first for the card that computes x."""

    def __init__(self, window: int = 50):
        self.times: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    def sync_tick(self, value) -> Optional[float]:
        x = next(t for t in tree_leaves(value) if isinstance(t, torch.Tensor))
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return self.tick()

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0
