"""Preemption-safe training (counterpart of `xggm_tpu/utils/preempt.py`):
catch the scheduler's eviction notice, save a mid-epoch checkpoint, and
resume where the run stopped.

A SIGTERM (or any signal given to `PreemptionGuard`) sets a flag; the
trainer polls `should_save(step)` at each step boundary, saves `PREEMPT`
and raises `Preempted`, and the CLI exits with `PREEMPTED_EXIT_CODE`, so a
wrapper restarts it with `--resume`.

In a data group of more than one rank every rank must stop at the same step
boundary: a rank that stops while another enters the next step's
all-reduce would hang it. The JAX package agrees on the step through its
coordination service; here `should_save` all-reduces the local flag (a MAX
of one int) at every step boundary, so a SIGTERM on any rank makes every
rank save `PREEMPT` and exit at the same step.

The `PREEMPT` checkpoint holds the host's `random.Random` as a fixed-shape
array (`pack_rng_state`), as the JAX package stores it.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable

import numpy as np

from xggm_tpu_torch.parallel.mesh import any_rank

# "transient failure, retry me" (BSD sysexits EX_TEMPFAIL): a scheduler or
# wrapper restarts the run with --resume
PREEMPTED_EXIT_CODE = 75


class Preempted(Exception):
    """Raised by the trainer after the preemption checkpoint is committed."""


class PreemptionGuard:
    """Signal-to-step-boundary bridge. Install once, poll every step."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 install: bool = True, mesh=None):
        self._flag = threading.Event()
        self.mesh = mesh
        self._prev = {}
        if install and threading.current_thread() is threading.main_thread():
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(signum)
        # chain a handler installed before this one, never re-raise
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def notify(self) -> None:
        """A preemption notice from the program (tests, in-process
        schedulers)."""
        self._flag.set()

    @property
    def signaled(self) -> bool:
        return self._flag.is_set()

    def should_save(self, step_id: int) -> bool:
        """True when this step boundary is the point to save and exit: as
        soon as the flag is set on any rank, the same answer on every rank
        (one all-reduce per call in a group of more than one). `step_id` is
        the run's step count, kept for the JAX package's signature."""
        return any_rank(self._flag.is_set(), self.mesh)

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()


# random.Random state = (version, 624 Mersenne words + position, gauss_next),
# as uint64[628]: version, has_gauss, the 625 words, the gauss carry's bits.

def pack_rng_state(rng) -> np.ndarray:
    version, internal, gauss_next = rng.getstate()
    if version != 3 or len(internal) != 625:
        raise ValueError(f"unsupported random.Random state v{version}")
    has_gauss = gauss_next is not None
    head = np.asarray([version, int(has_gauss)], dtype=np.uint64)
    words = np.asarray(internal, dtype=np.uint64)
    tail = np.asarray(
        [gauss_next if has_gauss else 0.0], np.float64).view(np.uint64)
    return np.concatenate([head, words, tail])


def unpack_rng_state(rng, packed: np.ndarray) -> None:
    a = np.asarray(packed, dtype=np.uint64)
    if a.shape != (628,):
        raise ValueError(f"bad packed rng state shape {a.shape}")
    gauss = float(a[-1:].view(np.float64)[0]) if int(a[1]) else None
    rng.setstate((int(a[0]), tuple(int(x) for x in a[2:-1]), gauss))


# np.random.RandomState (legacy MT19937): ('MT19937', uint32[624] key, pos,
# has_gauss, cached_gaussian) as uint64[627]: pos, has_gauss, the key, the
# cached gaussian's bits.

def pack_np_rng_state(rng: np.random.RandomState) -> np.ndarray:
    name, key, pos, has_gauss, cached = rng.get_state()
    if name != "MT19937" or key.shape != (624,):
        raise ValueError(f"unsupported np RandomState bit generator {name}")
    head = np.asarray([pos, int(has_gauss)], dtype=np.uint64)
    tail = np.asarray([cached], np.float64).view(np.uint64)
    return np.concatenate([head, key.astype(np.uint64), tail])


def unpack_np_rng_state(rng: np.random.RandomState,
                        packed: np.ndarray) -> None:
    a = np.asarray(packed, dtype=np.uint64)
    if a.shape != (627,):
        raise ValueError(f"bad packed np rng state shape {a.shape}")
    rng.set_state((
        "MT19937", a[2:-1].astype(np.uint32), int(a[0]), int(a[1]),
        float(a[-1:].view(np.float64)[0])))
