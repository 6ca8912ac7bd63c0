"""Checkpoints in the port's own format (counterpart of
`xggm_tpu/checkpoint/manager.py`, with its surface and semantics).

Each name ('BEST', 'BEST_2', ...) is a directory under the output directory
holding one `torch.save` file of a state: nested dicts and lists of tensors
and plain values (the trainer saves the model's `state_dict`, the BertAdam
state's `state_dict` and the epoch). The JAX package's orbax checkpoints
cannot be read without JAX.

`save` copies the state to owned host tensors before it returns (the train
steps update the parameters and moments in place, so a view would change
under the commit) and commits on a background thread: into a temporary
directory, then moved into place with `os.replace`, so that a crash never
leaves a partial checkpoint under the name. One commit runs at a time;
`wait` is the barrier and re-raises a failed commit's error.

In a world of more than one rank (`mesh`) every rank calls the same
methods at the same points: the caller has gathered a ZeRO-1 state's slices
within the data group and the tensor-parallel slices within the model
group first (`training/steps.py::whole_snapshot`), so the file has the
single-rank format, and restores re-slice it
(`training/steps.py::restore_snapshot`); global rank 0 alone commits and
removes, and `wait` ends at a barrier of every rank (`host_barrier`), so
no rank reads or leaves before rank 0's commit is on disk. What a rank finds on disk is
rank 0's answer (`exists`, `latest_epoch` and `load` read on rank 0 and
broadcast, `parallel/mesh.py::from_rank0`), so every rank resumes the same
checkpoint even where a host's disk lacks rank 0's commits.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from xggm_tpu_torch.parallel.distributed import host_barrier
from xggm_tpu_torch.parallel.mesh import from_rank0

STATE_FILE = "state.pt"


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x


class CheckpointManager:
    def __init__(self, output_dir: str, mesh=None):
        self.output_dir = os.path.abspath(output_dir)
        self._mesh = mesh
        self._ranks = 1 if mesh is None else mesh.world_size
        self.primary = mesh is None or mesh.primary
        os.makedirs(self.output_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # per committed save: name, seconds to snapshot and to commit, bytes
        self.history: List[Dict[str, Any]] = []

    def _path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def save(self, name: str, state: Dict[str, Any]) -> None:
        """Save `state` under `name`. Returns once it is copied to the
        host; the disk commit runs in the background (`wait` joins it).
        Only rank 0 saves."""
        self.wait()  # one commit at a time
        if not self.primary:
            return
        t0 = time.perf_counter()
        snapshot = _host_copy(state)
        snapshot_s = time.perf_counter() - t0
        self._thread = threading.Thread(
            target=self._commit, args=(name, snapshot, snapshot_s),
            daemon=True)
        self._thread.start()

    def _commit(self, name: str, snapshot: Dict[str, Any],
                snapshot_s: float) -> None:
        try:
            t0 = time.perf_counter()
            path = self._path(name)
            tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=self.output_dir)
            torch.save(snapshot, os.path.join(tmp, STATE_FILE))
            nbytes = os.path.getsize(os.path.join(tmp, STATE_FILE))
            old = None
            if os.path.isdir(path):
                old = tempfile.mkdtemp(prefix=f".{name}.old.",
                                       dir=self.output_dir)
                os.replace(path, os.path.join(old, name))
            os.replace(tmp, path)
            if old is not None:
                shutil.rmtree(old)
            self.history.append(dict(name=name, snapshot_s=snapshot_s,
                                     commit_s=time.perf_counter() - t0,
                                     bytes=nbytes))
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Barrier for the background commit, and for every rank; raises if
        the commit failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint commit failed") from err
        if self._ranks > 1:
            host_barrier("checkpoint")

    def load(self, name: str) -> Dict[str, Any]:
        """The state saved under `name`, with its tensors on the CPU."""
        self.wait()
        return from_rank0(
            lambda: torch.load(os.path.join(self._path(name), STATE_FILE),
                               map_location="cpu", weights_only=True),
            self._mesh)

    def exists(self, name: str) -> bool:
        self.wait()
        return from_rank0(lambda: os.path.isdir(self._path(name)), self._mesh)

    def remove(self, name: str) -> None:
        """Delete a checkpoint if present (rank 0 deletes)."""
        self.wait()
        path = self._path(name)
        if self.primary and os.path.isdir(path):
            shutil.rmtree(path)
        if self._ranks > 1:
            host_barrier("checkpoint_remove")

    def latest_epoch(self) -> Optional[int]:
        """The newest BEST_{epoch} checkpoint's epoch, None if there is
        none."""
        self.wait()
        return from_rank0(self._latest_epoch_here, self._mesh)

    def _latest_epoch_here(self) -> Optional[int]:
        best = -1
        for d in os.listdir(self.output_dir):
            if d.startswith("BEST_"):
                try:
                    best = max(best, int(d.split("_")[1]))
                except ValueError:
                    pass
        return best if best >= 0 else None
