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
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch

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
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # per committed save: name, seconds to snapshot and to commit, bytes
        self.history: List[Dict[str, Any]] = []

    def _path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def save(self, name: str, state: Dict[str, Any]) -> None:
        """Save `state` under `name`. Returns once it is copied to the
        host; the disk commit runs in the background (`wait` joins it)."""
        self.wait()  # one commit at a time
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
        """Barrier for the background commit; raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint commit failed") from err

    def load(self, name: str) -> Dict[str, Any]:
        """The state saved under `name`, with its tensors on the CPU."""
        self.wait()
        return torch.load(os.path.join(self._path(name), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def exists(self, name: str) -> bool:
        self.wait()
        return os.path.isdir(self._path(name))

    def remove(self, name: str) -> None:
        """Delete a checkpoint if present."""
        self.wait()
        path = self._path(name)
        if os.path.isdir(path):
            shutil.rmtree(path)

    def latest_epoch(self) -> Optional[int]:
        """The newest BEST_{epoch} checkpoint's epoch, None if there is
        none."""
        self.wait()
        best = -1
        for d in os.listdir(self.output_dir):
            if d.startswith("BEST_"):
                try:
                    best = max(best, int(d.split("_")[1]))
                except ValueError:
                    pass
        return best if best >= 0 else None
