"""XPack: packed binary feature records and their native batch loader
(counterpart of `xggm_tpu/data/xpack.py`).

A pack lays each image's fixed-shape record (feats [36, F] f32 | boxes01
[36, 4] f32 | adj [36, 36] f32) out contiguously in one binary file, with a
JSON index `{path}.index.json` ({"img_ids": [...], "feat_dim": F}).
`write_xpack` writes one from arrays, `convert_h5_to_xpack` from the H5
corpus. The host C++ library `xggm_tpu_torch/csrc/xpack_loader.cpp` (mmap,
thread-pool gather, asynchronous submit/wait) assembles batches; it is
built with g++ on first use into `build/xggm_tpu_torch/libxpack.so`. Where
it cannot be built, `XPack` gathers through a numpy memmap, and
`XPack.native` says which path runs.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from xggm_tpu_torch.config import NUM_OBJECTS
from xggm_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
from xggm_tpu_torch.utils.io import load_json, save_json

SOURCE = os.path.join(CSRC_DIR, "xpack_loader.cpp")
SO_PATH = os.path.join(BUILD_DIR, "libxpack.so")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# (img_id, feats [36, F], boxes divided by the image size [36, 4],
#  adj [36, 36] or None for zeros)
Record = Tuple[str, np.ndarray, np.ndarray, Optional[np.ndarray]]


def _build() -> None:
    """g++ the loader into SO_PATH, through a temporary file that is moved
    into place, so that concurrent builds never load a partial library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_native() -> Optional[ctypes.CDLL]:
    """Load the native loader, building it first when it is missing or
    older than its source; None when it cannot be built."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if (not os.path.exists(SO_PATH)
                or os.path.getmtime(SO_PATH) < os.path.getmtime(SOURCE)):
            try:
                _build()
            except (OSError, subprocess.CalledProcessError):
                return None
        lib = ctypes.CDLL(SO_PATH)
        lib.xp_open.restype = ctypes.c_void_p
        lib.xp_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64]
        lib.xp_close.restype = None
        lib.xp_close.argtypes = [ctypes.c_void_p]
        lib.xp_gather.restype = ctypes.c_int
        lib.xp_gather.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_void_p]
        lib.xp_submit.restype = ctypes.c_void_p
        lib.xp_submit.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_void_p]
        lib.xp_wait.restype = ctypes.c_int
        lib.xp_wait.argtypes = [ctypes.c_void_p]
        lib.xp_n_items.restype = ctypes.c_int64
        lib.xp_n_items.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def record_spec(feat_dim: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [("feats", (NUM_OBJECTS, feat_dim)),
            ("boxes", (NUM_OBJECTS, 4)),
            ("adj", (NUM_OBJECTS, NUM_OBJECTS))]


def record_floats(feat_dim: int) -> int:
    return sum(int(np.prod(shape)) for _, shape in record_spec(feat_dim))


def write_xpack(records: Iterable[Record], out_path: str,
                feat_dim: int) -> str:
    """Write `records` as a pack at `out_path` and its index beside it."""
    n_floats = record_floats(feat_dim)
    img_ids = []
    with open(out_path, "wb") as f:
        for img_id, feats, boxes01, adj in records:
            if adj is None:
                adj = np.zeros((NUM_OBJECTS, NUM_OBJECTS), np.float32)
            rec = np.concatenate([np.asarray(feats, np.float32).ravel(),
                                  np.asarray(boxes01, np.float32).ravel(),
                                  np.asarray(adj, np.float32).ravel()])
            if rec.size != n_floats:
                raise ValueError(f"{img_id}: {rec.size} floats, a record of "
                                 f"feat_dim {feat_dim} holds {n_floats}")
            f.write(rec.tobytes())
            img_ids.append(img_id)
    save_json({"img_ids": img_ids, "feat_dim": feat_dim},
              out_path + ".index.json")
    return out_path


def convert_h5_to_xpack(obj_h5: str, info_json: str, adj_h5: Optional[str],
                        out_path: str, feat_dim: int = 2048) -> str:
    """One-time H5 -> xpack conversion; the boxes are divided by the image
    size here, once, rather than at every read."""
    import h5py

    info = {d["img_id"]: d for d in load_json(info_json)}
    with h5py.File(obj_h5, "r") as obj:
        adj = h5py.File(adj_h5, "r") if adj_h5 else None
        try:
            def records():
                for img_id in (i for i in obj.keys() if i in info):
                    g, meta = obj[img_id], info[img_id]
                    boxes = np.asarray(g["boxes"], np.float32).copy()
                    boxes[:, (0, 2)] /= meta["img_w"]
                    boxes[:, (1, 3)] /= meta["img_h"]
                    yield (img_id, np.asarray(g["features"], np.float32),
                           boxes, None if adj is None
                           else np.asarray(adj[img_id], np.float32))

            return write_xpack(records(), out_path, feat_dim)
        finally:
            if adj is not None:
                adj.close()


class XPack:
    """Batch reader over a pack file; native when the library loads."""

    def __init__(self, path: str):
        with open(path + ".index.json") as f:
            index = json.load(f)
        self.img_ids: List[str] = index["img_ids"]
        self.feat_dim: int = index["feat_dim"]
        self.id2row = {i: r for r, i in enumerate(self.img_ids)}
        self.n_floats = record_floats(self.feat_dim)
        self.item_bytes = self.n_floats * 4

        self._lib = ensure_native()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.xp_open(
                path.encode(), len(self.img_ids), self.item_bytes)
            if not self._handle:
                self._lib = None
        if self._handle is None:
            self._mm = np.memmap(path, dtype=np.float32, mode="r",
                                 shape=(len(self.img_ids), self.n_floats))

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _rows(self, rows: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(rows, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.img_ids)):
            raise IndexError(f"rows outside [0, {len(self.img_ids)})")
        return idx

    def gather_rows(self, rows: Sequence[int]) -> np.ndarray:
        """[n, n_floats] float32 batch of raw records."""
        idx = self._rows(rows)
        if self._handle is None:
            return np.asarray(self._mm[idx])
        out = np.empty((len(idx), self.n_floats), np.float32)
        rc = self._lib.xp_gather(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"xp_gather failed: {rc}")
        return out

    def submit(self, rows: Sequence[int]) -> Tuple[object, np.ndarray]:
        """Start an asynchronous gather; returns (job, out). `out` is valid
        after `wait(job)`."""
        idx = self._rows(rows)
        out = np.empty((len(idx), self.n_floats), np.float32)
        if self._handle is None:
            out[:] = self._mm[idx]
            return None, out
        job = self._lib.xp_submit(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.c_void_p))
        if not job:
            raise RuntimeError("xp_submit failed")
        # idx and out stay referenced by the caller until wait
        return (job, idx), out

    def wait(self, job) -> None:
        if job is not None:
            self._lib.xp_wait(job[0])

    def unpack(self, raw: np.ndarray) -> Dict[str, np.ndarray]:
        """[n, n_floats] -> feats, boxes and adj batch arrays (views)."""
        n = raw.shape[0]
        out, off = {}, 0
        for name, shape in record_spec(self.feat_dim):
            size = int(np.prod(shape))
            out[name] = raw[:, off:off + size].reshape((n,) + shape)
            off += size
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.xp_close(self._handle)
            self._handle = None


class XPackFeatureStore:
    """`H5FeatureStore`'s surface over a pack, plus a whole-batch
    `get_batch`, which `GraphBatchDataset` uses when a store has one."""

    def __init__(self, pack_path: str):
        self.pack = XPack(pack_path)

    def has(self, img_id: str) -> bool:
        return img_id in self.pack.id2row

    def img_ids(self) -> List[str]:
        return list(self.pack.img_ids)

    def get(self, img_id: str):
        rec = self.pack.unpack(self.pack.gather_rows([self.pack.id2row[img_id]]))
        return rec["feats"][0], rec["boxes"][0], rec["adj"][0]

    def get_batch(self, img_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        rows = [self.pack.id2row[i] for i in img_ids]
        return self.pack.unpack(self.pack.gather_rows(rows))

    def close(self) -> None:
        self.pack.close()
