"""File helpers (copy of `xggm_tpu/utils/io.py`): JSON, pickle, text lines
and the obj36 H5 feature files (h5py imported only when one is opened)."""
from __future__ import annotations

import json
import pickle
from typing import Any, List


def load_json(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_json(obj: Any, path: str, indent: int = 4, sort_keys: bool = False) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=indent, sort_keys=sort_keys)


def load_pickle(path: str) -> Any:
    """Unpickle `path`, retrying as latin-1 for a Python 2 pickle. Unpickling
    runs code: load only files this program or a trusted source wrote."""
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            return pickle.load(f, encoding="latin-1")


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_txt_lines(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f]


def load_obj_h5(path: str):
    """An obj36 H5 file (one group per image), open for reading: the h5py
    File handle, which the caller closes."""
    import h5py

    return h5py.File(path, "r")
