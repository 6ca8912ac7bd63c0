"""Feature stores: obj36 features and boxes by image id (counterpart of
`xggm_tpu/data/datasets.py::H5FeatureStore`).

`H5FeatureStore` reads the on-disk contract of the JAX package
({split}_obj36.h5 with per-image 'features' [36, 2048] and 'boxes' [36, 4],
plus {split}_obj36_info.json); `h5py` is imported only when one is opened.
`MemoryFeatureStore` offers the same `get`/`has`/`img_ids` surface over
arrays held in memory.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from xggm_tpu_torch.utils.io import load_json

Obj36 = Tuple[np.ndarray, np.ndarray, np.ndarray]


class H5FeatureStore:
    """Random-access obj36 features/boxes (+ optional adjacency) by img_id."""

    def __init__(self, obj_h5_path: str, info_json_path: str,
                 adj_h5_path: Optional[str] = None):
        import h5py

        self.obj_h5 = h5py.File(obj_h5_path, "r")
        info = load_json(info_json_path)
        self.info = {d["img_id"]: d for d in info}
        self.adj_h5 = h5py.File(adj_h5_path, "r") if adj_h5_path else None

    def has(self, img_id: str) -> bool:
        return img_id in self.info

    def img_ids(self) -> List[str]:
        return list(self.info.keys())

    def get(self, img_id: str) -> Obj36:
        """Returns (feats [36,2048] f32, boxes01 [36,4] f32, adj [36,36] f32),
        with the boxes divided by the image size and checked to lie in
        [0, 1]."""
        grp = self.obj_h5[str(img_id)]
        feats = np.asarray(grp["features"], dtype=np.float32)
        boxes = np.asarray(grp["boxes"], dtype=np.float32).copy()
        meta = self.info[img_id]
        if not len(boxes) == len(feats) == meta["num_boxes"]:
            raise ValueError(f"{img_id}: {len(boxes)} boxes, {len(feats)} "
                             f"features, info says {meta['num_boxes']}")
        boxes[:, (0, 2)] /= meta["img_w"]
        boxes[:, (1, 3)] /= meta["img_h"]
        np.testing.assert_array_less(boxes, 1 + 1e-5)
        np.testing.assert_array_less(-boxes, 0 + 1e-5)
        if self.adj_h5 is not None:
            adj = np.asarray(self.adj_h5[str(img_id)], dtype=np.float32)
        else:
            adj = np.zeros((feats.shape[0], feats.shape[0]), np.float32)
        return feats, boxes, adj

    def close(self) -> None:
        self.obj_h5.close()
        if self.adj_h5 is not None:
            self.adj_h5.close()


class MemoryFeatureStore:
    """`H5FeatureStore`'s surface over {img_id: (feats, boxes01)} in memory;
    the adjacency is zeros."""

    def __init__(self, items: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self.items = items

    def has(self, img_id: str) -> bool:
        return img_id in self.items

    def img_ids(self) -> List[str]:
        return list(self.items.keys())

    def get(self, img_id: str) -> Obj36:
        feats, boxes = self.items[img_id]
        n = feats.shape[0]
        return feats, boxes, np.zeros((n, n), np.float32)
