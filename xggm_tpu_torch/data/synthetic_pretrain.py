"""Synthetic LXMERT pretraining corpus in the reference's on-disk format
(counterpart of `xggm_tpu/data/synthetic_pretrain.py`):
data/lxmert/{source}.json + all_ans.json + vocab.txt, and per source the
obj36 features, as an H5 file with its info json (the JAX package's
layout, byte for byte) or, with `tsv=True`, as `{source}_obj36.tsv`, which
needs no h5py."""
from __future__ import annotations

import os
from typing import List

import numpy as np

from xggm_tpu_torch.data.pretrain_data import write_obj_tsv
from xggm_tpu_torch.data.synthetic import ANSWERS, WORDS, write_vocab
from xggm_tpu_torch.utils.io import save_json

_H5_FIELDS = ("features", "boxes", "objects_id", "objects_conf", "attrs_id",
              "attrs_conf")


def make_synthetic_pretrain(root: str, source: str = "mscoco_train",
                            n_images: int = 16, sents_per_img: int = 3,
                            feat_dim: int = 2048, seed: int = 0,
                            tsv: bool = False) -> None:
    rng = np.random.RandomState(seed)
    lx = os.path.join(root, "lxmert")
    featdir = os.path.join(root, "lxmert_imgfeat")
    os.makedirs(lx, exist_ok=True)
    os.makedirs(featdir, exist_ok=True)

    save_json([{"ans": a, "dsets": ["vqa", "gqa"]} for a in ANSWERS],
              os.path.join(lx, "all_ans.json"))
    write_vocab(os.path.join(root, "vocab.txt"))

    img_ids = [f"pt_{source}_{i}" for i in range(n_images)]
    data, items = [], []
    for img_id in img_ids:
        w, h = int(rng.randint(200, 600)), int(rng.randint(200, 600))
        x1 = rng.uniform(0, w * 0.8, 36)
        y1 = rng.uniform(0, h * 0.8, 36)
        boxes = np.stack([x1, y1, x1 + rng.uniform(1, w - x1),
                          y1 + rng.uniform(1, h - y1)], axis=1
                         ).astype(np.float32)
        items.append({
            "img_id": img_id, "img_h": h, "img_w": w, "num_boxes": 36,
            "features": rng.randn(36, feat_dim).astype(np.float32),
            "boxes": boxes,
            "objects_id": rng.randint(0, 1600, 36).astype(np.int64),
            "objects_conf": rng.rand(36).astype(np.float32),
            "attrs_id": rng.randint(0, 400, 36).astype(np.int64),
            "attrs_conf": rng.rand(36).astype(np.float32)})

        sents: List[str] = [
            " ".join(rng.choice(WORDS, size=rng.randint(3, 9)))
            for _ in range(sents_per_img)]
        qa_sents = [
            " ".join(rng.choice(WORDS, size=rng.randint(3, 9))) + " ?"
            for _ in range(sents_per_img)]
        labels = [{ANSWERS[rng.randint(len(ANSWERS))]: 1.0}
                  for _ in range(sents_per_img)]
        data.append({
            "img_id": img_id,
            "sentf": {"mscoco": sents, "vqa": qa_sents},
            "labelf": {"vqa": labels},
        })
    if tsv:
        write_obj_tsv(os.path.join(featdir, f"{source}_obj36.tsv"), items)
    else:
        import h5py

        with h5py.File(os.path.join(featdir, f"{source}_obj36.h5"), "w") as f:
            for item in items:
                g = f.create_group(item["img_id"])
                for key in _H5_FIELDS:
                    g.create_dataset(key, data=item[key])
        save_json([{k: item[k] for k in ("img_id", "img_h", "img_w",
                                         "num_boxes")} for item in items],
                  os.path.join(featdir, f"{source}_obj36_info.json"))
    save_json(data, os.path.join(lx, f"{source}.json"))
