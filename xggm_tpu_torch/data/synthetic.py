"""Synthetic data (counterpart of `xggm_tpu/data/synthetic.py`).

`make_synthetic_gqa` writes the same miniature GQA-OOD corpus, file for file
and value for value, as the JAX package's (`h5py` is imported only for its
H5 files), or the same records as a feature pack with no H5 file.
`synthetic_obj36` makes features and boxes in memory, and
`synthetic_train_batch` a whole training batch.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from xggm_tpu_torch.config import (
    MAX_SEQ_LENGTH, NUM_OBJECTS, VISUAL_FEAT_DIM)
from xggm_tpu_torch.data.datasets import MemoryFeatureStore
from xggm_tpu_torch.data.tokenizer import BertTokenizer, encode_batch
from xggm_tpu_torch.utils.io import save_json

WORDS = ["what", "is", "the", "color", "of", "shape", "near", "left", "right",
         "dog", "cat", "car", "tree", "sky", "red", "blue", "small", "large",
         "on", "a"]
ANSWERS = ["yes", "no", "red", "blue", "green", "dog", "cat", "car", "left",
           "right", "one", "two", "three", "small", "large", "table"]


def vocab_tokens() -> List[str]:
    """Minimal BERT-style WordPiece vocab covering the synthetic questions."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [
        "##s", "##er", "?", ".", ","]
    # answer words come after the original table so its token ids stay put
    return tokens + [a for a in ANSWERS if a not in tokens]


def write_vocab(path: str) -> List[str]:
    tokens = vocab_tokens()
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return tokens


def synthetic_questions(n: int, seed: int = 0) -> List[str]:
    """`n` random questions over the synthetic vocabulary."""
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, size=rng.randint(3, 10))) + " ?"
            for _ in range(n)]


def synthetic_obj36(n_images: int, feat_dim: int = VISUAL_FEAT_DIM,
                    seed: int = 0, prefix: str = "synth") -> MemoryFeatureStore:
    """Seeded obj36 features (standard normal, [36, feat_dim] float32) and
    boxes already divided by the image size, for images `{prefix}_{i}`."""
    rng = np.random.RandomState(seed)
    items = {}
    for i in range(n_images):
        w, h = int(rng.randint(200, 800)), int(rng.randint(200, 800))
        x1 = rng.uniform(0, w * 0.8, NUM_OBJECTS)
        y1 = rng.uniform(0, h * 0.8, NUM_OBJECTS)
        x2 = x1 + rng.uniform(1, w - x1)
        y2 = y1 + rng.uniform(1, h - y1)
        boxes = np.stack([x1 / w, y1 / h, x2 / w, y2 / h], -1)
        feats = rng.randn(NUM_OBJECTS, feat_dim).astype(np.float32)
        items[f"{prefix}_{i}"] = (feats, boxes.astype(np.float32))
    return MemoryFeatureStore(items)


def synthetic_adjacency(rng: np.random.RandomState) -> np.ndarray:
    """A symmetric [36, 36] float32 relation matrix scaled to max 1, as the
    synthetic corpus stores it."""
    a = rng.rand(NUM_OBJECTS, NUM_OBJECTS).astype(np.float32)
    a = (a + a.T) / 2
    return a / a.max()


def synthetic_train_batch(n: int, num_answers: int,
                          feat_dim: int = VISUAL_FEAT_DIM,
                          seq_len: int = MAX_SEQ_LENGTH,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """One training batch of `n` synthetic questions on `n` synthetic
    images: input_ids, input_mask, segment_ids [n, seq_len] int32 from the
    tokenized questions, feats [n, 36, feat_dim] and boxes [n, 36, 4]
    float32, adj [n, 36, 36] float32 and one-hot targets [n, num_answers]."""
    tokenizer = BertTokenizer({t: i for i, t in enumerate(vocab_tokens())})
    ids, mask, segs = encode_batch(tokenizer, synthetic_questions(n, seed),
                                   seq_len)
    feats, boxes = zip(*synthetic_obj36(n, feat_dim, seed).items.values())
    rng = np.random.RandomState(seed)
    return {
        "input_ids": ids, "input_mask": mask, "segment_ids": segs,
        "feats": np.stack(feats), "boxes": np.stack(boxes),
        "adj": np.stack([synthetic_adjacency(rng) for _ in range(n)]),
        "target": np.eye(num_answers, dtype=np.float32)[
            rng.randint(0, num_answers, n)],
    }


def make_synthetic_gqa(root: str, split: str = "train", n_images: int = 32,
                       n_questions: int = 96, feat_dim: int = 2048,
                       seed: int = 0, pack: bool = False) -> None:
    """The miniature GQA-OOD corpus of the JAX package's
    `make_synthetic_gqa`: questions, answer vocabulary, image info and, per
    image, obj36 features, boxes and an adjacency. With `pack=False` the
    features go to `{split}_obj36.h5` and `{split}_obj36_adj_v2.h5` (needs
    `h5py`); with `pack=True` to `{split}_obj36.xpack` and its index, with
    the boxes divided by the image size, in the H5 files' key order (sorted
    by name), as `convert_h5_to_xpack` of the H5 corpus writes it, and no
    H5 file. Both modes draw the same random stream."""
    rng = np.random.RandomState(seed)
    gqa = os.path.join(root, "gqa_ood")
    feat = os.path.join(root, "gqa_imgfeat")
    os.makedirs(gqa, exist_ok=True)
    os.makedirs(feat, exist_ok=True)

    save_json(ANSWERS, os.path.join(gqa, "trainval_label2ans.json"))
    save_json({a: i for i, a in enumerate(ANSWERS)},
              os.path.join(gqa, "trainval_ans2label.json"))

    img_ids = [f"synth_{split}_{i}" for i in range(n_images)]
    info, records = [], {}
    for img_id in img_ids:
        w, h = int(rng.randint(200, 800)), int(rng.randint(200, 800))
        boxes = np.empty((36, 4), np.float32)
        x1 = rng.uniform(0, w * 0.8, 36)
        y1 = rng.uniform(0, h * 0.8, 36)
        boxes[:, 0] = x1
        boxes[:, 1] = y1
        boxes[:, 2] = x1 + rng.uniform(1, w - x1)
        boxes[:, 3] = y1 + rng.uniform(1, h - y1)
        feats = rng.randn(36, feat_dim).astype(np.float32)
        records[img_id] = (feats, boxes, synthetic_adjacency(rng))
        info.append({"img_id": img_id, "img_h": h, "img_w": w,
                     "num_boxes": 36})
    save_json(info, os.path.join(feat, f"{split}_obj36_info.json"))
    if pack:
        _write_pack(records, info, os.path.join(feat, f"{split}_obj36.xpack"),
                    feat_dim)
    else:
        _write_h5(records, feat, split)

    questions = []
    for qi in range(n_questions):
        sent = " ".join(rng.choice(WORDS, size=rng.randint(3, 10))) + " ?"
        ans = ANSWERS[rng.randint(len(ANSWERS))]
        questions.append({
            "question_id": f"q{split}{qi:05d}",
            "img_id": img_ids[qi % n_images],
            "sent": sent,
            "label": {ans: 1.0},
        })
    save_json(questions, os.path.join(gqa, f"{split}.json"))


def _write_h5(records, feat_dir: str, split: str) -> None:
    import h5py

    with h5py.File(os.path.join(feat_dir, f"{split}_obj36.h5"), "w") as obj, \
            h5py.File(os.path.join(feat_dir, f"{split}_obj36_adj_v2.h5"),
                      "w") as adjf:
        for img_id, (feats, boxes, adj) in records.items():
            grp = obj.create_group(img_id)
            grp.create_dataset("features", data=feats)
            grp.create_dataset("boxes", data=boxes)
            adjf.create_dataset(img_id, data=adj)


def _write_pack(records, info, path: str, feat_dim: int) -> None:
    from xggm_tpu_torch.data.xpack import write_xpack

    size = {d["img_id"]: (d["img_w"], d["img_h"]) for d in info}

    def normalised():
        for img_id in sorted(records):
            feats, boxes, adj = records[img_id]
            w, h = size[img_id]
            boxes = boxes.copy()
            boxes[:, (0, 2)] /= w
            boxes[:, (1, 3)] /= h
            yield img_id, feats, boxes, adj

    write_xpack(normalised(), path, feat_dim)
