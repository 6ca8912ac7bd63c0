"""Synthetic data (counterpart of `xggm_tpu/data/synthetic.py`).

`make_synthetic_gqa` writes the same miniature GQA-OOD corpus, file for file
and value for value, as the JAX package's (it needs `h5py`, imported inside
it). `synthetic_obj36` makes features and boxes in memory for a machine
without `h5py`, and `synthetic_train_batch` a whole training batch.
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
                       seed: int = 0) -> None:
    import h5py

    rng = np.random.RandomState(seed)
    gqa = os.path.join(root, "gqa_ood")
    feat = os.path.join(root, "gqa_imgfeat")
    os.makedirs(gqa, exist_ok=True)
    os.makedirs(feat, exist_ok=True)

    save_json(ANSWERS, os.path.join(gqa, "trainval_label2ans.json"))
    save_json({a: i for i, a in enumerate(ANSWERS)},
              os.path.join(gqa, "trainval_ans2label.json"))

    img_ids = [f"synth_{split}_{i}" for i in range(n_images)]
    info = []
    with h5py.File(os.path.join(feat, f"{split}_obj36.h5"), "w") as obj, \
            h5py.File(os.path.join(feat, f"{split}_obj36_adj_v2.h5"), "w") as adjf:
        for img_id in img_ids:
            w, h = int(rng.randint(200, 800)), int(rng.randint(200, 800))
            boxes = np.empty((36, 4), np.float32)
            x1 = rng.uniform(0, w * 0.8, 36)
            y1 = rng.uniform(0, h * 0.8, 36)
            boxes[:, 0] = x1
            boxes[:, 1] = y1
            boxes[:, 2] = x1 + rng.uniform(1, w - x1)
            boxes[:, 3] = y1 + rng.uniform(1, h - y1)
            grp = obj.create_group(img_id)
            grp.create_dataset("features",
                               data=rng.randn(36, feat_dim).astype(np.float32))
            grp.create_dataset("boxes", data=boxes)
            adjf.create_dataset(img_id, data=synthetic_adjacency(rng))
            info.append({"img_id": img_id, "img_h": h, "img_w": w,
                         "num_boxes": 36})
    save_json(info, os.path.join(feat, f"{split}_obj36_info.json"))

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
