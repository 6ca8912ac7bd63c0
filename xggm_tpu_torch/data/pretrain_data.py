"""LXMERT pretraining data (a copy, without JAX, of
`xggm_tpu/data/pretrain_data.py`; host code, numpy only).

* aggregated corpora jsons (data/lxmert/{source}.json) with per-image
  sentence/label families, answers normalized through the AnswerTable;
* sentence-level flattening into (uid, img_id, sent, label) examples;
* obj36 features from TSV (base64-encoded Faster-RCNN fields) or H5;
* featurization per batch: 80/10/10 word masking at --wordMaskRate,
  80/10/10 object-feature masking at --objMaskRate, 50% mismatched-pair
  sampling for the matched task, QA answer multinomial-sampled by score,
  every draw from the featurizer's own RandomState, so that the same seed
  gives the JAX package's batches exactly.

`write_obj_tsv` is the inverse of `load_obj_tsv`, for corpora written
where h5py is absent.
"""
from __future__ import annotations

import base64
import csv
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from xggm_tpu_torch.checkpoint.answer_table import AnswerTable
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.utils.io import load_json

TSV_FIELDNAMES = ["img_id", "img_h", "img_w", "objects_id", "objects_conf",
                  "attrs_id", "attrs_conf", "num_boxes", "boxes", "features"]


def load_obj_tsv(path: str, topk: Optional[int] = None) -> List[dict]:
    """Read a BUTD obj36 TSV with base64 fields (reference
    src/utils.py:21-62)."""
    csv.field_size_limit(sys.maxsize)
    data = []
    with open(path) as f:
        reader = csv.DictReader(f, TSV_FIELDNAMES, delimiter="\t")
        for i, item in enumerate(reader):
            for key in ("img_h", "img_w", "num_boxes"):
                item[key] = int(item[key])
            boxes = item["num_boxes"]
            decode_cfg = [("objects_id", (boxes,), np.int64),
                          ("objects_conf", (boxes,), np.float32),
                          ("attrs_id", (boxes,), np.int64),
                          ("attrs_conf", (boxes,), np.float32),
                          ("boxes", (boxes, 4), np.float32),
                          ("features", (boxes, -1), np.float32)]
            for key, shape, dtype in decode_cfg:
                item[key] = np.frombuffer(
                    base64.b64decode(item[key]), dtype=dtype).reshape(shape)
                item[key].setflags(write=False)
            data.append(item)
            if topk is not None and len(data) == topk:
                break
    return data


def write_obj_tsv(path: str, items: Sequence[dict]) -> None:
    """Write obj36 records (the fields `load_obj_tsv` returns) as a TSV
    with base64 fields, in `TSV_FIELDNAMES` order."""
    dtypes = {"objects_id": np.int64, "objects_conf": np.float32,
              "attrs_id": np.int64, "attrs_conf": np.float32,
              "boxes": np.float32, "features": np.float32}
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, TSV_FIELDNAMES, delimiter="\t",
                                lineterminator="\n")
        for item in items:
            row = {k: item[k] for k in ("img_id", "img_h", "img_w",
                                        "num_boxes")}
            for key, dtype in dtypes.items():
                row[key] = base64.b64encode(np.ascontiguousarray(
                    item[key], dtype=dtype).tobytes()).decode("ascii")
            writer.writerow(row)


def make_uid(img_id: str, dset: str, sent_idx: int) -> str:
    return f"{img_id}_{dset}_{sent_idx:03d}"


@dataclass
class PretrainExample:
    uid: str
    img_id: str
    sent: str
    label: Optional[Dict[int, float]]  # ans_id -> score (already normalized)


class LxmertPretrainDataset:
    """Aggregated corpora + answer normalization (reference
    LXMERTDataset, lxmert_data.py:41-77) and sentence flattening
    (LXMERTTorchDataset, :91-135)."""

    def __init__(self, splits: str, data_root: str = "data",
                 qa_sets: Optional[Sequence[str]] = None,
                 topk: Optional[int] = None):
        self.name = splits
        self.sources = splits.split(",")
        self.data = []
        for source in self.sources:
            self.data.extend(load_json(
                os.path.join(data_root, "lxmert", f"{source}.json")))
        self.answer_table = AnswerTable(
            os.path.join(data_root, "lxmert", "all_ans.json"), qa_sets)

        # normalize answers in-place (reference lxmert_data.py:63-73)
        for datum in self.data:
            for cat, labels in datum["labelf"].items():
                for label in labels:
                    for ans in list(label.keys()):
                        new_ans = self.answer_table.convert_ans(ans)
                        if self.answer_table.used(new_ans):
                            if ans != new_ans:
                                label[new_ans] = label.pop(ans)
                        else:
                            label.pop(ans)

        # image features: H5 store or TSV (both reference formats supported)
        self.img_data: Dict[str, dict] = {}

    def load_features_tsv(self, path: str, topk: Optional[int] = None):
        for item in load_obj_tsv(path, topk):
            self.img_data[item["img_id"]] = item

    def load_features_h5(self, obj_h5: str, info_json: str,
                         topk: Optional[int] = None):
        """H5 variant of the feature store (same group layout as the task
        datasets, plus objects_id/conf + attrs_id/conf datasets)."""
        import h5py

        info = {d["img_id"]: d for d in load_json(info_json)}
        with h5py.File(obj_h5, "r") as f:
            for n, img_id in enumerate(f.keys()):
                if topk is not None and n >= topk:
                    break
                g = f[img_id]
                meta = info[img_id]
                self.img_data[img_id] = {
                    "img_id": img_id,
                    "img_h": meta["img_h"], "img_w": meta["img_w"],
                    "num_boxes": meta["num_boxes"],
                    "features": np.asarray(g["features"], np.float32),
                    "boxes": np.asarray(g["boxes"], np.float32),
                    "objects_id": np.asarray(g["objects_id"], np.int64)
                    if "objects_id" in g else np.zeros(
                        meta["num_boxes"], np.int64),
                    "objects_conf": np.asarray(g["objects_conf"], np.float32)
                    if "objects_conf" in g else np.ones(
                        meta["num_boxes"], np.float32),
                    "attrs_id": np.asarray(g["attrs_id"], np.int64)
                    if "attrs_id" in g else np.zeros(
                        meta["num_boxes"], np.int64),
                    "attrs_conf": np.asarray(g["attrs_conf"], np.float32)
                    if "attrs_conf" in g else np.ones(
                        meta["num_boxes"], np.float32),
                }

    def flatten(self) -> List[PretrainExample]:
        """Sentence-level flattening (reference lxmert_data.py:112-135)."""
        examples = []
        for datum in self.data:
            if datum["img_id"] not in self.img_data:
                continue
            for cat, sents in datum["sentf"].items():
                labels = datum["labelf"].get(cat)
                for si, sent in enumerate(sents):
                    label = None
                    if labels is not None:
                        label = {self.answer_table.ans2id(a): s
                                 for a, s in labels[si].items()}
                    examples.append(PretrainExample(
                        make_uid(datum["img_id"], cat, si),
                        datum["img_id"], sent, label))
        return examples

    @property
    def num_answers(self) -> int:
        return self.answer_table.num_answers


class PretrainFeaturizer:
    """Vectorized batch featurizer (reference lxmert_pretrain.py:76-215)."""

    def __init__(self, dataset: LxmertPretrainDataset,
                 tokenizer: BertTokenizer, max_seq_length: int = 20,
                 word_mask_rate: float = 0.15, obj_mask_rate: float = 0.15,
                 task_matched: bool = True, seed: int = 9595):
        self.ds = dataset
        self.tok = tokenizer
        self.max_seq_length = max_seq_length
        self.word_mask_rate = word_mask_rate
        self.obj_mask_rate = obj_mask_rate
        self.task_matched = task_matched
        self.rng = np.random.RandomState(seed)
        self.examples = dataset.flatten()
        self.mask_id = tokenizer.vocab["[MASK]"]
        self.vocab_ids = np.asarray(list(tokenizer.vocab.values()))

    def __len__(self) -> int:
        return len(self.examples)

    def _random_feat(self) -> np.ndarray:
        """A random object feature from the corpus (reference
        lxmert_data.py:140-146)."""
        ex = self.examples[self.rng.randint(len(self.examples))]
        info = self.ds.img_data[ex.img_id]
        return info["features"][self.rng.randint(info["num_boxes"])]

    def featurize(self, indices: Sequence[int]) -> Tuple[Dict[str, np.ndarray],
                                                         List[str]]:
        n = len(indices)
        L = self.max_seq_length
        out = {k: None for k in ()}
        input_ids = np.zeros((n, L), np.int32)
        input_mask = np.zeros((n, L), np.int32)
        segment_ids = np.zeros((n, L), np.int32)
        lm_labels = np.full((n, L), -1, np.int32)
        matched = np.ones((n,), np.int32)
        ans = np.full((n,), -1, np.int32)
        uids = []

        first = self.ds.img_data[self.examples[indices[0]].img_id]
        n_obj, feat_dim = first["features"].shape
        feats = np.zeros((n, n_obj, feat_dim), np.float32)
        boxes = np.zeros((n, n_obj, 4), np.float32)
        obj_labels = np.zeros((n, n_obj), np.int32)
        obj_conf = np.zeros((n, n_obj), np.float32)
        attr_labels = np.zeros((n, n_obj), np.int32)
        attr_conf = np.zeros((n, n_obj), np.float32)
        feat_target = np.zeros((n, n_obj, feat_dim), np.float32)
        feat_mask = np.zeros((n, n_obj), np.float32)

        for k, idx in enumerate(indices):
            ex = self.examples[idx]
            uids.append(ex.uid)
            info = self.ds.img_data[ex.img_id]

            # matched-pair sampling (reference lxmert_data.py:174-183)
            sent = ex.sent
            is_matched = 1
            if self.task_matched and self.rng.rand() < 0.5:
                is_matched = 0
                while True:
                    other = self.examples[self.rng.randint(len(self.examples))]
                    if other.img_id != ex.img_id:
                        break
                sent = other.sent
            matched[k] = is_matched

            # word masking 80/10/10 (reference lxmert_pretrain.py:76-112)
            tokens = self.tok.tokenize(sent.strip())[: L - 2]
            ids = self.tok.convert_tokens_to_ids(tokens)
            masked = list(ids)
            labels = [-1] * len(ids)
            for i, tid in enumerate(ids):
                p = self.rng.rand()
                if p < self.word_mask_rate:
                    p /= self.word_mask_rate
                    if p < 0.8:
                        masked[i] = self.mask_id
                    elif p < 0.9:
                        masked[i] = int(self.vocab_ids[
                            self.rng.randint(len(self.vocab_ids))])
                    labels[i] = tid
            seq = [self.tok.vocab["[CLS]"]] + masked + [self.tok.vocab["[SEP]"]]
            lm = [-1] + labels + [-1]
            input_ids[k, : len(seq)] = seq
            input_mask[k, : len(seq)] = 1
            lm_labels[k, : len(lm)] = lm

            # visual side with box normalization
            b = info["boxes"].copy().astype(np.float32)
            b[:, (0, 2)] /= info["img_w"]
            b[:, (1, 3)] /= info["img_h"]
            boxes[k] = b
            f = info["features"].astype(np.float32)
            feat_target[k] = f
            obj_labels[k] = info["objects_id"]
            obj_conf[k] = info["objects_conf"]
            attr_labels[k] = info["attrs_id"]
            attr_conf[k] = info["attrs_conf"]

            # object-feature masking 80/10/10 (lxmert_pretrain.py:115-136)
            mf = f.copy()
            for i in range(n_obj):
                p = self.rng.rand()
                if p < self.obj_mask_rate:
                    p /= self.obj_mask_rate
                    if p < 0.8:
                        mf[i, :] = 0.0
                    elif p < 0.9:
                        mf[i, :] = self._random_feat()
                    feat_mask[k, i] = 1.0
            feats[k] = mf

            # QA answer sampling by score (lxmert_pretrain.py:187-199)
            if ex.label and is_matched == 1:
                keys = list(ex.label.keys())
                values = np.asarray(list(ex.label.values()), np.float64)
                if len(keys) == 1:
                    ans[k] = keys[0]
                else:
                    probs = values / values.sum()
                    ans[k] = keys[int(self.rng.multinomial(1, probs).argmax())]

        batch = {
            "input_ids": input_ids, "input_mask": input_mask,
            "segment_ids": segment_ids, "lm_labels": lm_labels,
            "feats": feats, "boxes": boxes,
            "obj_labels": obj_labels, "obj_mask": obj_conf,
            "attr_labels": attr_labels, "attr_mask": attr_conf,
            "feat_labels": feat_target, "feat_mask": feat_mask,
            "matched_labels": matched, "ans": ans,
        }
        return batch, uids


class LxmertPretrainEvaluator:
    """QA accuracy over labeled examples (reference LXMERTEvaluator,
    lxmert_data.py:202-259)."""

    def __init__(self, dataset: LxmertPretrainDataset):
        self.uid2label: Dict[str, Dict] = {}
        self.uid2dset: Dict[str, str] = {}
        for datum in dataset.data:
            for cat, sents in datum["sentf"].items():
                if cat not in datum["labelf"]:
                    continue
                labels = datum["labelf"][cat]
                for si in range(len(sents)):
                    uid = make_uid(datum["img_id"], cat, si)
                    self.uid2label[uid] = labels[si]
                    self.uid2dset[uid] = cat

    def evaluate(self, uid2ans: Dict[str, str]) -> Tuple[float, Dict[str, float]]:
        score, cnt = 0.0, 0
        dset_score: Dict[str, float] = {}
        dset_cnt: Dict[str, int] = {}
        for uid, answer in uid2ans.items():
            if uid not in self.uid2label:
                continue
            label = self.uid2label[uid]
            d = self.uid2dset[uid]
            if answer in label:
                score += label[answer]
                dset_score[d] = dset_score.get(d, 0.0) + label[answer]
            cnt += 1
            dset_cnt[d] = dset_cnt.get(d, 0) + 1
        accu = score / cnt if cnt else 0.0
        return accu, {d: dset_score.get(d, 0.0) / c
                      for d, c in dset_cnt.items()}
