"""Task datasets and feature stores (counterpart of
`xggm_tpu/data/datasets.py`).

The on-disk contract is the JAX package's:

  {root}/gqa_ood/{split}.json                     question records
  {root}/gqa_ood/trainval_ans2label.json          answer vocab
  {root}/gqa_imgfeat/{split}_obj36.h5             per-image groups with
                                                  'features' [36, 2048],
                                                  'boxes' [36, 4]
  {root}/gqa_imgfeat/{split}_obj36_info.json      img_h/img_w/num_boxes
  {root}/gqa_imgfeat/{split}_obj36_adj_v2.h5      [36, 36] adjacency
  {root}/gqa_imgfeat/{split}_obj36.xpack          the same records packed
                                                  (data/xpack.py)
  (VQA-CP v2 mirrors it with {split}_annotations.json and mscoco_imgfeat/)

`H5FeatureStore` imports `h5py` only when one is opened; `MemoryFeatureStore`
holds arrays in memory; `data/xpack.py::XPackFeatureStore` reads a pack.
`GraphBatchDataset` tokenizes once up front and assembles fixed-shape numpy
batches by index; `data/feeder.py` moves them to the device.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from xggm_tpu_torch.config import DataConfig, MAX_SEQ_LENGTH, NUM_OBJECTS
from xggm_tpu_torch.data.tokenizer import BertTokenizer, encode_batch
from xggm_tpu_torch.utils.io import load_json

TINY_IMG_NUM = 512   # --tiny keeps this many question records
FAST_IMG_NUM = 5000  # --fast's image count (no task dataset applies it)

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


@dataclass
class QuestionRecord:
    question_id: object  # str for GQA, int for VQA-CP
    img_id: str
    sent: str
    target: Optional[np.ndarray]  # [num_answers] soft scores, None at test
    label_dict: Optional[dict]    # raw label info for the evaluators


class VQABaseDataset:
    """Question-side logic shared by both tasks."""

    def __init__(self, splits: str, data_cfg: DataConfig):
        self.name = splits
        self.splits = splits.split(",")
        self.cfg = data_cfg
        self.data: List[dict] = []
        self.ans2label: Dict[str, int] = {}
        self.label2ans: List[str] = []

    @property
    def num_answers(self) -> int:
        return len(self.ans2label)

    def __len__(self) -> int:
        return len(self.data)

    def _check_vocab(self):
        if len(self.ans2label) != len(self.label2ans) or any(
                self.label2ans[label] != ans
                for ans, label in self.ans2label.items()):
            raise ValueError(f"{self.name}: trainval_ans2label.json and "
                             "trainval_label2ans.json disagree")


class GQADataset(VQABaseDataset):
    """GQA-OOD questions."""

    def __init__(self, splits: str, data_cfg: DataConfig):
        super().__init__(splits, data_cfg)
        root = os.path.join(data_cfg.data_root, "gqa_ood")
        for split in self.splits:
            self.data.extend(load_json(os.path.join(root, f"{split}.json")))
        self.id2datum = {d["question_id"]: d for d in self.data}
        self.ans2label = load_json(os.path.join(root, "trainval_ans2label.json"))
        self.label2ans = load_json(os.path.join(root, "trainval_label2ans.json"))
        self._check_vocab()

    def feature_store(self) -> H5FeatureStore:
        root = os.path.join(self.cfg.data_root, "gqa_imgfeat")
        s = self.splits[0]
        return H5FeatureStore(
            os.path.join(root, f"{s}_obj36.h5"),
            os.path.join(root, f"{s}_obj36_info.json"),
            os.path.join(root, f"{s}_obj36_adj_v2.h5"),
        )

    def records(self, store) -> List[QuestionRecord]:
        """The answerable questions whose image has features: one record per
        in-vocabulary answer of a question (each with the question's full
        soft target), as the JAX package keeps them; a question without
        labels (a test split) once."""
        out = []
        for datum in self.data:
            if "label" in datum:
                for ans, _score in datum["label"].items():
                    if ans in self.ans2label and store.has(datum["img_id"]):
                        target = np.zeros(self.num_answers, np.float32)
                        for a, s in datum["label"].items():
                            if a in self.ans2label:
                                target[self.ans2label[a]] = s
                        out.append(QuestionRecord(
                            datum["question_id"], datum["img_id"],
                            datum["sent"], target, datum["label"]))
            elif store.has(datum["img_id"]):
                out.append(QuestionRecord(
                    datum["question_id"], datum["img_id"], datum["sent"],
                    None, None))
        return out


class VQACPDataset(VQABaseDataset):
    """VQA-CP v2 questions."""

    def __init__(self, splits: str, data_cfg: DataConfig):
        super().__init__(splits, data_cfg)
        root = os.path.join(data_cfg.data_root, "vqacpv2")
        self.data = load_json(os.path.join(root, f"{self.name}_annotations.json"))
        self.id2datum = {d["question_id"]: d for d in self.data}
        self.ans2label = load_json(os.path.join(root, "trainval_ans2label.json"))
        self.label2ans = load_json(os.path.join(root, "trainval_label2ans.json"))
        self._check_vocab()

    def feature_store(self) -> H5FeatureStore:
        root = os.path.join(self.cfg.data_root, "mscoco_imgfeat")
        s = self.splits[0]
        # the adjacency exists for some splits only
        adj = os.path.join(root, f"{s}_obj36_adj_v2.h5")
        return H5FeatureStore(
            os.path.join(root, f"{s}_obj36.h5"),
            os.path.join(root, f"{s}_obj36_info.json"),
            adj if os.path.exists(adj) else None,
        )

    def records(self, store) -> List[QuestionRecord]:
        """The questions whose image has features; labels are parallel
        answer-id and score lists."""
        out = []
        for datum in self.data:
            img_id = datum["image_id"]
            if not store.has(img_id):
                continue
            target = None
            label_dict = None
            if "label" in datum:
                target = np.zeros(self.num_answers, np.float32)
                for aid, score in zip(datum["label"], datum["score"]):
                    target[aid] = score
                label_dict = dict(zip(datum["label"], datum["score"]))
            out.append(QuestionRecord(
                datum["question_id"], img_id, datum["question"], target,
                label_dict))
        return out


class GraphBatchDataset:
    """Filtered, tokenized question records over a feature store, assembled
    into fixed-shape numpy batches by index."""

    def __init__(self, dataset: VQABaseDataset, tokenizer: BertTokenizer,
                 max_seq_length: int = MAX_SEQ_LENGTH, store=None):
        self.raw = dataset
        # any feature store: H5 (the default), memory or xpack
        self.store = store if store is not None else dataset.feature_store()
        self.records = dataset.records(self.store)
        # --tiny keeps the first TINY_IMG_NUM records after the filtering;
        # --fast does not subset a task dataset
        if dataset.cfg.tiny:
            self.records = self.records[:TINY_IMG_NUM]

        self.input_ids, self.input_mask, self.segment_ids = encode_batch(
            tokenizer, (r.sent for r in self.records), max_seq_length)
        self.num_answers = dataset.num_answers
        self.has_targets = all(r.target is not None for r in self.records)

    def __len__(self) -> int:
        return len(self.records)

    def question_ids(self, indices: Sequence[int]) -> List[object]:
        return [self.records[i].question_id for i in indices]

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """input_ids, input_mask, segment_ids [n, L] int32; feats
        [n, 36, F], boxes [n, 36, 4], adj [n, 36, 36] and, with targets,
        target [n, num_answers], all float32."""
        n = len(indices)
        if hasattr(self.store, "get_batch"):
            # a pack store gathers the whole batch at once
            rec = self.store.get_batch(
                [self.records[i].img_id for i in indices])
            feats, boxes, adj = rec["feats"], rec["boxes"], rec["adj"]
        else:
            feats = np.empty((n, NUM_OBJECTS, self.store_feat_dim), np.float32)
            boxes = np.empty((n, NUM_OBJECTS, 4), np.float32)
            adj = np.empty((n, NUM_OBJECTS, NUM_OBJECTS), np.float32)
            for k, i in enumerate(indices):
                feats[k], boxes[k], adj[k] = self.store.get(
                    self.records[i].img_id)
        batch = {
            "input_ids": self.input_ids[indices],
            "input_mask": self.input_mask[indices],
            "segment_ids": self.segment_ids[indices],
            "feats": feats,
            "boxes": boxes,
            "adj": adj,
        }
        if self.has_targets:
            batch["target"] = np.stack(
                [self.records[i].target for i in indices]).astype(np.float32)
        return batch

    @property
    def store_feat_dim(self) -> int:
        if not hasattr(self, "_feat_dim"):
            f, _, _ = self.store.get(self.records[0].img_id)
            self._feat_dim = f.shape[-1]
        return self._feat_dim


class GQAEvaluator:
    """Soft-score accuracy and the challenge's prediction file."""

    def __init__(self, dataset: GQADataset):
        self.dataset = dataset

    def evaluate(self, quesid2ans: Dict[object, str]) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            datum = self.dataset.id2datum[quesid]
            if ans in datum["label"]:
                score += datum["label"][ans]
        return score / len(quesid2ans)

    @staticmethod
    def dump_result(quesid2ans: Dict[object, str], path: str) -> None:
        result = [{"questionId": q, "prediction": a}
                  for q, a in quesid2ans.items()]
        with open(path, "w") as f:
            json.dump(result, f, indent=4, sort_keys=True)


class VQAEvaluator:
    """Soft-score accuracy and the submission file."""

    def __init__(self, dataset: VQACPDataset):
        self.dataset = dataset

    def evaluate(self, quesid2ans: Dict[object, str]) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            datum = self.dataset.id2datum[quesid]
            label = dict(zip(datum["label"], datum["score"]))
            aid = self.dataset.ans2label[ans]
            if aid in label:
                score += label[aid]
        return score / len(quesid2ans)

    @staticmethod
    def dump_result(quesid2ans: Dict[object, str], path: str) -> None:
        result = [{"question_id": q, "answer": a}
                  for q, a in quesid2ans.items()]
        with open(path, "w") as f:
            json.dump(result, f, indent=4, sort_keys=True)


def oracle_score(dataset: GraphBatchDataset) -> float:
    """Upper-bound accuracy: the mean over records of the best gold score."""
    total = 0.0
    for r in dataset.records:
        if r.target is not None and r.target.size:
            total += float(np.max(r.target))
    return total / max(len(dataset), 1)
