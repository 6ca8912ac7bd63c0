"""VQA annotation helper API (a copy of `xggm_tpu/evals/vqa_api.py`, which
has no framework in it).

Indexes raw annotations and questions, selects question and image ids by
type, and turns a result file into an annotation set (`load_res`) for the
official evaluator. VQA-CP stores annotations as flat lists; plain VQA
wraps them under 'annotations' / 'questions' keys; both are accepted.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Sequence, Union


def _as_list(x):
    return x if isinstance(x, list) else [x]


class VQAAnnotations:
    def __init__(self, annotation_file: Optional[str] = None,
                 question_file: Optional[str] = None):
        self.dataset: List[dict] = []
        self.questions: List[dict] = []
        self.qa: Dict[int, dict] = {}
        self.qqa: Dict[int, dict] = {}
        self.img_to_qa: Dict[Union[int, str], List[dict]] = {}
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
            if isinstance(dataset, dict) and "annotations" in dataset:
                dataset = dataset["annotations"]
            self.dataset = dataset
            if question_file is not None:
                with open(question_file) as f:
                    questions = json.load(f)
                if isinstance(questions, dict) and "questions" in questions:
                    questions = questions["questions"]
                self.questions = questions
            self.create_index()

    def create_index(self) -> None:
        self.img_to_qa = {ann["image_id"]: [] for ann in self.dataset}
        self.qa = {}
        self.qqa = {}
        for ann in self.dataset:
            self.img_to_qa[ann["image_id"]].append(ann)
            self.qa[ann["question_id"]] = ann
        for ques in self.questions:
            self.qqa[ques["question_id"]] = ques

    def get_ques_ids(self, img_ids=(), ques_types=(), ans_types=()) -> List:
        img_ids = _as_list(list(img_ids) if not isinstance(img_ids, (int, str))
                           else img_ids)
        ques_types = _as_list(list(ques_types)
                              if not isinstance(ques_types, str) else ques_types)
        ans_types = _as_list(list(ans_types)
                             if not isinstance(ans_types, str) else ans_types)
        if not img_ids and not ques_types and not ans_types:
            anns = self.dataset
        else:
            anns = (sum((self.img_to_qa[i] for i in img_ids
                         if i in self.img_to_qa), [])
                    if img_ids else self.dataset)
            if ques_types:
                anns = [a for a in anns if a["question_type"] in ques_types]
            if ans_types:
                anns = [a for a in anns if a["answer_type"] in ans_types]
        return [a["question_id"] for a in anns]

    def get_img_ids(self, ques_ids=(), ques_types=(), ans_types=()) -> List:
        ques_ids = list(ques_ids)
        if not ques_ids and not ques_types and not ans_types:
            anns = self.dataset
        else:
            anns = ([self.qa[q] for q in ques_ids if q in self.qa]
                    if ques_ids else self.dataset)
            if ques_types:
                anns = [a for a in anns if a["question_type"] in ques_types]
            if ans_types:
                anns = [a for a in anns if a["answer_type"] in ans_types]
        return [a["image_id"] for a in anns]

    def load_qa(self, ids: Sequence[int]) -> List[dict]:
        return [self.qa[i] for i in ids]

    def load_res(self, res_file: str) -> "VQAAnnotations":
        """Materialize predictions as a VQAAnnotations with qa filled from
        the result file (reference vqa.py:143-174)."""
        res = VQAAnnotations()
        with open(res_file) as f:
            anns = json.load(f)
        assert isinstance(anns, list), "results must be a list"
        res_qids = {a["question_id"] for a in anns}
        assert res_qids.issubset(set(self.qa.keys())), (
            "results contain question ids absent from the annotations")
        out = []
        for ann in anns:
            qid = ann["question_id"]
            src = self.qa[qid]
            merged = copy.deepcopy(ann)
            merged["image_id"] = src["image_id"]
            merged["question_type"] = src["question_type"]
            merged["answer_type"] = src["answer_type"]
            out.append(merged)
        res.dataset = out
        res.qa = {a["question_id"]: a for a in out}
        return res
