"""Official GQA-OOD metric engine (a copy of `xggm_tpu/evals/gqa_eval.py`,
which has no framework in it).

The OpenVQA-adapted evaluator of GQA-OOD and its OOD report:

* accuracy / binary / open over the balanced subset
* per-structural-type / per-semantic-type / per-length / per-steps breakdowns
* validity & plausibility when a choices file is given
* consistency over entailed questions (optional)
* distribution score: chi-square of gold vs predicted answer histograms per
  global group (lower is better)
* head/tail confusion-matrix mode
* OOD report: head/tail/all accuracies + delta = (head - tail)/tail * 100
* tail-size sweep over alpha-thresholded subsets

Predictions that are missing for a question default to the gold answer
(reference gqa_eval.py:88-92 - a quirk preserved deliberately).
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def _avg(xs) -> float:
    return float(sum(xs)) / len(xs) if xs else 0.0


def _load_json_or_chunks(name: str):
    if os.path.isfile(name):
        with open(name) as f:
            return json.load(f)
    stem = name.split(".")[0]
    if os.path.isdir(stem):
        data = {}
        for chunk in glob.glob(f"{stem}/{stem}_*.{name.split('.')[1]}"):
            with open(chunk) as f:
                data.update(json.load(f))
        return data
    raise FileNotFoundError(name)


class GQAEval:
    def __init__(self, result_eval_file: str, ques_file_path: str,
                 choices_path: Optional[str] = None,
                 eval_consistency: bool = False,
                 eval_head_tail: bool = False):
        questions: Dict[str, dict] = _load_json_or_chunks(ques_file_path)
        choices = _load_json_or_chunks(choices_path) if choices_path else None
        preds_list = _load_json_or_chunks(result_eval_file)
        self.predictions = {p["questionId"]: p["prediction"]
                            for p in preds_list}

        s = {
            "accuracy": [], "binary": [], "open": [],
            "validity": [], "plausibility": [], "consistency": [],
            "accuracyPerStructuralType": defaultdict(list),
            "accuracyPerSemanticType": defaultdict(list),
            "accuracyPerLength": defaultdict(list),
            "accuracyPerSteps": defaultdict(list),
        }
        self.head_tail = eval_head_tail
        if eval_head_tail:
            # 3x3 confusion lists: [pred in {head,mid,tail}][gold in ...]
            s["head_tail"] = [[[], [], []], [[], [], []], [[], [], []]]
            self.qid2reasinfo = {}

        dist_gold = defaultdict(lambda: defaultdict(int))
        dist_pred = defaultdict(lambda: defaultdict(int))

        for qid, q in questions.items():
            gold = q["answer"]
            predicted = self.predictions.get(qid, gold)
            correct = (predicted == gold)
            score = 1.0 if correct else 0.0

            if q["isBalanced"]:
                s["accuracy"].append(score)
                s["accuracyPerLength"][len(q["question"].split())].append(score)
                s["accuracyPerSteps"][self._steps_num(q)].append(score)
                s["accuracyPerStructuralType"][
                    q["types"]["structural"]].append(score)
                s["accuracyPerSemanticType"][
                    q["types"]["semantic"]].append(score)
                ans_type = "open" if q["types"]["structural"] == "query" \
                    else "binary"
                s[ans_type].append(score)

                if choices is not None:
                    s["validity"].append(1.0 if self._belongs(
                        predicted, choices[qid]["valid"], q) else 0.0)
                    s["plausibility"].append(1.0 if self._belongs(
                        predicted, choices[qid]["plausible"], q) else 0.0)

                group = q["groups"]["global"]
                if group is not None:
                    dist_gold[group][gold] += 1
                    dist_pred[group][predicted] += 1

                if eval_consistency:
                    self._update_consistency(s, qid, q, questions)

            if eval_head_tail:
                self._update_head_tail(s, qid, q, gold, predicted, correct)

        s["distribution"] = self._chi_square(dist_gold, dist_pred) / 100.0

        for k in ("binary", "open", "accuracy", "consistency", "validity",
                  "plausibility"):
            s[k] = _avg(s[k]) * 100.0
        for k in ("accuracyPerStructuralType", "accuracyPerSemanticType",
                  "accuracyPerSteps", "accuracyPerLength"):
            s[k] = {t: (_avg(v) * 100.0, len(v)) for t, v in s[k].items()}
        self.scores = s
        self._choices = choices is not None
        self._consistency = eval_consistency

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _steps_num(q) -> int:
        """Reasoning-step count excluding terminal query ops
        (reference gqa_eval.py:318-323)."""
        return len([c for c in q["semantic"]
                    if not any(o in f"{c['operation']}: {c['argument']}"
                               for o in ("exist", "query: name",
                                         "choose name"))])

    @staticmethod
    def _belongs(element, group, q) -> bool:
        if "Common" in q["types"]["detailed"]:
            group = ["color", "material", "shape"]
        return element in group

    def _update_consistency(self, s, qid, q, questions):
        inferred = [e for e in q.get("entailed", []) if e != qid]
        if self.predictions.get(qid, q["answer"]) == q["answer"] and inferred:
            scores = [1.0 if self.predictions.get(
                e, questions[e]["answer"]) == questions[e]["answer"] else 0.0
                for e in inferred]
            s["consistency"].append(_avg(scores))

    def _update_head_tail(self, s, qid, q, gold, predicted, correct):
        g_tail = gold in q["ans_tail"]
        g_head = gold in q["ans_head"]
        p_tail = predicted in q["ans_tail"]
        p_head = predicted in q["ans_head"]

        def which(tail, head):
            return "tail" if tail else ("head" if head else "mid")

        self.qid2reasinfo[qid] = {
            "result": correct, "ans_pred": predicted,
            "pred": which(p_tail, p_head), "gt": which(g_tail, g_head)}
        P = {"head": 0, "mid": 1, "tail": 2}
        s["head_tail"][P[which(p_tail, p_head)]][
            P[which(g_tail, g_head)]].append(correct)

    @staticmethod
    def _chi_square(gold_dist, pred_dist) -> float:
        sum_score = sum_overall = 0.0
        for group in gold_dist:
            score = overall = 0.0
            for ans, e in gold_dist[group].items():
                o = pred_dist[group].get(ans, 0)
                score += (float(o - e) ** 2) / e
                overall += e
            sum_score += score * overall
            sum_overall += overall
        return float(sum_score) / sum_overall if sum_overall else 0.0

    # -- public API (reference gqa_eval.py:268-277) ----------------------

    def get_acc_result(self) -> dict:
        res = {"accuracy": self.scores["accuracy"],
               "binary": self.scores["binary"],
               "open": self.scores["open"]}
        if self.head_tail:
            res["head_tail"] = self.scores["head_tail"]
        return res

    def get_str_result(self) -> Tuple[List[str], List[str]]:
        lines = []
        for m in ("binary", "open", "accuracy", "consistency", "validity",
                  "plausibility", "distribution"):
            if m == "consistency" and not self._consistency:
                continue
            if m in ("validity", "plausibility") and not self._choices:
                continue
            suffix = " (lower is better)" if m == "distribution" else "%"
            lines.append(f"{m.capitalize()}: {self.scores[m]:.2f}{suffix}")
        detail = []
        for m, title in (("accuracyPerStructuralType",
                          "Accuracy / structural type"),
                         ("accuracyPerSemanticType",
                          "Accuracy / semantic type"),
                         ("accuracyPerSteps", "Accuracy / steps number"),
                         ("accuracyPerLength", "Accuracy / words number")):
            detail.append(f"{title}:")
            for t in sorted(self.scores[m].keys(), key=str):
                acc, n = self.scores[m][t]
                detail.append(f"  {t}: {acc:.2f}% ({n} questions)")
        return lines, detail


def ood_test_report(predictions_file: str, ques_dir: str) -> Dict[str, float]:
    """Head/tail/all accuracies + delta (reference evaluation.py:51-75)."""
    files = {"Tail": "ood_testdev_tail.json", "Head": "ood_testdev_head.json",
             "All": "ood_testdev_all.json"}
    result = {}
    for setup, fname in files.items():
        ev = GQAEval(predictions_file, os.path.join(ques_dir, fname))
        result[setup] = ev.get_acc_result()["accuracy"]
    result["Delta"] = ((result["Head"] - result["Tail"])
                       / result["Tail"] * 100.0) if result["Tail"] else 0.0
    return result


# reference evaluation.py:33-35
ALPHA_LIST = [9.0, 7.0, 5.0, 3.6, 2.8, 2.2, 1.8, 1.4, 1.0, 0.8, 0.4, 0.3,
              0.2, 0.1, 0.0, -0.1, -0.2, -0.3, -0.4, -0.5, -0.6, -0.7]


def tail_size_sweep(predictions_file: str, alpha_tail_dir: str,
                    alphas: Sequence[float] = tuple(ALPHA_LIST)
                    ) -> Tuple[List[float], List[float]]:
    """Accuracy vs 22 alpha-thresholded val subsets
    (reference evaluation.py:33-50)."""
    accs = []
    for alpha in alphas:
        path = os.path.join(alpha_tail_dir, f"val_bal_tail_{alpha:.1f}.json")
        accs.append(GQAEval(predictions_file, path)
                    .get_acc_result()["accuracy"])
    return list(alphas), accs
