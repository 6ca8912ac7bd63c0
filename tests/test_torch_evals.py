"""The port's offline evaluators (copies of the JAX package's host code)
against the originals:

  * `normalize_answer` on strings that exercise every rule, and
    `VQAOfficialEval` overall, per question type, per answer type and per
    question on random annotations;
  * `VQAAnnotations`: its index, id selections by image, question type and
    answer type, `load_qa` and `load_res`;
  * `cli.evaluate` in its `gqa`, `gqa-tail` (with `--plot`) and `vqa` modes
    prints JAX's lines on the same files, both run in-process.
"""
import contextlib
import io
import json

import numpy as np

from xggm_tpu.cli import evaluate as jax_evaluate
from xggm_tpu.evals import vqa_api as jax_vqa_api
from xggm_tpu.evals import vqa_eval as jax_vqa_eval
from xggm_tpu.evals.gqa_eval import ALPHA_LIST
from xggm_tpu_torch.cli import evaluate
from xggm_tpu_torch.evals import vqa_api, vqa_eval

ANS_POOL = ["yes", "no", "two", "Two", "blue car", "None", "a dog, maybe",
            "3,000", "it's 5.5", "isnt", "the man", "red!", "(left)"]


def _vqa_fixture(seed=0, n=40):
    rng = np.random.RandomState(seed)
    annotations, results = [], []
    for qid in range(n):
        answers = [{"answer": ANS_POOL[rng.randint(len(ANS_POOL))],
                    "answer_id": k + 1} for k in range(10)]
        if qid % 7 == 0:  # every annotator agrees
            answers = [dict(a, answer="yes") for a in answers]
        annotations.append({
            "question_id": qid, "image_id": int(qid % 9),
            "question_type": ["what", "how many", "is the"][qid % 3],
            "answer_type": ["other", "number", "yes/no"][rng.randint(3)],
            "answers": answers})
        results.append({"question_id": qid,
                        "answer": ANS_POOL[rng.randint(len(ANS_POOL))]})
    return annotations, results


def test_vqa_normalisation_and_official_eval_match_jax():
    strings = ANS_POOL + ["Ten\tdogs\n", "a.b", "I'dve", "it's 2.", "x ; y",
                          "3/4", "\"quoted\"", "zero", "an  apple"]
    for s in strings:
        assert vqa_eval.normalize_answer(s) == \
            jax_vqa_eval.normalize_answer(s), s
        assert vqa_eval.process_punctuation(s) == \
            jax_vqa_eval.process_punctuation(s), s
        assert vqa_eval.process_digit_article(s) == \
            jax_vqa_eval.process_digit_article(s), s
    for seed in range(3):
        anns, res = _vqa_fixture(seed)
        ours = vqa_eval.VQAOfficialEval(anns, res)
        ref = jax_vqa_eval.VQAOfficialEval(anns, res)
        acc = ours.evaluate()
        assert acc == ref.evaluate() and ours.evalQA == ref.evalQA
        assert set(acc["perAnswerType"]) == {"other", "number", "yes/no"}
        assert ours.evaluate([3, 1, 4]) == ref.evaluate([3, 1, 4])


def test_vqa_annotations_match_jax(tmp_path):
    anns, res = _vqa_fixture(1)
    questions = [{"question_id": a["question_id"], "image_id": a["image_id"],
                  "question": "q?"} for a in anns]
    paths = {}
    for name, obj in (("flat", anns), ("wrapped", {"annotations": anns}),
                      ("questions", {"questions": questions}),
                      ("results", res[::2])):
        paths[name] = str(tmp_path / f"{name}.json")
        json.dump(obj, open(paths[name], "w"))
    for ann_file in (paths["flat"], paths["wrapped"]):
        ours = vqa_api.VQAAnnotations(ann_file, paths["questions"])
        ref = jax_vqa_api.VQAAnnotations(ann_file, paths["questions"])
        assert (ours.dataset, ours.qa, ours.qqa, ours.img_to_qa) == \
            (ref.dataset, ref.qa, ref.qqa, ref.img_to_qa)
        for kw in ({}, {"img_ids": [1, 4]}, {"img_ids": 2},
                   {"ques_types": "what"}, {"ans_types": ["number"]},
                   {"img_ids": [0, 3], "ans_types": "other"}):
            assert ours.get_ques_ids(**kw) == ref.get_ques_ids(**kw), kw
        for kw in ({}, {"ques_ids": [5, 1]}, {"ques_types": ["how many"]},
                   {"ques_ids": [2, 8, 9], "ans_types": ["yes/no"]}):
            assert ours.get_img_ids(**kw) == ref.get_img_ids(**kw), kw
        assert ours.load_qa([7, 2]) == ref.load_qa([7, 2])
        a, b = ours.load_res(paths["results"]), ref.load_res(paths["results"])
        assert (a.dataset, a.qa) == (b.dataset, b.qa)


def _gqa_questions(seed, n=24):
    rng = np.random.RandomState(seed)
    answers = ["yes", "no", "red", "blue", "dog"]
    return {f"q{i}": {
        "answer": answers[rng.randint(5)], "isBalanced": True,
        "question": "what is it ?",
        "types": {"structural": ["query", "verify"][i % 2],
                  "semantic": "attr", "detailed": "x"},
        "groups": {"global": "color"},
        "semantic": [{"operation": "select", "argument": "thing"}],
        "ans_head": ["yes", "no"], "ans_tail": ["red"]} for i in range(n)}


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_evaluate_cli_prints_jax_lines(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # --plot writes into the working directory
    questions = _gqa_questions(0)
    ques_dir, alpha_dir = tmp_path / "org", tmp_path / "alpha_tail"
    ques_dir.mkdir()
    alpha_dir.mkdir()
    for i, split in enumerate(("tail", "head", "all")):
        sub = dict(list(questions.items())[i * 4:])
        json.dump(sub, open(ques_dir / f"ood_testdev_{split}.json", "w"))
    for k, alpha in enumerate(ALPHA_LIST):
        sub = dict(list(questions.items())[k % 5:])
        json.dump(sub, open(alpha_dir / f"val_bal_tail_{alpha:.1f}.json",
                            "w"))
    rng = np.random.RandomState(1)
    preds = [{"questionId": q, "prediction": v["answer"] if rng.rand() < 0.6
              else "no"} for q, v in questions.items()]
    json.dump(preds, open(tmp_path / "gqa.json", "w"))
    anns, res = _vqa_fixture(2)
    json.dump({"annotations": anns}, open(tmp_path / "anns.json", "w"))
    json.dump(res, open(tmp_path / "OOD_predict.json", "w"))

    runs = [["gqa", "--predictions", "gqa.json", "--ques_dir", str(ques_dir),
             "--save_dir", "saved"],
            ["gqa-tail", "--predictions", "gqa.json", "--alpha_dir",
             str(alpha_dir), "--plot"],
            ["vqa", "--predictions", "OOD_predict.json", "--annotations",
             "anns.json"]]
    plot = tmp_path / "tail_plot_default.pdf"
    printed = {}
    for argv in runs:
        want = _lines(jax_evaluate.main, argv)
        plot.unlink(missing_ok=True)  # the port draws its own
        printed[argv[0]] = _lines(evaluate.main, argv)
        assert printed[argv[0]] == want, argv
        assert want and all(want)
        assert plot.exists() == ("--plot" in argv)
    assert printed["gqa-tail"][-1] == "Plot saved to tail_plot_default.pdf"
    assert printed["vqa"][0].startswith("Overall Accuracy is: ")
    # the result file: JAX's line, then the port's
    saved = (tmp_path / "saved" / "result.txt").read_text().splitlines()
    assert len(saved) == 2 and saved[0] == saved[1]
    assert saved[0].startswith("Accuracy (all, tail, head, delta): ")
