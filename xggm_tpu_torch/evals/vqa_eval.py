"""Official VQA accuracy (a copy of `xggm_tpu/evals/vqa_eval.py`, which has
no framework in it).

The VQA-v2 metric: answers normalised (contractions restored, number words
as digits, articles removed, punctuation stripped by the comma and period
rules), then per question the mean over the 10 annotators left out in turn
of min(1, matching other annotators / 3), with per-question-type and
per-answer-type breakdowns. The contraction and number tables are the
public VQA toolkit's normalisation data.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = ("a", "an", "the")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) \
                or COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    return " ".join(CONTRACTIONS.get(w, w) for w in words)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


class VQAOfficialEval:
    """min(1, matches/3) accuracy over 10 annotators (reference
    vqaEval.py:112-165, vqaEvalDemo.py:40-60).

    `annotations`: list of dicts with question_id, question_type,
    answer_type, answers=[{'answer': str}, ...] (the raw VQA annotation
    format). `results`: list of {'question_id', 'answer'}."""

    def __init__(self, annotations: Sequence[dict], results: Sequence[dict],
                 n: int = 2):
        self.n = n
        self.gts = {a["question_id"]: a for a in annotations}
        self.res = {r["question_id"]: r for r in results}
        self.accuracy: Dict = {}
        self.evalQA: Dict = {}

    def evaluate(self, ques_ids: Optional[Sequence[int]] = None) -> Dict:
        if ques_ids is None:
            ques_ids = [q for q in self.gts if q in self.res]
        acc_qa: List[float] = []
        acc_ques_type: Dict[str, List[float]] = {}
        acc_ans_type: Dict[str, List[float]] = {}
        for qid in ques_ids:
            gt = self.gts[qid]
            res_ans = normalize_answer(self.res[qid]["answer"])
            answers = [dict(a) for a in gt["answers"]]
            if len({a["answer"] for a in answers}) > 1:
                for a in answers:
                    a["answer"] = process_punctuation(a["answer"])
            gt_acc = []
            # leave-one-out by VALUE inequality, exactly as the reference
            # (vqaEval.py:140-144) - with raw VQA annotations each answer
            # dict carries a unique answer_id, so this drops one element
            for gt_ans in answers:
                others = [a for a in answers if a != gt_ans]
                matching = [a for a in others if a["answer"] == res_ans]
                gt_acc.append(min(1.0, float(len(matching)) / 3.0))
            avg_acc = float(sum(gt_acc)) / len(gt_acc)
            acc_qa.append(avg_acc)
            acc_ques_type.setdefault(gt["question_type"], []).append(avg_acc)
            acc_ans_type.setdefault(gt["answer_type"], []).append(avg_acc)
            self.evalQA[qid] = round(100 * avg_acc, self.n)

        self.accuracy = {
            "overall": round(100 * sum(acc_qa) / len(acc_qa), self.n)
            if acc_qa else 0.0,
            "perQuestionType": {
                t: round(100 * sum(v) / len(v), self.n)
                for t, v in acc_ques_type.items()},
            "perAnswerType": {
                t: round(100 * sum(v) / len(v), self.n)
                for t, v in acc_ans_type.items()},
        }
        return self.accuracy
