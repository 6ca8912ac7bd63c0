"""The LXMERT answer vocabulary and the answer-head surgery of
`--loadLXMERTQA` (counterpart of `xggm_tpu/checkpoint/answer_table.py`).

LXMERT's pretraining answer head covers its own answer vocabulary. When a
task with another `label2ans` is fine-tuned from it, each task answer's row
of the head's last layer is copied from the pretrained row of the
normalised answer string (articles stripped, number words as digits,
'grey' as 'gray', ...), and zeroed when the pretraining vocabulary lacks
it. The port's Dense weights are [out, in], so the surgery acts on rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.torch_bridge import (
    _Mapper, convert_lxrt_bert, load_torch_state_dict, merge_into,
    strip_prefixes)
from xggm_tpu_torch.config import LxmertConfig
from xggm_tpu_torch.utils.io import load_json

ANS_CONVERT = {
    "a man": "man", "the man": "man",
    "a woman": "woman", "the woman": "woman",
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "grey": "gray",
}


class AnswerTable:
    """The canonical answer vocabulary of `all_ans.json` (entries
    {"ans": ..., "dsets": [...]}), optionally those of some datasets."""

    def __init__(self, all_ans_path: str,
                 dsets: Optional[Sequence[str]] = None):
        all_ans = load_json(all_ans_path)
        if dsets is not None:
            ds = set(dsets)
            self.anss: List[str] = [a["ans"] for a in all_ans
                                    if set(a["dsets"]) & ds]
        else:
            self.anss = [a["ans"] for a in all_ans]
        self.ans_set = set(self.anss)
        self._ans2id = {ans: i for i, ans in enumerate(self.anss)}
        assert len(self.anss) == len(self._ans2id)

    @staticmethod
    def convert_ans(ans: str) -> str:
        """The normalised answer string."""
        if len(ans) == 0:
            return ""
        ans = ans.lower()
        if ans.endswith("."):
            ans = ans[:-1].strip()
        for art in ("a ", "an ", "the "):
            if ans.startswith(art):
                ans = ans[len(art):].strip()
                break
        return ANS_CONVERT.get(ans, ans)

    def used(self, ans: str) -> bool:
        return ans in self.ans_set

    def ans2id(self, ans: str) -> int:
        return self._ans2id[ans]

    def id2ans(self, i: int) -> str:
        return self.anss[i]

    @property
    def num_answers(self) -> int:
        return len(self.anss)


def surger_answer_head(pre_weight: np.ndarray, pre_bias: np.ndarray,
                       cur_weight: np.ndarray, cur_bias: np.ndarray,
                       label2ans: Sequence[str], table: AnswerTable
                       ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """The task head's last layer from the pretrained one, in [out, in]
    layout: `pre_*` over the pretraining vocabulary, `cur_*` over the
    task's. Row `label` is the pretrained row of its normalised answer, or
    zeros (weight and bias) when the table lacks it. Returns the new weight
    and bias and the counts of rows loaded and not."""
    new_w = cur_weight.copy()
    new_b = cur_bias.copy()
    loaded = unload = 0
    for label, ans in enumerate(label2ans):
        norm = table.convert_ans(ans)
        if table.used(norm):
            j = table.ans2id(norm)
            new_w[label] = pre_weight[j]
            new_b[label] = pre_bias[j]
            loaded += 1
        else:
            new_w[label] = 0.0
            new_b[label] = 0.0
            unload += 1
    return new_w, new_b, loaded, unload


def load_lxmert_qa(path: str, model: torch.nn.Module,
                   label2ans: Sequence[str], cfg: LxmertConfig,
                   all_ans_path: str = "data/lxmert/all_ans.json") -> None:
    """Load an LXMERT pretraining snapshot (torch `{path}_LXRT.pth`, or
    `path` itself if it ends in .pth) into a task model, in place: the whole
    encoder, the answer head's first layer and LayerNorm as they are, and
    its last layer through `surger_answer_head`. The snapshot holds
    `bert.*` (the encoder) and `answer_head.logit_fc.{0,2,3}.*`; every
    encoder key must be present."""
    sd = strip_prefixes(load_torch_state_dict(
        path if path.endswith(".pth") else f"{path}_LXRT.pth"))

    flat, mapper = convert_lxrt_bert(sd, cfg, torch_prefix="bert.",
                                     our_prefix="lxrt")
    assert not mapper.missing, f"encoder keys missing: {mapper.missing[:5]}"

    head = _Mapper(sd)
    head.linear("answer_head.logit_fc.0", "logit_fc/fc1")
    head.layernorm("answer_head.logit_fc.2", "logit_fc/ln")
    flat.update(head.out)

    fc2 = model.logit_fc.fc2
    new_w, new_b, loaded, unload = surger_answer_head(
        sd["answer_head.logit_fc.3.weight"], sd["answer_head.logit_fc.3.bias"],
        fc2.weight.detach().cpu().numpy(), fc2.bias.detach().cpu().numpy(),
        label2ans, AnswerTable(all_ans_path))
    print(f"Loaded {loaded} answers from LXRTQA pre-training and {unload} not")
    flat["logit_fc/fc2/kernel"] = new_w.T
    flat["logit_fc/fc2/bias"] = new_b
    merge_into(model, flat)
