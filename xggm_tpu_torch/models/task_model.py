"""Task models (counterpart of `xggm_tpu/models/task_model.py`): the LXMERT
encoder plus the answer head.

`XGGMModel` carries the serving path's submodules, `lxrt` and `logit_fc`. Its
GGM submodules (`generator`, `encoder_adj`, `node_fc`, `fusion_fc`) are
absent at inference and come with the training slice of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from xggm_tpu_torch.config import LxmertConfig
from xggm_tpu_torch.models.lxmert import AnswerHead, LxmertModel
from xggm_tpu_torch.utils.device import resolve_device


class XGGMModel(nn.Module):
    """Encoder + answer head; parameters uninitialised on `device` until
    `ops.basic.init_weights` or a state dict fills them."""

    def __init__(self, cfg: LxmertConfig, num_answers: int, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_answers = num_answers
        self.lxrt = LxmertModel(cfg, device=dev)
        self.logit_fc = AnswerHead(cfg.bert.hidden_size, num_answers,
                                   cfg.compute_dtype, device=dev)

    def forward(self, input_ids, input_mask, token_type_ids, feats, boxes):
        """Encoder pass: ((lang_seq, visn_seq), input_mask, pooled)."""
        feat_seq, pooled = self.lxrt(input_ids, input_mask, token_type_ids,
                                     feats, boxes)
        return feat_seq, input_mask, pooled

    def clean_forward(self, input_ids, input_mask, token_type_ids, feats,
                      boxes) -> torch.Tensor:
        """Encoder -> answer logits [B, num_answers] in float32."""
        _, _, pooled = self(input_ids, input_mask, token_type_ids, feats,
                            boxes)
        return self.logit_fc(pooled)


class PlainModel(nn.Module):
    """Encoder + answer head baseline: forward returns the logits."""

    def __init__(self, cfg: LxmertConfig, num_answers: int, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_answers = num_answers
        self.lxrt = LxmertModel(cfg, device=dev)
        self.logit_fc = AnswerHead(cfg.bert.hidden_size, num_answers,
                                   cfg.compute_dtype, device=dev)

    def forward(self, input_ids, input_mask, token_type_ids, feats,
                boxes) -> torch.Tensor:
        _, pooled = self.lxrt(input_ids, input_mask, token_type_ids, feats,
                              boxes)
        return self.logit_fc(pooled)
