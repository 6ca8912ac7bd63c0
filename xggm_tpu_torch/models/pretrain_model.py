"""LXMERT pretraining model and its losses (counterpart of
`xggm_tpu/models/pretrain_model.py`).

The encoder (`lxrt`) feeds four heads: the masked-LM head over the language
stream, with its decoder tied to the encoder's word-embedding table; the
matched-pair classifier over the pooled output (`seq_relationship`); the
visual heads over the visual stream (object class, attribute and feature
regression); and the answer head over the pooled output. The loss is their
sum, the visual losses masked by confidence and weighted 1 / 0.15, in the
order of `LOSSES_NAME`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from xggm_tpu_torch.config import LxmertConfig
from xggm_tpu_torch.models.lxmert import (
    AnswerHead, LMPredictionHead, LxmertModel, VisualObjHead)
from xggm_tpu_torch.ops.basic import Dense, DropoutRng
from xggm_tpu_torch.ops.losses import cross_entropy, smooth_l1
from xggm_tpu_torch.utils.device import resolve_device

VISUAL_LOSS_WEIGHT = 1.0 / 0.15
LOSSES_NAME = ("Mask_LM", "Matched", "Obj", "Attr", "Feat", "QA")

Batch = Dict[str, torch.Tensor]


class PretrainModel(nn.Module):
    """Encoder and the heads of the tasks asked for; parameters
    uninitialised on `device` until `ops.basic.init_weights` or a state dict
    fills them. The matched-pair head is always built, as in the JAX
    package. Every forward takes an optional `DropoutRng`; without one it is
    deterministic."""

    def __init__(self, cfg: LxmertConfig, num_answers: int = 2,
                 task_mask_lm: bool = True, task_matched: bool = True,
                 task_obj_predict: bool = True, task_qa: bool = True,
                 visual_losses: Sequence[str] = ("obj", "attr", "feat"), *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        c, v, dt = cfg.bert, cfg.visual, cfg.compute_dtype
        self.cfg = cfg
        self.num_answers = num_answers
        self.task_mask_lm = task_mask_lm
        self.task_matched = task_matched
        self.task_obj_predict = task_obj_predict
        self.task_qa = task_qa
        self.visual_losses = tuple(visual_losses)
        self.lxrt = LxmertModel(cfg, device=dev)
        self.lm_head = LMPredictionHead(c, dt, device=dev)
        self.seq_relationship = Dense(c.hidden_size, 2, dt, device=dev)
        if task_obj_predict:
            dims = {"obj": v.obj_id_num, "attr": v.attr_id_num,
                    "feat": v.visual_feat_dim}
            self.obj_head = VisualObjHead(
                c, self.visual_losses, [dims[k] for k in self.visual_losses],
                dt, device=dev)
        if task_qa:
            self.answer_head = AnswerHead(c.hidden_size, num_answers, dt,
                                          device=dev)

    def forward(self, input_ids, input_mask, segment_ids, feats, boxes,
                rng: Optional[DropoutRng] = None):
        """(lm_logits [B, L, vocab], matched_logits [B, 2], visual
        predictions by loss name or None, answer logits [B, num_answers];
        without the QA task the first pooled unit [B, 1]), all float32."""
        (lang, visn), pooled = self.lxrt(input_ids, input_mask, segment_ids,
                                         feats, boxes, rng=rng)
        lm_logits = self.lm_head(
            lang, self.lxrt.embeddings.word_embeddings.weight)
        matched_logits = self.seq_relationship(pooled).float()
        visn_preds = self.obj_head(visn) if self.task_obj_predict else None
        ans_logits = (self.answer_head(pooled) if self.task_qa
                      else pooled[:, :1].float())
        return lm_logits, matched_logits, visn_preds, ans_logits

    def compute_losses(self, batch: Batch,
                       rng: Optional[DropoutRng] = None,
                       denominators: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  torch.Tensor]:
        """(total loss, the losses by `LOSSES_NAME` name, answer logits) of
        a featurized batch (`data/pretrain_data.py::PretrainFeaturizer`).
        `denominators` replaces the count of labelled rows that the
        Mask_LM, Matched and QA means divide by (a data-parallel rank passes
        the global count over the group's size, so that the ranks' mean
        loss and gradient are the global batch's); the visual losses are
        plain means, alike over equal shards."""
        den = denominators or {}
        lm_logits, matched_logits, visn_preds, ans_logits = self(
            batch["input_ids"], batch["input_mask"], batch["segment_ids"],
            batch["feats"], batch["boxes"], rng=rng)
        losses: Dict[str, torch.Tensor] = {}
        if self.task_mask_lm:
            losses["Mask_LM"] = cross_entropy(
                lm_logits.reshape(-1, lm_logits.shape[-1]),
                batch["lm_labels"].reshape(-1),
                denominator=den.get("Mask_LM"))
        if self.task_matched:
            losses["Matched"] = cross_entropy(
                matched_logits, batch["matched_labels"],
                denominator=den.get("Matched"))
        if self.task_obj_predict:
            for key in self.visual_losses:
                pred = visn_preds[key]
                pred = pred.reshape(-1, pred.shape[-1])
                label = batch[f"{key}_labels"]
                conf = batch[f"{key}_mask"].reshape(-1).float()
                if key == "feat":
                    per = smooth_l1(pred, label.reshape(pred.shape)).mean(1)
                else:
                    per = cross_entropy(pred, label.reshape(-1),
                                        reduction="none")
                losses[key.capitalize()] = ((per * conf).mean()
                                            * VISUAL_LOSS_WEIGHT)
        if self.task_qa:
            losses["QA"] = cross_entropy(ans_logits, batch["ans"],
                                         denominator=den.get("QA"))
        total = sum(losses.values(), torch.zeros((), device=ans_logits.device))
        return total, losses, ans_logits
