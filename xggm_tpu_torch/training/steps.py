"""Inference steps (counterpart of `make_eval_step` and `make_logits_step`
in `xggm_tpu/training/steps.py`). The GGM branch is absent at inference.

A batch is a dict of tensors on the model's device: input_ids, input_mask,
segment_ids [B, L] integer, feats [B, 36, F], boxes [B, 36, 4].
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from xggm_tpu_torch.models.task_model import XGGMModel


def _logits(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    args = (batch["input_ids"], batch["input_mask"], batch["segment_ids"],
            batch["feats"], batch["boxes"])
    if isinstance(model, XGGMModel):
        return model.clean_forward(*args)
    return model(*args)


def make_logits_step(model) -> Callable[[Dict[str, torch.Tensor]],
                                        torch.Tensor]:
    """batch -> float32 logits [B, num_answers]."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _logits(model, batch)

    return step


def make_eval_step(model) -> Callable[[Dict[str, torch.Tensor]],
                                      torch.Tensor]:
    """batch -> predicted answer ids [B] (argmax of the logits)."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _logits(model, batch).argmax(dim=-1)

    return step
