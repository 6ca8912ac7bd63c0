"""Losses of the GGM train step and of pretraining, in float32 (counterpart
of `bce_with_logits`, `symmetric_kl`, `score_matching_loss`,
`cross_entropy`, `smooth_l1` and `hinge_discriminator_loss` in
`xggm_tpu/ops/losses.py`)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits (torch BCEWithLogitsLoss), in
    the stable form max(x, 0) - x t + log1p(exp(-|x|))."""
    x, t = logits.float(), targets.float()
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def symmetric_kl(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise mean of KL(py || px) + KL(px || py), the softmaxes taken
    over the last axis."""
    log_px = F.log_softmax(x.float(), dim=-1)
    log_py = F.log_softmax(y.float(), dim=-1)
    px, py = log_px.exp(), log_py.exp()
    return (py * (log_py - log_px) + px * (log_px - log_py)).mean()


def score_matching_loss(score: torch.Tensor, grad_log_q_noise: torch.Tensor,
                        sigma: float = 0.2) -> torch.Tensor:
    """Denoising score matching, per-matrix normalised:
    0.5 sigma^2 mean_b(sum_ij (score - grad)^2) / (d1 d2)."""
    diff = (score - grad_log_q_noise).float()
    per_example = diff.square().sum(dim=(-1, -2))
    denom = score.shape[-1] * score.shape[-2]
    return 0.5 * (sigma ** 2) * per_example.mean() / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1, reduction: str = "mean",
                  denominator: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Softmax cross-entropy over the last axis in float32 (torch
    CrossEntropyLoss). A row whose label is `ignore_index` contributes 0;
    "mean" divides by the number of the other rows, at least 1, so a batch
    with every row ignored gives 0, or by `denominator` when one is given
    (a data-parallel rank's share of the global batch's count). "none"
    returns the per-row values."""
    valid = labels != ignore_index
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])
    nll = torch.where(valid, nll[..., 0], 0.0)
    if reduction == "none":
        return nll
    if denominator is None:
        denominator = valid.float().sum().clamp_min(1.0)
    return nll.sum() / denominator


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1 in float32 (torch SmoothL1Loss,
    reduction='none')."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def hinge_discriminator_loss(dis_fake: torch.Tensor,
                             dis_real: torch.Tensor) -> torch.Tensor:
    """Hinge GAN discriminator loss: mean(relu(1 - real)) + mean(relu(1 +
    fake)), in float32."""
    return (F.relu(1.0 - dis_real.float()).mean()
            + F.relu(1.0 + dis_fake.float()).mean())
