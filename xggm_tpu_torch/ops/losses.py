"""Losses of the GGM train step, in float32 (counterpart of
`bce_with_logits`, `symmetric_kl` and `score_matching_loss` in
`xggm_tpu/ops/losses.py`)."""
from __future__ import annotations

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
