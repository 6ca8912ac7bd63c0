"""VQA debiasing losses over (hidden, logits, bias, labels) batches
(counterpart of `xggm_tpu/ops/debias_losses.py`): Plain, Focal and
ReweightByInvBias as functions, BiasProduct and LearnedMixin as modules
with the JAX package's parameters (`smooth_param`, `bias_lin`)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import lecun_dense


def convert_sigmoid_logits_to_binary_logprobs(
        logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log p, log (1 - p)) of sigmoid logits."""
    return -F.softplus(-logits), -logits - F.softplus(-logits)


def elementwise_logsumexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def renormalize_binary_logits(a: torch.Tensor, b: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = elementwise_logsumexp(a, b)
    return a - norm, b - norm


def _bce_mean(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def plain_loss(hidden: torch.Tensor, logits: torch.Tensor,
               bias: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCE times the number of answers."""
    return _bce_mean(logits, labels) * labels.shape[1]


def focal_loss(hidden: torch.Tensor, logits: torch.Tensor,
               bias: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCE of log(softmax(logits) + 1e-5) (1 - softmax(bias))^2, times the
    number of answers."""
    focal = (torch.log(torch.softmax(logits, 1) + 1e-5)
             * (1.0 - torch.softmax(bias, 1)).square())
    return _bce_mean(focal, labels) * labels.shape[1]


def reweight_by_inv_bias(hidden: torch.Tensor, logits: torch.Tensor,
                         bias: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy weighted by 1 - bias."""
    log_p, log_1mp = convert_sigmoid_logits_to_binary_logprobs(logits)
    loss = -(log_p * labels + (1.0 - labels) * log_1mp)
    weights = 1.0 - bias
    return (loss * weights).sum() / weights.sum()


class _Smoothed(nn.Module):
    """A learnable smoothing logit `smooth_param` [1] (starting at
    smooth_init) when `smooth`, added through a sigmoid to
    constant_smooth."""

    def __init__(self, smooth: bool, smooth_init: float,
                 constant_smooth: float, *, device=None):
        super().__init__()
        self.smooth_init = smooth_init
        self.constant_smooth = constant_smooth
        self.smooth_param = (nn.Parameter(torch.empty(1, device=device))
                             if smooth else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.smooth_param is not None:
            with torch.no_grad():
                self.smooth_param.fill_(self.smooth_init)

    def _smoothing(self, b: torch.Tensor) -> torch.Tensor:
        b = b + self.constant_smooth
        if self.smooth_param is not None:
            b = b + torch.sigmoid(self.smooth_param)[0]
        return b


class BiasProduct(_Smoothed):
    """Product of experts with the (smoothed) bias distribution."""

    def __init__(self, smooth: bool = True, smooth_init: float = -1.0,
                 constant_smooth: float = 0.0, *, device=None):
        super().__init__(smooth, smooth_init, constant_smooth, device=device)

    def forward(self, hidden: torch.Tensor, logits: torch.Tensor,
                bias: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        smooth = self._smoothing(torch.zeros((), device=logits.device))
        log_p, log_1mp = convert_sigmoid_logits_to_binary_logprobs(logits)
        log_p = log_p + torch.log(bias + smooth)
        log_1mp = log_1mp + torch.log1p(-bias + smooth)
        log_p, log_1mp = renormalize_binary_logits(log_p, log_1mp)
        return (-(log_p * labels + (1.0 - labels) * log_1mp).sum(1)).mean()


class LearnedMixin(_Smoothed):
    """Learned-mixin: the bias log-probabilities scaled by softplus(
    `bias_lin`(hidden)), plus w times the entropy of the scaled bias."""

    def __init__(self, w: float, hidden_dim: int = 1024, smooth: bool = True,
                 smooth_init: float = -1.0, constant_smooth: float = 0.0, *,
                 device=None):
        super().__init__(smooth, smooth_init, constant_smooth, device=device)
        self.w = w
        self.bias_lin = lecun_dense(hidden_dim, 1, device=device)

    def forward(self, hidden: torch.Tensor, logits: torch.Tensor,
                bias: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        factor = F.softplus(self.bias_lin(hidden))
        b = self._smoothing(torch.stack([bias, 1.0 - bias], 2))
        b = torch.log(b) * factor[:, :, None]
        log_p, log_1mp = convert_sigmoid_logits_to_binary_logprobs(logits)
        both = b + torch.stack([log_p, log_1mp], 2)
        log_p, log_1mp = renormalize_binary_logits(both[:, :, 0],
                                                   both[:, :, 1])
        loss = (-(log_p * labels + (1.0 - labels) * log_1mp).sum(1)).mean()
        bias_logprob = b - elementwise_logsumexp(b[:, :, 0],
                                                 b[:, :, 1])[:, :, None]
        entropy = (-(torch.exp(bias_logprob) * bias_logprob).sum(2)).mean()
        return loss + self.w * entropy
