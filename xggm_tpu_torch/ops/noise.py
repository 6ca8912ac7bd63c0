"""Score-matching noise and dense-graph helpers (counterpart of the train
path's part of `xggm_tpu/ops/noise.py`). Every draw takes an explicit
`torch.Generator` on the tensor's device."""
from __future__ import annotations

from typing import Tuple

import torch


def _strict_upper(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, n, dtype=like.dtype, device=like.device).triu(1)


def add_edge_noise(generator: torch.Generator, adjs: torch.Tensor,
                   sigma: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Gaussian edge noise and its score target: noise ~
    N(0, sigma^2) on the strict upper triangle, mirrored below; returns
    (adjs + noise, -noise / sigma^2)."""
    raw = torch.randn(adjs.shape, generator=generator, dtype=adjs.dtype,
                      device=adjs.device) * sigma
    upper = raw * _strict_upper(adjs.shape[-1], adjs)
    noise = upper + upper.transpose(-1, -2)
    return adjs + noise, -noise / (sigma ** 2)


def add_feature_noise(generator: torch.Generator, feats: torch.Tensor,
                      sigma: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian node-feature noise and its score target:
    (feats + noise, -noise / sigma^2)."""
    noise = torch.randn(feats.shape, generator=generator, dtype=feats.dtype,
                        device=feats.device) * sigma
    return feats + noise, -noise / (sigma ** 2)


def apply_known_noise(x: torch.Tensor, noise: torch.Tensor,
                      sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pre-drawn noise tensor with the score target the draws above would
    give for it: (x + noise, -noise / sigma^2), the target in float32. Lets
    tests replay the noise of another implementation."""
    return x + noise.to(x.dtype), -noise.float() / (sigma ** 2)


def remove_self_loops(adjs: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal of batched square matrices."""
    n = adjs.shape[-1]
    return adjs * (1.0 - torch.eye(n, dtype=adjs.dtype, device=adjs.device))
