"""Shared NN primitives: erf GeLU, float32 LayerNorm (and its eps-1e-5 GGM
flavour), BERT-init Dense, the torch-default-init TorchLinear, and hidden
dropout from explicit generators (counterpart of `xggm_tpu/ops/basic.py` and
of flax `nn.Dropout`).

Every module creates its parameters uninitialised on `device`;
`reset_parameters(generator)` draws them from an explicit torch.Generator on
the same device. Parameters are float32 masters; `Dense` casts its input and
weights to its compute dtype at use, as flax `nn.Dense(dtype=...)` does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 where it is already (a float64 reference
    run computes in float64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-based GeLU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


class LayerNorm(nn.Module):
    """LayerNorm computed in float32 (float64 for a float64 input) with a
    configurable epsilon; the output takes the input's dtype. eps 1e-12 is
    BertLayerNorm; 1e-5 the torch default used by the GGM modules."""

    def __init__(self, dim: int, eps: float = 1e-12, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = at_least_float32(x)
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


TORCH_LN_EPS = 1e-5
# flax nn.LayerNorm's default, which the JAX package's research-lineage
# modules (score network, graph VAE, MixGenerator) keep
FLAX_LN_EPS = 1e-6


class TorchLayerNorm(LayerNorm):
    """LayerNorm with torch's default eps 1e-5, as the GGM modules use."""

    def __init__(self, dim: int, *, device=None):
        super().__init__(dim, TORCH_LN_EPS, device=device)


class Dense(nn.Module):
    """y = x W^T + b in `dtype`, with float32 weight [out, in] and BERT
    normal(stddev) init (flax Dense through `xggm_tpu.ops.basic.dense`);
    `bias=False` drops b."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, *, stddev: float = 0.02,
                 bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.stddev = stddev
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.stddev, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class TorchLinear(Dense):
    """Dense with torch nn.Linear's default init: kaiming-uniform weight and
    uniform bias, both in +-1/sqrt(fan_in)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)


def lecun_dense(n_in: int, n_out: int, *, bias: bool = True,
                device=None) -> Dense:
    """Dense in float32 with the variance of flax nn.Dense's default init
    (lecun: 1 / fan_in; a plain normal here, where flax truncates)."""
    return Dense(n_in, n_out, stddev=math.sqrt(1.0 / n_in), bias=bias,
                 device=device)


class Embedding(nn.Module):
    """float32 lookup table [num, dim] with BERT normal(stddev) init."""

    def __init__(self, num: int, dim: int, *, stddev: float = 0.02,
                 device=None):
        super().__init__()
        self.stddev = stddev
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.stddev, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, submodule by
    submodule in registration order; returns `module`."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax `nn.Dropout`: keep with probability 1 - p
    (drawn from `generator`, which lies on x's device) and scale the kept
    values by 1 / (1 - p) in x's dtype. p = 0 returns x."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class DropoutRng:
    """The random draws of a training forward, from two explicit generators
    seeded with `seed`: hidden-dropout masks from one on the model's device,
    and the 31-bit seeds of the attention-dropout kernels from one on the
    host, since a seed reaches the kernel launch as a host integer and
    drawing it there costs no device sync. Passing no DropoutRng to a
    forward makes it deterministic."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device_generator = torch.Generator(device=device).manual_seed(seed)
        self.host_generator = torch.Generator().manual_seed(seed)

    def seed31(self) -> int:
        """A fresh seed in [0, 2^31) for one attention call."""
        return int(torch.randint(0, 2 ** 31, (), generator=self.host_generator))

    def get_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both generators' states (host tensors; no device sync)."""
        return (self.device_generator.get_state(),
                self.host_generator.get_state())

    def set_state(self, state: Tuple[torch.Tensor, torch.Tensor]) -> None:
        """Put both generators back to a `get_state`: the draws that
        followed it are drawn again."""
        self.device_generator.set_state(state[0])
        self.host_generator.set_state(state[1])


def maybe_dropout(x: torch.Tensor, p: float,
                  rng: Optional[DropoutRng]) -> torch.Tensor:
    """Dropout at p under `rng`; the identity for a deterministic forward
    (rng None)."""
    return x if rng is None else dropout(x, p, rng.device_generator)
