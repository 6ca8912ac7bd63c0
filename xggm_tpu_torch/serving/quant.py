"""Int8 serving (counterpart of `xggm_tpu/serving/quant.py`).

Post-training quantization of the serving path, as the JAX package does it:
- weights: symmetric per-output-channel int8 (scale = max|W[:, o]| / 127),
  quantized once at export and stored as int8 in the artifact beside a
  float32 `kernel_scale_int8`;
- activations: symmetric dynamic per-row int8, the scale from each row's
  max at run time;
- the int32 accumulator times (a_scale * w_scale) in float32, plus the bias
  in float32, cast to the layer's compute dtype.

Only the encoder's and the answer head's `Dense` layers run int8 (the JAX
package's `nn.Dense`; `TorchLinear`, its own module there, never does), and
the answer projection `fc2` stays in the compute dtype. The int8 x int8 ->
int32 product is a plain matrix product in the JAX package too
(`lax.dot_general`, outside any Pallas kernel), so it is a library call
here: `torch._int_mm`, on the card and on the CPU. On the card `_int_mm`
needs more than 16 rows and K and N that are multiples of 8; `int8_matmul`
pads with zeros, which leaves the integer sums exact.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The answer projection (logits layer) keeps full precision: its output
# feeds argmax with no LayerNorm to absorb quantization noise.
DEFAULT_EXCLUDE = (r"(^|/)fc2$",)
SCALE_KEY = "kernel_scale_int8"
_MIN_ROWS = 17


def quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: w [in, out] -> (int8 w_q, float32
    scale [out]) with w ~= w_q * scale."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.maximum(amax, 1e-8) / 127.0
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return w_q, scale.astype(np.float32)


def quantize_dense_params(flat: Dict[str, np.ndarray],
                          exclude: Sequence[str] = DEFAULT_EXCLUDE
                          ) -> Tuple[Dict[str, np.ndarray], int]:
    """Over a flat `{JAX path: array}` dict: every 2-D float32 `.../kernel`
    whose module path matches no `exclude` regex becomes its int8
    quantization, with a `kernel_scale_int8` sibling right after it (the
    sorted order holds: no leaf of a Dense sorts after `kernel`). GGM
    `TorchLinear` kernels are quantized too, as the JAX package does (no
    serving forward reads them). Returns (new dict, number quantized)."""
    patterns = [re.compile(p) for p in exclude]
    out, n = {}, 0
    for key, arr in flat.items():
        parent, _, leaf = key.rpartition("/")
        if (leaf == "kernel" and arr.ndim == 2 and arr.dtype == np.float32
                and not any(p.search(parent) for p in patterns)):
            out[key], out[f"{parent}/{SCALE_KEY}"] = quantize_kernel(arr)
            n += 1
        else:
            out[key] = arr
    return out, n


def dynamic_act_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x in float32: (int8 x_q, float32 scale
    [..., 1]); x / scale rounded half to even, then clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times w [N, K] int8, transposed: the int32 [M, N]
    product through `torch._int_mm`, zero-padded to at least 17 rows and
    to K and N multiples of 8."""
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n = -k % 8, -n % 8
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    if pad_k or m < _MIN_ROWS:
        a = F.pad(a, (0, pad_k, 0, max(_MIN_ROWS - m, 0)))
    return torch._int_mm(a, w.t())[:m, :n]


class Int8Dense(nn.Module):
    """A `Dense` with an int8 weight [out, in], its float32 per-channel
    `weight_scale` [out] and a float32 bias, all buffers. `calls` counts its
    forwards."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, *, bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device)
                             if bias else None)
        self.calls = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        lead = x.shape[:-1]
        x_q, a_scale = dynamic_act_quant(x.reshape(-1, x.shape[-1]))
        acc = int8_matmul(x_q, self.weight)
        y = acc.float() * (a_scale * self.weight_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype).reshape(*lead, -1)
