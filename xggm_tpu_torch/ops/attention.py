"""Fused softmax attention over flattened (batch * head) rows: the
counterpart of `xggm_tpu/ops/pallas_attention.py::fused_attention` and
`mha_pallas`.

`fused_attention` launches the hand-written CUDA kernel
(`csrc/attention_fwd.cu`) on a CUDA tensor and raises if it cannot; on a CPU
tensor it runs `attention_reference`, the plain PyTorch version of the same
function, which the tests compare against the JAX package. Forward only: the
serving path needs no gradient.

The mask is an fp32 additive key bias of one row per batch element, [B, Lk]
with values 0 or -10000, or None for no mask. Row r of the flattened
[B * H, L, 64] layout belongs to batch element r // H.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from xggm_tpu_torch.ops import build

HEAD_DIM = 64
MAX_LEN = 64  # the kernel holds two keys per lane of one warp
_KERNEL = "attention_fwd"
_COUNT_LOCK = threading.Lock()  # server threads may launch concurrently


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        heads: int) -> torch.Tensor:
    """Plain PyTorch version: q [BH, Lq, D], k/v [BH, Lk, D], bias [B, Lk]
    or None -> softmax(q k^T / sqrt(D) + bias) v in q's dtype, with the
    scores and softmax in fp32 and p rounded to v's dtype first."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (q.shape[-1] ** -0.5)
    if bias is not None:
        s = s + bias.float().repeat_interleave(heads, dim=0)[:, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _kernel_fn():
    fn = build.load(_KERNEL).xggm_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = build.load(_KERNEL).xggm_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check(q, k, v, bias, heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [BH, L, D]")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if d != HEAD_DIM or k.shape != (bh, lk, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need D = {HEAD_DIM} and "
                         "matching BH and Lk")
    if not (1 <= lq <= MAX_LEN and 1 <= lk <= MAX_LEN):
        raise ValueError(f"Lq {lq}, Lk {lk}: the kernel takes 1..{MAX_LEN}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one "
                         "of bfloat16 or float32 for all three")
    if heads <= 0 or bh % heads:
        raise ValueError(f"BH {bh} is not a multiple of heads {heads}")
    tensors = [q, k, v] + ([] if bias is None else [bias])
    for t in tensors:
        if t.device != q.device:
            raise ValueError("q, k, v and bias must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel needs contiguous, 16-byte aligned "
                             "tensors")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (bh // heads, lk)):
        raise ValueError(f"bias must be float32 [{bh // heads}, {lk}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """softmax(q k^T / 8 + bias) v over [BH, L, 64] rows; see the module
    docstring. `fused_attention.launches` counts the kernel's launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, heads)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, bias, heads)
    bh, lq, _ = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            bh, lq, k.shape[1], heads, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err} "
                           f"({_error_string(err)})")
    with _COUNT_LOCK:
        fused_attention.launches += 1
    return o


fused_attention.launches = 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, H, L, D] attention through `fused_attention` (the layout of
    `mha_pallas`); bias [B, Lk] or None."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = fused_attention(q.reshape(b * h, lq, d).contiguous(),
                          k.reshape(b * h, lk, d).contiguous(),
                          v.reshape(b * h, lk, d).contiguous(), bias, h)
    return out.view(b, h, lq, d)
