"""Fused softmax attention over flattened (batch * head) rows, with and
without dropout on the probabilities: the counterpart of
`xggm_tpu/ops/pallas_attention.py::fused_attention`, `mha_pallas`,
`fused_attention_dropout` and `mha_pallas_dropout`.

Three hand-written CUDA kernels, each behind a wrapper that counts its
launches (`<wrapper>.launches`):
- kernel 1, `csrc/attention_fwd.cu`: softmax(q k^T / 8 + bias) v, behind
  `fused_attention` (which counts);
- kernel 2, `csrc/attention_dropout.cu`: the same with in-kernel dropout on
  the probabilities, behind `attention_dropout_fwd`;
- kernel 3, `csrc/attention_dropout.cu`: the backward of kernel 2, behind
  `attention_dropout_bwd`. At rate 0 it is also kernel 1's backward.

`fused_attention` and `fused_attention_dropout` are `torch.autograd.Function`s
over them; they save q, k, v, bias and the seed, never the probabilities or
the mask, which the backward kernel draws again from the seed
(`ops/philox.py` sets out the draws). A CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain PyTorch version of the same function
(`attention_dropout_reference` and `attention_dropout_reference_grads`, fed
the same Philox mask), which the tests compare against the JAX package.

The mask is an fp32 additive key bias of one row per batch element, [B, Lk]
with values 0 or -10000, or None for no mask. Row r of the flattened
[B * H, L, 64] layout belongs to batch element r // H. The bias gets no
gradient.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from xggm_tpu_torch.ops import build
from xggm_tpu_torch.ops.philox import (
    MASK32, dropout_keep, keep_scale, keep_threshold)

HEAD_DIM = 64
MAX_LEN = 64  # the kernels hold two keys per lane of one warp
_FWD = "attention_fwd"
_DROPOUT = "attention_dropout"
_COUNT_LOCK = threading.Lock()  # server threads may launch concurrently
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def attention_dropout_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: Optional[torch.Tensor],
                                heads: int,
                                keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of kernels 1 and 2: q [BH, Lq, D], k/v
    [BH, Lk, D], bias [B, Lk] or None, keep a float32 multiplier
    [BH, Lq, Lk] (0 or 1 / (1 - rate)) or None for no dropout. Returns
    (p * keep) v in q's dtype, p = softmax(q k^T / sqrt(D) + bias) in fp32,
    p * keep rounded to v's dtype before the second product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (q.shape[-1] ** -0.5)
    if bias is not None:
        s = s + bias.float().repeat_interleave(heads, dim=0)[:, None, :]
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = p * keep
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        heads: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 1: no dropout."""
    return attention_dropout_reference(q, k, v, bias, heads, None)


def attention_dropout_reference_grads(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      bias: Optional[torch.Tensor],
                                      heads: int,
                                      keep: Optional[torch.Tensor],
                                      g: torch.Tensor) -> Grads:
    """Plain PyTorch version of kernel 3: (dq, dk, dv) of the plain forward
    at output gradient g, computed in fp32 from fp32 copies of the inputs
    (so p * keep is not rounded, as in the TPU kernel's backward) and
    returned in the inputs' dtypes."""
    with torch.enable_grad():
        q32, k32, v32 = (t.detach().float().requires_grad_()
                         for t in (q, k, v))
        o = attention_dropout_reference(q32, k32, v32, bias, heads, keep)
        dq, dk, dv = torch.autograd.grad(o, (q32, k32, v32), g.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fn(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_DROP = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]  # _dropout_args
_FWD_ARGS = [_PTR] * 5 + [_INT] * 5 + [_PTR]
_DROPOUT_FWD_ARGS = [_PTR] * 5 + [_INT] * 5 + _DROP + [_PTR]
_DROPOUT_BWD_ARGS = [_PTR] * 8 + [_INT] * 5 + _DROP + [_PTR]


def _raise_on(err: int, lib: str, what: str) -> None:
    if err:
        fn = build.load(lib).xggm_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _check(q, k, v, bias, heads, g=None):
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
    if g is not None and (g.shape != q.shape or g.dtype != q.dtype):
        raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} does not "
                         f"match q {q.dtype} {tuple(q.shape)}")
    tensors = [q, k, v] + [t for t in (bias, g) if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("q, k, v, bias and g must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel needs contiguous, 16-byte aligned "
                             "tensors")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (bh // heads, lk)):
        raise ValueError(f"bias must be float32 [{bh // heads}, {lk}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _shape_args(q, k, heads) -> tuple:
    """(bh, lq, lk, heads, is_bf16) of a launch."""
    return (q.shape[0], q.shape[1], k.shape[1], heads,
            int(q.dtype == torch.bfloat16))


def _dropout_args(seed: int, rate: float) -> tuple:
    """(seed, threshold, keep_scale) of a launch; raises on a bad rate."""
    return seed & MASK32, keep_threshold(rate), keep_scale(rate)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _on_card(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return True


def _keep(q, k, seed, rate):
    """The Philox keep/scale mask of a call, or None at rate 0."""
    if rate == 0.0:
        return None
    return dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1], rate,
                        q.device)


def _attention_fwd(q, k, v, bias, heads):
    """Kernel 1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not _on_card(q):
        return attention_reference(q, k, v, bias, heads)
    _check(q, k, v, bias, heads)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn(_FWD, "xggm_attention_fwd", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), *_shape_args(q, k, heads), _stream(q))
    _raise_on(err, _FWD, "attention_fwd")
    _count(fused_attention)
    return o


def attention_dropout_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], heads: int, seed: int,
                          rate: float) -> torch.Tensor:
    """Kernel 2: (p * m) v with m the Philox mask of `seed` at `rate`.
    `attention_dropout_fwd.launches` counts its launches."""
    drop = _dropout_args(seed, rate)
    if not _on_card(q):
        return attention_dropout_reference(q, k, v, bias, heads,
                                           _keep(q, k, seed, rate))
    _check(q, k, v, bias, heads)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn(_DROPOUT, "xggm_attention_dropout_fwd", _DROPOUT_FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), *_shape_args(q, k, heads), *drop, _stream(q))
    _raise_on(err, _DROPOUT, "attention_dropout_fwd")
    _count(attention_dropout_fwd)
    return o


def attention_dropout_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], heads: int, seed: int,
                          rate: float, g: torch.Tensor) -> Grads:
    """Kernel 3: (dq, dk, dv) of kernel 2 at output gradient g, with the
    mask drawn again from `seed`; at rate 0, the gradient of kernel 1.
    `attention_dropout_bwd.launches` counts its launches."""
    drop = _dropout_args(seed, rate)
    if not _on_card(q):
        return attention_dropout_reference_grads(
            q, k, v, bias, heads, _keep(q, k, seed, rate), g)
    _check(q, k, v, bias, heads, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _fn(_DROPOUT, "xggm_attention_dropout_bwd", _DROPOUT_BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, heads), *drop, _stream(q))
    _raise_on(err, _DROPOUT, "attention_dropout_bwd")
    _count(attention_dropout_bwd)
    return dq, dk, dv


attention_dropout_fwd.launches = 0
attention_dropout_bwd.launches = 0


class _Attention(torch.autograd.Function):
    """Kernel 1 forward, kernel 3 at rate 0 backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, bias)
        return _attention_fwd(q, k, v, bias, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_dropout_bwd(q, k, v, bias, ctx.heads, 0, 0.0,
                                           g.contiguous())
        return dq, dk, dv, None, None


class _AttentionDropout(torch.autograd.Function):
    """Kernel 2 forward, kernel 3 backward, one seed for both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, seed, rate):
        ctx.heads, ctx.seed, ctx.rate = heads, seed, rate
        ctx.save_for_backward(q, k, v, bias)
        return attention_dropout_fwd(q, k, v, bias, heads, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_dropout_bwd(q, k, v, bias, ctx.heads, ctx.seed,
                                           ctx.rate, g.contiguous())
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """softmax(q k^T / 8 + bias) v over [BH, L, 64] rows, differentiable in
    q, k and v; see the module docstring. `fused_attention.launches` counts
    kernel 1's launches."""
    return _Attention.apply(q, k, v, bias, heads)


fused_attention.launches = 0


def fused_attention_dropout(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            heads: int, seed: int,
                            rate: float) -> torch.Tensor:
    """Attention with inverted dropout at `rate` on the probabilities, the
    mask drawn in the kernels from `seed` (row r of the call from seed + r);
    differentiable in q, k and v."""
    return _AttentionDropout.apply(q, k, v, bias, heads, seed, rate)


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, length, d = x.shape
    return x.reshape(b * h, length, d).contiguous()


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, H, L, D] attention through `fused_attention` (the layout of
    `mha_pallas`); bias [B, Lk] or None."""
    b, h, lq, d = q.shape
    out = fused_attention(_flat(q), _flat(k), _flat(v), bias, h)
    return out.view(b, h, lq, d)


def mha_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor], seed: int,
                rate: float) -> torch.Tensor:
    """[B, H, L, D] attention with probability dropout through
    `fused_attention_dropout` (the layout of `mha_pallas_dropout`): row
    b * H + h draws its mask from seed + b * H + h."""
    b, h, lq, d = q.shape
    out = fused_attention_dropout(_flat(q), _flat(k), _flat(v), bias, h,
                                  seed, rate)
    return out.view(b, h, lq, d)
