"""Fused softmax attention, with and without dropout on the probabilities,
over flattened (batch * head) rows and in the [B, L, H, 64] projection
layout (BLHD): the counterpart of
`xggm_tpu/ops/pallas_attention.py::fused_attention`, `mha_pallas`,
`fused_attention_dropout`, `mha_pallas_dropout`, `fused_attention_blhd`,
`mha_pallas_blhd`, `fused_attention_dropout_blhd` and
`mha_pallas_dropout_blhd`.

Six hand-written CUDA kernels, each behind a wrapper that counts its
launches (`<wrapper>.launches`):
- kernel 1, `csrc/attention_fwd.cu`: softmax(q k^T / 8 + bias) v, behind
  `fused_attention` (which counts). In bf16 it runs on the tensor cores
  (`attention_common.cuh`, `attention_forward_block_bf16`, which kernels 2,
  4 and 5 share); fp32 keeps a scalar body.
- kernel 2, `csrc/attention_dropout.cu`: the same with in-kernel dropout on
  the probabilities, behind `attention_dropout_fwd`; in bf16 the same body
  with the dropout multiplier;
- kernel 3, `csrc/attention_dropout.cu`: the backward of kernel 2, behind
  `attention_dropout_bwd`. At rate 0 it is also kernel 1's backward. In
  bf16 it runs on the tensor cores (`attention_common.cuh`,
  `attention_backward_block_bf16`); fp32 keeps a scalar body.
- kernels 4, 5 and 6, `csrc/attention_blhd.cu`: kernels 1, 2 and 3 on q
  [B, Lq, H, 64], k and v [B, Lk, H, 64], behind `fused_attention_blhd`
  (which counts kernel 4), `attention_dropout_blhd_fwd` and
  `attention_dropout_blhd_bwd`. Head h of batch b draws the mask of the
  flattened row b * H + h, so they give the same bits as kernels 1 to 3 on
  the permuted inputs with the same seed.

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
gradient. `fused_attention_blhd` and `fused_attention_dropout_blhd` save
and redraw as the flattened Functions do; their plain versions
(`attention_blhd_reference`, `attention_dropout_blhd_reference` and
`attention_dropout_blhd_reference_grads`) permute to the flattened layout
and back.
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
# the scalar bodies hold two keys per lane of one warp; the bf16 bodies pad
# Lq and Lk to at most four tiles of 16
MAX_LEN = 64
_FWD = "attention_fwd"
_DROPOUT = "attention_dropout"
_BLHD = "attention_blhd"
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


def _check(q, k, v, bias, heads, g=None, blhd=False):
    """Raise on what the kernels do not take: q [BH, Lq, 64] and k, v
    [BH, Lk, 64] with BH a multiple of heads, or with blhd q [B, Lq, H, 64]
    and k, v [B, Lk, H, 64] with H = heads; bias fp32 [B, Lk] or None; g as
    q; one device, contiguous and 16-byte aligned, bf16 or fp32."""
    if blhd:
        if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
            raise ValueError("q, k, v must be [B, L, H, D]")
        b, lq, h, d = q.shape
        lk = k.shape[1]
        if h != heads or k.shape != (b, lk, h, d):
            raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                             f": need matching B and H = {heads}")
        bh = b * h
    else:
        if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
            raise ValueError("q, k, v must be [BH, L, D]")
        bh, lq, d = q.shape
        lk = k.shape[1]
        if k.shape != (bh, lk, d):
            raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                             ": need matching BH")
    if d != HEAD_DIM or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need D = {HEAD_DIM} and "
                         "matching v and k")
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


# -- the BLHD layout: kernels 4, 5 and 6 --------------------------------------


def _to_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> the flattened [B * H, L, D] rows (a copy)."""
    b, length, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, length, d)


def _from_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B * H, L, D] rows -> [B, L, H, D] (a copy)."""
    bh, length, d = x.shape
    return x.view(b, bh // b, length, d).transpose(1, 2).contiguous()


def attention_dropout_blhd_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor,
                                     bias: Optional[torch.Tensor],
                                     keep: Optional[torch.Tensor]
                                     ) -> torch.Tensor:
    """Plain PyTorch version of kernels 4 and 5: q [B, Lq, H, D], k/v
    [B, Lk, H, D], bias [B, Lk] or None, keep the float32 multiplier of the
    flattened rows [B * H, Lq, Lk] (row b * H + h for head h of batch b) or
    None. `attention_dropout_reference` on the permuted rows, permuted
    back: [B, Lq, H, D] in q's dtype."""
    b, _, h, _ = q.shape
    out = attention_dropout_reference(_to_rows(q), _to_rows(k), _to_rows(v),
                                      bias, h, keep)
    return _from_rows(out, b)


def attention_blhd_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of kernel 4: no dropout."""
    return attention_dropout_blhd_reference(q, k, v, bias, None)


def attention_dropout_blhd_reference_grads(q: torch.Tensor, k: torch.Tensor,
                                           v: torch.Tensor,
                                           bias: Optional[torch.Tensor],
                                           keep: Optional[torch.Tensor],
                                           g: torch.Tensor) -> Grads:
    """Plain PyTorch version of kernel 6: (dq, dk, dv) [B, L, H, D] of the
    plain BLHD forward at output gradient g [B, Lq, H, D], computed as
    `attention_dropout_reference_grads` on the permuted rows."""
    b, _, h, _ = q.shape
    grads = attention_dropout_reference_grads(
        _to_rows(q), _to_rows(k), _to_rows(v), bias, h, keep, _to_rows(g))
    return tuple(_from_rows(x, b) for x in grads)


def _keep_blhd(q, k, seed, rate):
    """The Philox mask of a BLHD call as flattened rows, or None at 0."""
    if rate == 0.0:
        return None
    b, lq, h, _ = q.shape
    return dropout_keep(seed, b * h, lq, k.shape[1], rate, q.device)


def _blhd_args(q, k) -> tuple:
    """(batch, lq, lk, heads, is_bf16) of a BLHD launch."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
            int(q.dtype == torch.bfloat16))


def _attention_blhd_fwd(q, k, v, bias):
    """Kernel 4 on a CUDA tensor, the plain version on a CPU tensor."""
    if not _on_card(q):
        return attention_blhd_reference(q, k, v, bias)
    _check(q, k, v, bias, q.shape[2], blhd=True)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn(_BLHD, "xggm_attention_blhd_fwd", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), *_blhd_args(q, k), _stream(q))
    _raise_on(err, _BLHD, "attention_blhd_fwd")
    _count(fused_attention_blhd)
    return o


def attention_dropout_blhd_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor],
                               seed: int, rate: float) -> torch.Tensor:
    """Kernel 5: kernel 2 on q [B, Lq, H, 64], k and v [B, Lk, H, 64].
    `attention_dropout_blhd_fwd.launches` counts its launches."""
    drop = _dropout_args(seed, rate)
    if not _on_card(q):
        return attention_dropout_blhd_reference(q, k, v, bias,
                                                _keep_blhd(q, k, seed, rate))
    _check(q, k, v, bias, q.shape[2], blhd=True)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn(_BLHD, "xggm_attention_dropout_blhd_fwd", _DROPOUT_FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), *_blhd_args(q, k), *drop, _stream(q))
    _raise_on(err, _BLHD, "attention_dropout_blhd_fwd")
    _count(attention_dropout_blhd_fwd)
    return o


def attention_dropout_blhd_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor],
                               seed: int, rate: float,
                               g: torch.Tensor) -> Grads:
    """Kernel 6: (dq, dk, dv) in BLHD of kernel 5 at output gradient g, the
    mask drawn again from `seed`; at rate 0, the gradient of kernel 4.
    `attention_dropout_blhd_bwd.launches` counts its launches."""
    drop = _dropout_args(seed, rate)
    if not _on_card(q):
        return attention_dropout_blhd_reference_grads(
            q, k, v, bias, _keep_blhd(q, k, seed, rate), g)
    _check(q, k, v, bias, q.shape[2], g, blhd=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _fn(_BLHD, "xggm_attention_dropout_blhd_bwd", _DROPOUT_BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_blhd_args(q, k), *drop, _stream(q))
    _raise_on(err, _BLHD, "attention_dropout_blhd_bwd")
    _count(attention_dropout_blhd_bwd)
    return dq, dk, dv


attention_dropout_blhd_fwd.launches = 0
attention_dropout_blhd_bwd.launches = 0


class _AttentionBlhd(torch.autograd.Function):
    """Kernel 4 forward, kernel 6 at rate 0 backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _attention_blhd_fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_dropout_blhd_bwd(q, k, v, bias, 0, 0.0,
                                                g.contiguous())
        return dq, dk, dv, None


class _AttentionDropoutBlhd(torch.autograd.Function):
    """Kernel 5 forward, kernel 6 backward, one seed for both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        ctx.save_for_backward(q, k, v, bias)
        return attention_dropout_blhd_fwd(q, k, v, bias, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_dropout_blhd_bwd(q, k, v, bias, ctx.seed,
                                                ctx.rate, g.contiguous())
        return dq, dk, dv, None, None, None


def fused_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T / 8 + bias) v in the [B, L, H, 64] layout,
    differentiable in q, k and v. `fused_attention_blhd.launches` counts
    kernel 4's launches."""
    return _AttentionBlhd.apply(q, k, v, bias)


fused_attention_blhd.launches = 0


def fused_attention_dropout_blhd(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: Optional[torch.Tensor], seed: int,
                                 rate: float) -> torch.Tensor:
    """BLHD attention with inverted dropout at `rate` on the probabilities,
    head h of batch b drawing the mask of seed + b * H + h in the kernels;
    differentiable in q, k and v."""
    return _AttentionDropoutBlhd.apply(q, k, v, bias, seed, rate)


def mha_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, L, H, D] attention with no transpose at the kernel boundary (the
    layout of `mha_pallas_blhd`); bias [B, Lk] or None."""
    return fused_attention_blhd(q.contiguous(), k.contiguous(),
                                v.contiguous(), bias)


def mha_dropout_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], seed: int,
                     rate: float) -> torch.Tensor:
    """[B, L, H, D] attention with probability dropout (the layout of
    `mha_pallas_dropout_blhd`); bias [B, Lk] or None."""
    return fused_attention_dropout_blhd(q.contiguous(), k.contiguous(),
                                        v.contiguous(), bias, seed, rate)
