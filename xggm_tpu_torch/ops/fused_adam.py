"""Fused BertAdam update: the counterpart of `xggm_tpu/ops/pallas_optim.py`.

Kernel 7, `csrc/bert_adam.cu`, behind `fused_adam` (which counts its
launches in `fused_adam.launches`): for every parameter of one optimizer
update, in one launch,

    g' = g * c
    m' = b1 * m + (1 - b1) * g'
    v' = b2 * v + (1 - b2) * g' * g'
    p' = p - lr_eff[i] * (m' / (sqrt(v') + eps) + wd * p)

with m, v and p written in place, c the global-norm clip scale (a 0-d fp32
tensor) and lr_eff a float32 vector of per-parameter rates, read at the
parameter's index i; and, for a parameter given a bf16 shadow s, s = the
bf16 rounding (to nearest even) of p', in the same pass (the refresh of the
bf16 parameter shadow, `training/steps.py`). A gradient of None is a zero
gradient, a shadow of None none. A CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain PyTorch version, `fused_adam_reference`,
which the tests hold against the JAX package.

The kernel reads a table of (g, m, v, p, numel, index, first chunk, shadow)
rows that the wrapper builds on the host for every update (the gradients
are new tensors each time) and copies to the card from pinned memory
without a synchronisation.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from xggm_tpu_torch.ops import build

_LIB = "bert_adam"
CHUNK = 32768  # elements per block: kChunk of csrc/bert_adam.cu
_ROW = 8  # int64 fields per row of the table
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p] + [ctypes.c_double] * 4 + [ctypes.c_void_p]


@torch.no_grad()
def fused_adam_reference(grads: Sequence[Optional[torch.Tensor]],
                         ms: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         ps: Sequence[torch.Tensor],
                         indices: Sequence[int], clip_scale: torch.Tensor,
                         lr_eff: torch.Tensor, *, b1: float, b2: float,
                         eps: float, wd: float,
                         shadows: Optional[Sequence[Optional[torch.Tensor]]]
                         = None) -> None:
    """Plain PyTorch version of kernel 7: per parameter, the expression of
    `_adam_kernel` in its order, applied to m, v and p in place, then the
    new p cast into its shadow, where it has one."""
    shadows = shadows or [None] * len(ps)
    for g, m, v, p, i, s in zip(grads, ms, vs, ps, indices, shadows):
        gs = torch.zeros_like(p) if g is None else g * clip_scale
        m.copy_(b1 * m + (1.0 - b1) * gs)
        v.copy_(b2 * v + (1.0 - b2) * gs * gs)
        u = m / (v.sqrt() + eps)
        if wd > 0.0:
            u = u + wd * p
        p.sub_(lr_eff[i] * u)
        if s is not None:
            s.copy_(p)


def _check(grads, ms, vs, ps, indices, clip_scale, lr_eff, shadows) -> None:
    n = len(ps)
    if not (len(grads) == len(ms) == len(vs) == len(indices)
            == len(shadows) == n) or not n:
        raise ValueError("grads, ms, vs, ps, indices and shadows must be "
                         "non-empty and of one length")
    device = ps[0].device
    for t in (clip_scale, lr_eff):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError("clip_scale and lr_eff must be float32 on the "
                             "parameters' device")
    if clip_scale.numel() != 1 or lr_eff.dim() != 1:
        raise ValueError("clip_scale must hold one value, lr_eff be a vector")
    if min(indices) < 0 or max(indices) >= lr_eff.numel():
        raise ValueError(f"indices outside lr_eff's {lr_eff.numel()} entries")
    for g, m, v, p in zip(grads, ms, vs, ps):
        for t in (m, v, p) if g is None else (g, m, v, p):
            if (t.device != device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape != p.shape):
                raise ValueError(
                    "the kernel takes contiguous float32 g, m, v and p of one "
                    f"shape on one device; got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} for a parameter {tuple(p.shape)} on {device}")
    for s, p in zip(shadows, ps):
        if s is not None and (s.device != device
                              or s.dtype != torch.bfloat16
                              or not s.is_contiguous()
                              or s.shape != p.shape):
            raise ValueError(
                "a shadow must be a contiguous bfloat16 tensor of its "
                f"parameter's shape on its device; got {s.dtype} "
                f"{tuple(s.shape)} on {s.device} for {tuple(p.shape)}")


def _table(grads, ms, vs, ps, indices, shadows) -> np.ndarray:
    """The kernel's rows, parameters with no element left out."""
    rows = [(0 if g is None else g.data_ptr(), m.data_ptr(), v.data_ptr(),
             p.data_ptr(), p.numel(), i, 0, 0 if s is None else s.data_ptr())
            for g, m, v, p, i, s in zip(grads, ms, vs, ps, indices, shadows)
            if p.numel()]
    table = np.array(rows, dtype=np.int64).reshape(-1, _ROW)
    chunks = (table[:, 4] + CHUNK - 1) // CHUNK
    table[1:, 6] = np.cumsum(chunks)[:-1]
    return table


def _chunks(table: np.ndarray) -> int:
    return int(((table[:, 4] + CHUNK - 1) // CHUNK).sum())


def _launch(rows: torch.Tensor, chunks: int, clip_scale: torch.Tensor,
            lr_eff: torch.Tensor, b1: float, b2: float, eps: float,
            wd: float) -> None:
    """Launch kernel 7 over `rows`, the table on the card."""
    lib = build.load(_LIB)
    fn = lib.xggm_bert_adam
    if fn.argtypes is None:
        lib.xggm_bert_adam_chunk.argtypes = []
        lib.xggm_bert_adam_chunk.restype = ctypes.c_int
        if lib.xggm_bert_adam_chunk() != CHUNK:
            raise RuntimeError("csrc/bert_adam.cu's chunk is not "
                               f"ops/fused_adam.py's {CHUNK}")
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), rows.shape[0], chunks,
                 clip_scale.data_ptr(), lr_eff.data_ptr(), b1, b2, eps, wd,
                 torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on(err, "bert_adam")


def _raise_on(err: int, what: str) -> None:
    if err:
        fn = build.load(_LIB).xggm_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")


def fused_adam(grads: Sequence[Optional[torch.Tensor]],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
               ps: Sequence[torch.Tensor], indices: Sequence[int],
               clip_scale: torch.Tensor, lr_eff: torch.Tensor, *, b1: float,
               b2: float, eps: float, wd: float,
               shadows: Optional[Sequence[Optional[torch.Tensor]]] = None
               ) -> None:
    """One BertAdam update of every parameter `ps[t]` in place (with its
    moments `ms[t]`, `vs[t]`, gradient `grads[t]` or None, rate
    `lr_eff[indices[t]]`, and bf16 shadow `shadows[t]` or None, which gets
    the new value's rounding): kernel 7 in one launch on the card, the
    plain version on the CPU. Nothing is read back to the host."""
    if ps and ps[0].device.type == "cpu":
        fused_adam_reference(grads, ms, vs, ps, indices, clip_scale, lr_eff,
                             b1=b1, b2=b2, eps=eps, wd=wd, shadows=shadows)
        return
    if ps and ps[0].device.type != "cuda":
        raise ValueError(f"no BertAdam kernel for device {ps[0].device}")
    shadows = list(shadows) if shadows is not None else [None] * len(ps)
    _check(grads, ms, vs, ps, indices, clip_scale, lr_eff, shadows)
    table = _table(grads, ms, vs, ps, indices, shadows)
    if not len(table):
        return
    rows = torch.from_numpy(table).pin_memory().to(ps[0].device,
                                                  non_blocking=True)
    _launch(rows, _chunks(table), clip_scale, lr_eff, b1, b2, eps, wd)
    fused_adam.launches += 1


fused_adam.launches = 0
