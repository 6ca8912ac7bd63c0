"""The precision scheme of the fp32 bodies of kernels 1 to 6
(xggm_tpu_torch/csrc/attention_common.cuh, attention_forward_block_f32 and
attention_backward_block_f32), emulated in torch on the CPU.

The bodies sum the scores (q k^T, and the backward's g v^T) in fp32 FMAs in
the plain version's order, and multiply the other products on the tensor
cores in TF32 with fp32 accumulation: the forward's (p * m) v and the
backward's ds k, (p * m)^T g and ds^T q. A TF32 operand is the fp32 bit
pattern of which the tensor cores read the top 19 bits. Each fp32 operand
x enters as hi = x rounded to TF32 (to nearest, ties away from zero:
cvt.rna) and lo = x - hi with its low 13 bits dropped, and a product a b as
a_lo b_hi + a_hi b_lo + a_hi b_hi (three passes). The softmax, the mask
and ds stay fp32 as in the plain version.

This file holds that arithmetic against the plain fp32 versions
(`attention_dropout_reference`, `attention_dropout_reference_grads`) within
the port's fp32 tolerance (`chip_smoke.py`'s FP32_TOL), and against the
JAX package's `fused_attention` (interpreted on the CPU), its
`_reference_attention` and its `fused_attention_dropout` fed the same mask,
within 2e-5 (tests/test_pallas_attention.py's tolerance), at the four
(Lq, Lk) shapes of the training path, masked as there, at dropout rates 0.1
and 0. It also records why three passes: one TF32 pass leaves FP32_TOL at
some path shape.

The emulation lives here and not in the package: the package's plain
versions stay the fp32 math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.ops.pallas_attention import (
    _pick_group, _reference_attention, fused_attention,
    fused_attention_dropout)
from xggm_tpu_torch.ops import attention as attn

B, H, D = 8, 4, 64
# (Lq, Lk, key mask on the training path)
PATH_SHAPES = [(20, 20, True), (36, 36, False), (20, 36, False),
               (36, 20, True)]
RATES = (0.1, 0.0)
SEED = 1234
FP32_TOL = dict(atol=1e-5, rtol=1e-5)  # chip_smoke.py's, kernel vs plain
JAX_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_pallas_attention.py's

_fused = jax.jit(fused_attention)
_reference = jax.jit(lambda *a: _reference_attention(*a)[0])


@jax.jit
def _fused_grads(q, k, v, bias, g):
    return jax.vjp(lambda *a: fused_attention(*a, bias), q, k, v)[1](g)


@jax.jit
def _dropout_fwd_bwd(q, k, v, bias, seeds, g):
    out, vjp = jax.vjp(lambda *a: fused_attention_dropout(
        *a, bias, seeds, RATES[0]), q, k, v)
    return (out, *vjp(g))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread is fastest, and it keeps torch's
    thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tf32(x, nearest):
    """x as a TF32 operand, as fp32: rounded to nearest, ties away from zero
    (cvt.rna.tf32.f32), or its low 13 bits dropped (what the tensor cores
    read of an fp32 register)."""
    b = x.contiguous().view(torch.int32)
    if nearest:
        b = b + 0x1000  # the magnitude's half ulp: sign and magnitude
    return (b & ~0x1fff).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the bodies compute it: three TF32 passes, or one."""
    ah, bh = _tf32(a, True), _tf32(b, True)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_math(q, k, v, bias, keep, g, passes=3):
    """o and (dq, dk, dv) by the bodies' arithmetic: the scores in fp32,
    the other four products in `passes` TF32 passes."""
    scale = D ** -0.5
    s = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.repeat_interleave(H, dim=0)[:, None, :]
    p = torch.softmax(s, dim=-1)
    m = torch.ones_like(p) if keep is None else keep
    pm = p * m
    o = _mm(pm, v, passes)
    dp = m * (g @ v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dv = _mm(pm.transpose(-1, -2), g, passes)
    dq = _mm(ds, k, passes) * scale
    dk = _mm(ds.transpose(-1, -2), q, passes) * scale
    return o, (dq, dk, dv)


def _jax_mask(bh, lq, lk, rate):
    """The mask JAX's interpret path draws (pallas_attention.py
    `_group_dropout_mask`): per group of rows, uniform(PRNGKey(the seed of
    the group's first row), (group, Lq, Lk)) >= rate, over 1 - rate."""
    g = _pick_group(bh)
    parts = []
    for first in range(0, bh, g):
        key = jax.random.PRNGKey(np.uint32(SEED + first))
        kept = np.asarray(jax.random.uniform(key, (g, lq, lk))) >= rate
        parts.append(kept.astype(np.float32) / np.float32(1.0 - rate))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def cases():
    """Per path shape and rate: fp32 q, k, v, g from numpy, the [B, Lk] key
    bias (0 or -10000) or None, and JAX's interpret-path mask or None;
    drawn once for the module (JAX's draws take most of its time)."""
    return list(_cases())


def _cases():
    for n, (lq, lk, masked) in enumerate(PATH_SHAPES):
        rng = np.random.RandomState(10 * n)
        q, k, v, g = (torch.from_numpy(rng.randn(B * H, m, D)
                                       .astype(np.float32))
                      for m in (lq, lk, lk, lq))
        bias = None
        if masked:
            bias = torch.from_numpy(np.where(
                rng.rand(B, lk) > 0.2, 0.0, -10000.0).astype(np.float32))
        for rate in RATES:
            keep = (torch.from_numpy(_jax_mask(B * H, lq, lk, rate))
                    if rate else None)
            yield (lq, lk, masked, rate), (q, k, v, bias, keep, g)


def _over(got, want, tol):
    """The largest |got - want| / (atol + rtol |want|): 1 at the limit."""
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def test_three_passes_match_the_plain_fp32_version(cases):
    """o and every gradient within FP32_TOL of the plain fp32 versions fed
    the same mask, at each path shape and rate."""
    for where, (q, k, v, bias, keep, g) in cases:
        o, grads = _kernel_math(q, k, v, bias, keep, g)
        want_o = attn.attention_dropout_reference(q, k, v, bias, H, keep)
        want = attn.attention_dropout_reference_grads(q, k, v, bias, H, keep,
                                                      g)
        for name, a, w in zip(("o", "dq", "dk", "dv"), (o, *grads),
                              (want_o, *want)):
            worst = _over(a, w, FP32_TOL)
            assert worst <= 1.0, f"{where} {name}: {worst:.2f}x FP32_TOL"


def test_three_passes_match_jax(cases):
    """The same arithmetic against the JAX package in fp32, within 2e-5: at
    rate 0, o against `fused_attention` (interpreted Pallas) and
    `_reference_attention`, the gradients against `fused_attention`'s; at
    rate 0.1, o and the gradients against `fused_attention_dropout` with
    its interpret-path mask fed to the emulation."""
    for (lq, lk, masked, rate), (q, k, v, bias, keep, g) in cases:
        where = (lq, lk, masked, rate)
        o, grads = _kernel_math(q, k, v, bias, keep, g)
        bias_bh = jnp.asarray(
            np.zeros((B * H, lk), np.float32) if bias is None
            else np.repeat(bias.numpy(), H, axis=0))
        args = [jnp.asarray(t.numpy()) for t in (q, k, v)]
        g_ = jnp.asarray(g.numpy())
        if rate:
            seeds = jnp.asarray((SEED + np.arange(B * H, dtype=np.int32))
                                [:, None])
            wants = {"o": _dropout_fwd_bwd(*args, bias_bh, seeds, g_)}
            wants["o"], *grads_want = wants["o"]
            wants["grads"] = grads_want
        else:
            wants = {"o": _fused(*args, bias_bh),
                     "o_reference": _reference(*args, bias_bh),
                     "grads": _fused_grads(*args, bias_bh, g_)}
        for name in ("o", "o_reference"):
            if name in wants:
                np.testing.assert_allclose(
                    o.numpy(), np.asarray(wants[name]),
                    err_msg=f"{name} at {where}", **JAX_TOL)
        for name, a, w in zip(("dq", "dk", "dv"), grads, wants["grads"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=f"{name} at {where}",
                                       **JAX_TOL)


def test_one_tf32_pass_leaves_the_tolerance(cases):
    """A single TF32 pass puts o or a gradient outside FP32_TOL of the
    plain fp32 version at some path shape: the reason for three passes."""
    worst = 0.0
    for _, (q, k, v, bias, keep, g) in cases:
        o, grads = _kernel_math(q, k, v, bias, keep, g, passes=1)
        want_o = attn.attention_dropout_reference(q, k, v, bias, H, keep)
        want = attn.attention_dropout_reference_grads(q, k, v, bias, H, keep,
                                                      g)
        for a, w in zip((o, *grads), (want_o, *want)):
            worst = max(worst, _over(a, w, FP32_TOL))
    assert worst > 1.0, (f"one TF32 pass stayed within FP32_TOL (worst "
                         f"{worst:.2f}x): three passes would not be needed")
