"""The precision scheme of the bf16 backward of kernels 3 and 6
(xggm_tpu_torch/csrc/attention_common.cuh, attention_backward_block_bf16),
emulated in torch on the CPU.

The kernel multiplies bf16 operands on the tensor cores and accumulates in
fp32. q k^T and g v^T take their bf16 inputs exactly. p * m and ds are
fp32, and enter dv = (p * m)^T g, dq = ds k / 8 and dk = ds^T q / 8 as two
bf16 operands, hi = bf16(x) and lo = bf16(x - hi), each multiplied once.
This file holds that arithmetic against the plain gradients
(`attention_dropout_reference_grads`, all fp32, rounded once) within the
port's bf16 tolerance, at the four (Lq, Lk) shapes of the training path,
masked as there, at dropout rates 0.1 and 0. It also records why the split
is there: rounding p * m and ds once to bf16 leaves that tolerance.

The emulation lives here and not in the package: the package's plain
version stays the fp32 math.
"""
import numpy as np
import pytest
import torch

from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.philox import keep_scale

B, H, D = 8, 12, 64
# (Lq, Lk, key mask on the training path)
PATH_SHAPES = [(20, 20, True), (36, 36, False), (20, 36, False),
               (36, 20, True)]
RATES = (0.1, 0.0)
# one bf16 ulp, as the card tests and chip_smoke.py hold the kernels
ATOL, RTOL = 2.0 ** -8, 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread is fastest, and it keeps torch's
    thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(lq, lk, masked, rate, seed):
    """bf16 q, g [B * H, Lq, 64], k, v [B * H, Lk, 64]; the fp32 key bias
    [B, Lk] (0 or -10000) or None; the fp32 dropout multiplier [B * H, Lq,
    Lk] (0 or 1 / (1 - rate)) or None at rate 0; all from numpy."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B * H, n, D).astype(np.float32))
                  .to(torch.bfloat16) for n in (lq, lk, lk, lq))
    bias = None
    if masked:
        bias = torch.from_numpy(
            np.where(rng.rand(B, lk) > 0.2, 0.0, -10000.0).astype(np.float32))
    keep = None
    if rate:
        kept = rng.rand(B * H, lq, lk) >= rate
        keep = torch.from_numpy(
            np.where(kept, keep_scale(rate), 0.0).astype(np.float32))
    return q, k, v, bias, keep, g


def _operands(x, split):
    """x as the bf16 operands the tensor cores see: (hi, lo) with the split,
    (hi,) without it."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return (hi,)
    return hi, (x - hi).to(torch.bfloat16).float()


def _kernel_grads(q, k, v, bias, keep, g, split):
    """(dq, dk, dv) in bf16 by the kernel's arithmetic: fp32 products of
    bf16 operands, p * m and ds split into hi + lo (or rounded once)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = D ** -0.5
    s = qf @ kf.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.repeat_interleave(H, dim=0)[:, None, :]
    p = torch.softmax(s, dim=-1)
    m = torch.ones_like(p) if keep is None else keep
    dp = m * (gf @ vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    pm = _operands(p * m, split)
    dsx = _operands(ds, split)
    dv = sum(x.transpose(-1, -2) @ gf for x in pm)
    dq = sum(x @ kf for x in dsx) * scale
    dk = sum(x.transpose(-1, -2) @ qf for x in dsx) * scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _worst(got, want):
    """The largest |got - want| / (atol + rtol |want|), 1 at the limit,
    and the count of elements above it."""
    ratio = ((got.float() - want.float()).abs()
             / (ATOL + RTOL * want.float().abs()))
    return float(ratio.max()), int((ratio > 1).sum())


def _cases():
    for n, (lq, lk, masked) in enumerate(PATH_SHAPES):
        for rate in RATES:
            yield (lq, lk, masked, rate), _case(lq, lk, masked, rate,
                                                seed=10 * n + (rate > 0))


def test_split_products_stay_within_one_bf16_ulp():
    """hi + lo operands: every gradient within atol 2^-8, rtol 2^-7 of the
    plain fp32 gradients, at each path shape and rate."""
    for where, (q, k, v, bias, keep, g) in _cases():
        got = _kernel_grads(q, k, v, bias, keep, g, split=True)
        want = attn.attention_dropout_reference_grads(q, k, v, bias, H, keep,
                                                      g)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            worst, over = _worst(a, w)
            assert over == 0, (f"{where} {name}: {over} elements over the "
                               f"bf16 tolerance, worst {worst:.2f}x")


def test_single_bf16_rounding_leaves_the_tolerance():
    """p * m and ds rounded once to bf16 put gradients beyond one bf16 ulp
    of the fp32 math: the reason for the hi + lo split."""
    over_total, worst_all = 0, 0.0
    for where, (q, k, v, bias, keep, g) in _cases():
        got = _kernel_grads(q, k, v, bias, keep, g, split=False)
        want = attn.attention_dropout_reference_grads(q, k, v, bias, H, keep,
                                                      g)
        for a, w in zip(got, want):
            worst, over = _worst(a, w)
            over_total += over
            worst_all = max(worst_all, worst)
    assert over_total > 0 and worst_all > 1.0, (
        f"single rounding stayed within the tolerance (worst "
        f"{worst_all:.2f}x): the split would not be needed")
