"""Attention with dropout on the probabilities (xggm_tpu_torch/ops/attention,
kernels 2 and 3) and its Philox mask (ops/philox.py).

- Philox4x32-10 against the Random123 known answers.
- The port's plain forward and backward, fed the mask that JAX's interpret
  path draws, against `xggm_tpu.ops.pallas_attention.fused_attention_dropout`
  (interpreted on the CPU), at the four (Lq, Lk) shapes of the training path,
  and the forward also at the card tests' edge shapes, fp32, within 2e-5
  (the tolerance of tests/test_pallas_attention.py: both sides fp32, only
  the summation order differs).
- Rate-0 gradients of `fused_attention` against JAX `fused_attention`.
- The autograd.Function's backward against autograd through the plain
  version with the same mask, and the Philox mask's keep rate.
- `gpu`-marked card tests: kernels 2 and 3, and kernel 1's backward, against
  their plain versions; the bodies of kernels 2 and 3, bf16 and fp32, also
  at shapes off their tiles. They skip without a card. This file imports JAX
  only inside the tests that compare with it, so that the card tests run
  where JAX is absent:
  `python -m pytest --noconftest -m gpu tests/test_torch_attention_dropout.py`.

Each test loops over its cases and names the failing one, so that the file
holds few tests: pytest-xdist's `--dist loadfile` queues the files with the
most tests first, and a file of many quick tests would be scheduled ahead of
the suite's long files.
"""
import itertools

import numpy as np
import pytest
import torch

from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.philox import (
    dropout_bits, dropout_keep, keep_threshold, philox4x32)

H, D = 4, 64
RATE = 0.1
# (Lq, Lk, key mask on the training path)
PATH_SHAPES = [(20, 20, True), (36, 36, False), (20, 36, False),
               (36, 20, True)]
TOL = dict(rtol=2e-5, atol=2e-5)
# (Lq, Lk) off the 16 x 16 tiles of the bf16 bodies, and their largest
EDGE_SHAPES = [(1, 1), (7, 33), (33, 7), (64, 64)]
# an odd batch: the bf16 bodies run one block per (batch * head) row, so
# any row count works; this one is odd and no multiple of 16
EDGE_BATCH = 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, lq, lk, masked, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b * H, n, D).astype(np.float32))
                  for n in (lq, lk, lk, lq))
    bias = None
    if masked:
        bias = torch.from_numpy(
            np.where(rng.rand(b, lk) > 0.3, 0.0, -10000.0).astype(np.float32))
        bias = bias.to(device)
    q, k, v, g = (t.to(dtype=dtype, device=device) for t in (q, k, v, g))
    return q, k, v, bias, g


KNOWN_ANSWERS = [  # Random123: (counter, key) -> Philox4x32-10 output
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def test_philox_known_answers_and_mask():
    """The Random123 known answers; the mask's keep fraction within 5 sigma
    of 0.9, its values 0 and 1 / 0.9 in fp32, rows and seeds that differ, a
    seed that repeats, and the counter layout of ops/philox.py."""
    for counter, key, want in KNOWN_ANSWERS:
        got = tuple(int(w) for w in philox4x32(*counter, *key))
        assert got == want, (counter, key)
    rows, lq, lk = 96, 36, 36
    keep = dropout_keep(7, rows, lq, lk, RATE)
    frac = float((keep > 0).float().mean())
    assert abs(frac - 0.9) <= 5 * (0.9 * 0.1 / keep.numel()) ** 0.5
    assert set(keep.unique().tolist()) == {
        0.0, float(np.float32(1) / np.float32(0.9))}
    assert not torch.equal(keep[0], keep[1])
    other = dropout_keep(8, rows, lq, lk, RATE)
    assert not torch.equal(keep, other)
    assert torch.equal(keep, dropout_keep(7, rows, lq, lk, RATE))
    # row r of seed s and row r - 1 of seed s + 1 share the Philox key
    # (s + r) but not the counter
    assert not torch.equal(keep[1], other[0])
    bits = dropout_bits(7, 2, 1, 8)
    assert torch.equal(bits[0, 0, :4],
                       torch.stack(philox4x32(0, 0, 0, 0, 7, 0)))
    assert torch.equal(bits[1, 0, 4:],
                       torch.stack(philox4x32(1, 0, 1, 0, 8, 0)))
    assert keep_threshold(0.0) == 0 and keep_threshold(RATE) == 429496729
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            keep_threshold(rate)


def _jax_interpret_mask(seed, bh, lq, lk, rate):
    """The mask JAX's interpret path draws (pallas_attention.py
    `_group_dropout_mask`): per group of g rows, uniform(PRNGKey(seed of the
    group's first row), (g, Lq, Lk)) >= rate, scaled by 1 / (1 - rate)."""
    import jax

    from xggm_tpu.ops.pallas_attention import _pick_group

    g = _pick_group(bh)
    parts = []
    for first in range(0, bh, g):
        key = jax.random.PRNGKey(np.uint32(seed + first))
        keep = np.asarray(jax.random.uniform(key, (g, lq, lk))) >= rate
        parts.append(keep.astype(np.float32) / np.float32(1.0 - rate))
    return np.concatenate(parts)


def _bias_bh(bias, bh, lk):
    """The port's [B, Lk] bias (None: no mask) as JAX's [B * H, Lk]."""
    if bias is None:
        return np.zeros((bh, lk), np.float32)
    return np.repeat(bias.numpy(), H, axis=0)


def test_plain_dropout_attention_matches_jax():
    """At the 4 path shapes, the plain forward and its q, k, v gradients fed
    JAX's mask against JAX's `fused_attention_dropout` (2 groups of 40 rows
    in JAX); at EDGE_SHAPES and EDGE_BATCH (one group of 28 rows), the first
    element's every key masked, the forward; at rate 0,
    `fused_attention`'s backward against JAX's."""
    import jax
    import jax.numpy as jnp

    from xggm_tpu.ops.pallas_attention import (
        fused_attention, fused_attention_dropout)

    b, seed = 20, 1234
    bh = b * H
    for lq, lk, masked in PATH_SHAPES:
        q, k, v, bias, g = _inputs(b, lq, lk, masked, seed=lq + lk)
        bias_bh, seeds = _bias_bh(bias, bh, lk), \
            (seed + np.arange(bh, dtype=np.int32))[:, None]

        @jax.jit
        def fwd_bwd(q_, k_, v_, g_):
            out, vjp = jax.vjp(lambda *a: fused_attention_dropout(
                *a, jnp.asarray(bias_bh), jnp.asarray(seeds), RATE),
                q_, k_, v_)
            return (out, *vjp(g_))

        want = fwd_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v, g)))
        keep = torch.from_numpy(_jax_interpret_mask(seed, bh, lq, lk, RATE))
        got = [attn.attention_dropout_reference(q, k, v, bias, H, keep),
               *attn.attention_dropout_reference_grads(q, k, v, bias, H,
                                                       keep, g)]
        for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=f"{name} at {(lq, lk)}", **TOL)

    bh = EDGE_BATCH * H
    seeds = (seed + np.arange(bh, dtype=np.int32))[:, None]
    for lq, lk in EDGE_SHAPES:
        q, k, v, bias, _ = _inputs(EDGE_BATCH, lq, lk, True, seed=lq + lk)
        bias[0] = -10000.0  # every key of the first element
        want = jax.jit(lambda q_, k_, v_, b_: fused_attention_dropout(
            q_, k_, v_, b_, jnp.asarray(seeds), RATE))(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)),
            jnp.asarray(_bias_bh(bias, bh, lk)))
        keep = torch.from_numpy(_jax_interpret_mask(seed, bh, lq, lk, RATE))
        got = attn.attention_dropout_reference(q, k, v, bias, H, keep)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"o at {(lq, lk)}", **TOL)

    for lq, lk, masked in ((20, 36, True), (36, 20, False)):
        q, k, v, bias, g = _inputs(2, lq, lk, masked, seed=7)
        bias_bh = jnp.asarray(_bias_bh(bias, 2 * H, lk))
        _, vjp = jax.vjp(lambda *a: fused_attention(*a, bias_bh),
                         *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(attn.fused_attention(*qkv, bias, H), qkv, g)
        for a, w in zip(got, vjp(jnp.asarray(g.numpy()))):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=f"rate 0 at {(lq, lk)}", **TOL)


def test_dropout_function_on_the_cpu():
    """On the CPU the autograd.Function runs the plain versions with the
    Philox mask of its seed: its output and gradients equal autograd through
    the plain forward fed that mask, at the 4 path shapes. mha_dropout's
    row b * H + h draws the mask of seed + b * H + h. The kernel wrappers'
    input checks cover the gradient."""
    seed = 99
    for lq, lk, masked in PATH_SHAPES:
        q, k, v, bias, g = _inputs(3, lq, lk, masked, seed=11)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.fused_attention_dropout(*qkv, bias, H, seed, RATE)
        got = torch.autograd.grad(out, qkv, g)
        keep = dropout_keep(seed, 3 * H, lq, lk, RATE)
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want_out = attn.attention_dropout_reference(*ref, bias, H, keep)
        want = torch.autograd.grad(want_out, ref, g)
        torch.testing.assert_close(out, want_out, rtol=0, atol=0)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)

    b, lq, lk, seed = 2, 20, 36, 5
    q, k, v, bias, g = _inputs(b, lq, lk, True, seed=3)
    q4, k4, v4 = (t.view(b, H, -1, D) for t in (q, k, v))
    out = attn.mha_dropout(q4, k4, v4, bias, seed, RATE)
    keep = dropout_keep(seed, b * H, lq, lk, RATE).view(b, H, lq, lk)
    for i in range(b):
        for h in range(H):
            p = torch.softmax(q4[i, h] @ k4[i, h].T / 8.0 + bias[i], -1)
            torch.testing.assert_close(out[i, h], (p * keep[i, h]) @ v4[i, h],
                                       rtol=2e-5, atol=2e-5)

    for bad in (g[:, :10], g.double()):
        with pytest.raises(ValueError):
            attn._check(q, k, v, bias, H, bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: one ulp (2^-8..2^-7 of the value) apart at most, since the kernel
# and the plain version sum in different orders; fp32: summation order only.
TOLS = {torch.bfloat16: dict(rtol=2.0 ** -7, atol=2.0 ** -8),
        torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.mark.gpu
def test_kernels_match_plain_versions(cuda):
    """At the 4 path shapes in bf16 and fp32: kernel 2 against the plain
    forward and kernel 3 against the plain gradients, both fed the mask
    ops/philox.py draws on the card; kernel 1's backward (kernel 3 at rate
    0) against the plain gradients of attention_reference; one launch each.
    Then kernels 2 and 3 in bf16 and fp32 at EDGE_SHAPES and EDGE_BATCH,
    masked and not, at rates 0.1 and 0: kernel 2 (masked: every key of the
    first element masked) against the plain forward fed the Philox mask,
    kernel 3 against the plain gradients."""
    seed = 2024
    for dtype in (torch.bfloat16, torch.float32):
        for lq, lk, masked in PATH_SHAPES:
            where = f"{(lq, lk)} {dtype}"

            def msg(m, where=where):
                return f"{where}: {m}"

            q, k, v, bias, g = _inputs(64, lq, lk, masked, dtype, cuda)
            keep = dropout_keep(seed, q.shape[0], lq, lk, RATE, cuda)
            f0 = attn.attention_dropout_fwd.launches
            b0 = attn.attention_dropout_bwd.launches
            got = attn.attention_dropout_fwd(q, k, v, bias, H, seed, RATE)
            grads = attn.attention_dropout_bwd(q, k, v, bias, H, seed, RATE,
                                               g)
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            k1_grads = torch.autograd.grad(
                attn.fused_attention(*qkv, bias, H), qkv, g)
            torch.cuda.synchronize()
            assert attn.attention_dropout_fwd.launches == f0 + 1, where
            assert attn.attention_dropout_bwd.launches == b0 + 2, where
            want = attn.attention_dropout_reference(q, k, v, bias, H, keep)
            assert got.dtype == dtype and got.shape == q.shape, where
            torch.testing.assert_close(got.float(), want.float(), msg=msg,
                                       **TOLS[dtype])
            for keep_, pairs in ((keep, grads), (None, k1_grads)):
                wants = attn.attention_dropout_reference_grads(
                    q, k, v, bias, H, keep_, g)
                for a, w in zip(pairs, wants):
                    assert a.dtype == dtype and a.shape == w.shape, where
                    torch.testing.assert_close(a.float(), w.float(), msg=msg,
                                               **TOLS[dtype])

    for dtype, (lq, lk), masked in itertools.product(
            (torch.bfloat16, torch.float32), EDGE_SHAPES, (True, False)):
        q, k, v, bias, g = _inputs(EDGE_BATCH, lq, lk, masked, dtype, cuda,
                                   seed=lq + lk)
        bias2 = None
        if masked:
            bias2 = bias.clone()
            bias2[0] = -10000.0  # every key of the first element
        for rate in (RATE, 0.0):
            where = f"{(lq, lk)} {dtype} mask {masked} rate {rate}"
            keep = (dropout_keep(seed, q.shape[0], lq, lk, rate, cuda)
                    if rate else None)
            o = attn.attention_dropout_fwd(q, k, v, bias2, H, seed, rate)
            want = attn.attention_dropout_reference(q, k, v, bias2, H, keep)
            assert o.dtype == want.dtype and o.shape == want.shape, where
            torch.testing.assert_close(
                o.float(), want.float(),
                msg=lambda m, where=where: f"{where}: kernel 2: {m}",
                **TOLS[dtype])
            grads = attn.attention_dropout_bwd(q, k, v, bias, H, seed, rate,
                                               g)
            wants = attn.attention_dropout_reference_grads(
                q, k, v, bias, H, keep, g)
            for a, w in zip(grads, wants):
                assert a.dtype == w.dtype and a.shape == w.shape, where
                torch.testing.assert_close(
                    a.float(), w.float(),
                    msg=lambda m, where=where: f"{where}: {m}",
                    **TOLS[dtype])
