"""Attention in the [B, L, H, 64] layout (xggm_tpu_torch/ops/attention,
kernels 4, 5 and 6) against the JAX package and against the flattened
kernels 1 to 3.

- The plain `fused_attention_blhd` and its q, k, v gradients against JAX
  `fused_attention_blhd` (interpreted on the CPU, as
  tests/test_pallas_attention.py runs it) at the four (Lq, Lk) shapes of the
  training path, fp32, within 2e-5 (that file's tolerance: both sides fp32,
  only the summation order differs); `mha_blhd` with and without a mask
  against `mha_pallas_blhd`.
- The plain dropout pair against JAX's kernels 5 and 6, fed the port's
  mask. JAX cannot draw its own mask on the CPU (`pltpu.prng_seed` has no
  interpret lowering), so inside the test only `pltpu.prng_seed` becomes a
  no-op and `_dropout_keep` draws, in head order, the port's Philox mask of
  this program's batch group in jnp uint32 ops (a Pallas kernel may not
  close over an array). Nothing in xggm_tpu changes.
- The BLHD plain versions equal the flattened ones on permuted inputs with
  the same seed, exactly: head h of batch b draws row b * H + h's mask.
- `gpu`: kernels 4 to 6 against their plain versions and against kernels 1
  to 3 on the permuted inputs, kernels 4 to 6 in bf16 and fp32 also at
  shapes off their tiles (kernels 4 and 5 with every key of one element
  masked).
  This file imports JAX only inside the tests that compare with it, so
  that the card test runs where JAX is absent:
  `python -m pytest --noconftest -m gpu tests/test_torch_attention_blhd.py`.

Tests loop over their cases (see tests/test_torch_attention_dropout.py for
why the files hold few tests).
"""
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.philox import (
    MASK32, dropout_keep, keep_threshold)

H, D = 4, 64
RATE = 0.1
# (Lq, Lk, key mask on the training path)
PATH_SHAPES = [(20, 20, True), (36, 36, False), (20, 36, False),
               (36, 20, True)]
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, lq, lk, masked, dtype=torch.float32, device="cpu", seed=0):
    """q, g [B, Lq, H, 64], k, v [B, Lk, H, 64], bias [B, Lk] or None."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b, n, H, D).astype(np.float32))
                  for n in (lq, lk, lk, lq))
    bias = None
    if masked:
        bias = torch.from_numpy(
            np.where(rng.rand(b, lk) > 0.3, 0.0, -10000.0).astype(np.float32))
        bias = bias.to(device)
    q, k, v, g = (t.to(dtype=dtype, device=device) for t in (q, k, v, g))
    return q, k, v, bias, g


def _rows(x):
    """[B, L, H, D] -> [B * H, L, D]."""
    b, length, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, length, d).contiguous()


def _blhd(x, b):
    """[B * H, L, D] -> [B, L, H, D]."""
    return x.view(b, -1, x.shape[1], x.shape[2]).transpose(1, 2)


def _jax_bias(bias, b, lk):
    return np.zeros((b, lk), np.float32) if bias is None else bias.numpy()


def _compile_all(lowered):
    """Compile JAX lowerings in threads (XLA's compile releases the
    interpreter lock; lowering does not, so the callers lower first)."""
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda low: low.compile(), lowered))


def test_plain_blhd_attention_matches_jax():
    """At the 4 path shapes, the plain forward and its gradients (through
    the autograd.Function, on the CPU) against JAX `fused_attention_blhd`
    and `jax.vjp`; `mha_blhd` against `mha_pallas_blhd`."""
    import jax
    import jax.numpy as jnp

    from xggm_tpu.ops.pallas_attention import (
        fused_attention_blhd, mha_pallas_blhd)

    b = 8
    cases, lowered = [], []
    for lq, lk, masked in PATH_SHAPES:
        q, k, v, bias, g = _inputs(b, lq, lk, masked, seed=lq + lk)
        jbias = jnp.asarray(_jax_bias(bias, b, lk))

        def fwd_bwd(q_, k_, v_, g_, jbias=jbias):
            out, vjp = jax.vjp(
                lambda *a: fused_attention_blhd(*a, jbias), q_, k_, v_)
            return (out, *vjp(g_))

        args = [jnp.asarray(t.numpy()) for t in (q, k, v, g)]
        lowered.append(jax.jit(fwd_bwd).lower(*args))
        cases.append((lq, lk, (q, k, v, bias, g), args))
    for (lq, lk, (q, k, v, bias, g), args), fn in zip(
            cases, _compile_all(lowered)):
        want = fn(*args)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.fused_attention_blhd(*qkv, bias)
        got = [out.detach(), *torch.autograd.grad(out, qkv, g)]
        for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=f"{name} at {(lq, lk)}", **TOL)

    q, k, v, bias, _ = _inputs(2, 20, 36, True, seed=5)
    for mask in (bias, None):
        jmask = None if mask is None else \
            jnp.asarray(mask.numpy())[:, None, None, :]
        want = mha_pallas_blhd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               jmask)
        got = attn.mha_blhd(q, k, v, mask)
        assert got.shape == (2, 20, H, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"mha_blhd mask {mask is not None}",
                                   **TOL)


def _mulhilo(a, b, full):
    """(hi, lo) of the 64-bit product of the constant a and uint32 b, in
    uint32 ops from 16-bit halves; full(x) is x as a uint32 array (a
    Python int above 2^31 does not enter a uint32 op as a weak int)."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16), full(a) * b


def _philox_keep(shape, rate, seed, group, heads):
    """In a BLHD dropout kernel's program, the keep/scale masks of all heads
    [heads, G, Lq, Lk] (shape is [G, Lq, Lk]): Philox4x32-10 of
    ops/philox.py for the flattened rows (program * G + g) * heads + h, in
    jnp uint32 ops."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    u32 = jnp.uint32
    shape = (heads, *shape)

    def full(x):
        return jnp.full(shape, x, u32)

    hi_, gi, qi, kj = (jax.lax.broadcasted_iota(u32, shape, d)
                       for d in range(4))
    r = (pl.program_id(0).astype(u32) * group + gi) * heads + hi_
    c0, c1, c2, c3 = r, qi, kj >> 2, full(0)
    k0, k1 = r + full(seed & MASK32), full(0)
    for rnd in range(10):
        if rnd:
            k0, k1 = k0 + full(0x9E3779B9), k1 + full(0xBB67AE85)
        hi0, lo0 = _mulhilo(0xD2511F53, c0, full)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2, full)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    lane = kj & 3
    bits = jnp.where(lane == 0, c0, jnp.where(
        lane == 1, c1, jnp.where(lane == 2, c2, c3)))
    keep = bits >= keep_threshold(rate)
    return keep.astype(jnp.float32) / (1.0 - rate)  # as `_dropout_keep`


def test_plain_dropout_blhd_matches_jax_fed_the_same_mask(monkeypatch):
    """At the 4 path shapes, kernel 5's and 6's plain versions (through the
    autograd.Function on the CPU) against JAX's
    `fused_attention_dropout_blhd` forward and `jax.vjp`, with JAX's
    in-kernel mask replaced by the port's Philox mask (2 to 4 programs of
    4 or 8 batch rows)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from xggm_tpu.ops import pallas_attention as pa

    b, seed = 16, 4321
    cases, lowered = [], []
    for lq, lk, masked in PATH_SHAPES:
        group = pa._pick_group(b, pa._dropout_group(lq, lk))
        calls, drawn = [], {}

        def keep_in_head_order(shape, rate, group=group, calls=calls,
                               drawn=drawn):
            # each kernel trace asks for heads 0..H-1 in turn: draw all
            # heads at head 0, within that trace
            h = len(calls) % H
            calls.append(h)
            if h == 0:
                drawn["heads"] = _philox_keep(shape, rate, seed, group, H)
            return drawn["heads"][h]

        monkeypatch.setattr(pltpu, "prng_seed", lambda *a: None)
        monkeypatch.setattr(pa, "_dropout_keep", keep_in_head_order)
        q, k, v, bias, g = _inputs(b, lq, lk, masked, seed=lq * lk)
        jbias = jnp.asarray(_jax_bias(bias, b, lk))

        def fwd_bwd(q_, k_, v_, g_, jbias=jbias):
            out, vjp = jax.vjp(lambda *a: pa.fused_attention_dropout_blhd(
                *a, jbias, seed, RATE), q_, k_, v_)
            return (out, *vjp(g_))

        args = [jnp.asarray(t.numpy()) for t in (q, k, v, g)]
        lowered.append(jax.jit(fwd_bwd).lower(*args))  # traces the kernels
        monkeypatch.undo()
        assert calls and len(calls) % H == 0
        cases.append((lq, lk, (q, k, v, bias, g), args))
    for (lq, lk, (q, k, v, bias, g), args), fn in zip(
            cases, _compile_all(lowered)):
        want = fn(*args)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.fused_attention_dropout_blhd(*qkv, bias, seed, RATE)
        got = [out.detach(), *torch.autograd.grad(out, qkv, g)]
        for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       err_msg=f"{name} at {(lq, lk)}", **TOL)

    # the jnp draw is ops/philox.py's: in program 0 of groups of 2, head 1
    # holds rows 1 and H + 1
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "program_id", lambda axis: jnp.int32(0))
    np.testing.assert_array_equal(
        np.asarray(_philox_keep((2, 3, 9), RATE, seed, 2, H)[1]),
        dropout_keep(seed, 2 * H, 3, 9, RATE).numpy()[1::H])


def test_blhd_plain_versions_equal_flattened_ones():
    """On the CPU, kernels 4 to 6's wrappers (the plain versions), and the
    autograd.Functions over them, equal kernels 1 to 3's on the permuted
    rows with the same seed, bit for bit; a CPU tensor launches nothing;
    `_check` takes the BLHD shapes and refuses others."""
    seed, b = 77, 3
    counters = (attn.fused_attention_blhd, attn.attention_dropout_blhd_fwd,
                attn.attention_dropout_blhd_bwd)
    before = [c.launches for c in counters]
    for lq, lk, masked in PATH_SHAPES:
        q, k, v, bias, g = _inputs(b, lq, lk, masked, seed=lq - lk + 40)
        flat = [_rows(t) for t in (q, k, v, g)]
        for rate in (0.0, RATE):
            where = f"{(lq, lk)} rate {rate}"
            o = attn.attention_dropout_blhd_fwd(q, k, v, bias, seed, rate)
            o_flat = attn.attention_dropout_fwd(*flat[:3], bias, H, seed,
                                                rate)
            assert torch.equal(o, _blhd(o_flat, b)), where
            grads = attn.attention_dropout_blhd_bwd(q, k, v, bias, seed, rate,
                                                    g)
            grads_flat = attn.attention_dropout_bwd(*flat[:3], bias, H, seed,
                                                    rate, flat[3])
            for a, w in zip(grads, grads_flat):
                assert torch.equal(a, _blhd(w, b)), where

        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(
            attn.mha_dropout_blhd(*qkv, bias, seed, RATE), qkv, g)
        flat_qkv = [t.clone().requires_grad_() for t in flat[:3]]
        want = torch.autograd.grad(
            attn.fused_attention_dropout(*flat_qkv, bias, H, seed, RATE),
            flat_qkv, flat[3])
        for a, w in zip(got, want):
            assert torch.equal(a, _blhd(w, b)), (lq, lk)
        o4 = attn.fused_attention_blhd(q, k, v, bias)
        assert torch.equal(o4, attn.attention_blhd_reference(q, k, v, bias))
    assert [c.launches for c in counters] == before

    q, k, v, bias, g = _inputs(2, 20, 36, True)
    attn._check(q, k, v, bias, H, g, blhd=True)
    for bad in (dict(g=g[:, :10]), dict(g=g.double()), dict(heads=H + 1),
                dict(q=q[:, :, :2]), dict(bias=bias[:, :20]),
                dict(q=q.transpose(1, 2))):
        args = dict(q=q, k=k, v=v, bias=bias, heads=H, g=g)
        args.update(bad)
        with pytest.raises(ValueError):
            attn._check(**args, blhd=True)


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


# (Lq, Lk) off the 16 x 16 tiles of the bf16 bodies, and their largest;
# an odd batch (one block per (batch * head) row: any row count works)
EDGE_SHAPES = [(1, 1), (7, 33), (33, 7), (64, 64)]
EDGE_BATCH = 7


@pytest.mark.gpu
def test_blhd_kernels_match_plain_and_flattened_kernels(cuda):
    """At the 4 path shapes in bf16 and fp32: kernel 4 and kernel 5 against
    their plain versions (the latter fed the Philox mask), kernel 6 at rates
    0 and 0.1 against the plain gradients; each against kernels 1 to 3 on
    the permuted inputs with the same seed, bit for bit; kernel 5's own mask
    against the Philox mask of row b * H + h; one launch each. Then kernels
    4 to 6 in bf16 and fp32 at EDGE_SHAPES and EDGE_BATCH, masked and not:
    kernel 4 (masked: every key of the first element masked) against its
    plain version and against kernel 1 on the permuted inputs, bit for bit;
    kernel 5 (the same mask) at rates 0.1 and 0 against its plain version
    fed the Philox mask and against kernel 2 on the permuted inputs, bit
    for bit; kernel 6 at rates 0.1 and 0 against the plain gradients, and
    against kernel 3 on the permuted inputs, bit for bit."""
    seed, b = 2025, 32
    for dtype in (torch.bfloat16, torch.float32):
        for lq, lk, masked in PATH_SHAPES:
            where = f"{(lq, lk)} {dtype}"

            def msg(m, where=where):
                return f"{where}: {m}"

            q, k, v, bias, g = _inputs(b, lq, lk, masked, dtype, cuda)
            flat = [_rows(t) for t in (q, k, v, g)]
            keep = dropout_keep(seed, b * H, lq, lk, RATE, cuda)
            counts = [c.launches for c in (
                attn.fused_attention_blhd, attn.attention_dropout_blhd_fwd,
                attn.attention_dropout_blhd_bwd)]
            o4 = attn._attention_blhd_fwd(q, k, v, bias)
            o5 = attn.attention_dropout_blhd_fwd(q, k, v, bias, seed, RATE)
            g6 = attn.attention_dropout_blhd_bwd(q, k, v, bias, seed, RATE, g)
            g6_0 = attn.attention_dropout_blhd_bwd(q, k, v, bias, 0, 0.0, g)
            torch.cuda.synchronize()
            assert [c.launches for c in (
                attn.fused_attention_blhd, attn.attention_dropout_blhd_fwd,
                attn.attention_dropout_blhd_bwd)] == [
                counts[0] + 1, counts[1] + 1, counts[2] + 2], where
            pairs = [
                (o4, attn.attention_blhd_reference(q, k, v, bias)),
                (o5, attn.attention_dropout_blhd_reference(q, k, v, bias,
                                                           keep))]
            pairs += zip(g6, attn.attention_dropout_blhd_reference_grads(
                q, k, v, bias, keep, g))
            pairs += zip(g6_0, attn.attention_dropout_blhd_reference_grads(
                q, k, v, bias, None, g))
            for a, w in pairs:
                assert a.dtype == dtype and a.shape == w.shape, where
                torch.testing.assert_close(a.float(), w.float(), msg=msg,
                                           **TOLS[dtype])
            flat_out = [attn._attention_fwd(*flat[:3], bias, H),
                        attn.attention_dropout_fwd(*flat[:3], bias, H, seed,
                                                   RATE),
                        *attn.attention_dropout_bwd(*flat[:3], bias, H, seed,
                                                    RATE, flat[3]),
                        *attn.attention_dropout_bwd(*flat[:3], bias, H, 0,
                                                    0.0, flat[3])]
            for a, w in zip([o4, o5, *g6, *g6_0], flat_out):
                assert torch.equal(a, _blhd(w, b)), where

        # the kernel's own mask: q = k = 0 makes every p 1 / Lk, and an
        # identity v puts p * m[i, j] at o[b, i, h, j]
        lq, lk = 36, 20
        zq = torch.zeros(b, lq, H, D, device=cuda, dtype=dtype)
        zk = torch.zeros(b, lk, H, D, device=cuda, dtype=dtype)
        eye = torch.eye(lk, D, device=cuda, dtype=dtype)[None, :, None, :]
        drawn = attn.attention_dropout_blhd_fwd(
            zq, zk, eye.expand(b, lk, H, D).contiguous(), None, seed,
            RATE)[..., :lk] > 0
        keep = dropout_keep(seed, b * H, lq, lk, RATE, cuda) > 0
        assert torch.equal(_rows(drawn), keep), dtype

    for dtype, (lq, lk), masked in itertools.product(
            (torch.bfloat16, torch.float32), EDGE_SHAPES, (True, False)):
        q, k, v, bias, g = _inputs(EDGE_BATCH, lq, lk, masked, dtype, cuda,
                                   seed=lq + lk)
        flat = [_rows(t) for t in (q, k, v, g)]
        where = f"{(lq, lk)} {dtype} mask {masked} kernel 4"
        bias4 = None
        if masked:
            bias4 = bias.clone()
            bias4[0] = -10000.0  # every key of the first element
        o4 = attn._attention_blhd_fwd(q, k, v, bias4)
        torch.testing.assert_close(
            o4.float(),
            attn.attention_blhd_reference(q, k, v, bias4).float(),
            msg=lambda m, where=where: f"{where}: {m}",
            **TOLS[dtype])
        o1 = attn._attention_fwd(*flat[:3], bias4, H)
        assert torch.equal(o4, _blhd(o1, EDGE_BATCH)), where
        for rate in (RATE, 0.0):
            where = f"{(lq, lk)} {dtype} mask {masked} rate {rate}"
            keep = (dropout_keep(seed, EDGE_BATCH * H, lq, lk, rate, cuda)
                    if rate else None)
            o5 = attn.attention_dropout_blhd_fwd(q, k, v, bias4, seed,
                                                 rate)
            want = attn.attention_dropout_blhd_reference(q, k, v, bias4,
                                                         keep)
            assert o5.dtype == want.dtype and o5.shape == want.shape, \
                where
            torch.testing.assert_close(
                o5.float(), want.float(),
                msg=lambda m, where=where: f"{where}: kernel 5: {m}",
                **TOLS[dtype])
            o2 = attn.attention_dropout_fwd(*flat[:3], bias4, H, seed,
                                            rate)
            assert torch.equal(o5, _blhd(o2, EDGE_BATCH)), where
            g6 = attn.attention_dropout_blhd_bwd(q, k, v, bias, seed,
                                                 rate, g)
            wants = attn.attention_dropout_blhd_reference_grads(
                q, k, v, bias, keep, g)
            g3 = attn.attention_dropout_bwd(*flat[:3], bias, H, seed,
                                            rate, flat[3])
            for a, w, f in zip(g6, wants, g3):
                assert a.dtype == w.dtype and a.shape == w.shape, where
                torch.testing.assert_close(
                    a.float(), w.float(),
                    msg=lambda m, where=where: f"{where}: {m}",
                    **TOLS[dtype])
                assert torch.equal(a, _blhd(f, EDGE_BATCH)), where
