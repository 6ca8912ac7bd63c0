"""The port's attention wrapper and CUDA kernel (xggm_tpu_torch/ops/attention).

This file imports torch only, so that the card tests also run where JAX is
absent (`python -m pytest --noconftest -m gpu tests/test_torch_attention_kernel.py`).
On the CPU the wrapper runs its plain version; the `gpu` tests build the
kernel with nvcc and hold it against that plain version, and skip without a
card. Besides the four shapes of the serving path they take shapes off the
bf16 body's 16 x 16 tiles and its largest, at an odd batch whose first
element has every key masked (-10000).
"""
import numpy as np
import pytest
import torch

from xggm_tpu_torch.ops import attention as attn

H = 4
SHAPES = [(20, 20), (36, 36), (20, 36), (36, 20)]
# (Lq, Lk) off the 16 x 16 tiles of the bf16 body, and its largest
EDGE_SHAPES = [(1, 1), (7, 33), (33, 7), (64, 64)]
EDGE_BATCH = 7


def _inputs(b, lq, lk, masked, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b * H, n, 64).astype(np.float32))
               for n in (lq, lk, lk))
    bias = None
    if masked:
        bias = torch.from_numpy(
            np.where(rng.rand(b, lk) > 0.3, 0.0, -10000.0).astype(np.float32))
    to = dict(device=device)
    q, k, v = (t.to(dtype=dtype, **to) for t in (q, k, v))
    return q, k, v, None if bias is None else bias.to(**to)


def test_cpu_tensor_runs_plain_version_and_launches_nothing():
    q, k, v, bias = _inputs(2, 20, 36, True)
    before = attn.fused_attention.launches
    out = attn.fused_attention(q, k, v, bias, H)
    assert attn.fused_attention.launches == before
    torch.testing.assert_close(out, attn.attention_reference(q, k, v, bias, H),
                               rtol=0, atol=0)


def test_mha_layout_matches_per_head_softmax():
    """mha's [B, H, L, D] flattening and per-batch bias rows against an
    explicit per-(batch, head) computation."""
    b, lq, lk = 3, 20, 36
    q, k, v, bias = _inputs(b, lq, lk, True, seed=1)
    q4, k4, v4 = (t.view(b, H, -1, 64) for t in (q, k, v))
    out = attn.mha(q4, k4, v4, bias)
    assert out.shape == (b, H, lq, 64)
    for i in range(b):
        for h in range(H):
            s = q4[i, h] @ k4[i, h].T / 8.0 + bias[i]
            want = torch.softmax(s, -1) @ v4[i, h]
            torch.testing.assert_close(out[i, h], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["head_dim", "too_long", "dtype", "bias",
                                  "heads", "strided"])
def test_kernel_input_checks(case):
    q, k, v, bias = _inputs(2, 20, 36, True)
    heads = H
    if case == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif case == "too_long":
        k = v = torch.zeros(2 * H, 65, 64)
        bias = torch.zeros(2, 65)
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "bias":
        bias = bias[:, :20]
    elif case == "heads":
        heads = 3
    elif case == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        attn._check(q, k, v, bias, heads)


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lq,lk", SHAPES + EDGE_SHAPES)
def test_kernel_matches_plain_version(cuda, lq, lk, masked, dtype):
    """Kernel 1 against its plain version: batch 64 at the path shapes;
    EDGE_BATCH at EDGE_SHAPES, where a mask masks every key of the first
    element (p must spread over its real keys as the plain version's does,
    never onto a key of the padded tile)."""
    edge = (lq, lk) in EDGE_SHAPES
    b = EDGE_BATCH if edge else 64
    q, k, v, bias = _inputs(b, lq, lk, masked, dtype, cuda)
    if masked and edge:
        bias[0] = -10000.0
    before = attn.fused_attention.launches
    got = attn.fused_attention(q, k, v, bias, H)
    want = attn.attention_reference(q, k, v, bias, H)
    torch.cuda.synchronize()
    assert attn.fused_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


@pytest.mark.gpu
def test_kernel_raises_on_cuda_input_it_does_not_take(cuda):
    q, k, v, bias = _inputs(2, 20, 20, True, torch.float16, cuda)
    with pytest.raises(ValueError):
        attn.fused_attention(q, k, v, bias, H)
