"""The port's attention against the JAX package's: xggm_tpu_torch's plain
attention (what the wrapper runs on a CPU tensor) vs xggm_tpu's Pallas
`fused_attention` (interpreted on the CPU) and its `_reference_attention`,
at the four (Lq, Lk) pairs of the serving path, with and without a key mask,
and at the shapes off the bf16 kernels' 16 x 16 tiles that the card tests
use, with an odd batch whose first element has every key masked (-10000):
the port must give JAX's p there, spread over the real keys only.
fp32; tolerance 2e-5, as tests/test_pallas_attention.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.ops.pallas_attention import _reference_attention, fused_attention
from xggm_tpu_torch.ops import attention as port

B, H, D = 2, 4, 64
PATH_SHAPES = [(20, 20), (36, 36), (20, 36), (36, 20)]
# the card tests' edge shapes and batch (tests/test_torch_attention_kernel.py)
EDGE_SHAPES = [(1, 1), (7, 33), (33, 7), (64, 64)]
EDGE_BATCH = 7
_kernel = jax.jit(fused_attention)
_reference = jax.jit(lambda *a: _reference_attention(*a)[0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread is fastest, and it keeps torch's
    thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lq,lk", PATH_SHAPES + EDGE_SHAPES)
def test_port_attention_matches_jax(lq, lk, masked):
    edge = (lq, lk) in EDGE_SHAPES
    b = EDGE_BATCH if edge else B
    rng = np.random.RandomState(100 * lq + lk)
    q = rng.randn(b * H, lq, D).astype(np.float32)
    k = rng.randn(b * H, lk, D).astype(np.float32)
    v = rng.randn(b * H, lk, D).astype(np.float32)
    # the port takes one mask row per batch element and None for no mask;
    # JAX takes one row per (batch, head), zeros for no mask (mha_pallas)
    bias = (np.where(rng.rand(b, lk) > 0.3, 0.0, -10000.0).astype(np.float32)
            if masked else None)
    if masked and edge:
        bias[0] = -10000.0  # every key of the first element masked
    bias_bh = (np.repeat(bias, H, axis=0) if masked
               else np.zeros((b * H, lk), np.float32))

    got = port.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), H).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias_bh))
    kernel = np.asarray(_kernel(*args))
    reference = np.asarray(_reference(*args))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, reference, rtol=2e-5, atol=2e-5)
