"""The port's attention against the JAX package's: xggm_tpu_torch's plain
attention (what the wrapper runs on a CPU tensor) vs xggm_tpu's Pallas
`fused_attention` (interpreted on the CPU) and its `_reference_attention`,
at the four (Lq, Lk) pairs of the serving path, with and without a key mask.
fp32; tolerance 2e-5, as tests/test_pallas_attention.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.ops.pallas_attention import _reference_attention, fused_attention
from xggm_tpu_torch.ops import attention as port

B, H, D = 2, 4, 64
_kernel = jax.jit(fused_attention)
_reference = jax.jit(lambda *a: _reference_attention(*a)[0])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lq,lk", [(20, 20), (36, 36), (20, 36), (36, 20)])
def test_port_attention_matches_jax(lq, lk, masked):
    rng = np.random.RandomState(100 * lq + lk)
    q = rng.randn(B * H, lq, D).astype(np.float32)
    k = rng.randn(B * H, lk, D).astype(np.float32)
    v = rng.randn(B * H, lk, D).astype(np.float32)
    # the port takes one mask row per batch element and None for no mask;
    # JAX takes one row per (batch, head), zeros for no mask (mha_pallas)
    bias = (np.where(rng.rand(B, lk) > 0.3, 0.0, -10000.0).astype(np.float32)
            if masked else None)
    bias_bh = (np.repeat(bias, H, axis=0) if masked
               else np.zeros((B * H, lk), np.float32))

    got = port.fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), H).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias_bh))
    kernel = np.asarray(_kernel(*args))
    reference = np.asarray(_reference(*args))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, reference, rtol=2e-5, atol=2e-5)
