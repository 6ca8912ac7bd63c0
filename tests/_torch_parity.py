"""Shared helpers of the port's lineage tests: a flax module's parameters
drawn with numpy, carried onto the port's module with `from_jax_params`
(round trip and key checks included), and a forward and its parameter
gradients held against the JAX function's."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.serving.artifact import _flatten
from xggm_tpu_torch.checkpoint.jax_params import (
    from_jax_params, jax_names, to_jax_params)

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, msg, tol=TOL, scale=None):
    """got within tol of want, the absolute part times `scale` (by default
    want's largest entry) where that exceeds 1: float32 sums over a batch
    of 36-node graphs carry cancellation error in proportion to the
    magnitudes summed."""
    want = np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, err_msg=msg,
                               rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, scale))


def random_params(init_fn, seed=0):
    """The tree `init_fn(key)` builds, drawn with numpy (tracing init is
    cheaper than running it): scales and gains near 1, covariances in
    [0.2, 1.2), a kernel [.., in, out] normal(0, 1 / in), every other leaf
    normal(0, 0.1)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if name.endswith("scale") or name == "gain":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "covs":
            v = 0.2 + rng.rand(*leaf.shape)
        elif name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            v = 0.1 * rng.randn(*leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def carry(params, module):
    """Load JAX `params` onto the port's `module`: the flat tree maps onto
    its state dict, `to_jax_params` gives it back bit for bit, and a key
    too many or too few raises."""
    flat = _flatten(params)
    module.load_state_dict(from_jax_params(flat, module))
    back = to_jax_params(module)
    assert list(back) == sorted(flat, key=lambda k: k.split("/"))
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        from_jax_params({**flat, "params/no_such/kernel": v}, module)
    with pytest.raises(KeyError):
        from_jax_params(dict(list(flat.items())[1:]), module)
    return module


def t(x):
    return torch.from_numpy(np.array(x))


def hold_all(cases, grads=True, tol=TOL):
    """For each (name, jax_fn, params, module, port_fn) of `cases`:
    jax_fn(params) against port_fn() (the same structure of outputs, the
    port's module carrying `params`), then, with `grads`, the gradients of
    sum(output * c) for fixed random c in every parameter, the absolute
    tolerance scaled by the module's largest gradient entry. The JAX sides
    (one compile each, for the outputs and their gradients) compile in
    threads while the port's forwards run."""
    ports = []
    for name, jax_fn, params, module, port_fn in cases:
        module.zero_grad(set_to_none=True)
        got = [x for x in jax.tree_util.tree_leaves(
            port_fn(), is_leaf=lambda x: isinstance(x, torch.Tensor))]
        rng = np.random.RandomState(7)
        ports.append((got, [np.asarray(rng.randn(*g.shape), np.float32)
                            for g in got]))

    def jax_side(jax_fn, params, cot):
        def loss(p):
            return sum(jnp.sum(o * c) for o, c in
                       zip(jax.tree_util.tree_leaves(jax_fn(p)), cot))

        return jax.jit(lambda p: (jax_fn(p), jax.grad(loss)(p) if grads
                                  else None))(params)

    with ThreadPoolExecutor(min(4, len(cases))) as pool:
        futures = [pool.submit(jax_side, case[1], case[2], cot)
                   for case, (_, cot) in zip(cases, ports)]
        for (name, _, _, module, _), (got, cot), future in zip(
                cases, ports, futures):
            want, jgrad = future.result()
            want = jax.tree_util.tree_leaves(want)
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                close(g.detach().numpy(), w, f"{name} output {i}", tol)
            if grads:
                _hold_grads(name, module, got, cot, _flatten(jgrad), tol)


def _hold_grads(name, module, got, cot, jgrad, tol):
    sum((g * t(c)).sum() for g, c in zip(got, cot)).backward()
    # a gradient's error scales with the module's gradients, not its own:
    # one that is 0 in exact arithmetic (a bias under a LayerNorm) is noise
    scale = max(float(np.abs(g).max()) for g in jgrad.values())
    params_by_name = dict(module.named_parameters())
    for pname, key in jax_names(module).items():
        grad = params_by_name[pname].grad
        want_g = np.asarray(jgrad[key])
        if key.endswith("/kernel"):
            want_g = np.swapaxes(want_g, -1, -2)
        assert grad is not None, f"{name}: no gradient in {pname}"
        close(grad.numpy(), want_g, f"{name} grad {pname}", tol, scale)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread is fastest, and it keeps torch's
    thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
