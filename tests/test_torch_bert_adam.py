"""The port's BertAdam (xggm_tpu_torch/training/bert_adam.py) against the
reference-traced golden tests/goldens/bert_adam.npz and against the JAX
package's `bert_adam` on a small tree, and the train steps' global-norm clip
against the JAX formula. fp32 on both sides; tolerances are those of
tests/test_parity.py's BertAdam test (rtol 1e-5, atol 1e-6), counters and
flags exactly. Tests loop over their cases (see
tests/test_torch_attention_dropout.py for why the files hold few tests)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.training.bert_adam import SCHEDULES as JAX_SCHEDULES
from xggm_tpu.training.bert_adam import bert_adam as jax_bert_adam
from xggm_tpu_torch.training.bert_adam import (
    SCHEDULES, BertAdam, lr_scale_tree)
from xggm_tpu_torch.training.steps import clip_by_global_norm

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bert_adam_matches_golden():
    """Six updates with the pre-increment schedule (the first is a no-op)
    and a per-parameter lr (w at 4e-3, b at 1e-3)."""
    g = np.load(os.path.join(GOLDENS, "bert_adam.npz"))
    params = {"w": torch.tensor(g["w0"]), "b": torch.tensor(g["b0"])}
    opt = BertAdam(4e-3, warmup=0.1, t_total=10,
                   lr_scale={"w": 1.0, "b": 1e-3 / 4e-3})
    state = opt.init(params)
    for i in range(6):
        opt.step(params, {"w": torch.tensor(g["grads_w"][i]),
                          "b": torch.tensor(g["grads_b"][i])}, state)
        np.testing.assert_allclose(params["w"].numpy(), g["traj_w"][i],
                                   err_msg=f"step {i} w", **TOL)
        np.testing.assert_allclose(params["b"].numpy(), g["traj_b"][i],
                                   err_msg=f"step {i} b", **TOL)
    np.testing.assert_array_equal(g["traj_w"][0], g["w0"])


SHAPES = {"a": (3, 5), "b": (5,), "late": (2, 2), "dead": (4,)}


def _grads(rng, update):
    """`late` has no gradient before update 3 (None in the port, zeros in
    JAX); `dead` always has an all-zero gradient and never activates."""
    out = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    out["dead"][:] = 0.0
    if update < 3:
        out["late"] = None
    return out


def test_bert_adam_matches_jax_on_a_tree():
    """Four updates: lr 0 at each leaf's first update, lazy activation of a
    leaf that first gets a gradient at update 3, per-leaf counters, and a
    4x lr scale on one leaf."""
    rng = np.random.RandomState(0)
    init = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    scales = {"a": 1.0, "b": 4.0, "late": 4.0, "dead": 1.0}
    kw = dict(warmup=0.25, t_total=8)
    tx = jax_bert_adam(lr=1e-2, lr_scale=scales, **kw)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    jstate = tx.init(jparams)
    opt = BertAdam(1e-2, lr_scale=scales, **kw)
    params = {n: torch.tensor(v) for n, v in init.items()}
    state = opt.init(params)
    for update in range(1, 5):
        grads = _grads(rng, update)
        jgrads = {n: jnp.zeros(SHAPES[n]) if g is None else jnp.asarray(g)
                  for n, g in grads.items()}
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        opt.step(params, {n: None if g is None else torch.tensor(g)
                          for n, g in grads.items()}, state)
        for n in SHAPES:
            np.testing.assert_allclose(params[n].numpy(),
                                       np.asarray(jparams[n]),
                                       err_msg=f"update {update} {n}", **TOL)
        assert state.leaf_counts() == {
            n: int(c) for n, c in jstate.leaf_count.items()}
        assert state.active_flags() == {
            n: bool(a) for n, a in jstate.active.items()}
        if update == 1:  # lr 0: nothing moved
            for n in SHAPES:
                np.testing.assert_array_equal(params[n].numpy(), init[n])
    assert state.count == 4
    assert state.leaf_counts() == {"a": 4, "b": 4, "late": 2, "dead": 0}


def test_schedules_and_lr_scale_tree():
    x = np.linspace(0.0, 1.2, 25, dtype=np.float32)
    for name in sorted(SCHEDULES):
        got = SCHEDULES[name](torch.tensor(x), 0.1).numpy()
        want = np.asarray(JAX_SCHEDULES[name](x, 0.1))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    names = ["lxrt.pooler.dense.weight", "logit_fc.fc1.bias",
             "node_fc.fc.weight"]
    assert lr_scale_tree(names, lambda n: not n.startswith("lxrt."),
                         1.0, 0.25) == {names[0]: 0.25, names[1]: 1.0,
                                        names[2]: 1.0}


def test_global_norm_clip_matches_jax_formula():
    """scale = min(1, clip / (norm + 1e-6)) over every gradient, None ones
    skipped; below the clip (gain 0.1) nothing changes."""
    for gain in (0.1, 10.0):
        rng = np.random.RandomState(1)
        raw = {n: gain * rng.randn(*s).astype(np.float32)
               for n, s in SHAPES.items()}
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in raw.values()))
        grads = {n: torch.tensor(g) for n, g in raw.items()}
        grads["none"] = None
        got = clip_by_global_norm(grads, 5.0)
        np.testing.assert_allclose(float(got), norm, rtol=1e-6)
        scale = min(1.0, 5.0 / (norm + 1e-6))
        for n, g in raw.items():
            np.testing.assert_allclose(grads[n].numpy(), g * scale,
                                       rtol=1e-6, err_msg=f"{gain} {n}")
