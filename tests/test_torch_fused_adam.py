"""The port's fused BertAdam (`BertAdam(fused=True)`, kernel 7 behind
`xggm_tpu_torch/ops/fused_adam.py`) against the JAX package.

- `fused_step` on the CPU (the plain version) against JAX
  `_clip_update_apply(bert_adam(fused=True))`, the Pallas kernel
  interpreted, on the tree of tests/test_fused_optim.py: six updates, a clip
  at update 2, a leaf joining at update 3 (no gradient before: None in the
  port, zeros in JAX), a per-leaf lr scale, and a leaf with a None gradient
  at update 4 against JAX's zeros. Parameters and moments within rtol 1e-6
  and atol 1e-7 (tests/test_fused_optim.py's tolerances), counters and flags
  exactly.
- `fused=True` against the port's tree path (the same tolerances) and
  against the reference-traced golden tests/goldens/bert_adam.npz (rtol
  1e-5, atol 1e-6, those of tests/test_torch_bert_adam.py).
- The slice: a 2-batch `make_ggm_train_step` trajectory of
  `tiny_test_config()` with `BertAdam(fused=True)` against JAX's with
  `bert_adam(fused=True)`, through the helpers of
  tests/test_torch_train_step.py and its tolerances (losses rtol 1e-4,
  parameters atol 1e-5, counters and flags exactly).
- `gpu`: kernel 7 against `fused_adam_reference` on the card.

This file imports JAX only inside the tests that compare with it, so that
the card test runs where JAX is absent:
`python -m pytest --noconftest -m gpu tests/test_torch_fused_adam.py`.
Tests loop over their cases (see tests/test_torch_attention_dropout.py for
why the files hold few tests).
"""
import math
import os

import numpy as np
import pytest
import torch

from xggm_tpu_torch.ops.fused_adam import fused_adam, fused_adam_reference
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import clip_by_global_norm

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-6, atol=1e-7)
# tests/test_fused_optim.py's tree: odd shapes, 1-D, and a late leaf
SHAPES = {"enc/w": (37, 630), "enc/b": (630,), "head/w": (64, 1842),
          "head/ln": (7,), "late/w": (9, 257)}
SCALES = {"enc/w": 0.25, "enc/b": 0.25, "head/w": 1.0, "head/ln": 1.0,
          "late/w": 1.0}
KW = dict(lr=1e-2, warmup=0.1, t_total=12, weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grads(rng, update):
    """Gradients of one update; update 2 clips; `late/w` has none before
    update 3 and `head/ln` none at update 4 (None)."""
    scale = 10.0 if update == 2 else 0.5
    out = {n: (rng.randn(*s) * scale).astype(np.float32)
           for n, s in SHAPES.items()}
    if update < 3:
        out["late/w"] = None
    if update == 4:
        out["head/ln"] = None
    return out


def _torch(arrays):
    return {n: None if a is None else torch.tensor(a)
            for n, a in arrays.items()}


def _assert_close(got, want, what):
    for n in SHAPES:
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   err_msg=f"{what} {n}", **TOL)


def test_fused_step_matches_jax_fused_bert_adam():
    import jax
    import jax.numpy as jnp

    from xggm_tpu.training.bert_adam import bert_adam
    from xggm_tpu.training.steps import TrainState, _clip_update_apply

    def nest(flat):
        out = {}
        for n, a in flat.items():
            top, leaf = n.split("/")
            out.setdefault(top, {})[leaf] = a
        return out

    def flat(tree):
        return {f"{t}/{leaf}": a for t, sub in tree.items()
                for leaf, a in sub.items()}

    rng = np.random.RandomState(0)
    init = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    tx = bert_adam(fused=True, lr_scale=nest(SCALES), **KW)
    jstate = TrainState(nest({n: jnp.asarray(a) for n, a in init.items()}),
                        tx.init(nest(init)))
    jstep = jax.jit(lambda g, s: _clip_update_apply(tx, g, s, 5.0))
    opt = BertAdam(fused=True, lr_scale=SCALES, **KW)
    params = _torch(init)
    state = opt.init(params)
    for update in range(6):
        grads = _grads(rng, update)
        jstate = jstep(nest({n: jnp.zeros(SHAPES[n]) if g is None else
                             jnp.asarray(g) for n, g in grads.items()}),
                       jstate)
        opt.fused_step(params, _torch(grads), state, 5.0)
        _assert_close(params, flat(jstate.params), f"update {update} p")
        _assert_close(state.m, flat(jstate.opt_state.m), f"update {update} m")
        _assert_close(state.v, flat(jstate.opt_state.v), f"update {update} v")
        assert state.leaf_counts() == {
            n: int(c) for n, c in flat(jstate.opt_state.leaf_count).items()}
        assert state.active_flags() == {
            n: bool(a) for n, a in flat(jstate.opt_state.active).items()}
    assert state.count == int(jstate.opt_state.count) == 6
    assert state.leaf_counts()["late/w"] == 3
    assert state.leaf_counts()["enc/w"] == 6


def test_fused_step_matches_tree_path_and_golden():
    """Six updates with the schedule of the JAX comparison, the tree path
    clipping with `clip_by_global_norm` first; then the golden's six
    updates with no clip (clip = inf gives c = 1 exactly)."""
    rng = np.random.RandomState(1)
    init = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    tree_opt = BertAdam(lr_scale=SCALES, **KW)
    fused_opt = BertAdam(fused=True, lr_scale=SCALES, **KW)
    tree_p, fused_p = _torch(init), _torch(init)
    tree_s, fused_s = tree_opt.init(tree_p), fused_opt.init(fused_p)
    for update in range(6):
        grads = _grads(rng, update)
        tree_g = _torch(grads)
        clip_by_global_norm(tree_g, 5.0)
        tree_opt.step(tree_p, tree_g, tree_s)
        norm = fused_opt.fused_step(fused_p, _torch(grads), fused_s, 5.0)
        want = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                           for g in grads.values() if g is not None))
        np.testing.assert_allclose(float(norm), want, rtol=1e-6)
        for what, got, want in (("p", fused_p, tree_p),
                                ("m", fused_s.m, tree_s.m),
                                ("v", fused_s.v, tree_s.v)):
            _assert_close(got, want, f"update {update} {what}")
        assert fused_s.leaf_counts() == tree_s.leaf_counts()
        assert fused_s.active_flags() == tree_s.active_flags()
        assert fused_s.touched == tree_s.touched

    g = np.load(os.path.join(GOLDENS, "bert_adam.npz"))
    params = {"w": torch.tensor(g["w0"]), "b": torch.tensor(g["b0"])}
    opt = BertAdam(4e-3, warmup=0.1, t_total=10, fused=True,
                   lr_scale={"w": 1.0, "b": 1e-3 / 4e-3})
    state = opt.init(params)
    for i in range(6):
        opt.fused_step(params, {"w": torch.tensor(g["grads_w"][i]),
                                "b": torch.tensor(g["grads_b"][i])}, state,
                       math.inf)
        for n in ("w", "b"):
            np.testing.assert_allclose(params[n].numpy(), g[f"traj_{n}"][i],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"golden step {i} {n}")


def test_fused_train_step_trajectory_matches_jax():
    """make_ggm_train_step with `BertAdam(fused=True)` against JAX's with
    `bert_adam(fused=True)` (relation then representation, four updates);
    the checks of tests/test_torch_train_step.py."""
    import test_torch_train_step as tts

    batches = tts._batches()
    flat0, jax_record = tts._jax_trajectory(batches, fused=True)
    tts._check_trajectory(jax_record,
                          tts._port_trajectory(flat0, batches, fused=True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_version(cuda):
    """Kernel 7 against `fused_adam_reference` on leaves of 1, 7, 1842 and
    64 x 1842 elements, one more of 1842 at a 4-byte offset (the scalar
    path), one with a null gradient and one inactive (rate 0); one launch.
    Then the same update writing a bf16 shadow of every leaf but one (at
    lengths 1 and 7, the null row, a shadow 2 bytes off its buffer's
    start): each shadow equals the updated p cast to bf16, bit for bit, and
    the plain version's; p, m and v as without it."""
    rng = np.random.RandomState(2)
    shapes = [(1,), (7,), (1842,), (64, 1842), (1842,), (7, 33), (5, 5)]
    buf = torch.zeros(4 * 1843, device=cuda)  # holds the unaligned leaf
    leaves = []
    for t, shape in enumerate(shapes):
        g, m, v, p = (torch.tensor(rng.randn(*shape).astype(np.float32),
                                   device=cuda) for _ in range(4))
        v = v.abs()
        if t == 4:
            g, m, v, p = (buf[i * 1843 + 1:(i + 1) * 1843].copy_(x)
                          for i, x in enumerate((g, m, v, p)))
            assert p.data_ptr() % 16
        leaves.append([None if t == 5 else g, m, v, p])
    lr_eff = torch.tensor(rng.uniform(1e-3, 1e-1, 10).astype(np.float32),
                          device=cuda)
    indices = [3, 0, 9, 4, 1, 7, 2]
    lr_eff[indices[6]] = 0.0  # the inactive leaf
    clip = torch.tensor(0.37, device=cuda)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    want = [[None if x is None else x.clone() for x in leaf]
            for leaf in leaves]
    before = fused_adam.launches
    fused_adam(*zip(*leaves), indices, clip, lr_eff, **hyper)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 1
    fused_adam_reference(*zip(*want), indices, clip, lr_eff, **hyper)
    for t, (got, ref) in enumerate(zip(leaves, want)):
        for name, a, w in zip("mvp", got[1:], ref[1:]):
            torch.testing.assert_close(a, w, msg=f"leaf {t} {name}", **TOL)
    torch.testing.assert_close(leaves[6][3], want[6][3], rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_adam([leaves[0][0].double()], *[[x] for x in leaves[0][1:]],
                   [0], clip, lr_eff, **hyper)

    # the shadow: leaf 2's none, leaf 3's misaligned
    starts = [[None if x is None else x.clone() for x in leaf]
              for leaf in want]
    odd = torch.empty(64 * 1842 + 1, device=cuda, dtype=torch.bfloat16)
    shadows = [None if t == 2 else
               odd[1:].view(64, 1842) if t == 3 else
               torch.empty(shape, device=cuda, dtype=torch.bfloat16)
               for t, shape in enumerate(shapes)]
    plain_shadows = [None if x is None else x.clone() for x in shadows]
    ref = [[None if x is None else x.clone() for x in leaf]
           for leaf in starts]
    fused_adam(*zip(*starts), indices, clip, lr_eff, **hyper,
               shadows=shadows)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 2
    fused_adam_reference(*zip(*ref), indices, clip, lr_eff, **hyper,
                         shadows=plain_shadows)
    for t, (got, w) in enumerate(zip(starts, ref)):
        for name, a, x in zip("mvp", got[1:], w[1:]):
            torch.testing.assert_close(a, x, msg=f"leaf {t} {name}", **TOL)
        if shadows[t] is not None:
            assert torch.equal(shadows[t], got[3].to(torch.bfloat16)), t
            assert torch.equal(shadows[t], plain_shadows[t]), t
    with pytest.raises(ValueError):
        fused_adam(*[[x] for x in starts[0]], [0], clip, lr_eff, **hyper,
                   shadows=[shadows[0].float()])
