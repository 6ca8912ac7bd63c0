"""The port's bf16 parameter shadow (`training/steps.py::bf16_param_shadow`,
`TrainConfig.bf16_params`, the default under bf16 compute) against the JAX
package's (the counterpart of tests/test_bf16_shadow.py), at
`tiny_test_config()` sizes on the CPU:

  (a) selection: the shadowed parameters are those of JAX's
      `bf16_param_shadow`, through `checkpoint/jax_params.py`'s names, for
      the GCN, GIN and GAT task models, the stacked layout and
      `PretrainModel`; no LayerNorm scale or embedding table is selected
      (and such leaves exist). JAX's rule also selects the biases of the
      LayerNorms named `ln` (the answer head's, node_fc's, fusion_fc's and
      the GCN projections'), which both packages read in float32: there the
      LayerNorm adds the bias's bf16 rounding, as in JAX. Under the shadow
      the forward and backward read no master of a shadowed leaf and cast
      no weight;
  (b) the port's bf16 trajectory with the shadow against the one without
      (relation then representation, representation then relation, and the
      clean step; tree and fused BertAdam) within JAX's envelope: per leaf
      |a - b| <= 3e-2 |a| + 2e-5 in L2, losses rtol 2e-2 / atol 1e-3; the
      refreshed shadow a fresh cast of the masters, bit for bit; the
      masters of shadowed leaves take no gradient;
  (c) the port's shadowed GGM step (relation, then its clean phase) and
      clean step against JAX's `make_ggm_train_step` and
      `make_clean_train_step` run from `TrainState(p, tx.init(p),
      bf16_param_shadow(p))` on the same weights, within that envelope;
  (d) the trainer: a run preempted after step 3 and resumed equals the
      uninterrupted one bit for bit (the shadow rebuilt from the masters);
      the logits from the shadow equal those from the masters' cast
      exactly; the export's `params.npz` holds the bytes it held before
      the shadow (the masters' bf16 rounding where JAX's rule selects).

Depth 1/1/1, every dropout 0 and the GGM noise replayed where two runs
are compared. The JAX steps are compiled once, in threads.
"""
import contextlib
import dataclasses
import io
import json
import os
import threading

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_train_step as tts
import xggm_tpu.config as jax_config
import xggm_tpu_torch.config as port_config
from xggm_tpu.models.pretrain_model import PretrainModel as JaxPretrain
from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu.training import steps as jax_steps
from xggm_tpu.training.bert_adam import bert_adam as jax_bert_adam
from xggm_tpu.training.bert_adam import lr_scale_tree as jax_lr_scale_tree
from xggm_tpu_torch.checkpoint.jax_params import (
    bf16_consumed, from_jax_params, port_name, to_jax_params)
from xggm_tpu_torch.config import DataConfig
from xggm_tpu_torch.data.synthetic import make_synthetic_gqa, write_vocab
from xggm_tpu_torch.models.pretrain_model import PretrainModel
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.serving.artifact import export_model
from xggm_tpu_torch.training import steps
from xggm_tpu_torch.training.bert_adam import BertAdam, lr_scale_tree
from xggm_tpu_torch.training.trainer import XGGMTrainer
from xggm_tpu_torch.utils.preempt import Preempted, PreemptionGuard

BF16 = "bfloat16"
# gradients of one phase from one state, against a reference: relative L2
# over all parameters together and over each parameter (chip_smoke.py's
# GRAD_RTOL and PARAM_GRAD_RTOL)
GRAD_RTOL, PARAM_GRAD_RTOL = 1e-2, 5e-2
# the updates of one or two steps from one state, against a reference:
# relative L2 over all leaves together and over each leaf. BertAdam's first
# step moves each element by about lr whatever its gradient's size, so an
# element whose gradient is within rounding of 0 may move either way in
# the two runs: measured at most 0.041 overall and 0.21 on one leaf here
UPDATE_RTOL, UPDATE_PARAM_RTOL = 0.1, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread, clear of XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(cfg):
    return cfg.replace(lxmert=cfg.lxmert.replace(dtype=BF16))


def _envelope(got, want, what):
    """JAX's envelope (tests/test_bf16_shadow.py::_assert_params_close)."""
    for n, w in want.items():
        w = torch.as_tensor(np.asarray(w, np.float64))
        g = torch.as_tensor(np.asarray(got[n], np.float64))
        diff, ref = float((g - w).norm()), float(w.norm())
        assert diff <= 3e-2 * ref + 2e-5, (what, n, diff, ref)


def _metrics_close(got, want, what):
    for k in tts.METRICS:
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=1e-3,
                                       err_msg=f"{what} {k}")


def _fresh_cast(state):
    return all(torch.equal(s, state.params[n].detach().to(torch.bfloat16))
               for n, s in state.shadow.items())


class _Reads(TorchDispatchMode):
    """Counts the operators that read one of `ptrs` (storages), and the
    float32 -> bf16 casts."""

    def __init__(self, ptrs):
        super().__init__()
        self.ptrs, self.reads, self.casts = ptrs, [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = list(args) + list((kwargs or {}).values())
        for a in flat:
            for t in a if isinstance(a, (list, tuple)) else [a]:
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() in self.ptrs):
                    self.reads.append(str(func))
        if (func is torch.ops.aten._to_copy.default
                and args[0].dtype == torch.float32
                and (kwargs or {}).get("dtype") == torch.bfloat16):
            self.casts += 1
        return func(*args, **(kwargs or {}))


def _jax_task_shapes(cfg):
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    b, key = tts._batches()[0], jax.random.PRNGKey(0)
    return model, jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, b["input_ids"], b["input_mask"],
        b["segment_ids"], b["feats"], b["boxes"], b["adj"], k,
        method=JaxXGGM.init_all), key)


def test_selection_matches_jax_and_the_forward_reads_no_master():
    jcfg, pcfg = _bf16(jax_config.tiny_test_config()), \
        _bf16(port_config.tiny_test_config())
    cases = [(gnn, stacked) for gnn in ("GCN", "GIN", "GAT")
             for stacked in (False,)] + [("GCN", True)]
    trees = []
    for gnn, stacked in cases:
        jc = jcfg.replace(lxmert=jcfg.lxmert.replace(stacked_layers=stacked),
                          ggm=dataclasses.replace(jcfg.ggm, gnn=gnn))
        pc = pcfg.replace(lxmert=pcfg.lxmert.replace(stacked_layers=stacked),
                          ggm=dataclasses.replace(pcfg.ggm, gnn=gnn))
        trees.append((f"{gnn} stacked={stacked}", _jax_task_shapes(jc)[1],
                      XGGMModel(pc.lxmert, pc.num_answers, pc.ggm,
                                device="cpu")))
    lx = jcfg.lxmert
    B, F = 2, lx.visual.visual_feat_dim
    ids = np.ones((B, 20), np.int32)
    trees.append(("PretrainModel", jax.eval_shape(
        JaxPretrain(lx, num_answers=16).init,
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids, ids, np.zeros_like(ids), np.zeros((B, 36, F), np.float32),
        np.zeros((B, 36, 4), np.float32)),
        PretrainModel(pcfg.lxmert, 16, device="cpu")))
    for what, tree, model in trees:
        want = {port_name(k) for k in
                jax.eval_shape(jax_steps.bf16_param_shadow, tree)}
        got = set(steps.shadow_names(model))
        assert got == want and got, what
        full = {jax_steps._path_str(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(tree)}
        assert any("LayerNorm" in k for k in full)
        assert any(k.endswith("/embedding") for k in full)
        assert not any("LayerNorm" in n or "layer_norm" in n
                       or "embeddings" in n for n in got), what
        ln_biases = {n for n in got if n.endswith(".ln.bias")}
        assert ln_biases == {port_name(k) for k in full if k.endswith(
            "/ln/bias")} and bf16_consumed("params/logit_fc/ln/bias"), what
        assert steps.uses_shadow(model) and not steps.uses_shadow(
            model, bf16_params=False)

    # under the shadow no operator of a clean phase's forward and backward
    # reads a master of a shadowed leaf, and no float32 -> bf16 cast runs
    # on a weight (the masters' run casts every one)
    model = init_weights(trees[0][2], torch.Generator().manual_seed(0))
    opt = BertAdam(1e-3)
    state = steps.TrainState.create(model, opt)
    batch = tts._torch_batch(tts._batches()[0])
    loss = steps.make_clean_loss(model, model.num_answers)
    ptrs = {state.params[n].untyped_storage().data_ptr()
            for n in state.shadow}
    casts = {}
    for shadow in (None, state.shadow):
        run = dataclasses.replace(state, shadow=shadow)
        with _Reads(ptrs) as reads:
            _, grads = steps.loss_and_grads(run, loss, batch, 0)
        casts[shadow is None] = reads.casts
        if shadow is not None:
            assert reads.reads == [], reads.reads[:5]
            assert all(state.params[n].grad is None for n in shadow)
            assert grads["encoder_adj.weight"] is None
            assert all(g is None or g.dtype == torch.float32
                       for g in grads.values())
        else:
            assert reads.reads
    n_dense = sum(1 for n in state.shadow if n.startswith("lxrt."))
    assert casts[True] - casts[False] >= n_dense, casts


def _port_state(flat0, cfg, bf16_params, fused=False):
    """The port's model, a BertAdam at the constant rate LR (no warmup, so
    the first update of every leaf moves it) and a fresh state."""
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(from_jax_params(flat0, model))
    opt = BertAdam(tts.LR, lr_scale=lr_scale_tree(
        (n for n, _ in model.named_parameters()),
        lambda n: not n.startswith("lxrt."), 1.0, 0.25), fused=fused)
    return model, opt, steps.TrainState.create(model, opt,
                                               bf16_params=bf16_params)


def _grads_close(got, want, what):
    """Gradients by name (None: outside the graph) within GRAD_RTOL in
    relative L2 over all parameters together and PARAM_GRAD_RTOL over each
    parameter whose reference gradient is nonzero."""
    assert {n for n, g in got.items() if g is not None} == set(want), what
    diff = ref = 0.0
    for n, w in want.items():
        w = torch.as_tensor(np.asarray(w, np.float64))
        d = float((got[n].double() - w).norm())
        diff, ref = diff + d * d, ref + float(w.norm()) ** 2
        if float(w.norm()) > 0:
            assert d <= PARAM_GRAD_RTOL * float(w.norm()), (what, n, d)
    assert diff ** 0.5 <= GRAD_RTOL * ref ** 0.5, (what, diff, ref)


def _updates_close(got, want, p0, what):
    """The updates (p - p0) in relative L2: at most UPDATE_RTOL over all
    leaves together and UPDATE_PARAM_RTOL over each leaf the reference
    moves; the parameters themselves within JAX's envelope. Parameters left
    unchanged read 1 / UPDATE_RTOL overall and 1 / UPDATE_PARAM_RTOL on
    every leaf that moves, both above 1."""
    _envelope(got, want, what)
    diff = ref = 0.0
    for n, w in want.items():
        w = np.asarray(w, np.float64) - p0[n]
        d = float(np.linalg.norm(np.asarray(got[n], np.float64) - p0[n] - w))
        m = float(np.linalg.norm(w))
        diff, ref = diff + d * d, ref + m * m
        assert d <= UPDATE_PARAM_RTOL * m, (what, n, d, m)
    assert ref > 0 and diff ** 0.5 <= UPDATE_RTOL * ref ** 0.5, (what, diff,
                                                                ref)


def _phase_losses(model, cfg):
    return {"relation": steps.make_ggm_loss(model, cfg.train, "relation"),
            "representation": steps.make_ggm_loss(model, cfg.train,
                                                  "representation"),
            "clean": steps.make_clean_loss(model, cfg.num_answers)}


def test_trajectory_with_and_without_the_shadow():
    batches = tts._batches()
    _, shapes = _jax_task_shapes(_bf16(tts._shrink(jax_config.tiny_test_config())))
    flat0 = _flatten(tts._numpy_params(shapes))
    cfg = _bf16(tts._shrink(port_config.tiny_test_config()))

    # each phase's gradients from one state, through the shadow and
    # through the masters' cast at use
    model, _, state = _port_state(flat0, cfg, True)
    p0 = {n: p.detach().double().numpy().copy()
          for n, p in state.params.items()}
    masters = dataclasses.replace(state, shadow=None)
    for phase, loss in _phase_losses(model, cfg).items():
        batch = tts._torch_batch(batches[phase == "representation"])
        args = (batch, 0) if phase == "clean" else (batch, 0, 0)
        _, shadowed = steps.loss_and_grads(state, loss, *args)
        _, plain = steps.loss_and_grads(masters, loss, *args)
        assert all(p.grad is None for p in state.params.values())
        _grads_close(shadowed, {n: g for n, g in plain.items()
                                if g is not None}, phase)

    plans = {"rel,rep": [0, 1], "rep,rel": [1, 0], "clean": [0, 0]}
    for fused in (False, True):
        for plan, order in plans.items():
            out = {}
            for shadowed in (False, True):
                model, opt, state = _port_state(flat0, cfg, shadowed, fused)
                assert (state.shadow is not None) == shadowed
                metrics = []
                for i, b in enumerate(order):
                    batch = tts._torch_batch(batches[b])
                    if plan == "clean":
                        step = steps.make_clean_train_step(
                            model, opt, cfg.train, cfg.num_answers)
                    else:
                        step = steps.make_ggm_train_step(
                            model, opt, cfg.train, tts.PLAN[b])
                    state, m = step(state, batch, i)
                    metrics.append({k: float(v) for k, v in m.items()
                                    if v.dim() == 0})
                if shadowed:
                    assert _fresh_cast(state), (plan, fused)
                out[shadowed] = metrics, {n: p.detach().numpy().copy()
                                          for n, p in state.params.items()}
            assert out[True][1].keys() == out[False][1].keys()
            _updates_close(out[True][1], out[False][1], p0, (plan, fused))
            for a, b in zip(out[True][0], out[False][0]):
                _metrics_close(a, b, (plan, fused))


def _capture_first():
    """An optax transform that passes the updates on unchanged and keeps
    the first ones it sees (the clipped float32 gradients of a state's
    first update)."""
    def init(params):
        return jnp.zeros((), jnp.int32), jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        n, first = state
        first = jax.tree.map(lambda f, g: jnp.where(n == 0, g, f), first,
                             updates)
        return updates, (n + 1, first)

    return optax.GradientTransformation(init, update)


def test_shadow_step_matches_jax():
    """One GGM step (relation, then its clean phase) and one clean step
    from the same weights: the first update's clipped gradients at
    GRAD_RTOL / PARAM_GRAD_RTOL, the updates within JAX's envelope."""
    jcfg = _bf16(tts._shrink(jax_config.tiny_test_config()))
    model, shapes = _jax_task_shapes(jcfg)
    scales = jax_lr_scale_tree(
        shapes, lambda p: not p.startswith("params/lxrt"), 1.0, 0.25)
    tx = optax.chain(_capture_first(),
                     jax_bert_adam(lr=tts.LR, lr_scale=scales))

    def make_state(p):
        return jax_steps.TrainState(p, tx.init(p),
                                    jax_steps.bf16_param_shadow(p))

    state_shapes = jax.eval_shape(make_state, shapes)
    batch = tts._batches()[0]
    key = jax.random.PRNGKey(0)
    built = {
        "ggm": jax_steps.make_ggm_train_step(model, tx, jcfg.train,
                                             "relation"),
        "clean": jax_steps.make_clean_train_step(model, tx, jcfg.train,
                                                 jcfg.num_answers)}
    compiled, threads = {}, []
    for name, step in built.items():
        lowered = step.lower(state_shapes, batch, key)

        def run(name=name, lowered=lowered):
            compiled[name] = lowered.compile()
        threads.append(threading.Thread(target=run))
        threads[-1].start()

    params = tts._numpy_params(shapes)
    flat0 = _flatten(params)
    cfg = _bf16(tts._shrink(port_config.tiny_test_config()))
    port = {}
    for name in built:
        pmodel, opt, state = _port_state(flat0, cfg, True)
        p0 = {n: p.detach().double().numpy().copy()
              for n, p in state.params.items()}
        if name == "ggm":
            step = steps.make_ggm_train_step(pmodel, opt, cfg.train,
                                             "relation")
        else:
            step = steps.make_clean_train_step(pmodel, opt, cfg.train,
                                               cfg.num_answers)
        first = []
        apply_grads = steps.apply_grads

        def capture(opt, state, grads, clip):
            apply_grads(opt, state, grads, clip)
            if not first:
                first.append({n: None if g is None else g.clone()
                              for n, g in grads.items()})

        with mock.patch.object(steps, "apply_grads", capture):
            state, m = step(state, tts._torch_batch(batch), 0)
        assert _fresh_cast(state) and state.opt_state.count == (
            2 if name == "ggm" else 1)
        port[name] = ({k: float(v) for k, v in m.items() if v.dim() == 0},
                      {n: p.detach().numpy() for n, p in state.params.items()},
                      first[0], p0)
    for t in threads:
        t.join(timeout=600)
    assert set(compiled) == set(built), "JAX compile did not finish"

    def port_tree(flat):
        return {port_name(k): np.asarray(v).T if k.endswith("/kernel")
                else np.asarray(v) for k, v in flat.items()}

    for name, fn in compiled.items():
        jstate, jm = fn(make_state(jax.tree.map(np.array, params)), batch,
                        key)
        got_m, got_p, got_g, p0 = port[name]
        _metrics_close(got_m, {k: float(v) for k, v in jm.items()
                               if np.ndim(v) == 0}, name)
        grads = port_tree(_flatten(jstate.opt_state[0][1]))
        _grads_close(got_g, {n: g for n, g in grads.items()
                             if got_g.get(n) is not None or np.any(g)},
                     name)
        want = port_tree(_flatten(jstate.params))
        assert want.keys() == got_p.keys()
        _updates_close(got_p, want, p0, name)
        shadow = {port_name(k): np.asarray(v, np.float32) for k, v in
                  jstate.params_bf16.items()}
        assert shadow.keys() == set(steps.shadow_names(
            XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")))


def _trainer(root, out):
    """tiny_test_config at depth 1/1/1 in bf16, dropout 0.1, an epoch of
    4 batches of 8 (tests/test_torch_preempt.py's run, in bf16)."""
    cfg = _bf16(port_config.tiny_test_config())
    lx = cfg.lxmert
    cfg = cfg.replace(
        lxmert=lx.replace(visual=dataclasses.replace(
            lx.visual, l_layers=1, x_layers=1, r_layers=1)),
        train=dataclasses.replace(cfg.train, batch_size=8, epochs=1, seed=1),
        data=DataConfig(train="train", valid="val", data_root=root),
        output=out)
    with contextlib.redirect_stdout(io.StringIO()):
        return XGGMTrainer(cfg, use_xpack=True, device="cpu")


class _StepGuard(PreemptionGuard):
    def __init__(self, at_step):
        super().__init__(install=False)
        self.at_step = at_step

    def should_save(self, step_id):
        return step_id >= self.at_step


def _steps_of(out):
    recs = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in recs if "branch" in r]


def test_trainer_resume_predict_and_export(tmp_path):
    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, "train", n_images=8, n_questions=32,
                       feat_dim=32, pack=True)
    make_synthetic_gqa(root, "val", n_images=4, n_questions=12, feat_dim=32,
                       seed=1, pack=True)
    write_vocab(os.path.join(root, "vocab.txt"))

    a = _trainer(root, str(tmp_path / "a"))
    assert a.state.shadow and _fresh_cast(a.state)
    a.preempt = PreemptionGuard(install=False)
    with contextlib.redirect_stdout(io.StringIO()):
        a.train()
    assert a.state.opt_state.count == 8 and _fresh_cast(a.state)

    out = str(tmp_path / "b")
    b = _trainer(root, out)
    b.preempt = _StepGuard(3)
    with pytest.raises(Preempted):
        b.train()
    c = _trainer(root, out)
    c.preempt = PreemptionGuard(install=False)
    with contextlib.redirect_stdout(io.StringIO()):
        c.train(c.resume())
    assert _steps_of(out) == _steps_of(str(tmp_path / "a"))
    for n, p in a.state.params.items():
        assert torch.equal(c.state.params[n], p), n
    for n, s in a.state.shadow.items():
        assert torch.equal(c.state.shadow[n], s), n

    # the logits from the shadow and from the masters' cast at use
    _, batch, _ = next(iter(a._feeder(a.valid_set, 8, False)))
    logits = steps.make_logits_step(a.model)
    with steps.shadow_overlay(a.state):
        from_shadow = logits(batch)
    assert torch.equal(from_shadow, logits(batch))
    assert a.predict(a.valid_set)

    # the export: the bytes of the masters' bf16 rounding where JAX's rule
    # selects, the masters elsewhere, as before the shadow
    art = export_model(a.model, str(tmp_path / "art"),
                       shadow=a.state.shadow)
    got = np.load(os.path.join(art, "params.npz"))
    dtypes = json.load(open(os.path.join(art, "meta.json")))["param_dtypes"]
    flat = to_jax_params(a.model)
    assert set(got.files) == set(flat)
    for k, v in flat.items():
        if bf16_consumed(k):
            want = torch.from_numpy(v).to(torch.bfloat16).view(
                torch.int16).numpy().view(np.uint16)
        else:
            want = v
        assert dtypes[k] == ("bfloat16" if bf16_consumed(k) else "float32")
        assert got[k].dtype == want.dtype and got[k].tobytes() == \
            want.tobytes(), k
