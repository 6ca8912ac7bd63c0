"""The port's activation rematerialisation (`LxmertConfig.remat`:
`torch.utils.checkpoint` over every language, relational and cross layer)
at `tiny_test_config()` sizes on the CPU, fp32.

* The parameter tree is the same with and without remat;
  `stacked_layers` builds the stacked tree, and `pp_stages` without it
  raises ValueError, as in the JAX package.
* With dropout on (hidden and attention 0.1, the generator's 0.5), the
  loss and every gradient of each GGM branch and of the clean phase are
  those without remat from the same seeds, within rtol 1e-5 / atol 1e-7
  (tests/test_scaling_features.py:79-82): the recompute replays each
  layer's hidden masks and attention seeds. The attention calls per phase
  are counted: the recompute runs every layer's attentions again, the
  clean phase's last-layer visual ones included.
* With dropout off, the remat encoder's outputs and gradients against the
  JAX package's `remat=True` encoder (`nn.remat`) within 2e-5.
* A remat two-phase train step (both branches) runs and gives the
  non-remat step's parameters.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models import lxmert
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import (
    TrainState, make_clean_loss, make_ggm_loss, make_ggm_train_step,
    phase_seeds)

B = 4
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
# attention calls per forward at 2/1/1 layers: 2 language, 1 relational,
# and 4 in the cross layer
ATTENTIONS = 2 + 1 + 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(remat: bool, dropout: bool = True):
    cfg = tiny_test_config()
    lx = cfg.lxmert
    p = 0.1 if dropout else 0.0
    return cfg.replace(
        lxmert=lx.replace(remat=remat, bert=dataclasses.replace(
            lx.bert, hidden_dropout_prob=p, attention_probs_dropout_prob=p)),
        ggm=dataclasses.replace(cfg.ggm, dropout=0.5 if dropout else 0.0))


def _model(remat: bool, dropout: bool = True) -> XGGMModel:
    cfg = _cfg(remat, dropout)
    return init_weights(
        XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu"),
        torch.Generator().manual_seed(0))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    cfg = tiny_test_config()
    adj = rng.rand(B, 36, 36).astype(np.float32)
    mask = np.ones((B, 20), np.int64)
    mask[:, 13:] = 0
    return {
        "input_ids": torch.from_numpy(rng.randint(1, 128, (B, 20))),
        "input_mask": torch.from_numpy(mask),
        "segment_ids": torch.zeros(B, 20, dtype=torch.int64),
        "feats": torch.from_numpy(rng.randn(B, 36, 32).astype(np.float32)),
        "boxes": torch.from_numpy(rng.rand(B, 36, 4).astype(np.float32)),
        "target": torch.from_numpy(np.eye(cfg.num_answers, dtype=np.float32)[
            rng.randint(0, cfg.num_answers, B)]),
        "adj": torch.from_numpy((adj + adj.transpose(0, 2, 1)) / 2)}


def test_remat_keeps_the_parameter_tree_and_rejects_unported():
    plain, remat = _model(False), _model(True)
    assert [(n, p.shape) for n, p in plain.named_parameters()] == \
        [(n, p.shape) for n, p in remat.named_parameters()]
    assert remat.lxrt.encoder.remat and not plain.lxrt.encoder.remat
    stacked = lxmert.LxmertEncoder(
        _cfg(True).lxmert.replace(stacked_layers=True), device="cpu")
    assert stacked.remat and stacked.lang_stack.length == 2
    assert tuple(stacked.x_stack.layer.lang_mlp.intermediate.weight.shape) \
        == (1, 128, 64)
    with pytest.raises(ValueError, match="requires stacked_layers"):
        lxmert.LxmertEncoder(_cfg(True).lxmert.replace(pp_stages=2),
                             device="cpu")


def _phase_grads(model, phase: str, batch, monkeypatch):
    """(loss, gradients by name, attention calls) of one phase, seeds of
    step 5; the attention calls are counted in forward and recompute."""
    calls = []
    mha_dropout = lxmert.mha_dropout

    def counting(*args):
        calls.append(1)
        return mha_dropout(*args)

    monkeypatch.setattr(lxmert, "mha_dropout", counting)
    ggm_dropout, ggm_noise, clean_dropout = phase_seeds(5)
    cfg = _cfg(model.lxrt.encoder.remat)
    if phase == "clean":
        loss = make_clean_loss(model, cfg.num_answers)(batch,
                                                       clean_dropout)[0]
    else:
        loss = make_ggm_loss(model, cfg.train, phase)(batch, ggm_dropout,
                                                      ggm_noise)[0]
    forward = len(calls)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()],
                                allow_unused=True)
    monkeypatch.undo()
    return loss, dict(zip(names, grads)), (forward, len(calls) - forward)


def test_remat_gradients_equal_with_dropout_on(monkeypatch):
    batch = _batch()
    plain, remat = _model(False), _model(True)
    for phase in ("relation", "representation", "clean"):
        loss_p, grads_p, calls_p = _phase_grads(plain, phase, batch,
                                                monkeypatch)
        loss_r, grads_r, calls_r = _phase_grads(remat, phase, batch,
                                                monkeypatch)
        torch.testing.assert_close(loss_r, loss_p, rtol=1e-6, atol=0)
        assert calls_p == (ATTENTIONS, 0) and calls_r == (ATTENTIONS,
                                                          ATTENTIONS), phase
        assert set(grads_p) == set(grads_r)
        for n, g in grads_p.items():
            assert (g is None) == (grads_r[n] is None), n
            if g is not None:
                torch.testing.assert_close(grads_r[n], g, **GRAD_TOL,
                                           msg=f"{phase} {n}")


def test_remat_encoder_matches_jax_with_dropout_off():
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.lxmert import LxmertModel as JaxLxmert
    from xggm_tpu.serving.artifact import _flatten
    from test_torch_encoder import _inputs, _random_params

    jcfg = jax_tiny().lxmert.replace(remat=True)
    x = _inputs()
    args = (x["input_ids"], x["input_mask"], x["segment_ids"], x["feats"],
            x["boxes"])
    params = _random_params(lambda key: JaxLxmert(jcfg).init(key, *args))
    rng = np.random.RandomState(3)
    w_lang = rng.randn(B, 20, 64).astype(np.float32)
    w_visn = rng.randn(B, 36, 64).astype(np.float32)

    def jax_loss(p):
        (lang, visn), pooled = JaxLxmert(jcfg).apply(p, *args)
        return ((lang * w_lang).mean() + (visn * w_visn).mean()
                + pooled.mean())

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)

    cfg = tiny_test_config().lxmert.replace(remat=True)
    model = lxmert.LxmertModel(cfg, device="cpu")
    flat = _flatten(params)
    model.load_state_dict(from_jax_params(flat, model))
    t = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
         else torch.from_numpy(v) for k, v in x.items()}
    (lang, visn), pooled = model(t["input_ids"], t["input_mask"],
                                 t["segment_ids"], t["feats"], t["boxes"])
    loss = ((lang * torch.from_numpy(w_lang)).mean()
            + (visn * torch.from_numpy(w_visn)).mean() + pooled.mean())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                allow_unused=True)))
    jflat = _flatten(jgrads)
    assert {port_name(k) for k in jflat} == set(grads)
    for key, want in jflat.items():
        got = grads[port_name(key)]
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got.T if key.endswith("/kernel") else got,
                                   want, rtol=2e-5, atol=2e-5, err_msg=key)


def test_remat_train_step_runs_and_equals_the_plain_step():
    """Both branches and both phases of a step, dropout on, with and
    without remat: finite losses, four updates, the same parameters."""
    finals = []
    for remat in (False, True):
        model = _model(remat)
        cfg = _cfg(remat)
        opt = BertAdam(4e-4, 0.1, 20)
        state = TrainState.create(model, opt)
        losses = []
        for i, branch in enumerate(("relation", "representation")):
            state, m = make_ggm_train_step(model, opt, cfg.train, branch)(
                state, _batch(i), i)
            losses.append({k: float(v) for k, v in m.items()
                           if v.dim() == 0})
        assert all(np.isfinite(v) for d in losses for v in d.values())
        assert state.opt_state.count == 4
        finals.append((losses, {n: p.detach().clone()
                                for n, p in state.params.items()}))
    (loss_p, params_p), (loss_r, params_r) = finals
    for a, b in zip(loss_p, loss_r):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    for n, p in params_p.items():
        torch.testing.assert_close(params_r[n], p, rtol=1e-5, atol=1e-6,
                                   msg=n)
