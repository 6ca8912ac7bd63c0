"""The port's stacked-layers layout (`LxmertConfig.stacked_layers`:
`models/lxmert.py::LayerStack`, `checkpoint/torch_bridge.py::
stack_encoder_flat`, the stacked names of `checkpoint/jax_params.py`)
against the JAX package's `nn.scan` layout, on the CPU in fp32
(the counterparts of tests/test_scaling_features.py:41-82 and
tests/test_parity.py's stacked cases).

  (i)   `stack_encoder_flat` / `unstack_encoder_flat` and
        `convert_lxrt_bert` with `stacked_layers` equal JAX's bit for bit
        on a random reference snapshot; `from_jax_params` / `to_jax_params`
        round-trip JAX's stacked tree (kernels [L, in, out] <-> weights
        [L, out, in]);
  (ii)  the stacked encoder against JAX's stacked encoder, remat off and
        on, dropout off: the outputs' loss within 2e-5, every gradient
        within 1e-5 (rtol and atol);
  (iii) a 2-batch `make_ggm_train_step` trajectory (depth 1/1/1, dropout
        off, the noise replayed) stacked on both sides: losses rtol 1e-4,
        parameters atol 1e-5, every stacked leaf's counter and flag
        exactly; and the port's stacked trajectory equals its per-layer
        one within the same tolerances.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_train_step as tts
from test_torch_encoder import _inputs, _random_params
from xggm_tpu_torch.checkpoint import torch_bridge
from xggm_tpu_torch.checkpoint.jax_params import (
    from_jax_params, port_name, to_jax_params)
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models import lxmert
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import init_weights


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_snapshot(cfg, seed=0):
    """A random reference LXMERT snapshot (`bert.*` keys) at the width of
    the port's encoder config `cfg`."""
    rng = np.random.RandomState(seed)
    model = lxmert.LxmertModel(cfg, device="meta")
    sd = {}
    for name, p in model.named_parameters():
        keys = chip_smoke.reference_lxrt_keys("lxrt." + name)
        whole = rng.randn(*p.shape).astype(np.float32)
        for key, part in zip(keys, np.split(whole, len(keys))):
            sd[key] = part
    return sd


def test_stack_unstack_and_bridge_match_jax():
    """(i)."""
    from xggm_tpu.checkpoint import torch_bridge as jax_bridge
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.task_model import XGGMModel as JaxXGGM

    for stacked in (False, True):
        cfg = tiny_test_config().lxmert.replace(stacked_layers=stacked)
        jcfg = jax_tiny().lxmert.replace(stacked_layers=stacked)
        sd = _reference_snapshot(tiny_test_config().lxmert)
        got, _ = torch_bridge.convert_lxrt_bert(sd, cfg, torch_prefix="bert.")
        want, _ = jax_bridge.convert_lxrt_bert(sd, jcfg, torch_prefix="bert.")
        assert set(got) == set(want) and any(
            "lang_stack" in k for k in got) == stacked
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        flat = got if not stacked else jax_bridge.unstack_encoder_flat(
            got, jcfg)
        for fn_port, fn_jax in ((torch_bridge.stack_encoder_flat,
                                 jax_bridge.stack_encoder_flat),
                                (torch_bridge.unstack_encoder_flat,
                                 jax_bridge.unstack_encoder_flat)):
            src = flat if fn_port is torch_bridge.stack_encoder_flat \
                else jax_bridge.stack_encoder_flat(flat, jcfg)
            a, b = fn_port(src, cfg), fn_jax(src, jcfg)
            assert set(a) == set(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)
        # a group missing one layer's tensor is dropped, as in JAX
        partial = dict(flat)
        partial.pop("lxrt/encoder/layer_1/mlp/output/bias")
        assert (set(torch_bridge.stack_encoder_flat(partial, cfg))
                == set(jax_bridge.stack_encoder_flat(partial, jcfg)))

    # JAX's stacked task-model tree into a stacked port model and back
    jc = jax_tiny()
    jc = jc.replace(lxmert=jc.lxmert.replace(stacked_layers=True))
    x = tts._batches()[0]
    params = _random_params(lambda key: JaxXGGM(
        jc.lxmert, jc.ggm, jc.num_answers).init(
            {"params": key, "dropout": key}, x["input_ids"],
            x["input_mask"], x["segment_ids"], x["feats"], x["boxes"],
            x["adj"], key, method=JaxXGGM.init_all))
    from xggm_tpu.serving.artifact import _flatten

    flat = _flatten(params)
    pc = tiny_test_config()
    model = XGGMModel(pc.lxmert.replace(stacked_layers=True),
                      pc.num_answers, pc.ggm, device="cpu")
    model.load_state_dict(from_jax_params(flat, model))
    back = to_jax_params(model)
    assert list(back) == list(flat)
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k
    qkv = model.lxrt.encoder.lang_stack.layer.attention.self.qkv.weight
    assert tuple(qkv.shape) == (2, 192, 64)
    assert np.array_equal(qkv[1].detach().numpy(), flat[
        "params/lxrt/encoder/lang_stack/layer/attention/self/qkv/kernel"][1].T)
    with pytest.raises(KeyError):
        from_jax_params({**flat, "params/lxrt/encoder/lang_stack/layer/x/"
                                 "kernel": flat[next(iter(flat))]}, model)


def test_stacked_encoder_matches_jax():
    """(ii): remat off and on."""
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.lxmert import LxmertModel as JaxLxmert
    from xggm_tpu.serving.artifact import _flatten

    x = _inputs()
    args = (x["input_ids"], x["input_mask"], x["segment_ids"], x["feats"],
            x["boxes"])
    rng = np.random.RandomState(3)
    w_lang = rng.randn(4, 20, 64).astype(np.float32)
    w_visn = rng.randn(4, 36, 64).astype(np.float32)
    params = None
    for remat in (False, True):
        jcfg = jax_tiny().lxmert.replace(stacked_layers=True, remat=remat)
        if params is None:
            params = _random_params(lambda key: JaxLxmert(jcfg).init(
                key, *args))

        def jax_loss(p, jcfg=jcfg):
            (lang, visn), pooled = JaxLxmert(jcfg).apply(p, *args)
            return ((lang * w_lang).mean() + (visn * w_visn).mean()
                    + pooled.mean())

        jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
        cfg = tiny_test_config().lxmert.replace(stacked_layers=True,
                                                remat=remat)
        model = lxmert.LxmertModel(cfg, device="cpu")
        flat = _flatten(params)
        model.load_state_dict(from_jax_params(flat, model))
        t = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
             else torch.from_numpy(v) for k, v in x.items()}
        (lang, visn), pooled = model(t["input_ids"], t["input_mask"],
                                     t["segment_ids"], t["feats"],
                                     t["boxes"])
        loss = ((lang * torch.from_numpy(w_lang)).mean()
                + (visn * torch.from_numpy(w_visn)).mean() + pooled.mean())
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=2e-5)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True)))
        jflat = _flatten(jgrads)
        assert {port_name(k) for k in jflat} == set(grads)
        for key, want in jflat.items():
            got = grads[port_name(key)]
            got = np.zeros_like(want) if got is None else got.numpy()
            np.testing.assert_allclose(
                np.swapaxes(got, -1, -2) if key.endswith("/kernel") else got,
                want, rtol=1e-5, atol=1e-5, err_msg=f"remat {remat} {key}")


def _stacked_shrink(cfg):
    cfg = tts._shrink(cfg)
    return cfg.replace(lxmert=cfg.lxmert.replace(stacked_layers=True))


def _jax_stacked_trajectory(batches):
    """`tts._jax_trajectory` with stacked layers on the JAX side."""
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
    from xggm_tpu.serving.artifact import _flatten
    from xggm_tpu.training import steps as jax_steps
    from xggm_tpu.training.bert_adam import bert_adam, lr_scale_tree

    cfg = _stacked_shrink(jax_tiny())
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    b0, key = batches[0], jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, b0["input_ids"], b0["input_mask"],
        b0["segment_ids"], b0["feats"], b0["boxes"], b0["adj"], k,
        method=JaxXGGM.init_all), key)
    tx = bert_adam(lr=tts.LR, warmup=tts.WARMUP, t_total=tts.T_TOTAL,
                   lr_scale=lr_scale_tree(
                       shapes, lambda p: not p.startswith("params/lxrt"),
                       1.0, 0.25))
    state_shapes = jax_steps.TrainState(shapes,
                                        jax.eval_shape(tx.init, shapes))
    compiled, threads = {}, []
    for branch, batch in zip(tts.PLAN, batches):
        lowered = jax_steps.make_ggm_train_step(
            model, tx, cfg.train, branch).lower(state_shapes, batch, key)
        threads.append(threading.Thread(
            target=lambda b=branch, lw=lowered: compiled.__setitem__(
                b, lw.compile())))
        threads[-1].start()
    for t in threads:
        t.join(timeout=600)
    assert set(compiled) == set(tts.PLAN), "JAX compile did not finish"
    params = tts._numpy_params(shapes)
    flat0 = _flatten(params)
    state = jax_steps.TrainState(params, tx.init(params))
    record = []
    for branch, batch in zip(tts.PLAN, batches):
        state, m = compiled[branch](state, batch, key)
        record.append({
            "metrics": {k: float(m[k]) for k in tts.METRICS},
            "params": _flatten(state.params),
            "leaf_count": _flatten(state.opt_state.leaf_count),
            "active": _flatten(state.opt_state.active)})
    return flat0, record


def _port_record(flat0, batches, cfg):
    model, opt, state = tts._port_model(flat0, cfg)
    record = []
    for i, (branch, batch) in enumerate(zip(tts.PLAN, batches)):
        step = tts.make_ggm_train_step(model, opt, cfg.train, branch)
        state, m = step(state, tts._torch_batch(batch), i)
        record.append({
            "metrics": {k: float(m[k]) for k in tts.METRICS},
            "params": {n: p.detach().numpy().copy()
                       for n, p in state.params.items()},
            "leaf_count": state.opt_state.leaf_counts(),
            "active": state.opt_state.active_flags()})
    return record


def test_stacked_trajectory_matches_jax_and_per_layer():
    """(iii)."""
    batches = tts._batches()
    flat0, jax_record = _jax_stacked_trajectory(batches)
    cfg = _stacked_shrink(tiny_test_config())
    port = _port_record(flat0, batches, cfg)
    for step, (got, want) in enumerate(zip(port, jax_record)):
        for k in tts.METRICS:
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        for field in ("leaf_count", "active"):
            assert got[field] == {port_name(k): v.item()
                                  for k, v in want[field].items()}, \
                f"step {step} {field}"
    stacked = [n for n in port[-1]["params"] if "_stack." in n]
    assert len(stacked) == 12 + 12 + 32  # JAX: 56 stacked leaves
    want = {port_name(k): np.swapaxes(v, -1, -2) if k.endswith("/kernel")
            else v for k, v in jax_record[-1]["params"].items()}
    for name, w in want.items():
        np.testing.assert_allclose(port[-1]["params"][name], w, rtol=0,
                                   atol=1e-5, err_msg=name)

    # the per-layer port from the same weights
    plain_cfg = tts._shrink(tiny_test_config())
    plain_flat = {k: v for k, v in
                  torch_bridge.unstack_encoder_flat(
                      {k[len("params/"):]: v for k, v in flat0.items()},
                      cfg.lxmert).items()}
    plain = _port_record({f"params/{k}": v for k, v in plain_flat.items()},
                         batches, plain_cfg)
    for got, want in zip(port, plain):
        for k in tts.METRICS:
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], rtol=1e-4)
    per_layer = torch_bridge.unstack_encoder_flat(
        {k[len("params/"):]: v for k, v in to_jax_params(_loaded(
            port[-1]["params"], cfg)).items()}, cfg.lxmert)
    for k, v in per_layer.items():
        w = plain[-1]["params"][port_name(k)]
        np.testing.assert_allclose(
            np.swapaxes(v, -1, -2) if k.endswith("/kernel") else v, w,
            rtol=0, atol=1e-5, err_msg=k)


def _loaded(params, cfg):
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()})
    return model


def test_stacked_model_builds_with_remat_and_init():
    """The stacked tree from `init_weights` (its [L, ...] leaves drawn
    whole), remat on: a training step's loss is finite."""
    cfg = tiny_test_config()
    cfg = cfg.replace(lxmert=cfg.lxmert.replace(stacked_layers=True,
                                                remat=True))
    model = init_weights(XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm,
                                   device="cpu"),
                         torch.Generator().manual_seed(0))
    w = model.lxrt.encoder.x_stack.layer.visual_attention.att.kv.weight
    assert tuple(w.shape) == (1, 128, 64) and float(w.detach().std()) > 0.01
    opt = tts.BertAdam(tts.LR, tts.WARMUP, tts.T_TOTAL)
    state = tts.TrainState.create(model, opt)
    batch = tts._torch_batch(tts._batches()[0])
    state, m = tts.make_ggm_train_step(model, opt, cfg.train, "relation")(
        state, batch, 0)
    assert np.isfinite(float(m["ggm_loss"])) and state.opt_state.count == 2
    assert dataclasses.is_dataclass(cfg.lxmert)
