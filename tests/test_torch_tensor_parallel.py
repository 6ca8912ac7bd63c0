"""The port's tensor parallelism (`parallel/mesh.py::param_shardings`,
`parallel/tensor.py`, the model-group norm and flags of
`training/bert_adam.py`, the checkpoint's gather and re-slice in
`training/steps.py`) on the CPU over gloo, against the one-rank port and
the JAX package's DP x TP step (the counterpart of tests/test_parallel.py).
Four ranks (DP 2 x TP 2) run in subprocesses
(tests/_torch_parallel_worker.py, JAX blocked), started once per module
while this process compiles JAX's steps.

  (i)   `param_shardings` against JAX's rules, plain and stacked, on JAX's
        names (tests/test_parallel.py:9,107), and on the full-width model;
  (ii)  the 2-batch GGM trajectory (tiny, depth 1/1/1, fp32, dropout off,
        the noise replayed), the wide Dense layers split at
        `min_model_dim` 64 as JAX's test splits them, tree and fused
        BertAdam, against the one-rank port and JAX's `make_ggm_train_step`
        on a ('data' 4, 'model' 2) mesh: losses rtol 1e-4, parameters
        atol 1e-5, counters and flags exactly; the replicated parameters
        and their BertAdam state bit-identical across the model group; and
        one GGM loss with dropout on whose losses and logits agree bit for
        bit across the model group;
  (iii) with ZeRO-1 too: the same trajectory bit for bit, a checkpoint
        written by the four ranks and restored by one (bit for bit), and a
        single-rank checkpoint restored by the four and written again (bit
        for bit);
  (iv)  tensor and pipeline parallelism composed (model group 2 x pipe
        group 2, the stacked model in 2 microbatches, the counterpart of
        `__graft_entry__.py`'s three axes on one mesh) against the
        one-rank stacked port, at (ii)'s tolerances; the replicated state
        bit-identical across each model group and all of it across each
        pipe group.
"""
import dataclasses
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from test_torch_scale_out import (
    _batches, _free_port, _jax_tree_and_tx, _one_rank_checkpoint, _run_ranks)
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.checkpoint.manager import CheckpointManager
from xggm_tpu_torch.checkpoint.torch_bridge import stack_encoder_flat
from xggm_tpu_torch.config import gqa_ood_config, tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.parallel.mesh import Mesh, param_shardings
from xggm_tpu_torch.training.steps import (
    TrainState, restore_snapshot, whole_snapshot)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
RANKS, TIMEOUT = 4, 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(model_size):
    return Mesh(rank=0, size=1, device=torch.device("cpu"),
                model_size=model_size)


def test_param_shardings_rules():
    """(i): JAX's plain and stacked cases, by JAX name; the port dims; and
    at full width the fused qkv and FFN intermediates split, GQA's answer
    head (1842) not."""
    from xggm_tpu.parallel import mesh as jax_mesh

    plain = {"params/wide/kernel": np.zeros((64, 4096), np.float32),
             "params/wide/bias": np.zeros((4096,), np.float32),
             "params/narrow/kernel": np.zeros((64, 64), np.float32),
             "params/narrow/bias": np.zeros((64,), np.float32),
             "params/odd/kernel": np.zeros((64, 4097), np.float32)}
    stacked = {"params/stacked/kernel": np.zeros((9, 64, 4096), np.float32),
               "params/stacked/bias": np.zeros((9, 4096), np.float32),
               "params/narrow/kernel": np.zeros((9, 64, 64), np.float32),
               "params/narrow/bias": np.zeros((9, 64), np.float32)}
    jmesh = jax_mesh.make_mesh(model_parallel=2)
    for flat in (plain, stacked):
        tree = {"params": {}}
        for k, v in flat.items():
            _, mod, leaf = k.split("/")
            tree["params"].setdefault(mod, {})[leaf] = v
        specs = jax_mesh.param_shardings(tree, jmesh, min_model_dim=2048)
        want = {}
        for mod, leaves in specs["params"].items():
            for leaf, sh in leaves.items():
                if "model" in tuple(sh.spec):
                    want[f"{mod}.{'weight' if leaf == 'kernel' else leaf}"] \
                        = len(sh.spec) - 2 if leaf == "kernel" \
                        else len(sh.spec) - 1
                    assert tuple(sh.spec)[-1] == "model"
        got = param_shardings(flat, _mesh(2), min_model_dim=2048)
        assert got == want and got, (got, want)
        assert param_shardings(flat, _mesh(1)) == {}
    assert param_shardings(plain, _mesh(2)) == {"wide.weight": 0,
                                                "wide.bias": 0}

    cfg = gqa_ood_config()
    for stacked_layers in (False, True):
        model = XGGMModel(cfg.lxmert.replace(stacked_layers=stacked_layers),
                          cfg.num_answers, cfg.ggm, device="meta")
        dims = param_shardings(model, _mesh(2))
        params = dict(model.named_parameters())
        split = sum(params[n].numel() for n in dims)
        assert all(n.endswith(("qkv.weight", "qkv.bias",
                               "intermediate.weight", "intermediate.bias"))
                   for n in dims), sorted(dims)
        assert 98e6 < split < 100e6, split
        assert "logit_fc.fc2.weight" not in dims
        assert set(dims.values()) == {1 if stacked_layers else 0}


class _Ranks:
    def __init__(self, workdir, inp):
        self.workdir = workdir
        torch.save(inp, os.path.join(workdir, "inputs.pt"))
        coordinator = f"127.0.0.1:{_free_port()}"
        argvs = [[sys.executable, WORKER, "tensor", coordinator, str(r),
                  workdir] for r in range(RANKS)]
        self._outs = None
        self._thread = threading.Thread(target=self._run, args=(argvs,))
        self._thread.start()

    def _run(self, argvs):
        try:
            self._outs = _run_ranks(argvs, TIMEOUT)
        except BaseException as e:  # noqa: BLE001 - reported by results()
            self._outs = e

    def results(self):
        self._thread.join(timeout=TIMEOUT + 30)
        assert not self._thread.is_alive(), "workers did not finish"
        if isinstance(self._outs, BaseException):
            raise self._outs
        for r, (rc, out) in enumerate(self._outs):
            assert rc == 0 and f"WORKER_OK {r}" in out, \
                f"rank {r} failed:\n{out[-4000:]}"
        return [torch.load(os.path.join(self.workdir, f"results_{r}.pt"),
                           weights_only=False) for r in range(RANKS)]


def _jax_tp_trajectory(batches):
    """JAX's trajectory on a ('data' 4, 'model' 2) mesh, the wide kernels
    split at min_model_dim 64 (tests/test_parallel.py:26)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xggm_tpu.parallel.mesh import make_mesh, param_shardings as jps
    from xggm_tpu.serving.artifact import _flatten
    from xggm_tpu.training import steps as jax_steps

    cfg, model, shapes, tx = _jax_tree_and_tx()
    mesh = make_mesh(n_devices=8, model_parallel=2)
    params = tts._numpy_params(shapes)
    psh = jps(params, mesh, min_model_dim=64)
    placed = jax.tree.map(jax.device_put, params, psh)
    state = jax_steps.TrainState(placed, tx.init(placed))
    data = NamedSharding(mesh, P("data"))
    key = jax.random.PRNGKey(0)
    record = []
    for branch, batch in zip(tts.PLAN, batches):
        step = jax_steps.make_ggm_train_step(model, tx, cfg.train, branch)
        state, m = step(state, jax.tree.map(
            lambda x: jax.device_put(x, data), batch), key)
        record.append({
            "metrics": {k: float(m[k]) for k in tts.METRICS},
            "params": _flatten(state.params),
            "leaf_count": _flatten(state.opt_state.leaf_count),
            "active": _flatten(state.opt_state.active)})
    return _flatten(params), record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from xggm_tpu.serving.artifact import _flatten

    workdir = str(tmp_path_factory.mktemp("tensor_parallel"))
    batches = _batches()
    _, _, shapes, _ = _jax_tree_and_tx()
    flat0 = _flatten(tts._numpy_params(shapes))
    cfg = tts._shrink(tiny_test_config())
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    one = _one_rank_checkpoint(flat0, batches, workdir)
    lx = cfg.lxmert
    dropout = cfg.replace(lxmert=lx.replace(bert=dataclasses.replace(
        lx.bert, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)),
        ggm=dataclasses.replace(cfg.ggm, dropout=0.5))
    stacked_cfg = cfg.replace(lxmert=cfg.lxmert.replace(stacked_layers=True))
    flat0_stacked = {"params/" + k: v for k, v in stack_encoder_flat(
        {k[len("params/"):]: v for k, v in flat0.items()},
        stacked_cfg.lxmert).items()}
    composed_cfg = stacked_cfg.replace(lxmert=stacked_cfg.lxmert.replace(
        pp_stages=2, pp_microbatches=2))
    stacked_model = XGGMModel(stacked_cfg.lxmert, cfg.num_answers, cfg.ggm,
                              device="cpu")
    ranks = _Ranks(workdir, {
        "cfg": cfg, "cfg_dropout": dropout, "cfg_composed": composed_cfg,
        "flat0_stacked": from_jax_params(flat0_stacked, stacked_model),
        "flat0": from_jax_params(flat0, model), "batches": batches,
        "plan": tts.PLAN, "metrics": tts.METRICS, "lr": tts.LR,
        "warmup": tts.WARMUP, "t_total": tts.T_TOTAL,
        "tp4_dir": os.path.join(workdir, "tp4_ckpt"),
        "one_dir": os.path.join(workdir, "one_ckpt")})
    port_record = tts._port_trajectory(flat0, batches)
    stacked_record = _stacked_trajectory(flat0_stacked, batches, stacked_cfg)
    jax_flat0, jax_record = _jax_tp_trajectory(batches)
    assert set(jax_flat0) == set(flat0)
    return {"ranks": ranks.results(), "one": one, "port": port_record,
            "jax": jax_record, "workdir": workdir, "flat0": flat0,
            "stacked": stacked_record}


def _stacked_trajectory(flat0, batches, cfg):
    """The one-rank stacked port's trajectory, `_port_trajectory`'s
    record."""
    model, opt, state = tts._port_model(flat0, cfg)
    record = []
    for i, (branch, batch) in enumerate(zip(tts.PLAN, batches)):
        step = tts.make_ggm_train_step(model, opt, cfg.train, branch)
        state, m = step(state, tts._torch_batch(batch), i)
        record.append({"metrics": {k: float(m[k]) for k in tts.METRICS},
                       "leaf_count": state.opt_state.leaf_counts(),
                       "active": state.opt_state.active_flags()})
    record[-1]["params"] = {n: p.detach().clone()
                            for n, p in state.params.items()}
    return record


def _record(run):
    record = [dict(r) for r in run["record"]]
    record[-1]["params"] = {n: p.numpy() for n, p in run["params"].items()}
    return record


def test_tp_trajectory_matches_one_rank_and_jax(runs):
    """(ii): tree and fused BertAdam on DP 2 x TP 2 against JAX's DP x TP
    step and the one-rank port; the replicated state bit-identical across
    each model group; dropout on, the model ranks agree."""
    ranks = runs["ranks"]
    dims = ranks[0]["dims"]
    assert dims and all(r["dims"] == dims for r in ranks)
    assert "logit_fc.fc2.weight" not in dims  # 16 answers < 64
    for r, res in enumerate(ranks):
        for name in ("tree", "fused"):
            run = res[name]
            assert run["identical"], (r, name)
            tts._check_trajectory(runs["jax"], _record(run))
            for step, (got, want) in enumerate(zip(run["record"],
                                                   runs["port"])):
                for k in tts.METRICS:
                    np.testing.assert_allclose(
                        got["metrics"][k], want["metrics"][k], rtol=1e-4,
                        err_msg=f"{name} step {step} {k}")
                assert got["leaf_count"] == want["leaf_count"]
                assert got["active"] == want["active"]
            for n, p in run["params"].items():
                np.testing.assert_allclose(
                    p.numpy(), runs["port"][-1]["params"][n], rtol=0,
                    atol=1e-5, err_msg=f"{name} {n}")
            shapes = run["local_shapes"]
            for n, d in dims.items():
                assert shapes[n][d] * 2 == run["params"][n].shape[d], n
        assert res["dropout"]["agree"], r
        assert np.isfinite(res["dropout"]["loss"])
    # the data ranks drew their own masks for their own rows
    assert ranks[0]["dropout"]["loss"] == ranks[1]["dropout"]["loss"]
    assert ranks[0]["dropout"]["loss"] != ranks[2]["dropout"]["loss"]


def test_tp_zero_checkpoints_cross_worlds(runs):
    """(iii): ZeRO-1 on TP slices equals the TP run bit for bit; TP4,
    written by the four ranks, restored by one and saved again bit for
    bit; ONE, restored by the four, saved again bit for bit."""
    ranks = runs["ranks"]
    for res in ranks:
        zero, tree = res["zero"], res["tree"]
        assert zero["zero_leaves"] and zero["identical"]
        assert zero["record"] == tree["record"]
        for n, p in zero["params"].items():
            assert torch.equal(p, tree["params"][n]), n
        assert res["reverse"]["slices_equal"]
        assert res["reverse"]["n_split"] == len(res["dims"])
        assert res["reverse"]["n_zero"] > 0

    tp4 = CheckpointManager(os.path.join(runs["workdir"],
                                         "tp4_ckpt")).load("TP4")
    for n, p in ranks[0]["zero"]["params"].items():
        assert torch.equal(tp4["model"][n], p), n
    cfg = tts._shrink(tiny_test_config())
    model, opt, state = tts._port_model(runs["flat0"], cfg)
    restore_snapshot(model, state, tp4, False, "TP4")
    model_sd, opt_sd = whole_snapshot(model, state)
    _assert_same(tp4, {"model": model_sd, "opt_state": opt_sd})
    assert opt_sd["count"] == 4

    mgr = CheckpointManager(os.path.join(runs["workdir"], "one_ckpt"))
    _assert_same(mgr.load("ONE"), mgr.load("ONE_RESAVED"))


def _assert_same(a, b):
    for n, x in a["model"].items():
        assert torch.equal(x, b["model"][n]), n
    for key in ("m", "v"):
        assert set(a["opt_state"][key]) == set(b["opt_state"][key])
        for n, x in a["opt_state"][key].items():
            assert torch.equal(x, b["opt_state"][key][n]), f"{key} {n}"
    for key in ("names", "count", "touched"):
        assert a["opt_state"][key] == b["opt_state"][key], key
    for key in ("lr_scale", "leaf_count", "active"):
        assert torch.equal(a["opt_state"][key], b["opt_state"][key]), key
    assert port_name("params/logit_fc/fc2/kernel") in a["model"]


def test_tp_and_pp_composed(runs):
    """(iv)."""
    want = runs["stacked"]
    places = set()
    for r, res in enumerate(runs["ranks"]):
        got = res["composed"]
        places.add((got["model_rank"], got["stage"]))
        assert got["n_split"] > 0
        assert got["model_identical"] and got["pipe_identical"], r
        for step, (g, w) in enumerate(zip(got["record"], want)):
            for k in tts.METRICS:
                np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                           rtol=1e-4,
                                           err_msg=f"rank {r} step {step}")
            assert g["leaf_count"] == w["leaf_count"]
            assert g["active"] == w["active"]
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want[-1]["params"][n],
                                       rtol=0, atol=1e-5, err_msg=n)
    assert places == {(0, 0), (0, 1), (1, 0), (1, 1)}
