"""The port's data parallelism, ZeRO-1 and multi-process runtime
(`xggm_tpu_torch/parallel/`, `training/steps.py::apply_grads`, the trainers'
and CLIs' `mesh`) against the JAX package's mesh steps, on the CPU over
gloo. Two ranks run in subprocesses (tests/_torch_dist_worker.py, JAX
blocked), started once per module while this process compiles JAX's steps.

  (i)   the 2-batch GGM trajectory (relation, representation; four BertAdam
        updates) at `tiny_test_config()` sizes, depth 1/1/1, fp32, every
        dropout 0 and the GGM noise replayed (`noise_override`, each rank
        its rows): two ranks of 4 rows each against JAX's
        `make_ggm_train_step` on a `make_mesh()` DP mesh over the 8 virtual
        devices at the global batch of 8; the tolerances of
        tests/test_torch_train_step.py (losses rtol 1e-4, parameters
        atol 1e-5, counters and flags exactly), and both ranks' parameters
        equal;
  (ii)  the same under ZeRO-1: equal to (i) bit for bit, the fused BertAdam
        under ZeRO-1 against JAX's as in (i), the split leaves those of
        JAX's `maybe_zero_shard_state` on a 2-device data mesh; a ZeRO
        checkpoint written by the two ranks read by one rank, and a
        single-rank checkpoint sharded and written again by two, bit for
        bit. Then in bf16 with the bf16 parameter shadow (the JAX
        package's `zero_state_shardings` with its shadow; the counterpart
        of tests/test_zero_sharding.py's layout and bf16 envelope tests):
        ZeRO-1 equal to data parallelism bit for bit, both ranks alike,
        the tree and the fused BertAdam against one rank at the global
        batch within JAX's envelope (per leaf, relative L2 at most 3e-2
        plus 2e-5), the masters JAX's layout splits split along their
        moments' dimension and the others whole, a rank's bytes of
        masters, moments and shadow 12/N + 2 per shadowed parameter, the
        shadow a fresh cast of the masters, the gathered snapshot the
        single-rank one, and its restore re-slicing it;
  (iii) two epochs of `LxmertPretrainer` with accum_steps 2 (two updates)
        on two ranks against one rank on the global batch of 8 and against
        JAX's loss and gradient on each global microbatch: the masked-LM,
        matched and QA means divide by the global count of labelled rows;
  (iv)  `cli.gqa_ood --coordinator ... --num_hosts 2 --shard_opt_state` as
        two processes: a SIGTERM to rank 1 after its second step makes both
        ranks save one PREEMPT and exit 75 at the same step; `--resume`,
        rank 1 given an empty output directory of its own (a host whose
        disk lacks rank 0's commits), then resumes rank 0's PREEMPT on both
        and finishes the epoch, with the same validation, and rank 0 alone
        writes the run's files (the counterpart of
        tests/test_distributed.py's two-process CLI tests).

Every subprocess runs on a free port and is killed after its own timeout.
"""
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from test_torch_pretrain import _tiny_lxmert
import xggm_tpu_torch.config as port_config
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.checkpoint.manager import CheckpointManager
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
GLOBAL_B, RANKS = 8, 2
WORKER_TIMEOUT = 120
PRETRAIN_SOURCE = "mscoco_train"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argvs, timeout, env=None, on_start=None):
    """Start one process per argv; wait for all within `timeout` seconds,
    killing every one on a timeout. Returns [(returncode, output)]."""
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**os.environ, "PYTHONPATH": REPO,
                                   **(env or {})})
             for argv in argvs]
    if on_start is not None:
        on_start(procs)
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _batches():
    """tests/test_torch_train_step.py's batches at the global batch."""
    rng = np.random.RandomState(42)
    out = []
    for branch in tts.PLAN:
        adj = rng.rand(GLOBAL_B, 36, 36).astype(np.float32)
        mask = np.ones((GLOBAL_B, 20), np.int32)
        mask[:, 13:] = 0
        noise = rng.randn(*((GLOBAL_B, 36, 36) if branch == "relation"
                            else (GLOBAL_B, 36, tts.HID))).astype(np.float32)
        if branch == "relation":
            noise = np.triu(noise, 1) + np.swapaxes(np.triu(noise, 1), 1, 2)
        out.append({
            "input_ids": rng.randint(1, 128, (GLOBAL_B, 20)).astype(np.int32),
            "input_mask": mask,
            "segment_ids": np.zeros((GLOBAL_B, 20), np.int32),
            "feats": rng.randn(GLOBAL_B, 36, 32).astype(np.float32),
            "boxes": rng.rand(GLOBAL_B, 36, 4).astype(np.float32),
            "target": np.eye(tts.NUM_ANS, dtype=np.float32)[
                rng.randint(0, tts.NUM_ANS, GLOBAL_B)],
            "adj": (adj + adj.transpose(0, 2, 1)) / 2,
            "noise_override": noise,
        })
    return out


def _jax_tree_and_tx():
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
    from xggm_tpu.training.bert_adam import bert_adam, lr_scale_tree

    cfg = tts._shrink(jax_tiny())
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    b0, key = _batches()[0], jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, b0["input_ids"], b0["input_mask"],
        b0["segment_ids"], b0["feats"], b0["boxes"], b0["adj"], k,
        method=JaxXGGM.init_all), key)
    scales = lr_scale_tree(shapes, lambda p: not p.startswith("params/lxrt"),
                           1.0, 0.25)
    tx = bert_adam(lr=tts.LR, warmup=tts.WARMUP, t_total=tts.T_TOTAL,
                   lr_scale=scales)
    return cfg, model, shapes, tx


def _jax_mesh_trajectory(batches):
    """JAX's trajectory with the batch sharded over `make_mesh()` (8
    virtual devices, the 'data' axis) and the state replicated; its two
    steps compiled in threads."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xggm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from xggm_tpu.serving.artifact import _flatten
    from xggm_tpu.training import steps as jax_steps

    cfg, model, shapes, tx = _jax_tree_and_tx()
    mesh = make_mesh()
    assert dict(mesh.shape) == {"data": 8, "model": 1}
    rep, data = replicate(mesh), NamedSharding(mesh, P("data"))
    state_shapes = jax_steps.TrainState(shapes, jax.eval_shape(tx.init,
                                                               shapes))
    state_specs = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=rep),
        state_shapes)
    key = jax.random.PRNGKey(0)
    compiled, threads = {}, []
    for branch, batch in zip(tts.PLAN, batches):
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=data)
                 for k, v in batch.items()}
        lowered = jax_steps.make_ggm_train_step(
            model, tx, cfg.train, branch).lower(state_specs, specs, key)
        threads.append(threading.Thread(
            target=lambda b=branch, lw=lowered: compiled.__setitem__(
                b, lw.compile())))
        threads[-1].start()
    for t in threads:
        t.join(timeout=600)
    assert set(compiled) == set(tts.PLAN), "JAX compile did not finish"

    params = tts._numpy_params(shapes)
    flat0 = _flatten(params)
    state = jax.device_put(jax_steps.TrainState(params, tx.init(params)), rep)
    record = []
    for branch, batch in zip(tts.PLAN, batches):
        state, m = compiled[branch](state, shard_batch(mesh, batch), key)
        record.append({
            "metrics": {k: float(m[k]) for k in tts.METRICS},
            "params": _flatten(state.params),
            "leaf_count": _flatten(state.opt_state.leaf_count),
            "active": _flatten(state.opt_state.active)})
    return flat0, record


def _write_pretrain_corpus(root):
    from xggm_tpu_torch.data.synthetic_pretrain import make_synthetic_pretrain

    # 4 images x (2 captions + 2 questions): 16 sentences, two global
    # microbatches of 8 per epoch, one update of accum_steps 2
    make_synthetic_pretrain(root, PRETRAIN_SOURCE, n_images=4,
                            sents_per_img=2, feat_dim=32, tsv=True)


def _pretrain_cfg(out):
    """tiny_test_config at depth 1/1/1, fp32, dropout 0, global batch 8,
    accum_steps 2, two epochs."""
    cfg = tiny_test_config()
    return cfg.replace(
        lxmert=_tiny_lxmert(port_config, l_layers=1, x_layers=1, r_layers=1),
        train=dataclasses.replace(cfg.train, batch_size=GLOBAL_B, lr=1e-3,
                                  epochs=2, seed=0, accum_steps=2),
        output=out)


def _pretrain_featurizer(root):
    from xggm_tpu_torch.data.pretrain_data import (
        LxmertPretrainDataset, PretrainFeaturizer)
    from xggm_tpu_torch.data.tokenizer import BertTokenizer

    ds = LxmertPretrainDataset(PRETRAIN_SOURCE, root, None)
    ds.load_features_tsv(os.path.join(root, "lxmert_imgfeat",
                                      f"{PRETRAIN_SOURCE}_obj36.tsv"))
    return PretrainFeaturizer(
        ds, BertTokenizer.from_file(os.path.join(root, "vocab.txt")),
        max_seq_length=20, seed=0)


def _pretrain_init_state(root):
    """The pretrainer's initial parameters moved off the init (as in
    tests/test_torch_pretrain.py: at the init a masked object's all-zero
    row meets a LayerNorm whose eps 1e-12 scales its gradient by 1e6)."""
    from xggm_tpu_torch.training.pretrainer import LxmertPretrainer

    t = LxmertPretrainer(_pretrain_cfg(os.path.join(root, "init")),
                         _pretrain_featurizer(root), None, device="cpu")
    noise = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in t.model.parameters():
            p.add_(torch.randn(p.shape, generator=noise) * 0.02)
    return {k: v.clone() for k, v in t.model.state_dict().items()}


class _Ranks:
    """The two worker ranks, started when the module's first test asks."""

    def __init__(self, workdir, flat0, batches, one_rank):
        self.workdir = workdir
        self.one_rank = one_rank
        self.pretrain_root = os.path.join(workdir, "pretrain")
        _write_pretrain_corpus(self.pretrain_root)
        self.pretrain_state = _pretrain_init_state(self.pretrain_root)
        cfg = tts._shrink(tiny_test_config())
        torch.save({
            "cfg": cfg, "flat0": flat0, "batches": batches,
            "plan": tts.PLAN, "metrics": tts.METRICS, "lr": tts.LR,
            "warmup": tts.WARMUP, "t_total": tts.T_TOTAL,
            "zero_dir": os.path.join(workdir, "zero_ckpt"),
            "one_dir": os.path.join(workdir, "one_ckpt"),
            "pretrain": {
                "root": self.pretrain_root, "source": PRETRAIN_SOURCE,
                "qa_sets": None, "vocab": os.path.join(self.pretrain_root,
                                                       "vocab.txt"),
                "tsv": os.path.join(self.pretrain_root, "lxmert_imgfeat",
                                    f"{PRETRAIN_SOURCE}_obj36.tsv"),
                "cfg": _pretrain_cfg(os.path.join(workdir, "pretrain_out")),
                "state": self.pretrain_state}},
            os.path.join(workdir, "inputs.pt"))
        coordinator = f"127.0.0.1:{_free_port()}"
        self._outs = None
        worker = os.path.join(HERE, "_torch_dist_worker.py")
        argvs = [[sys.executable, worker, coordinator, str(RANKS), str(r),
                  workdir] for r in range(RANKS)]
        self._thread = threading.Thread(target=self._run, args=(argvs,))
        self._thread.start()

    def _run(self, argvs):
        try:
            self._outs = _run_ranks(argvs, WORKER_TIMEOUT)
        except BaseException as e:  # noqa: BLE001 - reported by results()
            self._outs = e

    def results(self):
        self._thread.join(timeout=WORKER_TIMEOUT + 30)
        assert not self._thread.is_alive(), "workers did not finish"
        if isinstance(self._outs, BaseException):
            raise self._outs
        for r, (rc, out) in enumerate(self._outs):
            assert rc == 0 and f"WORKER_OK {r}" in out, \
                f"rank {r} failed:\n{out[-4000:]}"
        return [torch.load(os.path.join(self.workdir, f"results_{r}.pt"),
                           weights_only=False) for r in range(RANKS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh trajectory (compiled while the ranks run), the ranks'
    results and the single-rank port trajectory."""
    from xggm_tpu.serving.artifact import _flatten

    workdir = str(tmp_path_factory.mktemp("scale_out"))
    batches = _batches()
    _, _, shapes, _ = _jax_tree_and_tx()
    flat0 = _flatten(tts._numpy_params(shapes))
    model = XGGMModel(*_port_cfg_args(), device="cpu")
    flat0_port = from_jax_params(flat0, model)
    one = _one_rank_checkpoint(flat0, batches, workdir)
    ranks = _Ranks(workdir, flat0_port, batches, one)
    jax_flat0, jax_record = _jax_mesh_trajectory(batches)
    assert set(jax_flat0) == set(flat0)
    return {"jax": jax_record, "ranks": ranks.results(), "ranks_obj": ranks,
            "workdir": workdir, "one": one}


def _port_cfg_args():
    cfg = tts._shrink(tiny_test_config())
    return cfg.lxmert, cfg.num_answers, cfg.ggm


def _one_rank_checkpoint(flat0, batches, workdir):
    """One rank's 2-batch trajectory on the global batch, its final state
    saved as ONE (the single-rank format)."""
    cfg = tts._shrink(tiny_test_config())
    model, opt, state = tts._port_model(flat0, cfg)
    for i, (branch, batch) in enumerate(zip(tts.PLAN, batches)):
        step = tts.make_ggm_train_step(model, opt, cfg.train, branch)
        state, _ = step(state, tts._torch_batch(batch), i)
    ckpt = CheckpointManager(os.path.join(workdir, "one_ckpt"))
    ckpt.save("ONE", {"model": model.state_dict(),
                      "opt_state": state.opt_state.state_dict()})
    ckpt.wait()
    return {n: p.detach().clone() for n, p in state.params.items()}


def _as_record(run):
    """A rank's task run in tests/test_torch_train_step.py's record form."""
    record = [dict(r) for r in run["record"]]
    record[-1]["params"] = {n: p.numpy() for n, p in run["params"].items()}
    return record


def _assert_same_state(a, b):
    for key in ("params", "m", "v"):
        assert set(a[key]) == set(b[key])
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), f"{key} {n}"
    for ra, rb in zip(a["record"], b["record"]):
        assert ra == rb


def test_dp_trajectory_matches_jax_mesh(runs):
    """(i): two ranks of 4 rows against JAX's DP mesh at 8, and against
    one rank at 8; the ranks hold the same parameters."""
    r0, r1 = runs["ranks"]
    # both ranks on this host: each its index among the host's ranks
    assert [r0["host_ranks"], r1["host_ranks"]] == [(0, 2), (1, 2)]
    dp = _as_record(r0["task"]["dp"])
    tts._check_trajectory(runs["jax"], dp)
    for n, p in r0["task"]["dp"]["params"].items():
        assert torch.equal(p, r1["task"]["dp"]["params"][n]), n
        np.testing.assert_allclose(p.numpy(), runs["one"][n].numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    assert r0["task"]["dp"]["sharded"] == []


def test_zero_trajectory_and_cross_world_checkpoint(runs):
    """(ii): ZeRO-1 equal to DP bit for bit, the fused BertAdam under ZeRO
    against JAX, the split leaves those of JAX's layout, and the two
    cross-world checkpoint round trips."""
    from xggm_tpu.parallel.mesh import (
        make_mesh, maybe_zero_shard_state, param_shardings)
    from xggm_tpu.training import steps as jax_steps

    r0, r1 = runs["ranks"]
    dp, zero = r0["task"]["dp"], r0["task"]["zero"]
    _assert_same_state(zero, dp)
    _assert_same_state(r1["task"]["zero"], dp)
    tts._check_trajectory(runs["jax"], _as_record(r0["task"]["zero_fused"]))

    # the split leaves: JAX's data-axis leaves on a 2-device data mesh (a
    # Dense kernel [in, out] is the port's weight [out, in], so the split
    # dimension itself may differ)
    _, _, shapes, tx = _jax_tree_and_tx()
    params = tts._numpy_params(shapes)
    mesh = make_mesh(n_devices=RANKS)
    state, shardings = maybe_zero_shard_state(
        jax_steps.TrainState(params, tx.init(params)), mesh,
        param_shardings(params, mesh), True)
    jax_split = sorted(
        port_name(jax_steps._path_str(path)) for path, sh in
        jax.tree_util.tree_leaves_with_path(shardings.opt_state.m)
        if "data" in tuple(sh.spec))
    assert zero["sharded"] == jax_split and len(jax_split) > 0
    for n in zero["sharded"]:
        whole, local = dp["m"][n].shape, zero["local_m_shapes"][n]
        assert sum(a != b for a, b in zip(whole, local)) <= 1
        assert np.prod(local) * RANKS == np.prod(whole), n

    # ZERO2, written by the two ranks, read by one: the DP state exactly
    restored = CheckpointManager(os.path.join(runs["workdir"],
                                              "zero_ckpt")).load("ZERO2")
    opt = restored["opt_state"]
    for n in dp["params"]:
        assert torch.equal(restored["model"][n], dp["params"][n]), n
        assert torch.equal(opt["m"][n], dp["m"][n]), n
        assert torch.equal(opt["v"][n], dp["v"][n]), n
    assert opt["count"] == dp["record"][-1]["count"] == 4
    assert dict(zip(opt["names"], opt["leaf_count"].tolist())) == \
        dp["record"][-1]["leaf_count"]

    # ONE, a single-rank checkpoint, sharded by two ranks and saved again
    rev = r0["reverse"]
    assert rev["slices_equal"] and r1["reverse"]["slices_equal"]
    assert rev["n_sharded"] == len(jax_split)
    assert rev["n_sharded"] + rev["n_whole"] == len(dp["params"])
    mgr = CheckpointManager(os.path.join(runs["workdir"], "one_ckpt"))
    a, b = mgr.load("ONE"), mgr.load("ONE_RESAVED")
    assert set(a) == set(b)
    for key in ("m", "v"):
        for n, x in a["opt_state"][key].items():
            assert torch.equal(x, b["opt_state"][key][n]), f"{key} {n}"
    for n, x in a["model"].items():
        assert torch.equal(x, b["model"][n]), n
    for key in ("names", "count", "touched"):
        assert a["opt_state"][key] == b["opt_state"][key], key
    for key in ("lr_scale", "leaf_count", "active"):
        assert torch.equal(a["opt_state"][key], b["opt_state"][key]), key

    _check_zero_shadow(runs, params, tx, mesh)


def _envelope(got, want, what):
    """JAX's bf16-shadow envelope (tests/test_bf16_shadow.py): per leaf,
    |got - want| <= 3e-2 |want| + 2e-5 in L2."""
    for n, w in want.items():
        diff = float((got[n].double() - w.double()).norm())
        assert diff <= 3e-2 * float(w.double().norm()) + 2e-5, (what, n)


def _check_zero_shadow(runs, params, tx, mesh):
    """(ii) in bf16 with the shadow: `_torch_dist_worker.shadow_runs`
    against JAX's shadowed ZeRO layout on the 2-device data mesh."""
    from xggm_tpu.parallel.mesh import maybe_zero_shard_state, \
        param_shardings
    from xggm_tpu.training import steps as jax_steps

    r0, r1 = (r["shadow"] for r in runs["ranks"])
    one, dp = r0["one"], r0["dp"]
    assert one["sliced"] == [] and dp["sliced"] == []
    for run in ("dp", "zero", "zero_fused"):
        for r in (r0, r1):
            got = r[run]
            assert got["fresh_cast"], run
            assert set(got["shadow"]) == set(one["shadow"]), run
            for n, t in got["params"].items():
                assert torch.equal(t, r0[run]["params"][n]), (run, n)
            for a, b in zip(got["record"], one["record"]):
                for k in a:
                    np.testing.assert_allclose(a[k], b[k], rtol=2e-2,
                                               atol=1e-3, err_msg=run)
        _envelope(r0[run]["params"], one["params"], run)
    for n, t in dp["params"].items():
        assert torch.equal(r0["zero"]["params"][n], t), n
    assert r0["zero"]["record"] == dp["record"]

    state, shardings = maybe_zero_shard_state(
        jax_steps.TrainState(params, tx.init(params),
                             jax_steps.bf16_param_shadow(params)),
        mesh, param_shardings(params, mesh), True)
    flat = {port_name(jax_steps._path_str(path)): sh for path, sh in
            jax.tree_util.tree_leaves_with_path(shardings.params)}
    jax_sliced = sorted(n for n, sh in flat.items()
                        if "data" in tuple(sh.spec))
    assert set(state.params_bf16) and set(
        port_name(k) for k in state.params_bf16) == set(one["shadow"])
    for r in (r0, r1):
        for run in ("zero", "zero_fused"):
            got = r[run]
            assert got["sliced"] == jax_sliced and jax_sliced, run
            assert got["restored_ok"], run
            for n, shape in got["param_shapes"].items():
                whole = tuple(dp["params"][n].shape)
                if n not in got["sliced"]:
                    assert shape == whole, (run, n)
                    continue
                d = got["dims"][n]
                assert shape[d] * RANKS == whole[d] and all(
                    a == b for i, (a, b) in enumerate(zip(shape, whole))
                    if i != d), (run, n)
            b = got["bytes"]
            assert (b["masters"] + b["moments"] + b["shadow"]
                    == (12 / RANKS + 2) * b["shadowed"]), (run, b)


def test_two_rank_pretraining_matches_one_rank_and_jax(runs, monkeypatch):
    """(iii): every microbatch's losses (the ranks' mean) against one rank
    on the global batch and against JAX's losses on it; each update's
    averaged gradient against one rank's and against the mean of JAX's
    gradients of its two microbatches; the final parameters."""
    import xggm_tpu.config as jax_config
    from xggm_tpu.models.pretrain_model import PretrainModel as JaxModel
    from xggm_tpu.serving.artifact import _flatten, _unflatten
    from xggm_tpu_torch.checkpoint.jax_params import to_jax_params
    from xggm_tpu_torch.models.pretrain_model import LOSSES_NAME
    from xggm_tpu_torch.training import pretrainer as pt

    ranks = runs["ranks_obj"]
    two = runs["ranks"][0]["pretrain"]
    assert two["losses"] == runs["ranks"][1]["pretrain"]["losses"]
    root = ranks.pretrain_root

    t = pt.LxmertPretrainer(
        _pretrain_cfg(os.path.join(runs["workdir"], "pretrain_one")),
        _pretrain_featurizer(root), None, device="cpu")
    t.model.load_state_dict(ranks.pretrain_state)
    batches, losses, grads = [], [], []
    grad_step = t.grad_step

    def recording(batch, seed):
        out = grad_step(batch, seed)
        batches.append({k: v.numpy() for k, v in batch.items()})
        losses.append([float(out[0])] + [float(out[1][k])
                                         for k in LOSSES_NAME])
        return out

    apply_grads = pt.apply_grads

    def recording_apply(opt, state, g, clip):
        grads.append([x.clone() for x in g.values() if x is not None])
        apply_grads(opt, state, g, clip)

    t.grad_step = recording
    monkeypatch.setattr(pt, "apply_grads", recording_apply)
    t.train()
    monkeypatch.undo()
    assert len(losses) == len(two["losses"]) == 4
    assert len(grads) == len(two["grads"]) == t.state.opt_state.count \
        == two["count"] == 2
    np.testing.assert_allclose(two["losses"], losses, rtol=1e-4)
    for update, (a, b) in enumerate(zip(two["grads"], grads)):
        for n, x, y in zip(two["names"], a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{update} {n}")
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose(two["params"][n].numpy(),
                                   p.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=n)
    assert two["leaf_count"] == t.state.opt_state.leaf_counts()

    # a rank builds its rows of a batch as the whole batch has them, and
    # its featurizer's RandomState moves as the whole batch's does
    whole, part = _pretrain_featurizer(root), _pretrain_featurizer(root)
    for first in (0, GLOBAL_B):
        idx = list(range(first, first + GLOBAL_B))
        want, want_uids = whole.featurize(idx)
        got, got_uids = part.featurize(idx, range(GLOBAL_B // 2, GLOBAL_B))
        assert got_uids == want_uids
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v[GLOBAL_B // 2:],
                                          err_msg=k)
    assert str(whole.rng.get_state()) == str(part.rng.get_state())

    # JAX's losses and gradients at the initial parameters: the first
    # update's rate is 0, so all four microbatches see them
    jax_model = JaxModel(
        _tiny_lxmert(jax_config, l_layers=1, x_layers=1, r_layers=1),
        num_answers=t.train_feat.ds.num_answers)
    model0 = t.model
    model0.load_state_dict(ranks.pretrain_state)
    flat = to_jax_params(model0)

    def jax_loss(p, batch):
        total, named, _ = jax_model.apply(p, batch, deterministic=True,
                                          method=JaxModel.compute_losses)
        return total, named

    fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    jax_grads = []
    for i, batch in enumerate(batches):
        (total, named), g = fn(_unflatten(flat), batch)
        np.testing.assert_allclose(
            two["losses"][i], [float(total)] + [float(named[k])
                                                for k in LOSSES_NAME],
            rtol=1e-4, atol=1e-6, err_msg=f"microbatch {i}")
        jax_grads.append(_flatten(g))
    names = two["names"]
    for update in range(2):
        a, b = jax_grads[2 * update], jax_grads[2 * update + 1]
        for n, got in zip(names, two["grads"][update]):
            key = next(k for k in a if port_name(k) == n)
            want = (a[key] + b[key]) / 2
            got = got.numpy()
            np.testing.assert_allclose(
                got.T if key.endswith("/kernel") else got, want, rtol=1e-4,
                atol=1e-5, err_msg=f"update {update} {n}")


CLI = r"""
import functools, os, signal, sys, time
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import xggm_tpu_torch.cli.common as common
from xggm_tpu_torch.config import BertConfig
common.BertConfig = functools.partial(
    BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=64)
from xggm_tpu_torch.cli import gqa_ood
from xggm_tpu_torch.training.metrics import MetricsLogger

argv = sys.argv[1:]
rank = int(argv[argv.index("--host_id") + 1])
if os.environ.get("SIGTERM_RANK") == str(rank):
    log_step = MetricsLogger.log_step

    def sigterm_after_second_step(self, step, metrics, branch=""):
        log_step(self, step, metrics, branch)
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.2)
    MetricsLogger.log_step = sigterm_after_second_step
trainer = gqa_ood.main(argv)
print("COUNT", trainer.state.opt_state.count,
      sorted(trainer.state.opt_state.shards or {}) != [])
"""


def test_two_process_cli_and_joint_preemption(tmp_path):
    """(iv): the CLI as two processes over a TCP rendezvous, ZeRO-1 on;
    SIGTERM to rank 1, then --resume with rank 1 writing to a directory of
    its own."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    own = str(tmp_path / "rank1_own_disk")
    base = ["--synthetic", "--xpack", "--device", "cpu", "--dtype",
            "float32", "--data_root", root, "--llayers", "1",
            "--xlayers", "1", "--rlayers", "1", "--bs", "16", "--epochs", "1",
            "--shard_opt_state", "--num_hosts", "2"]

    def launch(extra, outputs, env=None):
        coordinator = f"127.0.0.1:{_free_port()}"
        return _run_ranks(
            [[sys.executable, "-c", CLI, *base, *extra, "--output", o,
              "--coordinator", coordinator, "--host_id", str(r)]
             for r, o in enumerate(outputs)],
            WORKER_TIMEOUT, env=env)

    first = launch([], [out, out], env={"SIGTERM_RANK": "1"})
    for r, (rc, text) in enumerate(first):
        assert rc == 75, f"rank {r}: exit {rc}\n{text[-3000:]}"
        assert "preempted at epoch 0 batch 2" in text, text[-2000:]
    saved = torch.load(os.path.join(out, "PREEMPT", "state.pt"),
                       weights_only=False)
    assert saved["batches_done"] == 2 and saved["train_iter"] == 2
    # the whole (gathered) moments of the single-rank format
    assert saved["opt_state"]["m"]["logit_fc.fc2.weight"].shape == \
        saved["model"]["logit_fc.fc2.weight"].shape

    os.makedirs(own)
    second = launch(["--resume"], [out, own])
    best = []
    for r, (rc, text) in enumerate(second):
        assert rc == 0, f"rank {r}: exit {rc}\n{text[-3000:]}"
        lines = text.splitlines()
        assert "resumed from PREEMPT (epoch 0, 2 batches done)" in lines
        best.append(next(ln for ln in lines if ln.startswith("Best valid")))
        count = next(ln for ln in lines if ln.startswith("COUNT")).split()
        assert count[1:] == [str(2 * 6), "True"], count
    assert best[0] == best[1], best
    for name in ("args.json", "metrics.jsonl", "log.log", "BEST_0"):
        assert os.path.exists(os.path.join(out, name)), name
    assert not os.path.exists(os.path.join(out, "PREEMPT"))
    assert not any(n.startswith(("BEST", "PREEMPT"))
                   for n in os.listdir(own)), os.listdir(own)
    # one log line per epoch, written by rank 0 alone
    with open(os.path.join(out, "log.log")) as f:
        assert sum(ln.startswith("Epoch 0") for ln in f) == 1
