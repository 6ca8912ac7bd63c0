"""The port's GPipe pipeline (`xggm_tpu_torch/parallel/pipeline.py`,
`pipeline_lxmert.py`) on the CPU over gloo, against its sequential stack,
the one-rank port and the JAX package (the counterpart of
tests/test_pipeline.py). Four ranks run in subprocesses
(tests/_torch_parallel_worker.py, JAX blocked), started once per module
while this process computes the references.

  (i)   `gpipe_apply` against `sequential_apply` on a pipe group of 4: a
        tanh-MLP stack, 8 layers, M = 8 > S and M = S = 4, forward at
        rtol/atol 1e-6; 4 layers, loss and gradients at rtol 1e-6 and
        rtol 1e-5 / atol 1e-6; a bf16 layer fed an fp32 input, cast up
        front to bf16 on both sides (1e-2); a layer that changes the
        activation's shape raises ValueError on every rank;
  (ii)  the LXMERT virtual-layer layout (kinds and identity padding)
        against JAX's `build_superset_stack`, and the 2-stage pipelined
        tiny encoder (stacked, 2/1/1 layers, DP 2 x PP 2, 2 microbatches
        per data rank, dropout off) against the stacked sequential port
        and JAX's stacked encoder: the clean loss rtol 1e-5, its gradients
        rtol 1e-4 / atol 1e-5;
  (iii) one relation train step of that layout, without and with remat,
        against the one-rank stacked step (losses rtol 1e-4, parameters
        rtol 2e-3 / atol 2e-5, tests/test_pipeline.py:330), counters and
        flags exactly, every rank's parameters and BertAdam state
        bit-identical; with dropout on, the remat loss equals the plain
        one's;
  (iv)  `cli.gqa_ood --multiGPU --pp 2 --device cpu` as four torchrun
        ranks (DP 2 x PP 2; the counterpart of tests/test_cli.py:173).

Parity runs with dropout off: a pipelined microbatch draws its masks in
turn from the step's generator, not as one rank draws them.
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
from test_torch_scale_out import _free_port, _run_ranks
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.parallel.pipeline import sequential_apply, stack_stages
from xggm_tpu_torch.parallel.pipeline_lxmert import (
    KIND_IDENT, KIND_LANG, KIND_VISN, KIND_X, stage_layout)
from xggm_tpu_torch.training.bert_adam import BertAdam, lr_scale_tree
from xggm_tpu_torch.training.steps import (
    TrainState, make_clean_loss, make_ggm_train_step, restore_snapshot)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
GLOBAL_B, RANKS, TIMEOUT = 8, 4, 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(pp=2, dropout=0.0, **lx):
    """tiny_test_config, stacked (2/1/1 layers), 2 microbatches, every
    dropout `dropout`, fp32."""
    cfg = tiny_test_config()
    return cfg.replace(
        lxmert=cfg.lxmert.replace(
            stacked_layers=True, pp_stages=pp, pp_microbatches=2,
            bert=dataclasses.replace(cfg.lxmert.bert,
                                     hidden_dropout_prob=dropout,
                                     attention_probs_dropout_prob=dropout),
            **lx),
        ggm=dataclasses.replace(cfg.ggm, dropout=dropout))


def global_batches(n=1):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        adj = rng.rand(GLOBAL_B, 36, 36).astype(np.float32)
        mask = np.ones((GLOBAL_B, 20), np.int32)
        mask[:, 13:] = 0
        noise = np.triu(rng.randn(GLOBAL_B, 36, 36).astype(np.float32), 1)
        out.append({
            "input_ids": rng.randint(1, 128, (GLOBAL_B, 20)).astype(np.int32),
            "input_mask": mask,
            "segment_ids": np.zeros((GLOBAL_B, 20), np.int32),
            "feats": rng.randn(GLOBAL_B, 36, 32).astype(np.float32),
            "boxes": rng.rand(GLOBAL_B, 36, 4).astype(np.float32),
            "target": np.eye(16, dtype=np.float32)[
                rng.randint(0, 16, GLOBAL_B)],
            "adj": (adj + adj.transpose(0, 2, 1)) / 2,
            "noise_override": noise + np.swapaxes(noise, 1, 2)})
    return out


def _jax_stacked(cfg_port):
    """JAX's stacked tiny model (dropout off), its parameter shapes and a
    numpy draw of them (flat)."""
    from xggm_tpu.config import tiny_test_config as jax_tiny
    from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
    from xggm_tpu.serving.artifact import _flatten

    cfg = jax_tiny()
    lx = cfg.lxmert
    cfg = cfg.replace(
        lxmert=lx.replace(stacked_layers=True, bert=dataclasses.replace(
            lx.bert, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)),
        ggm=dataclasses.replace(cfg.ggm, dropout=0.0))
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    b0, key = global_batches()[0], jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, b0["input_ids"], b0["input_mask"],
        b0["segment_ids"], b0["feats"], b0["boxes"], b0["adj"], k,
        method=JaxXGGM.init_all), key)
    params = tts._numpy_params(shapes)
    return model, params, _flatten(params)


def _generic_cases():
    rng = np.random.RandomState(3)

    def stack(n, d, dtype=torch.float32):
        return {"w": torch.tensor(rng.randn(n, d, d) * 0.3, dtype=dtype),
                "b": torch.tensor(rng.randn(n, d) * 0.1, dtype=dtype)}

    def rows(b, d):
        return torch.tensor(rng.randn(b, d), dtype=torch.float32)

    return [
        dict(name="m_gt_s", params=stack(8, 16), x=rows(16, 16), m=8,
             tgt=None, bf16=False),
        dict(name="m_eq_s", params=stack(8, 8), x=rows(8, 8), m=4, tgt=None,
             bf16=False),
        dict(name="grads", params=stack(4, 8), x=rows(8, 8), m=4,
             tgt=rows(8, 8), bf16=False),
        dict(name="bf16", params=stack(4, 16, torch.bfloat16),
             x=rows(8, 16), m=4, tgt=None, bf16=True)]


class _Ranks:
    def __init__(self, workdir, inp):
        self.workdir = workdir
        torch.save(inp, os.path.join(workdir, "inputs.pt"))
        coordinator = f"127.0.0.1:{_free_port()}"
        argvs = [[sys.executable, WORKER, "pipeline", coordinator, str(r),
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


def _stacked_model(flat, cfg):
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(from_jax_params(flat, model))
    return model


def _opt(model):
    return BertAdam(tts.LR, tts.WARMUP, tts.T_TOTAL, lr_scale=lr_scale_tree(
        (n for n, _ in model.named_parameters()),
        lambda n: not n.startswith("lxrt."), 1.0, 0.25))


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("input_ids", "input_mask", "segment_ids"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pipeline"))
    jax_model, jax_params, flat = _jax_stacked(_cfg())
    batches = global_batches()
    cfg = _cfg()
    stacked0 = from_jax_params(flat, _stacked_model(flat, _cfg(pp=0)))
    generic = _generic_cases()
    ranks = _Ranks(workdir, {
        "generic": generic, "pp_cfg": cfg,
        "pp_cfg_dropout": _cfg(dropout=0.1), "stacked0": stacked0,
        "batches": batches, "metrics": tts.METRICS, "lr": tts.LR,
        "warmup": tts.WARMUP, "t_total": tts.T_TOTAL})

    # the references, while the ranks run
    seq_cfg = _cfg(pp=0)
    model = _stacked_model(flat, seq_cfg)
    batch = _torch(batches[0])
    loss = make_clean_loss(model, seq_cfg.num_answers)(batch, 0)[0] \
        / seq_cfg.num_answers
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    seq = {"loss": float(loss.detach()), "grads": dict(zip(
        [n for n, _ in model.named_parameters()], grads))}
    steps = {}
    for remat in (False, True):
        lx = seq_cfg.lxmert.replace(remat=remat)
        one = _stacked_model(flat, seq_cfg.replace(lxmert=lx))
        opt = _opt(one)
        state = TrainState.create(one, opt)
        state, m = make_ggm_train_step(one, opt, seq_cfg.train, "relation")(
            state, batch, 0)
        steps[remat] = {"metrics": {k: float(m[k]) for k in tts.METRICS},
                        "params": {n: p.detach().clone()
                                   for n, p in state.params.items()},
                        "leaf_count": state.opt_state.leaf_counts(),
                        "active": state.opt_state.active_flags()}
    from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
    from xggm_tpu.ops.losses import bce_with_logits
    from xggm_tpu.serving.artifact import _flatten

    b = batches[0]
    args5 = tuple(b[k] for k in ("input_ids", "input_mask", "segment_ids",
                                 "feats", "boxes"))

    def jax_loss(p):
        logits = jax_model.apply(p, *args5, deterministic=True,
                                 method=JaxXGGM.clean_forward)
        return bce_with_logits(logits, b["target"])

    jl, jg = jax.jit(jax.value_and_grad(jax_loss))(jax_params)
    return {"ranks": ranks.results(), "generic": generic, "seq": seq,
            "steps": steps, "jax": {"loss": float(jl),
                                    "grads": _flatten(jg)},
            "jax_params": jax_params}


def test_gpipe_matches_sequential(runs):
    """(i) on every rank: the forward, the loss and gradients, the bf16
    cast and the shape check."""
    for case in runs["generic"]:
        layer = (lambda p, x, _: {"h": torch.tanh(
            x["h"].to(torch.bfloat16) @ p["w"] + p["b"])}) if case["bf16"] \
            else (lambda p, x, _: {"h": torch.tanh(x["h"] @ p["w"]
                                                   + p["b"])})
        params = {k: v.clone().requires_grad_() for k, v in
                  case["params"].items()}
        ref = sequential_apply(layer, params, {"h": case["x"]})["h"]
        for r, res in enumerate(runs["ranks"]):
            got = res["generic"][case["name"]]
            assert got["y"].dtype == ref.dtype, (case["name"], r)
            tol = 1e-2 if case["bf16"] else 1e-6
            torch.testing.assert_close(got["y"].float(),
                                       ref.detach().float(), rtol=tol,
                                       atol=tol)
            if case["tgt"] is None:
                continue
            loss = ((ref - case["tgt"]) ** 2).mean()
            want = torch.autograd.grad(loss, [params["w"], params["b"]],
                                       retain_graph=True)
            np.testing.assert_allclose(float(got["loss"]), float(loss.detach()),
                                       rtol=1e-6)
            for g, w in zip(got["grads"], want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        assert case["bf16"] == (ref.dtype == torch.bfloat16)
    for res in runs["ranks"]:
        assert "changes the activation" in res["generic"]["shape_change"]
    staged = stack_stages({"w": torch.zeros(8, 4, 4),
                           "b": torch.zeros(8, 4)}, 4)
    assert staged["w"].shape == (4, 2, 4, 4) and staged["b"].shape == (4, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        stack_stages({"w": torch.zeros(8, 4, 4)}, 3)


def test_stage_layout_and_pipelined_encoder(runs):
    """(ii): JAX's kinds and padding; the pipelined encoder's loss and
    gradients on every rank against the stacked sequential port and
    JAX."""
    import jax.numpy as jnp
    from xggm_tpu.parallel import pipeline_lxmert as jpl

    enc = runs["jax_params"]["params"]["lxrt"]["encoder"]
    for stages in (1, 2, 3, 4):
        want = np.asarray(jpl.build_superset_stack(
            jax.tree.map(jnp.asarray, enc), stages)["kind"]).tolist()
        assert [jpl.KIND_LANG, jpl.KIND_VISN, jpl.KIND_X, jpl.KIND_IDENT] \
            == [KIND_LANG, KIND_VISN, KIND_X, KIND_IDENT]
        assert stage_layout(2, 1, 1, stages)[0] == want, stages
    assert stage_layout(9, 5, 5, 2)[0] == (
        [KIND_LANG] * 9 + [KIND_VISN] * 5 + [KIND_X] * 5 + [KIND_IDENT])

    seq, jx = runs["seq"], runs["jax"]
    for r, res in enumerate(runs["ranks"]):
        got = res["encoder"]
        np.testing.assert_allclose(got["loss"], seq["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["loss"], jx["loss"], rtol=1e-5)
        assert {n for n, g in got["grads"].items() if g is not None} == \
            {n for n, g in seq["grads"].items() if g is not None}
        for n, g in got["grads"].items():
            if g is None:
                continue
            torch.testing.assert_close(g, seq["grads"][n], rtol=1e-4,
                                       atol=1e-5, msg=f"rank {r} {n}")
        for key, w in jx["grads"].items():
            g = got["grads"][port_name(key)]
            w = np.swapaxes(w, -1, -2) if key.endswith("/kernel") else w
            if g is None:  # outside the clean graph: JAX's gradient is 0
                assert not np.any(w), key
                continue
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {key}")


def test_pp_train_step_matches_one_rank(runs):
    """(iii): one relation step on DP 2 x PP 2 against the one-rank step,
    without and with remat; with dropout on, remat replays the draws."""
    for remat in (False, True):
        want = runs["steps"][remat]
        for r, res in enumerate(runs["ranks"]):
            got = res[f"step_remat{int(remat)}"]
            assert got["identical"], (remat, r)
            for k in tts.METRICS:
                np.testing.assert_allclose(got["metrics"][k],
                                           want["metrics"][k], rtol=1e-4,
                                           err_msg=f"{remat} {r} {k}")
            assert got["leaf_count"] == want["leaf_count"]
            assert got["active"] == want["active"]
            for n, p in got["params"].items():
                torch.testing.assert_close(p, want["params"][n], rtol=2e-3,
                                           atol=2e-5, msg=f"{remat} {r} {n}")
    for res in runs["ranks"]:
        (plain, plain_norm), (remat, remat_norm) = res["dropout_remat"]
        np.testing.assert_allclose(remat, plain, rtol=1e-6)
        np.testing.assert_allclose(remat_norm, plain_norm, rtol=1e-5)


CLI = r"""
import functools, sys
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
trainer = gqa_ood.main(sys.argv[1:])
m = trainer.mesh
print("GRID", m.rank, m.size, m.pipe_rank, m.pipe_size,
      trainer.state.opt_state.count)
"""


def test_pp_cli_end_to_end(tmp_path):
    """(iv): four torchrun ranks train an epoch with --pp 2 and validate;
    "Best valid:" on every rank and BEST_0 from rank 0."""
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    argv = ["--synthetic", "--xpack", "--device", "cpu", "--dtype",
            "float32", "--data_root", root, "--llayers", "1", "--xlayers",
            "1", "--rlayers", "1", "--bs", "16", "--epochs", "1",
            "--multiGPU", "--pp", "2", "--pp_microbatches", "2",
            "--output", out]
    port = str(_free_port())
    outs = []
    procs = [[sys.executable, "-c", CLI, *argv] for _ in range(RANKS)]
    envs = [{"RANK": str(r), "WORLD_SIZE": str(RANKS),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
            for r in range(RANKS)]
    outs = _run_torchrun(procs, envs)
    for r, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {r}: exit {rc}\n{text[-3000:]}"
        assert any(ln.startswith("Best valid:") for ln in text.splitlines())
    best = {next(ln for ln in t.splitlines() if ln.startswith("Best valid"))
            for _, t in outs}
    assert len(best) == 1, best
    grids = sorted(tuple(next(ln for ln in t.splitlines()
                              if ln.startswith("GRID")).split()[1:5])
                   for _, t in outs)
    assert grids == [(d, "2", p, "2") for d in "01" for p in "01"], grids
    assert os.path.isdir(os.path.join(out, "BEST_0"))
    saved = torch.load(os.path.join(out, "BEST_0", "state.pt"),
                       weights_only=False)
    assert saved["model"]["lxrt.encoder.lang_stack.layer.attention.self."
                          "qkv.weight"].shape == (1, 192, 64)
    # the four ranks' checkpoint loads in a single-rank stacked run
    from xggm_tpu_torch.config import BertConfig, GGMConfig, LxmertConfig
    from xggm_tpu_torch.config import VisualConfig

    lx = LxmertConfig(
        bert=BertConfig(vocab_size=128, hidden_size=64,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64),
        visual=VisualConfig(l_layers=1, x_layers=1, r_layers=1),
        stacked_layers=True)
    n_ans = saved["model"]["logit_fc.fc2.bias"].shape[0]
    one = XGGMModel(lx, n_ans, GGMConfig(), device="cpu")
    one.load_state_dict(saved["model"])
    state = TrainState.create(one, BertAdam(1e-5))
    restore_snapshot(one, state, saved, False, "BEST_0")
    assert state.opt_state.count == saved["opt_state"]["count"] > 0


def _run_torchrun(argvs, envs):
    """`_run_ranks` with one environment per rank."""
    import subprocess
    import time

    procs = [subprocess.Popen(a, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**os.environ, "PYTHONPATH": REPO, **e})
             for a, e in zip(argvs, envs)]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1, deadline
                                                - time.monotonic()))
            outs.append((p.returncode, text))
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks did not finish within {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs
