"""The port's trainer against the JAX package's `XGGMTrainer`.

On one synthetic GQA-OOD corpus (32 training questions over 8 images, 12
validation questions over 4, 32-d features), at `tiny_test_config()` sizes
with depth 1/1/1, fp32 and every dropout 0, the port's trainer starting
from the JAX trainer's initial parameters (`from_jax_params`):
  * `train_baseline` (2 epochs of 4 batches of 8): per-step `clean_loss`
    within rtol 1e-4, the final parameters within atol 1e-5 (the tolerances
    of tests/test_torch_train_step.py), the same update count, and the same
    `predict` answers on the validation split;
  * GGM `train()`: the branch of every batch and the steps after which the
    trainer validates equal to the JAX trainer's for the same seed (its
    train steps stubbed: the branch draw, the feeder and the validations
    are its own), two updates per batch, BEST only after an improvement,
    BEST_{epoch} after every epoch, the log.log lines of JAX's format, and
    a `--profile` trace longer than the run closed at its end;
  * a checkpoint round trip: parameters and every BertAdamState field
    exact, and the same predictions after `load`, although the parameters
    and moments were changed in place right after `save` returned;
  * `GQAEval`, `ood_test_report` and `tail_size_sweep` equal to JAX's.
The JAX trainer's steps compile once per module, in the fixture.
"""
import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import xggm_tpu.config as jax_config
import xggm_tpu_torch.config as port_config
from xggm_tpu.checkpoint.manager import CheckpointManager as JaxCheckpoints
from xggm_tpu.data.synthetic import make_synthetic_gqa, write_vocab
from xggm_tpu.evals import gqa_eval as jax_gqa_eval
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu.training.metrics import MetricsLogger as JaxMetricsLogger
from xggm_tpu.training.trainer import XGGMTrainer as JaxTrainer
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.evals import gqa_eval
from xggm_tpu_torch.training.trainer import XGGMTrainer

EPOCHS, BS, N_TRAIN, N_VAL = 2, 8, 32, 12
BATCHES = N_TRAIN // BS
LOG_LINE = re.compile(r"^Epoch (\d+): Train \d+\.\d\d, Valid (\d+\.\d\d), "
                      r"Best (\d+\.\d\d) \(\d+\.\ds\)$")


@pytest.fixture(autouse=True, scope="module")
def quiet_module():
    """One torch thread (tiny shapes; torch's and XLA's pools contend in
    one process), and no TensorBoard: importing it takes seconds here and
    it writes nothing the tests read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()
    torch.set_num_threads(threads)


def _cfg(module, root, out):
    """tiny_test_config at depth 1/1/1, fp32, every dropout 0."""
    cfg = module.tiny_test_config()
    lx = cfg.lxmert
    return cfg.replace(
        lxmert=lx.replace(
            bert=dataclasses.replace(lx.bert, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0),
            visual=dataclasses.replace(lx.visual, l_layers=1, x_layers=1,
                                       r_layers=1)),
        ggm=dataclasses.replace(cfg.ggm, dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=BS, lr=1e-4,
                                  epochs=EPOCHS, seed=1),
        data=module.DataConfig(train="train", valid="val", data_root=root),
        output=out)


def _port_trainer(root, out, flat0, **kw):
    tr = XGGMTrainer(_cfg(port_config, root, out), device="cpu", **kw)
    tr.model.load_state_dict(from_jax_params(flat0, tr.model))
    return tr


def _jsonl(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gqa"))
    make_synthetic_gqa(root, "train", n_images=8, n_questions=N_TRAIN,
                       feat_dim=32)
    make_synthetic_gqa(root, "val", n_images=4, n_questions=N_VAL,
                       feat_dim=32, seed=1)
    write_vocab(os.path.join(root, "vocab.txt"))
    jax_out = str(tmp_path_factory.mktemp("jax_base"))
    jtr = JaxTrainer(_cfg(jax_config, root, jax_out))
    flat0 = {k: np.array(v) for k, v in _flatten(jtr.params).items()}
    jtr.train_baseline()
    jax_base = dict(
        losses=[r["clean_loss"] for r in _jsonl(f"{jax_out}/metrics.jsonl")],
        params={port_name(k): v.T if k.endswith("/kernel") else v
                for k, v in _flatten(jtr.state.params).items()},
        count=int(np.asarray(jtr.state.opt_state.count)),
        answers=jtr.predict(jtr.valid_set))

    # the JAX GGM loop with its steps stubbed: its branch draws, feeder,
    # validations (through its compiled eval step), saves and log.log
    ggm_out = str(tmp_path_factory.mktemp("jax_ggm"))
    jtr.output, jtr.ckpt = ggm_out, JaxCheckpoints(ggm_out)
    jtr.logger = JaxMetricsLogger(ggm_out)

    def stub(state, batch, key):
        preds = np.zeros(batch["input_ids"].shape[0], np.int32)
        return state, {"preds": preds, "ggm_loss": np.float32(1.0),
                       "clean_loss": np.float32(1.0)}

    jtr.rel_step = jtr.rep_step = stub
    jtr.train()
    return dict(root=root, flat0=flat0, base=jax_base, ggm_out=ggm_out)


def test_train_baseline_matches_jax(env, tmp_path):
    tr = _port_trainer(env["root"], str(tmp_path), env["flat0"])
    tr.train_baseline()
    want = env["base"]
    got = [r["clean_loss"] for r in _jsonl(tmp_path / "metrics.jsonl")]
    assert len(got) == len(want["losses"]) == EPOCHS * BATCHES
    np.testing.assert_allclose(got, want["losses"], rtol=1e-4)
    params = {n: p.detach().numpy() for n, p in tr.model.named_parameters()}
    assert set(params) == set(want["params"])
    for name, w in want["params"].items():
        np.testing.assert_allclose(params[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert tr.state.opt_state.count == want["count"] == EPOCHS * BATCHES
    assert tr.predict(tr.valid_set) == want["answers"]
    assert all(os.path.isdir(tmp_path / f"BEST_{e}") for e in range(EPOCHS))


def _run_record(out):
    """Branches, the steps after which the trainer validated, the
    validation accuracies and the log.log lines of a train() run."""
    recs = _jsonl(os.path.join(out, "metrics.jsonl"))
    return dict(
        branches=[r["branch"] for r in recs if "branch" in r],
        val_steps=[r["step"] for r in recs if "valid/mid_epoch_acc" in r],
        val_accs=[r["valid/mid_epoch_acc"] for r in recs
                  if "valid/mid_epoch_acc" in r],
        log=open(os.path.join(out, "log.log")).read().splitlines())


def _check_best_policy(out, rec):
    """BEST exists iff some validation improved on 0; BEST_{e} always."""
    end_accs = [float(LOG_LINE.match(ln).group(2)) for ln in rec["log"]]
    improved = any(a > 0 for a in rec["val_accs"] + end_accs)
    assert os.path.isdir(os.path.join(out, "BEST")) == improved
    for e in range(EPOCHS):
        assert os.path.isdir(os.path.join(out, f"BEST_{e}"))


def test_ggm_train_loop_matches_jax(env, tmp_path):
    # a profile longer than the run: the trace is closed at its end
    tr = _port_trainer(env["root"], str(tmp_path), env["flat0"],
                       profile_steps=100)
    best = tr.train()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    got, want = _run_record(str(tmp_path)), _run_record(env["ggm_out"])
    assert len(got["branches"]) == EPOCHS * BATCHES
    assert got["branches"] == want["branches"]
    assert set(got["branches"]) == {"rel", "rep"}
    assert got["val_steps"] == want["val_steps"]
    assert len(got["val_steps"]) == 3 * EPOCHS
    assert tr.state.opt_state.count == 2 * EPOCHS * BATCHES
    for rec, out in ((got, str(tmp_path)), (want, env["ggm_out"])):
        assert [int(LOG_LINE.match(ln).group(1)) for ln in rec["log"]] == \
            list(range(EPOCHS)), rec["log"]
        _check_best_policy(out, rec)
    assert f"{best * 100:.2f}" == LOG_LINE.match(got["log"][-1]).group(3)
    metrics = _jsonl(tmp_path / "metrics.jsonl")
    assert set(metrics[0]) == {"step", "branch", "ts", "ggm_bce", "d_loss",
                               "loss_grad", "loss_sm", "ggm_loss",
                               "clean_loss"}


def test_checkpoint_round_trip(env, tmp_path):
    tr = _port_trainer(env["root"], str(tmp_path), env["flat0"])
    for qids, batch, _ in tr._feeder(tr.train_set, BS, True):
        tr.state, _ = tr.rel_step(tr.state, batch, 0)
        break
    answers = tr.predict(tr.valid_set)
    params = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    opt = tr.state.opt_state
    opt_before = {k: ({n: t.clone() for n, t in v.items()}
                      if isinstance(v, dict) else
                      v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in opt.state_dict().items()}
    tr.save("RT", epoch=3)
    # the next step's in-place updates, before the commit ends
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
    for t in list(opt.m.values()) + list(opt.v.values()):
        t.add_(1.0)
    opt.leaf_count += 1
    opt.count += 1
    tr.ckpt.wait()
    assert tr.ckpt.exists("RT") and tr.ckpt.history[-1]["bytes"] > 0

    fresh = _port_trainer(env["root"], str(tmp_path), env["flat0"])
    fresh.load(str(tmp_path / "RT"))
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, params[n]), n
    loaded = fresh.state.opt_state.state_dict()
    assert set(loaded) == set(opt_before)
    for k, want in opt_before.items():
        got = loaded[k]
        if isinstance(want, dict):
            assert set(got) == set(want)
            assert all(torch.equal(got[n], want[n]) for n in want), k
        elif isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got, want), k
        else:
            assert got == want, k
    assert fresh.predict(fresh.valid_set) == answers
    assert fresh.ckpt.load("RT")["epoch"] == 3
    assert fresh.ckpt.latest_epoch() is None
    fresh.ckpt.remove("RT")
    assert not fresh.ckpt.exists("RT")
    with pytest.raises(NotImplementedError, match="item 2"):
        fresh.resume()


def test_gqa_eval_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    answers = ["yes", "no", "red", "blue", "dog", "cat"]
    structurals = ["query", "verify", "compare", "logic"]
    ops = ["select", "exist", "query: name", "filter", "choose name",
           "relate"]
    questions, choices = {}, {}
    for i in range(60):
        qid = f"q{i}"
        questions[qid] = {
            "answer": answers[rng.randint(len(answers))],
            "isBalanced": bool(rng.rand() < 0.8),
            "question": " ".join(["w"] * rng.randint(3, 9)) + " ?",
            "types": {"structural": structurals[rng.randint(4)],
                      "semantic": ["attr", "rel", "obj"][rng.randint(3)],
                      "detailed": "chooseCommon" if rng.rand() < 0.2
                      else "x"},
            "groups": {"global": ["color", "animal", None][rng.randint(3)]},
            "semantic": [{"operation": op, "argument": "a"} for op in
                         rng.choice(ops, size=rng.randint(1, 5))],
            "ans_head": ["yes", "no", "dog"],
            "ans_tail": ["red", "cat"],
            "entailed": [],
        }
        choices[qid] = {"valid": answers[:4], "plausible": answers[:2]}
    questions["q0"]["entailed"] = ["q1", "q2"]
    questions["q5"]["entailed"] = ["q5", "q6"]
    # about 60% right; q59 left out (it counts as its gold answer)
    preds = [{"questionId": q, "prediction": v["answer"] if rng.rand() < 0.6
              else answers[rng.randint(len(answers))]}
             for q, v in questions.items() if q != "q59"]
    for name, obj in (("q.json", questions), ("p.json", preds),
                      ("c.json", choices)):
        (tmp_path / name).write_text(json.dumps(obj))
    q, p, c = (str(tmp_path / n) for n in ("q.json", "p.json", "c.json"))
    for kw in (dict(), dict(choices_path=c, eval_consistency=True,
                            eval_head_tail=True)):
        ours = gqa_eval.GQAEval(p, q, **kw)
        ref = jax_gqa_eval.GQAEval(p, q, **kw)
        assert ours.scores == ref.scores
        assert ours.get_acc_result() == ref.get_acc_result()
        assert ours.get_str_result() == ref.get_str_result()

    # the OOD report over head/tail/all files, and the tail-size sweep
    ood = tmp_path / "ood"
    ood.mkdir()
    split = {"Tail": [k for k in questions if int(k[1:]) % 3 == 0],
             "Head": [k for k in questions if int(k[1:]) % 3 == 1],
             "All": list(questions)}
    for setup, keys in split.items():
        (ood / f"ood_testdev_{setup.lower()}.json").write_text(
            json.dumps({k: questions[k] for k in keys}))
    assert gqa_eval.ood_test_report(p, str(ood)) == \
        jax_gqa_eval.ood_test_report(p, str(ood))
    for alpha, keys in ((1.0, split["Tail"]), (0.4, split["Head"])):
        (ood / f"val_bal_tail_{alpha:.1f}.json").write_text(
            json.dumps({k: questions[k] for k in keys}))
    assert gqa_eval.tail_size_sweep(p, str(ood), (1.0, 0.4)) == \
        jax_gqa_eval.tail_size_sweep(p, str(ood), (1.0, 0.4))
