"""The port's preemption and resume (`utils/preempt.py`,
`XGGMTrainer.save_preempt` / `resume`, the CLIs' `--resume` and exit code
75) against the JAX package's host-level functions and semantics.

  * the guard: its flag, chaining to an earlier handler, SIGUSR1,
    `uninstall`; the packed `random.Random` and `np.random.RandomState`
    states equal to JAX's `pack_rng_state` / `pack_np_rng_state` on the
    same generator states, and unpacked back;
  * at `tiny_test_config()` on the CPU (dropout on, 2 epochs of 4
    batches), a run preempted after step 3 and resumed gives the same step
    records and parameters as the uninterrupted run, exactly;
  * a stale `PREEMPT` loses to a newer `BEST_{n}`;
  * `cli.vqacpv2.main` exits 75 on a real SIGTERM after its second step,
    then finishes under `--resume` with the uninterrupted run's parameters.

No JAX trainer, train step or model is built here.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import random
import signal
import sys
import time

import numpy as np
import pytest
import torch

from xggm_tpu.utils import preempt as jax_preempt
from xggm_tpu_torch.cli import common, vqacpv2
from xggm_tpu_torch.config import BertConfig, DataConfig, tiny_test_config
from xggm_tpu_torch.data.synthetic import make_synthetic_gqa, write_vocab
from xggm_tpu_torch.training.metrics import MetricsLogger
from xggm_tpu_torch.training.trainer import XGGMTrainer
from xggm_tpu_torch.utils.preempt import (
    PREEMPTED_EXIT_CODE, Preempted, PreemptionGuard, pack_np_rng_state,
    pack_rng_state, unpack_np_rng_state, unpack_rng_state)


@pytest.fixture(autouse=True, scope="module")
def quiet_module():
    """One torch thread (tiny shapes), and no TensorBoard: importing it
    takes seconds and it writes nothing the tests read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()
    torch.set_num_threads(threads)


class _StepGuard(PreemptionGuard):
    """A preemption notice at a fixed step, with no signal installed."""

    def __init__(self, at_step: int):
        super().__init__(install=False)
        self.at_step = at_step

    def should_save(self, step_id: int) -> bool:
        return step_id >= self.at_step


def _wait_for(cond):
    deadline = time.time() + 5
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def test_guard_and_packed_rng_states_match_jax():
    assert PREEMPTED_EXIT_CODE == jax_preempt.PREEMPTED_EXIT_CODE == 75
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    other = PreemptionGuard(install=False)
    try:
        assert not guard.signaled and not guard.should_save(1)
        os.kill(os.getpid(), signal.SIGUSR1)
        _wait_for(lambda: guard.signaled)
        # the earlier handler still runs; another guard's flag is its own
        assert guard.signaled and guard.should_save(2)
        assert seen == [signal.SIGUSR1] and not other.signaled
        other.notify()
        assert other.should_save(0)
    finally:
        guard.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is not guard._on_signal
        signal.signal(signal.SIGUSR1, prev)

    # random.Random, with and without a gauss carry
    for draws, gauss in ((13, False), (5, True)):
        rng = random.Random(7)
        [rng.randint(1, 10) for _ in range(draws)]
        if gauss:
            rng.gauss(0.0, 1.0)
        packed = pack_rng_state(rng)
        np.testing.assert_array_equal(packed, jax_preempt.pack_rng_state(rng))
        want = [rng.gauss(0, 1) for _ in range(3)] + [
            rng.randint(1, 10) for _ in range(20)]
        again = random.Random(0)
        unpack_rng_state(again, packed)
        assert [again.gauss(0, 1) for _ in range(3)] + [
            again.randint(1, 10) for _ in range(20)] == want
    # np.random.RandomState, with and without a cached gaussian
    for gauss in (False, True):
        rng = np.random.RandomState(11)
        rng.rand(17)
        if gauss:
            rng.randn()
        packed = pack_np_rng_state(rng)
        np.testing.assert_array_equal(packed,
                                      jax_preempt.pack_np_rng_state(rng))
        want = rng.randn(5)
        again = np.random.RandomState(0)
        unpack_np_rng_state(again, packed)
        np.testing.assert_array_equal(again.randn(5), want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gqa"))
    make_synthetic_gqa(root, "train", n_images=8, n_questions=32,
                       feat_dim=32, pack=True)
    make_synthetic_gqa(root, "val", n_images=4, n_questions=12, feat_dim=32,
                       seed=1, pack=True)
    write_vocab(os.path.join(root, "vocab.txt"))
    return root


def _trainer(root, out):
    """tiny_test_config at depth 1/1/1 in fp32, dropout 0.1, 2 epochs of 4
    batches of 8."""
    cfg = tiny_test_config()
    lx = cfg.lxmert
    cfg = cfg.replace(
        lxmert=lx.replace(visual=dataclasses.replace(
            lx.visual, l_layers=1, x_layers=1, r_layers=1)),
        train=dataclasses.replace(cfg.train, batch_size=8, epochs=2, seed=1),
        data=DataConfig(train="train", valid="val", data_root=root),
        output=out)
    with contextlib.redirect_stdout(io.StringIO()):
        return XGGMTrainer(cfg, use_xpack=True, device="cpu")


def _steps(out):
    """The step records of metrics.jsonl, without their times."""
    recs = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in recs if "branch" in r]


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_preempted_and_resumed_run_equals_uninterrupted(corpus, tmp_path):
    a = _trainer(corpus, str(tmp_path / "a"))
    a.preempt = PreemptionGuard(install=False)
    with contextlib.redirect_stdout(io.StringIO()):
        a.train()
    assert a.state.opt_state.count == 16  # 2 epochs x 4 batches x 2

    out = str(tmp_path / "b")
    b = _trainer(corpus, out)
    b.preempt = _StepGuard(at_step=3)
    with pytest.raises(Preempted, match="epoch 0 batch 3"):
        b.train()
    assert b.ckpt.exists("PREEMPT") and b.state.opt_state.count == 6
    saved = b.ckpt.load("PREEMPT")
    assert (saved["epoch"], saved["batches_done"], saved["train_iter"]) == \
        (0, 3, 3)

    c = _trainer(corpus, out)
    c.preempt = PreemptionGuard(install=False)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        start = c.resume()
        c.train(start)
    assert start == 0
    assert "resumed from PREEMPT (epoch 0, 3 batches done)" in \
        stdout.getvalue().splitlines()
    assert not c.ckpt.exists("PREEMPT")
    assert c.state.opt_state.count == 16
    assert _steps(out) == _steps(str(tmp_path / "a"))
    assert len(_steps(out)) == 8
    want = _params(a)
    for n, p in _params(c).items():
        assert torch.equal(p, want[n]), n
    assert c.state.opt_state.leaf_counts() == a.state.opt_state.leaf_counts()


def test_stale_preempt_loses_to_newer_best(corpus, tmp_path):
    out = str(tmp_path / "o")
    t = _trainer(corpus, out)
    t.preempt = _StepGuard(at_step=1)
    with pytest.raises(Preempted):
        t.train()
    t.save("BEST_1", epoch=1)  # a later, completed epoch
    t.ckpt.wait()
    fresh = _trainer(corpus, out)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert fresh.resume() == 2
    assert stdout.getvalue().splitlines() == ["resumed from BEST_1"]
    assert fresh._resume_cursor is None
    # a PREEMPT of a later epoch than the newest BEST_{n} wins
    t.save_preempt(epoch=2, batches_done=1, train_iter=9, best_valid=0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        assert fresh.resume() == 2
    assert fresh._resume_cursor == {"skip_batches": 1, "train_iter": 9,
                                    "best_valid": 0.5}


def test_cli_exits_75_on_sigterm_and_finishes_under_resume(tmp_path,
                                                           monkeypatch):
    """In-process, as a user's process would run it: a SIGTERM right after
    the second step, caught by the guard `train` installed."""
    monkeypatch.setattr(common, "BertConfig", functools.partial(
        BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=64))
    root = str(tmp_path / "data")
    base = ["--synthetic", "--xpack", "--device", "cpu", "--dtype",
            "float32", "--data_root", root, "--llayers", "1", "--xlayers",
            "1", "--rlayers", "1", "--bs", "32", "--epochs", "1", "--delta",
            "0", "--valid", ""]
    with contextlib.redirect_stdout(io.StringIO()):
        straight = vqacpv2.main(base + ["--output", str(tmp_path / "a")])

    log_step = MetricsLogger.log_step

    def sigterm_after_second_step(self, step, metrics, branch=""):
        log_step(self, step, metrics, branch)
        if step == 1:
            handler = signal.getsignal(signal.SIGTERM)
            # never kill the test process: the guard must be installed
            assert isinstance(getattr(handler, "__self__", None),
                              PreemptionGuard), handler
            os.kill(os.getpid(), signal.SIGTERM)
            _wait_for(lambda: handler.__self__.signaled)

    out = str(tmp_path / "b")
    before = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as mp:
        mp.setattr(MetricsLogger, "log_step", sigterm_after_second_step)
        with pytest.raises(SystemExit) as exit_info, \
                contextlib.redirect_stdout(io.StringIO()):
            vqacpv2.main(base + ["--output", out])
    assert exit_info.value.code == PREEMPTED_EXIT_CODE == 75
    # the guard is gone with the run
    assert signal.getsignal(signal.SIGTERM) is before
    assert os.path.isdir(os.path.join(out, "PREEMPT"))

    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        resumed = vqacpv2.main(base + ["--output", out, "--resume"])
    lines = stdout.getvalue().splitlines()
    assert "resumed from PREEMPT (epoch 0, 2 batches done)" in lines
    assert any(ln.startswith("Best valid: ") for ln in lines)
    assert not os.path.isdir(os.path.join(out, "PREEMPT"))
    assert _steps(out) == _steps(str(tmp_path / "a"))
    assert [r["branch"] for r in _steps(out)] == ["rep"] * 3
    want = _params(straight)
    for n, p in _params(resumed).items():
        assert torch.equal(p, want[n]), n
