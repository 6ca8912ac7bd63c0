"""LXMERT pretraining trainer (counterpart of
`xggm_tpu/training/pretrainer.py::LxmertPretrainer`, for one card and one
process).

The same observable behaviour as the JAX trainer:
  * BertAdam with warmup 0.05 over t_total = batches // accum_steps x
    epochs, ONE update per batch (fine-tuning takes two), the gradients
    clipped to a global norm of 1.0 (`steps.apply_grads`);
  * with `accum_steps` > 1, the float32 gradients of that many consecutive
    microbatches are summed and their mean applied once, and a trailing
    partial group is dropped, as the last partial batch is;
  * batches come in the order of `RandomState(seed)`'s shuffle, featurized
    by the featurizer's own RandomState; validation is deterministic;
  * the epoch line (train loss and the six losses), the QA accuracy lines,
    `valid loss`, `BEST_EVAL_LOSS` when it improves and `Epoch{N:02d}`
    after each epoch; `log.log` gets the epoch lines.
The hidden and attention dropout of a microbatch draws from a seed made of
`cfg.train.seed` and the microbatch's index, so it differs from the JAX
package's draws.

`train` saves `PREEMPT` at the first update boundary after a SIGTERM and
raises `Preempted`; `resume` continues from it: the parameters, the BertAdam
state, the batch cursor and both host RandomStates (the epoch's shuffle as
of its start, the featurizer's as of the save).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.manager import CheckpointManager
from xggm_tpu_torch.config import XGGMConfig
from xggm_tpu_torch.data.pretrain_data import (
    LxmertPretrainEvaluator, PretrainFeaturizer)
from xggm_tpu_torch.models.pretrain_model import LOSSES_NAME, PretrainModel
from xggm_tpu_torch.ops.basic import DropoutRng, init_weights
from xggm_tpu_torch.training.bert_adam import BertAdam, BertAdamState
from xggm_tpu_torch.training.steps import TrainState, _grads, apply_grads
from xggm_tpu_torch.training.trainer import ITEM_7
from xggm_tpu_torch.utils.device import resolve_device
from xggm_tpu_torch.utils.guard import check_step_finite
from xggm_tpu_torch.utils.preempt import (
    Preempted, PreemptionGuard, pack_np_rng_state, unpack_np_rng_state)

CLIP = 1.0
WARMUP = 0.05

Batch = Dict[str, torch.Tensor]


class LxmertPretrainer:
    """Pretrains `PretrainModel` on `device` (the card unless the caller
    passes "cpu")."""

    def __init__(self, cfg: XGGMConfig, train_feat: PretrainFeaturizer,
                 valid_feat: Optional[PretrainFeaturizer] = None,
                 task_mask_lm: bool = True, task_matched: bool = True,
                 task_obj_predict: bool = True, task_qa: bool = True,
                 visual_losses: Sequence[str] = ("obj", "attr", "feat"),
                 mesh=None, device: Union[str, torch.device] = "cuda"):
        if mesh is not None:
            raise NotImplementedError(f"device meshes: {ITEM_7}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_feat = train_feat
        self.valid_feat = valid_feat
        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)

        self.answer_table = train_feat.ds.answer_table
        # the JAX trainer featurizes two examples to shape its init; the
        # same draws keep the featurizer's stream in step with its batches
        train_feat.featurize([0, 1])
        self.model = init_weights(
            PretrainModel(cfg.lxmert, train_feat.ds.num_answers,
                          task_mask_lm=task_mask_lm,
                          task_matched=task_matched,
                          task_obj_predict=task_obj_predict, task_qa=task_qa,
                          visual_losses=visual_losses, device=self.device),
            torch.Generator(device=self.device).manual_seed(cfg.train.seed))

        # the schedule ticks once per update, one per accum_steps batches
        self.accum = max(1, int(cfg.train.accum_steps))
        steps_per_epoch = (len(train_feat) // cfg.train.batch_size
                           // self.accum)
        self.t_total = int(steps_per_epoch * cfg.train.epochs)
        self.opt = BertAdam(lr=cfg.train.lr, warmup=WARMUP,
                            t_total=self.t_total,
                            weight_decay=cfg.train.weight_decay)
        self.state = TrainState.create(self.model, self.opt)
        self._acc: Optional[Dict[str, Optional[torch.Tensor]]] = None

        self.task_qa = task_qa
        self.train_evaluator = (LxmertPretrainEvaluator(train_feat.ds)
                                if task_qa else None)
        self.valid_evaluator = (
            LxmertPretrainEvaluator(valid_feat.ds)
            if task_qa and valid_feat is not None else None)

        self.ckpt = CheckpointManager(self.output)
        # installed by `train` when the caller has set none, so that making
        # a trainer never touches the process's signal handlers
        self.preempt: Optional[PreemptionGuard] = None
        self._resume_cursor: Optional[Dict[str, object]] = None

    # ------------------------------------------------------------------

    def put(self, batch: Dict[str, np.ndarray]) -> Batch:
        """A featurized batch on the model's device, integers as int64."""
        return {k: torch.from_numpy(v).to(
                    self.device,
                    torch.int64 if v.dtype.kind in "iu" else torch.float32)
                for k, v in batch.items()}

    def _step_seed(self, train_iter: int) -> int:
        """The dropout seed of microbatch `train_iter` of the run."""
        return self.cfg.train.seed * 2 ** 32 + train_iter

    def _losses(self, batch: Batch, seed: int):
        return self.model.compute_losses(batch,
                                         DropoutRng(seed, self.device))

    def train_step(self, batch: Batch, seed: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              torch.Tensor]:
        """One batch and one update: (total, losses, predicted answers)."""
        total, losses, ans_logits = self._losses(batch, seed)
        apply_grads(self.opt, self.state, _grads(total, self.state), CLIP)
        return total.detach(), _detached(losses), ans_logits.argmax(-1)

    def grad_step(self, batch: Batch, seed: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
        """One microbatch: its float32 gradients added to the accumulator,
        no update."""
        total, losses, ans_logits = self._losses(batch, seed)
        grads = _grads(total, self.state)
        if self._acc is None:
            self._acc = {n: None if g is None else g.float().clone()
                         for n, g in grads.items()}
        else:
            for n, g in grads.items():
                if g is not None:
                    self._acc[n].add_(g.float())
        return total.detach(), _detached(losses), ans_logits.argmax(-1)

    def apply_step(self) -> None:
        """The update from the mean of the accumulated gradients."""
        grads = {n: None if a is None else a / self.accum
                 for n, a in self._acc.items()}
        self._acc = None
        apply_grads(self.opt, self.state, grads, CLIP)

    @staticmethod
    def _batches(feat: PretrainFeaturizer, bs: int, shuffle: bool,
                 rng: np.random.RandomState, skip: int = 0):
        """The epoch's batches (the last partial one dropped); the first
        `skip` are not featurized, so that a resumed featurizer's
        RandomState stays where it was saved."""
        order = np.arange(len(feat))
        if shuffle:
            rng.shuffle(order)
        stop = (len(feat) // bs) * bs
        for j, s in enumerate(range(0, stop, bs)):
            if j < skip:
                continue
            yield feat.featurize(order[s: s + bs].tolist())

    def train(self, start_epoch: int = 0) -> float:
        """Pretrain from `start_epoch` (after the batches a `resume` found
        done); returns the best validation loss. A guard that `train`
        installs itself is uninstalled when it returns or raises."""
        cfg = self.cfg
        rng = np.random.RandomState(cfg.train.seed)
        bs = cfg.train.batch_size
        own_guard = self.preempt is None
        if own_guard:
            self.preempt = PreemptionGuard()
        cursor = self._resume_cursor or {}
        self._resume_cursor = None
        opt_steps = int(cursor.get("opt_steps", 0))
        train_iter = int(cursor.get("train_iter", 0))
        best_eval_loss = float(cursor.get("best", math.inf))
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                skip = int(cursor.get("skip", 0)) if epoch == start_epoch \
                    else 0
                if skip:
                    # the epoch's shuffle as of its start: the same order,
                    # past the batches already done
                    unpack_np_rng_state(rng, cursor["loop_rng0"])
                epoch_rng0 = pack_np_rng_state(rng)
                total_loss, sums = 0.0, {}
                uid2ans = {}  # on a resumed epoch: the batches left
                n, n_proc, micro = skip, 0, 0
                n_micro = len(self.train_feat) // bs
                n_micro -= n_micro % self.accum  # whole groups only
                for batch, uids in self._batches(self.train_feat, bs, True,
                                                 rng, skip=skip):
                    if n >= n_micro:
                        break  # a trailing partial group is dropped
                    batch = self.put(batch)
                    seed = self._step_seed(train_iter)
                    if self.accum == 1:
                        loss, losses, preds = self.train_step(batch, seed)
                    else:
                        loss, losses, preds = self.grad_step(batch, seed)
                        micro += 1
                        if micro == self.accum:
                            self.apply_step()
                            micro = 0
                    scalars = _host_scalars(loss, losses)
                    check_step_finite(n, "pretrain", scalars)
                    total_loss += scalars.pop("loss")
                    for k, v in scalars.items():
                        sums[k] = sums.get(k, 0.0) + v
                    if self.task_qa:
                        for uid, p in zip(uids, preds.tolist()):
                            uid2ans[uid] = self.answer_table.id2ans(int(p))
                    n += 1
                    n_proc += 1
                    train_iter += 1
                    # an update boundary is the only consistent state
                    if micro == 0:
                        opt_steps += 1
                        if self.preempt.should_save(opt_steps):
                            self.save_preempt(epoch, n, opt_steps,
                                              train_iter, best_eval_loss,
                                              epoch_rng0)
                            raise Preempted(
                                f"preempted at epoch {epoch} batch {n}; "
                                f"PREEMPT checkpoint committed to "
                                f"{self.output}")
                line = (f"Epoch {epoch}: train loss "
                        f"{total_loss / max(n_proc, 1):.4f} "
                        + " ".join(f"{k}: {sums[k] / max(n_proc, 1):.4f}"
                                   for k in LOSSES_NAME if k in sums))
                if self.train_evaluator is not None:
                    accu, dset_acc = self.train_evaluator.evaluate(uid2ans)
                    line += (f"\ntrain QA accuracy: {accu:.4f}"
                             + "".join(f" {d}: {a:.4f}"
                                       for d, a in sorted(dset_acc.items())))
                print(line)
                with open(os.path.join(self.output, "log.log"), "a") as f:
                    f.write(line + "\n")

                if self.valid_feat is not None:
                    eval_loss = self.evaluate_epoch()
                    if eval_loss < best_eval_loss:
                        best_eval_loss = eval_loss
                        self.save("BEST_EVAL_LOSS")
                self.save(f"Epoch{epoch + 1:02d}")
        finally:
            if own_guard:
                self.preempt.uninstall()
                self.preempt = None
        self.ckpt.wait()
        # a completed run: a PREEMPT cursor would be stale
        self.ckpt.remove("PREEMPT")
        return best_eval_loss

    @torch.no_grad()
    def evaluate_epoch(self) -> float:
        """The mean deterministic loss over the validation batches, printed
        with the QA accuracy."""
        bs = self.cfg.train.batch_size
        total, n = 0.0, 0
        uid2ans = {}
        for batch, uids in self._batches(self.valid_feat, bs, False,
                                         np.random.RandomState(0)):
            loss, _, ans_logits = self.model.compute_losses(self.put(batch))
            total += float(loss)
            if self.valid_evaluator is not None:
                for uid, p in zip(uids, ans_logits.argmax(-1).tolist()):
                    uid2ans[uid] = self.answer_table.id2ans(int(p))
            n += 1
        avg = total / max(n, 1)
        line = f"valid loss {avg:.4f}"
        if self.valid_evaluator is not None:
            accu, dset_acc = self.valid_evaluator.evaluate(uid2ans)
            line += (f"\nvalid QA accuracy: {accu:.4f}"
                     + "".join(f" {d}: {a:.4f}"
                               for d, a in sorted(dset_acc.items())))
        print(line)
        return avg

    # ------------------------------------------------------------------

    def save(self, name: str) -> None:
        self.ckpt.save(name, {"model": self.model.state_dict(),
                              "opt_state": self.state.opt_state.state_dict()})

    def _restore(self, restored: Dict[str, object], name: str) -> None:
        """The model and BertAdam state of a checkpoint of this format."""
        self.model.load_state_dict(restored["model"])
        opt_state = BertAdamState.from_state_dict(restored["opt_state"],
                                                  self.device)
        if opt_state.names != self.state.opt_state.names:
            raise ValueError(f"{name}: the optimizer state's parameters are "
                             "not this model's")
        self.state.opt_state = opt_state

    def load(self, name_or_path: str) -> None:
        """--load: the parameters and BertAdam state of a checkpoint by name
        from the output directory ('Epoch01', or a path ending in one)."""
        name = os.path.basename(name_or_path.rstrip("/"))
        self._restore(self.ckpt.load(name), name)

    def save_preempt(self, epoch: int, batches_done: int, opt_steps: int,
                     train_iter: int, best_eval_loss: float,
                     loop_rng0: np.ndarray) -> None:
        """Commit the loop's state mid-epoch as `PREEMPT`, and wait for the
        commit: the model, the BertAdam state, the batch cursor, the update
        and microbatch counts (the latter gives the dropout seeds), the best
        validation loss, the epoch's shuffle RandomState as of its start and
        the featurizer's as of now."""
        self.ckpt.save("PREEMPT", {
            "model": self.model.state_dict(),
            "opt_state": self.state.opt_state.state_dict(),
            "epoch": epoch, "batches_done": batches_done,
            "opt_steps": opt_steps, "train_iter": train_iter,
            "best_eval_loss": best_eval_loss,
            "loop_rng0": loop_rng0.tolist(),
            "feat_rng": pack_np_rng_state(self.train_feat.rng).tolist()})
        self.ckpt.wait()

    def resume(self) -> int:
        """Restore `PREEMPT` if the output directory has one; returns the
        epoch to continue (0 when there is nothing to resume). Epoch-level
        restarts use --load Epoch{N:02d}."""
        if not self.ckpt.exists("PREEMPT"):
            return 0
        restored = self.ckpt.load("PREEMPT")
        self._restore(restored, "PREEMPT")
        unpack_np_rng_state(self.train_feat.rng,
                            np.asarray(restored["feat_rng"], np.uint64))
        ep = int(restored["epoch"])
        self._resume_cursor = {
            "skip": int(restored["batches_done"]),
            "opt_steps": int(restored["opt_steps"]),
            "train_iter": int(restored["train_iter"]),
            "best": float(restored["best_eval_loss"]),
            "loop_rng0": np.asarray(restored["loop_rng0"], np.uint64)}
        print(f"resumed from PREEMPT (epoch {ep}, "
              f"{int(restored['batches_done'])} batches done)")
        return ep


def _detached(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in losses.items()}


def _host_scalars(loss: torch.Tensor,
                  losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's total ('loss') and named losses as host floats, in one
    transfer."""
    keys = ["loss", *losses]
    vals = torch.stack([loss, *losses.values()]).float().tolist()
    return dict(zip(keys, vals))
