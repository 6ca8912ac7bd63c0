"""LXMERT pretraining trainer (counterpart of
`xggm_tpu/training/pretrainer.py::LxmertPretrainer`).

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

With a `mesh` every rank draws the same global batch (one RandomState
stream on every rank) and builds only its `process_slice` of the rows
(`PretrainFeaturizer.featurize(rows=)`), as the JAX trainer feeds its
processes; a JAX process featurizes the whole global batch for every
device of its host, a rank its own rows for its one card. The masked-LM, matched and QA losses
divide by the global batch's count of labelled rows (summed over the
group), so that the ranks' averaged gradient is the global batch's; the
logged losses are the ranks' mean, the answers are gathered in rank order,
and rank 0 alone writes files. `accum_steps` and preemption behave as in a
single-rank run (one gradient all-reduce per update).

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
from xggm_tpu_torch.parallel.distributed import process_slice, to_host
from xggm_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_sum, maybe_zero_shard_state, mean_scalars)
from xggm_tpu_torch.parallel.pipeline import from_last_stage
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import (
    TrainState, apply_grads, fold_rank, loss_and_grads, on_last_stage,
    restore_snapshot, shadow_overlay, whole_snapshot)
from xggm_tpu_torch.training.trainer import split_wide_layers, use_pipeline
from xggm_tpu_torch.utils.device import resolve_device
from xggm_tpu_torch.utils.guard import check_step_finite
from xggm_tpu_torch.utils.preempt import (
    Preempted, PreemptionGuard, pack_np_rng_state, unpack_np_rng_state)

CLIP = 1.0
WARMUP = 0.05

Batch = Dict[str, torch.Tensor]


class LxmertPretrainer:
    """Pretrains `PretrainModel` on `device` (the card unless the caller
    passes "cpu"), or on the mesh's device as one rank of its data
    group."""

    def __init__(self, cfg: XGGMConfig, train_feat: PretrainFeaturizer,
                 valid_feat: Optional[PretrainFeaturizer] = None,
                 task_mask_lm: bool = True, task_matched: bool = True,
                 task_obj_predict: bool = True, task_qa: bool = True,
                 visual_losses: Sequence[str] = ("obj", "attr", "feat"),
                 mesh: Optional[Mesh] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.mesh = mesh
        self.primary = mesh is None or mesh.primary
        use_pipeline(cfg, mesh)
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
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
        split_wide_layers(self.model, mesh)

        # the schedule ticks once per update, one per accum_steps batches
        self.accum = max(1, int(cfg.train.accum_steps))
        steps_per_epoch = (len(train_feat) // cfg.train.batch_size
                           // self.accum)
        self.t_total = int(steps_per_epoch * cfg.train.epochs)
        self.opt = BertAdam(lr=cfg.train.lr, warmup=WARMUP,
                            t_total=self.t_total,
                            weight_decay=cfg.train.weight_decay)
        self.state, _ = maybe_zero_shard_state(
            TrainState.create(self.model, self.opt, mesh,
                              cfg.train.bf16_params),
            mesh, cfg.train.shard_opt_state)
        self._acc: Optional[Dict[str, Optional[torch.Tensor]]] = None

        self.task_qa = task_qa
        self.train_evaluator = (LxmertPretrainEvaluator(train_feat.ds)
                                if task_qa else None)
        self.valid_evaluator = (
            LxmertPretrainEvaluator(valid_feat.ds)
            if task_qa and valid_feat is not None else None)

        self.ckpt = CheckpointManager(self.output, mesh)
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
        """The dropout seed of microbatch `train_iter` of the run, on this
        rank."""
        return fold_rank(self.cfg.train.seed * 2 ** 32 + train_iter,
                         self.mesh)

    def _denominators(self, batch: Batch
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """In a group of more than one rank: the global batch's count of
        labelled rows of each cross-entropy loss (at least 1) over the
        group's size; None (the local counts) otherwise."""
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return None
        keys = {"Mask_LM": "lm_labels", "Matched": "matched_labels",
                "QA": "ans"}
        counts = torch.stack([(batch[k] != -1).sum() for k in keys.values()])
        counts = all_reduce_sum(counts, mesh).float().clamp_min(1.0)
        return dict(zip(keys, (counts / mesh.size).unbind()))

    def _losses(self, batch: Batch, seed: Optional[int]):
        """(total, losses, answer logits), None on a pipeline stage but the
        last; deterministic without a seed."""
        rng = None if seed is None else DropoutRng(seed, self.device)
        return on_last_stage(self.model.compute_losses, batch, rng,
                             self._denominators(batch))

    def _losses_and_grads(self, batch: Batch, seed: int):
        """`_losses` and the float32 gradients of its total, both from the
        bf16 shadow where the state carries one."""
        return loss_and_grads(self.state, self._losses, batch, seed)

    def train_step(self, batch: Batch, seed: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              torch.Tensor]:
        """One batch and one update: (total, losses, predicted answers)."""
        out, grads = self._losses_and_grads(batch, seed)
        apply_grads(self.opt, self.state, grads, CLIP)
        return self._global(out)

    def _global(self, out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                    torch.Tensor]:
        """(total, losses) averaged over the data group, and every rank's
        predicted answers in rank order (numpy), from `_losses`'s result
        (the last pipeline stage's)."""
        if out is not None:
            total, losses, ans_logits = out
            out = ({"loss": total.detach(), **_detached(losses)},
                   ans_logits.detach().argmax(-1))
        scalars, preds = from_last_stage(out, self.mesh)
        scalars = mean_scalars(scalars, self.mesh)
        return scalars.pop("loss"), scalars, to_host(preds, self.mesh)

    def grad_step(self, batch: Batch, seed: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
        """One microbatch: its float32 gradients (a shadowed leaf's the
        upcast of its bf16 gradient) added to the accumulator, no
        update."""
        out, grads = self._losses_and_grads(batch, seed)
        if self._acc is None:
            self._acc = {n: None if g is None else g.float().clone()
                         for n, g in grads.items()}
        else:
            for n, g in grads.items():
                if g is not None:
                    self._acc[n].add_(g.float())
        return self._global(out)

    def apply_step(self) -> None:
        """The update from the mean of the accumulated gradients."""
        grads = {n: None if a is None else a / self.accum
                 for n, a in self._acc.items()}
        self._acc = None
        apply_grads(self.opt, self.state, grads, CLIP)

    def _batches(self, feat: PretrainFeaturizer, bs: int, shuffle: bool,
                 rng: np.random.RandomState, skip: int = 0):
        """The epoch's batches (the last partial one dropped), this rank's
        rows of each, with every row's uids; the first `skip` are not
        featurized, so that a resumed featurizer's RandomState stays where
        it was saved."""
        order = np.arange(len(feat))
        if shuffle:
            rng.shuffle(order)
        mesh = self.mesh
        rows = (None if mesh is None or mesh.size == 1
                else process_slice(range(bs), mesh.rank, mesh.size))
        stop = (len(feat) // bs) * bs
        for j, s in enumerate(range(0, stop, bs)):
            if j < skip:
                continue
            yield feat.featurize(order[s: s + bs].tolist(), rows)

    def train(self, start_epoch: int = 0) -> float:
        """Pretrain from `start_epoch` (after the batches a `resume` found
        done); returns the best validation loss. A guard that `train`
        installs itself is uninstalled when it returns or raises."""
        cfg = self.cfg
        rng = np.random.RandomState(cfg.train.seed)
        bs = cfg.train.batch_size
        own_guard = self.preempt is None
        if own_guard:
            self.preempt = PreemptionGuard(mesh=self.mesh)
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
                if self.primary:
                    with open(os.path.join(self.output, "log.log"),
                              "a") as f:
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
        """The mean deterministic loss over the validation batches (from the
        bf16 shadow where the state carries one), printed with the QA
        accuracy."""
        bs = self.cfg.train.batch_size
        total, n = 0.0, 0
        uid2ans = {}
        for batch, uids in self._batches(self.valid_feat, bs, False,
                                         np.random.RandomState(0)):
            batch = self.put(batch)
            with shadow_overlay(self.state):
                out = self._losses(batch, None)
            loss, _, preds = self._global(out)
            total += float(loss)
            if self.valid_evaluator is not None:
                for uid, p in zip(uids, preds.tolist()):
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
        model, opt_state = whole_snapshot(self.model, self.state)
        self.ckpt.save(name, {"model": model, "opt_state": opt_state})

    def _restore(self, restored: Dict[str, object], name: str) -> None:
        """The model and BertAdam state of a checkpoint of this format,
        re-sliced for this rank's tensor-parallel and ZeRO-1 layout."""
        restore_snapshot(self.model, self.state, restored,
                         self.cfg.train.shard_opt_state, name)

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
        model, opt_state = whole_snapshot(self.model, self.state)
        self.ckpt.save("PREEMPT", {
            "model": model, "opt_state": opt_state,
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
