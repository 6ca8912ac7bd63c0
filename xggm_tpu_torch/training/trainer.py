"""Task trainer (counterpart of `xggm_tpu/training/trainer.py::XGGMTrainer`,
for one card and one process).

The same observable behaviour as the JAX trainer:
  * the branch of each batch is drawn on the host, `randint(1, 10) <= delta`
    from `random.Random(seed)`, and nothing else draws from that generator;
  * batches come from the feeder in the same shuffled order
    (`RandomState(seed + epoch)`, the last partial batch dropped);
  * two optimizer updates per batch, t_total = t_total_mult x batches x
    epochs, the encoder at 1 / downstream_lr_mult of the rest's lr;
  * three validations inside each epoch, after the batches at
    linspace(0, n, 5)[1:-1], and one at its end; 'BEST' on an improvement,
    'BEST' and 'BEST_{epoch}' at the end of an epoch; `log.log` lines and
    `metrics.jsonl` records in the same format.
The dropout and noise of a step come from a seed made of `cfg.train.seed`
and the step's index, so they differ from the JAX package's draws.

`train` saves a `PREEMPT` checkpoint at the first step boundary after a
SIGTERM and raises `Preempted`; `resume` continues from it, or from the
newest `BEST_{epoch}`. The loaders read the reference's torch snapshots
(`load_lxmert`, `load_lxmert_qa`, `load` of a `.pth`).
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.answer_table import load_lxmert_qa
from xggm_tpu_torch.checkpoint.manager import CheckpointManager
from xggm_tpu_torch.checkpoint.torch_bridge import (
    convert_lxrt_bert, convert_task_model, load_torch_state_dict, merge_into,
    strip_prefixes)
from xggm_tpu_torch.config import MAX_SEQ_LENGTH, XGGMConfig
from xggm_tpu_torch.data.datasets import (
    GQADataset, GQAEvaluator, GraphBatchDataset, VQACPDataset, VQAEvaluator,
    oracle_score)
from xggm_tpu_torch.data.feeder import Feeder
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.training.bert_adam import (
    BertAdam, BertAdamState, lr_scale_tree)
from xggm_tpu_torch.training.metrics import MetricsLogger
from xggm_tpu_torch.training.steps import (
    TrainState, make_clean_train_step, make_eval_step, make_ggm_train_step)
from xggm_tpu_torch.utils.device import resolve_device
from xggm_tpu_torch.utils.guard import check_step_finite
from xggm_tpu_torch.utils.preempt import (
    Preempted, PreemptionGuard, pack_rng_state, unpack_rng_state)

ITEM_7 = "ROADMAP.md section 1, item 7 (scale-out)"


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The scalar metrics of a step as host floats, in one transfer."""
    keys = [k for k, v in metrics.items() if v.dim() == 0]
    if not keys:
        return {}
    vals = torch.stack([metrics[k].float() for k in keys]).tolist()
    return dict(zip(keys, vals))


class XGGMTrainer:
    """Trains, predicts and evaluates one task ('gqa' or 'vqa') on `device`
    (the card unless the caller passes "cpu")."""

    def __init__(self, cfg: XGGMConfig, task: str = "gqa",
                 tokenizer: Optional[BertTokenizer] = None, mesh=None,
                 use_xpack: bool = False, profile_steps: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if task not in ("gqa", "vqa"):
            raise ValueError(f"unknown task {task!r}")
        if mesh is not None:
            raise NotImplementedError(f"device meshes: {ITEM_7}")
        self.device = resolve_device(device)
        self.use_xpack = use_xpack
        self.profile_steps = profile_steps
        self.task = task
        # bf16 compute: ship the features in bf16 (half the bytes to copy;
        # the model casts them on entry anyway)
        self._feats_dtype = (torch.bfloat16
                             if cfg.lxmert.compute_dtype == torch.bfloat16
                             else None)
        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)

        vocab = cfg.data.vocab_path or os.path.join(cfg.data.data_root,
                                                    "vocab.txt")
        self.tokenizer = tokenizer or BertTokenizer.from_file(vocab)
        ds_cls = GQADataset if task == "gqa" else VQACPDataset
        self.ev_cls = GQAEvaluator if task == "gqa" else VQAEvaluator

        def make_set(split):
            raw = ds_cls(split, cfg.data)
            store = self._maybe_xpack_store(raw) if use_xpack else None
            return raw, GraphBatchDataset(raw, self.tokenizer,
                                          MAX_SEQ_LENGTH, store=store)

        self.train_set = None
        num_answers = None
        raw = None
        if cfg.data.train:
            raw, self.train_set = make_set(cfg.data.train)
            self.train_evaluator = self.ev_cls(raw)
            num_answers = raw.num_answers
        self.valid_set = None
        if cfg.data.valid:
            raw, self.valid_set = make_set(cfg.data.valid)
            self.valid_evaluator = self.ev_cls(raw)
            if num_answers is None:  # the vocabulary of any split present
                num_answers = raw.num_answers
        if num_answers is None:
            num_answers = cfg.num_answers
        self.label2ans = raw.label2ans if raw is not None else None
        self.num_answers = num_answers
        self.cfg = cfg = cfg.replace(num_answers=num_answers)

        self.model = init_weights(
            XGGMModel(cfg.lxmert, num_answers, cfg.ggm, device=self.device),
            torch.Generator(device=self.device).manual_seed(cfg.train.seed))

        # downstream parameters at mult x lr, the encoder at lr;
        # t_total = t_total_mult x batches x epochs
        if self.train_set is not None:
            steps_per_epoch = len(self.train_set) // cfg.train.batch_size
            t_total = int(cfg.train.t_total_mult * steps_per_epoch
                          * cfg.train.epochs)
        else:
            t_total = -1
        mult = cfg.train.downstream_lr_mult
        self.opt = BertAdam(
            lr=mult * cfg.train.lr, warmup=cfg.train.warmup, t_total=t_total,
            weight_decay=cfg.train.weight_decay,
            lr_scale=lr_scale_tree(
                (n for n, _ in self.model.named_parameters()),
                lambda n: not n.startswith("lxrt."), 1.0, 1.0 / mult))
        self.state = TrainState.create(self.model, self.opt)

        self.rel_step = make_ggm_train_step(self.model, self.opt, cfg.train,
                                            "relation")
        self.rep_step = make_ggm_train_step(self.model, self.opt, cfg.train,
                                            "representation")
        self.clean_step = make_clean_train_step(self.model, self.opt,
                                                cfg.train, num_answers)
        self.eval_step = make_eval_step(self.model)

        self.ckpt = CheckpointManager(self.output)
        self.logger = MetricsLogger(self.output)
        self.host_rng = random.Random(cfg.train.seed)
        # installed by `train` when the caller has set none, so that making
        # a trainer never touches the process's signal handlers
        self.preempt: Optional[PreemptionGuard] = None
        self._resume_cursor: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------------

    @staticmethod
    def _maybe_xpack_store(raw):
        """The pack store when a {split}_obj36.xpack lies beside the H5
        files; None (the H5 store) otherwise."""
        sub = "gqa_imgfeat" if isinstance(raw, GQADataset) else "mscoco_imgfeat"
        pack = os.path.join(raw.cfg.data_root, sub,
                            f"{raw.splits[0]}_obj36.xpack")
        if os.path.exists(pack):
            from xggm_tpu_torch.data.xpack import XPackFeatureStore

            store = XPackFeatureStore(pack)
            gather = "native" if store.pack.native else "memmap"
            print(f"using xpack store ({gather} gather): {pack}")
            return store
        return None

    def _feeder(self, dataset: GraphBatchDataset, batch_size: int,
                train: bool) -> Feeder:
        return Feeder(dataset, batch_size, shuffle=train, drop_last=train,
                      seed=self.cfg.train.seed,
                      prefetch_depth=self.cfg.data.prefetch_depth,
                      feats_dtype=self._feats_dtype, device=self.device)

    def _step_seed(self, train_iter: int) -> int:
        """The seed of step `train_iter`'s dropout and noise."""
        return self.cfg.train.seed * 2 ** 32 + train_iter

    def _fresh_opt_state(self) -> None:
        """A new BertAdam state for the parameters as they are now."""
        self.state = TrainState.create(self.model, self.opt)

    def _restore(self, restored: Dict[str, object], name: str) -> None:
        """The model and BertAdam state of a checkpoint of this format."""
        self.model.load_state_dict(restored["model"])
        opt_state = BertAdamState.from_state_dict(restored["opt_state"],
                                                  self.device)
        if opt_state.names != self.state.opt_state.names:
            raise ValueError(f"{name}: the optimizer state's parameters are "
                             "not this model's")
        self.state.opt_state = opt_state

    def load_lxmert(self, path: str) -> None:
        """--loadLXMERT: the encoder of a torch LXMERT snapshot
        (`{path}_LXRT.pth`, or `path` if it ends in .pth)."""
        sd = strip_prefixes(load_torch_state_dict(
            path if path.endswith(".pth") else f"{path}_LXRT.pth"))
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        flat, _ = convert_lxrt_bert(sd, self.cfg.lxmert, torch_prefix=prefix,
                                    our_prefix="lxrt")
        unmatched = merge_into(self.model, flat)
        self._fresh_opt_state()
        print(f"load_lxmert: {len(flat)} tensors, "
              f"{len(unmatched)} model params untouched")

    def load_lxmert_qa(self, path: str, all_ans_path: str) -> None:
        """--loadLXMERTQA: the encoder and the answer head of a torch LXMERT
        pretraining snapshot, the head's rows matched by answer string."""
        load_lxmert_qa(path, self.model, self.label2ans, self.cfg.lxmert,
                       all_ans_path)
        self._fresh_opt_state()

    def load(self, name_or_path: str) -> None:
        """--load: a reference torch task model (a .pth file), or a
        checkpoint of this trainer's format by name from the output
        directory ('BEST', 'BEST_3', or a path ending in one)."""
        if name_or_path.endswith(".pth") or os.path.isfile(name_or_path):
            flat = convert_task_model(load_torch_state_dict(name_or_path),
                                      self.cfg.lxmert, self.cfg.ggm.gnn,
                                      self.cfg.ggm.num_layers,
                                      self.cfg.ggm.gat_heads)
            unmatched = merge_into(self.model, flat)
            self._fresh_opt_state()
            print(f"load(torch): {len(flat)} tensors, "
                  f"{len(unmatched)} untouched")
            return
        name = os.path.basename(name_or_path)
        self._restore(self.ckpt.load(name), name_or_path)

    def save(self, name: str, epoch: int = -1) -> None:
        self.ckpt.save(name, {"model": self.model.state_dict(),
                              "opt_state": self.state.opt_state.state_dict(),
                              "epoch": epoch})

    def save_preempt(self, epoch: int, batches_done: int, train_iter: int,
                     best_valid: float) -> None:
        """Commit the loop's state mid-epoch as `PREEMPT`, and wait for the
        commit (the grace window after a SIGTERM is short): the model, the
        BertAdam state, the epoch and batch cursor, the step count, the best
        validation so far and the host's branch generator. No device
        generator is saved: a step's dropout and noise come from
        `_step_seed(train_iter)`, so the restored step count restores
        their stream."""
        self.ckpt.save("PREEMPT", {
            "model": self.model.state_dict(),
            "opt_state": self.state.opt_state.state_dict(),
            "epoch": epoch, "batches_done": batches_done,
            "train_iter": train_iter, "best_valid": best_valid,
            "host_rng": pack_rng_state(self.host_rng).tolist()})
        self.ckpt.wait()

    def resume(self) -> int:
        """Restore the newest checkpoint in the output directory; returns
        the epoch to start from (0 when there is none). `PREEMPT` wins when
        its epoch is later than the newest `BEST_{n}`'s: `train` then goes
        on with that epoch after its saved batches, with the saved host
        generator and step count. Otherwise `BEST_{n}` is restored and
        training starts at epoch n + 1."""
        last = self.ckpt.latest_epoch()
        if self.ckpt.exists("PREEMPT"):
            restored = self.ckpt.load("PREEMPT")
            ep = int(restored["epoch"])
            if last is None or ep > last:
                self._restore(restored, "PREEMPT")
                unpack_rng_state(self.host_rng, restored["host_rng"])
                self._resume_cursor = {
                    "skip_batches": int(restored["batches_done"]),
                    "train_iter": int(restored["train_iter"]),
                    "best_valid": float(restored["best_valid"])}
                print(f"resumed from PREEMPT (epoch {ep}, "
                      f"{int(restored['batches_done'])} batches done)")
                return ep
        if last is None:
            return 0
        self._restore(self.ckpt.load(f"BEST_{last}"), f"BEST_{last}")
        print(f"resumed from BEST_{last}")
        return last + 1

    # ------------------------------------------------------------------

    def _start_trace(self):
        if not self.profile_steps:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_trace(self, prof) -> None:
        prof.stop()
        trace = os.path.join(self.output, "trace")
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, "trace.json"))

    def _record(self, qids, metrics, quesid2ans: Dict[object, str]
                ) -> Dict[str, float]:
        """Note the step's predictions; return its scalar metrics."""
        preds = metrics["preds"].cpu()[: len(qids)].tolist()
        for qid, p in zip(qids, preds):
            quesid2ans[qid] = self.label2ans[int(p)]
        return host_metrics(metrics)

    def _end_epoch(self, epoch: int, quesid2ans, best_valid: float,
                   t_epoch: Optional[float]) -> float:
        """Score the epoch, validate and save; append its log.log line.
        Returns the best validation accuracy so far."""
        train_acc = self.train_evaluator.evaluate(quesid2ans) \
            if quesid2ans else 0.0
        log_line = f"Epoch {epoch}: Train {train_acc * 100.:.2f}"
        if self.valid_set is not None:
            acc = self.evaluate_valid()
            if acc > best_valid:
                best_valid = acc
                self.save("BEST", epoch)
            self.save(f"BEST_{epoch}", epoch)
            log_line += (f", Valid {acc * 100.:.2f}"
                         f", Best {best_valid * 100.:.2f}")
        if t_epoch is not None:
            log_line += f" ({time.time() - t_epoch:.1f}s)"
        print(log_line)
        with open(os.path.join(self.output, "log.log"), "a") as f:
            f.write(log_line + "\n")
        return best_valid

    def train(self, start_epoch: int = 0) -> float:
        """GGM training: per batch one branch (relation or representation)
        and the clean phase. Returns the best validation accuracy.

        Starts at `start_epoch`, after the batches a `resume` from `PREEMPT`
        found done. At the first step boundary after the guard's signal it
        saves `PREEMPT` and raises `Preempted`; a run that completes removes
        `PREEMPT`. A guard that `train` installs itself is uninstalled when
        it returns or raises."""
        cfg = self.cfg
        feeder = self._feeder(self.train_set, cfg.train.batch_size, True)
        n_batches = len(feeder)
        val_points = set(np.linspace(0, n_batches, 5, dtype=int)[1:-1].tolist())
        own_guard = self.preempt is None
        if own_guard:
            self.preempt = PreemptionGuard()
        cursor = self._resume_cursor or {}
        self._resume_cursor = None
        start_batch = int(cursor.get("skip_batches", 0))
        best_valid = cursor.get("best_valid", 0.0)
        train_iter = int(cursor.get("train_iter", 0))
        # the shuffle of the resumed epoch, past the batches already done
        feeder.set_position(start_epoch, start_batch)
        prof = self._start_trace()
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                # after a resume from PREEMPT the epoch's train accuracy
                # covers the batches left
                quesid2ans: Dict[object, str] = {}
                t_epoch = time.time()
                offset = start_batch if epoch == start_epoch else 0
                for i, (qids, batch, _mask) in enumerate(feeder,
                                                         start=offset):
                    use_relation = (self.host_rng.randint(1, 10)
                                    <= cfg.ggm.delta)
                    step = self.rel_step if use_relation else self.rep_step
                    self.state, metrics = step(self.state, batch,
                                               self._step_seed(train_iter))
                    scalars = self._record(qids, metrics, quesid2ans)
                    branch_name = "rel" if use_relation else "rep"
                    check_step_finite(train_iter, branch_name, scalars)
                    self.logger.log_step(train_iter, scalars,
                                         branch=branch_name)
                    train_iter += 1
                    if prof is not None and train_iter >= self.profile_steps:
                        self._stop_trace(prof)
                        prof = None

                    if self.preempt.should_save(train_iter):
                        self.save_preempt(epoch, i + 1, train_iter,
                                          best_valid)
                        raise Preempted(
                            f"preempted at epoch {epoch} batch {i + 1}; "
                            f"PREEMPT checkpoint committed to {self.output}")

                    if i in val_points and self.valid_set is not None:
                        acc = self.evaluate_valid()
                        self.logger.log_scalar("valid/mid_epoch_acc", acc,
                                               train_iter)
                        if acc > best_valid:
                            best_valid = acc
                            self.save("BEST")
                best_valid = self._end_epoch(epoch, quesid2ans, best_valid,
                                             t_epoch)
        finally:
            if prof is not None:  # a run shorter than profile_steps
                self._stop_trace(prof)
            if own_guard:
                self.preempt.uninstall()
                self.preempt = None
        self.ckpt.wait()
        # a completed run: a PREEMPT cursor would be stale
        self.ckpt.remove("PREEMPT")
        return best_valid

    def train_baseline(self) -> float:
        """Plain-BCE training: one clean step per batch, no GGM phase."""
        cfg = self.cfg
        feeder = self._feeder(self.train_set, cfg.train.batch_size, True)
        best_valid, train_iter = 0.0, 0
        for epoch in range(cfg.train.epochs):
            quesid2ans: Dict[object, str] = {}
            for qids, batch, _mask in feeder:
                self.state, metrics = self.clean_step(
                    self.state, batch, self._step_seed(train_iter))
                scalars = self._record(qids, metrics, quesid2ans)
                check_step_finite(train_iter, "clean", scalars)
                self.logger.log_step(train_iter, scalars, branch="clean")
                train_iter += 1
            best_valid = self._end_epoch(epoch, quesid2ans, best_valid, None)
        self.ckpt.wait()
        return best_valid

    def predict(self, dataset: GraphBatchDataset,
                dump_path: Optional[str] = None) -> Dict[object, str]:
        """Answers without gradients (encoder and head), in batches of
        max(batch_size, 64), the padding rows dropped."""
        feeder = self._feeder(dataset, max(self.cfg.train.batch_size, 64),
                              False)
        quesid2ans: Dict[object, str] = {}
        for qids, batch, mask in feeder:
            preds = self.eval_step(batch).cpu()
            # the feeder pads trailing rows; preds[:len(qids)] relies on that
            assert bool(np.all(mask[: len(qids)])) and not np.any(
                mask[len(qids):]), "feeder mask must be trailing padding"
            for qid, p in zip(qids, preds[: len(qids)].tolist()):
                quesid2ans[qid] = self.label2ans[int(p)]
        if dump_path:
            self.ev_cls.dump_result(quesid2ans, dump_path)
        return quesid2ans

    def evaluate_valid(self) -> float:
        return self.valid_evaluator.evaluate(self.predict(self.valid_set))

    def oracle_score(self) -> float:
        return oracle_score(self.train_set)
