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
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from xggm_tpu_torch.checkpoint.manager import CheckpointManager
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

ITEM_2 = "ROADMAP.md section 1, item 2 (checkpoints, resume and loaders)"
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

    def load_lxmert(self, path: str) -> None:
        raise NotImplementedError(f"--loadLXMERT: {ITEM_2}")

    def load_lxmert_qa(self, path: str, all_ans_path: str) -> None:
        raise NotImplementedError(f"--loadLXMERTQA: {ITEM_2}")

    def load(self, name_or_path: str) -> None:
        """--load: a checkpoint of this trainer's format, by name, from the
        output directory ('BEST', 'BEST_3', or a path ending in one)."""
        if name_or_path.endswith(".pth") or os.path.isfile(name_or_path):
            raise NotImplementedError(f"loading a torch .pth: {ITEM_2}")
        restored = self.ckpt.load(os.path.basename(name_or_path))
        self.model.load_state_dict(restored["model"])
        opt_state = BertAdamState.from_state_dict(restored["opt_state"],
                                                  self.device)
        if opt_state.names != self.state.opt_state.names:
            raise ValueError(f"{name_or_path}: the optimizer state's "
                             "parameters are not this model's")
        self.state.opt_state = opt_state

    def save(self, name: str, epoch: int = -1) -> None:
        self.ckpt.save(name, {"model": self.model.state_dict(),
                              "opt_state": self.state.opt_state.state_dict(),
                              "epoch": epoch})

    def save_preempt(self, epoch: int, batches_done: int, train_iter: int,
                     best_valid: float) -> None:
        raise NotImplementedError(f"PREEMPT checkpoints: {ITEM_2}")

    def resume(self) -> int:
        raise NotImplementedError(f"--resume: {ITEM_2}")

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
        and the clean phase. Returns the best validation accuracy."""
        cfg = self.cfg
        feeder = self._feeder(self.train_set, cfg.train.batch_size, True)
        n_batches = len(feeder)
        val_points = set(np.linspace(0, n_batches, 5, dtype=int)[1:-1].tolist())
        prof = self._start_trace()
        best_valid, train_iter = 0.0, 0
        feeder.set_position(start_epoch)
        for epoch in range(start_epoch, cfg.train.epochs):
            quesid2ans: Dict[object, str] = {}
            t_epoch = time.time()
            for i, (qids, batch, _mask) in enumerate(feeder):
                use_relation = self.host_rng.randint(1, 10) <= cfg.ggm.delta
                step = self.rel_step if use_relation else self.rep_step
                self.state, metrics = step(self.state, batch,
                                           self._step_seed(train_iter))
                scalars = self._record(qids, metrics, quesid2ans)
                branch_name = "rel" if use_relation else "rep"
                check_step_finite(train_iter, branch_name, scalars)
                self.logger.log_step(train_iter, scalars, branch=branch_name)
                train_iter += 1
                if prof is not None and train_iter >= self.profile_steps:
                    self._stop_trace(prof)
                    prof = None

                if i in val_points and self.valid_set is not None:
                    acc = self.evaluate_valid()
                    self.logger.log_scalar("valid/mid_epoch_acc", acc,
                                           train_iter)
                    if acc > best_valid:
                        best_valid = acc
                        self.save("BEST")
            best_valid = self._end_epoch(epoch, quesid2ans, best_valid,
                                         t_epoch)
        if prof is not None:  # a run shorter than profile_steps
            self._stop_trace(prof)
        self.ckpt.wait()
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
