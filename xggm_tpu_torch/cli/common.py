"""Shared CLI argument parsing (counterpart of `xggm_tpu/cli/common.py`).

`build_parser` takes the JAX CLI's flags, so that its launch scripts parse.
The differences:
  * `--device` is `cuda` (the default) or `cpu`; without a card the CLI
    fails rather than run on the CPU;
  * `--pallas_attention` and `--prng` are accepted and have no effect: the
    port always runs its attention kernels, and its dropout masks come from
    the Philox generator of `ops/philox.py`;
  * the flags of paths not ported yet raise NotImplementedError, naming
    their ROADMAP.md item, when set (`reject_unported`).
As in the JAX CLI, `--optim`, `--fast` and `--numWorkers` reach the config
and nothing reads them (the reference scripts pass `--optim bert`, the only
optimizer there is).

`load_weights` and `train_or_exit` are the load, resume and preemption arms
that the JAX CLIs repeat in each entry point.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import warnings

import numpy as np
import torch

from xggm_tpu_torch.config import (
    BertConfig, DataConfig, GGMConfig, LxmertConfig, TrainConfig,
    VisualConfig, XGGMConfig)
from xggm_tpu_torch.utils.preempt import PREEMPTED_EXIT_CODE, Preempted

ITEM_7 = "ROADMAP.md section 1, item 7 (scale-out)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # data splits
    p.add_argument("--train", default="train")
    p.add_argument("--valid", default="val")
    p.add_argument("--test", default=None)
    # training hyperparameters
    p.add_argument("--bs", dest="batch_size", type=int, default=8)
    p.add_argument("--optim", default="bert")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=9595)
    p.add_argument("--fp16", action="store_const", default=False, const=True)
    # accepted and not read, as in the JAX CLI
    p.add_argument("--space", type=int, default=1, choices=[1, 9, 12])
    p.add_argument("--tf_writer", default=True,
                   type=lambda s: s in ("True", "true", "1", True))
    # debugging
    p.add_argument("--output", type=str, default="snap/debug")
    p.add_argument("--fast", action="store_const", default=False, const=True)
    p.add_argument("--tiny", action="store_const", default=False, const=True)
    p.add_argument("--tqdm", action="store_const", default=False, const=True)
    # model loading
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--loadLXMERT", dest="load_lxmert", type=str, default=None)
    p.add_argument("--loadLXMERTQA", dest="load_lxmert_qa", type=str,
                   default=None)
    p.add_argument("--fromScratch", dest="from_scratch",
                   action="store_const", default=False, const=True)
    p.add_argument("--mceLoss", dest="mce_loss", action="store_const",
                   default=False, const=True)
    # LXRT architecture
    p.add_argument("--llayers", default=9, type=int)
    p.add_argument("--xlayers", default=5, type=int)
    p.add_argument("--rlayers", default=5, type=int)
    # pretraining task switches
    p.add_argument("--taskMatched", dest="task_matched",
                   action="store_const", default=False, const=True)
    p.add_argument("--taskMaskLM", dest="task_mask_lm",
                   action="store_const", default=False, const=True)
    p.add_argument("--taskObjPredict", dest="task_obj_predict",
                   action="store_const", default=False, const=True)
    p.add_argument("--taskQA", dest="task_qa",
                   action="store_const", default=False, const=True)
    p.add_argument("--visualLosses", dest="visual_losses",
                   default="obj,attr,feat", type=str)
    p.add_argument("--qaSets", dest="qa_sets", default=None, type=str)
    p.add_argument("--wordMaskRate", dest="word_mask_rate", default=0.15,
                   type=float)
    p.add_argument("--objMaskRate", dest="obj_mask_rate", default=0.15,
                   type=float)
    # training configuration
    p.add_argument("--multiGPU", action="store_const", default=False,
                   const=True, help=f"not ported: {ITEM_7}")
    p.add_argument("--numWorkers", dest="num_workers", default=0, type=int)
    # OOD config
    p.add_argument("--tmode", default="OOD", type=str)
    p.add_argument("--gnn", default="GCN", type=str,
                   help="the graph generator: GCN, GIN or GAT (2 heads)")
    p.add_argument("--num_layer", default=2, type=int)
    p.add_argument("--sigma", default=1.0, type=float)
    p.add_argument("--delta", default=5, type=int)
    # additions of the JAX CLI
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--model_parallel", default=1, type=int,
                   help=f"1; tensor parallelism is not ported: {ITEM_7}")
    p.add_argument("--pp", dest="pp_stages", default=0, type=int,
                   help=f"not ported: {ITEM_7}")
    p.add_argument("--pp_microbatches", default=4, type=int)
    # a dead flag of the reference scripts, accepted so that they parse
    p.add_argument("--eg", dest="edge_gnn", default=None)
    p.add_argument("--coordinator", default=None, type=str,
                   help=f"not ported: {ITEM_7}")
    p.add_argument("--num_hosts", default=None, type=int)
    p.add_argument("--host_id", default=None, type=int)
    p.add_argument("--data_root", default="data", type=str)
    p.add_argument("--vocab", default=None, type=str,
                   help="WordPiece vocab.txt (default {data_root}/vocab.txt)")
    p.add_argument("--all_ans", default=None, type=str,
                   help="all_ans.json for answer-head surgery (default "
                        "{data_root}/lxmert/all_ans.json)")
    p.add_argument("--synthetic", action="store_const", default=False,
                   const=True, help="generate a synthetic corpus in place "
                                    "(runs without real data)")
    p.add_argument("--xpack", action="store_const", default=False, const=True,
                   help="read features through the packed loader "
                        "({split}_obj36.xpack beside the H5 files); with "
                        "--synthetic, write packs and no H5")
    p.add_argument("--profile", default=0, type=int,
                   help="a torch.profiler trace of the first N steps into "
                        "{output}/trace")
    p.add_argument("--resume", action="store_const", default=False,
                   const=True, help="resume from the newest checkpoint in "
                                    "--output: a mid-epoch PREEMPT (written "
                                    "on SIGTERM) or BEST_{epoch}")
    p.add_argument("--pallas_attention", action="store_const", default=False,
                   const=True, help="no effect: the port always runs its "
                                    "attention kernels")
    p.add_argument("--remat", action="store_const", default=False, const=True,
                   help=f"not ported: {ITEM_7}")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="pretraining (cli.pretrain): one update on the mean "
                        "gradient of this many microbatches of --bs; the "
                        "task recipes do not read it")
    p.add_argument("--shard_opt_state", action="store_const", default=False,
                   const=True, help=f"not ported: {ITEM_7}")
    p.add_argument("--prng", default="rbg", choices=["rbg", "threefry2x32"],
                   help="no effect: dropout masks come from the Philox "
                        "generator of ops/philox.py")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    return p


def reject_unported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError for a flag whose path is not ported."""
    unported = [
        ("--multiGPU", args.multiGPU, ITEM_7),
        ("--pp", args.pp_stages > 0, ITEM_7),
        ("--model_parallel", args.model_parallel != 1, ITEM_7),
        ("--shard_opt_state", args.shard_opt_state, ITEM_7),
        ("--remat", args.remat, ITEM_7),
        ("--coordinator/--num_hosts/--host_id",
         args.coordinator is not None or args.num_hosts is not None
         or args.host_id is not None, ITEM_7),
    ]
    for flag, is_set, item in unported:
        if is_set:
            raise NotImplementedError(f"{flag} is not ported yet: {item}")


def to_config(args: argparse.Namespace, task: str) -> XGGMConfig:
    """The XGGMConfig of parsed flags; raises for an unported flag."""
    reject_unported(args)
    clean_first = task == "vqa"  # VQA-CP runs the clean phase first
    rel_d_mult = 8.0 if task == "vqa" else 12.0
    # --fp16 is the reference's mixed-precision switch; bf16 compute is the
    # default here, so it matters only beside an explicit --dtype float32
    if args.fp16 and args.dtype == "float32":
        warnings.warn("--fp16 requested with --dtype float32: using bf16 "
                      "mixed precision")
        args.dtype = "bfloat16"
    return XGGMConfig(
        lxmert=LxmertConfig(
            bert=BertConfig(hidden_dropout_prob=args.dropout,
                            attention_probs_dropout_prob=args.dropout),
            visual=VisualConfig(l_layers=args.llayers, x_layers=args.xlayers,
                                r_layers=args.rlayers),
            dtype=args.dtype,
        ),
        ggm=GGMConfig(gnn=args.gnn, num_layers=args.num_layer,
                      sigma=args.sigma, delta=args.delta),
        train=TrainConfig(batch_size=args.batch_size, optim=args.optim,
                          lr=args.lr, epochs=args.epochs,
                          dropout=args.dropout, seed=args.seed,
                          clean_phase_first=clean_first,
                          rel_d_mult=rel_d_mult,
                          accum_steps=args.accum_steps),
        data=DataConfig(train=args.train or "",
                        valid=args.valid or "",
                        test=args.test, tiny=args.tiny, fast=args.fast,
                        num_workers=args.num_workers,
                        data_root=args.data_root,
                        vocab_path=args.vocab),
        output=args.output,
        tmode=args.tmode,
    )


def seed_everything(seed: int) -> None:
    """Seed the process-wide generators; the trainer draws from its own."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generate_synthetic_once(generate, data_root: str) -> None:
    """Write the synthetic corpus under `data_root`: one process writes it
    (the JAX CLI's multi-host coordination has no counterpart here)."""
    generate()


def dump_args(args: argparse.Namespace, output: str) -> None:
    """The run's flags as {output}/args.json."""
    os.makedirs(output, exist_ok=True)
    with open(os.path.join(output, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


def load_weights(trainer, args: argparse.Namespace) -> None:
    """The load flags, in the JAX CLIs' precedence: --load, else
    --loadLXMERT, else --loadLXMERTQA (its answer table from --all_ans,
    by default {data_root}/lxmert/all_ans.json). An empty value means
    "from scratch"."""
    if args.load:
        trainer.load(args.load)
    elif args.load_lxmert:
        trainer.load_lxmert(args.load_lxmert)
    elif args.load_lxmert_qa:
        all_ans = args.all_ans or os.path.join(args.data_root, "lxmert",
                                               "all_ans.json")
        trainer.load_lxmert_qa(args.load_lxmert_qa, all_ans)


def train_or_exit(trainer, resume: bool) -> float:
    """`trainer.train` from the epoch `resume` finds (0 without
    --resume); on a preemption, exit with PREEMPTED_EXIT_CODE once the
    PREEMPT checkpoint is on disk."""
    start_epoch = trainer.resume() if resume else 0
    try:
        return trainer.train(start_epoch)
    except Preempted as e:
        print(e)
        raise SystemExit(PREEMPTED_EXIT_CODE)
