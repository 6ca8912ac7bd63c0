"""Shared CLI argument parsing (counterpart of `xggm_tpu/cli/common.py`).

`build_parser` takes the JAX CLI's flags, so that its launch scripts parse.
The differences:
  * `--device` is `cuda` (the default) or `cpu`; without a card the CLI
    fails rather than run on the CPU;
  * `--pallas_attention` and `--prng` are accepted and have no effect: the
    port always runs its attention kernels, and its dropout masks come from
    the Philox generator of `ops/philox.py`;
  * a rank is one process driving one card, where a JAX process drives
    every device of its host: `--multiGPU` joins the world that torchrun's
    environment describes, or forms a world of one without it;
    `--coordinator H:P --num_hosts N --host_id I` joins a world of N ranks
    through a TCP rendezvous at H:P, N counting the ranks of every host,
    one per card (`make_mesh_if_requested`). A host must run as many ranks
    as it has visible cards. NCCL is the backend on the card, gloo on the
    CPU;
  * `--model_parallel N` and `--pp S` lay the world out as a (data, model,
    pipe) grid of ranks (`parallel/mesh.py::make_mesh`); `--pp` > 1 implies
    the stacked-layers layout and needs `--multiGPU`, as in JAX.
As in the JAX CLI, `--optim`, `--fast` and `--numWorkers` reach the config
and nothing reads them (the reference scripts pass `--optim bert`, the only
optimizer there is).

`load_weights` and `train_or_exit` are the load, resume and preemption arms
that the JAX CLIs repeat in each entry point.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import socket
import warnings
from typing import Optional

import numpy as np
import torch

from xggm_tpu_torch.config import (
    BertConfig, DataConfig, GGMConfig, LxmertConfig, MeshConfig, TrainConfig,
    VisualConfig, XGGMConfig)
from xggm_tpu_torch.parallel.distributed import (
    host_barrier, host_ranks, init_distributed, init_from_env,
    shutdown_distributed, torchrun_environment)
from xggm_tpu_torch.parallel.mesh import Mesh, make_mesh
from xggm_tpu_torch.parallel.pipeline_lxmert import clear_pipeline_mesh
from xggm_tpu_torch.utils.preempt import PREEMPTED_EXIT_CODE, Preempted


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
                   const=True, help="data parallelism: one rank per card in "
                                    "the world torchrun's environment "
                                    "describes, else a world of one")
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
                   help="ranks of each tensor-parallel model group (the "
                        "wide Dense layers split over them)")
    p.add_argument("--pp", dest="pp_stages", default=0, type=int,
                   help="pipeline stages: run the encoder's layer sequence "
                        "as a GPipe pipeline over this many ranks (implies "
                        "the stacked-layers layout; needs --multiGPU)")
    p.add_argument("--pp_microbatches", default=4, type=int,
                   help="microbatches per pipelined batch")
    # a dead flag of the reference scripts, accepted so that they parse
    p.add_argument("--eg", dest="edge_gnn", default=None)
    p.add_argument("--coordinator", default=None, type=str,
                   help="host:port of rank 0 for a multi-host run (with "
                        "--num_hosts and --host_id)")
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
                   help="recompute each encoder layer's activations in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="pretraining (cli.pretrain): one update on the mean "
                        "gradient of this many microbatches of --bs; the "
                        "task recipes do not read it")
    p.add_argument("--shard_opt_state", action="store_const", default=False,
                   const=True, help="ZeRO-1: BertAdam's m and v split over "
                                    "the data group (requires --multiGPU or "
                                    "--coordinator)")
    p.add_argument("--prng", default="rbg", choices=["rbg", "threefry2x32"],
                   help="no effect: dropout masks come from the Philox "
                        "generator of ops/philox.py")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh_if_requested(args: argparse.Namespace,
                           device: torch.device) -> Optional[Mesh]:
    """The (data, model, pipe) grid the flags ask for, this process joined
    to it, or None (counterpart of the JAX CLI's `make_mesh_if_requested`):
    `--coordinator H:P --num_hosts N --host_id I` joins N ranks at H:P;
    `--multiGPU` joins torchrun's world, or forms a world of one;
    `--model_parallel` and `--pp` set the grid's model and pipe groups. A
    rank on the card drives the card of its index among its host's ranks
    (`host_ranks`), and a host must run one rank per visible card: a host
    with more cards than ranks would leave cards idle, one with fewer would
    put two ranks on a card, and either raises ValueError. So do
    `--shard_opt_state` without a world, as in the JAX package, an
    incomplete multi-host triple, and `--pp` > 1 without `--multiGPU` or
    with `--coordinator` (JAX keeps pipeline stages on one host)."""
    hosts = (args.coordinator, args.num_hosts, args.host_id)
    pp = args.pp_stages
    if pp > 1:
        if any(x is not None for x in hosts):
            raise ValueError("--pp composes with --multiGPU single-host "
                             "worlds; multi-host pipeline stages are not "
                             "supported")
        if not args.multiGPU:
            raise ValueError("--pp requires --multiGPU (a device mesh)")
    if any(x is not None for x in hosts):
        if any(x is None for x in hosts):
            raise ValueError("--coordinator, --num_hosts and --host_id go "
                             "together")
        init_distributed(args.coordinator, args.num_hosts, args.host_id,
                         device=device)
    elif args.multiGPU:
        if torchrun_environment():
            init_from_env(device=device)
        else:
            init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                             device=device)
    else:
        if args.shard_opt_state:
            raise ValueError("shard_opt_state requires a device mesh "
                             "(--multiGPU or --coordinator)")
        return None
    if device.type == "cuda":
        index, on_host = host_ranks()
        cards = torch.cuda.device_count()
        if on_host != cards:
            shutdown_distributed()
            raise ValueError(
                f"{on_host} rank(s) on host {socket.gethostname()}, which "
                f"has {cards} visible card(s): run one rank per card "
                f"(torchrun --nproc_per_node {cards}, or as many "
                f"--coordinator ranks, --num_hosts counting them all), or "
                f"limit CUDA_VISIBLE_DEVICES to the cards to use")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    try:
        return make_mesh(args.model_parallel, device,
                         pipeline_parallel=max(1, pp))
    except ValueError:  # the world does not divide into the grid
        shutdown_distributed()
        raise


@contextlib.contextmanager
def mesh_if_requested(args: argparse.Namespace, device: torch.device):
    """`make_mesh_if_requested` for the body of a run; the process leaves
    the group when the body ends, however it ends."""
    mesh = make_mesh_if_requested(args, device)
    try:
        yield mesh
    finally:
        if mesh is not None:
            clear_pipeline_mesh()
            shutdown_distributed()


def to_config(args: argparse.Namespace, task: str) -> XGGMConfig:
    """The XGGMConfig of parsed flags."""
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
            remat=args.remat,
            # --pp implies the stacked [L, ...] layout the pipeline's stages
            # are cut from (checkpoints interchange with per-stage runs)
            stacked_layers=args.pp_stages > 1,
            pp_stages=args.pp_stages,
            pp_microbatches=args.pp_microbatches,
        ),
        ggm=GGMConfig(gnn=args.gnn, num_layers=args.num_layer,
                      sigma=args.sigma, delta=args.delta),
        train=TrainConfig(batch_size=args.batch_size, optim=args.optim,
                          lr=args.lr, epochs=args.epochs,
                          dropout=args.dropout, seed=args.seed,
                          clean_phase_first=clean_first,
                          rel_d_mult=rel_d_mult,
                          accum_steps=args.accum_steps,
                          shard_opt_state=args.shard_opt_state),
        data=DataConfig(train=args.train or "",
                        valid=args.valid or "",
                        test=args.test, tiny=args.tiny, fast=args.fast,
                        num_workers=args.num_workers,
                        data_root=args.data_root,
                        vocab_path=args.vocab),
        mesh=MeshConfig(model_parallel=args.model_parallel),
        output=args.output,
        tmode=args.tmode,
    )


def seed_everything(seed: int) -> None:
    """Seed the process-wide generators; the trainer draws from its own."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generate_synthetic_once(generate, data_root: str,
                            mesh: Optional[Mesh] = None) -> None:
    """Write the synthetic corpus under `data_root` once: rank 0 writes it
    and a completion mark, every rank waits at a barrier, and a rank that
    then sees no mark (a host with a filesystem of its own) writes its own
    seeded copy. Two ranks racing the same writes would corrupt them."""
    if mesh is None or mesh.world_size == 1:
        generate()
        return
    mark = os.path.join(data_root, ".synthetic_done")
    if mesh.primary:
        generate()
        with open(mark, "w") as f:
            f.write("ok\n")
    host_barrier("synthetic_corpus")
    if not mesh.primary and not os.path.exists(mark):
        generate()


def dump_args(args: argparse.Namespace, output: str,
              mesh: Optional[Mesh] = None) -> None:
    """The run's flags as {output}/args.json (rank 0 writes it)."""
    os.makedirs(output, exist_ok=True)
    if mesh is not None and not mesh.primary:
        return
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
