"""GQA-OOD entry point (counterpart of `xggm_tpu/cli/gqa_ood.py`): train,
or with --test SPLIT predict and score a split.

    python -m xggm_tpu_torch.cli.gqa_ood --synthetic --xpack \
        --data_root data --output snap/gqa --bs 96 --epochs 1 --lr 5e-6
    python -m xggm_tpu_torch.cli.gqa_ood --xpack --data_root data \
        --output snap/gqa --test val --load snap/gqa/BEST

It runs on the card unless `--device cpu` is given, and raises when there
is none. `--load NAME` reads the checkpoint NAME (a path's last part) from
`--output`, or a reference task model from a `.pth` file; `--loadLXMERT`
and `--loadLXMERTQA` read an LXMERT snapshot. `--resume` continues from
`PREEMPT` or the newest `BEST_{epoch}`; a SIGTERM during training saves
`PREEMPT` and exits with code 75. On several cards:

    torchrun --nproc_per_node 8 -m xggm_tpu_torch.cli.gqa_ood --multiGPU \
        [--shard_opt_state] ...    # --bs stays the global batch
    python -m xggm_tpu_torch.cli.gqa_ood --coordinator HOST:PORT \
        --num_hosts N --host_id I ...   # one process per host
"""
from __future__ import annotations

import dataclasses
import os

from xggm_tpu_torch.cli.common import (
    build_parser, dump_args, generate_synthetic_once, load_weights,
    mesh_if_requested, seed_everything, to_config, train_or_exit)
from xggm_tpu_torch.utils.device import resolve_device


def main(argv=None):
    """Run the CLI on `argv`; returns the trainer."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)
    cfg = to_config(args, task="gqa")
    with mesh_if_requested(args, device) as mesh:
        return _run(args, cfg, device, mesh)


def _run(args, cfg, device, mesh):
    if args.synthetic:
        from xggm_tpu_torch.data.synthetic import make_synthetic_gqa, write_vocab

        def _gen():
            splits = {args.train, args.valid, args.test} - {None, ""}
            for i, split in enumerate(sorted(splits)):
                make_synthetic_gqa(args.data_root, split, seed=i,
                                   pack=args.xpack)
            write_vocab(os.path.join(args.data_root, "vocab.txt"))
        generate_synthetic_once(_gen, args.data_root, mesh)

    from xggm_tpu_torch.data.datasets import (
        GQADataset, GQAEvaluator, GraphBatchDataset)
    from xggm_tpu_torch.training.trainer import XGGMTrainer

    if args.test is not None:
        # the test arm reads the whole split
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, tiny=False, fast=False))

    trainer = XGGMTrainer(cfg, task="gqa", mesh=mesh, use_xpack=args.xpack,
                          profile_steps=args.profile, device=device)
    dump_args(args, args.output, mesh)

    load_weights(trainer, args)

    if args.test is not None:
        ds_raw = GQADataset(args.test, cfg.data)
        store = trainer._maybe_xpack_store(ds_raw) if args.xpack else None
        dataset = GraphBatchDataset(ds_raw, trainer.tokenizer, store=store)
        dump = os.path.join(args.output, f"{args.test}_predict.json")
        quesid2ans = trainer.predict(dataset, dump_path=dump)
        if dataset.has_targets:
            acc = GQAEvaluator(ds_raw).evaluate(quesid2ans)
            print(f"{args.test} accuracy: {acc * 100.:.2f}")
    else:
        print(f"Oracle score: {trainer.oracle_score() * 100.:.2f}")
        best = train_or_exit(trainer, args.resume)
        print(f"Best valid: {best * 100.:.2f}")
    return trainer


if __name__ == "__main__":
    main()
