"""VQA-CP v2 entry point (counterpart of `xggm_tpu/cli/vqacpv2.py`): train,
or with --test SPLIT predict a split and score it.

    python -m xggm_tpu_torch.cli.vqacpv2 --train train --valid test \
        --bs 92 --lr 1e-6 --epochs 4 --delta 0 --xpack \
        --loadLXMERTQA snap/pretrained/model --output snap/vqacp
    python -m xggm_tpu_torch.cli.vqacpv2 --xpack --test test --tmode OOD \
        --load BEST --loadLXMERTQA "" --output snap/vqacp

The task runs the clean phase before the GGM phase, with `rel_d_mult` 8;
the shipped recipe passes `--delta 0`, so the relation branch never runs.
The test arm writes `{tmode}_predict.json` in `--output` (the format of the
official evaluator, `cli.evaluate vqa`) and prints the split's soft-score
accuracy. It runs on the card unless `--device cpu` is given; the load,
resume and preemption flags are those of `cli.gqa_ood`.
"""
from __future__ import annotations

import os

from xggm_tpu_torch.cli.common import (
    build_parser, dump_args, generate_synthetic_once, load_weights,
    mesh_if_requested, seed_everything, to_config, train_or_exit)
from xggm_tpu_torch.utils.device import resolve_device


def write_synthetic(args, mesh=None) -> None:
    """--synthetic: a VQA-CP corpus for every split named, and a vocab
    (written once in a data group)."""
    from xggm_tpu_torch.data.synthetic import make_synthetic_vqacp, write_vocab

    def _gen():
        splits = {args.train, args.valid, args.test} - {None, ""}
        for i, split in enumerate(sorted(splits)):
            make_synthetic_vqacp(args.data_root, split, seed=i,
                                 pack=args.xpack)
        write_vocab(os.path.join(args.data_root, "vocab.txt"))
    generate_synthetic_once(_gen, args.data_root, mesh)


def predict_split(trainer, cfg) -> None:
    """The test arm: answers for split --test as {tmode}_predict.json
    (`cfg.tmode`, from --tmode), and its accuracy when the split has
    answers."""
    from xggm_tpu_torch.data.datasets import (
        GraphBatchDataset, VQACPDataset, VQAEvaluator)

    ds_raw = VQACPDataset(cfg.data.test, cfg.data)
    store = (trainer._maybe_xpack_store(ds_raw) if trainer.use_xpack
             else None)
    dataset = GraphBatchDataset(ds_raw, trainer.tokenizer, store=store)
    dump = os.path.join(cfg.output, f"{cfg.tmode}_predict.json")
    quesid2ans = trainer.predict(dataset, dump_path=dump)
    if dataset.has_targets:
        acc = VQAEvaluator(ds_raw).evaluate(quesid2ans)
        print(f"{cfg.data.test} ({cfg.tmode}) accuracy: {acc * 100.:.2f}")


def main(argv=None):
    """Run the CLI on `argv`; returns the trainer."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)
    cfg = to_config(args, task="vqa")
    with mesh_if_requested(args, device) as mesh:
        return _run(args, cfg, device, mesh)


def _run(args, cfg, device, mesh):
    if args.synthetic:
        write_synthetic(args, mesh)

    from xggm_tpu_torch.training.trainer import XGGMTrainer

    trainer = XGGMTrainer(cfg, task="vqa", mesh=mesh, use_xpack=args.xpack,
                          profile_steps=args.profile, device=device)
    dump_args(args, args.output, mesh)
    load_weights(trainer, args)

    if args.test is not None:
        predict_split(trainer, cfg)
    else:
        best = train_or_exit(trainer, args.resume)
        print(f"Best valid: {best * 100.:.2f}")
    return trainer


if __name__ == "__main__":
    main()
