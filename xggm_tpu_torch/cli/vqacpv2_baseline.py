"""VQA-CP v2 plain-BCE baseline (counterpart of
`xggm_tpu/cli/vqacpv2_baseline.py`): the same model without the GGM phase,
one forward and one BertAdam update per batch, every parameter at the base
lr and t_total = the batches (not twice them).

    python -m xggm_tpu_torch.cli.vqacpv2_baseline --train train \
        --valid test --bs 92 --lr 1e-6 --epochs 4 --xpack \
        --loadLXMERTQA snap/pretrained/model --output snap/vqacp_baseline

Flags, the load arms and the test arm are those of `cli.vqacpv2`; the
baseline trains with no preemption guard and ignores --resume, as the JAX
CLI does. `--xpack` reads feature packs here as in the other CLIs.
"""
from __future__ import annotations

import dataclasses

from xggm_tpu_torch.cli.common import (
    build_parser, dump_args, load_weights, seed_everything, to_config)
from xggm_tpu_torch.cli.vqacpv2 import predict_split, write_synthetic
from xggm_tpu_torch.utils.device import resolve_device


def to_baseline_config(args):
    """The VQA-CP config of the flags, with one parameter group (no
    downstream multiplier) and t_total = 1 x the batches."""
    cfg = to_config(args, task="vqa")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, downstream_lr_mult=1.0, t_total_mult=1.0))


def main(argv=None):
    """Run the CLI on `argv`; returns the trainer."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)
    cfg = to_baseline_config(args)
    if args.synthetic:
        write_synthetic(args)

    from xggm_tpu_torch.training.trainer import XGGMTrainer

    trainer = XGGMTrainer(cfg, task="vqa", use_xpack=args.xpack,
                          device=device)
    dump_args(args, args.output)
    load_weights(trainer, args)

    if args.test is not None:
        predict_split(trainer, cfg)
    else:
        best = trainer.train_baseline()
        print(f"Best valid: {best * 100.:.2f}")
    return trainer


if __name__ == "__main__":
    main()
