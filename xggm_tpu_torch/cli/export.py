"""Export a checkpoint as a serving artifact (counterpart of
`xggm_tpu/cli/export.py`).

    python -m xggm_tpu_torch.cli.export --task gqa --xpack --data_root data \
        --output snap/gqa --load BEST --artifact art/ [--quantize int8]
    python -m xggm_tpu_torch.cli.serve --artifact art/ --data_root data

It loads through the task CLIs' ladder (`--load` a checkpoint of the port's
format by name from `--output`, or a reference task model `.pth`; else
`--loadLXMERT`, else `--loadLXMERTQA`) into an `XGGMTrainer` whose answer
vocabulary is that of `--valid` (or `--test`, or `val`), then writes
`params.npz` and `meta.json` (`serving/artifact.py::export_model`).
`--serve_bs 0` exports for any batch size. `--platforms` is accepted and
has no effect: the port writes no compiled graph. It runs on the card
unless `--device cpu` is given.
"""
from __future__ import annotations

import os

from xggm_tpu_torch.cli.common import (
    build_parser, load_weights, seed_everything, to_config)
from xggm_tpu_torch.utils.device import resolve_device


def main(argv=None) -> str:
    """Run the CLI on `argv`; returns the artifact's path."""
    parser = build_parser()
    parser.add_argument("--task", default="gqa", choices=["gqa", "vqa"])
    parser.add_argument("--artifact", required=True,
                        help="output artifact directory")
    parser.add_argument("--serve_bs", default=16, type=int,
                        help="exported static batch size; 0 = any batch "
                             "size")
    parser.add_argument("--platforms", default="cpu,tpu",
                        help="no effect: the port writes no compiled graph")
    parser.add_argument("--fp32_weights", action="store_const",
                        default=False, const=True,
                        help="export the fp32 masters instead of the bf16 "
                             "layout the forward reads")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="per-channel int8 Dense kernels, served with "
                             "dynamic int8 activations")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)

    split = args.valid or args.test or "val"
    if args.synthetic:
        from xggm_tpu_torch.data.synthetic import (
            make_synthetic_gqa, make_synthetic_vqacp, write_vocab)
        make = make_synthetic_gqa if args.task == "gqa" else make_synthetic_vqacp
        make(args.data_root, split, pack=args.xpack)
        write_vocab(os.path.join(args.data_root, "vocab.txt"))

    # the answer vocabulary comes from one split; no training set
    args.train, args.valid = "", split
    cfg = to_config(args, task=args.task)

    from xggm_tpu_torch.serving.artifact import export_model
    from xggm_tpu_torch.training.trainer import XGGMTrainer

    trainer = XGGMTrainer(cfg, task=args.task, use_xpack=args.xpack,
                          device=device)
    load_weights(trainer, args)
    path = export_model(
        trainer.model, args.artifact,
        batch_size=None if args.serve_bs == 0 else args.serve_bs,
        label2ans=trainer.label2ans, bf16_weights=not args.fp32_weights,
        quantize=args.quantize, shadow=trainer.state.shadow,
        notes={"task": args.task, "load": args.load or None,
               "load_lxmert": args.load_lxmert or None,
               "load_lxmert_qa": args.load_lxmert_qa or None})
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    print(f"exported artifact: {path} ({size / 1e6:.1f} MB, "
          f"bs={args.serve_bs or 'any'}, quantize={args.quantize})")
    return path


if __name__ == "__main__":
    main()
