"""LXMERT pretraining entry point (counterpart of `xggm_tpu/cli/pretrain.py`).

    python -m xggm_tpu_torch.cli.pretrain --taskMaskLM --taskObjPredict \
        --taskMatched --taskQA --visualLosses obj,attr,feat \
        --qaSets vqa,gqa,visual7w --train mscoco_train,vgnococo \
        --valid mscoco_minival --llayers 9 --xlayers 5 --rlayers 5 \
        --fromScratch --bs 256 --lr 1e-4 --epochs 20 --output snap/pretrained

Features are read per source from `{data_root}/lxmert_imgfeat/`: the H5 file
`{source}_obj36.h5` (with its info json) when present, else
`{source}_obj36.tsv`. `--synthetic` writes a small corpus with H5 features
first (it needs h5py; `data/synthetic_pretrain.py` writes TSV features with
`tsv=True`). `--accum_steps N` applies one update per N microbatches of
`--bs`. `--load NAME` reads the parameters and BertAdam state of a
checkpoint from `--output`; a SIGTERM saves `PREEMPT` at the next update
boundary and exits 75, and `--resume` continues from it. It runs on the
card unless `--device cpu` is given; `--multiGPU` (under torchrun) or
`--coordinator/--num_hosts/--host_id` pretrain data-parallel with `--bs`
the global batch, `--shard_opt_state` splits BertAdam's moments over the
ranks and `--remat` recomputes the encoder's activations in the backward.
"""
from __future__ import annotations

import os

from xggm_tpu_torch.cli.common import (
    build_parser, generate_synthetic_once, mesh_if_requested,
    seed_everything, to_config, train_or_exit)
from xggm_tpu_torch.utils.device import resolve_device


def build_featurizer(split: str, args, tokenizer):
    """The featurizer of the sources in `split` (comma-separated), their
    features from H5 where present, else TSV."""
    from xggm_tpu_torch.data.pretrain_data import (
        LxmertPretrainDataset, PretrainFeaturizer)

    qa_sets = None
    if args.qa_sets:
        qa_sets = [s.strip().lower() for s in args.qa_sets.split(",")]
    topk = 512 if args.tiny else (5000 if args.fast else None)
    ds = LxmertPretrainDataset(split, args.data_root, qa_sets, topk)
    feat_dir = os.path.join(args.data_root, "lxmert_imgfeat")
    for source in ds.sources:
        h5 = os.path.join(feat_dir, f"{source}_obj36.h5")
        tsv = os.path.join(feat_dir, f"{source}_obj36.tsv")
        if os.path.exists(h5):
            ds.load_features_h5(
                h5, os.path.join(feat_dir, f"{source}_obj36_info.json"),
                topk)
        elif os.path.exists(tsv):
            ds.load_features_tsv(tsv, topk)
        else:
            raise FileNotFoundError(f"no features for source {source}")
    return PretrainFeaturizer(
        ds, tokenizer, max_seq_length=20,
        word_mask_rate=args.word_mask_rate,
        obj_mask_rate=args.obj_mask_rate,
        task_matched=args.task_matched, seed=args.seed)


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
        from xggm_tpu_torch.data.synthetic_pretrain import (
            make_synthetic_pretrain)
        generate_synthetic_once(
            lambda: make_synthetic_pretrain(args.data_root), args.data_root,
            mesh)

    from xggm_tpu_torch.data.tokenizer import BertTokenizer
    from xggm_tpu_torch.training.pretrainer import LxmertPretrainer

    tok = BertTokenizer.from_file(
        args.vocab or os.path.join(args.data_root, "vocab.txt"))
    train_feat = build_featurizer(args.train, args, tok)
    valid_feat = build_featurizer(args.valid, args, tok) if args.valid \
        else None
    trainer = LxmertPretrainer(
        cfg, train_feat, valid_feat,
        task_mask_lm=args.task_mask_lm, task_matched=args.task_matched,
        task_obj_predict=args.task_obj_predict, task_qa=args.task_qa,
        visual_losses=tuple(args.visual_losses.split(",")), mesh=mesh,
        device=device)
    if args.load:
        trainer.load(args.load)
    best = train_or_exit(trainer, args.resume)
    print(f"Best eval loss: {best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
