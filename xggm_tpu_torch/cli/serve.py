"""Serve an artifact exported by either package (bf16, fp32 or int8) over
HTTP, with PyTorch.

    python -m xggm_tpu_torch.cli.serve --artifact art/ --data_root data \
        --task gqa --split val --port 8000 [--device cuda|cpu] [--synthetic]

The artifact brings the weights and the answer vocabulary; this process adds
the tokenizer and the obj36 feature store and answers
{"queries": [{"img_id", "sent"}]} POSTs on /predict. It runs on the card
unless `--device cpu` is given. The features are read from H5 files, so
this CLI needs h5py; `InferenceEngine` takes any feature store.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True)
    p.add_argument("--task", default="gqa", choices=["gqa", "vqa"])
    p.add_argument("--data_root", default="data")
    p.add_argument("--split", default="val",
                   help="feature split: {data_root}/{task}_imgfeat/"
                        "{split}_obj36.h5")
    p.add_argument("--vocab", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic corpus of --task first")
    args = p.parse_args(argv)

    from xggm_tpu_torch.data.datasets import H5FeatureStore
    from xggm_tpu_torch.data.tokenizer import BertTokenizer
    from xggm_tpu_torch.serving.artifact import ServingModel
    from xggm_tpu_torch.serving.server import InferenceEngine, make_server

    model = ServingModel.load(args.artifact, device=args.device)
    if args.synthetic:
        from xggm_tpu_torch.data.synthetic import (
            make_synthetic_gqa, make_synthetic_vqacp, write_vocab)
        make = make_synthetic_gqa if args.task == "gqa" else make_synthetic_vqacp
        make(args.data_root, args.split)
        write_vocab(os.path.join(args.data_root, "vocab.txt"))

    sub = "gqa_imgfeat" if args.task == "gqa" else "mscoco_imgfeat"
    root = os.path.join(args.data_root, sub)
    store = H5FeatureStore(
        os.path.join(root, f"{args.split}_obj36.h5"),
        os.path.join(root, f"{args.split}_obj36_info.json"))
    tokenizer = BertTokenizer.from_file(
        args.vocab or os.path.join(args.data_root, "vocab.txt"))

    server = make_server(InferenceEngine(model, tokenizer, store),
                         args.host, args.port)
    print(f"serving {args.artifact} on http://{args.host}:{args.port} "
          f"(device={model.device}, bs={model.batch_size}, "
          f"{model.meta['num_answers']} answers)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        store.close()


if __name__ == "__main__":
    main()
