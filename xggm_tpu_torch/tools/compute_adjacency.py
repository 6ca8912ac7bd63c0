"""BERT-cosine adjacency precompute (counterpart of
`tools/compute_adjacency.py`).

For each image, adj[i, j] = cos(class_i, attr_j) for j >= i, the diagonal
included, of the pooled BERT embeddings of box i's object-class name and
box j's attribute name; then adj += adj^T (which doubles the diagonal, a
reference quirk kept) and adj /= adj.max(). The object and attribute
vocabularies are embedded once (`embed_vocab`: a pooled `BertTextModel`
forward per chunk of names, whose attention is kernel 1 on the card), and
each image's adjacency is a gather over the cached embeddings
(`adjacency_from_ids`, on the embeddings' device).

    python -m xggm_tpu_torch.tools.compute_adjacency \
        --obj_h5 .../train_obj36.h5 --objects_vocab objects_vocab.txt \
        --attrs_vocab attributes_vocab.txt --vocab vocab.txt \
        --bert_ckpt bert_base.pth --out .../train_obj36_adj_v2.h5 \
        [--device cpu]

Reading and writing the H5 files needs h5py.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from xggm_tpu_torch.data.tokenizer import BertTokenizer, encode_batch


def embed_vocab(names: List[str], tokenizer: BertTokenizer, model,
                max_len: int = 16, batch_size: int = 256) -> np.ndarray:
    """The pooled embedding of every name, [len(names), hidden]: one
    deterministic forward of `model` (a BertTextModel) per chunk of
    batch_size names on the model's device, the last chunk padded with
    empty names."""
    device = next(model.parameters()).device
    outs = []
    with torch.no_grad():
        for s in range(0, len(names), batch_size):
            chunk = names[s: s + batch_size]
            pad = batch_size - len(chunk)
            ids, mask, seg = (torch.from_numpy(a).long().to(device)
                              for a in encode_batch(tokenizer,
                                                    chunk + [""] * pad,
                                                    max_len))
            _, pooled = model(ids, mask, seg)
            outs.append(pooled[: len(chunk)].float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def adjacency_from_ids(obj_ids, attr_ids, obj_emb, attr_emb) -> torch.Tensor:
    """The class-vs-attribute cosine adjacency [..., 36, 36] of one image's
    ids [36] (or a batch of them [B, 36]), float32 on obj_emb's device
    (arrays or tensors; a numpy array lies on the host). The norms and
    cosines accumulate in float64, so the result does not depend on the
    device's summation order beyond float32's last place; the cosine's
    floor is 1e-6, as torch.cosine_similarity's."""
    obj_emb = torch.as_tensor(obj_emb)
    dev = obj_emb.device
    attr_emb = torch.as_tensor(attr_emb, device=dev)
    c = obj_emb[torch.as_tensor(obj_ids, device=dev).long()].double()
    a = attr_emb[torch.as_tensor(attr_ids, device=dev).long()].double()
    cn = c / c.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    an = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    upper = torch.matmul(cn, an.transpose(-1, -2)).triu()
    adj = upper + upper.transpose(-1, -2)
    return (adj / adj.amax(dim=(-1, -2), keepdim=True)).float()


def compute_adjacency(obj_h5_path: str, out_path: str,
                      obj_emb: np.ndarray, attr_emb: np.ndarray) -> int:
    """Write one [36, 36] float32 dataset per image of `obj_h5_path` into
    `out_path`; returns the number of images."""
    import h5py

    n = 0
    with h5py.File(obj_h5_path, "r") as obj, \
            h5py.File(out_path, "w") as out:
        for img_id in obj.keys():
            g = obj[img_id]
            adj = adjacency_from_ids(np.asarray(g["objects_id"], np.int64),
                                     np.asarray(g["attrs_id"], np.int64),
                                     obj_emb, attr_emb)
            out.create_dataset(img_id, data=adj.cpu().numpy(),
                               dtype=np.float32)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--obj_h5", required=True)
    p.add_argument("--objects_vocab", required=True)
    p.add_argument("--attrs_vocab", required=True)
    p.add_argument("--vocab", required=True, help="WordPiece vocab.txt")
    p.add_argument("--bert_ckpt", default=None,
                   help="bert-base-uncased torch .pth/.bin (random init "
                        "BERT if omitted - for smoke runs only)")
    p.add_argument("--out", required=True)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="device of the BERT forward (default the card)")
    args = p.parse_args(argv)

    from xggm_tpu_torch.config import BertConfig
    from xggm_tpu_torch.models.lxmert import BertTextModel
    from xggm_tpu_torch.ops.basic import init_weights
    from xggm_tpu_torch.utils.device import resolve_device
    from xggm_tpu_torch.utils.io import load_txt_lines

    device = resolve_device(args.device)
    tokenizer = BertTokenizer.from_file(args.vocab)
    cfg = BertConfig(vocab_size=len(tokenizer.vocab))
    model = BertTextModel(cfg, num_layers=args.layers, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))
    if args.bert_ckpt:
        from xggm_tpu_torch.checkpoint.torch_bridge import (
            convert_bert_text, load_torch_state_dict, merge_into)
        sd = load_torch_state_dict(args.bert_ckpt)
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        flat = convert_bert_text(sd, args.layers, prefix)
        unmatched = merge_into(model, flat)
        print(f"loaded BERT: {len(flat)} tensors, {len(unmatched)} untouched")

    obj_names = load_txt_lines(args.objects_vocab)
    attr_names = load_txt_lines(args.attrs_vocab)
    print(f"embedding {len(obj_names)} object + {len(attr_names)} attribute "
          f"names...")
    obj_emb = embed_vocab(obj_names, tokenizer, model)
    attr_emb = embed_vocab(attr_names, tokenizer, model)

    n = compute_adjacency(args.obj_h5, args.out, obj_emb, attr_emb)
    print(f"wrote {n} adjacency matrices to {args.out}")


if __name__ == "__main__":
    main()
