"""The port's VQA-CP v2 recipe against the JAX package's host-level code:

  * `make_synthetic_vqacp(pack=True)` writes a pack byte for byte equal to
    JAX's `convert_h5_to_xpack` of JAX's H5 corpus, the same annotations
    and vocabulary, and no H5 file; with `pack=False`, JAX's H5 files; the
    port's `VQACPDataset` batches over that pack equal JAX's over the H5;
  * `to_config(args, "vqa")` and the baseline's replacement equal the JAX
    CLIs' fields;
  * both VQA-CP CLIs end to end at a tiny size, in a subprocess with jax,
    flax and h5py blocked (the pattern of tests/test_torch_cli.py): train,
    then the test arm's `{tmode}_predict.json` in `VQAEvaluator`'s format
    and its accuracy; the baseline one clean update per batch, t_total the
    batches.

No JAX trainer, train step or model is built here.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from xggm_tpu.cli.common import build_parser as jax_build_parser
from xggm_tpu.cli.common import to_config as jax_to_config
from xggm_tpu.config import DataConfig as JaxDataConfig
from xggm_tpu.data import datasets as jax_datasets
from xggm_tpu.data.synthetic import make_synthetic_vqacp as jax_make
from xggm_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from xggm_tpu.data.xpack import convert_h5_to_xpack
from xggm_tpu_torch.cli.common import build_parser, to_config
from xggm_tpu_torch.cli.vqacpv2_baseline import to_baseline_config
from xggm_tpu_torch.config import DataConfig
from xggm_tpu_torch.data import datasets
from xggm_tpu_torch.data.synthetic import make_synthetic_vqacp, write_vocab
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.data.xpack import XPackFeatureStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSONS = ("vqacpv2/val_annotations.json", "vqacpv2/trainval_label2ans.json",
         "vqacpv2/trainval_ans2label.json",
         "mscoco_imgfeat/val_obj36_info.json")


def test_synthetic_vqacp_matches_jax(tmp_path):
    kw = dict(n_images=11, n_questions=23, feat_dim=16, seed=4)
    ref, pack, h5 = (str(tmp_path / d) for d in ("jax", "pack", "h5"))
    jax_make(ref, "val", **kw)
    make_synthetic_vqacp(pack, "val", pack=True, **kw)
    make_synthetic_vqacp(h5, "val", **kw)
    for rel in JSONS:
        want = json.load(open(os.path.join(ref, rel)))
        assert json.load(open(os.path.join(pack, rel))) == want, rel
        assert json.load(open(os.path.join(h5, rel))) == want, rel

    feat = os.path.join(ref, "mscoco_imgfeat")
    want_pack = convert_h5_to_xpack(
        os.path.join(feat, "val_obj36.h5"),
        os.path.join(feat, "val_obj36_info.json"),
        os.path.join(feat, "val_obj36_adj_v2.h5"),
        str(tmp_path / "ref.xpack"), feat_dim=16)
    got = os.path.join(pack, "mscoco_imgfeat", "val_obj36.xpack")
    assert open(got, "rb").read() == open(want_pack, "rb").read()
    assert json.load(open(got + ".index.json")) == \
        json.load(open(want_pack + ".index.json"))
    assert not [f for f in os.listdir(os.path.join(pack, "mscoco_imgfeat"))
                if f.endswith(".h5")]

    import h5py
    for name in ("val_obj36.h5", "val_obj36_adj_v2.h5"):
        with h5py.File(os.path.join(feat, name)) as a, \
                h5py.File(os.path.join(h5, "mscoco_imgfeat", name)) as b:
            assert list(a) == list(b)
            a.visititems(lambda k, v: None if isinstance(v, h5py.Group)
                         else np.testing.assert_array_equal(v[()], b[k][()]))

    # the port's VQA-CP batches over the pack = JAX's over the H5
    write_vocab(str(tmp_path / "vocab.txt"))
    vocab = [ln.strip() for ln in open(tmp_path / "vocab.txt")]
    ours = datasets.GraphBatchDataset(
        datasets.VQACPDataset("val", DataConfig(data_root=pack)),
        BertTokenizer({t: i for i, t in enumerate(vocab)}),
        store=XPackFeatureStore(got))
    theirs = jax_datasets.GraphBatchDataset(
        jax_datasets.VQACPDataset("val", JaxDataConfig(data_root=ref)),
        JaxTokenizer({t: i for i, t in enumerate(vocab)}))
    idx = np.arange(len(theirs))[::-1]
    assert len(ours) == len(theirs) == 23
    assert ours.question_ids(idx) == theirs.question_ids(idx)
    a, b = ours.get_batch(idx), theirs.get_batch(idx)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0, err_msg=k)


def _fields(obj, prefix=""):
    """{dotted field name: value} over nested dataclasses."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_to_config_and_baseline_match_jax():
    argvs = [[], ["--bs", "92", "--lr", "1e-6", "--epochs", "4", "--delta",
                  "0", "--tmode", "ID", "--loadLXMERTQA", "snap/model",
                  "--dropout", "0.2", "--seed", "3", "--fp16", "--dtype",
                  "float32"]]
    for argv in argvs:
        with (pytest.warns(UserWarning, match="--fp16") if "--fp16" in argv
              else contextlib.nullcontext()):
            ours = to_config(build_parser().parse_args(argv), "vqa")
            base = to_baseline_config(build_parser().parse_args(argv))
        with (pytest.warns(UserWarning, match="--fp16") if "--fp16" in argv
              else contextlib.nullcontext()):
            theirs = jax_to_config(jax_build_parser().parse_args(argv), "vqa")
        theirs_base = theirs.replace(train=dataclasses.replace(
            theirs.train, downstream_lr_mult=1.0, t_total_mult=1.0))
        for mine, ref in ((ours, theirs), (base, theirs_base)):
            got, want = _fields(mine), _fields(ref)
            assert len(got) > 30
            for k, v in got.items():
                assert k in want and want[k] == v, (argv, k)
        assert ours.train.clean_phase_first and ours.train.rel_d_mult == 8.0
        assert (base.train.downstream_lr_mult, base.train.t_total_mult) == \
            (1.0, 1.0)


E2E = r"""
import functools, json, os, sys
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes",
             "torch.utils.tensorboard"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import xggm_tpu_torch.cli.common as common
from xggm_tpu_torch.config import BertConfig
common.BertConfig = functools.partial(
    BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=64)
from xggm_tpu_torch.cli import vqacpv2, vqacpv2_baseline

root, out = sys.argv[1], sys.argv[2]
base = ["--synthetic", "--xpack", "--device", "cpu", "--dtype", "float32",
        "--data_root", root, "--llayers", "1", "--xlayers", "1",
        "--rlayers", "1", "--bs", "48", "--epochs", "1", "--delta", "0"]
trainer = vqacpv2.main(base + ["--output", out])
print("COUNT", trainer.state.opt_state.count, len(trainer.train_set) // 48)
vqacpv2.main(base + ["--output", out, "--test", "val", "--tmode", "ID",
                     "--load", os.path.join(out, "BEST_0")])
trainer = vqacpv2_baseline.main(base + ["--output", out + "_baseline"])
print("BASELINE", trainer.state.opt_state.count, trainer.opt.t_total,
      len(trainer.train_set) // 48)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "flax", "h5py", "xggm_tpu"))
print("LEAKED", leaked)
"""


def test_vqacp_clis_end_to_end_without_jax_or_h5py(tmp_path):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", E2E, root, out], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "LEAKED []" in lines
    count, batches = map(int, next(ln for ln in lines
                                   if ln.startswith("COUNT")).split()[1:])
    assert count == 2 * batches == 4
    # the baseline: one clean update per batch, t_total = the batches
    count, t_total, batches = map(int, next(
        ln for ln in lines if ln.startswith("BASELINE")).split()[1:])
    assert count == t_total == batches == 2
    steps = [json.loads(ln) for ln in
             open(os.path.join(out + "_baseline", "metrics.jsonl"))]
    assert [r["branch"] for r in steps if "branch" in r] == ["clean"] * 2
    # the GGM run: the representation branch only (delta 0)
    steps = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["branch"] for r in steps if "branch" in r] == ["rep"] * 2
    assert sum(1 for ln in lines if ln.startswith("Best valid: ")) == 2
    for d in (out, out + "_baseline"):
        assert os.path.isdir(os.path.join(d, "BEST_0"))
    feat = os.path.join(root, "mscoco_imgfeat")
    assert not [f for f in os.listdir(feat) if f.endswith(".h5")]

    # the test arm: ID_predict.json in VQAEvaluator's format, its accuracy
    preds = json.load(open(os.path.join(out, "ID_predict.json")))
    raw = datasets.VQACPDataset("val", DataConfig(data_root=root))
    assert len(preds) == 96
    assert all(set(p) == {"question_id", "answer"}
               and p["answer"] in raw.label2ans for p in preds)
    acc = datasets.VQAEvaluator(raw).evaluate(
        {p["question_id"]: p["answer"] for p in preds})
    assert f"val (ID) accuracy: {acc * 100.:.2f}" in lines
    size = sum(os.path.getsize(os.path.join(out, "BEST_0", f))
               for f in os.listdir(os.path.join(out, "BEST_0")))
    assert size < 10e6
