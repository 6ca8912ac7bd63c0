"""The port stands alone: every module of it imports with jax, flax, h5py
and matplotlib blocked, none of them (nor chip_smoke.py) imports xggm_tpu,
and entry points called without device="cpu" on a machine with no card
raise (the CLIs before they write anything). Also the host-side
copies it keeps (tokenizer, synthetic corpus, feature store) against the
JAX package's originals."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "xggm_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "xggm_tpu")


def _port_sources():
    paths = [os.path.join(root, f) for root, _, files in os.walk(PORT)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def test_import_with_jax_flax_h5py_blocked():
    script = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes", "matplotlib"):
    sys.modules[name] = None
import xggm_tpu_torch
for m in pkgutil.walk_packages(xggm_tpu_torch.__path__, "xggm_tpu_torch."):
    importlib.import_module(m.name)
import xggm_tpu_torch.parallel
assert {"xggm_tpu_torch.parallel.distributed",
        "xggm_tpu_torch.parallel.mesh"} <= set(sys.modules)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "xggm_tpu" or m.startswith("xggm_tpu."))
assert not leaked, leaked
print("IMPORT_OK")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORT_OK" in proc.stdout


def test_port_sources_are_not_ignored_by_git():
    """A checkout holds only what git commits, so no source of the port may
    match a .gitignore rule (the root's `data/` also matches
    xggm_tpu_torch/data/ unless that is re-included)."""
    probe = subprocess.run(["git", "rev-parse", "--is-inside-work-tree"],
                           cwd=REPO, capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip("not a git work tree")
    files = [os.path.relpath(p, REPO) for p in _port_sources()]
    csrc = os.path.join("xggm_tpu_torch", "csrc")
    files += [os.path.join(csrc, f) for f in os.listdir(os.path.join(REPO, csrc))]
    proc = subprocess.run(["git", "check-ignore", "--no-index", *files],
                          cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 1 and not proc.stdout, \
        f"ignored by git: {proc.stdout}{proc.stderr}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in BANNED, f"{path}:{node.lineno} imports {name}"
            if root == "h5py":
                assert id(node) not in top_level, \
                    f"{path}:{node.lineno} imports h5py at module level"


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from xggm_tpu_torch.cli import (
        export, gqa_ood, pretrain, vqacpv2, vqacpv2_baseline)
    from xggm_tpu_torch.config import tiny_test_config
    from xggm_tpu_torch.data.feeder import Feeder
    from xggm_tpu_torch.models.lxmert import LxmertModel
    from xggm_tpu_torch.models.pretrain_model import PretrainModel
    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.parallel import make_mesh
    from xggm_tpu_torch.training.pretrainer import LxmertPretrainer
    from xggm_tpu_torch.training.trainer import XGGMTrainer

    cfg = tiny_test_config()
    for make in (lambda: XGGMModel(cfg.lxmert, cfg.num_answers),
                 lambda: XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm),
                 lambda: LxmertModel(cfg.lxmert),
                 lambda: PretrainModel(cfg.lxmert),
                 lambda: XGGMTrainer(cfg.replace(output=str(tmp_path))),
                 lambda: LxmertPretrainer(cfg.replace(output=str(tmp_path)),
                                          train_feat=None),
                 lambda: Feeder([], 8),
                 make_mesh,
                 *(lambda cli=cli, flags=flags: cli.main(
                     ["--synthetic", "--data_root", str(tmp_path / "data"),
                      "--output", str(tmp_path / "out"), *flags])
                   for cli in (gqa_ood, vqacpv2, vqacpv2_baseline,
                               pretrain)
                   for flags in ([], ["--multiGPU", "--shard_opt_state"],
                                 ["--coordinator", "127.0.0.1:1",
                                  "--num_hosts", "2", "--host_id", "0"])),
                 lambda: export.main(
                     ["--synthetic", "--data_root", str(tmp_path / "data"),
                      "--output", str(tmp_path / "out"), "--artifact",
                      str(tmp_path / "art")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the CLIs raised before they wrote anything
    assert not os.listdir(tmp_path)


def test_tokenizer_copy_matches_jax():
    from xggm_tpu.data.tokenizer import encode_batch as jax_encode
    from xggm_tpu.data.tokenizer import BertTokenizer as JaxTok
    from xggm_tpu.data.tokenizer import make_test_vocab
    from xggm_tpu_torch.data.tokenizer import BertTokenizer, encode_batch

    vocab = make_test_vocab()
    sents = ["What is the color of the dog?", "unwanted running, cat",
             "Ünwänted   left\tright ,a", "", "on " * 30]
    got = encode_batch(BertTokenizer(vocab), sents, 20)
    want = jax_encode(JaxTok(vocab), sents, 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_corpus_and_feature_store_match_jax(tmp_path):
    from xggm_tpu.data.datasets import H5FeatureStore as JaxStore
    from xggm_tpu.data.synthetic import make_synthetic_gqa as jax_make
    from xggm_tpu.data.synthetic import write_vocab as jax_vocab
    from xggm_tpu_torch.data.datasets import H5FeatureStore
    from xggm_tpu_torch.data.synthetic import make_synthetic_gqa, write_vocab

    kw = dict(n_images=3, n_questions=5, feat_dim=8, seed=3)
    jax_make(str(tmp_path / "jax"), "val", **kw)
    make_synthetic_gqa(str(tmp_path / "port"), "val", **kw)
    for rel in ("gqa_ood/val.json", "gqa_ood/trainval_ans2label.json",
                "gqa_imgfeat/val_obj36_info.json"):
        assert json.load(open(tmp_path / "port" / rel)) == \
            json.load(open(tmp_path / "jax" / rel))
    assert write_vocab(str(tmp_path / "v1.txt")) == \
        jax_vocab(str(tmp_path / "v2.txt"))

    def store(cls, root):
        feat = os.path.join(str(tmp_path), root, "gqa_imgfeat")
        return cls(os.path.join(feat, "val_obj36.h5"),
                   os.path.join(feat, "val_obj36_info.json"),
                   os.path.join(feat, "val_obj36_adj_v2.h5"))

    port, ref = store(H5FeatureStore, "port"), store(JaxStore, "jax")
    try:
        assert port.img_ids() == ref.img_ids()
        for img in ref.img_ids():
            for a, b in zip(port.get(img), ref.get(img)):
                np.testing.assert_array_equal(a, b)
    finally:
        port.close()
