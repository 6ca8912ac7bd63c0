"""The port's loaders of reference torch snapshots against the JAX
package's conversions, on snapshots built from `goldens/lxrt_tiny.npz` as
tests/test_load_paths.py builds them:

  * `--loadLXMERT` (an encoder snapshot with DataParallel prefixes),
    `--loadLXMERTQA` (encoder and answer head, the head's rows matched
    through the answer table, the `Loaded k answers ...` line) and
    `--load x.pth` (a task model with TF-style LayerNorm names) leave the
    port trainer's `state_dict` equal, exactly, to JAX's
    `convert_lxrt_bert` / `load_lxmert_qa` / `convert_task_model` merged
    with `merge_into` into the same initial parameters, mapped through
    `port_name`; the entries a snapshot lacks keep their values; the load
    flags' precedence and their empty values;
  * `AnswerTable.convert_ans` and `surger_answer_head` against JAX's;
  * `--load x.pth` of a GIN and of a GAT task model against JAX's
    `convert_task_model` + `merge_into`, exactly;
  * the refusals: an unknown generator or parameter name raises, a
    snapshot without an encoder key fails its coverage assert, a shape
    mismatch is reported and leaves the entry as it was.

No JAX trainer, train step or model is built: JAX's side works on numpy
copies of the port's initial parameters.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from xggm_tpu.checkpoint import answer_table as jax_answer_table
from xggm_tpu.checkpoint import torch_bridge as jax_bridge
from xggm_tpu.config import tiny_test_config as jax_tiny_config
from xggm_tpu.serving.artifact import _unflatten
from xggm_tpu_torch.checkpoint import answer_table, torch_bridge
from xggm_tpu_torch.checkpoint.jax_params import port_name, to_jax_params
from xggm_tpu_torch.cli.common import build_parser, load_weights
from xggm_tpu_torch.config import DataConfig, tiny_test_config
from xggm_tpu_torch.data.synthetic import (
    ANSWERS, make_synthetic_vqacp, write_vocab)
from xggm_tpu_torch.training.trainer import XGGMTrainer

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# the pretraining vocabulary: 10 of the 16 synthetic answers match, some
# only after normalisation ('one' -> '1', 'two' -> '2', 'three' -> '3')
PRE_ANSWERS = ["yes", "no", "2", "dog", "cat", "red", "gray", "man", "1",
               "left", "table", "3"]


@pytest.fixture(autouse=True, scope="module")
def quiet_module():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()
    torch.set_num_threads(threads)


def _golden_encoder():
    data = np.load(os.path.join(GOLDENS, "lxrt_tiny.npz"))
    return {k[len("sd::"):]: data[k] for k in data.files
            if k.startswith("sd::")}


# the port's names of the task model's head and GGM modules -> the
# reference task model's torch keys
_TORCH_KEYS = [
    # GIN convs and GAT heads (the reference's names), before GCN's convs
    (r"^generator\.gnn\.(\d+)\.conv\.(\d+)\.eps$",
     r"generator.gnn_layers.\1.gnn_convs.\2.eps"),
    (r"^generator\.gnn\.(\d+)\.conv\.(\d+)\.linear\.fc\.",
     r"generator.gnn_layers.\1.gnn_convs.\2.linear.0."),
    (r"^generator\.gnn\.(\d+)\.conv\.(\d+)\.linear\.ln\.",
     r"generator.gnn_layers.\1.gnn_convs.\2.linear.2."),
    (r"^generator\.gnn\.(\d+)\.head\.(\d+)\.linear_layer\.",
     r"generator.gnn_layers.\1.gat_layers.\2.linear_layer."),
    (r"^generator\.gnn\.(\d+)\.head\.(\d+)\.attn$",
     r"generator.gnn_layers.\1.gat_layers.\2.attn_layer.weight"),
    (r"^logit_fc\.fc1\.", "logit_fc.0."), (r"^logit_fc\.ln\.", "logit_fc.2."),
    (r"^logit_fc\.fc2\.", "logit_fc.3."), (r"^encoder_adj\.", "encoder_adj.0."),
    (r"^(node_fc|fusion_fc)\.fc\.", r"\1.0."),
    (r"^(node_fc|fusion_fc)\.ln\.", r"\1.2."),
    (r"^generator\.gnn\.(\d+)\.conv\.(\d+)\.",
     r"generator.gnn_layers.\1.gnn_layers.\2."),
    (r"^generator\.gnn\.(\d+)\.proj\.(\d+)\.fc\.",
     r"generator.gnn_layers.\1.linear_prediction.\2.0."),
    (r"^generator\.gnn\.(\d+)\.proj\.(\d+)\.ln\.",
     r"generator.gnn_layers.\1.linear_prediction.\2.2."),
]


def _torch_key(name):
    for pat, rep in _TORCH_KEYS:
        if re.match(pat, name):
            return re.sub(pat, rep, name)
    raise KeyError(name)


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    return path


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqacp"))
    make_synthetic_vqacp(root, "train", n_images=4, n_questions=8,
                         feat_dim=32, pack=True)
    write_vocab(os.path.join(root, "vocab.txt"))
    snaps = tmp_path_factory.mktemp("snapshots")
    enc = _golden_encoder()
    rng = np.random.RandomState(5)
    hid = 2 * 64
    head = {"answer_head.logit_fc.0.weight": rng.randn(hid, 64),
            "answer_head.logit_fc.0.bias": rng.randn(hid),
            "answer_head.logit_fc.2.gamma": 1 + 0.1 * rng.randn(hid),
            "answer_head.logit_fc.2.beta": rng.randn(hid),
            "answer_head.logit_fc.3.weight": rng.randn(len(PRE_ANSWERS), hid),
            "answer_head.logit_fc.3.bias": rng.randn(len(PRE_ANSWERS))}
    head = {k: v.astype(np.float32) for k, v in head.items()}
    with open(snaps / "all_ans.json", "w") as f:
        json.dump([{"ans": a, "dsets": ["vqa"]} for a in PRE_ANSWERS], f)

    # a task model: the encoder, the head and the GGM modules but
    # fusion_fc, under DataParallel's prefix, TF-style LayerNorm names
    trainer = _trainer(root, str(tmp_path_factory.mktemp("probe")))
    task = {f"lxrt_encoder.model.bert.{k}": v for k, v in enc.items()}
    for name, p in trainer.model.state_dict().items():
        if name.startswith(("lxrt.", "fusion_fc.")):
            continue
        key = _torch_key(name)
        if key.startswith("logit_fc.2."):
            key = key.replace(".weight", ".gamma").replace(".bias", ".beta")
        task[key] = rng.randn(*p.shape).astype(np.float32)
    return dict(
        root=root, all_ans=str(snaps / "all_ans.json"),
        enc=_save({f"module.bert.{k}": v for k, v in enc.items()},
                  str(snaps / "enc_LXRT.pth"))[: -len("_LXRT.pth")],
        pre=_save({**{f"bert.{k}": v for k, v in enc.items()}, **head},
                  str(snaps / "pre_LXRT.pth"))[: -len("_LXRT.pth")],
        task=_save({f"module.{k}": v for k, v in task.items()},
                   str(snaps / "task.pth")))


def _trainer(root, out, gnn="GCN"):
    cfg = tiny_test_config().replace(
        data=DataConfig(train="train", valid="", data_root=root), output=out)
    cfg = cfg.replace(ggm=dataclasses.replace(cfg.ggm, gnn=gnn))
    with contextlib.redirect_stdout(io.StringIO()):
        return XGGMTrainer(cfg, task="vqa", use_xpack=True, device="cpu")


def _jax_tree(state):
    """The port's parameters as the JAX package's nested tree (Dense
    kernels [in, out]), each name checked to map back through
    `port_name`."""
    tree = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        parts = []
        for p in path:
            if p.isdigit():  # layer.0 -> layer_0, r_layers.0 -> r_layer_0
                parts[-1] = {"r_layers": "r_layer", "x_layers": "x_layer"
                             }.get(parts[-1], parts[-1]) + f"_{p}"
            else:
                parts.append(p)
        arr = t.numpy()
        if leaf == "bias":
            key = "bias"
        elif arr.ndim == 1:
            key = "scale"
        elif parts[-1].endswith("_embeddings"):
            key = "embedding"
        else:
            key, arr = "kernel", arr.T
        assert port_name("/".join(parts + [key])) == name
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[key] = arr.copy()
    return {"params": tree}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


def _port_layout(flat):
    return {port_name(k): v.T if k.endswith("/kernel") else v
            for k, v in flat.items()}


def _jax_expectation(case, env, init):
    """What JAX's loaders give on the same initial parameters: the port
    names and values, and the lines they print."""
    cfg = jax_tiny_config().lxmert
    params = _jax_tree(init)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if case == "lxmert":
            sd = jax_bridge.strip_prefixes(
                jax_bridge.load_torch_state_dict(env["enc"] + "_LXRT.pth"))
            flat, mapper = jax_bridge.convert_lxrt_bert(
                sd, cfg, torch_prefix="bert.", our_prefix="lxrt")
            assert not mapper.missing
            params, unmatched = jax_bridge.merge_into(params, flat)
            print(f"load_lxmert: {len(flat)} tensors, "
                  f"{len(unmatched)} model params untouched")
        elif case == "lxmert_qa":
            params = jax_answer_table.load_lxmert_qa(
                env["pre"], params, ANSWERS, cfg, env["all_ans"])
        else:
            flat = jax_bridge.convert_task_model(
                jax_bridge.load_torch_state_dict(env["task"]), cfg, "GCN", 2)
            params, unmatched = jax_bridge.merge_into(params, flat)
            print(f"load(torch): {len(flat)} tensors, "
                  f"{len(unmatched)} untouched")
    return _port_layout(_flat(params["params"])), out.getvalue().splitlines()


def test_load_flags_match_jax_conversions(env, tmp_path):
    cases = [
        ("lxmert", ["--loadLXMERT", env["enc"]]),
        ("lxmert_qa", ["--loadLXMERTQA", env["pre"], "--all_ans",
                       env["all_ans"]]),
        ("task", ["--load", env["task"]]),
        # --load wins over both, --loadLXMERT over --loadLXMERTQA
        ("task", ["--load", env["task"], "--loadLXMERT", env["enc"],
                  "--loadLXMERTQA", env["pre"]]),
        ("lxmert", ["--load", "", "--loadLXMERT", env["enc"],
                    "--loadLXMERTQA", env["pre"]]),
        # empty values: from scratch
        (None, ["--load", "", "--loadLXMERT", "", "--loadLXMERTQA", ""]),
    ]
    for case, argv in cases:
        trainer = _trainer(env["root"], str(tmp_path))
        init = {n: t.clone() for n, t in trainer.model.state_dict().items()}
        opt_before = trainer.state.opt_state
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            load_weights(trainer, build_parser().parse_args(argv))
        got = trainer.model.state_dict()
        if case is None:
            assert not out.getvalue()
            assert all(torch.equal(got[n], t) for n, t in init.items())
            continue
        want, lines = _jax_expectation(case, env, init)
        assert out.getvalue().splitlines() == lines, argv
        assert set(want) == set(got)
        for n, t in got.items():
            assert torch.equal(t, torch.tensor(want[n])), (argv, n)
        # what the snapshot lacks keeps its value
        kept = {"lxmert": ("logit_fc.", "generator.", "node_fc."),
                "lxmert_qa": ("generator.", "encoder_adj.", "fusion_fc."),
                "task": ("fusion_fc.",)}[case]
        for n in got:
            if n.startswith(kept):
                assert torch.equal(got[n], init[n]), n
        # a fresh optimizer state for the loaded parameters
        assert trainer.state.opt_state is not opt_before
        assert trainer.state.opt_state.count == 0
        if case == "lxmert_qa":
            assert lines == ["Loaded 10 answers from LXRTQA pre-training "
                             "and 6 not"]
            fc2 = got["logit_fc.fc2.weight"]
            assert (fc2[ANSWERS.index("blue")] == 0).all()
            assert got["logit_fc.fc2.bias"][ANSWERS.index("car")] == 0


def test_answer_table_and_surgery_match_jax(env):
    strings = ["A man", "the woman.", "Two", "grey", "an apple", "the",
               "", "The Dog.", "three", "ten.", "yes", "a  cat"]
    for s in strings:
        assert answer_table.AnswerTable.convert_ans(s) == \
            jax_answer_table.AnswerTable.convert_ans(s), s
    for dsets in (None, ["vqa"], ["gqa"]):
        ours = answer_table.AnswerTable(env["all_ans"], dsets)
        ref = jax_answer_table.AnswerTable(env["all_ans"], dsets)
        assert ours.anss == ref.anss and ours.num_answers == ref.num_answers
    table = answer_table.AnswerTable(env["all_ans"])
    rng = np.random.RandomState(0)
    label2ans = ANSWERS + ["a man", "grey", "zebra"]
    pre_w = rng.randn(len(PRE_ANSWERS), 8).astype(np.float32)
    pre_b = rng.randn(len(PRE_ANSWERS)).astype(np.float32)
    cur_w = rng.randn(len(label2ans), 8).astype(np.float32)
    cur_b = rng.randn(len(label2ans)).astype(np.float32)
    w, b, loaded, unload = answer_table.surger_answer_head(
        pre_w, pre_b, cur_w, cur_b, label2ans, table)
    jw, jb, jloaded, junload = jax_answer_table.surger_answer_head(
        pre_w.T, pre_b, cur_w.T, cur_b, label2ans,
        jax_answer_table.AnswerTable(env["all_ans"]))
    np.testing.assert_array_equal(w, jw.T)
    np.testing.assert_array_equal(b, jb)
    assert (loaded, unload) == (jloaded, junload) == (12, 7)


def test_refusals(env, tmp_path):
    cfg = tiny_test_config().lxmert
    sd = torch_bridge.load_torch_state_dict(env["task"])
    with pytest.raises(ValueError, match="GNN"):
        torch_bridge.convert_task_model(sd, cfg, "GNN", 2)
    # --load x.pth of a GIN and of a GAT task model: the port trainer's
    # state equals JAX's convert_task_model + merge_into on the same
    # initial parameters; GAT's merge projections (no reference key) keep
    # their values
    rng = np.random.RandomState(6)
    for gnn in ("GIN", "GAT"):
        trainer = _trainer(env["root"], str(tmp_path / gnn), gnn)
        init = to_jax_params(trainer.model)
        task = {k: v for k, v in sd.items()
                if not k.startswith("module.generator.")}
        for name, p in trainer.model.state_dict().items():
            if name.startswith("generator.") and ".merge." not in name:
                v = rng.randn(*p.shape).astype(np.float32)
                task[f"module.{_torch_key(name)}"] = (
                    v.T if name.endswith(".attn") else v)
        path = _save(task, str(tmp_path / f"{gnn}.pth"))
        with contextlib.redirect_stdout(io.StringIO()):
            load_weights(trainer, build_parser().parse_args(["--load", path]))
        flat = jax_bridge.convert_task_model(
            jax_bridge.load_torch_state_dict(path),
            jax_tiny_config().lxmert, gnn, 2, 2)
        params, _ = jax_bridge.merge_into(
            {"params": _unflatten({k[len("params/"):]: v
                                   for k, v in init.items()})}, flat)
        want = _port_layout(_flat(params["params"]))
        got = trainer.model.state_dict()
        assert set(want) == set(got), gnn
        for n, t in got.items():
            assert torch.equal(t, torch.tensor(want[n])), (gnn, n)
        merge = [n for n in got if n.startswith("generator.merge.")]
        assert bool(merge) == (gnn == "GAT")
        jax_key = {port_name(k): k for k in init}
        for n in merge:
            w = init[jax_key[n]]
            assert torch.equal(got[n], torch.tensor(
                w.T if n.endswith("weight") else w)), n
    trainer = _trainer(env["root"], str(tmp_path))
    with pytest.raises(KeyError, match="no counterpart"):
        torch_bridge.merge_into(trainer.model,
                                {"lxrt/encoder/layer_7/mlp/output/bias":
                                 np.zeros(64, np.float32)})
    # a shape that does not fit: reported untouched, the value kept
    before = trainer.model.logit_fc.fc2.bias.detach().clone()
    untouched = torch_bridge.merge_into(
        trainer.model, {"logit_fc/fc2/bias": np.zeros(3, np.float32)})
    assert "logit_fc.fc2.bias: shape (3,) vs (16,)" in untouched
    assert "logit_fc.fc2.bias" not in untouched
    assert len(untouched) == len(trainer.model.state_dict())
    assert torch.equal(trainer.model.logit_fc.fc2.bias, before)
    # an LXMERT-QA snapshot must hold every encoder key
    pre = torch_bridge.load_torch_state_dict(env["pre"] + "_LXRT.pth")
    del pre["bert.pooler.dense.bias"]
    path = _save(pre, str(tmp_path / "partial_LXRT.pth"))
    with pytest.raises(AssertionError, match="encoder keys missing"):
        trainer.load_lxmert_qa(path, env["all_ans"])
