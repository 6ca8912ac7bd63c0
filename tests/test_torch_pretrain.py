"""The port's LXMERT pretraining against the JAX package's, and against the
reference-traced goldens.

* Data: `make_synthetic_pretrain` writes JAX's files byte for byte; the TSV
  reader, the dataset over H5 and over TSV, `flatten`, the featurizer's
  batches for one seed over several calls and the QA evaluator equal
  JAX's exactly.
* Model: `PretrainModel.compute_losses` on JAX's initial parameters
  (`from_jax_params`), fp32, deterministic: the total, the six losses and
  the answer logits within 2e-5, every gradient within 1e-5 of one
  `jax.jit(jax.grad)`; `to_jax_params` gives JAX's tree back; and
  `goldens/pretrain_tiny.npz` through `convert_pretrain_model` at the
  tolerances of tests/test_pretrain.py.
* Trajectory: `goldens/pretrain_traj_tiny.npz`'s 4 steps (BertAdam lr 1e-3,
  warmup 0.05, t_total 8, clip 1.0, one update per batch), no JAX needed.
* Pretrainer and CLI: the port's `LxmertPretrainer` against JAX's on one
  corpus at depth 1/1/1, fp32, dropout 0, `accum_steps` 2 with a trailing
  partial group: every microbatch's losses within rtol 1e-4, the final
  parameters within atol 1e-5, BertAdam's counters exactly, the validation
  loss; a run preempted after its first update and resumed equals the
  uninterrupted one exactly; then `cli.pretrain` in a subprocess with jax,
  flax and h5py blocked, on a TSV corpus: an epoch, `--load Epoch01` for
  another, exit 75 on a real SIGTERM and `--resume`.
* On a card (`gpu`): one bf16 pretraining step's loss and gradients through
  kernels 2 and 3 against the plain attention fed the same Philox masks,
  and the deterministic loss through kernel 1 against the plain forward.
  This file imports JAX only inside its CPU tests, so that
  `pytest --noconftest -m gpu tests/test_torch_pretrain.py` runs on a
  machine without JAX.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from xggm_tpu_torch.checkpoint.jax_params import (
    from_jax_params, port_name, to_jax_params)
from xggm_tpu_torch.checkpoint.torch_bridge import (
    convert_pretrain_model, merge_into)
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.data import pretrain_data
from xggm_tpu_torch.data.synthetic_pretrain import make_synthetic_pretrain
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.models.pretrain_model import LOSSES_NAME, PretrainModel
from xggm_tpu_torch.ops.basic import DropoutRng, init_weights
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import TrainState, _grads, apply_grads
from xggm_tpu_torch.utils.preempt import Preempted, PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
SOURCE = "mscoco_train"
# 9 images x (2 captions + 2 questions): 36 sentences, 9 batches of 4, so
# accum_steps 2 gives 4 updates and drops one microbatch
N_IMAGES, SENTS, FEAT_DIM, BS, ACCUM = 9, 2, 32, 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: tiny shapes, and torch's and XLA's thread pools
    contend in one process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feat_paths(root, source=SOURCE):
    d = os.path.join(root, "lxmert_imgfeat")
    return (os.path.join(d, f"{source}_obj36.h5"),
            os.path.join(d, f"{source}_obj36_info.json"),
            os.path.join(d, f"{source}_obj36.tsv"))


def _featurizer(mod, root, fmt="h5", seed=0, qa_sets=None):
    """A featurizer of package `mod` ({'data': pretrain_data module,
    'tok': BertTokenizer}) over the corpus at `root`."""
    ds = mod["data"].LxmertPretrainDataset(SOURCE, root, qa_sets)
    h5, info, tsv = _feat_paths(root)
    if fmt == "h5":
        ds.load_features_h5(h5, info)
    else:
        ds.load_features_tsv(tsv)
    tok = mod["tok"].from_file(os.path.join(root, "vocab.txt"))
    return mod["data"].PretrainFeaturizer(ds, tok, max_seq_length=20,
                                          seed=seed)


PORT = {"data": pretrain_data, "tok": BertTokenizer}


def _jax_modules():
    from xggm_tpu.data import pretrain_data as jax_data
    from xggm_tpu.data.tokenizer import BertTokenizer as JaxTokenizer

    return {"data": jax_data, "tok": JaxTokenizer}


def _write_corpus(root, tsv=False):
    make_synthetic_pretrain(root, SOURCE, n_images=N_IMAGES,
                            sents_per_img=SENTS, feat_dim=FEAT_DIM, tsv=tsv)


def _assert_same_record(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_data_matches_jax(tmp_path):
    from xggm_tpu.data.synthetic_pretrain import (
        make_synthetic_pretrain as jax_make)

    jax_root, root, tsv_root = (str(tmp_path / d) for d in ("j", "p", "t"))
    jax_make(jax_root, SOURCE, n_images=N_IMAGES, sents_per_img=SENTS,
             feat_dim=FEAT_DIM)
    _write_corpus(root)
    _write_corpus(tsv_root, tsv=True)
    files = sorted(os.path.relpath(os.path.join(d, f), jax_root)
                   for d, _, fs in os.walk(jax_root) for f in fs)
    assert len(files) == 5
    for f in files:
        with open(os.path.join(jax_root, f), "rb") as a, \
                open(os.path.join(root, f), "rb") as b:
            assert a.read() == b.read(), f
    assert sorted(os.listdir(os.path.join(tsv_root, "lxmert_imgfeat"))) == \
        [f"{SOURCE}_obj36.tsv"]

    jax_mod = _jax_modules()
    tsv = _feat_paths(tsv_root)[2]
    ours, theirs = (m["data"].load_obj_tsv(tsv) for m in (PORT, jax_mod))
    assert len(ours) == N_IMAGES
    for a, b in zip(ours, theirs):
        _assert_same_record(a, b)
    assert len(pretrain_data.load_obj_tsv(tsv, topk=3)) == 3

    for qa_sets in (None, ["gqa"]):
        jax_feat = _featurizer(jax_mod, jax_root, "h5", qa_sets=qa_sets)
        for fmt, r in (("h5", root), ("tsv", tsv_root)):
            feat = _featurizer(PORT, r, fmt, qa_sets=qa_sets)
            assert feat.ds.data == jax_feat.ds.data
            assert feat.ds.num_answers == jax_feat.ds.num_answers
            assert set(feat.ds.img_data) == set(jax_feat.ds.img_data)
            for img_id, rec in jax_feat.ds.img_data.items():
                _assert_same_record(feat.ds.img_data[img_id], rec)
            assert [dataclasses.astuple(e) for e in feat.examples] == \
                [dataclasses.astuple(e) for e in jax_feat.examples]
    assert len(jax_feat.examples) == N_IMAGES * 2 * SENTS

    # the featurizer: the same seed gives the same batches, call for call
    jax_feat = _featurizer(jax_mod, jax_root, "h5", seed=3)
    feat = _featurizer(PORT, tsv_root, "tsv", seed=3)
    order = np.random.RandomState(0)
    masked_words = masked_objects = 0
    for n in (4, 7, 36, 1):
        idx = order.permutation(len(feat))[:n].tolist()
        (ours, uids), (theirs, juids) = feat.featurize(idx), \
            jax_feat.featurize(idx)
        assert uids == juids
        _assert_same_record(ours, theirs)
        masked_words += int((ours["lm_labels"] != -1).sum())
        masked_objects += int((ours["feat_mask"] > 0).sum())
    assert masked_words and masked_objects

    # the evaluator, on random answers and on the gold ones
    rng = np.random.RandomState(1)
    table = feat.ds.answer_table
    uid2ans = {ex.uid: table.id2ans(rng.randint(table.num_answers))
               for ex in feat.examples}
    gold = {ex.uid: table.id2ans(max(ex.label, key=ex.label.get))
            for ex in feat.examples if ex.label}
    ev = pretrain_data.LxmertPretrainEvaluator(feat.ds)
    jax_ev = jax_mod["data"].LxmertPretrainEvaluator(jax_feat.ds)
    for answers in (uid2ans, gold):
        assert ev.evaluate(answers) == jax_ev.evaluate(answers)
    assert ev.evaluate(gold)[0] == pytest.approx(1.0)


def _tiny_lxmert(module, **visual):
    """tiny_test_config's encoder of package config `module`, fp32, with
    dropout 0 and the given VisualConfig fields."""
    lx = module.tiny_test_config().lxmert
    return lx.replace(
        bert=dataclasses.replace(lx.bert, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0),
        visual=dataclasses.replace(lx.visual, **visual))


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def _named_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return dict(zip(names, grads))


def _golden_batch(z, prefix):
    g = lambda k: z[prefix + k]  # noqa: E731
    conf = g("conf")
    return _port_batch({
        "input_ids": g("input_ids"), "input_mask": g("input_mask"),
        "segment_ids": g("segment_ids"), "feats": g("feats"),
        "boxes": g("boxes"), "lm_labels": g("lm_labels"),
        "matched_labels": g("matched"), "obj_labels": g("obj_labels"),
        "obj_mask": conf, "attr_labels": g("attr_labels"),
        "attr_mask": conf, "feat_labels": g("feat_target"),
        "feat_mask": conf, "ans": g("ans")})


def _golden_model(z):
    """The golden's reference LXRTPretraining on a port PretrainModel
    (tiny encoder, 16 answers) through `convert_pretrain_model`."""
    import xggm_tpu_torch.config as cfg_mod

    lx = cfg_mod.tiny_test_config().lxmert
    model = PretrainModel(lx, num_answers=16, device="cpu")
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    assert "cls.predictions.decoder.weight" in sd
    untouched = merge_into(model, convert_pretrain_model(sd, lx))
    assert not untouched, untouched[:8]
    return model


def test_model_matches_jax_and_goldens(tmp_path):
    import jax

    import xggm_tpu.config as jax_config
    import xggm_tpu_torch.config as port_config
    from xggm_tpu.models.pretrain_model import PretrainModel as JaxModel
    from xggm_tpu.serving.artifact import _flatten, _unflatten
    from xggm_tpu.training.steps import _path_str

    root = str(tmp_path / "data")
    _write_corpus(root)
    feat = _featurizer(PORT, root)
    batch, _ = feat.featurize(list(range(6)))
    assert (batch["matched_labels"] == 0).any() and (batch["ans"] >= 0).any()

    jax_model = JaxModel(_tiny_lxmert(jax_config),
                         num_answers=feat.ds.num_answers)
    model = init_weights(
        PretrainModel(_tiny_lxmert(port_config), feat.ds.num_answers,
                      device="cpu"), torch.Generator().manual_seed(0))
    # every parameter moved off its init: at the init, visn_fc's bias is 0,
    # so a masked (zeroed) object's features reach a LayerNorm as an
    # all-zero row, whose gradient eps 1e-12 scales by 1e6
    noise = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=noise) * 0.02)
    flat = to_jax_params(model)
    # the JAX model's own tree, key for key and shape for shape
    tree = jax.eval_shape(
        jax_model.init, {"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
        batch["input_ids"], batch["input_mask"], batch["segment_ids"],
        batch["feats"], batch["boxes"])
    shapes = {_path_str(path): leaf.shape for path, leaf
              in jax.tree_util.tree_leaves_with_path(tree)}
    assert {k: v.shape for k, v in flat.items()} == shapes
    assert list(flat) == list(shapes)
    back = from_jax_params(flat, model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())

    def jax_loss(p):
        total, losses, logits = jax_model.apply(
            p, batch, deterministic=True, method=JaxModel.compute_losses)
        return total, (losses, logits)

    (jtotal, (jlosses, jlogits)), jgrads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(_unflatten(flat))

    total, losses, logits = model.compute_losses(_port_batch(batch))
    assert list(losses) == list(LOSSES_NAME)
    for k in LOSSES_NAME:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=2e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-5, atol=2e-5)
    grads = _named_grads(model, total)
    jflat = _flatten(jgrads)
    assert len(jflat) == len(grads)
    for key, want in jflat.items():
        got = grads[port_name(key)].numpy()
        np.testing.assert_allclose(got.T if key.endswith("/kernel") else got,
                                   want, rtol=1e-5, atol=1e-5, err_msg=key)
    # the tied decoder's gradient reaches row 0 of the word table
    word = "lxrt.embeddings.word_embeddings.weight"
    assert grads[word][0].abs().max() > 0

    # the golden of the reference LXRTPretraining
    z = np.load(os.path.join(GOLDENS, "pretrain_tiny.npz"))
    gmodel = _golden_model(z)
    with torch.no_grad():
        total, losses, logits = gmodel.compute_losses(
            _golden_batch(z, "in::"))
    np.testing.assert_allclose([float(losses[k]) for k in LOSSES_NAME],
                               z["losses"], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(float(total), float(z["total"]), rtol=5e-4)
    np.testing.assert_allclose(logits.numpy(), z["ans_logit"], rtol=1e-3,
                               atol=2e-4)


def test_trajectory_matches_golden():
    """4 steps of the reference pretraining loop (BertAdam lr 1e-3, warmup
    0.05, t_total 8, clip 1.0, one update per batch) replayed: the total and
    the six losses per step, and the final pooler weight."""
    z = np.load(os.path.join(GOLDENS, "pretrain_traj_tiny.npz"))
    model = _golden_model(z)
    batches = [_golden_batch(z, "b0::"), _golden_batch(z, "b1::")]
    opt = BertAdam(lr=1e-3, warmup=0.05, t_total=8)
    state = TrainState.create(model, opt)
    seq = []
    for i in range(4):
        total, losses, _ = model.compute_losses(batches[i % 2])
        seq.append([float(total.detach())]
                   + [float(losses[k].detach()) for k in LOSSES_NAME])
        apply_grads(opt, state, _grads(total, state), 1.0)
    np.testing.assert_allclose(np.asarray(seq, np.float32), z["loss_seq"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        model.lxrt.pooler.dense.weight.detach().numpy().T,
        z["final_pooler_kernel"], rtol=1e-3, atol=2e-5)
    assert state.opt_state.count == 4


def _train_cfg(module, out, valid=True):
    """tiny_test_config at depth 1/1/1, fp32, dropout 0, batch BS,
    accum_steps ACCUM, one epoch."""
    cfg = module.tiny_test_config()
    return cfg.replace(
        lxmert=_tiny_lxmert(module, l_layers=1, x_layers=1, r_layers=1),
        train=dataclasses.replace(cfg.train, batch_size=BS, lr=1e-3,
                                  epochs=1, seed=0, accum_steps=ACCUM),
        output=out)


def _recording(step, record):
    """`step` (a grad_step), noting each microbatch's total and losses."""
    def wrapped(*args):
        out = step(*args)
        total, losses = out[-3], out[-2]
        record.append([float(total)] + [float(losses[k])
                                        for k in LOSSES_NAME])
        return out
    return wrapped


def _port_trainer(root, out, flat0):
    from xggm_tpu_torch.training.pretrainer import LxmertPretrainer
    import xggm_tpu_torch.config as port_config

    t = LxmertPretrainer(_train_cfg(port_config, out), _featurizer(PORT, root),
                         _featurizer(PORT, root), device="cpu")
    t.model.load_state_dict(from_jax_params(flat0, t.model))
    t.record = []
    t.grad_step = _recording(t.grad_step, t.record)
    return t


CLI = r"""
import functools, os, signal, sys
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import xggm_tpu_torch.cli.common as common
from xggm_tpu_torch.config import BertConfig
common.BertConfig = functools.partial(
    BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=64)
from xggm_tpu_torch.cli import pretrain
from xggm_tpu_torch.data.synthetic_pretrain import make_synthetic_pretrain
from xggm_tpu_torch.training.pretrainer import LxmertPretrainer

root, out = sys.argv[1], sys.argv[2]
for i, source in enumerate(("mscoco_train", "mscoco_minival")):
    make_synthetic_pretrain(root, source, n_images=4, sents_per_img=2,
                            feat_dim=2048, seed=i, tsv=True)
base = ["--device", "cpu", "--dtype", "float32", "--data_root", root,
        "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--bs", "4",
        "--lr", "1e-4", "--epochs", "1", "--taskMaskLM", "--taskObjPredict", "--taskMatched",
        "--taskQA", "--visualLosses", "obj,attr,feat", "--qaSets", "vqa,gqa",
        "--train", "mscoco_train", "--valid", "mscoco_minival",
        "--fromScratch"]
t = pretrain.main(base + ["--output", out])
print("COUNT", t.state.opt_state.count, t.t_total)
t = pretrain.main(base + ["--output", out, "--load", "Epoch01"])
print("COUNT", t.state.opt_state.count, t.t_total)

step = LxmertPretrainer.train_step
def sigterm_after_first(self, *args):
    res = step(self, *args)
    os.kill(os.getpid(), signal.SIGTERM)
    return res
LxmertPretrainer.train_step = sigterm_after_first
try:
    pretrain.main(base + ["--output", out + "_b"])
except SystemExit as e:
    print("EXIT", e.code, os.path.isdir(os.path.join(out + "_b", "PREEMPT")))
LxmertPretrainer.train_step = step
t = pretrain.main(base + ["--output", out + "_b", "--resume"])
print("COUNT", t.state.opt_state.count, t.t_total)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "flax", "h5py", "xggm_tpu"))
print("LEAKED", leaked)
"""


def test_pretrainer_and_cli_match_jax(tmp_path, monkeypatch):
    import jax

    import xggm_tpu.config as jax_config
    from xggm_tpu.models.pretrain_model import PretrainModel as JaxModel
    from xggm_tpu.serving.artifact import _flatten
    from xggm_tpu.training.pretrainer import LxmertPretrainer as JaxTrainer

    root = str(tmp_path / "data")
    _write_corpus(root)
    jax_mod = _jax_modules()
    from test_torch_train_step import _numpy_params

    # the JAX trainer's initial parameters drawn with numpy on its own tree
    init = JaxModel.init
    monkeypatch.setattr(JaxModel, "init", lambda self, rngs, *args:
                        _numpy_params(jax.eval_shape(
                            lambda r: init(self, r, *args), rngs)))
    jax_t = JaxTrainer(_train_cfg(jax_config, str(tmp_path / "jax")),
                       _featurizer(jax_mod, root), _featurizer(jax_mod, root))
    monkeypatch.undo()
    flat0 = _flatten(jax_t.params)
    jax_record = []
    jax_t.grad_step = _recording(jax_t.grad_step, jax_record)

    port_t = _port_trainer(root, str(tmp_path / "a"), flat0)
    assert port_t.t_total == 4
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        jax_best = jax_t.train()
        best = port_t.train()
    assert len(port_t.record) == len(jax_record) == 2 * 4
    np.testing.assert_allclose(port_t.record, jax_record, rtol=1e-4)
    np.testing.assert_allclose(best, jax_best, rtol=1e-4)
    state = port_t.model.state_dict()
    jax_final = _flatten(jax_t.state.params)
    for key, want in jax_final.items():
        got = state[port_name(key)].numpy()
        np.testing.assert_allclose(got.T if key.endswith("/kernel") else got,
                                   want, rtol=0, atol=1e-5, err_msg=key)
    jax_counts = _flatten(jax_t.state.opt_state.leaf_count)
    counts = port_t.state.opt_state.leaf_counts()
    assert {port_name(k): int(v) for k, v in jax_counts.items()} == counts
    assert port_t.state.opt_state.count == \
        int(np.asarray(jax_t.state.opt_state.count)) == 4
    lines = stdout.getvalue().splitlines()
    epoch = [ln for ln in lines if ln.startswith("Epoch 0: train loss ")]
    assert len(epoch) == 2 and all(f" {k}: " in ln for ln in epoch
                                   for k in LOSSES_NAME)
    for name in ("Epoch01", "BEST_EVAL_LOSS"):
        assert port_t.ckpt.exists(name)
    assert not port_t.ckpt.exists("PREEMPT")

    # preempted after its first update, then resumed: the run above
    out = str(tmp_path / "b")
    t = _port_trainer(root, out, flat0)
    t.preempt = PreemptionGuard(install=False)
    t.preempt.notify()
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(Preempted):
        t.train()
    assert t.record == port_t.record[:ACCUM]
    t = _port_trainer(root, out, flat0)
    init_weights(t.model, torch.Generator().manual_seed(5))
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert t.resume() == 0
        assert t.train(0) == best
    assert "resumed from PREEMPT (epoch 0, 2 batches done)" in \
        stdout.getvalue().splitlines()
    assert t.record == port_t.record[ACCUM:]
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert t.state.opt_state.leaf_counts() == counts
    assert not t.ckpt.exists("PREEMPT")

    # the CLI without jax, flax or h5py, on a TSV corpus
    proc = subprocess.run(
        [sys.executable, "-c", CLI, str(tmp_path / "cli_data"),
         str(tmp_path / "cli")], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "LEAKED []" in lines
    # 16 sentences: 4 batches of 4 per epoch, t_total 4
    assert [ln for ln in lines if ln.startswith("COUNT")] == \
        ["COUNT 4 4", "COUNT 8 4", "COUNT 4 4"]
    assert "EXIT 75 True" in lines
    assert "resumed from PREEMPT (epoch 0, 1 batches done)" in lines
    # an epoch line per completed epoch: the preempted one has none
    epoch = [ln for ln in lines if ln.startswith("Epoch 0: train loss ")]
    assert len(epoch) == 3 and all(f" {k}: " in ln for ln in epoch
                                   for k in LOSSES_NAME)
    assert sum(ln.startswith("train QA accuracy: ") for ln in lines) == 3
    assert sum(ln.startswith("valid QA accuracy: ") for ln in lines) == 3
    assert sum(ln.startswith("Best eval loss: ") for ln in lines) == 3
    for out, names in ((str(tmp_path / "cli"), ("Epoch01", "BEST_EVAL_LOSS")),
                       (str(tmp_path / "cli_b"),
                        ("Epoch01", "BEST_EVAL_LOSS"))):
        for name in names:
            assert os.path.isdir(os.path.join(out, name)), (out, name)
        assert not os.path.exists(os.path.join(out, "PREEMPT"))
    with open(os.path.join(tmp_path, "cli", "log.log")) as f:
        assert sum(ln.startswith("Epoch 0: train loss ") for ln in f) == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernels_vs_plain(device, root):
    """One bf16 training step's loss and gradients of a small pretraining
    model (tiny_test_config with hidden 128 in 2 heads of 64, the head
    width the kernels take) on `device`, through the attention wrappers
    and through the plain attention fed the same Philox masks; then the
    deterministic loss both ways. Returns the wrappers' launches of the
    kernel-driven passes, the attentions of one forward, and the
    differences."""
    from unittest import mock

    from xggm_tpu_torch.ops import attention as attn
    from xggm_tpu_torch.ops.philox import dropout_keep

    feat = _featurizer(PORT, root, "tsv")
    lx = tiny_test_config().lxmert
    lx = lx.replace(bert=dataclasses.replace(
        lx.bert, hidden_size=128, num_attention_heads=2,
        intermediate_size=256), dtype="bfloat16")
    model = init_weights(
        PretrainModel(lx, feat.ds.num_answers, device=device),
        torch.Generator(device=device).manual_seed(0))
    batch = {k: v.to(device) for k, v in
             _port_batch(feat.featurize(list(range(8)))[0]).items()}
    params = list(model.parameters())

    def loss_and_grads():
        total = model.compute_losses(batch, DropoutRng(7, device))[0]
        return float(total.detach()), torch.autograd.grad(total, params)

    def plain_dropout(q, k, v, bias, heads, seed, rate):
        keep = dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1], rate,
                            q.device)
        return attn.attention_dropout_reference(q, k, v, bias, heads, keep)

    counters = (attn.attention_dropout_fwd, attn.attention_dropout_bwd,
                attn.fused_attention)
    before = [c.launches for c in counters]
    loss_k, grads_k = loss_and_grads()
    with torch.no_grad():
        det_k = float(model.compute_losses(batch)[0])
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = [c.launches - b for c, b in zip(counters, before)]
    with mock.patch.object(attn, "fused_attention_dropout", plain_dropout):
        loss_p, grads_p = loss_and_grads()
    with torch.no_grad(), mock.patch.object(attn, "fused_attention",
                                            attn.attention_reference):
        det_p = float(model.compute_losses(batch)[0])
    diff = torch.stack([(a.float() - b.float()).norm()
                        for a, b in zip(grads_k, grads_p)])
    norm = torch.stack([b.float().norm() for b in grads_p])
    v = lx.visual
    return dict(
        launches=launches,
        per_forward=v.l_layers + v.r_layers + 4 * v.x_layers,
        loss=abs(loss_k - loss_p) / abs(loss_p),
        det_loss=abs(det_k - det_p) / abs(det_p),
        grads=float(diff.norm() / norm.norm()),
        worst=float(torch.where(norm > 0, diff / norm, 0.0).max()))


@pytest.mark.gpu
def test_pretrain_step_kernels_match_plain_attention(cuda, tmp_path):
    """On the card: one training step through kernels 2 and 3 (one launch
    of each per attention of the forward) against the plain attention fed
    the same Philox masks, within the gates of chip_smoke.py's phase 8
    (loss 1e-4 relative, gradients 1e-2 relative L2 overall and 5e-2 per
    parameter); the deterministic loss through kernel 1 (one launch per
    attention) against the plain forward within 1e-4."""
    root = str(tmp_path / "data")
    _write_corpus(root, tsv=True)
    got = _kernels_vs_plain(cuda, root)
    n = got["per_forward"]
    assert got["launches"] == [n, n, n], got
    assert got["loss"] <= 1e-4 and got["det_loss"] <= 1e-4, got
    assert got["grads"] <= 1e-2 and got["worst"] <= 5e-2, got
