"""The port's data layer against the JAX package's.

On one synthetic corpus (the JAX package's writers, H5): the datasets'
records, token arrays and batches exactly equal, `--tiny` truncation, the
evaluators' scores and dump files, `oracle_score`; the feature pack written
from arrays (`make_synthetic_gqa(pack=True)`, no H5) byte for byte equal to
JAX's `convert_h5_to_xpack` of the H5 corpus, read through the native
loader and the numpy memmap alike; the feeder's index order, padding masks
and batches against JAX's `Feeder` over two shuffled epochs and
`set_position`, and a producer error re-raised; `MultiEpochsFeeder` over
three epochs and `Prefetcher` against JAX's; `check_step_finite` and
`MetricsLogger` against JAX's. Torch runs on one thread (tiny shapes), and
the tests loop over their cases (see tests/test_torch_attention_dropout.py
for why the files hold few tests).
"""
import argparse
import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.config import DataConfig as JaxDataConfig
from xggm_tpu.data import datasets as jax_ds
from xggm_tpu.data import xpack as jax_xpack
from xggm_tpu.data.feeder import Feeder as JaxFeeder
from xggm_tpu.data.feeder import MultiEpochsFeeder as JaxMultiEpochsFeeder
from xggm_tpu.data.feeder import Prefetcher as JaxPrefetcher
from xggm_tpu.data.synthetic import make_synthetic_gqa as jax_make_gqa
from xggm_tpu.data.synthetic import make_synthetic_vqacp as jax_make_vqacp
from xggm_tpu.data.synthetic import write_vocab as jax_write_vocab
from xggm_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from xggm_tpu.training.metrics import MetricsLogger as JaxMetricsLogger
from xggm_tpu.utils.guard import TrainingDiverged as JaxDiverged
from xggm_tpu.utils.guard import check_step_finite as jax_check_step_finite
from xggm_tpu_torch.cli.common import dump_args
from xggm_tpu_torch.config import DataConfig
from xggm_tpu_torch.data import datasets as ds
from xggm_tpu_torch.data import xpack
from xggm_tpu_torch.data.feeder import Feeder, MultiEpochsFeeder, Prefetcher
from xggm_tpu_torch.data.synthetic import make_synthetic_gqa
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.training.metrics import MetricsLogger
from xggm_tpu_torch.utils.guard import TrainingDiverged, check_step_finite

FEAT = 8
# more question records than TINY_IMG_NUM (512), so that --tiny truncates
N_QUESTIONS, N_IMAGES = 600, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    jax_make_gqa(root, "train", n_images=N_IMAGES, n_questions=N_QUESTIONS,
                 feat_dim=FEAT, seed=0)
    jax_make_vqacp(root, "train", n_images=N_IMAGES, n_questions=40,
                   feat_dim=FEAT, seed=1)
    vocab = os.path.join(root, "vocab.txt")
    jax_write_vocab(vocab)
    return root, vocab


def _pairs(root, vocab, tiny=False, store=None):
    """(JAX, port) GraphBatchDatasets of both tasks over `root`."""
    out = []
    for name in ("GQADataset", "VQACPDataset"):
        jraw = getattr(jax_ds, name)("train", JaxDataConfig(data_root=root,
                                                            tiny=tiny))
        praw = getattr(ds, name)("train", DataConfig(data_root=root,
                                                     tiny=tiny))
        pstore = store if name == "GQADataset" else None
        out.append((name, jraw, praw,
                    jax_ds.GraphBatchDataset(jraw, JaxTokenizer.from_file(vocab)),
                    ds.GraphBatchDataset(praw, BertTokenizer.from_file(vocab),
                                         store=pstore)))
    return out


def test_datasets_batches_and_evaluators_match_jax(corpus, tmp_path):
    root, vocab = corpus
    idx = np.array([5, 0, 3, 3, 17])
    for tiny in (False, True):
        for name, jraw, praw, jset, pset in _pairs(root, vocab, tiny):
            assert praw.data == jraw.data and praw.label2ans == jraw.label2ans
            assert praw.ans2label == jraw.ans2label
            assert len(pset) == len(jset), (name, tiny)
            for a, b in zip(pset.records, jset.records):
                assert (a.question_id, a.img_id, a.sent, a.label_dict) == \
                    (b.question_id, b.img_id, b.sent, b.label_dict)
                np.testing.assert_array_equal(a.target, b.target)
            for k in ("input_ids", "input_mask", "segment_ids"):
                np.testing.assert_array_equal(getattr(pset, k),
                                              getattr(jset, k))
            got, want = pset.get_batch(idx), jset.get_batch(idx)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert ds.oracle_score(pset) == jax_ds.oracle_score(jset)

            # evaluators: a mix of right and wrong answers, and the dumps
            ev, jev = ((ds.GQAEvaluator, jax_ds.GQAEvaluator)
                       if name == "GQADataset"
                       else (ds.VQAEvaluator, jax_ds.VQAEvaluator))
            rng = np.random.RandomState(3)
            answers = {r.question_id: praw.label2ans[
                rng.randint(praw.num_answers)] for r in pset.records}
            assert ev(praw).evaluate(answers) == jev(jraw).evaluate(answers)
            ev.dump_result(answers, str(tmp_path / "p.json"))
            jev.dump_result(answers, str(tmp_path / "j.json"))
            assert filecmp.cmp(tmp_path / "p.json", tmp_path / "j.json",
                               shallow=False)
        n_gqa = len(_pairs(root, vocab, tiny)[0][3])
        assert n_gqa == (ds.TINY_IMG_NUM if tiny else N_QUESTIONS)


def test_pack_equals_jax_conversion_on_both_gather_paths(
        corpus, tmp_path, monkeypatch):
    root, vocab = corpus
    feat = os.path.join(root, "gqa_imgfeat")
    h5 = [os.path.join(feat, f) for f in
          ("train_obj36.h5", "train_obj36_info.json",
           "train_obj36_adj_v2.h5")]
    want = jax_xpack.convert_h5_to_xpack(*h5, str(tmp_path / "jax.xpack"),
                                         feat_dim=FEAT)
    mine = xpack.convert_h5_to_xpack(*h5, str(tmp_path / "port.xpack"),
                                     feat_dim=FEAT)
    packed = str(tmp_path / "packed")
    make_synthetic_gqa(packed, "train", n_images=N_IMAGES,
                       n_questions=N_QUESTIONS, feat_dim=FEAT, seed=0,
                       pack=True)
    pfeat = os.path.join(packed, "gqa_imgfeat")
    assert sorted(os.listdir(pfeat)) == [
        "train_obj36.xpack", "train_obj36.xpack.index.json",
        "train_obj36_info.json"]
    written = os.path.join(pfeat, "train_obj36.xpack")
    for path in (mine, written):
        assert filecmp.cmp(path, want, shallow=False), path
        assert filecmp.cmp(path + ".index.json", want + ".index.json",
                           shallow=False), path
    for rel in ("gqa_ood/train.json", "gqa_ood/trainval_ans2label.json",
                "gqa_ood/trainval_label2ans.json",
                "gqa_imgfeat/train_obj36_info.json"):
        assert json.load(open(os.path.join(packed, rel))) == \
            json.load(open(os.path.join(root, rel))), rel

    assert xpack.ensure_native() is not None, "libxpack.so did not build"
    rows = [3, 0, 7, 7, 1]
    ref = jax_xpack.XPack(want)
    ref_rows = ref.gather_rows(rows)
    jset = _pairs(root, vocab)[0][3]
    idx = np.array([5, 0, 3, 3, 17, 599])
    for native in (True, False):
        if not native:  # the path taken where libxpack.so cannot be built
            monkeypatch.setattr(xpack, "ensure_native", lambda: None)
        pack = xpack.XPack(written)
        assert pack.native is native
        np.testing.assert_array_equal(pack.gather_rows(rows), ref_rows)
        job, out = pack.submit(rows)
        pack.wait(job)
        np.testing.assert_array_equal(out, ref_rows)
        for k, v in pack.unpack(ref_rows).items():
            np.testing.assert_array_equal(v, ref.unpack(ref_rows)[k])
        with pytest.raises(IndexError):
            pack.gather_rows([len(pack.img_ids)])
        pack.close()
        # the pack store in the dataset, against JAX's H5 batches
        store = xpack.XPackFeatureStore(written)
        pset = _pairs(root, vocab, store=store)[0][4]
        got, jb = pset.get_batch(idx), jset.get_batch(idx)
        for k in jb:
            np.testing.assert_array_equal(got[k], jb[k], err_msg=k)
        for a, b in zip(store.get("synth_train_4"),
                        jset.store.get("synth_train_4")):
            np.testing.assert_array_equal(a, b)
        store.close()
    ref.close()


class _Cached:
    """A feature store's records held in memory (H5 reads are slow)."""

    def __init__(self, store):
        self.items = {i: store.get(i) for i in store.img_ids()}

    def has(self, img_id):
        return img_id in self.items

    def get(self, img_id):
        return self.items[img_id]


class _Failing:
    """A dataset whose third batch fails to assemble."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __len__(self):
        return len(self.inner)

    def question_ids(self, idx):
        return self.inner.question_ids(idx)

    def get_batch(self, idx):
        self.calls += 1
        if self.calls == 3:
            raise OSError("disk went away")
        return self.inner.get_batch(idx)


def _same_batches(got, want, feats_dtype):
    """The port's (qids, tensors, mask) items equal JAX's, with the port's
    types: int64 ids and masks, feats in `feats_dtype`, the rest fp32."""
    assert len(got) == len(want) > 0
    for (q, b, m), (jq, jb, jm) in zip(got, want):
        assert q == jq
        np.testing.assert_array_equal(m, jm)
        assert set(b) == set(jb)
        for k, v in b.items():
            assert v.device.type == "cpu"
            w = np.asarray(jb[k])
            if k == "feats":
                assert v.dtype == (torch.bfloat16 if feats_dtype
                                   else torch.float32)
                v, w = v.float(), w.astype(np.float32)
            elif k in ("input_ids", "input_mask", "segment_ids"):
                assert v.dtype == torch.int64
            else:
                assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def test_feeder_matches_jax(corpus):
    root, vocab = corpus
    _, jraw, praw, jset, _ = _pairs(root, vocab)[0]
    store = _Cached(jset.store)
    jset = jax_ds.GraphBatchDataset(jraw, JaxTokenizer.from_file(vocab),
                                    store=store)
    pset = ds.GraphBatchDataset(praw, BertTokenizer.from_file(vocab),
                                store=store)
    cases = [dict(batch_size=64, shuffle=True, drop_last=True),
             dict(batch_size=96, shuffle=False, drop_last=False),
             dict(batch_size=128, shuffle=True, drop_last=False)]
    for kw in cases:
        for feats_dtype in (None, "bfloat16"):
            ref = JaxFeeder(jset, seed=7, feats_dtype=feats_dtype and
                            jnp.bfloat16, **kw)
            mine = Feeder(pset, seed=7, device="cpu", feats_dtype=feats_dtype
                          and torch.bfloat16, **kw)
            assert len(mine) == len(ref)
            for epoch_run in range(3):
                if epoch_run == 2:  # rewind to epoch 1, skipping 2 batches
                    ref.set_position(1, 2)
                    mine.set_position(1, 2)
                _same_batches(list(mine), list(ref), feats_dtype)
    # one producer over epochs: the same batches, epoch after epoch
    for kw in (cases[0], cases[2]):
        ref = JaxMultiEpochsFeeder(jset, seed=7, **kw)
        mine = MultiEpochsFeeder(pset, seed=7, device="cpu", **kw)
        assert len(mine) == len(ref)
        for _ in range(3):
            _same_batches(list(mine), list(ref), None)
    # the pull API over a feeder
    mine, ref = Prefetcher(Feeder(pset, 96, device="cpu")), \
        JaxPrefetcher(JaxFeeder(jset, 96))
    got, want = [], []
    while ref.batch is not None:
        got.append(mine.next())
        want.append(ref.next())
    assert mine.next() is None
    assert len(got) == len(Feeder(pset, 96, device="cpu"))
    _same_batches(got, want, None)
    # a producer error reaches the consumer, with its cause
    failing = Feeder(_Failing(pset), 64, device="cpu")
    seen = []
    with pytest.raises(RuntimeError, match="producer thread failed") as err:
        for q, _, _ in failing:
            seen.append(q)
    assert isinstance(err.value.__cause__, OSError) and len(seen) == 2
    # an early exit stops the producer
    for _ in zip(range(1), Feeder(pset, 8, device="cpu")):
        pass


def test_guard_and_metrics_logger_match_jax(tmp_path, monkeypatch):
    # no TensorBoard: its import is slow here and it writes no jsonl
    monkeypatch.setitem(__import__("sys").modules,
                        "torch.utils.tensorboard", None)
    good = {"ggm_loss": 1.5, "clean_loss": 2.0, "d_loss": 0.25}
    cases = [good,
             {**good, "clean_loss": float("nan")},
             {**good, "d_loss": float("inf"), "loss_sm": -float("inf")}]
    for step, metrics in enumerate(cases):
        port_m = {k: torch.tensor(v) for k, v in metrics.items()}
        port_m["preds"] = torch.zeros(4, dtype=torch.int64)
        jax_m = {k: jnp.asarray(v) for k, v in metrics.items()}
        jax_m["preds"] = jnp.zeros(4, jnp.int32)
        errors = []
        for fn, m, exc in ((check_step_finite, port_m, TrainingDiverged),
                           (jax_check_step_finite, jax_m, JaxDiverged)):
            try:
                fn(step, "rel", m)
                errors.append(None)
            except exc as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        assert (errors[0] is None) == (step == 0)

        for cls, m, out in ((MetricsLogger, port_m, "port"),
                            (JaxMetricsLogger, jax_m, "jax")):
            logger = cls(str(tmp_path / out))
            assert logger.tb is None
            logger.log_step(step, m, branch="rep")
            logger.log_scalar("valid/mid_epoch_acc", 0.25, step)
        # args.json: the port's CLI writes it through dump_args, where
        # JAX's logger (the last one made) has dump_config
        dump_args(argparse.Namespace(step=step), str(tmp_path / "port"))
        logger.dump_config({"step": step})
    recs = {}
    for out in ("port", "jax"):
        lines = [json.loads(ln) for ln in
                 open(tmp_path / out / "metrics.jsonl")]
        for r in lines:
            r.pop("ts")
        recs[out] = lines
        assert json.load(open(tmp_path / out / "args.json")) == {"step": 2}
    assert json.dumps(recs["port"]) == json.dumps(recs["jax"])
