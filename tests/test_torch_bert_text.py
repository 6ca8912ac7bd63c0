"""The port's text-only BERT and the adjacency precompute against the JAX
package's: `BertTextModel` (2 layers, hidden 32, padded masks) within
2e-5, its tree carried across and back bit for bit; `convert_bert_text`
and `convert_tf_bert` key for key and bit for bit on the synthesized
checkpoints of tests/test_aux.py, loaded into the port's model;
`read_tf_checkpoint` without TensorFlow; `adjacency_from_ids`,
`embed_vocab` and `compute_adjacency` against JAX's tool (`tools/
compute_adjacency.py`) on the corpus of tests/test_data_factory.py within
1e-5, and the port's CLI on the CPU."""
import builtins
import os
from unittest import mock

import h5py
import jax
import numpy as np
import pytest
import torch

from _torch_parity import carry, close, one_torch_thread, random_params, t  # noqa: F401
from test_data_factory import write_synthetic_tsv
from tools import compute_adjacency as jax_tool
from tools.tsv2h5 import tsv_to_h5
from xggm_tpu.checkpoint import tf_bridge as jax_tf
from xggm_tpu.checkpoint import torch_bridge as jax_tb
from xggm_tpu.config import BertConfig as JaxBertConfig
from xggm_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from xggm_tpu.data.tokenizer import make_test_vocab as jax_vocab
from xggm_tpu.models.lxmert import BertTextModel as JaxBertText
from xggm_tpu_torch.checkpoint import tf_bridge, torch_bridge
from xggm_tpu_torch.config import BertConfig
from xggm_tpu_torch.data.tokenizer import BertTokenizer, make_test_vocab
from xggm_tpu_torch.models.lxmert import BertTextModel
from xggm_tpu_torch.tools import compute_adjacency as tool

TOL = dict(rtol=2e-5, atol=2e-5)
WIDTH = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)


def _ids(vocab, bs=5, length=9, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (bs, length)).astype(np.int32)
    mask = np.ones_like(ids)
    for b in range(bs):
        mask[b, 1 + b:] = 0  # row b has 1 + b tokens
    seg = (rng.rand(bs, length) > 0.5).astype(np.int32)
    return ids, mask, seg


def test_bert_text_model_matches_jax():
    vocab = 40
    ids, mask, seg = _ids(vocab)
    jm = JaxBertText(JaxBertConfig(vocab_size=vocab, **WIDTH), num_layers=2)
    params = random_params(lambda k: jm.init(k, ids, mask, seg))
    pm = carry(params, BertTextModel(BertConfig(vocab_size=vocab, **WIDTH),
                                     num_layers=2, device="cpu"))
    assert [n for n, _ in pm.named_children()] == ["embeddings", "layer",
                                                   "pooler"]
    want = jax.jit(lambda p: jm.apply(p, ids, mask, seg))(params)
    with torch.no_grad():
        for args in ((ids, mask, seg), (ids,)):
            got = pm(*map(lambda a: t(a).long(), args))
            if len(args) == 1:  # no mask and no segments
                want = jax.jit(lambda p: jm.apply(p, ids))(params)
            for g, w, what in zip(got, want, ("sequence", "pooled")):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           err_msg=what, **TOL)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertTextModel(BertConfig(vocab_size=vocab, **WIDTH), num_layers=1)


def _hf_state_dict(rng, h, inter, vocab, layers, prefix=""):
    """A plain BERT state dict in the HF bert-base-uncased layout."""
    sd = {f"{prefix}embeddings.word_embeddings.weight": rng.randn(vocab, h),
          f"{prefix}embeddings.position_embeddings.weight": rng.randn(64, h),
          f"{prefix}embeddings.token_type_embeddings.weight":
              rng.randn(2, h),
          f"{prefix}embeddings.LayerNorm.gamma": 1 + 0.1 * rng.randn(h),
          f"{prefix}embeddings.LayerNorm.beta": 0.1 * rng.randn(h),
          f"{prefix}pooler.dense.weight": rng.randn(h, h) / np.sqrt(h),
          f"{prefix}pooler.dense.bias": 0.1 * rng.randn(h)}
    for i in range(layers):
        t_ = f"{prefix}encoder.layer.{i}"
        for name, (n_out, n_in) in (
                ("attention.self.query", (h, h)),
                ("attention.self.key", (h, h)),
                ("attention.self.value", (h, h)),
                ("attention.output.dense", (h, h)),
                ("intermediate.dense", (inter, h)),
                ("output.dense", (h, inter))):
            sd[f"{t_}.{name}.weight"] = rng.randn(n_out, n_in) / np.sqrt(n_in)
            sd[f"{t_}.{name}.bias"] = 0.1 * rng.randn(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{t_}.{name}.weight"] = 1 + 0.1 * rng.randn(h)
            sd[f"{t_}.{name}.bias"] = 0.1 * rng.randn(h)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_bert_bridges_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    h, inter, vocab = 32, 64, 50
    cfg = BertConfig(vocab_size=vocab, hidden_size=h, num_attention_heads=4,
                     intermediate_size=inter, max_position_embeddings=64)

    def loaded(flat):
        model = BertTextModel(cfg, num_layers=1, device="cpu")
        assert torch_bridge.merge_into(model, flat) == []
        return model

    for prefix in ("", "bert."):
        sd = _hf_state_dict(rng, h, inter, vocab, 1, prefix)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "bert.pth")
        sd = torch_bridge.load_torch_state_dict(str(tmp_path / "bert.pth"))
        got = torch_bridge.convert_bert_text(sd, 1, prefix)
        want = jax_tb.convert_bert_text(sd, 1, prefix)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        loaded(got)

    # the TF variables of tests/test_aux.py::test_tf_bridge_mapping
    rng = np.random.RandomState(0)
    H, I, V = 32, 64, 50
    tf_vars = {
        "bert/embeddings/word_embeddings": rng.randn(V, H),
        "bert/embeddings/position_embeddings": rng.randn(64, H),
        "bert/embeddings/token_type_embeddings": rng.randn(2, H),
        "bert/embeddings/LayerNorm/gamma": np.ones(H),
        "bert/embeddings/LayerNorm/beta": np.zeros(H),
        "bert/pooler/dense/kernel": rng.randn(H, H),
        "bert/pooler/dense/bias": np.zeros(H),
    }
    for n in ("query", "key", "value"):
        tf_vars[f"bert/encoder/layer_0/attention/self/{n}/kernel"] = \
            rng.randn(H, H)
        tf_vars[f"bert/encoder/layer_0/attention/self/{n}/bias"] = np.zeros(H)
    for name, shape in [("attention/output/dense", (H, H)),
                        ("intermediate/dense", (H, I)),
                        ("output/dense", (I, H))]:
        tf_vars[f"bert/encoder/layer_0/{name}/kernel"] = rng.randn(*shape)
        tf_vars[f"bert/encoder/layer_0/{name}/bias"] = np.zeros(shape[1])
    for ln in ("attention/output/LayerNorm", "output/LayerNorm"):
        tf_vars[f"bert/encoder/layer_0/{ln}/gamma"] = np.ones(H)
        tf_vars[f"bert/encoder/layer_0/{ln}/beta"] = np.zeros(H)
    for layers, drop in ((1, None), (2, None),
                         (1, "bert/encoder/layer_0/output/dense/bias")):
        tv = {k: v for k, v in tf_vars.items() if k != drop}
        got, got_missing = tf_bridge.convert_tf_bert(tv, num_layers=layers)
        want, want_missing = jax_tf.convert_tf_bert(tv, num_layers=layers)
        assert list(got) == list(want) and got_missing == want_missing
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = loaded(tf_bridge.convert_tf_bert(tf_vars, num_layers=1)[0])
    with torch.no_grad():
        _, pooled = model(torch.ones(2, 10, dtype=torch.long))
    assert bool(torch.isfinite(pooled).all())

    real_import = builtins.__import__

    def no_tensorflow(name, *args, **kwargs):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real_import(name, *args, **kwargs)

    with mock.patch.object(builtins, "__import__", no_tensorflow):
        with pytest.raises(ImportError, match="tensorflow is required"):
            tf_bridge.read_tf_checkpoint(str(tmp_path / "model.ckpt"))


def test_adjacency_and_vocab_embedding_match_jax(tmp_path):
    # the inputs of tests/test_data_factory.py::
    # test_adjacency_matches_reference_algorithm
    rng = np.random.RandomState(0)
    obj_emb = rng.randn(10, 32).astype(np.float32)
    attr_emb = rng.randn(5, 32).astype(np.float32)
    obj_ids = rng.randint(0, 10, 36)
    attr_ids = rng.randint(0, 5, 36)
    want = jax_tool.adjacency_from_ids(obj_ids, attr_ids, obj_emb, attr_emb)
    got = tool.adjacency_from_ids(obj_ids, attr_ids, obj_emb, attr_emb)
    close(got, want, "adjacency_from_ids", dict(rtol=1e-5, atol=1e-6))
    # the reference's per-pair cosine, diagonal doubled, over its max
    m1, m2 = t(obj_emb[obj_ids]), t(attr_emb[attr_ids])
    ref = torch.zeros(36, 36)
    for i in range(36):
        for j in range(i, 36):
            ref[i, j] = torch.cosine_similarity(m1[i], m2[j], dim=0, eps=1e-6)
    ref = ref + ref.T
    close(got, ref / ref.max(), "vs the reference", dict(rtol=1e-5,
                                                          atol=1e-6))
    # a batch of images at once equals each image alone
    ids = rng.randint(0, 10, (4, 36)), rng.randint(0, 5, (4, 36))
    batched = tool.adjacency_from_ids(*ids, t(obj_emb), t(attr_emb))
    for b in range(4):
        close(batched[b], jax_tool.adjacency_from_ids(
            ids[0][b], ids[1][b], obj_emb, attr_emb), f"image {b}",
            dict(rtol=1e-5, atol=1e-6))

    # the end to end of tests/test_data_factory.py::
    # test_compute_adjacency_end_to_end: a 1-layer BERT of hidden 32
    tsv = str(tmp_path / "x.tsv")
    write_synthetic_tsv(tsv, ["a", "b"])
    obj_h5 = str(tmp_path / "x.h5")
    tsv_to_h5(tsv, {"a", "b"}, obj_h5, str(tmp_path / "i.json"))
    vocab = jax_vocab()
    assert make_test_vocab() == vocab
    jcfg = JaxBertConfig(vocab_size=len(vocab), hidden_size=32,
                         num_attention_heads=2, intermediate_size=64)
    jm = JaxBertText(jcfg, num_layers=1)
    params = random_params(lambda k: jm.init(k, np.zeros((2, 16), np.int32)))
    pm = carry(params, BertTextModel(
        BertConfig(vocab_size=len(vocab), hidden_size=32,
                   num_attention_heads=2, intermediate_size=64),
        num_layers=1, device="cpu"))
    obj_names = [f"dog {i}" for i in range(10)]
    attr_names = [f"red {i}" for i in range(5)]
    embs = {}
    for side, embed, tok, model in (
            ("jax", lambda n, tok, m: jax_tool.embed_vocab(
                n, tok, params, m, batch_size=4), JaxTokenizer(vocab), jm),
            ("port", lambda n, tok, m: tool.embed_vocab(n, tok, m,
                                                        batch_size=4),
             BertTokenizer(vocab), pm)):
        embs[side] = [embed(names, tok, model)
                      for names in (obj_names, attr_names)]
        out = str(tmp_path / f"adj_{side}.h5")
        mod = jax_tool if side == "jax" else tool
        assert mod.compute_adjacency(obj_h5, out, *embs[side]) == 2
    for g, w in zip(embs["port"], embs["jax"]):
        assert g.shape == w.shape
        close(g, w, "embed_vocab")
    with h5py.File(str(tmp_path / "adj_port.h5")) as got, \
            h5py.File(str(tmp_path / "adj_jax.h5")) as want:
        assert sorted(got) == sorted(want) == ["a", "b"]
        for img in want:
            assert got[img].dtype == np.float32
            close(got[img][()], want[img][()], f"adjacency {img}")


def test_compute_adjacency_cli_on_the_cpu(tmp_path, capsys):
    tsv = str(tmp_path / "x.tsv")
    write_synthetic_tsv(tsv, ["a", "b", "c"])
    obj_h5 = str(tmp_path / "x.h5")
    tsv_to_h5(tsv, {"a", "b", "c"}, obj_h5, str(tmp_path / "i.json"))
    vocab = make_test_vocab()
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (tmp_path / "objects.txt").write_text(
        "\n".join(f"dog {i}" for i in range(10)) + "\n")
    (tmp_path / "attrs.txt").write_text(
        "\n".join(f"red {i}" for i in range(5)) + "\n")
    out = str(tmp_path / "adj.h5")
    flags = ["--obj_h5", obj_h5, "--objects_vocab",
             str(tmp_path / "objects.txt"), "--attrs_vocab",
             str(tmp_path / "attrs.txt"), "--vocab",
             str(tmp_path / "vocab.txt"), "--out", out, "--layers", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(flags)
        assert not os.path.exists(out)
    tool.main(flags + ["--device", "cpu"])
    assert "wrote 3 adjacency matrices" in capsys.readouterr().out
    with h5py.File(out) as f:
        assert sorted(f) == ["a", "b", "c"]
        for img in f:
            a = f[img][()]
            assert a.shape == (36, 36) and a.dtype == np.float32
            np.testing.assert_allclose(a, a.T, rtol=1e-6)
            assert a.max() == pytest.approx(1.0)
