"""The port's export and int8 serving against the JAX package's:

- `export_model` on a port model holding the same weights as a JAX model
  (`tiny_test_config()` widths, bf16 compute, the GAT generator) writes
  the `params.npz` of JAX's `export_model(..., platforms=("cpu",))`, key
  for key, dtype for dtype and bit for bit, for bf16_weights in {True,
  False} x quantize in {None, "int8"}; `meta.json` field by field except
  `jax_version`, `platforms` and the head count the port adds to `notes`;
  `to_jax_params` gives `_flatten`'s keys and shapes for the GCN, GIN and
  GAT models;
- `Int8Dense` against `int8_dense_interceptor` on seeded inputs: the int8
  activations and their scales and the int32 accumulators equal, the
  outputs within 1e-6 relative (fp32 and bf16 layers, K = 4 as `box_fc`,
  fewer than 17 rows, 3-D inputs);
- a port export loaded back by `ServingModel.load` on the CPU in fp32
  gives the in-memory model's logits exactly, the head count read from
  the artifact's notes;
- `python -m xggm_tpu_torch.cli.export` end to end in a subprocess with
  jax, flax and h5py blocked: a tiny artifact, bf16 and int8, served back.

JAX's exports lower the graph once per case (no compile); torch runs on one
thread. Tests loop over their cases (see tests/test_torch_attention_dropout.py
for why the files hold few tests).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xggm_tpu.config import tiny_test_config as jax_tiny
from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
from xggm_tpu.serving import export_model as jax_export_model
from xggm_tpu.serving import quant as jax_quant
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu.training.steps import _path_str
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, to_jax_params
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import Dense, init_weights
from xggm_tpu_torch.serving.artifact import ServingModel, export_model
from xggm_tpu_torch.serving.quant import (
    Int8Dense, dynamic_act_quant, int8_matmul, quantize_dense_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = [f"a{i}" for i in range(16)]
COMBOS = [(bf16, q) for bf16 in (True, False) for q in (None, "int8")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, 20), np.int32)
    mask[:, 12:] = 0
    return {"input_ids": rng.randint(1, 128, (n, 20)).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, 20), np.int32),
            "feats": rng.randn(n, 36, 32).astype(np.float32),
            "boxes": rng.rand(n, 36, 4).astype(np.float32),
            "adj": rng.rand(n, 36, 36).astype(np.float32)}


def _jax_model(gnn, dtype="bfloat16"):
    cfg = jax_tiny()
    return JaxXGGM(cfg.lxmert.replace(dtype=dtype),
                   dataclasses.replace(cfg.ggm, gnn=gnn), cfg.num_answers)


def _jax_shapes(gnn):
    b = _batch(2)
    model = _jax_model(gnn)
    return jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, b["input_ids"], b["input_mask"],
        b["segment_ids"], b["feats"], b["boxes"], b["adj"], k,
        method=JaxXGGM.init_all), jax.random.PRNGKey(0))


def _random_params(shapes, seed=0):
    """Numpy draws with the tree `shapes`: LayerNorm scales near 1, every
    other leaf normal(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + 0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(gnn, dtype="bfloat16", flat=None):
    cfg = tiny_test_config()
    model = XGGMModel(cfg.lxmert.replace(dtype=dtype), cfg.num_answers,
                      dataclasses.replace(cfg.ggm, gnn=gnn), device="cpu")
    if flat is None:
        return init_weights(model, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_params(flat, model))
    return model


def _read(path):
    with np.load(os.path.join(path, "params.npz")) as raw:
        arrays = {k: raw[k] for k in raw.files}
    return arrays, json.load(open(os.path.join(path, "meta.json")))


def test_export_matches_jax_export(tmp_path):
    for gnn in ("GCN", "GIN", "GAT"):
        want = {_path_str(path): leaf.shape for path, leaf
                in jax.tree_util.tree_leaves_with_path(_jax_shapes(gnn))}
        got = to_jax_params(_port_model(gnn))
        assert list(got) == list(want), gnn
        assert {k: v.shape for k, v in got.items()} == want, gnn

    params = _random_params(_jax_shapes("GAT"))
    port = _port_model("GAT", flat=_flatten(params))
    for bf16, quantize in COMBOS:
        ours, theirs = (str(tmp_path / f"{side}_{bf16}_{quantize}")
                        for side in ("port", "jax"))
        kw = dict(batch_size=8, label2ans=LABELS, bf16_weights=bf16,
                  quantize=quantize, notes={"task": "gqa"})
        export_model(port, ours, **kw)
        jax_export_model(_jax_model("GAT"), params, theirs,
                         platforms=("cpu",), **kw)
        (got, got_meta), (want, want_meta) = _read(ours), _read(theirs)
        case = (bf16, quantize)
        assert list(got) == list(want), case
        for k, w in want.items():
            assert got[k].dtype == w.dtype, (case, k)
            assert got[k].tobytes() == w.tobytes(), (case, k)
        dtypes = set(want_meta["param_dtypes"].values())
        assert ("bfloat16" in dtypes) == bf16, case
        assert ("int8" in dtypes) == (quantize == "int8"), case
        assert not os.path.exists(os.path.join(ours, "predict.stablehlo"))
        for field in set(want_meta) | set(got_meta):
            if field in ("jax_version", "platforms"):
                continue
            if field == "notes":
                assert got_meta["notes"] == {**want_meta["notes"],
                                             "num_attention_heads": 4}
                continue
            assert got_meta[field] == want_meta[field], (case, field)
        # the JAX package's quantizer over the same flat dict
        flat = to_jax_params(port)
        q, n = quantize_dense_params(flat)
        jq, jn = jax_quant.quantize_dense_params(params)
        assert n == jn and set(q) == set(_flatten(jq))


def test_int8_dense_matches_interceptor():
    import flax.linen as nn

    rng = np.random.RandomState(1)
    cases = [((16, 64), 80, jnp.float32), ((5, 4), 64, jnp.float32),
             ((3, 7, 64), 48, jnp.bfloat16), ((2, 36, 4), 64, jnp.bfloat16),
             ((40, 128), 16, jnp.float32)]
    for shape, features, dtype in cases:
        x = (3.0 * rng.randn(*shape)).astype(np.float32)
        x[..., 0] = 0.0
        if dtype == jnp.bfloat16:
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dense = nn.Dense(features, dtype=dtype, param_dtype=jnp.float32)
        params = dense.init(jax.random.PRNGKey(0), x)
        params = jax.tree.map(
            lambda p: (0.1 * rng.randn(*p.shape)).astype(np.float32), params)
        q_params, n_q = jax_quant.quantize_dense_params(
            jax.device_get(params), exclude=())
        assert n_q == 1
        jx = jnp.asarray(x, dtype)
        want = np.asarray(jax_quant.intercepted_apply(dense, q_params, jx)
                          .astype(jnp.float32))
        jx_q, ja_scale = jax_quant._dynamic_act_quant(jx)
        w_q = q_params["params"]["kernel"]
        acc = jax.lax.dot_general(
            jx_q, w_q, (((jx_q.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        layer = Int8Dense(shape[-1], features, tdtype)
        layer.weight.copy_(torch.from_numpy(np.asarray(w_q).T.copy()))
        layer.weight_scale.copy_(torch.from_numpy(
            np.asarray(q_params["params"]["kernel_scale_int8"])))
        layer.bias.copy_(torch.from_numpy(np.asarray(
            q_params["params"]["bias"])))
        tx = torch.from_numpy(x).to(tdtype)
        x_q, a_scale = dynamic_act_quant(tx)
        assert torch.equal(x_q, torch.from_numpy(np.array(jx_q)))
        assert torch.equal(a_scale, torch.from_numpy(np.array(ja_scale)))
        got_acc = int8_matmul(x_q.reshape(-1, shape[-1]), layer.weight)
        assert torch.equal(got_acc, torch.from_numpy(
            np.array(acc).reshape(-1, features)))
        got = layer(tx)
        assert got.dtype == tdtype and layer.calls == 1
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                   atol=0, err_msg=str((shape, dtype)))


def test_port_export_round_trip(tmp_path):
    """fp32 exports of the GCN, GIN and GAT models serve the in-memory
    model's logits exactly; the head count (4) comes from the notes, not
    from the default config (12); an int8 export swaps every Dense but the
    answer projection."""
    batch = {k: v for k, v in _batch(8, seed=3).items() if k != "adj"}
    for gnn in ("GCN", "GIN", "GAT"):
        model = _port_model(gnn, "float32")
        want = ServingModel(model, {"batch_size": None}).predict_logits(batch)
        path = export_model(model, str(tmp_path / gnn), batch_size=8,
                            label2ans=LABELS)
        sm = ServingModel.load(path, device="cpu")
        assert sm.model.cfg.bert.num_attention_heads == 4
        np.testing.assert_array_equal(sm.predict_logits(batch), want)
    path = export_model(model, str(tmp_path / "int8"), batch_size=8,
                        label2ans=LABELS, quantize="int8")
    sm = ServingModel.load(path, device="cpu")
    dense = [n for n, m in model.named_modules()
             if type(m) is Dense and n.startswith(("lxrt.", "logit_fc."))]
    swapped = [n for n, m in sm.model.named_modules()
               if isinstance(m, Int8Dense)]
    assert swapped == [n for n in dense if n != "logit_fc.fc2"]
    assert type(sm.model.logit_fc.fc2) is Dense
    got = sm.predict_logits(batch)
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() < 0.05, rel
    x_layer = sm.model.lxrt.encoder.x_layers[0].visual_attention.att.query
    assert x_layer.calls == 2  # both directions of the cross-attention


E2E = r"""
import functools, os, sys
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
from xggm_tpu_torch.cli import export
from xggm_tpu_torch.data.synthetic import synthetic_obj36, vocab_tokens
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.serving.artifact import ServingModel
from xggm_tpu_torch.serving.server import InferenceEngine

root, out = sys.argv[1], sys.argv[2]
base = ["--synthetic", "--xpack", "--device", "cpu", "--data_root", root,
        "--output", out, "--llayers", "1", "--xlayers", "1", "--rlayers",
        "1", "--gnn", "GAT", "--platforms", "cpu", "--serve_bs", "0"]
store = synthetic_obj36(4, 2048, seed=0)
queries = [{"img_id": i, "sent": "what is on the table ?"}
           for i in store.img_ids()]
tok = BertTokenizer({t: i for i, t in enumerate(vocab_tokens())})
for flags in ([], ["--quantize", "int8"]):
    path = export.main(base + flags + ["--artifact",
                                       os.path.join(out, "art" + "".join(flags))])
    sm = ServingModel.load(path, device="cpu")
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    answers = InferenceEngine(sm, tok, store).answer(queries)
    print("ART", sm.meta["quantize"], sm.meta["feats_dtype"], size,
          len(answers), all(a in sm.label2ans for a in answers))
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "flax", "h5py", "xggm_tpu"))
print("LEAKED", leaked)
"""


def test_export_cli_without_jax_or_h5py(tmp_path):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", E2E, root, out], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "LEAKED []" in lines
    arts = [ln.split()[1:] for ln in lines if ln.startswith("ART ")]
    assert [a[:2] for a in arts] == [["None", "bfloat16"],
                                     ["int8", "bfloat16"]]
    for _, _, size, n, known in arts:
        assert int(size) < 5e6 and n == "4" and known == "True"
    assert sum(ln.startswith("exported artifact: ") for ln in lines) == 2
