"""The whole slice: an artifact exported by the JAX package (`export_model`,
tiny XGGMModel, Pallas attention interpreted on the CPU) served by the port's
`ServingModel` and HTTP server on the CPU.

Tolerances: fp32 artifact, logits within 1e-5 (both sides in fp32; only the
summation order differs) and identical answers; bf16-weights artifact in
bf16 compute, within 0.05, the bf16 envelope of tests/test_serving.py;
int8 artifact of the fp32 model, per-row relative L2 within 5e-3 (a tenth
of the int8 envelope there: a summation-order difference can flip an
activation's int8 rounding) and identical answers."""
import dataclasses
import json
import os
import shutil
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from xggm_tpu.config import tiny_test_config as jax_tiny
from xggm_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
from xggm_tpu.serving import ServingModel as JaxServing
from xggm_tpu.serving import export_model
from xggm_tpu.serving.server import InferenceEngine as JaxEngine
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.data.synthetic import synthetic_obj36, vocab_tokens
from xggm_tpu_torch.data.tokenizer import BertTokenizer
from xggm_tpu_torch.models.task_model import PlainModel
from xggm_tpu_torch.serving.artifact import ServingModel
from xggm_tpu_torch.ops.basic import Dense
from xggm_tpu_torch.serving.quant import Int8Dense
from xggm_tpu_torch.serving.server import InferenceEngine, make_server
from xggm_tpu_torch.training.steps import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)
INT8_RTOL = 5e-3
LABELS = [f"a{i}" for i in range(16)]


def _random_params(init_fn, seed=0):
    """JAX params with the tree `init_fn(key)` would build, drawn with numpy
    (tracing init is much cheaper than compiling it): LayerNorm scales near
    1, every other leaf normal(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + 0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_model(dtype):
    cfg = jax_tiny()
    lx = cfg.lxmert.replace(dtype=dtype, bert=dataclasses.replace(
        cfg.lxmert.bert, use_pallas_attention=True))
    return JaxXGGM(lx, cfg.ggm, cfg.num_answers)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(fp32 artifact, bf16-weights artifact, batch of 8, the JAX
    ServingModel of the fp32 artifact, int8 artifact of the fp32 model)
    from one set of JAX params, GGM submodules included."""
    from __graft_entry__ import _make_batch

    batch = _make_batch(np.random.RandomState(0), 8, 128, 32, 16)
    args = tuple(batch[k] for k in ("input_ids", "input_mask", "segment_ids",
                                    "feats", "boxes", "adj"))
    params = _random_params(lambda key: _jax_model("float32").init(
        {"params": key, "dropout": key}, *args, key,
        method=JaxXGGM.init_all))
    root = tmp_path_factory.mktemp("art")
    fp32, bf16, int8 = (str(root / k) for k in ("fp32", "bf16", "int8"))
    export_model(_jax_model("float32"), params, fp32, batch_size=8,
                 label2ans=LABELS, platforms=("cpu",), bf16_weights=False)
    export_model(_jax_model("bfloat16"), params, bf16, batch_size=8,
                 label2ans=LABELS, platforms=("cpu",))
    export_model(_jax_model("float32"), params, int8, batch_size=8,
                 label2ans=LABELS, platforms=("cpu",), bf16_weights=False,
                 quantize="int8")
    serve = {k: batch[k] for k in ("input_ids", "input_mask", "segment_ids",
                                   "feats", "boxes")}
    return fp32, bf16, serve, JaxServing.load(fp32), int8


def test_fp32_artifact_matches_jax(artifacts):
    fp32, _, batch, want, _ = artifacts
    sm = ServingModel.load(fp32, tiny_test_config(), device="cpu")
    logits = sm.predict_logits(batch)
    np.testing.assert_allclose(logits, want.predict_logits(batch), **FP32_TOL)
    assert sm.predict_answers(batch) == want.predict_answers(batch)
    ids = make_eval_step(sm.model)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(ids.numpy(), logits.argmax(-1))


def test_ragged_batch_pads_like_jax(artifacts):
    fp32, _, batch, jax_sm, _ = artifacts
    sm = ServingModel.load(fp32, tiny_test_config(), device="cpu")
    short = {k: v[:5] for k, v in batch.items()}
    padded, n = sm.pad_batch(short)
    want_padded, want_n = jax_sm.pad_batch(short)
    assert n == want_n == 5
    for k in padded:
        np.testing.assert_array_equal(padded[k], want_padded[k])
    got = sm.predict_logits(short)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, sm.predict_logits(batch)[:5], **FP32_TOL)
    with pytest.raises(ValueError):
        sm.predict_logits({k: np.concatenate([v, v]) for k, v in batch.items()})


def test_bf16_weights_artifact_matches_jax(artifacts):
    _, bf16, batch, _, _ = artifacts
    dtypes = json.load(open(os.path.join(bf16, "meta.json")))["param_dtypes"]
    assert "bfloat16" in dtypes.values()
    sm = ServingModel.load(bf16, tiny_test_config(), device="cpu")
    assert sm.model.cfg.compute_dtype == torch.bfloat16
    got = sm.predict_logits(batch)
    np.testing.assert_allclose(got, JaxServing.load(bf16).predict_logits(batch),
                               **BF16_TOL)
    assert not np.allclose(got, 0)


def test_plain_model_takes_the_same_params(artifacts):
    fp32, _, batch, _, _ = artifacts
    sm = ServingModel.load(fp32, tiny_test_config(), device="cpu")
    plain = PlainModel(sm.model.cfg, sm.model.num_answers, device="cpu")
    plain.load_state_dict(sm.model.state_dict())
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = plain(t["input_ids"], t["input_mask"], t["segment_ids"],
                    t["feats"], t["boxes"])
    np.testing.assert_array_equal(got.numpy(), sm.predict_logits(batch))
    with np.load(os.path.join(fp32, "params.npz")) as raw:
        flat = {k: raw[k] for k in raw.files}
    assert set(from_jax_params(flat, plain)) == set(plain.state_dict())


def test_int8_artifact_raises(artifacts, tmp_path):
    """The port serves a JAX-exported int8 artifact (fp32 model) as JAX's
    ServingModel does: per-row relative L2 of the logits within INT8_RTOL,
    a tenth of the 5% envelope of int8 against fp32
    (tests/test_serving.py), and every answer the same; every Dense but
    the answer projection runs int8. A quantize mode it does not know
    raises."""
    fp32, _, batch, _, int8 = artifacts
    sm = ServingModel.load(int8, tiny_test_config(), device="cpu")
    jax_sm = JaxServing.load(int8)
    got, want = sm.predict_logits(batch), jax_sm.predict_logits(batch)
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() <= INT8_RTOL, rel
    assert sm.predict_answers(batch) == jax_sm.predict_answers(batch)
    full = ServingModel.load(fp32, tiny_test_config(), device="cpu")
    swapped = [n for n, m in sm.model.named_modules()
               if isinstance(m, Int8Dense)]
    assert swapped == [n for n, m in full.model.named_modules()
                       if type(m) is Dense and n != "logit_fc.fc2"]
    assert len(swapped) == 27
    # int8 against the fp32 artifact: the JAX package's PTQ envelope
    ref = full.predict_logits(batch)
    assert (np.linalg.norm(got - ref, axis=-1)
            / np.linalg.norm(ref, axis=-1)).max() < 0.05

    art = str(tmp_path / "int4")
    shutil.copytree(int8, art)
    meta = json.load(open(os.path.join(art, "meta.json")))
    meta["quantize"] = "int4"
    json.dump(meta, open(os.path.join(art, "meta.json"), "w"))
    with pytest.raises(ValueError, match="int4"):
        ServingModel.load(art, tiny_test_config(), device="cpu")


def test_load_defaults_to_the_card(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel.load(artifacts[0], tiny_test_config())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)


def _post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def test_http_server_answers_like_jax_engine(artifacts):
    fp32, _, _, jax_sm, _ = artifacts
    vocab = {t: i for i, t in enumerate(vocab_tokens())}
    store = synthetic_obj36(3, feat_dim=32, seed=1)
    engine = InferenceEngine(
        ServingModel.load(fp32, tiny_test_config(), device="cpu"),
        BertTokenizer(vocab), store)
    queries = [{"img_id": f"synth_{i % 3}",
                "sent": f"what color is the dog on the left {i} ?"}
               for i in range(10)]  # 10 > batch 8: two chunks, one padded
    want = JaxEngine(jax_sm, JaxTokenizer(vocab),
                     store).answer(queries)
    server = make_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = _get(base + "/healthz")
        assert health["status"] == "ok" and health["batch_size"] == 8
        assert health["num_answers"] == 16 and health["device"] == "cpu"
        resp = _post(base + "/predict",
                     json.dumps({"queries": queries}).encode())
        assert resp["answers"] == want and resp["latency_ms"] > 0
        for path, body, code in (("/predict", b"{}", 400),
                                 ("/predict", b"[1]", 400),
                                 ("/other", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + path, body)
            assert err.value.code == code and "error" in json.load(err.value)
        assert _get(base + "/healthz")["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
