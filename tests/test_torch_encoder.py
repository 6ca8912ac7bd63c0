"""The port's LXMERT encoder against the JAX package's, with the weights
carried by `from_jax_params`: against flax `LxmertModel` (Pallas attention,
interpreted on the CPU) and against the reference-traced golden
tests/goldens/lxrt_tiny.npz through `convert_lxrt_bert`. fp32; tolerance
2e-5, as tests/test_parity.py."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from xggm_tpu.checkpoint.torch_bridge import convert_lxrt_bert, strip_prefixes
from xggm_tpu.config import tiny_test_config as jax_tiny
from xggm_tpu.models.lxmert import LxmertModel as JaxLxmert
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu_torch.checkpoint.jax_params import (
    bf16_bits_to_float32, from_jax_params, port_name)
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.lxmert import LxmertModel
from xggm_tpu_torch.ops.basic import LayerNorm, TorchLinear, gelu, init_weights

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=2e-5, atol=2e-5)


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


def _inputs(bs=4, seed=0):
    cfg = tiny_test_config().lxmert
    rng = np.random.RandomState(seed)
    mask = np.ones((bs, 20), np.int32)
    mask[:, 12:] = 0
    return {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (bs, 20)).astype(np.int32),
        "input_mask": mask,
        "segment_ids": np.zeros((bs, 20), np.int32),
        "feats": rng.randn(bs, 36, cfg.visual.visual_feat_dim).astype(np.float32),
        "boxes": rng.rand(bs, 36, 4).astype(np.float32),
    }


def _port_forward(flat, x):
    model = LxmertModel(tiny_test_config().lxmert, device="cpu")
    model.load_state_dict(from_jax_params(flat, model))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.inference_mode():
        (lang, visn), pooled = model(t["input_ids"], t["input_mask"],
                                     t["segment_ids"], t["feats"], t["boxes"])
    return lang.numpy(), visn.numpy(), pooled.numpy()


@pytest.fixture(scope="module")
def jax_encoder():
    """Tiny flax LxmertModel params and its outputs with the Pallas
    attention kernel."""
    cfg = jax_tiny().lxmert
    cfg = cfg.replace(bert=dataclasses.replace(cfg.bert,
                                               use_pallas_attention=True))
    x = _inputs()
    args = (x["input_ids"], x["input_mask"], x["segment_ids"], x["feats"],
            x["boxes"])
    params = _random_params(lambda key: JaxLxmert(cfg).init(key, *args))
    (lang, visn), pooled = jax.jit(
        lambda p: JaxLxmert(cfg).apply(p, *args))(params)
    return _flatten(params), x, [np.asarray(a) for a in (lang, visn, pooled)]


def test_encoder_matches_flax(jax_encoder):
    flat, x, want = jax_encoder
    for got, ref in zip(_port_forward(flat, x), want):
        np.testing.assert_allclose(got, ref, **TOL)


def test_encoder_matches_golden():
    data = np.load(os.path.join(GOLDENS, "lxrt_tiny.npz"))
    sd = {k[len("sd::"):]: data[k] for k in data.files if k.startswith("sd::")}
    flat, mapper = convert_lxrt_bert(strip_prefixes(sd), jax_tiny().lxmert,
                                     torch_prefix="", our_prefix="lxrt")
    assert not mapper.missing
    flat = {k[len("lxrt/"):]: v for k, v in flat.items()}
    x = {k: data[k] for k in ("input_ids", "input_mask", "segment_ids",
                              "feats", "boxes")}
    lang, visn, pooled = _port_forward(flat, x)
    np.testing.assert_allclose(pooled, data["out_pooled"], **TOL)
    np.testing.assert_allclose(lang, data["out_lang"], **TOL)
    np.testing.assert_allclose(visn, data["out_visn"], **TOL)


def test_port_names():
    assert port_name("params/lxrt/encoder/x_layer_3/visual_attention/att/kv/kernel") \
        == "lxrt.encoder.x_layers.3.visual_attention.att.kv.weight"
    assert port_name("encoder/r_layer_0/mlp/LayerNorm/scale") \
        == "encoder.r_layers.0.mlp.LayerNorm.weight"
    assert port_name("embeddings/word_embeddings/embedding") \
        == "embeddings.word_embeddings.weight"
    assert port_name("params/node_fc/fc/kernel") == "node_fc.fc.weight"
    assert port_name("params/generator/gnn_1/conv_0/layer_norm/scale") \
        == "generator.gnn.1.conv.0.layer_norm.weight"
    with pytest.raises(KeyError):
        port_name("params/lxrt/pooler/dense/weight")


def test_from_jax_params_checks_every_key(jax_encoder):
    flat, _, _ = jax_encoder
    model = LxmertModel(tiny_test_config().lxmert, device="cpu")
    sd = from_jax_params({**flat, "params/generator/gnn_0/proj_0/fc/kernel":
                          np.zeros((2, 2), np.float32)}, model)
    assert set(sd) == set(model.state_dict())
    k = "params/pooler/dense/kernel"
    np.testing.assert_array_equal(sd["pooler.dense.weight"].numpy(), flat[k].T)
    with pytest.raises(KeyError):
        from_jax_params({**flat, "params/pooler/extra/kernel": flat[k]}, model)
    with pytest.raises(KeyError):
        from_jax_params({n: a for n, a in flat.items() if n != k}, model)
    with pytest.raises(ValueError):
        from_jax_params({**flat, k: flat[k][:, :3]}, model)


def test_bf16_bits_decode_exactly():
    import ml_dtypes

    x = np.random.RandomState(0).randn(64).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(bf16_bits_to_float32(x.view(np.uint16)),
                                  x.astype(np.float32))


def test_basic_ops_match_jax():
    """erf GeLU, float32 LayerNorm at both epsilons, and TorchLinear (its
    forward on the same weights, and its init bound) against ops/basic.py."""
    import jax.numpy as jnp

    from xggm_tpu.ops import basic as jb

    rng = np.random.RandomState(3)
    x = rng.randn(4, 16).astype(np.float32) * 3
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.gelu(jnp.asarray(x))), **TOL)
    scale, bias = rng.rand(16).astype(np.float32), rng.randn(16).astype(np.float32)
    for eps in (1e-12, 1e-5):
        want = jb.LayerNormBase(epsilon=eps).apply(
            {"params": {"scale": scale, "bias": bias}}, x)
        ln = LayerNorm(16, eps, device="cpu")
        ln.load_state_dict({"weight": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)})
        np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(want), **TOL)
    params = jb.TorchLinear(features=8).init(jax.random.PRNGKey(0), x)
    lin = TorchLinear(16, 8, device="cpu")
    lin.load_state_dict(from_jax_params(_flatten(params), lin))
    np.testing.assert_allclose(
        lin(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jb.TorchLinear(features=8).apply(params, x)), **TOL)
    init_weights(lin, torch.Generator().manual_seed(0))
    assert lin.weight.abs().max() <= 0.25 and lin.bias.abs().max() <= 0.25
