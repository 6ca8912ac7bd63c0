"""The port's GGM modules against the reference-traced goldens and the JAX
package:
- `GCNGenerator` against goldens/ggm_gcn_tiny.npz;
- the losses against goldens/losses.npz;
- the task glue (logit_fc, encoder_adj with the triu scatter, node_fc,
  fusion_fc) against goldens/task_glue_tiny.npz;
  each golden's torch state dict goes through `checkpoint/torch_bridge` (the
  JAX package's mapping, as tests/test_parity.py does) and then
  `from_jax_params`;
- `relation_branch` and `representation_branch` against the flax
  `XGGMModel` with the noise replayed through `noise_override`, at
  `tiny_test_config()` widths with depth 1/1/1.
fp32 everywhere and dropout off; tolerance 2e-5 (the goldens' tolerance in
tests/test_parity.py), the losses rtol 1e-6 as there.
Also, on the port alone: the training forward's dropout draws from its
seed, and the noise draws; and `make_generator`'s GIN and GAT generators
against JAX's (tests/test_torch_generators.py holds the rest of them).
Tests loop over their cases (see tests/test_torch_attention_dropout.py for
why the files hold few tests)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from xggm_tpu.checkpoint.torch_bridge import (
    _Mapper, _map_gcn, _map_linear_gelu_ln)
from xggm_tpu.config import tiny_test_config as jax_tiny
from xggm_tpu.ggm.generators import make_generator as jax_make_generator
from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.ggm.generators import GCNGenerator, make_generator
from xggm_tpu_torch.models.lxmert import AnswerHead
from xggm_tpu_torch.models.task_model import (
    NodeFC, XGGMModel, adjacency_to_triu, triu_to_adjacency)
from xggm_tpu_torch.ops.basic import DropoutRng, TorchLinear, init_weights
from xggm_tpu_torch.ops.losses import (
    bce_with_logits, score_matching_loss, symmetric_kl)
from xggm_tpu_torch.ops.noise import (
    add_edge_noise, add_feature_noise, remove_self_loops)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=2e-5, atol=2e-5)
B = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden(name):
    data = np.load(os.path.join(GOLDENS, name))
    sd = {k[len("sd::"):]: data[k] for k in data.files if k.startswith("sd::")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd::")}


def _load(module, flat, name=None):
    """Fill `module` from the JAX-layout flat dict: all of it, or the
    entries under the top-level submodule `name`."""
    if name is not None:
        holder = torch.nn.Module()
        holder.add_module(name, module)
        flat = {k: v for k, v in flat.items() if k.startswith(f"{name}/")}
        module = holder
    module.load_state_dict(from_jax_params(flat, module))
    return module if name is None else getattr(module, name)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_gcn_generator_and_losses_match_goldens():
    sd, g = _golden("ggm_gcn_tiny.npz")
    m = _Mapper({f"generator.{k}": v for k, v in sd.items()})
    for i in range(2):
        _map_gcn(m, f"generator.gnn_layers.{i}", f"gnn_{i}", n_convs=2)
    assert not m.missing
    gen = _load(GCNGenerator(64, n_layers=2, device="cpu"), m.out)
    with torch.no_grad():
        x, adj = gen(_t(g["x"]), _t(g["adj"]))
    np.testing.assert_allclose(x.numpy(), g["out_x"], **TOL)
    np.testing.assert_allclose(adj.numpy(), g["out_adj"], **TOL)

    _, g = _golden("losses.npz")
    sm = score_matching_loss(_t(g["score"]), _t(g["grad"]), float(g["sigma"]))
    np.testing.assert_allclose(float(sm), float(g["sm"]), rtol=1e-6)
    kl = symmetric_kl(_t(g["klx"]), _t(g["kly"]))
    np.testing.assert_allclose(float(kl), float(g["kl"]), rtol=1e-6)
    bce = bce_with_logits(_t(g["logits"]), _t(g["target"]))
    np.testing.assert_allclose(float(bce), float(g["bce"]), rtol=1e-6)


def test_task_glue_matches_golden():
    sd, g = _golden("task_glue_tiny.npz")
    m = _Mapper(sd)
    m.linear("logit_fc.0", "logit_fc/fc1")
    m.layernorm("logit_fc.2", "logit_fc/ln")
    m.linear("logit_fc.3", "logit_fc/fc2")
    m.linear("encoder_adj.0", "encoder_adj")
    _map_linear_gelu_ln(m, "node_fc", "node_fc")
    _map_linear_gelu_ln(m, "fusion_fc", "fusion_fc")
    assert not m.missing
    flat, x, nodes = m.out, _t(g["x"]), _t(g["nodes"])
    f32 = torch.float32
    with torch.no_grad():
        head = _load(AnswerHead(64, 16, f32, device="cpu"), flat, "logit_fc")
        np.testing.assert_allclose(head(x).numpy(), g["out_logits"], **TOL)
        adj_fc = _load(TorchLinear(64, 630, device="cpu"), flat, "encoder_adj")
        adj = triu_to_adjacency(torch.sigmoid(adj_fc(x)))
        np.testing.assert_allclose(adj.numpy(), g["out_adj"], **TOL)
        assert torch.equal(triu_to_adjacency(adjacency_to_triu(adj)), adj)
        node_fc = _load(NodeFC(64, 64, f32, device="cpu"), flat, "node_fc")
        out = node_fc(x[:, None, :].expand(-1, 36, -1))
        np.testing.assert_allclose(out.numpy(), g["out_node"], **TOL)
        fusion = _load(NodeFC(128, 64, f32, device="cpu"), flat, "fusion_fc")
        x_gen = fusion(torch.cat([x, torch.tanh(nodes.mean(1))], dim=-1))
        np.testing.assert_allclose(x_gen.numpy(), g["out_xgen"], **TOL)


def _shallow(cfg):
    return cfg.replace(lxmert=cfg.lxmert.replace(visual=dataclasses.replace(
        cfg.lxmert.visual, l_layers=1, x_layers=1, r_layers=1)))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, 20), np.int32)
    mask[:, 12:] = 0
    adj = rng.rand(B, 36, 36).astype(np.float32)
    return {
        "input_ids": rng.randint(1, 128, (B, 20)).astype(np.int32),
        "input_mask": mask,
        "segment_ids": np.zeros((B, 20), np.int32),
        "feats": rng.randn(B, 36, 32).astype(np.float32),
        "boxes": rng.rand(B, 36, 4).astype(np.float32),
        "adj": (adj + adj.transpose(0, 2, 1)) / 2,
        "relation": rng.randn(B, 36, 36).astype(np.float32),
        "representation": rng.randn(B, 36, 64).astype(np.float32),
    }


ARGS = ("input_ids", "input_mask", "segment_ids", "feats", "boxes", "adj")


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


@pytest.fixture(scope="module")
def branches():
    """Flat JAX params, the inputs, and both branches' JAX outputs."""
    cfg = _shallow(jax_tiny())
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    x = _inputs()
    args = [x[k] for k in ARGS]
    key = jax.random.PRNGKey(0)
    params = _random_params(lambda k: model.init(
        k, *args, k, method=JaxXGGM.init_all))
    out = {}
    for branch in ("relation", "representation"):
        method = getattr(JaxXGGM, f"{branch}_branch")
        fn = jax.jit(lambda p, noise: model.apply(
            p, *args, key, deterministic=True, noise_override=noise,
            method=method))
        out[branch] = [np.asarray(a) for a in fn(params, x[branch])]
    return _flatten(params), x, out


def test_branches_match_flax(branches):
    flat, x, want = branches
    cfg = _shallow(tiny_test_config())
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(from_jax_params(flat, model))
    t = {k: _t(x[k]) for k in ARGS}
    for k in ("input_ids", "input_mask", "segment_ids"):
        t[k] = t[k].long()
    for branch in ("relation", "representation"):
        with torch.no_grad():
            got = getattr(model, f"{branch}_branch")(
                *(t[k] for k in ARGS), None, noise_override=_t(x[branch]))
        assert len(got) == len(want[branch])
        for i, (a, w) in enumerate(zip(got, want[branch])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), w,
                                       err_msg=f"{branch} output {i}", **TOL)


def test_random_draws_and_unported_generators():
    """The training forward, with hidden and attention dropout at 0.1 and
    GGM dropout at 0.5: one seed gives the same outputs twice, another seed
    others, and no rng gives the deterministic forward. Edge noise is
    symmetric with a zero diagonal, both noise draws have score target
    -noise / sigma^2, and a generator seed repeats its draw. The GIN and GAT
    generators of `make_generator` equal JAX's at 2e-5."""
    cfg = _shallow(tiny_test_config())
    model = init_weights(
        XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu"),
        torch.Generator().manual_seed(0))
    x = _inputs(1)
    t = [_t(x[k]).long() if k in ("input_ids", "input_mask", "segment_ids")
         else _t(x[k]) for k in ARGS]
    noise = torch.Generator().manual_seed(3)

    def run(seed):
        rng = None if seed is None else DropoutRng(seed, "cpu")
        with torch.no_grad():
            return model.representation_branch(
                *t, noise, rng, noise_override=_t(x["representation"]))[0]

    assert torch.equal(run(5), run(5))
    assert not torch.allclose(run(5), run(6))
    assert not torch.allclose(run(5), run(None))
    assert torch.equal(run(None), run(None))

    adj = torch.rand(2, 36, 36)
    sigma = 0.7
    noisy, grad = add_edge_noise(torch.Generator().manual_seed(1), adj, sigma)
    edge = noisy - adj
    torch.testing.assert_close(edge, edge.transpose(-1, -2))
    assert torch.equal(torch.diagonal(edge, dim1=-2, dim2=-1),
                       torch.zeros(2, 36))
    torch.testing.assert_close(grad, -edge / sigma ** 2)
    again, _ = add_edge_noise(torch.Generator().manual_seed(1), adj, sigma)
    assert torch.equal(again, noisy)
    feats = torch.randn(2, 36, 8)
    noisy, grad = add_feature_noise(torch.Generator().manual_seed(2), feats,
                                    sigma)
    torch.testing.assert_close(grad, -(noisy - feats) / sigma ** 2)
    assert torch.equal(remove_self_loops(torch.ones(1, 3, 3)),
                       1.0 - torch.eye(3)[None])

    # the GIN and GAT generators of make_generator, as the task model
    # builds them, equal JAX's on the same parameters (dropout off)
    rng = np.random.RandomState(4)
    x, adj = rng.randn(2, 36, 64).astype(np.float32), remove_self_loops(
        torch.rand(2, 36, 36)).numpy()
    for gnn in ("GIN", "GAT"):
        jax_module = jax_make_generator(gnn, 64, 2)
        shapes = jax.eval_shape(lambda k: jax_module.init(k, x, adj, True),
                                jax.random.PRNGKey(0))
        params = jax.tree.map(
            lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
        want = jax_module.apply(params, x, adj, True)
        port = _load(make_generator(gnn, 64, 2, device="cpu"),
                     {k[len("params/"):]: v
                      for k, v in _flatten(params).items()})
        with torch.no_grad():
            got = port(_t(x), _t(adj))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=gnn, **TOL)
