"""The port's GIN and GAT generators, the edge and node generators and the
discriminators against the reference-traced goldens and the JAX package:

- `GINGenerator` (2 layers) against goldens/ggm_gin_tiny.npz and
  `GATGenerator(faithful_cat=True)` (1 layer) against ggm_gat_tiny.npz,
  each golden's torch state dict through the port's `torch_bridge`
  mappings (`_map_gin`, `_map_gat`), at 2e-5 as tests/test_parity.py;
- `GATGenerator` with the merge projection (heads 2 and 3, 2 layers),
  `EdgeGenerator`, `NodeGenerator`, `Discriminator` and `DiscriminatorV2`
  against the flax modules on the same parameters (numpy draws), fp32,
  dropout off, at 2e-5; the dropout of a GIN and a GAT round draws from the
  seed it is given;
- a 2-batch GQA trajectory (relation then representation, four BertAdam
  updates) with `gnn="GIN"` and with `gnn="GAT"` against JAX's
  `make_ggm_train_step`, through tests/test_torch_train_step.py's helpers
  and checks: losses rtol 1e-4, every parameter atol 1e-5, BertAdam's
  counters and flags exactly.

The JAX trajectories compile once per generator, in threads; torch runs on
one thread. Tests loop over their cases (see
tests/test_torch_attention_dropout.py for why the files hold few tests).
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from xggm_tpu.ggm import generators as jax_gen
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params
from xggm_tpu_torch.checkpoint.torch_bridge import _Mapper, _map_gat, _map_gin
from xggm_tpu_torch.ggm import generators as gen
from xggm_tpu_torch.ops.basic import DropoutRng, init_weights

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=2e-5, atol=2e-5)
HID = 64
GNNS = ("GIN", "GAT")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(module, flat):
    """Fill `module` from a flat JAX-layout dict (no `params/` prefix)."""
    module.load_state_dict(from_jax_params(flat, module))
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _graph(seed, b=3, width=HID):
    rng = np.random.RandomState(seed)
    adj = rng.rand(b, 36, 36).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    adj[:, :, 5] = 0.0  # some edges absent: GAT masks them
    adj[:, 5, :] = 0.0
    return rng.randn(b, 36, width).astype(np.float32), adj


def _random_params(jax_module, *args, seed=0):
    """The flax module's parameters drawn with numpy: LayerNorm scales near
    1, every other leaf normal(0, 0.1); as a flat dict."""
    shapes = jax.eval_shape(lambda k: jax_module.init(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return params, _flatten(params)


def test_gin_and_gat_generators_match_goldens():
    for name, n_layers in (("ggm_gin_tiny.npz", 2), ("ggm_gat_tiny.npz", 1)):
        data = np.load(os.path.join(GOLDENS, name))
        sd = {k[len("sd::"):]: data[k] for k in data.files
              if k.startswith("sd::")}
        m = _Mapper(sd)
        for i in range(n_layers):
            if "gin" in name:
                _map_gin(m, f"gnn_layers.{i}", f"gnn_{i}", n_convs=1)
            else:
                _map_gat(m, f"gnn_layers.{i}", f"gnn_{i}", n_heads=2)
        assert not m.missing, m.missing[:5]
        module = (gen.GINGenerator(HID, n_layers, device="cpu")
                  if "gin" in name else
                  gen.GATGenerator(HID, n_layers, faithful_cat=True,
                                   device="cpu"))
        _load(module, m.out)
        with torch.no_grad():
            x, adj = module(_t(data["x"]), _t(data["adj"]))
        np.testing.assert_allclose(x.numpy(), data["out_x"], err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(adj.numpy(), data["out_adj"],
                                   err_msg=name, **TOL)


def test_generators_and_discriminators_match_flax():
    x, adj = _graph(0)
    cases = [
        ("GAT, 2 heads", jax_gen.GATGenerator(HID, 2, n_head=2),
         gen.GATGenerator(HID, 2, n_head=2, device="cpu"), (x, adj, True)),
        ("GAT, 3 heads", jax_gen.GATGenerator(HID, 2, n_head=3),
         gen.GATGenerator(HID, 2, n_head=3, device="cpu"), (x, adj, True)),
        ("edge", jax_gen.EdgeGenerator(HID, 2),
         gen.EdgeGenerator(HID, 2, device="cpu"), (x, adj, True)),
        ("node", jax_gen.NodeGenerator(HID, 2),
         gen.NodeGenerator(HID, 2, device="cpu"), (x, adj, True)),
        ("discriminator", jax_gen.Discriminator(),
         gen.Discriminator(36 * HID, device="cpu"), (x,)),
        ("discriminator v2", jax_gen.DiscriminatorV2(),
         gen.DiscriminatorV2(36 * 36, device="cpu"), (adj,)),
    ]
    for name, jax_module, port, args in cases:
        params, flat = _random_params(jax_module, *args)
        want = jax.tree.leaves(jax_module.apply(params, *args))
        _load(port, {k[len("params/"):]: v for k, v in flat.items()})
        with torch.no_grad():
            got = port(*(_t(a) for a in args[:2]))
        got = list(got) if isinstance(got, tuple) else [got]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **TOL)

    # dropout (GGM rate 0.5) draws from the seed it is given
    for gnn in ("GIN", "GAT"):
        module = init_weights(gen.make_generator(gnn, HID, 2, device="cpu"),
                              torch.Generator().manual_seed(0))

        def run(seed):
            rng = None if seed is None else DropoutRng(seed, "cpu")
            with torch.no_grad():
                return module(_t(x), _t(adj), rng)[0]

        assert torch.equal(run(3), run(3)), gnn
        assert not torch.allclose(run(3), run(4)), gnn
        assert not torch.allclose(run(3), run(None)), gnn
    with pytest.raises(ValueError, match="GNN"):
        gen.make_generator("GNN", HID, 2, device="cpu")


@pytest.fixture(scope="module")
def trajectories():
    import test_torch_train_step as tts

    batches = tts._batches()
    # both generators' JAX steps lower and compile at once: XLA's compile
    # releases the interpreter lock
    with ThreadPoolExecutor(2) as pool:
        jax_side = dict(zip(GNNS, pool.map(
            lambda gnn: tts._jax_trajectory(batches, gnn=gnn), GNNS)))
    return {gnn: (record, tts._port_trajectory(flat0, batches, gnn=gnn))
            for gnn, (flat0, record) in jax_side.items()}


def test_train_step_with_gin_and_gat_matches_jax(trajectories):
    import test_torch_train_step as tts

    for gnn, (jax_record, port_record) in trajectories.items():
        params = port_record[-1]["params"]
        assert any(n.startswith("generator.gnn.0.conv.0.eps") for n in params
                   ) == (gnn == "GIN")
        assert any(n.startswith("generator.merge.1.") for n in params
                   ) == (gnn == "GAT")
        tts._check_trajectory(jax_record, port_record)
