"""The port's graph helpers and GGM research lineage against the JAX
package's, on the same numpy inputs and weights, fp32, dropout off: the
noise helpers (JAX's draws replayed), `segment_sum`, `to_dense_batch` and
the hinge loss; `ggm/extras.py`; the score network and the Langevin
sampler; `ggm/graph_vae.py` with `mpm` and `match_graphs`. Outputs and
parameter gradients within 1e-5; each module's tree carried across and back
bit for bit. The port's own draws are checked for their distribution's
support and symmetry. Where a tensor's largest entry exceeds 1, the
absolute tolerance scales with it (`_torch_parity.close`)."""
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (  # noqa: F401
    carry, close, hold_all, one_torch_thread, random_params, t)
from xggm_tpu.ggm import extras as jx
from xggm_tpu.ggm import graph_vae as jv
from xggm_tpu.ggm import score_network as js
from xggm_tpu.ops import losses as jl
from xggm_tpu.ops import noise as jn
from xggm_tpu.ops import segment as jseg
from xggm_tpu_torch.ggm import extras as px
from xggm_tpu_torch.ggm import graph_vae as pv
from xggm_tpu_torch.ggm import score_network as ps
from xggm_tpu_torch.ops import hinge_discriminator_loss, noise as pn
from xggm_tpu_torch.ops import segment_sum, to_dense_batch

KEY = jax.random.PRNGKey(3)


def _graph(seed, b=2, n=6, f=4, binary=False):
    rng = np.random.RandomState(seed)
    a = rng.rand(b, n, n).astype(np.float32)
    if binary:
        a = (a > 0.5).astype(np.float32)
        a = np.triu(a, 1) + np.swapaxes(np.triu(a, 1), 1, 2)
    else:
        a = (a + np.swapaxes(a, 1, 2)) / 2
    flags = np.ones((b, n), np.float32)
    flags[:, n - 2:] = 0.0
    return rng.randn(b, n, f).astype(np.float32), a, flags


def _jax_noise_side(x, adjs, flags, batch, feats):
    """Every JAX helper of the noise test and the draws its keys give, in
    one compiled program."""
    shape, a = adjs.shape, adjs[0]
    out = {"normal": jax.random.normal(KEY, shape)}
    for half in (False, True):
        for fl in (None, flags):
            out[f"gaussian {half} {fl is None}"] = jn.add_gaussian_noise(
                KEY, adjs, 0.5, half, fl)
    out["gen_list_of_data"] = jn.gen_list_of_data(KEY, x, adjs, flags,
                                                  (0.5, 1.0))
    out["normals"] = [jax.random.normal(jax.random.fold_in(KEY, i), shape)
                      for i in range(2)]
    for p, lo, hi in CORRUPT_K:
        k = jax.random.fold_in(KEY, lo)
        out[f"corrupt {lo}"] = (jn.get_corrupt_k(k, lo, hi, p),
                                jax.random.geometric(k, p))
    for count in TOGGLES:
        k = jax.random.fold_in(KEY, count)
        kx, ky = jax.random.split(k)
        c = min(count, a.shape[-1])
        out[f"toggle {count}"] = (
            jn.toggle_edges(k, a, count),
            jax.random.randint(kx, (c,), 0, a.shape[0]),
            jax.random.randint(ky, (c,), 0, a.shape[1]))
    out["node_feature_to_matrix"] = jn.node_feature_to_matrix(x)
    out["mask_adjs"] = jn.mask_adjs(adjs, flags)
    out["mask_adjs channels"] = jn.mask_adjs(jnp.stack([adjs, adjs], 1),
                                             flags)
    out["pad_adjs"] = jn.pad_adjs(a, 9)
    out["add_self_loops"] = jn.add_self_loops(adjs)
    out["remove_self_loops"] = jn.remove_self_loops(adjs)
    out["check_adjs_symmetry"] = jn.check_adjs_symmetry(x[:, :, :4] @ jnp.ones(
        (4, 6)))
    out["hinge"] = jl.hinge_discriminator_loss(x[0], x[1])
    out["segment_sum"] = jseg.segment_sum(feats, batch, 4)
    out["to_dense_batch"] = jseg.to_dense_batch(feats, batch, 4, 6, -1.5)
    return out


CORRUPT_K = ((0.5, 1, 3), (0.3, 0, None))
TOGGLES = (1, 3, 50)


def test_noise_segment_and_hinge_match_jax():
    x, adjs, flags = _graph(0, b=3, binary=True)
    # segment_sum and to_dense_batch: ragged graphs of 2, 0, 4 and 1 nodes
    rng = np.random.RandomState(1)
    batch = np.repeat(np.arange(4), [2, 0, 4, 1]).astype(np.int64)
    feats = rng.randn(batch.size, 3).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(_jax_noise_side)(
        x, adjs, flags, batch, feats))

    for half in (False, True):
        for fl in (None, flags):
            got = pn.add_gaussian_noise(None, t(adjs), 0.5, half,
                                        None if fl is None else t(fl),
                                        normal=t(want["normal"]))
            for g, w in zip(got, want[f"gaussian {half} {fl is None}"]):
                close(g, w, f"add_gaussian_noise half={half}")
    got = pn.gen_list_of_data(None, t(x), t(adjs), t(flags), [0.5, 1.0],
                              normals=[t(n) for n in want["normals"]])
    w = want["gen_list_of_data"]
    for g, ww in zip(got[:3] + tuple(got[3]), tuple(w[:3]) + tuple(w[3])):
        close(g, ww, "gen_list_of_data")
    for p, lo, hi in CORRUPT_K:
        k, geometric = want[f"corrupt {lo}"]
        assert int(pn.get_corrupt_k(None, lo, hi, p,
                                    geometric=t(geometric))) == int(k)
    a = adjs[0]
    for count in TOGGLES:
        toggled, xs, ys = want[f"toggle {count}"]
        close(pn.toggle_edges(None, t(a), count, xy=(t(xs), t(ys))), toggled,
              f"toggle_edges {count}")
    for name, targs in (
            ("node_feature_to_matrix", (t(x),)),
            ("mask_adjs", (t(adjs), t(flags))),
            ("mask_adjs channels", (t(np.stack([adjs, adjs], 1)), t(flags))),
            ("pad_adjs", (t(a), 9)),
            ("add_self_loops", (t(adjs),)),
            ("remove_self_loops", (t(adjs),)),
            ("check_adjs_symmetry", (t(x[:, :, :4] @ np.ones((4, 6))),))):
        close(getattr(pn, name.split()[0])(*targs), want[name], name)
    close(hinge_discriminator_loss(t(x[0]), t(x[1])), want["hinge"], "hinge")
    close(segment_sum(t(feats), t(batch), 4), want["segment_sum"],
          "segment_sum")
    for max_n, fill, w in ((None, 0.0, jseg.to_dense_batch(feats, batch, 4)),
                           (6, -1.5, want["to_dense_batch"])):
        got = to_dense_batch(t(feats), t(batch), 4, max_n, fill)
        for g, ww in zip(got, w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(ww))

    # the port's own draws
    gen = torch.Generator().manual_seed(0)
    noisy, grad = pn.add_gaussian_noise(gen, t(adjs), 0.5, True, t(flags))
    assert torch.equal(noisy, noisy.transpose(1, 2))
    assert not noisy[:, 4:].any() and not grad[:, :, 4:].any()
    real = (noisy - t(adjs))[:, :4, :4]
    assert bool((real >= 0).all()) and bool(real.any())  # is_half: |noise|
    ks = [int(pn.get_corrupt_k(gen, 1, 3)) for _ in range(60)]
    assert set(ks) == {1, 2, 3}
    ks = [int(pn.get_corrupt_k(gen, 0, None, 0.5)) for _ in range(60)]
    assert min(ks) >= 0 and len(set(ks)) > 2
    for count in (1, 4, 50):
        state = gen.get_state()
        xs, ys = pn.draw_toggle_indices(gen, t(a), count)
        gen.set_state(state)
        out = pn.toggle_edges(gen, t(a), count).numpy()
        np.testing.assert_array_equal(out, out.T)
        assert set(np.unique(out)) <= {0.0, 1.0}
        # exactly the drawn positions flip, each with its mirror
        drawn = {tuple(sorted(p)) for p in zip(xs.tolist(), ys.tolist())}
        flipped = {tuple(sorted(p)) for p in zip(*np.nonzero(out != a))}
        assert flipped == drawn and len(xs) == min(count, a.shape[0])


def test_extras_match_jax():
    x, adj, flags = _graph(1, n=36, f=8)
    eps = np.asarray(jax.random.normal(KEY, (2, 8)))
    pooled = np.random.RandomState(2).randn(2, 8).astype(np.float32)
    feats = np.random.RandomState(3).rand(2, 36, 8).astype(np.float32)
    cases = [
        ("GinPlainEncoder", jx.GinPlainEncoder(8, 2),
         px.GinPlainEncoder(8, 8, 2, device="cpu"), (x, adj, True),
         lambda m: m(t(x), t(adj))),
        ("GCNPlainEncoder", jx.GCNPlainEncoder(8, 2),
         px.GCNPlainEncoder(8, 8, 2, device="cpu"), (x, adj, True),
         lambda m: m(t(x), t(adj))),
        ("MixGenerator", jx.MixGenerator(8, 2),
         px.MixGenerator(8, 8, 2, device="cpu"),
         (pooled, adj, feats, KEY, True),
         lambda m: m(t(pooled), t(adj), t(feats), eps=t(eps))),
        ("SpectralGCN", jx.SpectralGCN((8, 6, 3)),
         px.SpectralGCN((8, 6, 3), device="cpu"), (x, adj, flags),
         lambda m: m(t(x), t(adj), t(flags))),
        ("GraphAttentionLayer", jx.GraphAttentionLayer(5),
         px.GraphAttentionLayer(8, 5, device="cpu"), (x, adj),
         lambda m: m(t(x), t(adj))),
        ("GraphAttentionLayer concat=False",
         jx.GraphAttentionLayer(5, concat=False),
         px.GraphAttentionLayer(8, 5, concat=False, device="cpu"), (x, adj),
         lambda m: m(t(x), t(adj))),
    ]
    held = []
    for i, (name, jm, pm, args, run) in enumerate(cases):
        params = random_params(lambda k, jm=jm, args=args: jm.init(k, *args),
                               seed=i)
        held.append((name, lambda p, jm=jm, args=args: jm.apply(p, *args),
                     params, carry(params, pm),
                     lambda pm=pm, run=run: run(pm)))
    hold_all(held)
    close(px.normalize_adjacency(t(adj)), jx.normalize_adjacency(adj, flags),
           "normalize_adjacency")
    for row in (True, False):
        close(px.doubly_stochastic_norm(t(adj + 0.1), row),
               jx.doubly_stochastic_norm(adj + 0.1, row),
               f"doubly_stochastic_norm {row}")


def test_score_network_and_langevin_match_jax():
    b, n, f = 2, 7, 5
    x, _, flags = _graph(4, b=b, n=n, f=f)
    adjs, init_flags = js.gen_init_sample(KEY, b, n)
    got = ps.gen_init_sample(None, b, n, normal=t(np.asarray(
        jax.random.normal(KEY, (b, n, n)))))
    for g, w in zip(got, (adjs, init_flags)):
        close(g, w, "gen_init_sample")
    adjs = np.asarray(adjs)
    nets = [("EdgeDenseScoreNetwork", js.EdgeDenseScoreNetwork((f, 6, 6), 4),
             ps.EdgeDenseScoreNetwork((f, 6, 6), 4, device="cpu"), 1),
            ("EdgeDenseScoreNetwork 2 classes",
             js.EdgeDenseScoreNetwork((f, 6), 3, num_classes=2),
             ps.EdgeDenseScoreNetwork((f, 6), 3, num_classes=2,
                                      device="cpu"), 2)]
    held = []
    for i, (name, jm, pm, classes) in enumerate(nets):
        # the conditioned rows come in num_classes groups of the batch
        xx, aa, ff = (np.concatenate([v] * classes)
                      for v in (x, adjs, flags))
        params = random_params(lambda k, jm=jm, a=(xx, aa, ff): jm.init(k, *a),
                               seed=i)
        held.append((name, lambda p, jm=jm, a=(xx, aa, ff): jm.apply(p, *a),
                     params, carry(params, pm),
                     lambda pm=pm, a=(xx, aa, ff): pm(*map(t, a))))
    mlp = js.CondMLP(1, 3, 2)
    pm = ps.CondMLP(4, 1, 3, 2, device="cpu")
    params = random_params(lambda k: mlp.init(k, x[..., :4]), seed=5)
    held.append(("CondMLP 1 layer", lambda p: mlp.apply(p, x[..., :4]),
                 params, carry(params, pm), lambda: pm(t(x[..., :4]))))
    hold_all(held)

    # the sampler: 5 steps, JAX's noise replayed into the port's loop
    jm, pm = nets[0][1], nets[0][2]
    params = random_params(lambda k: jm.init(k, x, adjs, flags), seed=0)
    carry(params, pm)
    sampler = js.LangevinSampler(eps=0.3, grad_step_size=0.1, step_num=5)
    psampler = ps.LangevinSampler(eps=0.3, grad_step_size=0.1, step_num=5)
    assert psampler.sigma == sampler.sigma
    normals = [t(np.asarray(jax.random.normal(k, adjs.shape)))
               for k in jax.random.split(KEY, 5)]
    for to_int in (False, True):
        want = sampler.sample(KEY, lambda a, fl: jm.apply(params, x, a, fl),
                              adjs, flags, to_int=to_int)
        with torch.no_grad():
            got = psampler.sample(lambda a, fl: pm(t(x), a, fl), t(adjs),
                                  t(flags), to_int=to_int, normals=normals)
        for g, w in zip(got, want):
            close(g, w, f"LangevinSampler to_int={to_int}",
                  dict(rtol=1e-4, atol=1e-5))
    want = js.gen_multi_sigma_batches(KEY, x, adjs, [0.5, 1.0])
    normals = [t(np.asarray(jax.random.normal(jax.random.fold_in(KEY, i),
                                              adjs.shape)))
               for i in range(2)]
    got = ps.gen_multi_sigma_batches(None, t(x), t(adjs), [0.5, 1.0],
                                     normals=normals)
    for g, w in zip(got, want):
        close(g, w, "gen_multi_sigma_batches")
    # the port's own draws: symmetric, zero diagonal, 0/1 after sampling
    gen = torch.Generator().manual_seed(0)
    a0, f0 = ps.gen_init_sample(gen, b, n)
    assert torch.equal(a0, a0.transpose(1, 2)) and not a0.diagonal(
        dim1=1, dim2=2).any() and bool(f0.all())
    with torch.no_grad():
        out, _ = psampler.sample(lambda a, fl: pm(t(x), a, fl), a0, f0,
                                 generator=gen)
    assert set(np.unique(out.numpy())) <= {0.0, 1.0}


def _no_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


def test_graph_vae_modules_match_jax():
    b = 2
    rng = np.random.RandomState(6)
    x = rng.randn(b, 36, 12).astype(np.float32)
    adj = 1.0 / (1.0 + np.exp(-rng.randn(b, 36, 36)))
    adj = ((adj + np.swapaxes(adj, 1, 2)) / 2).astype(np.float32)
    eps = np.asarray(jax.random.normal(KEY, (b, 8)))

    vae = jv.GraphVAE(hidden_dim=8, input_dim=12)
    pvae = pv.GraphVAE(hidden_dim=8, input_dim=12, device="cpu")
    params = random_params(lambda k: vae.init(k, x, adj, KEY), seed=0)
    # deterministic, then the sampled path (std = exp(log_var)) with JAX's
    # eps and dropout off
    held = [("GraphVAE",
             lambda p: (vae.apply(p, x, adj, KEY),
                        vae.apply(p, x, adj, KEY, deterministic=False)),
             params, carry(params, pvae),
             lambda: (pvae(t(x), t(adj)), pvae(t(x), t(adj), eps=t(eps))))]

    h = rng.randn(b, 10).astype(np.float32)
    mlp_vae = jv.MlpVaePlain(embedding_size=8, y_size=5)
    pmlp = pv.MlpVaePlain(10, 8, 5, device="cpu")
    params = random_params(lambda k: mlp_vae.init(k, h, KEY), seed=1)
    held.append(("MlpVaePlain", lambda p: (mlp_vae.apply(p, h, KEY),
                                           mlp_vae.apply(p, h, KEY, False)),
                 params, carry(params, pmlp),
                 lambda: (pmlp(t(h)), pmlp(t(h), eps=t(eps)))))

    xs, adjs = x[:, :10, :8], adj[:, :10, :10]
    for i, (name, jm, pm) in enumerate((
            ("EdgeConvGNN", jv.EdgeConvGNN(8, 2),
             pv.EdgeConvGNN(8, 8, 10, 2, device="cpu")),
            ("EdgeConvGNN node_norm", jv.EdgeConvGNN(8, 1, node_norm=True),
             pv.EdgeConvGNN(8, 8, 10, 1, node_norm=True, device="cpu")),
            ("EdgeGNN", jv.EdgeGNN(8, 1), pv.EdgeGNN(8, 8, 1,
                                                    device="cpu")))):
        params = random_params(lambda k, jm=jm: jm.init(k, xs, adjs),
                               seed=2 + i)
        held.append((name, lambda p, jm=jm: jm.apply(p, xs, adjs), params,
                     carry(params, pm), lambda pm=pm: pm(t(xs), t(adjs))))
    with mock.patch.object(fnn.Dropout, "__call__", _no_dropout):
        hold_all(held)

    vals = rng.rand(b, 630).astype(np.float32)
    close(pv.recover_adj(t(vals)), jv.recover_adj(vals), "recover_adj")
    a, r = adj[0, :7, :7], adj[1, :7, :7]
    feat, feat_r = a.sum(1), r.sum(1)
    s_want = jax.jit(jv.edge_similarity_matrix)(a, r, feat, feat_r)
    s_got = pv.edge_similarity_matrix(t(a), t(r), t(feat), t(feat_r))
    close(s_got, s_want, "edge_similarity_matrix")
    init = np.full((7, 7), 1.0 / 7, np.float32)
    close(pv.mpm(t(init), s_got), jax.jit(jv.mpm)(init, s_want), "mpm")
    # the reference's hand case: a path and a star of 4 nodes
    path = np.array([[1, 1, 0, 0], [1, 1, 1, 0],
                     [0, 1, 1, 1], [0, 0, 1, 1]], np.float32)
    star = np.array([[1, 1, 1, 0], [1, 1, 0, 1],
                     [1, 0, 1, 0], [0, 1, 0, 1]], np.float32)
    got, want = pv.match_graphs(path, star), jv.match_graphs(path, star)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pv.permute_adj(path, *got),
                                  jv.permute_adj(path, *want))
