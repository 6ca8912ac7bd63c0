"""The port's MI estimators, debias losses and UpDn blocks against the JAX
package's, on the same numpy inputs and weights, fp32, dropout off, every
sampling estimator fed JAX's draws (the permutation, indices or normals
its key gives). Outputs and parameter gradients within 1e-5 (the absolute
part scaled by the tensor's, or for gradients the module's, largest entry
where that exceeds 1); each module's tree carried across and back bit for
bit. The debias losses are also held to the reference's torch formulas
(those of tests/test_lineage.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from _torch_parity import (  # noqa: F401
    carry, close, hold_all, one_torch_thread, random_params, t)
from xggm_tpu.models import updn as ju
from xggm_tpu.ops import debias_losses as jd
from xggm_tpu.ops import mi as jm
from xggm_tpu_torch.models import updn as pu
from xggm_tpu_torch.ops import debias_losses as pd
from xggm_tpu_torch.ops import mi as pm

KEY = jax.random.PRNGKey(5)


def _xy(seed, n=12, dx=6, dy=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dx).astype(np.float32),
            rng.randn(n, dy).astype(np.float32))


def _case(name, jax_module, port_module, jax_args, port_call, seed):
    jax_args = tuple(jnp.asarray(a) for a in jax_args)
    params = random_params(lambda k: jax_module.init(k, *jax_args), seed=seed)
    return (name, lambda p: jax_module.apply(p, *jax_args), params,
            carry(params, port_module), lambda: port_call(port_module))


def test_mi_estimators_match_jax():
    x, y = _xy(0)
    n = y.shape[0]
    # the draws and the parameter-free estimators, in one compiled program
    want = jax.tree_util.tree_map(np.asarray, jax.jit(lambda x, y: dict(
        perm=jax.random.permutation(KEY, n),
        idx=jax.random.randint(KEY, (n,), 0, n),
        club_v2_org=jm.club_v2_org(y),
        club_v2_sample=jm.club_v2_sample(KEY, y),
        knn=jm.knn_kl_estimator(x[:, :5], y),
        knn3=jm.knn_kl_estimator(x[:, :5], y, k=3),
        skl=jm.skl_divergence_knn(x[:, :5], y)))(x, y))
    perm = t(want["perm"])
    cases = [
        _case("CLUB", jm.CLUB(5, 8), pm.CLUB(6, 5, 8, device="cpu"), (x, y),
              lambda m: m(t(x), t(y)), 0),
        _case("CLUBSample", jm.CLUBSample(5, 8),
              pm.CLUBSample(6, 5, 8, device="cpu"), (x, y, KEY),
              lambda m: m(t(x), t(y), perm=perm), 1),
        _case("MINE", jm.MINE(8), pm.MINE(6, 5, 8, device="cpu"),
              (x, y, KEY), lambda m: m(t(x), t(y), perm=perm), 2),
        _case("NWJ", jm.NWJ(8), pm.NWJ(6, 5, 8, device="cpu"), (x, y),
              lambda m: m(t(x), t(y)), 3),
        _case("VarUB", jm.VarUB(5, 8), pm.VarUB(6, 5, 8, device="cpu"),
              (x, y), lambda m: m(t(x), t(y)), 4),
        _case("L1OutUB", jm.L1OutUB(5, 8), pm.L1OutUB(6, 5, 8, device="cpu"),
              (x, y), lambda m: m(t(x), t(y)), 5),
        _case("InfoNCE", jm.InfoNCE(8), pm.InfoNCE(6, 5, 8, device="cpu"),
              (x, y, KEY), lambda m: m(t(x), t(y), perm=perm), 6),
        _case("InfoNCEv2", jm.InfoNCEv2(8),
              pm.InfoNCEv2(6, 5, 8, device="cpu"), (x, y, KEY),
              lambda m: m(t(x), t(y), perm=perm), 7),
    ]
    hold_all(cases)
    close(pm.club_v2_org(t(y)), want["club_v2_org"], "club_v2_org")
    close(pm.club_v2_sample(None, t(y), idx=t(want["idx"])),
          want["club_v2_sample"], "club_v2_sample")
    close(pm.knn_kl_estimator(t(x[:, :5]), t(y)), want["knn"],
          "knn_kl_estimator")
    close(pm.knn_kl_estimator(t(x[:, :5]), t(y), k=3), want["knn3"],
          "knn_kl_estimator k=3")
    close(pm.skl_divergence_knn(t(x[:, :5]), t(y)), want["skl"],
          "skl_divergence_knn")

    # the port's own draws: a seeded generator gives the estimate of the
    # permutation it draws
    mod = cases[2][3]
    with torch.no_grad():
        drawn = mod(t(x), t(y), torch.Generator().manual_seed(4))
        given = mod(t(x), t(y), perm=torch.randperm(
            n, generator=torch.Generator().manual_seed(4)))
    assert torch.equal(drawn, given) and torch.isfinite(drawn)
    got = sorted(torch.randperm(n, generator=torch.Generator()).tolist())
    assert got == list(range(n))


def test_composite_mi_estimators_match_jax():
    x, y = _xy(1)
    n = y.shape[0]
    h = 4
    rng = np.random.RandomState(2)
    z1, z2 = (rng.randn(n, 2 * h).astype(np.float32) for _ in range(2))
    zl = rng.randn(6, 20, 2 * h).astype(np.float32)
    zv = rng.randn(6, 36, 2 * h).astype(np.float32)
    def draws(y):
        k1, k2 = jax.random.split(KEY)
        j1, j2, j3 = jax.random.split(KEY, 3)
        return dict(perm=jax.random.permutation(KEY, n),
                    mv=(jax.random.normal(k1, (n, h)),
                        jax.random.normal(k2, (n, h))),
                    joint=(jax.random.normal(j1, (6, h)),
                           jax.random.normal(j2, (6, h)),
                           jax.random.permutation(j3, 6)),
                    org=jm.mi_upper_bound_org(y),
                    sample=jm.mi_upper_bound_sample(KEY, y))

    want = jax.tree_util.tree_map(np.asarray, jax.jit(draws)(y))
    perm = t(want["perm"])
    mv_normals = tuple(map(t, want["mv"]))
    joint_draws = tuple(map(t, want["joint"]))
    ub = jm.MIUpperBound(True, 5, 8)
    pub = pm.MIUpperBound(True, 6, 5, 8, device="cpu")
    x, y = jnp.asarray(x), jnp.asarray(y)
    params = random_params(lambda k: ub.init(k, x, y), seed=0)
    cases = [
        ("MIUpperBound", lambda p: (ub.apply(p, x, y),
                                    ub.apply(p, x, y, KEY, mi_mode="sample")),
         params, carry(params, pub),
         lambda: (pub(t(x), t(y)), pub(t(x), t(y), perm=perm,
                                       mi_mode="sample"))),
        _case("MIEstimator", jm.MIEstimator(), pm.MIEstimator(11,
                                                             device="cpu"),
              (x, y), lambda m: m(t(x), t(y)), 1),
        _case("MVMIEstimator", jm.MVMIEstimator(h),
              pm.MVMIEstimator(h, device="cpu"), (z1, z2, KEY),
              lambda m: m(t(z1), t(z2), normals=mv_normals), 2),
        _case("JointMIEstimator", jm.JointMIEstimator(h),
              pm.JointMIEstimator(h, device="cpu"), (zl, zv, KEY),
              lambda m: m(t(zl), t(zv), draws=joint_draws), 3),
    ]
    hold_all(cases)
    close(pm.mi_upper_bound_org(t(y)), want["org"], "mi_upper_bound_org")
    close(pm.mi_upper_bound_sample(None, t(y), perm=perm), want["sample"],
          "mi_upper_bound_sample")
    with pytest.raises(ValueError, match="sample"):
        pub(t(x), t(y), mi_mode="sample")
    gen = torch.Generator().manual_seed(0)
    for est in (cases[2][3](t(z1), t(z2), gen),
                cases[3][3](t(zl), t(zv), gen)):
        assert torch.isfinite(est)


def test_debias_losses_match_jax_and_reference():
    rng = np.random.RandomState(3)
    b, a, hd = 6, 10, 12
    hidden = rng.randn(b, hd).astype(np.float32)
    logits = rng.randn(b, a).astype(np.float32)
    bias = rng.rand(b, a).astype(np.float32)
    labels = (rng.rand(b, a) > 0.7).astype(np.float32)
    args = (hidden, logits, bias, labels)
    targs = tuple(map(t, args))
    tl, tb, tt = targs[1:]
    reference = {
        "plain_loss": TF.binary_cross_entropy_with_logits(tl, tt) * a,
        "focal_loss": TF.binary_cross_entropy_with_logits(
            torch.log(TF.softmax(tl, 1) + 1e-5)
            * (1 - TF.softmax(tb, 1)) ** 2, tt) * a,
        "reweight_by_inv_bias": (
            -(TF.logsigmoid(tl) * tt + (1 - tt) * TF.logsigmoid(-tl))
            * (1 - tb)).sum() / (1 - tb).sum(),
    }
    helpers = (("convert_sigmoid_logits_to_binary_logprobs", (1,)),
               ("elementwise_logsumexp", (1, 2)),
               ("renormalize_binary_logits", (1, 2)))
    constant = jd.BiasProduct(False, 0.0, 0.1)  # no parameters
    want = jax.jit(lambda *a: (
        {name: getattr(jd, name)(*a) for name in reference},
        {name: getattr(jd, name)(*(a[i] for i in idx))
         for name, idx in helpers},
        constant.apply({}, *a)))(*args)
    for name, ref in reference.items():
        got = getattr(pd, name)(*targs)
        close(got, want[0][name], name)
        close(got, ref, f"{name} vs the reference formula",
              dict(rtol=1e-4, atol=1e-6))
    for name, idx in helpers:
        got = getattr(pd, name)(*(targs[i] for i in idx))
        w = want[1][name]
        for g, ww in zip(*((got, w) if isinstance(got, tuple)
                           else ((got,), (w,)))):
            close(g, ww, name)
    close(pd.BiasProduct(False, 0.0, 0.1, device="cpu")(*targs), want[2],
          "BiasProduct constant")
    cases = []
    for i, (name, jmod, pmod) in enumerate((
            ("BiasProduct", jd.BiasProduct(), pd.BiasProduct(device="cpu")),
            ("LearnedMixin", jd.LearnedMixin(0.36, hd),
             pd.LearnedMixin(0.36, hd, device="cpu")),
            ("LearnedMixin constant",
             jd.LearnedMixin(0.36, hd, smooth=False, constant_smooth=0.05),
             pd.LearnedMixin(0.36, hd, smooth=False, constant_smooth=0.05,
                             device="cpu")))):
        cases.append(_case(name, jmod, pmod, args, lambda m: m(*targs), i))
    hold_all(cases)


def test_updn_blocks_match_jax():
    rng = np.random.RandomState(4)
    v = rng.randn(3, 7, 10).astype(np.float32)
    q = rng.randn(3, 6).astype(np.float32)
    ids = rng.randint(0, 21, (3, 5)).astype(np.int32)
    emb = rng.randn(3, 5, 4).astype(np.float32)
    cases = [
        _case("FCNet", ju.FCNet((10, 8, 5)),
              pu.FCNet((10, 8, 5), device="cpu"), (v,), lambda m: m(t(v)),
              0),
        _case("Attention", ju.Attention(8), pu.Attention(10, 6, 8,
                                                         device="cpu"),
              (v, q), lambda m: m(t(v), t(q)), 1),
        _case("NewAttention", ju.NewAttention(8),
              pu.NewAttention(10, 6, 8, device="cpu"), (v, q),
              lambda m: m(t(v), t(q)), 2),
        _case("SimpleClassifier", ju.SimpleClassifier(8, 4),
              pu.SimpleClassifier(6, 8, 4, device="cpu"), (q,),
              lambda m: m(t(q)), 3),
        _case("GaussianLayer", ju.GaussianLayer(6, 4),
              pu.GaussianLayer(6, 4, device="cpu"), (q,), lambda m: m(t(q)),
              4),
        _case("WordEmbedding", ju.WordEmbedding(20, 4),
              pu.WordEmbedding(20, 4, device="cpu"), (ids,),
              lambda m: m(t(ids).long()), 5),
    ]
    # GRU and LSTM, one and two layers, one and two directions
    for i, (rnn, layers, bidirect) in enumerate((
            ("GRU", 1, False), ("GRU", 2, True), ("LSTM", 1, True),
            ("LSTM", 2, False))):
        cases.append(_case(
            f"QuestionEmbedding {rnn} {layers} bidirect={bidirect}",
            ju.QuestionEmbedding(6, layers, bidirect, rnn),
            pu.QuestionEmbedding(4, 6, layers, bidirect, rnn, device="cpu"),
            (emb,), lambda m: m(t(emb)), 10 + i))
    hold_all(cases)
    # JAX's forward_all builds its RNNs outside a compact method, so flax
    # cannot apply it: the port's steps end in its forward's last step
    qe = cases[-1][3]
    with torch.no_grad():
        steps = qe.forward_all(t(emb))
        assert steps.shape == (3, 5, 6)
        assert torch.equal(steps[:, -1], qe(t(emb)))

    want = jax.jit(lambda a, b: (
        ju.cosine_sim(a, b), ju.contrastive_loss(a, b),
        ju.contrastive_loss(a, b, max_violation=False)))(v[0], v[1])
    close(pu.cosine_sim(t(v[0]), t(v[1])), want[0], "cosine_sim")
    for mv, w in ((True, want[1]), (False, want[2])):
        close(pu.contrastive_loss(t(v[0]), t(v[1]), max_violation=mv), w,
              f"contrastive_loss max_violation={mv}")
