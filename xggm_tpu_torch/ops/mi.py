"""Mutual-information estimators (counterpart of `xggm_tpu/ops/mi.py`):
variational bounds over [sample_size, dim] batches, with the reference's
formulas and sign conventions as the JAX package keeps them (MINE, NWJ and
InfoNCEv2 return the negative lower bound; InfoNCE the positive one).

A sampling estimator draws its permutation, indices or normals from a
`torch.Generator` on the inputs' device, or takes them from the caller
(`perm`, `idx`, `normals`). Submodules carry the flax automatic names of the
JAX package's tree (`_MuLogvarNet_0`, `_TNet_0`, `Dense_k`, `layers_k`,
`MIEstimator_0`, `InfoNCE_0`), so `checkpoint/jax_params.py` maps it
leaf for leaf. The constructors take the input widths, which flax infers.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import gelu, lecun_dense


def _perm(generator: Optional[torch.Generator], n: int,
          like: torch.Tensor) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=like.device)


def _normal(generator: Optional[torch.Generator],
            like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


class _MuLogvarNet(nn.Module):
    """q(y | x): mu = Dense_0(relu(Dense_1(x))), logvar =
    tanh(Dense_2(relu(Dense_3(x)))), through hidden_size // 2."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int, *,
                 device=None):
        super().__init__()
        h = hidden_size // 2
        self.Dense_0 = lecun_dense(h, y_dim, device=device)
        self.Dense_1 = lecun_dense(x_dim, h, device=device)
        self.Dense_2 = lecun_dense(h, y_dim, device=device)
        self.Dense_3 = lecun_dense(x_dim, h, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.Dense_0(F.relu(self.Dense_1(x)))
        return mu, torch.tanh(self.Dense_2(F.relu(self.Dense_3(x))))


class _TNet(nn.Module):
    """Critic T(x, y) = Dense_0(relu(Dense_1([x, y]))), softplus'd when
    asked."""

    def __init__(self, in_dim: int, hidden_size: int, softplus: bool = False,
                 *, device=None):
        super().__init__()
        self.softplus = softplus
        self.Dense_0 = lecun_dense(hidden_size, 1, device=device)
        self.Dense_1 = lecun_dense(in_dim, hidden_size, device=device)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        t = self.Dense_0(F.relu(self.Dense_1(xy)))
        return F.softplus(t) if self.softplus else t


class _Variational(nn.Module):
    """An estimator over a q(y | x) network `_MuLogvarNet_0`."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int, *,
                 device=None):
        super().__init__()
        self._MuLogvarNet_0 = _MuLogvarNet(x_dim, y_dim, hidden_size,
                                           device=device)


class CLUB(_Variational):
    """Contrastive log-ratio upper bound, negatives averaged over all
    samples."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mu, logvar = self._MuLogvarNet_0(x)
        positive = -((mu - y) ** 2) / 2.0 / torch.exp(logvar)
        negative = -((y[None, :, :] - mu[:, None, :]) ** 2).mean(1) \
            / 2.0 / torch.exp(logvar)
        return (positive.sum(-1) - negative.sum(-1)).mean()


class CLUBSample(_Variational):
    """Sampled CLUB: the negatives are y permuted (`perm`, or drawn)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        mu, logvar = self._MuLogvarNet_0(x)
        if perm is None:
            perm = _perm(generator, y.shape[0], y)
        positive = -((mu - y) ** 2) / torch.exp(logvar)
        negative = -((mu - y[perm]) ** 2) / torch.exp(logvar)
        return (positive.sum(-1) - negative.sum(-1)).mean() / 2.0


def club_v2_org(y: torch.Tensor) -> torch.Tensor:
    """Parameter-free CLUBv2 (the InfoBERT variant)."""
    negative = -((y[None, :, :] - y[:, None, :]) ** 2).mean(1) / 2.0
    return (-negative.sum(-1)).mean()


def club_v2_sample(generator: Optional[torch.Generator], y: torch.Tensor,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CLUBv2 against y at `idx` (drawn uniformly with replacement when not
    given)."""
    if idx is None:
        idx = torch.randint(0, y.shape[0], (y.shape[0],),
                            generator=generator, device=y.device)
    negative = -((y - y[idx]) ** 2) / 2.0
    return (-negative.sum(-1)).mean()


class MINE(nn.Module):
    """Donsker-Varadhan lower bound; returns -bound."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int, *,
                 device=None):
        super().__init__()
        self._TNet_0 = _TNet(x_dim + y_dim, hidden_size, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        if perm is None:
            perm = _perm(generator, y.shape[0], y)
        t0 = self._TNet_0(torch.cat([x, y], -1))
        t1 = self._TNet_0(torch.cat([x, y[perm]], -1))
        return -(t0.mean() - torch.log(torch.exp(t1).mean()))


def _pairs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[n, n, x_dim + y_dim]: entry (i, j) is [x_j, y_i]."""
    n = y.shape[0]
    return torch.cat([x[None].expand(n, *x.shape),
                      y[:, None].expand(n, n, *y.shape[1:])], -1)


class NWJ(nn.Module):
    """NWJ (f-divergence) lower bound; returns -bound."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int, *,
                 device=None):
        super().__init__()
        self._TNet_0 = _TNet(x_dim + y_dim, hidden_size, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = y.shape[0]
        t0 = self._TNet_0(torch.cat([x, y], -1))
        t1 = self._TNet_0(_pairs(x, y)) - 1.0
        lower = t0.mean() - torch.exp(torch.logsumexp(t1, 1)
                                      - math.log(n)).mean()
        return -lower


class VarUB(_Variational):
    """Variational upper bound: 0.5 mean(mu^2 + exp(logvar) - 1 -
    logvar)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mu, logvar = self._MuLogvarNet_0(x)
        return 0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar).mean()


class L1OutUB(_Variational):
    """Leave-one-out upper bound."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = y.shape[0]
        mu, logvar = self._MuLogvarNet_0(x)
        positive = (-((mu - y) ** 2) / 2.0 / torch.exp(logvar)
                    - logvar / 2.0).sum(-1)
        all_probs = (-((y[None, :, :] - mu[:, None, :]) ** 2)
                     / 2.0 / torch.exp(logvar)[:, None, :]
                     - logvar[:, None, :] / 2.0).sum(-1)
        diag = torch.eye(n, dtype=all_probs.dtype,
                         device=all_probs.device) * -20.0
        negative = torch.logsumexp(all_probs + diag, 0) - math.log(n - 1.0)
        return (positive - negative).mean()


class _InfoNCEBase(nn.Module):
    def __init__(self, x_dim: int, y_dim: int, hidden_size: int = 300, *,
                 device=None):
        super().__init__()
        self._TNet_0 = _TNet(x_dim + y_dim, hidden_size, softplus=True,
                             device=device)

    def _scores(self, x, y, generator, perm):
        if perm is None:
            perm = _perm(generator, y.shape[0], y)
        t0 = self._TNet_0(torch.cat([x, y], -1))
        return t0, self._TNet_0(_pairs(x, y[perm]))[..., 0]


class InfoNCE(_InfoNCEBase):
    """InfoNCE lower bound with a softplus critic; returns the positive
    bound, as the reference does."""

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        t0, t1 = self._scores(x, y, generator, perm)
        return t0.mean() - (torch.logsumexp(t1, 1).mean()
                            - math.log(y.shape[0]))


class InfoNCEv2(_InfoNCEBase):
    """The sum-over-negatives variant; returns -bound."""

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        t0, t1 = self._scores(x, y, generator, perm)
        return -(math.log(y.shape[0]) + t0.mean() - t1.sum(1).mean())


class _GeluMLP(nn.Module):
    """flax nn.Sequential([Dense, gelu, Dense(, tanh)]): `layers_0`,
    `layers_2`."""

    def __init__(self, n_in: int, n_hid: int, n_out: int, tanh: bool, *,
                 device=None):
        super().__init__()
        self.tanh = tanh
        self.layers_0 = lecun_dense(n_in, n_hid, device=device)
        self.layers_2 = lecun_dense(n_hid, n_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layers_2(gelu(self.layers_0(x)))
        return torch.tanh(y) if self.tanh else y


class MIUpperBound(nn.Module):
    """The 'modified CLUBv2' upper bound with a variational q(y | x)
    (`p_mu`, `p_logvar`: exact-erf GELU heads, the logvar tanh'd), in the
    "original" (all negatives) or "sample" (permuted negatives) mode. The
    parameter-free estimates are `mi_upper_bound_org` and
    `mi_upper_bound_sample`."""

    def __init__(self, variational: bool = False, x_dim: int = 0,
                 y_dim: int = 0, hidden_size: int = 0, *, device=None):
        super().__init__()
        if variational:
            h = hidden_size // 2
            self.p_mu = _GeluMLP(x_dim, h, y_dim, False, device=device)
            self.p_logvar = _GeluMLP(x_dim, h, y_dim, True, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None,
                mi_mode: str = "original") -> torch.Tensor:
        mu, logvar = self.p_mu(x), self.p_logvar(x)
        if mi_mode == "original":
            positive = -((mu - y) ** 2) / 2.0 / torch.exp(logvar)
            negative = -((y[None, :, :] - mu[:, None, :]) ** 2).mean(1) \
                / 2.0 / torch.exp(logvar)
            return (positive.sum(-1) - negative.sum(-1)).mean()
        if perm is None:
            if generator is None:
                raise ValueError('mi_mode="sample" needs a generator or a '
                                 'permutation')
            perm = _perm(generator, y.shape[0], y)
        positive = -((mu - y) ** 2) / torch.exp(logvar)
        negative = -((mu - y[perm]) ** 2) / torch.exp(logvar)
        return (positive.sum(-1) - negative.sum(-1)).mean() / 2.0


def mi_upper_bound_org(y: torch.Tensor) -> torch.Tensor:
    """MIUpperBound's parameter-free estimate over all negatives."""
    return club_v2_org(y)


def mi_upper_bound_sample(generator: Optional[torch.Generator],
                          y: torch.Tensor,
                          perm: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """MIUpperBound's parameter-free estimate against y permuted (where
    CLUBv2's draws with replacement)."""
    if perm is None:
        perm = _perm(generator, y.shape[0], y)
    negative = -((y - y[perm]) ** 2) / 2.0
    return (-negative.sum(-1)).mean()


class MIEstimator(nn.Module):
    """JSD / energy-based MI critic: [x1, x2] -> 1024 GELU -> 1024 GELU ->
    1 (`Dense_0` to `Dense_2`), negatives by rolling x1 one row. Returns
    (JSD gradient term, the estimate)."""

    def __init__(self, in_dim: int, *, device=None):
        super().__init__()
        self.Dense_0 = lecun_dense(in_dim, 1024, device=device)
        self.Dense_1 = lecun_dense(1024, 1024, device=device)
        self.Dense_2 = lecun_dense(1024, 1, device=device)

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(gelu(self.Dense_1(gelu(self.Dense_0(x)))))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = self._net(torch.cat([x1, x2], 1))
        neg = self._net(torch.cat([torch.roll(x1, 1, 0), x2], 1))
        grad = -F.softplus(-pos).mean() - F.softplus(neg).mean()
        return grad, pos.mean() - torch.exp(neg).mean() + 1.0


def _factorized_normal(z: torch.Tensor, hidden_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return z[:, :hidden_size], F.softplus(z[:, hidden_size:]) + 1e-7


def _normal_log_prob(x: torch.Tensor, mu: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    return (-0.5 * math.log(2 * math.pi) - torch.log(sigma)
            - 0.5 * ((x - mu) / sigma) ** 2).sum(-1)


def _skl(z1, mu1, s1, z2, mu2, s2) -> torch.Tensor:
    kl_1_2 = _normal_log_prob(z1, mu1, s1) - _normal_log_prob(z1, mu2, s2)
    kl_2_1 = _normal_log_prob(z2, mu2, s2) - _normal_log_prob(z2, mu1, s1)
    return (kl_1_2 + kl_2_1).mean()


class MVMIEstimator(nn.Module):
    """Multi-view objective: factorized-normal posteriors from [*, 2 hidden]
    heads, reparameterized samples (`normals` = (n1, n2), or drawn), their
    symmetric KL minus twice the JSD gradient of `MIEstimator_0`."""

    def __init__(self, hidden_size: int = 384, *, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.MIEstimator_0 = MIEstimator(2 * hidden_size, device=device)

    def forward(self, p_z1: torch.Tensor, p_z2: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                normals: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        mu1, s1 = _factorized_normal(p_z1, self.hidden_size)
        mu2, s2 = _factorized_normal(p_z2, self.hidden_size)
        n1, n2 = normals or (_normal(generator, mu1), _normal(generator, mu2))
        z1, z2 = mu1 + s1 * n1, mu2 + s2 * n2
        mi_gradient, _ = self.MIEstimator_0(z1, z2)
        return _skl(z1, mu1, s1, z2, mu2, s2) - 2.0 * mi_gradient


class JointMIEstimator(nn.Module):
    """Cross-modal objective: the lang_len language and visn_len visual
    positions pooled by learned projections (`fc_l`, `fc_v`),
    factorized-normal posteriors, reparameterized samples, half their
    symmetric KL minus the InfoNCE estimate of `InfoNCE_0`. `draws` =
    (n1, n2, perm), or drawn from `generator`."""

    def __init__(self, hidden_size: int = 384, lang_len: int = 20,
                 visn_len: int = 36, *, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.fc_l = lecun_dense(lang_len, 1, device=device)
        self.fc_v = lecun_dense(visn_len, 1, device=device)
        self.InfoNCE_0 = InfoNCE(hidden_size, hidden_size, device=device)

    def forward(self, zl: torch.Tensor, zv: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None) -> torch.Tensor:
        z1 = self.fc_l(zl.transpose(1, 2))[..., 0]
        z2 = self.fc_v(zv.transpose(1, 2))[..., 0]
        mu1, s1 = _factorized_normal(z1, self.hidden_size)
        mu2, s2 = _factorized_normal(z2, self.hidden_size)
        if draws is None:
            draws = (_normal(generator, mu1), _normal(generator, mu2),
                     _perm(generator, mu1.shape[0], mu1))
        n1, n2, perm = draws
        z1, z2 = mu1 + s1 * n1, mu2 + s2 * n2
        d_skl = _skl(z1, mu1, s1, z2, mu2, s2) / 2.0
        return d_skl - self.InfoNCE_0(z1, z2, perm=perm)


def knn_kl_estimator(s1: torch.Tensor, s2: torch.Tensor,
                     k: int = 1) -> torch.Tensor:
    """Brute-force k-NN estimate of KL(P || Q) from samples s1 ~ P and
    s2 ~ Q."""
    n, m, d = s1.shape[0], s2.shape[0], s1.shape[1]
    nu_k = (s2[None, :, :] - s1[:, None, :]).norm(dim=-1).sort(-1).values[
        :, k - 1]
    rho_k = (s1[:, None, :] - s1[None, :, :]).norm(dim=-1).sort(-1).values[
        :, k]
    return math.log(m / (n - 1.0)) + (d / n) * torch.log(nu_k / rho_k).sum()


def skl_divergence_knn(xl: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Symmetric k-NN KL."""
    return knn_kl_estimator(xl, xv) + knn_kl_estimator(xv, xl)
