"""The GGM research lineage's remaining modules (counterpart of
`xggm_tpu/ggm/extras.py`):

* `GinPlainEncoder` / `GCNPlainEncoder`: n rounds of message passing over
  a fixed adjacency;
* `MixGenerator`: VAE-style node generation from a pooled vector (mu and
  log-variance heads, a decoder to 36 x hidden) refined by GIN rounds;
  returns (nodes, vae_loss);
* the Kipf spectral GCN (`GraphConvolution`, `normalize_adjacency`,
  `SpectralGCN`), in float32 as the JAX package asks;
* the GSM lineage's `doubly_stochastic_norm` and `GraphAttentionLayer`.

Submodules carry the JAX package's names (`gnn.i` for `gnn_i`, `gcn_i`,
`fc1`, `dec_ln`, ...), so `checkpoint/jax_params.py` maps a JAX tree onto
them. A forward takes an optional `rng` (`ops.basic.DropoutRng`) for its
dropout; without one it is deterministic. A random draw comes from a
`torch.Generator` unless the caller hands it in (`eps`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.config import NUM_OBJECTS
from xggm_tpu_torch.ggm.gnn import GCN, GIN
from xggm_tpu_torch.ops.basic import (
    FLAX_LN_EPS, DropoutRng, LayerNorm, at_least_float32, lecun_dense)


class GinPlainEncoder(nn.Module):
    """n_layers single-conv GINs (`gnn.i`) over a fixed adjacency."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        self.gnn = nn.ModuleList(
            GIN(in_dim if i == 0 else hidden_dim, (hidden_dim, hidden_dim),
                1, dropout, torch.float32, device=device)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
        return x


class GCNPlainEncoder(nn.Module):
    """n_layers single-conv GCNs (`gnn.i`) over a fixed adjacency."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        self.gnn = nn.ModuleList(
            GCN(in_dim if i == 0 else hidden_dim, (hidden_dim, hidden_dim),
                1, dropout, torch.float32, device=device)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
        return x


class MixGenerator(nn.Module):
    """VAE node generator and GIN refinement. z = mu + exp(log_var / 2) eps
    from the pooled vector x; the decoder (dec1, LayerNorm eps 1e-6, ReLU,
    dec2) gives 36 nodes of hidden_dim, which n_layers GINs refine. The loss
    is the KL term plus BCE-with-logits of the nodes against the real object
    features, times 768 (the reference's: the features are no
    probabilities)."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.fc1 = lecun_dense(in_dim, h, device=device)
        self.fc2 = lecun_dense(in_dim, h, device=device)
        self.dec1 = lecun_dense(h, 6 * h, device=device)
        self.dec_ln = LayerNorm(6 * h, FLAX_LN_EPS, device=device)
        self.dec2 = lecun_dense(6 * h, NUM_OBJECTS * h, device=device)
        self.gnn = nn.ModuleList(GIN(h, (h, h), 1, dropout, torch.float32,
                                     device=device)
                                 for _ in range(n_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                obj_feats: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(refined nodes [B, 36, hidden], vae_loss); eps, a standard normal
        of mu's shape, is drawn from `generator` when not given."""
        mu, log_var = self.fc1(x), self.fc2(x)
        std = torch.exp(0.5 * log_var)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              dtype=std.dtype, device=std.device)
        z = mu + std * eps
        h = F.relu(self.dec_ln(self.dec1(z)))
        nodes = self.dec2(h).view(-1, NUM_OBJECTS, self.hidden_dim)
        kl = -0.5 * torch.sum(1.0 + log_var - mu ** 2 - torch.exp(log_var))
        t, lg = at_least_float32(obj_feats), at_least_float32(nodes)
        rec = (lg.clamp_min(0.0) - lg * t
               + torch.log1p(torch.exp(-lg.abs()))).mean() * 768.0
        out = nodes
        for gnn in self.gnn:
            out = gnn(out, adj, rng)
        return out, rec + kl


class GraphConvolution(nn.Module):
    """Kipf GCN layer adj @ (x W) + b in the parameters' dtype (float32, as
    the JAX package asks), with the raw parameters
    `weight` [in, out] and `bias` [out], uniform in +-1/sqrt(out) at
    init."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.uniform_(-stdv, stdv, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        w = self.weight
        out = torch.matmul(adj.to(w.dtype), torch.matmul(x.to(w.dtype), w))
        return out if self.bias is None else out + self.bias


def normalize_adjacency(adjs: torch.Tensor) -> torch.Tensor:
    """Self-loops in place of the diagonal, then D^-1/2 A D^-1/2."""
    eye = torch.eye(adjs.shape[-1], dtype=adjs.dtype, device=adjs.device)
    adjs = adjs * (1.0 - eye) + eye
    dh = torch.rsqrt(adjs.sum(-1).clamp_min(1e-12))
    return dh[..., :, None] * adjs * dh[..., None, :]


class SpectralGCN(nn.Module):
    """Kipf GCN layers `gcn_i` (feature_nums[i] -> feature_nums[i + 1]) over
    the normalized adjacency, ReLU between them, on the flagged nodes."""

    def __init__(self, feature_nums: Sequence[int], *, device=None):
        super().__init__()
        self.n_layers = len(feature_nums) - 1
        for i in range(self.n_layers):
            setattr(self, f"gcn_{i}", GraphConvolution(
                feature_nums[i], feature_nums[i + 1], device=device))

    def forward(self, x: torch.Tensor, adjs: torch.Tensor,
                node_flags: torch.Tensor) -> torch.Tensor:
        adj_hat = normalize_adjacency(adjs)
        x = x * node_flags[..., None]
        for i in range(self.n_layers):
            x = getattr(self, f"gcn_{i}")(x, adj_hat)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


def doubly_stochastic_norm(adjs_f: torch.Tensor,
                           do_row_norm: bool = True) -> torch.Tensor:
    """Row-normalize (optionally), column-normalize, then E = E_col E^T."""
    e_tilde = adjs_f / adjs_f.sum(2, keepdim=True) if do_row_norm else adjs_f
    e_col = e_tilde / e_tilde.sum(1, keepdim=True)
    return torch.matmul(e_col, e_tilde.transpose(1, 2))


class GraphAttentionLayer(nn.Module):
    """The GSM lineage's GAT layer: h = x W, e_ij = leaky_relu(a . [h_i,
    h_j, adj_ij], alpha), attention softmax_j(e) times the adjacency (not
    masked), h' = attention @ h, ELU when `concat`. W [in, out] and a
    [2 out + 1, 1] are raw parameters (xavier-uniform, gain 1.414)."""

    def __init__(self, in_features: int, out_features: int,
                 alpha: float = 0.2, concat: bool = True, *, device=None):
        super().__init__()
        self.alpha = alpha
        self.concat = concat
        self.W = nn.Parameter(torch.empty(in_features, out_features,
                                          device=device))
        self.a = nn.Parameter(torch.empty(2 * out_features + 1, 1,
                                          device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.W, self.a):
                bound = 1.414 * math.sqrt(6.0 / sum(p.shape))
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = torch.matmul(x, self.W)
        f = h.shape[-1]
        a = self.a[:, 0]
        # a . [h_i, h_j, adj_ij] without the [B, N, N, 2F + 1] pair tensor
        e = ((h @ a[:f])[..., :, None] + (h @ a[f:2 * f])[..., None, :]
             + adj * a[2 * f])
        attention = torch.softmax(F.leaky_relu(e, self.alpha), dim=-1) * adj
        h_prime = torch.matmul(attention, h)
        return F.elu(h_prime) if self.concat else h_prime
