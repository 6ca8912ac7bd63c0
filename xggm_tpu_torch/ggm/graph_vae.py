"""Graph VAE, graph matching and edge-refinement GNN lineage (counterpart of
`xggm_tpu/ggm/graph_vae.py`).

`GraphVAE` and `MlpVaePlain` keep the reference's reparameterizations as
the JAX package does: GraphVAE samples z = eps exp(log_var) + mu (not
exp(log_var / 2)), MlpVaePlain z = eps exp(lsgms / 2) + mu. `mpm` (the
max-pooling matching power iteration) and `edge_similarity_matrix` run on
their inputs' device; `match_graphs` hands the assignment to scipy's
Hungarian solver on the host, as the JAX package does. Submodules carry
the JAX package's names (`encoder_mu`, `Dense_0`, `LayerNorm_0`, `gnn.i`
for `gnn_i`, `edge_i`, `conv_i`, `conv_ln_i`, ...).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.config import NUM_OBJECTS, NUM_TRIU_EDGES
from xggm_tpu_torch.ggm.gnn import GIN
from xggm_tpu_torch.ops.basic import (
    FLAX_LN_EPS, Dense, DropoutRng, LayerNorm, at_least_float32, lecun_dense,
    maybe_dropout)
from xggm_tpu_torch.ops.noise import node_feature_to_matrix


def _relu_xavier_dense(n_in: int, n_out: int, device) -> Dense:
    """Dense with the variance of the JAX package's relu-gain xavier init
    (variance_scaling(2, fan_avg)): 4 / (fan_in + fan_out)."""
    return Dense(n_in, n_out, stddev=math.sqrt(4.0 / (n_in + n_out)),
                 device=device)


class MLPDecoder(nn.Module):
    """Dropout, `Dense_0`, `LayerNorm_0` (eps 1e-6), ReLU, `Dense_1` to
    hidden_dim // 2."""

    def __init__(self, in_dim: int, hidden_dim: int = 16,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        self.p = dropout
        self.Dense_0 = _relu_xavier_dense(in_dim, hidden_dim, device)
        self.LayerNorm_0 = LayerNorm(hidden_dim, FLAX_LN_EPS, device=device)
        self.Dense_1 = _relu_xavier_dense(hidden_dim, hidden_dim // 2,
                                          device)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = self.Dense_0(maybe_dropout(x, self.p, rng))
        return self.Dense_1(F.relu(self.LayerNorm_0(x)))


def recover_adj(values: torch.Tensor) -> torch.Tensor:
    """[B, 630] strict-upper-triangle values -> symmetric [B, 36, 36]."""
    i, j = torch.triu_indices(NUM_OBJECTS, NUM_OBJECTS, 1,
                              device=values.device)
    adj = values.new_zeros(values.shape[0], NUM_OBJECTS, NUM_OBJECTS)
    adj[:, i, j] = values
    return adj + adj.transpose(-1, -2)


class GraphVAE(nn.Module):
    """GIN-encoder VAE over the 36-node adjacency: two 2-conv GINs
    (`encoder_mu`, `encoder_var`), a normalized max-pool over the nodes, z,
    and the MLP decoder of the 630 upper-triangle logits. Returns
    (sigmoid adjacency [B, 36, 36], KL / 1296, BCE against the true upper
    triangle)."""

    def __init__(self, hidden_dim: int = 300, input_dim: int = 768, *,
                 device=None):
        super().__init__()
        h = hidden_dim
        self.encoder_mu = GIN(input_dim, (h, h), 2, 0.5, torch.float32,
                              device=device)
        self.encoder_var = GIN(input_dim, (h, h), 2, 0.5, torch.float32,
                               device=device)
        self.decoder = MLPDecoder(h, 2 * NUM_TRIU_EDGES, device=device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Deterministic (z = mu, no dropout) without `rng` and `eps`; with
        either, z = eps exp(log_var) + mu, eps a standard normal drawn from
        rng's device generator when not given. Dropout runs under `rng`."""
        def norm_maxpool(v):
            v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            return v.max(dim=1).values

        mu = norm_maxpool(self.encoder_mu(x, adj, rng))
        log_var = norm_maxpool(self.encoder_var(x, adj, rng))
        if rng is None and eps is None:
            z = mu
        else:
            if eps is None:
                eps = torch.randn(log_var.shape,
                                  generator=rng.device_generator,
                                  dtype=log_var.dtype, device=log_var.device)
            z = eps * torch.exp(log_var) + mu
        logits = self.decoder(z, rng)
        rec_adj = recover_adj(torch.sigmoid(logits))
        kl = -0.5 * torch.sum(1.0 + log_var - mu ** 2 - torch.exp(log_var))
        kl = kl / (NUM_OBJECTS * NUM_OBJECTS)
        i, j = torch.triu_indices(NUM_OBJECTS, NUM_OBJECTS, 1,
                                  device=adj.device)
        t, lg = at_least_float32(adj[:, i, j]), at_least_float32(logits)
        rec = (lg.clamp_min(0.0) - lg * t
               + torch.log1p(torch.exp(-lg.abs()))).mean()
        return rec_adj, kl, rec


class MlpVaePlain(nn.Module):
    """Plain MLP VAE: `encode_mu` and `encode_lsgms` heads, z, then
    `decode_1`, ReLU, `decode_2`. Returns (y, z_mu, z_lsgms)."""

    def __init__(self, in_dim: int, embedding_size: int, y_size: int, *,
                 device=None):
        super().__init__()
        e = embedding_size
        self.encode_mu = _relu_xavier_dense(in_dim, e, device)
        self.encode_lsgms = _relu_xavier_dense(in_dim, e, device)
        self.decode_1 = _relu_xavier_dense(e, e, device)
        self.decode_2 = _relu_xavier_dense(e, y_size, device)

    def forward(self, h: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z = mu without `generator` and `eps`; else z = eps exp(lsgms / 2)
        + mu, eps drawn from `generator` when not given."""
        z_mu, z_lsgms = self.encode_mu(h), self.encode_lsgms(h)
        if generator is None and eps is None:
            z = z_mu
        else:
            if eps is None:
                eps = torch.randn(z_lsgms.shape, generator=generator,
                                  dtype=z_lsgms.dtype, device=z_lsgms.device)
            z = eps * torch.exp(0.5 * z_lsgms) + z_mu
        y = self.decode_2(F.relu(self.decode_1(z)))
        return y, z_mu, z_lsgms


def deg_feature_similarity(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    return 1.0 / ((f1 - f2).abs() + 1.0)


def edge_similarity_matrix(adj: torch.Tensor, adj_recon: torch.Tensor,
                           feat: torch.Tensor,
                           feat_recon: torch.Tensor) -> torch.Tensor:
    """The [N, N, N, N] edge affinity S[i, j, a, b] = adj[i, j] adj[i, i]
    adj[j, j] rec[a, b] rec[a, a] rec[b, b] for i != j and a != b, 0 where
    exactly one of them is equal, and adj[i, i] rec[a, a] sim(deg_i,
    deg_a) on the (i, i, a, a) entries."""
    n = adj.shape[0]
    diag_a, diag_r = adj.diagonal(), adj_recon.diagonal()
    off = ((adj * diag_a[:, None] * diag_a[None, :])[:, :, None, None]
           * (adj_recon * diag_r[:, None] * diag_r[None, :])[None, None])
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    off = off.masked_fill(eye[None, None], 0.0).masked_fill(
        eye[:, :, None, None], 0.0)
    ii = torch.arange(n, device=adj.device)
    off[ii[:, None], ii[:, None], ii[None, :], ii[None, :]] = (
        diag_a[:, None] * diag_r[None, :]
        * deg_feature_similarity(feat[:, None], feat_recon[None, :]))
    return off


def mpm(x_init: torch.Tensor, S: torch.Tensor,
        max_iters: int = 50) -> torch.Tensor:
    """Max-pooling matching power iteration: x[i, a] <- x[i, a] S[i, i, a,
    a] + sum_{j != i} max_b x[j, b] S[i, j, a, b], normalized each round."""
    n = x_init.shape[0]
    ii = torch.arange(n, device=S.device)
    diag_s = S[ii[:, None], ii[:, None], ii[None, :], ii[None, :]]
    not_self = 1.0 - torch.eye(n, dtype=S.dtype, device=S.device)
    x = x_init
    for _ in range(max_iters):
        pooled = (x[None, :, None, :] * S).amax(-1)          # [i, j, a]
        x = x * diag_s + torch.einsum("ija,ij->ia", pooled, not_self)
        x = x / x.norm().clamp_min(1e-12)
    return x


def match_graphs(adj, adj_recon, max_iters: int = 50
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-feature MPM affinity on adj's device (a tensor or a numpy
    array), then the Hungarian assignment on the host (scipy): (row_ind,
    col_ind)."""
    import scipy.optimize

    adj = torch.as_tensor(adj)
    adj_recon = torch.as_tensor(adj_recon, device=adj.device)
    S = edge_similarity_matrix(adj, adj_recon, adj.sum(1), adj_recon.sum(1))
    n = adj.shape[0]
    init = torch.full((n, n), 1.0 / n, dtype=S.dtype, device=S.device)
    assignment = mpm(init, S, max_iters).cpu().numpy()
    return scipy.optimize.linear_sum_assignment(-assignment)


def permute_adj(adj: np.ndarray, curr_ind: np.ndarray,
                target_ind: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    ind = np.zeros(n, dtype=np.int64)
    ind[target_ind] = curr_ind
    return adj[ind, :][:, ind]


class EdgeConvGNN(nn.Module):
    """GIN rounds (`gnn.i`), each followed by tanh'd 2-channel pair features
    (`edge_i`), a channel mix of [A, 1 - A, edge] (`conv.i`) and a ReLU'd
    LayerNorm over each adjacency row of num_nodes (`conv_ln_i`, eps 1e-6);
    the JAX package's stand-in for the reference's 1x1 Conv2d and
    BatchNorm. Returns the sums over depths of the node features and of
    the adjacencies."""

    def __init__(self, in_dim: int, hidden_dim: int, num_nodes: int,
                 n_layers: int = 2, dropout: float = 0.5,
                 node_norm: bool = False, *, device=None):
        super().__init__()
        self.node_norm = node_norm
        self.gnn = nn.ModuleList(
            GIN(in_dim if i == 0 else hidden_dim, (hidden_dim, hidden_dim),
                2, dropout, torch.float32, device=device)
            for i in range(n_layers))
        self.conv = nn.ModuleList(lecun_dense(4, 1, device=device)
                                  for _ in range(n_layers))
        for i in range(n_layers):
            setattr(self, f"edge_{i}", lecun_dense(2 * hidden_dim, 2,
                                                   device=device))
            setattr(self, f"conv_ln_{i}", LayerNorm(num_nodes, FLAX_LN_EPS,
                                                    device=device))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden_x, hidden_adj = [x], [adj]
        for i, gnn in enumerate(self.gnn):
            x = gnn(x, adj, rng)
            hidden_x.append(x)
            edge = torch.tanh(getattr(self, f"edge_{i}")(
                node_feature_to_matrix(x)))
            if self.node_norm:
                edge = edge / edge.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            stacked = torch.cat([adj[..., None], 1.0 - adj[..., None], edge],
                                dim=-1)
            mixed = self.conv[i](stacked)[..., 0]
            adj = F.relu(getattr(self, f"conv_ln_{i}")(mixed))
            hidden_adj.append(adj)
        return sum(hidden_x), sum(hidden_adj)


class EdgeGNN(nn.Module):
    """GIN rounds (`gnn.i`), each re-estimating the adjacency from the pair
    features (`edge_i`); returns the sums over depths of the node features
    and of the adjacencies."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, *, device=None):
        super().__init__()
        self.gnn = nn.ModuleList(
            GIN(in_dim if i == 0 else hidden_dim, (hidden_dim, hidden_dim),
                2, dropout, torch.float32, device=device)
            for i in range(n_layers))
        for i in range(n_layers):
            setattr(self, f"edge_{i}", lecun_dense(2 * hidden_dim, 1,
                                                   device=device))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden_x, hidden_adj = [x], [adj]
        for i, gnn in enumerate(self.gnn):
            x = gnn(x, adj, rng)
            hidden_x.append(x)
            adj = getattr(self, f"edge_{i}")(node_feature_to_matrix(x))[..., 0]
            hidden_adj.append(adj)
        return sum(hidden_x), sum(hidden_adj)
