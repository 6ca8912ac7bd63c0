"""Score-based graph generation lineage: the EDP-GNN score network and the
annealed Langevin sampler (counterpart of `xggm_tpu/ggm/score_network.py`).

Multi-channel dense message passing is one einsum over [B, C, N, N]
adjacency stacks, in float32; the edge MLP runs on [B, N, N, F] pair
features. The JAX package's documented deviation from the reference is
kept: LayerNorm (flax's, eps 1e-6) where the reference has BatchNorm.
Submodules carry the JAX package's names (`fc_i`, `norm_i`, `cond_i`,
`layer.k` for `layer_k`, `proj_i_a`, `proj_i_b`, ...). A random draw comes
from a `torch.Generator` unless the caller hands it in (`normal`,
`normals`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import (
    FLAX_LN_EPS, DropoutRng, LayerNorm, at_least_float32, lecun_dense,
    maybe_dropout)
from xggm_tpu_torch.ops.noise import (
    add_gaussian_noise, mask_adjs, node_feature_to_matrix)


class ConditionalScale(nn.Module):
    """Per-class gain and bias [num_classes, F] over an input whose leading
    dimension is num_classes groups of rows."""

    def __init__(self, num_features: int, num_classes: int, *, device=None):
        super().__init__()
        self.num_features = num_features
        self.num_classes = num_classes
        self.gain = nn.Parameter(torch.empty(num_classes, num_features,
                                             device=device))
        self.bias = nn.Parameter(torch.empty(num_classes, num_features,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gain.normal_(1.0, 0.02, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grouped = x.reshape(self.num_classes, -1, self.num_features)
        out = grouped * self.gain[:, None, :] + self.bias[:, None, :]
        return out.reshape(x.shape)


class CondMLP(nn.Module):
    """MLP of num_layers Dense layers (`linear` alone for one layer, else
    `fc_0` ... `fc_{n-1}`), each hidden one followed by LayerNorm
    (`use_norm`), the per-class scale (`num_classes` > 0) and
    `activation`."""

    def __init__(self, in_dim: int, num_layers: int, hidden_dim: int,
                 output_dim: int, num_classes: int = 0,
                 use_norm: bool = False,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.elu,
                 *, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.use_norm = use_norm
        self.num_classes = num_classes
        self.activation = activation
        if num_layers == 1:
            self.linear = lecun_dense(in_dim, output_dim, device=device)
            return
        for i in range(num_layers - 1):
            setattr(self, f"fc_{i}", lecun_dense(
                in_dim if i == 0 else hidden_dim, hidden_dim, device=device))
            if use_norm:
                setattr(self, f"norm_{i}", LayerNorm(hidden_dim, FLAX_LN_EPS,
                                                     device=device))
            if num_classes:
                setattr(self, f"cond_{i}", ConditionalScale(
                    hidden_dim, num_classes, device=device))
        setattr(self, f"fc_{num_layers - 1}",
                lecun_dense(hidden_dim, output_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_layers == 1:
            return self.linear(x)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"fc_{i}")(x)
            if self.use_norm:
                x = getattr(self, f"norm_{i}")(x)
            if self.num_classes:
                x = getattr(self, f"cond_{i}")(x)
            x = self.activation(x)
        return getattr(self, f"fc_{self.num_layers - 1}")(x)


class MultiChannelGIN(nn.Module):
    """GIN over [B, C, N, N] adjacency stacks: per layer k, h_norm =
    LN(h) (`norm_k`), z = concat_c(A_c @ h_norm) + eps[k] tile_C(h_norm),
    h = tanh(`layer.k`(z)); then a jumping-knowledge readout, the sum over
    depths of `proj_i_b`(leaky_relu(`proj_i_a`(h_i))), each dropped out.
    The einsum runs in float32 (or wider)."""

    def __init__(self, feature_nums: Sequence[int], out_dim: int = 1,
                 channel_num: int = 1, dropout: float = 0.5, *, device=None):
        super().__init__()
        self.p = dropout
        self.channel_num = channel_num
        layer_n = len(feature_nums) - 1
        self.eps = nn.Parameter(torch.empty(layer_n, device=device))
        self.layer = nn.ModuleList(
            lecun_dense(channel_num * feature_nums[k], feature_nums[k + 1],
                        device=device)
            for k in range(layer_n))
        for k in range(layer_n):
            setattr(self, f"norm_{k}", LayerNorm(feature_nums[k], FLAX_LN_EPS,
                                                 device=device))
        width = 2 * max(feature_nums)
        for i in range(layer_n + 1):
            setattr(self, f"proj_{i}_a", lecun_dense(feature_nums[i], width,
                                                     device=device))
            setattr(self, f"proj_{i}_b", lecun_dense(width, out_dim,
                                                     device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.eps.zero_()

    def forward(self, x: torch.Tensor, adjs: torch.Tensor,
                node_flags: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if adjs.dim() == 3:
            adjs = adjs[:, None]
        flags = node_flags[..., None]
        h = x * flags
        hidden = [h]
        for k, layer in enumerate(self.layer):
            h_norm = getattr(self, f"norm_{k}")(h)
            msg = torch.einsum("bcij,bjf->bcif", at_least_float32(adjs),
                               at_least_float32(h_norm))
            msg = msg.transpose(1, 2).reshape(h.shape[0], h.shape[1], -1)
            tiled = torch.cat([h_norm] * self.channel_num, dim=-1)
            h = torch.tanh(layer(msg + self.eps[k] * tiled))
            hidden.append(h * flags)
        ret = 0.0
        for i, hh in enumerate(hidden):
            y = F.leaky_relu(getattr(self, f"proj_{i}_a")(hh), 0.01)
            y = getattr(self, f"proj_{i}_b")(y)
            ret = ret + maybe_dropout(y, self.p, rng)
        return ret


class EdgeDensePredictionLayer(nn.Module):
    """`gnn` (MultiChannelGIN) over the c_in channels, then the pairwise edge
    MLP `translate` on [channels, x_i, x_j] -> c_out symmetric, masked
    channels. Returns (node features, new adjacency channels)."""

    def __init__(self, gnn_features: Sequence[int], c_in: int, c_out: int,
                 num_classes: int = 1, *, device=None):
        super().__init__()
        f_out = gnn_features[-1]
        self.gnn = MultiChannelGIN(gnn_features, out_dim=f_out,
                                   channel_num=c_in, device=device)
        self.translate = CondMLP(c_in + 2 * f_out, 2, 2 * max(c_in, c_out),
                                 c_out, num_classes, use_norm=True,
                                 device=device)

    def forward(self, x: torch.Tensor, adjs: torch.Tensor,
                node_flags: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_o = self.gnn(x, adjs, node_flags, rng)
        mlp_in = torch.cat([adjs.movedim(1, -1), node_feature_to_matrix(x_o)],
                           dim=-1)
        new_adjs = self.translate(mlp_in).movedim(-1, 1)
        new_adjs = new_adjs + new_adjs.transpose(-1, -2)
        return x_o, mask_adjs(new_adjs, node_flags)


class EdgeDenseScoreNetwork(nn.Module):
    """Adjacency score estimator: the channels [A, 1 - A], one edge layer
    (`edge_gnn`), all channels stacked, then the pairwise MLP
    `final_read_score` -> a per-edge score with a zero diagonal. Returns
    (score [B, N, N], node features)."""

    def __init__(self, feature_nums: Sequence[int], channel_out: int = 8,
                 num_classes: int = 1, *, device=None):
        super().__init__()
        self.edge_gnn = EdgeDensePredictionLayer(
            feature_nums, 2, channel_out, num_classes, device=device)
        c_total = 2 + channel_out
        self.final_read_score = CondMLP(c_total, 2, 2 * c_total, 1,
                                        num_classes, device=device)

    def forward(self, x: torch.Tensor, adjs: torch.Tensor,
                node_flags: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = adjs[:, None]
        stacked = mask_adjs(torch.cat([a, 1.0 - a], dim=1), node_flags)
        x_o, new_adjs = self.edge_gnn(x, stacked, node_flags, rng)
        all_adjs = torch.cat([stacked, new_adjs], dim=1)
        score = self.final_read_score(all_adjs.movedim(1, -1))[..., 0]
        eye = torch.eye(score.shape[-1], dtype=score.dtype,
                        device=score.device)
        return score * (1.0 - eye), x_o


def gen_init_sample(generator: Optional[torch.Generator], batch_size: int,
                    max_node_num: int,
                    normal: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A symmetric |N(0, 1)| initial adjacency [B, N, N] (zero diagonal;
    `normal` drawn from `generator` on its device when not given) and its
    node flags (row sum > 1e-5)."""
    if normal is None:
        normal = torch.randn(batch_size, max_node_num, max_node_num,
                             generator=generator, device=generator.device)
    upper = normal.abs().triu(1)
    adjs = upper + upper.transpose(-1, -2)
    return adjs, (adjs.sum(-1) > 1e-5).float()


class LangevinSampler:
    """Annealed Langevin dynamics over adjacency matrices: each step adds
    symmetric N(0, sigma^2) noise off the diagonal, masks the padded nodes,
    then ascends the estimated score: A <- A + grad_step_size * score(A).
    sigma = sqrt(2 grad_step_size) eps, in float32 as the JAX package
    computes it."""

    def __init__(self, eps: float = 0.3, grad_step_size: float = 1.0,
                 step_num: int = 100):
        self.eps = eps
        self.grad_step_size = grad_step_size
        self.sigma = float(torch.sqrt(torch.tensor(2.0 * grad_step_size))
                           * eps)
        self.step_num = step_num

    def sample(self, score_func, init_adjs: torch.Tensor,
               node_flags: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               step_num: Optional[int] = None, to_int: bool = True,
               normals: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run `step_num` steps (a Python loop; the JAX package scans) from
        `init_adjs`; step i's noise is `normals[i]` times sigma, or a
        standard normal drawn from `generator`. `score_func(adjs, flags)`
        returns (score, anything). Returns the adjacency, 0/1 with
        `to_int`, and its node flags."""
        steps = step_num if step_num is not None else self.step_num
        adjs = init_adjs
        for i in range(steps):
            raw = (torch.randn(adjs.shape, generator=generator,
                               device=adjs.device)
                   if normals is None else normals[i]) * self.sigma
            upper = raw.triu(1)
            adjs = mask_adjs(adjs + upper + upper.transpose(-1, -2),
                             node_flags)
            score, _ = score_func(adjs, node_flags)
            adjs = adjs + self.grad_step_size * score
        if to_int:
            adjs = torch.where(adjs < 0.5, 0.0, 1.0)
        return adjs, (adjs.sum(-1) > 1e-5).float()


def gen_multi_sigma_batches(generator: Optional[torch.Generator],
                            x: torch.Tensor, adjs: torch.Tensor,
                            sigma_list: Sequence[float],
                            normals: Optional[Sequence[torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Flagless multi-sigma noisy batches: for each sigma (the i-th noise
    `normals[i]`, or drawn from `generator`) the symmetric edge noise of
    `ops.noise.add_edge_noise`; returns (x, noisy adjs, score targets), each
    concatenated over the sigmas on the batch. The flagged, per-sigma-list
    form is `ops.noise.gen_list_of_data`."""
    xs: List[torch.Tensor] = []
    noisy: List[torch.Tensor] = []
    grads: List[torch.Tensor] = []
    for i, sigma in enumerate(sigma_list):
        a, g = add_gaussian_noise(generator, adjs, float(sigma),
                                  normal=None if normals is None
                                  else normals[i])
        xs.append(x)
        noisy.append(a)
        grads.append(g)
    return torch.cat(xs), torch.cat(noisy), torch.cat(grads)
