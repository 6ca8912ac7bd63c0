"""Dense GNN blocks over fixed 36-node graphs (counterpart of `LinearGeluLn`,
`GCNConv`, `GCN`, `GINConv`, `GIN`, `GATConv` and `GAT` in
`xggm_tpu/ggm/gnn.py`). Graphs are dense [B, N, N] adjacency matrices, so
message passing is a batched matmul. The GGM linears use torch's default
init (`ops.basic.TorchLinear`), the LayerNorms eps 1e-5, and dropout draws
from the generator it is given (None: deterministic)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import (
    Dense, DropoutRng, TorchLayerNorm, TorchLinear, gelu, maybe_dropout)


class LinearGeluLn(nn.Module):
    """Linear -> GeLU -> LayerNorm(eps 1e-5)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.fc = TorchLinear(n_in, n_out, dtype, device=device)
        self.ln = TorchLayerNorm(n_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(gelu(self.fc(x)))


class GCNConv(nn.Module):
    """Residual graph convolution: LN(x + W (adj @ x)), W without bias. (The
    JAX GCNConv's dropout is 0 wherever GCN builds it.)"""

    def __init__(self, features: int, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.ctx_layer = TorchLinear(features, features, dtype, bias=False,
                                     device=device)
        self.layer_norm = TorchLayerNorm(features, device=device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        msg = torch.matmul(adj.to(self.dtype), x)
        return self.layer_norm(x + self.ctx_layer(msg))


class GINConv(nn.Module):
    """Graph isomorphism conv: (Linear -> GeLU -> LN)(x + (1 + eps)
    (adj @ x)), with a learnable eps [1] that starts at 0."""

    def __init__(self, n_in: int, features: int, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = nn.Parameter(torch.empty(1, device=device))
        self.linear = LinearGeluLn(n_in, features, dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.eps.zero_()

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        msg = torch.matmul(adj.to(self.dtype), x)
        return self.linear(x + (1.0 + self.eps.to(self.dtype)) * msg)


class _JumpingKnowledge(nn.Module):
    """Stacked convs (`self.conv`) + jumping-knowledge readout: the sum over
    depths of (Linear -> GeLU -> LN) projections (`self.proj`), each dropped
    out independently at `self.p`."""

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        hidden = [x]
        for conv in self.conv:
            x = conv(x, adj)
            hidden.append(x)
        out = 0.0
        for proj, h in zip(self.proj, hidden):
            out = out + maybe_dropout(proj(h), self.p, rng)
        return out


class GCN(_JumpingKnowledge):
    """Stacked GCNConvs, each keeping the width `features`."""

    def __init__(self, features: int, hidden_dims: Sequence[int],
                 n_layers: int, dropout: float, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.p = dropout
        self.conv = nn.ModuleList(GCNConv(features, dtype, device=device)
                                  for _ in range(n_layers))
        self.proj = nn.ModuleList(
            LinearGeluLn(features, hidden_dims[min(i, len(hidden_dims) - 1)],
                         dtype, device=device)
            for i in range(n_layers + 1))


class GIN(_JumpingKnowledge):
    """Stacked GINConvs, conv i to the width hidden_dims[i]."""

    def __init__(self, features: int, hidden_dims: Sequence[int],
                 n_layers: int, dropout: float, dtype: torch.dtype, *,
                 device=None):
        super().__init__()
        self.p = dropout
        dims = [features] + [hidden_dims[i] for i in range(n_layers)]
        self.conv = nn.ModuleList(
            GINConv(dims[i], dims[i + 1], dtype, device=device)
            for i in range(n_layers))
        self.proj = nn.ModuleList(
            LinearGeluLn(dims[i], hidden_dims[min(i, len(hidden_dims) - 1)],
                         dtype, device=device)
            for i in range(n_layers + 1))


class GATConv(nn.Module):
    """Dense graph attention head: h = W x (no bias; xavier-normal, gain
    sqrt 2), score_ij = leaky_relu(a1 . h_i + a2 . h_j, alpha) with a =
    `attn` [2F, 1] (xavier-normal), -9e15 where adj == 0, a float32
    softmax over j, then elu(att @ h)."""

    def __init__(self, n_in: int, features: int, dtype: torch.dtype,
                 alpha: float = 0.2, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.features = features
        self.alpha = alpha
        # the JAX package's nn.Dense with variance_scaling(2, fan_avg,
        # normal): a normal of std sqrt(4 / (fan_in + fan_out))
        self.linear_layer = Dense(n_in, features, dtype,
                                  stddev=math.sqrt(4.0 / (n_in + features)),
                                  bias=False, device=device)
        self.attn = nn.Parameter(torch.empty(2 * features, 1, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = math.sqrt(2.0 / (2 * self.features + 1))
        with torch.no_grad():
            self.attn.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = self.linear_layer(x)
        a = self.attn.to(self.dtype)
        f = self.features
        scores = torch.matmul(h, a[:f]) + torch.matmul(h, a[f:]).transpose(
            -1, -2)
        scores = F.leaky_relu(scores, self.alpha)
        scores = scores.masked_fill(adj == 0, -9e15)
        att = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        return F.elu(torch.matmul(att, h))


class GAT(nn.Module):
    """Multi-head GAT over its dropped-out input: merge 'cat' concatenates
    the heads (width n_head * features), any other merge takes their
    mean."""

    def __init__(self, n_in: int, features: int, n_head: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32,
                 alpha: float = 0.2, merge: str = "cat", *, device=None):
        super().__init__()
        self.p = dropout
        self.merge = merge
        self.head = nn.ModuleList(
            GATConv(n_in, features, dtype, alpha, device=device)
            for _ in range(n_head))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = maybe_dropout(x, self.p, rng)
        heads = [head(x, adj) for head in self.head]
        if self.merge == "cat":
            return torch.cat(heads, dim=-1)
        return torch.stack(heads).mean(dim=0)
