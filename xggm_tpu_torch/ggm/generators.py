"""Graph generators and discriminators (counterpart of
`xggm_tpu/ggm/generators.py`): each generator runs n_layers rounds of (GNN
over (x, adj), then adj = zero_diag(sigmoid(x x^T / colmax))) and returns
the final (x, adj); `EdgeGenerator` and `NodeGenerator` return one of the
two."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ggm.gnn import GAT, GCN, GIN, LinearGeluLn
from xggm_tpu_torch.ops.basic import DropoutRng, TorchLinear
from xggm_tpu_torch.ops.noise import remove_self_loops

# adj.triu(1) + adj.tril(-1) for batched square matrices
zero_diagonal = remove_self_loops


def _normalized_gram(x: torch.Tensor) -> torch.Tensor:
    """x x^T in float32, entry (i, j) divided by the max of column i
    (torch's `adj / adj.max(dim=1)[0].unsqueeze(-1)`)."""
    x = x.float()
    gram = torch.matmul(x, x.transpose(-1, -2))
    return gram / gram.amax(dim=1)[..., None]


def recompute_adjacency(x: torch.Tensor) -> torch.Tensor:
    """zero_diag(sigmoid(gram / colmax)) of node features x [B, N, D], in
    float32."""
    return zero_diagonal(torch.sigmoid(_normalized_gram(x)))


def _gin_rounds(hidden_dim: int, n_layers: int, dropout: float,
                dtype: torch.dtype, device) -> nn.ModuleList:
    return nn.ModuleList(
        GIN(hidden_dim, (hidden_dim, hidden_dim), 1, dropout, dtype,
            device=device)
        for _ in range(n_layers))


class _Rounds(nn.Module):
    """Each round of `self.gnn`, then the adjacency recompute in float32."""

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
            adj = recompute_adjacency(x).to(adj.dtype)
        return x, adj


class GCNGenerator(_Rounds):
    """n_layers x (2-conv GCN -> adjacency recompute)."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.gnn = nn.ModuleList(
            GCN(hidden_dim, (hidden_dim, hidden_dim), 2, dropout, dtype,
                device=device)
            for _ in range(n_layers))


class GINGenerator(_Rounds):
    """n_layers x (1-conv GIN -> adjacency recompute)."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.gnn = _gin_rounds(hidden_dim, n_layers, dropout, dtype, device)


class GATGenerator(nn.Module):
    """n_layers x (n_head-head GAT -> adjacency recompute in float32). The
    heads are concatenated; unless `faithful_cat`, the TorchLinear
    `merge.i` projects them back to hidden_dim after each round, so that
    the generator runs at any depth (`faithful_cat` keeps the reference's
    widening shapes, which hold only for n_layers == 1)."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, n_head: int = 2,
                 faithful_cat: bool = False,
                 dtype: torch.dtype = torch.float32, *, device=None):
        super().__init__()
        wide = n_head * hidden_dim
        n_in = [hidden_dim] + [wide if faithful_cat else hidden_dim] * (
            n_layers - 1)
        self.gnn = nn.ModuleList(
            GAT(n_in[i], hidden_dim, n_head, dropout, dtype, device=device)
            for i in range(n_layers))
        self.merge = None if faithful_cat else nn.ModuleList(
            TorchLinear(wide, hidden_dim, dtype, device=device)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, gnn in enumerate(self.gnn):
            x = gnn(x, adj, rng)
            if self.merge is not None:
                x = self.merge[i](x)
            adj = recompute_adjacency(x).to(adj.dtype)
        return x, adj


class EdgeGenerator(nn.Module):
    """Adjacency only: GIN rounds, each followed by zero_diag(gram /
    colmax), with no sigmoid."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.gnn = _gin_rounds(hidden_dim, n_layers, dropout, dtype, device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
            adj = zero_diagonal(_normalized_gram(x)).to(adj.dtype)
        return adj


class NodeGenerator(nn.Module):
    """Node features only: GIN rounds over a fixed adjacency."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.gnn = _gin_rounds(hidden_dim, n_layers, dropout, dtype, device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
        return x


class Discriminator(nn.Module):
    """Linear -> GeLU -> LN -> Linear(1) on the input flattened to
    `n_in` features."""

    def __init__(self, n_in: int, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.fc1 = LinearGeluLn(n_in, 512, dtype, device=device)
        self.fc2 = TorchLinear(512, 1, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.fc1(x.reshape(x.shape[0], -1)))


class DiscriminatorV2(nn.Module):
    """Linear(512) -> LeakyReLU(0.2) -> Linear(256) -> LeakyReLU(0.2) ->
    Linear(1) on the input flattened to `n_in` features."""

    def __init__(self, n_in: int, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.fc1 = TorchLinear(n_in, 512, dtype, device=device)
        self.fc2 = TorchLinear(512, 256, dtype, device=device)
        self.fc3 = TorchLinear(256, 1, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(x.reshape(x.shape[0], -1)), 0.2)
        return self.fc3(F.leaky_relu(self.fc2(h), 0.2))


def make_generator(gnn: str, hidden_dim: int, n_layers: int,
                   dropout: float = 0.5, dtype: torch.dtype = torch.float32,
                   gat_heads: int = 2, *, device=None) -> nn.Module:
    """The generator named by `--gnn`."""
    if gnn == "GCN":
        return GCNGenerator(hidden_dim, n_layers, dropout, dtype,
                            device=device)
    if gnn == "GIN":
        return GINGenerator(hidden_dim, n_layers, dropout, dtype,
                            device=device)
    if gnn == "GAT":
        return GATGenerator(hidden_dim, n_layers, dropout, n_head=gat_heads,
                            dtype=dtype, device=device)
    raise ValueError(f"unknown gnn kind: {gnn!r} (expected GCN|GIN|GAT)")
