"""Graph generators (counterpart of `recompute_adjacency`, `zero_diagonal`,
`GCNGenerator` and `make_generator` in `xggm_tpu/ggm/generators.py`): n_layers
rounds of (GNN over (x, adj), then adj = zero_diag(sigmoid(x x^T / colmax))).
The port has the GCN generator; GIN and GAT are queued (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from xggm_tpu_torch.ggm.gnn import GCN
from xggm_tpu_torch.ops.basic import DropoutRng
from xggm_tpu_torch.ops.noise import remove_self_loops

# adj.triu(1) + adj.tril(-1) for batched square matrices
zero_diagonal = remove_self_loops


def recompute_adjacency(x: torch.Tensor) -> torch.Tensor:
    """zero_diag(sigmoid(gram / colmax)) of node features x [B, N, D], in
    x's dtype: gram = x x^T, and entry (i, j) is divided by the max of
    column i (torch's `adj / adj.max(dim=1)[0].unsqueeze(-1)`)."""
    gram = torch.matmul(x, x.transpose(-1, -2))
    gram = gram / gram.amax(dim=1)[..., None]
    return zero_diagonal(torch.sigmoid(gram))


class GCNGenerator(nn.Module):
    """n_layers x (2-conv GCN -> adjacency recompute in float32)."""

    def __init__(self, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32, *,
                 device=None):
        super().__init__()
        self.gnn = nn.ModuleList(
            GCN(hidden_dim, (hidden_dim, hidden_dim), 2, dropout, dtype,
                device=device)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                rng: Optional[DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for gnn in self.gnn:
            x = gnn(x, adj, rng)
            adj = recompute_adjacency(x.float()).to(adj.dtype)
        return x, adj


def make_generator(gnn: str, hidden_dim: int, n_layers: int,
                   dropout: float = 0.5, dtype: torch.dtype = torch.float32,
                   *, device=None) -> nn.Module:
    """The generator named by `--gnn`."""
    if gnn == "GCN":
        return GCNGenerator(hidden_dim, n_layers, dropout, dtype,
                            device=device)
    if gnn in ("GIN", "GAT"):
        raise NotImplementedError(
            f"the {gnn} generator is not ported yet (ROADMAP.md); the "
            "shipped GQA-OOD and VQA-CP v2 recipes use GCN")
    raise ValueError(f"unknown gnn kind: {gnn!r} (expected GCN|GIN|GAT)")
