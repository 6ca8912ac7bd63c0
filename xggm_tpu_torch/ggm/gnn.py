"""Dense GCN blocks over fixed 36-node graphs (counterpart of `LinearGeluLn`,
`GCNConv` and `GCN` in `xggm_tpu/ggm/gnn.py`). Graphs are dense [B, N, N]
adjacency matrices, so message passing is a batched matmul. The linears use
torch's default init (`ops.basic.TorchLinear`), the LayerNorms eps 1e-5, and
dropout draws from the generator it is given (None: deterministic)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from xggm_tpu_torch.ops.basic import (
    DropoutRng, TorchLayerNorm, TorchLinear, gelu, maybe_dropout)


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


class GCN(nn.Module):
    """Stacked GCNConvs + jumping-knowledge readout: the sum over depths of
    (Linear -> GeLU -> LN) projections, each dropped out independently."""

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
