"""Sparse-to-dense graph batching (counterpart of `xggm_tpu/ops/segment.py`):
`segment_sum` over `index_add_`, in place of `torch_scatter.scatter_add`,
and a PyG-style `to_dense_batch` built on it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of `data` by segment id into [num_segments, ...]; every
    id must lie in [0, num_segments)."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids, data)


def to_dense_batch(x: torch.Tensor, batch: torch.Tensor, num_graphs: int,
                   max_num_nodes: Optional[int] = None,
                   fill_value: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked node features x [total_nodes, F] with their graph ids `batch`
    (sorted, as in PyG) -> (dense [num_graphs, N, F] filled with
    `fill_value` where a graph has fewer than N nodes, mask [num_graphs, N]
    True on real nodes). N is `max_num_nodes`, or the largest graph's node
    count, which is read back to the host; a graph's nodes past N are
    dropped."""
    num_nodes = segment_sum(torch.ones_like(batch), batch, num_graphs)
    if max_num_nodes is None:
        max_num_nodes = int(num_nodes.max())
    cum = torch.cumsum(num_nodes, 0) - num_nodes
    idx_in_graph = torch.arange(batch.shape[0], device=x.device) - cum[batch]
    keep = idx_in_graph < max_num_nodes
    flat_idx = (batch * max_num_nodes + idx_in_graph)[keep]
    dense = torch.full((num_graphs * max_num_nodes, x.shape[-1]), fill_value,
                       dtype=x.dtype, device=x.device)
    dense[flat_idx] = x[keep]
    mask = (torch.arange(max_num_nodes, device=x.device)[None, :]
            < num_nodes[:, None])
    return dense.view(num_graphs, max_num_nodes, x.shape[-1]), mask
