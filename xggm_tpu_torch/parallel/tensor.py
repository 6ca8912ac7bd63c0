"""Tensor parallelism of the wide projections over the model group.

The JAX package has no module here: it shards the wide Dense kernels
(`parallel/mesh.py::param_shardings`) and XLA's partitioner inserts the
collectives. In the port they are explicit, two autograd functions over the
model group:
  * `_Enter`: the identity forward; the backward all-reduces (sums) the
    input's gradient, each rank's partial product with its weight slice;
  * `_Gather`: all-gathers the ranks' output slices along the last dim; the
    backward keeps the rank's slice of the output's gradient.
A split Dense (`ColumnParallelDense`) computes
`gather(linear(enter(x), W_local, b_local))`, so everything downstream sees
the whole output, as JAX's replicated consumers do, and every model rank
computes the replicated parts from the same inputs. The split is JAX's
contiguous split of the output dim, so a fused `[q|k|v]` projection is cut
across its q, k and v blocks and every rank runs every head.

`shard_model_` swaps each split Dense for a `ColumnParallelDense` holding
its rank's slice, under the same parameter names (the stacked encoder's
template Dense included: its [L, out, in] weight keeps [L, out / mp, in]).
`local_slice` narrows a whole tensor to a rank's slice of the parameter of
that name; `gather_split` is the inverse over the model group, for the
checkpoint's single-rank file.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from xggm_tpu_torch.ops.basic import Dense
from xggm_tpu_torch.parallel.mesh import Mesh


class _Enter(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group
    (in float32, rounded once to the gradient's dtype)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _Gather(torch.autograd.Function):
    """The model ranks' slices concatenated along the last dim; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.width = rank, y.shape[-1]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(),
                None, None, None)


class ColumnParallelDense(Dense):
    """A Dense whose output dim is split over the model group: this rank's
    contiguous slice of the weight and bias (`tp_slices`: {leaf: (dim,
    start, length)} of the whole tensor), the whole output from the
    forward."""

    def __init__(self, dense: Dense, mesh: Mesh, weight_dim: int):
        nn.Module.__init__(self)
        self.dtype, self.stddev = dense.dtype, dense.stddev
        self.group, self.tp_rank, self.tp_size = (
            mesh.model_group, mesh.model_rank, mesh.model_size)
        n = dense.weight.shape[weight_dim] // self.tp_size
        start = self.tp_rank * n
        self.tp_slices = {"weight": (weight_dim, start, n)}
        self.weight = nn.Parameter(
            dense.weight.detach().narrow(weight_dim, start, n).clone())
        self.bias = None
        if dense.bias is not None:
            self.tp_slices["bias"] = (weight_dim, start, n)
            self.bias = nn.Parameter(
                dense.bias.detach().narrow(weight_dim, start, n).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.linear(_Enter.apply(x, self.group).to(dt), self.weight.to(dt),
                     b)
        return _Gather.apply(y, self.group, self.tp_rank, self.tp_size)


def shard_model_(model: nn.Module, mesh: Mesh,
                 shardings: Mapping[str, int]) -> Dict[str, int]:
    """Swap every Dense whose weight `shardings` splits for a
    `ColumnParallelDense` of this rank's slice, in place, under the same
    names. Returns {parameter name: split dim} of the swapped parameters
    (`tp_split`)."""
    for name, dim in shardings.items():
        mod_path, leaf = name.rsplit(".", 1)
        if leaf != "weight":
            continue
        dense = model.get_submodule(mod_path)
        if not isinstance(dense, Dense) or isinstance(dense,
                                                      ColumnParallelDense):
            raise ValueError(f"{name}: not a whole Dense to split")
        parent, _, child = mod_path.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child,
                ColumnParallelDense(dense, mesh, dim))
    return tp_split(model)


def tp_split(model: nn.Module) -> Dict[str, int]:
    """{parameter name: the dim split over the model group} of `model`'s
    tensor-parallel Dense layers (empty for a whole model)."""
    out = {}
    for path, mod in model.named_modules():
        for leaf, (dim, _, _) in getattr(mod, "tp_slices", {}).items():
            out[f"{path}.{leaf}" if path else leaf] = dim
    return out


def local_slice(model: nn.Module, name: str,
                whole: torch.Tensor) -> torch.Tensor:
    """This rank's slice of `whole`, the whole tensor of `model`'s
    parameter `name` (itself for a parameter that is not split)."""
    mod_path, _, leaf = name.rpartition(".")
    try:
        mod = model.get_submodule(mod_path)
    except AttributeError:
        return whole
    s = getattr(mod, "tp_slices", {}).get(leaf)
    return whole if s is None else whole.narrow(*s)


def local_state_dict(model: nn.Module, whole: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A whole (single-rank) state dict narrowed to this rank's slices."""
    return {n: local_slice(model, n, t) for n, t in whole.items()}


def gather_split(tensors: Mapping[str, torch.Tensor],
                 split: Mapping[str, int], mesh: Optional[Mesh]
                 ) -> Dict[str, torch.Tensor]:
    """`tensors` with every one that `split` names made whole: the model
    ranks' slices concatenated along its dim, in one all-gather. Every rank
    of the model group calls it."""
    names = [n for n in tensors if n in split]
    if mesh is None or mesh.model_size == 1 or not names:
        return dict(tensors)
    mine = torch.cat([tensors[n].detach().reshape(-1) for n in names])
    parts = [torch.empty_like(mine) for _ in range(mesh.model_size)]
    dist.all_gather(parts, mine, group=mesh.model_group)
    sizes = [tensors[n].numel() for n in names]
    pieces = [p.split(sizes) for p in parts]
    out = dict(tensors)
    for i, n in enumerate(names):
        out[n] = torch.cat([pc[i].view(tensors[n].shape) for pc in pieces],
                           dim=split[n])
    return out


def model_all_reduce(x: torch.Tensor, mesh: Optional[Mesh],
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced over the model group, in place (`x` as it is for a
    model group of one)."""
    if mesh is not None and mesh.model_size > 1:
        dist.all_reduce(x, op=op, group=mesh.model_group)
    return x
