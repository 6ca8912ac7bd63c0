"""The (data, model, pipe) grid of ranks, the tensor-parallel layout of
the parameters and the ZeRO-1 layout of the BertAdam state (counterpart of
`xggm_tpu/parallel/mesh.py`).

The JAX package shards a batch over a ('data', 'model'[, 'pipe']) device
mesh and lets XLA insert the collectives. Here a rank is one process, and
`make_mesh` lays the world's ranks out as JAX's `reshape(n // (mp * pp),
mp, pp)` does, the pipe axis innermost: global rank r is data
r // (mp * pp), model (r // pp) % mp and pipe r % pp. A `Mesh` holds the
three process groups through this rank (`rank` and `size` are the DATA
group's, so the feeder and ZeRO-1 read them as before). Each rank feeds the
`process_slice` of its data index; the ranks of one data slice feed the
same rows. The train steps sum the gradients over the pipe group and
average them over the data group before the clip
(`training/steps.py::apply_grads`). Every collective below is one that both
NCCL and gloo implement for CPU and CUDA tensors (all-reduce, broadcast and
the list form of all-gather), so the CPU tests run the path the card runs.

Tensor parallelism (`param_shardings`, `parallel/tensor.py`): a Dense whose
output width is at least `min_model_dim` and divides by the model group's
size keeps its rank's contiguous slice of the output dim, as JAX's rule
shards it.

ZeRO-1 (`maybe_zero_shard_state`): each BertAdam m and v is split along its
first dimension that the data group's size divides and that tensor
parallelism did not split (`_with_data_axis`), each rank keeping its slice;
a leaf with no such dimension stays whole on every rank. The port keeps no
bf16 shadow, so the fp32 masters, which the forward reads, stay whole, as
the JAX package keeps the masters its forward reads. After the all-reduce
every rank holds the whole averaged gradient, so each computes the same
global norm and activation flags as data parallelism does, updates its
slice of every sharded parameter, and the slices are all-gathered
(`gather_params_`): the update is the data-parallel one, bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple, TypeVar, Union

import numpy as np
import torch
import torch.distributed as dist

from xggm_tpu_torch.parallel.distributed import world
from xggm_tpu_torch.utils.device import resolve_device

T = TypeVar("T")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model, pipe) grid: its index and
    size in each group, its global rank and the world's size, the device it
    computes on, the backend (None outside a process group) and the three
    process groups (None: the default group, or no group)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    model_rank: int = 0
    model_size: int = 1
    pipe_rank: int = 0
    pipe_size: int = 1
    global_rank: int = 0
    world_size: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)
    pipe_group: Any = field(default=None, compare=False, repr=False)

    @property
    def primary(self) -> bool:
        """Whether this is global rank 0, which writes the run's files."""
        return self.global_rank == 0

    @property
    def last_stage_rank(self) -> int:
        """The global rank of the last pipeline stage of this rank's
        pipe group."""
        return self.global_rank - self.pipe_rank + self.pipe_size - 1


def grid_ranks(world_size: int, model_parallel: int,
               pipeline_parallel: int) -> Dict[str, List[List[int]]]:
    """The global ranks of every data, model and pipe group of the grid,
    in the order each kind of group is created."""
    mp, pp = model_parallel, pipeline_parallel
    n_data = world_size // (mp * pp)

    def rank(d, m, p):
        return (d * mp + m) * pp + p

    return {
        "data": [[rank(d, m, p) for d in range(n_data)]
                 for m in range(mp) for p in range(pp)],
        "model": [[rank(d, m, p) for m in range(mp)]
                  for d in range(n_data) for p in range(pp)],
        "pipe": [[rank(d, m, p) for p in range(pp)]
                 for d in range(n_data) for m in range(mp)]}


def make_mesh(model_parallel: int = 1,
              device: Union[str, torch.device] = "cuda",
              pipeline_parallel: int = 1) -> Mesh:
    """The (data, model, pipe) grid of every rank of the process group this
    process has joined (`parallel/distributed.py`), or a grid of this
    process alone when it has joined none; its rank computes on `device`.
    Every rank creates the groups, in the same order. Raises ValueError
    when the world does not divide by model_parallel x pipeline_parallel."""
    mp, pp = int(model_parallel), max(1, int(pipeline_parallel))
    rank, size = world()
    if mp < 1 or size % (mp * pp):
        raise ValueError(f"{size} rank(s) not divisible by model_parallel="
                         f"{mp} x pipeline_parallel={pp}")
    dev = resolve_device(device)
    backend = dist.get_backend() if dist.is_initialized() else None
    if mp * pp == 1:
        return Mesh(rank=rank, size=size, device=dev, backend=backend,
                    global_rank=rank, world_size=size)
    groups, places = {}, {}
    for kind, lists in grid_ranks(size, mp, pp).items():
        for ranks in lists:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[kind], places[kind] = group, ranks.index(rank)
    return Mesh(rank=places["data"], size=size // (mp * pp), device=dev,
                backend=backend, model_rank=places["model"], model_size=mp,
                pipe_rank=places["pipe"], pipe_size=pp, global_rank=rank,
                world_size=size, data_group=groups["data"],
                model_group=groups["model"], pipe_group=groups["pipe"])


def pad_batch_to(batch: Dict[str, np.ndarray], size: int
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad every array's leading dim to `size` with zeros at the end;
    returns (padded, valid_mask)."""
    n = next(iter(batch.values())).shape[0]
    if n > size:
        raise ValueError(f"batch of {n} exceeds the padded size {size}")
    if n == size:
        return batch, np.ones((n,), np.bool_)
    mask = np.zeros((size,), np.bool_)
    mask[:n] = True
    padded = {k: np.pad(x, [(0, size - n)] + [(0, 0)] * (x.ndim - 1))
              for k, x in batch.items()}
    return padded, mask


# ---------------------------------------------------------------- collectives

def _split_into(flat: torch.Tensor, outs: Sequence[torch.Tensor]) -> None:
    """Copy consecutive chunks of `flat` into `outs` (any strides)."""
    chunks = flat.split([o.numel() for o in outs])
    torch._foreach_copy_(list(outs), [c.view(o.shape)
                                      for c, o in zip(chunks, outs)])


def all_reduce_mean_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Average `tensors` over the data group in place, in one all-reduce of
    their concatenation. Every rank passes the same shapes in the same
    order."""
    if mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.size)
    _split_into(flat, tensors)


def mean_scalars(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                 ) -> Dict[str, torch.Tensor]:
    """The 0-d entries of `metrics` averaged over the data group (a step's
    losses over the global batch), the others as they are."""
    if mesh is None or mesh.size == 1:
        return metrics
    keys = [k for k, v in metrics.items() if v.dim() == 0]
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(vals, group=mesh.data_group)
    vals.div_(mesh.size)
    return {**metrics, **dict(zip(keys, vals.unbind()))}


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of `x` over the data group (a copy; `x` itself with no
    group)."""
    if mesh is None or mesh.size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether `flag` is set on any rank of the world (a one-int MAX
    all-reduce); every rank gets the same answer at the same call."""
    if mesh is None or mesh.world_size == 1:
        return flag
    x = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


def from_rank0(read: Callable[[], T], mesh: Optional[Mesh]) -> T:
    """`read()` evaluated on global rank 0 alone and its value (picklable;
    tensors come back on the CPU) given to every rank in one broadcast, so
    that every rank acts on rank 0's answer (a checkpoint only rank 0's
    disk holds). An error on rank 0 is raised on every rank."""
    if mesh is None or mesh.world_size == 1:
        return read()
    box: List[object] = [None]
    error = None
    if mesh.primary:
        try:
            box[0] = (True, read())
        except Exception as e:  # noqa: BLE001 - raised below, on every rank
            error, box[0] = e, (False, f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(
        box, src=0, device=mesh.device if mesh.backend == "nccl" else None)
    ok, value = box[0]
    if error is not None:
        raise error
    if not ok:
        raise RuntimeError(f"on rank 0: {value}")
    return value


def _gather_slices(fulls: List[torch.Tensor], slices: List[Tuple[int, int,
                   int]], mesh: Mesh) -> None:
    """Every rank of the data group holds its slice (dim, start, length;
    start = rank x length) of each tensor of `fulls`: fill in the other
    ranks' slices, in one all-gather."""
    if mesh.size == 1 or not fulls:
        return
    mine = torch.cat([f.narrow(*s).reshape(-1) for f, s in zip(fulls, slices)])
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.data_group)
    for r, part in enumerate(parts):
        if r == mesh.rank:
            continue
        _split_into(part, [f.narrow(d, r * n, n)
                           for f, (d, _, n) in zip(fulls, slices)])


# ---------------------------------------------------- tensor-parallel layout

def param_shardings(params, mesh: Mesh, min_model_dim: int = 2048
                    ) -> Dict[str, int]:
    """The tensor-parallel layout of a parameter tree, by JAX's rule: a leaf
    named `kernel` whose last JAX dim (out) is at least `min_model_dim` and
    divides by the model group's size is split along out, and so is its
    matching `bias`; everything else is replicated. `params` is a port
    model (its JAX names, `checkpoint/jax_params.py::jax_names`) or a
    {JAX path: array} dict. Returns {port name: the dim of the port's
    tensor split over the model group}: 0 for a Dense weight [out, in] or a
    bias [out], 1 for a stacked weight [L, out, in] or bias [L, out]; empty
    for a model group of one."""
    from xggm_tpu_torch.checkpoint.jax_params import jax_names, port_name

    if isinstance(params, torch.nn.Module):
        names = jax_names(params)
        flat = {}
        for name, t in params.state_dict().items():
            shape, key = tuple(t.shape), names[name]
            flat[key] = (shape[:-2] + (shape[-1], shape[-2])
                         if key.endswith("/kernel") else shape)
    else:
        flat = {k: tuple(np.shape(v)) for k, v in params.items()}
    size = mesh.model_size
    if size == 1:
        return {}
    out = {}
    for key, shape in flat.items():
        if (key.endswith("kernel") and len(shape) in (2, 3)
                and shape[-1] >= min_model_dim and shape[-1] % size == 0):
            out[port_name(key)] = len(shape) - 2
            bias = key[: -len("kernel")] + "bias"
            if bias in flat and len(flat[bias]) in (1, 2):
                out[port_name(bias)] = len(flat[bias]) - 1
    return out


# ------------------------------------------------------------- ZeRO-1 layout

def _with_data_axis(shape: Sequence[int], data_size: int,
                    skip: Optional[int] = None) -> Optional[int]:
    """The first dimension but `skip` (the one tensor parallelism split)
    that `data_size` divides (and does not exceed), or None: the dimension
    a moment is split along."""
    for d, n in enumerate(shape):
        if d != skip and n >= data_size and n % data_size == 0:
            return d
    return None


def zero_state_shardings(state, mesh: Mesh) -> Dict[str, Optional[int]]:
    """The ZeRO-1 layout of a TrainState: {parameter name: the dimension its
    m and v are split along over the data group, None for a whole leaf}.
    The masters, counters and flags stay whole."""
    split = state.opt_state.split or {}
    return {n: _with_data_axis(tuple(m.shape), mesh.size, split.get(n))
            for n, m in state.opt_state.m.items()}


def maybe_zero_shard_state(state, mesh: Optional[Mesh], enabled: bool):
    """Validate and apply the ZeRO-1 layout when `enabled`: each rank keeps
    its slice of every split m and v (`BertAdamState.shards` records
    them). The one entry point both trainers call on init, --resume and
    --load. Returns (state, layout or None); `state` is changed in place."""
    if not enabled:
        return state, None
    if mesh is None:
        raise ValueError("shard_opt_state requires a device mesh "
                         "(--multiGPU or --coordinator)")
    dims = zero_state_shardings(state, mesh)
    opt = state.opt_state
    if opt.shards is not None:
        raise ValueError("the optimizer state is sharded already")
    shards = {}
    for n, d in dims.items():
        if d is not None:
            length = opt.m[n].shape[d] // mesh.size
            shards[n] = (d, mesh.rank * length, length)

    def local(moments):
        return {n: x.narrow(*shards[n]).clone() if n in shards else x
                for n, x in moments.items()}

    state.opt_state = dataclasses.replace(opt, m=local(opt.m),
                                          v=local(opt.v), shards=shards)
    return state, dims


def axis_sharded_leaves(opt_state) -> List[str]:
    """The names whose m and v are split over the group (the counterpart
    of JAX's spec inspection for ZeRO assertions)."""
    return sorted(opt_state.shards or {})


def gathered_opt_state(opt_state, mesh: Optional[Mesh]):
    """A whole (single-rank layout) copy of a ZeRO-sharded BertAdam state,
    its split moments all-gathered; an unsharded state as it is. Every rank
    calls it."""
    if not opt_state.shards:
        return opt_state
    m, v = dict(opt_state.m), dict(opt_state.v)
    names = list(opt_state.shards)
    slices = [opt_state.shards[n] for n in names]
    fulls = []
    for moments in (m, v):
        for n, (d, _, length) in zip(names, slices):
            shape = list(moments[n].shape)
            shape[d] = length * (mesh.size if mesh is not None else 1)
            full = moments[n].new_empty(shape)
            full.narrow(*opt_state.shards[n]).copy_(moments[n])
            moments[n] = full
            fulls.append(full)
    if mesh is not None:
        _gather_slices(fulls, slices * 2, mesh)
    return dataclasses.replace(opt_state, m=m, v=v, shards=None)


def gather_params_(params: Dict[str, torch.Tensor], opt_state,
                   mesh: Optional[Mesh]) -> None:
    """After a ZeRO-1 update, in which each rank updated its slice of every
    sharded parameter: fill in the other ranks' slices."""
    shards = opt_state.shards
    if not shards or mesh is None or mesh.size == 1:
        return
    names = list(shards)
    with torch.no_grad():
        _gather_slices([params[n].data for n in names],
                       [shards[n] for n in names], mesh)
