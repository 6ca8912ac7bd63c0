"""GPipe pipeline parallelism over the pipe group (counterpart of
`xggm_tpu/parallel/pipeline.py`).

The JAX package pipelines a homogeneous [L, ...] layer stack inside one
SPMD program (`shard_map`, a scan over M + S - 1 ticks, `ppermute`), and
`jax.grad` derives the reverse pipeline. Here each stage is a rank of the
mesh's pipe group (`parallel/mesh.py`), and both directions are explicit:

  * forward (`run_pipeline`): the batch's activation, a dict of [B, ...]
    tensors sharing the batch dim, splits into M microbatches (B must
    divide by M). Stage 0 takes them from its input, every later stage
    receives each from the stage before; each stage runs its layers and
    sends its output on to the next stage; the last stage reassembles
    [B, ...] and returns it. The other stages return None;
  * backward (`pipeline_grads`): the last stage takes its gradients from
    the loss, then sends its inputs' gradients back, microbatch M - 1 first;
    every other stage, in the same order, receives its outputs' gradients,
    back-propagates its layers for that microbatch and sends its inputs'
    gradients on. Stage 0 then back-propagates into whatever made its
    input (the embeddings), once for the whole batch.

Each rank holds every stacked parameter, as JAX replicates the stage
weights over the pipe axis, and stage s runs layers [s L / S, (s + 1) L /
S) (`stage_layers`). A parameter's gradient thus lives on the stage that
used it: `sum_over_pipe` sums the gradients over the pipe group, so every
pipe rank holds the whole gradient, with None (never touched) decided from
the union over the group.

The hand-off is `send` / `recv` between neighbouring ranks. NCCL sends and
receives device tensors. Gloo's branch copies through host memory, so the
same code runs on the CPU in the tests and with CUDA tensors over gloo (two
ranks on one card); on the CPU the copy is a no-op.

With a data group (JAX's `batch_axis`) each data slice runs its own
pipeline: the pipe groups never cross data ranks. Every stage carries the
dtypes of the activation it is given. `gpipe_apply` and `sequential_apply`
probe their layer on one row first, as JAX's runners take the layer's
`eval_shape`: a layer that changes the activation's structure or shape
raises ValueError on every rank, and one that changes its dtype (an fp32
input meeting a bf16 layer) has its input cast up front.

Microbatching is exact for per-example layers, so the pipelined output
equals the sequential one to float tolerance (tests/test_torch_pipeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from xggm_tpu_torch.parallel.mesh import Mesh

Carry = Dict[str, torch.Tensor]


class NotLastStage(Exception):
    """Raised by a pipelined forward on every stage but the last, once the
    stage's share of the forward has run: what follows the pipeline (the
    pooler, the heads, the losses) runs on the last stage alone."""


@dataclass
class _Run:
    """One recorded forward of a stage, kept for its backward."""

    mesh: Mesh
    keys: Tuple[str, ...]
    grad_keys: Tuple[str, ...]
    ins: List[Carry]
    outs: List[Carry]
    source: Optional[Carry]  # stage 0: the batch's input, as given


_PENDING: List[_Run] = []


def stack_stages(stacked: Dict[str, torch.Tensor], n_stages: int
                 ) -> Dict[str, torch.Tensor]:
    """[L, ...] leaves -> [S, L / S, ...] views, stage-major."""
    out = {}
    for k, leaf in stacked.items():
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"stack length {n} not divisible by "
                             f"{n_stages} pipeline stages")
        out[k] = leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])
    return out


def stage_layers(n_layers: int, stage: int, n_stages: int) -> range:
    """The layers stage `stage` of `n_stages` runs, of a stack of
    `n_layers` (which the stages divide)."""
    if n_layers % n_stages:
        raise ValueError(f"stack length {n_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _send(t: torch.Tensor, dst: int, mesh: Mesh) -> None:
    t = t.detach()
    if mesh.backend == "gloo":
        t = t.cpu()
    dist.send(t.contiguous(), dst)


def _recv(shape, dtype, src: int, mesh: Mesh) -> torch.Tensor:
    if mesh.backend == "gloo":
        buf = torch.empty(shape, dtype=dtype)
        dist.recv(buf, src)
        return buf.to(mesh.device)
    buf = torch.empty(shape, dtype=dtype, device=mesh.device)
    dist.recv(buf, src)
    return buf


def _check_structure(y: Carry, x: Carry, same_dtype: bool = True) -> None:
    if set(y) != set(x) or any(
            tuple(y[k].shape) != tuple(x[k].shape)
            or (same_dtype and y[k].dtype != x[k].dtype) for k in x):
        raise ValueError(
            "the layer changes the activation "
            f"({ {k: tuple(v.shape) for k, v in x.items()} } -> "
            f"{ {k: tuple(v.shape) for k, v in y.items()} }); a pipelined "
            "stack must preserve it")


def run_pipeline(stage_fn: Callable[[Carry], Carry], x: Carry, mesh: Mesh,
                 n_microbatches: int,
                 grad_keys: Optional[Sequence[str]] = None
                 ) -> Optional[Carry]:
    """The GPipe forward of `stage_fn` (this rank's layers, which keep the
    activation's structure, shapes and dtypes) over the pipe group: the
    whole [B, ...] output on the last stage, None on the others. `x` is the
    batch's activation on stage 0; on the later stages only its keys,
    shapes and dtypes are read (meta tensors will do).
    `grad_keys` (default: the floating keys) carry gradients between
    stages; with gradients enabled the run is recorded for
    `pipeline_grads`."""
    keys = tuple(sorted(x))
    if not keys:
        raise ValueError("a pipelined activation needs at least one tensor")
    b = x[keys[0]].shape[0]
    if any(x[k].shape[0] != b for k in keys):
        raise ValueError("every activation tensor must share the batch dim "
                         f"({ {k: tuple(v.shape) for k, v in x.items()} })")
    m_count = n_microbatches
    if b % m_count:
        raise ValueError(f"batch {b} not divisible by {m_count} "
                         "microbatches")
    if grad_keys is None:
        grad_keys = [k for k in keys if x[k].dtype.is_floating_point]
    grad_keys = tuple(sorted(grad_keys))
    mb = b // m_count
    stage, n_stages = mesh.pipe_rank, mesh.pipe_size
    first, last = stage == 0, stage == n_stages - 1
    prev, nxt = mesh.global_rank - 1, mesh.global_rank + 1
    record = torch.is_grad_enabled()
    source = dict(x) if first else None

    def leaf(t, k):
        t = t.detach()
        return t.requires_grad_() if record and k in grad_keys else t

    ins, outs = [], []
    for m in range(m_count):
        if first:
            xm = {k: leaf(source[k][m * mb:(m + 1) * mb], k) for k in keys}
        else:
            xm = {k: leaf(_recv((mb, *x[k].shape[1:]), x[k].dtype, prev,
                                mesh), k) for k in keys}
        ym = stage_fn(xm)
        _check_structure(ym, xm)
        if not last:
            for k in keys:
                _send(ym[k], nxt, mesh)
        ins.append(xm)
        outs.append(ym)
    if record:
        _PENDING.append(_Run(mesh, keys, grad_keys, ins,
                             [] if last else outs,
                             source if first else None))
    if not last:
        return None
    return {k: torch.cat([y[k] for y in outs]) for k in keys}


def _accumulate(acc: List[Optional[torch.Tensor]],
                grads: Sequence[Optional[torch.Tensor]]) -> None:
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def pipeline_grads(loss: Optional[torch.Tensor],
                   inputs: Sequence[torch.Tensor]
                   ) -> List[Optional[torch.Tensor]]:
    """d loss / d `inputs` on this stage (None: untouched here), driving
    the backward of every recorded forward in reverse: `loss` on the last
    stage, None on the others. Every stage of the pipe group calls it at
    the same point. Without a recorded forward it is `autograd.grad`."""
    inputs = list(inputs)
    runs = list(_PENDING)
    _PENDING.clear()
    if not runs:
        return list(torch.autograd.grad(loss, inputs, allow_unused=True))
    mesh = runs[0].mesh
    stage, n_stages = mesh.pipe_rank, mesh.pipe_size
    prev, nxt = mesh.global_rank - 1, mesh.global_rank + 1
    n = len(inputs)
    acc: List[Optional[torch.Tensor]] = [None] * n

    def send_back(ins: Carry, grads: Dict[str, Optional[torch.Tensor]],
                  run: _Run) -> None:
        for k in run.grad_keys:
            g = grads.get(k)
            _send(torch.zeros_like(ins[k]) if g is None else g, prev, mesh)

    if stage == n_stages - 1:
        leaves = [(r, m, k) for r, run in enumerate(runs)
                  for m in range(len(run.ins)) for k in run.grad_keys]
        grads = torch.autograd.grad(
            loss, inputs + [runs[r].ins[m][k] for r, m, k in leaves],
            allow_unused=True)
        _accumulate(acc, grads[:n])
        by_leaf = dict(zip(leaves, grads[n:]))
        for r in reversed(range(len(runs))):
            run = runs[r]
            for m in reversed(range(len(run.ins))):
                send_back(run.ins[m], {k: by_leaf[(r, m, k)]
                                       for k in run.grad_keys}, run)
        return acc

    for run in reversed(runs):
        in_grads: List[Dict[str, Optional[torch.Tensor]]] = \
            [{} for _ in run.ins]
        for m in reversed(range(len(run.ins))):
            out_m = run.outs[m]
            g_out = {k: _recv(tuple(out_m[k].shape), out_m[k].dtype, nxt,
                              mesh) for k in run.grad_keys}
            pairs = [(out_m[k], g_out[k]) for k in run.grad_keys
                     if out_m[k].requires_grad]
            leaves = [k for k in run.grad_keys
                      if run.ins[m][k].requires_grad]
            if pairs:
                grads = torch.autograd.grad(
                    [o for o, _ in pairs], inputs + [run.ins[m][k]
                                                     for k in leaves],
                    [g for _, g in pairs], allow_unused=True)
                _accumulate(acc, grads[:n])
                in_grads[m] = dict(zip(leaves, grads[n:]))
            if stage > 0:
                send_back(run.ins[m], in_grads[m], run)
        if stage == 0:
            src = run.source
            pairs = []
            for k in run.grad_keys:
                if not src[k].requires_grad:
                    continue
                parts = [in_grads[m].get(k) for m in range(len(run.ins))]
                parts = [torch.zeros_like(run.ins[m][k]) if g is None else g
                         for m, g in enumerate(parts)]
                pairs.append((src[k], torch.cat(parts).to(src[k].dtype)))
            if pairs:
                _accumulate(acc, torch.autograd.grad(
                    [s for s, _ in pairs], inputs, [g for _, g in pairs],
                    allow_unused=True))
    return acc


def sum_over_pipe(grads: List[Optional[torch.Tensor]],
                  like: Sequence[torch.Tensor], mesh: Optional[Mesh]
                  ) -> List[Optional[torch.Tensor]]:
    """Every pipe rank's gradients summed over the pipe group, so that each
    holds the whole gradient: a gradient is None only where it is None on
    every stage (a one-int-per-leaf MAX all-reduce first), and is zero on a
    stage that did not touch it. `like` gives each gradient's shape."""
    if mesh is None or mesh.pipe_size == 1:
        return grads
    dev = mesh.device
    has = torch.tensor([g is not None for g in grads], dtype=torch.int32,
                       device=dev)
    dist.all_reduce(has, op=dist.ReduceOp.MAX, group=mesh.pipe_group)
    live = [i for i, h in enumerate(has.tolist()) if h]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    if not live:
        return out
    parts = [grads[i] if grads[i] is not None
             else torch.zeros(like[i].shape, dtype=like[i].dtype, device=dev)
             for i in live]
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=mesh.pipe_group)
    for i, piece in zip(live, flat.split([p.numel() for p in parts])):
        out[i] = piece.view(like[i].shape)
    return out


def from_last_stage(value, mesh: Optional[Mesh]):
    """`value` of the pipe group's last stage given to every stage (one
    broadcast; tensors travel through the host and come back on the mesh's
    device). `value` itself without a pipe group."""
    if mesh is None or mesh.pipe_size == 1:
        return value

    def move(v, device):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device)
        if isinstance(v, dict):
            return {k: move(x, device) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(move(x, device) for x in v)
        return v

    last = mesh.pipe_rank == mesh.pipe_size - 1
    box = [move(value, "cpu") if last else None]
    dist.broadcast_object_list(
        box, src=mesh.last_stage_rank, group=mesh.pipe_group,
        device=mesh.device if mesh.backend == "nccl" else None)
    return move(box[0], mesh.device)


def gpipe_apply(layer_apply: Callable, stacked_params: Dict[str,
                torch.Tensor], x: Carry, mesh: Mesh, *, n_microbatches: int,
                extra=None, grad_keys: Optional[Sequence[str]] = None
                ) -> Optional[Carry]:
    """Run `x` through L stacked layers, pipelined over the pipe group:
    `layer_apply(params_i, x, extra) -> x` applies one layer (params_i the
    i-th slice of every stacked leaf); `x` is a dict of [B, ...] tensors
    sharing the batch dim, B divisible by `n_microbatches`. Returns the
    whole output on the last stage and None on the others
    (`run_pipeline`)."""
    layers = stage_layers(next(iter(stacked_params.values())).shape[0],
                          mesh.pipe_rank, mesh.pipe_size)
    x = _cast_up_front(layer_apply, stacked_params, x, extra)

    def stage_fn(xm: Carry) -> Carry:
        for i in layers:
            xm = layer_apply({k: v[i] for k, v in stacked_params.items()},
                             xm, extra)
        return xm

    return run_pipeline(stage_fn, x, mesh, n_microbatches, grad_keys)


def sequential_apply(layer_apply: Callable, stacked_params: Dict[str,
                     torch.Tensor], x: Carry, extra=None) -> Carry:
    """The same stack run in turn over the whole batch (the reference
    semantics of `gpipe_apply`); a layer that changes the activation's
    dtype has its input cast up front, as `gpipe_apply` does."""
    x = _cast_up_front(layer_apply, stacked_params, x, extra)
    for i in range(next(iter(stacked_params.values())).shape[0]):
        x = layer_apply({k: v[i] for k, v in stacked_params.items()}, x,
                        extra)
    return x


def _cast_up_front(layer_apply: Callable, stacked_params: Dict[str,
                   torch.Tensor], x: Carry, extra) -> Carry:
    """`x` in the dtypes layer 0 emits, after a probe of layer 0 on the
    first row (no gradients); ValueError if the layer changes the
    activation's structure or shapes."""
    with torch.no_grad():
        probe = {k: v[:1] for k, v in x.items()}
        y = layer_apply({k: v[0] for k, v in stacked_params.items()}, probe,
                        extra)
    _check_structure(y, probe, same_dtype=False)
    return {k: v.to(y[k].dtype) for k, v in x.items()}
