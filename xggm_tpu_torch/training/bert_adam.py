"""BertAdam (counterpart of `xggm_tpu/training/bert_adam.py::bert_adam`, its
default tree path and its `fused=True` path, and of `lr_scale_tree`).

It keeps the quirks that change training dynamics:
* no bias correction: the update is m / (sqrt(v) + eps);
* decoupled weight decay on every parameter: the update adds wd * p;
* the scheduled lr of a parameter is taken from its own counter BEFORE the
  counter increments, so under warmup its first update has lr 0;
* lazy activation: a parameter is skipped until its first nonzero
  gradient; from then on it updates at every step (moment decay and weight
  decay on zero gradients) with its own counter. A gradient of None (a
  parameter outside the step's graph) counts as zero.

Parameters and gradients are dicts keyed by the model's parameter names.
The per-parameter counters, flags and schedule live on the device as
vectors, so a step reads nothing back to the host.

`step` is the tree path (`torch._foreach_*` over the parameters; the caller
clips first). `fused_step`, the counterpart of `make_fused_bert_adam_step`,
clips, updates and applies in one traversal: the global norm in
`torch._foreach_norm`, then one launch of kernel 7 (`ops/fused_adam.py`)
over every parameter. `BertAdam(fused=True)` makes the train steps take it.
The JAX package's `jnp_fused` and `flat` variants are not ported: nothing
selects them there but a probe script, and on the H100 they were no faster
than the tree path and slower than kernel 7 (ROADMAP.md, item 5).

Under ZeRO-1 (`parallel/mesh.py::maybe_zero_shard_state`) a state's m and v
hold this rank's shard of each parameter that `shards` names; `step` and
`fused_step` then update that shard of the parameter only, from the whole
gradient, and the caller gathers the parameters (`training/steps.py`).

Under tensor parallelism (`parallel/tensor.py`) the parameters that `split`
names hold this rank's slice, and so do their gradients, m and v. Given the
mesh, the global norm then sums those leaves' squares over the model group
(each replicated leaf counted once), and a split leaf's "any nonzero" flag
is OR-ed over the model group, so that the clip, the flags and the
per-leaf counters are those of the whole leaf on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Set, \
    Tuple, Union

import torch
import torch.distributed as dist

from xggm_tpu_torch.ops.fused_adam import fused_adam
from xggm_tpu_torch.parallel.tensor import model_all_reduce


def _w(x: torch.Tensor, warmup: float) -> torch.Tensor:
    return torch.tensor(warmup, dtype=torch.float32, device=x.device)


def warmup_linear(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    """Triangular: x / warmup up to warmup, then down to 0 at x = 1."""
    w = _w(x, warmup)
    return torch.where(x < w, x / w, ((x - 1.0) / (w - 1.0)).clamp_min(0.0))


def warmup_cosine(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    w = _w(x, warmup)
    return torch.where(x < w, x / w, 0.5 * (1.0 + torch.cos(math.pi * x)))


def warmup_constant(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    w = _w(x, warmup)
    return torch.where(x < w, x / w, torch.ones_like(x))


SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
}


@dataclass
class BertAdamState:
    """Moments per parameter; per-parameter lr scales, counters and
    activation flags as vectors in `names` order; the global update count;
    the names that have had a gradient (the others are certainly inactive
    and are skipped); under ZeRO-1, {name: (dim, start, length)} of the
    slice of each sharded parameter that this rank's m and v hold; and
    under tensor parallelism, {name: dim} of the parameters whose slice
    this rank holds (its m and v too)."""

    names: list
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    lr_scale: torch.Tensor  # float32 [n]
    leaf_count: torch.Tensor  # int32 [n]
    active: torch.Tensor  # bool [n]
    count: int = 0
    touched: Set[str] = field(default_factory=set)
    shards: Optional[Dict[str, Tuple[int, int, int]]] = None
    split: Optional[Dict[str, int]] = None

    def local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole-parameter tensor `x` (all of it
        for a parameter that is not sharded)."""
        s = self.shards.get(name) if self.shards else None
        return x if s is None else x.narrow(*s)

    def leaf_counts(self) -> Dict[str, int]:
        return dict(zip(self.names, self.leaf_count.tolist()))

    def active_flags(self) -> Dict[str, bool]:
        return dict(zip(self.names, self.active.tolist()))

    def state_dict(self) -> Dict[str, object]:
        """Every field but `shards` and `split`, as tensors, lists and
        numbers (`touched` sorted); a sharded state is gathered first
        (`parallel/tensor.py::whole_opt_state`)."""
        if self.shards or self.split:
            raise ValueError("a ZeRO-sharded or tensor-parallel BertAdam "
                             "state has no single-rank state dict: gather "
                             "it first")
        return dict(names=list(self.names), m=dict(self.m), v=dict(self.v),
                    lr_scale=self.lr_scale, leaf_count=self.leaf_count,
                    active=self.active, count=self.count,
                    touched=sorted(self.touched))

    @classmethod
    def from_state_dict(cls, d: Mapping[str, object],
                        device: Union[str, torch.device]) -> "BertAdamState":
        """The state of `state_dict`, its tensors on `device`."""
        def to(x):
            return x.to(device)
        return cls(names=list(d["names"]),
                   m={n: to(t) for n, t in d["m"].items()},
                   v={n: to(t) for n, t in d["v"].items()},
                   lr_scale=to(d["lr_scale"]), leaf_count=to(d["leaf_count"]),
                   active=to(d["active"]), count=int(d["count"]),
                   touched=set(d["touched"]))


def global_norm(grads: List[torch.Tensor],
                split: Optional[List[bool]] = None, mesh=None
                ) -> torch.Tensor:
    """The L2 norm of all the gradients together (0 for none). Under
    tensor parallelism (`split` flags the gradients that are this rank's
    slice of their leaf, `mesh` gives the model group) their squares are
    summed over the model group and the others counted once."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch.stack(torch._foreach_norm(grads))
    if mesh is None or mesh.model_size == 1 or not split or not any(split):
        return norms.norm()
    sq = norms.float().square()
    mask = torch.tensor(split, device=sq.device)
    split_sq = model_all_reduce(sq[mask].sum(), mesh)
    return (split_sq + sq[~mask].sum()).sqrt()


class BertAdam:
    """Adam without bias correction, with a scheduled lr per parameter and
    decoupled weight decay. `lr_scale` maps parameter names to lr
    multipliers (1.0 where absent). With `fused=False` (the default, as in
    the JAX package) gradient clipping stays with the caller and `step`
    updates; with `fused=True` the train steps call `fused_step`, which
    clips too."""

    def __init__(self, lr: float, warmup: float = -1.0, t_total: int = -1,
                 schedule: str = "warmup_linear", b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01,
                 lr_scale: Optional[Mapping[str, float]] = None,
                 fused: bool = False):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.schedule = SCHEDULES[schedule]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.lr_scale = dict(lr_scale or {})
        self.fused = fused

    def init(self, params: Mapping[str, torch.Tensor]) -> BertAdamState:
        names = list(params)
        dev = next(iter(params.values())).device
        return BertAdamState(
            names=names,
            m={n: torch.zeros_like(p) for n, p in params.items()},
            v={n: torch.zeros_like(p) for n, p in params.items()},
            lr_scale=torch.tensor([self.lr_scale.get(n, 1.0) for n in names],
                                  dtype=torch.float32, device=dev),
            leaf_count=torch.zeros(len(names), dtype=torch.int32, device=dev),
            active=torch.zeros(len(names), dtype=torch.bool, device=dev))

    def _leaf_lr(self, cnt: torch.Tensor) -> torch.Tensor:
        if self.t_total != -1 and self.warmup != -1:
            progress = cnt.float() / float(self.t_total)
            return self.lr * self.schedule(progress, self.warmup)
        return torch.full(cnt.shape, self.lr, dtype=torch.float32,
                          device=cnt.device)

    def _activate(self, grads: Mapping[str, Optional[torch.Tensor]],
                  state: BertAdamState, mesh=None
                  ) -> Tuple[List[str], List[str], Dict[str, int]]:
        """Names with a gradient, names touched before with none (their
        gradient is zero), and the names' indices; marks the former touched
        and activates those whose gradient has a nonzero entry (its
        inf-norm, which cannot underflow as the L2 norm can; for a
        tensor-parallel slice, on any rank of the model group)."""
        index = {n: i for i, n in enumerate(state.names)}
        with_grad = [n for n in state.names if grads.get(n) is not None]
        state.touched.update(with_grad)
        no_grad = [n for n in state.names
                   if grads.get(n) is None and n in state.touched]
        if with_grad:
            idx = torch.tensor([index[n] for n in with_grad],
                               device=state.active.device)
            nonzero = torch.stack(torch._foreach_norm(
                [grads[n] for n in with_grad], float("inf"))) > 0
            if state.split and mesh is not None and mesh.model_size > 1:
                flags = nonzero.int()
                model_all_reduce(flags, mesh, dist.ReduceOp.MAX)
                nonzero = flags > 0
            state.active[idx] |= nonzero
        return with_grad, no_grad, index

    def _rates(self, state: BertAdamState) -> torch.Tensor:
        """Each parameter's lr: the schedule at its own counter, before the
        counter moves, times its lr scale."""
        return self._leaf_lr(state.leaf_count) * state.lr_scale

    def _advance(self, state: BertAdamState) -> None:
        state.leaf_count += state.active.int()
        state.count += 1

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, Optional[torch.Tensor]],
             state: BertAdamState, mesh=None) -> None:
        """One update of `params` in place from `grads` (None: zero), which
        the caller has clipped; under ZeRO-1, of this rank's slices. `mesh`
        gives the model group of a tensor-parallel state."""
        b1, b2 = self.b1, self.b2
        with_grad, no_grad, index = self._activate(grads, state, mesh)
        live = with_grad + no_grad

        if with_grad:
            gs = [state.local(n, grads[n]) for n in with_grad]
            ms = [state.m[n] for n in with_grad]
            vs = [state.v[n] for n in with_grad]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(gs, 1.0 - b2), gs))
        if no_grad:
            torch._foreach_mul_([state.m[n] for n in no_grad], b1)
            torch._foreach_mul_([state.v[n] for n in no_grad], b2)

        if live:
            ps = [state.local(n, params[n]) for n in live]
            denom = torch._foreach_sqrt([state.v[n] for n in live])
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div([state.m[n] for n in live], denom)
            if self.weight_decay > 0.0:
                torch._foreach_add_(upd, torch._foreach_mul(
                    ps, self.weight_decay))
            factor = torch.where(state.active, -self._rates(state), 0.0)
            idx = torch.tensor([index[n] for n in live],
                               device=factor.device)
            torch._foreach_mul_(upd, factor[idx].unbind())
            torch._foreach_add_(ps, upd)
        self._advance(state)

    @torch.no_grad()
    def fused_step(self, params: Mapping[str, torch.Tensor],
                   grads: Mapping[str, Optional[torch.Tensor]],
                   state: BertAdamState, clip: float,
                   mesh=None) -> torch.Tensor:
        """Clip to a global norm of `clip`, update and apply in one
        traversal (the counterpart of `make_fused_bert_adam_step`): the
        gradients are not scaled in place; kernel 7 applies
        c = min(1, clip / (norm + 1e-6)) as it reads them. Parameters
        touched before with a gradient of None join with a zero gradient;
        those never touched stay out. Returns the norm before clipping.
        `mesh` gives the model group of a tensor-parallel state."""
        with_grad, no_grad, index = self._activate(grads, state, mesh)
        live = with_grad + no_grad
        norm = global_norm([grads[n] for n in with_grad],
                           split_flags(with_grad, state), mesh)
        if live:
            norm = norm.to(state.active.device)
            scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
            self._kernel_update(params, grads, state, live, index, scale)
        self._advance(state)
        return norm

    def _kernel_update(self, params, grads, state: BertAdamState, live,
                       index, scale: torch.Tensor) -> None:
        """Kernel 7 over this rank's slice of every live parameter. The
        kernel takes contiguous tensors: a slice across a later dimension
        is updated in a contiguous copy and written back."""
        lr_eff = torch.where(state.active, self._rates(state), 0.0)
        ps = [state.local(n, params[n]) for n in live]
        work = [p if p.is_contiguous() else p.contiguous() for p in ps]
        gs = [None if grads.get(n) is None
              else state.local(n, grads[n]).contiguous() for n in live]
        fused_adam(gs, [state.m[n] for n in live],
                   [state.v[n] for n in live], work,
                   [index[n] for n in live], scale, lr_eff,
                   b1=self.b1, b2=self.b2, eps=self.eps,
                   wd=self.weight_decay)
        for p, w in zip(ps, work):
            if w is not p:
                p.copy_(w)


def split_flags(names: List[str], state: BertAdamState) -> List[bool]:
    """Whether each of `names` is a tensor-parallel slice in `state`."""
    split = state.split or {}
    return [n in split for n in names]


def lr_scale_tree(names: Iterable[str], predicate: Callable[[str], bool],
                  scale_true: float, scale_false: float) -> Dict[str, float]:
    """{name: scale_true if predicate(name) else scale_false}: e.g. the
    encoder at 1/4 of the downstream lr with
    `predicate=lambda n: not n.startswith("lxrt.")`."""
    return {n: scale_true if predicate(n) else scale_false for n in names}
