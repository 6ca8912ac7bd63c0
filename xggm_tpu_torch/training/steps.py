"""Train, eval and logits steps (counterpart of `xggm_tpu/training/steps.py`).

A GGM train step runs, per batch, two phases with one optimizer update
each (hence t_total = 2 x the batch count):
  [GGM phase]   one branch (relation or representation, chosen by the
                caller) -> backward -> clip to global norm 5.0 -> BertAdam
  [clean phase] plain BCE -> backward -> clip -> BertAdam
GQA runs GGM then clean; VQA-CP (`clean_phase_first`) clean then GGM. With
`BertAdam(fused=True)` the clip and the update are one `fused_step`.

Under data parallelism (a `TrainState.mesh` of more than one rank) each rank
runs the steps on its rows of the global batch: `apply_grads` averages the
gradients over the data group before the clip, so every rank computes the
same norm and the same update, and the step's scalar metrics are averaged
over the group (the global batch's losses). A ZeRO-1 state updates this
rank's slice of each sharded parameter and gathers the rest
(`parallel/mesh.py`). The data rank is folded into the step's dropout and
noise seeds, so data ranks draw different masks for their rows (data rank
0 draws those of a single-process run), while the ranks of one data slice
(its model and pipe ranks) draw alike.

Under tensor parallelism the split leaves hold this rank's slice; the
optimizer sums their norm over the model group (`bert_adam.py`). Under
pipeline parallelism (`pp_stages` > 1) a loss exists on the last pipe stage
alone: the forward raises `NotLastStage` on the others (`on_last_stage`
turns that into None), `_grads` drives the pipeline's backward and sums the
gradients over the pipe group, so every pipe rank applies the same whole
gradient, and the metrics come from the last stage (`from_last_stage`).

The model's float32 parameters are the masters BertAdam updates. Under
bf16 compute with `TrainConfig.bf16_params` (the default, as in the JAX
package) the state also carries the bf16 parameter shadow
(`bf16_param_shadow`): a bf16 copy of every leaf the model reads in bf16
(`checkpoint/jax_params.py::bf16_consumed`, the JAX package's rule). A
phase's forward and backward run with the shadow in place of those masters
(`shadow_overlay`, the counterpart of `_apply_params`), so no weight is
cast at use; the shadow's bf16 gradients are upcast to float32 in one
multi-tensor copy (`upcast_grads`) before the data-group average, the clip
and the update, and the update refreshes the shadow: the tree BertAdam in
one multi-tensor cast, kernel 7 in the same pass as the update. The
shadow is never saved: a restore rebuilds it from the masters. Under ZeRO-1
with the shadow a rank holds only its slice of each shadowed master that
its moments split, and the refreshed shadow is rebuilt by one bf16
all-gather (`parallel/mesh.py`). A batch is a dict of tensors on the
model's device: input_ids, input_mask, segment_ids [B, L] integer, feats
[B, 36, F], boxes [B, 36, 4], target [B, num_answers], adj [B, 36, 36], and
optionally noise_override (the GGM noise to replay).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Mapping, Optional, \
    Sequence, Tuple

import torch

from xggm_tpu_torch.checkpoint.jax_params import bf16_consumed, jax_names
from xggm_tpu_torch.config import TrainConfig
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import DropoutRng
from xggm_tpu_torch.ops.losses import (
    bce_with_logits, score_matching_loss, symmetric_kl)
from xggm_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, gather_params_, gathered_opt_state,
    maybe_zero_shard_state, mean_scalars, whole_masters)
from xggm_tpu_torch.parallel.pipeline import (
    NotLastStage, from_last_stage, pipeline_grads, sum_over_pipe)
from xggm_tpu_torch.parallel.pipeline_lxmert import pipeline_mesh
from xggm_tpu_torch.parallel.tensor import (
    gather_split, local_state_dict, tp_split)
from xggm_tpu_torch.training.bert_adam import (
    BertAdam, BertAdamState, cast_copy_, global_norm, split_flags)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Grads = Dict[str, Optional[torch.Tensor]]


Shadow = Dict[str, torch.Tensor]


def shadow_names(model: torch.nn.Module) -> List[str]:
    """The float32 parameters of `model` that a bf16 model reads in bf16,
    by the JAX package's rule on their JAX names (`bf16_consumed`): every
    Dense weight and bias (the GGM's, the heads' and `lm_head.bias`
    included), no LayerNorm or embedding table."""
    names = jax_names(model)
    return [n for n, p in model.named_parameters()
            if p.dtype == torch.float32 and bf16_consumed(names[n])]


def uses_shadow(model: torch.nn.Module, bf16_params: bool = True) -> bool:
    """Whether a TrainState of `model` carries the bf16 shadow: with
    `bf16_params` and bf16 compute (`model.cfg.compute_dtype`)."""
    cfg = getattr(model, "cfg", None)
    return (bf16_params and cfg is not None
            and cfg.compute_dtype == torch.bfloat16)


def bf16_param_shadow(model: torch.nn.Module) -> Shadow:
    """{name: bf16 copy} of the `shadow_names` leaves, each a leaf tensor
    that requires grad (the forward's weights under `shadow_overlay`)."""
    params = dict(model.named_parameters())
    return {n: params[n].detach().to(torch.bfloat16).requires_grad_()
            for n in shadow_names(model)}


@contextlib.contextmanager
def shadow_overlay(state: "TrainState") -> Iterator[None]:
    """Within the block the model of `state` reads each shadowed parameter
    from the state's shadow in place of its master (the JAX package's
    `_apply_params`); nothing changes without a shadow. A backward that
    recomputes (remat) or drives a pipeline runs inside the block, so that
    it reads the shadow too."""
    swapped = []
    try:
        for n, t in (state.shadow or {}).items():
            module, leaf = state.slots[n]
            swapped.append((module, leaf, module._parameters[leaf]))
            module._parameters[leaf] = t
        yield
    finally:
        for module, leaf, p in reversed(swapped):
            module._parameters[leaf] = p


@dataclass
class TrainState:
    """The model's float32 parameters (the masters, updated in place) by
    name, the BertAdam state (with the model's tensor-parallel split), the
    mesh the steps run in (None: this process alone), the bf16 shadow of
    the leaves read in bf16 (None: no shadow) and the (module, leaf name)
    of each shadowed parameter. Under ZeRO-1 with the shadow the masters
    that `opt_state.sliced` names hold this rank's slice alone: the state
    owns that layout, and `whole_params`, `unshard_` and `restore_snapshot`
    are the ways to read or write them whole."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: BertAdamState
    mesh: Optional[Mesh] = None
    shadow: Optional[Shadow] = None
    slots: Dict[str, Tuple[torch.nn.Module, str]] = field(
        default_factory=dict, repr=False)

    @classmethod
    def create(cls, model: torch.nn.Module, opt: BertAdam,
               mesh: Optional[Mesh] = None,
               bf16_params: bool = True) -> "TrainState":
        """A fresh state of `model`'s parameters as they are, whole; with
        the shadow where `uses_shadow`."""
        params = dict(model.named_parameters())
        opt_state = opt.init(params)
        opt_state.split = tp_split(model) or None
        if not uses_shadow(model, bf16_params):
            return cls(params, opt_state, mesh)
        shadow = bf16_param_shadow(model)
        slots = {n: (model.get_submodule(path), leaf) for n in shadow
                 for path, _, leaf in [n.rpartition(".")]}
        return cls(params, opt_state, mesh, shadow, slots)

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """The masters by name, whole and detached: the ZeRO-1 slices
        gathered over the data group into new tensors (every rank calls
        it), the others the parameters themselves."""
        return whole_masters({n: p.detach() for n, p in self.params.items()},
                             self.opt_state, self.mesh)

    def unshard_(self) -> None:
        """The sliced masters whole again, in place (each parameter's data
        the gathered tensor), ending this state's ZeRO-1 slicing of them:
        before the model's parameters are written whole or a new state is
        made of them. Every rank calls it."""
        sliced = self.opt_state.sliced
        if sliced:
            whole = self.whole_params()
            for n in sliced:
                self.params[n].data = whole[n]
            self.opt_state.sliced = set()

    @torch.no_grad()
    def refresh_shadow_(self) -> None:
        """Cast the (whole) masters into the shadow (after a load replaced
        them)."""
        if self.shadow:
            cast_copy_(list(self.shadow.values()),
                       [self.params[n] for n in self.shadow])


def whole_snapshot(model: torch.nn.Module, state: TrainState
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """The model's state dict and the BertAdam state dict in the
    single-rank format: a ZeRO-1 state's slices (of the moments, and of the
    sliced masters) gathered over the data group, then the tensor-parallel
    slices over the model group. Every rank calls it."""
    mesh = state.mesh
    masters = {**model.state_dict(), **state.whole_params()}
    opt = gathered_opt_state(state.opt_state, mesh)
    if opt.split:
        opt = dataclasses.replace(opt, m=gather_split(opt.m, opt.split, mesh),
                                  v=gather_split(opt.v, opt.split, mesh),
                                  split=None)
    return (gather_split(masters, tp_split(model), mesh), opt.state_dict())


def restore_snapshot(model: torch.nn.Module, state: TrainState,
                     restored: Mapping[str, object], shard_opt_state: bool,
                     name: str) -> None:
    """Load a single-rank checkpoint's model and BertAdam state into
    `model` and `state`, re-sliced for this rank: the tensor-parallel
    slices of the split leaves, the shadow cast anew from the masters, then
    the ZeRO-1 layout under `shard_opt_state`."""
    state.unshard_()
    model.load_state_dict(local_state_dict(model, restored["model"]))
    device = next(iter(state.params.values())).device
    opt = BertAdamState.from_state_dict(restored["opt_state"], device)
    if opt.names != state.opt_state.names:
        raise ValueError(f"{name}: the optimizer state's parameters are "
                         "not this model's")
    split = tp_split(model)
    if split:
        def local(moments):
            return {n: x.clone() if n in split else x for n, x in
                    local_state_dict(model, moments).items()}
        opt = dataclasses.replace(opt, m=local(opt.m), v=local(opt.v),
                                  split=split)
    state.opt_state = opt
    state.refresh_shadow_()
    maybe_zero_shard_state(state, state.mesh, shard_opt_state)


def _batch_args(batch: Batch) -> Tuple[torch.Tensor, ...]:
    return (batch["input_ids"], batch["input_mask"], batch["segment_ids"],
            batch["feats"], batch["boxes"])


def on_last_stage(fn: Callable, *args):
    """`fn(*args)`, or None on a pipeline stage that is not the last (where
    the forward raises `NotLastStage`)."""
    try:
        return fn(*args)
    except NotLastStage:
        return None


@torch.no_grad()
def upcast_grads(grads: Sequence[Optional[torch.Tensor]]
                 ) -> List[Optional[torch.Tensor]]:
    """The bf16 gradients (the shadow's) as float32 views of one new
    buffer, filled by one multi-tensor copy (the JAX package's
    `_upcast_grads`); the others as they are."""
    out = list(grads)
    low = [i for i, g in enumerate(out)
           if g is not None and g.dtype == torch.bfloat16]
    if low:
        sizes = [out[i].numel() for i in low]
        flat = torch.empty(sum(sizes), dtype=torch.float32,
                           device=out[low[0]].device)
        wide = [x.view(out[i].shape) for i, x in
                zip(low, flat.split(sizes))]
        cast_copy_(wide, [out[i] for i in low])
        for i, w in zip(low, wide):
            out[i] = w
    return out


def _grads(loss: Optional[torch.Tensor], state: TrainState) -> Grads:
    """d loss / d params, in float32; None for a parameter outside the
    graph. A shadowed parameter's gradient is that of its shadow leaf,
    upcast. Under pipeline parallelism `loss` is None on every stage but
    the last; the pipeline's backward runs, and the gradients are summed
    over the pipe group, None where no stage touched a parameter."""
    names = list(state.params)
    shadow = state.shadow or {}
    leaves = [shadow.get(n, state.params[n]) for n in names]
    grads = upcast_grads(pipeline_grads(loss, leaves))
    return dict(zip(names, sum_over_pipe(grads, leaves, state.mesh)))


def loss_and_grads(state: TrainState, loss_fn: Callable,
                   *args) -> Tuple[object, Grads]:
    """`loss_fn(*args)` (its first output the loss; None on a pipeline
    stage but the last) and `_grads` of that loss, the forward and the
    backward reading the state's shadow."""
    with shadow_overlay(state):
        out = on_last_stage(loss_fn, *args)
        grads = _grads(None if out is None else out[0], state)
    return out, grads


def clip_by_global_norm(grads: Grads, clip: float,
                        state: Optional[BertAdamState] = None,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most `clip`
    (scale min(1, clip / (norm + 1e-6))); returns the norm before. A
    tensor-parallel `state` and its `mesh` sum the split leaves' norm over
    the model group."""
    names = [n for n, g in grads.items() if g is not None]
    gs = [grads[n] for n in names]
    norm = global_norm(gs, None if state is None
                       else split_flags(names, state), mesh)
    torch._foreach_mul_(gs, torch.clamp(clip / (norm + 1e-6), max=1.0))
    return norm


def apply_grads(opt: BertAdam, state: TrainState, grads: Grads,
                clip: float) -> None:
    """Clip, update and apply, from gradients already taken (None: outside
    the graph; the same parameters on every rank, since every rank takes
    the same branch): through `fused_step` (kernel 7) for a fused BertAdam,
    as the JAX package's `_clip_update_apply` takes a transform's
    `fused_step`; else clip the gradients in place, then `step`. Either
    refreshes the shadow. In a data group of more than one rank the
    gradients are first averaged over it, in place. A ZeRO-1 state's
    parameters (or their shadow) are gathered after the update."""
    mesh = state.mesh
    if mesh is not None and mesh.size > 1:
        all_reduce_mean_([g for g in grads.values() if g is not None], mesh)
    if opt.fused:
        opt.fused_step(state.params, grads, state.opt_state, clip, mesh,
                       state.shadow)
    else:
        clip_by_global_norm(grads, clip, state.opt_state, mesh)
        opt.step(state.params, grads, state.opt_state, mesh, state.shadow)
    gather_params_(state.params, state.opt_state, mesh, state.shadow)


def fold_rank(seed: int, mesh: Optional[Mesh]) -> int:
    """`seed` for this rank's draws: that of its data rank (`Mesh.rank`),
    so that the model and pipe ranks of one data slice draw alike; data
    rank 0's is `seed` itself."""
    return seed + ((mesh.rank if mesh is not None else 0) << 48)


def _merged(*metrics: Optional[Metrics]) -> Optional[Metrics]:
    """The phases' metrics in one dict; None on a stage without them."""
    if any(m is None for m in metrics):
        return None
    return {k: v for m in metrics for k, v in m.items()}


def phase_seeds(seed: int, mesh: Optional[Mesh] = None
                ) -> Tuple[int, int, int]:
    """(GGM dropout, GGM noise, clean dropout) seeds of one batch's step,
    on this rank of `mesh`."""
    g = torch.Generator().manual_seed(seed)
    return tuple(fold_rank(int(s), mesh)
                 for s in torch.randint(0, 2 ** 31, (3,), generator=g))


def make_ggm_loss(model: XGGMModel, cfg: TrainConfig,
                  branch: str) -> Callable:
    """The GGM phase's loss for `branch` in {'relation', 'representation'},
    with no update: loss(batch, dropout_seed, noise_seed) -> (loss,
    metrics)."""
    if branch not in ("relation", "representation"):
        raise ValueError(f"unknown branch {branch!r}")
    num_ans = model.num_answers
    sigma = model.ggm.sigma
    device = next(model.parameters()).device

    def ggm_loss(batch: Batch, dropout_seed: int,
                 noise_seed: int) -> Tuple[torch.Tensor, Metrics]:
        noise = torch.Generator(device=device).manual_seed(noise_seed)
        kw = dict(rng=DropoutRng(dropout_seed, device),
                  noise_override=batch.get("noise_override"))
        if branch == "relation":
            logits, adj_gen, grad_log, adj_true = model.relation_branch(
                *_batch_args(batch), batch["adj"], noise, **kw)
            d_loss = symmetric_kl(adj_gen, adj_true) * num_ans
            loss_grad = score_matching_loss(adj_gen, grad_log, sigma)
            loss_sm = cfg.rel_d_mult * d_loss + loss_grad
            sm_mult = cfg.rel_sm_mult
        else:
            logits, node_gen, feat_grad, visn = model.representation_branch(
                *_batch_args(batch), batch["adj"], noise, **kw)
            d_loss = symmetric_kl(node_gen, visn) * num_ans
            loss_grad = score_matching_loss(node_gen, feat_grad, sigma)
            loss_sm = cfg.rep_d_mult * d_loss + cfg.rep_grad_mult * loss_grad
            sm_mult = cfg.rep_sm_mult
        bce = bce_with_logits(logits, batch["target"]) * num_ans
        loss = bce + sm_mult * loss_sm
        return loss, {"ggm_bce": bce, "d_loss": d_loss,
                      "loss_grad": loss_grad, "loss_sm": loss_sm,
                      "ggm_loss": loss}

    return ggm_loss


def make_ggm_phase(model: XGGMModel, opt: BertAdam, cfg: TrainConfig,
                   branch: str) -> Callable:
    """The GGM phase for `branch`: phase(state, batch, dropout_seed,
    noise_seed) -> metrics, one update."""
    ggm_loss = make_ggm_loss(model, cfg, branch)

    def phase(state: TrainState, batch: Batch, dropout_seed: int,
              noise_seed: int) -> Optional[Metrics]:
        out, grads = loss_and_grads(state, ggm_loss, batch, dropout_seed,
                                    noise_seed)
        apply_grads(opt, state, grads, cfg.grad_clip)
        return None if out is None else {k: v.detach()
                                         for k, v in out[1].items()}

    return phase


def make_clean_loss(model, num_answers: int) -> Callable:
    """The plain BCE loss of an XGGMModel or PlainModel, with no update:
    loss(batch, dropout_seed) -> (loss, logits)."""
    device = next(model.parameters()).device

    def clean_loss(batch: Batch,
                   dropout_seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        rng = DropoutRng(dropout_seed, device)
        args = _batch_args(batch)
        logits = (model.clean_forward(*args, rng=rng)
                  if isinstance(model, XGGMModel) else model(*args, rng=rng))
        return bce_with_logits(logits, batch["target"]) * num_answers, logits

    return clean_loss


def make_clean_phase(model, opt: BertAdam, cfg: TrainConfig,
                     num_answers: int) -> Callable:
    """The plain BCE phase of an XGGMModel or PlainModel:
    phase(state, batch, dropout_seed) -> metrics (None on a pipeline stage
    but the last), one update."""
    clean_loss = make_clean_loss(model, num_answers)

    def phase(state: TrainState, batch: Batch,
              dropout_seed: int) -> Optional[Metrics]:
        out, grads = loss_and_grads(state, clean_loss, batch,
                                    dropout_seed)
        apply_grads(opt, state, grads, cfg.grad_clip)
        if out is None:
            return None
        loss, logits = out
        return {"clean_loss": loss.detach(),
                "preds": logits.detach().argmax(dim=-1)}

    return phase


def make_ggm_train_step(model: XGGMModel, opt: BertAdam, cfg: TrainConfig,
                        branch: str) -> Callable:
    """One (GGM phase + clean phase) train step for `branch`:
    step(state, batch, seed) -> (state, metrics), two updates. `seed` draws
    the batch's dropout masks and noise (`phase_seeds`)."""
    ggm_phase = make_ggm_phase(model, opt, cfg, branch)
    clean_phase = make_clean_phase(model, opt, cfg, model.num_answers)

    def step(state: TrainState, batch: Batch,
             seed: int) -> Tuple[TrainState, Metrics]:
        ggm_dropout, ggm_noise, clean_dropout = phase_seeds(seed, state.mesh)
        if cfg.clean_phase_first:
            m2 = clean_phase(state, batch, clean_dropout)
            m1 = ggm_phase(state, batch, ggm_dropout, ggm_noise)
        else:
            m1 = ggm_phase(state, batch, ggm_dropout, ggm_noise)
            m2 = clean_phase(state, batch, clean_dropout)
        metrics = from_last_stage(_merged(m1, m2), state.mesh)
        return state, mean_scalars(metrics, state.mesh)

    return step


def make_clean_train_step(model, opt: BertAdam, cfg: TrainConfig,
                          num_answers: int) -> Callable:
    """Plain BCE fine-tuning step, one update per batch:
    step(state, batch, seed) -> (state, metrics)."""
    clean_phase = make_clean_phase(model, opt, cfg, num_answers)

    def step(state: TrainState, batch: Batch,
             seed: int) -> Tuple[TrainState, Metrics]:
        metrics = clean_phase(state, batch, fold_rank(seed, state.mesh))
        return state, mean_scalars(from_last_stage(metrics, state.mesh),
                                   state.mesh)

    return step


def _logits(model, batch: Batch) -> torch.Tensor:
    """The logits, on every stage of a pipeline (from its last)."""
    args = _batch_args(batch)
    forward = (model.clean_forward if isinstance(model, XGGMModel)
               else model)
    return from_last_stage(on_last_stage(forward, *args), pipeline_mesh())


def make_logits_step(model) -> Callable[[Batch], torch.Tensor]:
    """batch -> float32 logits [B, num_answers]."""

    @torch.inference_mode()
    def step(batch: Batch) -> torch.Tensor:
        return _logits(model, batch)

    return step


def make_eval_step(model) -> Callable[[Batch], torch.Tensor]:
    """batch -> predicted answer ids [B] (argmax of the logits)."""

    @torch.inference_mode()
    def step(batch: Batch) -> torch.Tensor:
        return _logits(model, batch).argmax(dim=-1)

    return step
