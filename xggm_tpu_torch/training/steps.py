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

The model's float32 parameters are the masters; the forward casts them to
the compute dtype at use (bf16 on the card), which takes the place of the
JAX package's bf16 parameter shadow. A batch is a dict of tensors on the
model's device: input_ids, input_mask, segment_ids [B, L] integer, feats
[B, 36, F], boxes [B, 36, 4], target [B, num_answers], adj [B, 36, 36], and
optionally noise_override (the GGM noise to replay).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from xggm_tpu_torch.config import TrainConfig
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import DropoutRng
from xggm_tpu_torch.ops.losses import (
    bce_with_logits, score_matching_loss, symmetric_kl)
from xggm_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_mean_, gather_params_, gathered_opt_state,
    maybe_zero_shard_state, mean_scalars)
from xggm_tpu_torch.parallel.pipeline import (
    NotLastStage, from_last_stage, pipeline_grads, sum_over_pipe)
from xggm_tpu_torch.parallel.pipeline_lxmert import pipeline_mesh
from xggm_tpu_torch.parallel.tensor import (
    gather_split, local_state_dict, tp_split)
from xggm_tpu_torch.training.bert_adam import (
    BertAdam, BertAdamState, global_norm, split_flags)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Grads = Dict[str, Optional[torch.Tensor]]


@dataclass
class TrainState:
    """The model's float32 parameters (the masters, updated in place) by
    name, the BertAdam state (with the model's tensor-parallel split), and
    the mesh the steps run in (None: this process alone)."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: BertAdamState
    mesh: Optional[Mesh] = None

    @classmethod
    def create(cls, model: torch.nn.Module, opt: BertAdam,
               mesh: Optional[Mesh] = None) -> "TrainState":
        params = dict(model.named_parameters())
        opt_state = opt.init(params)
        opt_state.split = tp_split(model) or None
        return cls(params, opt_state, mesh)


def whole_snapshot(model: torch.nn.Module, state: TrainState
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """The model's state dict and the BertAdam state dict in the
    single-rank format: a ZeRO-1 state's slices gathered over the data
    group, then the tensor-parallel slices over the model group. Every rank
    calls it."""
    mesh = state.mesh
    opt = gathered_opt_state(state.opt_state, mesh)
    if opt.split:
        opt = dataclasses.replace(opt, m=gather_split(opt.m, opt.split, mesh),
                                  v=gather_split(opt.v, opt.split, mesh),
                                  split=None)
    return (gather_split(model.state_dict(), tp_split(model), mesh),
            opt.state_dict())


def restore_snapshot(model: torch.nn.Module, state: TrainState,
                     restored: Mapping[str, object], shard_opt_state: bool,
                     name: str) -> None:
    """Load a single-rank checkpoint's model and BertAdam state into
    `model` and `state`, re-sliced for this rank: the tensor-parallel
    slices of the split leaves, then the ZeRO-1 layout under
    `shard_opt_state`."""
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


def _grads(loss: Optional[torch.Tensor], state: TrainState) -> Grads:
    """d loss / d params; None for a parameter outside the graph. Under
    pipeline parallelism `loss` is None on every stage but the last; the
    pipeline's backward runs, and the gradients are summed over the pipe
    group, None where no stage touched a parameter."""
    names = list(state.params)
    params = [state.params[n] for n in names]
    grads = sum_over_pipe(pipeline_grads(loss, params), params, state.mesh)
    return dict(zip(names, grads))


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


def _update(opt: BertAdam, state: TrainState, loss: Optional[torch.Tensor],
            clip: float) -> None:
    """Clip, update and apply: through `fused_step` (kernel 7) for a fused
    BertAdam, as the JAX package's `_clip_update_apply` takes a transform's
    `fused_step`; else clip the gradients in place, then `step`."""
    apply_grads(opt, state, _grads(loss, state), clip)


def apply_grads(opt: BertAdam, state: TrainState, grads: Grads,
                clip: float) -> None:
    """`_update` from gradients already taken (None: outside the graph; the
    same parameters on every rank, since every rank takes the same branch).
    In a data group of more than one rank the gradients are first averaged
    over it, in place; on the tree path they are clipped in place. A
    ZeRO-1 state's parameters are gathered after the update."""
    mesh = state.mesh
    if mesh is not None and mesh.size > 1:
        all_reduce_mean_([g for g in grads.values() if g is not None], mesh)
    if opt.fused:
        opt.fused_step(state.params, grads, state.opt_state, clip, mesh)
    else:
        clip_by_global_norm(grads, clip, state.opt_state, mesh)
        opt.step(state.params, grads, state.opt_state, mesh)
    gather_params_(state.params, state.opt_state, mesh)


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
        out = on_last_stage(ggm_loss, batch, dropout_seed, noise_seed)
        loss, metrics = out if out is not None else (None, None)
        _update(opt, state, loss, cfg.grad_clip)
        return None if metrics is None else {k: v.detach()
                                             for k, v in metrics.items()}

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
        out = on_last_stage(clean_loss, batch, dropout_seed)
        loss, logits = out if out is not None else (None, None)
        _update(opt, state, loss, cfg.grad_clip)
        if loss is None:
            return None
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
