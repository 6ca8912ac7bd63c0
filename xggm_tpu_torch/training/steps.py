"""Train, eval and logits steps (counterpart of `xggm_tpu/training/steps.py`).

A GGM train step runs, per batch, two phases with one optimizer update
each (hence t_total = 2 x the batch count):
  [GGM phase]   one branch (relation or representation, chosen by the
                caller) -> backward -> clip to global norm 5.0 -> BertAdam
  [clean phase] plain BCE -> backward -> clip -> BertAdam
GQA runs GGM then clean; VQA-CP (`clean_phase_first`) clean then GGM. With
`BertAdam(fused=True)` the clip and the update are one `fused_step`.

The model's float32 parameters are the masters; the forward casts them to
the compute dtype at use (bf16 on the card), which takes the place of the
JAX package's bf16 parameter shadow. A batch is a dict of tensors on the
model's device: input_ids, input_mask, segment_ids [B, L] integer, feats
[B, 36, F], boxes [B, 36, 4], target [B, num_answers], adj [B, 36, 36], and
optionally noise_override (the GGM noise to replay).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from xggm_tpu_torch.config import TrainConfig
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops.basic import DropoutRng
from xggm_tpu_torch.ops.losses import (
    bce_with_logits, score_matching_loss, symmetric_kl)
from xggm_tpu_torch.training.bert_adam import (
    BertAdam, BertAdamState, global_norm)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Grads = Dict[str, Optional[torch.Tensor]]


@dataclass
class TrainState:
    """The model's float32 parameters (the masters, updated in place) by
    name, and the BertAdam state."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: BertAdamState

    @classmethod
    def create(cls, model: torch.nn.Module, opt: BertAdam) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(params, opt.init(params))


def _batch_args(batch: Batch) -> Tuple[torch.Tensor, ...]:
    return (batch["input_ids"], batch["input_mask"], batch["segment_ids"],
            batch["feats"], batch["boxes"])


def _grads(loss: torch.Tensor, state: TrainState) -> Grads:
    """d loss / d params; None for a parameter outside the graph."""
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[n] for n in names],
                                allow_unused=True)
    return dict(zip(names, grads))


def clip_by_global_norm(grads: Grads, clip: float) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most `clip`
    (scale min(1, clip / (norm + 1e-6))); returns the norm before."""
    gs = [g for g in grads.values() if g is not None]
    norm = global_norm(gs)
    torch._foreach_mul_(gs, torch.clamp(clip / (norm + 1e-6), max=1.0))
    return norm


def _update(opt: BertAdam, state: TrainState, loss: torch.Tensor,
            clip: float) -> None:
    """Clip, update and apply: through `fused_step` (kernel 7) for a fused
    BertAdam, as the JAX package's `_clip_update_apply` takes a transform's
    `fused_step`; else clip the gradients in place, then `step`."""
    apply_grads(opt, state, _grads(loss, state), clip)


def apply_grads(opt: BertAdam, state: TrainState, grads: Grads,
                clip: float) -> None:
    """`_update` from gradients already taken (None: outside the graph);
    clips them in place on the tree path."""
    if opt.fused:
        opt.fused_step(state.params, grads, state.opt_state, clip)
    else:
        clip_by_global_norm(grads, clip)
        opt.step(state.params, grads, state.opt_state)


def phase_seeds(seed: int) -> Tuple[int, int, int]:
    """(GGM dropout, GGM noise, clean dropout) seeds of one batch's step."""
    g = torch.Generator().manual_seed(seed)
    return tuple(int(s) for s in torch.randint(0, 2 ** 31, (3,), generator=g))


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
              noise_seed: int) -> Metrics:
        loss, metrics = ggm_loss(batch, dropout_seed, noise_seed)
        _update(opt, state, loss, cfg.grad_clip)
        return {k: v.detach() for k, v in metrics.items()}

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
    phase(state, batch, dropout_seed) -> metrics, one update."""
    clean_loss = make_clean_loss(model, num_answers)

    def phase(state: TrainState, batch: Batch, dropout_seed: int) -> Metrics:
        loss, logits = clean_loss(batch, dropout_seed)
        _update(opt, state, loss, cfg.grad_clip)
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
        ggm_dropout, ggm_noise, clean_dropout = phase_seeds(seed)
        if cfg.clean_phase_first:
            m2 = clean_phase(state, batch, clean_dropout)
            m1 = ggm_phase(state, batch, ggm_dropout, ggm_noise)
        else:
            m1 = ggm_phase(state, batch, ggm_dropout, ggm_noise)
            m2 = clean_phase(state, batch, clean_dropout)
        return state, {**m1, **m2}

    return step


def make_clean_train_step(model, opt: BertAdam, cfg: TrainConfig,
                          num_answers: int) -> Callable:
    """Plain BCE fine-tuning step, one update per batch:
    step(state, batch, seed) -> (state, metrics)."""
    clean_phase = make_clean_phase(model, opt, cfg, num_answers)

    def step(state: TrainState, batch: Batch,
             seed: int) -> Tuple[TrainState, Metrics]:
        return state, clean_phase(state, batch, seed)

    return step


def _logits(model, batch: Batch) -> torch.Tensor:
    args = _batch_args(batch)
    if isinstance(model, XGGMModel):
        return model.clean_forward(*args)
    return model(*args)


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
