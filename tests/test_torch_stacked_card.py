"""The stacked-layers layout on a card (`gpu`; it skips without one). This
file imports no JAX, so that `pytest --noconftest -m gpu
tests/test_torch_stacked_card.py` runs on a machine without it.

A 2-batch GGM trajectory (relation, representation) of a small bf16 model
(hidden 128 in 2 heads of 64, the head width the kernels take; 2/1/1
layers; dropout on: hidden and attention 0.1, the generator's 0.5), once
per-layer and once stacked from the same weights
(`checkpoint/torch_bridge.py::stack_encoder_flat`), with the same seeds:
the stacked layer runs the same kernels on the same values and draws the
same masks, so the first step's losses are equal bit for bit; the clip
norm sums its per-leaf norms grouped otherwise, so the second step's
losses agree within 1e-6 relative and the parameters within rtol 1e-3 /
atol 1e-6. Kernels 2 and 3 launch alike both ways, and each stacked
leaf's counter equals its layers'.
"""
import dataclasses

import numpy as np
import pytest
import torch

from xggm_tpu_torch.checkpoint.jax_params import (
    from_jax_params, to_jax_params)
from xggm_tpu_torch.checkpoint.torch_bridge import (
    stack_encoder_flat, unstack_encoder_flat)
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import TrainState, make_ggm_train_step

B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(stacked=False):
    cfg = tiny_test_config()
    lx = cfg.lxmert
    return cfg.replace(lxmert=lx.replace(
        stacked_layers=stacked, dtype="bfloat16", bert=dataclasses.replace(
            lx.bert, hidden_size=128, num_attention_heads=2,
            intermediate_size=256)))


def _batch(device, seed):
    rng = np.random.RandomState(seed)
    adj = rng.rand(B, 36, 36).astype(np.float32)
    mask = np.ones((B, 20), np.int64)
    mask[:, 13:] = 0
    batch = {
        "input_ids": rng.randint(1, 128, (B, 20)), "input_mask": mask,
        "segment_ids": np.zeros((B, 20), np.int64),
        "feats": rng.randn(B, 36, 32).astype(np.float32),
        "boxes": rng.rand(B, 36, 4).astype(np.float32),
        "target": np.eye(16, dtype=np.float32)[rng.randint(0, 16, B)],
        "adj": ((adj + adj.transpose(0, 2, 1)) / 2).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _trajectory(model, cfg, device):
    opt = BertAdam(4e-4, 0.1, 20)
    state = TrainState.create(model, opt)
    losses = []
    counters = (attn.attention_dropout_fwd, attn.attention_dropout_bwd)
    before = [c.launches for c in counters]
    for i, branch in enumerate(("relation", "representation")):
        state, m = make_ggm_train_step(model, opt, cfg.train, branch)(
            state, _batch(device, i), i)
        losses.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    torch.cuda.synchronize()
    return losses, state, [c.launches - b for c, b in zip(counters, before)]


@pytest.mark.gpu
def test_stacked_trajectory_matches_per_layer_on_card(cuda):
    cfg, scfg = _cfg(), _cfg(stacked=True)
    plain = init_weights(XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm,
                                   device=cuda),
                         torch.Generator(device=cuda).manual_seed(0))
    stacked = XGGMModel(scfg.lxmert, scfg.num_answers, scfg.ggm,
                        device=cuda)
    flat = {k[len("params/"):]: v for k, v in to_jax_params(plain).items()}
    stacked.load_state_dict(from_jax_params(
        stack_encoder_flat(flat, scfg.lxmert), stacked))
    loss_p, state_p, n_p = _trajectory(plain, cfg, cuda)
    loss_s, state_s, n_s = _trajectory(stacked, scfg, cuda)
    assert n_s == n_p and n_p[0] > 0
    assert loss_s[0] == loss_p[0]
    for k, v in loss_p[1].items():
        np.testing.assert_allclose(loss_s[1][k], v, rtol=1e-6, err_msg=k)
    got = unstack_encoder_flat(
        {k[len("params/"):]: v for k, v in to_jax_params(stacked).items()},
        scfg.lxmert)
    want = {k[len("params/"):]: v for k, v in to_jax_params(plain).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    counts_p = state_p.opt_state.leaf_counts()
    for name, count in state_s.opt_state.leaf_counts().items():
        if "_stack." not in name:
            assert counts_p[name] == count, name
    assert {c for n, c in state_s.opt_state.leaf_counts().items()
            if "_stack." in n} == {c for n, c in counts_p.items()
                                   if ".encoder.layer" in n
                                   or "_layers." in n}
