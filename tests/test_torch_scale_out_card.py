"""The port's scale-out on a card (`gpu`; they skip without one): a world
of one over NCCL, and remat's gradients through the attention kernels.
This file imports no JAX, so that `pytest --noconftest -m gpu
tests/test_torch_scale_out_card.py` runs on a machine without it.

* A world of one: `init_distributed` over a TCP rendezvous picks NCCL for
  the card; a collective of the group runs; the GGM train step with the
  mesh and ZeRO-1 gives the parameters, moments and counters of the step
  without a mesh, bit for bit (a group of one averages and gathers
  nothing).
* Remat: one bf16 training forward and backward of a small model (hidden
  128 in 2 heads of 64, the head width the kernels take) with dropout on,
  with and without remat from the same seeds: kernel 2 launches again in
  the recompute (twice the attentions of a forward), kernel 3 once per
  attention, and the loss and every gradient equal within rtol 1e-5 /
  atol 1e-7 (the kernels redraw the same masks from the same seeds).
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch

from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.parallel import (
    gathered_opt_state, init_distributed, make_mesh, maybe_zero_shard_state,
    shutdown_distributed)
from xggm_tpu_torch.training.bert_adam import BertAdam
from xggm_tpu_torch.training.steps import (
    TrainState, make_clean_loss, make_ggm_train_step, phase_seeds)

B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(remat=False):
    cfg = tiny_test_config()
    lx = cfg.lxmert
    return cfg.replace(lxmert=lx.replace(
        remat=remat, dtype="bfloat16", bert=dataclasses.replace(
            lx.bert, hidden_size=128, num_attention_heads=2,
            intermediate_size=256)))


def _model(device, remat=False):
    cfg = _cfg(remat)
    return init_weights(
        XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device=device),
        torch.Generator(device=device).manual_seed(0))


def _batch(device, seed=0):
    rng = np.random.RandomState(seed)
    cfg = _cfg()
    adj = rng.rand(B, 36, 36).astype(np.float32)
    mask = np.ones((B, 20), np.int64)
    mask[:, 13:] = 0
    batch = {
        "input_ids": rng.randint(1, 128, (B, 20)), "input_mask": mask,
        "segment_ids": np.zeros((B, 20), np.int64),
        "feats": rng.randn(B, 36, 32).astype(np.float32),
        "boxes": rng.rand(B, 36, 4).astype(np.float32),
        "target": np.eye(cfg.num_answers, dtype=np.float32)[
            rng.randint(0, cfg.num_answers, B)],
        "adj": ((adj + adj.transpose(0, 2, 1)) / 2).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trajectory(device, mesh, zero):
    model = _model(device)
    opt = BertAdam(4e-4, 0.1, 20)
    state, _ = maybe_zero_shard_state(TrainState.create(model, opt, mesh),
                                      mesh, zero)
    losses = []
    for i, branch in enumerate(("relation", "representation")):
        state, m = make_ggm_train_step(model, opt, _cfg().train, branch)(
            state, _batch(device, i), i)
        losses.append(float(m["ggm_loss"]))
    whole = gathered_opt_state(state.opt_state, mesh)
    return losses, state, whole


@pytest.mark.gpu
def test_world_of_one_over_nccl(cuda):
    import torch.distributed as dist

    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0",
                     timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(device="cuda:0")
        assert (mesh.rank, mesh.size) == (0, 1)
        x = torch.arange(4.0, device=cuda)
        dist.all_reduce(x)
        assert x.tolist() == [0.0, 1.0, 2.0, 3.0]
        got = _trajectory(cuda, mesh, True)
    finally:
        shutdown_distributed()
    want = _trajectory(cuda, None, False)
    assert got[0] == want[0]
    assert got[1].opt_state.shards and not want[1].opt_state.shards
    for n, p in want[1].params.items():
        assert torch.equal(got[1].params[n], p), n
        assert torch.equal(got[2].m[n], want[2].m[n]), n
        assert torch.equal(got[2].v[n], want[2].v[n]), n
    assert got[1].opt_state.leaf_counts() == want[1].opt_state.leaf_counts()


@pytest.mark.gpu
def test_remat_gradients_through_the_kernels(cuda):
    batch = _batch(cuda)
    _, _, clean_dropout = phase_seeds(3)
    v = _cfg().lxmert.visual
    per_forward = v.l_layers + v.r_layers + 4 * v.x_layers
    out = []
    for remat in (False, True):
        model = _model(cuda, remat)
        params = list(model.parameters())
        counters = (attn.attention_dropout_fwd, attn.attention_dropout_bwd)
        before = [c.launches for c in counters]
        loss = make_clean_loss(model, _cfg().num_answers)(batch,
                                                         clean_dropout)[0]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        out.append((loss.detach(), grads,
                    [c.launches - b for c, b in zip(counters, before)]))
    (loss_p, grads_p, n_p), (loss_r, grads_r, n_r) = out
    # the clean loss reads the language stream only: the last cross
    # layer's two visual-side attentions get no backward
    assert n_p == [per_forward, per_forward - 2], n_p
    assert n_r == [2 * per_forward, per_forward - 2], n_r
    torch.testing.assert_close(loss_r, loss_p, rtol=1e-5, atol=1e-7)
    for a, b in zip(grads_r, grads_p):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
