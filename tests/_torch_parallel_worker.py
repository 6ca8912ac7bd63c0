"""One rank of the port's four-rank CPU runs (gloo) of tensor and pipeline
parallelism, for tests/test_torch_tensor_parallel.py and
tests/test_torch_pipeline.py; JAX is blocked here.

    python tests/_torch_parallel_worker.py MODE COORDINATOR RANK WORKDIR

WORKDIR/inputs.pt (written by the test) holds the cases. MODE is

  * `tensor`: on a DP 2 x TP 2 grid (`make_mesh(model_parallel=2)`), the
    wide Dense layers split at `min_model_dim` 64: the 2-batch GGM
    trajectory with the tree and the fused BertAdam, dropout off and the
    noise replayed, each data rank on its rows; one GGM loss with dropout
    on; the trajectory again under ZeRO-1, written as the checkpoint TP4;
    the single-rank checkpoint ONE restored, checked slice for slice and
    written again as ONE_RESAVED; and the stacked model's trajectory on a
    TP 2 x PP 2 grid (data group of 1);
  * `pipeline`: the generic `gpipe_apply` cases on a pipe group of 4; then
    on a DP 2 x PP 2 grid the stacked tiny encoder pipelined in 2
    microbatches: its loss and gradients, one relation train step without
    and with remat, and a GGM loss with dropout on, without and with
    remat.

Every multi-rank trajectory also reports whether the replicated parameters
and the BertAdam state are bit-identical across the model or pipe group.
It writes WORKDIR/results_{RANK}.pt and prints WORKER_OK RANK.
"""
import os
import sys

for _name in ("jax", "jaxlib", "flax", "ml_dtypes"):
    sys.modules[_name] = None

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from xggm_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from xggm_tpu_torch.models.task_model import XGGMModel  # noqa: E402
from xggm_tpu_torch.parallel import (  # noqa: E402
    clear_pipeline_mesh, from_last_stage, gpipe_apply, init_distributed,
    make_mesh,
    maybe_zero_shard_state, param_shardings, pipeline_grads,
    process_slice, set_pipeline_mesh, shard_model_, shutdown_distributed,
    sum_over_pipe, tp_split)
from xggm_tpu_torch.parallel.mesh import all_reduce_mean_  # noqa: E402
from xggm_tpu_torch.training.bert_adam import (  # noqa: E402
    BertAdam, lr_scale_tree)
from xggm_tpu_torch.training.steps import (  # noqa: E402
    TrainState, _grads, make_clean_loss, make_ggm_loss, make_ggm_train_step,
    on_last_stage, restore_snapshot, whole_snapshot)

WORLD = 4
INT_KEYS = ("input_ids", "input_mask", "segment_ids")


def local_batch(batch, mesh):
    out = {k: torch.from_numpy(process_slice(v, mesh.rank, mesh.size))
           for k, v in batch.items()}
    for k in INT_KEYS:
        out[k] = out[k].long()
    return out


def same_across(tensors, group, size):
    """Whether `tensors` (a list) are bit-identical on every rank of
    `group`."""
    if size == 1 or not tensors:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def make_opt(inp, model, fused=False):
    return BertAdam(inp["lr"], inp["warmup"], inp["t_total"],
                    lr_scale=lr_scale_tree(
                        (n for n, _ in model.named_parameters()),
                        lambda n: not n.startswith("lxrt."), 1.0, 0.25),
                    fused=fused)


def trajectory(model, opt, state, inp, mesh, cfg):
    record = []
    for i, (branch, batch) in enumerate(zip(inp["plan"], inp["batches"])):
        step = make_ggm_train_step(model, opt, cfg.train, branch)
        state, m = step(state, local_batch(batch, mesh), i)
        record.append({
            "metrics": {k: float(m[k]) for k in inp["metrics"]},
            "leaf_count": state.opt_state.leaf_counts(),
            "active": state.opt_state.active_flags(),
            "count": state.opt_state.count})
    return record


def replicated_identity(state, split, group, size):
    """Replicated parameters, and m and v of replicated leaves (whole
    leaves only), bit-identical across `group`."""
    names = [n for n in state.params if n not in split]
    opt = state.opt_state
    moments = [opt.m[n] for n in names if not (opt.shards or {}).get(n)]
    moments += [opt.v[n] for n in names if not (opt.shards or {}).get(n)]
    return (same_across([state.params[n] for n in names], group, size)
            and same_across(moments, group, size))


# ------------------------------------------------------------------ tensor

def tensor_mode(inp, mesh):
    cfg, out = inp["cfg"], {}
    dims = None
    for name, fused, zero in (("tree", False, False), ("fused", True, False),
                              ("zero", False, True)):
        model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
        model.load_state_dict(inp["flat0"])
        dims = param_shardings(model, mesh, min_model_dim=64)
        shard_model_(model, mesh, dims)
        opt = make_opt(inp, model, fused)
        state, _ = maybe_zero_shard_state(
            TrainState.create(model, opt, mesh), mesh, zero)
        record = trajectory(model, opt, state, inp, mesh, cfg)
        whole, opt_sd = whole_snapshot(model, state)
        out[name] = {
            "record": record, "params": whole,
            "identical": replicated_identity(state, tp_split(model),
                                             mesh.model_group,
                                             mesh.model_size),
            "local_shapes": {n: tuple(p.shape)
                             for n, p in state.params.items()},
            "zero_leaves": sorted(state.opt_state.shards or {})}
        if zero:
            ckpt = CheckpointManager(inp["tp4_dir"], mesh)
            ckpt.save("TP4", {"model": whole, "opt_state": opt_sd})
            ckpt.wait()
    out["dims"] = dims

    # dropout on: the model ranks draw alike, so their activations agree
    model = XGGMModel(inp["cfg_dropout"].lxmert, cfg.num_answers,
                      inp["cfg_dropout"].ggm, device="cpu")
    model.load_state_dict(inp["flat0"])
    shard_model_(model, mesh, dims)
    loss_fn = make_ggm_loss(model, inp["cfg_dropout"].train, "relation")
    batch = local_batch(inp["batches"][0], mesh)
    batch.pop("noise_override")
    loss, metrics = loss_fn(batch, 11, 12)
    logits = make_clean_loss(model, cfg.num_answers)(batch, 13)[1]
    out["dropout"] = {
        "loss": float(loss),
        "agree": same_across([loss.detach(), logits.detach(),
                              *metrics.values()], mesh.model_group,
                             mesh.model_size)}

    # the reverse: a single-rank checkpoint restored into this layout
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    shard_model_(model, mesh, dims)
    opt = make_opt(inp, model)
    state = TrainState.create(model, opt, mesh)
    ckpt = CheckpointManager(inp["one_dir"], mesh)
    restored = ckpt.load("ONE")
    restore_snapshot(model, state, restored, True, "ONE")
    split = tp_split(model)
    ok = True
    for n, p in state.params.items():
        want = restored["model"][n]
        if n in split:
            d, s, k = model.get_submodule(n.rpartition(".")[0]).tp_slices[
                n.rpartition(".")[2]]
            want = want.narrow(d, s, k)
        ok &= torch.equal(p.detach(), want)
        m_want = restored["opt_state"]["m"][n]
        if n in split:
            m_want = m_want.narrow(d, s, k)
        shard = (state.opt_state.shards or {}).get(n)
        if shard is not None:
            m_want = m_want.narrow(*shard)
        ok &= torch.equal(state.opt_state.m[n], m_want)
    model_sd, opt_sd = whole_snapshot(model, state)
    ckpt.save("ONE_RESAVED", {"model": model_sd, "opt_state": opt_sd})
    ckpt.wait()
    out["reverse"] = {"slices_equal": bool(ok),
                      "n_split": len(split),
                      "n_zero": len(state.opt_state.shards or {})}
    out["composed"] = composed_run(inp)
    return out


def composed_run(inp):
    """The stacked model on a model group of 2 by a pipe group of 2, its
    wide Dense layers split, pipelined in 2 microbatches: the trajectory,
    the whole parameters, and whether the replicated state agrees across
    the model group and all of it across the pipe group."""
    cmesh = make_mesh(2, device="cpu", pipeline_parallel=2)
    cfg = inp["cfg_composed"]
    set_pipeline_mesh(cmesh, cfg.lxmert.pp_microbatches)
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(inp["flat0_stacked"])
    shard_model_(model, cmesh, param_shardings(model, cmesh,
                                               min_model_dim=64))
    opt = make_opt(inp, model)
    state = TrainState.create(model, opt, cmesh)
    record = trajectory(model, opt, state, inp, cmesh, cfg)
    clear_pipeline_mesh()
    whole, _ = whole_snapshot(model, state)
    split = tp_split(model)
    names = list(state.params)
    opt_state = state.opt_state
    return {"record": record, "params": whole, "n_split": len(split),
            "stage": cmesh.pipe_rank, "model_rank": cmesh.model_rank,
            "model_identical": replicated_identity(
                state, split, cmesh.model_group, cmesh.model_size),
            "pipe_identical": same_across(
                [state.params[n] for n in names]
                + [opt_state.m[n] for n in names]
                + [opt_state.v[n] for n in names],
                cmesh.pipe_group, cmesh.pipe_size)}


# ---------------------------------------------------------------- pipeline

def mlp_layer(p, x, _extra):
    return {"h": torch.tanh(x["h"] @ p["w"] + p["b"])}


def bf16_layer(p, x, _extra):
    return {"h": torch.tanh(x["h"].to(torch.bfloat16) @ p["w"] + p["b"])}


def generic_cases(inp, mesh):
    out = {}
    last = mesh.pipe_rank == mesh.pipe_size - 1
    for case in inp["generic"]:
        layer = bf16_layer if case["bf16"] else mlp_layer
        params = {k: v.clone().requires_grad_() for k, v in
                  case["params"].items()}
        with torch.set_grad_enabled(case["tgt"] is not None):
            y = gpipe_apply(layer, params, {"h": case["x"]}, mesh,
                            n_microbatches=case["m"])
        got = {"y": from_last_stage(None if y is None else y["h"].detach(),
                                    mesh)}
        if case["tgt"] is not None:
            loss = (((y["h"] - case["tgt"]) ** 2).mean() if last else None)
            like = [params["w"], params["b"]]
            grads = sum_over_pipe(pipeline_grads(loss, like), like, mesh)
            got["grads"] = grads
            got["loss"] = from_last_stage(
                None if loss is None else loss.detach(), mesh)
        out[case["name"]] = got
    try:
        gpipe_apply(lambda p, h, _: {"h": h["h"][..., :4]},
                    inp["generic"][0]["params"],
                    {"h": inp["generic"][0]["x"]}, mesh, n_microbatches=4)
        out["shape_change"] = None
    except ValueError as e:
        out["shape_change"] = str(e)
    return out


def pp_model(inp, cfg, remat=False):
    lx = cfg.lxmert.replace(remat=remat)
    model = XGGMModel(lx, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(inp["stacked0"])
    return model


def pipeline_mode(inp, mesh4):
    out = {"generic": generic_cases(inp, mesh4)}
    mesh = make_mesh(device="cpu", pipeline_parallel=2)
    set_pipeline_mesh(mesh, inp["pp_cfg"].lxmert.pp_microbatches)
    cfg = inp["pp_cfg"]

    # (ii) the encoder's clean loss and gradients
    model = pp_model(inp, cfg)
    batch = local_batch(inp["batches"][0], mesh)
    res = on_last_stage(make_clean_loss(model, cfg.num_answers), batch, 0)
    state = TrainState(dict(model.named_parameters()), None, mesh)
    grads = _grads(None if res is None else res[0] / cfg.num_answers, state)
    live = [g for g in grads.values() if g is not None]
    all_reduce_mean_(live, mesh)
    loss = from_last_stage(None if res is None else res[0].detach(), mesh)
    total = torch.stack([loss])
    all_reduce_mean_([total], mesh)
    out["encoder"] = {"loss": float(total) / cfg.num_answers,
                      "grads": grads}

    # (iii) one relation step, without and with remat
    for remat in (False, True):
        model = pp_model(inp, cfg, remat)
        opt = make_opt(inp, model)
        state = TrainState.create(model, opt, mesh)
        step = make_ggm_train_step(model, opt, cfg.train, "relation")
        state, m = step(state, local_batch(inp["batches"][0], mesh), 0)
        out[f"step_remat{int(remat)}"] = {
            "metrics": {k: float(m[k]) for k in inp["metrics"]},
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "leaf_count": state.opt_state.leaf_counts(),
            "active": state.opt_state.active_flags(),
            "identical": replicated_identity(state, {}, None, WORLD)}

    # dropout on: remat replays the pipeline's draws
    losses = []
    for remat in (False, True):
        model = pp_model(inp, inp["pp_cfg_dropout"], remat)
        fn = make_ggm_loss(model, inp["pp_cfg_dropout"].train, "relation")
        batch = local_batch(inp["batches"][0], mesh)
        res = on_last_stage(fn, batch, 21, 22)
        state = TrainState(dict(model.named_parameters()), None, mesh)
        grads = _grads(None if res is None else res[0], state)
        norm = torch.stack([g.norm() for g in grads.values()
                            if g is not None]).norm()
        losses.append((from_last_stage(None if res is None
                                       else float(res[0].detach()), mesh),
                       float(norm)))
    out["dropout_remat"] = losses
    return out


def main():
    mode, coordinator, rank, workdir = sys.argv[1:5]
    rank = int(rank)
    init_distributed(coordinator, WORLD, rank, device="cpu", timeout_s=120)
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        if mode == "tensor":
            results = tensor_mode(inp, make_mesh(2, device="cpu"))
        else:
            results = pipeline_mode(
                inp, make_mesh(device="cpu", pipeline_parallel=WORLD))
        torch.save(results, os.path.join(workdir, f"results_{rank}.pt"))
    finally:
        shutdown_distributed()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
