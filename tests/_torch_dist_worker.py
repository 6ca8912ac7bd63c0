"""One rank of the port's two-rank CPU runs (gloo) for
tests/test_torch_scale_out.py; JAX is blocked here.

    python tests/_torch_dist_worker.py COORDINATOR WORLD RANK WORKDIR

WORKDIR/inputs.pt (written by the test) holds the tiny model's initial
state dict, the global batches of the task trajectory and the paths of the
checkpoint and pretraining runs. The rank runs, each on its slice of every
global batch:

  * the 2-batch GGM trajectory (relation, representation) with the tree
    BertAdam under data parallelism ("dp"), under ZeRO-1 ("zero") and with
    the fused BertAdam under ZeRO-1 ("zero_fused", the kernel's plain
    version on the CPU, over the shard views); "zero" then writes its
    gathered state as the checkpoint ZERO2;
  * the reverse: the single-rank checkpoint ONE loaded, sharded, checked
    slice for slice and saved again, gathered, as ONE_RESAVED;
  * two epochs of `LxmertPretrainer` with accum_steps 2, recording every
    microbatch's losses (the ranks' mean) and the averaged gradient of
    each update;
  * the task trajectory again in bf16 with the bf16 parameter shadow, as
    "dp", "zero" and "zero_fused", and on rank 0 as one rank at the global
    batch ("one"): the ZeRO-1 layout of the masters, a rank's bytes of
    masters, moments and shadow, the gathered snapshot, the shadow against
    a fresh cast of the masters, and a restore of the snapshot.

It writes WORKDIR/results_{RANK}.pt and prints WORKER_OK RANK.
"""
import os
import sys

for _name in ("jax", "jaxlib", "flax", "ml_dtypes"):
    sys.modules[_name] = None

import torch  # noqa: E402

torch.set_num_threads(1)

from xggm_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from xggm_tpu_torch.models.task_model import XGGMModel  # noqa: E402
from xggm_tpu_torch.parallel import (  # noqa: E402
    axis_sharded_leaves, gathered_opt_state, init_distributed, make_mesh,
    maybe_zero_shard_state, process_slice, shutdown_distributed)
from xggm_tpu_torch.parallel.distributed import host_ranks  # noqa: E402
from xggm_tpu_torch.training import steps  # noqa: E402
from xggm_tpu_torch.training.bert_adam import (  # noqa: E402
    BertAdam, BertAdamState, lr_scale_tree)
from xggm_tpu_torch.training.steps import (  # noqa: E402
    TrainState, make_ggm_train_step)

INT_KEYS = ("input_ids", "input_mask", "segment_ids")


def task_runs(inp, mesh):
    cfg = inp["cfg"]
    out = {}
    for name, kw, zero in (("dp", {}, False), ("zero", {}, True),
                           ("zero_fused", {"fused": True}, True)):
        model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
        model.load_state_dict(inp["flat0"])
        opt = BertAdam(inp["lr"], inp["warmup"], inp["t_total"],
                       lr_scale=lr_scale_tree(
                           (n for n, _ in model.named_parameters()),
                           lambda n: not n.startswith("lxrt."), 1.0, 0.25),
                       **kw)
        state, _ = maybe_zero_shard_state(
            TrainState.create(model, opt, mesh), mesh, zero)
        record = []
        for i, (branch, batch) in enumerate(zip(inp["plan"],
                                                inp["batches"])):
            local = {k: torch.from_numpy(process_slice(v, mesh.rank,
                                                       mesh.size))
                     for k, v in batch.items()}
            for k in INT_KEYS:
                local[k] = local[k].long()
            step = make_ggm_train_step(model, opt, cfg.train, branch)
            state, m = step(state, local, i)
            record.append({
                "metrics": {k: float(m[k]) for k in inp["metrics"]},
                "leaf_count": state.opt_state.leaf_counts(),
                "active": state.opt_state.active_flags(),
                "count": state.opt_state.count})
        whole = gathered_opt_state(state.opt_state, mesh)
        out[name] = {
            "record": record,
            "params": {n: p.detach().clone() for n, p in state.params.items()},
            "m": whole.m, "v": whole.v,
            "sharded": axis_sharded_leaves(state.opt_state),
            "local_m_shapes": {n: tuple(x.shape)
                               for n, x in state.opt_state.m.items()}}
        if name == "zero":
            ckpt = CheckpointManager(inp["zero_dir"], mesh)
            ckpt.save("ZERO2", {"model": model.state_dict(),
                                "opt_state": whole.state_dict()})
            ckpt.wait()
    return out


def shadow_runs(inp, mesh):
    """The task trajectory in bf16 with the shadow, as "dp", "zero",
    "zero_fused" and (rank 0) "one": per step the metrics, then the
    gathered snapshot, the shadow and the ZeRO-1 layout and bytes."""
    cfg = inp["cfg"]
    cfg = cfg.replace(lxmert=cfg.lxmert.replace(dtype="bfloat16"))
    runs = [("dp", {}, False, mesh), ("zero", {}, True, mesh),
            ("zero_fused", {"fused": True}, True, mesh)]
    if mesh.rank == 0:
        runs.append(("one", {}, False, None))
    out = {}
    for name, kw, zero, run_mesh in runs:
        model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
        model.load_state_dict(inp["flat0"])
        opt = BertAdam(inp["lr"], inp["warmup"], inp["t_total"], **kw)
        state, _ = maybe_zero_shard_state(
            TrainState.create(model, opt, run_mesh), run_mesh, zero)
        record = []
        for i, (branch, batch) in enumerate(zip(inp["plan"],
                                                inp["batches"])):
            rows = ({k: torch.from_numpy(v) for k, v in batch.items()}
                    if run_mesh is None else
                    {k: torch.from_numpy(process_slice(v, mesh.rank,
                                                       mesh.size))
                     for k, v in batch.items()})
            for k in INT_KEYS:
                rows[k] = rows[k].long()
            step = make_ggm_train_step(model, opt, cfg.train, branch)
            state, m = step(state, rows, i)
            record.append({k: float(m[k]) for k in inp["metrics"]})
        opt_state = state.opt_state
        shadow = state.shadow
        masters, opt_sd = steps.whole_snapshot(model, state)
        sliced = sorted(opt_state.sliced)
        bytes_ = {
            "masters": sum(state.params[n].numel() * 4 for n in shadow),
            "moments": sum((opt_state.m[n].numel() + opt_state.v[n].numel())
                           * 4 for n in shadow),
            "shadow": sum(t.numel() * 2 for t in shadow.values()),
            "shadowed": sum(t.numel() for t in shadow.values())}
        fresh = all(torch.equal(shadow[n], masters[n].to(torch.bfloat16))
                    for n in shadow)
        restored_ok = None
        if zero:
            # a restore of the gathered snapshot: the masters re-sliced
            # and the shadow cast anew, equal to what was saved
            steps.restore_snapshot(model, state,
                                   {"model": masters, "opt_state": opt_sd},
                                   True, "snapshot")
            again, _ = steps.whole_snapshot(model, state)
            restored_ok = (sorted(state.opt_state.sliced) == sliced
                           and all(torch.equal(again[n], masters[n])
                                   for n in masters)
                           and all(torch.equal(state.shadow[n],
                                               masters[n].to(torch.bfloat16))
                                   for n in state.shadow))
        out[name] = {
            "record": record,
            "params": {n: t.clone() for n, t in masters.items()},
            "shadow": {n: t.detach().clone() for n, t in shadow.items()},
            "fresh_cast": fresh, "sliced": sliced,
            "dims": {n: s[0] for n, s in (opt_state.shards or {}).items()},
            "param_shapes": {n: tuple(p.shape)
                             for n, p in state.params.items()},
            "bytes": bytes_, "restored_ok": restored_ok}
    return out


def reverse_checkpoint(inp, mesh):
    """ONE (single-rank format) loaded and sharded: this rank's m and v
    slices against the whole leaves; then saved again, gathered."""
    ckpt = CheckpointManager(inp["one_dir"], mesh)
    restored = ckpt.load("ONE")
    opt_state = BertAdamState.from_state_dict(restored["opt_state"], "cpu")
    whole_m = dict(opt_state.m)
    state = TrainState(dict(restored["model"]), opt_state, mesh)
    state, dims = maybe_zero_shard_state(state, mesh, True)
    shards = state.opt_state.shards
    slices_equal = all(
        torch.equal(state.opt_state.m[n], whole_m[n].narrow(*shards[n]))
        for n in shards)
    ckpt.save("ONE_RESAVED", {
        "model": restored["model"],
        "opt_state": gathered_opt_state(state.opt_state, mesh).state_dict()})
    ckpt.wait()
    return {"slices_equal": slices_equal, "n_sharded": len(shards),
            "n_whole": sum(d is None for d in dims.values())}


def pretrain_run(inp, mesh):
    """Two epochs of the pretrainer on this rank's rows: each microbatch's
    (total, losses) and each update's averaged gradient before the clip."""
    from xggm_tpu_torch.data.pretrain_data import (
        LxmertPretrainDataset, PretrainFeaturizer)
    from xggm_tpu_torch.data.tokenizer import BertTokenizer
    from xggm_tpu_torch.models.pretrain_model import LOSSES_NAME
    from xggm_tpu_torch.training.pretrainer import LxmertPretrainer

    p = inp["pretrain"]
    ds = LxmertPretrainDataset(p["source"], p["root"], p["qa_sets"])
    ds.load_features_tsv(p["tsv"])
    feat = PretrainFeaturizer(ds, BertTokenizer.from_file(p["vocab"]),
                              max_seq_length=20, seed=0)
    t = LxmertPretrainer(p["cfg"], feat, None, mesh=mesh)
    t.model.load_state_dict(p["state"])
    losses, grads = [], []

    def recording(fn):
        def wrapped(*args):
            out = fn(*args)
            total, named = out[0], out[1]
            losses.append([float(total)] + [float(named[k])
                                            for k in LOSSES_NAME])
            return out
        return wrapped

    reduce = steps.all_reduce_mean_

    def averaged(tensors, group):
        reduce(tensors, group)
        grads.append([x.clone() for x in tensors])

    t.grad_step = recording(t.grad_step)
    steps.all_reduce_mean_ = averaged
    try:
        t.train()
    finally:
        steps.all_reduce_mean_ = reduce
    names = [n for n, _ in t.model.named_parameters()]
    return {"losses": losses, "grads": grads, "names": names,
            "params": {n: x.detach().clone()
                       for n, x in t.model.named_parameters()},
            "count": t.state.opt_state.count,
            "leaf_count": t.state.opt_state.leaf_counts()}


def main():
    coordinator, world, rank, workdir = sys.argv[1:5]
    init_distributed(coordinator, int(world), int(rank), device="cpu",
                     timeout_s=120)
    try:
        mesh = make_mesh(device="cpu")
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        results = {"host_ranks": host_ranks(),
                   "task": task_runs(inp, mesh),
                   "reverse": reverse_checkpoint(inp, mesh),
                   "shadow": shadow_runs(inp, mesh),
                   "pretrain": pretrain_run(inp, mesh)}
        torch.save(results, os.path.join(workdir, f"results_{rank}.pt"))
    finally:
        shutdown_distributed()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
