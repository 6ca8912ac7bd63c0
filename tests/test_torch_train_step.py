"""The port's GGM train step against the JAX package's.

A 2-batch trajectory, relation then representation (GQA ordering, four
BertAdam updates), of `xggm_tpu_torch.training.steps.make_ggm_train_step`
against `xggm_tpu.training.steps.make_ggm_train_step`, from one state dict
(JAX `init` -> `from_jax_params`), at `tiny_test_config()` sizes with depth
1/1/1, fp32, every dropout 0 and the GGM noise replayed through
`noise_override` on both sides. The JAX side runs its plain XLA attention;
the kernel-level parity of the attention is in
tests/test_torch_attention_dropout.py.

Tolerances: losses rtol 1e-4 and parameters atol 1e-5 after the four
updates (fp32 on both sides; only summation orders differ, and the Adam
normalisation m / (sqrt(v) + 1e-6) keeps a tiny gradient's update tiny);
BertAdam's per-parameter counters and activation flags exactly.

The JAX steps are compiled once per module, in threads, since XLA's compile
releases the interpreter lock. The VQA ordering (`clean_phase_first`) is
checked on the port alone: the step equals its two phases composed by hand
in that order. Tests loop over their cases (see
tests/test_torch_attention_dropout.py for why the files hold few tests).
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import xggm_tpu.config as jax_config
import xggm_tpu_torch.config as port_config
from xggm_tpu.config import tiny_test_config as jax_tiny
from xggm_tpu.models.task_model import XGGMModel as JaxXGGM
from xggm_tpu.serving.artifact import _flatten
from xggm_tpu.training.bert_adam import bert_adam as jax_bert_adam
from xggm_tpu.training.bert_adam import lr_scale_tree as jax_lr_scale_tree
from xggm_tpu.training import steps as jax_steps
from xggm_tpu_torch.checkpoint.jax_params import from_jax_params, port_name
from xggm_tpu_torch.config import tiny_test_config
from xggm_tpu_torch.models.task_model import XGGMModel
from xggm_tpu_torch.training.bert_adam import BertAdam, lr_scale_tree
from xggm_tpu_torch.training.steps import (
    TrainState, make_clean_phase, make_clean_train_step, make_ggm_phase,
    make_ggm_train_step, phase_seeds)

B, NUM_ANS, HID = 4, 16, 64
LR, WARMUP, T_TOTAL = 4e-4, 0.1, 20
PLAN = ("relation", "representation")
METRICS = ("ggm_loss", "clean_loss", "d_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread is fastest, and it keeps
    torch's thread pool from contending with XLA's in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shrink(cfg, gnn="GCN"):
    """Depth 1/1/1, every dropout 0, the generator `gnn`."""
    lx = cfg.lxmert
    return cfg.replace(
        lxmert=lx.replace(
            bert=dataclasses.replace(lx.bert, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0),
            visual=dataclasses.replace(lx.visual, l_layers=1, x_layers=1,
                                       r_layers=1)),
        ggm=dataclasses.replace(cfg.ggm, dropout=0.0, gnn=gnn))


def _batches():
    rng = np.random.RandomState(42)
    out = []
    for branch in PLAN:
        adj = rng.rand(B, 36, 36).astype(np.float32)
        mask = np.ones((B, 20), np.int32)
        mask[:, 13:] = 0
        noise = rng.randn(*((B, 36, 36) if branch == "relation"
                            else (B, 36, HID))).astype(np.float32)
        if branch == "relation":
            noise = np.triu(noise, 1) + np.swapaxes(np.triu(noise, 1), 1, 2)
        out.append({
            "input_ids": rng.randint(1, 128, (B, 20)).astype(np.int32),
            "input_mask": mask,
            "segment_ids": np.zeros((B, 20), np.int32),
            "feats": rng.randn(B, 36, 32).astype(np.float32),
            "boxes": rng.rand(B, 36, 4).astype(np.float32),
            "target": np.eye(NUM_ANS, dtype=np.float32)[
                rng.randint(0, NUM_ANS, B)],
            "adj": (adj + adj.transpose(0, 2, 1)) / 2,
            "noise_override": noise,
        })
    return out


def _numpy_params(shapes, seed=0):
    """A JAX parameter tree of `shapes` drawn with numpy: LayerNorm scales
    near 1, every other leaf normal(0, 0.05). Tracing a model's init for
    its shapes is much cheaper than compiling or running the init."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + 0.05 * rng.randn(*leaf.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_trajectory(batches, fused=False, gnn="GCN"):
    """Initial flat params (`_numpy_params` on the init's tree), then per
    step the metrics, the flat params and BertAdam's per-leaf counters and
    flags after it. `fused` takes
    `bert_adam(fused=True)`, the Pallas BertAdam interpreted, its
    `fused_step` under a `jax.jit` of its own: a step's two updates then
    share one lowering of the 123 interpreted kernels (about 0.13 s each).
    `gnn` names the generator."""
    cfg = _shrink(jax_tiny(), gnn)
    model = JaxXGGM(cfg.lxmert, cfg.ggm, cfg.num_answers)
    b0, key = batches[0], jax.random.PRNGKey(0)

    def init(k):
        return model.init(
            {"params": k, "dropout": k}, b0["input_ids"], b0["input_mask"],
            b0["segment_ids"], b0["feats"], b0["boxes"], b0["adj"], k,
            method=JaxXGGM.init_all)

    shapes = jax.eval_shape(init, key)
    scales = jax_lr_scale_tree(
        shapes, lambda p: not p.startswith("params/lxrt"), 1.0, 0.25)
    tx = jax_bert_adam(lr=LR, warmup=WARMUP, t_total=T_TOTAL,
                       lr_scale=scales, fused=fused)
    if fused:
        tx = tx._replace(fused_step=jax.jit(tx.fused_step, static_argnums=3))
    state_shapes = jax_steps.TrainState(shapes, jax.eval_shape(tx.init, shapes))
    compiled, threads = {}, []

    def compile_in_thread(name, lowered):
        def run():
            compiled[name] = lowered.compile()
        threads.append(threading.Thread(target=run))
        threads[-1].start()

    # each compile overlaps the next lowering
    for branch, batch in zip(PLAN, batches):
        step = jax_steps.make_ggm_train_step(model, tx, cfg.train, branch)
        compile_in_thread(branch, step.lower(state_shapes, batch, key))
    for t in threads:
        t.join(timeout=600)
    assert set(compiled) == set(PLAN), "JAX compile did not finish"

    params = _numpy_params(shapes)
    flat0 = _flatten(params)
    state = jax_steps.TrainState(params, tx.init(params))
    record = []
    for branch, batch in zip(PLAN, batches):
        state, m = compiled[branch](state, batch, key)
        record.append({
            "metrics": {k: float(m[k]) for k in METRICS},
            "params": _flatten(state.params),
            "leaf_count": _flatten(state.opt_state.leaf_count),
            "active": _flatten(state.opt_state.active)})
    return flat0, record


def _port_model(flat0, cfg, fused=False):
    model = XGGMModel(cfg.lxmert, cfg.num_answers, cfg.ggm, device="cpu")
    model.load_state_dict(from_jax_params(flat0, model))
    opt = BertAdam(LR, WARMUP, T_TOTAL, lr_scale=lr_scale_tree(
        (n for n, _ in model.named_parameters()),
        lambda n: not n.startswith("lxrt."), 1.0, 0.25), fused=fused)
    return model, opt, TrainState.create(model, opt)


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("input_ids", "input_mask", "segment_ids"):
        out[k] = out[k].long()
    return out


def _port_trajectory(flat0, batches, fused=False, gnn="GCN"):
    """The port's record of the same steps as `_jax_trajectory`."""
    cfg = _shrink(tiny_test_config(), gnn)
    model, opt, state = _port_model(flat0, cfg, fused)
    port_record = []
    for i, (branch, batch) in enumerate(zip(PLAN, batches)):
        step = make_ggm_train_step(model, opt, cfg.train, branch)
        state, m = step(state, _torch_batch(batch), i)
        port_record.append({
            "metrics": {k: float(m[k]) for k in METRICS},
            "params": {n: p.detach().numpy().copy()
                       for n, p in state.params.items()},
            "leaf_count": state.opt_state.leaf_counts(),
            "active": state.opt_state.active_flags(),
            "count": state.opt_state.count})
    return port_record


@pytest.fixture(scope="module")
def trajectories():
    batches = _batches()
    flat0, jax_record = _jax_trajectory(batches)
    return flat0, batches, jax_record, _port_trajectory(flat0, batches)


def _check_trajectory(jax_record, port_record):
    """Per step, the losses within rtol 1e-4 and BertAdam's per-leaf
    counters and active flags exactly (node_fc joins only at the first
    representation batch, with its own counter from then on); after the
    four updates every parameter within atol 1e-5."""
    for step, (got, want) in enumerate(zip(port_record, jax_record)):
        for k in METRICS:
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        for field in ("leaf_count", "active"):
            assert got[field] == {port_name(k): v.item()
                                  for k, v in want[field].items()}, \
                f"step {step} {field}"
        active = got["active"]
        node_fc = [n for n in active if n.startswith("node_fc.")]
        assert node_fc and all(active[n] == (step == 1) for n in node_fc)
        assert got["count"] == 2 * (step + 1)
        assert not active["lxrt.embeddings.token_type_embeddings.weight"]

    params = port_record[-1]["params"]
    # a Dense kernel [in, out] is the port's weight [out, in]
    want = {port_name(k): v.T if k.endswith("/kernel") else v
            for k, v in jax_record[-1]["params"].items()}
    assert set(params) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_trajectory_matches_jax(trajectories):
    """`_check_trajectory` on the tree BertAdam of both packages."""
    _, _, jax_record, port_record = trajectories
    _check_trajectory(jax_record, port_record)


def test_clean_first_step_is_its_phases_in_order(trajectories):
    """VQA ordering: the step with clean_phase_first equals the clean phase
    then the GGM phase, composed by hand with the same seeds; and its
    counters show the order."""
    flat0, batches, _, port_record = trajectories
    cfg = _shrink(tiny_test_config())
    vqa = cfg.train.__class__(**{**dataclasses.asdict(cfg.train),
                                 "clean_phase_first": True})
    batch = _torch_batch(batches[0])
    model, opt, state = _port_model(flat0, cfg)
    _, m = make_ggm_train_step(model, opt, vqa, "relation")(state, batch, 0)

    hand, hand_opt, hand_state = _port_model(flat0, cfg)
    ggm_dropout, ggm_noise, clean_dropout = phase_seeds(0)
    m2 = make_clean_phase(hand, hand_opt, vqa, NUM_ANS)(
        hand_state, batch, clean_dropout)
    m1 = make_ggm_phase(hand, hand_opt, vqa, "relation")(
        hand_state, batch, ggm_dropout, ggm_noise)
    for k in METRICS:
        assert float(m[k]) == float({**m1, **m2}[k]), k
    for n, p in state.params.items():
        torch.testing.assert_close(p, hand_state.params[n], rtol=0, atol=0)
    # the GGM leaves join at the second update when the clean phase runs
    # first, at the first when the GGM phase does
    counts = state.opt_state.leaf_counts()
    gqa_counts = port_record[0]["leaf_count"]
    gen = [n for n in counts if n.startswith("generator.")]
    assert gen and all(counts[n] == 1 and gqa_counts[n] == 2 for n in gen)
    assert counts["logit_fc.fc1.weight"] == gqa_counts["logit_fc.fc1.weight"]


def test_config_fields_match_jax():
    """Every field the port's configs keep has the JAX recipe's value."""
    for recipe in ("gqa_ood_config", "vqacpv2_config", "tiny_test_config"):
        port, ref = (getattr(m, recipe)() for m in (port_config, jax_config))
        pairs = [(port.lxmert.bert, ref.lxmert.bert),
                 (port.lxmert.visual, ref.lxmert.visual),
                 (port.ggm, ref.ggm), (port.train, ref.train)]
        for ours, theirs in pairs:
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(theirs, f.name), \
                    f"{recipe} {f.name}"
        assert port.num_answers == ref.num_answers
        assert port.lxmert.dtype == ref.lxmert.dtype


def test_clean_train_step_is_its_clean_phase(trajectories):
    """make_clean_train_step: one update of the clean phase per batch."""
    flat0, batches, _, _ = trajectories
    cfg = _shrink(tiny_test_config())
    batch = _torch_batch(batches[0])
    model, opt, state = _port_model(flat0, cfg)
    _, m = make_clean_train_step(model, opt, cfg.train, NUM_ANS)(
        state, batch, 3)
    hand, hand_opt, hand_state = _port_model(flat0, cfg)
    want = make_clean_phase(hand, hand_opt, cfg.train, NUM_ANS)(
        hand_state, batch, 3)
    assert float(m["clean_loss"]) == float(want["clean_loss"])
    assert state.opt_state.count == 1
    assert torch.equal(m["preds"], want["preds"])
