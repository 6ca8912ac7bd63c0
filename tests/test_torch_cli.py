"""The port's GQA-OOD CLI: its flags against the JAX CLI's, an end-to-end
run on the CPU with jax and h5py blocked, and the flags of paths not ported
yet; and `cli.export` then `cli.serve` over HTTP for both tasks (the
counterpart of tests/test_serving.py::test_http_server_end_to_end).

The end-to-end run is in-process in a subprocess that blocks `jax`, `flax`
and `h5py` (as tests/test_torch_imports.py does) and swaps in a tiny
`BertConfig` (hidden 64, 4 heads, vocabulary 128), so that its checkpoints
stay a few MB: `--synthetic --xpack` writes a pack corpus and no H5, the
train arm trains one epoch at depth 1/1/1 in fp32, then the test arm loads
a checkpoint and predicts the validation split.
"""
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from xggm_tpu.cli.common import build_parser as jax_build_parser
from xggm_tpu.cli.common import to_config as jax_to_config
from xggm_tpu_torch.cli import gqa_ood
from xggm_tpu_torch.cli.common import build_parser, to_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    [],
    ["--bs", "96", "--lr", "5e-6", "--epochs", "4", "--llayers", "2",
     "--xlayers", "3", "--rlayers", "1", "--dtype", "float32", "--tiny",
     "--test", "testdev", "--data_root", "d", "--vocab", "v.txt",
     "--delta", "3", "--sigma", "0.5", "--num_layer", "3", "--dropout",
     "0.2", "--seed", "7", "--output", "o", "--tmode", "ID",
     "--numWorkers", "3", "--fast", "--optim", "adam", "--gnn", "GAT"],
    ["--fp16", "--dtype", "float32", "--train", "", "--valid", ""],
    ["--pallas_attention", "--prng", "threefry2x32", "--space", "9",
     "--tf_writer", "false", "--eg", "GCN", "--accum_steps", "2"],
]


def _fields(obj, prefix=""):
    """{dotted field name: value} over nested dataclasses."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_to_config_matches_jax():
    """Every field the port's config keeps has the JAX CLI's value, for
    both tasks; every JAX flag parses, with the JAX default (--device
    apart: cuda or cpu here, the jax platform there)."""
    port_p, jax_p = build_parser(), jax_build_parser()
    jax_dests = {a.dest: a.default for a in jax_p._actions}
    port_dests = {a.dest: a.default for a in port_p._actions}
    assert set(jax_dests) == set(port_dests)
    assert {k for k in jax_dests if jax_dests[k] != port_dests[k]} == \
        {"device"}
    assert port_dests["device"] == "cuda"
    for argv in ARGVS:
        for task in ("gqa", "vqa"):
            configs = []
            for parser, make in ((port_p, to_config),
                                 (jax_p, jax_to_config)):
                with (pytest.warns(UserWarning, match="--fp16")
                      if "--fp16" in argv else contextlib.nullcontext()):
                    configs.append(_fields(make(parser.parse_args(argv),
                                                task)))
            ours, theirs = configs
            assert len(ours) > 30
            for k, v in ours.items():
                assert k in theirs and theirs[k] == v, (argv, task, k)


E2E = r"""
import functools, json, os, sys
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes",
             "torch.utils.tensorboard"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import xggm_tpu_torch.cli.common as common
from xggm_tpu_torch.config import BertConfig
common.BertConfig = functools.partial(
    BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=64)
from xggm_tpu_torch.cli import gqa_ood

root, out = sys.argv[1], sys.argv[2]
base = ["--synthetic", "--xpack", "--device", "cpu", "--dtype", "float32",
        "--data_root", root, "--output", out, "--llayers", "1",
        "--xlayers", "1", "--rlayers", "1", "--bs", "32", "--epochs", "1"]
trainer = gqa_ood.main(base)
print("COUNT", trainer.state.opt_state.count, len(trainer.train_set) // 32)
gqa_ood.main(base + ["--test", "val", "--load", os.path.join(out, "BEST_0")])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "flax", "h5py", "xggm_tpu"))
print("LEAKED", leaked)
"""


def test_cli_end_to_end_without_jax_or_h5py(tmp_path):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", E2E, root, out], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "Oracle score: 100.00" in lines
    assert "LEAKED []" in lines
    count, batches = next(ln for ln in lines if ln.startswith("COUNT")
                          ).split()[1:]
    assert int(count) == 2 * int(batches) == 6
    best = next(ln for ln in lines if ln.startswith("Best valid: "))
    best = float(best.split()[-1])
    # BEST only after an improvement on 0; BEST_0 after the epoch
    assert os.path.isdir(os.path.join(out, "BEST")) == (best > 0)
    assert os.path.isdir(os.path.join(out, "BEST_0"))
    assert sum(1 for ln in lines if ln.startswith("Epoch 0: ")) == 1
    assert any(ln.startswith("val accuracy: ") for ln in lines)
    feat = os.path.join(root, "gqa_imgfeat")
    assert not [f for f in os.listdir(feat) if f.endswith(".h5")]
    assert os.path.exists(os.path.join(feat, "train_obj36.xpack"))
    vocab = set(json.load(open(os.path.join(root, "gqa_ood",
                                            "trainval_label2ans.json"))))
    preds = json.load(open(os.path.join(out, "val_predict.json")))
    assert len(preds) == 96 and all(p["prediction"] in vocab for p in preds)
    for name in ("BEST_0", "args.json", "metrics.jsonl", "log.log"):
        assert os.path.exists(os.path.join(out, name)), name
    size = sum(os.path.getsize(os.path.join(out, "BEST_0", f))
               for f in os.listdir(os.path.join(out, "BEST_0")))
    assert size < 10e6


UNPORTED = [
    ["--multiGPU"], ["--pp", "2"], ["--model_parallel", "2"],
    ["--shard_opt_state"], ["--remat"],
    ["--coordinator", "localhost:1234"], ["--num_hosts", "2"],
    ["--host_id", "1"]]


def test_unported_flags_raise(tmp_path):
    """Each raises NotImplementedError naming its ROADMAP.md item, before
    anything is written."""
    for flags in UNPORTED:
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md section 1, item \d"):
            gqa_ood.main(flags + ["--device", "cpu", "--synthetic",
                                  "--data_root", str(tmp_path / "d"),
                                  "--output", str(tmp_path / "out")])
        assert not os.listdir(tmp_path), flags


EXPORT = r"""
import functools, os, sys
for name in ("jax", "jaxlib", "flax", "h5py", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import xggm_tpu_torch.cli.common as common
from xggm_tpu_torch.config import BertConfig
common.BertConfig = functools.partial(
    BertConfig, vocab_size=128, hidden_size=64, num_attention_heads=4,
    intermediate_size=128, max_position_embeddings=64)
from xggm_tpu_torch.cli import export

root = sys.argv[1]
for task in ("gqa", "vqa"):
    export.main(["--synthetic", "--xpack", "--device", "cpu", "--task", task,
                 "--data_root", os.path.join(root, task), "--valid", "val",
                 "--output", os.path.join(root, task, "snap"),
                 "--llayers", "1", "--xlayers", "1", "--rlayers", "1",
                 "--artifact", os.path.join(root, task, "art"),
                 "--serve_bs", "4"])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "flax", "h5py", "xggm_tpu"))
print("LEAKED", leaked)
"""

# h5py stays: the served features are read from H5, as in the JAX CLI
SERVE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from xggm_tpu_torch.cli import serve
serve.main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body: bytes, timeout=120):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=timeout))


def test_export_then_serve_over_http(tmp_path):
    """For --task gqa and vqa: `cli.export --synthetic` (jax, flax and h5py
    blocked), then `cli.serve --synthetic` on a free port (jax and flax
    blocked): /healthz, 6 queries past the exported batch of 4 answered
    from the artifact's vocabulary, a 400 with an error on `{}`, and the
    server still healthy after it."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", EXPORT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout.splitlines()
    prefix = {"gqa": "synth_val", "vqa": "coco_val"}
    servers = {}
    try:
        for task in prefix:
            port = _free_port()
            root = tmp_path / task
            servers[task] = (port, subprocess.Popen(
                [sys.executable, "-c", SERVE, "--artifact",
                 str(root / "art"), "--task", task, "--data_root",
                 str(root), "--split", "val", "--device", "cpu",
                 "--synthetic", "--port", str(port)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        for task, (port, server) in servers.items():
            base = f"http://127.0.0.1:{port}"
            health = None
            for _ in range(240):
                if server.poll() is not None:
                    raise AssertionError(f"{task} server died: "
                                         f"{server.stderr.read()[-2000:]}")
                try:
                    health = json.load(urllib.request.urlopen(
                        base + "/healthz", timeout=5))
                    break
                except OSError:
                    time.sleep(0.5)
            assert health and health["status"] == "ok" and \
                health["batch_size"] == 4, (task, health)
            with open(tmp_path / task / "art" / "meta.json") as f:
                vocab = set(json.load(f)["label2ans"])
            queries = [{"img_id": f"{prefix[task]}_{i % 3}",
                        "sent": f"what color is the object {i} ?"}
                       for i in range(6)]
            resp = _post(base + "/predict",
                         json.dumps({"queries": queries}).encode())
            assert len(resp["answers"]) == 6, (task, resp)
            assert all(a in vocab for a in resp["answers"]), task
            assert resp["latency_ms"] > 0
            with pytest.raises(urllib.error.HTTPError) as bad:
                _post(base + "/predict", b"{}")
            assert bad.value.code == 400 and "error" in json.load(bad.value)
            health = json.load(urllib.request.urlopen(base + "/healthz",
                                                      timeout=30))
            assert health["status"] == "ok", task
    finally:
        for _, server in servers.values():
            server.terminate()
            server.wait(timeout=30)
