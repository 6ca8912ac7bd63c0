#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`xggm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device   the card's name, count and power limit; TF32 off for matmuls.
2. build    nvcc builds every kernel of the serving path for sm_90a (with
            -Xptxas -v: registers, shared memory, spills).
3. kernel   the attention kernel against its plain PyTorch version at the
            four shapes of the serving path, batch 512, bf16 with and
            without a key mask, plus one fp32 check: max abs error against
            the stated tolerance, kernel / plain / SDPA times (CUDA events)
            and the bandwidth bound.
4. serving  gqa_ood_config() at full width (9/5/5 layers, hidden 768, 12
            heads, 1842 answers, 2048-d features) in bf16 with seeded random
            weights, behind the HTTP server: POSTs of 1, 16 and 64 queries,
            answers checked against the answer vocabulary, 34 kernel
            launches per forward, logits against the same model with the
            plain attention.
5. timing   served pairs/s and p50 latency at batch 64, predict_logits
            pairs/s at batch 512, peak device memory.
6. summary  the kernels line, the card's name and power limit, and last
            {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package. Without a CUDA card, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from unittest import mock

SEED = 0
B, H, D = 512, 12, 64
# (Lq, Lk, key mask on the serving path, launches per forward):
# language self-attention (9 layers + 5 x-layers), visual self-attention
# (5 r-layers + 5 x-layers), language->visual and visual->language cross
# attention (5 x-layers each). Only the language keys carry a mask.
PATH_SHAPES = ((20, 20, True, 14), (36, 36, False, 10),
               (20, 36, False, 5), (36, 20, True, 5))
LAUNCHES_PER_FORWARD = sum(s[3] for s in PATH_SHAPES)
# One bf16 ulp is 2^-8..2^-7 of the value; kernel and plain version sum in
# different orders, so a rounding may land one ulp apart.
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# Full model, bf16, kernel vs plain attention: one-ulp differences in the
# attention outputs carried through 19 layers; logits have std ~0.8 here.
LOGITS_ATOL = 0.1
MIN_ARGMAX_AGREEMENT = 0.9
# H100 SXM published peaks (dense): HBM bytes/s and bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SERVE_BATCHES = (1, 16, 64)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(lq: int, lk: int, masked: bool, elem: int):
    """(least ms for one call, "bytes" or "operations"): each input byte read
    once and each output byte written once over HBM bandwidth, against the
    call's FLOPs at the bf16 peak; the larger bounds it."""
    bh = B * H
    nbytes = elem * bh * D * (2 * lq + 2 * lk) + (4 * B * lk if masked else 0)
    flops = 4 * bh * lq * lk * D
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def phase_kernel(torch, attn):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for lq, lk, path_masked, per_fwd in PATH_SHAPES:
        for masked in (True, False):
            def randn(*shape):
                return torch.randn(*shape, device="cuda", generator=g,
                                   dtype=torch.float32).to(torch.bfloat16)

            q, k, v = randn(B * H, lq, D), randn(B * H, lk, D), randn(B * H, lk, D)
            bias = None
            if masked:
                keep = torch.rand(B, lk, device="cuda", generator=g) > 0.2
                bias = (~keep).float() * -10000.0
            got = attn.fused_attention(q, k, v, bias, H)
            want = attn.attention_reference(q, k, v, bias, H)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            ok = bool((err <= BF16_TOL["atol"] + BF16_TOL["rtol"]
                       * want.float().abs()).all())
            q4, k4, v4 = (t.view(B, H, -1, D) for t in (q, k, v))
            mask4 = None if bias is None else \
                bias.to(torch.bfloat16)[:, None, None, :]
            row = dict(
                lq=lq, lk=lk, mask=masked, dtype="bfloat16",
                max_abs_err=float(err.max()), tolerance=BF16_TOL,
                within_tolerance=ok,
                kernel_ms=cuda_ms(lambda: attn.fused_attention(q, k, v, bias, H)),
                plain_ms=cuda_ms(lambda: attn.attention_reference(q, k, v, bias, H)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4)))
            row["bound_ms"], row["bound_by"] = attention_bound(lq, lk, masked, 2)
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["dynamic_smem_bytes"] = 4 * (lq * D + lk * (D + 1) + lk * D)
            row["on_path"] = masked == path_masked
            row["launches_per_forward"] = per_fwd if row["on_path"] else 0
            emit("kernel", **row)
            rows.append(row)

    bad = [(r["lq"], r["lk"], r["mask"], r["max_abs_err"]) for r in rows
           if not r["within_tolerance"]]
    check(not bad, f"bf16 attention kernel vs plain, (Lq, Lk, mask, max abs "
                   f"err) outside {BF16_TOL}: {bad}")

    # the kernel's fp32 path, at the largest shape of the serving path
    q, k, v = (torch.randn(B * H, 36, D, device="cuda", generator=g)
               for _ in range(3))
    bias = (torch.rand(B, 36, device="cuda", generator=g) < 0.2).float() * -1e4
    got = attn.fused_attention(q, k, v, bias, H)
    want = attn.attention_reference(q, k, v, bias, H)
    err = (got - want).abs()
    ok = bool((err <= FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()).all())
    # the same function in float64: how far both fp32 versions are from it
    s64 = (q.double() @ k.double().transpose(-1, -2) / 8.0
           + bias.double().repeat_interleave(H, dim=0)[:, None, :])
    exact = torch.softmax(s64, dim=-1) @ v.double()
    emit("kernel", lq=36, lk=36, mask=True, dtype="float32",
         max_abs_err=float(err.max()), tolerance=FP32_TOL,
         within_tolerance=ok,
         kernel_max_abs_err_vs_float64=float((got.double() - exact).abs().max()),
         plain_max_abs_err_vs_float64=float((want.double() - exact).abs().max()))
    check(ok, f"fp32 attention kernel vs plain: max abs err {float(err.max())}")
    return rows


def post(url: str, payload: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from xggm_tpu_torch.config import gqa_ood_config
    from xggm_tpu_torch.data.synthetic import (
        ANSWERS, synthetic_obj36, synthetic_questions, vocab_tokens)
    from xggm_tpu_torch.data.tokenizer import BertTokenizer
    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.ops import attention as attn
    from xggm_tpu_torch.ops import build
    from xggm_tpu_torch.ops.basic import init_weights
    from xggm_tpu_torch.serving.artifact import ServingModel
    from xggm_tpu_torch.serving.server import InferenceEngine, make_server

    t_start = time.perf_counter()
    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", kind=name, count=count, nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off: torch.backends.cuda.matmul.allow_tf32 = False")

    # 2. build
    res = build.build("attention_fwd")
    emit("build", kernel="attention_fwd", seconds=res.seconds,
         library=res.path,
         ptxas=[ln.strip() for ln in res.log.splitlines()
                if "ptxas info" in ln or "spill" in ln])

    # 3. kernel check and times
    rows = phase_kernel(torch, attn)

    # 4. serving at full width
    cfg = gqa_ood_config()
    lx = cfg.lxmert.replace(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_weights(XGGMModel(lx, cfg.num_answers, device="cuda"), gen)
    label2ans = ANSWERS + [f"answer_{i}" for i in
                           range(len(ANSWERS), cfg.num_answers)]
    meta = {"batch_size": None, "num_answers": cfg.num_answers,
            "label2ans": label2ans, "seq_len": 20, "num_objects": 36,
            "feat_dim": lx.visual.visual_feat_dim, "feats_dtype": "bfloat16"}
    sm = ServingModel(model, meta)
    tokenizer = BertTokenizer({t: i for i, t in enumerate(vocab_tokens())})
    store = synthetic_obj36(64, lx.visual.visual_feat_dim, seed=SEED)
    img_ids = store.img_ids()
    sents = synthetic_questions(512, seed=SEED)

    def queries(n, offset=0):
        return [{"img_id": img_ids[(offset + i) % len(img_ids)],
                 "sent": sents[(offset + i) % len(sents)]} for i in range(n)]

    engine = InferenceEngine(sm, tokenizer, store)
    server = make_server(engine, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.load(resp)
        check(health["status"] == "ok", f"healthz: {health}")

        # the main path: counts at 0 just before, read just after
        attn.fused_attention.launches = 0
        answers = []
        for n in SERVE_BATCHES:
            answers.append(post(url + "/predict", {"queries": queries(n)}))
        torch.cuda.synchronize()
        launches = attn.fused_attention.launches
        vocab = set(label2ans)
        for n, resp in zip(SERVE_BATCHES, answers):
            check(len(resp.get("answers", ())) == n and
                  all(a in vocab for a in resp["answers"]),
                  f"batch {n}: {str(resp)[:300]}")
        forwards = len(SERVE_BATCHES)
        check(launches == LAUNCHES_PER_FORWARD * forwards,
              f"{launches} kernel launches for {forwards} forwards, "
              f"expected {LAUNCHES_PER_FORWARD} each")

        batch = engine._assemble(queries(64))
        logits = sm.predict_logits(batch)
        with mock.patch.object(attn, "fused_attention",
                               attn.attention_reference):
            plain = sm.predict_logits(batch)
        diff = float(abs(logits - plain).max())
        agree = float((logits.argmax(-1) == plain.argmax(-1)).mean())
        emit("serving", healthz=health, batches=list(SERVE_BATCHES),
             answers_sample=answers[-1]["answers"][:8],
             launches=launches, forwards=forwards,
             launches_per_forward=launches / forwards,
             logits_shape=list(logits.shape),
             logits_finite=bool(abs(logits).max() < float("inf")),
             logits_std=float(logits.std()),
             max_abs_diff_vs_plain=diff, logits_atol=LOGITS_ATOL,
             argmax_agreement_vs_plain=agree)
        check(logits.shape == (64, cfg.num_answers), "logits shape")
        check(bool((abs(logits) < float("inf")).all()), "non-finite logits")
        check(diff <= LOGITS_ATOL, f"logits vs plain attention: {diff}")
        check(agree >= MIN_ARGMAX_AGREEMENT, f"argmax agreement {agree}")

        # 5. timing
        torch.cuda.reset_peak_memory_stats()
        lat, t0 = [], time.perf_counter()
        n_req = 20
        for i in range(n_req):
            t = time.perf_counter()
            resp = post(url + "/predict", {"queries": queries(64, 64 * i)})
            lat.append((time.perf_counter() - t) * 1e3)
            check(len(resp.get("answers", ())) == 64, str(resp)[:300])
        served = 64 * n_req / (time.perf_counter() - t0)
        big = engine._assemble(queries(512))
        for _ in range(2):
            sm.predict_logits(big)
        torch.cuda.synchronize()
        iters, t0 = 10, time.perf_counter()
        for _ in range(iters):
            sm.predict_logits(big)
        torch.cuda.synchronize()
        offline = 512 * iters / (time.perf_counter() - t0)
        emit("timing", card=card, served_pairs_per_s_bs64=served,
             served_p50_ms_bs64=statistics.median(lat),
             predict_logits_pairs_per_s_bs512=offline,
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             seconds_so_far=time.perf_counter() - t_start)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # 6. summary: one entry per kernel, over one forward's launches at B=512
    path = [r for r in rows if r["on_path"]]

    def per_forward(key):
        return sum(r[key] * r["launches_per_forward"] for r in path)

    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "xggm_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "xggm_tpu/ops/pallas_attention.py:95",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in path)
                     else "operations"),
        "library_ms": per_forward("library_ms"),
        "timed_over": f"one forward's {LAUNCHES_PER_FORWARD} launches at "
                      f"B={B}"}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
