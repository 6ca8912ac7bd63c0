#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`xggm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --forward-device ROOT   # forward kernels' device
                                 # time, for the checkout at ROOT

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device   the card's name, count and power limit; TF32 off for matmuls.
2. build    nvcc builds every kernel source for sm_90a, one nvcc per source,
            all started together: attention_fwd.cu (kernel 1),
            attention_dropout.cu (kernels 2 and 3), attention_blhd.cu
            (kernels 4, 5 and 6) and bert_adam.cu (kernel 7), with
            -Xptxas -v (registers, shared memory, spills); the bf16
            tensor-core kernels' registers and spills (none allowed), the
            backward's (kernels 3 and 6) and the forward's (kernels 1, 2, 4
            and 5), and their dynamic shared memory at the path's shapes;
            the scalar forward instantiated for fp32 only.
3. kernel   kernel 1 against its plain PyTorch version at the four shapes
            of the serving path, batch 512, bf16 with and without a key
            mask, plus one fp32 check: max abs error against the stated
            tolerance, kernel / plain / SDPA times (CUDA events) and the
            bandwidth bound; at the path's masks, the device's own time of
            kernel 1 and of SDPA (torch.profiler), and the wrapper's host
            time.
4. dropout  kernels 2 and 3, and kernel 1's backward (kernel 3 at rate 0),
            at the training batch (B = 96, H = 12), the four shapes of the
            path x {bf16, fp32}, rate 0.1: kernel 2 against the plain
            forward fed the mask ops/philox.py draws, kernel 3 and kernel
            1's backward against torch.autograd.grad through the plain
            versions; the kernel's own mask (read out through an identity v),
            in bf16 and fp32, against the Philox mask, its keep fraction
            against 0.9 +- 5 sigma, and its dependence on the row and the
            seed; kernel 2's registers and shared memory; kernel, plain
            and library times (SDPA with dropout_p=0.1 forward and
            forward+backward; the memory-efficient attention's backward alone
            from a saved forward, at dropout_p 0.1 and, for kernel 1's
            backward, 0) and the bandwidth bounds; in bf16 the device's
            own time per launch of kernel 2, of SDPA's dropout forward, of
            kernel 3 at rates 0.1 and 0 and of the library backward
            (torch.profiler's kernel durations; the run fails if it records
            none).
5. blhd     kernels 4, 5 and 6 (the [B, L, H, 64] layout) at the training
            batch, the four shapes x {bf16, fp32}, rate 0.1: each against its
            plain version and against kernels 1, 2 and 3 on the permuted
            inputs with the same seed (bit for bit expected; at most one
            bf16 ulp allowed), kernel 5's own mask, in bf16 and fp32, checked
            as kernel 2's against the Philox mask of row b * H + h; kernel
            5's registers and shared memory; kernel, plain and library
            times (SDPA, and the memory-efficient attention's backward from
            a saved forward, on strided views of the same BLHD storage),
            the device's own time
            of kernels 4, 5 and 6, of SDPA's forwards and of the library
            backward, and the bandwidth bounds; summary lines of the backward kernels
            (backward_device) and of the forward kernels 1, 2, 4 and 5
            (forward_device) per pass of 34 launches, event and device
            times against the bound; then the
            entry points mha_blhd and mha_dropout_blhd forward and
            backward, as many times as a training forward attends (34 per
            kernel, 68 for kernel 6).
6. serving  gqa_ood_config() at full width (9/5/5 layers, hidden 768, 12
            heads, 1842 answers, 2048-d features) in bf16 with seeded random
            weights, behind the HTTP server: POSTs of 1, 16 and 64 queries,
            answers checked against the answer vocabulary, 34 kernel
            launches per forward, logits against the same model with the
            plain attention.
7. timing   served pairs/s and p50 latency at batch 64, predict_logits
            pairs/s at batch 512, peak device memory.
8. train    the same configuration as a training model (GCN generator, 2
            layers, sigma 1; hidden and attention dropout 0.1, GGM dropout
            0.5), bf16 compute over fp32 masters, BertAdam at lr 4 x 5e-6
            with lxrt at 1/4 of it, warmup 0.1 of t_total 10000, one
            synthetic batch of 96 with an adjacency: the branch plan
            relation, representation, relation, representation, with 68
            kernel-2 and 66 kernel-3 launches per batch (the clean phase
            backpropagates through neither visual-stream attention of the
            last x-layer, which its loss does not read), finite losses, two
            optimizer updates per batch and node_fc joining BertAdam at the
            first representation batch; then, from that state and without an
            update, the loss of each GGM branch and of the clean phase and
            its gradient for every parameter, once through kernels 2 and 3
            and once through the plain attention (same Philox masks): losses
            within 1e-4 relative, gradients within 1e-2 relative L2 over all
            parameters and 5e-2 for each; then ms per two-phase batch over
            10 batches, pairs/s and peak device memory; and one batch under
            torch.profiler: the device's busy and idle share and its time by
            kernel.
9. fused    the same training model with BertAdam(fused=True) (kernel 7, one
   train    launch per update): the branch plan with 8 kernel-7 launches
            for 4 batches and the checks of phase 8; kernel 7 against its
            plain version over the full 395-parameter state with one null
            gradient and one inactive parameter (rtol 1e-6, atol 1e-7), and
            its time per update against its bound, beside
            torch._fused_adamw_ over the same tensors (another function: it
            corrects the moments' bias); from one copied state and one
            batch, one GGM-phase update through the fused path against the
            tree path (the same tolerances, counters and flags exactly);
            then ms per two-phase batch over 10 batches, pairs/s and peak
            device memory for the tree and the fused update in turns on this
            one model (tree, fused, fused, tree), and one profiled batch
            with BertAdam's device time against phase 8's.
10. trainer the GQA-OOD trainer through its CLI (`cli/gqa_ood.py`) at full
            width: a synthetic corpus of 384 training questions over 64
            images and 192 validation questions over 32, written as feature
            packs with no H5 file, its answer vocabulary padded to 1842;
            one epoch of 4 batches of 96 in bf16 (`--xpack`, lr 5e-6, seed
            9595), kernels 1, 2 and 3 counted over it: 68 kernel-2 and 66
            kernel-3 launches per batch, 34 kernel-1 launches per
            validation forward (3 validations inside the epoch and one at
            its end, 2 forwards each), the branches random.Random(9595)'s
            draws, finite losses, 8 BertAdam updates, BEST iff a
            validation improved on 0 and BEST_0, one log.log line; then the
            test arm from that checkpoint: 192 answers in the vocabulary,
            the accuracy recorded for it, and, where the checkpoint holds
            the epoch's final parameters, the answers those parameters
            give in memory, answer for answer. It prints ms per batch
            through the trainer beside phase 8's, the feeder's own host ms
            per batch, which xpack gather ran, seconds and bytes per
            checkpoint save, the epoch's seconds and peak device memory;
            and, on the trained model, ms of each of its steps fed by its
            feeder against the same steps on one resident batch, in turns
            (fed, resident, resident, fed, fed, resident; 2 feeder passes
            each), each pass's first step left out. Its directory stays for
            phase 12 (BEST is deleted once the test arm has read it).
11. vqacp   the VQA-CP v2 recipe (`cli/vqacpv2.py`, 16039 answers, batch
            92, clean phase first, delta 0) at full width in bf16: a pack
            corpus (368 training questions over 64 images, 184 test
            questions over 32) and a seeded random LXMERT pretraining
            snapshot (9/5/5 layers, separate q/k/v, an answer head over
            9500 answers, 1000 of them the corpus's). Run A: an epoch of 4
            batches from `--loadLXMERTQA`; the load prints "Loaded 1000
            answers ... and 15039 not", every encoder parameter and the
            head's first layer equal the snapshot's bit for bit after the
            fuse, the 1000 rows of the last layer their pretraining rows
            and the others 0; branches all `rep`, the clean phase before
            the GGM phase, finite losses, 8 updates, kernels 1 to 3
            launched as derived from the code. Run B: the same, stopped by
            a real SIGTERM after its second step: exit 75, PREEMPT with 2
            batches done and train_iter 2, the save's seconds and bytes.
            Run C: --resume in B's directory: "resumed from PREEMPT (epoch
            0, 2 batches done)", 2 steps, step records and final
            parameters equal to run A's (rtol 1e-4 on losses, atol 1e-5 on
            parameters; the largest differences printed), PREEMPT gone.
            The test arm from C's BEST_0 (--tmode OOD): 184 answers in the
            vocabulary, the accuracy VQAEvaluator gives on the file, the
            answers C's final parameters give in memory. The baseline CLI:
            one clean update per batch, t_total 4, kernels 2 and 3 of the
            clean phase alone. Each run's checkpoints are deleted once
            read. It prints ms per batch through the trainer (runs A and
            C), the snapshot's and the resume's load seconds and peak
            device memory.
12. export  phase 10's BEST_0 (full width, 1842 answers) exported through
   serve    `cli/export.py` (`--load BEST_0`, any batch size) once in bf16
            and once `--quantize int8`; each loaded with
            `ServingModel.load` on the card (no predict.stablehlo, the
            answer vocabulary, the int8 artifact with every Dense but
            `logit_fc.fc2` an `Int8Dense`) and served through
            `InferenceEngine` and the HTTP server over the validation
            images in memory (`MemoryFeatureStore`: the card's machine has
            no h5py): POSTs of 1, 16 and 64 queries, answers in the
            vocabulary, 34 kernel-1 launches per forward and each
            Int8Dense once a forward (the x-layers' shared cross-attention
            twice); the bf16 artifact's logits on 64 validation queries
            against those of phase 10's final parameters in memory (max abs
            diff <= 0.1, argmax >= 90%), the int8 artifact's against the
            bf16 artifact's over the split's distinct questions (per-row
            relative L2 < 5%, the bound of tests/test_serving.py; the
            answers the same, printed with each question's bf16 top-1
            margin where they differ: near-ties of a model 4 updates from
            random weights); per artifact its bytes, the export's and the
            load's seconds, served pairs/s and p50 at batch 64,
            predict_logits pairs/s at batch 512, peak memory; and the
            device time of one forward at batch 512 by category
            (torch.profiler), int8 and bf16. Then the int8 answers on a
            model that has learnt its task: a corpus of phase 10's size
            with each image's answer planted (+3 in its feature column,
            and named in each question), a trainer at full width and
            2/1/1 layers trained from random weights with plain BCE in
            fp32 (`train_baseline`, 64 epochs, lr 1e-4), exported through
            `cli/export.py` in bf16 and int8 and loaded; bf16 accuracy on
            the validation split >= 50% (chance 1/16), int8 against bf16
            per-row relative L2 < 5% and answers the same >= 90% (the
            bounds of tests/test_serving.py).
13. gin/gat the full-width training model of phase 8 with `--gnn GIN`,
            then `--gnn GAT` (2 heads, merge projection): one relation and
            one representation batch of 96 through make_ggm_train_step,
            finite losses, 2 updates per batch, 68 kernel-2 and 66 kernel-3
            launches per batch and no kernel-1 launch; each GGM branch's
            loss and gradients through the kernels against the plain
            attention, within phase 8's limits on the loss, on all
            gradients together and on each parameter's, but GIN's eps
            (a scalar whose terms nearly cancel), held in bf16 to the
            generator's whole gradient and, by GIN's comparison repeated
            from the same parameters computing in fp32, to its own; ms
            per batch over 4 batches, pairs/s and peak memory.
14. pretrain LXMERT pretraining (`cli/pretrain.py`) at the width of
            scripts/pretrain.sh: 9/5/5 layers, hidden 768, 12 heads,
            vocabulary 30522, 1600 objects, 400 attributes, 2048-d
            features, 9500 answers, all four tasks and the visual losses
            obj, attr and feat, bf16, from scratch. A TSV corpus (no h5py
            on the card's machine) of 6 batches of 256 to train and one to
            validate. Run A: one epoch at batch 256, kernel 2 and kernel 3
            34 launches per step (every attention feeds a head), kernel 1
            34 per validation forward, finite losses with all six named in
            the epoch line, 6 BertAdam updates and t_total 6, Epoch01 and
            BEST_EVAL_LOSS. Run B: the same with --accum_steps 2 --bs 128:
            12 microbatches, 6 updates, the counts per microbatch. Then one
            batch of 256's loss and every gradient (the tied word table's
            too, row 0 included), with no update, through the kernels and
            through the plain attention, within phase 8's limits; ms per
            step on a resident batch and pairs/s, the featurizer's host ms
            per batch (and for one rank's half of it, as each of two ranks
            builds), peak memory, one profiled step by category (the
            tied decoder's fp32 GEMMs apart) and the tied decoder's own
            forward and backward time.
15. scale-  (a) `cli/gqa_ood.py` for an epoch of 4 batches of 96 at full
    out     width (no validation), as it is and with --multiGPU
            --shard_opt_state: a world of one over NCCL, ZeRO-1 on; losses,
            parameters and BertAdam counters bit for bit those of the
            first run, kernels 2 and 3 launched 68 and 66 times a batch.
            (b) two ranks in processes of their own on the one card over
            gloo (NCCL takes one rank per device), batch 48 each of the
            global 96, dropout off and the GGM noise replayed: for the
            tree and the fused BertAdam, with and without ZeRO-1, the
            2-step trajectory against one rank at 96 (rank 0 runs it):
            the phases' losses (ggm_loss, clean_loss) within 1e-4
            relative, their terms printed, each parameter's update within
            phase 8's gradient gates, BertAdam's counters and flags
            exactly, kernels 1, 3 and 7 launched as derived; ms per global
            batch (no gain to claim: the ranks share the card). Then once
            in fp32 (tree BertAdam, ZeRO-1): every loss term within 1e-4
            relative, the same update gates, counters and launches. (c) the
            training model at 96, dropout on, with and without remat: a
            relation phase's loss within 1e-6 relative, its gradients
            within relative L2 1e-3; kernel 2 launched twice per
            attention under remat (136 a batch), kernel 3 66; ms per batch
            and peak memory each way, in turns.
16. model-  the stacked layout, tensor and pipeline parallelism at full
    para-   width, GCN, batch 96, dropout off, the GGM noise replayed, the
    llel    2-step plan from phase 8's weights: two ranks in processes of
            their own on the one card over gloo, rank 0 also running the
            one-rank references. (a) the stacked layout (`stacked_layers`,
            the weights stacked by `stack_encoder_flat`) against the
            per-layer run, tree and fused BertAdam, bf16 and once fp32:
            losses within 1e-5 relative, updates within phase 8's
            gradient gates (1e-4 relative L2 in fp32), each stacked leaf's
            counter and flag its layers', launches alike; ms per batch
            each way in turns and one tree update's device events. (b)
            TP (`model_parallel` 2, data group of 1; every fused qkv and
            FFN intermediate split): the same gates against the per-layer
            run (bf16: the phases' losses 1e-4; fp32: every loss term
            1e-5), the replicated parameters and moments bit-identical on
            both ranks, every rank launching what one rank launches, one
            eval forward's answers equal to one rank's (fp32); bytes of
            parameters and moments and the peak above them per rank. (c)
            PP (`--pp 2`, 4 microbatches) against (a)'s stacked run: the
            same gates, every parameter and moment bit-identical on both
            stages, kernels 1 and 3 launched per stage as derived (80 and
            80 a batch on stage 0, 192 and 184 on stage 1); with dropout
            on, the pipelined relation loss with remat within 1e-6 of the
            one without. (d) four ranks, TP 2 x PP 2 (`--composed-rank`),
            fp32, against the one-rank stacked run: (b)'s fp32 gates, the
            replicated state identical across each model group and all of
            it across each pipe group, (c)'s launches per stage on every
            model rank. Also whether gloo's send and recv take CUDA
            tensors (a two-process probe). ms per global batch: no gain to
            claim while the ranks share the card.
17. summary the kernels line (all seven kernels; kernels 1 to 3 with their
            trainer-phase, VQA-CP, served-artifact, GIN/GAT, pretraining,
            scale-out and model-parallel launches too, kernel 7 with its
            scale-out and model-parallel ones), the card's name and power
            limit, and last {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package. Without a CUDA card, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
# H100 SXM published peaks (dense): HBM bytes/s, bf16 FLOP/s on the tensor
# cores, fp32 FLOP/s outside them.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
SERVE_BATCHES = (1, 16, 64)
KERNEL_SOURCES = ("attention_fwd", "attention_dropout", "attention_blhd",
                  "bert_adam")
# The training path: attention-probability dropout 0.1 at the batch of the
# GQA-OOD recipe (96); a two-phase batch runs two forwards and two backwards.
RATE = 0.1
FWD_LAUNCHES_PER_BATCH = 2 * LAUNCHES_PER_FORWARD
# The clean phase's loss reads only the language stream, so the last
# x-layer's visual self-attention and visual->language cross-attention get
# no gradient, and autograd runs no backward for those two.
BWD_LAUNCHES_PER_BATCH = 2 * LAUNCHES_PER_FORWARD - 2
PLAN = ("relation", "representation", "relation", "representation")
TIMED_BATCHES = 10
T_TOTAL = 10_000
# One phase's loss and gradients through the kernels vs through the plain
# attention, same masks, no update. Kernels 2 and 3 differ from their plain
# versions by one bf16 ulp (their products sum in another order), carried
# through 19 layers: the relative L2 distance of the gradients over all
# parameters together, and the largest over single parameters whose plain
# gradient is nonzero. On an H100 80GB HBM3 (700 W), while kernel 2 still
# ran a scalar body that equalled its plain version bit for bit, the losses
# agreed exactly, and the gradients within 1.0e-3 to 1.4e-3 together and
# 1.2e-2 for the worst parameter (visn_fc's weight); with the tensor-core
# kernel 2 the losses within 2e-5 and the gradients within 2.5e-3 to
# 5.0e-3 together and 2.8e-2 for the worst parameter (visn_fc's weight).
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-2
PARAM_GRAD_RTOL = 5e-2
# Kernel 7 against its plain version, and the fused update against the tree
# update: the tolerances of tests/test_fused_optim.py (fp32 on both sides;
# the kernel rounds every operation as the plain version does).
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
UPDATES_PER_BATCH = 2
# The trainer phase: a synthetic GQA-OOD corpus written as feature packs,
# trained one epoch through the CLI at the recipe's batch (4 batches), then
# its test arm on the validation split.
TRAINER_TRAIN = dict(n_questions=384, n_images=64, seed=0)
TRAINER_VAL = dict(n_questions=192, n_images=32, seed=1)
TRAINER_SEED = 9595
FED_PASSES = 2  # feeder passes per timing turn of the trainer phase
# The VQA-CP phase: a synthetic corpus written as feature packs (4 batches
# of the recipe's 92 to train, 2 to test), an LXMERT pretraining snapshot
# over VQACP_PRE_ANSWERS answers of which VQACP_SHARED are the corpus's,
# and a resumed run held to the uninterrupted one within the tolerances of
# the train step's trajectory test (bit for bit expected: kernels 1 to 3
# use no atomics, and a step's draws come from its index).
VQACP_TRAIN = dict(n_questions=368, n_images=64, seed=0)
VQACP_TEST = dict(n_questions=184, n_images=32, seed=1)
VQACP_SEED = 9595
# The export-and-serve phase: int8 against bf16 at the JAX package's int8
# envelope (tests/test_serving.py): per-row relative L2 of the logits and
# argmax agreement.
INT8_REL_L2 = 0.05
SERVE_REQUESTS = 20
# Phase 10's BEST_0, four updates from random weights, answers the questions
# nearly alike: most of its bf16 top-1 margins lie below int8's error, so
# the share of answers int8 keeps there counts near-ties, and is printed.
# The answer gate reads a model whose answers follow its inputs: full width
# at 2/1/1 layers, trained from random weights with plain BCE (one clean
# update per batch) in fp32 on a corpus whose answer is planted in both
# modalities, as the JAX package's int8 accuracy test and
# tools/blind_parity.py plant it; then exported and served in bf16. At the
# full depth, or in bf16, no input-dependent answer was learnt within the
# run's budget. Its bf16 accuracy must show it learnt the task (chance is
# 1/16).
LEARN_DEPTH = ("2", "1", "1")
LEARN_EPOCHS, LEARN_LR = 64, 1e-4
LEARN_MIN_ACCURACY = 0.5
# The GIN and GAT phase: one batch of each branch, then timed batches.
GEN_PLAN = ("relation", "representation")
GEN_TIMED_BATCHES = 4
VQACP_PRE_ANSWERS, VQACP_SHARED = 9500, 1000
# The pretraining phase (scripts/pretrain.sh at full width): a TSV corpus
# of PRETRAIN_STEPS batches of 256 sentences to train (128 images x 6
# captions and 6 questions) and one to validate (32 x 4 x 2), an answer
# table of 9500; run A at batch 256, run B at batch 128 with two
# microbatches per update.
PRETRAIN_BS, PRETRAIN_STEPS, PRETRAIN_ANSWERS = 256, 6, 9500
PRETRAIN_SOURCES = {
    "mscoco_train": dict(n_images=128, sents_per_img=6, seed=0),
    "mscoco_minival": dict(n_images=32, sents_per_img=4, seed=1)}
PRETRAIN_RUNS = {"A": (PRETRAIN_BS, 1), "B": (PRETRAIN_BS // 2, 2)}
PRETRAIN_TIMED_STEPS = 4
RESUME_LOSS_RTOL, RESUME_PARAM_ATOL = 1e-4, 1e-5
# An update reads g, m, v, p and writes m, v, p: 28 bytes per fp32 element
# (24 where the gradient is null), and some 15 FLOPs.
ADAM_BYTES, ADAM_FLOPS = 28, 15


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA-event ms per call of `fn` over back-to-back calls. The garbage
    collector is off in the timed window, as timeit keeps it: a collection
    there, milliseconds long, would outweigh 20 calls of a host-bound
    wrapper."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The host's time per call of `fn` over back-to-back calls, without
    waiting for the device: what the wrapper costs before its launch is
    queued, the garbage collector off as in cuda_ms. CUDA events around the
    same calls read the larger of this and the device's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return ms


def device_ms(fn, bound_ms: float, iters: int = 20, warmup: int = 3,
              sessions: int = 8) -> dict:
    """The device's own time per call of `fn`: the durations of the device
    events that torch.profiler records over `iters` calls, summed and
    divided by `iters`, with each kernel's name and launches per call (the
    host's work between launches is not counted). Each session first runs
    `iters` calls with the tracer on and their events discarded (the
    profiler's warm-up step), then records `iters` calls: on an H100,
    sessions without that step recorded one kernel 19 times in 20 calls in
    eight sessions in a row, and none with it did. Some sessions still come
    back without device events, or with only some of them (5 to 19 of 20
    launches), at times three in a row, and one has read a kernel at a
    fifth of its bound; so a session in which any kernel ran a number of
    times that is not a positive multiple of `iters`, or whose time per
    call is under `bound_ms` (the least time of the call's work) by more
    than 5%, is repeated, up to `sessions` in all, and the run fails if
    none is whole and at or above the bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    refused = []
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us, counts = 0.0, {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                us += evt.time_range.elapsed_us()
                name = evt.name[:100]
                counts[name] = counts.get(name, 0) + 1
        whole = bool(counts) and all(n % iters == 0 for n in counts.values())
        plausible = us / 1e3 / iters * 1.05 >= bound_ms
        if whole and plausible:
            break
        refused.append(dict(ms=us / 1e3 / iters, launches=counts))
    if attempt > 1:
        emit("profiler_repeat", sessions=attempt, recorded=whole,
             at_or_above_bound=plausible, bound_ms=bound_ms, refused=refused)
    check(whole, f"torch.profiler recorded no whole session of {iters} "
                 f"calls in {sessions} sessions: {counts}")
    check(plausible, f"torch.profiler read {us / 1e3 / iters} ms a call, "
                     f"under the bound {bound_ms} ms by more than 5%: "
                     f"{counts}")
    return dict(ms=us / 1e3 / iters, method="torch.profiler",
                kernels_per_call={n: c / iters for n, c in counts.items()},
                sessions=attempt)


def ptxas_entries(log: str) -> dict:
    """Registers, spill bytes and stack of each entry function in nvcc's
    -Xptxas -v output, by mangled name."""
    import re

    entries, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = entries.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return entries


def bf16_kernels(builds, direction: str) -> list:
    """ptxas' registers and spills of the bf16 tensor-core kernels by key
    tiles of 16, direction "bwd" (kernels 3 and 6) or "fwd" (kernels 1, 2,
    4 and 5), as attention_dropout_bwd_bf16_kernel<n>."""
    import re

    rows = []
    for res in builds:
        for name, info in ptxas_entries(res.log).items():
            m = re.search(rf"(attention_[a-z_]*{direction}_bf16_kernel)"
                          r"ILi(\d)E", name)
            if m:
                rows.append(dict(kernel=f"{m.group(1)}<{m.group(2)}>",
                                 **info))
    return sorted(rows, key=lambda r: r["kernel"])


def scalar_forwards(builds) -> list:
    """The scalar forward kernels in the build logs (attention_fwd_kernel,
    attention_dropout_fwd_kernel, attention_blhd_fwd_kernel) with their
    mangled template arguments: "f" for fp32 (BLHD: "fLb0E" and "fLb1E",
    without and with dropout), "13__nv_bfloat16" for bf16."""
    import re

    found = []
    for res in builds:
        for name in ptxas_entries(res.log):
            m = re.search(
                r"(attention_(?:dropout_|blhd_)?fwd_kernel)I(.+?)EEv", name)
            if m:
                found.append(f"{m.group(1)}<{m.group(2)}>")
    return sorted(found)


def forward_resources(fwd_bf16: list, kernel: str, lq: int, lk: int) -> dict:
    """Registers, threads and dynamic shared memory of one launch of the
    bf16 forward `kernel` (as attention_dropout_fwd_bf16_kernel) at (lq,
    lk): the instantiation for its key tiles of 16."""
    name = f"{kernel}<{(lk + 15) // 16}>"
    info = next(r for r in fwd_bf16 if r["kernel"] == name)
    return dict(kernel=name, registers=info["registers"],
                threads=32 * ((lq + 15) // 16),
                dynamic_smem_bytes=bf16_forward_smem_bytes(lq, lk))


def check_own_mask(torch, draw, seed: int, keep, lq: int, lk: int,
                   dtype) -> dict:
    """A dropout forward's own mask. `draw(seed, dtype)` runs the kernel on
    q = k = 0, which makes every p 1 / Lk, and an identity v, which puts
    p * m of key j at o[..., j] (1.111 / Lk, positive in bf16 too), and
    returns o[..., :Lk] > 0 in flattened row order (row b * H + h). It must
    equal the Philox mask `keep` of `seed`, keep 0.9 +- 5 sigma of the
    scores, differ between rows and between seeds, and repeat for a seed."""
    drawn = draw(seed, dtype)
    n = drawn.numel()
    frac = float(drawn.float().mean())
    sigma = math.sqrt(0.9 * 0.1 / n)
    stats = dict(lq=lq, lk=lk, dtype=str(dtype).split(".")[1], draws=n,
                 keep_fraction=frac, keep_fraction_sigma=sigma,
                 equals_philox_mask=bool(torch.equal(drawn, keep > 0)),
                 rows_differ=not bool(torch.equal(drawn[0], drawn[1])),
                 seeds_differ=not bool(torch.equal(drawn,
                                                   draw(seed + 1, dtype))),
                 same_seed_same_mask=bool(torch.equal(drawn,
                                                      draw(seed, dtype))))
    where = f"{(lq, lk)} {stats['dtype']}"
    check(abs(frac - 0.9) <= 5 * sigma,
          f"keep fraction {frac} at {where}: not within 0.9 +- 5 sigma")
    for key in ("equals_philox_mask", "rows_differ", "seeds_differ",
                "same_seed_same_mask"):
        check(stats[key], f"dropout mask at {where}: {key} is False")
    return stats


def bf16_backward_smem_bytes(lq: int, lk: int) -> int:
    """Dynamic shared memory of one bf16 backward block, as the launch asks
    for it (attention_common.cuh, backward_bf16_smem_bytes)."""
    import ctypes

    from xggm_tpu_torch.ops import build

    fn = build.load("attention_dropout").xggm_attention_bwd_bf16_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_size_t
    return int(fn(lq, lk))


def bf16_forward_smem_bytes(lq: int, lk: int) -> int:
    """Dynamic shared memory of one bf16 forward block, as the launch asks
    for it (attention_common.cuh, forward_bf16_smem_bytes)."""
    import ctypes

    from xggm_tpu_torch.ops import build

    fn = build.load("attention_fwd").xggm_attention_fwd_bf16_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_size_t
    return int(fn(lq, lk))


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(least ms, "bytes" or "operations"): the bytes over HBM bandwidth
    against the FLOPs at `peak` (the bf16 peak unless said); the larger
    bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def pass_bounds(lq: int, lk: int, masked: bool, b: int, elem: int):
    """Bounds of one forward (kernels 2 and 5) and one backward (kernels 3
    and 6) at batch b: q, k, v (and g) read once, o (dq, dk, dv) written
    once, the bias read once; 4 and 10 B H Lq Lk D FLOPs."""
    bh = b * H
    bias_bytes = 4 * b * lk if masked else 0
    return (bound(elem * bh * D * (2 * lq + 2 * lk) + bias_bytes,
                  4 * bh * lq * lk * D),
            bound(elem * bh * D * (3 * lq + 4 * lk) + bias_bytes,
                  10 * bh * lq * lk * D))


def attention_bound(lq: int, lk: int, masked: bool, elem: int):
    """Kernel 1 at B=512: each input byte read once and each output byte
    written once, against 4 B H Lq Lk D FLOPs."""
    bh = B * H
    nbytes = elem * bh * D * (2 * lq + 2 * lk) + (4 * B * lk if masked else 0)
    return bound(nbytes, 4 * bh * lq * lk * D)


def within(got, want, tol) -> bool:
    err = (got.float() - want.float()).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


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
            q4, k4, v4 = (t.view(B, H, -1, D) for t in (q, k, v))
            mask4 = None if bias is None else \
                bias.to(torch.bfloat16)[:, None, None, :]
            row = dict(
                lq=lq, lk=lk, mask=masked, dtype="bfloat16",
                max_abs_err=max_err(got, want), tolerance=BF16_TOL,
                within_tolerance=within(got, want, BF16_TOL),
                kernel_ms=cuda_ms(lambda: attn.fused_attention(q, k, v, bias, H)),
                plain_ms=cuda_ms(lambda: attn.attention_reference(q, k, v, bias, H)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4)))
            row["bound_ms"], row["bound_by"] = attention_bound(lq, lk, masked, 2)
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["dynamic_smem_bytes"] = bf16_forward_smem_bytes(lq, lk)
            row["on_path"] = masked == path_masked
            row["launches_per_forward"] = per_fwd if row["on_path"] else 0
            if row["on_path"]:
                # the device's own time, without the wrapper's host work
                # between back-to-back calls
                dev = device_ms(lambda: attn.fused_attention(q, k, v, bias, H),
                                row["bound_ms"])
                lib = device_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4), row["bound_ms"])
                row.update(
                    kernel_device_ms=dev["ms"], library_device_ms=lib["ms"],
                    device_time_method=dev["method"],
                    kernel_host_ms=host_ms(
                        lambda: attn.fused_attention(q, k, v, bias, H)),
                    kernel_device_kernels=dev["kernels_per_call"],
                    library_device_kernels=lib["kernels_per_call"],
                    device_bound_share=row["bound_ms"] / dev["ms"])
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
    ok = within(got, want, FP32_TOL)
    # the same function in float64: how far both fp32 versions are from it
    s64 = (q.double() @ k.double().transpose(-1, -2) / 8.0
           + bias.double().repeat_interleave(H, dim=0)[:, None, :])
    exact = torch.softmax(s64, dim=-1) @ v.double()
    emit("kernel", lq=36, lk=36, mask=True, dtype="float32",
         max_abs_err=max_err(got, want), tolerance=FP32_TOL,
         within_tolerance=ok,
         kernel_max_abs_err_vs_float64=float((got.double() - exact).abs().max()),
         plain_max_abs_err_vs_float64=float((want.double() - exact).abs().max()))
    check(ok, f"fp32 attention kernel vs plain: max abs err "
              f"{max_err(got, want)}")
    return rows


def library_padded_bias(F, mask4, b, lq, lk):
    """The library's bias [B, H, Lq, Lk] with rows padded to 16 elements,
    as SDPA pads it (None: no mask)."""
    if mask4 is None:
        return None
    return F.pad(mask4.expand(b, H, lq, lk), (0, -lk % 16))[..., :lk]


def library_backward(torch, q4, k4, v4, g4, lib_bias, rate: float):
    """The memory-efficient attention's backward alone, as a function of no
    arguments: fed its own forward's output, log-sum-exp and Philox state
    (its own RNG: timing only), at dropout_p `rate`."""
    out, lse, pseed, poff = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, lib_bias, True, rate)

    def run():
        torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            g4, q4, k4, v4, lib_bias, out, lse, pseed, poff, rate,
            [True, True, True, False])

    return run


def float64_grads(q, k, v, bias, keep, g):
    """(dq, dk, dv) of the dropout attention in float64."""
    import torch

    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / 8.0
    if bias is not None:
        s = s + bias.double().repeat_interleave(H, dim=0)[:, None, :]
    o = (torch.softmax(s, dim=-1) * keep.double()) @ v
    return torch.autograd.grad(o, (q, k, v), g.double())


def phase_dropout(torch, attn, philox, train_b: int, fwd_bf16: list):
    """Kernels 2 and 3 and kernel 1's backward at the training batch;
    fwd_bf16: the bf16 forward kernels' ptxas rows."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bh = train_b * H
    rows = []
    for lq, lk, masked, per_fwd in PATH_SHAPES:
        seed = 1000 * lq + lk
        keep = philox.dropout_keep(seed, bh, lq, lk, RATE, "cuda")

        def plain_keep():
            return philox.dropout_keep(seed, bh, lq, lk, RATE, "cuda")

        for dtype in (torch.bfloat16, torch.float32):
            tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            q, k, v, gout = (
                torch.randn(bh, n, D, device="cuda", generator=g).to(dtype)
                for n in (lq, lk, lk, lq))
            bias = None
            if masked:
                bias = (torch.rand(train_b, lk, device="cuda", generator=g)
                        < 0.2).float() * -10000.0
            o = attn.attention_dropout_fwd(q, k, v, bias, H, seed, RATE)
            grads = attn.attention_dropout_bwd(q, k, v, bias, H, seed, RATE,
                                               gout)
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            k1_grads = torch.autograd.grad(
                attn.fused_attention(*qkv, bias, H), qkv, gout)
            torch.cuda.synchronize()
            # the plain forward fed the Philox mask; torch.autograd.grad
            # through it, on fp32 copies for bf16 (the kernels' backward
            # computes in fp32 and rounds its outputs once)
            want_o = attn.attention_dropout_reference(q, k, v, bias, H, keep)
            want = attn.attention_dropout_reference_grads(q, k, v, bias, H,
                                                          keep, gout)
            want_k1 = attn.attention_dropout_reference_grads(q, k, v, bias, H,
                                                             None, gout)
            row = dict(
                lq=lq, lk=lk, mask=masked, dtype=str(dtype).split(".")[1],
                tolerance=tol, launches_per_forward=per_fwd,
                fwd_max_abs_err=max_err(o, want_o),
                fwd_within=within(o, want_o, tol),
                bwd_max_abs_err=max(max_err(a, w) for a, w in zip(grads, want)),
                bwd_within=all(within(a, w, tol) for a, w in zip(grads, want)),
                k1_bwd_max_abs_err=max(max_err(a, w)
                                       for a, w in zip(k1_grads, want_k1)),
                k1_bwd_within=all(within(a, w, tol)
                                  for a, w in zip(k1_grads, want_k1)))
            if dtype == torch.float32:
                # how far both fp32 versions are from float64
                exact = float64_grads(q, k, v, bias, keep, gout)
                row.update(
                    bwd_kernel_max_abs_err_vs_float64=max(
                        max_err(a, w) for a, w in zip(grads, exact)),
                    bwd_plain_max_abs_err_vs_float64=max(
                        max_err(a, w) for a, w in zip(want, exact)))
            else:
                q4, k4, v4, g4 = (t.view(train_b, H, -1, D)
                                  for t in (q, k, v, gout))
                mask4 = None if bias is None else \
                    bias.to(dtype)[:, None, None, :]
                r4 = [t.clone().requires_grad_() for t in (q4, k4, v4)]

                def sdpa_fwd_bwd():
                    out = F.scaled_dot_product_attention(
                        *r4, attn_mask=mask4, dropout_p=RATE)
                    torch.autograd.grad(out, r4, g4)

                lib_bias = library_padded_bias(F, mask4, train_b, lq, lk)
                library_bwd = library_backward(torch, q4, k4, v4, g4,
                                               lib_bias, RATE)
                library_bwd0 = library_backward(torch, q4, k4, v4, g4,
                                                lib_bias, 0.0)
                fwd_bound, bwd_bound = pass_bounds(lq, lk, masked, train_b, 2)
                row.update(
                    fwd_ms=cuda_ms(lambda: attn.attention_dropout_fwd(
                        q, k, v, bias, H, seed, RATE)),
                    bwd_ms=cuda_ms(lambda: attn.attention_dropout_bwd(
                        q, k, v, bias, H, seed, RATE, gout)),
                    k1_bwd_ms=cuda_ms(lambda: attn.attention_dropout_bwd(
                        q, k, v, bias, H, 0, 0.0, gout)),
                    mask_ms=cuda_ms(plain_keep),
                    plain_fwd_ms=cuda_ms(lambda: attn.attention_dropout_reference(
                        q, k, v, bias, H, plain_keep())),
                    plain_bwd_ms=cuda_ms(
                        lambda: attn.attention_dropout_reference_grads(
                            q, k, v, bias, H, plain_keep(), gout)),
                    sdpa_fwd_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4, dropout_p=RATE)),
                    sdpa_fwd_bwd_ms=cuda_ms(sdpa_fwd_bwd),
                    library_bwd_ms=cuda_ms(library_bwd),
                    k1_library_bwd_ms=cuda_ms(library_bwd0),
                    fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                    bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
                row["fwd_bound_share"] = row["fwd_bound_ms"] / row["fwd_ms"]
                row["bwd_bound_share"] = row["bwd_bound_ms"] / row["bwd_ms"]
                # the kernels' own device time, without the wrappers' host
                # work between back-to-back calls
                dev = {key: device_ms(fn, least[0]) for key, fn, least in (
                    ("fwd", lambda: attn.attention_dropout_fwd(
                        q, k, v, bias, H, seed, RATE), fwd_bound),
                    ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4, dropout_p=RATE),
                     fwd_bound),
                    ("bwd", lambda: attn.attention_dropout_bwd(
                        q, k, v, bias, H, seed, RATE, gout), bwd_bound),
                    ("k1_bwd", lambda: attn.attention_dropout_bwd(
                        q, k, v, bias, H, 0, 0.0, gout), bwd_bound),
                    ("library_bwd", library_bwd, bwd_bound),
                    ("k1_library_bwd", library_bwd0, bwd_bound))}
                row.update({f"{key}_device_ms": d["ms"]
                            for key, d in dev.items()})
                row.update(
                    fwd_host_ms=host_ms(lambda: attn.attention_dropout_fwd(
                        q, k, v, bias, H, seed, RATE)),
                    fwd_device_bound_share=(row["fwd_bound_ms"]
                                            / row["fwd_device_ms"]),
                    bwd_host_ms=host_ms(lambda: attn.attention_dropout_bwd(
                        q, k, v, bias, H, seed, RATE, gout)),
                    device_time_method=dev["bwd"]["method"],
                    bwd_device_kernels=dev["bwd"]["kernels_per_call"],
                    library_bwd_device_kernels=dev["library_bwd"][
                        "kernels_per_call"],
                    bwd_device_bound_share=(row["bwd_bound_ms"]
                                            / row["bwd_device_ms"]),
                    bwd_threads=32 * ((lq + 15) // 16),
                    bwd_dynamic_smem_bytes=bf16_backward_smem_bytes(lq, lk),
                    fwd_resources=forward_resources(
                        fwd_bf16, "attention_dropout_fwd_bf16_kernel", lq,
                        lk))
            emit("dropout", **row)
            rows.append(row)

        # the kernel's own mask, in both bodies (bf16 and fp32)
        def kernel_mask(s, dtype):
            zq = torch.zeros(bh, lq, D, device="cuda", dtype=dtype)
            zk = torch.zeros(bh, lk, D, device="cuda", dtype=dtype)
            eye = torch.eye(lk, D, device="cuda", dtype=dtype).expand(
                bh, lk, D).contiguous()
            return attn.attention_dropout_fwd(zq, zk, eye, None, H, s,
                                              RATE)[..., :lk] > 0

        for dtype in (torch.bfloat16, torch.float32):
            emit("dropout_mask", **check_own_mask(torch, kernel_mask, seed,
                                                  keep, lq, lk, dtype))

    for key in ("fwd_within", "bwd_within", "k1_bwd_within"):
        bad = [(r["lq"], r["lk"], r["dtype"]) for r in rows if not r[key]]
        check(not bad, f"dropout phase {key} failed at {bad}")
    return rows


def phase_blhd(torch, attn, philox, train_b: int, fwd_bf16: list):
    """Kernels 4, 5 and 6 at the training batch, in the BLHD layout;
    fwd_bf16: the bf16 forward kernels' ptxas rows."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bh = train_b * H

    def rows_of(x):  # [B, L, H, n] -> [B * H, L, n]
        return x.transpose(1, 2).reshape(bh, x.shape[1], x.shape[3])

    def blhd_of(x):  # [B * H, L, n] -> [B, L, H, n]
        return x.view(train_b, H, x.shape[1], x.shape[2]).transpose(1, 2)

    def inputs(lq, lk, masked, dtype):
        q, k, v, gout = (
            torch.randn(train_b, n, H, D, device="cuda", generator=g).to(dtype)
            for n in (lq, lk, lk, lq))
        bias = None
        if masked:
            bias = (torch.rand(train_b, lk, device="cuda", generator=g)
                    < 0.2).float() * -10000.0
        return q, k, v, bias, gout

    rows = []
    for lq, lk, masked, per_fwd in PATH_SHAPES:
        seed = 3000 * lq + lk
        keep = philox.dropout_keep(seed, bh, lq, lk, RATE, "cuda")

        def plain_keep():
            return philox.dropout_keep(seed, bh, lq, lk, RATE, "cuda")

        for dtype in (torch.bfloat16, torch.float32):
            tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
            q, k, v, bias, gout = inputs(lq, lk, masked, dtype)
            ours = [attn._attention_blhd_fwd(q, k, v, bias),
                    attn.attention_dropout_blhd_fwd(q, k, v, bias, seed,
                                                    RATE),
                    *attn.attention_dropout_blhd_bwd(q, k, v, bias, seed,
                                                     RATE, gout),
                    *attn.attention_dropout_blhd_bwd(q, k, v, bias, 0, 0.0,
                                                     gout)]
            # kernels 1 to 3 on the permuted inputs, the same seed
            qf, kf, vf, gf = (rows_of(t).contiguous()
                              for t in (q, k, v, gout))
            flat = [attn._attention_fwd(qf, kf, vf, bias, H),
                    attn.attention_dropout_fwd(qf, kf, vf, bias, H, seed,
                                               RATE),
                    *attn.attention_dropout_bwd(qf, kf, vf, bias, H, seed,
                                                RATE, gf),
                    *attn.attention_dropout_bwd(qf, kf, vf, bias, H, 0, 0.0,
                                                gf)]
            torch.cuda.synchronize()
            plain = [attn.attention_blhd_reference(q, k, v, bias),
                     attn.attention_dropout_blhd_reference(q, k, v, bias,
                                                           keep),
                     *attn.attention_dropout_blhd_reference_grads(
                         q, k, v, bias, keep, gout),
                     *attn.attention_dropout_blhd_reference_grads(
                         q, k, v, bias, None, gout)]
            errs = [max_err(a, w) for a, w in zip(ours, plain)]
            row = dict(
                lq=lq, lk=lk, mask=masked, dtype=str(dtype).split(".")[1],
                tolerance=tol, launches_per_forward=per_fwd,
                k4_max_abs_err=errs[0], k5_max_abs_err=errs[1],
                k6_max_abs_err=max(errs[2:5]),
                k6_rate0_max_abs_err=max(errs[5:]),
                within=all(within(a, w, tol) for a, w in zip(ours, plain)),
                vs_kernels_1_to_3_max_abs_err=max(
                    max_err(a, blhd_of(w)) for a, w in zip(ours, flat)),
                vs_kernels_1_to_3_within_one_bf16_ulp=all(
                    within(a, blhd_of(w), BF16_TOL)
                    for a, w in zip(ours, flat)))
            if dtype == torch.bfloat16:
                # the library on strided [B, H, L, D] views of the same
                # BLHD storage: no copy
                q4, k4, v4, g4 = (t.transpose(1, 2) for t in (q, k, v, gout))
                mask4 = None if bias is None else \
                    bias.to(dtype)[:, None, None, :]
                library_bwd = library_backward(
                    torch, q4, k4, v4, g4,
                    library_padded_bias(F, mask4, train_b, lq, lk), RATE)
                fwd_bound, bwd_bound = pass_bounds(lq, lk, masked, train_b, 2)
                row.update(
                    k4_ms=cuda_ms(lambda: attn._attention_blhd_fwd(
                        q, k, v, bias)),
                    k5_ms=cuda_ms(lambda: attn.attention_dropout_blhd_fwd(
                        q, k, v, bias, seed, RATE)),
                    k6_ms=cuda_ms(lambda: attn.attention_dropout_blhd_bwd(
                        q, k, v, bias, seed, RATE, gout)),
                    k4_bwd_ms=cuda_ms(lambda: attn.attention_dropout_blhd_bwd(
                        q, k, v, bias, 0, 0.0, gout)),
                    plain_k4_ms=cuda_ms(lambda: attn.attention_blhd_reference(
                        q, k, v, bias)),
                    plain_k5_ms=cuda_ms(
                        lambda: attn.attention_dropout_blhd_reference(
                            q, k, v, bias, plain_keep())),
                    plain_k6_ms=cuda_ms(
                        lambda: attn.attention_dropout_blhd_reference_grads(
                            q, k, v, bias, plain_keep(), gout)),
                    sdpa_fwd_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4)),
                    sdpa_dropout_fwd_ms=cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask4, dropout_p=RATE)),
                    library_bwd_ms=cuda_ms(library_bwd),
                    fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                    bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
                dev = {key: device_ms(fn, least[0]) for key, fn, least in (
                    ("k4", lambda: attn._attention_blhd_fwd(q, k, v, bias),
                     fwd_bound),
                    ("k5", lambda: attn.attention_dropout_blhd_fwd(
                        q, k, v, bias, seed, RATE), fwd_bound),
                    ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4), fwd_bound),
                    ("sdpa_dropout_fwd", lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask4, dropout_p=RATE),
                     fwd_bound),
                    ("k6", lambda: attn.attention_dropout_blhd_bwd(
                        q, k, v, bias, seed, RATE, gout), bwd_bound),
                    ("k4_bwd", lambda: attn.attention_dropout_blhd_bwd(
                        q, k, v, bias, 0, 0.0, gout), bwd_bound),
                    ("library_bwd", library_bwd, bwd_bound))}
                row.update({f"{key}_device_ms": d["ms"]
                            for key, d in dev.items()})
                row.update(k4_host_ms=host_ms(
                               lambda: attn._attention_blhd_fwd(
                                   q, k, v, bias)),
                           k4_device_bound_share=(row["fwd_bound_ms"]
                                                  / row["k4_device_ms"]),
                           k6_host_ms=host_ms(
                               lambda: attn.attention_dropout_blhd_bwd(
                                   q, k, v, bias, seed, RATE, gout)),
                           device_time_method=dev["k6"]["method"],
                           k6_device_bound_share=(row["bwd_bound_ms"]
                                                  / row["k6_device_ms"]),
                           k5_resources=forward_resources(
                               fwd_bf16,
                               "attention_blhd_dropout_fwd_bf16_kernel", lq,
                               lk))
            emit("blhd", **row)
            rows.append(row)

        # kernel 5's own mask, in both bodies, read out at o[b, i, h, j]
        # and compared in the flattened order of rows b * H + h
        def kernel_mask(s, dtype):
            zq = torch.zeros(train_b, lq, H, D, device="cuda", dtype=dtype)
            zk = torch.zeros(train_b, lk, H, D, device="cuda", dtype=dtype)
            eye = torch.eye(lk, D, device="cuda", dtype=dtype)[
                None, :, None, :].expand(train_b, lk, H, D).contiguous()
            return rows_of(attn.attention_dropout_blhd_fwd(
                zq, zk, eye, None, s, RATE)[..., :lk] > 0)

        for dtype in (torch.bfloat16, torch.float32):
            stats = check_own_mask(torch, kernel_mask, seed, keep, lq, lk,
                                   dtype)
            emit("blhd_mask", **stats,
                 equals_philox_mask_of_row_b_times_h_plus_h=stats[
                     "equals_philox_mask"])

    bad = [(r["lq"], r["lk"], r["dtype"]) for r in rows if not r["within"]]
    check(not bad, f"kernels 4 to 6 vs their plain versions failed at {bad}")
    bad = [(r["lq"], r["lk"], r["dtype"], r["vs_kernels_1_to_3_max_abs_err"])
           for r in rows if not r["vs_kernels_1_to_3_within_one_bf16_ulp"]]
    check(not bad, f"kernels 4 to 6 vs kernels 1 to 3 on the permuted "
                   f"inputs, more than one bf16 ulp apart: {bad}")

    # the main path of kernels 4 to 6, their entry points: mha_blhd and
    # mha_dropout_blhd forward and backward at each shape as often as a
    # training forward attends there; counts at 0 just before, read after
    path = [(inputs(lq, lk, masked, torch.bfloat16), per_fwd)
            for lq, lk, masked, per_fwd in PATH_SHAPES]
    counters = {"attention_blhd_fwd": attn.fused_attention_blhd,
                "attention_dropout_blhd_fwd": attn.attention_dropout_blhd_fwd,
                "attention_dropout_blhd_bwd": attn.attention_dropout_blhd_bwd}
    for c in counters.values():
        c.launches = 0
    for (q, k, v, bias, gout), per_fwd in path:
        for i in range(per_fwd):
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(attn.mha_blhd(*qkv, bias), qkv, gout)
            torch.autograd.grad(attn.mha_dropout_blhd(*qkv, bias, 100 + i,
                                                      RATE), qkv, gout)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    emit("blhd_path", launches=launches,
         calls="mha_blhd and mha_dropout_blhd, forward and backward, "
               f"{LAUNCHES_PER_FORWARD} times each at B={train_b}, bf16")
    want = {"attention_blhd_fwd": LAUNCHES_PER_FORWARD,
            "attention_dropout_blhd_fwd": LAUNCHES_PER_FORWARD,
            "attention_dropout_blhd_bwd": 2 * LAUNCHES_PER_FORWARD}
    check(launches == want, f"BLHD launches {launches}, expected {want}")
    return rows, launches


def emit_backward_device(drop_rows, blhd_rows, train_b: int) -> None:
    """Kernels 3 and 6 and the library backward per pass of the path's 34
    launches at the training batch in bf16: CUDA events around back-to-back
    calls (the wrapper's host work included) and the device's own time,
    against the bound."""
    drop = [r for r in drop_rows if "bwd_device_ms" in r]
    blhd = [r for r in blhd_rows if "k6_device_ms" in r]

    def per_pass(key, table):
        return sum(r[key] * r["launches_per_forward"] for r in table)

    bound_ms = per_pass("bwd_bound_ms", drop)
    keys = {"k3_ms": ("bwd_ms", drop),
            "k3_device_ms": ("bwd_device_ms", drop),
            "k3_host_ms": ("bwd_host_ms", drop),
            "k3_rate0_ms": ("k1_bwd_ms", drop),
            "k3_rate0_device_ms": ("k1_bwd_device_ms", drop),
            "library_bwd_ms": ("library_bwd_ms", drop),
            "library_bwd_device_ms": ("library_bwd_device_ms", drop),
            "library_bwd_rate0_ms": ("k1_library_bwd_ms", drop),
            "library_bwd_rate0_device_ms": ("k1_library_bwd_device_ms", drop),
            "k6_ms": ("k6_ms", blhd),
            "k6_device_ms": ("k6_device_ms", blhd),
            "k6_host_ms": ("k6_host_ms", blhd),
            "k6_rate0_device_ms": ("k4_bwd_device_ms", blhd),
            "library_bwd_blhd_ms": ("library_bwd_ms", blhd),
            "library_bwd_blhd_device_ms": ("library_bwd_device_ms", blhd)}
    passes = {name: per_pass(key, table)
              for name, (key, table) in keys.items()}
    emit("backward_device", per_pass=passes, bound_ms=bound_ms,
         share_of_bound={name: bound_ms / ms for name, ms in passes.items()
                         if "host" not in name},
         method=drop[0]["device_time_method"],
         over=f"one training backward's {LAUNCHES_PER_FORWARD} launches at "
              f"B={train_b}, bf16; *_ms: CUDA events around back-to-back "
              "calls, *_device_ms: the device's own time, *_host_ms: the "
              "host's time per wrapper call")


def emit_forward_device(rows, drop_rows, blhd_rows, train_b: int) -> None:
    """The forward kernels (1, 2, 4 and 5) and the library's forward per
    pass of the path's 34 launches in bf16: kernel 1 and SDPA per served
    forward at B = 512, kernels 2, 4 and 5 and SDPA per training forward at
    the training batch; CUDA events around back-to-back calls (the
    wrapper's host work included) and the device's own time, against the
    bound."""
    path = [r for r in rows if "kernel_device_ms" in r]
    drop = [r for r in drop_rows if "fwd_device_ms" in r]
    blhd = [r for r in blhd_rows if "k4_device_ms" in r]

    def per_pass(key, table):
        return sum(r[key] * r["launches_per_forward"] for r in table)

    def report(bound_ms, keys, over):
        passes = {name: per_pass(key, table)
                  for name, (key, table) in keys.items()}
        return dict(per_pass=passes, bound_ms=bound_ms,
                    share_of_bound={name: bound_ms / ms
                                    for name, ms in passes.items()
                                    if "host" not in name},
                    over=over)

    served = report(per_pass("bound_ms", path), {
        "k1_ms": ("kernel_ms", path),
        "k1_device_ms": ("kernel_device_ms", path),
        "k1_host_ms": ("kernel_host_ms", path),
        "library_ms": ("library_ms", path),
        "library_device_ms": ("library_device_ms", path)},
        f"one served forward's {LAUNCHES_PER_FORWARD} launches at B={B}")
    training = report(per_pass("fwd_bound_ms", drop), {
        "k2_ms": ("fwd_ms", drop),
        "k2_device_ms": ("fwd_device_ms", drop),
        "k2_host_ms": ("fwd_host_ms", drop),
        "library_dropout_ms": ("sdpa_fwd_ms", drop),
        "library_dropout_device_ms": ("sdpa_fwd_device_ms", drop),
        "k4_ms": ("k4_ms", blhd),
        "k4_device_ms": ("k4_device_ms", blhd),
        "k4_host_ms": ("k4_host_ms", blhd),
        "k5_ms": ("k5_ms", blhd),
        "k5_device_ms": ("k5_device_ms", blhd),
        "library_blhd_ms": ("sdpa_fwd_ms", blhd),
        "library_blhd_device_ms": ("sdpa_fwd_device_ms", blhd),
        "library_dropout_blhd_ms": ("sdpa_dropout_fwd_ms", blhd),
        "library_dropout_blhd_device_ms": ("sdpa_dropout_fwd_device_ms",
                                           blhd)},
        f"one training forward's {LAUNCHES_PER_FORWARD} launches at "
        f"B={train_b}; library_*: SDPA, *_blhd on strided views of the "
        "BLHD tensors, *_dropout at dropout_p 0.1")
    emit("forward_device", served=served, training=training,
         method=path[0]["device_time_method"],
         times="*_ms: CUDA events around back-to-back calls, *_device_ms: "
               "the device's own time, *_host_ms: the host's time per "
               "wrapper call")


def forward_device_of(root: str) -> int:
    """`python3 chip_smoke.py --forward-device ROOT`: the device ms per pass
    of 34 launches of the forward kernels 1, 2, 4 and 5 in bf16 and of
    SDPA's forward in each layout, under the names of the forward_device
    line, for the package of the checkout at ROOT, printed as one JSON line
    with the card and the device us per launch by shape. It calls only the
    wrappers that every checkout from the BLHD kernels on has, and checks
    nothing but the bounds, so a checkout older than this script can be
    timed too: run on two checkouts in turns in one call, it compares their
    forwards on one card."""
    import os

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from xggm_tpu_torch.config import gqa_ood_config
    from xggm_tpu_torch.ops import attention as attn

    check(attn.__file__.startswith(root + os.sep),
          f"imported {attn.__file__}, not the package under {root}")
    train_b = gqa_ood_config().train.batch_size
    g = torch.Generator(device="cuda").manual_seed(SEED)
    per_pass, bounds = {}, {"served": 0.0, "training": 0.0}
    per_launch = {f"{lq}x{lk}": {} for lq, lk, _, _ in PATH_SHAPES}
    for lq, lk, masked, per_fwd in PATH_SHAPES:
        seed = 1000 * lq + lk
        for b, blhd in ((B, False), (train_b, False), (train_b, True)):
            q, k, v = (torch.randn(*((b, n, H, D) if blhd else (b * H, n, D)),
                                   device="cuda", generator=g)
                       .to(torch.bfloat16) for n in (lq, lk, lk))
            bias = None
            if masked:
                bias = (torch.rand(b, lk, device="cuda", generator=g)
                        < 0.2).float() * -10000.0
            q4, k4, v4 = (t.transpose(1, 2) if blhd else t.view(b, H, -1, D)
                          for t in (q, k, v))
            mask4 = None if bias is None else \
                bias.to(torch.bfloat16)[:, None, None, :]
            least = pass_bounds(lq, lk, masked, b, 2)[0][0]

            def sdpa(rate=0.0):
                return F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4, dropout_p=rate)

            if b == B:
                bounds["served"] += least * per_fwd
                timed = (("k1", lambda: attn.fused_attention(q, k, v, bias,
                                                             H)),
                         ("library", sdpa))
            elif not blhd:
                bounds["training"] += least * per_fwd
                timed = (("k2", lambda: attn.attention_dropout_fwd(
                              q, k, v, bias, H, seed, RATE)),
                         ("library_dropout", lambda: sdpa(RATE)))
            else:
                timed = (("k4", lambda: attn._attention_blhd_fwd(q, k, v,
                                                                 bias)),
                         ("k5", lambda: attn.attention_dropout_blhd_fwd(
                             q, k, v, bias, seed, RATE)),
                         ("library_blhd", sdpa),
                         ("library_dropout_blhd", lambda: sdpa(RATE)))
            for name, fn in timed:
                key = f"{name}_device_ms"
                ms = device_ms(fn, least)["ms"]
                per_pass[key] = per_pass.get(key, 0.0) + ms * per_fwd
                per_launch[f"{lq}x{lk}"][f"{name}_device_us"] = ms * 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    emit("forward_device_of", root=root, package=os.path.dirname(
             os.path.dirname(attn.__file__)),
         card=smi.stdout.strip().splitlines()[0], per_pass=per_pass,
         bound_ms=bounds, per_launch=per_launch,
         over=f"k1 and library: one served forward's {LAUNCHES_PER_FORWARD} "
              f"launches at B={B}; the others one training forward's at "
              f"B={train_b}; bf16, torch.profiler's device time")
    return 0


def grad_agreement(torch, names, kernels, plain, apart=(),
                   watch=()) -> dict:
    """Relative L2 distance of two gradient lists (None: outside the
    graph): over all parameters together, and the largest over single
    parameters whose plain gradient is nonzero. The parameters named in
    `apart` are left out of that largest; those and the ones in `watch` are
    each measured on their own and against the norm of the generator's
    whole gradient."""
    same_graph = all((a is None) == (b is None)
                     for a, b in zip(kernels, plain))
    pairs = [(n, a.float(), b.float()) for n, a, b in zip(names, kernels, plain)
             if a is not None and b is not None]
    diff = torch.stack([(a - b).norm() for _, a, b in pairs])
    norm = torch.stack([b.norm() for _, _, b in pairs])
    rel = torch.where(norm > 0, diff / norm, 0.0)
    own = torch.tensor([n not in apart for n, _, _ in pairs],
                       device=rel.device)
    worst = int(torch.where(own, rel, -1.0).argmax())
    gen = torch.tensor([n.startswith("generator.") for n, _, _ in pairs],
                       device=rel.device)
    gen_norm = norm[gen].norm()
    return dict(same_graph=same_graph, params_with_grad=len(pairs),
                grad_rel_l2=float(diff.norm() / norm.norm()),
                max_param_grad_rel_l2=float(rel[worst]),
                worst_param=pairs[worst][0],
                median_param_grad_rel_l2=float(rel[norm > 0].median()),
                apart=list(apart),
                named={n: dict(rel_l2=float(rel[i]),
                               rel_to_generator_grad=float(diff[i]
                                                           / gen_norm))
                       for i, (n, _, _) in enumerate(pairs)
                       if n in apart or n in watch})


def train_setup(torch, fused: bool, gnn: str = "GCN",
                dtype: str = "bfloat16", dropout: bool = True):
    """The full-width training model with the generator `gnn`, computing in
    `dtype`, BertAdam (`fused`: kernel 7), its state, the two branch steps
    and one synthetic batch of 96; `dropout` False sets the hidden,
    attention and generator dropout to 0."""
    from dataclasses import replace
    from types import SimpleNamespace

    from xggm_tpu_torch.config import gqa_ood_config
    from xggm_tpu_torch.data.synthetic import synthetic_train_batch
    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.ops.basic import init_weights
    from xggm_tpu_torch.training.bert_adam import BertAdam, lr_scale_tree
    from xggm_tpu_torch.training.steps import TrainState, make_ggm_train_step

    cfg = gqa_ood_config()
    cfg = cfg.replace(ggm=replace(cfg.ggm, gnn=gnn))
    if not dropout:
        cfg = cfg.replace(
            lxmert=cfg.lxmert.replace(bert=replace(
                cfg.lxmert.bert, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)),
            ggm=replace(cfg.ggm, dropout=0.0))
    lx, tc = cfg.lxmert.replace(dtype=dtype), cfg.train
    train_b = tc.batch_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_weights(
        XGGMModel(lx, cfg.num_answers, cfg.ggm, device="cuda"), gen)
    names = [n for n, _ in model.named_parameters()]
    mult = tc.downstream_lr_mult

    def make_opt(fused_opt: bool) -> BertAdam:
        return BertAdam(tc.lr * mult, warmup=tc.warmup, t_total=T_TOTAL,
                        weight_decay=tc.weight_decay,
                        lr_scale=lr_scale_tree(
                            names, lambda n: not n.startswith("lxrt."), 1.0,
                            1.0 / mult), fused=fused_opt)

    opt = make_opt(fused)
    state = TrainState.create(model, opt)
    steps = {br: make_ggm_train_step(model, opt, tc, br)
             for br in ("relation", "representation")}
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             synthetic_train_batch(train_b, cfg.num_answers,
                                   lx.visual.visual_feat_dim,
                                   seed=SEED).items()}
    for k in ("input_ids", "input_mask", "segment_ids"):
        batch[k] = batch[k].long()
    return SimpleNamespace(cfg=cfg, tc=tc, train_b=train_b, model=model,
                           names=names, opt=opt, make_opt=make_opt,
                           state=state, steps=steps, batch=batch)


def drive_plan(torch, t, phase: str, counters: dict) -> dict:
    """The main path: the branch plan through the train steps, every count
    of `counters` ({name: wrapper}) at 0 just before and read just after;
    the plan's checks. Returns the counts."""
    node_fc = [n for n in t.names if n.startswith("node_fc.")]
    for c in counters.values():
        c.launches = 0
    metrics, node_fc_trace = [], []
    state = t.state
    for i, br in enumerate(PLAN):
        state, m = t.steps[br](state, t.batch, i)
        metrics.append(m)
        active, counts = (state.opt_state.active_flags(),
                          state.opt_state.leaf_counts())
        node_fc_trace.append((all(active[n] for n in node_fc),
                              any(active[n] for n in node_fc),
                              sorted({counts[n] for n in node_fc})))
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    losses = [{k: float(v) for k, v in m.items() if v.dim() == 0}
              for m in metrics]
    lxrt_count = state.opt_state.leaf_counts()["lxrt.pooler.dense.weight"]
    emit(phase, plan=list(PLAN), losses=losses, launches=launches,
         launches_per_batch={k: v / len(PLAN) for k, v in launches.items()},
         optimizer_count=state.opt_state.count,
         lxrt_pooler_leaf_count=lxrt_count,
         node_fc_all_active_any_active_counts=node_fc_trace,
         params=sum(p.numel() for p in t.model.parameters()))
    check(all(math.isfinite(x) for d in losses for x in d.values()),
          f"non-finite train loss: {losses}")
    check(state.opt_state.count == UPDATES_PER_BATCH * len(PLAN),
          f"optimizer count {state.opt_state.count} after {len(PLAN)} batches")
    check(lxrt_count == UPDATES_PER_BATCH * len(PLAN),
          f"lxrt leaf count {lxrt_count}")
    # node_fc joins at the first representation batch (the second), then
    # updates in both phases of every batch
    check(node_fc_trace[0][:2] == (False, False)
          and node_fc_trace[1] == (True, True, [2])
          and node_fc_trace[3] == (True, True, [6]),
          f"node_fc activation {node_fc_trace}")
    for key, per_batch in (("attention_dropout_fwd", FWD_LAUNCHES_PER_BATCH),
                           ("attention_dropout_bwd", BWD_LAUNCHES_PER_BATCH)):
        check(launches[key] == per_batch * len(PLAN),
              f"{launches[key]} {key} launches for {len(PLAN)} batches, "
              f"expected {per_batch} each")
    return launches


def time_batches(torch, t) -> dict:
    """ms per two-phase batch over TIMED_BATCHES batches of the branches in
    turn, pairs/s and peak device memory."""
    state = t.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TIMED_BATCHES):
        br = ("relation", "representation")[i % 2]
        state, m = t.steps[br](state, t.batch, 1000 + i)
    final = float(m["clean_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(math.isfinite(final), "non-finite loss in the timed batches")
    return dict(batches=TIMED_BATCHES, batch_size=t.train_b,
                ms_per_batch=dt / TIMED_BATCHES * 1e3,
                pairs_per_s=t.train_b * TIMED_BATCHES / dt,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                final_clean_loss=final)


def kernels_vs_plain(torch, attn, philox, t, state, phase: str, branches,
                     apart=(), watch=()) -> list:
    """Each phase's loss (`branches`: relation, representation, clean) and
    its gradient for every parameter, from `state` and fixed seeds, once
    through kernels 2 and 3 and once through the plain attention fed the
    same Philox masks, with no update: within LOSS_RTOL, GRAD_RTOL overall
    and PARAM_GRAD_RTOL per parameter; for the parameters in `apart`,
    PARAM_GRAD_RTOL of the generator's whole gradient (those and the
    ones in `watch` printed by name)."""
    from xggm_tpu_torch.training.steps import (
        make_clean_loss, make_ggm_loss, phase_seeds)

    def plain_dropout(q, k, v, bias, heads, seed, rate):
        keep = philox.dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1],
                                   rate, q.device)
        return attn.attention_dropout_reference(q, k, v, bias, heads, keep)

    ggm_dropout, ggm_noise, clean_dropout = phase_seeds(100)
    params = [state.params[n] for n in t.names]
    phases = {}
    for br in branches:
        if br == "clean":
            phases["clean_loss"] = (make_clean_loss(t.model,
                                                    t.cfg.num_answers),
                                    (t.batch, clean_dropout))
        else:
            phases[f"{br}_ggm_loss"] = (make_ggm_loss(t.model, t.tc, br),
                                        (t.batch, ggm_dropout, ggm_noise))

    def loss_and_grads(fn, args):
        loss = fn(*args)[0]
        return float(loss.detach()), torch.autograd.grad(loss, params,
                                                         allow_unused=True)

    agreement = []
    for key, (fn, args) in phases.items():
        loss_k, grads_k = loss_and_grads(fn, args)
        with mock.patch.object(attn, "fused_attention_dropout",
                               plain_dropout):
            loss_p, grads_p = loss_and_grads(fn, args)
        agreement.append(dict(
            phase=key, kernels=loss_k, plain=loss_p,
            loss_rel_diff=abs(loss_k - loss_p) / max(abs(loss_p), 1e-12),
            **grad_agreement(torch, t.names, grads_k, grads_p, apart,
                             watch)))
        del grads_k, grads_p
    emit(phase, rows=agreement, loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL,
         param_grad_rtol=PARAM_GRAD_RTOL)
    bad = [r for r in agreement
           if not (r["same_graph"] and r["loss_rel_diff"] <= LOSS_RTOL
                   and r["grad_rel_l2"] <= GRAD_RTOL
                   and r["max_param_grad_rel_l2"] <= PARAM_GRAD_RTOL
                   and all(v["rel_to_generator_grad"] <= PARAM_GRAD_RTOL
                           for n, v in r["named"].items()
                           if n in r["apart"]))]
    check(not bad, f"{phase}: losses and gradients with kernels vs plain "
                   f"attention: {bad}")
    return agreement


def phase_train(torch, attn, philox):
    """The GGM train step at full width through kernels 2 and 3, with the
    tree BertAdam. Returns the main path's counts and the profile."""
    t = train_setup(torch, fused=False)
    launches = drive_plan(torch, t, "train", {
        "attention_fwd": attn.fused_attention,
        "attention_dropout_fwd": attn.attention_dropout_fwd,
        "attention_dropout_bwd": attn.attention_dropout_bwd})
    state = t.state

    kernels_vs_plain(torch, attn, philox, t, state, "train_vs_plain",
                     ("relation", "representation", "clean"))

    timing = time_batches(torch, t)
    emit("train_timing", **timing)
    profile = profile_batch(torch, t.steps["relation"], t.state, t.batch,
                            timing["ms_per_batch"])
    emit("train_profile", **profile)
    return launches, profile


def copy_train_state(state):
    """A copy of a TrainState's parameters and BertAdam state."""
    from dataclasses import replace

    s = state.opt_state
    params = {n: p.detach().clone() for n, p in state.params.items()}
    return params, replace(
        s, m={n: x.clone() for n, x in s.m.items()},
        v={n: x.clone() for n, x in s.v.items()},
        lr_scale=s.lr_scale.clone(), leaf_count=s.leaf_count.clone(),
        active=s.active.clone(), touched=set(s.touched))


def check_kernel7(torch, fa, t) -> dict:
    """Kernel 7 against its plain version over the full state, on copies:
    random gradients, one null (node_fc's first parameter, touched before),
    one parameter inactive (rate 0); then its time per update with every
    gradient present, its plain version's, and torch._fused_adamw_'s."""
    state, names, opt = t.state, t.names, t.opt
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ps = [state.params[n].detach() for n in names]
    grads = [torch.randn(p.shape, device="cuda", generator=gen) * 1e-2
             for p in ps]
    null = next(i for i, n in enumerate(names) if n.startswith("node_fc."))
    inactive = names.index("lxrt.encoder.visn_fc.visn_fc.weight")
    some_null = [None if i == null else g for i, g in enumerate(grads)]
    lr_eff = torch.rand(len(names), device="cuda", generator=gen) * 1e-2
    lr_eff[inactive] = 0.0
    clip = torch.tensor(0.37, device="cuda")
    idx = list(range(len(names)))

    def copies():
        return ([p.clone() for p in ps],
                [state.opt_state.m[n].clone() for n in names],
                [state.opt_state.v[n].clone() for n in names])

    kernel_pmv, plain_pmv = copies(), copies()
    fa.fused_adam(some_null, *kernel_pmv[1:], kernel_pmv[0], idx, clip,
                  lr_eff, **hyper)
    fa.fused_adam_reference(some_null, *plain_pmv[1:], plain_pmv[0], idx,
                            clip, lr_eff, **hyper)
    torch.cuda.synchronize()
    errs = {k: max(max_err(a, b) for a, b in zip(x, y))
            for k, x, y in zip("pmv", kernel_pmv, plain_pmv)}
    ok = all(within(a, b, ADAM_TOL) for x, y in zip(kernel_pmv, plain_pmv)
             for a, b in zip(x, y))
    unchanged = bool(torch.equal(kernel_pmv[0][inactive], ps[inactive]))
    elements = sum(p.numel() for p in ps)
    emit("fused_adam_kernel", params=len(names), elements=elements,
         null_gradient=names[null], inactive=names[inactive],
         max_abs_err=errs, tolerance=ADAM_TOL, within=ok,
         inactive_parameter_unchanged=unchanged)
    check(ok and unchanged, f"kernel 7 vs its plain version: max abs err "
                            f"{errs}, inactive unchanged {unchanged}")
    del plain_pmv

    # the kernel alone: launches from one table on the card; the wrapper
    # (checks, the table on the host, its copy) takes longer than the
    # kernel, so CUDA events around wrapper calls time the host
    kp, km, kv = kernel_pmv
    table = fa._table(grads, km, kv, kp, idx)
    rows = torch.from_numpy(table).to("cuda")
    steps_t = [torch.zeros((), device="cuda") for _ in names]
    kernel = dict(
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: fa._launch(rows, fa._chunks(table), clip, lr_eff,
                                      **hyper)),
        wrapper_ms=cuda_ms(lambda: fa.fused_adam(grads, km, kv, kp, idx,
                                                 clip, lr_eff, **hyper)),
        plain_ms=cuda_ms(lambda: fa.fused_adam_reference(
            grads, km, kv, kp, idx, clip, lr_eff, **hyper), iters=3,
            warmup=1),
        fused_adamw_ms=cuda_ms(lambda: torch._fused_adamw_(
            kp, grads, km, kv, [], steps_t, lr=1e-3, beta1=opt.b1,
            beta2=opt.b2, weight_decay=opt.weight_decay, eps=opt.eps,
            amsgrad=False, maximize=False)))
    kernel["bound_ms"], kernel["bound_by"] = bound(
        ADAM_BYTES * elements, ADAM_FLOPS * elements, FP32_FLOPS)
    kernel["bound_share"] = kernel["bound_ms"] / kernel["ms"]
    emit("fused_adam_time", **kernel, elements=elements,
         timed_over="one update of every parameter, every gradient present; "
                    "ms: the kernel's launches alone from one table on the "
                    "card; wrapper_ms: fused_adam calls, host work included",
         fused_adamw="torch._fused_adamw_ over the same tensors: AdamW with "
                     "bias correction, another function; timing only")
    return kernel


def check_fused_vs_tree(torch, t) -> None:
    """From one copied state and one batch's GGM-phase gradients, one
    update through the fused path against one through the tree path."""
    from xggm_tpu_torch.training.steps import (
        clip_by_global_norm, make_ggm_loss, phase_seeds)

    state, names = t.state, t.names
    ggm_dropout, ggm_noise, _ = phase_seeds(200)
    loss = make_ggm_loss(t.model, t.tc, "relation")(
        t.batch, ggm_dropout, ggm_noise)[0]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [state.params[n] for n in names], allow_unused=True)))
    fused_p, fused_s = copy_train_state(state)
    tree_p, tree_s = copy_train_state(state)
    t.opt.fused_step(fused_p, grads, fused_s, t.tc.grad_clip)
    clip_by_global_norm(grads, t.tc.grad_clip)
    t.make_opt(False).step(tree_p, grads, tree_s)
    torch.cuda.synchronize()
    pairs = {"p": (fused_p, tree_p), "m": (fused_s.m, tree_s.m),
             "v": (fused_s.v, tree_s.v)}
    errs = {k: max(max_err(a[n], b[n]) for n in names)
            for k, (a, b) in pairs.items()}
    ok = all(within(a[n], b[n], ADAM_TOL) for a, b in pairs.values()
             for n in names)
    same = (fused_s.leaf_counts() == tree_s.leaf_counts()
            and fused_s.active_flags() == tree_s.active_flags()
            and fused_s.count == tree_s.count
            and fused_s.touched == tree_s.touched)
    check(ok and same, f"fused vs tree update: max abs err {errs}, "
                       f"counters and flags equal {same}")

    # host time of one update (the launches' enqueue, the device idle at
    # its start): the median of 5, on the copies
    def host_ms(update):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            update()
            samples.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(samples)

    tree_opt = t.make_opt(False)

    def tree_update():
        clip_by_global_norm(grads, t.tc.grad_clip)
        tree_opt.step(tree_p, grads, tree_s)

    emit("fused_vs_tree", branch="relation",
         null_gradients=sum(g is None for g in grads.values()),
         max_abs_err=errs, tolerance=ADAM_TOL, within=ok,
         counters_flags_touched_equal=same,
         host_ms_per_update_fused=host_ms(lambda: t.opt.fused_step(
             fused_p, grads, fused_s, t.tc.grad_clip)),
         host_ms_per_update_tree=host_ms(tree_update))


def phase_fused_train(torch, attn, fa, tree_profile: dict):
    """The train step with BertAdam(fused=True): kernel 7 on the main path,
    against its plain version, against the tree update, and timed."""
    t = train_setup(torch, fused=True)
    launches = drive_plan(torch, t, "fused_train", {
        "attention_fwd": attn.fused_attention,
        "attention_dropout_fwd": attn.attention_dropout_fwd,
        "attention_dropout_bwd": attn.attention_dropout_bwd,
        "bert_adam": fa.fused_adam})
    want = UPDATES_PER_BATCH * len(PLAN)
    check(launches["bert_adam"] == want,
          f"{launches['bert_adam']} kernel-7 launches for {len(PLAN)} "
          f"batches, expected {UPDATES_PER_BATCH} per batch: {want}")
    kernel = check_kernel7(torch, fa, t)
    check_fused_vs_tree(torch, t)
    gc.collect()
    torch.cuda.empty_cache()

    # the tree and the fused update in turns on this model and state
    # (tree, fused, fused, tree): `fused` picks the path at every update
    turns = []
    for fused in (False, True, True, False):
        t.opt.fused = fused
        turns.append(dict(fused=fused, **time_batches(torch, t)))
    t.opt.fused = True
    emit("fused_train_timing", turns=turns)
    fused_ms = [x["ms_per_batch"] for x in turns if x["fused"]]
    profile = profile_batch(torch, t.steps["relation"], t.state, t.batch,
                            sum(fused_ms) / len(fused_ms))
    emit("fused_train_profile", **profile)
    cats = profile["device_ms_by_category"]
    emit("fused_train_optimizer", bert_adam_kernel_ms_per_batch=cats.get(
        KERNEL7_CATEGORY, 0.0),
         foreach_ms_per_batch=cats.get(FOREACH_CATEGORY, 0.0),
         tree_path_foreach_ms_per_batch=tree_profile[
             "device_ms_by_category"].get(FOREACH_CATEGORY, 0.0),
         device_events=profile["device_events"],
         tree_path_device_events=tree_profile["device_events"])
    return launches, kernel


KERNEL7_CATEGORY = "BertAdam, kernel 7 (ours)"
FOREACH_CATEGORY = "optimizer and clip (foreach)"


def kernel_category(name: str) -> str:
    if "bert_adam" in name:
        return KERNEL7_CATEGORY
    if "attention_dropout" in name or "attention_fwd" in name:
        return "attention kernels (ours)"
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas",
                               "sm90_")):
        return "GEMM (cuBLAS)"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return FOREACH_CATEGORY
    if "copy" in name.lower() or "memset" in name.lower():
        return "casts and copies"
    return "elementwise and reductions"


def profile_call(torch, fn, category=kernel_category) -> dict:
    """Device time of one call of `fn` by kernel, from torch.profiler (CUDA
    activity only), after one unprofiled call: the sum of kernel durations
    is the device's busy time (one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_cat, launches = {}, {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us / 1e3
        cat = category(evt.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3
        launches += 1
    busy = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy,
                device_events=launches, device_ms_by_category=by_cat,
                top_kernels_ms=[[n[:120], ms] for n, ms in top],
                note=("no device events: not measured" if not busy
                      else "device events from torch.profiler (CUPTI)"))


def profile_batch(torch, step, state, batch, timed_ms: float) -> dict:
    """Device time of one two-phase batch by kernel; its idle share is
    taken against the unprofiled ms per batch of the timing run."""
    seeds = iter((2000, 2001))
    prof = profile_call(torch, lambda: step(state, batch, next(seeds)))
    busy = prof["device_busy_ms"]
    return dict(prof, timed_ms_per_batch=timed_ms,
                device_idle_share=(1.0 - busy / timed_ms) if busy else None)


def write_answer_tables(root: str, label2ans: list) -> None:
    """The GQA-OOD answer vocabulary of a corpus under `root`."""
    from xggm_tpu_torch.utils.io import save_json

    save_json(label2ans, os.path.join(root, "gqa_ood",
                                      "trainval_label2ans.json"))
    save_json({a: i for i, a in enumerate(label2ans)},
              os.path.join(root, "gqa_ood", "trainval_ans2label.json"))


def phase_trainer(torch, attn, phase8_ms_per_batch: float,
                  t_start: float, tmp: str):
    """The GQA-OOD trainer through its CLI at full width: a pack corpus
    written without H5 (1842 answers) under `tmp`, one epoch of 4 batches of
    96 in bf16, then the test arm from its checkpoint. Kernels 1, 2 and 3
    counted over the train arm (counts at 0 just before, read just after).
    Returns the counts, and what phase 12 serves: the run's directories,
    the validation questions over an in-memory store of their images, and
    the epoch's final parameters' logits (those BEST_0 holds) on the first
    64 of them, through the serving path."""
    from xggm_tpu_torch.cli import gqa_ood
    from xggm_tpu_torch.config import gqa_ood_config
    from xggm_tpu_torch.data.datasets import (
        GQADataset, GraphBatchDataset, MemoryFeatureStore)
    from xggm_tpu_torch.data.feeder import Feeder
    from xggm_tpu_torch.data.synthetic import (
        ANSWERS, make_synthetic_gqa, write_vocab)
    from xggm_tpu_torch.data.xpack import XPackFeatureStore
    from xggm_tpu_torch.serving.artifact import ServingModel
    from xggm_tpu_torch.serving.server import InferenceEngine
    from xggm_tpu_torch.utils.guard import check_step_finite

    cfg = gqa_ood_config()
    bs, feat_dim = cfg.train.batch_size, cfg.lxmert.visual.visual_feat_dim
    counters = {"attention_fwd": attn.fused_attention,
                "attention_dropout_fwd": attn.attention_dropout_fwd,
                "attention_dropout_bwd": attn.attention_dropout_bwd}
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    make_synthetic_gqa(root, "train", feat_dim=feat_dim, pack=True,
                       **TRAINER_TRAIN)
    make_synthetic_gqa(root, "val", feat_dim=feat_dim, pack=True,
                       **TRAINER_VAL)
    write_vocab(os.path.join(root, "vocab.txt"))
    # the recipe's answer vocabulary size, as the serving phase pads it
    label2ans = ANSWERS + [f"answer_{i}" for i in
                           range(len(ANSWERS), cfg.num_answers)]
    write_answer_tables(root, label2ans)
    feat_files = sorted(os.listdir(os.path.join(root, "gqa_imgfeat")))
    corpus_s = time.perf_counter() - t0
    check(not [f for f in feat_files if f.endswith(".h5")],
          f"the pack corpus holds H5 files: {feat_files}")

    argv = ["--train", "train", "--valid", "val", "--data_root", root,
            "--output", out, "--bs", str(bs), "--epochs", "1", "--lr",
            str(cfg.train.lr), "--seed", str(TRAINER_SEED), "--device",
            "cuda", "--xpack", "--dtype", "bfloat16"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        trainer = gqa_ood.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    lines = stdout.getvalue().splitlines()

    recs = [json.loads(ln) for ln in
            open(os.path.join(out, "metrics.jsonl"))]
    steps = [r for r in recs if "branch" in r]
    vals = [r for r in recs if "valid/mid_epoch_acc" in r]
    log = open(os.path.join(out, "log.log")).read().splitlines()
    epoch_lines = [ln for ln in log if ln.startswith("Epoch 0: ")]
    end = re.match(r"Epoch 0: Train [\d.]+, Valid ([\d.]+), Best "
                   r"([\d.]+) \(([\d.]+)s\)$",
                   epoch_lines[0] if epoch_lines else "")
    best_line = [ln for ln in lines if ln.startswith("Best valid: ")]
    draw = random.Random(TRAINER_SEED)
    want_branches = ["rel" if draw.randint(1, 10) <= cfg.ggm.delta
                     else "rep" for _ in steps]
    n_batches = len(trainer.train_set) // bs
    # validations: after the batches at linspace(0, n, 5)[1:-1] and
    # at the epoch's end; each predicts the split in batches of
    # max(bs, 64), 34 kernel-1 launches a forward
    mid = len({int(x) for x in
               [n_batches * k / 4 for k in (1, 2, 3)]})
    eval_forwards = (mid + 1) * math.ceil(len(trainer.valid_set)
                                          / max(bs, 64))
    want = {"attention_fwd": LAUNCHES_PER_FORWARD * eval_forwards,
            "attention_dropout_fwd": FWD_LAUNCHES_PER_BATCH * len(steps),
            "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH * len(steps)}
    # ms per training batch: gaps between consecutive step records that
    # no validation (and its save) separates
    val_after = {r["step"] for r in vals}
    gaps = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(steps, steps[1:])
            if b["step"] not in val_after]
    trainer_ms = statistics.median(gaps) if gaps else None
    saves = list(trainer.ckpt.history)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    count = trainer.state.opt_state.count
    native = trainer.train_set.store.pack.native
    losses = [{k: v for k, v in r.items()
               if k not in ("step", "branch", "ts")} for r in steps]
    checkpoints = sorted(d for d in os.listdir(out)
                         if d.startswith("BEST"))
    accs = [r["valid/mid_epoch_acc"] for r in vals]
    end_acc = float(end.group(1)) / 100 if end else None
    improved = any(a > 0 for a in accs + [end_acc or 0.0])
    emit("trainer", cli_lines=lines, corpus_seconds=corpus_s,
         feature_files=feat_files, steps=len(steps),
         branches=[r["branch"] for r in steps],
         expected_branches=want_branches, losses=losses,
         validation_steps=sorted(val_after), validation_accuracies=accs,
         end_of_epoch_accuracy=end_acc, optimizer_count=count,
         launches=launches, expected_launches=want,
         eval_forwards=eval_forwards, checkpoints=checkpoints,
         log_lines=log, xpack_native=native, params=n_params)
    check("Oracle score: 100.00" in lines, f"oracle: {lines}")
    check(len(steps) == n_batches == 4, f"{len(steps)} steps")
    check(all(math.isfinite(v) for d in losses for v in d.values()),
          f"non-finite trainer losses: {losses}")
    check([r["branch"] for r in steps] == want_branches,
          "branches are not random.Random(seed)'s draws")
    check(count == UPDATES_PER_BATCH * len(steps),
          f"optimizer count {count} after {len(steps)} batches")
    check(launches == want, f"launches {launches}, expected {want}")
    check(len(epoch_lines) == 1 and end is not None and best_line,
          f"log.log {log}, stdout {lines}")
    # BEST after an improvement on 0, BEST_0 at the end of the epoch
    check(("BEST" in checkpoints) == improved and "BEST_0" in checkpoints,
          f"checkpoints {checkpoints}, accuracies {accs}, {end_acc}")
    check(saves and all(s["bytes"] >= 3 * 4 * n_params for s in saves),
          f"checkpoint sizes {saves}")

    # the epoch's final parameters (those BEST_0 holds) predict the
    # split in memory, before the timing turns below change them
    final_preds = trainer.predict(trainer.valid_set)
    save_names = [sv["name"] for sv in saves]
    pack = XPackFeatureStore(os.path.join(root, "gqa_imgfeat",
                                          "val_obj36.xpack"))
    val_store = MemoryFeatureStore({i: pack.get(i)[:2]
                                    for i in pack.img_ids()})
    pack.close()
    val_queries = [{"img_id": r.img_id, "sent": r.sent}
                   for r in trainer.valid_set.records]
    in_memory = InferenceEngine(ServingModel(trainer.model, {
        "batch_size": None, "seq_len": 20, "num_objects": 36,
        "feat_dim": feat_dim}), trainer.tokenizer, val_store)
    served_batch = in_memory._assemble(val_queries[:64])
    handoff = dict(root=root, out=out, tmp=tmp, label2ans=label2ans,
                   tokenizer=trainer.tokenizer, store=val_store,
                   queries=val_queries, batch=served_batch,
                   final_logits=in_memory.model.predict_logits(
                       served_batch))
    del in_memory

    # the feeder alone over the train set: host ms per batch
    store = XPackFeatureStore(os.path.join(root, "gqa_imgfeat",
                                           "train_obj36.xpack"))
    ds = GraphBatchDataset(GQADataset("train", trainer.cfg.data),
                           trainer.tokenizer, store=store)
    feeder = Feeder(ds, bs, shuffle=True, drop_last=True,
                    seed=TRAINER_SEED, feats_dtype=torch.bfloat16,
                    device="cuda")
    feeder_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        n = sum(1 for _ in feeder)
        torch.cuda.synchronize()
        feeder_ms.append((time.perf_counter() - t0) * 1e3 / n)
    store.close()

    # the trainer's steps fed by its feeder against the same steps on
    # one batch already on the card, in alternating turns (fed,
    # resident, resident, fed, fed, resident), each of FED_PASSES
    # feeder passes. Each step is timed on its own, with the trainer's
    # host reads. The first step of each pass (the producer's start-up,
    # which no step overlaps) is left out, at the same positions in
    # both modes: if the copies overlap the steps, the two agree within
    # the noise
    train_feeder = trainer._feeder(trainer.train_set, bs, True)
    per_pass = len(train_feeder)
    resident = list(train_feeder)[0]

    def run(items) -> list:
        """ms of each step after the pass's first."""
        times = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i, (qids, batch, _) in enumerate(items):
            step = trainer.rel_step if i % 2 == 0 else trainer.rep_step
            trainer.state, m = step(trainer.state, batch, 10_000 + i)
            check_step_finite(i, "timing", trainer._record(qids, m, {}))
            now = time.perf_counter()
            if i % per_pass:
                times.append((now - t) * 1e3)
            t = now
        return times

    def fed():
        for _ in range(FED_PASSES):
            yield from train_feeder

    turns = []
    for mode in ("fed", "resident", "resident", "fed", "fed",
                 "resident"):
        turns.append((mode, run(fed() if mode == "fed" else
                                [resident] * (FED_PASSES * per_pass))))
    steady = {mode: statistics.median(
        [t for m, ts in turns if m == mode for t in ts])
        for mode in ("fed", "resident")}
    best_valid = float(best_line[0].split()[-1])
    del trainer, ds, feeder, train_feeder, resident
    gc.collect()
    torch.cuda.empty_cache()

    # the test arm, from BEST when it was saved, else BEST_0. Either
    # holds the final parameters when it was the last save but BEST_0's
    # own (BEST saved at the epoch's end): its answers must then be
    # final_preds', answer for answer
    load = "BEST" if improved else "BEST_0"
    holds_final = (load == "BEST_0"
                   or save_names[-2:] == ["BEST", "BEST_0"])
    want_acc = best_valid if improved else float(end.group(1))
    for c in counters.values():
        c.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        gqa_ood.main(argv + ["--test", "val", "--load",
                             os.path.join(out, load)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = counters["attention_fwd"].launches
    test_lines = stdout.getvalue().splitlines()
    # phase 12 exports BEST_0; free the disk of the other checkpoint
    shutil.rmtree(os.path.join(out, "BEST"), ignore_errors=True)
    preds = json.load(open(os.path.join(out, "val_predict.json")))
    acc_line = [ln for ln in test_lines
                if ln.startswith("val accuracy: ")]
    vocab = set(label2ans)
    loaded_preds = {p["questionId"]: p["prediction"] for p in preds}
    differ = (sum(loaded_preds.get(q) != a for q, a in final_preds.items())
              if holds_final else None)
    emit("trainer_test_arm", loaded=load, cli_lines=test_lines,
         predictions=len(preds), seconds=test_s,
         attention_fwd_launches=test_launches,
         expected_accuracy=f"{want_acc:.2f}",
         compared_with_final_parameters=holds_final,
         answers_differing_from_final_parameters=differ)
    check(len(preds) == TRAINER_VAL["n_questions"]
          and all(p["prediction"] in vocab for p in preds),
          f"{len(preds)} predictions")
    check(not holds_final or (differ == 0 and len(loaded_preds)
                              == len(final_preds)),
          f"{load}'s test arm: {differ} answers differ from the final "
          "parameters' in memory")
    check(acc_line and acc_line[0].split()[-1] == f"{want_acc:.2f}",
          f"test arm accuracy {acc_line}, expected {want_acc:.2f}")
    check(test_launches == LAUNCHES_PER_FORWARD * math.ceil(
        len(preds) / max(bs, 64)), f"{test_launches} test-arm launches")

    emit("trainer_timing", card=torch.cuda.get_device_name(0),
         trainer_ms_per_batch=trainer_ms, trainer_gaps_ms=gaps,
         phase8_ms_per_batch=phase8_ms_per_batch,
         feeder_host_ms_per_batch=feeder_ms,
         copy_overlaps=(None if trainer_ms is None else
                        trainer_ms - phase8_ms_per_batch
                        <= min(feeder_ms)),
         steps_fed_vs_resident_ms=turns,
         steady_ms_per_batch=steady,
         fed_minus_resident_ms=steady["fed"] - steady["resident"],
         xpack_native=native, checkpoint_saves=saves,
         epoch_seconds_log=float(end.group(3)), train_arm_seconds=train_s,
         max_memory_allocated_bytes=peak,
         seconds_so_far=time.perf_counter() - t_start)
    return launches, handoff



def reference_lxrt_keys(name: str) -> list:
    """The reference LXMERT snapshot's torch keys of the port's encoder
    parameter `name` (`lxrt.*`), in the order the port fuses them along
    dim 0: q, k, v for a self-attention's `qkv`, k, v for a cross
    attention's `kv`. Written from the reference's module names, not from
    the port's bridge, so that the load check holds the bridge to them."""
    key = "bert." + name[len("lxrt."):]
    for pat, rep in ((r"\.(lang|visn)_mlp\.intermediate\.", r".\1_inter.dense."),
                     (r"\.(lang|visn)_mlp\.output\.", r".\1_output.dense."),
                     (r"\.(lang|visn)_mlp\.LayerNorm\.", r".\1_output.LayerNorm."),
                     (r"\.mlp\.intermediate\.", ".intermediate.dense."),
                     (r"\.mlp\.output\.", ".output.dense."),
                     (r"\.mlp\.LayerNorm\.", ".output.LayerNorm.")):
        key = re.sub(pat, rep, key)
    for fused, parts in ((".qkv.", ("query", "key", "value")),
                         (".kv.", ("key", "value"))):
        if fused in key:
            return [key.replace(fused, f".{p}.") for p in parts]
    return [key]


def write_lxmert_snapshot(torch, lx, path: str, pre_answers: list) -> dict:
    """A seeded random LXMERT pretraining snapshot at the width of `lx`, as
    the reference saves one (`{name}_LXRT.pth`): the encoder's `bert.*`
    keys with separate q/k/v, and `answer_head.logit_fc.{0,2,3}.*` over
    `pre_answers`. Returns {port name: the tensor the load must give} for
    the encoder and the head's first layer and LayerNorm, and the last
    layer's pretraining weight and bias."""
    from xggm_tpu_torch.models.lxmert import LxmertModel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def draw(shape, one=False):
        t = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        return (t + 1) if one else t

    encoder = LxmertModel(lx, device="cuda")
    shapes = {n: tuple(p.shape) for n, p in encoder.state_dict().items()}
    del encoder
    sd, want = {}, {}
    for name, shape in shapes.items():
        name = "lxrt." + name
        keys = reference_lxrt_keys(name)
        one = name.endswith("weight") and len(shape) == 1  # a LayerNorm
        parts = [draw((shape[0] // len(keys),) + shape[1:], one)
                 for _ in keys]
        sd.update(zip(keys, parts))
        want[name] = torch.cat(parts)
    hid = lx.bert.hidden_size
    head = {"0.weight": draw((2 * hid, hid)), "0.bias": draw((2 * hid,)),
            "2.weight": draw((2 * hid,), one=True), "2.bias": draw((2 * hid,)),
            "3.weight": draw((len(pre_answers), 2 * hid)),
            "3.bias": draw((len(pre_answers),))}
    sd.update({f"answer_head.logit_fc.{k}": v for k, v in head.items()})
    for port, ref in (("fc1", "0"), ("ln", "2")):
        want[f"logit_fc.{port}.weight"] = head[f"{ref}.weight"]
        want[f"logit_fc.{port}.bias"] = head[f"{ref}.bias"]
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return dict(want=want, fc2_weight=head["3.weight"],
                fc2_bias=head["3.bias"], tensors=len(sd),
                bytes=os.path.getsize(path))


class RunClock:
    """Per-step ms of a trainer run from its step records, less the time
    spent between two records in validations and saves; and, with
    `sigterm_after`, a real SIGTERM to this process right after that step's
    record, once the trainer's preemption guard is installed."""

    def __init__(self, sigterm_after=None):
        self.sigterm_after = sigterm_after
        self.steps, self.excluded = [], 0.0

    @contextlib.contextmanager
    def patched(self):
        import signal

        from xggm_tpu_torch.training.metrics import MetricsLogger
        from xggm_tpu_torch.training.trainer import XGGMTrainer
        from xggm_tpu_torch.utils.preempt import PreemptionGuard

        log_step = MetricsLogger.log_step
        clock = self

        def logged(logger, step, metrics, branch=""):
            log_step(logger, step, metrics, branch)
            clock.steps.append((step, time.perf_counter(), clock.excluded))
            if step == clock.sigterm_after:
                handler = signal.getsignal(signal.SIGTERM)
                check(isinstance(getattr(handler, "__self__", None),
                                 PreemptionGuard),
                      f"no preemption guard holds SIGTERM: {handler}")
                os.kill(os.getpid(), signal.SIGTERM)

        def excluded(fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    clock.excluded += time.perf_counter() - t0
            return wrapper

        with mock.patch.object(MetricsLogger, "log_step", logged), \
                mock.patch.object(XGGMTrainer, "evaluate_valid",
                                  excluded(XGGMTrainer.evaluate_valid)), \
                mock.patch.object(XGGMTrainer, "save",
                                  excluded(XGGMTrainer.save)):
            yield self

    def ms_per_step(self) -> list:
        return [((t1 - t0) - (x1 - x0)) * 1e3 for (_, t0, x0), (_, t1, x1)
                in zip(self.steps, self.steps[1:])]


def phase_vqacp(torch, attn, phase10_launches: dict, t_start: float) -> dict:
    """The VQA-CP v2 recipe at full width (16039 answers, batch 92, clean
    phase first, delta 0): an LXMERT snapshot loaded with the answer-head
    surgery, an epoch (run A), the same run stopped by SIGTERM after its
    second step (B) and resumed (C), the test arm from C's checkpoint, and
    the baseline CLI. Returns the kernels' launches over each run."""
    import signal

    from xggm_tpu_torch.cli import vqacpv2, vqacpv2_baseline
    from xggm_tpu_torch.config import vqacpv2_config
    from xggm_tpu_torch.data.datasets import VQACPDataset, VQAEvaluator
    from xggm_tpu_torch.data.synthetic import (
        ANSWERS, make_synthetic_vqacp, write_vocab)
    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.training.trainer import XGGMTrainer
    from xggm_tpu_torch.utils.io import save_json

    cfg = vqacpv2_config()
    lx = cfg.lxmert.replace(dtype="bfloat16")
    bs, feat_dim = cfg.train.batch_size, lx.visual.visual_feat_dim
    counters = {"attention_fwd": attn.fused_attention,
                "attention_dropout_fwd": attn.attention_dropout_fwd,
                "attention_dropout_bwd": attn.attention_dropout_bwd}
    tmp = tempfile.mkdtemp(prefix="xggm_vqacp_")
    try:
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        make_synthetic_vqacp(root, "train", feat_dim=feat_dim, pack=True,
                             **VQACP_TRAIN)
        make_synthetic_vqacp(root, "dev_test", feat_dim=feat_dim, pack=True,
                             **VQACP_TEST)
        write_vocab(os.path.join(root, "vocab.txt"))
        label2ans = ANSWERS + [f"answer_{i}" for i in
                               range(len(ANSWERS), cfg.num_answers)]
        save_json(label2ans, os.path.join(root, "vqacpv2",
                                          "trainval_label2ans.json"))
        save_json({a: i for i, a in enumerate(label2ans)},
                  os.path.join(root, "vqacpv2", "trainval_ans2label.json"))
        feat_files = sorted(os.listdir(os.path.join(root, "mscoco_imgfeat")))
        check(not [f for f in feat_files if f.endswith(".h5")],
              f"the pack corpus holds H5 files: {feat_files}")
        # the pretraining vocabulary: VQACP_SHARED of the corpus's answers
        # (none of the 16 synthetic words), the rest its own, shuffled
        shared = label2ans[len(ANSWERS):len(ANSWERS) + VQACP_SHARED]
        pre_answers = shared + [f"pretrain_{j}" for j in range(
            VQACP_PRE_ANSWERS - VQACP_SHARED)]
        random.Random(SEED).shuffle(pre_answers)
        os.makedirs(os.path.join(root, "lxmert"))
        save_json([{"ans": a, "dsets": ["vqa"]} for a in pre_answers],
                  os.path.join(root, "lxmert", "all_ans.json"))
        os.makedirs(os.path.join(tmp, "pretrained"))
        snapshot = write_lxmert_snapshot(
            torch, lx, os.path.join(tmp, "pretrained", "model_LXRT.pth"),
            pre_answers)
        corpus_s = time.perf_counter() - t0

        def argv(out, *extra):
            return ["--xpack", "--train", "train", "--valid", "dev_test",
                    "--data_root", root, "--output", os.path.join(tmp, out),
                    "--bs", str(bs), "--epochs", "1", "--lr",
                    str(cfg.train.lr), "--delta", str(cfg.ggm.delta),
                    "--seed", str(VQACP_SEED), "--device", "cuda", "--dtype",
                    "bfloat16", "--loadLXMERTQA",
                    os.path.join(tmp, "pretrained", "model"), *extra]

        def run(cli, args, clock=None, patches=()):
            """cli.main(args), stdout captured, `patches` ((object, name,
            replacement), ...) in place, counts at 0 just before and read
            just after: (trainer or exit code, lines, launches, seconds)."""
            for c in counters.values():
                c.launches = 0
            stdout = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                stack.enter_context(contextlib.redirect_stdout(stdout))
                if clock is not None:
                    stack.enter_context(clock.patched())
                for obj, attr, fn in patches:
                    stack.enter_context(mock.patch.object(obj, attr, fn))
                try:
                    result = cli.main(args)
                except SystemExit as e:
                    result = e.code
            torch.cuda.synchronize()
            return (result, stdout.getvalue().splitlines(),
                    {n: c.launches for n, c in counters.items()},
                    time.perf_counter() - t0)

        def steps_of(out):
            recs = [json.loads(ln) for ln in
                    open(os.path.join(tmp, out, "metrics.jsonl"))]
            return [{k: v for k, v in r.items() if k != "ts"}
                    for r in recs if "branch" in r]

        def validations(n_batches, offset):
            """Validations of an epoch resumed after `offset` batches:
            after the batches at linspace(0, n, 5)[1:-1] and at its end."""
            mid = {int(n_batches * k / 4) for k in (1, 2, 3)}
            return len({i for i in mid if i >= offset}) + 1

        def want_launches(steps, n_valid, phases=2):
            per_forward = math.ceil(VQACP_TEST["n_questions"] / max(bs, 64))
            return {"attention_fwd":
                    LAUNCHES_PER_FORWARD * per_forward * n_valid,
                    "attention_dropout_fwd":
                    LAUNCHES_PER_FORWARD * phases * steps,
                    "attention_dropout_bwd":
                    (LAUNCHES_PER_FORWARD * phases - 2) * steps}

        # run A: an epoch from the snapshot; the load checked on the card
        # right after it, and the order of the phases recorded
        load = {}
        real_load_qa = XGGMTrainer.load_lxmert_qa

        def load_qa(trainer, path, all_ans):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_load_qa(trainer, path, all_ans)
            torch.cuda.synchronize()
            load["seconds"] = time.perf_counter() - t0
            got = trainer.model.state_dict()
            load["differ"] = sorted(n for n, t in snapshot["want"].items()
                                    if not torch.equal(got[n], t))
            load["params"] = len(snapshot["want"])
            load["encoder_params"] = sum(n.startswith("lxrt.")
                                         for n in snapshot["want"])
            check(load["encoder_params"] == sum(
                n.startswith("lxrt.") for n in got), "encoder coverage")
            rows = torch.tensor([label2ans.index(a) for a in shared],
                                device="cuda")
            pre_rows = torch.tensor([pre_answers.index(a) for a in shared],
                                    device="cuda")
            rest = torch.ones(cfg.num_answers, dtype=torch.bool,
                              device="cuda")
            rest[rows] = False
            w, b = got["logit_fc.fc2.weight"], got["logit_fc.fc2.bias"]
            load["fc2_rows_loaded_equal"] = bool(
                torch.equal(w[rows], snapshot["fc2_weight"][pre_rows])
                and torch.equal(b[rows], snapshot["fc2_bias"][pre_rows]))
            load["fc2_rows_zero"] = int(rest.sum())
            load["fc2_rest_all_zero"] = bool(
                (w[rest] == 0).all() and (b[rest] == 0).all())
            # the snapshot's copy on the card is not the trainer's memory
            for key in ("want", "fc2_weight", "fc2_bias"):
                snapshot.pop(key)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        order = []

        def recorded(name, fn):
            def wrapper(*a, **kw):
                if torch.is_grad_enabled():  # a training phase
                    order.append(name)
                return fn(*a, **kw)
            return wrapper

        phase_patches = [
            (XGGMModel, "clean_forward",
             recorded("clean", XGGMModel.clean_forward)),
            (XGGMModel, "representation_branch",
             recorded("rep", XGGMModel.representation_branch))]

        clock_a = RunClock()
        trainer_a, lines_a, launches_a, seconds_a = run(
            vqacpv2, argv("a"), clock_a,
            [(XGGMTrainer, "load_lxmert_qa", load_qa), *phase_patches])
        n_batches = len(trainer_a.train_set) // bs
        steps_a = steps_of("a")
        count_a = trainer_a.state.opt_state.count
        final_a = {n: p.detach().cpu() for n, p in
                   trainer_a.model.named_parameters()}
        loaded_line = (f"Loaded {VQACP_SHARED} answers from LXRTQA "
                       f"pre-training and {cfg.num_answers - VQACP_SHARED} "
                       "not")
        want_a = want_launches(len(steps_a), validations(n_batches, 0))
        emit("vqacp_load", snapshot_tensors=snapshot["tensors"],
             snapshot_bytes=snapshot["bytes"], corpus_and_snapshot_seconds=
             corpus_s, load_seconds=load.get("seconds"),
             loaded_line=[ln for ln in lines_a if ln.startswith("Loaded ")],
             params_checked=load.get("params"),
             encoder_params_checked=load.get("encoder_params"),
             params_differing=load.get("differ"),
             fc2_shared_rows_equal=load.get("fc2_rows_loaded_equal"),
             fc2_other_rows=load.get("fc2_rows_zero"),
             fc2_other_rows_and_biases_zero=load.get("fc2_rest_all_zero"))
        check(loaded_line in lines_a, f"no '{loaded_line}' in {lines_a}")
        check(load.get("differ") == [], f"loaded parameters differ from the "
                                        f"snapshot: {load.get('differ')}")
        check(load["fc2_rows_loaded_equal"] and load["fc2_rest_all_zero"]
              and load["fc2_rows_zero"] == cfg.num_answers - VQACP_SHARED,
              "answer-head surgery")
        emit("vqacp_train", cli_lines=lines_a, steps=len(steps_a),
             branches=[r["branch"] for r in steps_a],
             phase_order=order, losses=steps_a, optimizer_count=count_a,
             t_total=trainer_a.opt.t_total, launches=launches_a,
             expected_launches=want_a, phase10_launches=phase10_launches,
             clean_phase_first=trainer_a.cfg.train.clean_phase_first,
             rel_d_mult=trainer_a.cfg.train.rel_d_mult,
             num_answers=trainer_a.num_answers, seconds=seconds_a)
        check(len(steps_a) == n_batches == 4, f"{len(steps_a)} steps")
        check(all(r["branch"] == "rep" for r in steps_a), "branches")
        check(order == ["clean", "rep"] * n_batches, f"phases {order}")
        check(trainer_a.cfg.train.clean_phase_first
              and trainer_a.cfg.train.rel_d_mult == 8.0
              and trainer_a.num_answers == cfg.num_answers, "config")
        check(all(math.isfinite(v) for r in steps_a for v in r.values()
                  if isinstance(v, float)), f"non-finite losses {steps_a}")
        check(count_a == UPDATES_PER_BATCH * n_batches,
              f"optimizer count {count_a}")
        check(launches_a == want_a, f"launches {launches_a}, want {want_a}")
        del trainer_a, snapshot
        shutil.rmtree(os.path.join(tmp, "a"))  # read; free the disk
        gc.collect()
        torch.cuda.empty_cache()

        # run B: the same run, stopped by a SIGTERM after its second step
        saves = {}
        real_save_preempt = XGGMTrainer.save_preempt

        def save_preempt(trainer, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_save_preempt(trainer, *a, **kw)
            saves["seconds"] = time.perf_counter() - t0
            saves.update(trainer.ckpt.history[-1])

        before = signal.getsignal(signal.SIGTERM)
        code_b, lines_b, launches_b, seconds_b = run(
            vqacpv2, argv("bc"), RunClock(sigterm_after=1),
            [(XGGMTrainer, "save_preempt", save_preempt)])
        gc.collect()
        torch.cuda.empty_cache()
        preempt = os.path.join(tmp, "bc", "PREEMPT")
        cursor = None
        if os.path.isdir(preempt):
            state = torch.load(os.path.join(preempt, "state.pt"),
                               map_location="cpu", weights_only=True)
            cursor = {k: state[k] for k in
                      ("epoch", "batches_done", "train_iter", "best_valid")}
            del state
        want_b = want_launches(2, 0)
        emit("vqacp_preempt", exit_code=code_b, cli_lines=lines_b,
             preempt_cursor=cursor, save_seconds=saves.get("seconds"),
             save_bytes=saves.get("bytes"), save=saves,
             steps=len(steps_of("bc")), launches=launches_b,
             expected_launches=want_b, seconds=seconds_b)
        check(code_b == 75, f"run B exited with {code_b!r}, not 75")
        check(signal.getsignal(signal.SIGTERM) is before,
              "the SIGTERM handler was not restored")
        check(cursor is not None and cursor["epoch"] == 0
              and cursor["batches_done"] == 2 and cursor["train_iter"] == 2,
              f"PREEMPT cursor {cursor}")
        check(launches_b == want_b, f"launches {launches_b}, want {want_b}")

        # run C: --resume in B's directory
        resume = {}
        real_resume = XGGMTrainer.resume

        def timed_resume(trainer):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_resume(trainer)
            torch.cuda.synchronize()
            resume["seconds"] = time.perf_counter() - t0
            return out

        clock_c = RunClock()
        trainer_c, lines_c, launches_c, seconds_c = run(
            vqacpv2, argv("bc", "--resume"), clock_c,
            [(XGGMTrainer, "resume", timed_resume)])
        steps_c = steps_of("bc")
        loss_diff = max(abs(a - b) / max(abs(b), 1e-30)
                        for ra, rb in zip(steps_c[2:], steps_a[2:])
                        for a, b in ((ra[k], rb[k]) for k in rb
                                     if isinstance(rb[k], float)))
        records_equal = steps_c == steps_a
        param_diff = max(float((p.detach().cpu() - final_a[n]).abs().max())
                         for n, p in trainer_c.model.named_parameters())
        bit_equal = all(torch.equal(p.detach().cpu(), final_a[n])
                        for n, p in trainer_c.model.named_parameters())
        want_c = want_launches(2, validations(n_batches, 2))
        emit("vqacp_resume", cli_lines=lines_c, steps=steps_c[2:],
             resume_seconds=resume.get("seconds"),
             step_records_equal_run_a=records_equal,
             max_rel_loss_diff=loss_diff, max_abs_param_diff=param_diff,
             params_bit_equal=bit_equal, launches=launches_c,
             expected_launches=want_c, seconds=seconds_c)
        check("resumed from PREEMPT (epoch 0, 2 batches done)" in lines_c,
              f"resume lines {lines_c}")
        check(len(steps_c) == 4 and [r["step"] for r in steps_c] ==
              [0, 1, 2, 3], f"step records {steps_c}")
        check(loss_diff <= RESUME_LOSS_RTOL, f"losses differ: {loss_diff}")
        check(param_diff <= RESUME_PARAM_ATOL,
              f"parameters differ: {param_diff}")
        check(not os.path.isdir(preempt), "PREEMPT left after the run")
        check(trainer_c.state.opt_state.count == count_a, "update count")
        check(launches_c == want_c, f"launches {launches_c}, want {want_c}")

        # the test arm from C's checkpoint, against C's final parameters
        test_raw = VQACPDataset("dev_test", trainer_c.cfg.data)
        final_preds = trainer_c.predict(trainer_c.valid_set)
        del trainer_c, final_a
        gc.collect()
        torch.cuda.empty_cache()
        trainer_t, lines_t, launches_t, seconds_t = run(
            vqacpv2, argv("bc", "--test", "dev_test", "--tmode", "OOD",
                          "--load", "BEST_0", "--loadLXMERTQA", ""))
        del trainer_t
        preds = json.load(open(os.path.join(tmp, "bc", "OOD_predict.json")))
        answers = {p["question_id"]: p["answer"] for p in preds}
        acc = VQAEvaluator(test_raw).evaluate(answers)
        differ = sum(answers.get(q) != a for q, a in final_preds.items())
        want_t = want_launches(0, 1)
        emit("vqacp_test_arm", cli_lines=lines_t, predictions=len(preds),
             accuracy=acc, answers_differing_from_final_parameters=differ,
             launches=launches_t, expected_launches=want_t,
             seconds=seconds_t)
        check(len(preds) == VQACP_TEST["n_questions"] and all(
            a in set(label2ans) for a in answers.values()),
            f"{len(preds)} predictions")
        check(f"dev_test (OOD) accuracy: {acc * 100.:.2f}" in lines_t,
              f"test arm lines {lines_t}, accuracy {acc}")
        check(differ == 0 and len(answers) == len(final_preds),
              f"{differ} answers differ from the final parameters'")
        check(launches_t == want_t, f"launches {launches_t}, want {want_t}")
        shutil.rmtree(os.path.join(tmp, "bc"))
        peak_runs = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()

        # the baseline: one clean phase, one update per batch
        order.clear()
        torch.cuda.reset_peak_memory_stats()
        trainer_p, lines_p, launches_p, seconds_p = run(
            vqacpv2_baseline, argv("baseline"), patches=phase_patches)
        steps_p = steps_of("baseline")
        want_p = want_launches(len(steps_p), 1, phases=1)
        emit("vqacp_baseline", cli_lines=lines_p, steps=len(steps_p),
             branches=[r["branch"] for r in steps_p], phase_order=order,
             losses=steps_p, optimizer_count=trainer_p.state.opt_state.count,
             t_total=trainer_p.opt.t_total, launches=launches_p,
             expected_launches=want_p, seconds=seconds_p)
        check(len(steps_p) == n_batches and order == ["clean"] * n_batches
              and all(r["branch"] == "clean" for r in steps_p),
              f"baseline steps {steps_p}, phases {order}")
        check(trainer_p.state.opt_state.count == n_batches
              and trainer_p.opt.t_total == n_batches,
              f"baseline count {trainer_p.state.opt_state.count}, t_total "
              f"{trainer_p.opt.t_total}")
        check(all(math.isfinite(v) for r in steps_p for v in r.values()
                  if isinstance(v, float)), f"non-finite losses {steps_p}")
        check(launches_p == want_p, f"launches {launches_p}, want {want_p}")
        del trainer_p
        gc.collect()
        torch.cuda.empty_cache()

        emit("vqacp_timing", card=torch.cuda.get_device_name(0),
             run_a_ms_per_batch=clock_a.ms_per_step(),
             run_c_ms_per_batch=clock_c.ms_per_step(),
             snapshot_load_seconds=load.get("seconds"),
             resume_load_seconds=resume.get("seconds"),
             preempt_save_seconds=saves.get("seconds"),
             preempt_save_bytes=saves.get("bytes"),
             max_memory_allocated_bytes=peak_runs,
             baseline_max_memory_allocated_bytes=(
                 torch.cuda.max_memory_allocated()),
             seconds_so_far=time.perf_counter() - t_start)
        return {"run_a": launches_a, "run_b": launches_b, "run_c": launches_c,
                "test_arm": launches_t, "baseline": launches_p}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def int8_category(name: str) -> str:
    """`kernel_category`, with the int8 GEMMs of `torch._int_mm` apart."""
    low = name.lower()
    if "gemm" in low and re.search(r"s8|i8|int8|imma", low):
        return "int8 GEMM (torch._int_mm)"
    return kernel_category(name)


def int8_layers_exact(torch, sm, int8: dict, batch) -> dict:
    """One forward of `batch` with every Int8Dense's input and output
    captured; then, per layer, the int32 product of `int8_matmul` against
    the float64 product of the same int8 operands (exact: the sums stay far
    below 2^53), and the layer's output against its formula on that
    product."""
    from xggm_tpu_torch.serving.quant import dynamic_act_quant, int8_matmul

    seen, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):  # the first call's input and output
            seen.setdefault(name, (args[0].detach(), out.detach()))
        return hook

    for name, m in int8.items():
        hooks.append(m.register_forward_hook(keep(name)))
    try:
        sm.predict_logits(batch)
    finally:
        for hk in hooks:
            hk.remove()
    bad, shapes = [], set()
    for name, (x, y) in seen.items():
        m = int8[name]
        x_q, a_scale = dynamic_act_quant(x.reshape(-1, x.shape[-1]))
        acc = int8_matmul(x_q, m.weight)
        ref = x_q.double() @ m.weight.double().t()
        want = acc.float() * (a_scale * m.weight_scale)
        if m.bias is not None:
            want = want + m.bias.float()
        shapes.add(tuple(x_q.shape) + (m.weight.shape[0],))
        if not (torch.equal(acc.double(), ref) and torch.equal(
                want.to(m.dtype).reshape(y.shape), y)):
            bad.append(name)
    check(len(seen) == len(int8) and not bad,
          f"Int8Dense against float64 on the card: {len(seen)} of "
          f"{len(int8)} layers seen, differing {bad}")
    return dict(layers=len(seen), gemm_shapes_mkn=sorted(shapes))


def plant_answers(root: str, split: str, seed: int, feat_dim: int) -> None:
    """Give each image of the split's pack an answer, +3 in that answer's
    feature column of all its objects, and each of its questions that
    answer, named among filler words in a random place."""
    from xggm_tpu_torch.data.synthetic import ANSWERS, WORDS
    from xggm_tpu_torch.data.xpack import XPackFeatureStore, write_xpack
    from xggm_tpu_torch.utils.io import save_json

    rng = random.Random(seed)
    path = os.path.join(root, "gqa_imgfeat", f"{split}_obj36.xpack")
    store = XPackFeatureStore(path)
    records, truth = [], {}
    for img_id in store.img_ids():
        feats, boxes, adj = store.get(img_id)
        truth[img_id] = rng.randrange(len(ANSWERS))
        feats = feats.copy()
        feats[:, truth[img_id]] += 3.0
        records.append((img_id, feats, boxes, adj))
    store.close()
    write_xpack(records, path, feat_dim)
    fillers = [w for w in WORDS if w not in ANSWERS]
    path = os.path.join(root, "gqa_ood", f"{split}.json")
    with open(path) as f:
        questions = json.load(f)
    for q in questions:
        ans = ANSWERS[truth[q["img_id"]]]
        words = [rng.choice(fillers) for _ in range(rng.randint(2, 8))]
        words.insert(rng.randint(0, len(words)), ans)
        q["sent"], q["label"] = " ".join(words) + " ?", {ans: 1.0}
    save_json(questions, path)


def int8_on_a_learnt_model(torch, h: dict, card: str) -> None:
    """The int8 answer gate on a model that has learnt its task: a planted
    corpus the size of phase 10's, a trainer at full width and LEARN_DEPTH
    layers trained from random weights with `train_baseline` in fp32,
    saved, exported through `cli/export.py` in bf16 and int8 and loaded
    with `ServingModel.load`; int8 against bf16 over the validation split's
    questions at the bounds of tests/test_serving.py, and the bf16
    accuracy at least LEARN_MIN_ACCURACY."""
    import numpy as np

    from xggm_tpu_torch.cli import export
    from xggm_tpu_torch.cli.common import (
        build_parser, seed_everything, to_config)
    from xggm_tpu_torch.data.datasets import MemoryFeatureStore
    from xggm_tpu_torch.data.synthetic import make_synthetic_gqa, write_vocab
    from xggm_tpu_torch.data.xpack import XPackFeatureStore
    from xggm_tpu_torch.serving.artifact import ServingModel
    from xggm_tpu_torch.serving.server import InferenceEngine
    from xggm_tpu_torch.training.trainer import XGGMTrainer
    from xggm_tpu_torch.utils.device import resolve_device

    root = os.path.join(h["tmp"], "learn_data")
    out = os.path.join(h["tmp"], "learn_out")
    feat_dim = 2048
    for split, cut in (("train", TRAINER_TRAIN), ("val", TRAINER_VAL)):
        make_synthetic_gqa(root, split, feat_dim=feat_dim, pack=True, **cut)
        plant_answers(root, split, cut["seed"], feat_dim)
    write_vocab(os.path.join(root, "vocab.txt"))
    label2ans = h["label2ans"]
    write_answer_tables(root, label2ans)
    depth = ["--llayers", LEARN_DEPTH[0], "--xlayers", LEARN_DEPTH[1],
             "--rlayers", LEARN_DEPTH[2]]
    common = ["--data_root", root, "--output", out, "--bs", "96", "--seed",
              str(TRAINER_SEED), "--device", "cuda", "--xpack"] + depth
    args = build_parser().parse_args(common + [
        "--train", "train", "--valid", "", "--epochs", str(LEARN_EPOCHS),
        "--lr", str(LEARN_LR), "--dtype", "float32"])
    seed_everything(args.seed)
    trainer = XGGMTrainer(to_config(args, task="gqa"), task="gqa",
                          use_xpack=True, device=resolve_device("cuda"))
    stdout = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        trainer.train_baseline()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = trainer.state.opt_state.count
    trainer.save("LEARNT")
    trainer.ckpt.wait()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    pack = XPackFeatureStore(os.path.join(root, "gqa_imgfeat",
                                          "val_obj36.xpack"))
    store = MemoryFeatureStore({i: pack.get(i)[:2] for i in pack.img_ids()})
    pack.close()
    with open(os.path.join(root, "gqa_ood", "val.json")) as f:
        questions = json.load(f)
    split = list({(q["img_id"], q["sent"]): q for q in questions}.values())
    gold = [next(iter(q["label"])) for q in split]
    logits = {}
    for kind, flags in (("bf16", []), ("int8", ["--quantize", "int8"])):
        path = os.path.join(h["tmp"], f"learnt_{kind}")
        with contextlib.redirect_stdout(io.StringIO()):
            export.main(common + [
                "--task", "gqa", "--artifact", path, "--valid", "val",
                "--load", "LEARNT", "--dtype", "bfloat16", "--serve_bs",
                "0"] + flags)
        sm = ServingModel.load(path, device="cuda")
        engine = InferenceEngine(sm, h["tokenizer"], store)
        logits[kind] = sm.predict_logits(engine._assemble(
            [{"img_id": q["img_id"], "sent": q["sent"]} for q in split]))
        del sm, engine
        gc.collect()
        torch.cuda.empty_cache()
    s16, s8 = logits["bf16"], logits["int8"]
    rel = (((s8 - s16) ** 2).sum(-1) ** 0.5 / ((s16 ** 2).sum(-1) ** 0.5))
    same = s8.argmax(-1) == s16.argmax(-1)
    top2 = -np.sort(-s16, axis=-1)[:, :2]
    margin = top2[:, 0] - top2[:, 1]
    accuracy = {kind: float(np.mean([label2ans[i] == a for i, a in zip(
        lg.argmax(-1).tolist(), gold)])) for kind, lg in logits.items()}
    emit("export_serve_learnt", card=card, layers=list(LEARN_DEPTH),
         epochs=LEARN_EPOCHS, lr=LEARN_LR, updates=steps,
         train_seconds=train_s, log_lines=stdout.getvalue().splitlines(),
         split_questions=len(split), accuracy=accuracy,
         min_accuracy=LEARN_MIN_ACCURACY,
         bf16_answers_distinct=len(set(s16.argmax(-1).tolist())),
         int8_vs_bf16_max_row_rel_l2=float(rel.max()),
         int8_vs_bf16_median_row_rel_l2=float(np.median(rel)),
         int8_rel_l2_limit=INT8_REL_L2,
         int8_vs_bf16_argmax_agreement=float(same.mean()),
         min_argmax_agreement=MIN_ARGMAX_AGREEMENT,
         bf16_top1_margin_p10_median=[float(np.percentile(margin, 10)),
                                      float(np.median(margin))],
         bf16_top1_margin_of_differing=margin[~same].tolist(),
         int8_max_abs_err_median=float(np.median(abs(s8 - s16).max(-1))))
    check(bool(np.isfinite(s16).all() and np.isfinite(s8).all()),
          "learnt model: non-finite logits")
    check(accuracy["bf16"] >= LEARN_MIN_ACCURACY,
          f"learnt model: bf16 accuracy {accuracy['bf16']}, "
          f"{LEARN_MIN_ACCURACY} required")
    check(float(rel.max()) < INT8_REL_L2,
          f"learnt model: int8 vs bf16 relative L2 {float(rel.max())}")
    check(float(same.mean()) >= MIN_ARGMAX_AGREEMENT,
          f"learnt model: int8 vs bf16: {float(same.mean())} of the "
          f"answers the same, {MIN_ARGMAX_AGREEMENT} required")


def phase_export_serve(torch, attn, handoff: dict, card: str,
                       t_start: float) -> dict:
    """Phase 10's BEST_0 (full width, 1842 answers) exported through
    `cli/export.py` in bf16 and in int8, each loaded with
    `ServingModel.load` on the card and served through `InferenceEngine`
    and the HTTP server over the validation images in memory. Kernel 1
    counted over each artifact's POSTs (counts at 0 just before, read just
    after). Returns the counts."""
    import numpy as np

    from xggm_tpu_torch.cli import export
    from xggm_tpu_torch.ops.basic import Dense
    from xggm_tpu_torch.serving.artifact import ServingModel
    from xggm_tpu_torch.serving.quant import Int8Dense
    from xggm_tpu_torch.serving.server import InferenceEngine, make_server

    h = handoff
    queries_all = h["queries"]
    # the validation split's distinct questions, for the int8 check
    split = list({(q["img_id"], q["sent"]): q for q in queries_all}.values())

    def queries(n, offset=0):
        return [queries_all[(offset + i) % len(queries_all)]
                for i in range(n)]

    results, launches, logits, split_logits = {}, {}, {}, {}
    exact = None
    for kind, flags in (("bf16", []), ("int8", ["--quantize", "int8"])):
        path = os.path.join(h["tmp"], f"artifact_{kind}")
        argv = ["--task", "gqa", "--artifact", path, "--valid", "val",
                "--data_root", h["root"], "--output", h["out"], "--load",
                "BEST_0", "--xpack", "--device", "cuda", "--dtype",
                "bfloat16", "--serve_bs", "0", "--seed", str(TRAINER_SEED)]
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            export.main(argv + flags)
        export_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm = ServingModel.load(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        meta = sm.meta
        int8 = {n: m for n, m in sm.model.named_modules()
                if isinstance(m, Int8Dense)}
        dense = [n for n, m in sm.model.named_modules() if type(m) is Dense]
        check(meta["label2ans"] == h["label2ans"] and meta["batch_size"] is None
              and meta["quantize"] == (flags[-1] if flags else None)
              and not os.path.exists(os.path.join(path, "predict.stablehlo")),
              f"{kind} artifact meta: {str(meta)[:300]}")
        if kind == "bf16":
            check(not int8 and "bfloat16" in meta["param_dtypes"].values(),
                  f"bf16 artifact: {len(int8)} int8 layers")
            n_dense = len(dense)
        else:
            check(dense == ["logit_fc.fc2"] and len(int8) == n_dense - 1,
                  f"int8 artifact: {len(int8)} Int8Dense of {n_dense} Dense, "
                  f"plain Dense {dense}")

        engine = InferenceEngine(sm, h["tokenizer"], h["store"])
        server = make_server(engine, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the main path: counts at 0 just before, read just after
            attn.fused_attention.launches = 0
            for m in int8.values():
                m.calls = 0
            answers = [post(url + "/predict", {"queries": queries(n)})
                       for n in SERVE_BATCHES]
            torch.cuda.synchronize()
            launches[kind] = attn.fused_attention.launches
            calls = {n: m.calls for n, m in int8.items()}
            forwards = len(SERVE_BATCHES)
            vocab = set(h["label2ans"])
            for n, resp in zip(SERVE_BATCHES, answers):
                check(len(resp.get("answers", ())) == n and
                      all(a in vocab for a in resp["answers"]),
                      f"{kind} batch {n}: {str(resp)[:300]}")
            check(launches[kind] == LAUNCHES_PER_FORWARD * forwards,
                  f"{kind}: {launches[kind]} kernel-1 launches for "
                  f"{forwards} forwards")
            # each Int8Dense once a forward; the x-layers' cross-attention
            # serves both directions, twice
            want_calls = {n: forwards * (2 if ".visual_attention." in n
                                         else 1) for n in int8}
            check(calls == want_calls, f"Int8Dense calls {calls}")
            logits[kind] = sm.predict_logits(h["batch"])
            split_logits[kind] = sm.predict_logits(engine._assemble(split))
            if int8:
                exact = int8_layers_exact(torch, sm, int8, h["batch"])

            torch.cuda.reset_peak_memory_stats()
            lat, t0 = [], time.perf_counter()
            for i in range(SERVE_REQUESTS):
                t = time.perf_counter()
                resp = post(url + "/predict", {"queries": queries(64, 64 * i)})
                lat.append((time.perf_counter() - t) * 1e3)
                check(len(resp.get("answers", ())) == 64, str(resp)[:300])
            served = 64 * SERVE_REQUESTS / (time.perf_counter() - t0)
            big = engine._assemble(queries(512))
            for _ in range(2):
                sm.predict_logits(big)
            torch.cuda.synchronize()
            iters, t0 = 10, time.perf_counter()
            for _ in range(iters):
                sm.predict_logits(big)
            torch.cuda.synchronize()
            offline = 512 * iters / (time.perf_counter() - t0)
            profile = profile_call(torch, lambda: sm.predict_logits(big),
                                   int8_category)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        results[kind] = dict(
            artifact_bytes=size, export_seconds=export_s,
            load_seconds=load_s, export_lines=stdout.getvalue().splitlines(),
            param_dtypes=sorted(set(meta["param_dtypes"].values())),
            int8_layers=len(int8), int8_calls=sum(calls.values()),
            int8_exact_vs_float64=exact if int8 else None,
            kernel1_launches=launches[kind], forwards=forwards,
            served_pairs_per_s_bs64=served,
            served_p50_ms_bs64=statistics.median(lat),
            predict_logits_pairs_per_s_bs512=offline,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            answers_sample=answers[-1]["answers"][:8])
        emit(f"export_serve_{kind}_profile", card=card, forward_batch=512,
             **profile)
        del sm, engine, server, big
        gc.collect()
        torch.cuda.empty_cache()

    final = h["final_logits"]
    bf16, q8 = logits["bf16"], logits["int8"]
    diff = float(abs(bf16 - final).max())
    agree = float((bf16.argmax(-1) == final.argmax(-1)).mean())
    # int8 against bf16 over the split's distinct questions
    s16, s8 = split_logits["bf16"], split_logits["int8"]
    rel = (((s8 - s16) ** 2).sum(-1) ** 0.5 / ((s16 ** 2).sum(-1) ** 0.5))
    same = s8.argmax(-1) == s16.argmax(-1)
    agree8 = float(same.mean())
    # the bf16 top-1 margin of each question, and the int8 error beside it
    top2 = -np.sort(-s16, axis=-1)[:, :2]
    margin = top2[:, 0] - top2[:, 1]
    err = abs(s8 - s16).max(-1)
    emit("export_serve", card=card, artifacts=results,
         bf16_vs_final_parameters_max_abs_diff=diff, logits_atol=LOGITS_ATOL,
         bf16_vs_final_parameters_argmax_agreement=agree,
         split_questions=len(split),
         int8_vs_bf16_max_row_rel_l2=float(rel.max()),
         int8_vs_bf16_median_row_rel_l2=float(statistics.median(rel.tolist())),
         int8_rel_l2_limit=INT8_REL_L2, int8_vs_bf16_argmax_agreement=agree8,
         int8_vs_bf16_argmax_agreement_first_64=float(
             (q8.argmax(-1) == bf16.argmax(-1)).mean()),
         bf16_answers_distinct=len(set(s16.argmax(-1).tolist())),
         bf16_top1_margin_p10_median=[float(np.percentile(margin, 10)),
                                      float(np.median(margin))],
         bf16_top1_margin_of_differing=margin[~same].tolist(),
         int8_max_abs_err_of_differing=err[~same].tolist(),
         int8_max_abs_err_median=float(np.median(err)),
         logits_std=float(s16.std()),
         seconds_so_far=time.perf_counter() - t_start)
    check(bf16.shape == final.shape == (64, len(h["label2ans"])),
          f"logits shape {bf16.shape}")
    check(bool(np.isfinite(s16).all() and np.isfinite(s8).all()),
          "non-finite logits")
    check(diff <= LOGITS_ATOL and agree >= MIN_ARGMAX_AGREEMENT,
          f"bf16 artifact vs the final parameters: {diff}, {agree}")
    check(float(rel.max()) < INT8_REL_L2,
          f"int8 vs bf16: relative L2 {float(rel.max())}")
    int8_on_a_learnt_model(torch, h, card)
    return launches


def phase_generators(torch, attn, philox, card: str, t_start: float) -> dict:
    """The full-width GQA-OOD training model with the GIN and then the GAT
    generator (2 heads, merge projection): one relation and one
    representation batch of 96 through `make_ggm_train_step`, kernels 1 to
    3 counted over them (counts at 0 just before, read just after); each GGM
    branch's loss and gradients through the kernels against the plain
    attention; ms per batch and peak memory. Returns the counts by gnn."""
    counters = {"attention_fwd": attn.fused_attention,
                "attention_dropout_fwd": attn.attention_dropout_fwd,
                "attention_dropout_bwd": attn.attention_dropout_bwd}
    out = {}
    for gnn in ("GIN", "GAT"):
        t = train_setup(torch, fused=False, gnn=gnn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        state, losses = t.state, []
        for i, br in enumerate(GEN_PLAN):
            state, m = t.steps[br](state, t.batch, i)
            losses.append({k: float(v) for k, v in m.items()
                           if v.dim() == 0})
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        out[gnn] = launches
        want = {"attention_fwd": 0,
                "attention_dropout_fwd": FWD_LAUNCHES_PER_BATCH * len(GEN_PLAN),
                "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH * len(GEN_PLAN)}
        count = state.opt_state.count
        gen_params = {n: p.numel() for n, p in t.model.named_parameters()
                      if n.startswith("generator.")}
        emit(f"generators_{gnn}", plan=list(GEN_PLAN), losses=losses,
             launches=launches, expected_launches=want,
             optimizer_count=count, generator_tensors=len(gen_params),
             generator_params=sum(gen_params.values()),
             params=sum(p.numel() for p in t.model.parameters()))
        check(all(math.isfinite(x) for d in losses for x in d.values()),
              f"{gnn}: non-finite train loss {losses}")
        check(count == UPDATES_PER_BATCH * len(GEN_PLAN),
              f"{gnn}: optimizer count {count}")
        check(launches == want, f"{gnn}: launches {launches}, expected {want}")
        # the gates of phase 8: each loss, all gradients together and each
        # parameter's. GIN's eps [1] sums the products of every node's
        # features with their gradients, some 2.6 M terms that nearly
        # cancel, so a bf16 ulp of difference in the terms moves the sum
        # far from itself: in bf16 its difference is held to the
        # generator's whole gradient, and the same comparison from the same
        # parameters computing in fp32 holds it to its own
        eps = tuple(n for n in t.names if n.endswith(".eps"))
        kernels_vs_plain(torch, attn, philox, t, state,
                         f"generators_{gnn}_vs_plain", GEN_PLAN, apart=eps)
        if eps:
            t32 = train_setup(torch, fused=False, gnn=gnn, dtype="float32")
            with torch.no_grad():
                for n in t.names:
                    t32.state.params[n].copy_(state.params[n])
            kernels_vs_plain(torch, attn, philox, t32, t32.state,
                             f"generators_{gnn}_fp32_vs_plain", GEN_PLAN,
                             watch=eps)
            del t32
            gc.collect()
            torch.cuda.empty_cache()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(GEN_TIMED_BATCHES):
            state, m = t.steps[GEN_PLAN[i % 2]](state, t.batch, 1000 + i)
        final = float(m["clean_loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(math.isfinite(final), f"{gnn}: non-finite timed loss")
        emit(f"generators_{gnn}_timing", card=card,
             batches=GEN_TIMED_BATCHES, batch_size=t.train_b,
             ms_per_batch=dt / GEN_TIMED_BATCHES * 1e3,
             pairs_per_s=t.train_b * GEN_TIMED_BATCHES / dt,
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
             seconds_so_far=time.perf_counter() - t_start)
        del t, state, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pretrain_category(name: str) -> str:
    """kernel_category, with the fp32 GEMMs (the tied decoder's, the only
    fp32 products of a bf16 pretraining step: cuBLAS's f32f32 xmma and
    CUTLASS's simt sgemm kernels) apart."""
    if "f32f32_f32f32" in name or "sgemm" in name:
        return "GEMM fp32 (tied decoder)"
    return kernel_category(name)


def pretrain_corpus(root: str) -> None:
    """The pretraining corpus: TSV features (the card's machine has no
    h5py), 2048-d, object ids below 1600 and attribute ids below 400; the
    training source holds PRETRAIN_STEPS batches of PRETRAIN_BS sentences,
    the validation source one; an all_ans.json of PRETRAIN_ANSWERS answers,
    the corpus's among them."""
    from xggm_tpu_torch.data.synthetic import ANSWERS
    from xggm_tpu_torch.data.synthetic_pretrain import make_synthetic_pretrain
    from xggm_tpu_torch.utils.io import save_json

    for source, kw in PRETRAIN_SOURCES.items():
        make_synthetic_pretrain(root, source, feat_dim=2048, tsv=True, **kw)
    answers = ANSWERS + [f"answer_{i}" for i in
                         range(len(ANSWERS), PRETRAIN_ANSWERS)]
    save_json([{"ans": a, "dsets": ["vqa", "gqa", "visual7w"]}
               for a in answers],
              os.path.join(root, "lxmert", "all_ans.json"))


def pretrain_launches_per_pass(model) -> tuple:
    """Attention launches of one forward and of one backward, from the
    model: a language layer and an r-layer attend once, an x-layer four
    times (both cross directions and both self-attentions). Every attention
    gets a gradient when the visual heads read the last x-layer's visual
    stream; without them, its visual self-attention and visual->language
    cross-attention feed no loss."""
    v = model.cfg.visual
    forward = v.l_layers + v.r_layers + 4 * v.x_layers
    return forward, forward if model.task_obj_predict else forward - 2


def phase_pretrain(torch, attn, philox, card: str, t_start: float) -> dict:
    """LXMERT pretraining through `cli/pretrain.py` at the width of
    scripts/pretrain.sh (9/5/5 layers, hidden 768, 12 heads, vocabulary
    30522, 1600 objects, 400 attributes, 2048-d features, 9500 answers),
    batch 256, all four tasks, in bf16: run A one epoch of PRETRAIN_STEPS
    steps and a validation batch; run B the same with --accum_steps 2 --bs
    128. Kernels 1 to 3 counted over each run (counts at 0 just before,
    read just after); BertAdam's count and t_total; Epoch01 and
    BEST_EVAL_LOSS. Then, on B's model, one batch's loss and gradients
    through the kernels against the plain attention (phase 8's gates), ms
    per step on a resident batch, the featurizer's host ms per batch, peak
    memory, one profiled step and the tied decoder's time. Returns the
    launches by run."""
    from xggm_tpu_torch.cli import pretrain
    from xggm_tpu_torch.ops.basic import DropoutRng
    from xggm_tpu_torch.models.lxmert import tied_logits

    counters = {"attention_fwd": attn.fused_attention,
                "attention_dropout_fwd": attn.attention_dropout_fwd,
                "attention_dropout_bwd": attn.attention_dropout_bwd}
    tmp = tempfile.mkdtemp(prefix="xggm_pretrain_")
    out = {}
    try:
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        pretrain_corpus(root)
        corpus_s = time.perf_counter() - t0
        base = ["--data_root", root, "--train", "mscoco_train",
                "--valid", "mscoco_minival", "--llayers", "9", "--xlayers",
                "5", "--rlayers", "5", "--lr", "1e-4", "--epochs", "1",
                "--taskMaskLM", "--taskObjPredict", "--taskMatched",
                "--taskQA", "--visualLosses", "obj,attr,feat", "--qaSets",
                "vqa,gqa,visual7w", "--fromScratch", "--seed", "9595"]
        trainer = None
        for run, (bs, accum) in PRETRAIN_RUNS.items():
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            output = os.path.join(tmp, f"out_{run}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stdout = io.StringIO()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                trainer = pretrain.main(base + [
                    "--bs", str(bs), "--accum_steps", str(accum),
                    "--output", output])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {name: c.launches for name, c in counters.items()}
            out[run] = launches
            lines = stdout.getvalue().splitlines()
            n_train = len(trainer.train_feat)
            n_valid = len(trainer.valid_feat)
            micro = n_train // bs
            updates = micro // accum
            per_fwd, per_bwd = pretrain_launches_per_pass(trainer.model)
            want = {"attention_fwd": per_fwd * (n_valid // bs),
                    "attention_dropout_fwd": per_fwd * micro,
                    "attention_dropout_bwd": per_bwd * micro}
            epoch = [ln for ln in lines if ln.startswith("Epoch 0: ")]
            losses = {}
            if epoch:
                # Epoch 0: train loss X Mask_LM: X Matched: X ...
                parts = epoch[0].split()
                losses = {"train loss": float(parts[4])}
                losses.update((parts[i].rstrip(":"), float(parts[i + 1]))
                              for i in range(5, len(parts) - 1, 2))
            saved = sorted(d for d in os.listdir(output)
                           if not d.startswith("."))
            emit(f"pretrain_{run}", card=card, batch_size=bs,
                 accum_steps=accum, sentences=n_train,
                 valid_sentences=n_valid, microbatches=micro,
                 launches=launches, expected_launches=want,
                 optimizer_count=trainer.state.opt_state.count,
                 t_total=trainer.t_total, expected_updates=updates,
                 lines=lines, losses=losses, saved=saved,
                 params=sum(p.numel() for p in trainer.model.parameters()),
                 run_seconds=run_s, corpus_seconds=corpus_s,
                 checkpoint_saves=trainer.ckpt.history,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 seconds_so_far=time.perf_counter() - t_start)
            names = ("train loss", "Mask_LM", "Matched", "Obj", "Attr",
                     "Feat", "QA")
            check(len(epoch) == 1 and set(losses) == set(names)
                  and all(math.isfinite(v) for v in losses.values()),
                  f"pretrain {run}: epoch line {epoch}")
            check(any(ln.startswith("valid loss ") for ln in lines),
                  f"pretrain {run}: no validation line")
            check(trainer.state.opt_state.count == updates == trainer.t_total
                  == PRETRAIN_STEPS,
                  f"pretrain {run}: {trainer.state.opt_state.count} updates,"
                  f" t_total {trainer.t_total}, expected {updates}")
            check(per_fwd == per_bwd == LAUNCHES_PER_FORWARD,
                  f"pretrain {run}: {per_fwd} and {per_bwd} attentions per "
                  f"pass, expected {LAUNCHES_PER_FORWARD}")
            check(launches == want,
                  f"pretrain {run}: launches {launches}, expected {want}")
            check({"Epoch01", "BEST_EVAL_LOSS"} <= set(saved),
                  f"pretrain {run}: saved {saved}")
            shutil.rmtree(output, ignore_errors=True)

        # on run B's model: kernels vs plain, times and the profile
        model = trainer.model
        batch_np, _ = trainer.train_feat.featurize(
            list(range(PRETRAIN_BS)))
        batch = trainer.put(batch_np)
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]

        def plain_dropout(q, k, v, bias, heads, seed, rate):
            keep = philox.dropout_keep(seed, q.shape[0], q.shape[1],
                                       k.shape[1], rate, q.device)
            return attn.attention_dropout_reference(q, k, v, bias, heads,
                                                    keep)

        def loss_and_grads():
            total = model.compute_losses(
                batch, DropoutRng(100, trainer.device))[0]
            return float(total.detach()), torch.autograd.grad(total, params)

        loss_k, grads_k = loss_and_grads()
        with mock.patch.object(attn, "fused_attention_dropout",
                               plain_dropout):
            loss_p, grads_p = loss_and_grads()
        word = names.index("lxrt.embeddings.word_embeddings.weight")
        row0 = float(grads_k[word][0].float().norm())
        word_rel = float((grads_k[word].float() - grads_p[word].float()).norm()
                         / grads_p[word].float().norm())
        agree = dict(kernels=loss_k, plain=loss_p,
                     loss_rel_diff=abs(loss_k - loss_p) / abs(loss_p),
                     word_table_grad_rel_l2=word_rel,
                     word_table_row0_grad_norm=row0,
                     **grad_agreement(torch, names, grads_k, grads_p))
        del grads_k, grads_p
        emit("pretrain_vs_plain", batch_size=PRETRAIN_BS, **agree,
             loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL,
             param_grad_rtol=PARAM_GRAD_RTOL)
        check(agree["same_graph"] and agree["loss_rel_diff"] <= LOSS_RTOL
              and agree["grad_rel_l2"] <= GRAD_RTOL
              and agree["max_param_grad_rel_l2"] <= PARAM_GRAD_RTOL
              and word_rel <= PARAM_GRAD_RTOL and row0 > 0,
              f"pretrain: kernels vs plain attention {agree}")

        # ms per step on a resident batch, the featurizer's host time
        trainer.train_step(batch, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(PRETRAIN_TIMED_STEPS):
            loss, _, _ = trainer.train_step(batch, 2 + i)
        final = float(loss)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / PRETRAIN_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated()
        check(math.isfinite(final), "pretrain: non-finite timed loss")
        t0 = time.perf_counter()
        for i in range(2):
            host = trainer.train_feat.featurize(
                list(range(i * PRETRAIN_BS, (i + 1) * PRETRAIN_BS)))[0]
        featurize_ms = (time.perf_counter() - t0) / 2 * 1e3
        # one rank's half of a batch, as each of two ranks builds it: the
        # draws of every row, the arrays of its own
        t0 = time.perf_counter()
        for i in range(2):
            trainer.train_feat.featurize(
                list(range(i * PRETRAIN_BS, (i + 1) * PRETRAIN_BS)),
                range(PRETRAIN_BS // 2, PRETRAIN_BS))
        featurize_half_ms = (time.perf_counter() - t0) / 2 * 1e3
        t0 = time.perf_counter()
        trainer.put(host)
        torch.cuda.synchronize()
        put_ms = (time.perf_counter() - t0) * 1e3
        seeds = iter(range(3000, 3010))
        prof = profile_call(torch, lambda: trainer.train_step(batch,
                                                              next(seeds)),
                            pretrain_category)
        busy = prof["device_busy_ms"]
        # the tied decoder alone: forward and backward at the step's shape
        table = model.lxrt.embeddings.word_embeddings.weight
        vocab, hidden = table.shape
        lang = torch.randn(PRETRAIN_BS, 20, hidden, device=trainer.device,
                           dtype=torch.bfloat16, requires_grad=True)

        def decoder():
            logits = tied_logits(lang, table)
            torch.autograd.grad(logits, (lang, table), torch.ones_like(logits))

        decoder_ms = cuda_ms(decoder, iters=5, warmup=2)
        emit("pretrain_timing", card=card, batch_size=PRETRAIN_BS,
             ms_per_step=step_s * 1e3, pairs_per_s=PRETRAIN_BS / step_s,
             steps=PRETRAIN_TIMED_STEPS, final_loss=final,
             featurize_host_ms_per_batch=featurize_ms,
             featurize_host_ms_per_batch_one_of_two_ranks=featurize_half_ms,
             put_host_ms_per_batch=put_ms,
             max_memory_allocated_bytes=peak,
             profile=dict(prof, timed_ms_per_step=step_s * 1e3,
                          device_idle_share=(1.0 - busy / (step_s * 1e3))
                          if busy else None),
             tied_decoder_fwd_bwd_ms=decoder_ms,
             tied_decoder_flops=3 * 2 * PRETRAIN_BS * 20 * hidden * vocab,
             seconds_so_far=time.perf_counter() - t_start)
        del trainer, model, batch, params, lang, table
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The scale-out phase: a world of one over NCCL through the CLI (bit for
# bit against the run without the flags), two ranks on the one card over
# gloo (NCCL takes one rank per device) against one rank at the global
# batch (in bf16, and once in fp32 as the witness of the bf16 gate), and
# remat against the plain encoder.
SCALE_OUT_RANKS = 2
SCALE_OUT_PLAN = ("relation", "representation")
SCALE_OUT_RANK_TIMEOUT = 400
# two ranks of 48 rows against one rank of 96 (dropout off, the GGM noise
# replayed): only summation orders differ, in bf16 GEMMs. Gated: the two
# phases' losses, whose gradients the updates take. Their terms are
# printed beside them: the representation branch's d_loss, a symmetric KL
# of two nearly equal distributions times 1842, read 6.8e-4 relative apart
# on an H100 80GB HBM3 (700 W), its cancellation amplifying the bf16
# rounding of GEMMs over 48 rows against 96 (step 1's terms 1e-6 apart).
# In fp32 the same run gates every term at DP_LOSS_RTOL.
DP_LOSS_RTOL = 1e-4
DP_GATED_LOSSES = ("ggm_loss", "clean_loss")
# (dtype, BertAdam fused, ZeRO-1) of each two-rank run
SCALE_OUT_RUNS = (("bfloat16", False, False), ("bfloat16", False, True),
                  ("bfloat16", True, False), ("bfloat16", True, True),
                  ("float32", False, True))
# remat against the plain encoder from the same seeds: the recompute runs
# the same kernels on the same inputs
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL = 1e-6, 1e-3
REMAT_TIMED_BATCHES = 3
# the recompute runs every checkpointed layer's forward again in the
# backward, its attentions included: each phase's 34 kernel-2 launches
# twice, the clean phase's last-layer visual ones too (their backward
# still does not run)
REMAT_FWD_LAUNCHES_PER_BATCH = 2 * FWD_LAUNCHES_PER_BATCH
# BertAdam's t_total in (b). At phase 8's 10,000 the first updates
# (lr 2e-8 to 6e-8) move a LayerNorm scale by about one fp32 ulp, so their
# rounding, not the update, would decide the comparison of the updates; at
# 200 (lr 1e-6 to 3e-6) an update moves it by some 170 ulps.
SCALE_OUT_T_TOTAL = 200


def scale_out_batches(torch, t) -> dict:
    """Phase 8's batch of 96 for each branch with its GGM noise drawn once
    for the global batch (`noise_override`), so that each rank replays its
    rows of the single-rank draw."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    b, hid = t.train_b, t.cfg.lxmert.bert.hidden_size
    upper = torch.randn(b, 36, 36, device="cuda", generator=gen).triu(1)
    return {"relation": {**t.batch,
                         "noise_override": upper + upper.transpose(1, 2)},
            "representation": {**t.batch, "noise_override": torch.randn(
                b, 36, hid, device="cuda", generator=gen)}}


def scale_out_counters(attn, fa) -> dict:
    return {"attention_fwd": attn.fused_attention,
            "attention_dropout_fwd": attn.attention_dropout_fwd,
            "attention_dropout_bwd": attn.attention_dropout_bwd,
            "bert_adam": fa.fused_adam}


def scale_out_trajectory(torch, t, batches, counters, rows=None) -> dict:
    """The 2-step trajectory (relation, representation) of `t` on `rows`
    (a slice; all rows by default): each step's scalar losses (the
    group's mean) and ms, the counts of `counters` over it, and the
    BertAdam counters and flags after it."""
    for c in counters.values():
        c.launches = 0
    state, record = t.state, []
    for i, br in enumerate(SCALE_OUT_PLAN):
        batch = {k: v if rows is None else v[rows]
                 for k, v in batches[br].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = t.steps[br](state, batch, i)
        torch.cuda.synchronize()
        record.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           losses={k: float(v) for k, v in m.items()
                                   if v.dim() == 0}))
    return dict(record=record,
                launches={k: c.launches for k, c in counters.items()},
                leaf_count=state.opt_state.leaf_counts(),
                active=state.opt_state.active_flags(),
                count=state.opt_state.count)


def scale_out_rank(coordinator: str, rank: int, workdir: str) -> int:
    """One of the two ranks of phase 15 (b), on the one card over gloo:
    for each run of SCALE_OUT_RUNS, the trajectory on this rank's 48 rows
    from the seeded initial parameters and a fresh BertAdam state; rank 0
    first runs each (dtype, optimizer)'s single-rank trajectory at 96 and
    holds the two ranks' to it, gating the losses of DP_GATED_LOSSES in
    bf16 and every loss term in fp32. Writes {workdir}/rank{rank}.json."""
    import torch

    from xggm_tpu_torch.ops import attention as attn
    from xggm_tpu_torch.ops import fused_adam as fa
    from xggm_tpu_torch.parallel import (
        gathered_opt_state, host_barrier, init_distributed, make_mesh,
        maybe_zero_shard_state, shutdown_distributed)
    from xggm_tpu_torch.training.steps import TrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coordinator, SCALE_OUT_RANKS, rank, backend="gloo",
                     device="cuda:0", timeout_s=SCALE_OUT_RANK_TIMEOUT)
    try:
        mesh = make_mesh(device="cuda:0")
        counters = scale_out_counters(attn, fa)
        out = dict(rank=rank, backend=mesh.backend, runs=[])
        t = refs = built = None
        for dtype, fused, zero in SCALE_OUT_RUNS:
            if dtype != built:
                built = dtype
                del t
                gc.collect()
                torch.cuda.empty_cache()
                t = train_setup(torch, fused=False, dtype=dtype,
                                dropout=False)
                t.opt.t_total = SCALE_OUT_T_TOTAL
                batches = scale_out_batches(torch, t)
                init = [p.detach().clone() for p in t.state.params.values()]
                rows_per_rank = t.train_b // SCALE_OUT_RANKS
                rows = slice(rank * rows_per_rank, (rank + 1) * rows_per_rank)
                refs = {}

            def fresh(mesh_or_none, zero_or_not: bool) -> None:
                """The initial parameters and a new BertAdam state."""
                with torch.no_grad():
                    torch._foreach_copy_(list(t.state.params.values()), init)
                t.opt.fused = fused
                t.state = TrainState.create(t.model, t.opt, mesh_or_none)
                maybe_zero_shard_state(t.state, mesh_or_none, zero_or_not)

            if rank == 0 and fused not in refs:
                fresh(None, False)
                refs[fused] = scale_out_trajectory(torch, t, batches,
                                                   counters)
                refs[fused]["params"] = [p.detach().clone()
                                         for p in t.state.params.values()]
            ref = refs.get(fused)
            fresh(mesh, zero)
            sharded = len(t.state.opt_state.shards or {})
            host_barrier(f"run_{dtype}_{fused}_{zero}")
            got = scale_out_trajectory(torch, t, batches, counters, rows)
            whole = gathered_opt_state(t.state.opt_state, mesh)
            row = dict(dtype=dtype, fused=fused, zero=zero,
                       rows=rows_per_rank, sharded_leaves=sharded,
                       ms_per_global_batch=[r["ms"] for r in got["record"]],
                       launches=got["launches"], count=got["count"])
            if ref is not None:
                deltas = [p.detach() - p0 for p, p0 in
                          zip(t.state.params.values(), init)]
                want = [p - p0 for p, p0 in zip(ref["params"], init)]
                rel = [{k: abs(g["losses"][k] - v) / max(abs(v), 1e-12)
                        for k, v in w["losses"].items()}
                       for g, w in zip(got["record"], ref["record"])]
                gated = (DP_GATED_LOSSES if dtype == "bfloat16"
                         else tuple(ref["record"][0]["losses"]))
                loss_rel = max(r[k] for r in rel for k in gated
                               if k in r)
                row.update(
                    reference_ms_per_batch=[r["ms"] for r in ref["record"]],
                    reference_launches=ref["launches"],
                    losses=[r["losses"] for r in got["record"]],
                    reference_losses=[r["losses"] for r in ref["record"]],
                    gated_losses=gated, loss_rel_diffs=rel,
                    loss_rel_diff=loss_rel,
                    counters_flags_equal=(
                        got["leaf_count"] == ref["leaf_count"]
                        and got["active"] == ref["active"]
                        and got["count"] == ref["count"]),
                    moments_whole=all(
                        whole.m[n].shape == p.shape
                        for n, p in t.state.params.items()),
                    update_agreement=grad_agreement(
                        torch, t.names, deltas, want))
                del deltas, want
            out["runs"].append(row)
            del whole
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def scale_out_two_ranks(torch) -> dict:
    """Phase 15 (b): the two ranks in processes of their own, each
    stopped at its time limit; their rows checked here."""
    workdir = tempfile.mkdtemp(prefix="xggm_scale_out_")
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        coordinator = f"127.0.0.1:{port}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--scale-out-rank",
             coordinator, str(r), workdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(SCALE_OUT_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=SCALE_OUT_RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            check(p.returncode == 0,
                  f"scale-out rank {r} exited {p.returncode}:\n{text[-4000:]}")
        ranks = [json.load(open(os.path.join(workdir, f"rank{r}.json")))
                 for r in range(SCALE_OUT_RANKS)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rows = ranks[0]["runs"]
    emit("scale_out_two_ranks", backend=ranks[0]["backend"],
         wall_seconds=wall, runs=rows,
         rank1_launches=[r["launches"] for r in ranks[1]["runs"]],
         loss_rtol=DP_LOSS_RTOL, grad_rtol=GRAD_RTOL,
         param_grad_rtol=PARAM_GRAD_RTOL,
         note="two ranks share one card: ms per global batch is no gain "
              "to claim; dropout off, the GGM noise replayed")
    per_batch = {"attention_fwd": FWD_LAUNCHES_PER_BATCH,
                 "attention_dropout_fwd": 0,
                 "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH}
    for row, other in zip(rows, ranks[1]["runs"]):
        agree = row["update_agreement"]
        want = {k: n * len(SCALE_OUT_PLAN) for k, n in per_batch.items()}
        want["bert_adam"] = (UPDATES_PER_BATCH * len(SCALE_OUT_PLAN)
                             if row["fused"] else 0)
        check(ranks[0]["backend"] == ranks[1]["backend"] == "gloo",
              f"backend {ranks[0]['backend']}")
        check(row["launches"] == other["launches"] == want
              == row["reference_launches"],
              f"two-rank launches {row['launches']}, {other['launches']}, "
              f"expected {want} (reference {row['reference_launches']})")
        check(row["loss_rel_diff"] <= DP_LOSS_RTOL,
              f"two ranks against one, {row['dtype']} losses "
              f"{row['gated_losses']}: {row}")
        check(row["counters_flags_equal"] and row["moments_whole"],
              f"two ranks against one, counters and flags: {row}")
        check(agree["same_graph"] and agree["grad_rel_l2"] <= GRAD_RTOL
              and agree["max_param_grad_rel_l2"] <= PARAM_GRAD_RTOL,
              f"two ranks against one, parameter updates: {agree}")
        check((row["sharded_leaves"] > 0) == row["zero"],
              f"ZeRO layout: {row['sharded_leaves']} split leaves")
    return {k: sum(r["launches"][k] + o["launches"][k]
                   for r, o in zip(rows, ranks[1]["runs"]))
            for k in rows[0]["launches"]}


def scale_out_world_of_one(torch, attn, fa, tmp: str) -> dict:
    """Phase 15 (a): `cli/gqa_ood.py` for an epoch of 4 batches of 96 (no
    validation), once as it is and once with --multiGPU
    --shard_opt_state: a world of one over NCCL, whose group averages and
    gathers nothing, so the losses, the parameters and the BertAdam
    counters are those of the first run bit for bit."""
    from xggm_tpu_torch.cli import gqa_ood
    from xggm_tpu_torch.config import gqa_ood_config
    from xggm_tpu_torch.data.synthetic import (
        ANSWERS, make_synthetic_gqa, write_vocab)

    cfg = gqa_ood_config()
    bs, feat_dim = cfg.train.batch_size, cfg.lxmert.visual.visual_feat_dim
    root = os.path.join(tmp, "data")
    make_synthetic_gqa(root, "train", feat_dim=feat_dim, pack=True,
                       **TRAINER_TRAIN)
    write_vocab(os.path.join(root, "vocab.txt"))
    write_answer_tables(root, ANSWERS + [
        f"answer_{i}" for i in range(len(ANSWERS), cfg.num_answers)])
    argv = ["--train", "train", "--valid", "", "--data_root", root, "--bs",
            str(bs), "--epochs", "1", "--lr", str(cfg.train.lr), "--seed",
            str(TRAINER_SEED), "--device", "cuda", "--xpack", "--dtype",
            "bfloat16"]
    counters = scale_out_counters(attn, fa)
    runs = {}
    for name, extra in (("single", []),
                        ("world_of_one", ["--multiGPU",
                                          "--shard_opt_state"])):
        out = os.path.join(tmp, name)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = gqa_ood.main(argv + ["--output", out] + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in
                open(os.path.join(out, "metrics.jsonl"))]
        runs[name] = dict(
            seconds=seconds,
            launches={k: c.launches for k, c in counters.items()},
            losses=[{k: v for k, v in r.items() if k not in ("step", "ts")}
                    for r in recs if "branch" in r],
            mesh=None if trainer.mesh is None else dict(
                size=trainer.mesh.size, backend=trainer.mesh.backend),
            sharded_leaves=len(trainer.state.opt_state.shards or {}),
            counts=trainer.state.opt_state.leaf_counts(),
            count=trainer.state.opt_state.count,
            params={n: p.detach().clone()
                    for n, p in trainer.model.named_parameters()})
        del trainer
        gc.collect()
    single, one = runs["single"], runs["world_of_one"]
    same_params = all(torch.equal(one["params"][n], p)
                      for n, p in single["params"].items())
    n_batches = TRAINER_TRAIN["n_questions"] // bs
    want = {"attention_fwd": 0,
            "attention_dropout_fwd": FWD_LAUNCHES_PER_BATCH * n_batches,
            "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH * n_batches,
            "bert_adam": 0}
    emit("scale_out_world_of_one", mesh=one["mesh"],
         sharded_leaves=one["sharded_leaves"],
         seconds={k: r["seconds"] for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         expected_launches=want, losses=one["losses"],
         losses_equal=one["losses"] == single["losses"],
         params_equal=same_params,
         counters_equal=(one["counts"] == single["counts"]
                         and one["count"] == single["count"]))
    check(one["mesh"] == {"size": 1, "backend": "nccl"},
          f"world of one: {one['mesh']}")
    check(one["sharded_leaves"] > 0, "world of one: no ZeRO layout")
    check(len(one["losses"]) == n_batches and one["losses"]
          == single["losses"], f"world of one, losses: {one['losses']} "
                               f"against {single['losses']}")
    check(same_params and one["counts"] == single["counts"]
          and one["count"] == single["count"] == UPDATES_PER_BATCH
          * n_batches, "world of one: parameters or counters differ")
    check(one["launches"] == single["launches"] == want,
          f"world of one, launches {one['launches']}, single "
          f"{single['launches']}, expected {want}")
    return one["launches"]


def scale_out_remat(torch, attn, fa) -> tuple:
    """Phase 15 (c): the training model at batch 96, dropout on, with
    and without remat (`encoder.remat`, one model): one relation GGM
    phase's loss and gradients, the launches of the plan's two batches
    under remat, and ms per batch and peak memory each way in turns.
    Returns the remat launches."""
    from xggm_tpu_torch.training.steps import make_ggm_loss, phase_seeds

    t = train_setup(torch, fused=False)
    enc = t.model.lxrt.encoder
    params = [t.state.params[n] for n in t.names]
    ggm_dropout, ggm_noise, _ = phase_seeds(300)
    loss_fn = make_ggm_loss(t.model, t.tc, "relation")
    got = {}
    for remat in (False, True):
        enc.remat = remat
        loss = loss_fn(t.batch, ggm_dropout, ggm_noise)[0]
        got[remat] = (float(loss.detach()), torch.autograd.grad(
            loss, params, allow_unused=True))
        del loss
    (loss_p, grads_p), (loss_r, grads_r) = got[False], got[True]
    agree = grad_agreement(torch, t.names, grads_r, grads_p)
    del got, grads_p, grads_r

    counters = scale_out_counters(attn, fa)
    enc.remat = True
    for c in counters.values():
        c.launches = 0
    state = t.state
    for i, br in enumerate(SCALE_OUT_PLAN):
        state, m = t.steps[br](state, t.batch, i)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    n = len(SCALE_OUT_PLAN)
    want = {"attention_fwd": 0,
            "attention_dropout_fwd": REMAT_FWD_LAUNCHES_PER_BATCH * n,
            "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH * n,
            "bert_adam": 0}

    turns = []
    for remat in (False, True, True, False):
        enc.remat = remat
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(REMAT_TIMED_BATCHES):
            br = SCALE_OUT_PLAN[i % 2]
            state, m = t.steps[br](state, t.batch, 2000 + i)
        final = float(m["clean_loss"])
        torch.cuda.synchronize()
        turns.append(dict(
            remat=remat, ms_per_batch=(time.perf_counter() - t0) * 1e3
            / REMAT_TIMED_BATCHES,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            final_clean_loss=final))
    enc.remat = False
    loss_rel = abs(loss_r - loss_p) / abs(loss_p)
    emit("scale_out_remat", loss=loss_r, plain_loss=loss_p,
         loss_rel_diff=loss_rel, loss_rtol=REMAT_LOSS_RTOL,
         grad_rtol=REMAT_GRAD_RTOL, grads=agree, launches=launches,
         expected_launches=want, turns=turns)
    check(loss_rel <= REMAT_LOSS_RTOL, f"remat loss {loss_r} against "
                                       f"{loss_p}")
    check(agree["same_graph"] and agree["grad_rel_l2"] <= REMAT_GRAD_RTOL,
          f"remat gradients: {agree}")
    check(launches == want, f"remat launches {launches}, expected {want}")
    check(all(math.isfinite(x["final_clean_loss"]) for x in turns),
          f"non-finite loss in the remat turns: {turns}")
    del t, state
    return launches


def phase_scale_out(torch, attn, fa, t_start: float) -> dict:
    """Phase 15: (a) to (c) above. Returns each part's kernel launches."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xggm_world_of_one_")
    try:
        world_of_one = scale_out_world_of_one(torch, attn, fa, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    two_ranks = scale_out_two_ranks(torch)
    remat = scale_out_remat(torch, attn, fa)
    gc.collect()
    torch.cuda.empty_cache()
    emit("scale_out", seconds=time.perf_counter() - t0,
         seconds_so_far=time.perf_counter() - t_start)
    return {"world_of_one": world_of_one, "two_ranks": two_ranks,
            "remat": remat}


# ---------------------------------------------------------------- phase 16

# Phase 16: the stacked-layers layout, tensor parallelism (TP) and the GPipe
# pipeline (PP), at full width, GCN, batch 96, dropout off and the GGM noise
# replayed, the two-step plan of phase 15. Two ranks on the one card over
# gloo (NCCL takes one rank per device), started as processes of their own
# (`--model-parallel-rank`); rank 0 also runs the one-rank references.
MP_RANKS = 2
MP_COMPOSED_RANKS = 4
MP_RANK_TIMEOUT = 600
MP_MICROBATCHES = 4
MP_TIMED_BATCHES = 3
# (a) the stacked layout against the per-layer one: the same kernels on the
# same values (a stacked leaf's slice is the layer's weight; each slice's
# gradient lands in its own rows), so only the global norm's summation
# order differs (its leaves are grouped otherwise).
STACKED_LOSS_RTOL = 1e-5
# (b), (c) in fp32: every loss term, and the parameter updates' relative L2
# over all parameters together.
MP_FP32_LOSS_RTOL = 1e-5
MP_FP32_UPDATE_RTOL = 1e-4
# Launches per two-phase batch of each pipeline stage (S = 2, M = 4),
# dropout off (kernel 1 forward, kernel 3 at rate 0 backward): 9/5/5
# layers pad to 20 virtual layers; stage 0 runs lang 0-8 and visn 0 (10
# attentions a microbatch), stage 1 visn 1-4, x 0-4 (4 attentions each)
# and one identity layer (24). The clean phase's loss reads no visual
# output, so the last stage sends back no visual gradient for the last
# x-layer and its two visual attentions run no backward (22).
PP_ATTENTIONS = {0: 10, 1: 24}
PP_FWD_PER_BATCH = {s: 2 * n * MP_MICROBATCHES
                    for s, n in PP_ATTENTIONS.items()}
PP_BWD_PER_BATCH = {0: 2 * 10 * MP_MICROBATCHES,
                    1: (24 + 22) * MP_MICROBATCHES}


def same_across(torch, tensors, group, size) -> bool:
    """Whether `tensors` (fp32) are bit-identical on every rank of `group`:
    two int64 digests of each one's bits (their sum, and their sum
    weighted by the position mod 65521, plus one) gathered and compared."""
    import torch.distributed as dist

    if size == 1:
        return True
    digests = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        digests += [bits.sum(), (bits * weight).sum()]
        del bits, weight
    mine = torch.stack(digests)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine, group=group)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def unstacked(params: dict) -> dict:
    """A stacked model's parameters by the per-layer model's names: each
    [L, ...] leaf's slice i under layer i's name."""
    out = {}
    for n, x in params.items():
        m = re.match(r"^(.*\.encoder\.)(lang|r|x)_stack\.layer\.(.*)$", n)
        if m is None:
            out[n] = x
            continue
        group = {"lang": "layer", "r": "r_layers", "x": "x_layers"}[m[2]]
        for i in range(x.shape[0]):
            out[f"{m[1]}{group}.{i}.{m[3]}"] = x[i]
    return out


def stacked_state_dict(lx, model) -> dict:
    """`model`'s (per-layer) parameters in the stacked layout of `lx`."""
    from xggm_tpu_torch.checkpoint.jax_params import (
        from_jax_params, to_jax_params)
    from xggm_tpu_torch.checkpoint.torch_bridge import stack_encoder_flat
    from xggm_tpu_torch.models.task_model import XGGMModel

    flat = {k[len("params/"):]: v for k, v in to_jax_params(model).items()}
    meta = XGGMModel(lx, model.num_answers, model.ggm, device="meta")
    return from_jax_params(stack_encoder_flat(flat, lx), meta)


def mp_model(torch, t, lx, state_dict, mesh=None, tp=False):
    """A training model of `lx` from `state_dict` on the card, its wide
    Dense layers split over `mesh`'s model group with `tp`."""
    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.parallel import param_shardings, shard_model_

    model = XGGMModel(lx, t.cfg.num_answers, t.cfg.ggm, device="cuda")
    model.load_state_dict(state_dict)
    if tp:
        shard_model_(model, mesh, param_shardings(model, mesh))
    return model


def mp_opt(t, model, fused: bool):
    """Phase 8's BertAdam for `model`'s parameter names (`fused`: kernel
    7), at phase 15's t_total."""
    from xggm_tpu_torch.training.bert_adam import BertAdam, lr_scale_tree

    tc = t.tc
    mult = tc.downstream_lr_mult
    return BertAdam(tc.lr * mult, warmup=tc.warmup,
                    t_total=SCALE_OUT_T_TOTAL, weight_decay=tc.weight_decay,
                    lr_scale=lr_scale_tree(
                        (n for n, _ in model.named_parameters()),
                        lambda n: not n.startswith("lxrt."), 1.0,
                        1.0 / mult), fused=fused)


def mp_trajectory(torch, model, opt, tc, batches, counters, mesh=None):
    """The 2-step plan from a fresh BertAdam state: each step's losses and
    ms, the launches, the counters and flags, the parameters after (whole,
    gathered over a model group), and the memory: the bytes of the
    parameters and moments this rank holds, and the peak allocated over
    the run above what was allocated before it."""
    from xggm_tpu_torch.parallel import gather_split, tp_split
    from xggm_tpu_torch.training.steps import TrainState, make_ggm_train_step

    state = TrainState.create(model, opt, mesh)
    steps = {br: make_ggm_train_step(model, opt, tc, br)
             for br in SCALE_OUT_PLAN}
    state_bytes = 4 * sum(p.numel() + state.opt_state.m[n].numel()
                          + state.opt_state.v[n].numel()
                          for n, p in state.params.items())
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    record = []
    for i, br in enumerate(SCALE_OUT_PLAN):
        t0 = time.perf_counter()
        state, m = steps[br](state, batches[br], i)
        torch.cuda.synchronize()
        record.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           losses={k: float(v) for k, v in m.items()
                                   if v.dim() == 0}))
    peak = torch.cuda.max_memory_allocated() - before
    params = gather_split({n: p.detach().clone()
                           for n, p in state.params.items()},
                          tp_split(model), mesh)
    return dict(record=record,
                launches={k: c.launches for k, c in counters.items()},
                leaf_count=state.opt_state.leaf_counts(),
                active=state.opt_state.active_flags(),
                count=state.opt_state.count, state_bytes=state_bytes,
                peak_step_bytes=peak, params=params, state=state,
                steps=steps, batches=batches, opt=opt)


def mp_compare(torch, got, ref, init, dtype: str) -> dict:
    """`got` against the reference trajectory `ref` from the same initial
    parameters `init`: the losses' relative differences (gated: the
    phases' losses in bf16, every term in fp32), the updates' agreement,
    and the counters and flags."""
    names = list(ref["params"])
    deltas = [got["params"][n] - init[n] for n in names]
    want = [ref["params"][n] - init[n] for n in names]
    rel = [{k: abs(g["losses"][k] - v) / max(abs(v), 1e-12)
            for k, v in w["losses"].items()}
           for g, w in zip(got["record"], ref["record"])]
    gated = (DP_GATED_LOSSES if dtype == "bfloat16"
             else tuple(ref["record"][0]["losses"]))
    return dict(
        losses=[r["losses"] for r in got["record"]],
        reference_losses=[r["losses"] for r in ref["record"]],
        ms_per_global_batch=[r["ms"] for r in got["record"]],
        reference_ms_per_batch=[r["ms"] for r in ref["record"]],
        gated_losses=list(gated), loss_rel_diffs=rel,
        loss_rel_diff=max(r[k] for r in rel for k in gated if k in r),
        counters_flags_equal=(got["leaf_count"] == ref["leaf_count"]
                              and got["active"] == ref["active"]
                              and got["count"] == ref["count"]),
        update_agreement=grad_agreement(torch, names, deltas, want))


def stacked_counts_as_derived(stacked: dict, layer: dict) -> bool:
    """Each stacked leaf's counter (or flag) equals that of every layer of
    its stack in the per-layer run, and every other leaf's its own."""
    import re as _re

    groups = {}
    for n, v in layer.items():
        key = _re.sub(r"\.encoder\.layer\.\d+\.", ".encoder.lang_stack.layer.",
                      n)
        key = _re.sub(r"\.encoder\.r_layers\.\d+\.",
                      ".encoder.r_stack.layer.", key)
        key = _re.sub(r"\.encoder\.x_layers\.\d+\.",
                      ".encoder.x_stack.layer.", key)
        groups.setdefault(key, set()).add(v)
    return (set(groups) == set(stacked)
            and all(groups[n] == {v} for n, v in stacked.items()))


def update_launches(torch, t_opt, state, grads) -> dict:
    """Device kernels of one tree update of `state` from `grads`
    (torch.profiler), and its host ms."""
    from xggm_tpu_torch.training.steps import apply_grads

    prof = profile_call(torch, lambda: apply_grads(
        t_opt, state, dict(grads), 5.0))
    return dict(device_events=prof["device_events"],
                device_busy_ms=prof["device_busy_ms"],
                wall_ms=prof["wall_ms_profiled"])


def model_parallel_rank(coordinator: str, rank: int, workdir: str) -> int:
    """One of the two ranks of phase 16: for bf16 (tree and fused
    BertAdam) and fp32 (tree), rank 0 runs the one-rank references, the
    per-layer and the stacked trajectory at 96 ((a)); then both ranks run
    the TP trajectory (model group of 2, data group of 1) and the PP
    trajectory (pipe group of 2, M = 4) on the whole batch; in bf16 also
    the PP relation GGM loss with dropout on, without and with remat.
    Writes {workdir}/mp_rank{rank}.json."""
    import torch

    from xggm_tpu_torch.ops import attention as attn
    from xggm_tpu_torch.ops import fused_adam as fa
    from xggm_tpu_torch.parallel import (
        clear_pipeline_mesh, host_barrier, init_distributed, make_mesh,
        set_pipeline_mesh, shutdown_distributed, tp_split)
    from xggm_tpu_torch.training.steps import make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coordinator, MP_RANKS, rank, backend="gloo",
                     device="cuda:0", timeout_s=MP_RANK_TIMEOUT)
    try:
        tp_mesh = make_mesh(MP_RANKS, device="cuda:0")
        pp_mesh = make_mesh(device="cuda:0", pipeline_parallel=MP_RANKS)
        counters = scale_out_counters(attn, fa)
        out = dict(rank=rank, runs=[], tp_stage=tp_mesh.model_rank,
                   pp_stage=pp_mesh.pipe_rank)
        for dtype in ("bfloat16", "float32"):
            t = train_setup(torch, fused=False, dtype=dtype, dropout=False)
            t.opt.t_total = SCALE_OUT_T_TOTAL
            tc, lx = t.tc, t.cfg.lxmert.replace(dtype=dtype)
            batches = scale_out_batches(torch, t)
            init = {n: p.detach().clone()
                    for n, p in t.model.state_dict().items()}
            lx_stacked = lx.replace(stacked_layers=True)
            stacked_sd = stacked_state_dict(lx_stacked, t.model)
            init_stacked = {n: x.to("cuda") for n, x in stacked_sd.items()}
            del t.state
            if dtype == "float32":
                # one eval forward, TP against one rank
                tp_model = mp_model(torch, t, lx, init, tp_mesh, tp=True)
                out["eval_answers_equal"] = bool(torch.equal(
                    make_eval_step(tp_model)(batches["relation"]),
                    make_eval_step(t.model)(batches["relation"])))
                del tp_model
            for fused in ((False, True) if dtype == "bfloat16"
                          else (False,)):
                row = dict(dtype=dtype, fused=fused)
                refs = {}
                if rank == 0:
                    with torch.no_grad():
                        torch._foreach_copy_(
                            list(t.model.state_dict().values()),
                            list(init.values()))
                    refs["layer"] = mp_trajectory(
                        torch, t.model, mp_opt(t, t.model, fused), tc,
                        batches, counters)
                    stacked = mp_model(torch, t, lx_stacked, init_stacked)
                    refs["stacked"] = mp_trajectory(
                        torch, stacked, mp_opt(t, stacked, fused), tc,
                        batches, counters)
                    a = mp_compare(
                        torch, dict(refs["stacked"], params=unstacked(
                            refs["stacked"]["params"])), refs["layer"],
                        init, dtype)
                    a["counters_flags_equal"] = a[
                        "stacked_counts_as_derived"] = (
                        stacked_counts_as_derived(
                            refs["stacked"]["leaf_count"],
                            refs["layer"]["leaf_count"])
                        and stacked_counts_as_derived(
                            refs["stacked"]["active"],
                            refs["layer"]["active"]))
                    a["launches"] = {k: refs[k]["launches"]
                                     for k in ("layer", "stacked")}
                    a["leaves"] = {k: len(refs[k]["params"])
                                   for k in ("layer", "stacked")}
                    if dtype == "bfloat16" and not fused:
                        a.update(stacked_timing(torch, refs))
                    row["stacked"] = a
                    del stacked
                # (b) TP: both ranks on all 96 rows
                host_barrier(f"tp_{dtype}_{fused}")
                model = mp_model(torch, t, lx, init, tp_mesh, tp=True)
                got = mp_trajectory(torch, model, mp_opt(t, model, fused),
                                    tc, batches, counters, tp_mesh)
                split = tp_split(model)
                st = got["state"]
                rep = [n for n in st.params if n not in split]
                identical = same_across(
                    torch, [st.params[n] for n in rep]
                    + [st.opt_state.m[n] for n in rep]
                    + [st.opt_state.v[n] for n in rep],
                    tp_mesh.model_group, tp_mesh.model_size)
                tp = dict(launches=got["launches"],
                          split_leaves=len(split),
                          split_params=sum(init[n].numel() for n in split
                                           if n.endswith("weight")
                                           or n.endswith("bias")),
                          state_bytes=got["state_bytes"],
                          peak_step_bytes=got["peak_step_bytes"],
                          replicated_identical=identical,
                          ms_per_global_batch=[r["ms"]
                                               for r in got["record"]])
                if rank == 0:
                    tp.update(mp_compare(torch, got, refs["layer"], init,
                                         dtype))
                    tp["reference_state_bytes"] = refs["layer"][
                        "state_bytes"]
                    tp["reference_peak_step_bytes"] = refs["layer"][
                        "peak_step_bytes"]
                    tp["reference_launches"] = refs["layer"]["launches"]
                row["tp"] = tp
                del model, got, st
                gc.collect()
                torch.cuda.empty_cache()
                # (c) PP: both ranks feed all 96 rows, stage s its layers
                host_barrier(f"pp_{dtype}_{fused}")
                set_pipeline_mesh(pp_mesh, MP_MICROBATCHES)
                lx_pp = lx_stacked.replace(pp_stages=MP_RANKS,
                                           pp_microbatches=MP_MICROBATCHES)
                model = mp_model(torch, t, lx_pp, init_stacked)
                got = mp_trajectory(torch, model, mp_opt(t, model, fused),
                                    tc, batches, counters, pp_mesh)
                st = got["state"]
                names = list(st.params)
                identical = same_across(
                    torch, [st.params[n] for n in names]
                    + [st.opt_state.m[n] for n in names]
                    + [st.opt_state.v[n] for n in names],
                    pp_mesh.pipe_group, pp_mesh.pipe_size)
                pp = dict(launches=got["launches"], stage=pp_mesh.pipe_rank,
                          state_bytes=got["state_bytes"],
                          peak_step_bytes=got["peak_step_bytes"],
                          replicated_identical=identical,
                          ms_per_global_batch=[r["ms"]
                                               for r in got["record"]])
                if rank == 0:
                    pp.update(mp_compare(torch, got, refs["stacked"],
                                         init_stacked, dtype))
                    pp["reference_peak_step_bytes"] = refs["stacked"][
                        "peak_step_bytes"]
                row["pp"] = pp
                del model, got, st
                if dtype == "bfloat16" and not fused:
                    row["pp_remat"] = pp_remat_check(
                        torch, t, lx_pp, init_stacked, batches, counters,
                        pp_mesh)
                clear_pipeline_mesh()
                refs.clear()
                gc.collect()
                torch.cuda.empty_cache()
                out["runs"].append(row)
            del t, init, init_stacked, stacked_sd
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(workdir, f"mp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def stacked_timing(torch, refs) -> dict:
    """(a): ms per batch of each layout over MP_TIMED_BATCHES batches, in
    turns (layer, stacked, stacked, layer), and one tree update's device
    kernels and host ms each way."""
    turns = []
    for name in ("layer", "stacked", "stacked", "layer"):
        r = refs[name]
        state = r["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MP_TIMED_BATCHES):
            br = SCALE_OUT_PLAN[i % 2]
            state, _ = r["steps"][br](state, r["batches"][br], 500 + i)
        torch.cuda.synchronize()
        turns.append(dict(layout=name, ms_per_batch=(time.perf_counter() - t0)
                          * 1e3 / MP_TIMED_BATCHES))
    update = {}
    for name in ("layer", "stacked"):
        state = refs[name]["state"]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        grads = {n: torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
                 for n, p in state.params.items()}
        update[name] = update_launches(torch, refs[name]["opt"], state,
                                       grads)
    return dict(timing_turns=turns, update=update)


def pp_remat_check(torch, t, lx_pp, init_stacked, batches, counters,
                   mesh) -> dict:
    """(c): the pipelined relation GGM loss and gradients with dropout on
    (hidden and attention 0.1, the generator's 0.5), without and with
    remat, from the same seeds: the loss (the last stage's), the norm of
    the pipe-summed gradient and the launches each way."""
    from dataclasses import replace

    from xggm_tpu_torch.models.task_model import XGGMModel
    from xggm_tpu_torch.parallel import from_last_stage
    from xggm_tpu_torch.training.steps import (
        TrainState, _grads, make_ggm_loss, on_last_stage, phase_seeds)

    lx = lx_pp.replace(bert=replace(lx_pp.bert, hidden_dropout_prob=RATE,
                                    attention_probs_dropout_prob=RATE))
    model = XGGMModel(lx, t.cfg.num_answers, replace(t.cfg.ggm, dropout=0.5),
                      device="cuda")
    model.load_state_dict(init_stacked)
    loss_fn = make_ggm_loss(model, t.tc, "relation")
    state = TrainState(dict(model.named_parameters()), None, mesh)
    batch = {k: v for k, v in batches["relation"].items()
             if k != "noise_override"}
    dropout_seed, noise_seed, _ = phase_seeds(300)
    got = {}
    for remat in (False, True):
        model.lxrt.encoder.remat = remat
        for c in counters.values():
            c.launches = 0
        res = on_last_stage(loss_fn, batch, dropout_seed, noise_seed)
        grads = _grads(None if res is None else res[0], state)
        torch.cuda.synchronize()
        norm = torch.stack([g.float().norm() for g in grads.values()
                            if g is not None]).norm()
        got[remat] = dict(
            loss=from_last_stage(None if res is None
                                 else float(res[0].detach()), mesh),
            grad_norm=float(norm),
            launches={k: c.launches for k, c in counters.items()})
        del res, grads
    plain, remat = got[False], got[True]
    return dict(loss=remat["loss"], plain_loss=plain["loss"],
                loss_rel_diff=abs(remat["loss"] - plain["loss"])
                / abs(plain["loss"]),
                grad_norm=remat["grad_norm"],
                plain_grad_norm=plain["grad_norm"],
                launches=remat["launches"], plain_launches=plain["launches"])


def gloo_p2p_probe(coordinator: str, rank: int) -> int:
    """Whether gloo's send and recv take CUDA tensors: rank 0 sends one
    on the card to rank 1. Prints GLOO_CUDA_P2P ok or the error."""
    import torch
    import torch.distributed as dist

    from xggm_tpu_torch.parallel import init_distributed, shutdown_distributed

    init_distributed(coordinator, 2, rank, backend="gloo", device="cuda:0",
                     timeout_s=60)
    try:
        x = torch.full((4,), 7.0, device="cuda")
        if rank == 0:
            dist.send(x, 1)
        else:
            y = torch.zeros(4, device="cuda")
            dist.recv(y, 0)
            check(bool((y == 7.0).all()), f"received {y}")
        print("GLOO_CUDA_P2P ok", flush=True)
    except Exception as e:  # noqa: BLE001 - the probe's answer
        print(f"GLOO_CUDA_P2P {type(e).__name__}: {e}"[:400], flush=True)
    finally:
        shutdown_distributed()
    return 0


def probe_gloo_p2p() -> str:
    """`gloo_p2p_probe` in two processes, stopped after 90 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-p2p-probe",
         f"127.0.0.1:{port}", str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    answers = []
    try:
        for p in procs:
            text = p.communicate(timeout=90)[0]
            answers += [ln for ln in text.splitlines()
                        if ln.startswith("GLOO_CUDA_P2P")]
    except subprocess.TimeoutExpired:
        answers.append("GLOO_CUDA_P2P timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return "; ".join(answers) or "GLOO_CUDA_P2P no answer"


def composed_rank(coordinator: str, rank: int, workdir: str) -> int:
    """(d) One of four ranks: a model group of 2 by a pipe group of 2 (data
    group of 1), fp32, tree BertAdam: the stacked model pipelined in 4
    microbatches with its wide Dense layers split, the 2-step plan on the
    whole batch; rank 0 first runs the one-rank stacked reference. Writes
    {workdir}/composed_rank{rank}.json."""
    import torch

    from xggm_tpu_torch.ops import attention as attn
    from xggm_tpu_torch.ops import fused_adam as fa
    from xggm_tpu_torch.parallel import (
        clear_pipeline_mesh, host_barrier, init_distributed, make_mesh,
        set_pipeline_mesh, shutdown_distributed, tp_split)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coordinator, MP_COMPOSED_RANKS, rank, backend="gloo",
                     device="cuda:0", timeout_s=MP_RANK_TIMEOUT)
    try:
        mesh = make_mesh(2, device="cuda:0", pipeline_parallel=2)
        counters = scale_out_counters(attn, fa)
        t = train_setup(torch, fused=False, dtype="float32", dropout=False)
        tc, lx = t.tc, t.cfg.lxmert.replace(dtype="float32",
                                            stacked_layers=True)
        batches = scale_out_batches(torch, t)
        init = {n: x.to("cuda")
                for n, x in stacked_state_dict(lx, t.model).items()}
        del t.state, t.model, t.steps
        gc.collect()
        out = dict(rank=rank, model_rank=mesh.model_rank,
                   stage=mesh.pipe_rank)
        ref = None
        if rank == 0:
            stacked = mp_model(torch, t, lx, init)
            ref = mp_trajectory(torch, stacked, mp_opt(t, stacked, False),
                                tc, batches, counters)
            del stacked
        host_barrier("composed")
        set_pipeline_mesh(mesh, MP_MICROBATCHES)
        model = mp_model(torch, t, lx.replace(
            pp_stages=2, pp_microbatches=MP_MICROBATCHES), init, mesh,
            tp=True)
        got = mp_trajectory(torch, model, mp_opt(t, model, False), tc,
                            batches, counters, mesh)
        clear_pipeline_mesh()
        split, st = tp_split(model), got["state"]
        names = list(st.params)
        rep = [n for n in names if n not in split]
        out.update(
            launches=got["launches"], split_leaves=len(split),
            state_bytes=got["state_bytes"],
            peak_step_bytes=got["peak_step_bytes"],
            ms_per_global_batch=[r["ms"] for r in got["record"]],
            replicated_identical=same_across(
                torch, [st.params[n] for n in rep]
                + [st.opt_state.m[n] for n in rep]
                + [st.opt_state.v[n] for n in rep],
                mesh.model_group, mesh.model_size),
            pipe_identical=same_across(
                torch, [st.params[n] for n in names]
                + [st.opt_state.m[n] for n in names]
                + [st.opt_state.v[n] for n in names],
                mesh.pipe_group, mesh.pipe_size))
        if rank == 0:
            out.update(mp_compare(torch, got, ref, init, "float32"))
        with open(os.path.join(workdir, f"composed_rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def launch_ranks(flag: str, n: int, workdir: str, prefix: str) -> list:
    """`n` ranks of this script (`flag COORDINATOR RANK WORKDIR`) in
    processes of their own, each stopped at its time limit; returns what
    each wrote to {workdir}/{prefix}{rank}.json."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag,
         f"127.0.0.1:{port}", str(r), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{flag} rank {r} exited "
                                 f"{p.returncode}:\n{text[-4000:]}")
    return [json.load(open(os.path.join(workdir, f"{prefix}{r}.json")))
            for r in range(n)]


def phase_model_parallel(torch, t_start: float) -> dict:
    """Phase 16: the two ranks of `model_parallel_rank`, then the four of
    `composed_rank`; their rows checked here. Returns the launches of
    each part (bf16, tree BertAdam; kernel 7 from the fused runs; (d) in
    fp32)."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="xggm_model_parallel_")
    try:
        ranks = launch_ranks("--model-parallel-rank", MP_RANKS, workdir,
                             "mp_rank")
        t_composed = time.perf_counter()
        composed = launch_ranks("--composed-rank", MP_COMPOSED_RANKS,
                                workdir, "composed_rank")
        composed_seconds = time.perf_counter() - t_composed
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    rows, other = ranks[0]["runs"], ranks[1]["runs"]
    emit("model_parallel_composed", seconds=composed_seconds,
         ranks=composed)
    emit("model_parallel", wall_seconds=wall, gloo_cuda_p2p=probe_gloo_p2p(),
         seconds_so_far=time.perf_counter() - t_start, runs=rows,
         rank1=[{k: r[k] for k in ("dtype", "fused", "tp", "pp")}
                for r in other],
         eval_answers_equal=[r.get("eval_answers_equal") for r in ranks],
         pp_launches_per_batch_expected=dict(
             attention_fwd=PP_FWD_PER_BATCH,
             attention_dropout_bwd=PP_BWD_PER_BATCH),
         note="two ranks share one card over gloo: ms per global batch is "
              "no gain to claim; dropout off, the GGM noise replayed")
    n = len(SCALE_OUT_PLAN)

    def one_rank(fused):
        return {"attention_fwd": FWD_LAUNCHES_PER_BATCH * n,
                "attention_dropout_fwd": 0,
                "attention_dropout_bwd": BWD_LAUNCHES_PER_BATCH * n,
                "bert_adam": UPDATES_PER_BATCH * n if fused else 0}

    def gates(part: dict, dtype: str, what: str, loss_rtol=None) -> None:
        agree = part["update_agreement"]
        if dtype == "bfloat16":
            ok = (part["loss_rel_diff"] <= (loss_rtol or DP_LOSS_RTOL)
                  and agree["grad_rel_l2"] <= GRAD_RTOL
                  and agree["max_param_grad_rel_l2"] <= PARAM_GRAD_RTOL)
        else:
            ok = (part["loss_rel_diff"] <= MP_FP32_LOSS_RTOL
                  and agree["grad_rel_l2"] <= MP_FP32_UPDATE_RTOL)
        check(ok and agree["same_graph"] and part["counters_flags_equal"],
              f"{what} {dtype}: losses {part['loss_rel_diffs']}, updates "
              f"{agree}, counters and flags {part['counters_flags_equal']}")

    for row, row1 in zip(rows, other):
        dtype, fused = row["dtype"], row["fused"]
        a = row["stacked"]
        gates(a, dtype, "(a) stacked against per-layer", STACKED_LOSS_RTOL)
        check(a["loss_rel_diff"] <= STACKED_LOSS_RTOL,
              f"(a) stacked losses {a['loss_rel_diffs']}")
        check(a["stacked_counts_as_derived"], "(a) stacked counters/flags")
        check(a["launches"]["layer"] == a["launches"]["stacked"]
              == one_rank(fused), f"(a) launches {a['launches']}")
        for part, part1, what in ((row["tp"], row1["tp"], "(b) TP"),
                                  (row["pp"], row1["pp"], "(c) PP")):
            gates(part, dtype, what)
            check(part["replicated_identical"]
                  and part1["replicated_identical"],
                  f"{what} {dtype}: replicated state differs across ranks")
        check(row["tp"]["launches"] == row1["tp"]["launches"]
              == one_rank(fused),
              f"(b) TP launches {row['tp']['launches']}, "
              f"{row1['tp']['launches']}, expected {one_rank(fused)}")
        for part in (row["pp"], row1["pp"]):
            s = part["stage"]
            want = {"attention_fwd": PP_FWD_PER_BATCH[s] * n,
                    "attention_dropout_fwd": 0,
                    "attention_dropout_bwd": PP_BWD_PER_BATCH[s] * n,
                    "bert_adam": UPDATES_PER_BATCH * n if fused else 0}
            check(part["launches"] == want,
                  f"(c) PP stage {s} launches {part['launches']}, "
                  f"expected {want}")
        if "pp_remat" in row:
            rm = row["pp_remat"]
            check(rm["loss_rel_diff"] <= REMAT_LOSS_RTOL,
                  f"(c) PP remat loss {rm}")
    check(all(r.get("eval_answers_equal") for r in ranks),
          "(b) TP eval answers differ from one rank's")
    # (d): (b)'s fp32 gates, the replicated state identical across each
    # model group, every parameter and moment across each pipe group, and
    # each stage's launches those of (c) on every model rank
    d = composed[0]
    gates(d, "float32", "(d) TP x PP")
    for r in composed:
        s = r["stage"]
        want = {"attention_fwd": PP_FWD_PER_BATCH[s] * n,
                "attention_dropout_fwd": 0,
                "attention_dropout_bwd": PP_BWD_PER_BATCH[s] * n,
                "bert_adam": 0}
        check(r["replicated_identical"] and r["pipe_identical"],
              f"(d) rank {r['rank']}: state differs across its groups")
        check(r["launches"] == want and r["split_leaves"] > 0,
              f"(d) rank {r['rank']} (stage {s}) launches "
              f"{r['launches']}, expected {want}")
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    tree = next(r for r in bf16 if not r["fused"])
    fused = next(r for r in bf16 if r["fused"])
    tree1 = next(r for r in other if r["dtype"] == "bfloat16"
                 and not r["fused"])
    fused1 = next(r for r in other if r["dtype"] == "bfloat16"
                  and r["fused"])
    out = {}
    for kernel in ("attention_fwd", "attention_dropout_fwd",
                   "attention_dropout_bwd"):
        out[kernel] = {
            "stacked": tree["stacked"]["launches"]["stacked"][kernel],
            "tp_per_rank": tree["tp"]["launches"][kernel],
            "pp_stage0": tree["pp"]["launches"][kernel],
            "pp_stage1": tree1["pp"]["launches"][kernel],
            "pp_remat_stage0": tree["pp_remat"]["launches"][kernel],
            "pp_remat_stage1": tree1["pp_remat"]["launches"][kernel]}
    for kernel in out:
        out[kernel]["tp_pp_stage0_fp32"], out[kernel]["tp_pp_stage1_fp32"] = (
            next(r for r in composed if r["stage"] == s)["launches"][kernel]
            for s in (0, 1))
    out["bert_adam"] = {
        "stacked": fused["stacked"]["launches"]["stacked"]["bert_adam"],
        "tp_per_rank": fused["tp"]["launches"]["bert_adam"],
        "pp_stage0": fused["pp"]["launches"]["bert_adam"],
        "pp_stage1": fused1["pp"]["launches"]["bert_adam"]}
    return out


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
    from xggm_tpu_torch.ops import build, philox
    from xggm_tpu_torch.ops import fused_adam as fa
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(build.build, KERNEL_SOURCES))
    for src, res in zip(KERNEL_SOURCES, builds):
        emit("build", kernel=src, seconds=res.seconds, library=res.path,
             ptxas=[ln.strip() for ln in res.log.splitlines()
                    if "ptxas info" in ln or "spill" in ln])
    emit("build", wall_seconds=time.perf_counter() - t0)
    bwd_bf16 = bf16_kernels(builds, "bwd")
    emit("build_bwd_bf16", kernels=bwd_bf16,
         dynamic_smem_bytes_at_path_shapes={
             f"{lq}x{lk}": bf16_backward_smem_bytes(lq, lk)
             for lq, lk, _, _ in PATH_SHAPES})
    fwd_bf16 = bf16_kernels(builds, "fwd")
    scalar_fwd = scalar_forwards(builds)
    emit("build_fwd_bf16", kernels=fwd_bf16,
         dynamic_smem_bytes_at_path_shapes={
             f"{lq}x{lk}": bf16_forward_smem_bytes(lq, lk)
             for lq, lk, _, _ in PATH_SHAPES},
         scalar_forwards=scalar_fwd)
    # kernels 1 and 2, and kernel 4 with and without dropout (5), in fp32
    check(len(scalar_fwd) == 4
          and all(k.split("<")[1].startswith("f") for k in scalar_fwd),
          f"expected the scalar forward for fp32 only: {scalar_fwd}")
    # backward: kernels 3 and 6; forward: kernels 1, 2, 4 and 5
    for kind, found, want in (("backward", bwd_bf16, 8),
                              ("forward", fwd_bf16, 16)):
        check(len(found) == want, f"expected {want} bf16 {kind} kernels in "
                                  f"the build log, found {len(found)}")
        spills = [r["kernel"] for r in found
                  if r.get("spill_store_bytes") or r.get("spill_load_bytes")]
        check(not spills, f"bf16 {kind} kernels spill: {spills}")

    # 3. kernel check and times
    rows = phase_kernel(torch, attn)

    # 4. dropout kernels at the training batch
    cfg = gqa_ood_config()
    train_b = cfg.train.batch_size
    drop_rows = phase_dropout(torch, attn, philox, train_b, fwd_bf16)

    # 5. the BLHD kernels at the training batch, and their entry points
    blhd_rows, blhd_launches = phase_blhd(torch, attn, philox, train_b,
                                          fwd_bf16)
    emit_backward_device(drop_rows, blhd_rows, train_b)
    emit_forward_device(rows, drop_rows, blhd_rows, train_b)

    # 6. serving at full width
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

        # 7. timing
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

    # free the serving model, so that the training peak memory is its own
    del server, engine, sm, model, batch, big, logits, plain
    gc.collect()
    torch.cuda.empty_cache()

    # 8. training at full width
    train_launches, tree_profile = phase_train(torch, attn, philox)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. training with the fused BertAdam (kernel 7)
    fused_launches, adam = phase_fused_train(torch, attn, fa, tree_profile)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. the trainer and its CLI: an epoch and the test arm; its BEST_0
    # stays on disk for phase 12
    trainer_dir = tempfile.mkdtemp(prefix="xggm_trainer_")
    try:
        trainer_launches, handoff = phase_trainer(
            torch, attn, tree_profile["timed_ms_per_batch"], t_start,
            trainer_dir)
        gc.collect()
        torch.cuda.empty_cache()

        # 11. the VQA-CP v2 recipe: snapshot, epoch, preemption, resume,
        # test arm, baseline
        vqacp_launches = phase_vqacp(torch, attn, trainer_launches, t_start)
        gc.collect()
        torch.cuda.empty_cache()

        # 12. phase 10's BEST_0 exported in bf16 and int8, and served
        served_launches = phase_export_serve(torch, attn, handoff, card,
                                             t_start)
    finally:
        shutil.rmtree(trainer_dir, ignore_errors=True)
    del handoff
    gc.collect()
    torch.cuda.empty_cache()

    # 13. training with the GIN and the GAT generators
    generator_launches = phase_generators(torch, attn, philox, card, t_start)

    # 14. LXMERT pretraining through its CLI, batch 256 and accumulated
    pretrain_launches = phase_pretrain(torch, attn, philox, card, t_start)
    gc.collect()
    torch.cuda.empty_cache()

    # 15. scale-out: a world of one, two ranks, remat
    scale_out = phase_scale_out(torch, attn, fa, t_start)
    gc.collect()
    torch.cuda.empty_cache()

    # 16. the stacked layout, tensor and pipeline parallelism
    model_parallel = phase_model_parallel(torch, t_start)

    def vqacp(kernel):
        return {run: counts[kernel] for run, counts in vqacp_launches.items()}

    def generators(kernel):
        return {gnn: counts[kernel]
                for gnn, counts in generator_launches.items()}

    def pretraining(kernel):
        return {run: counts[kernel]
                for run, counts in pretrain_launches.items()}

    def scaled_out(kernel):
        return {part: counts[kernel] for part, counts in scale_out.items()}

    # 17. summary: one entry per kernel. Kernel 1 over one forward's
    # launches at B=512; kernels 2 to 6 over one training forward's or
    # backward's launches at B=96, in bf16 (the path's type); kernel 7 per
    # update of every parameter.
    path = [r for r in rows if r["on_path"]]
    drop_path = [r for r in drop_rows if "fwd_ms" in r]
    blhd_path = [r for r in blhd_rows if "k4_ms" in r]

    def per_forward(key, table=path):
        return sum(r[key] * r["launches_per_forward"] for r in table)

    def bound_by(key, table):
        return ("bytes" if all(r[key] == "bytes" for r in table)
                else "operations")

    blhd_over = (f"one training forward's or backward's "
                 f"{LAUNCHES_PER_FORWARD} launches at B={train_b}")
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "xggm_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "xggm_tpu/ops/pallas_attention.py:95",
        "launches": launches,
        "trainer_launches": trainer_launches["attention_fwd"],
        "vqacp_launches": vqacp("attention_fwd"),
        "served_artifact_launches": served_launches,
        "pretrain_launches": pretraining("attention_fwd"),
        "scale_out_launches": scaled_out("attention_fwd"),
        "model_parallel_launches": model_parallel["attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": bound_by("bound_by", path),
        "library_ms": per_forward("library_ms"),
        "device_ms": per_forward("kernel_device_ms"),
        "library_device_ms": per_forward("library_device_ms"),
        "timed_over": f"one forward's {LAUNCHES_PER_FORWARD} launches at "
                      f"B={B}; device_ms: the device's own time",
        "backward_ms": per_forward("k1_bwd_ms", drop_path),
        "backward_max_abs_err": max(r["k1_bwd_max_abs_err"]
                                    for r in drop_rows),
        "backward_bound_ms": per_forward("bwd_bound_ms", drop_path),
        "backward_library_ms": per_forward("k1_library_bwd_ms", drop_path),
        "backward_timed_over": f"one backward's {LAUNCHES_PER_FORWARD} "
                               f"launches of kernel 3 at rate 0, B={train_b}; "
                               "backward_library_ms is _scaled_dot_product_"
                               "efficient_attention_backward at dropout_p 0 "
                               "from a saved forward"},
        {"name": "attention_dropout_fwd", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "xggm_tpu/ops/pallas_attention.py:237",
         "launches": train_launches["attention_dropout_fwd"],
         "trainer_launches": trainer_launches["attention_dropout_fwd"],
         "vqacp_launches": vqacp("attention_dropout_fwd"),
         "generator_launches": generators("attention_dropout_fwd"),
         "pretrain_launches": pretraining("attention_dropout_fwd"),
         "scale_out_launches": scaled_out("attention_dropout_fwd"),
         "model_parallel_launches": model_parallel["attention_dropout_fwd"],
         "max_abs_err": max(r["fwd_max_abs_err"] for r in drop_rows),
         "ms": per_forward("fwd_ms", drop_path),
         "plain_ms": per_forward("plain_fwd_ms", drop_path),
         "bound_ms": per_forward("fwd_bound_ms", drop_path),
         "bound_by": bound_by("fwd_bound_by", drop_path),
         "library_ms": per_forward("sdpa_fwd_ms", drop_path),
         "device_ms": per_forward("fwd_device_ms", drop_path),
         "library_device_ms": per_forward("sdpa_fwd_device_ms", drop_path),
         "timed_over": f"one training forward's {LAUNCHES_PER_FORWARD} "
                       f"launches at B={train_b}; device_ms: the device's "
                       "own time"},
        {"name": "attention_dropout_bwd", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/attention_dropout.cu",
         "replaces": "xggm_tpu/ops/pallas_attention.py:250",
         "launches": train_launches["attention_dropout_bwd"],
         "trainer_launches": trainer_launches["attention_dropout_bwd"],
         "vqacp_launches": vqacp("attention_dropout_bwd"),
         "generator_launches": generators("attention_dropout_bwd"),
         "pretrain_launches": pretraining("attention_dropout_bwd"),
         "scale_out_launches": scaled_out("attention_dropout_bwd"),
         "model_parallel_launches": model_parallel["attention_dropout_bwd"],
         "max_abs_err": max(r["bwd_max_abs_err"] for r in drop_rows),
         "ms": per_forward("bwd_ms", drop_path),
         "plain_ms": per_forward("plain_bwd_ms", drop_path),
         "bound_ms": per_forward("bwd_bound_ms", drop_path),
         "bound_by": bound_by("bwd_bound_by", drop_path),
         "library_ms": per_forward("library_bwd_ms", drop_path),
         "library_fwd_bwd_ms": per_forward("sdpa_fwd_bwd_ms", drop_path),
         "timed_over": f"one training backward's {LAUNCHES_PER_FORWARD} "
                       f"launches at B={train_b}; library_ms is "
                       "_scaled_dot_product_efficient_attention_backward "
                       "from a saved forward, library_fwd_bwd_ms SDPA "
                       "forward + backward"},
        {"name": "attention_blhd_fwd", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/attention_blhd.cu",
         "replaces": "xggm_tpu/ops/pallas_attention.py:477",
         "launches": blhd_launches["attention_blhd_fwd"],
         "max_abs_err": max(r["k4_max_abs_err"] for r in blhd_rows),
         "max_abs_err_vs_kernel_1": max(
             r["vs_kernels_1_to_3_max_abs_err"] for r in blhd_rows),
         "ms": per_forward("k4_ms", blhd_path),
         "plain_ms": per_forward("plain_k4_ms", blhd_path),
         "bound_ms": per_forward("fwd_bound_ms", blhd_path),
         "bound_by": bound_by("fwd_bound_by", blhd_path),
         "library_ms": per_forward("sdpa_fwd_ms", blhd_path),
         "device_ms": per_forward("k4_device_ms", blhd_path),
         "library_device_ms": per_forward("sdpa_fwd_device_ms", blhd_path),
         "backward_ms": per_forward("k4_bwd_ms", blhd_path),
         "timed_over": f"{blhd_over}; library_ms is SDPA on strided views "
                       "of the BLHD tensors; backward_ms is kernel 6 at "
                       "rate 0; device_ms: the device's own time"},
        {"name": "attention_dropout_blhd_fwd", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/attention_blhd.cu",
         "replaces": "xggm_tpu/ops/pallas_attention.py:553",
         "launches": blhd_launches["attention_dropout_blhd_fwd"],
         "max_abs_err": max(r["k5_max_abs_err"] for r in blhd_rows),
         "ms": per_forward("k5_ms", blhd_path),
         "plain_ms": per_forward("plain_k5_ms", blhd_path),
         "bound_ms": per_forward("fwd_bound_ms", blhd_path),
         "bound_by": bound_by("fwd_bound_by", blhd_path),
         "library_ms": per_forward("sdpa_dropout_fwd_ms", blhd_path),
         "device_ms": per_forward("k5_device_ms", blhd_path),
         "library_device_ms": per_forward("sdpa_dropout_fwd_device_ms",
                                          blhd_path),
         "timed_over": f"{blhd_over}; library_ms is SDPA with dropout_p "
                       "0.1 on strided views of the BLHD tensors; device_ms: "
                       "the device's own time"},
        {"name": "attention_dropout_blhd_bwd", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/attention_blhd.cu",
         "replaces": "xggm_tpu/ops/pallas_attention.py:574",
         "launches": blhd_launches["attention_dropout_blhd_bwd"],
         "max_abs_err": max(max(r["k6_max_abs_err"],
                                r["k6_rate0_max_abs_err"])
                            for r in blhd_rows),
         "ms": per_forward("k6_ms", blhd_path),
         "plain_ms": per_forward("plain_k6_ms", blhd_path),
         "bound_ms": per_forward("bwd_bound_ms", blhd_path),
         "bound_by": bound_by("bwd_bound_by", blhd_path),
         "library_ms": per_forward("library_bwd_ms", blhd_path),
         "timed_over": f"{blhd_over}; library_ms is "
                       "_scaled_dot_product_efficient_attention_backward "
                       "from a saved forward, on strided views"},
        {"name": "bert_adam", "route": "cuda",
         "source": "xggm_tpu_torch/csrc/bert_adam.cu",
         "replaces": "xggm_tpu/ops/pallas_optim.py:38",
         "launches": fused_launches["bert_adam"],
         "scale_out_launches": scaled_out("bert_adam"),
         "model_parallel_launches": model_parallel["bert_adam"],
         "max_abs_err": adam["max_abs_err"], "ms": adam["ms"],
         "plain_ms": adam["plain_ms"], "bound_ms": adam["bound_ms"],
         "bound_by": adam["bound_by"], "library_ms": None,
         "fused_adamw_ms": adam["fused_adamw_ms"],
         "wrapper_ms": adam["wrapper_ms"],
         "timed_over": "one update of all parameters, every gradient "
                       "present; ms launches the kernel from one table on "
                       "the card, wrapper_ms calls fused_adam (host work "
                       "included); no PyTorch call computes BertAdam: "
                       "fused_adamw_ms is torch._fused_adamw_ over the same "
                       "tensors, with bias correction"}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--forward-device":
        sys.exit(forward_device_of(sys.argv[2]))
    if len(sys.argv) == 5 and sys.argv[1] == "--scale-out-rank":
        sys.exit(scale_out_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 4 and sys.argv[1] == "--gloo-p2p-probe":
        sys.exit(gloo_p2p_probe(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 5 and sys.argv[1] == "--composed-rank":
        sys.exit(composed_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--model-parallel-rank":
        sys.exit(model_parallel_rank(sys.argv[2], int(sys.argv[3]),
                                     sys.argv[4]))
    sys.exit(main())
