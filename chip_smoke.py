#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA GPU and holds it to its plain versions.

    python3 chip_smoke.py

Phases, each printing one JSON line (the kernels phase one per case) with
its seconds:

1. device       the card's name, count and nvidia-smi name/power limit;
2. build        nvcc builds every ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels      each kernel's wrapper against its plain version on the card,
                with its device time (CUDA-graph replay), its time per call
                from Python, the plain version's and one PyTorch library
                call's device times, and the least time the card could take
                for the work (``bound_ms``); each flash case also names the
                route that ran and fails on the other (bf16 on the tensor
                cores, fp32 on the CUDA cores), each rmsnorm case the path
                and launch shape of ``rmsnorm.plan`` and fails on another
                path; ``ssd_scan`` also against the sequential recurrence
                ``reference_ssd``; the flash forward and backward under the
                prefix-LM mask (paligemma's serve shape, vit's train shape,
                a ragged small case) and in the non-causal mode of whisper's
                encoder and cross-attention (Sq 4096 over Sk 1500), with
                ``library_ms`` SDPA with a boolean mask, ``bound_ms`` over
                the mask's valid pairs, and prefix 0 and a prefix past Sk
                giving the causal and non-causal launches' bits;
                The backward kernels (``rmsnorm_bwd``, ``flash_attention_bwd``,
                ``ssd_scan_bwd``) against the plain backward versions of
                ``kernels/ref.py`` on the same inputs, with ``library_ms``
                the backward through ``F.rms_norm`` and
                ``F.scaled_dot_product_attention`` under autograd (forward
                and backward, less the forward alone; none for ssd_scan);
                each names the path of ``rmsnorm.plan_bwd``, the route and
                tile of ``flash_attention.plan_bwd`` or the chunk_grads
                instance (route, heads a block, ring; the profiler's kernel
                name) that ran, and fails on another; each
                ``ssd_scan_bwd`` case records its five
                launches' device times (``torch.profiler``), each gradient
                is also held by norm, and the slow-decay case against a
                control without the carried state gradient; the moe
                family's widths: the flash forward at MLA's serve shape
                (128 heads, qk 192, v 128 a strided view beside k_nope),
                flash forward and backward at olmoe's train shape (16 heads
                of 128), rmsnorm at rows of 7168, 1536 and 512; the flash
                backward at paligemma's train shape (8 heads of 256 on one KV
                head, 4352 positions, prefix 256; the width-256 tile) and an
                fp32 case of the same heads at a small size; the flash
                backward at MLA's train shape (128 heads, D 192, Dv 128,
                (2, 4096), causal; the width-256 tile with zero columns),
                ``mla_train_bwd``, and an fp32 case of those widths small;
                the registry's other dense archs' widths: the flash forward
                and backward at starcoder2's train shape (36 heads of 128 on
                4, the GQA group of 9, (2, 4096)), the flash forward at
                mistral-nemo's serve shape (32 heads on 8), and rmsnorm
                forward and backward at rows of 4608 and 5120 (bf16 rows
                past 8 KB) and 768;
4. consistency  stablelm-1.6b, mamba2-370m, zamba2-1.2b and whisper-large-v3
                at full width in float32: decode logits at every prompt
                position equal the full forward's (the ssm/hybrid archs over
                two 256-row chunks, at a third of their depth; whisper over
                1500 seeded frames, its cross caches filled from the
                encoder), and reduced stablelm,
                mamba2 and zamba2 models on the card equal the same models
                on the CPU; reduced stablelm, mamba2, zamba2, paligemma
                (MQA, prefix 8), whisper and vit (fp32, each arch's remat)
                train 3 steps on the card and on the CPU from one init, with
                equal losses and grad norms; olmoe-1b-7b at full width and
                deepseek-v3-671b's full-width 2-layer cut (mtp_depth 0) in
                float32, decode against forward with capacity_factor E / k
                so that neither path drops a token; reduced olmoe (AdamW)
                and deepseek (Adafactor, MLA, MTP) train steps card vs CPU;
                each moe line names the smallest gap between a token's k-th
                and (k+1)-th router score; granite-3-8b, starcoder2-7b,
                mistral-nemo-12b and nanogpt-124m whole in float32, decode
                against forward, and their reduced configs that keep each
                arch's features (``configs.FEATURE_CUTS``: the GQA groups of
                9 and 4, attention narrower than d_model, a tied head over
                a padded vocab) train 3 steps card vs CPU;
5. serve        the serving paths: stablelm-1.6b, mamba2-370m, zamba2-1.2b,
                paligemma-3b, whisper-large-v3, olmoe-1b-7b and the
                deepseek-v3-671b 2-layer cut with its MTP head, granite-3-8b,
                starcoder2-7b, mistral-nemo-12b and nanogpt-124m at full
                width in bf16 each serve a batch through ``ServingEngine.generate``, then
                ``apply_lm`` runs on the same model (paligemma with 256
                patches before the tokens, whisper over 1500 frames); the
                launch counts of each path must be exactly the path's, which
                proves that it went through its kernels;
6. train        the training paths: full-width bf16 stablelm-1.6b, mamba2-370m
                and zamba2-1.2b, each with its own TrainConfig (AdamW, remat
                full) at seq 4096, batch 2 (the train_4k global batch of 256
                cut to what one card holds), whisper-large-v3 the same over
                1500 frames, paligemma-3b the same after 256 patches (4352
                positions, head dim 256), and vit-base-16 at batch 64 (196
                patches, 16 tokens; remat full), olmoe-1b-7b cut to 4
                layers at full width (AdamW, remat full, (2, 4096)), and
                deepseek-v3-671b cut to its first 2 (dense MLA) layers and
                its MTP head at full width (Adafactor at lr 1e-4, remat
                full, (2, 4096); 3.95 B params, no routed expert),
                granite-3-8b, starcoder2-7b and mistral-nemo-12b cut to 18,
                15 and 6 layers at full width and nanogpt-124m whole (each
                arch's AdamW, (2, 4096)), through
                ``launch/train.py``'s loop: one warm-up step, then 4 steps on
                one fixed batch, each with exactly its launches; olmoe's run
                twice from one init, with equal bits; after each run a
                ``roofline`` line: the same step at world size 1 counted on
                fake tensors (``roofline.count_step``, in worker processes
                that run beside the build and end with it, so that no timed
                phase shares the host with them), its model flops and
                counted flops, the median step, ``mfu`` and
                ``bound_fraction``, and the params ``mfu`` counts beside
                the params the state holds;
7. workflow     the paper's production loop through the port's Couler layer
                (``repro_torch.core``): full-width bf16 stablelm-1.6b as the
                steps prepare-corpus (a ``ShardedCorpus``), train (a warm-up
                step and 4 steps at (2, 4096) read through
                ``CachedShardReader``, not cacheable), evaluate and serve
                (``ServingEngine.generate`` on the trained params) on
                ``LocalEngine(enable_speculation=False, profile_steps=True)``,
                submitted twice: each step's record and profile, the train
                steps' times by CUDA events against the profile's fenced
                ``execute_s``, exact launches per train step and serve pass,
                prepare-corpus Cached and shard-cache hits the second time,
                and the time of the serve step's content key over the
                trained params; a repeat workflow whose train step cycles
                two batches (each seen at least twice) with an evaluate
                gate on a margin predicted in advance; then reduced checks
                in fp32: a recomputed CUDA tensor artifact leaves its
                consumer Cached, a checkpoint-wired train step resumes
                after mid-step kills with an uninterrupted run's losses, a
                profiled step that returns with ~50 ms of products queued
                has an ``execute_s`` that covers them, and
                ``train_real_model`` ends lower at lr 3e-3 than at 3.0;
8. distributed  the mesh loop of ``launch/train.py`` (``mesh_state``,
                ``mesh_step``) on NCCL at world size 1, mesh (1,1) over
                ("data", "model"): full-width bf16 stablelm-1.6b under the
                baseline and pure_fsdp strategies (params, AdamW moments and
                batch as DTensors, every kernel entered on local shards), a
                warm-up step and 4 steps on the train phase's batch and
                init, and mamba2-370m under baseline for 2 steps; each step's
                loss within 1e-3 relative of the train phase's, the last
                below the first, exactly the train phase's launches per
                step, and step_s, tokens_per_s and peak memory beside the
                card line; then stablelm-1.6b's serve run again under the
                mesh (params by ``param_specs``, fp32 caches by
                ``cache_specs`` as DTensors, decode attention on the
                caches' local blocks): its greedy tokens equal the serve
                phase's and each step launches exactly the serve phase's
                decode kernels. The multi-rank checks (EP, all-to-all, moe_rs,
                the compressed mean, the pipeline) would need gloo on this
                one card; it takes CUDA tensors for its all-to-all,
                all-gather, reduce-scatter and MAX all-reduce but not for
                send/recv, which the pipeline's ring permute needs
                (``GLOO_TAKES_CUDA``), so they run in the CPU tests only.

Then the run's seconds, a summary line {"kernels": [...]}, the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero before
the last line. Needs one CUDA device; imports nothing of JAX.
"""
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The bound of each kernel case (``bound_ms``) and each train path's roofline
# line read the published peaks of one H100 SXM (data sheet, dense, 700 W)
# and the kernels' work from ``repro_torch/roofline/analysis.py``.
# bf16: tests/test_kernels.py's tolerance. fp32: sums run in another order
# than the plain version's, with TF32 off.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Decode logits against forward logits (tests/test_models.py:84).
CONSISTENCY_TOL = 2e-2
# serve: 4 prompts of 128 tokens, then 32 greedy tokens (host-bound decode
# steps, each path's launches exact per step)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
# stablelm's serve phase also samples one batch at temperature 1.0, twice
# from one seed: SAMPLE_GEN tokens after a prompt of SAMPLE_PROMPT
SAMPLE_TEMPERATURE, SAMPLE_SEED, SAMPLE_PROMPT, SAMPLE_GEN = 1.0, 7, 4, 16
CONSISTENCY_PROMPT = 64
# The train phase: train_4k's sequence (configs/base.py), its global batch of
# 256 cut to 2 sequences, what one 80 GB card holds with fp32 AdamW moments.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
TRAIN_CUT = "train_4k global batch 256 cut to 2 per card (one H100)"
# Loss and grad norm of the card's train steps against the CPU's (fp32).
TRAIN_TOL = 1e-4
# The forward's lse (fp32 sums of the same exact products) against the plain
# one: (atol, rtol), as tests/test_torch_cuda.py holds it.
LSE_TOL = (1e-3, 1e-4)
# ||got - want|| / ||want|| of the ssd_scan_bwd gradients (dx, d dA, dB, dC),
# by B/C's dtype. The kernel's split products read about 4e-6 on dx and d dA,
# and with bf16 B and C, where dB and dC are rounded to bf16, 1e-4 on those
# (with fp32 B and C, three pieces, 1e-6 to 3e-6); the plain backward from x
# and dy rounded to bf16, the control of the bf16 cases, reads about 2e-3 on
# dx and d dA and 3e-3 on dB and dC.
SSD_GRAD_NORM_TOL = {"float32": (1e-4, 1e-4, 1e-4, 1e-4),
                     "bfloat16": (1e-4, 1e-4, 1e-3, 1e-3)}
# ||got - want|| / ||want|| of each flash gradient. A sound bf16 kernel reads
# about 3e-3 (bf16 P^T, dS^T and outputs); the same gradients from inputs
# rounded to fp8 e4m3, the control, about 5e-2; the case fails unless the
# kernel is under the limit and the control over it.
GRAD_NORM_TOL = 1e-2
SSM_CONSISTENCY_PROMPT = 512        # two chunks of 256
# The fp32 ssm/hybrid decode-vs-forward loops at a third of their depth
# (mamba2 48 -> 16 layers; zamba2 38 -> 14: 2 shared blocks and 2 leftover
# layers), so that the mesh decode of phase 8 fits the smoke's time
SSM_CONSISTENCY_CUT = {"mamba2-370m": 16, "zamba2-1.2b": 14}
SSM_FORWARD_LEN = 1024              # apply_lm after an ssm/hybrid serve run
# vit-base-16's train batch: 64 images of 196 patches and 16 text tokens
VIT_BATCH, VIT_TOKENS = 64, 16
# deepseek-v3-671b at full width, cut to 2 layers (one first_k_dense layer
# and one moe layer): 14.87 B params with the MTP head, 29.74 GB in bf16
DEEPSEEK_CUT = dict(num_layers=2, first_k_dense=1)
DEEPSEEK_CUT_TEXT = "61 layers cut to 2: first_k_dense 3 -> 1, one moe layer"
# deepseek-v3-671b trains at full width as its first two layers, both dense
# (MLA and a d_ff 18,432 SwiGLU), with its MTP head: 3,945,204,736 params,
# no routed expert. Its own Adafactor at lr 3e-4 overshoots on one batch at
# width 7168 (on the H100, NVIDIA H100 80GB HBM3 at 700.00 W, bf16 at
# (2, 4096): losses 9.28, 14.46, 12.08, 13.06 after the warm-up step, then
# no lower over 8 steps: scripts/train_probe.py, PERF.md section 6). The
# port's steps of this cut equal the JAX package's at full width: on the
# CPU in fp32 at (1, 64), losses within 1.4e-5 (lr 3e-4) and 1.0e-4 (lr
# 1e-4) relative, over 4 steps (scripts/fullwidth_parity.py, PERF.md
# section 6); that run does not reproduce the card's case, where 1e-4
# falls. The run
# takes lr 1e-4, 3e-4 x 2048 / 7168 rounded, the step per logit of the
# width-2048 archs' runs: a departure from the configuration for a run
# on one batch
DEEPSEEK_TRAIN_CUT = dict(num_layers=2, first_k_dense=2)
DEEPSEEK_TRAIN_LR = dict(learning_rate=1e-4)
DEEPSEEK_TRAIN_CUT_TEXT = ("61 layers cut to the first 2 dense layers and the MTP head; "
                           "no experts; Adafactor at lr 1e-4, not 3e-4")
# olmoe-1b-7b trains at full width per layer, 16 layers cut to 4: 1.88 B
# params, 22.6 GB with AdamW (the full model's step would take about 83 GB)
OLMOE_TRAIN_CUT = dict(num_layers=4)
# The registry's other dense archs train at full width as layer cuts, their
# embedding and head whole. On the H100 (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6) cuts of 12, 10 and 4 layers peaked at 37.9, 38.9 and
# 49.1 GB, about 12 bytes a param of the layers (bf16 params and grads,
# fp32 moments) and 2.4, 2.7 and 3.4 GB a layer; the whole models (8.17 /
# 7.40 / 12.25 B params) would take 100-150 GB. These cuts, about 53-56 GB,
# hold 3.79 / 3.71 / 2.98 B params. nanogpt-124m trains whole.
DENSE_TRAIN_CUTS = {"granite-3-8b": (18, "40 layers cut to 18"),
                    "starcoder2-7b": (15, "32 layers cut to 15"),
                    "mistral-nemo-12b": (6, "40 layers cut to 6")}
# The train phase's runs: (arch, batch, seq, what the cut is, config fields
# replaced, TrainConfig fields replaced). vit-base-16's own TrainConfig has
# remat none; the phase holds every path to remat full, where each body's
# kernels run again in the recompute.
TRAIN_RUNS = tuple((aid, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CUT, {}, {}) for aid in (
    "stablelm-1.6b", "mamba2-370m", "zamba2-1.2b", "whisper-large-v3",
    "paligemma-3b")) + (
    ("vit-base-16", VIT_BATCH, VIT_TOKENS, "the paper's RQ2 ViT-B/16 batch: 64 images "
     "of 196 patches, 16 text tokens", {}, {"remat": "full"}),
    ("olmoe-1b-7b", TRAIN_BATCH, TRAIN_SEQ, TRAIN_CUT + "; 16 layers cut to 4 (AdamW's "
     "full-model step would take about 83 GB)", OLMOE_TRAIN_CUT, {}),
    ("deepseek-v3-671b", TRAIN_BATCH, TRAIN_SEQ, TRAIN_CUT + "; " + DEEPSEEK_TRAIN_CUT_TEXT,
     DEEPSEEK_TRAIN_CUT, DEEPSEEK_TRAIN_LR)) + tuple(
    (aid, TRAIN_BATCH, TRAIN_SEQ, f"{TRAIN_CUT}; {text}", {"num_layers": n}, {})
    for aid, (n, text) in DENSE_TRAIN_CUTS.items()) + (
    ("nanogpt-124m", TRAIN_BATCH, TRAIN_SEQ, TRAIN_CUT, {}, {}),)


# Processes counting the train runs' steps on fake tensors during the build:
# one alone takes longer than the build, three about as long
COUNT_WORKERS = 3


def train_configs(aid: str, cfg_kw: dict, tcfg_kw: dict):
    """The arch's own config and TrainConfig at full width, fields replaced."""
    from repro_torch.launch import train as launch_train
    cfg, tcfg = launch_train.configs(aid, full=True)
    return cfg.replace(**cfg_kw), dataclasses.replace(tcfg, **tcfg_kw)


def train_shape(batch_size: int, seq: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"train_{batch_size}x{seq}", seq, batch_size, "train")


def count_train_step(aid: str, batch_size: int, seq: int, cfg_kw: dict, tcfg_kw: dict):
    """One train run's step at world size 1 counted on fake tensors
    (``roofline.count_step``: nothing allocated, no launch) and the seconds
    the count took. Runs in a worker process beside the build, which sees
    no card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.specs import input_specs
    from repro_torch.roofline import analysis as RF
    from repro_torch.training import train as TR
    t0 = time.perf_counter()
    cfg, tcfg = train_configs(aid, cfg_kw, tcfg_kw)
    with FakeTensorMode():
        state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
        terms = RF.count_step(TR.make_train_step(cfg, tcfg), state,
                              input_specs(cfg, train_shape(batch_size, seq)))
    return terms, time.perf_counter() - t0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def call_ms(torch, fn, min_total_ms: float = 30.0) -> float:
    """Mean time of one fn() call, Python wrapper included: CUDA events around
    back-to-back calls, after a warm-up. Where the host launches calls more
    slowly than the card runs them, this is the host's rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    iters = 5
    while True:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        total = start.elapsed_time(end)
        if total >= min_total_ms or iters >= 2000:
            return total / iters
        iters = min(2000, max(iters * 2, int(iters * min_total_ms / max(total, 1e-3))))


def device_ms(torch, fn, per_call_ms: float, min_total_ms: float = 30.0) -> float:
    """Mean device time of one fn() call: n calls captured in a CUDA graph,
    replayed between CUDA events, so the host's launch rate drops out."""
    n = max(1, min(500, int(min_total_ms / max(per_call_ms, 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    return ms


# ssd_scan_bwd's five launches, by a mark in each kernel's name
SSD_BWD_LAUNCHES = ("chunk_dstate", "dstate_pass", "chunk_grads", "reduce_rows", "dA_scan")


def launch_ms(torch, fn, marks, reps: int = 3):
    """Device ms per call of each of fn's kernels, by the first of ``marks``
    its name holds, the names of the kernels under each mark, and the
    traces taken, from ``torch.profiler`` over ``reps`` calls after one
    warm-up call. A trace without a kernel of every mark (the profiler at
    times drops a kernel) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for tries in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, names = {m: 0.0 for m in marks}, {m: set() for m in marks}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            mark = next((m for m in marks if m in e.name), None)
            if mark is not None:
                out[mark] += e.time_range.elapsed_us() / 1e3 / reps
                names[mark].add(e.name)
        if all(names.values()):
            break
    return out, {m: sorted(v) for m, v in names.items()}, tries


def timed_grads(torch, fwd, inputs, grad_out):
    """Device time of the backward through ``fwd`` under autograd: forward
    and backward together, less the forward alone, each by CUDA-graph
    replay."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]

    def both():
        return torch.autograd.grad(fwd(*leaves), leaves, grad_out)

    def forward():
        with torch.no_grad():
            return fwd(*leaves)

    return (device_ms(torch, both, call_ms(torch, both))
            - device_ms(torch, forward, call_ms(torch, forward)))


def sdpa_mask(torch, Sq: int, Sk: int, causal: bool, prefix: int, device):
    """SDPA's arguments for the same mask: is_causal for the plain causal
    mask, a boolean (Sq, Sk) attn_mask for a prefix, neither without the
    causal flag."""
    if not causal:
        return {}
    if not prefix:
        return {"is_causal": True}
    j = torch.arange(Sk, device=device)
    return {"attn_mask": (j[None] <= torch.arange(Sq, device=device)[:, None]) | (j < prefix)}


# The workflow phase: stablelm-1.6b's production loop as Couler steps over a
# corpus of 8 shards of 8,192 tokens over the model's vocab, of which the
# warm-up step and TRAIN_STEPS steps at (TRAIN_BATCH, TRAIN_SEQ) read 40,970.
WF_ARCH = "stablelm-1.6b"
WF_SHARDS, WF_SHARD_TOKENS = 8, 8192
# The reduced checks: checkpoint-resume after a mid-step kill (as
# tests/test_faults.py sets it) and the Fig. 8 payload's two learning rates.
WF_RESUME_ITERS = 6
WF_KILL_PLAN = dict(seed=5, worker_loss_rate=1.0, max_failures_per_site=2,
                    mid_step_kill_window=4)
WF_GOOD_LR, WF_BAD_LR, WF_TUNE_STEPS = 3e-3, 3.0, 30
# Per submission, what its train and serve steps measured. A module global:
# a step's key covers its closure's contents, so a record that grows in a
# closure cell would give the serve step a new key on every submission.
WF_INSIDE = []
# The repeat workflow: its train step cycles WF_REPEAT_BATCHES batches over
# the warm-up and TRAIN_STEPS steps, so each is seen at least twice; its
# evaluate gate wants the last loss below the first by WF_REPEAT_MARGIN
# (half the margin PERF.md predicts from the train phase's one-batch run).
WF_REPEAT_BATCHES, WF_REPEAT_MARGIN = 2, 0.5
# The distributed phase: world size 1 on NCCL, mesh (1,1); each arch's
# strategies and timed steps, and each loss against the train phase's.
DIST_RUNS = (("stablelm-1.6b", "baseline", TRAIN_STEPS),
             ("stablelm-1.6b", "pure_fsdp", TRAIN_STEPS),
             ("mamba2-370m", "baseline", 2))
DIST_LOSS_RTOL = 1e-3
# decodes under the mesh after the train runs, against the serve phase's tokens
DIST_DECODE_ARCH = "stablelm-1.6b"
# scripts/probe_gloo_cuda.py on the H100 (torch 2.11.0+cu128): gloo takes
# CUDA tensors (int8 and fp32) for all_to_all_single, all_gather_into_tensor,
# reduce_scatter_tensor and a MAX all_reduce, but send/recv fails on them
# ("writev ... Bad address"), so not every collective the multi-rank checks
# use: they stay in the CPU tests, and this phase runs world size 1 only.
GLOO_TAKES_CUDA = False


def distributed_phase(torch, cuda, main_paths, train_losses, served) -> None:
    """Phase 8. ``DIST_RUNS`` through ``launch/train.py``'s mesh loop on
    NCCL at world size 1, each from the train phase's init (seed 0) on its
    batch, held to its losses (``train_losses[aid]``) and launches, then
    ``mesh_decode`` against the serve phase's ``served`` (prompts, tokens).
    Adds each run's launches to ``main_paths``; raises on any failed
    check."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR

    if not GLOO_TAKES_CUDA:
        emit({"phase": "distributed", "what": "multi-rank checks (EP, all-to-all, "
              "moe_rs, compressed mean, pipeline)", "on_card": False,
              "where": "tests/test_torch_distributed.py on the CPU: gloo's send/recv "
              "takes no CUDA tensor here, and NCCL needs a card per rank"})
    store = Path(tempfile.mkdtemp(dir=ROOT / "build")) / "rdzv"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        for aid, strategy, n_steps in DIST_RUNS:
            t_phase = time.perf_counter()
            cfg, tcfg = launch_train.configs(aid, full=True)
            rules = rules_for(aid, strategy)
            batch = next(launch_train.with_modality_inputs(
                cfg, synthetic_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed=0, n=1)))
            steps = []

            def on_step(step, m):
                torch.cuda.synchronize()
                steps.append((time.perf_counter(), float(m["loss"]),
                              float(m["grad_norm"]), dict(ops.LAUNCHES)))
                ops.reset_launches()

            with use_mesh(mesh, rules, strategy):
                state = launch_train.mesh_state(cfg, tcfg, mesh, rules, strategy, cuda)
                placements = sorted({str(tuple(p.placements)) for p in
                                     state["params"].parameters()})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                launch_train.train_loop(state, launch_train.mesh_step(cfg, tcfg, mesh, rules),
                                        iter([batch] * (1 + n_steps)), steps=1 + n_steps,
                                        device=cuda, log_every=0, on_step=on_step,
                                        compute_dtype=cfg.compute_dtype)
            peak = torch.cuda.max_memory_allocated()
            timed = steps[1:]
            step_s = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
            losses = [st[1] for st in timed]
            per_step = [st[3] for st in timed]
            want = train_losses[aid][:n_steps]
            expect = TR.kernel_launches_per_step(cfg, tcfg.remat)
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            ok = (len(timed) == n_steps and all(r <= DIST_LOSS_RTOL for r in rel)
                  and losses[-1] < losses[0] and all(ls == expect for ls in per_step)
                  and all(map(math.isfinite, losses + [st[2] for st in timed])))
            emit({"phase": "distributed", "arch": cfg.name, "strategy": strategy,
                  "mesh": {"data": 1, "model": 1}, "backend": "nccl", "world": 1,
                  "param_placements": placements, "layers": cfg.num_layers,
                  "dtype": cfg.compute_dtype, "optimizer": tcfg.optimizer,
                  "remat": tcfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                  "reduced": TRAIN_CUT,
                  "warmup_step": {"loss": steps[0][1], "launches": steps[0][3]},
                  "step_s": step_s,
                  "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / t for t in step_s],
                  "max_memory_allocated_bytes": peak, "losses": losses,
                  "train_phase_losses": want, "loss_rel_err": rel,
                  "grad_norms": [st[2] for st in timed], "launches_per_step": per_step,
                  "expected_launches_per_step": expect, "card": dev_card_line(),
                  "ok": ok, "seconds": time.perf_counter() - t_phase})
            if not ok:
                fail(f"{aid} {strategy} distributed phase failed: losses {losses} "
                     f"against {want}, launches {per_step}, expected {expect}")
            total = {k: sum(ls[k] for ls in per_step) for k in expect}
            for name, n in expect.items():
                if n and total[name] == 0:
                    fail(f"kernel {name} was never launched on the {aid} mesh path")
            main_paths[f"{aid}/mesh {strategy}"] = total
            del state
            torch.cuda.empty_cache()
        mesh_decode(torch, cuda, mesh, main_paths, served)
    finally:
        dist.destroy_process_group()


def mesh_decode(torch, cuda, mesh, main_paths, served) -> None:
    """The serve phase's stablelm-1.6b run again under the mesh: the same
    seeded bf16 params placed by ``param_specs``, fp32 caches (the engine's)
    laid out by ``cache_specs`` as DTensors, and the engine's loop (the
    prompt through the decode path, then greedy tokens) through
    ``apply_lm_decode``, each step's attention on the cache's local blocks.
    Its tokens must equal the serve phase's, and each step launch exactly
    the serve phase's decode step's kernels."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import place_caches
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR
    t_phase = time.perf_counter()
    aid, strategy = DIST_DECODE_ARCH, "baseline"
    prompts, want = served
    cfg = get_arch(aid).model
    rules = rules_for(aid, strategy)
    B, P = prompts.shape
    params = T.init_lm(cfg, 0, device=cuda)
    with use_mesh(mesh, rules, strategy):
        params = TR.place_params(params, cfg, mesh, rules, strategy).requires_grad_(False)
        caches = place_caches(T.init_caches(cfg, B, SERVE_PROMPT + SERVE_GEN, torch.float32,
                                            device=cuda), mesh, rules)
    cache_placements = sorted({str(tuple(t.placements)) for t in caches["layers"][0].values()})
    prompts = prompts.to(cuda)
    expect = {name: 0 for name in ops.LAUNCHES}
    expect["rmsnorm"] = 2 * cfg.num_layers + 1
    per_step, step_s, tokens, finite = [], [], [], True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), use_mesh(mesh, rules, strategy), implicit_replication():
        tok = None
        for i in range(P + SERVE_GEN - 1):
            ops.reset_launches()
            t0 = time.perf_counter()
            logits, _ = T.apply_lm_decode(params, cfg, prompts[:, i:i + 1] if i < P else tok,
                                          caches, i)
            last = logits.full_tensor()[:, -1]
            tok = last.argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(dict(ops.LAUNCHES))
            finite = finite and bool(torch.isfinite(last).all())
            if i >= P - 1:
                tokens.append(tok)
    got = torch.cat(tokens, dim=1).tolist()
    decode_ms = sorted(1e3 * t for t in step_s[P:])
    ok = got == want and finite and all(ls == expect for ls in per_step)
    emit({"phase": "distributed", "what": "decode over caches laid out by cache_specs",
          "arch": cfg.name, "strategy": strategy, "mesh": {"data": 1, "model": 1},
          "backend": "nccl", "world": 1, "layers": cfg.num_layers,
          "dtype": cfg.compute_dtype, "cache_dtype": "float32",
          "cache_placements": cache_placements, "batch": B, "prompt": P, "gen": SERVE_GEN,
          "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "tokens_equal_serve_phase": got == want, "logits_finite": finite,
          "launches_per_step": per_step[-1], "expected_launches_per_step": expect,
          "steps_with_expected_launches": sum(ls == expect for ls in per_step),
          "steps": len(per_step), "card": dev_card_line(),
          "ok": ok, "seconds": time.perf_counter() - t_phase})
    if not ok:
        fail(f"{aid} mesh decode failed: tokens equal {got == want}, finite {finite}, "
             f"launches {per_step[-1]}, expected {expect} per step")
    main_paths[f"{aid}/mesh decode"] = {k: sum(ls[k] for ls in per_step) for k in expect}
    del params, caches
    torch.cuda.empty_cache()


def dev_card_line() -> str:
    from repro_torch import device as dev
    return dev.card_line()


def workflow_phase(torch, cuda, main_paths, every_kernel) -> None:
    """Phase 7. The full-width production loop of ``WF_ARCH`` (bf16, its own
    TrainConfig) as a Couler workflow on the port's ``LocalEngine``
    (speculation off, every step profiled), submitted twice; then reduced
    checks on the card in fp32: a recomputed tensor artifact keeps its
    consumer Cached, a checkpoint-wired train step resumes after mid-step
    kills with the losses of an uninterrupted run, a profiled step's
    ``execute_s`` covers the card work it left queued, and
    ``train_real_model`` orders a good and a bad learning rate. Adds the loop's launches to
    ``main_paths``; raises on any failed check."""
    import shutil
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import couler
    from repro_torch.core.autotune import train_real_model
    from repro_torch.core.caching import CacheStore, CoulerPolicy
    from repro_torch.core.engines.base import StepStatus
    from repro_torch.core.engines.local import LocalEngine, cache_key
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data.pipeline import (CachedShardReader, ShardedCorpus,
                                           synthetic_batches)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import train as TR

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_workflow"
    shutil.rmtree(work, ignore_errors=True)
    cfg, tcfg = launch_train.configs(WF_ARCH, full=True)
    expect_step = TR.kernel_launches_per_step(cfg, tcfg.remat)
    decode_steps = SERVE_PROMPT + SERVE_GEN - 1
    expect_serve = every_kernel({"rmsnorm": decode_steps * (2 * cfg.num_layers + 1)})
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator().manual_seed(4))
    cache = CacheStore(capacity_bytes=1 << 30, policy=CoulerPolicy())
    inside = WF_INSIDE
    inside.clear()

    def launches_since(before):
        return {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()}

    def prepare_corpus():
        corpus = ShardedCorpus(str(work / "shards"), n_shards=WF_SHARDS,
                               tokens_per_shard=WF_SHARD_TOKENS, vocab=cfg.vocab_size)
        corpus.materialize()
        return corpus

    def train(corpus):
        """A warm-up step and TRAIN_STEPS steps on batches read through the
        artifact cache, each timed by CUDA events, its launches counted on
        the host. Nothing here waits for the card: the step returns while
        the last update still runs, and the engine's fence waits for it."""
        rec = WF_INSIDE[-1]
        hits, misses = cache.stats["hits"], cache.stats["misses"]
        reader = CachedShardReader(corpus, cache=cache)
        state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
        step_fn = TR.make_train_step(cfg, tcfg)
        batches = reader.batches(TRAIN_BATCH, TRAIN_SEQ)
        losses, gnorms = [], []
        for _ in range(1 + TRAIN_STEPS):
            batch = TR.to_device(next(batches), cuda)
            before = dict(ops.LAUNCHES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            rec["train_launches"].append(launches_since(before))
            rec["events"].append((start, end))
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        h, ms = cache.stats["hits"] - hits, cache.stats["misses"] - misses
        rec["shard_reads"] = {"hits": h, "misses": ms}
        return {"losses": torch.stack(losses), "grad_norms": torch.stack(gnorms),
                "params": state["params"]}

    def evaluate(result):
        losses = result["losses"].tolist()
        return losses[-1] < losses[0]

    def serve(result):
        rec = WF_INSIDE[-1]
        engine = ServingEngine(cfg, result["params"], max_len=SERVE_PROMPT + SERVE_GEN,
                               device=cuda)
        before = dict(ops.LAUNCHES)
        res = engine.generate(prompts, gen_len=SERVE_GEN)
        rec["serve_launches"].append(launches_since(before))
        rec["serve"] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                        "tokens_per_s": res.tokens_per_s,
                        "decode_step_ms": 1e3 * res.decode_s / (SERVE_GEN - 1)}
        return res.tokens

    def build():
        with couler.workflow(f"train-serve-{WF_ARCH}") as ir:
            corpus = couler.run_step(prepare_corpus, step_name="prepare-corpus")
            result = couler.run_step(train, corpus, step_name="train", cacheable=False)
            couler.run_step(evaluate, result, step_name="evaluate")
            couler.run_step(serve, result, step_name="serve")
        return ir

    # the main path: both submissions, counted from 0
    eng = LocalEngine(cache=cache, enable_speculation=False, profile_steps=True)
    runs = []
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        for _ in range(2):
            inside.append({"train_launches": [], "events": [], "serve_launches": []})
            runs.append(eng.submit(build()))
    finally:
        eng.close()
    path_launches = dict(ops.LAUNCHES)

    def shard_hit_ratio(rec):
        n = rec["shard_reads"]["hits"] + rec["shard_reads"]["misses"]
        return rec["shard_reads"]["hits"] / n if n else 0.0

    subs, ok = [], True
    want_total = every_kernel({})
    for run, rec in zip(runs, inside):
        steps = {name: {"status": r.status.value, "seconds": r.end - r.start,
                        "attempts": r.attempts, "profile": r.profile,
                        **({"error": r.error} if r.error else {})}
                 for name, r in run.steps.items()}
        sub = {"status": run.status, "steps": steps}
        if run.succeeded():
            event_s = [a.elapsed_time(b) / 1e3 for a, b in rec["events"]]
            prof = run.steps["train"].profile or {}
            result = run.artifacts["train:out"]
            sub.update({
                "evaluate": run.artifacts["evaluate:out"],
                "losses": result["losses"].tolist(),
                "grad_norms": result["grad_norms"].tolist(),
                "train_step_s_by_events": event_s,
                "train_execute_s": prof.get("execute_s"),
                "train_device_bytes_in_use": prof.get("device_bytes_in_use"),
                "shard_reads": rec["shard_reads"],
                "shard_hit_ratio": shard_hit_ratio(rec),
                "train_launches_per_step": rec["train_launches"],
                "serve_launches": rec["serve_launches"],
                "serve": rec.get("serve")})
            ok = (ok and run.artifacts["evaluate:out"] is True
                  and len(rec["train_launches"]) == 1 + TRAIN_STEPS
                  and all(ls == expect_step for ls in rec["train_launches"])
                  and all(ls == expect_serve for ls in rec["serve_launches"])
                  and prof.get("execute_s", 0.0) >= sum(event_s)
                  and prof.get("device_bytes_in_use", 0.0) > 0
                  and all(map(math.isfinite, sub["losses"] + sub["grad_norms"])))
            for ls in rec["train_launches"] + rec["serve_launches"]:
                want_total = {k: want_total[k] + ls[k] for k in want_total}
        else:
            ok = False
        subs.append(sub)
    ok = (ok and path_launches == want_total
          and runs[1].steps["prepare-corpus"].status == StepStatus.CACHED
          and shard_hit_ratio(inside[1]) > 0)

    # the content key of the serve step: the trained params, hashed on the host
    params = runs[-1].artifacts["train:out"]["params"]
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    t0 = time.perf_counter()
    key = cache_key(runs[-1].workflow.jobs["serve"], runs[-1].artifacts)
    key_s = time.perf_counter() - t0
    emit({"phase": "workflow", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
          "optimizer": tcfg.optimizer, "remat": tcfg.remat, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "reduced": TRAIN_CUT,
          "corpus": {"shards": WF_SHARDS, "tokens_per_shard": WF_SHARD_TOKENS,
                     "vocab": cfg.vocab_size},
          "engine": {"enable_speculation": False, "profile_steps": True},
          "submissions": subs, "expected_train_launches_per_step": expect_step,
          "expected_serve_launches": expect_serve, "launches": path_launches,
          "expected_launches": want_total,
          "serve_cache_key": {"seconds": key_s, "param_bytes": param_bytes,
                              "key": key},
          "ok": ok, "seconds": time.perf_counter() - t_phase})
    if not ok:
        fail(f"the {WF_ARCH} workflow phase failed: {subs}")
    for name, n in want_total.items():
        if n and path_launches[name] == 0:
            fail(f"kernel {name} was never launched on the {WF_ARCH} workflow path")
    del runs, params, inside, subs
    torch.cuda.empty_cache()

    # the repeat workflow: a train step that sees each batch at least twice,
    # and an evaluate gate with a margin predicted in advance
    t_phase = time.perf_counter()
    repeat = {"launches": []}

    def train_repeat(corpus):
        reader = CachedShardReader(corpus, cache=cache)
        it = reader.batches(TRAIN_BATCH, TRAIN_SEQ)
        distinct = [next(it) for _ in range(WF_REPEAT_BATCHES)]
        state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
        step_fn = TR.make_train_step(cfg, tcfg)
        losses = []
        for i in range(1 + TRAIN_STEPS):
            before = dict(ops.LAUNCHES)
            state, m = step_fn(state, TR.to_device(distinct[i % WF_REPEAT_BATCHES], cuda))
            repeat["launches"].append(launches_since(before))
            losses.append(m["loss"])
        return {"losses": torch.stack(losses)}

    def evaluate_margin(result):
        losses = result["losses"].tolist()
        return losses[0] - losses[-1] >= WF_REPEAT_MARGIN

    with couler.workflow(f"train-repeat-{WF_ARCH}") as ir:
        corpus = couler.run_step(prepare_corpus, step_name="prepare-corpus")
        result = couler.run_step(train_repeat, corpus, step_name="train-repeat",
                                 cacheable=False)
        couler.run_step(evaluate_margin, result, step_name="evaluate-repeat")
    eng = LocalEngine(cache=cache, enable_speculation=False)
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        rrun = eng.submit(ir)
    finally:
        eng.close()
    repeat_launches = dict(ops.LAUNCHES)
    r_losses = rrun.artifacts["train-repeat:out"]["losses"].tolist() if rrun.succeeded() else []
    want_repeat = every_kernel({k: (1 + TRAIN_STEPS) * v for k, v in expect_step.items()})
    repeat_ok = (rrun.succeeded() and rrun.artifacts["evaluate-repeat:out"] is True
                 and rrun.steps["prepare-corpus"].status == StepStatus.CACHED
                 and all(ls == expect_step for ls in repeat["launches"])
                 and repeat_launches == want_repeat
                 and all(map(math.isfinite, r_losses)))
    emit({"phase": "workflow", "what": "repeat: each batch seen at least twice",
          "arch": cfg.name, "batches": WF_REPEAT_BATCHES, "steps": 1 + TRAIN_STEPS,
          "statuses": {k: r.status.value for k, r in rrun.steps.items()},
          "losses": r_losses,
          "margin": (r_losses[0] - r_losses[-1]) if r_losses else None,
          "margin_gate": WF_REPEAT_MARGIN, "launches": repeat_launches,
          "expected_launches": want_repeat, "ok": repeat_ok,
          "seconds": time.perf_counter() - t_phase})
    if not repeat_ok:
        fail(f"the {WF_ARCH} repeat workflow failed: losses {r_losses}, "
             f"statuses {[r.status.value for r in rrun.steps.values()]}")
    main_paths[f"{WF_ARCH}/workflow"] = {k: path_launches[k] + repeat_launches[k]
                                         for k in path_launches}
    del rrun, repeat
    torch.cuda.empty_cache()

    # reduced checks on the card, fp32 -----------------------------------------
    t_phase = time.perf_counter()
    small = reduced(get_arch(WF_ARCH).model).replace(param_dtype="float32",
                                                     compute_dtype="float32")
    small_tcfg = dataclasses.replace(get_arch(WF_ARCH).train, learning_rate=1e-3,
                                     remat="none")
    made = []
    tokens = torch.randint(0, small.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(2)).to(cuda)

    def make_logits():
        """Non-cacheable: the same logits on the card in a new tensor."""
        with torch.inference_mode():
            logits, _ = T.apply_lm(T.init_lm(small, 1, device=cuda), small, tokens)
        made.append(logits)
        return logits

    def consume(logits):
        consume.calls += 1          # on the function: a closure cell is keyed
        return float(logits.abs().sum())

    consume.calls = 0

    def build_recompute():
        with couler.workflow("recompute") as ir:
            t = couler.run_step(make_logits, step_name="make", cacheable=False)
            couler.run_step(consume, t, step_name="consume")
        return ir

    eng = LocalEngine(cache=CacheStore(), enable_speculation=False)
    try:
        rr = [eng.submit(build_recompute()) for _ in range(2)]
    finally:
        eng.close()
    recompute = {"statuses": [{k: r.steps[k].status.value for k in r.steps} for r in rr],
                 "logits_on": str(made[0].device) if made else None,
                 "equal_values": bool(len(made) == 2 and torch.equal(made[0], made[1])),
                 "new_tensor": bool(len(made) == 2 and made[0] is not made[1]
                                    and made[0].data_ptr() != made[1].data_ptr()),
                 "consumer_calls": consume.calls}
    rec_ok = (all(r.succeeded() for r in rr) and made[0].device == cuda
              and recompute["equal_values"] and recompute["new_tensor"]
              and rr[1].steps["consume"].status == StepStatus.CACHED
              and consume.calls == 1)
    del made

    batches = list(synthetic_batches(2, 16, small.vocab_size, seed=3, n=WF_RESUME_ITERS))

    def ckpt_train(losses, log, starts):
        def train(n, ckpt=None):
            state = TR.init_train_state(small, small_tcfg, 0, device=cuda)
            start = 0
            if ckpt.latest_step() is not None:
                state = ckpt.restore(like=state)
                start = ckpt.latest_step() + 1
            starts.append(start)
            step = TR.make_train_step(small, small_tcfg)
            for i in range(start, n):
                ckpt.tick(i)                      # interruption point
                log.append(i)
                state, m = step(state, TR.to_device(batches[i], cuda))
                losses[i] = float(m["loss"])
                ckpt.save(i, state)
            return int(state["step"])
        return train

    resume = {}
    for name, plan in (("uninterrupted", None),
                       ("killed", FaultPlan(targets=frozenset(["ck/train"]),
                                            **WF_KILL_PLAN))):
        losses, log, starts = {}, [], []
        with couler.workflow("ck") as ir:
            couler.add_job(ckpt_train(losses, log, starts), WF_RESUME_ITERS,
                           checkpoint=str(work / f"ckpt_{name}"), step_name="train",
                           retry_limit=8)
        eng = LocalEngine(cache=CacheStore(), enable_speculation=False,
                          retry_backoff_s=0.001, retry_backoff_max_s=0.01,
                          fault_plan=plan)
        try:
            run = eng.submit(ir)
        finally:
            eng.close()
        resume[name] = {"status": run.status, "attempts": run.steps["train"].attempts,
                        "iterations_run": len(log), "attempt_starts": starts,
                        "mid_step_kills": (eng.injector.stats["mid_step_kill"]
                                           if eng.injector else 0),
                        "losses": [losses.get(i) for i in range(WF_RESUME_ITERS)]}
    got, want = resume["killed"]["losses"], resume["uninterrupted"]["losses"]
    resume_ok = (all(v["status"] == "Succeeded" for v in resume.values())
                 and resume["killed"]["mid_step_kills"] == 2
                 and resume["killed"]["attempts"] == 3
                 and resume["killed"]["iterations_run"] < 3 * WF_RESUME_ITERS
                 and resume["killed"]["attempt_starts"][-1] > 0
                 and None not in got + want
                 and all(abs(a - b) <= TRAIN_TOL * (1 + abs(b)) for a, b in zip(got, want)))

    # the fence: a profiled step that queues ~50 ms of fp32 products and
    # returns at once (nothing in it allocates or waits); the full-width
    # train step cannot show it, as launching a step takes the host about
    # as long as the card takes to run it
    a = torch.randn(4096, 4096, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(5)) / 64.0
    prod = torch.empty_like(a)
    torch.mm(a, a, out=prod)
    torch.cuda.synchronize()
    marks = []

    def products():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            torch.mm(a, a, out=prod)
        end.record()
        marks.append((start, end))
        return prod

    with couler.workflow("fence") as ir:
        couler.run_step(products, step_name="products", cacheable=False)
    eng = LocalEngine(enable_speculation=False, profile_steps=True)
    try:
        run = eng.submit(ir)
    finally:
        eng.close()
    marks[0][1].synchronize()
    fence = {"execute_s": (run.steps["products"].profile or {}).get("execute_s"),
             "device_s_by_events": marks[0][0].elapsed_time(marks[0][1]) / 1e3}
    fence_ok = run.succeeded() and fence["execute_s"] >= fence["device_s_by_events"] > 0.01
    del a, prod, marks

    good = train_real_model({"learning_rate": WF_GOOD_LR, "batch_size": 16},
                            steps=WF_TUNE_STEPS, device=cuda)
    bad = train_real_model({"learning_rate": WF_BAD_LR, "batch_size": 16},
                           steps=WF_TUNE_STEPS, device=cuda)
    tune_ok = (math.isfinite(good["final_loss"])
               and good["final_loss"] < bad["final_loss"])
    emit({"phase": "workflow", "what": "reduced checks on the card", "arch": small.name,
          "dtype": "float32", "recompute": {**recompute, "ok": rec_ok},
          "resume": {**resume, "tol": TRAIN_TOL, "ok": resume_ok},
          "fence": {**fence, "ok": fence_ok},
          "train_real_model": {"good": {"learning_rate": WF_GOOD_LR,
                                        "final_loss": good["final_loss"]},
                               "bad": {"learning_rate": WF_BAD_LR,
                                       "final_loss": bad["final_loss"]},
                               "steps": WF_TUNE_STEPS, "ok": tune_ok},
          "ok": rec_ok and resume_ok and fence_ok and tune_ok,
          "seconds": time.perf_counter() - t_phase})
    if not (rec_ok and resume_ok and fence_ok and tune_ok):
        fail(f"workflow reduced checks failed: recompute {rec_ok}, resume "
             f"{resume_ok}, fence {fence_ok}, train_real_model {tune_ok}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    # the train runs' roofline counts, in workers beside the build
    pool = ProcessPoolExecutor(COUNT_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        return phases(torch, pool, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def phases(torch, pool, t_start) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import device as dev
    from repro_torch.configs import FEATURE_CUTS, get_arch, reduced
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch import bridge
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.roofline import analysis as RF
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import train as TR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = dev.card_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    counts = {aid: pool.submit(count_train_step, aid, batch_size, seq, cfg_kw, tcfg_kw)
              for aid, batch_size, seq, _, cfg_kw, tcfg_kw in TRAIN_RUNS}

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.library()
    build_s = time.perf_counter() - t0
    # the counts end here, and their workers with them: no timed phase
    # shares the host's cores with them
    counts = {aid: f.result() for aid, f in counts.items()}
    pool.shutdown(wait=True)
    emit({"phase": "build", "seconds": build_s, "nvcc_s": lib.build_s,
          "library": str(lib.path.relative_to(ROOT)),
          "ptxas": build.ptxas_summary(lib.log),
          "roofline_counts_s": {aid: c[1] for aid, c in counts.items()},
          "roofline_counts_wait_s": time.perf_counter() - t0 - build_s})

    # 3. kernels --------------------------------------------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtypes[dtype])

    results = {}

    def check_case(kernel, case, dtype, run, plain, library, fields, tol=None,
                   extra_ok=True, route=None, record=None, tols=None, judge=None,
                   library_timer=None, **info):
        """``fields``: the call's shape fields, from which
        ``roofline.kernel_work`` gives the bytes and the least time for the
        operations that ``bound_ms`` takes. ``route``: (read, expected) for a
        kernel with more than one route or path; ``record``: more fields of
        the launch; both read just after the checked run. Each output (a
        backward's gradients, a forward's o and lse) is held to atol and
        rtol ``tol``, or to the (atol, rtol) of its entry of ``tols``;
        ``judge(outs, wants)`` returns more fields and an "ok" of its own;
        ``library_timer`` times the library call (``timed_grads``)."""
        out = run()
        if route is not None:
            info["route"] = route[0]()
            extra_ok = extra_ok and info["route"] == route[1]
        if record is not None:
            info.update(record())
        want = plain()
        torch.cuda.synchronize()
        outs, wants = ((out, want) if isinstance(out, tuple) else ((out,), (want,)))
        tol = tol or TOL[dtype]
        tols = tols or [(tol, tol)] * len(outs)
        errs = [(o.float() - w.float()).abs().max().item() for o, w in zip(outs, wants)]
        err = max(errs)
        ok = extra_ok and all(
            bool(torch.allclose(o.float(), w.float(), atol=at, rtol=rt))
            for o, w, (at, rt) in zip(outs, wants, tols))
        if len(outs) > 1:
            info["max_abs_err_each"] = errs
            info["tol_each"] = tols
        if judge is not None:
            judged = judge(outs, wants)
            ok = ok and judged.pop("ok")
            info.update(judged)
        del outs, wants, out, want
        nbytes, ops_s, form = RF.kernel_work(kernel, fields)
        bound_ms, bound_by = RF.bound(nbytes, ops_s)
        if form != "products":
            info["bound_ops"] = form

        def timed(fn):
            per_call = call_ms(torch, fn)
            return device_ms(torch, fn, per_call), per_call

        kernel_ms, kernel_call_ms = timed(run)
        plain_ms, _ = timed(plain)
        if library_timer is not None:
            library_ms = library_timer()
        else:
            library_ms = None if library is None else timed(library)[0]
        rec = {"phase": "kernels", "kernel": kernel, "case": case,
               "dtype": dtype, **info, "max_abs_err": err, "tol": tol,
               "ok": ok, "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(rec)
        results[(kernel, case)] = rec
        if not ok:
            fail(f"{kernel}/{case}: max abs err {err} (tolerance {tols}), "
                 f"route {info.get('route')}, {info}")

    has_rms_norm = hasattr(F, "rms_norm")
    sdpa_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    warp, block = "warp_per_row", "block_per_row"
    for case, R, D, dtype, sdtype, path in [
            ("serve_decode", SERVE_BATCH, 2048, "bfloat16", "bfloat16", block),
            ("serve_forward", SERVE_BATCH * SERVE_PROMPT, 2048, "bfloat16", "bfloat16", warp),
            ("consistency_forward", CONSISTENCY_PROMPT, 2048, "float32", "float32", block),
            ("ragged_rows", 1000, 2048, "bfloat16", "bfloat16", warp),
            ("wide_mixed_scale", 333, 4096, "bfloat16", "float32", block),
            ("unaligned_dim", 77, 2050, "float32", "bfloat16", "scalar"),
            ("mamba2_decode", SERVE_BATCH, 1024, "bfloat16", "bfloat16", block),
            ("mamba2_forward", SERVE_BATCH * SSM_FORWARD_LEN, 1024,
             "bfloat16", "bfloat16", warp),
            ("ssm_gate_forward", SERVE_BATCH * SSM_FORWARD_LEN, 2048,
             "bfloat16", "bfloat16", warp),
            ("zamba2_shared_forward", SERVE_BATCH * SSM_FORWARD_LEN, 4096,
             "bfloat16", "bfloat16", warp),
            ("train_forward", TRAIN_BATCH * TRAIN_SEQ, 2048, "bfloat16", "bfloat16", warp),
            # the moe family: deepseek's d_model and MLA's q_norm and kv_norm
            # over the serve forward's 512 rows; olmoe's train forward
            ("deepseek_d7168", SERVE_BATCH * SERVE_PROMPT, 7168, "bfloat16", "bfloat16",
             block),
            ("mla_q_norm_1536", SERVE_BATCH * SERVE_PROMPT, 1536, "bfloat16", "bfloat16",
             warp),
            ("mla_kv_norm_512", SERVE_BATCH * SERVE_PROMPT, 512, "bfloat16", "bfloat16",
             warp),
            # the registry's other dense archs over the serve forward's 512
            # rows: starcoder2's d_model 4608 and mistral-nemo's 5120 (bf16
            # rows past 8 KB) and nanogpt's 768
            ("starcoder2_d4608", SERVE_BATCH * SERVE_PROMPT, 4608, "bfloat16", "bfloat16",
             block),
            ("mistral_nemo_d5120", SERVE_BATCH * SERVE_PROMPT, 5120, "bfloat16", "bfloat16",
             block),
            ("nanogpt_d768", SERVE_BATCH * SERVE_PROMPT, 768, "bfloat16", "bfloat16", warp)]:
        x = randn(R, D, dtype=dtype)
        s = 1.0 + 0.1 * randn(D, dtype=sdtype)
        s_lib = s.to(x.dtype)
        lib_fn = ((lambda x=x, s=s_lib: F.rms_norm(x, (x.shape[1],), s, 1e-5))
                  if has_rms_norm else None)
        check_case("rmsnorm", case, dtype,
                   lambda x=x, s=s: ops.rmsnorm(x, s),
                   lambda x=x, s=s: ref.reference_rmsnorm(x, s),
                   lib_fn,
                   dict(R=R, D=D, dtype=dtype, scale_dtype=sdtype),
                   route=(lambda: rn.PLAN.path, path),
                   record=lambda: {"plan": {"grid": rn.PLAN.grid,
                                            "threads": rn.PLAN.threads,
                                            "vectors": rn.PLAN.vectors}},
                   shape=[R, D])

    def attn_case(case, B, H, KH, Sq, Sk, D, Dv, dtype, causal, model_layout,
                  lse=False, prefix=0, v_offset=0):
        """``lse``: the train path's forward, which also writes the rows'
        logsumexp; o and lse are each held to the plain version's.
        ``prefix``: the prefix-LM mask's prefix_len (under ``causal``).
        ``v_offset``: v is the last Dv of each head's v_offset + Dv values,
        a strided view, as MLA hands it over (k_nope beside v)."""
        if model_layout:   # (B,S,heads,hd) transposed, as the model hands it over
            q = randn(B, Sq, H, D, dtype=dtype).transpose(1, 2)
            k = randn(B, Sk, KH, D, dtype=dtype).transpose(1, 2)
            v = randn(B, Sk, KH, v_offset + Dv,
                      dtype=dtype)[..., v_offset:].transpose(1, 2)
        else:
            q = randn(B, H, Sq, D, dtype=dtype)
            k = randn(B, KH, Sk, D, dtype=dtype)
            v = randn(B, KH, Sk, Dv, dtype=dtype)
        pairs = RF.valid_pairs(Sq, Sk, causal, prefix)
        lib_kw = sdpa_mask(torch, Sq, Sk, causal, prefix, cuda)
        if KH != H:
            lib_kw["enable_gqa"] = True
        library = (None if KH != H and not sdpa_gqa else
                   lambda: F.scaled_dot_product_attention(q, k, v, **lib_kw))
        if lse:
            run = lambda: fa.flash_attention_cuda(q, k, v, causal, return_lse=True,
                                                  prefix_len=prefix)
            tols = [(TOL[dtype], TOL[dtype]), LSE_TOL]
        else:
            run = lambda: ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
            tols = None
        check_case(
            "flash_attention", case, dtype, run,
            lambda: ops.flash_attention_plain(q, k, v, causal=causal, return_lse=lse,
                                              prefix_len=prefix),
            library, dict(B=B, H=H, KH=KH, Sq=Sq, Sk=Sk, D=D, Dv=Dv, dtype=dtype,
                          causal=causal, prefix_len=prefix, lse=lse),
            route=(lambda: fa.ROUTE, fa.ROUTES[dtypes[dtype]]), tols=tols,
            valid_pairs=pairs,
            shape={"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk, "D": D,
                   "Dv": Dv}, causal=causal, prefix_len=prefix, v_stride=list(v.stride()))

    P = SERVE_PROMPT
    attn_case("serve_forward", SERVE_BATCH, 32, 32, P, P, 64, 64, "bfloat16", True, True)
    attn_case("consistency_forward", 1, 32, 32, CONSISTENCY_PROMPT,
              CONSISTENCY_PROMPT, 64, 64, "float32", True, True)
    attn_case("s1024", 4, 32, 32, 1024, 1024, 64, 64, "bfloat16", True, False)
    attn_case("s1024_fp32", 1, 32, 32, 1024, 1024, 64, 64, "float32", True, False)
    attn_case("ragged_s1000", 4, 32, 32, 1000, 1000, 64, 64, "bfloat16", True, True)
    attn_case("gqa_32q_8kv_hd128", 2, 32, 8, 512, 512, 128, 128, "bfloat16", True, True)
    attn_case("dv_ne_d", 2, 16, 16, 256, 256, 192, 128, "bfloat16", True, False)
    attn_case("non_causal", 2, 32, 32, 512, 512, 64, 64, "bfloat16", False, False)
    attn_case("zamba2_forward", SERVE_BATCH, 32, 32, SSM_FORWARD_LEN, SSM_FORWARD_LEN,
              128, 128, "bfloat16", True, True)
    attn_case("hd256", 2, 16, 16, 1024, 1024, 256, 256, "bfloat16", True, True)
    # a decoder's cross-attention over a longer encoder output
    attn_case("sq_ne_sk_cross", SERVE_BATCH, 32, 32, SERVE_PROMPT, SSM_FORWARD_LEN,
              64, 64, "bfloat16", False, True)
    attn_case("train_forward", TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64, 64,
              "bfloat16", True, True, lse=True)
    # the vlm and encdec paths: the prefix-LM mask and the non-causal mode
    attn_case("paligemma_serve_forward", SERVE_BATCH, 8, 1, 256 + SERVE_PROMPT,
              256 + SERVE_PROMPT, 256, 256, "bfloat16", True, True, prefix=256)
    attn_case("vit_train_forward", VIT_BATCH, 12, 12, 196 + VIT_TOKENS, 196 + VIT_TOKENS,
              64, 64, "bfloat16", True, True, lse=True, prefix=196)
    attn_case("whisper_encoder_forward", TRAIN_BATCH, 20, 20, 1500, 1500, 64, 64,
              "bfloat16", False, True, lse=True)
    attn_case("whisper_cross_forward", TRAIN_BATCH, 20, 20, TRAIN_SEQ, 1500, 64, 64,
              "bfloat16", False, True, lse=True)
    attn_case("ragged_prefix_small", 1, 4, 2, 100, 100, 48, 48, "float32", True, True,
              lse=True, prefix=37)
    # the moe family: MLA's serve forward (128 heads, qk 192 = nope 128 + rope
    # 64, v 128 beside k_nope), olmoe's train forward (16 heads of 128)
    attn_case("mla_serve_forward", SERVE_BATCH, 128, 128, P, P, 192, 128, "bfloat16",
              True, True, v_offset=128)
    attn_case("olmoe_train_forward", TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, 128,
              "bfloat16", True, True, lse=True)
    # the registry's other dense archs: starcoder2's train forward (36 heads
    # on 4, the GQA group of 9), mistral-nemo's serve forward (32 on 8)
    attn_case("starcoder2_train_forward", TRAIN_BATCH, 36, 4, TRAIN_SEQ, TRAIN_SEQ, 128, 128,
              "bfloat16", True, True, lse=True)
    attn_case("mistral_nemo_serve_forward", SERVE_BATCH, 32, 8, P, P, 128, 128, "bfloat16",
              True, True)

    # the Pallas kernel's own contract: (BH, S, D)
    q3, k3, v3 = (randn(8, 256, 64, dtype="float32") for _ in range(3))
    o3 = ops.flash_attention(q3, k3, v3)
    err3 = (o3 - ref.reference_attention(q3, k3, v3)).abs().max().item()
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "bh_s_d_contract",
          "max_abs_err": err3, "tol": TOL["float32"]})
    if not err3 <= TOL["float32"]:
        fail(f"flash_attention (BH,S,D): max abs err {err3}")

    def ssd_case(case, B, S, H, G, Pd, N, chunk, x_dtype, bc_dtype, decay=1.0,
                 pallas=False):
        """x dt-scaled, dA = -decay * softplus(.) in fp32, B and C each a
        contiguous (B,S,G*N) projection viewed as (B,S,G,N), as
        ``ssm.apply_ssm_full`` hands them over. ``pallas``: the (BH,S,P)
        contract, H = G = 1 squeezed out. Held to 10x TOL, as
        tests/test_kernels.py:70-73 holds the Pallas kernel, on y and on the
        final state."""
        x = randn(B, S, H, Pd, dtype=x_dtype)
        dA = -decay * F.softplus(randn(B, S, H, dtype="float32"))
        Bm, Cm = (0.5 * randn(B, S, G * N, dtype=bc_dtype).reshape(B, S, G, N)
                  for _ in range(2))
        args = (x[:, :, 0], dA[:, :, 0], Bm[:, :, 0], Cm[:, :, 0]) if pallas else (x, dA, Bm, Cm)
        Q = min(chunk, S)

        def plain():
            y, st = ops.ssd_scan_plain(x, dA, Bm, Cm, chunk=Q)
            return (y[:, :, 0], st[:, 0]) if pallas else (y, st)

        _, state = ops.ssd_scan(*args, chunk=chunk, return_state=True)
        want_state = plain()[1]
        tol = 10 * TOL[x_dtype]
        state_err = (state - want_state).abs().max().item()
        state_ok = bool(torch.allclose(state, want_state, atol=tol, rtol=tol))
        check_case("ssd_scan", case, x_dtype,
                   lambda: ops.ssd_scan(*args, chunk=chunk), lambda: plain()[0], None,
                   dict(B=B, S=S, H=H, G=G, P=Pd, N=N, chunk=Q, bc_dtype=bc_dtype,
                        x_bytes=x.element_size()),
                   tol=tol, extra_ok=state_ok, cuda_launches_per_call=ssd.CUDA_LAUNCHES,
                   shape={"B": B, "S": S, "H": H, "G": G, "P": Pd, "N": N,
                          "chunk": chunk}, bc_dtype=bc_dtype, decay=decay,
                   state_max_abs_err=state_err)

    # (the model hands over x dt-scaled in fp32 and B/C in the compute type)
    ssd_case("mamba2_forward", SERVE_BATCH, SSM_FORWARD_LEN, 32, 1, 64, 128, 256,
             "float32", "bfloat16")
    ssd_case("zamba2_forward", SERVE_BATCH, SSM_FORWARD_LEN, 64, 1, 64, 64, 256,
             "float32", "bfloat16")
    ssd_case("consistency", 1, SSM_CONSISTENCY_PROMPT, 32, 1, 64, 128, 256,
             "float32", "float32")
    ssd_case("slow_decay", 2, SSM_FORWARD_LEN, 32, 1, 64, 128, 256,
             "float32", "bfloat16", decay=0.01)
    ssd_case("grouped", 2, 512, 8, 2, 64, 64, 256, "float32", "bfloat16")
    ssd_case("short", SERVE_BATCH, 128, 32, 1, 64, 128, 256, "float32", "bfloat16")
    ssd_case("pallas_contract", 8, 512, 1, 1, 64, 128, 64, "bfloat16", "bfloat16",
             pallas=True)

    # once against the sequential recurrence itself: y and the final state
    x, dA, Bm, Cm = (randn(4, 256, 64, dtype="float32"),
                     -0.1 * F.softplus(randn(4, 256, dtype="float32")),
                     0.5 * randn(4, 256, 128, dtype="float32"),
                     0.5 * randn(4, 256, 128, dtype="float32"))
    y, state = ops.ssd_scan(x, dA, Bm, Cm, chunk=64, return_state=True)
    y_ref, state_ref = ref.reference_ssd(x, dA, Bm, Cm)
    tol = 10 * TOL["float32"]
    rec = {"phase": "kernels", "kernel": "ssd_scan", "case": "reference_ssd",
           "shape": {"BH": 4, "S": 256, "P": 64, "N": 128, "chunk": 64},
           "max_abs_err": (y - y_ref).abs().max().item(),
           "state_max_abs_err": (state - state_ref).abs().max().item(), "tol": tol,
           "ok": bool(torch.allclose(y, y_ref, atol=tol, rtol=tol)
                      and torch.allclose(state, state_ref, atol=tol, rtol=tol))}
    emit(rec)
    if not rec["ok"]:
        fail("ssd_scan against reference_ssd failed")

    # the backward kernels, against the plain backward versions
    for case, R, D, dtype, sdtype, path in [
            ("train_bwd", TRAIN_BATCH * TRAIN_SEQ, 2048, "bfloat16", "bfloat16", warp),
            ("train_bwd_fp32", TRAIN_BATCH * TRAIN_SEQ, 2048, "float32", "float32", block),
            ("unaligned_dim_bwd", 77, 2050, "float32", "bfloat16", "scalar"),
            # starcoder2's and mistral-nemo's train rows (bf16 rows past
            # 8 KB), nanogpt's
            ("starcoder2_train_bwd", TRAIN_BATCH * TRAIN_SEQ, 4608, "bfloat16", "bfloat16",
             block),
            ("mistral_nemo_train_bwd", TRAIN_BATCH * TRAIN_SEQ, 5120, "bfloat16", "bfloat16",
             block),
            ("nanogpt_train_bwd", TRAIN_BATCH * TRAIN_SEQ, 768, "bfloat16", "bfloat16", warp)]:
        x = randn(R, D, dtype=dtype)
        s = 1.0 + 0.1 * randn(D, dtype=sdtype)
        dy = randn(R, D, dtype=dtype)
        s_lib = s.to(x.dtype)
        library_timer = ((lambda x=x, s=s_lib, dy=dy: timed_grads(
            torch, lambda a, b: F.rms_norm(a, (a.shape[1],), b, 1e-5), (x, s), dy))
            if has_rms_norm else None)
        check_case("rmsnorm_bwd", case, dtype,
                   lambda x=x, s=s, dy=dy: rn.rmsnorm_bwd_cuda(x, s, dy),
                   lambda x=x, s=s, dy=dy: ref.reference_rmsnorm_bwd(x, s, dy),
                   None, dict(R=R, D=D, dtype=dtype, scale_dtype=sdtype),
                   library_timer=library_timer,
                   # dscale sums R rows: its atol scales with sqrt(R); it
                   # comes back in the scale's dtype, so a bf16 dscale is
                   # held to bf16's tolerance, as tests/test_torch_cuda.py
                   # holds it (one rounding of a sum over rows whose fp32
                   # order differs is a bf16 ulp: 0.0078 at |dscale| in [1, 2))
                   tols=[(TOL[dtype], TOL[dtype]),
                         (max(TOL[dtype], TOL[sdtype]) * R ** 0.5,
                          max(TOL[dtype], TOL[sdtype]))],
                   shape=[R, D],
                   scale_dtype=sdtype, route=(lambda: rn.PLAN_BWD.path, path),
                   record=lambda: {"plan": {"grid": rn.PLAN_BWD.grid,
                                            "threads": rn.PLAN_BWD.threads,
                                            "vectors": rn.PLAN_BWD.vectors}})

    def attn_bwd_case(case, B, H, KH, Sq, Sk, D, dtype, causal, route, prefix=0, Dv=None):
        """The model's layout: q, k, v transposed views of (B,S,heads,hd), do
        a transposed view of the (B,S,H*Dv) gradient (``Dv`` D unless
        given). The kernel takes o and
        lse from the kernel's forward, as in training; the plain backward
        takes the plain forward's, so a wrong o or lse shows. Each gradient
        is also held to ``GRAD_NORM_TOL`` by norm, against a control: the
        plain gradients from q, k, v, do rounded to fp8. Bound: the five
        products (2 Sq Sk D each, over the causal pairs) at the peak rate of
        the inputs' type, or the bytes of q, k, v, o, do, lse read and dq,
        dk, dv written. ``route``: the (route, tile) that must run.
        ``prefix``: the prefix-LM mask's prefix_len (under ``causal``)."""
        Dv = Dv or D
        q = randn(B, Sq, H, D, dtype=dtype).transpose(1, 2)
        k = randn(B, Sk, KH, D, dtype=dtype).transpose(1, 2)
        v = randn(B, Sk, KH, Dv, dtype=dtype).transpose(1, 2)
        do = randn(B, Sq, H * Dv, dtype=dtype).view(B, Sq, H, Dv).transpose(1, 2)
        o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True, prefix_len=prefix)

        def plain_grads(q, k, v, do):
            o_p, lse_p = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                                   prefix_len=prefix)
            return ref.reference_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal,
                                               prefix_len=prefix)

        def rel(got, want):
            return ((got.float() - want.float()).norm() / want.float().norm()).item()

        def judge(outs, wants):
            fp8 = [t.to(torch.float8_e4m3fn).to(t.dtype) for t in (q, k, v, do)]
            control = [rel(c, w) for c, w in zip(plain_grads(*fp8), wants)]
            kernel = [rel(g, w) for g, w in zip(outs, wants)]
            return {"want_median_abs": [w.float().abs().median().item() for w in wants],
                    "rel_norm_err": kernel, "fp8_control_rel_norm_err": control,
                    "rel_norm_tol": GRAD_NORM_TOL,
                    "ok": (max(kernel) <= GRAD_NORM_TOL < min(control))}

        o_p, lse_p = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True,
                                               prefix_len=prefix)
        pairs = RF.valid_pairs(Sq, Sk, causal, prefix)
        lib_kw = sdpa_mask(torch, Sq, Sk, causal, prefix, cuda)
        if KH != H:
            lib_kw["enable_gqa"] = True
        library_timer = (None if KH != H and not sdpa_gqa else lambda: timed_grads(
            torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, **lib_kw),
            (q, k, v), do))
        check_case(
            "flash_attention_bwd", case, dtype,
            lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, prefix),
            lambda: ref.reference_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal,
                                                prefix_len=prefix),
            None, dict(B=B, H=H, KH=KH, Sq=Sq, Sk=Sk, D=D, Dv=Dv, dtype=dtype,
                       causal=causal, prefix_len=prefix),
            library_timer=library_timer, judge=judge,
            route=(lambda: json.loads(json.dumps(fa.BWD_ROUTE)), route),   # tuples as lists
            valid_pairs=pairs,
            shape={"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk, "D": D, "Dv": Dv},
            causal=causal, prefix_len=prefix)

    # route: tensor cores (wgmma) with the (width, q step) tile, or CUDA cores
    wg64, cores = ["tensor_cores", [64, 64]], ["cuda_cores", None]
    attn_bwd_case("train_bwd", TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16",
                  True, wg64)
    attn_bwd_case("gqa_32q_8kv_hd128_bwd", 2, 32, 8, 1024, 1024, 128, "bfloat16", True,
                  ["tensor_cores", [128, 32]])
    attn_bwd_case("fp32_bwd", 1, 32, 32, 1024, 1024, 64, "float32", True, cores)
    attn_bwd_case("non_causal_ragged_bwd", 2, 8, 8, 1000, 1000, 64, "bfloat16", False, wg64)
    # the vlm and encdec train paths: paligemma's MQA at head dim 256 after
    # its 256 patches (the width-256 tile), and an fp32 case at a small size
    wide = ["tensor_cores", [256, 32]]
    attn_bwd_case("paligemma_train_bwd", TRAIN_BATCH, 8, 1, 256 + TRAIN_SEQ, 256 + TRAIN_SEQ,
                  256, "bfloat16", True, wide, prefix=256)
    attn_bwd_case("paligemma_bwd_fp32_small", 1, 8, 1, 300, 300, 256, "float32", True,
                  cores, prefix=40)
    attn_bwd_case("vit_train_bwd", VIT_BATCH, 12, 12, 196 + VIT_TOKENS, 196 + VIT_TOKENS,
                  64, "bfloat16", True, wg64, prefix=196)
    attn_bwd_case("whisper_encoder_bwd", TRAIN_BATCH, 20, 20, 1500, 1500, 64, "bfloat16",
                  False, wg64)
    attn_bwd_case("whisper_cross_bwd", TRAIN_BATCH, 20, 20, TRAIN_SEQ, 1500, 64, "bfloat16",
                  False, wg64)
    attn_bwd_case("ragged_prefix_small_bwd", 1, 4, 2, 100, 100, 48, "float32", True, cores,
                  prefix=37)
    attn_bwd_case("olmoe_train_bwd", TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128,
                  "bfloat16", True, ["tensor_cores", [128, 32]])
    # deepseek's MLA train path: D 192 (nope 128 + rope 64), Dv 128 on the
    # width-256 tile (Q/K and V/dO zero-padded), and an fp32 case small
    attn_bwd_case("mla_train_bwd", TRAIN_BATCH, 128, 128, TRAIN_SEQ, TRAIN_SEQ, 192,
                  "bfloat16", True, wide, Dv=128)
    attn_bwd_case("mla_bwd_fp32_small", 1, 8, 8, 300, 300, 192, "float32", True, cores,
                  prefix=40, Dv=128)
    # starcoder2's train shape: 36 heads on 4, each dK/dV block over the
    # group's 9 query heads
    attn_bwd_case("starcoder2_train_bwd", TRAIN_BATCH, 36, 4, TRAIN_SEQ, TRAIN_SEQ, 128,
                  "bfloat16", True, ["tensor_cores", [128, 32]])

    # prefix 0 and a prefix past Sk: the causal and non-causal launches' bits
    def same_bits(case, B, H, KH, S, D, dtype):
        q = randn(B, S, H, D, dtype=dtype).transpose(1, 2)
        k, v = (randn(B, S, KH, D, dtype=dtype).transpose(1, 2) for _ in range(2))
        do = randn(B, H, S, D, dtype=dtype)
        equal = {}
        for prefix, causal in ((0, True), (S, False), (S + 1000, False)):
            o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True, prefix_len=prefix)
            o2, lse2 = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
            g = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, prefix)
            g2 = fa.flash_attention_bwd_cuda(q, k, v, o2, lse2, do, causal)
            equal[f"prefix_{prefix}_vs_{'causal' if causal else 'non_causal'}"] = (
                bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2))
                and all(bool(torch.equal(a, b)) for a, b in zip(g, g2)))
        rec = {"phase": "kernels", "kernel": "flash_attention", "case": case,
               "shape": {"B": B, "H": H, "KH": KH, "S": S, "D": D}, "dtype": dtype,
               "equal_bits_fwd_lse_bwd": equal, "ok": all(equal.values())}
        emit(rec)
        if not rec["ok"]:
            fail(f"flash_attention/{case}: a prefix launch differs from the plain mask's")

    same_bits("prefix_bits_vit", 8, 12, 12, 196 + VIT_TOKENS, 64, "bfloat16")
    same_bits("prefix_bits_ragged_small", 1, 4, 2, 100, 48, "float32")

    def ssd_bwd_case(case, B, S, H, G, Pd, N, chunk, bc_dtype, decay=1.0,
                     dstate=False, control=False, instance=None):
        """Inputs as ``ssd_case`` gives them; cum, the chunk states and the
        final state from the kernel's forward, as in training; dy (and, with
        ``dstate``, the final state's gradient) random. Each gradient held
        elementwise at 10x TOL of its dtype (dB and dC come back in B/C's),
        and by norm at its ``SSD_GRAD_NORM_TOL``; d dA sums up to ``chunk``
        rows of d cum in the chunk, so its atol scales with sqrt(chunk), as
        dscale's with sqrt(rows); two runs must give equal bits. With bf16
        B/C, the plain backward from x and dy rounded to bf16 (products of
        bf16 operands) must read above every gradient's limit, which shows
        that the check sees a kernel that computes in bf16. ``control``: the
        plain backward with the carried state gradient set to zero must read
        above the limit on dx, which shows that the check sees the
        cross-chunk path. Bound: ``ssd_bwd_ops_s``, or the bytes of x, B, C,
        cum, states, dy (dstate, state) read and dx, d dA, dB, dC written.
        The chunk_grads that ran (``torch.profiler``'s kernel name) must be
        ``instance``, which names the route by B/C's type and the blocking
        that ``ssd_scan.plan_bwd`` should pick; the record names the plan,
        each of the five launches' device time and the share of its
        elementwise tolerance each gradient uses at most."""
        x = randn(B, S, H, Pd, dtype="float32")
        dA = -decay * F.softplus(randn(B, S, H, dtype="float32"))
        Bm, Cm = (0.5 * randn(B, S, G * N, dtype=bc_dtype).reshape(B, S, G, N)
                  for _ in range(2))
        dy = randn(B, S, H, Pd, dtype="float32")
        ds = randn(B, H, N, Pd, dtype="float32") if dstate else None
        _, st, cum, states = ssd.ssd_scan_cuda(x, dA, Bm, Cm, chunk, True)
        limits = SSD_GRAD_NORM_TOL[bc_dtype]

        def run():
            return ssd.ssd_scan_bwd_cuda(x, dA, Bm, Cm, chunk, cum, states, st, dy, ds)

        def rel(got, want):
            return ((got.float() - want.float()).norm() / want.float().norm()).item()

        t32, tbc = 10 * TOL["float32"], 10 * TOL[bc_dtype]
        tols = [(t32, t32), (t32 * chunk ** 0.5, t32), (tbc, tbc), (tbc, tbc)]

        def judge(outs, wants):
            again = run()
            got = [rel(g, w) for g, w in zip(outs, wants)]
            rec = {"rel_norm_err": got, "rel_norm_tol": limits,
                   # the largest share of its elementwise tolerance a value uses
                   "tol_share": [((g.float() - w.float()).abs()
                                  / (at + rt * w.float().abs())).max().item()
                                 for g, w, (at, rt) in zip(outs, wants, tols)],
                   "equal_bits": all(bool(torch.equal(a, b)) for a, b in zip(outs, again))}
            ok = all(e <= lim for e, lim in zip(got, limits)) and rec["equal_bits"]
            if bc_dtype == "bfloat16":
                def r16(t):
                    return t.to(torch.bfloat16).float()
                ctl = ref.ssd_scan_bwd(r16(x), dA, Bm, Cm, r16(dy), ds, chunk=chunk)
                rec["bf16_control_rel_norm_err"] = [rel(c, w) for c, w in zip(ctl, wants)]
                ok = ok and all(e > lim for e, lim in
                                zip(rec["bf16_control_rel_norm_err"], limits))
            if control:
                ctl = ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk,
                                       carry_state_grad=False)
                rec["no_state_grad_control_rel_norm_err"] = [
                    rel(c, w) for c, w in zip(ctl, wants)]
                ok = ok and rec["no_state_grad_control_rel_norm_err"][0] > limits[0]
            return {**rec, "ok": ok}

        launched = {}

        def chunk_grads_instance():
            """The chunk_grads instance that ran, by the profiler's name."""
            launched["ms"], names, launched["profiler_tries"] = launch_ms(
                torch, run, SSD_BWD_LAUNCHES)
            return sorted({build.kernel_instance(n) for n in names["chunk_grads"]})

        def record():
            plan = ssd.BWD_PLAN
            return {"plan": {"route": plan.route, "heads_per_block": plan.heads_per_block,
                             "ring": plan.ring, "widths": list(plan.widths),
                             "smem": plan.smem, "terms": plan.terms},
                    "launch_ms": launched["ms"], "profiler_tries": launched["profiler_tries"]}

        check_case("ssd_scan_bwd", case, "float32", run,
                   lambda: ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=chunk),
                   None, dict(B=B, S=S, H=H, G=G, P=Pd, N=N, chunk=chunk,
                              bc_dtype=bc_dtype, dstate=dstate),
                   judge=judge, record=record,
                   route=(chunk_grads_instance, [instance]), tols=tols,
                   cuda_launches_per_call=ssd.CUDA_LAUNCHES_BWD,
                   shape={"B": B, "S": S, "H": H, "G": G, "P": Pd, "N": N,
                          "chunk": chunk}, bc_dtype=bc_dtype, decay=decay,
                   dstate=dstate)

    # the train path's shapes (x fp32, B/C bf16 as the model hands them over)
    # instance: the chunk_grads that must run, <B/C type, P and N padded,
    # heads a block, ring> (fewer heads where the grid is small)
    bf, f32 = "chunk_grads_kernel<bf16,", "chunk_grads_kernel<float,"
    ssd_bwd_case("mamba2_train_bwd", TRAIN_BATCH, TRAIN_SEQ, 32, 1, 64, 128, 256, "bfloat16",
                 instance=bf + "64,128,2,true>")
    ssd_bwd_case("zamba2_train_bwd", TRAIN_BATCH, TRAIN_SEQ, 64, 1, 64, 64, 256, "bfloat16",
                 instance=bf + "64,64,4,true>")
    ssd_bwd_case("slow_decay_bwd", 2, 2048, 8, 1, 64, 128, 256, "float32", decay=0.01,
                 dstate=True, control=True, instance=f32 + "64,128,1,true>")
    ssd_bwd_case("grouped_bwd", 2, 512, 8, 2, 64, 64, 256, "bfloat16", dstate=True,
                 instance=bf + "64,64,1,true>")
    ssd_bwd_case("ragged_bwd", 1, 128, 2, 1, 30, 20, 64, "float32", decay=0.1, dstate=True,
                 instance=f32 + "64,64,1,true>")
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_phase})

    # 4. consistency ----------------------------------------------------------
    router_gap = []        # per _route call of a moe path: its smallest top-k gap
    route = M._route

    def gap_route(p, cfg, x):
        """``moe._route``, also noting the smallest gap between a token's
        k-th and (k+1)-th router score: a near-tie can flip an expert
        choice between the card and the CPU."""
        logits = x.float() @ p["router"].float()
        scores = (torch.sigmoid(logits) if cfg.router_type == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        top = torch.topk(scores, cfg.experts_per_token + 1, dim=-1).values
        router_gap.append((top[..., -2] - top[..., -1]).min().item())
        return route(p, cfg, x)

    M._route = gap_route
    def reduced_card_vs_cpu(aid, S, **kw):
        small = reduced(get_arch(aid).model).replace(
            param_dtype="float32", compute_dtype="float32", **kw)
        toks = torch.randint(0, small.vocab_size, (2, S),
                             generator=torch.Generator().manual_seed(2))
        lg_cpu, _ = T.apply_lm(T.init_lm(small, 1, device="cpu"), small, toks)
        lg_gpu, _ = T.apply_lm(T.init_lm(small, 1, device="cpu").to(cuda), small,
                               toks.to(cuda))
        return (lg_gpu.cpu() - lg_cpu).abs().max().item()

    def every_kernel(counts):
        """``counts`` with every kernel of ``ops.LAUNCHES`` that it does not
        name at 0: a serving path launches no backward kernel."""
        return {**{name: 0 for name in ops.LAUNCHES}, **counts}

    def decode_vs_forward(aid, prompt, expect, **cfg_kw):
        """Full width in float32 (depth too, unless ``cfg_kw`` cuts it),
        batch 1: decode logits at every position against the forward's; the
        forward's launches must be exactly ``expect``. encdec: the forward
        over ``enc_seq`` seeded frames, the decode over cross caches filled
        from the encoder's output of the same frames. moe: the record names
        the smallest gap between a token's k-th and (k+1)-th router score."""
        t_phase = time.perf_counter()
        base = get_arch(aid).model.replace(**cfg_kw)
        cfg32 = base.replace(param_dtype="float32", compute_dtype="float32")
        router_gap.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = T.init_lm(cfg32, 0, device=cuda)
        toks = torch.randint(0, cfg32.vocab_size, (1, prompt),
                             generator=torch.Generator().manual_seed(3)).to(cuda)
        extra = {}
        if cfg32.family == "encdec":
            extra["frames"] = torch.randn((1, cfg32.enc_seq, cfg32.d_model), device=cuda,
                                          generator=torch.Generator(device=cuda).manual_seed(5))
        ops.reset_launches()
        t0 = time.perf_counter()
        full, _ = T.apply_lm(params, cfg32, toks, **extra)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_launches = dict(ops.LAUNCHES)
        caches = T.init_caches(cfg32, 1, prompt, torch.float32, device=cuda)
        if extra:
            T.fill_cross_caches(params, cfg32, caches, extra["frames"])
        outs = []
        for i in range(prompt):
            lg, caches = T.apply_lm_decode(params, cfg32, toks[:, i:i + 1], caches, i)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        torch.cuda.synchronize()
        err = (full - dec).abs().max().item()
        ok = (bool(torch.isfinite(full).all())
              and full.shape == (1, prompt, cfg32.padded_vocab)
              and bool(torch.allclose(full, dec, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)))
        rec = {"phase": "consistency", "arch": base.name, "layers": cfg32.num_layers,
               "d_model": cfg32.d_model, "dtype": "float32", "prompt": prompt,
               **({"frames": cfg32.enc_seq, "enc_layers": cfg32.num_enc_layers}
                  if extra else {}),
               "decode_vs_forward_max_abs_err": err, "tol": CONSISTENCY_TOL,
               "logits_abs_max": full.abs().max().item(), "forward_s": fwd_s,
               "forward_launches": fwd_launches, "expected_launches": expect,
               **({"changed": cfg_kw} if cfg_kw else {}),
               **({"min_router_gap": min(router_gap)} if router_gap else {}),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        del params, caches, full, dec, outs
        torch.cuda.empty_cache()
        return rec, ok and fwd_launches == every_kernel(expect), t_phase

    with torch.inference_mode():
        small_err = reduced_card_vs_cpu("stablelm-1.6b", 40, num_kv_heads=2)
        n = get_arch("stablelm-1.6b").model.num_layers
        rec, ok, t_phase = decode_vs_forward(
            "stablelm-1.6b", CONSISTENCY_PROMPT,
            {"flash_attention": n, "rmsnorm": 2 * n + 1, "ssd_scan": 0})
        ok = ok and small_err <= TOL["float32"]
        emit({**rec, "reduced_card_vs_cpu_max_abs_err": small_err, "ok": ok,
              "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("stablelm-1.6b consistency phase failed")

        small_errs = {"mamba2-370m": reduced_card_vs_cpu("mamba2-370m", 48),
                      "zamba2-1.2b": reduced_card_vs_cpu("zamba2-1.2b", 48, num_layers=5)}
        n = SSM_CONSISTENCY_CUT["mamba2-370m"]
        rec, ok, t_phase = decode_vs_forward(
            "mamba2-370m", SSM_CONSISTENCY_PROMPT,
            {"flash_attention": 0, "rmsnorm": 2 * n + 1, "ssd_scan": n}, num_layers=n)
        ok = ok and max(small_errs.values()) <= TOL["float32"]
        emit({**rec, "reduced_card_vs_cpu_max_abs_err": small_errs, "ok": ok,
              "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("mamba2-370m consistency phase failed")

        n = SSM_CONSISTENCY_CUT["zamba2-1.2b"]
        groups = T.hybrid_split(get_arch("zamba2-1.2b").model.replace(num_layers=n))[0]
        rec, ok, t_phase = decode_vs_forward(
            "zamba2-1.2b", SSM_CONSISTENCY_PROMPT,
            {"flash_attention": groups, "rmsnorm": 2 * n + 2 * groups + 1, "ssd_scan": n},
            num_layers=n)
        emit({**rec, "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("zamba2-1.2b consistency phase failed")

        wcfg = get_arch("whisper-large-v3").model
        n, ne = wcfg.num_layers, wcfg.num_enc_layers
        rec, ok, t_phase = decode_vs_forward(
            "whisper-large-v3", CONSISTENCY_PROMPT,
            {"flash_attention": ne + 2 * n, "rmsnorm": 2 * ne + 1 + 3 * n + 1})
        emit({**rec, "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("whisper-large-v3 consistency phase failed")

        # the moe family, capacity_factor E / k (the one changed field) so
        # that neither the forward nor the decode drops a token
        ocfg = get_arch("olmoe-1b-7b").model
        n = ocfg.num_layers
        rec, ok, t_phase = decode_vs_forward(
            "olmoe-1b-7b", CONSISTENCY_PROMPT, {"flash_attention": n, "rmsnorm": 2 * n + 1},
            capacity_factor=ocfg.num_experts / ocfg.experts_per_token)
        emit({**rec, "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("olmoe-1b-7b consistency phase failed")
        dcfg = get_arch("deepseek-v3-671b").model
        rec, ok, t_phase = decode_vs_forward(
            "deepseek-v3-671b", CONSISTENCY_PROMPT,
            {"flash_attention": 2, "rmsnorm": 4 * 2 + 1}, **DEEPSEEK_CUT, mtp_depth=0,
            capacity_factor=dcfg.num_experts / dcfg.experts_per_token)
        emit({**rec, "reduced": DEEPSEEK_CUT_TEXT + "; mtp_depth 0", "ok": ok,
              "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("deepseek-v3-671b consistency phase failed")

        # the registry's other dense archs and nanogpt, whole
        for aid in FEATURE_CUTS:
            n = get_arch(aid).model.num_layers
            rec, ok, t_phase = decode_vs_forward(
                aid, CONSISTENCY_PROMPT, {"flash_attention": n, "rmsnorm": 2 * n + 1})
            emit({**rec, "ok": ok, "seconds": time.perf_counter() - t_phase})
            if not ok:
                fail(f"{aid} consistency phase failed")

    def train_card_vs_cpu(aid, label, **kw):
        """A reduced model (fp32, the arch's TrainConfig) trains 3 steps on
        the card (kernels) and on the CPU (plain versions) from one init;
        loss and grad norm agree within TRAIN_TOL, launches are exact."""
        t_phase = time.perf_counter()
        spec = get_arch(aid)
        small = reduced(spec.model).replace(param_dtype="float32",
                                            compute_dtype="float32", **kw)
        cpu_state = TR.init_train_state(small, spec.train, 1, device="cpu")
        card_state = bridge.state_from_jax(
            bridge.unflatten(bridge.state_to_flat(cpu_state)), small, cuda)
        step_fn = TR.make_train_step(small, spec.train)
        expect = TR.kernel_launches_per_step(small, spec.train.remat)
        rows, ok = [], True
        router_gap.clear()
        for batch in launch_train.with_modality_inputs(
                small, synthetic_batches(2, 64, small.vocab_size, seed=1, n=3), seed=1):
            ops.reset_launches()
            card_state, m_card = step_fn(card_state, TR.to_device(batch, cuda))
            launches = dict(ops.LAUNCHES)
            cpu_state, m_cpu = step_fn(cpu_state, TR.to_device(batch, "cpu"))
            row = {k: [float(m_card[k]), float(m_cpu[k])] for k in ("loss", "grad_norm")}
            row["launches"] = launches
            ok = (ok and launches == expect
                  and all(abs(a - b) <= TRAIN_TOL * (1 + abs(b)) for a, b in
                          (row["loss"], row["grad_norm"])))
            rows.append(row)
        emit({"phase": "consistency", "arch": label, "what": "train steps, card vs cpu",
              "dtype": "float32", "remat": spec.train.remat, "steps": rows,
              "tol": TRAIN_TOL, "expected_launches": expect, "optimizer": spec.train.optimizer,
              **({"min_router_gap": min(router_gap)} if router_gap else {}),
              "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail(f"reduced {aid} train steps on the card differ from the CPU's")

    # reduced models train on the card (kernels) as on the CPU (plain)
    train_card_vs_cpu("stablelm-1.6b", "stablelm-1.6b (reduced: 3 layers, d_model 64, "
                      "4 heads on 2 KV heads)", num_layers=3, num_kv_heads=2)
    train_card_vs_cpu("mamba2-370m", "mamba2-370m (reduced: 3 layers, d_model 64, "
                      "8 SSD heads of P 16, N 16, chunk 16)", num_layers=3)
    train_card_vs_cpu("zamba2-1.2b", "zamba2-1.2b (reduced: 5 mamba2 layers, 2 shared "
                      "blocks and a leftover layer, d_model 64)", num_layers=5)
    train_card_vs_cpu("paligemma-3b", "paligemma-3b (reduced: 2 layers, d_model 64, "
                      "4 heads on 1 KV head, 8 patches as the prefix)")
    train_card_vs_cpu("whisper-large-v3", "whisper-large-v3 (reduced: 2 encoder and 2 "
                      "decoder layers, d_model 64, 16 frames)")
    train_card_vs_cpu("vit-base-16", "vit-base-16 (reduced: 2 layers, d_model 64, "
                      "8 patches as the prefix)")
    train_card_vs_cpu("olmoe-1b-7b", "olmoe-1b-7b (reduced: 2 layers, d_model 64, 8 "
                      "experts top-2, AdamW)")
    train_card_vs_cpu("deepseek-v3-671b", "deepseek-v3-671b (reduced: 1 dense and 1 moe "
                      "layer, MLA 16 + 8 / 16, 8 experts top-2 and a shared one, MTP, "
                      "Adafactor)")
    for aid, kw in FEATURE_CUTS.items():
        train_card_vs_cpu(aid, f"{aid} (reduced: 2 layers, {kw})", **kw)
    M._route = route

    # 5. serve: the main paths ------------------------------------------------
    def serve(aid, forward_len, per_pass, decode_rmsnorm=None, label=None, cut=None,
              sampled=False, **cfg_kw):
        """bf16 at full width (``cfg_kw`` may cut the depth, ``cut`` says
        how): ``generate`` then ``apply_lm`` on (batch, forward_len) tokens
        that start with the prompts (vlm: after seeded patches; encdec: over
        seeded frames; the engine, as the JAX one, decodes from the tokens
        alone; moe with the MTP head: its logits too). Launch counts are
        reset just before and read just after; they must equal ``per_pass``
        once for the forward and, for rmsnorm, ``decode_rmsnorm`` (by
        default the forward's) for every decode step. With ``sampled``, the
        batch is then generated twice more at ``SAMPLE_TEMPERATURE`` from
        ``SAMPLE_SEED``: equal tokens both times, inside the vocab, and each
        decode step the greedy run's launches."""
        t_phase = time.perf_counter()
        cfg = get_arch(aid).model.replace(**cfg_kw)   # bf16 params and compute
        params = T.init_lm(cfg, 0, device=cuda)
        n_params = sum(p.numel() for p in params.parameters())
        toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, forward_len),
                             generator=torch.Generator().manual_seed(4))
        extra = {}
        if cfg.family in TR.MODALITY_INPUT:
            n = cfg.num_patches if cfg.family == "vlm" else cfg.enc_seq
            extra[TR.MODALITY_INPUT[cfg.family]] = torch.randn(
                (SERVE_BATCH, n, cfg.d_model), device=cuda, dtype=torch.bfloat16,
                generator=torch.Generator(device=cuda).manual_seed(6))
        prefix = cfg.num_patches if cfg.family == "vlm" else 0
        prompts = toks[:, :SERVE_PROMPT]
        engine = ServingEngine(cfg, params, max_len=SERVE_PROMPT + SERVE_GEN,
                               device=cuda)
        engine.generate(prompts[:, :8], gen_len=4)          # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        ops.reset_launches()
        res = engine.generate(prompts, gen_len=SERVE_GEN)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, aux = T.apply_lm(params, cfg, toks.to(cuda), **extra)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        mtp = aux.get("mtp_logits")

        steps = SERVE_PROMPT + SERVE_GEN - 1
        decode_rms = per_pass["rmsnorm"] if decode_rmsnorm is None else decode_rmsnorm
        expect = every_kernel({**per_pass, "rmsnorm": per_pass["rmsnorm"] + steps * decode_rms})
        tokens = torch.tensor(res.tokens)
        # the same function of the same tokens only where the forward sees
        # no more than the engine
        first_match = (None if extra else (tokens[:, 0] == logits[
            :, SERVE_PROMPT - 1].argmax(-1).cpu()).float().mean().item())
        ok = (launches == expect and tokens.shape == (SERVE_BATCH, SERVE_GEN)
              and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.padded_vocab
              and bool(torch.isfinite(logits).all())
              and logits.shape == (SERVE_BATCH, prefix + forward_len, cfg.padded_vocab)
              and (mtp is not None) == bool(cfg.family == "moe" and cfg.mtp_depth)
              and (mtp is None or (mtp.shape == logits.shape
                                   and bool(torch.isfinite(mtp).all()))))
        sample = None
        if sampled:
            runs = []
            for _ in range(2):
                ops.reset_launches()
                r = engine.generate(prompts[:, :SAMPLE_PROMPT], gen_len=SAMPLE_GEN,
                                    temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)
                runs.append((torch.tensor(r.tokens), dict(ops.LAUNCHES), r.decode_s))
            sample_steps = SAMPLE_PROMPT + SAMPLE_GEN - 1
            want = every_kernel({"rmsnorm": sample_steps * decode_rms})
            (ta, la, da), (tb, lb, _) = runs
            sample = {"temperature": SAMPLE_TEMPERATURE, "seed": SAMPLE_SEED,
                      "prompt": SAMPLE_PROMPT, "gen": SAMPLE_GEN,
                      "tokens_equal": bool(torch.equal(ta, tb)),
                      "in_vocab": bool(int(ta.min()) >= 0
                                       and int(ta.max()) < cfg.padded_vocab),
                      "launches": la, "expected_launches": want,
                      "decode_step_ms": 1e3 * da / (SAMPLE_GEN - 1)}
            ok = ok and (sample["tokens_equal"] and sample["in_vocab"]
                         and la == lb == want)
        emit({"phase": "serve", "arch": label or cfg.name, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "params": n_params, "dtype": cfg.compute_dtype,
              "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
              "prefill_s": res.prefill_s, "decode_s": res.decode_s,
              "tokens_per_s": res.tokens_per_s,
              "decode_step_ms": 1e3 * res.decode_s / (SERVE_GEN - 1),
              "apply_lm_tokens": [SERVE_BATCH, forward_len], "apply_lm_s": fwd_s,
              **{f"apply_lm_{k}": list(v.shape) for k, v in extra.items()},
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "expected_launches": expect,
              "first_token_matches_forward_argmax": first_match,
              **({"reduced": cut} if cut else {}),
              **({"sampled": sample} if sample else {}),
              **({"moe_aux": float(aux["moe_aux"]), "mtp_logits": list(mtp.shape)
                  if mtp is not None else None} if cfg.family == "moe" else {}),
              "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail(f"{aid} serve phase failed: launches {launches}, expected {expect}")
        for name, n in per_pass.items():
            if n and launches[name] == 0:
                fail(f"kernel {name} was never launched on the {aid} path")
        served[label or aid] = (prompts, res.tokens)
        del engine, params, logits, extra, aux, mtp
        torch.cuda.empty_cache()
        return launches

    main_paths, served = {}, {}
    n = get_arch("stablelm-1.6b").model.num_layers
    main_paths["stablelm-1.6b"] = serve(
        "stablelm-1.6b", SERVE_PROMPT,
        {"flash_attention": n, "rmsnorm": 2 * n + 1, "ssd_scan": 0}, sampled=True)
    n = get_arch("mamba2-370m").model.num_layers
    main_paths["mamba2-370m"] = serve(
        "mamba2-370m", SSM_FORWARD_LEN,
        {"flash_attention": 0, "rmsnorm": 2 * n + 1, "ssd_scan": n})
    zcfg = get_arch("zamba2-1.2b").model
    n, groups = zcfg.num_layers, zcfg.num_layers // zcfg.shared_attn_interval
    main_paths["zamba2-1.2b"] = serve(
        "zamba2-1.2b", SSM_FORWARD_LEN,
        {"flash_attention": groups, "rmsnorm": 2 * n + 2 * groups + 1, "ssd_scan": n})
    n = get_arch("paligemma-3b").model.num_layers
    main_paths["paligemma-3b"] = serve(
        "paligemma-3b", SERVE_PROMPT, {"flash_attention": n, "rmsnorm": 2 * n + 1})
    n, ne = wcfg.num_layers, wcfg.num_enc_layers
    main_paths["whisper-large-v3"] = serve(
        "whisper-large-v3", SERVE_PROMPT,
        {"flash_attention": ne + 2 * n, "rmsnorm": 2 * ne + 1 + 3 * n + 1},
        decode_rmsnorm=3 * n + 1)
    n = get_arch("olmoe-1b-7b").model.num_layers
    main_paths["olmoe-1b-7b"] = serve(
        "olmoe-1b-7b", SERVE_PROMPT, {"flash_attention": n, "rmsnorm": 2 * n + 1})
    # deepseek's 2-layer cut with its MTP head: flash 2 + the MTP block's;
    # rmsnorm per MLA layer ln1, q_norm, kv_norm, ln2, the final norm, and
    # the MTP head's 5; a decode step runs no MTP
    main_paths["deepseek-v3-671b (2-layer cut)"] = serve(
        "deepseek-v3-671b", SERVE_PROMPT, {"flash_attention": 2 + 1, "rmsnorm": 4 * 2 + 1 + 5},
        decode_rmsnorm=4 * 2 + 1, label="deepseek-v3-671b (2-layer cut, MTP)",
        cut=DEEPSEEK_CUT_TEXT, **DEEPSEEK_CUT)
    for aid in FEATURE_CUTS:
        n = get_arch(aid).model.num_layers
        main_paths[aid] = serve(aid, SERVE_PROMPT, {"flash_attention": n, "rmsnorm": 2 * n + 1})

    # 6. train: the training paths -------------------------------------------
    def roofline_line(aid, cfg, shape, step_s, n_params):
        """The same step at world size 1 counted on fake tensors (a
        worker's ``count_train_step``, during the build), its report on the
        card's data sheet figures, and the measured median step: ``mfu``
        and ``bound_fraction``. ``mfu_basis``: the active params that the
        model flops (6 N T) count, ``ModelConfig.param_counts()``'s as in
        JAX, beside the params the state holds (``n_params``; they differ
        for the deepseek cut, whose MTP block the count takes as a moe
        layer), and the ``mfu`` at the latter."""
        terms, count_s = counts[aid]
        rep = RF.measured_report(RF.roofline_report(terms, cfg, shape, 1),
                                 sorted(step_s)[len(step_s) // 2])
        active = cfg.param_counts()["active"]
        emit({"phase": "train", "arch": cfg.name, "roofline": {
                  "model_flops": rep["model_flops_per_chip"],
                  "counted_flops": rep["hlo_flops_per_chip"],
                  "useful_flops_ratio": rep["useful_flops_ratio"],
                  "compute_s": rep["compute_s"], "memory_s": rep["memory_s"],
                  "roofline_bound_s": rep["roofline_bound_s"], "step_s": rep["measured_s"],
                  "mfu": rep["mfu"], "bound_fraction": rep["bound_fraction"],
                  "mfu_basis": {"active_params": active,
                                "counted_by": "ModelConfig.param_counts()['active']",
                                "params_in_state": n_params,
                                "mfu_at_params_in_state": rep["mfu"] * n_params / active}},
              "counted_on": "fake tensors, world size 1", "card": smi,
              "count_s": count_s})

    def train(aid, batch_size, seq, cut, cfg_kw, tcfg_kw, twice=False):
        """The arch's own config (``cfg_kw`` replaced in it) and TrainConfig
        (``tcfg_kw`` replaced) at full width through ``launch/train.py``'s
        loop, the batch with its seeded frames or patches: a warm-up step,
        then TRAIN_STEPS steps on one fixed batch, each with exactly
        ``kernel_launches_per_step``. ``twice``: the whole run again from
        the same init must give the same losses and params, bit for bit."""
        t_phase = time.perf_counter()
        cfg, tcfg = train_configs(aid, cfg_kw, tcfg_kw)
        state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
        n_params = sum(p.numel() for p in state["params"].parameters())
        batch = next(launch_train.with_modality_inputs(
            cfg, synthetic_batches(batch_size, seq, cfg.vocab_size, seed=0, n=1)))
        steps = []            # (host time after the step, its metrics, its launches)

        def on_step(step, m):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), float(m["loss"]), float(m["grad_norm"]),
                          dict(ops.LAUNCHES)))
            ops.reset_launches()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        launch_train.train_loop(state, TR.make_train_step(cfg, tcfg),
                                iter([batch] * (1 + TRAIN_STEPS)), steps=1 + TRAIN_STEPS,
                                device=cuda, log_every=0, on_step=on_step,
                                compute_dtype=cfg.compute_dtype)
        peak = torch.cuda.max_memory_allocated()
        timed_steps = steps[1:]                  # after the warm-up step
        step_s = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
        losses = [st[1] for st in timed_steps]
        gnorms = [st[2] for st in timed_steps]
        per_step = [st[3] for st in timed_steps]
        expect = TR.kernel_launches_per_step(cfg, tcfg.remat)
        train_total = {k: sum(ls[k] for ls in per_step) for k in expect}
        finite = all(map(math.isfinite, losses + gnorms + [steps[0][1], steps[0][2]]))
        ok = (finite and all(ls == expect for ls in per_step) and losses[-1] < losses[0]
              and len(timed_steps) == TRAIN_STEPS)
        again = None
        if twice:
            first = [p.detach().clone() for p in state["params"].parameters()]
            del state
            torch.cuda.empty_cache()
            state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
            seen = []
            launch_train.train_loop(
                state, TR.make_train_step(cfg, tcfg), iter([batch] * (1 + TRAIN_STEPS)),
                steps=1 + TRAIN_STEPS, device=cuda, log_every=0,
                on_step=lambda step, m: seen.append(float(m["loss"])),
                compute_dtype=cfg.compute_dtype)
            again = {"losses": seen[1:],
                     "equal_bits": bool(seen[1:] == losses and all(
                         torch.equal(a, b) for a, b in
                         zip(first, state["params"].parameters())))}
            ok = ok and again["equal_bits"]
            del first
        emit({"phase": "train", "arch": cfg.name, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "params": n_params, "dtype": cfg.compute_dtype,
              "optimizer": tcfg.optimizer, "learning_rate": tcfg.learning_rate,
              "remat": tcfg.remat, "batch": batch_size, "seq": seq,
              **{k: list(v.shape) for k, v in batch.items() if k in ("frames", "patches")},
              "reduced": cut, "warmup_step": {"loss": steps[0][1],
                                                    "grad_norm": steps[0][2],
                                                    "launches": steps[0][3]},
              # positions the model runs a step: the patches too, for vlm
              "step_s": step_s, "tokens_per_s": [
                  batch_size * (seq + (cfg.num_patches if cfg.family == "vlm" else 0)) / t
                  for t in step_s],
              "max_memory_allocated_bytes": peak, "losses": losses, "grad_norms": gnorms,
              "launches_per_step": per_step, "expected_launches_per_step": expect,
              **({"second_run": again} if again is not None else {}),
              "ok": ok, "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail(f"{aid} train phase failed: losses {losses}, launches {per_step}, "
                 f"expected {expect} per step")
        roofline_line(aid, cfg, train_shape(batch_size, seq), step_s, n_params)
        for name, n in expect.items():
            if n and train_total[name] == 0:
                fail(f"kernel {name} was never launched on the {aid} train path")
        main_paths[f"{aid}/train"] = train_total     # the first run's
        train_losses[aid] = losses
        del state
        torch.cuda.empty_cache()

    train_losses = {}
    # paligemma's step comes within 10 GB of the card's memory: segments that
    # grow in place keep it from failing on memory the runs before it left
    # cached in pieces (it did once: 56.9 GB in use, 17.9 GB free in pieces,
    # 7.9 GB asked). Only here: they slow the allocations of other phases.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    for run in TRAIN_RUNS:
        train(*run, twice=run[0] == "olmoe-1b-7b")
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")

    # 7. workflow: the paper's production loop through the port's Couler layer
    workflow_phase(torch, cuda, main_paths, every_kernel)

    # 8. distributed: the mesh loop at world size 1 ---------------------------
    distributed_phase(torch, cuda, main_paths, train_losses, served["stablelm-1.6b"])

    # summary -----------------------------------------------------------------
    main_case = {"rmsnorm": "serve_decode", "flash_attention": "serve_forward",
                 "ssd_scan": "mamba2_forward", "rmsnorm_bwd": "train_bwd",
                 "flash_attention_bwd": "train_bwd", "ssd_scan_bwd": "mamba2_train_bwd"}
    meta = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:32"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:102"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:76"),
        # no TPU kernel: the JAX package differentiates its jnp model code
        "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/models/layers.py:51 (jax.grad of apply_rmsnorm)"),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/models/attention.py:72 (jax.grad of "
                                "blockwise_attention)"),
        "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                         "src/repro/models/ssm.py:67 (jax.grad of ssd_chunked)"),
    }
    # the wider train paths' cases beside the main one
    wider = {"flash_attention": ("starcoder2_train_forward", "mistral_nemo_serve_forward"),
             "flash_attention_bwd": ("paligemma_train_bwd", "mla_train_bwd",
                                     "starcoder2_train_bwd"),
             "rmsnorm": ("starcoder2_d4608", "mistral_nemo_d5120", "nanogpt_d768"),
             "rmsnorm_bwd": ("starcoder2_train_bwd", "mistral_nemo_train_bwd",
                             "nanogpt_train_bwd")}
    summary = []
    for name, (source, replaces) in meta.items():
        rec = results[(name, main_case[name])]
        by_path = {aid: counts.get(name, 0) for aid, counts in main_paths.items()}
        # which of the kernel's routes its main-path case ran
        extra = {"kernel_route": rec["route"]} if "route" in rec else {}
        summary.append({"name": name, "route": "cuda", **extra, "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "case": main_case[name], "shape": rec["shape"],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                        "call_ms": rec["kernel_call_ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                        **({"wider_cases": {case: {k: results[(name, case)][k] for k in (
                            "shape", "kernel_ms", "plain_ms", "bound_ms", "library_ms",
                            "max_abs_err")} for case in wider[name]}} if name in wider else {})})
    emit({"phase": "end", "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
