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
                ``reference_ssd``;
                The backward kernels (``rmsnorm_bwd``, ``flash_attention_bwd``)
                against the plain backward versions of ``kernels/ref.py`` on
                the same inputs, with ``library_ms`` the backward through
                ``F.rms_norm`` and ``F.scaled_dot_product_attention`` under
                autograd (forward and backward, less the forward alone);
                each names the path of ``rmsnorm.plan_bwd`` or the route and
                tile of ``flash_attention.plan_bwd`` that ran, and fails on
                another;
4. consistency  stablelm-1.6b and mamba2-370m at full width in float32:
                decode logits at every prompt position equal the full
                forward's (mamba2 over two 256-row chunks), and reduced
                stablelm, mamba2 and zamba2 models on the card equal the same
                models on the CPU; a reduced stablelm (fp32, remat full)
                trains 3 steps on the card and on the CPU from one init, with
                equal losses and grad norms;
5. serve        the serving paths: stablelm-1.6b, mamba2-370m and zamba2-1.2b
                at full width in bf16 each serve a batch through
                ``ServingEngine.generate``, then ``apply_lm`` runs on the same
                model; the launch counts of each path must be exactly the
                path's, which proves that it went through its kernels;
6. train        the training path: full-width bf16 stablelm-1.6b with its own
                TrainConfig (AdamW, remat full) at seq 4096, batch 2 (the
                train_4k global batch of 256 cut to what one card holds),
                through ``launch/train.py``'s loop: one warm-up step, then 4
                steps on one fixed batch, each with exactly its launches.

Then a summary line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero before
the last line. Needs one CUDA device; imports nothing of JAX.
"""
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # fp32 outside tensor cores
# bf16: tests/test_kernels.py's tolerance. fp32: sums run in another order
# than the plain version's, with TF32 off.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Decode logits against forward logits (tests/test_models.py:84).
CONSISTENCY_TOL = 2e-2
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 64
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
# ||got - want|| / ||want|| of each flash gradient. A sound bf16 kernel reads
# about 3e-3 (bf16 P^T, dS^T and outputs); the same gradients from inputs
# rounded to fp8 e4m3, the control, about 5e-2; the case fails unless the
# kernel is under the limit and the control over it.
GRAD_NORM_TOL = 1e-2
SSM_CONSISTENCY_PROMPT = 512        # two chunks of 256
SSM_FORWARD_LEN = 1024              # apply_lm after an ssm/hybrid serve run


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


def ssd_ops_s(BH: int, S: int, P: int, N: int, Q: int, bc_dtype: str,
              heads_per_group: int = 1):
    """Least time for the operations of one SSD scan, and the form it counts:
    the smaller of the sequential recurrence's 5*N*P fp32 flops per row and
    head (state decay and rank-1 update, then C . state) and the chunked
    form's, whose C B^T term (Q*N per row, once per group of heads) may run
    at B/C's own rate (tensor cores for bf16) and whose rest (Q*P + 4*N*P
    per row and head) is fp32."""
    rows = BH * S
    recurrence = 5 * rows * N * P / PEAK_FLOPS["float32"]
    chunked = rows * (Q * N / heads_per_group / PEAK_FLOPS[bc_dtype]
                      + (Q * P + 4 * N * P) / PEAK_FLOPS["float32"])
    return min((recurrence, "recurrence"), (chunked, "chunked"))


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


def bound(nbytes: float, ops_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, ops_s), ("bytes" if t_bytes >= ops_s else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import device as dev
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch import bridge
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
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

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_s": lib.build_s, "library": str(lib.path.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in lib.log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernels --------------------------------------------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float32).to(dtypes[dtype])

    results = {}

    def check_case(kernel, case, dtype, run, plain, library, nbytes, flops=None,
                   ops_s=None, tol=None, extra_ok=True, route=None, record=None,
                   tols=None, judge=None, library_timer=None, **info):
        """``ops_s``: the least time for the operations; by default ``flops``
        at the peak rate of ``dtype``. ``route``: (read, expected) for a
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
        bound_ms, bound_by = bound(
            nbytes, flops / PEAK_FLOPS[dtype] if ops_s is None else ops_s)

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
            ("train_forward", TRAIN_BATCH * TRAIN_SEQ, 2048, "bfloat16", "bfloat16", warp)]:
        x = randn(R, D, dtype=dtype)
        s = 1.0 + 0.1 * randn(D, dtype=sdtype)
        s_lib = s.to(x.dtype)
        lib_fn = ((lambda x=x, s=s_lib: F.rms_norm(x, (x.shape[1],), s, 1e-5))
                  if has_rms_norm else None)
        check_case("rmsnorm", case, dtype,
                   lambda x=x, s=s: ops.rmsnorm(x, s),
                   lambda x=x, s=s: ref.reference_rmsnorm(x, s),
                   lib_fn,
                   nbytes=2 * x.numel() * x.element_size() + s.numel() * s.element_size(),
                   flops=4 * R * D, route=(lambda: rn.PLAN.path, path),
                   record=lambda: {"plan": {"grid": rn.PLAN.grid,
                                            "threads": rn.PLAN.threads,
                                            "vectors": rn.PLAN.vectors}},
                   shape=[R, D])

    def attn_case(case, B, H, KH, Sq, Sk, D, Dv, dtype, causal, model_layout,
                  lse=False):
        """``lse``: the train path's forward, which also writes the rows'
        logsumexp; o and lse are each held to the plain version's."""
        if model_layout:   # (B,S,heads,hd) transposed, as the model hands it over
            q = randn(B, Sq, H, D, dtype=dtype).transpose(1, 2)
            k = randn(B, Sk, KH, D, dtype=dtype).transpose(1, 2)
            v = randn(B, Sk, KH, Dv, dtype=dtype).transpose(1, 2)
        else:
            q = randn(B, H, Sq, D, dtype=dtype)
            k = randn(B, KH, Sk, D, dtype=dtype)
            v = randn(B, KH, Sk, Dv, dtype=dtype)
        pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk)
        lib_kw = {"is_causal": causal}
        if KH != H:
            lib_kw["enable_gqa"] = True
        library = (None if KH != H and not sdpa_gqa else
                   lambda: F.scaled_dot_product_attention(q, k, v, **lib_kw))
        if lse:
            run = lambda: fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
            tols = [(TOL[dtype], TOL[dtype]), LSE_TOL]
        else:
            run, tols = lambda: ops.flash_attention(q, k, v, causal=causal), None
        check_case(
            "flash_attention", case, dtype, run,
            lambda: ops.flash_attention_plain(q, k, v, causal=causal, return_lse=lse),
            library, route=(lambda: fa.ROUTE, fa.ROUTES[dtypes[dtype]]), tols=tols,
            nbytes=((q.numel() + k.numel() + v.numel() + B * H * Sq * Dv) * q.element_size()
                    + (4 * B * H * Sq if lse else 0)),
            flops=2 * B * H * pairs * (D + Dv),
            shape={"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk, "D": D,
                   "Dv": Dv}, causal=causal)

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
        nbytes = (2 * x.numel() * x.element_size() + dA.numel() * 4
                  + 2 * Bm.numel() * Bm.element_size())
        ops_s, ops_form = ssd_ops_s(B * H, S, Pd, N, Q, bc_dtype, H // G)
        check_case("ssd_scan", case, x_dtype,
                   lambda: ops.ssd_scan(*args, chunk=chunk), lambda: plain()[0], None,
                   nbytes=nbytes, ops_s=ops_s, tol=tol, extra_ok=state_ok,
                   bound_ops=ops_form, cuda_launches_per_call=ssd.CUDA_LAUNCHES,
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
            ("unaligned_dim_bwd", 77, 2050, "float32", "bfloat16", "scalar")]:
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
                   None, library_timer=library_timer,
                   # dscale sums R rows: its atol scales with sqrt(R)
                   tols=[(TOL[dtype], TOL[dtype]), (TOL[dtype] * R ** 0.5, TOL[dtype])],
                   nbytes=3 * x.numel() * x.element_size() + 2 * s.numel() * s.element_size(),
                   ops_s=9 * R * D / PEAK_FLOPS["float32"], shape=[R, D],
                   scale_dtype=sdtype, route=(lambda: rn.PLAN_BWD.path, path),
                   record=lambda: {"plan": {"grid": rn.PLAN_BWD.grid,
                                            "threads": rn.PLAN_BWD.threads,
                                            "vectors": rn.PLAN_BWD.vectors}})

    def attn_bwd_case(case, B, H, KH, S, D, dtype, causal, route):
        """The model's layout: q, k, v transposed views of (B,S,heads,hd), do
        a transposed view of the (B,S,H*hd) gradient. The kernel takes o and
        lse from the kernel's forward, as in training; the plain backward
        takes the plain forward's, so a wrong o or lse shows. Each gradient
        is also held to ``GRAD_NORM_TOL`` by norm, against a control: the
        plain gradients from q, k, v, do rounded to fp8. Bound: the five
        products (2 Sq Sk D each, over the causal pairs) at the peak rate of
        the inputs' type, or the bytes of q, k, v, o, do, lse read and dq,
        dk, dv written. ``route``: the (route, tile) that must run."""
        q = randn(B, S, H, D, dtype=dtype).transpose(1, 2)
        k = randn(B, S, KH, D, dtype=dtype).transpose(1, 2)
        v = randn(B, S, KH, D, dtype=dtype).transpose(1, 2)
        do = randn(B, S, H * D, dtype=dtype).view(B, S, H, D).transpose(1, 2)
        o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)

        def plain_grads(q, k, v, do):
            o_p, lse_p = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
            return ref.reference_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal)

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

        o_p, lse_p = ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        pairs = (S * (S + 1) // 2) if causal else S * S
        lib_kw = {"is_causal": causal}
        if KH != H:
            lib_kw["enable_gqa"] = True
        library_timer = (None if KH != H and not sdpa_gqa else lambda: timed_grads(
            torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, **lib_kw),
            (q, k, v), do))
        check_case(
            "flash_attention_bwd", case, dtype,
            lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal),
            lambda: ref.reference_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal),
            None, library_timer=library_timer, judge=judge,
            route=(lambda: json.loads(json.dumps(fa.BWD_ROUTE)), route),   # tuples as lists
            nbytes=(2 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel()
                    + do.numel()) * q.element_size() + 4 * lse.numel(),
            flops=5 * 2 * B * H * pairs * D,
            shape={"B": B, "H": H, "KH": KH, "Sq": S, "Sk": S, "D": D, "Dv": D},
            causal=causal)

    # route: tensor cores (wgmma) with the (width, q step) tile, or CUDA cores
    attn_bwd_case("train_bwd", TRAIN_BATCH, 32, 32, TRAIN_SEQ, 64, "bfloat16", True,
                  ["tensor_cores", [64, 64]])
    attn_bwd_case("gqa_32q_8kv_hd128_bwd", 2, 32, 8, 1024, 128, "bfloat16", True,
                  ["tensor_cores", [128, 32]])
    attn_bwd_case("fp32_bwd", 1, 32, 32, 1024, 64, "float32", True, ["cuda_cores", None])
    attn_bwd_case("non_causal_ragged_bwd", 2, 8, 8, 1000, 64, "bfloat16", False,
                  ["tensor_cores", [64, 64]])
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_phase})

    # 4. consistency ----------------------------------------------------------
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

    def decode_vs_forward(aid, prompt, expect):
        """Full width and depth in float32, batch 1: decode logits at every
        position against the forward's; the forward's launches must be
        exactly ``expect``."""
        t_phase = time.perf_counter()
        base = get_arch(aid).model
        cfg32 = base.replace(param_dtype="float32", compute_dtype="float32")
        params = T.init_lm(cfg32, 0, device=cuda)
        toks = torch.randint(0, cfg32.vocab_size, (1, prompt),
                             generator=torch.Generator().manual_seed(3)).to(cuda)
        ops.reset_launches()
        t0 = time.perf_counter()
        full, _ = T.apply_lm(params, cfg32, toks)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_launches = dict(ops.LAUNCHES)
        caches = T.init_caches(cfg32, 1, prompt, torch.float32, device=cuda)
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
               "decode_vs_forward_max_abs_err": err, "tol": CONSISTENCY_TOL,
               "logits_abs_max": full.abs().max().item(), "forward_s": fwd_s,
               "forward_launches": fwd_launches, "expected_launches": expect}
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
        n = get_arch("mamba2-370m").model.num_layers
        rec, ok, t_phase = decode_vs_forward(
            "mamba2-370m", SSM_CONSISTENCY_PROMPT,
            {"flash_attention": 0, "rmsnorm": 2 * n + 1, "ssd_scan": n})
        ok = ok and max(small_errs.values()) <= TOL["float32"]
        emit({**rec, "reduced_card_vs_cpu_max_abs_err": small_errs, "ok": ok,
              "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail("mamba2-370m consistency phase failed")

    def train_launches(n_layers):
        """A train step's launches under remat "full": each layer's forward
        kernels run again in the recompute; the final norm is outside it."""
        return {"flash_attention": 2 * n_layers, "flash_attention_bwd": n_layers,
                "rmsnorm": 4 * n_layers + 1, "rmsnorm_bwd": 2 * n_layers + 1,
                "ssd_scan": 0}

    # a reduced stablelm trains on the card (kernels) as on the CPU (plain)
    t_phase = time.perf_counter()
    spec = get_arch("stablelm-1.6b")
    small = reduced(spec.model).replace(num_layers=3, num_kv_heads=2,
                                        param_dtype="float32", compute_dtype="float32")
    cpu_state = TR.init_train_state(small, spec.train, 1, device="cpu")
    card_state = bridge.state_from_jax(
        bridge.unflatten(bridge.state_to_flat(cpu_state)), small, cuda)
    step_fn = TR.make_train_step(small, spec.train)
    rows, ok = [], True
    for batch in synthetic_batches(2, 64, small.vocab_size, seed=1, n=3):
        ops.reset_launches()
        card_state, m_card = step_fn(card_state, TR.to_device(batch, cuda))
        launches = dict(ops.LAUNCHES)
        cpu_state, m_cpu = step_fn(cpu_state, TR.to_device(batch, "cpu"))
        row = {k: [float(m_card[k]), float(m_cpu[k])] for k in ("loss", "grad_norm")}
        row["launches"] = launches
        ok = (ok and launches == train_launches(small.num_layers)
              and all(abs(a - b) <= TRAIN_TOL * (1 + abs(b)) for a, b in
                      (row["loss"], row["grad_norm"])))
        rows.append(row)
    emit({"phase": "consistency", "arch": "stablelm-1.6b (reduced: 3 layers, d_model 64, "
          "4 heads on 2 KV heads)", "what": "train steps, card vs cpu", "dtype": "float32",
          "remat": spec.train.remat, "steps": rows, "tol": TRAIN_TOL,
          "expected_launches": train_launches(small.num_layers), "ok": ok,
          "seconds": time.perf_counter() - t_phase})
    if not ok:
        fail("reduced stablelm train steps on the card differ from the CPU's")
    del cpu_state, card_state

    # 5. serve: the main paths ------------------------------------------------
    def serve(aid, forward_len, per_pass):
        """bf16 at full width: ``generate`` then ``apply_lm`` on (batch,
        forward_len) tokens that start with the prompts. Launch counts are
        reset just before and read just after; they must equal ``per_pass``
        times the passes (rmsnorm: every decode step and the forward) for
        rmsnorm and once per forward for the rest."""
        t_phase = time.perf_counter()
        cfg = get_arch(aid).model   # bf16 params and compute, full width
        params = T.init_lm(cfg, 0, device=cuda)
        n_params = sum(p.numel() for p in params.parameters())
        toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, forward_len),
                             generator=torch.Generator().manual_seed(4))
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
            logits, _ = T.apply_lm(params, cfg, toks.to(cuda))
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)

        steps = SERVE_PROMPT + SERVE_GEN - 1
        expect = every_kernel({k: n * (steps + 1 if k == "rmsnorm" else 1)
                               for k, n in per_pass.items()})
        tokens = torch.tensor(res.tokens)
        first_match = (tokens[:, 0] == logits[:, SERVE_PROMPT - 1].argmax(-1).cpu()
                       ).float().mean().item()
        ok = (launches == expect and tokens.shape == (SERVE_BATCH, SERVE_GEN)
              and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.padded_vocab
              and bool(torch.isfinite(logits).all())
              and logits.shape == (SERVE_BATCH, forward_len, cfg.padded_vocab))
        emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "params": n_params, "dtype": cfg.compute_dtype,
              "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
              "prefill_s": res.prefill_s, "decode_s": res.decode_s,
              "tokens_per_s": res.tokens_per_s,
              "decode_step_ms": 1e3 * res.decode_s / (SERVE_GEN - 1),
              "apply_lm_tokens": [SERVE_BATCH, forward_len], "apply_lm_s": fwd_s,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "expected_launches": expect,
              "first_token_matches_forward_argmax": first_match, "ok": ok,
              "seconds": time.perf_counter() - t_phase})
        if not ok:
            fail(f"{aid} serve phase failed: launches {launches}, expected {expect}")
        for name, n in per_pass.items():
            if n and launches[name] == 0:
                fail(f"kernel {name} was never launched on the {aid} path")
        del engine, params, logits
        torch.cuda.empty_cache()
        return launches

    main_paths = {}
    n = get_arch("stablelm-1.6b").model.num_layers
    main_paths["stablelm-1.6b"] = serve(
        "stablelm-1.6b", SERVE_PROMPT,
        {"flash_attention": n, "rmsnorm": 2 * n + 1, "ssd_scan": 0})
    n = get_arch("mamba2-370m").model.num_layers
    main_paths["mamba2-370m"] = serve(
        "mamba2-370m", SSM_FORWARD_LEN,
        {"flash_attention": 0, "rmsnorm": 2 * n + 1, "ssd_scan": n})
    zcfg = get_arch("zamba2-1.2b").model
    n, groups = zcfg.num_layers, zcfg.num_layers // zcfg.shared_attn_interval
    main_paths["zamba2-1.2b"] = serve(
        "zamba2-1.2b", SSM_FORWARD_LEN,
        {"flash_attention": groups, "rmsnorm": 2 * n + 2 * groups + 1, "ssd_scan": n})

    # 6. train: the training path --------------------------------------------
    t_phase = time.perf_counter()
    cfg, tcfg = launch_train.configs("stablelm-1.6b", full=True)
    state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
    n_params = sum(p.numel() for p in state["params"].parameters())
    batch = next(synthetic_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed=0, n=1))
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
                            device=cuda, log_every=0, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    timed_steps = steps[1:]                  # after the warm-up step
    step_s = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    losses = [st[1] for st in timed_steps]
    gnorms = [st[2] for st in timed_steps]
    per_step = [st[3] for st in timed_steps]
    expect = train_launches(cfg.num_layers)
    train_total = {k: sum(ls[k] for ls in per_step) for k in expect}
    finite = all(map(math.isfinite, losses + gnorms + [steps[0][1], steps[0][2]]))
    ok = (finite and all(ls == expect for ls in per_step) and losses[-1] < losses[0]
          and len(timed_steps) == TRAIN_STEPS)
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": cfg.compute_dtype,
          "optimizer": tcfg.optimizer, "learning_rate": tcfg.learning_rate,
          "remat": tcfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "reduced": TRAIN_CUT, "warmup_step": {"loss": steps[0][1],
                                                "grad_norm": steps[0][2],
                                                "launches": steps[0][3]},
          "step_s": step_s, "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / t for t in step_s],
          "max_memory_allocated_bytes": peak, "losses": losses, "grad_norms": gnorms,
          "launches_per_step": per_step, "expected_launches_per_step": expect,
          "ok": ok, "seconds": time.perf_counter() - t_phase})
    if not ok:
        fail(f"stablelm-1.6b train phase failed: losses {losses}, launches {per_step}, "
             f"expected {expect} per step")
    for name, n in expect.items():
        if n and train_total[name] == 0:
            fail(f"kernel {name} was never launched on the train path")
    main_paths["stablelm-1.6b/train"] = train_total
    del state
    torch.cuda.empty_cache()

    # summary -----------------------------------------------------------------
    main_case = {"rmsnorm": "serve_decode", "flash_attention": "serve_forward",
                 "ssd_scan": "mamba2_forward", "rmsnorm_bwd": "train_bwd",
                 "flash_attention_bwd": "train_bwd"}
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
    }
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
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
