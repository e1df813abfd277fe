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
4. consistency  stablelm-1.6b and mamba2-370m at full width in float32:
                decode logits at every prompt position equal the full
                forward's (mamba2 over two 256-row chunks), and reduced
                stablelm, mamba2 and zamba2 models on the card equal the same
                models on the CPU;
5. serve        the main paths: stablelm-1.6b, mamba2-370m and zamba2-1.2b at
                full width in bf16 each serve a batch through
                ``ServingEngine.generate``, then ``apply_lm`` runs on the same
                model; the launch counts of each path must be exactly the
                path's, which proves that it went through its kernels.

Then a summary line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero before
the last line. Needs one CUDA device; imports nothing of JAX.
"""
import json
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
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine

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
                   **info):
        """``ops_s``: the least time for the operations; by default ``flops``
        at the peak rate of ``dtype``. ``route``: (read, expected) for a
        kernel with more than one route or path; ``record``: more fields of
        the launch; both read just after the checked run."""
        out = run()
        if route is not None:
            info["route"] = route[0]()
            extra_ok = extra_ok and info["route"] == route[1]
        if record is not None:
            info.update(record())
        want = plain()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = tol or TOL[dtype]
        ok = extra_ok and bool(torch.allclose(out.float(), want.float(),
                                              atol=tol, rtol=tol))
        bound_ms, bound_by = bound(
            nbytes, flops / PEAK_FLOPS[dtype] if ops_s is None else ops_s)

        def timed(fn):
            per_call = call_ms(torch, fn)
            return device_ms(torch, fn, per_call), per_call

        kernel_ms, kernel_call_ms = timed(run)
        plain_ms, _ = timed(plain)
        library_ms = None if library is None else timed(library)[0]
        rec = {"phase": "kernels", "kernel": kernel, "case": case,
               "dtype": dtype, **info, "max_abs_err": err, "tol": tol,
               "ok": ok, "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(rec)
        results[(kernel, case)] = rec
        if not ok:
            fail(f"{kernel}/{case}: max abs err {err} (tolerance {tol}), "
                 f"route {info.get('route')}")

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
             "bfloat16", "bfloat16", warp)]:
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

    def attn_case(case, B, H, KH, Sq, Sk, D, Dv, dtype, causal, model_layout):
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
        check_case(
            "flash_attention", case, dtype,
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: ops.flash_attention_plain(q, k, v, causal=causal),
            library, route=(lambda: fa.ROUTE, fa.ROUTES[dtypes[dtype]]),
            nbytes=(q.numel() + k.numel() + v.numel() + B * H * Sq * Dv) * q.element_size(),
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
        return rec, ok and fwd_launches == expect, t_phase

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
        expect = {k: n * (steps + 1 if k == "rmsnorm" else 1)
                  for k, n in per_pass.items()}
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

    # summary -----------------------------------------------------------------
    main_case = {"rmsnorm": "serve_decode", "flash_attention": "serve_forward",
                 "ssd_scan": "mamba2_forward"}
    meta = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:32"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:102"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:76"),
    }
    summary = []
    for name, (source, replaces) in meta.items():
        rec = results[(name, main_case[name])]
        by_path = {aid: counts[name] for aid, counts in main_paths.items()}
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
