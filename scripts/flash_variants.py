#!/usr/bin/env python3
"""Times variants of one of the port's CUDA kernels against each other on one card.

    PYTHONPATH=src python scripts/flash_variants.py
        [--kernel flash|rmsnorm|ssd_scan|flash_bwd|rmsnorm_bwd|ssd_scan_bwd]
        NAME=SOURCE[:FLAG,FLAG...] ... [--order NAME,NAME,...] [--legacy NAME,...]
        [--blocks-per-sm N] [--ssd-heads NAME=N,...]

Each variant is a CUDA source with the kernel's C entry points
(``flash_attention_fwd_bf16``, ``rmsnorm_fwd``, ``ssd_scan_fwd``,
``flash_attention_bwd_bf16`` and ``_f32``, ``rmsnorm_bwd`` or
``ssd_scan_bwd`` of ``src/repro_torch/csrc/``): that file, an edited or earlier copy of it, or it
with ``-D`` flags, built by nvcc with the port's flags into
``build/variants/``. ``--legacy`` names the variants whose source has the
earlier entry points: ``rmsnorm_fwd`` without the path, grid and vector
arguments, ``ssd_scan_fwd`` without the two scratch tensors,
``flash_attention_fwd_bf16`` and ``flash_attention_bwd_bf16`` / ``_f32``
without the ``prefix_len`` argument (the source at ``427853c``, and
earlier back to the forward's lse pointer), ``rmsnorm_bwd``
without the path and vector arguments (its grid then one block per SM
pair of rows, as it was), ``ssd_scan_bwd`` without the heads per block
and the ring (the fp32-FMA design's, with per-head dB and dC scratch).
An earlier source comes from git, e.g. ``git show
<rev>:src/repro_torch/csrc/ssd_scan.cu > build/old/ssd_scan.cu``, made
before the run where the card has no git.

The variants then run in ``--order`` (default: each once, then in reverse, so
that drift on the card falls on both sides) at the main-path shapes:

- flash: the stablelm serve forward (4,32,128,64), S 1024 at hd 64, the
  zamba2 shared block (4,32,1024,128), hd 256 and the stablelm train
  forward (2,32,4096,64), causal, bf16, in the model's transposed layout,
  without the lse output as serving runs them; and the train forward with
  the lse output (``train_forward_lse``);
- rmsnorm: the decode and forward rows of ``chip_smoke.py``'s bf16 cases,
  with ``F.rms_norm``'s time on the same inputs in each turn;
- ssd_scan: ``chip_smoke.py``'s cases (x fp32; B and C bf16, or fp32 for
  the consistency case);
- flash_bwd: ``chip_smoke.py``'s four backward cases (the train shape
  (2,32,4096,64) bf16 causal, GQA 32/8 at hd 128, fp32, non-causal S 1000),
  o and lse from the library's forward, with the backward through
  ``F.scaled_dot_product_attention`` timed in each turn;
- rmsnorm_bwd: (8192, 2048) in bf16 and in fp32, with ``F.rms_norm``'s
  backward timed in each turn;
- ssd_scan_bwd: ``chip_smoke.py``'s backward cases (the mamba2 and zamba2
  train shapes (2, 4096) with bf16 B/C, slow decay in fp32, grouped,
  ragged), cum and the chunk states from the port's forward; heads a block
  and the ring from ``ssd_scan.plan_bwd`` for the card, or with
  ``--ssd-heads N`` at most N heads a block for every case (one: C B^T per
  head), so that ``new=SRC cap1=SRC --ssd-heads cap1=1`` times both in
  turns. A variant of the kernel's code is an edited copy of the source
  (under ``build/``), timed against the source as another NAME=SOURCE.

Prints one JSON line per turn with each shape's device time (CUDA-graph
replay, as ``chip_smoke.py``) and max abs error against the plain version,
or why a launch was refused. Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
KERNELS = ("flash", "rmsnorm", "ssd_scan", "flash_bwd", "rmsnorm_bwd", "ssd_scan_bwd")
# (B, H, S, hd, lse written)
FLASH_SHAPES = {"serve_forward": (4, 32, 128, 64, False), "s1024": (4, 32, 1024, 64, False),
                "zamba2_forward": (4, 32, 1024, 128, False),
                "hd256": (2, 16, 1024, 256, False),
                "train_forward": (2, 32, 4096, 64, False),
                "train_forward_lse": (2, 32, 4096, 64, True)}
RMSNORM_SHAPES = {"serve_decode": (4, 2048), "serve_forward": (512, 2048),
                  "ragged_rows": (1000, 2048), "mamba2_decode": (4, 1024),
                  "mamba2_forward": (4096, 1024), "ssm_gate_forward": (4096, 2048),
                  "zamba2_shared_forward": (4096, 4096)}
# (B, S, H, G, P, N, chunk, B/C dtype, decay)
SSD_SHAPES = {"mamba2_forward": (4, 1024, 32, 1, 64, 128, 256, "bfloat16", 1.0),
              "zamba2_forward": (4, 1024, 64, 1, 64, 64, 256, "bfloat16", 1.0),
              "consistency": (1, 512, 32, 1, 64, 128, 256, "float32", 1.0),
              "slow_decay": (2, 1024, 32, 1, 64, 128, 256, "bfloat16", 0.01),
              "grouped": (2, 512, 8, 2, 64, 64, 256, "bfloat16", 1.0),
              "short": (4, 128, 32, 1, 64, 128, 256, "bfloat16", 1.0),
              "pallas_contract": (8, 512, 1, 1, 64, 128, 64, "bfloat16", 1.0)}
# (B, H, KH, S, hd, dtype, causal): chip_smoke.py's backward cases
FLASH_BWD_SHAPES = {"train_bwd": (2, 32, 32, 4096, 64, "bfloat16", True),
                    "gqa_32q_8kv_hd128_bwd": (2, 32, 8, 1024, 128, "bfloat16", True),
                    "fp32_bwd": (1, 32, 32, 1024, 64, "float32", True),
                    "non_causal_ragged_bwd": (2, 8, 8, 1000, 64, "bfloat16", False)}
RMSNORM_BWD_SHAPES = {"train_bwd": (8192, 2048, "bfloat16"),
                      "train_bwd_fp32": (8192, 2048, "float32")}
# (B, S, H, G, P, N, chunk, B/C dtype, decay, final-state gradient)
SSD_BWD_SHAPES = {
    "mamba2_train_bwd": (2, 4096, 32, 1, 64, 128, 256, "bfloat16", 1.0, False),
    "zamba2_train_bwd": (2, 4096, 64, 1, 64, 64, 256, "bfloat16", 1.0, False),
    "slow_decay_bwd": (2, 2048, 8, 1, 64, 128, 256, "float32", 0.01, True),
    "grouped_bwd": (2, 512, 8, 2, 64, 64, 256, "bfloat16", 1.0, True),
    "ragged_bwd": (1, 128, 2, 1, 30, 20, 64, "float32", 0.1, True)}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
LEGACY_SIGNATURES = {"rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
                     "ssd_scan_fwd": [_P] * 6 + [_I] * 7 + [_L] * 12 + [_I, _P],
                     "flash_attention_fwd_bf16": [_P] * 5 + [_I] * 7 + [_L] * 9
                     + [_F, _I, _I, _I, _P],
                     "flash_attention_bwd_f32": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _P],
                     "flash_attention_bwd_bf16": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _P],
                     "rmsnorm_bwd": [_P] * 6 + [_I, _I, _F, _I, _I, _I, _P],
                     "ssd_scan_bwd": [_P] * 16 + [_I] * 7 + [_L] * 9 + [_I, _P]}


def _timer(torch, cs, fn):
    """The device time of one PyTorch library call, or None without one."""
    return None if fn is None else (lambda: cs.device_ms(torch, fn, cs.call_ms(torch, fn)))


def flash_cases(torch, gen, cuda, cs):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cases = {}
    for case, (B, H, S, D, with_lse) in FLASH_SHAPES.items():
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=cuda).bfloat16()
                   .transpose(1, 2) for _ in range(3))
        o = torch.empty((B, H, S, D), dtype=q.dtype, device=cuda)
        lse = torch.empty((B, H, S), device=cuda) if with_lse else None

        def make(bind, legacy, q=q, k=k, v=v, o=o, lse=lse, B=B, H=H, S=S, D=D):
            fn = bind("flash_attention_fwd_bf16")
            prefix = () if legacy else (0,)
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              None if lse is None else lse.data_ptr(), B, H, H, S, S, D, D,
                              *fa._strides(q), *fa._strides(k), *fa._strides(v), D ** -0.5,
                              1, *prefix, *fa.bf16_tile(D, D),
                              torch.cuda.current_stream().cuda_stream)

        cases[case] = (make, lambda o=o: o,
                       lambda q=q, k=k, v=v: ops.flash_attention_plain(q, k, v), None)
    return cases


def rmsnorm_cases(torch, gen, cuda, cs, blocks_per_sm=None):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = {}
    for case, (R, D) in RMSNORM_SHAPES.items():
        x = torch.randn((R, D), generator=gen, device=cuda).bfloat16()
        s = (1.0 + 0.1 * torch.randn((D,), generator=gen, device=cuda)).bfloat16()
        o = torch.empty_like(x)
        p = rn.plan(R, D, x.dtype, s.dtype, sms=sms)
        if blocks_per_sm and p.path == "warp_per_row":
            p = rn.Plan(p.path, min(-(-R // 4), sms * blocks_per_sm), p.threads, p.vectors)

        def make(bind, legacy, x=x, s=s, o=o, R=R, D=D, p=p):
            fn = bind("rmsnorm_fwd")
            shape = () if legacy else (rn.PATH_CODE[p.path], p.grid, p.vectors)
            return lambda: fn(x.data_ptr(), s.data_ptr(), o.data_ptr(), R, D, 1e-5,
                              1, 1, *shape, torch.cuda.current_stream().cuda_stream)

        library = ((lambda x=x, s=s: F.rms_norm(x, (x.shape[1],), s, 1e-5))
                   if hasattr(F, "rms_norm") else None)
        cases[case] = (make, lambda o=o: o,
                       lambda x=x, s=s: ref.reference_rmsnorm(x, s), _timer(torch, cs, library))
    return cases


def flash_bwd_cases(torch, gen, cuda, cs):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    cases = {}
    for case, (B, H, KH, S, D, dt, causal) in FLASH_BWD_SHAPES.items():
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device=cuda).to(dtypes[dt])
                   .transpose(1, 2) for n in (H, KH, KH))
        do = (torch.randn((B, S, H * D), generator=gen, device=cuda).to(dtypes[dt])
              .view(B, S, H, D).transpose(1, 2))
        o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((2, B, H, S), device=cuda)

        def make(bind, legacy, q=q, k=k, v=v, o=o, lse=lse, do=do, grads=grads,
                 delta=delta, dims=(B, H, KH, S, S, D, D), causal=causal, dt=dt):
            fn = bind("flash_attention_bwd_bf16" if dt == "bfloat16"
                      else "flash_attention_bwd_f32")
            ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, *grads)]
            strides = [st for t in (q, k, v, o, do, *grads) for st in fa._strides(t)]
            prefix = () if legacy else (0,)
            return lambda: fn(*ptrs, *dims, *strides, dims[-1] ** -0.5, int(causal), *prefix,
                              torch.cuda.current_stream().cuda_stream)

        kw = {"is_causal": causal, **({"enable_gqa": True} if KH != H else {})}
        library = (None if KH != H and not gqa else lambda q=q, k=k, v=v, do=do, kw=kw:
                   cs.timed_grads(torch, lambda a, b, c: F.scaled_dot_product_attention(
                       a, b, c, **kw), (q, k, v), do))
        cases[case] = (make, lambda grads=grads: grads,
                       lambda q=q, k=k, v=v, o=o, lse=lse, do=do, causal=causal:
                       ref.reference_attention_bwd(q, k, v, o, lse, do, causal=causal),
                       library)
    return cases


def rmsnorm_bwd_cases(torch, gen, cuda, cs):
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rmsnorm as rn
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = {}
    for case, (R, D, dt) in RMSNORM_BWD_SHAPES.items():
        x, dy = (torch.randn((R, D), generator=gen, device=cuda).to(dtypes[dt])
                 for _ in range(2))
        s = (1.0 + 0.1 * torch.randn((D,), generator=gen, device=cuda)).to(dtypes[dt])
        dx, ds = torch.empty_like(x), torch.empty_like(s)
        p = rn.plan_bwd(R, D, x.dtype, s.dtype, sms=sms)
        legacy_grid = rn.bwd_grid(R, sms)         # the earlier source's: a row a block
        partials = torch.empty((max(p.grid, legacy_grid), D), device=cuda)

        def make(bind, legacy, x=x, s=s, dy=dy, dx=dx, ds=ds, partials=partials, R=R, D=D,
                 p=p, legacy_grid=legacy_grid):
            fn = bind("rmsnorm_bwd")
            shape = ((legacy_grid,) if legacy
                     else (p.grid, rn.PATH_CODE[p.path], p.vectors))
            code = build.DTYPE_CODE[x.dtype]
            return lambda: fn(x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                              partials.data_ptr(), ds.data_ptr(), R, D, 1e-5, code, code,
                              *shape, torch.cuda.current_stream().cuda_stream)

        library = (None if not hasattr(F, "rms_norm") else lambda x=x, s=s, dy=dy:
                   cs.timed_grads(torch, lambda a, b: F.rms_norm(a, (a.shape[1],), b, 1e-5),
                                  (x, s), dy))
        cases[case] = (make, lambda dx=dx, ds=ds: (dx, ds),
                       lambda x=x, s=s, dy=dy: ref.reference_rmsnorm_bwd(x, s, dy), library)
    return cases


def ssd_cases(torch, gen, cuda, cs):
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops
    cases = {}
    for case, (B, S, H, G, P, N, chunk, bc, decay) in SSD_SHAPES.items():
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[bc]
        x = torch.randn((B, S, H, P), generator=gen, device=cuda)
        dA = -decay * F.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
        Bm, Cm = ((0.5 * torch.randn((B, S, G * N), generator=gen, device=cuda))
                  .to(dt).reshape(B, S, G, N) for _ in range(2))
        Q = min(chunk, S)
        y = torch.empty((B, S, H, P), device=cuda)
        cum = torch.empty((B, H, S), dtype=torch.float64, device=cuda)
        states = torch.empty((B, H, S // Q, N, P), device=cuda)

        def make(bind, legacy, x=x, dA=dA, Bm=Bm, Cm=Cm, y=y, cum=cum, states=states,
                 dims=(B, S, H, G, P, N, Q), code=build.DTYPE_CODE[dt]):
            fn = bind("ssd_scan_fwd")
            scratch = () if legacy else (cum.data_ptr(), states.data_ptr())
            strides = [st for t in (x, dA, Bm, Cm) for st in t.stride()[:3]]
            return lambda: fn(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                              y.data_ptr(), None, *scratch, *dims, *strides, code,
                              torch.cuda.current_stream().cuda_stream)

        cases[case] = (make, lambda y=y: y,
                       lambda x=x, dA=dA, Bm=Bm, Cm=Cm, Q=Q:
                       ops.ssd_scan_plain(x, dA, Bm, Cm, chunk=Q)[0], None)
    return cases


def ssd_bwd_cases(torch, gen, cuda, cs):
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as ssd
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = {}
    for case, (B, S, H, G, P, N, Q, bc, decay, with_ds) in SSD_BWD_SHAPES.items():
        x = torch.randn((B, S, H, P), generator=gen, device=cuda)
        dA = -decay * F.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
        Bm, Cm = ((0.5 * torch.randn((B, S, G * N), generator=gen, device=cuda))
                  .to(dtypes[bc]).reshape(B, S, G, N) for _ in range(2))
        dy = torch.randn((B, S, H, P), generator=gen, device=cuda)
        ds = torch.randn((B, H, N, P), generator=gen, device=cuda) if with_ds else None
        _, st, cum, states = ssd.ssd_scan_cuda(x, dA, Bm, Cm, Q, True)
        f32 = dict(dtype=torch.float32, device=cuda)
        outs = (torch.empty_like(x), torch.empty((B, S, H), **f32),
                torch.empty_like(Bm), torch.empty_like(Cm))
        # scratch as large as the per-head layout, which holds every variant's
        scratch = (torch.empty((B, H, S // Q, N, P), **f32), torch.empty((B, S, H, N), **f32),
                   torch.empty((B, S, H, N), **f32), torch.empty((B, H, S), **f32))

        def make(bind, legacy, most_heads=None, x=x, Bm=Bm, Cm=Cm, cum=cum, states=states,
                 st=st, dy=dy, ds=ds, outs=outs, scratch=scratch, dims=(B, S, H, G, P, N, Q),
                 code=build.DTYPE_CODE[dtypes[bc]], bc_dtype=dtypes[bc]):
            fn = bind("ssd_scan_bwd")
            heads = ()
            if not legacy:
                b_, s_, h_, g_, p_, n_, q_ = dims
                plan = ssd.plan_bwd(n_, p_, q_, h_ // g_, bc_dtype,
                                    tiles=b_ * g_ * (s_ // q_) * -(-q_ // ssd.TILE), sms=sms)
                hb, ring = plan.heads_per_block, plan.ring
                if most_heads is not None and hb > most_heads:
                    hb = max(k for k in (1, 2, 4) if k <= most_heads)
                    ring = ssd.grad_smem(plan.route == "bf16_bc", *plan.widths, hb,
                                         True) <= ssd.MAX_BLOCK_SMEM
                heads = (hb, int(ring))
            ptrs = [t.data_ptr() for t in (x, Bm, Cm, cum, states)] + [
                None if ds is None else st.data_ptr(), dy.data_ptr(),
                None if ds is None else ds.data_ptr()] + [
                t.data_ptr() for t in outs + scratch]
            strides = [v for t in (x, Bm, Cm) for v in t.stride()[:3]]
            return lambda: fn(*ptrs, *dims, *strides, *heads, code,
                              torch.cuda.current_stream().cuda_stream)

        cases[case] = (make, lambda outs=outs: outs,
                       lambda x=x, dA=dA, Bm=Bm, Cm=Cm, dy=dy, ds=ds, Q=Q:
                       ref.ssd_scan_bwd(x, dA, Bm, Cm, dy, ds, chunk=Q), None)
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE[:FLAG,FLAG...]")
    ap.add_argument("--kernel", choices=KERNELS, default="flash")
    ap.add_argument("--order", default=None)
    ap.add_argument("--legacy", default="",
                    help="variants whose source has the earlier C entry point")
    ap.add_argument("--blocks-per-sm", type=int, default=None,
                    help="rmsnorm: size the warp path's grid to this many "
                         "blocks per SM in place of the plan's")
    ap.add_argument("--ssd-heads", default="",
                    help="ssd_scan_bwd: NAME=N,... at most N heads a chunk_grads "
                         "block for that variant")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    from repro_torch import device as dev
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("flash_variants.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        src, _, flags = rest.partition(":")
        libs[name] = out_dir / f"{args.kernel}-{name}.so"
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                     *[f for f in flags.split(",") if f], src, "-o", str(libs[name])])
    logs = dict(zip(libs, build._run_each(cmds)))
    names = list(libs)
    order = args.order.split(",") if args.order else names + names[::-1]
    legacy = set(filter(None, args.legacy.split(",")))
    heads_cap = {k: int(v) for k, _, v in
                 (item.partition("=") for item in filter(None, args.ssd_heads.split(",")))}

    cuda = torch.device("cuda", 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    make_cases = {"flash": flash_cases, "rmsnorm": rmsnorm_cases, "ssd_scan": ssd_cases,
                  "flash_bwd": flash_bwd_cases, "rmsnorm_bwd": rmsnorm_bwd_cases,
                  "ssd_scan_bwd": ssd_bwd_cases}
    cases = (rmsnorm_cases(torch, gen, cuda, cs, args.blocks_per_sm)
             if args.kernel == "rmsnorm" else make_cases[args.kernel](torch, gen, cuda, cs))
    print(json.dumps({"card": dev.card_line(), "kernel": args.kernel}), flush=True)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": build.ptxas_summary(log)}), flush=True)
    wants = {}                                   # each case's plain result, made once
    for turn, name in enumerate(order):
        lib = ctypes.CDLL(str(libs[name]))

        def bind(entry, lib=lib, old=name in legacy):
            fn = getattr(lib, entry)
            fn.argtypes = LEGACY_SIGNATURES.get(entry, build.SIGNATURES[entry]) if old \
                else build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            return fn

        row = {"turn": turn, "variant": name}
        extra = {}
        if args.kernel == "ssd_scan_bwd":
            extra["most_heads"] = row["most_heads"] = heads_cap.get(name)
        for case, (make, result, plain, library) in cases.items():
            run = make(bind, name in legacy, **extra)
            code = run()
            torch.cuda.synchronize()
            if code:
                row[case] = f"refused: CUDA error {code}"
                continue
            if case not in wants:
                wants[case] = plain()
            got, want = result(), wants[case]
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
            row[case] = {"ms": cs.device_ms(torch, run, cs.call_ms(torch, run)),
                         "max_abs_err": err}
            if library is not None:
                row[case]["library_ms"] = library()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
