#!/usr/bin/env python3
"""Times variants of one of the port's CUDA kernels against each other on one card.

    PYTHONPATH=src python scripts/flash_variants.py [--kernel flash|rmsnorm|ssd_scan]
        NAME=SOURCE[:FLAG,FLAG...] ... [--order NAME,NAME,...] [--legacy NAME,...]

Each variant is a CUDA source with the kernel's C entry point
(``flash_attention_fwd_bf16``, ``rmsnorm_fwd`` or ``ssd_scan_fwd`` of
``src/repro_torch/csrc/``): that file, an edited or earlier copy of it, or it
with ``-D`` flags, built by nvcc with the port's flags into
``build/variants/``. ``--legacy`` names the variants whose source has the
earlier entry points: ``rmsnorm_fwd`` without the path, grid and vector
arguments, ``ssd_scan_fwd`` without the two scratch tensors,
``flash_attention_fwd_bf16`` without the lse pointer. An earlier
source comes from git, e.g. ``git show <rev>:src/repro_torch/csrc/ssd_scan.cu
> build/old/ssd_scan.cu``, made before the run where the card has no git.

The variants then run in ``--order`` (default: each once, then in reverse, so
that drift on the card falls on both sides) at the main-path shapes:

- flash: the stablelm serve forward (4,32,128,64), S 1024 at hd 64, the
  zamba2 shared block (4,32,1024,128), hd 256 and the stablelm train
  forward (2,32,4096,64), causal, bf16, in the model's transposed layout,
  without the lse output as serving runs them; and the train forward with
  the lse output (``train_forward_lse``, not for a ``--legacy`` source);
- rmsnorm: the decode and forward rows of ``chip_smoke.py``'s bf16 cases,
  with ``F.rms_norm``'s time on the same inputs in each turn;
- ssd_scan: ``chip_smoke.py``'s cases (x fp32; B and C bf16, or fp32 for
  the consistency case).

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
ENTRY = {"flash": "flash_attention_fwd_bf16", "rmsnorm": "rmsnorm_fwd",
         "ssd_scan": "ssd_scan_fwd"}
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
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
LEGACY_SIGNATURES = {"rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
                     "ssd_scan_fwd": [_P] * 6 + [_I] * 7 + [_L] * 12 + [_I, _P],
                     "flash_attention_fwd_bf16": [_P] * 4 + [_I] * 7 + [_L] * 9
                     + [_F, _I, _I, _I, _P]}


def flash_cases(torch, gen, cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cases = {}
    for case, (B, H, S, D, with_lse) in FLASH_SHAPES.items():
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=cuda).bfloat16()
                   .transpose(1, 2) for _ in range(3))
        o = torch.empty((B, H, S, D), dtype=q.dtype, device=cuda)
        lse = torch.empty((B, H, S), device=cuda) if with_lse else None

        def make(fn, legacy, q=q, k=k, v=v, o=o, lse=lse, B=B, H=H, S=S, D=D):
            if legacy and lse is not None:
                return None                      # the earlier source writes no lse
            out = () if legacy else (None if lse is None else lse.data_ptr(),)
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              *out, B, H, H, S, S, D, D, *fa._strides(q), *fa._strides(k),
                              *fa._strides(v), D ** -0.5, 1, *fa.bf16_tile(D, D),
                              torch.cuda.current_stream().cuda_stream)

        cases[case] = (make, lambda o=o: o,
                       lambda q=q, k=k, v=v: ops.flash_attention_plain(q, k, v), None)
    return cases


def rmsnorm_cases(torch, gen, cuda, blocks_per_sm=None):
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

        def make(fn, legacy, x=x, s=s, o=o, R=R, D=D, p=p):
            shape = () if legacy else (rn.PATH_CODE[p.path], p.grid, p.vectors)
            return lambda: fn(x.data_ptr(), s.data_ptr(), o.data_ptr(), R, D, 1e-5,
                              1, 1, *shape, torch.cuda.current_stream().cuda_stream)

        library = ((lambda x=x, s=s: F.rms_norm(x, (x.shape[1],), s, 1e-5))
                   if hasattr(F, "rms_norm") else None)
        cases[case] = (make, lambda o=o: o,
                       lambda x=x, s=s: ref.reference_rmsnorm(x, s), library)
    return cases


def ssd_cases(torch, gen, cuda):
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

        def make(fn, legacy, x=x, dA=dA, Bm=Bm, Cm=Cm, y=y, cum=cum, states=states,
                 dims=(B, S, H, G, P, N, Q), code=build.DTYPE_CODE[dt]):
            scratch = () if legacy else (cum.data_ptr(), states.data_ptr())
            strides = [st for t in (x, dA, Bm, Cm) for st in t.stride()[:3]]
            return lambda: fn(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                              y.data_ptr(), None, *scratch, *dims, *strides, code,
                              torch.cuda.current_stream().cuda_stream)

        cases[case] = (make, lambda y=y: y,
                       lambda x=x, dA=dA, Bm=Bm, Cm=Cm, Q=Q:
                       ops.ssd_scan_plain(x, dA, Bm, Cm, chunk=Q)[0], None)
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE[:FLAG,FLAG...]")
    ap.add_argument("--kernel", choices=sorted(ENTRY), default="flash")
    ap.add_argument("--order", default=None)
    ap.add_argument("--legacy", default="",
                    help="variants whose source has the earlier C entry point")
    ap.add_argument("--blocks-per-sm", type=int, default=None,
                    help="rmsnorm: size the warp path's grid to this many "
                         "blocks per SM in place of the plan's")
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
    log = build._run_all(cmds)
    names = list(libs)
    order = args.order.split(",") if args.order else names + names[::-1]
    legacy = set(filter(None, args.legacy.split(",")))

    cuda = torch.device("cuda", 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    make_cases = {"flash": flash_cases, "rmsnorm": rmsnorm_cases, "ssd_scan": ssd_cases}
    cases = (rmsnorm_cases(torch, gen, cuda, args.blocks_per_sm) if args.kernel == "rmsnorm"
             else make_cases[args.kernel](torch, gen, cuda))
    print(json.dumps({"card": dev.card_line(), "kernel": args.kernel,
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)
    entry = ENTRY[args.kernel]
    for turn, name in enumerate(order):
        fn = getattr(ctypes.CDLL(str(libs[name])), entry)
        fn.argtypes = (LEGACY_SIGNATURES[entry] if name in legacy
                       else build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        row = {"turn": turn, "variant": name}
        for case, (make, result, plain, library) in cases.items():
            run = make(fn, name in legacy)
            if run is None:
                row[case] = "n/a: not in this source's entry point"
                continue
            code = run()
            torch.cuda.synchronize()
            if code:
                row[case] = f"refused: CUDA error {code}"
                continue
            err = (result().float() - plain().float()).abs().max().item()
            row[case] = {"ms": cs.device_ms(torch, run, cs.call_ms(torch, run)),
                         "max_abs_err": err}
            if library is not None:
                row[case]["library_ms"] = cs.device_ms(torch, library,
                                                       cs.call_ms(torch, library))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
