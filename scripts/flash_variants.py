#!/usr/bin/env python3
"""Times variants of the bf16 flash-attention kernel against each other on one card.

    PYTHONPATH=src python scripts/flash_variants.py NAME=SOURCE[:FLAG,FLAG...] ...
        [--order NAME,NAME,...]

Each variant is a CUDA source with the C entry point
``flash_attention_fwd_bf16`` of ``src/repro_torch/csrc/flash_attention.cu``
(that file, an edited copy of it, or it with ``-D`` flags), built by nvcc
with the port's flags into ``build/variants/``. The variants then run in
``--order`` (default: each once, then in reverse, so that drift on the card
falls on both sides) at the main-path shapes: the stablelm serve forward
(4,32,128,64), S 1024 at hd 64, the zamba2 shared block (4,32,1024,128) and
hd 256, causal, in the model's transposed layout. Prints one JSON line per
run with each shape's device time (CUDA-graph replay, as ``chip_smoke.py``)
and max abs error against the plain version, or why a launch was refused.
Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
SHAPES = {"serve_forward": (4, 32, 128, 64), "s1024": (4, 32, 1024, 64),
          "zamba2_forward": (4, 32, 1024, 128), "hd256": (2, 16, 1024, 256)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE[:FLAG,FLAG...]")
    ap.add_argument("--order", default=None)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    from repro_torch import device as dev
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("flash_variants.py: no CUDA device", file=sys.stderr)
        return 1

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        src, _, flags = rest.partition(":")
        libs[name] = out_dir / f"{name}.so"
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                     *[f for f in flags.split(",") if f], src, "-o", str(libs[name])])
    log = build._run_all(cmds)
    names = list(libs)
    order = args.order.split(",") if args.order else names + names[::-1]

    cuda = torch.device("cuda", 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = {c: [torch.randn((B, S, H, D), generator=gen, device=cuda).bfloat16().transpose(1, 2)
                 for _ in range(3)] for c, (B, H, S, D) in SHAPES.items()}
    print(json.dumps({"card": dev.card_line(),
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)
    for turn, name in enumerate(order):
        fn = ctypes.CDLL(str(libs[name])).flash_attention_fwd_bf16
        fn.argtypes = build.SIGNATURES["flash_attention_fwd_bf16"]
        fn.restype = ctypes.c_int
        row = {"turn": turn, "variant": name}
        for case, (q, k, v) in cases.items():
            B, H, S, D = q.shape
            o = torch.empty((B, H, S, D), dtype=q.dtype, device=cuda)

            def run():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                          B, H, H, S, S, D, D, *fa._strides(q), *fa._strides(k),
                          *fa._strides(v), D ** -0.5, 1, *fa.bf16_tile(D, D),
                          torch.cuda.current_stream().cuda_stream)

            code = run()
            torch.cuda.synchronize()
            if code:
                row[case] = f"refused: CUDA error {code}"
                continue
            err = (o.float() - ops.flash_attention_plain(q, k, v).float()).abs().max().item()
            row[case] = {"ms": cs.device_ms(torch, run, cs.call_ms(torch, run)),
                         "max_abs_err": err}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
