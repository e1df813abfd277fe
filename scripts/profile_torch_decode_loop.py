#!/usr/bin/env python3
"""Where the host time of an fp32 decode loop goes: ``chip_smoke.py``'s
decode-vs-forward loop (full width, float32, batch 1, one token a step
through ``apply_lm_decode`` from position 0) under ``torch.profiler``.

    PYTHONPATH=src python scripts/profile_torch_decode_loop.py [--arch mamba2-370m] \\
        [--steps 512] [--profiled 64]

Runs ``--steps`` steps, the last ``--profiled`` of them under the profiler,
and prints one JSON object: the seconds of the whole loop and host ms per
step outside and inside the profiler, the card's busy share over the
profiled window, device time by kernel name, and the host operators with
the most self CPU time. The script reads the package beside it (``../src``),
so a copy in an unpacked earlier checkout profiles that checkout. Needs a
CUDA device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--profiled", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    cfg = get_arch(args.arch).model.replace(param_dtype="float32", compute_dtype="float32")
    params = T.init_lm(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, args.steps),
                         generator=torch.Generator().manual_seed(3)).to(cuda)
    caches = T.init_caches(cfg, 1, args.steps, torch.float32, device=cuda)
    plain = args.steps - args.profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(plain):
        _, caches = T.apply_lm_decode(params, cfg, toks[:, i:i + 1], caches, i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(plain, args.steps):
            _, caches = T.apply_lm_decode(params, cfg, toks[:, i:i + 1], caches, i)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    host = sorted(((a.key, a.self_cpu_time_total, a.count) for a in prof.key_averages()
                   if a.self_cpu_time_total > 0), key=lambda r: -r[1])[:args.top]
    window_us = 1e6 * (t2 - t1)
    out = {"arch": cfg.name, "dtype": "float32", "batch": 1, "steps": args.steps,
           "profiled_steps": args.profiled, "loop_s": t2 - t0,
           "host_ms_per_step": 1e3 * (t1 - t0) / max(plain, 1),
           "host_ms_per_step_profiled": window_us / 1e3 / args.profiled,
           "device_busy_share": busy / window_us,
           "device_ms_per_step": busy / 1e3 / args.profiled,
           "kernel_launches_per_step": len(kernels) / args.profiled,
           "device_ms_by_kernel": {k: v / 1e3 / args.profiled for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:args.top]},
           "host_self_ms_per_step_by_op": {k: [t / 1e3 / args.profiled, n // args.profiled]
                                           for k, t, n in host},
           "card": torch.cuda.get_device_name(0)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
