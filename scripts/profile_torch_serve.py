#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving path spends its time.

    PYTHONPATH=src python scripts/profile_torch_serve.py [--arch mamba2-370m] [--steps 16]

A ported arch (default stablelm-1.6b) at full width in bf16 on seeded random
weights, batch 4: the prompt (128 tokens) is prefilled through the decode
path as ``ServingEngine.generate`` does, then ``--steps`` decode steps run
under ``torch.profiler``. Prints one JSON object: host wall time per step,
the card's busy share over that window (union of kernel intervals over wall
time), and device time by kernel name. Needs a CUDA device.
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
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import device as dev
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cuda = dev.resolve("cuda")
    cfg = get_arch(args.arch).model
    B, P = 4, 128
    params = T.init_lm(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(4)).to(cuda)
    caches = T.init_caches(cfg, B, P + args.steps + 1, torch.float32, device=cuda)
    with torch.inference_mode():
        for i in range(P):
            logits, caches = T.apply_lm_decode(params, cfg, prompts[:, i:i + 1],
                                               caches, i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(P, P + args.steps):
                logits, caches = T.apply_lm_decode(params, cfg, tok, caches, i)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "arch": cfg.name, "dtype": cfg.compute_dtype, "batch": B, "prompt": P,
        "steps": args.steps, "card": dev.card_line(),
        "wall_ms_per_step": 1e3 * wall_s / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_ms_per_step_by_kernel": [
            {"name": name[:90], "launches_per_step": n / args.steps,
             "ms_per_step": t / 1e3 / args.steps} for name, (n, t) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
