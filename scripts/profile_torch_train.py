#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on the card.

    PYTHONPATH=src python scripts/profile_torch_train.py
        [--arch stablelm-1.6b|mamba2-370m|zamba2-1.2b|whisper-large-v3|...]
        [--batch 2] [--seq 4096] [--steps 1] [--timed 0] [--layers N]

The arch's own config and TrainConfig (bf16, its optimizer and remat) at
full width, its depth cut to ``--layers`` where given, on seeded random weights and one fixed
batch of ``synthetic_batches`` (with seeded frames or patches for the
encdec and vlm families, as ``launch/train.py`` feeds them); the
default shape is train_4k's sequence with its global batch of 256 cut to 2,
what one card holds. One warm-up step, then ``--steps`` steps under
``torch.profiler``, then ``--timed`` steps without it, each ended by
``torch.cuda.synchronize()`` and timed on the host's clock (what a step
takes when nothing traces it; the port's package is the one beside the
script, so a copy of the script in another checkout times that checkout).
Prints one JSON object: host wall time per step, those unprofiled steps, the
card's busy share over that window (union of kernel intervals over wall
time), device time per step by kernel name, and the same summed into groups
(the port's kernels by name; library matrix products; the rest). Needs a
CUDA device.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

# The port's kernels (csrc/*.cu) by the names of their __global__ functions;
# a name takes the group of the first mark it holds ("dstate_pass" before
# "state_pass", which it contains).
PORT_KERNELS = {"flash_bwd_dkdv_wgmma": "flash_attention_bwd (dK/dV)",
                "flash_bwd_dq_wgmma": "flash_attention_bwd (dQ)",
                "flash_bwd_delta": "flash_attention_bwd (delta)",
                "flash_bwd_": "flash_attention_bwd (fp32, CUDA cores)",
                "flash_fwd": "flash_attention (forward)",
                "rmsnorm_bwd_vec": "rmsnorm_bwd (rows)",
                "rmsnorm_bwd_rows": "rmsnorm_bwd (rows, scalar path)",
                "rmsnorm_bwd_scale": "rmsnorm_bwd (dscale)",
                "rmsnorm_": "rmsnorm (forward)",
                "chunk_dstate": "ssd_scan_bwd (chunk_dstate)",
                "dstate_pass": "ssd_scan_bwd (dstate_pass)",
                "chunk_grads": "ssd_scan_bwd (chunk_grads)",
                "reduce_rows": "ssd_scan_bwd (reduce_rows)",
                "dA_scan": "ssd_scan_bwd (dA_scan)",
                "chunk_state": "ssd_scan (chunk_state)",
                "state_pass": "ssd_scan (state_pass)",
                "chunk_out": "ssd_scan (chunk_out)"}
GEMM_MARKS = ("gemm", "xmma", "cutlass", "sm90_", "nvjet")


def _group(name: str) -> str:
    for mark, group in PORT_KERNELS.items():
        if mark in name:
            return group
    if any(m in name.lower() for m in GEMM_MARKS):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, copies, optimizer)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--timed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (olmoe-1b-7b trains as 4)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from profile_torch_serve import _busy_us
    from repro_torch import device as dev
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.training import train as TR

    cuda = dev.resolve("cuda")
    cfg, tcfg = launch_train.configs(args.arch, full=True)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    state = TR.init_train_state(cfg, tcfg, 0, device=cuda)
    batch = TR.to_device(next(launch_train.with_modality_inputs(
        cfg, synthetic_batches(args.batch, args.seq, cfg.vocab_size, n=1))), cuda,
        getattr(torch, cfg.compute_dtype))
    step = TR.make_train_step(cfg, tcfg)
    state, m = step(state, batch)                  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    timed_s = []
    for _ in range(args.timed):
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        timed_s.append(time.perf_counter() - t1)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
        g = _group(e.name)
        n, t = by_group.get(g, (0, 0.0))
        by_group[g] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    per = args.steps
    print(json.dumps({
        "arch": cfg.name, "dtype": cfg.compute_dtype, "remat": tcfg.remat,
        "optimizer": tcfg.optimizer, "batch": args.batch, "seq": args.seq,
        "steps": per, "card": dev.card_line(), "loss": float(m["loss"]),
        "wall_s_per_step": wall_s / per, "unprofiled_step_s": timed_s,
        "device_busy_s_per_step": busy_us / 1e6 / per,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_step": len(kernels) / per,
        "device_ms_per_step_by_group": [
            {"group": g, "launches_per_step": n / per, "ms_per_step": t / 1e3 / per}
            for g, (n, t) in sorted(by_group.items(), key=lambda kv: -kv[1][1])],
        "device_ms_per_step_by_kernel": [
            {"name": name[:90], "launches_per_step": n / per, "ms_per_step": t / 1e3 / per}
            for name, (n, t) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
