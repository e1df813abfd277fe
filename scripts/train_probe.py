#!/usr/bin/env python3
"""Losses of a few full-width train steps on one fixed batch, at given
learning rates: how an arch's own TrainConfig behaves on the card.

    PYTHONPATH=src python scripts/train_probe.py --arch deepseek-v3-671b \\
        --set num_layers=2 --set first_k_dense=2 --lr 3e-4 1e-4 --steps 8

The arch's config (``--set FIELD=INT`` replaced in it) and TrainConfig
(``--lr`` replacing its learning rate, one run each) at (``--batch``,
``--seq``), seed 0, through ``launch/train.py``'s loop, as ``chip_smoke.py``'s
train phase runs them: a warm-up step, then ``--steps`` steps on the same
batch. Prints one JSON object a run: the losses (the warm-up step's first),
grad norms, step seconds, peak memory and the card. Needs a CUDA device.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v3-671b")
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=INT")
    ap.add_argument("--lr", type=float, nargs="+", default=[None])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch
    from repro_torch import device as dev
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.training import train as TR

    cuda = torch.device("cuda", 0)
    cfg, tcfg = launch_train.configs(args.arch, full=True)
    cfg = cfg.replace(**{k: int(v) for k, v in (s.split("=") for s in args.set)})
    for lr in args.lr:
        run_tcfg = tcfg if lr is None else dataclasses.replace(tcfg, learning_rate=lr)
        state = TR.init_train_state(cfg, run_tcfg, 0, device=cuda)
        batch = next(launch_train.with_modality_inputs(
            cfg, synthetic_batches(args.batch, args.seq, cfg.vocab_size, seed=0, n=1)))
        seen = []

        def on_step(step, m):
            torch.cuda.synchronize()
            seen.append((time.perf_counter(), float(m["loss"]), float(m["grad_norm"])))

        torch.cuda.reset_peak_memory_stats()
        launch_train.train_loop(state, TR.make_train_step(cfg, run_tcfg),
                                iter([batch] * (1 + args.steps)), steps=1 + args.steps,
                                device=cuda, log_every=0, on_step=on_step,
                                compute_dtype=cfg.compute_dtype)
        print(json.dumps({
            "arch": cfg.name, "set": args.set, "optimizer": run_tcfg.optimizer,
            "learning_rate": run_tcfg.learning_rate, "remat": run_tcfg.remat,
            "batch": args.batch, "seq": args.seq, "losses": [s[1] for s in seen],
            "grad_norms": [s[2] for s in seen],
            "step_s": [b[0] - a[0] for a, b in zip(seen, seen[1:])],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "card": dev.card_line()}), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
