#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 13 ...
        [--control-seeds 3] [--out <file>.jsonl]

For every seed: the reference's first steps, and the program's (a sound
run: the lower readings). For the first ``--control-seeds`` seeds also the
control (the reference with fp8 products, ``Reference(quant="fp8")``) and
the faults a training cell can have, planted in the program: half of the
batch left out (the mean over the rest) and one leaf moved twice as far. A
state left unchanged reads 1 on ``grad`` and ``change`` by the measure and is
not run. Each line printed (and appended to ``--out``) is one side on one
seed, with its three numbers against the reference. Not part of a
benchmark run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import check, harness

    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        sides = [None] + (list(("half_batch", "altered", "fp8")) if i < args.control_seeds else [])
        ref = None
        for side in sides:
            t0 = time.perf_counter()
            s = harness.first_steps(cell, seed, device, None if side in (None, "fp8") else side)
            s.state = s.step = s.batches = None
            harness.free(device)
            if ref is None:
                ref = harness.reference_run(cell, s, seed, device)
            got = (harness.reference_run(cell, s, seed, device, quant="fp8")
                   if side == "fp8" else s.got)
            line = {"cell": cell.name, "seed": seed, "side": side or "program",
                    "numbers": check.numbers(got, ref), "losses": got["losses"],
                    "ref_losses": ref["losses"], "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
