"""Host time of a train step with and without a (1,1) mesh, and the part of
it the optimizer takes, on the CPU (one gloo rank).

    PYTHONPATH=src python scripts/mesh_host_overhead.py [--layers 8] [--seq 32]

Reduced stablelm-1.6b and mamba2-370m (fp32, AdamW, remat full) cut to
``--layers`` layers; each line gives the mean of 3 steps after a warm-up.
On the CPU every op runs on the host, so the difference between the two
modes is what DTensor's dispatch and the mesh's bookkeeping add per step;
it is no device time.
"""
import argparse
import contextlib
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import synthetic_batches
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.ctx import use_mesh
from repro_torch.sharding.rules import rules_for
from repro_torch.training import optimizer as O
from repro_torch.training import train as TR


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args()
    torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method=f"file://{tempfile.mkdtemp()}/store",
                            rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    real_update = O.adamw_update
    spent = [0.0]

    def timed_update(*a, **k):
        t = time.perf_counter()
        out = real_update(*a, **k)
        spent[0] += time.perf_counter() - t
        return out

    O.adamw_update = timed_update
    try:
        for aid in ("stablelm-1.6b", "mamba2-370m"):
            cfg, _ = LT.configs(aid, full=False)
            cfg = cfg.replace(num_layers=args.layers)
            tcfg = LT.configs(aid, full=False)[1].__class__(
                optimizer="adamw", learning_rate=1e-3, remat="full")
            batch = TR.to_device(next(synthetic_batches(2, args.seq, cfg.vocab_size, n=1)),
                                 "cpu")
            rules = rules_for(aid, "baseline")
            for mode in ("plain", "mesh"):
                on_mesh = mode == "mesh"
                with use_mesh(mesh, rules) if on_mesh else contextlib.nullcontext():
                    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
                    b = batch
                    if on_mesh:
                        state = TR.place_train_state(state, cfg, tcfg, mesh, rules)
                        b = TR.place_batch(batch, mesh, rules)
                    step = TR.make_train_step(cfg, tcfg)
                    step(state, b)
                    spent[0] = 0.0
                    t = time.perf_counter()
                    for _ in range(3):
                        step(state, b)
                    total = (time.perf_counter() - t) / 3
                n = len(list(state["params"].parameters()))
                print(f"{aid} {args.layers} layers {mode}: step {total:.3f} s host, "
                      f"optimizer {spent[0] / 3:.3f} s, {n} leaves", flush=True)
    finally:
        O.adamw_update = real_update
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
