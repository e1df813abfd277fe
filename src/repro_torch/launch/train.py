"""Training entry point: the port's train step on synthetic data, with
periodic asynchronous checkpoints and restart from the latest, on one card
or SPMD over a device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --full --batch 2 --seq 4096 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 --mesh 2x2 --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 --strategy dp_zero1

Port of ``repro/launch/train.py``. ``--mesh DxM`` (data x model) trains
under a ``DeviceMesh`` with the ``--strategy`` rules (baseline, dp_zero1,
pure_fsdp, moe_a2a, moe_rs): the state placed by ``param_specs`` /
``opt_state_specs``, each batch by ``batch_specs``. ``--nproc N`` (JAX's
``--fake-devices N``) starts the N ranks itself, one process each; under
``torchrun`` the rank comes from the environment. The ranks rendezvous
through a file; NCCL on the card, gloo with ``--device cpu``. A checkpoint
is gathered whole and written by rank 0, so it restores onto any mesh.
Without ``--mesh`` and ``--nproc`` it trains on one device, as before.
``--reduced`` (the default) trains
the reduced config in float32 with lr 1e-3 and no remat, as the JAX
launcher does, with the arch's optimizer (deepseek-v3-671b: Adafactor);
``--full`` the arch's own config and ``TrainConfig``. Runs on
the card unless ``--device cpu`` is given.

For the vlm and encdec families each batch also carries seeded standard
normal ``patches`` (B, num_patches, d_model) or ``frames`` (B, enc_seq,
d_model), the shapes of ``repro/launch/specs.py:26-29``, as the JAX dry run
feeds them (``repro/launch/dryrun.py:92-95``): the modality frontends are
stubs. This is the port's one departure from the JAX launcher, which feeds
tokens only (``repro/launch/train.py:91``) and so cannot train these
families.
"""
import argparse
import os
from typing import Any, Callable, Dict, Iterable, Iterator, Optional


def configs(arch: str, *, full: bool):
    """(model config, TrainConfig) of ``arch``, full or reduced."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    spec = get_arch(arch)
    if full:
        return spec.model, spec.train
    cfg = reduced(spec.model).replace(param_dtype="float32", compute_dtype="float32")
    return cfg, TrainConfig(optimizer=spec.train.optimizer, learning_rate=1e-3,
                            remat="none")


def with_modality_inputs(cfg, batches: Iterable, seed: int = 0) -> Iterator:
    """``batches`` with seeded ``patches`` (vlm) or ``frames`` (encdec) added
    to each, float32 (B, n, d_model); other families' batches pass as they
    are."""
    import numpy as np
    from repro_torch.training.train import MODALITY_INPUT
    name = MODALITY_INPUT.get(cfg.family)
    n = cfg.num_patches if cfg.family == "vlm" else cfg.enc_seq
    rng = np.random.default_rng(seed)
    for batch in batches:
        if name is not None:
            B = batch["tokens"].shape[0]
            batch = {**batch, name: rng.standard_normal((B, n, cfg.d_model), np.float32)}
        yield batch


def train_loop(state: Dict[str, Any], step_fn, batches: Iterable, *, steps: int,
               device, mgr=None, ckpt_every: int = 0, log_every: int = 10,
               on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
               compute_dtype: str = "float32") -> Dict[str, Any]:
    """Runs ``step_fn`` on ``batches`` (numpy dicts) until the state's step
    reaches ``steps``; ``on_step(step, metrics)`` after each step. Float
    entries of a batch go to the device in ``compute_dtype``."""
    import torch
    from repro_torch.training import train as TR
    dtype = getattr(torch, compute_dtype)
    for batch in batches:
        if int(state["step"]) >= steps:
            break
        state, m = step_fn(state, TR.to_device(batch, device, dtype))
        s = int(state["step"])
        if on_step is not None:
            on_step(s, m)
        if log_every and s % log_every == 0:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if mgr is not None and ckpt_every and s % ckpt_every == 0:
            mgr.async_save(s, state)
    return state


def mesh_state(cfg, tcfg, mesh, rules, strategy: str, device, seed: int = 0):
    """A fresh train state placed on ``mesh`` by the strategy's specs."""
    from repro_torch.training import train as TR
    state = TR.init_train_state(cfg, tcfg, seed, device=device)
    return TR.place_train_state(state, cfg, tcfg, mesh, rules, strategy)


def mesh_step(cfg, tcfg, mesh, rules):
    """The train step with each batch placed by ``batch_specs`` first; run it
    under ``use_mesh(mesh, rules, strategy)``."""
    from repro_torch.training import train as TR
    step = TR.make_train_step(cfg, tcfg)
    return lambda state, batch: step(state, TR.place_batch(batch, mesh, rules))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="full", action="store_false",
                      help="the reduced config in float32, CPU-sized (default)")
    size.add_argument("--full", dest="full", action="store_true",
                      help="the arch's own config and TrainConfig")
    # the group's first action would make its own default (True) the dest's
    ap.set_defaults(full=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="out/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--strategy", default="baseline",
                    choices=["baseline", "dp_zero1", "pure_fsdp", "moe_a2a", "moe_rs"])
    ap.add_argument("--mesh", default=None,
                    help="data x model (e.g. 2x2); the product is the number of ranks")
    ap.add_argument("--nproc", type=int, default=0,
                    help="start this many ranks (JAX's --fake-devices)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.nproc or args.mesh or "RANK" in os.environ:
        return _distributed(args)

    from repro_torch import device as dev
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.training import train as TR
    from repro_torch.training.checkpoint import CheckpointManager

    device = dev.resolve(args.device)
    cfg, tcfg = configs(args.arch, full=args.full)
    mgr = CheckpointManager(args.ckpt_dir)
    state = TR.init_train_state(cfg, tcfg, 0, device=device)
    start = mgr.latest_step()
    if start is not None:
        print(f"resuming from checkpoint step {start}")
        state = mgr.restore(like=state)
    batches = with_modality_inputs(
        cfg, synthetic_batches(args.batch, args.seq, cfg.vocab_size, n=args.steps + 1))
    state = train_loop(state, TR.make_train_step(cfg, tcfg), batches,
                       steps=args.steps, device=device, mgr=mgr,
                       ckpt_every=args.ckpt_every, log_every=args.log_every,
                       compute_dtype=cfg.compute_dtype)
    mgr.wait()
    mgr.save(int(state["step"]), state)
    print(f"done at step {int(state['step'])}; checkpoints in {args.ckpt_dir}")


def _distributed(args) -> None:
    dims = tuple(int(x) for x in (args.mesh or f"{args.nproc}x1").split("x"))
    n = 1
    for d in dims:
        n *= d
    if "RANK" in os.environ:                     # torchrun
        _rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                   args, dims)
        return
    if args.nproc != n:
        raise SystemExit(f"--mesh {args.mesh} needs --nproc {n}")
    import tempfile
    import torch.multiprocessing as mp
    rdzv = os.path.join(tempfile.mkdtemp(prefix="rdzv_"), "store")
    mp.start_processes(_rank_main, args=(n, f"file://{rdzv}", args, dims), nprocs=n,
                       join=True, start_method="spawn")


def _rank_main(rank: int, world: int, init_method: str, args, dims) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch import device as dev
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training.checkpoint import CheckpointManager

    device = dev.resolve(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) %
                              torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world)
    try:
        mesh = make_mesh(dims, ("data", "model")[: len(dims)], device_type=device.type)
        rules = rules_for(args.arch, args.strategy)
        cfg, tcfg = configs(args.arch, full=args.full)
        mgr = CheckpointManager(args.ckpt_dir)
        with use_mesh(mesh, rules, args.strategy):
            state = mesh_state(cfg, tcfg, mesh, rules, args.strategy, device)
            start = mgr.latest_step()
            if start is not None:
                if rank == 0:
                    print(f"resuming from checkpoint step {start}")
                state = mgr.restore(like=state)
            batches = with_modality_inputs(cfg, synthetic_batches(
                args.batch, args.seq, cfg.vocab_size, n=args.steps + 1))
            state = train_loop(state, mesh_step(cfg, tcfg, mesh, rules), batches, steps=args.steps, device=device,
                               mgr=_RankZeroCheckpoints(mgr, rank),
                               ckpt_every=args.ckpt_every,
                               log_every=args.log_every if rank == 0 else 0,
                               compute_dtype=cfg.compute_dtype)
            final = bridge.state_to_flat(state)
        if rank == 0:
            mgr.wait()
            mgr.save(int(state["step"]), final)
            print(f"done at step {int(state['step'])} on mesh {dims} "
                  f"({args.strategy}); checkpoints in {args.ckpt_dir}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


class _RankZeroCheckpoints:
    """``async_save`` of a placed state: every rank gathers it (a
    collective), rank 0 writes it."""

    def __init__(self, mgr, rank: int):
        self.mgr, self.rank = mgr, rank

    def async_save(self, step: int, state) -> None:
        from repro_torch import bridge
        flat = bridge.state_to_flat(state)
        if self.rank == 0:
            self.mgr.async_save(step, flat)


if __name__ == "__main__":
    main()
