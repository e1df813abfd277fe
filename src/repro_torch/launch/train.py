"""Training entry point on one card: the port's train step on synthetic data,
with periodic asynchronous checkpoints and restart from the latest.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --full --batch 2 --seq 4096 --steps 4

Port of ``repro/launch/train.py`` without its mesh and sharding strategies
(they come with the distributed queue). ``--reduced`` (the default) trains
the reduced config in float32 with lr 1e-3 and no remat, as the JAX
launcher does; ``--full`` the arch's own config and ``TrainConfig``. Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
from typing import Any, Callable, Dict, Iterable, Optional


def configs(arch: str, *, full: bool):
    """(model config, TrainConfig) of ``arch``, full or reduced."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    spec = get_arch(arch)
    if full:
        return spec.model, spec.train
    cfg = reduced(spec.model).replace(param_dtype="float32", compute_dtype="float32")
    return cfg, TrainConfig(optimizer=spec.train.optimizer, learning_rate=1e-3,
                            remat="none")


def train_loop(state: Dict[str, Any], step_fn, batches: Iterable, *, steps: int,
               device, mgr=None, ckpt_every: int = 0, log_every: int = 10,
               on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None
               ) -> Dict[str, Any]:
    """Runs ``step_fn`` on ``batches`` (numpy dicts) until the state's step
    reaches ``steps``; ``on_step(step, metrics)`` after each step."""
    from repro_torch.training import train as TR
    for batch in batches:
        if int(state["step"]) >= steps:
            break
        state, m = step_fn(state, TR.to_device(batch, device))
        s = int(state["step"])
        if on_step is not None:
            on_step(s, m)
        if log_every and s % log_every == 0:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if mgr is not None and ckpt_every and s % ckpt_every == 0:
            mgr.async_save(s, state)
    return state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="full", action="store_false",
                      help="the reduced config in float32, CPU-sized (default)")
    size.add_argument("--full", dest="full", action="store_true",
                      help="the arch's own config and TrainConfig")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="out/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

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
    batches = synthetic_batches(args.batch, args.seq, cfg.vocab_size, n=args.steps + 1)
    state = train_loop(state, TR.make_train_step(cfg, tcfg), batches,
                       steps=args.steps, device=device, mgr=mgr,
                       ckpt_every=args.ckpt_every, log_every=args.log_every)
    mgr.wait()
    mgr.save(int(state["step"]), state)
    print(f"done at step {int(state['step'])}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
