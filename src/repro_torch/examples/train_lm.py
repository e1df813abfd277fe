"""End-to-end driver of the port: train a small LM for a few hundred steps
THROUGH the COULER workflow engine. Data prep, shard caching, training, eval
and checkpointing are workflow steps, with automatic artifact caching and
restart-from-failure: the paper's production loop on the port.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--arch stablelm-1.6b] [--device cpu]

Port of ``examples/train_lm.py`` with its flags and defaults, and
``--device`` (the card unless ``cpu`` is given). As there, a second run with
the same ``--out`` resumes from the final checkpoint, trains no step and
fails in ``train`` on its empty loss list.
"""
import argparse
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="out/train_lm")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from repro_torch import device as dev
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import couler
    from repro_torch.core.caching import CacheStore, CoulerPolicy
    from repro_torch.core.engines.local import LocalEngine
    from repro_torch.data.pipeline import CachedShardReader, ShardedCorpus
    from repro_torch.training import train as TR
    from repro_torch.training.checkpoint import CheckpointManager

    device = dev.resolve(args.device)
    spec = get_arch(args.arch)
    cfg = reduced(spec.model).replace(
        d_model=args.d_model, num_layers=4,
        param_dtype="float32", compute_dtype="float32")
    tcfg = spec.train.__class__(optimizer="adamw", learning_rate=1e-3,
                                remat="none")
    cache = CacheStore(capacity_bytes=1 << 28, policy=CoulerPolicy())
    ckpt = CheckpointManager(f"{args.out}/ckpt", cache=cache)

    # ---------------- workflow steps ----------------
    def prepare_corpus():
        corpus = ShardedCorpus(f"{args.out}/shards", n_shards=8,
                               tokens_per_shard=args.batch * (args.seq + 1) * 8,
                               vocab=cfg.vocab_size, read_delay_s=0.002)
        corpus.materialize()
        return corpus

    def train(corpus, steps):
        reader = CachedShardReader(corpus, cache=cache)
        state = TR.init_train_state(cfg, tcfg, 0, device=device)
        start = ckpt.latest_step()
        if start is not None:                         # restart-from-failure
            state = ckpt.restore(like=state)
            print(f"  resumed from checkpoint step {start}")
        step_fn = TR.make_train_step(cfg, tcfg)
        losses = []
        t0 = time.time()
        it = iter(reader.batches(args.batch, args.seq, epochs=1000))
        while int(state["step"]) < steps:
            batch = TR.to_device(next(it), device)
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            s = int(state["step"])
            if s % 50 == 0:
                ckpt.async_save(s, state)
                print(f"  step {s:4d} loss {losses[-1]:.4f} "
                      f"({s / (time.time() - t0):.1f} steps/s, "
                      f"shard-cache hit {reader.cache.hit_ratio():.0%})")
        ckpt.wait()
        ckpt.save(int(state["step"]), state)
        return {"losses": losses, "first": losses[0], "last": losses[-1]}

    def evaluate(result):
        improved = result["last"] < result["first"]
        print(f"  eval: first loss {result['first']:.4f} -> "
              f"last {result['last']:.4f} improved={improved}")
        return improved

    with couler.workflow("train-lm") as ir:
        corpus = couler.run_step(prepare_corpus, step_name="prepare-corpus",
                                 est_time_s=0.5)
        result = couler.run_step(train, corpus, args.steps,
                                 step_name="train", cacheable=False,
                                 est_time_s=60.0)
        couler.run_step(evaluate, result, step_name="evaluate")

    eng = LocalEngine(cache=cache, enable_speculation=False)
    try:
        run = eng.submit(ir)
    finally:
        eng.close()
    print("workflow:", run.status, run.counts())
    if not (run.succeeded() and run.artifacts["evaluate:out"] is True):
        raise SystemExit(f"train-lm workflow failed: {run.counts()}")
    return run


if __name__ == "__main__":
    main()
