#!/usr/bin/env python3
"""The first train steps of a full-width cut, the JAX package's against the
port's, on the CPU in fp32: losses and grad norms.

    PYTHONPATH=src python scripts/fullwidth_parity.py --arch deepseek-v3-671b

The arch's config at full width, cut as ``chip_smoke.py`` trains it
(``CUT``: ``num_layers=2``, ``first_k_dense=2``, with the MTP head), in
fp32, with the arch's own TrainConfig at each of ``LRS`` (3e-4, the
config's, then 1e-4). One batch of ``BATCH`` tokens, made from ``SEED``,
the same for each of the ``STEPS`` steps. The results go to ``OUT``.

One framework a process, one after the other, so that no process holds two
models' training state:

- the JAX process makes the train state with ``init_train_state`` at
  ``PRNGKey(SEED)``, takes a fingerprint of its params (each leaf's float64
  sum and sum of squares), then runs ``STEPS`` jitted steps (the state
  donated) at each lr, the state made afresh for each;
- the port's process makes the same state with JAX's ``init_train_state``
  from the same key (its fingerprint must equal the JAX process's), hands
  it to ``bridge.state_from_jax``, drops JAX's copy and runs the port's
  train step (``repro_torch.training.train.make_train_step``).

The parent prints one JSON object: for each lr, both frameworks' losses and
grad norms and their largest relative gap, beside each process's wall time
and peak resident memory (``ru_maxrss``). At the deepseek-v3-671b cut
(3,945,204,736 params, 15.8 GB in fp32) each process holds the params, the
gradients and the optimizer's temporaries: about 40 GB at its peak.
"""
import argparse
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "deepseek-v3-671b"
CUT = {"num_layers": 2, "first_k_dense": 2}
LRS = (3e-4, 1e-4)
STEPS = 4
BATCH = (1, 64)
SEED = 0
OUT = ROOT / "out" / "fullwidth_parity"


def _configs(lr, port=False):
    """(model config, TrainConfig) of the JAX package, or of the port."""
    import dataclasses
    mod = "repro_torch.configs" if port else "repro.configs"
    configs = __import__(mod, fromlist=["get_arch"])
    spec = configs.get_arch(ARCH)
    cfg = spec.model.replace(param_dtype="float32", compute_dtype="float32", **CUT)
    return cfg, dataclasses.replace(spec.train, learning_rate=lr)


def _batch(vocab):
    t = np.random.default_rng(SEED).integers(0, vocab, (BATCH[0], BATCH[1] + 1))
    return {"tokens": t[:, :-1].astype(np.int32), "targets": t[:, 1:].astype(np.int32)}


def _jax_state(cfg, tcfg):
    """JAX's initial train state and its params' fingerprint."""
    import jax
    from repro.training import train as JTR
    state = jax.jit(lambda k: JTR.init_train_state(cfg, tcfg, k))(
        jax.random.PRNGKey(SEED))
    leaves = jax.tree_util.tree_flatten_with_path(state["params"])[0]
    prints = {jax.tree_util.keystr(kp): [float(np.sum(np.asarray(x), dtype=np.float64)),
                                         float(np.sum(np.square(np.asarray(x),
                                                                dtype=np.float64)))]
              for kp, x in leaves}
    return state, prints


def _run_jax():
    import jax
    from repro.training import train as JTR
    out = {}
    for lr in LRS:
        cfg, tcfg = _configs(lr)
        t0 = time.perf_counter()
        state, prints = _jax_state(cfg, tcfg)
        init_s = time.perf_counter() - t0
        batch = jax.tree.map(jax.numpy.asarray, _batch(cfg.vocab_size))
        step = jax.jit(JTR.make_train_step(cfg, tcfg), donate_argnums=0)
        losses, norms, step_s = [], [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
        n = sum(x.size for x in jax.tree.leaves(state["params"]))
        del state
        out[str(lr)] = {"losses": losses, "grad_norms": norms, "params": int(n),
                        "init_s": init_s, "step_s": step_s, "fingerprint": prints}
    return out


def _run_torch():
    import jax
    import torch
    from repro_torch import bridge
    from repro_torch.training import train as TR
    out = {}
    for lr in LRS:
        jcfg, jtcfg = _configs(lr)
        cfg, tcfg = _configs(lr, port=True)
        t0 = time.perf_counter()
        jstate, prints = _jax_state(jcfg, jtcfg)
        state = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
        del jstate
        init_s = time.perf_counter() - t0
        batch = {k: torch.from_numpy(v).long()
                 for k, v in _batch(cfg.vocab_size).items()}
        step = TR.make_train_step(cfg, tcfg)
        losses, norms, step_s = [], [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
        n = sum(p.numel() for p in state["params"].parameters())
        del state
        out[str(lr)] = {"losses": losses, "grad_norms": norms, "params": int(n),
                        "init_s": init_s, "step_s": step_s, "fingerprint": prints}
    return out


def _child(side):
    t0 = time.perf_counter()
    res = _run_jax() if side == "jax" else _run_torch()
    res = {"runs": res, "wall_s": time.perf_counter() - t0,
           "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    (OUT / f"{side}.json").write_text(json.dumps(res))


def _gap(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=(ARCH,), default=ARCH)
    ap.add_argument("--side", choices=("jax", "torch"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        _child(args.side)
        return 0
    os.makedirs(OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    for side in ("jax", "torch"):
        subprocess.run([sys.executable, __file__, "--side", side], env=env, check=True)
    res = {side: json.loads((OUT / f"{side}.json").read_text()) for side in ("jax", "torch")}
    runs = {}
    for lr in map(str, LRS):
        j, t = res["jax"]["runs"][lr], res["torch"]["runs"][lr]
        runs[lr] = {"jax_losses": j["losses"], "port_losses": t["losses"],
                    "jax_grad_norms": j["grad_norms"], "port_grad_norms": t["grad_norms"],
                    "loss_gap": _gap(t["losses"], j["losses"]),
                    "grad_norm_gap": _gap(t["grad_norms"], j["grad_norms"]),
                    "same_init": j["fingerprint"] == t["fingerprint"],
                    "params": [j["params"], t["params"]],
                    "jax_step_s": j["step_s"], "port_step_s": t["step_s"]}
    print(json.dumps({
        "arch": ARCH, "cut": CUT, "batch": list(BATCH), "steps": STEPS,
        "dtype": "float32", "device": "cpu", "runs": runs,
        "wall_s": {s: res[s]["wall_s"] for s in res},
        "peak_rss_bytes": {s: res[s]["peak_rss_bytes"] for s in res}}))
    return 0 if all(r["same_init"] for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
