"""One run of one cell: set-up, the first steps checked, the measured or
traced window, the reference, and the result line.

Set-up builds the program's train state and step once
(``repro_torch.training.train.init_train_state`` / ``make_train_step``, the
step ``launch/train.py``'s loop runs), writes the seed's weights into it,
puts the seed's batches on the device, and drives the first
``check_steps`` optimizer steps through that same step on distinct batches.
Those steps are the warm-up: every shape of the cell is built there. Their
losses, the first clipped gradient (read from AdamW's first moment after
step 1, mu / (1 - beta1), by ``first_gradient``) and the parameters' change
over them are what the reference is held to. The same state and step then run the window, cycling
the batches, with no host sync added and the garbage collector as the
program's loop has it: ``--trace 0`` for ``--seconds``
seconds, ended by one ``torch.cuda.synchronize()``; ``--trace 1`` for the
traffic's ``trace_steps``, first timed alone and then under the profiler.
When the window has closed and the peak memory has been read, the program's
state is freed and the reference follows the same first steps.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, data, weights
from portbench.reference import Reference

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")
FAULTS = ("frozen", "half_batch", "altered")


def banned_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that the port's runs may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json")
                                   .read_text()),
                limits=json.loads((root / "portbench" / "limits" / f"{name}.json").read_text()),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    model: Dict
    traffic: Dict
    tokens_per_step: int
    steps: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    step_s: float = 0.0
    trace: Optional[object] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _with_fault(step, fault: Optional[str], cfg, tcfg):
    """The step broken as ``fault`` says (tests and calibration only)."""
    if fault is None:
        return step
    if fault not in FAULTS:
        raise ValueError(f"fault is one of {FAULTS}, got {fault!r}")
    from repro_torch.training import train as TR
    if fault == "frozen":                       # the state comes back unchanged
        evaluate = TR.make_eval_step(cfg, tcfg)
        return lambda state, batch: (state, evaluate(state["params"], batch))
    if fault == "half_batch":                   # the mean over half the rows
        return lambda state, batch: step(state, {k: v[: v.shape[0] // 2]
                                                 for k, v in batch.items()})

    def altered(state, batch):                  # one leaf moved twice as far
        p = next(p for _, p in state["params"].named_parameters() if p.dim() == 2)
        before = p.detach().clone()
        state, m = step(state, batch)
        with torch.no_grad():
            p.add_(p - before)
        return state, m
    return altered


def first_gradient(state: Dict, names, beta1: float) -> Dict[str, torch.Tensor]:
    """Each leaf's clipped gradient as AdamW got it at step 1, from the first
    moment it keeps: mu = (1 - beta1) g. The program's state has to hold it
    as ``state["opt"]["mu"][leaf]``, in the leaf's shape (views of a flat
    buffer will do)."""
    try:
        mu = state["opt"]["mu"]
        return {n: mu[n] / (1 - beta1) for n in names}
    except (KeyError, TypeError) as e:
        raise RuntimeError("the benchmark reads AdamW's first moment after step 1 as "
                           f"state['opt']['mu'][leaf]; the program's state has none ({e!r})")


@dataclasses.dataclass
class Setup:
    """The program's state and step after the first, checked steps."""
    state: Dict
    step: Callable
    batches: List[Dict[str, torch.Tensor]]
    host: List[Dict]
    leaves: List
    got: Dict
    phases: Dict[str, float]


def first_steps(cell: Cell, seed: int, device: torch.device,
                fault: Optional[str] = None) -> Setup:
    """Builds the program's state and step, writes the seed's weights, and
    drives the first ``check_steps`` steps; keeps what the reference is held
    to."""
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.training import train as TR

    model, train, traffic = cell.config["model"], cell.config["train"], cell.traffic
    accum = traffic["accum_steps"]
    rows = traffic["micro_batch"] * accum
    cfg = ModelConfig(**model)
    tcfg = TrainConfig(**{**train, "accum_steps": accum})

    phases: Dict[str, float] = {}
    clock = [time.perf_counter()]

    def done(phase: str) -> None:
        _sync(device)
        now = time.perf_counter()
        phases[phase] = now - clock[0]
        clock[0] = now

    state = TR.init_train_state(cfg, tcfg, 0, device=device)
    params = dict(state["params"].named_parameters())
    leaves = weights.leaves_of(params.items())
    done("state")
    with torch.no_grad():
        for name, value in weights.draw(leaves, seed, device):
            params[name].copy_(value)
    done("weights")
    host = data.batches(seed, traffic["distinct_batches"], rows, traffic["seq"],
                        model["vocab_size"])
    batches = [{n: torch.from_numpy(a).to(device) for n, a in b.items()} for b in host]
    step = _with_fault(TR.make_train_step(cfg, tcfg), fault, cfg, tcfg)
    done("batches")
    if device.type == "cuda":                   # the kernels, built at the first run
        from repro_torch.kernels import build
        build.library()
        done("kernels")

    losses, first = [], None
    for i in range(traffic["check_steps"]):
        state, m = step(state, batches[i])
        losses.append(m["loss"])
        if first is None:
            first = {n: g.norm() for n, g in
                     first_gradient(state, params, train["beta1"]).items()}
        done(f"step{i + 1}")
    with torch.no_grad():
        change = {n: (params[n].float() - w0.float()).norm()
                  for n, w0 in weights.draw(leaves, seed, device)}
    got = {"losses": [float(x) for x in losses],
           "grad_norms": {n: float(v) for n, v in first.items()},
           "change_norms": {n: float(v) for n, v in change.items()}}
    done("readings")
    return Setup(state, step, batches, host, leaves, got, phases)


def reference_run(cell: Cell, setup: Setup, seed: int, device: torch.device,
                  quant: Optional[str] = None) -> Dict:
    """The reference (or, with ``quant``, the control) over the first steps."""
    k = cell.traffic["check_steps"]
    batches = [{n: torch.from_numpy(a).to(device) for n, a in b.items()}
               for b in setup.host[:k]]
    return Reference(cell.config["model"], cell.config["train"], quant).run(
        setup.leaves, seed, batches, cell.traffic["accum_steps"], device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, fault: Optional[str] = None) -> Dict:
    """One run; returns the result line's object, with ``check`` last."""
    traffic = cell.traffic
    k = traffic["check_steps"]
    imports_s = time.perf_counter() - t_start
    s = first_steps(cell, seed, device, fault)
    state, step, batches = s.state, s.step, s.batches
    s.state = s.step = s.batches = None
    model = cell.config["model"]
    run = Run(model=model, traffic=traffic,
              tokens_per_step=traffic["micro_batch"] * traffic["accum_steps"] * traffic["seq"])
    n = len(batches)
    window_losses: List[torch.Tensor] = []

    def step_once(i: int) -> None:
        nonlocal state
        state, m = step(state, batches[(k + i) % n])
        window_losses.append(m["loss"])

    gc.collect()                                # set-up's garbage, once
    if not trace:
        _sync(device)
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        while time.perf_counter() - t0 < seconds:
            step_once(run.steps)
            run.steps += 1
        _sync(device)
        run.window_s = time.perf_counter() - t0
    else:
        steps = traffic["trace_steps"]
        _sync(device)
        t0 = time.perf_counter()
        for i in range(steps):
            step_once(i)
        _sync(device)
        run.step_s = (time.perf_counter() - t0) / steps
        from portbench import trace as TRACE
        run.trace = TRACE.traced_window(lambda i: step_once(steps + i), steps, device)
        run.steps = 2 * steps + 1
    losses = torch.stack(window_losses).tolist() if window_losses else []
    finite = [math.isfinite(x) for x in losses]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del state, step, batches, window_losses
    free(device)
    t_ref = time.perf_counter()
    nums = check.numbers(s.got, reference_run(cell, s, seed, device))
    ref_s = time.perf_counter() - t_ref
    failed = finite.count(False)
    correct = check.verdict(nums, cell.limits) and failed == 0

    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": len(finite), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                            "idle_gaps": [list(x) for x in t.idle_gaps]}
    out["check"] = {name: {"value": _num(nums[name]), "limit": cell.limits.get(name)}
                    for name in check.NUMBERS}
    out["_lines"] = ([f"set-up imports {imports_s!r} s"]
                     + [f"set-up {k} {v!r} s" for k, v in s.phases.items()]
                     + ([f"trace read {run.trace.read_s!r} s, device s no op claimed "
                         f"{run.trace.unlinked_s!r}"] if trace else [])
                     + [f"reference {ref_s!r} s"] + check.lines(nums, cell.limits))
    return out


def _num(x: float):
    return x if math.isfinite(x) else str(x)
