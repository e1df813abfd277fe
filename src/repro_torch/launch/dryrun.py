"""Multi-pod dry run of the port: every (arch x shape x mesh) cell traced on
fake tensors, on a host with no card.

Port of ``repro/launch/dryrun.py``. Where the JAX package lowers and
compiles each cell ahead of time, this starts a fake process group of the
production mesh's size (backend ``"fake"``: every collective returns at
once), builds the mesh on it, lays the params, optimizer state and batch
out as DTensors of fake local shards by the port's own specs
(``sharding/rules.py``), and runs the port's real ``train_step``, prefill
or decode step once under ``roofline.count_step`` (each kernel planned by
its own launcher, none launched) and a tally of live storages of its own
(``roofline.StepCounter``). Nothing is allocated, and no other process
starts unless ``--subprocess-per-cell`` asks for one a cell. The record
goes to
``out/dryrun_torch/<mesh>/<arch>/<shape>[.<strategy>].json`` with JAX's
keys where a counterpart exists:

- ``memory_analysis``: ``argument_bytes`` (the local shards of state and
  batch), ``output_bytes`` (of what the step returns), ``alias_bytes``
  (the part of it the arguments hold: the state is updated in place),
  ``temp_bytes`` (the tally's peak less the arguments) and
  ``total_per_device_bytes`` as JAX sums them;
- ``cost_analysis``: ``flops`` and ``bytes accessed`` (the terms' flops
  and bytes);
- ``roofline``: ``roofline_report``;
- ``hlo_instruction_count``: the aten ops traced; ``lower_s``: the
  seconds the layout took, ``compile_s`` those of layout and trace;
- ``status``: "ok", or "error" with the exception, as on the card: a
  kernel's refusal (a head dim past 256) is the card's own.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every applicable cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --subprocess-per-cell
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(os.environ.get("DRYRUN_TORCH_OUT", "out/dryrun_torch"))
# --all --subprocess-per-cell: a cell's process that leaves no record within
# this time (or dies without one) gets a "not reached" record
CELL_TIMEOUT_S = 600
STRATEGIES = ["baseline", "dp_zero1", "pure_fsdp", "moe_a2a", "moe_rs"]


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _placed_params(cfg, tcfg, mesh, rules, strategy):
    from repro_torch.training import train as TR
    state = TR.init_train_state(cfg, tcfg, 0, device="cpu")
    state = TR.place_train_state(state, cfg, tcfg, mesh, rules, strategy)
    return state


def place_caches(caches, mesh, rules):
    """The caches laid out by ``cache_specs`` as DTensors, in the port's
    per-layer tree (the decode cells' and any decode under a mesh)."""
    from repro_torch import bridge
    from repro_torch.sharding import ctx
    from repro_torch.sharding import rules as R
    named = [(k.replace("/", "."), t) for k, t in bridge.flatten(caches).items()]
    placements = R.port_placements(
        named, R.cache_specs(R.stacked_shapes(named), mesh, rules), mesh)

    def walk(tree, name):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree) if isinstance(tree, list) else None)
        if items is None:
            return ctx.place(tree, mesh, placements[name])
        out = {k: walk(v, f"{name}.{k}" if name else str(k)) for k, v in items}
        return out if isinstance(tree, dict) else [out[i] for i in range(len(tree))]
    return walk(caches, "")


@dataclasses.dataclass
class Cell:
    """One cell laid out on the fake mesh: the step and its arguments, all
    made under ``mode`` (a fake tensor belongs to the mode that made it)."""
    arch: str
    shape: object
    cfg: object
    multi_pod: bool
    strategy: str
    mesh: object
    rules: dict
    mode: object
    step: object
    args: tuple
    place_s: float


def place_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               strategy: str = "baseline", remat: str = None) -> Cell:
    """The cell's state (or params and caches) and batch as DTensors of fake
    local shards on the production mesh, and its step."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import cache_specs_shapes, input_specs
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import rules_for
    from repro_torch.training import train as TR

    spec = get_arch(arch_id)
    cfg, tcfg = spec.model, spec.train
    if remat is not None:
        tcfg = dataclasses.replace(tcfg, remat=remat)
    shape = SHAPES_BY_NAME[shape_name]
    if shape_name in spec.skips:
        raise SystemExit(f"SKIP {arch_id} x {shape_name}: {spec.skips[shape_name]}")

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_for(arch_id, strategy)
    # the mesh keeps real rank maps: they meet fake tensors in its own ops
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with mode:
        batch = input_specs(cfg, shape)
        state = TR.place_train_state(TR.init_train_state(cfg, tcfg, 0, device="cpu"),
                                     cfg, tcfg, mesh, rules, strategy)
        batch = TR.place_batch(batch, mesh, rules)
        if shape.kind == "train":
            step, args = TR.make_train_step(cfg, tcfg), (state, batch)
        elif shape.kind == "prefill":
            params = state["params"].requires_grad_(False)
            kwargs = {k: batch[k] for k in ("frames", "patches") if k in batch}

            @torch.no_grad()
            def step(params, batch):
                with implicit_replication():          # as train_step runs its model
                    logits, _ = T.apply_lm(params, cfg, batch["tokens"],
                                           remat=tcfg.remat, **kwargs)
                return logits[:, -1, :]
            args = (params, batch)
        else:
            params = state["params"].requires_grad_(False)
            caches = place_caches(cache_specs_shapes(cfg, shape), mesh, rules)

            @torch.no_grad()
            def step(params, caches, token, index):
                with implicit_replication():
                    return T.apply_lm_decode(params, cfg, token, caches, index)
            args = (params, caches, batch["token"], shape.seq_len - 1)
    return Cell(arch_id, shape, cfg, multi_pod, strategy, mesh, rules, mode, step, args,
                time.time() - t0)


def trace_cell(cell: Cell):
    """Runs the cell's step once under ``count_step``; returns (counter, terms)."""
    from repro_torch.roofline.analysis import StepCounter, count_step
    from repro_torch.sharding.ctx import use_mesh
    counter = StepCounter(memory=True)
    with cell.mode, use_mesh(cell.mesh, cell.rules, cell.strategy):
        counter.hold_arguments(cell.args)
        terms = count_step(cell.step, *cell.args, counter=counter)
    return counter, terms


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             strategy: str = "baseline", remat: str = None, tag: str = None,
             out_dir: Path = OUT_DIR, verbose: bool = True, cell: Cell = None) -> dict:
    """Places and traces one cell (or traces ``cell``) and writes its record,
    "ok" or "error" with the exception; returns the record."""
    from repro_torch.roofline.analysis import roofline_report
    path = _record_path(out_dir, multi_pod, arch_id, shape_name, tag or strategy)
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    try:
        cell = cell or place_cell(arch_id, shape_name, multi_pod=multi_pod,
                                  strategy=strategy, remat=remat)
        counter, terms = trace_cell(cell)
    except Exception as e:  # noqa: BLE001
        rec = {"arch": arch_id, "shape": shape_name, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        path.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"FAIL {arch_id} x {shape_name}: {rec['error']}")
        return rec
    out, alias = counter.output_bytes(counter.result)
    mem = {"argument_bytes": counter.argument_bytes, "output_bytes": out,
           "temp_bytes": max(counter.peak - counter.argument_bytes, 0),
           "alias_bytes": alias}
    mem["total_per_device_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                                     + mem["temp_bytes"] - mem["alias_bytes"])
    report = roofline_report(terms, cell.cfg, cell.shape, cell.mesh.size())
    rec = {"arch": arch_id, "shape": shape_name, "strategy": strategy,
           "multi_pod": multi_pod, "chips": cell.mesh.size(),
           "lower_s": round(cell.place_s, 2), "compile_s": round(time.time() - t0, 2),
           "memory_analysis": mem,
           "cost_analysis": {"flops": terms.flops, "bytes accessed": terms.hbm_bytes},
           "roofline": report, "kernel_calls": len(counter.kernels),
           "hlo_instruction_count": counter.aten_ops, "status": "ok"}
    path.write_text(json.dumps(rec, indent=1))
    if verbose:
        print(f"[{_mesh_tag(multi_pod)}] {arch_id} x {shape_name}: "
              f"trace={rec['compile_s']}s "
              f"mem/dev={mem['total_per_device_bytes']/2**30:.2f}GiB "
              f"dom={report['dominant']} "
              f"terms(c/m/x)=({report['compute_s']:.4f},"
              f"{report['memory_s']:.4f},{report['collective_s']:.4f})s "
              f"useful={report['useful_flops_ratio']:.2f}")
    return rec


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _record_path(out_dir: Path, multi_pod: bool, arch_id: str, shape_name: str,
                 label: str) -> Path:
    fname = f"{shape_name}.json" if label == "baseline" else f"{shape_name}.{label}.json"
    return out_dir / _mesh_tag(multi_pod) / arch_id / fname


def all_cells(multi_pod: bool):
    from repro_torch.configs import ARCHS, LM_SHAPES, get_arch
    for arch_id in ARCHS:                 # the registry's, as JAX's ARCH_IDS
        spec = get_arch(arch_id)
        for shape in LM_SHAPES:
            if shape.name in spec.skips:
                yield arch_id, shape.name, "skip", spec.skips[shape.name]
            else:
                yield arch_id, shape.name, "run", None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="baseline", choices=STRATEGIES)
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--tag", default=None, help="suffix for the output json")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess-per-cell", action="store_true",
                    help="isolate each cell's trace in a fresh process")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        failures = []
        for arch_id, shape_name, status, reason in all_cells(args.multi_pod):
            mesh_tag = _mesh_tag(args.multi_pod)
            path = _record_path(out_dir, args.multi_pod, arch_id, shape_name, "baseline")
            if status == "skip":
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(
                    {"arch": arch_id, "shape": shape_name, "status": "skip",
                     "reason": reason}, indent=1))
                print(f"[{mesh_tag}] {arch_id} x {shape_name}: SKIP ({reason})")
                continue
            if path.exists() and json.loads(path.read_text()).get("status") == "ok":
                print(f"[{mesh_tag}] {arch_id} x {shape_name}: cached")
                continue
            if args.subprocess_per_cell:
                import subprocess
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch_id, "--shape", shape_name, "--out", str(out_dir)]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                path.unlink(missing_ok=True)
                try:
                    ok = subprocess.run(cmd, timeout=CELL_TIMEOUT_S).returncode == 0
                except subprocess.TimeoutExpired:
                    ok = False
                if not path.exists():
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_text(json.dumps(
                        {"arch": arch_id, "shape": shape_name, "status": "not reached",
                         "reason": f"no record within {CELL_TIMEOUT_S} s"}, indent=1))
                    print(f"[{mesh_tag}] {arch_id} x {shape_name}: NOT REACHED")
                if not ok:
                    failures.append((arch_id, shape_name))
            elif run_cell(arch_id, shape_name, multi_pod=args.multi_pod,
                          out_dir=out_dir)["status"] != "ok":
                failures.append((arch_id, shape_name))
        if failures:
            print("FAILED CELLS:", failures)
            sys.exit(1)
        print("ALL CELLS OK")
        return

    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   strategy=args.strategy, remat=args.remat, tag=args.tag,
                   out_dir=out_dir)
    if rec["status"] != "ok":
        sys.exit(1)
    print(json.dumps({k: rec[k] for k in ("memory_analysis", "roofline")}, indent=1))


if __name__ == "__main__":
    main()
