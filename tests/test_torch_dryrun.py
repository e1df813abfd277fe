"""The port's dry run (``repro_torch/launch/dryrun.py``, ``launch/specs.py``)
and the two benchmark twins (``scripts/roofline_report_torch.py``,
``scripts/bench_autotune_torch.py``) against the JAX package's: the input
and cache shapes of every cell, the argument bytes per device that JAX's
specs imply on ``jax.eval_shape`` trees (no compile), a full-width cell
traced end to end on a fake 256-rank group (its memory without the global
logits), the cells that stopped before the port's loss, heads and decode
repairs and its backward at MLA's 192/128 (uneven heads, decode over
sharded caches, deepseek's training), and the twins' output on the same
inputs."""
import functools
import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import specs as jspecs
from repro.sharding import rules as JR
from repro.training import train as JTR
from repro_torch import bridge, configs
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun, specs
from repro_torch.roofline.analysis import StepCounter
from repro_torch.kernels import flash_attention as fa
from repro_torch.sharding import rules as R
from repro_torch.training import train as TR

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(configs.ARCHS)
SHAPES = list(SHAPES_BY_NAME)
POD = {"data": 16, "model": 16}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _path(kp) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)


def _flat_jax(tree):
    return {_path(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_shapes_equal_jax(arch, shape):
    """Every batch entry has JAX's shape, in the port's own dtypes (int64
    tokens); a decode cell's caches have JAX's shapes and dtypes, leaf by
    leaf on the stacked JAX paths."""
    cfg, jc = configs.get_arch(arch).model, jcfg.get_arch(arch).model
    sh, jsh = SHAPES_BY_NAME[shape], jcfg.get_shape(shape)
    got, want = specs.input_specs(cfg, sh), jspecs.input_specs(jc, jsh)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k, v in got.items():
        integer = jnp.issubdtype(want[k].dtype, jnp.integer)
        assert v.dtype == (torch.long if integer else torch.bfloat16), k
    if sh.kind != "decode":
        return
    caches = specs.cache_specs_shapes(cfg, sh)
    named = [(k.replace("/", "."), t) for k, t in bridge.flatten(caches).items()]
    dtypes = {bridge.jax_key(n)[0]: str(t.dtype).replace("torch.", "") for n, t in named}
    jcaches = _flat_jax(jspecs.cache_specs_shapes(jc, jsh))
    assert R.stacked_shapes(named) == {k: tuple(v.shape) for k, v in jcaches.items()}
    assert dtypes == {k: str(v.dtype) for k, v in jcaches.items()}


def _local_bytes(shape, spec, itemsize):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        div = math.prod(POD[a] for a in axes)
        assert d % div == 0
        n *= d // div
    return n * itemsize


def _jax_argument_bytes(arch):
    """Local bytes a device holds of JAX's train state and batch at
    pod16x16 by JAX's own specs, with the port's int64 tokens."""
    spec = jcfg.get_arch(arch)
    jc, strategy = spec.model, "baseline"
    mesh = SimpleNamespace(shape=POD)
    rules = JR.rules_for(arch, strategy)
    state = jax.eval_shape(lambda: JTR.init_train_state(jc, spec.train, jax.random.PRNGKey(0)))
    batch = jspecs.input_specs(jc, jcfg.get_shape("train_4k"))
    total = 0
    for tree, spec_tree, int_bytes in (
            (state["params"], JR.param_specs(state["params"], mesh, rules, jc, strategy), None),
            (state["opt"], JR.opt_state_specs(state["opt"], mesh, rules, jc, strategy), None),
            (batch, JR.batch_specs(batch, mesh, rules), 8)):
        leaves, specs_ = _flat_jax(tree), _flat_jax(spec_tree)
        for k, leaf in leaves.items():
            size = (int_bytes if int_bytes and jnp.issubdtype(leaf.dtype, jnp.integer)
                    else leaf.dtype.itemsize)
            total += _local_bytes(leaf.shape, tuple(specs_.get(k, ())), size)
    return total + 4                                     # the int32 step


@functools.lru_cache(maxsize=None)
def _train_cell(arch):
    return dryrun.place_cell(arch, "train_4k")


@pytest.fixture(scope="module", autouse=True)
def _close_the_fake_group():
    """The dry run leaves its fake process group up; later tests in this
    process must not find one."""
    yield
    import torch.distributed as dist
    _train_cell.cache_clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_specs(arch):
    """The port lays the train_4k state and batch out by its own specs on
    the fake 256-rank mesh: each device holds exactly the bytes JAX's specs
    give it."""
    counter = StepCounter(memory=True)
    counter.hold_arguments(_train_cell(arch).args)
    assert counter.argument_bytes == _jax_argument_bytes(arch)


def test_a_full_width_cell_end_to_end(tmp_path):
    """stablelm-1.6b x train_4k from the command line: an "ok" record with
    JAX's keys, the argument bytes JAX's specs give, every kernel planned,
    and a device's memory below 57 GiB: the loss reads each rank's block of
    the (256, 4096, 100352) fp32 logits, whose gradient replicated alone
    took 392 GiB a device (449.06 GiB in all)."""
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "pod16x16" / "stablelm-1.6b" / "train_4k.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] == _jax_argument_bytes("stablelm-1.6b")
    assert mem["total_per_device_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                             + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["total_per_device_bytes"] < 57 * 2**30
    r = rec["roofline"]
    assert r["model_flops_total"] == 6.0 * configs.get_arch(
        "stablelm-1.6b").model.param_counts()["active"] * 4096 * 256
    assert r["hlo_flops_per_chip"] > r["model_flops_per_chip"] > 0
    assert r["coll_bytes_per_chip"] > 0 and rec["hlo_instruction_count"] > 0
    # 24 layers under remat full: flash 48 + 24, rmsnorm 97 + 49
    assert rec["kernel_calls"] == 48 + 24 + 97 + 49
    assert rec["cost_analysis"]["flops"] == r["hlo_flops_per_chip"]


def test_deepseek_train_records_the_mla_refusal(tmp_path):
    """MLA's 192/128 heads train: the flash backward plans them at the
    width-256 tile, as on the card, and the full-width cell, which recorded
    that plan's refusal before the backward took 192/128, now traces to an
    "ok" record with every kernel call of a train step."""
    mla_q = torch.zeros(1, 128, 16, 192, dtype=torch.bfloat16)
    mla_v = torch.zeros(1, 128, 16, 128, dtype=torch.bfloat16)
    assert fa.plan_bwd(mla_q, mla_q, mla_v) == ("tensor_cores", (256, 32))
    rec = dryrun.run_cell("deepseek-v3-671b", "train_4k", out_dir=tmp_path,
                          cell=_train_cell("deepseek-v3-671b"), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    spec = configs.get_arch("deepseek-v3-671b")
    assert rec["kernel_calls"] == sum(
        TR.kernel_launches_per_step(spec.model, spec.train.remat).values())
    path = tmp_path / "pod16x16" / "deepseek-v3-671b" / "train_4k.json"
    assert json.loads(path.read_text())["status"] == "ok"


@pytest.mark.parametrize("arch,shape", [
    ("paligemma-3b", "train_4k"),      # 8 heads on a model axis of 16
    ("stablelm-1.6b", "decode_32k")])  # decode over caches laid out by cache_specs
def test_cells_past_the_uneven_heads_and_the_sharded_cache(tmp_path, arch, shape):
    """Two cells that stopped in DTensor's propagation (the (B, S, 8 x 256)
    projection viewed as heads over 16 shards; the decode's products over
    the sharded cache) record "ok", every kernel of the step planned."""
    rec = dryrun.run_cell(arch, shape, out_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    cfg = configs.get_arch(arch).model
    if shape == "train_4k":
        want = TR.kernel_launches_per_step(cfg, configs.get_arch(arch).train.remat)
        assert rec["kernel_calls"] == sum(want.values())
    else:                                     # one rmsnorm a norm, no flash in decode
        assert rec["kernel_calls"] == 2 * cfg.num_layers + 1
    assert rec["memory_analysis"]["total_per_device_bytes"] > 0


def _records(out: Path):
    """An "ok", a "skip" and an "error" record, as the dry runs write them."""
    ok = {"arch": "a", "shape": "train_4k", "status": "ok", "compile_s": 1.5,
          "memory_analysis": {"total_per_device_bytes": 3 * 2**30},
          "roofline": {"compute_s": 0.123456, "memory_s": 0.5, "collective_s": 0.25,
                       "collective_s_bf16adj": 0.2, "dominant": "memory",
                       "useful_flops_ratio": 0.6789, "roofline_fraction": 0.01234567}}
    for arch, shape, rec in (("a", "train_4k", ok),
                             ("a", "long_500k", {"arch": "a", "shape": "long_500k",
                                                 "status": "skip", "reason": "full attention"}),
                             ("b", "decode_32k", {"arch": "b", "shape": "decode_32k",
                                                  "status": "error", "error": "E"})):
        path = out / "pod16x16" / arch / f"{shape}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec))


def test_roofline_report_twin_equals_jax_on_the_same_records(tmp_path, monkeypatch):
    _records(tmp_path)
    jax_script = _load(ROOT / "benchmarks" / "roofline_report.py", "jax_roofline_report")
    twin = _load(ROOT / "scripts" / "roofline_report_torch.py", "roofline_report_torch")
    monkeypatch.setattr(jax_script, "OUT", tmp_path)
    monkeypatch.setattr(twin, "OUT", tmp_path)
    assert twin.load() == jax_script.load()
    assert twin.markdown_table(twin.load()) == jax_script.markdown_table(jax_script.load())
    assert twin.run() == jax_script.run()
    assert "NOT REACHED" in twin.markdown_table(
        [{"arch": "c", "shape": "train_4k", "status": "not reached"}])


def test_autotune_twin_picks_jax_configs(monkeypatch):
    """Fig. 8's rows: the same three configurations and hyperparameters as
    the JAX script's (the surrogate's pick included); each trained on the
    CPU (two steps here) to a finite loss."""
    jax_script = _load(ROOT / "benchmarks" / "bench_autotune.py", "jax_bench_autotune")
    twin = _load(ROOT / "scripts" / "bench_autotune_torch.py", "bench_autotune_torch")
    got, want = twin.run(steps=5, device="cpu"), jax_script.run(steps=5)
    strip = [{k: v for k, v in r.items() if not k.endswith("_loss")} for r in want]
    assert [{k: v for k, v in r.items() if not k.endswith("_loss")} for r in got] == strip
    assert all(np.isfinite(r["final_loss"]) and np.isfinite(r["first_loss"]) for r in got)


def test_all_cells_loop_records_a_cell_not_reached(tmp_path, monkeypatch, capsys):
    """``--all --subprocess-per-cell``: a cell whose process leaves no record
    within ``CELL_TIMEOUT_S`` gets a "not reached" record and fails the run;
    the twin's ``--all`` runs that loop and lists the cell as such."""
    from repro_torch.launch import dryrun
    cells = [("stablelm-1.6b", "train_4k", "run", None),
             ("stablelm-1.6b", "long_500k", "skip", "full attention")]
    monkeypatch.setattr(dryrun, "all_cells", lambda multi_pod: iter(cells))
    monkeypatch.setattr(dryrun, "CELL_TIMEOUT_S", 0.01)
    with pytest.raises(SystemExit) as ended:
        dryrun.main(["--all", "--subprocess-per-cell", "--out", str(tmp_path)])
    assert ended.value.code == 1
    rec = json.loads((tmp_path / "pod16x16" / "stablelm-1.6b" / "train_4k.json").read_text())
    assert rec["status"] == "not reached"
    twin = _load(ROOT / "scripts" / "roofline_report_torch.py", "roofline_report_torch")
    monkeypatch.setattr(twin, "OUT", tmp_path)
    capsys.readouterr()
    twin.main(["--all"])
    table = capsys.readouterr().out
    assert "| stablelm-1.6b | train_4k | NOT REACHED |" in table
    assert "| stablelm-1.6b | long_500k | SKIP |" in table
