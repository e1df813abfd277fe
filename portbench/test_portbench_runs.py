"""Whole runs of tiny cells on the CPU: the last line's shape, the faults
that ``correct`` has to catch, the traced window's calls, and the check that
nothing of JAX or the JAX package is loaded."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, tiny, trace

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(name, fault=None, traced=False, accum=1, seed=2 ** 31 + 7):
    return harness.run_cell(tiny.cell(name, accum=accum), seed, 0.3, traced, CPU,
                            time.perf_counter(), fault=fault)


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_shape(traced):
    out = _run("stablelm-1.6b.train-4k", traced=traced)
    out.pop("_lines")
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert NAME.match(name) and set(m) == {"value", "unit"}
    assert set(line["check"]) == {"loss", "grad", "change"}
    want = {"mfu"} if traced else {"tokens_per_s", "setup_s"}
    assert set(line["metrics"]) == want
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,accum", [("stablelm-1.6b.train-4k", 1),
                                        ("zamba2-1.2b.train-4k-b8", 1),
                                        ("stablelm-1.6b.train-4k", 2)])
@pytest.mark.parametrize("fault", harness.FAULTS)
def test_a_broken_step_is_not_correct(name, accum, fault):
    assert _run(name, accum=accum)["correct"] is True
    out = _run(name, fault=fault, accum=accum)
    assert out["correct"] is False, out["check"]


def test_traced_calls_count_the_recompute_once():
    """Under remat full each layer's flash forward runs twice a step (the
    recompute inside the backward) and its backward once."""
    cell = tiny.cell("stablelm-1.6b.train-4k", "float32")
    s = harness.first_steps(cell, 3, CPU)
    calls = trace.Calls()
    with trace.wrapped_kernels(calls):
        calls.on = True
        s.step(s.state, s.batches[0])
    names = [n for n, _ in calls.work]
    layers = cell.config["model"]["num_layers"]
    assert names.count("flash_attention") == 2 * layers
    assert names.count("flash_attention_bwd") == layers
    assert set(calls.nodes.values()) == {"flash_attention", "rmsnorm"}


def test_classify_takes_the_innermost_known_range():
    calls = trace.Calls(nodes={"_FlashFnBackward": "flash_attention"})

    def op(name, parent=None):
        return SimpleNamespace(name=name, cpu_parent=parent)
    node = op(trace.EVAL + "_FlashFnBackward")
    copy = op("aten::copy_", op("_FlashFnBackward", node))
    assert trace._classify(copy, calls) == "flash_attention"
    assert trace._classify(op("aten::mm", op("MmBackward0", node)), calls) == "gemm"
    assert trace._classify(op("aten::mul", op(trace.SPAN + "ssd_scan")), calls) == "ssd_scan"
    assert trace._classify(op("aten::add_"), calls) == "other"


def test_banned_names_are_whole_top_level_names():
    assert harness.banned_modules(["repro_torch", "repro_torch.kernels", "jaxtyping"]) == []
    assert harness.banned_modules(["repro.core", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, time, torch; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness, tiny\n"
            "harness.run_cell(tiny.cell('zamba2-1.2b.train-4k-b8'), 1, 0.1, False,\n"
            "                 torch.device('cpu'), time.perf_counter())\n"
            "print(harness.banned_modules())\n") % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run.py would run the cell")
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          "stablelm-1.6b.train-4k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path: Path):
    import ast
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_and_the_yardstick_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.BANNED), path
    if (path.name in ("reference.py", "weights.py", "data.py", "check.py", "work.py")
            or path.parent.name == "families"):
        assert "repro_torch" not in tops, path
