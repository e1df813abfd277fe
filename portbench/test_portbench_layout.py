"""BENCHMARK.json against the benchmark's contract, and discovery by name."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields_and_reader(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["moves"] == "tokens_per_s"
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert {"loss", "grad", "change"} <= set(cell.limits)
    assert {m["name"] for m in cell.end_to_end} >= {"tokens_per_s", "setup_s"}
    assert cell.per_layer
    for key in ("seq", "micro_batch", "accum_steps", "distinct_batches", "check_steps",
                "trace_steps"):
        assert isinstance(cell.traffic[key], int)
    assert cell.traffic["distinct_batches"] > cell.traffic["check_steps"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    doc = json.loads((ROOT / conf["file"]).read_text())
    assert doc["name"] == conf["name"] and doc["reduced"] == conf["reduced"]
    assert conf["file"].startswith("portbench/")
    assert len(json.dumps(BENCH)) < 64 * 1024
