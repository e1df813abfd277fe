"""The train step's profiler ranges (``repro_torch.ranges``): their names,
count and nesting under a CPU profiler, the collector's range, nothing built
and nothing changed when no profiler records, and, on the card, nothing of
them on the device's timeline.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ranges.py
"""
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import ranges
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import pipeline
from repro_torch.training import optimizer as O
from repro_torch.training import train as TR

CFG = reduced(get_arch("stablelm-1.6b").model).replace(
    num_layers=2, num_kv_heads=2, param_dtype="float32", compute_dtype="float32")
STEP_NAMES = ["repro_torch.step", "repro_torch.step.forward", "repro_torch.step.backward",
              "repro_torch.step.optimizer"]


def _setup(accum=1, seed=0):
    tcfg = TrainConfig(accum_steps=accum)
    state = TR.init_train_state(CFG, tcfg, seed, device="cpu")
    batch = next(pipeline.synthetic_batches(2, 16, CFG.vocab_size, seed=seed, n=1))
    return state, TR.make_train_step(CFG, tcfg), TR.to_device(batch, "cpu")


def _ranges(prof):
    """The program's ranges, by start."""
    evs = [e for e in prof.events() if e.name.startswith(ranges.PREFIX)]
    return sorted(evs, key=lambda e: e.time_range.start)


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("accum", [1, 2])
def test_each_step_opens_its_ranges_in_order(accum):
    state, step, batch = _setup(accum)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
    got = [e for e in _ranges(prof) if e.name in STEP_NAMES]
    names = [e.name for e in got]
    assert names == 2 * (["repro_torch.step"]
                         + accum * ["repro_torch.step.forward", "repro_torch.step.backward"]
                         + ["repro_torch.step.optimizer"])
    per_step = len(names) // 2
    for i in range(2):
        whole, *inner = got[i * per_step:(i + 1) * per_step]
        assert all(_inside(e, whole) for e in inner)
        assert all(a.time_range.end <= b.time_range.start for a, b in zip(inner, inner[1:]))


def test_a_collection_in_a_profiled_step_makes_a_gc_range(monkeypatch):
    state, step, batch = _setup()
    clip = O.clip_by_global_norm

    def clip_after_a_collection(grads, max_norm):
        gc.collect()
        return clip(grads, max_norm)
    monkeypatch.setattr(O, "clip_by_global_norm", clip_after_a_collection)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    got = _ranges(prof)
    optimizer = next(e for e in got if e.name == "repro_torch.step.optimizer")
    assert any(e.name == "repro_torch.gc" and _inside(e, optimizer) for e in got)
    assert gc.callbacks.count(ranges.GC_RANGE) == 1
    TR.make_train_step(CFG, TrainConfig())
    assert gc.callbacks.count(ranges.GC_RANGE) == 1


def test_no_range_is_built_without_a_profiler(monkeypatch):
    def built(name):
        raise AssertionError(f"a range {name} was built with no profiler recording")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", built)
    monkeypatch.setattr(torch.profiler, "record_function", built)
    assert ranges.span("step") is ranges.OFF
    state, step, batch = _setup()
    step(state, batch)
    ranges.GC_RANGE("start", {})          # a raise inside gc.collect() would be swallowed
    ranges.GC_RANGE("stop", {})
    assert ranges.GC_RANGE.open is None


@pytest.mark.parametrize("accum", [1, 2])
def test_a_profiler_changes_no_bit_of_the_step(accum):
    plain_state, step, batch = _setup(accum)
    traced_state, _, _ = _setup(accum)
    plain_state, plain = step(plain_state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced_state, traced = step(traced_state, batch)
    assert torch.equal(plain["loss"], traced["loss"])
    assert torch.equal(plain["grad_norm"], traced["grad_norm"])
    for (name, a), (_, b) in zip(plain_state["params"].named_parameters(),
                                 traced_state["params"].named_parameters()):
        assert torch.equal(a, b), name
    for m in ("mu", "nu"):
        for k, a in plain_state["opt"][m].items():
            assert torch.equal(a, traced_state["opt"][m][k]), (m, k)


@pytest.mark.cuda
def test_on_the_card_no_range_lies_on_the_device_timeline():
    """The ranges are CPU ops: no device event carries their names and no
    kernel is linked to them; a collection in the backward, on the autograd
    engine's device thread, gets its range on that thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(1024, 1024, device="cuda", requires_grad=True)
    ranges.install_gc_range()

    def collect(g):
        gc.collect()
        return g
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with ranges.span("step"):
            y = x * 1.0
            y.register_hook(collect)
            with ranges.span("step.backward"):
                torch.autograd.grad((y * y).sum(), [x])
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.events()
    ours = [e for e in evs if e.name.startswith(ranges.PREFIX)]
    assert {e.name for e in ours} == {"repro_torch.step", "repro_torch.step.backward",
                                      "repro_torch.gc"}
    assert all(e.device_type != cuda and not e.kernels for e in ours)
    assert any(e.device_type == cuda for e in evs)
    main = next(e.thread for e in ours if e.name == "repro_torch.step")
    engine = {e.thread for e in evs if e.name.startswith("autograd::engine")}
    collected = next(e for e in ours if e.name == "repro_torch.gc")
    assert collected.thread in engine and collected.thread != main
