"""``portbench.ranges`` on hand-built events: the optimizer's device time, the
idle time under the backward and the optimizer with the collector's part
left to it (on any thread), the collector's host time, and no reading where
the program opens no ranges."""
import itertools
from types import SimpleNamespace

import pytest
import torch

from portbench import ranges, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _span(start, end):
    return SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)


IDS = itertools.count(1)


def _op(name, start, end, parent=None, kernels=(), thread=1, id=None):
    return SimpleNamespace(name=name, device_type=CPU, time_range=_span(start, end),
                           cpu_parent=parent, thread=thread, is_user_annotation=False,
                           id=next(IDS) if id is None else id,
                           kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def _kernel(start, end, name="k", annotation=False):
    return SimpleNamespace(name=name, device_type=CUDA, time_range=_span(start, end),
                           cpu_parent=None, is_user_annotation=annotation, kernels=[])


def _window(program=True):
    """A window of 1000 us: kernels busy over [0,150], [300,550], [650,680]
    and [800,1000]; the backward over [100,500] with a collection on the
    engine's thread over [200,260]; the optimizer over [500,900] with a
    collection over [600,700]; its two ops launched 30 and 200 us of
    kernels (the 200 also linked to a runtime event of the same id), the
    backward's op 250."""
    window = _op(trace.WINDOW, 0, 1000)
    events = [window, _kernel(0, 1000, trace.WINDOW, annotation=True),
              _kernel(0, 150), _kernel(300, 550), _kernel(650, 680), _kernel(800, 1000)]
    if not program:
        return events
    step = _op(ranges.STEP, 0, 1000, window)
    backward = _op(ranges.BACKWARD, 100, 500, step)
    optimizer = _op(ranges.OPTIMIZER, 500, 900, step)
    events += [step, backward, optimizer,
               _op(ranges.GC, 200, 260, thread=2),
               _op(ranges.GC, 600, 700, optimizer),
               _op("aten::mm", 310, 320, _op("MmBackward0", 305, 330, thread=2),
                   [("nvjet", 250)], thread=2),
               _op("aten::mul", 640, 650, optimizer, [("mul", 30)]),
               _op("aten::add_", 790, 800, _op("aten::add", 785, 805, optimizer),
                   [("add", 200), (trace.SPAN + "x", 999)], id=-1),
               _op("Command Buffer Full", 795, 799, optimizer, [("add", 200)], id=-1)]
    return events


@pytest.mark.parametrize("steps", [1, 2])
def test_readings_from_known_intervals(steps):
    got = ranges.read(_window(), steps)
    us = 1e-6 / steps
    assert got.optimizer_s == pytest.approx(230 * us)
    # idle [150,300], [550,650], [680,800]; the gc ranges [200,260], [600,700]
    assert got.backward_idle_s == pytest.approx((50 + 40) * us)
    assert got.optimizer_idle_s == pytest.approx((50 + 100) * us)
    assert got.gc_s == pytest.approx(160 * us)
    assert got.gc_idle_s == pytest.approx((60 + 20 + 50) * us)


def test_no_reading_without_the_programs_ranges():
    assert ranges.read(_window(program=False), 2) is None


@pytest.mark.parametrize("a,b,want", [
    ([(0, 10), (20, 30)], [(5, 25)], [(5, 10), (20, 25)]),
    ([(0, 10)], [(10, 20)], []),
    ([(0, 100)], [(10, 20), (30, 40)], [(10, 20), (30, 40)]),
])
def test_intersect(a, b, want):
    assert ranges._intersect(a, b) == want
    assert ranges._intersect(b, a) == want


def test_gaps():
    assert ranges._gaps([(10, 20), (30, 40)], 0, 50) == [(0, 10), (20, 30), (40, 50)]
    assert ranges._gaps([(0, 50)], 0, 50) == []


def test_the_programs_ranges_change_no_reading_of_trace():
    """The ranges are CPU ops with no kernels: the accepted readings of a
    window (its kinds of device time, busy time, bounds) are the same with
    and without them."""
    def read(events):
        got = vars(trace.analyse(events, trace.Calls(), [], 2, 0))
        got.pop("idle_gaps")                    # named by the innermost host op
        return got
    bare = [e for e in _window() if not e.name.startswith(ranges.PROGRAM)]
    assert read(_window()) == read(bare)


def test_a_traced_cpu_step_reads_its_ranges(monkeypatch):
    """A real CPU trace of the tiny step: its ranges are found and read. No
    kernel runs on a device, so the window is idle throughout and each
    range's reading is its host time."""
    from portbench import harness, tiny
    events = {}
    analyse = trace.analyse

    def keep(evs, *a, **k):
        events["all"] = evs
        return analyse(evs, *a, **k)
    monkeypatch.setattr(trace, "analyse", keep)
    s = harness.first_steps(tiny.cell("stablelm-1.6b.train-4k"), 5, torch.device("cpu"))
    state = [s.state]

    def step_once(i):
        state[0], _ = s.step(state[0], s.batches[i % len(s.batches)])
    data = trace.traced_window(step_once, 2, torch.device("cpu"))
    got = ranges.read(events["all"], 2)
    assert got.optimizer_s == 0.0 and got.gc_idle_s == pytest.approx(got.gc_s)
    assert got.optimizer_idle_s > 0 and got.backward_idle_s > 0
    assert got.optimizer_idle_s + got.backward_idle_s + got.gc_s < data.window_s / 2
