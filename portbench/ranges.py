"""The program's own ranges in a traced window (``repro_torch.ranges``), read
on the device trace's clock, each per step:

- ``optimizer_s``: device seconds of the kernels whose launching op lies
  under ``repro_torch.step.optimizer`` (the clip and the update);
- ``optimizer_idle_s``, ``backward_idle_s``: seconds the device ran no
  kernel while the host was in ``repro_torch.step.optimizer`` or
  ``repro_torch.step.backward``, on any thread, a collection inside either
  left to ``gc``;
- ``gc_s``: the host's seconds in ``repro_torch.gc`` ranges, and
  ``gc_idle_s`` the device's idle seconds among them.

No metric of ``BENCHMARK.json`` reads these yet: ``trace.analyse`` keeps no
events, so a reader under ``metrics/`` cannot reach them until
``trace.analyse`` calls ``read`` and keeps its result on ``TraceData``.

The kernels and the idle time are those of ``trace.analyse``: the window's
device kernels, the benchmark's ranges and the user annotations left out.
As there, a kind's device time sums the durations of the kernels linked to
its ops, so where the profiler's timestamps of consecutive kernels overlap,
the overlap counts twice; unlike there, the kernels of ops that share one id
(a runtime event such as "Command Buffer Full" gets the id, and the kernels,
of the launch it held up) count once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from portbench import trace

PROGRAM = "repro_torch."
STEP, BACKWARD, OPTIMIZER, GC = (PROGRAM + n for n in
                                 ("step", "step.backward", "step.optimizer", "gc"))
Intervals = List[Tuple[float, float]]


@dataclass
class Ranges:
    optimizer_s: float
    optimizer_idle_s: float
    backward_idle_s: float
    gc_s: float
    gc_idle_s: float


def _gaps(iv: Intervals, lo: float, hi: float) -> Intervals:
    """[lo, hi] less the sorted, disjoint intervals ``iv`` that lie in it."""
    edges = [lo] + [x for s in iv for x in s] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _intersect(a: Intervals, b: Intervals) -> Intervals:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def _under(op, name: str) -> bool:
    while op is not None:
        if op.name == name:
            return True
        op = op.cpu_parent
    return False


def read(events, steps: int) -> Optional[Ranges]:
    """The program's ranges in a profiler's events (``prof.events()``) of a
    traced window of ``steps`` steps; None where the window holds no
    ``repro_torch.step`` (a program without the ranges)."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu_ops = [e for e in events if e.device_type != cuda]
    win = max((e for e in cpu_ops if e.name == trace.WINDOW), key=lambda e: e.time_range.start)
    w0, w1 = win.time_range.start, win.time_range.end

    def ranges(name: str) -> Intervals:
        return trace._union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                             for e in cpu_ops if e.name == name
                             and e.time_range.end > w0 and e.time_range.start < w1])

    if not ranges(STEP):
        return None
    kernels = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
               if e.device_type == cuda and not trace._ours(e.name)
               and not getattr(e, "is_user_annotation", False)
               and e.time_range.end > w0 and e.time_range.start < w1]
    idle = _gaps(trace._union(kernels), w0, w1)
    gc = ranges(GC)
    outside_gc = _gaps(gc, w0, w1)

    def idle_in(name: str) -> float:
        return _length(_intersect(idle, _intersect(ranges(name), outside_gc)))

    optimizer_us, seen = 0.0, set()
    for op in cpu_ops:
        ks = [k for k in getattr(op, "kernels", ()) if not trace._ours(k.name)]
        if (ks and op.id not in seen and w0 <= op.time_range.start <= w1
                and _under(op, OPTIMIZER)):
            seen.add(op.id)
            optimizer_us += sum(k.duration for k in ks)
    per_step = 1e-6 / steps
    return Ranges(optimizer_s=optimizer_us * per_step,
                  optimizer_idle_s=idle_in(OPTIMIZER) * per_step,
                  backward_idle_s=idle_in(BACKWARD) * per_step,
                  gc_s=_length(gc) * per_step,
                  gc_idle_s=_length(_intersect(idle, gc)) * per_step)
