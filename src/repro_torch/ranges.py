"""The train step's own profiler ranges.

``span(name)`` is a range ``repro_torch.<name>`` while a ``torch.profiler``
records on the calling thread, and one shared null context otherwise, so the
step pays a check and no range when nothing profiles. ``install_gc_range()``
adds one ``gc.callbacks`` entry that lays a ``repro_torch.gc`` range over
each collection made while a profiler records, on the thread that collects
(the autograd engine's device thread included).

The ranges are recorded as the profiler's CPU ops, on the same clock as the
device trace, and not as user annotations (``torch.profiler.record_function``):
the profiler mirrors a user annotation onto the device's timeline and links
that mirror to the range as one of its kernels, where a reader of the
launched kernels would count it as device time. The names and their
nesting are an interface of the traces (``docs/observability.md``):

- ``repro_torch.step``: a whole ``train_step``;
- ``repro_torch.step.forward``: each call of the loss, one per micro-batch;
- ``repro_torch.step.backward``: each ``torch.autograd.grad`` call;
- ``repro_torch.step.optimizer``: the clip and the update, together;
- ``repro_torch.gc``: a collection, inside whatever range was open.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

PREFIX = "repro_torch."
OFF = contextlib.nullcontext()


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def span(name: str):
    """A profiler range ``repro_torch.<name>`` while a profiler records on
    this thread, else ``OFF``."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _range(name)


class _GcRange:
    """A ``gc.callbacks`` entry: a ``repro_torch.gc`` range from a
    collection's "start" to its "stop". Collections never overlap (the
    interpreter runs one at a time, callbacks included), so one slot holds
    the open range."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info) -> None:
        if phase == "start":
            if torch.autograd._profiler_enabled():
                self.open = _range("gc")
                self.open.__enter__()
        elif self.open is not None:
            rf, self.open = self.open, None
            rf.__exit__(None, None, None)


GC_RANGE = _GcRange()
_INSTALL = threading.Lock()


def install_gc_range() -> None:
    """Adds ``GC_RANGE`` to ``gc.callbacks`` once per process."""
    with _INSTALL:
        if GC_RANGE not in gc.callbacks:
            gc.callbacks.append(GC_RANGE)
