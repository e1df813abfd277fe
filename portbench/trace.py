"""The traced window: which device time went to which kind of work, and the
work those calls had to do.

While a window is traced the program's kernel entry points
(``repro_torch.kernels.ops.flash_attention``, ``ssd_scan``, ``rmsnorm``) are
wrapped from here: each call runs inside a profiler range
``portbench.<kernel>``, and the name of the autograd node its output hangs on
(the node whose range the backward call runs in) is kept. A device kernel
belongs to the innermost recognised range above the op that launched it: a
product op (``work.PRODUCT_OPS``) gives ``gemm``, a ``portbench.<kernel>``
range or its backward node gives that kernel, anything else (PyTorch's
elementwise, reduction and copy kernels) ``other``. So a renamed or
replaced kernel keeps its call's work and its time
(``scripts/profile_torch_train.py`` groups by kernel name instead). Where
the profiler ties no kernel to an op, no kind of work is read.

The work comes from one step counted before the traced window, the same
shapes as every step of it: each kernel call's shapes, and each product
op's shapes under a dispatch mode (the profiler's own records also hold an
``aten::mm`` that checkpoint's early stop aborts before it runs). The trace
itself records no shapes, so that it costs the host little.

The work of a call comes from its shapes (``work.kernel_work``): a forward
call made outside the backward with an output that needs a gradient has one
backward call of the same shapes; a forward call made inside the backward
(the recompute under ``remat="full"``) has none. The SSD backward is counted
without the final state's gradient, which the models never use.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import work

SPAN = "portbench."
KERNELS = ("flash_attention", "ssd_scan", "rmsnorm")
EVAL = "autograd::engine::evaluate_function: "
WINDOW = SPAN + "window"


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def flash_fields(args, kw, grad: bool) -> Dict:
    q, k, v = args[:3]
    causal, prefix = kw.get("causal", True), kw.get("prefix_len", 0)
    if q.dim() == 3:
        q, k, v = q[:, None], k[:, None], v[:, None]
    if not causal or prefix >= k.shape[2]:
        causal, prefix = False, 0
    B, H, Sq, D = q.shape
    return dict(B=B, H=H, KH=k.shape[1], Sq=Sq, Sk=k.shape[2], D=D, Dv=v.shape[3],
                dtype=_dtype(q), causal=bool(causal), prefix_len=prefix, lse=grad)


def ssd_fields(args, kw, grad: bool) -> Dict:
    x, _, Bm = args[:3]
    if x.dim() == 3:
        x, Bm = x[:, :, None], Bm[:, :, None]
    Bsz, S, H, P = x.shape
    return dict(B=Bsz, S=S, H=H, G=Bm.shape[2], P=P, N=Bm.shape[3],
                chunk=min(kw.get("chunk", 128), S), bc_dtype=_dtype(Bm), x_bytes=4,
                dstate=False)


FIELDS: Dict[str, Optional[Callable]] = {"flash_attention": flash_fields,
                                         "ssd_scan": ssd_fields, "rmsnorm": None}


def _custom_node(fn) -> Optional[str]:
    """The nearest autograd node from ``fn`` that a custom Function made
    (its name ends in "Backward", where an aten op's ends in a digit)."""
    seen = 0
    todo = [fn]
    while todo and seen < 8:
        node = todo.pop(0)
        if node is None:
            continue
        seen += 1
        if not node.name()[-1].isdigit():
            return node.name()
        todo.extend(f for f, _ in node.next_functions)
    return None


@dataclass
class Calls:
    """The kernel calls of the traced window."""
    on: bool = False
    work: List[Tuple[str, Dict]] = field(default_factory=list)
    nodes: Dict[str, str] = field(default_factory=dict)

    def record(self, name: str, out, args, kw) -> None:
        first = out[0] if isinstance(out, tuple) else out
        grad = first.grad_fn is not None
        outside = torch._C._current_autograd_node() is None
        if grad and outside:
            node = _custom_node(first.grad_fn)
            if node is not None:
                self.nodes[node] = name
        fields = FIELDS[name]
        if fields is None or not self.on:
            return
        f = fields(args, kw, grad)
        self.work.append((name, f))
        if grad and outside:
            self.work.append((name + "_bwd", f))


@contextlib.contextmanager
def wrapped_kernels(calls: Calls):
    """The program's kernel entry points wrapped for the traced window."""
    from repro_torch.kernels import ops
    originals = {name: getattr(ops, name) for name in KERNELS}

    def wrap(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(SPAN + name):
                out = fn(*args, **kw)
            calls.record(name, out, args, kw)
            return out
        return call

    for name, fn in originals.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


class ProductShapes(TorchDispatchMode):
    """Keeps each product op's name, input shapes and operand type."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, List[List[int]], str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = "aten::" + func._overloadpacket.__name__
        if name in work.PRODUCT_OPS:
            shapes = [list(a.shape) if isinstance(a, torch.Tensor) else [] for a in args]
            self.ops.append((name, shapes, _dtype(args[-1])))
        return out


@dataclass
class TraceData:
    steps: int
    window_s: float
    busy_s: float
    device_s: Dict[str, float]          # device seconds by kind of work
    bound_s: Dict[str, float]           # least seconds of that work
    peak_bytes: int
    unlinked_s: float                   # device seconds no op claimed
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    read_s: float = 0.0                 # seconds the trace took to read


def _classify(op, calls: Calls) -> str:
    while op is not None:
        name = op.name
        if name in work.PRODUCT_OPS:
            return "gemm"
        if name.startswith(SPAN) and name[len(SPAN):] in KERNELS:
            return name[len(SPAN):]
        bare = name[len(EVAL):] if name.startswith(EVAL) else name
        if bare in calls.nodes:
            return calls.nodes[bare]
        op = op.cpu_parent
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _ours(name: str) -> bool:
    """A range of this benchmark's (the profiler also lays it on the device's
    timeline, where it is no kernel)."""
    return name.startswith(SPAN)


def analyse(events, calls: Calls, products, steps: int, peak_bytes: int) -> TraceData:
    """Reads a profiler's events (``prof.events()``) of a traced window of
    ``steps`` steps; ``calls.work`` and ``products`` hold one step's kernel
    calls and product ops."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu_ops = [e for e in events if e.device_type != cuda]
    kernels = [e for e in events if e.device_type == cuda and not _ours(e.name)
               and not getattr(e, "is_user_annotation", False)]
    win = max((e for e in cpu_ops if e.name == WINDOW), key=lambda e: e.time_range.start)
    w0, w1 = win.time_range.start, win.time_range.end
    kernels = [k for k in kernels if k.time_range.end > w0 and k.time_range.start < w1]
    total_us = sum(k.time_range.elapsed_us() for k in kernels)

    device_us: Dict[str, float] = {}
    linked_us = 0.0
    for op in cpu_ops:
        ks = [k for k in getattr(op, "kernels", ()) if not _ours(k.name)]
        if not ks or not (w0 <= op.time_range.start <= w1):
            continue
        us = sum(k.duration for k in ks)
        kind = _classify(op, calls)
        device_us[kind] = device_us.get(kind, 0.0) + us
        linked_us += us
    unlinked_us = max(0.0, total_us - linked_us)
    if linked_us:                               # else no kind of work can be read
        device_us["other"] = device_us.get("other", 0.0) + unlinked_us

    bound: Dict[str, float] = {"gemm": steps * sum(work.product_work(n, sh, dt)[1]
                                                    for n, sh, dt in products)}
    for name, f in calls.work:
        kind = name.replace("_bwd", "")
        bound[kind] = bound.get(kind, 0.0) + steps * work.bound_s(*work.kernel_work(name, f))

    spans = _union([(max(k.time_range.start, w0), min(k.time_range.end, w1)) for k in kernels])
    busy_us = sum(b - a for a, b in spans)
    edges = [w0] + [x for s in spans for x in s] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
                  reverse=True)[:10]
    by_name: Dict[str, float] = {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + k.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(
        steps=steps, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        device_s={k: v / 1e6 for k, v in device_us.items()}, bound_s=bound,
        peak_bytes=peak_bytes, unlinked_s=unlinked_us / 1e6,
        device_ops=[(n, us / 1e6) for n, us in top],
        idle_gaps=[(_host_at(cpu_ops, start + length / 2), length / 1e6)
                   for length, start in gaps if length > 0])


def _host_at(cpu_ops, t: float) -> str:
    """The innermost op the host was in at ``t`` (the window's own range
    left out), or "host (python)" where it was in none."""
    inner = None
    for op in cpu_ops:
        r = op.time_range
        if r.start <= t <= r.end and op.name != WINDOW:
            if inner is None or r.start > inner.time_range.start:
                inner = op
    return inner.name if inner is not None else "host (python)"


def traced_window(step_once: Callable[[int], None], steps: int, device) -> TraceData:
    """Counts one step's work (its kernel calls and, under a dispatch mode,
    its product ops), then runs ``step_once(i)`` for ``steps`` more steps
    under ``torch.profiler`` without shapes, so the trace costs the host
    little, and reads it."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    calls = Calls()
    with wrapped_kernels(calls):
        calls.on = True
        with ProductShapes() as products:
            step_once(0)
        calls.on = False
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(steps):
                    step_once(1 + i)
                if cuda:
                    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t0 = time.perf_counter()
    data = analyse(prof.events(), calls, products.ops, steps, peak)
    data.read_s = time.perf_counter() - t0
    return data
