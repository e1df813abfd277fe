"""COULER unified programming interface (paper §II.B, Appendix A, Table V).

The module-level functions mirror the paper's API:

    run_script / run_container / run_job / run_step
    when / equal / map_ / concurrent / exec_while / dag
    create_parameter_artifact / set_dependencies / run(submitter)

Workflows are built into the engine-agnostic IR; ``run(submitter=...)``
hands the IR to any backend engine (local threaded executor, multi-cluster
scheduler, Argo-YAML generator, Airflow generator). In this JAX adaptation a
"container" payload is a Python/JAX callable; image/command are retained for
the YAML backends.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.ir import Condition, Job, Resources, WorkflowIR

_local = threading.local()


class StepOutput:
    """Handle to a step's output artifact; passing it to another step's args
    creates a data edge (implicit workflow construction, paper code 2)."""

    def __init__(self, job_name: str, artifact: str):
        self.job_name = job_name
        self.artifact = artifact

    def __repr__(self):
        return f"StepOutput({self.job_name}:{self.artifact})"


class StreamOutput(StepOutput):
    """Handle to a *streamed* output artifact (``run_stream``/``map_stream``).

    Behaves as a normal ``StepOutput`` everywhere: a non-streaming consumer
    that receives it sees the fully materialized list of chunks. Passing it
    to ``map_stream`` instead wires the consumer chunk-wise onto the
    producer's ``ArtifactChannel`` so both overlap in time."""

    def __repr__(self):
        return f"StreamOutput({self.job_name}:{self.artifact})"


def _wf() -> WorkflowIR:
    wf = getattr(_local, "wf", None)
    if wf is None:
        wf = WorkflowIR("default")
        _local.wf = wf
    return wf


class workflow:
    """Context manager opening a fresh workflow under construction."""

    def __init__(self, name: str = "workflow", **configs):
        self.ir = WorkflowIR(name, configs)

    def __enter__(self) -> WorkflowIR:
        self._prev = getattr(_local, "wf", None)
        _local.wf = self.ir
        return self.ir

    def __exit__(self, *exc):
        _local.wf = self._prev
        return False


def current_workflow() -> WorkflowIR:
    return _wf()


def _unique(name: str) -> str:
    wf = _wf()
    if name not in wf.jobs:
        return name
    i = 2
    while f"{name}-{i}" in wf.jobs:
        i += 1
    return f"{name}-{i}"


def _add_step(name, fn, args, kwargs, *, kind, image="", command=None,
              resources=None, step_name=None, cacheable=True,
              est_time_s=1.0, est_mem_bytes=1 << 20, retry_limit=3) -> StepOutput:
    wf = _wf()
    name = step_name or name
    if getattr(_local, "in_dag", False) and name in wf.jobs:
        # explicit-DAG merge semantics (paper's diamond): re-invoking a step
        # with the same name references the existing node
        return StepOutput(name, wf.jobs[name].outputs[0])
    name = _unique(name)
    inputs, clean_args = [], []
    for a in (args or ()):
        if isinstance(a, StepOutput):
            inputs.append(a.artifact)
            clean_args.append(a)
        else:
            clean_args.append(a)
    out_art = f"{name}:out"
    job = Job(name=name, fn=fn, args=tuple(clean_args), kwargs=dict(kwargs or {}),
              inputs=inputs, outputs=[out_art], kind=kind, image=image,
              command=list(command or []),
              resources=resources or Resources(), cacheable=cacheable,
              est_time_s=est_time_s, est_mem_bytes=est_mem_bytes,
              retry_limit=retry_limit)
    wf.add_job(job)
    for a in inputs:
        src = a.split(":")[0]
        if src in wf.jobs:
            wf.add_edge(src, name)
    return StepOutput(name, out_art)


# ---------------------------------------------------------------------------
# paper Table V API
# ---------------------------------------------------------------------------

def run_step(fn: Callable, *args, step_name: Optional[str] = None,
             **kw) -> StepOutput:
    """JAX-native step: fn(*args) runs in a worker (our 'pod')."""
    opts = {k: kw.pop(k) for k in ("resources", "cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    return _add_step(step_name or getattr(fn, "__name__", "step"), fn, args,
                     kw, kind="job", step_name=step_name, **opts)


def run_stream(fn: Callable, *args, step_name: Optional[str] = None,
               buffer_chunks: int = 8, **kw) -> StreamOutput:
    """Streaming producer step: ``fn(*args)`` must return an iterable (a
    generator, typically) whose items are the output chunks. Downstream
    ``map_stream`` consumers start as soon as the first chunk is emitted;
    any other consumer sees the materialized list of chunks."""
    opts = {k: kw.pop(k) for k in ("resources", "cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    out = _add_step(step_name or getattr(fn, "__name__", "stream"), fn, args,
                    kw, kind="job", step_name=step_name, **opts)
    job = _wf().jobs[out.job_name]
    job.stream_output = True
    job.stream_buffer_chunks = buffer_chunks
    return StreamOutput(out.job_name, out.artifact)


def map_stream(fn: Callable[[Any], Any], source: StepOutput, *args,
               step_name: Optional[str] = None, buffer_chunks: int = 8,
               **kw) -> StreamOutput:
    """Chunk-wise consumer: applies ``fn(chunk, *args)`` to each chunk of
    ``source`` as it arrives, emitting its own streamed output (so stages
    chain into a pipeline). If ``source`` is not streamed (or its producer
    already finished), the materialized value is iterated instead — same
    results, no overlap."""
    opts = {k: kw.pop(k) for k in ("resources", "cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    out = _add_step(step_name or getattr(fn, "__name__", "map_stream"), fn,
                    (source,) + args, kw, kind="job", step_name=step_name,
                    **opts)
    job = _wf().jobs[out.job_name]
    job.stream_input = True
    job.stream_arg = source.artifact
    job.stream_output = True
    job.stream_buffer_chunks = buffer_chunks
    return StreamOutput(out.job_name, out.artifact)


def run_script(image: str = "", source: Optional[Callable] = None,
               step_name: Optional[str] = None, **kw) -> StepOutput:
    opts = {k: kw.pop(k) for k in ("resources", "cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    return _add_step(step_name or getattr(source, "__name__", "script"),
                     source, (), kw, kind="script", image=image,
                     step_name=step_name, **opts)


def run_container(image: str, command: Sequence[str] = (),
                  args: Sequence[Any] = (), step_name: Optional[str] = None,
                  fn: Optional[Callable] = None, output: Any = None,
                  **kw) -> StepOutput:
    opts = {k: kw.pop(k) for k in ("resources", "cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    return _add_step(step_name or "container", fn, tuple(args), kw,
                     kind="container", image=image, command=command,
                     step_name=step_name, **opts)


def run_job(fn: Callable, *args, num_workers: int = 1,
            step_name: Optional[str] = None, **kw) -> StepOutput:
    """Distributed job (maps to a multi-worker pod group)."""
    res = kw.pop("resources", Resources(cpu=float(num_workers)))
    return _add_step(step_name or getattr(fn, "__name__", "job"), fn, args,
                     kw, kind="job", resources=res, step_name=step_name)


def add_job(fn: Callable, *args, num_workers: int = 1,
            checkpoint: Optional[str] = None,
            step_name: Optional[str] = None, **kw) -> StepOutput:
    """Long (training-shaped) job with optional checkpoint-resume.

    With ``checkpoint=dir`` the step is checkpoint-wired: ``fn`` is
    called with an extra ``ckpt=`` keyword — a
    ``repro.training.checkpoint.StepCheckpointSession`` whose
    ``latest_step()`` / ``restore()`` / ``save(step, state)`` persist
    progress under ``dir`` — so a mid-step worker loss resumes from the
    latest checkpoint instead of the step's start (the engine retries the
    step, and the fn finds its own saved progress). Checkpoint-wired
    steps never speculate (two racers would share one directory).
    """
    res = kw.pop("resources", Resources(cpu=float(num_workers)))
    opts = {k: kw.pop(k) for k in ("cacheable", "est_time_s",
                                   "est_mem_bytes", "retry_limit")
            if k in kw}
    out = _add_step(step_name or getattr(fn, "__name__", "job"), fn, args,
                    kw, kind="job", resources=res, step_name=step_name,
                    **opts)
    if checkpoint:
        _wf().jobs[out.job_name].checkpoint = str(checkpoint)
    return out


def equal(a, b=None) -> Condition:
    if isinstance(a, StepOutput):
        return Condition("equal", a.artifact, b)
    return Condition("equal", str(a), b)


def not_equal(a, b=None) -> Condition:
    c = equal(a, b)
    return Condition("not_equal", c.artifact, c.value)


def when(cond: Condition, then: Callable[[], StepOutput]) -> StepOutput:
    """Conditional step (paper code 3): `then()` runs iff cond holds.

    The condition's artifact must already have a producing step —
    a missing producer raises here (CLR003) instead of silently
    evaluating the predicate over ``None`` mid-run."""
    out = then()
    wf = _wf()
    job = wf.jobs[out.job_name]
    job.condition = cond
    wf.check_condition_producers(job)
    src = cond.artifact.split(":")[0]
    if src in wf.jobs and src != out.job_name:
        wf.add_edge(src, out.job_name)
    return out


def exec_while(cond: Condition, body: Callable[[], StepOutput],
               max_iterations: int = 16) -> StepOutput:
    """Recursive step (paper code 5): re-run body while cond holds.

    Like ``when``, the loop condition is validated eagerly (CLR003);
    conditioning on the body step's own output is the normal case."""
    out = body()
    wf = _wf()
    job = wf.jobs[out.job_name]
    job.loop_condition = cond
    job.max_iterations = max_iterations
    wf.check_condition_producers(job)
    return out


def map_(fn: Callable[[Any], StepOutput], items: Sequence[Any]) -> List[StepOutput]:
    """Start one instance of fn per item (paper couler.map, code 6)."""
    return [fn(x) for x in items]


# keep the paper's exact name available too
map = map_  # noqa: A001


def concurrent(fns: Sequence[Callable[[], Any]]) -> List[Any]:
    """Run several steps with no edges between them (paper code 7)."""
    return [f() for f in fns]


def dag(chains: Sequence[Sequence[Callable[[], StepOutput]]]) -> None:
    """Explicit DAG definition (paper §II.B code 1): each chain is a list of
    thunks; consecutive thunks get dependency edges. Thunks naming an
    existing step (same step_name) are merged — the diamond example."""
    wf = _wf()
    _local.in_dag = True
    try:
        for chain in chains:
            prev: Optional[str] = None
            for thunk in chain:
                before = set(wf.jobs)
                out = thunk()
                name = out.job_name if isinstance(out, StepOutput) else None
                if name is None:
                    new = set(wf.jobs) - before
                    name = next(iter(new)) if new else None
                if prev is not None and name is not None and prev != name:
                    wf.add_edge(prev, name)
                prev = name
    finally:
        _local.in_dag = False


def set_dependencies(step: StepOutput, depends_on: Sequence[StepOutput]) -> None:
    for d in depends_on:
        _wf().add_edge(d.job_name, step.job_name)


def create_parameter_artifact(path: str = "", is_global: bool = False):
    class _Art:
        def __init__(self, p):
            self.path = p
    return _Art(path)


def lint(workflow_ir: Optional[WorkflowIR] = None, *, engine=None,
         clusters=None, max_inflight_steps: Optional[int] = None):
    """Statically analyze a workflow (the current one by default).

    Returns a ``repro_torch.core.analysis.LintResult`` of typed ``CLR0xx``
    diagnostics — cycles, orphans, conditions on unproduced artifacts,
    streaming misuse, unschedulable resource requests, nondeterministic
    cacheable steps (see ``docs/diagnostics.md``). Engines run the same
    passes automatically at submit time (``lint="error"|"warn"|"off"``).
    """
    from repro_torch.core.analysis import lint as _lint
    return _lint(workflow_ir or _wf(), engine=engine, clusters=clusters,
                 max_inflight_steps=max_inflight_steps)


def run(submitter=None, workflow_ir: Optional[WorkflowIR] = None,
        optimize: bool = True, **kw):
    """Submit the current workflow to an engine (paper §II.F)."""
    wf = workflow_ir or _wf()
    wf.validate()
    if submitter is None:
        # throwaway engine: release its gateway loop + worker pool after
        # the run instead of leaking one thread set per couler.run() call
        from repro_torch.core.engines.local import LocalEngine
        submitter = LocalEngine()
        try:
            return submitter.submit(wf, optimize=optimize, **kw)
        finally:
            submitter.close()
    return submitter.submit(wf, optimize=optimize, **kw)


async def run_async(submitter=None, workflow_ir: Optional[WorkflowIR] = None,
                    optimize: bool = True, tenant: str = "default",
                    priority: int = 0, **kw):
    """Submit the current workflow through the async gateway path.

    Returns an ``AsyncWorkflowRun``: ``await`` it for the finished
    ``WorkflowRun``, iterate ``.events()`` for typed lifecycle events, or
    ``.cancel()`` for cooperative cancellation. Admission is backpressured
    per tenant — a full queue raises ``gateway.QueueFull`` (shed load)."""
    wf = workflow_ir or _wf()
    wf.validate()
    if submitter is None:
        from repro_torch.core.engines.local import LocalEngine
        submitter = LocalEngine()
        handle = await submitter.submit_async(wf, optimize=optimize,
                                              tenant=tenant,
                                              priority=priority, **kw)
        # throwaway engine: tear its gateway down once the run finishes
        # (the callback fires on the gateway loop; stop() self-schedules)
        handle._result.add_done_callback(lambda _f: submitter.close())
        return handle
    return await submitter.submit_async(wf, optimize=optimize, tenant=tenant,
                                        priority=priority, **kw)


async def stream(submitter=None, workflow_ir: Optional[WorkflowIR] = None,
                 optimize: bool = True, tenant: str = "default",
                 priority: int = 0, **kw):
    """Async generator of gateway lifecycle events for the current
    workflow: yields ``WorkflowEvent``s in order, ending with the single
    terminal ``WORKFLOW_DONE`` (see ``repro_torch.core.gateway`` for the
    taxonomy)."""
    handle = await run_async(submitter=submitter, workflow_ir=workflow_ir,
                             optimize=optimize, tenant=tenant,
                             priority=priority, **kw)
    async for ev in handle.events():
        yield ev


def observe(engine, collector=None):
    """Attach an observability collector to ``engine`` (span trees +
    ``run.report()`` critical-path breakdowns for every subsequent run).
    Returns the ``ObsCollector``; see ``repro_torch.core.obs``."""
    from repro_torch.core import obs
    return obs.observe(engine, collector)


def telemetry(engine, interval_s: float = 0.25, anomaly=None, slos=None,
              path=None):
    """Turn on continuous fleet telemetry on ``engine``'s gateway: a
    ``TimeSeriesDB`` sampled every ``interval_s`` seconds, streaming
    anomaly detection (``anomaly`` — an ``AnomalyMonitor``; one with the
    default detectors is created when None), and optional per-tenant SLO
    burn-rate alerting (``slos`` — an ``SLOMonitor`` or an iterable of
    ``SLO`` objectives). JSONL persistence when ``path`` is given.
    Returns ``(tsdb, anomaly_monitor, slo_monitor)``; see
    ``docs/observability.md``."""
    from repro_torch.core.obs.anomaly import AnomalyMonitor
    from repro_torch.core.obs.slo import SLOMonitor
    gw = getattr(engine, "gateway", None)
    if gw is None or not hasattr(gw, "start_telemetry"):
        raise TypeError(
            f"engine {type(engine).__name__} has no gateway — nothing to "
            "sample (MultiClusterEngine: use attach_telemetry instead)")
    if anomaly is None:
        anomaly = AnomalyMonitor()
    slo_mon = None
    if slos is not None:
        slo_mon = slos if isinstance(slos, SLOMonitor) else SLOMonitor(slos)
    return gw.start_telemetry(interval_s=interval_s, anomaly=anomaly,
                              slo=slo_mon, path=path)


def reset() -> None:
    _local.wf = WorkflowIR("default")
