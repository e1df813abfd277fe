"""Span derivation from the gateway's typed event stream.

``ObsCollector`` subscribes to each run's publish path (the same
single-hook slot the ``TraceChecker`` sanitizer uses — handles now fan
out to any number of observers) and folds the ordered event stream into a
**span tree** per run:

* one workflow span (``WORKFLOW_ADMITTED`` → ``WORKFLOW_DONE``), carrying
  workflow-scope segments — ``readmission-backoff`` windows opened by
  ``WORKFLOW_REQUEUED`` and closed by the next event of the new epoch;
* one step span per ``STEP_STARTED`` → terminal pair, subdivided into
  segments: ``retry`` (attempt start → ``STEP_RETRY``, cause
  ``STEP_RETRY`` or ``WORKER_LOST``), ``compute`` (last attempt →
  terminal), ``cache-fetch`` (span of a ``STEP_CACHED`` terminal),
  ``skipped``, and a synthetic duration-only ``stream-stall`` segment fed
  by the producer's channel backpressure accounting;
* ``queue-wait`` segments derived at finalize time from the DAG: a step's
  ready instant is the max of its predecessors' terminal timestamps and
  its epoch start — the gap to ``STEP_STARTED`` is time spent waiting on
  the admission pump / in-flight-steps semaphore.

The derivation honours the taxonomy's cancel-scoping exception: a step
cancelled mid-stream reverts to ``Pending`` with no terminal event, so
its span is closed as ``Reverted`` when the workflow's ``WORKFLOW_DONE``
arrives — ``open_run_ids`` is the leak check (empty once every observed
run finished).

Exports: ``export_jsonl`` (one span-tree object per line, loadable with
``load_jsonl`` for offline reports) and ``export_chrome`` (Chrome
trace-event JSON, loadable in Perfetto / ``chrome://tracing``;
``validate_chrome_trace`` is the schema check the test suite pins).
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.gateway.events import EventType, WorkflowEvent
from repro_torch.core.obs.metrics import MetricsRegistry

__all__ = ["Segment", "StepSpan", "SpanTree", "ObsCollector",
           "chrome_trace", "validate_chrome_trace", "load_jsonl"]

#: step terminal statuses that satisfy successors
SATISFIED = ("Succeeded", "Cached", "Skipped")

#: segment taxonomy (docs/observability.md)
SEGMENT_KINDS = ("queue-wait", "cache-fetch", "compute", "retry",
                 "readmission-backoff", "stream-stall", "skipped",
                 "overhead")


@dataclass
class Segment:
    """One attributed slice of a span. ``synthetic`` marks duration-only
    segments (``stream-stall``) that overlap real timeline slices and are
    therefore excluded from makespan partitioning."""

    kind: str
    start: float
    end: float
    cause: str = ""
    synthetic: bool = False

    @property
    def dur(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "start": self.start, "end": self.end}
        if self.cause:
            d["cause"] = self.cause
        if self.synthetic:
            d["synthetic"] = True
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Segment":
        return cls(kind=d["kind"], start=d["start"], end=d["end"],
                   cause=d.get("cause", ""),
                   synthetic=bool(d.get("synthetic")))


@dataclass
class StepSpan:
    step: str
    epoch: int
    start: float
    end: Optional[float] = None
    status: str = "Running"
    attempts: int = 1
    chunks: int = 0
    segments: List[Segment] = field(default_factory=list)
    annotations: Dict[str, Any] = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.end is not None

    @property
    def dur(self) -> float:
        return max(0.0, (self.end or self.start) - self.start)

    def seg_total(self, kind: str) -> float:
        return sum(s.dur for s in self.segments if s.kind == kind)

    def to_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "epoch": self.epoch, "start": self.start,
                "end": self.end, "status": self.status,
                "attempts": self.attempts, "chunks": self.chunks,
                "segments": [s.to_dict() for s in self.segments],
                "annotations": self.annotations}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StepSpan":
        return cls(step=d["step"], epoch=d.get("epoch", 0),
                   start=d["start"], end=d.get("end"),
                   status=d.get("status", "Running"),
                   attempts=d.get("attempts", 1), chunks=d.get("chunks", 0),
                   segments=[Segment.from_dict(s)
                             for s in d.get("segments", ())],
                   annotations=dict(d.get("annotations", {})))


class SpanTree:
    """One finalized run: workflow span + ordered step spans + the DAG
    edges needed to attribute the critical path offline.

    A ``__slots__`` class (not a dataclass): one tree is built per run on
    the collector hot path, and the generated-``__init__`` +
    ``default_factory`` overhead is measurable at bench scale.

    Fields: ``steps`` — ordered step spans; ``segments`` —
    workflow-scope segments (readmission-backoff windows); ``causes`` —
    annotated causes in arrival order (STEP_RETRY / WORKER_LOST /
    CLUSTER_PREEMPTED / WORKFLOW_REQUEUED).
    """

    __slots__ = ("workflow", "run_id", "tenant", "start", "end", "status",
                 "steps", "segments", "causes", "edges", "counts",
                 "events_total")

    def __init__(self, workflow: str, run_id: str, tenant: str = "default",
                 start: float = 0.0, end: float = 0.0,
                 status: str = "Running",
                 steps: Optional[List[StepSpan]] = None,
                 segments: Optional[List[Segment]] = None,
                 causes: Optional[List[Dict[str, Any]]] = None,
                 edges: Optional[List[Tuple[str, str]]] = None,
                 counts: Optional[Dict[str, int]] = None,
                 events_total: int = 0):
        self.workflow = workflow
        self.run_id = run_id
        self.tenant = tenant
        self.start = start
        self.end = end
        self.status = status
        self.steps = steps if steps is not None else []
        self.segments = segments if segments is not None else []
        self.causes = causes if causes is not None else []
        self.edges = edges if edges is not None else []
        self.counts = counts if counts is not None else {}
        self.events_total = events_total

    @property
    def makespan_s(self) -> float:
        return max(0.0, self.end - self.start)

    def latest_spans(self) -> Dict[str, StepSpan]:
        """Latest closed span per step (re-run steps keep every span in
        ``steps``; attribution wants the one that finally counted)."""
        out: Dict[str, StepSpan] = {}
        for sp in self.steps:
            if not sp.closed:
                continue
            cur = out.get(sp.step)
            if cur is None or sp.end >= cur.end:
                out[sp.step] = sp
        return out

    def seg_total(self, kind: str) -> float:
        tot = sum(s.dur for s in self.segments if s.kind == kind)
        for sp in self.steps:
            tot += sp.seg_total(kind)
        return tot

    @property
    def retry_segments(self) -> List[Tuple[Segment, str]]:
        """Every retry segment paired with its step name, in span order —
        the chaos tests compare this 1:1 against the STEP_RETRY events."""
        return [(s, sp.step) for sp in self.steps
                for s in sp.segments if s.kind == "retry"]

    def to_dict(self) -> Dict[str, Any]:
        return {"workflow": self.workflow, "run_id": self.run_id,
                "tenant": self.tenant, "start": self.start, "end": self.end,
                "status": self.status,
                "steps": [s.to_dict() for s in self.steps],
                "segments": [s.to_dict() for s in self.segments],
                "causes": self.causes,
                "edges": [list(e) for e in self.edges],
                "counts": self.counts, "events_total": self.events_total}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpanTree":
        return cls(workflow=d["workflow"], run_id=d["run_id"],
                   tenant=d.get("tenant", "default"),
                   start=d.get("start", 0.0), end=d.get("end", 0.0),
                   status=d.get("status", "Running"),
                   steps=[StepSpan.from_dict(s) for s in d.get("steps", ())],
                   segments=[Segment.from_dict(s)
                             for s in d.get("segments", ())],
                   causes=list(d.get("causes", ())),
                   edges=[tuple(e) for e in d.get("edges", ())],
                   counts=dict(d.get("counts", {})),
                   events_total=d.get("events_total", 0))


class _RunBuilder:
    """Mutable per-run accumulator; becomes a ``SpanTree`` at
    ``WORKFLOW_DONE``. Mutated only under the collector lock."""

    __slots__ = ("tree", "open_spans", "epoch", "epoch_starts",
                 "open_backoff", "pending_cause", "saw_admitted")

    def __init__(self, workflow: str, run_id: str, tenant: str,
                 edges: List[Tuple[str, str]]):
        self.tree = SpanTree(workflow=workflow, run_id=run_id, tenant=tenant,
                             edges=edges)
        self.open_spans: Dict[str, StepSpan] = {}
        self.epoch = 0
        self.epoch_starts: List[float] = []
        self.open_backoff: Optional[Segment] = None
        self.pending_cause: Dict[str, str] = {}   # step -> WORKER_LOST etc.
        self.saw_admitted = False


_FINAL_SEGMENT = {EventType.STEP_SUCCEEDED: "compute",
                  EventType.STEP_FAILED: "compute",
                  EventType.STEP_CACHED: "cache-fetch",
                  EventType.STEP_SKIPPED: "skipped"}

# enum .name is a DynamicClassAttribute (a function call per access);
# resolved once here — _apply runs per event on the publish path
_TYPE_NAME = {et: et.name for et in EventType}


class ObsCollector:
    """Derives span trees from run event streams; thread-safe.

    Attach via ``couler.observe(engine)`` (every subsequent run is
    registered by the gateway) or feed a recorded stream directly with
    ``ingest``. Finished trees are kept in an LRU of ``max_runs``;
    ``report(run_id)`` runs the critical-path attribution
    (``repro_torch.core.obs.attribution``) over a finished tree.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_runs: int = 256):
        self.registry = registry or MetricsRegistry("obs")
        self.max_runs = max_runs
        # plain Lock (cheaper acquire than RLock) — no method here calls
        # back into another locked method while holding it
        self._lock = threading.Lock()
        self._open: Dict[str, _RunBuilder] = {}
        self._done: "OrderedDict[str, SpanTree]" = OrderedDict()
        self._anomalies = self.registry.counter("obs_stream_anomalies_total")
        # hot-path instruments, pre-resolved once: the per-event registry
        # lookup (label sort + lock) dominated ingest cost at n=2000
        reg = self.registry
        self._m_event = {et: reg.counter("obs_events_total", type=et.name)
                         for et in EventType}
        self._m_retries = reg.counter("obs_retries_total")
        self._m_chunks = reg.counter("obs_chunks_total")
        self._m_readmissions = reg.counter("obs_readmissions_total")
        self._m_alerts = reg.counter("obs_alerts_total")
        self._m_step_status: Dict[str, Any] = {}
        self._m_run_status: Dict[str, Any] = {}
        self._h_step_dur = reg.histogram("obs_step_duration_s")
        self._h_queue_wait = reg.histogram("obs_step_queue_wait_s")
        self._h_makespan = reg.histogram("obs_run_makespan_s")

    def _step_status_counter(self, status: str):
        c = self._m_step_status.get(status)
        if c is None:
            c = self.registry.counter("obs_steps_total", status=status)
            self._m_step_status[status] = c
        return c

    # -- registration ------------------------------------------------------
    def register_run(self, run_id: str, wf=None, tenant: str = "default",
                     workflow: str = "") -> None:
        """Start (or restart — resume/readmission re-submission) the
        builder for ``run_id``. The DAG edges are copied now (elements are
        already immutable ``(src, dst)`` tuples per the IR contract) so
        offline reports never depend on the workflow object staying
        alive."""
        edges = list(getattr(wf, "edges", ()))
        name = workflow or getattr(wf, "name", "") or run_id
        with self._lock:
            prev = self._open.pop(run_id, None)
            if prev is not None:
                # a re-registered unfinished stream replaces the old one;
                # count it so leak hunts notice silent restarts
                self._anomalies.inc()
            self._open[run_id] = _RunBuilder(name, run_id, tenant, edges)

    def ingest(self, events: Iterable[WorkflowEvent], wf=None,
               run_id: str = "", tenant: str = "default") -> Optional[str]:
        """Feed a recorded event stream (e.g. ``handle.events_so_far()``
        from a backend without a live publish hook). Returns the run id
        the stream was registered under."""
        if type(events) is not list:
            events = list(events)
        if not events:
            return None
        rid = run_id or events[0].run_id or "anon"
        name = (getattr(wf, "name", "") or events[0].workflow or rid)
        edges = list(getattr(wf, "edges", ()))
        batch_counts: Dict[Any, int] = {}
        apply_, type_name = self._apply, _TYPE_NAME
        with self._lock:                   # one acquire for the batch
            if self._open.pop(rid, None) is not None:
                self._anomalies.inc()      # silent restart — see register_run
            b = _RunBuilder(name, rid, tenant, edges)
            self._open[rid] = b
            for ev in events:
                batch_counts[ev.type] = batch_counts.get(ev.type, 0) + 1
                apply_(b, ev)
            # per-type totals folded into the tree once, not per event
            t, n_total = b.tree, 0
            for et, n in batch_counts.items():
                tname = type_name[et]
                t.counts[tname] = t.counts.get(tname, 0) + n
                n_total += n
            t.events_total += n_total
        for et, n in batch_counts.items():  # one inc per type, not per event
            self._m_event[et].inc(n)
        return rid

    # -- live observation --------------------------------------------------
    def observe(self, ev: WorkflowEvent) -> None:
        """Publish-path hook (``AsyncWorkflowRun.add_observer``); called
        under the handle's publish lock, so events of one run arrive in
        seq order. Never raises into the publish path."""
        self._observe_for(ev.run_id or "anon", ev)

    def _observe_for(self, run_id: str, ev: WorkflowEvent) -> None:
        with self._lock:
            b = self._open.get(run_id)
            if b is None:
                # stream started before the collector attached (coarse
                # backends): synthesize a builder from what the event has
                b = _RunBuilder(ev.workflow or run_id, run_id, ev.tenant, [])
                self._open[run_id] = b
            self._m_event[ev.type].inc()
            t, tname = b.tree, _TYPE_NAME[ev.type]
            t.events_total += 1
            t.counts[tname] = t.counts.get(tname, 0) + 1
            self._apply(b, ev)

    def _apply(self, b: _RunBuilder, ev: WorkflowEvent) -> None:
        # NOTE: per-type counts / events_total are folded in by the two
        # callers (batched in ``ingest``, per event in ``_observe_for``)
        t = b.tree
        if t.start == 0.0:
            t.start = ev.ts
        if b.open_backoff is not None and ev.type not in (
                EventType.WORKFLOW_REQUEUED, EventType.ALERT):
            # ALERT is advisory (a readmission-storm alert lands right
            # after WORKFLOW_REQUEUED) — it must not close the window
            # first event of the new epoch closes the backoff window
            b.open_backoff.end = ev.ts
            b.open_backoff = None
            if b.epoch >= len(b.epoch_starts):
                b.epoch_starts.append(ev.ts)
        et = ev.type
        if et is EventType.WORKFLOW_ADMITTED:
            b.saw_admitted = True
            if not b.epoch_starts:
                b.epoch_starts.append(ev.ts)
        elif et is EventType.WORKFLOW_DONE:
            # checked early: every stream ends with one, and coarse
            # (admit/done only) streams are the high-volume ingest case
            t.end = ev.ts
            t.status = ev.status or "Succeeded"
            if ev.error:
                t.causes.append({"type": "WORKFLOW_DONE", "ts": ev.ts,
                                 "error": ev.error})
            # cancel-scoping exception: mid-stream cancelled steps revert
            # to Pending with no terminal event — close them here
            if b.open_spans:
                self._close_open(b, ev.ts, "Reverted", "WORKFLOW_DONE")
            self._finalize(b)
        elif et is EventType.STEP_STARTED:
            if ev.step in b.open_spans:
                self._anomalies.inc()
            b.open_spans[ev.step] = StepSpan(
                step=ev.step, epoch=b.epoch, start=ev.ts,
                attempts=max(1, ev.attempt + 1))
        elif et is EventType.WORKER_LOST:
            b.pending_cause[ev.step] = "WORKER_LOST"
            t.causes.append({"type": "WORKER_LOST", "step": ev.step,
                             "attempt": ev.attempt, "ts": ev.ts,
                             "error": ev.error})
        elif et is EventType.STEP_RETRY:
            sp = b.open_spans.get(ev.step)
            cause = b.pending_cause.pop(ev.step, "STEP_RETRY")
            t.causes.append({"type": "STEP_RETRY", "step": ev.step,
                             "attempt": ev.attempt, "ts": ev.ts,
                             "cause": cause, "error": ev.error})
            self._m_retries.inc()
            if sp is None:
                self._anomalies.inc()
            else:
                boundary = sp.segments[-1].end if sp.segments else sp.start
                sp.segments.append(Segment("retry", boundary, ev.ts,
                                           cause=cause))
                sp.attempts += 1
        elif et is EventType.STEP_STREAMING:
            sp = b.open_spans.get(ev.step)
            if sp is not None:
                sp.annotations["streaming_ts"] = ev.ts
        elif et is EventType.STEP_CHUNK:
            self._m_chunks.inc()
            sp = b.open_spans.get(ev.step)
            if sp is not None:
                sp.chunks += 1
                sp.annotations["last_chunk_ts"] = ev.ts
        elif et in _FINAL_SEGMENT:
            sp = b.open_spans.pop(ev.step, None)
            b.pending_cause.pop(ev.step, None)
            if sp is None:
                self._anomalies.inc()
                return
            sp.end = ev.ts
            sp.status = ev.status or et.name.replace("STEP_", "").title()
            if ev.error:
                sp.annotations["error"] = ev.error
            boundary = sp.segments[-1].end if sp.segments else sp.start
            sp.segments.append(Segment(_FINAL_SEGMENT[et], boundary, ev.ts,
                                       cause=ev.error if et is
                                       EventType.STEP_FAILED else ""))
            t.steps.append(sp)
            self._step_status_counter(sp.status).inc()
            self._h_step_dur.observe(sp.dur)
        elif et is EventType.CLUSTER_PREEMPTED:
            t.causes.append({"type": "CLUSTER_PREEMPTED", "step": ev.step,
                             "attempt": ev.attempt, "ts": ev.ts,
                             "error": ev.error})
        elif et is EventType.WORKFLOW_REQUEUED:
            t.causes.append({"type": "WORKFLOW_REQUEUED",
                             "attempt": ev.attempt, "ts": ev.ts,
                             "error": ev.error})
            self._m_readmissions.inc()
            # steps still open at requeue were reverted by the failure
            if b.open_spans:
                self._close_open(b, ev.ts, "Reverted", "WORKFLOW_REQUEUED")
            b.epoch += 1
            seg = Segment("readmission-backoff", ev.ts, ev.ts,
                          cause="WORKFLOW_REQUEUED")
            t.segments.append(seg)
            b.open_backoff = seg
        elif et is EventType.ALERT:
            t.causes.append({"type": "ALERT", "detector": ev.status,
                             "step": ev.step, "ts": ev.ts,
                             "error": ev.error})
            self._m_alerts.inc()

    def _close_open(self, b: _RunBuilder, ts: float, status: str,
                    cause: str) -> None:
        for step, sp in list(b.open_spans.items()):
            sp.end = ts
            sp.status = status
            boundary = sp.segments[-1].end if sp.segments else sp.start
            sp.segments.append(Segment("compute", boundary, ts, cause=cause))
            b.tree.steps.append(sp)
            self._step_status_counter(status).inc()
        b.open_spans.clear()

    # -- finalize: DAG-derived queue-wait + bookkeeping --------------------
    def _finalize(self, b: _RunBuilder) -> None:
        t = b.tree
        if t.steps:                   # coarse streams: nothing to wait on
            preds: Dict[str, List[str]] = {}
            for src, dst in t.edges:
                preds.setdefault(dst, []).append(src)
            # latest SATISFYING terminal per step gates successors; epoch
            # starts bound readiness for steps re-run after a requeue
            done_at: Dict[str, float] = {}
            for sp in t.steps:
                if sp.status in SATISFIED:
                    done_at[sp.step] = max(done_at.get(sp.step, 0.0), sp.end)
            qw_hist = self._h_queue_wait
            for sp in t.steps:
                epoch_start = (b.epoch_starts[sp.epoch]
                               if sp.epoch < len(b.epoch_starts) else t.start)
                ready = max([epoch_start] +
                            [done_at[p] for p in preds.get(sp.step, ())
                             if p in done_at and done_at[p] <= sp.start])
                ready = min(ready, sp.start)
                if sp.start > ready:
                    sp.segments.insert(0, Segment("queue-wait", ready,
                                                  sp.start))
                qw_hist.observe(max(0.0, sp.start - ready))
        c = self._m_run_status.get(t.status)
        if c is None:
            c = self.registry.counter("obs_runs_total", status=t.status)
            self._m_run_status[t.status] = c
        c.inc()
        self._h_makespan.observe(t.end - t.start if t.end > t.start else 0.0)
        rid, done = t.run_id, self._done
        self._open.pop(rid, None)
        refresh = rid in done              # re-finalized: bump LRU recency
        done[rid] = t                      # fresh keys insert at the end
        if refresh:
            done.move_to_end(rid)
        while len(done) > self.max_runs:
            done.popitem(last=False)

    # -- post-hoc annotation (gateway channel accounting) ------------------
    def annotate_step(self, run_id: str, step: str,
                      stream_stall_s: float = 0.0,
                      **attrs: Any) -> None:
        """Attach channel-level measurements to a step's span (producer
        backpressure stalls are not observable from events alone). Works
        on open or finished runs; stalls become a synthetic duration-only
        ``stream-stall`` segment."""
        with self._lock:
            spans: List[StepSpan] = []
            b = self._open.get(run_id)
            if b is not None:
                sp = b.open_spans.get(step)
                if sp is not None:
                    spans.append(sp)
                spans += [s for s in b.tree.steps if s.step == step]
            t = self._done.get(run_id)
            if t is not None:
                spans += [s for s in t.steps if s.step == step]
            if not spans:
                return
            sp = spans[-1]
            sp.annotations.update(attrs)
            if stream_stall_s > 0:
                end = sp.end if sp.end is not None else sp.start
                sp.segments.append(Segment(
                    "stream-stall", end - stream_stall_s, end,
                    cause="backpressure", synthetic=True))
                sp.annotations["stream_stall_s"] = stream_stall_s

    # -- introspection -----------------------------------------------------
    @property
    def open_run_ids(self) -> List[str]:
        with self._lock:
            return list(self._open)

    def tree(self, run_id: str) -> Optional[SpanTree]:
        with self._lock:
            return self._done.get(run_id)

    def trees(self) -> List[SpanTree]:
        with self._lock:
            return list(self._done.values())

    def report(self, run_id: str):
        """Critical-path makespan breakdown for a finished run."""
        t = self.tree(run_id)
        if t is None:
            raise RuntimeError(
                f"run {run_id!r} has no finished span tree (still "
                "running, never observed, or rotated out of the LRU)")
        from repro_torch.core.obs.attribution import build_report
        return build_report(t)

    # -- export ------------------------------------------------------------
    def export_jsonl(self, path: Optional[str] = None,
                     run_id: Optional[str] = None) -> str:
        trees = [self.tree(run_id)] if run_id else self.trees()
        lines = [json.dumps(t.to_dict(), sort_keys=True)
                 for t in trees if t is not None]
        text = "\n".join(lines) + ("\n" if lines else "")
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def export_chrome(self, run_id: Optional[str] = None) -> Dict[str, Any]:
        trees = [self.tree(run_id)] if run_id else self.trees()
        return chrome_trace([t for t in trees if t is not None])


def load_jsonl(text: str) -> List[SpanTree]:
    """Inverse of ``export_jsonl`` (accepts the text or a file's
    contents); blank lines are skipped."""
    return [SpanTree.from_dict(json.loads(line))
            for line in text.splitlines() if line.strip()]


# -- Chrome trace-event export ---------------------------------------------

def chrome_trace(trees: List[SpanTree]) -> Dict[str, Any]:
    """Render span trees as Chrome trace-event JSON (the ``traceEvents``
    object form Perfetto and ``chrome://tracing`` load). One process per
    run, thread 0 is the workflow lane, one thread per step; every
    segment is a complete ("X") slice with its cause in ``args``.
    Timestamps are microseconds relative to the earliest run start."""
    events: List[Dict[str, Any]] = []
    t0 = min((t.start for t in trees if t.start), default=0.0)

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    for pid, t in enumerate(trees, start=1):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"{t.workflow} run {t.run_id}"}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "thread_name",
                       "args": {"name": "workflow"}})
        events.append({"ph": "X", "pid": pid, "tid": 0,
                       "name": f"workflow:{t.status}", "cat": "workflow",
                       "ts": us(t.start),
                       "dur": max(0.0, round(t.makespan_s * 1e6, 1)),
                       "args": {"run_id": t.run_id, "tenant": t.tenant,
                                "status": t.status,
                                "events": t.events_total}})
        for seg in t.segments:
            events.append({"ph": "X", "pid": pid, "tid": 0,
                           "name": seg.kind, "cat": seg.kind,
                           "ts": us(seg.start),
                           "dur": max(0.0, round(seg.dur * 1e6, 1)),
                           "args": {"cause": seg.cause}})
        tids = {s: i for i, s in enumerate(
            sorted({sp.step for sp in t.steps}), start=1)}
        for step, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": step}})
        for sp in t.steps:
            tid = tids[sp.step]
            args = {"status": sp.status, "attempts": sp.attempts,
                    "epoch": sp.epoch}
            if sp.chunks:
                args["chunks"] = sp.chunks
            args.update({k: v for k, v in sp.annotations.items()
                         if isinstance(v, (str, int, float, bool))})
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "name": f"{sp.step}:{sp.status}", "cat": "step",
                           "ts": us(sp.start),
                           "dur": max(0.0, round(sp.dur * 1e6, 1)),
                           "args": args})
            for seg in sp.segments:
                events.append({"ph": "X", "pid": pid, "tid": tid,
                               "name": seg.kind, "cat": seg.kind,
                               "ts": us(seg.start),
                               "dur": max(0.0, round(seg.dur * 1e6, 1)),
                               "args": {"cause": seg.cause,
                                        "synthetic": seg.synthetic}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.core.obs",
                          "runs": len(trees)}}


_VALID_PH = {"B", "E", "X", "I", "i", "M", "C", "b", "e", "n", "s", "t",
             "f", "P", "N", "O", "D"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Schema check against the trace-event format Perfetto consumes.
    Returns a list of problems; empty means the export is loadable."""
    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"{where}: invalid ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                problems.append(f"{where}: {k} must be an int")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: X event needs ts >= 0")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0")
        if ph == "M" and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: metadata event needs args")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args must be an object")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems
