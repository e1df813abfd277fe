"""``TraceChecker`` — the executable spec of the gateway event invariants.

``repro_torch.core.gateway`` documents the ordering invariants over each run's
``WorkflowEvent`` stream. This module encodes them as a linear-time
automaton: feed events in order through ``observe`` (O(1) amortized per
event) and any breach raises ``TraceViolation`` naming the invariant.

Usage:

* post-hoc — ``TraceChecker.check(events, wf=ir)`` replays a collected
  stream and runs the end-of-stream completeness checks;
* inline (sanitizer mode) — ``WorkflowGateway(check_events=True)``
  attaches a checker to every run's publish path, so the violating event
  raises at its source, with the publisher's stack.

Invariants (numbers match the gateway package docstring):

1. ``WORKFLOW_ADMITTED`` is first (seq 0) and precedes every ``STEP_*``.
2. Exactly one terminal ``WORKFLOW_DONE`` (status Succeeded / Failed /
   Cancelled), and nothing follows it.
3. Every step terminal event is preceded by its own ``STEP_STARTED``
   (at most one of each per stream); in a *Succeeded* run every started
   step also reached a terminal event. Cancel scoping: a step
   interrupted mid-stream by cancellation reverts to Pending with no
   terminal event, so the completeness half is skipped for runs that
   did not end ``Succeeded``.
4. ``STEP_STREAMING`` / ``STEP_CHUNK`` fall strictly between their own
   step's ``STEP_STARTED`` and terminal event; a chunk requires a prior
   ``STEP_STREAMING`` (each retry attempt re-announces before its first
   chunk).
5. Within an attempt chunk indices run 0,1,2,…; an index may only ever
   restart at 0 (a failure-triggered channel rewind), never skip.
6. A chunk-wise consumer's ``STEP_STARTED`` may precede its streaming
   producer's terminal event, but never the producer's
   ``STEP_STREAMING``. Needs workflow topology (``wf=``); checked
   leniently for producers with no events in this stream (already
   satisfied before a resume).
7. ``STEP_RETRY`` / ``WORKER_LOST`` fall strictly between their own
   step's ``STEP_STARTED`` and terminal event, and a step's
   ``STEP_RETRY`` attempt numbers strictly increase (within one
   admission epoch — see 8).
8. ``WORKFLOW_REQUEUED`` (a failed run re-entering admission after
   backoff) appears only after ``WORKFLOW_ADMITTED`` and before the
   terminal event, and opens a new *epoch*: per-step bookkeeping
   (started / streaming / terminal / chunks / retry attempts) resets, so
   re-executed steps legitimately re-announce ``STEP_STARTED``.
   ``CLUSTER_PREEMPTED`` is run-scope (the cluster simulator emits no
   step lifecycle) and may appear anywhere between admission and the
   terminal event.
9. ``ALERT`` (a streaming anomaly detector firing in-band) appears only
   between ``WORKFLOW_ADMITTED`` and the terminal event, and always
   names its detector in ``status``. Alerts are advisory: they affect
   no step bookkeeping and are collected on ``TraceChecker.alerts``.

``TraceViolation`` subclasses ``AssertionError`` so assertion-driven
harnesses (the sanity fuzzes) treat breaches like any failed check.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from repro_torch.core.gateway.events import EventType, WorkflowEvent

_TERMINAL_STATUSES = ("Succeeded", "Failed", "Cancelled")


class TraceViolation(AssertionError):
    """One event stream broke a gateway invariant."""

    def __init__(self, invariant: int, message: str,
                 event: Optional[WorkflowEvent] = None):
        self.invariant = invariant
        self.event = event
        at = f" at {event}" if event is not None else ""
        super().__init__(f"invariant {invariant}: {message}{at}")


class TraceChecker:
    """Incremental automaton over one run's ordered event stream."""

    def __init__(self, wf=None):
        # consumer step -> its chunk-wise streaming producer step
        self._stream_producer: Dict[str, str] = {}
        if wf is not None:
            for job in wf.jobs.values():
                if job.stream_input and job.stream_arg:
                    p = job.stream_arg.split(":")[0]
                    pj = wf.jobs.get(p)
                    if pj is not None and pj.stream_output:
                        self._stream_producer[job.name] = p
        self.admitted = False
        self.terminal: Optional[WorkflowEvent] = None
        self.started: Set[str] = set()
        self.streaming: Set[str] = set()
        self.step_terminal: Set[str] = set()
        self.chunks: Dict[str, int] = {}
        self.retries: Dict[str, int] = {}   # step -> last STEP_RETRY attempt
        self.alerts: List[WorkflowEvent] = []   # in-band ALERT events seen
        self.epoch = 0                      # re-admissions observed
        self._last_seq: Optional[int] = None
        self.n_events = 0

    # ------------------------------------------------------------------
    def observe(self, ev: WorkflowEvent) -> WorkflowEvent:
        """Validate one event (raises ``TraceViolation``) and return it."""
        if ev.seq >= 0:
            if self._last_seq is None:
                if ev.seq != 0:
                    raise TraceViolation(1, "stream must start at seq 0",
                                         ev)
            elif ev.seq != self._last_seq + 1:
                raise TraceViolation(
                    2, f"seq not contiguous ({self._last_seq} -> "
                       f"{ev.seq})", ev)
            self._last_seq = ev.seq
        if self.terminal is not None:
            raise TraceViolation(2, "event after terminal WORKFLOW_DONE",
                                 ev)
        t = ev.type
        if t is EventType.WORKFLOW_ADMITTED:
            if self.n_events:
                raise TraceViolation(1, "WORKFLOW_ADMITTED is not the "
                                        "first event", ev)
            self.admitted = True
        elif t is EventType.WORKFLOW_DONE:
            if not self.admitted:
                raise TraceViolation(1, "WORKFLOW_DONE before "
                                        "WORKFLOW_ADMITTED", ev)
            if ev.status not in _TERMINAL_STATUSES:
                raise TraceViolation(
                    2, f"terminal status {ev.status!r} not in "
                       f"{_TERMINAL_STATUSES}", ev)
            self.terminal = ev
            if ev.status == "Succeeded":
                missing = sorted(self.started - self.step_terminal)
                if missing:
                    raise TraceViolation(
                        3, f"run Succeeded but started steps {missing} "
                           f"have no terminal step event", ev)
        elif t is EventType.WORKFLOW_REQUEUED:
            if not self.admitted:
                raise TraceViolation(8, "WORKFLOW_REQUEUED before "
                                        "WORKFLOW_ADMITTED", ev)
            # new admission epoch: the gateway reset unsatisfied steps to
            # Pending, so they may re-announce STEP_STARTED
            self.epoch += 1
            self.started.clear()
            self.streaming.clear()
            self.step_terminal.clear()
            self.chunks.clear()
            self.retries.clear()
        elif t is EventType.CLUSTER_PREEMPTED:
            if not self.admitted:
                raise TraceViolation(8, "CLUSTER_PREEMPTED before "
                                        "WORKFLOW_ADMITTED", ev)
        elif t is EventType.ALERT:
            if not self.admitted:
                raise TraceViolation(9, "ALERT before WORKFLOW_ADMITTED",
                                     ev)
            if not ev.status:
                raise TraceViolation(9, "ALERT without a detector name",
                                     ev)
            self.alerts.append(ev)
        elif ev.is_step_event:
            if not self.admitted:
                raise TraceViolation(1, f"{t.name} before "
                                        f"WORKFLOW_ADMITTED", ev)
            self._observe_step(ev)
        else:  # pragma: no cover - no other event types exist today
            raise TraceViolation(2, f"unknown event type {t!r}", ev)
        self.n_events += 1
        return ev

    def _observe_step(self, ev: WorkflowEvent) -> None:
        t, s = ev.type, ev.step
        if t is EventType.STEP_STARTED:
            if s in self.started:
                raise TraceViolation(3, f"duplicate STEP_STARTED for "
                                        f"{s!r}", ev)
            p = self._stream_producer.get(s)
            if (p is not None and p in self.started
                    and p not in self.streaming
                    and p not in self.step_terminal):
                raise TraceViolation(
                    6, f"chunk-wise consumer {s!r} started before its "
                       f"producer {p!r} announced STEP_STREAMING", ev)
            self.started.add(s)
        elif t is EventType.STEP_STREAMING:
            if s not in self.started:
                raise TraceViolation(4, f"STEP_STREAMING for {s!r} "
                                        f"before its STEP_STARTED", ev)
            if s in self.step_terminal:
                raise TraceViolation(4, f"STEP_STREAMING for {s!r} after "
                                        f"its terminal event", ev)
            self.streaming.add(s)
        elif t is EventType.STEP_CHUNK:
            if s not in self.streaming:
                raise TraceViolation(4, f"STEP_CHUNK for {s!r} before its "
                                        f"STEP_STREAMING", ev)
            if s in self.step_terminal:
                raise TraceViolation(4, f"STEP_CHUNK for {s!r} after its "
                                        f"terminal event", ev)
            prev = self.chunks.get(s, -1)
            if ev.chunk != prev + 1 and ev.chunk != 0:
                raise TraceViolation(
                    5, f"chunk index {ev.chunk} for {s!r} after {prev}: "
                       f"neither +1 nor a rewind restart at 0", ev)
            self.chunks[s] = ev.chunk
        elif t is EventType.STEP_RETRY:
            if s not in self.started:
                raise TraceViolation(7, f"STEP_RETRY for {s!r} before its "
                                        f"STEP_STARTED", ev)
            if s in self.step_terminal:
                raise TraceViolation(7, f"STEP_RETRY for {s!r} after its "
                                        f"terminal event", ev)
            prev = self.retries.get(s, 0)
            if ev.attempt <= prev:
                raise TraceViolation(
                    7, f"STEP_RETRY attempt {ev.attempt} for {s!r} not "
                       f"greater than previous attempt {prev}", ev)
            self.retries[s] = ev.attempt
        elif t is EventType.WORKER_LOST:
            if s not in self.started:
                raise TraceViolation(7, f"WORKER_LOST for {s!r} before its "
                                        f"STEP_STARTED", ev)
            if s in self.step_terminal:
                raise TraceViolation(7, f"WORKER_LOST for {s!r} after its "
                                        f"terminal event", ev)
        else:  # terminal step event
            if s not in self.started:
                raise TraceViolation(3, f"{t.name} for {s!r} before its "
                                        f"STEP_STARTED", ev)
            if s in self.step_terminal:
                raise TraceViolation(3, f"second terminal event for "
                                        f"{s!r}", ev)
            self.step_terminal.add(s)

    # ------------------------------------------------------------------
    def finish(self) -> "TraceChecker":
        """End-of-stream checks for a run believed complete."""
        if not self.admitted:
            raise TraceViolation(1, "no WORKFLOW_ADMITTED observed")
        if self.terminal is None:
            raise TraceViolation(2, "no terminal WORKFLOW_DONE observed")
        return self

    @classmethod
    def check(cls, events: Iterable[WorkflowEvent], wf=None
              ) -> "TraceChecker":
        """Replay a collected stream and run the completeness checks."""
        checker = cls(wf=wf)
        for ev in events:
            checker.observe(ev)
        return checker.finish()
