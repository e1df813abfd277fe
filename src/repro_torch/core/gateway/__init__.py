"""Async workflow gateway: asyncio submission layer between the user API
and the engines.

The gateway multiplexes thousands of concurrent workflows onto shared
executor resources: one event loop, one step worker pool, one (thread-safe)
artifact store, and one backpressured multi-tenant admission queue per
``LocalEngine``. ``couler.run_async`` / ``couler.stream`` and
``Engine.submit_async`` are the user-facing entry points;
``LocalEngine.submit`` is a thin sync facade over the same path.

Event taxonomy
--------------
Every run's event stream (``AsyncWorkflowRun.events()``) is a totally
ordered sequence of ``WorkflowEvent``s:

``WORKFLOW_ADMITTED``
    The submission passed the backpressure gate (per-tenant bounded queue;
    a full queue sheds load with ``QueueFull`` instead). Always the first
    event (``seq == 0``).
``STEP_STARTED``
    A step acquired an in-flight slot and was handed to the worker pool.
``STEP_STREAMING``
    A streaming step (``couler.run_stream`` / ``couler.map_stream``) is
    about to emit its first chunk — downstream chunk-wise consumers may
    start from this point, before the producer's terminal event.
``STEP_CHUNK``
    One chunk delivered into the step's artifact channel (or replayed
    from the chunk-granular cache); ``chunk`` is its 0-based index.
``STEP_RETRY``
    A transient failure was absorbed and the step is about to re-run;
    ``attempt`` is the attempt number about to execute (so attempts on a
    step's retries strictly increase). Emitted on every retry — organic
    ``TransientError``s and injected chaos alike.
``WORKER_LOST``
    The pool slot executing the step died (``repro_torch.core.faults``
    worker-loss injection); ``attempt`` is the attempt that died. Always
    followed by either a ``STEP_RETRY`` or the step's ``STEP_FAILED``.
``STEP_SUCCEEDED`` / ``STEP_CACHED`` / ``STEP_SKIPPED`` / ``STEP_FAILED``
    The step's terminal status: executed, served from the artifact store
    (Algorithm 2 consumer side), skipped by its ``couler.when`` condition,
    or failed after exhausting the transient-error retry budget. Always
    preceded by that step's ``STEP_STARTED``.
``CLUSTER_PREEMPTED``
    Run-scoped (``MultiClusterEngine`` chaos): the cluster running
    ``step`` went dark and evicted it; the job re-enters placement.
``WORKFLOW_REQUEUED``
    The run failed but a ``ReadmissionPolicy`` accepted it back into the
    admission queue (capped exponential backoff + priority aging);
    ``attempt`` is the re-admission round. Opens a new *epoch*: completed
    steps stay completed, failed steps reset to Pending and may emit a
    fresh ``STEP_STARTED``.
``ALERT``
    A streaming anomaly detector fired in-band (continuous telemetry,
    ``couler.telemetry``): ``status`` names the detector (``straggler``,
    ``readmission_storm``, ...), ``error`` carries the human-readable
    reason, and ``step`` is set for step-scoped detectors. Advisory —
    alerts never change run or step state.
``WORKFLOW_DONE``
    Terminal; exactly one per run, always last, with ``status`` in
    ``{"Succeeded", "Failed", "Cancelled"}``. A cancelled run keeps its
    unlaunched steps ``Pending`` and is resumable via ``engine.resume``.

Invariants — the **executable specification** is
``repro_torch.core.analysis.TraceChecker``, a linear-time automaton that
consumes each run's event stream and raises ``TraceViolation`` naming the
broken invariant. The gateway/streaming test suites and the sanity fuzz
all validate streams through that single checker, and
``WorkflowGateway(check_events=True)`` (or
``LocalEngine(check_events=True)``) attaches one per run inline —
sanitizer mode — so a breach raises at the offending publish. In prose:

1. ``WORKFLOW_ADMITTED`` is first (seq 0) and precedes every ``STEP_*``
   event.
2. Exactly one terminal event per run, and nothing follows it.
3. Every ``STEP_SUCCEEDED/CACHED/SKIPPED/FAILED`` is preceded by its own
   ``STEP_STARTED``.
4. Every ``STEP_STREAMING``/``STEP_CHUNK`` falls strictly between its own
   step's ``STEP_STARTED`` and terminal event, and the step's first
   ``STEP_CHUNK`` is preceded by its ``STEP_STREAMING``.
5. Within one *attempt* a step's ``STEP_CHUNK`` indices are 0,1,2,…;
   a retried producer rewinds its channel and restarts at chunk 0, so
   indices reset only after a failure-triggered rewind.
6. A consumer's ``STEP_STARTED`` may precede its producer's terminal
   event (that is the point of streaming) but never the producer's
   ``STEP_STREAMING``.
7. ``STEP_RETRY`` / ``WORKER_LOST`` fall strictly between their own
   step's ``STEP_STARTED`` and terminal event, and a step's
   ``STEP_RETRY`` attempt numbers strictly increase within an epoch.
8. ``WORKFLOW_REQUEUED`` falls strictly between admission and the
   terminal event and resets the checker's per-step bookkeeping (new
   epoch — re-admitted steps may legally re-emit ``STEP_STARTED``);
   ``CLUSTER_PREEMPTED`` may appear anywhere in that same span.
9. ``ALERT`` falls strictly between admission and the terminal event and
   always names its detector in ``status``; it touches no step
   bookkeeping.

Exception (encoded in the checker's cancel scoping): a step interrupted
*mid-stream* by cooperative cancellation is reverted to ``Pending`` (the
run stays resumable) and — like a step that never launched — gets no
terminal step event; its ``STEP_STARTED`` / ``STEP_STREAMING`` /
``STEP_CHUNK`` events remain in the history, so invariant 3's
completeness half applies only to runs that ended ``Succeeded``.

Workflows are also statically linted before admission
(``repro_torch.core.analysis.lint``; diagnostics table in
``docs/diagnostics.md``) — errors reject at ``submit``/``submit_async``
time unless ``lint="warn"|"off"``.

The generic ``Engine.submit_async`` fallback (engines without a native
async path, e.g. ``MultiClusterEngine`` or the YAML generators) emits only
the coarse pair ``WORKFLOW_ADMITTED`` / ``WORKFLOW_DONE``.
"""
from repro_torch.core.gateway.admission import (AdmissionQueue, AdmittedItem,
                                          QueueFull)
from repro_torch.core.gateway.channels import (ArtifactChannel, StepContext,
                                         StreamBroken, StreamCancelled,
                                         StreamError, StreamReader,
                                         StreamRewound, StreamStalled)
from repro_torch.core.gateway.events import STEP_EVENTS, EventType, WorkflowEvent
from repro_torch.core.gateway.gateway import WorkflowGateway
from repro_torch.core.gateway.run import AsyncWorkflowRun

__all__ = ["AdmissionQueue", "AdmittedItem", "QueueFull", "EventType",
           "STEP_EVENTS", "WorkflowEvent", "WorkflowGateway",
           "AsyncWorkflowRun", "ArtifactChannel", "StreamReader",
           "StepContext", "StreamError", "StreamCancelled", "StreamRewound",
           "StreamBroken", "StreamStalled"]
