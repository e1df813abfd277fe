"""Typed lifecycle events emitted by the workflow gateway.

See ``repro_torch.core.gateway`` (package docstring) for the full taxonomy and
the ordering invariants every event stream satisfies.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class EventType(str, enum.Enum):
    """Lifecycle event kinds, in the order they may appear in a stream."""

    WORKFLOW_ADMITTED = "WORKFLOW_ADMITTED"   # passed the backpressure gate
    STEP_STARTED = "STEP_STARTED"             # step handed to the worker pool
    STEP_STREAMING = "STEP_STREAMING"         # step is emitting chunks
    STEP_CHUNK = "STEP_CHUNK"                 # one chunk emitted (see .chunk)
    STEP_RETRY = "STEP_RETRY"                 # transient failure; retrying
    WORKER_LOST = "WORKER_LOST"               # pool slot died mid-execution
    STEP_SUCCEEDED = "STEP_SUCCEEDED"
    STEP_CACHED = "STEP_CACHED"               # outputs served from the store
    STEP_SKIPPED = "STEP_SKIPPED"             # couler.when condition false
    STEP_FAILED = "STEP_FAILED"
    CLUSTER_PREEMPTED = "CLUSTER_PREEMPTED"   # run-scope: cluster went dark
    WORKFLOW_REQUEUED = "WORKFLOW_REQUEUED"   # failed run re-enters admission
    ALERT = "ALERT"                           # anomaly detector fired in-band
    WORKFLOW_DONE = "WORKFLOW_DONE"           # terminal; exactly one per run


STEP_EVENTS = frozenset({EventType.STEP_STARTED, EventType.STEP_STREAMING,
                         EventType.STEP_CHUNK, EventType.STEP_RETRY,
                         EventType.WORKER_LOST, EventType.STEP_SUCCEEDED,
                         EventType.STEP_CACHED, EventType.STEP_SKIPPED,
                         EventType.STEP_FAILED})


@dataclass(frozen=True)
class WorkflowEvent:
    """One lifecycle event of one run.

    ``seq`` is a per-run monotonic counter (0 is always the admission
    event); ``status`` carries the step status for STEP_* events and the
    terminal run status ("Succeeded"/"Failed"/"Cancelled") for
    WORKFLOW_DONE and the firing detector name for ALERT (whose ``error``
    carries the human-readable reason). ``chunk`` is the 0-based chunk
    index for STEP_CHUNK
    events (-1 otherwise). ``attempt`` is the 1-based attempt number for
    retry-related events: the attempt about to run for STEP_RETRY, the
    attempt that died for WORKER_LOST / CLUSTER_PREEMPTED, the admission
    round for WORKFLOW_REQUEUED (0 when not applicable).
    """

    type: EventType
    workflow: str
    run_id: str
    tenant: str = "default"
    step: str = ""
    status: str = ""
    error: str = ""
    chunk: int = -1
    attempt: int = 0
    seq: int = -1
    ts: float = 0.0

    @property
    def terminal(self) -> bool:
        return self.type is EventType.WORKFLOW_DONE

    @property
    def is_step_event(self) -> bool:
        return self.type in STEP_EVENTS
