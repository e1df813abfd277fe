"""Engine interface + run bookkeeping (paper §II.F, App. B.B).

Every backend consumes the same IR. ``WorkflowRun`` persists step statuses
so a failed workflow can be restarted from the failure point, skipping
steps whose status is Succeeded / Skipped / Cached (paper App. B.B).
"""
from __future__ import annotations

import asyncio
import enum
import json
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core.ir import WorkflowIR


class StepStatus(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    SKIPPED = "Skipped"
    CACHED = "Cached"


@dataclass
class StepRecord:
    status: StepStatus = StepStatus.PENDING
    attempts: int = 0
    start: float = 0.0
    end: float = 0.0
    error: str = ""
    speculative: bool = False
    # streaming steps: chunks served from the chunk-granular cache vs
    # computed this run (whole-step CACHED means all chunks replayed)
    chunks_replayed: int = 0
    chunks_emitted: int = 0
    # content key the step's outputs were offered under — persisted so a
    # restarted engine can reconstruct the completion frontier from cache
    # hits (repro_torch.core.faults.restore_frontier)
    cache_key: str = ""
    # compute-layer profile (LocalEngine profile_steps=True): compile_s /
    # execute_s split and device memory, folded into registry histograms
    # and span annotations by the gateway
    profile: Optional[Dict[str, float]] = None

    def duration(self) -> float:
        return max(0.0, self.end - self.start)


@dataclass
class WorkflowRun:
    workflow: WorkflowIR
    steps: Dict[str, StepRecord] = field(default_factory=dict)
    artifacts: Dict[str, Any] = field(default_factory=dict)
    status: str = "Pending"
    wall_time_s: float = 0.0
    submitted: float = field(default_factory=time.time)
    run_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])

    def succeeded(self) -> bool:
        return self.status == "Succeeded"

    def report(self):
        """Critical-path makespan breakdown for this run (a
        ``repro_torch.core.obs.MakespanReport``). Requires the engine to have
        been observed — ``couler.observe(engine)`` — before the run."""
        ref = getattr(self, "_obs_collector", None)
        coll = ref() if ref is not None else None
        if coll is None:
            raise RuntimeError(
                "run was not traced: call couler.observe(engine) before "
                "submitting, then run.report()")
        rep = coll.report(self.run_id)
        if rep is None:
            raise RuntimeError(
                f"no span tree for run {self.run_id!r} (rotated out of "
                "the collector's LRU, or the run never finished)")
        return rep

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.steps.values():
            out[r.status.value] = out.get(r.status.value, 0) + 1
        return out

    # -- metadata persistence ("we persist workflow metadata into a
    #    database for automated management", App. B.B) -----------------
    def persist(self, db_dir: str = "out/workflow_db") -> Path:
        p = Path(db_dir)
        p.mkdir(parents=True, exist_ok=True)
        # the run_id suffix keeps two runs of the same workflow within one
        # second from overwriting each other — inevitable under concurrent
        # gateway submission
        f = p / f"{self.workflow.name}-{int(self.submitted)}-{self.run_id}.json"
        f.write_text(json.dumps({
            "workflow": self.workflow.name,
            "run_id": self.run_id,
            "status": self.status,
            "wall_time_s": self.wall_time_s,
            "steps": {k: {"status": r.status.value, "attempts": r.attempts,
                          "duration": r.duration(), "error": r.error,
                          "cache_key": r.cache_key}
                      for k, r in self.steps.items()},
        }, indent=1))
        return f


class Engine:
    name = "engine"

    def submit(self, wf: WorkflowIR, optimize: bool = True, **kw) -> WorkflowRun:
        raise NotImplementedError

    # -- static analysis ---------------------------------------------------
    def lint_context(self) -> Dict[str, Any]:
        """Capacity facts this engine contributes to the workflow linter
        (``repro_torch.core.analysis``): e.g. ``clusters`` enables the CLR005
        fit check, ``max_inflight_steps`` the CLR006 streaming-depth
        check. The base engine knows nothing."""
        return {}

    def lint(self, wf: WorkflowIR, **overrides):
        """Lint ``wf`` with this engine's deployment context; returns a
        ``LintResult``. Submission paths run the same passes as a gate
        (``lint="error"|"warn"|"off"`` on ``submit``/``submit_async``)."""
        from repro_torch.core.analysis import lint as _lint
        ctx = self.lint_context()
        ctx.update(overrides)
        return _lint(wf, **ctx)

    def resume(self, run: WorkflowRun, **kw) -> WorkflowRun:
        """Restart from failure: re-submit, skipping Succeeded/Skipped/Cached."""
        raise NotImplementedError

    async def submit_async(self, wf: WorkflowIR, optimize: bool = True,
                           tenant: str = "default", priority: int = 0, **kw):
        """Generic async adapter: run the blocking ``submit`` in a worker
        thread and return an ``AsyncWorkflowRun`` handle. Only the coarse
        ``WORKFLOW_ADMITTED`` / ``WORKFLOW_DONE`` events are emitted, and
        cancellation is not cooperative mid-run. Engines with a native
        async path (``LocalEngine``) override this with the gateway
        implementation, which adds per-step events, backpressure, and
        cooperative cancel."""
        from repro_torch.core.gateway.events import EventType
        from repro_torch.core.gateway.run import AsyncWorkflowRun
        handle = AsyncWorkflowRun(wf.name, tenant=tenant)
        handle._publish(EventType.WORKFLOW_ADMITTED)
        loop = asyncio.get_running_loop()
        # tenant maps onto the scheduler's user attribution (MultiCluster
        # quotas/fairness); engines accepting neither ignore the extras
        kw.setdefault("user", tenant)
        kw.setdefault("priority", priority)

        def work() -> None:
            try:
                run = self.submit(wf, optimize=optimize, **kw)
                handle.run = run
                handle._publish(EventType.WORKFLOW_DONE, status=run.status)
                handle._finish(run)
            except BaseException as e:  # noqa: BLE001
                handle._publish(EventType.WORKFLOW_DONE, status="Failed",
                                error=f"{type(e).__name__}: {e}")
                handle._fail(e)

        loop.run_in_executor(None, work)
        return handle


# The >20 abnormal cloud patterns the controller auto-retries (App. B.B).
TRANSIENT_ERROR_PATTERNS = [
    "ExceededQuotaErr", "TooManyRequestsErr", "EtcdTimeout", "APIServerBusy",
    "PodEvicted", "NodeNotReady", "ImagePullBackOff", "NetworkUnreachable",
    "ConnectionReset", "DNSFailure", "VolumeMountTimeout", "OOMKilledTransient",
    "LeaseLost", "WebhookTimeout", "SchedulerPreempted", "DiskPressure",
    "RegistryThrottled", "CertRotation", "TokenExpired", "IPAMExhausted",
    "ControllerRestart", "HeartbeatMissed",
]


class TransientError(RuntimeError):
    """An error matching a known-retryable abnormal pattern."""


def is_transient(err: BaseException) -> bool:
    if isinstance(err, TransientError):
        return True
    msg = str(err)
    return any(p in msg for p in TRANSIENT_ERROR_PATTERNS)
