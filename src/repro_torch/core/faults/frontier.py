"""Frontier checkpoint-resume: persist step-level completion through the
artifact cache so a crashed (or entirely restarted) run resumes from the
last completed frontier instead of re-running from scratch.

Two persistence channels, both tiny JSON snapshots of per-step
``(status, attempts, cache_key)``:

* ``FrontierStore.record(run)`` offers the snapshot to the (tiered)
  artifact cache under ``frontier:{workflow}`` after every step terminal
  event — the gateway drives this when the engine has a frontier store
  attached. Because the cache may be shared (``SharedRemoteTier``), a
  FRESH engine/gateway instance attached to the same store can pick the
  snapshot up.
* ``WorkflowRun.persist`` (the App. B.B metadata database) now includes
  each step's ``cache_key``; ``load_run_snapshot`` reads one of those
  JSON files back into the same snapshot shape.

``restore_frontier`` turns a snapshot back into a live ``WorkflowRun``:
steps recorded done are kept only if their outputs are still
reconstructable — the stored cache key must hit (for streaming steps:
the ``{key}#n`` manifest plus every chunk) — otherwise they quietly
degrade to ``Pending`` and re-run. Restored steps are marked ``Cached``
(their artifacts came from the store), so the normal resume path treats
them as satisfied.

Frontier snapshots are offered with ``producer="__frontier__"`` — a name
outside every workflow DAG, which the Eq. 3/4 scorer treats by its
recency fallback. They are a few hundred bytes; keeping them hot is
exactly what fault tolerance wants.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core.engines.base import StepRecord, StepStatus, WorkflowRun
from repro_torch.core.ir import WorkflowIR

FRONTIER_PRODUCER = "__frontier__"


def run_snapshot(run: WorkflowRun) -> Dict[str, Any]:
    """The persisted frontier shape (a subset of ``persist``'s schema)."""
    return {
        "workflow": run.workflow.name,
        "run_id": run.run_id,
        "status": run.status,
        "steps": {k: {"status": r.status.value, "attempts": r.attempts,
                      "cache_key": r.cache_key}
                  for k, r in run.steps.items()},
    }


def load_run_snapshot(path) -> Dict[str, Any]:
    """Load a ``WorkflowRun.persist`` JSON file as a frontier snapshot."""
    return json.loads(Path(path).read_text())


class FrontierStore:
    """Records/loads frontier snapshots through an artifact cache."""

    PREFIX = "frontier:"

    def __init__(self, cache):
        self.cache = cache

    def key(self, workflow_name: str) -> str:
        return f"{self.PREFIX}{workflow_name}"

    def record(self, run: WorkflowRun) -> None:
        blob = json.dumps(run_snapshot(run))
        self.cache.offer(self.key(run.workflow.name), blob,
                         compute_time_s=0.0, producer=FRONTIER_PRODUCER,
                         nbytes=len(blob))

    def load(self, wf: WorkflowIR) -> Optional[Dict[str, Any]]:
        hit = self.cache.get(self.key(wf.name))
        return json.loads(hit.value) if hit is not None else None


def _restore_chunks(cache, key: str) -> Optional[List[Any]]:
    """Rebuild a streaming step's full chunk list from the chunk-granular
    cache; None unless the manifest AND every chunk hit (a partial prefix
    is not a finished step — the step re-runs and replays the prefix
    itself)."""
    m = cache.get(f"{key}#n")
    if m is None:
        return None
    chunks: List[Any] = []
    for i in range(int(m.value)):
        hit = cache.get(f"{key}#c{i}")
        if hit is None:
            return None
        chunks.append(hit.value)
    return chunks


def restore_frontier(wf: WorkflowIR, snapshot: Optional[Dict[str, Any]],
                     cache) -> WorkflowRun:
    """Reconstruct a resumable ``WorkflowRun`` for ``wf`` from a frontier
    snapshot + cache hits. Walks topo order; a recorded-done step whose
    stored cache key still hits becomes ``Cached`` with its artifacts
    restored, anything else (missed, evicted, non-cacheable, previously
    failed) starts over as ``Pending``. ``Skipped`` steps stay skipped —
    their condition held in the recorded run."""
    run = WorkflowRun(workflow=wf)
    for n in wf.jobs:
        run.steps[n] = StepRecord()
    if not snapshot:
        return run
    steps = snapshot.get("steps", {})
    for n in wf.topo_order():
        info = steps.get(n)
        if info is None:
            continue
        status = info.get("status", "")
        if status == StepStatus.SKIPPED.value:
            run.steps[n].status = StepStatus.SKIPPED
            continue
        if status not in (StepStatus.SUCCEEDED.value,
                          StepStatus.CACHED.value):
            continue
        job = wf.jobs[n]
        key = info.get("cache_key") or ""
        if not key or not job.cacheable:
            continue                       # unreconstructable: re-run
        if job.stream_output or job.stream_input:
            value = _restore_chunks(cache, key)
            if value is None:
                continue
        else:
            hit = cache.get(key)
            if hit is None:
                continue
            value = hit.value
        for out in job.outputs:
            run.artifacts[out] = value
        rec = run.steps[n]
        rec.status = StepStatus.CACHED
        rec.cache_key = key
        rec.attempts = int(info.get("attempts", 0))
    return run
