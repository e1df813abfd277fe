"""Critical-path attribution: where did the makespan go?

Walks a finalized ``SpanTree`` plus the run's DAG edges (captured into the
tree at finalize) to produce a ``MakespanReport``: the chain of step spans
that gated completion, with every microsecond of ``WORKFLOW_ADMITTED`` →
``WORKFLOW_DONE`` attributed to exactly one segment kind —

* step-internal time on the critical path: ``compute``, ``retry``
  (failed-attempt time, with its ``STEP_RETRY``/``WORKER_LOST`` cause),
  ``cache-fetch`` (terminal ``STEP_CACHED``), ``skipped``;
* gaps between critical-path spans: ``readmission-backoff`` where they
  overlap a ``WORKFLOW_REQUEUED`` backoff window, ``queue-wait``
  otherwise (admission pump, in-flight-steps semaphore, scheduling);
* the tail after the last step terminal (persist + bookkeeping):
  ``overhead``.

The pieces partition the makespan **by construction** — their sum equals
``end - start`` exactly — so ``reconciles(measured_wall_s)`` is a real
cross-check against an externally measured wall clock, not an identity.

The chain itself is chosen backwards: start from the span with the
latest terminal, repeatedly hop to the predecessor whose terminal was
latest (the dependency that actually gated readiness), stopping when a
span has no predecessor span in the tree (entry step, or a frontier
satisfied before this run).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.obs.spans import SpanTree, StepSpan

__all__ = ["MakespanReport", "build_report", "critical_path"]

#: partitioning segment kinds in render order
_KIND_ORDER = ("compute", "queue-wait", "cache-fetch", "retry",
               "readmission-backoff", "stream-stall", "skipped", "overhead")


def critical_path(tree: SpanTree) -> List[StepSpan]:
    """Chronological chain of step spans that gated the makespan."""
    latest = tree.latest_spans()
    if not latest:
        return []
    preds: Dict[str, List[str]] = {}
    for src, dst in tree.edges:
        preds.setdefault(dst, []).append(src)
    cur = max(latest.values(), key=lambda sp: sp.end)
    chain = [cur]
    seen = {cur.step}
    while True:
        best: Optional[StepSpan] = None
        for p in preds.get(cur.step, ()):
            sp = latest.get(p)
            if sp is None or sp.step in seen:
                continue
            if sp.end <= cur.start + 1e-9 and \
                    (best is None or sp.end > best.end):
                best = sp
        if best is None:
            break
        chain.append(best)
        seen.add(best.step)
        cur = best
    chain.reverse()
    return chain


@dataclass
class MakespanReport:
    """Attributed makespan breakdown for one finished run."""

    workflow: str
    run_id: str
    status: str
    makespan_s: float
    critical_path: List[str] = field(default_factory=list)
    # ordered timeline pieces: {"kind", "step" (or ""), "start", "end",
    # "dur", "cause"} — partition of [tree.start, tree.end]
    segments: List[Dict] = field(default_factory=list)
    totals: Dict[str, float] = field(default_factory=dict)
    # informational (synthetic, overlaps compute): producer backpressure
    stream_stall_s: float = 0.0

    @property
    def attributed_s(self) -> float:
        return sum(self.totals.values())

    def pct(self, kind: str) -> float:
        if self.makespan_s <= 0:
            return 0.0
        return 100.0 * self.totals.get(kind, 0.0) / self.makespan_s

    def reconciles(self, measured_wall_s: float, tol: float = 0.05) -> bool:
        """Does the attributed total agree with an externally measured
        wall clock within ``tol`` (relative)?"""
        if measured_wall_s <= 0:
            return self.attributed_s <= tol
        return abs(self.attributed_s - measured_wall_s) \
            <= tol * measured_wall_s

    def to_dict(self) -> Dict:
        return {"workflow": self.workflow, "run_id": self.run_id,
                "status": self.status, "makespan_s": self.makespan_s,
                "critical_path": self.critical_path,
                "segments": self.segments, "totals": self.totals,
                "stream_stall_s": self.stream_stall_s}

    def render(self) -> str:
        """Human-readable breakdown, biggest buckets first."""
        lines = [f"run {self.run_id} workflow {self.workflow}: "
                 f"{self.status}, makespan {self.makespan_s:.3f}s"]
        by_step: Dict[str, Dict[str, float]] = {}
        for seg in self.segments:
            if seg["step"]:
                by_step.setdefault(seg["kind"], {})
                by_step[seg["kind"]][seg["step"]] = \
                    by_step[seg["kind"]].get(seg["step"], 0.0) + seg["dur"]
        kinds = sorted((k for k, v in self.totals.items() if v > 0),
                       key=lambda k: -self.totals[k])
        for kind in kinds:
            tot = self.totals[kind]
            detail = ""
            steps = by_step.get(kind)
            if steps:
                top = sorted(steps.items(), key=lambda kv: -kv[1])[:3]
                detail = "  (" + ", ".join(
                    f"{s} {d:.3f}s" for s, d in top) + ")"
            lines.append(f"  {self.pct(kind):5.1f}% {kind:<20s}"
                         f"{tot:9.3f}s{detail}")
        if self.stream_stall_s > 0:
            lines.append(f"  [stream-stall {self.stream_stall_s:.3f}s "
                         "of backpressure inside compute]")
        if self.critical_path:
            lines.append("critical path: "
                         + " -> ".join(self.critical_path))
        return "\n".join(lines)


def _classify_gap(start: float, end: float,
                  backoffs: List) -> List[Dict]:
    """Split an inter-span gap into readmission-backoff pieces (where it
    overlaps a WORKFLOW_REQUEUED window) and queue-wait for the rest."""
    pieces: List[Dict] = []
    cur = start
    for b in sorted(backoffs, key=lambda s: s.start):
        lo, hi = max(b.start, cur), min(b.end, end)
        if hi <= lo:
            continue
        if lo > cur:
            pieces.append({"kind": "queue-wait", "step": "", "start": cur,
                           "end": lo, "dur": lo - cur, "cause": ""})
        pieces.append({"kind": "readmission-backoff", "step": "",
                       "start": lo, "end": hi, "dur": hi - lo,
                       "cause": b.cause})
        cur = hi
    if end > cur:
        pieces.append({"kind": "queue-wait", "step": "", "start": cur,
                       "end": end, "dur": end - cur, "cause": ""})
    return pieces


def build_report(tree: SpanTree) -> MakespanReport:
    chain = critical_path(tree)
    backoffs = [s for s in tree.segments
                if s.kind == "readmission-backoff"]
    segments: List[Dict] = []
    cursor = tree.start
    for sp in chain:
        if sp.start > cursor + 1e-12:
            segments.extend(_classify_gap(cursor, sp.start, backoffs))
            cursor = sp.start
        for seg in sp.segments:
            if seg.synthetic or seg.kind == "queue-wait":
                continue
            lo = max(seg.start, cursor)
            if seg.end > lo:
                segments.append({"kind": seg.kind, "step": sp.step,
                                 "start": lo, "end": seg.end,
                                 "dur": seg.end - lo, "cause": seg.cause})
                cursor = seg.end
        cursor = max(cursor, sp.end)
    if tree.end > cursor + 1e-12:
        # post-chain tail: persist / requeue rounds that out-lasted the
        # last critical step, bookkeeping before WORKFLOW_DONE
        segments.extend(_classify_gap(cursor, tree.end, backoffs))
        if segments and segments[-1]["kind"] == "queue-wait":
            segments[-1]["kind"] = "overhead"
    totals: Dict[str, float] = {}
    for seg in segments:
        totals[seg["kind"]] = totals.get(seg["kind"], 0.0) + seg["dur"]
    return MakespanReport(
        workflow=tree.workflow, run_id=tree.run_id, status=tree.status,
        makespan_s=tree.makespan_s,
        critical_path=[sp.step for sp in chain],
        segments=segments, totals=totals,
        stream_stall_s=tree.seg_total("stream-stall"))
