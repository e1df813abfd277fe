"""Big-workflow auto-parallelism (paper §IV.B, Algorithm 3).

A workflow whose *budget* C — spec bytes (alpha, the 2MB-CRD analog), step
count (beta, e.g. 200), pod count (gamma) — exceeds the engine limit is split
into multiple sub-workflows by a DFS over the DAG that greedily accumulates
vertices into a candidate until the candidate would exceed the budget
(O(|V|), as in the paper). Cross-sub-workflow data edges become artifact
handoffs through the cache store; sub-workflows whose mutual dependencies
allow it run in parallel (maximum parallelism goal, Eq. 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import WorkflowIR


@dataclass(frozen=True)
class Budget:
    """C = alpha + beta + gamma (paper defaults: 2MB spec, 200 steps)."""
    spec_bytes: float = 2 * 1024 * 1024
    steps: float = 200
    pods: float = 512

    def exceeded_by(self, wf_budget: Dict[str, float]) -> bool:
        return (wf_budget["spec_bytes"] > self.spec_bytes
                or wf_budget["steps"] > self.steps
                or wf_budget["pods"] > self.pods)


def _budget_of(wf: WorkflowIR, names: Sequence[str]) -> Dict[str, float]:
    jobs = [wf.jobs[n] for n in names]
    return {"spec_bytes": sum(j.spec_size_bytes() for j in jobs),
            "steps": float(len(jobs)),
            "pods": sum(max(1.0, j.resources.cpu) for j in jobs)}


def split_workflow(wf: WorkflowIR, budget: Optional[Budget] = None
                   ) -> List[WorkflowIR]:
    """Algorithm 3. Returns sub-workflows in a valid execution order:
    every cross-edge goes from an earlier to a later sub-workflow."""
    budget = budget or Budget()
    if not budget.exceeded_by(wf.budget()):         # lines 9-11: fits whole
        return [wf]

    # DFS over the DAG in topological order (ensures cross-edges only flow
    # forward across sub-workflow boundaries). The candidate's budget is
    # accumulated incrementally — each vertex contributes its (spec bytes,
    # step, pods) terms exactly once — instead of re-deriving the whole
    # candidate's budget (an O(|cand|) json serialization) at every vertex.
    visited: Set[str] = set()
    cand: List[str] = []
    out_groups: List[List[str]] = []
    acc = {"spec_bytes": 0.0, "steps": 0.0, "pods": 0.0}

    def flush():
        if cand:
            out_groups.append(list(cand))
            cand.clear()
            acc["spec_bytes"] = acc["steps"] = acc["pods"] = 0.0

    def visit(v: str):
        if v in visited:
            return
        visited.add(v)
        job = wf.jobs[v]
        spec = job.spec_size_bytes()
        pods = max(1.0, job.resources.cpu)
        trial = {"spec_bytes": acc["spec_bytes"] + spec,
                 "steps": acc["steps"] + 1.0,
                 "pods": acc["pods"] + pods}
        if budget.exceeded_by(trial):                   # lines 15-19
            flush()
        cand.append(v)
        acc["spec_bytes"] += spec
        acc["steps"] += 1.0
        acc["pods"] += pods
        for nxt in sorted(wf.successors(v)):            # lines 21-24
            # only descend once all predecessors are visited (DAG safety)
            if all(p in visited for p in wf.predecessors(nxt)):
                visit(nxt)

    for v in wf.topo_order():                           # lines 3-6
        visit(v)
    flush()

    subs = [wf.subgraph(g, f"{wf.name}-part{i}")
            for i, g in enumerate(out_groups)]
    return subs


def cross_edges(wf: WorkflowIR, subs: Sequence[WorkflowIR]
                ) -> List[Tuple[str, str, int, int]]:
    """(src_job, dst_job, src_part, dst_part) for edges crossing parts."""
    owner: Dict[str, int] = {}
    for i, s in enumerate(subs):
        for n in s.jobs:
            owner[n] = i
    out = []
    for s, d in wf.edges:
        if owner[s] != owner[d]:
            out.append((s, d, owner[s], owner[d]))
    return out


def schedule_parts(wf: WorkflowIR, subs: Sequence[WorkflowIR]
                   ) -> List[List[int]]:
    """Waves of sub-workflow indices runnable in parallel (maximum
    parallelism over the part-DAG induced by cross edges)."""
    edges = cross_edges(wf, subs)
    deps: Dict[int, Set[int]] = {i: set() for i in range(len(subs))}
    for _, _, a, b in edges:
        if a != b:
            deps[b].add(a)
    done: Set[int] = set()
    waves: List[List[int]] = []
    remaining = set(range(len(subs)))
    while remaining:
        wave = sorted(i for i in remaining if deps[i] <= done)
        if not wave:
            raise ValueError("cyclic sub-workflow dependency (split bug)")
        waves.append(wave)
        done.update(wave)
        remaining -= set(wave)
    return waves


def validate_split(wf: WorkflowIR, subs: Sequence[WorkflowIR],
                   budget: Budget) -> None:
    """Invariants used by the property tests: partition + budget + acyclic."""
    all_names = [n for s in subs for n in s.jobs]
    assert sorted(all_names) == sorted(wf.jobs), "split must partition jobs"
    assert len(set(all_names)) == len(all_names), "no duplicated jobs"
    for i, s in enumerate(subs):
        if len(subs) > 1 and len(s.jobs) > 1:
            # each part respects the budget unless it is a single huge job
            b = _budget_of(s, list(s.jobs))
            assert (b["steps"] <= budget.steps
                    and b["spec_bytes"] <= budget.spec_bytes
                    and b["pods"] <= budget.pods), (i, b)
        s.validate()
    schedule_parts(wf, subs)  # raises on cycles
