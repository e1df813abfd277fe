"""Structural lint passes over ``WorkflowIR``.

Two traversals, each O(V+E), so the submission-time gate stays linear
and negligible against scheduling itself (``benchmarks/bench_analysis.py``
pins the <2% overhead claim):

* ``cycle_pass`` — one graph sweep (order-free Kahn) for CLR001;
* ``step_pass`` — one fused sweep over the jobs for every per-step
  concern (CLR002/003/004/005/007/008/009 plus the CLR006 streaming
  component check). The concerns are independent — they share a loop,
  not state — and each lives in its own labelled block below.

Every pass takes the workflow plus a ``LintContext`` of optional
capacity facts (clusters, in-flight step bound) and returns a list of
``Diagnostic``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.analysis.diagnostics import Diagnostic, Severity
from repro_torch.core.analysis.ndet import nondeterminism_findings
from repro_torch.core.ir import WorkflowIR


@dataclass
class LintContext:
    """Optional capacity facts an engine contributes to the lint run."""
    clusters: Optional[Sequence] = None          # engines.cluster.Cluster
    max_inflight_steps: Optional[int] = None     # gateway step-slot bound


def _producer(artifact: str) -> str:
    return artifact.split(":")[0]


def _find_cycle(wf: WorkflowIR) -> List[str]:
    """One offending cycle path (colored DFS); [] when acyclic."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {n: WHITE for n in wf.jobs}
    for root in wf.jobs:
        if color[root] != WHITE:
            continue
        stack = [(root, iter(sorted(wf.successors(root))))]
        color[root] = GRAY
        path = [root]
        while stack:
            node, it = stack[-1]
            adv = next(it, None)
            if adv is None:
                color[node] = BLACK
                stack.pop()
                path.pop()
                continue
            if color[adv] == GRAY:                 # back edge: cycle found
                return path[path.index(adv):] + [adv]
            if color[adv] == WHITE:
                color[adv] = GRAY
                stack.append((adv, iter(sorted(wf.successors(adv)))))
                path.append(adv)
    return []


def cycle_pass(wf: WorkflowIR, ctx: LintContext) -> List[Diagnostic]:
    """CLR001 — dependency cycle (with the offending path). A cycle
    through streaming steps would additionally deadlock the bounded
    ``ArtifactChannel``s, so the message calls that out."""
    # Cheap acyclicity witnesses first; otherwise an order-free Kahn
    # sweep (cheaper than topo_order(): no determinism sort, no
    # defensive copies — this is the gate's hot path).
    if (not wf._has_back_edge            # all edges forward => acyclic
            or not wf.edges or wf._topo_cache is not None):
        return []
    preds, succs = wf._preds, wf._succs
    indeg = {n: len(preds[n]) for n in wf.jobs}
    ready = [n for n, k in indeg.items() if not k]
    seen = 0
    while ready:
        n = ready.pop()
        seen += 1
        for d in succs[n]:
            indeg[d] -= 1
            if not indeg[d]:
                ready.append(d)
    if seen == len(wf.jobs):
        return []
    path = _find_cycle(wf)
    streaming = any(wf.jobs[n].stream_output or wf.jobs[n].stream_input
                    for n in path)
    extra = ("; the cycle passes through streaming steps and would "
             "deadlock their bounded channels" if streaming else "")
    return [Diagnostic(
        code="CLR001", severity=Severity.ERROR, job=path[0] if path else "",
        message=f"dependency cycle: {' -> '.join(path)}{extra}",
        fix="remove one of the edges on the cycle")]


def step_pass(wf: WorkflowIR, ctx: LintContext) -> List[Diagnostic]:
    """All per-step concerns in one traversal:

    CLR002 (warning) — isolated steps (no edges at all) in a multi-step
    workflow; ``couler.concurrent`` builds these on purpose, but in
    hand-written DAGs they are usually a forgotten ``set_dependencies``
    or a misspelled step name.
    CLR003 — ``when``/``exec_while`` conditions referencing artifacts no
    step produces: the predicate could only ever see ``None``.
    CLR008 — declared inputs whose producing step is missing (e.g. a
    ``StepOutput`` smuggled in from another workflow context).
    CLR004 — a chunk-wise consumer fed more than one streamed input;
    only the ``stream_arg`` slot is chunk-wise, every other streamed
    input is silently materialized — overlap the author expects never
    happens.
    CLR009 (info) — ``map_stream`` over a source that is not streamed.
    CLR006 — a connected streaming component wider than
    ``max_inflight_steps``: all its steps must hold step slots
    simultaneously, so the pipeline deadlocks under that bound.
    CLR005 — a job requesting more cpu/mem/gpu than ANY cluster's total
    capacity can never be scheduled; today it silently pins its workflow
    in the queue forever.
    CLR007 (warning) — unseeded RNG / wall-clock / uuid inside a
    ``cacheable=True`` step fn: two runs produce different artifacts
    under the same cache key, so downstream consumers silently reuse a
    stale value (the chunk cache has no runtime detection for this).
    """
    out: List[Diagnostic] = []
    jobs = wf.jobs
    preds, succs = wf._preds, wf._succs
    multi = len(jobs) > 1
    clusters = ctx.clusters
    if clusters:
        # a request within every dimension's MINIMUM capacity fits every
        # cluster — one comparison chain accepts the common case, the
        # per-cluster joint-fit loop only runs for big requests
        env_cpu = min(c.cpu for c in clusters)
        env_mem = min(c.mem_bytes for c in clusters)
        env_gpu = min(c.gpu for c in clusters) + 1e-9
    comp: Dict[str, str] = {}          # union-find over stream edges

    def find(x: str) -> str:
        while comp.get(x, x) != x:
            comp[x] = comp.get(comp[x], comp[x])
            x = comp[x]
        return x

    def union(a: str, b: str) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            comp.setdefault(ra, ra)
            comp[rb] = ra

    for n, job in jobs.items():
        # -- CLR002: orphan step ---------------------------------------
        if multi and not preds.get(n) and not succs.get(n):
            out.append(Diagnostic(
                code="CLR002", severity=Severity.WARNING, job=n,
                message=f"step {n!r} has no incoming or outgoing edges",
                fix="wire it into the DAG or drop it (intended for "
                    "couler.concurrent fan-outs)"))

        # -- CLR003: condition on an unproduced artifact ---------------
        if job.condition is not None or job.loop_condition is not None:
            for label, cond in (("condition", job.condition),
                                ("loop condition", job.loop_condition)):
                if cond is not None and _producer(cond.artifact) not in jobs:
                    out.append(Diagnostic(
                        code="CLR003", severity=Severity.ERROR, job=n,
                        message=f"{label} references artifact "
                                f"{cond.artifact!r} but no step named "
                                f"{_producer(cond.artifact)!r} produces it",
                        fix="add the producing step before the "
                            "conditional one, or drop the condition"))

        # -- CLR008: dangling declared input ---------------------------
        for art in job.inputs:
            if _producer(art) not in jobs:
                out.append(Diagnostic(
                    code="CLR008", severity=Severity.ERROR, job=n,
                    message=f"input artifact {art!r} has no producing "
                            f"step in this workflow",
                    fix=f"add a step named {_producer(art)!r} or remove "
                        f"the input"))

        # -- CLR004 / CLR009: streaming shape --------------------------
        if job.stream_input:
            streamed = [a for a in job.inputs
                        if _producer(a) in jobs
                        and jobs[_producer(a)].stream_output]
            if len(streamed) > 1:
                extras = [a for a in streamed if a != job.stream_arg]
                out.append(Diagnostic(
                    code="CLR004", severity=Severity.ERROR, job=n,
                    message=f"chunk-wise consumer {n!r} receives "
                            f"{len(streamed)} streamed inputs; only "
                            f"{job.stream_arg!r} is consumed chunk-wise — "
                            f"{', '.join(repr(a) for a in extras)} would "
                            f"be silently materialized whole",
                    fix="merge upstream streams into one producer, or "
                        "materialize the extra input through a plain "
                        "run_step stage"))
            if job.stream_arg:
                p = _producer(job.stream_arg)
                pj = jobs.get(p)
                if pj is not None and not pj.stream_output:
                    out.append(Diagnostic(
                        code="CLR009", severity=Severity.INFO, job=n,
                        message=f"chunk-wise consumer {n!r} maps over "
                                f"{job.stream_arg!r}, which is not "
                                f"streamed; chunks will be iterated from "
                                f"the materialized value with no overlap",
                        fix="produce the source with run_stream to "
                            "overlap the stages"))
                elif pj is not None:
                    union(p, n)

        # -- CLR005: fits no cluster -----------------------------------
        if clusters:
            r = job.resources
            if (r.cpu <= env_cpu and r.mem_bytes <= env_mem
                    and r.gpu <= env_gpu):
                pass                    # fits every cluster
            else:
                for c in clusters:
                    if (r.cpu <= c.cpu and r.mem_bytes <= c.mem_bytes
                            and r.gpu <= c.gpu + 1e-9):
                        break
                else:
                    caps = ", ".join(
                        f"{c.name}(cpu={c.cpu:g}, gpu={c.gpu:g})"
                        for c in clusters)
                    out.append(Diagnostic(
                        code="CLR005", severity=Severity.ERROR, job=n,
                        message=f"step {n!r} requests cpu={r.cpu:g} "
                                f"mem={r.mem_bytes} gpu={r.gpu:g}, "
                                f"exceeding every cluster's capacity: "
                                f"{caps}",
                        fix="shrink the request or add a cluster that "
                            "fits it"))

        # -- CLR007: nondeterministic cacheable step -------------------
        if job.cacheable and job.fn is not None:
            findings = nondeterminism_findings(job.fn)
            if findings:
                out.append(Diagnostic(
                    code="CLR007", severity=Severity.WARNING, job=n,
                    message=f"cacheable step {n!r} calls "
                            f"{', '.join(findings)} — nondeterministic "
                            f"output poisons the artifact cache",
                    fix="seed the RNG explicitly or mark the step "
                        "cacheable=False"))

    # -- CLR006: streaming component vs the in-flight bound ------------
    bound = ctx.max_inflight_steps
    if bound and comp:
        # component size = number of steps that must hold a slot at once
        sizes: Dict[str, int] = {}
        for n in list(comp):
            r = find(n)
            sizes[r] = sizes.get(r, 0) + 1
        for root, size in sizes.items():
            if size > bound:
                out.append(Diagnostic(
                    code="CLR006", severity=Severity.ERROR, job=root,
                    message=f"streaming pipeline of {size} chunk-wise "
                            f"connected steps needs {size} concurrent "
                            f"step slots but max_inflight_steps={bound}; "
                            f"the pipeline would deadlock",
                    fix=f"raise max_inflight_steps to >= {size} or break "
                        f"the pipeline into shorter stages"))
    return out


ALL_PASSES = (cycle_pass, step_pass)
