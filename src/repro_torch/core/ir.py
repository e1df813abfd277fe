"""Workflow Intermediate Representation (paper §II.C).

A workflow is ``G = <J, E, C>`` — jobs, edges, configurations — engine- and
platform-agnostic. All optimizers (caching §IV.A, auto-parallel split §IV.B)
and all backend generators (Argo YAML, Airflow DAG, local/cluster executors)
operate on this IR, which is what makes the programming interface unified.

Adjacency & cache-invalidation contract
---------------------------------------
``WorkflowIR`` maintains indexed adjacency maps (``_preds``/``_succs``)
incrementally so ``predecessors()``/``successors()`` are O(degree) instead
of O(|E|) — these are the inner-loop primitives of every scheduler, cache
scorer, and the auto-split DFS. Derived structure (topological order, the
default-order adjacency matrix, the name→index map) is computed lazily and
cached. The rules:

* All structural mutation MUST go through ``add_job``/``add_edge`` (or the
  constructors ``from_json``/``subgraph``). Direct writes to ``self.jobs``
  or ``self.edges`` bypass the indices and are unsupported.
* Every structural mutation bumps ``structure_version`` and drops the
  cached topo order / adjacency matrix / index map.
* Mutating *job attributes* (``est_time_s``, ``resources`` …) does not
  change structure, so it does not touch the caches above — but consumers
  that memoize attribute-dependent quantities (e.g. the cache scorer's
  reconstruction cost, Eq. 3) key their memos on ``weights_version``;
  engines that refine time estimates call ``note_weights_changed()``.
* ``topo_order()``/``adjacency()`` return fresh copies; callers may mutate
  the returned list/array freely.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass
class Resources:
    cpu: float = 1.0
    mem_bytes: int = 1 << 28
    gpu: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclass
class Condition:
    """Runtime predicate on an upstream artifact: kind in {equal, not_equal,
    greater, less, truthy}."""
    kind: str
    artifact: str
    value: Any = None

    def evaluate(self, artifacts: Dict[str, Any]) -> bool:
        v = artifacts.get(self.artifact)
        if self.kind == "equal":
            return v == self.value
        if self.kind == "not_equal":
            return v != self.value
        if self.kind == "greater":
            return v > self.value
        if self.kind == "less":
            return v < self.value
        return bool(v)


@dataclass
class Job:
    name: str
    fn: Optional[Callable] = None
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)    # artifact names
    outputs: List[str] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    retry_limit: int = 3
    kind: str = "script"                               # script|container|job
    image: str = ""
    command: List[str] = field(default_factory=list)
    condition: Optional[Condition] = None
    est_time_s: float = 1.0
    est_mem_bytes: int = 1 << 20
    cacheable: bool = True
    # loop metadata (exec_while)
    loop_condition: Optional[Condition] = None
    max_iterations: int = 16
    # streaming metadata: a stream_output job's fn is a generator whose
    # chunks flow through an ArtifactChannel; a stream_input job maps the
    # chunks of the upstream artifact named by stream_arg. A non-streaming
    # consumer of a streamed output sees the materialized list of chunks.
    stream_output: bool = False
    stream_input: bool = False
    stream_arg: Optional[str] = None
    stream_buffer_chunks: int = 8
    # checkpoint-wired step (couler.add_job(..., checkpoint=dir)): the fn
    # receives a ckpt= StepCheckpointSession saving/restoring through
    # training.checkpoint, so an intra-step kill resumes from the latest
    # checkpoint instead of the step's start
    checkpoint: Optional[str] = None

    def spec_size_bytes(self) -> int:
        """Serialized-spec size of this job — the CRD-size budget component."""
        d = {"name": self.name, "kind": self.kind, "image": self.image,
             "command": self.command, "inputs": self.inputs,
             "outputs": self.outputs, "resources": self.resources.as_dict()}
        return len(json.dumps(d))


class WorkflowIR:
    """DAG of jobs with artifact-labelled edges (see module docstring for
    the adjacency/invalidations contract)."""

    def __init__(self, name: str, configs: Optional[Dict] = None):
        self.name = name
        self.jobs: Dict[str, Job] = {}
        self.edges: Set[Tuple[str, str]] = set()
        self.configs: Dict[str, Any] = configs or {}
        # incrementally maintained adjacency indices
        self._preds: Dict[str, Set[str]] = {}
        self._succs: Dict[str, Set[str]] = {}
        # cheap acyclicity witness: job -> insertion index, and whether any
        # edge ever pointed from a later-inserted job to an earlier one.
        # All edges forward w.r.t. insertion order => acyclic, so the lint
        # cycle pass can skip its Kahn sweep for API-built workflows.
        self._insert_idx: Dict[str, int] = {}
        self._has_back_edge = False
        # lazily computed derived structure, dropped on mutation
        self._topo_cache: Optional[List[str]] = None
        self._index_cache: Optional[Dict[str, int]] = None
        self._adj_cache: Optional[np.ndarray] = None
        self._struct_version = 0
        self._weights_version = 0
        self._weights_counter = itertools.count(1)

    # -- versioning --------------------------------------------------------
    @property
    def structure_version(self) -> int:
        """Bumped on every add_job/add_edge; keys structural memos."""
        return self._struct_version

    @property
    def weights_version(self) -> int:
        """Bumped via note_weights_changed(); keys attribute-dependent
        memos (est_time_s feeds Eq. 3's w_i)."""
        return self._weights_version

    def note_weights_changed(self) -> None:
        # engines call this from pool worker threads; next() on the shared
        # counter is atomic, so concurrent bumps never collapse into one
        # observable value (a plain += could lose an update and leave
        # memo consumers serving stale Eq. 3 costs)
        self._weights_version = next(self._weights_counter)

    def _invalidate(self) -> None:
        self._struct_version += 1
        self._topo_cache = None
        self._index_cache = None
        self._adj_cache = None

    # -- construction ------------------------------------------------------
    def add_job(self, job: Job, _check_conditions: bool = True) -> Job:
        if job.name in self.jobs:
            return self.jobs[job.name]          # idempotent (paper's dag())
        if _check_conditions:
            self.check_condition_producers(job)
        self.jobs[job.name] = job
        self._insert_idx[job.name] = len(self.jobs)
        self._preds[job.name] = set()
        self._succs[job.name] = set()
        self._invalidate()
        return job

    def check_condition_producers(self, job: Job) -> None:
        """Eagerly reject a condition on an artifact nothing produces
        (diagnostic CLR003): the predicate could only ever evaluate over
        ``None``, so the mistake surfaced mid-run at the earliest. A job
        may condition on its own output (``exec_while`` loops do)."""
        for label, cond in (("condition", job.condition),
                            ("loop condition", job.loop_condition)):
            if cond is None:
                continue
            producer = cond.artifact.split(":")[0]
            if producer != job.name and producer not in self.jobs:
                raise ValueError(
                    f"workflow {self.name!r}: step {job.name!r} has a "
                    f"{label} on artifact {cond.artifact!r}, but no step "
                    f"named {producer!r} produces it (CLR003); add the "
                    f"producing step first or drop the condition")

    def add_edge(self, src: str, dst: str) -> None:
        if src not in self.jobs or dst not in self.jobs:
            raise KeyError(f"edge references unknown job: {src}->{dst}")
        if src == dst:
            raise ValueError(f"self-edge on {src}")
        if (src, dst) in self.edges:
            return                              # idempotent, keep caches
        self.edges.add((src, dst))
        if self._insert_idx[src] > self._insert_idx[dst]:
            self._has_back_edge = True
        self._succs[src].add(dst)
        self._preds[dst].add(src)
        self._invalidate()

    # -- structure ---------------------------------------------------------
    @property
    def job_names(self) -> List[str]:
        return list(self.jobs)

    def predecessors(self, name: str) -> List[str]:
        return list(self._preds.get(name, ()))

    def successors(self, name: str) -> List[str]:
        return list(self._succs.get(name, ()))

    def in_degree(self, name: str) -> int:
        return len(self._preds.get(name, ()))

    def out_degree(self, name: str) -> int:
        return len(self._succs.get(name, ()))

    def node_index(self) -> Dict[str, int]:
        """name -> position in job insertion order (cached)."""
        if self._index_cache is None:
            self._index_cache = {n: i for i, n in enumerate(self.jobs)}
        return self._index_cache

    def adjacency(self, order: Optional[Sequence[str]] = None) -> np.ndarray:
        if order is None:
            if self._adj_cache is None:
                self._adj_cache = self._build_adjacency(list(self.jobs))
            return self._adj_cache.copy()
        return self._build_adjacency(list(order))

    def _build_adjacency(self, order: List[str]) -> np.ndarray:
        idx = {n: i for i, n in enumerate(order)}
        A = np.zeros((len(order), len(order)), dtype=np.float64)
        for s in order:
            i = idx.get(s)
            if i is None:
                continue
            for d in self._succs.get(s, ()):
                j = idx.get(d)
                if j is not None:
                    A[i, j] = 1.0
        return A

    def degrees(self, order: Optional[Sequence[str]] = None) -> np.ndarray:
        A = self.adjacency(order)
        return A.sum(0) + A.sum(1)

    def topo_order(self) -> List[str]:
        if self._topo_cache is not None:
            return list(self._topo_cache)
        indeg = {n: len(self._preds[n]) for n in self.jobs}
        ready = deque(sorted(n for n, k in indeg.items() if k == 0))
        out: List[str] = []
        while ready:
            n = ready.popleft()
            out.append(n)
            for d in sorted(self._succs[n]):
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        if len(out) != len(self.jobs):
            raise ValueError(f"workflow {self.name} contains a cycle")
        self._topo_cache = out
        return list(out)

    def validate(self) -> None:
        self.topo_order()
        for s, d in self.edges:
            assert s in self.jobs and d in self.jobs

    def critical_path(self) -> Tuple[float, List[str]]:
        """Longest chain by est_time_s (paper Eq. 1: T = max over paths)."""
        finish: Dict[str, float] = {}
        parent: Dict[str, Optional[str]] = {}
        for n in self.topo_order():
            base, p = 0.0, None
            for q in self._preds[n]:
                if finish[q] > base:
                    base, p = finish[q], q
            finish[n] = base + self.jobs[n].est_time_s
            parent[n] = p
        if not finish:
            return 0.0, []
        end = max(finish, key=finish.get)
        path = [end]
        while parent[path[-1]] is not None:
            path.append(parent[path[-1]])
        return finish[end], list(reversed(path))

    def peak_parallel_mem(self) -> float:
        """Paper Eq. 2 proxy: S = max over antichains of summed job memory.
        Approximated by levels of the topological order."""
        level: Dict[str, int] = {}
        for n in self.topo_order():
            level[n] = 1 + max((level[p] for p in self._preds[n]), default=-1)
        by_level: Dict[int, float] = {}
        for n, l in level.items():
            by_level[l] = by_level.get(l, 0.0) + self.jobs[n].est_mem_bytes
        return max(by_level.values(), default=0.0)

    # -- budget (paper §IV.B): C = alpha(spec bytes) + beta(steps) + gamma(pods)
    def budget(self) -> Dict[str, float]:
        alpha = sum(j.spec_size_bytes() for j in self.jobs.values())
        beta = len(self.jobs)
        gamma = sum(max(1.0, j.resources.cpu) for j in self.jobs.values())
        return {"spec_bytes": alpha, "steps": beta, "pods": gamma}

    def subgraph(self, names: Sequence[str], name: str) -> "WorkflowIR":
        sub = WorkflowIR(name, dict(self.configs))
        keep = set(names)
        for n in names:
            # shares Job objects; a condition's producer may land in a
            # sibling part, so the eager CLR003 check is skipped here
            sub.add_job(self.jobs[n], _check_conditions=False)
        for n in names:
            for d in self._succs.get(n, ()):
                if d in keep:
                    sub.add_edge(n, d)
        return sub

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        def job_dict(j: Job):
            d = {k: v for k, v in dataclasses.asdict(j).items()
                 if k not in ("fn", "args", "kwargs", "condition",
                              "loop_condition", "resources")}
            d["resources"] = j.resources.as_dict()
            if j.condition:
                d["condition"] = dataclasses.asdict(j.condition)
            if j.loop_condition:
                d["loop_condition"] = dataclasses.asdict(j.loop_condition)
            return d
        return json.dumps({
            "name": self.name,
            "configs": {k: v for k, v in self.configs.items()
                        if isinstance(v, (int, float, str, bool, list, dict))},
            "jobs": [job_dict(j) for j in self.jobs.values()],
            "edges": sorted(self.edges),
        }, indent=1, default=str)

    @classmethod
    def from_json(cls, text: str) -> "WorkflowIR":
        d = json.loads(text)
        wf = cls(d["name"], d.get("configs", {}))
        for jd in d["jobs"]:
            cond = jd.pop("condition", None)
            loop = jd.pop("loop_condition", None)
            res = jd.pop("resources", None)
            job = Job(**{k: v for k, v in jd.items()
                         if k in {f.name for f in dataclasses.fields(Job)}})
            if res:
                job.resources = Resources(**res)
            if cond:
                job.condition = Condition(**cond)
            if loop:
                job.loop_condition = Condition(**loop)
            wf.add_job(job)
        for s, d_ in d["edges"]:
            wf.add_edge(s, d_)
        return wf

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]
