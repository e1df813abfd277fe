"""Eq. 3-6 scoring primitives for the artifact cache (paper §IV.A).

The *caching importance factor* of artifact u:

    I(u) = alpha * log(1 + L(u)) + beta * F(u)^2 - e^(-V(u))        (Eq. 6)

  L(u)  reconstruction cost over the n-layer predecessor subgraph G_p,
        truncated at already-cached artifacts:
            L(u) = sum_ij A_ij * (w_i + d_i * d_j)                  (Eq. 3)
  F(u)  reuse value over the successor subgraph G_s:
            F(u) = sum_i r / kappa_ui * (zeta_ui + 1)               (Eq. 4)
        with zeta = diag(d) - A (graph Laplacian)                   (Eq. 5)
  V(u)  cache (memory) cost of u, normalized to the holding tier's
        capacity (single-tier stores normalize to the store capacity).

Eq. 4 literal-vs-deviation
--------------------------
Taken literally, zeta_ui = -A_ui makes every DIRECT successor contribute
(zeta + 1) = 0 to F(u), which contradicts Eq. 4's stated intent (F measures
the value of reuse by successors — direct dependents should count *most*).
``reuse_value`` therefore defaults to ``literal_eq4=False``: it keeps the
Laplacian structure but weights by |zeta_ui| so direct dependents dominate.
Pass ``literal_eq4=True`` (or ``CoulerPolicy(literal_eq4=True)``) for the
equation exactly as printed. Both behaviors are pinned by
``tests/test_cache_tiers.py::test_reuse_value_literal_vs_deviation``; the
deviation is the project default until a reference trace says otherwise.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.ir import WorkflowIR


def sizeof(value: Any) -> int:
    try:
        import numpy as _np
        if isinstance(value, _np.ndarray):
            return int(value.nbytes)
    except Exception:
        pass
    if hasattr(value, "nbytes"):
        try:
            return int(value.nbytes)
        except Exception:
            pass
    if isinstance(value, (bytes, bytearray, str)):
        return len(value)
    if isinstance(value, (list, tuple)):
        return 64 + sum(sizeof(v) for v in value)
    if isinstance(value, dict):
        return 64 + sum(sizeof(k) + sizeof(v) for k, v in value.items())
    return 64


@dataclass
class CachedArtifact:
    name: str
    value: Any
    bytes: int
    compute_time_s: float
    producer: str                      # job name
    created: float = field(default_factory=time.time)
    last_used: float = field(default_factory=time.time)
    uses: int = 0
    insertion: int = 0                 # FIFO order
    # weakref to the producing WorkflowIR (set when the engine offers with
    # workflow=...): scoring resolves the producer in THIS DAG instead of
    # whichever workflow was attached last — the per-artifact scoring
    # context that makes concurrent workflows sharing a store stop
    # invalidating each other. None falls back to store.workflow.
    wf_ref: Any = None


def predecessor_subgraph(wf: WorkflowIR, job: str, n_layers: int,
                         cached_producers: set) -> List[str]:
    """G_p: preceding n layers from u's producer; truncated at cached jobs
    (paper §IV.A.2 properties (a),(b))."""
    frontier = [job]
    seen = {job}
    for _ in range(n_layers):
        nxt = []
        for j in frontier:
            for p in wf.predecessors(j):
                if p in seen:
                    continue
                seen.add(p)
                if p in cached_producers:
                    continue            # truncate at cached artifact
                nxt.append(p)
        frontier = nxt
        if not frontier:
            break
    return list(seen)


def successor_subgraph(wf: WorkflowIR, job: str, n_layers: int) -> Dict[str, int]:
    """G_s with hop distance kappa from u's producer."""
    dist = {job: 0}
    frontier = [job]
    for k in range(1, n_layers + 1):
        nxt = []
        for j in frontier:
            for s in wf.successors(j):
                if s not in dist:
                    dist[s] = k
                    nxt.append(s)
        frontier = nxt
        if not frontier:
            break
    return dist


def reconstruction_cost(wf: WorkflowIR, job: str, cached_producers: set,
                        n_layers: int = 3) -> float:
    """Eq. 3: L(u) = sum_ij A_ij (w_i + d_i d_j) over G_p."""
    nodes = predecessor_subgraph(wf, job, n_layers, cached_producers)
    A = wf.adjacency(nodes)
    d = A.sum(0) + A.sum(1)
    w = np.array([wf.jobs[n].est_time_s * max(1.0, wf.jobs[n].resources.cpu)
                  for n in nodes])
    # A_ij * (w_i + d_i*d_j), vectorized
    cost = float((A * (w[:, None] + np.outer(d, d))).sum())
    return cost


def reuse_value(wf: WorkflowIR, job: str, n_layers: int = 3,
                literal_eq4: bool = False) -> float:
    """Eq. 4/5: F(u) = sum_i r/kappa_ui * (zeta_ui + 1), zeta = diag(d) - A.

    ``literal_eq4=False`` (default) weights by |zeta_ui| instead of zeta_ui
    so direct successors count most — see the module docstring for why the
    literal equation zeroes them out."""
    dist = successor_subgraph(wf, job, n_layers)
    nodes = list(dist)
    if len(nodes) <= 1:
        return 0.0
    A = wf.adjacency(nodes)
    d = A.sum(0) + A.sum(1)
    zeta = np.diag(d) - A
    u = nodes.index(job)
    total = 0.0
    for i, n in enumerate(nodes):
        if n == job:
            continue
        kappa = dist[n]
        r = 1.0                           # reuse event indicator
        z = zeta[u, i] if literal_eq4 else abs(zeta[u, i])
        total += (r / max(kappa, 1)) * (z + 1.0)
    return float(total)


def importance(l: float, f: float, v: float, alpha: float = 1.5,
               beta: float = 1.0) -> float:
    """Eq. 6 (alpha=1.5, beta=1 per paper §VI.C)."""
    return alpha * math.log1p(max(l, 0.0)) + beta * f * f - math.exp(-v)
