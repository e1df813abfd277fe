"""Per-tenant SLO objectives with multi-window burn-rate alerting.

An ``SLO`` names a tenant's objectives; three are supported, matching
what the gateway can actually measure per finished run:

* ``completion_rate`` — fraction of runs ending ``Succeeded``. The error
  budget is ``1 - completion_rate``; a window's **burn rate** is its
  observed failure fraction divided by that budget (burn 1.0 = exactly
  spending budget, >1 = over-spending).
* ``p99_queue_wait_s`` — admission-to-first-processing latency bound.
  Latency SLOs burn against a fixed violation budget: at p99 the budget
  is 1% of runs, so burn = (fraction of runs waiting longer) / 0.01.
* ``makespan_budget_s`` — per-run wall-clock budget, evaluated at p95
  (violation budget 5%).

Evaluation uses the classic **multi-window** rule: an objective fires
only when BOTH the short window (fast signal) and the long window
(sustained evidence) burn above ``burn_threshold`` — a lone hiccup in
the short window or stale history in the long one cannot fire alone.
Each firing yields an ``Alert`` (detector ``slo_burn``) carrying both
burns and the window sizes in its context.

``nudge(queue)`` is the optional control-loop half: tenants currently
burning get their ``AdmissionQueue`` weighted-round-robin weight
multiplied by ``nudge_factor`` (capped), and recover their base weight
once the burn clears — SLO pressure translates into scheduling priority
without touching the queue's fairness machinery.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.obs.anomaly import Alert
from repro_torch.core.obs.metrics import MetricsRegistry

__all__ = ["SLO", "SLOMonitor"]

#: latency objectives burn against a fixed violation-fraction budget
_P99_BUDGET = 0.01
_P95_BUDGET = 0.05


@dataclass(frozen=True)
class SLO:
    """One tenant's objectives (None disables an objective)."""

    tenant: str = "default"
    completion_rate: Optional[float] = 0.95
    p99_queue_wait_s: Optional[float] = None
    makespan_budget_s: Optional[float] = None

    def __post_init__(self):
        if self.completion_rate is not None \
                and not 0.0 < self.completion_rate < 1.0:
            raise ValueError("completion_rate must be in (0, 1)")


# one finished run: (ts, succeeded, makespan_s, queue_wait_s)
_RunPoint = Tuple[float, bool, float, float]


class SLOMonitor:
    """Rolling per-tenant run records + multi-window burn evaluation."""

    def __init__(self, objectives: Iterable[SLO],
                 short_window_s: float = 60.0,
                 long_window_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 min_runs: int = 5,
                 nudge_factor: int = 2,
                 max_weight: int = 8,
                 history: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.objectives: Dict[str, SLO] = {}
        for slo in objectives:
            if slo.tenant in self.objectives:
                raise ValueError(f"duplicate SLO for tenant {slo.tenant!r}")
            self.objectives[slo.tenant] = slo
        self.short_window_s = short_window_s
        self.long_window_s = long_window_s
        self.burn_threshold = burn_threshold
        self.min_runs = min_runs
        self.nudge_factor = max(1, nudge_factor)
        self.max_weight = max_weight
        self.history = history
        self._lock = threading.Lock()
        self._runs: Dict[str, Deque[_RunPoint]] = {}
        self.alerts: Deque[Alert] = deque(maxlen=1024)
        self._registry = registry
        # tenants currently burning (per last evaluate) and the base
        # weights nudge() overrode, for restoration on recovery
        self._burning: Dict[str, List[str]] = {}
        self._base_weights: Dict[str, int] = {}

    def bind(self, registry: MetricsRegistry) -> "SLOMonitor":
        self._registry = registry
        return self

    # -- feed (gateway loop thread, at WORKFLOW_DONE) ----------------------
    def note_run(self, tenant: str, ok: bool, makespan_s: float = 0.0,
                 queue_wait_s: float = 0.0,
                 ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            dq = self._runs.get(tenant)
            if dq is None:
                dq = deque(maxlen=self.history)
                self._runs[tenant] = dq
            dq.append((ts, ok, makespan_s, queue_wait_s))

    # -- evaluation --------------------------------------------------------
    def _objective_burns(self, slo: SLO, now: float
                         ) -> List[Tuple[str, float, float, float, int, int]]:
        """Per enabled objective: (name, budget, burn_short, burn_long,
        n_short, n_long). One fused pass over the tenant's run ring
        counts both windows and every violation kind at once — this runs
        for every tenant on every telemetry tick, so it must not build
        per-window lists per objective."""
        lo_s = now - self.short_window_s
        lo_l = now - self.long_window_s
        qbound = slo.p99_queue_wait_s
        mbound = slo.makespan_budget_s
        n_s = n_l = 0
        fail_s = fail_l = qw_s = qw_l = mk_s = mk_l = 0
        for ts, ok, mk, qw in self._runs.get(slo.tenant, ()):
            in_s, in_l = ts >= lo_s, ts >= lo_l
            if not (in_s or in_l):
                continue
            if in_s:
                n_s += 1
            if in_l:
                n_l += 1
            if not ok:
                fail_s += in_s
                fail_l += in_l
            if qbound is not None and qw > qbound:
                qw_s += in_s
                qw_l += in_l
            if mbound is not None and mk > mbound:
                mk_s += in_s
                mk_l += in_l

        def burn(n_bad: int, n: int, budget: float) -> float:
            return (n_bad / n) / budget if n and budget > 0 else 0.0

        out = []
        if slo.completion_rate is not None:
            budget = 1.0 - slo.completion_rate
            out.append(("completion_rate", budget,
                        burn(fail_s, n_s, budget), burn(fail_l, n_l, budget),
                        n_s, n_l))
        if qbound is not None:
            out.append(("p99_queue_wait_s", _P99_BUDGET,
                        burn(qw_s, n_s, _P99_BUDGET),
                        burn(qw_l, n_l, _P99_BUDGET), n_s, n_l))
        if mbound is not None:
            out.append(("makespan_budget_s", _P95_BUDGET,
                        burn(mk_s, n_s, _P95_BUDGET),
                        burn(mk_l, n_l, _P95_BUDGET), n_s, n_l))
        return out

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """Multi-window burn evaluation for every tenant; returns (and
        logs) the alerts fired this pass. Objectives with fewer than
        ``min_runs`` runs in the short window never fire."""
        now = time.time() if now is None else now
        fired: List[Alert] = []
        with self._lock:
            burning: Dict[str, List[str]] = {}
            for tenant, slo in self.objectives.items():
                for (name, budget, b_s, b_l, n_s, n_l) \
                        in self._objective_burns(slo, now):
                    if n_s < self.min_runs:
                        continue
                    if b_s > self.burn_threshold \
                            and b_l > self.burn_threshold:
                        burning.setdefault(tenant, []).append(name)
                        fired.append(Alert(
                            detector="slo_burn",
                            reason=(f"tenant {tenant!r} burning {name} "
                                    f"error budget at {b_s:.1f}x (short "
                                    f"{self.short_window_s:.0f}s) / "
                                    f"{b_l:.1f}x (long "
                                    f"{self.long_window_s:.0f}s); "
                                    f"threshold {self.burn_threshold:.1f}x"),
                            value=min(b_s, b_l),
                            threshold=self.burn_threshold,
                            ts=now, scope=tenant, severity="critical",
                            context={"burn_short": b_s, "burn_long": b_l,
                                     "budget": budget,
                                     "n_short": float(n_s),
                                     "n_long": float(n_l),
                                     "short_window_s": self.short_window_s,
                                     "long_window_s": self.long_window_s}))
            self._burning = burning
            for a in fired:
                self.alerts.append(a)
                if self._registry is not None:
                    self._registry.counter("alerts_total",
                                           detector="slo_burn").inc()
        return fired

    # -- dashboard view ----------------------------------------------------
    def status(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """Per-tenant compliance snapshot (the dashboard's SLO table)."""
        now = time.time() if now is None else now
        out: Dict[str, Dict] = {}
        with self._lock:
            for tenant, slo in self.objectives.items():
                objs = {}
                for (name, budget, b_s, b_l, n_s, n_l) \
                        in self._objective_burns(slo, now):
                    objs[name] = {"burn_short": b_s, "burn_long": b_l,
                                  "n_short": n_s, "n_long": n_l,
                                  "burning": (n_s >= self.min_runs
                                              and b_s > self.burn_threshold
                                              and b_l > self.burn_threshold)}
                out[tenant] = {
                    "objectives": objs,
                    "burning": tenant in self._burning,
                    "runs_seen": len(self._runs.get(tenant, ())),
                }
        return out

    # -- admission priority nudge ------------------------------------------
    def nudge(self, queue) -> Dict[str, int]:
        """Translate burn into WRR priority: burning tenants get their
        queue weight multiplied by ``nudge_factor`` (capped at
        ``max_weight``); recovered tenants get their base weight back.
        Returns the weights changed this call."""
        changed: Dict[str, int] = {}
        with self._lock:
            burning = set(self._burning)
            for tenant in burning:
                base = self._base_weights.get(tenant)
                if base is None:
                    base = int(queue.weights.get(tenant,
                                                 queue.default_weight))
                    self._base_weights[tenant] = base
                w = min(self.max_weight, base * self.nudge_factor)
                if queue.weights.get(tenant) != w:
                    queue.weights[tenant] = w
                    changed[tenant] = w
            for tenant in list(self._base_weights):
                if tenant in burning:
                    continue
                base = self._base_weights.pop(tenant)
                if queue.weights.get(tenant) != base:
                    queue.weights[tenant] = base
                    changed[tenant] = base
        return changed
