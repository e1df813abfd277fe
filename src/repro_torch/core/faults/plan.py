"""Deterministic fault injection — the chaos half of App. B.B's
reliability story.

``FaultPlan`` is a pure, seedable description of WHAT may fail: per-site
probabilities for transient step crashes, permanent crashes, worker loss
(the pool slot running a step dies mid-execution), and simulated cluster
preemption (``MultiClusterEngine``: a cluster goes dark, its in-flight
jobs are evicted, capacity returns after ``preemption_dark_s``).

``ChaosInjector`` is the runtime the engines consult:

* ``LocalEngine`` calls ``begin_attempt(workflow, step)`` at the start of
  every execution attempt (step boundary). The returned fault, if any, is
  raised either before the fn runs (crashes) or after it ran with the
  result discarded (worker loss — the work happened, the slot carrying
  the result died).
* Checkpoint-wired steps (``couler.add_job(..., checkpoint=...)``) get
  their worker-loss faults delivered MID-STEP instead: ``begin_attempt``
  also returns a kill iteration, and the ``StepCheckpointSession`` raises
  at that tick — exercising resume-from-latest-checkpoint rather than
  restart-from-step-start.
* ``MultiClusterEngine`` draws per-cluster preemption times from
  ``random.Random(f"{seed}:{cluster}")`` inside its event-driven
  simulator.

Decisions derive from ``sha256(seed | site | consult-index)``, so a
replay with the same plan injects the identical fault sequence regardless
of wall-clock timing or thread interleaving: a step's attempts are
sequential, which makes the per-site consult counter deterministic. The
counter never resets — not on retry, not on workflow re-admission — so
``max_failures_per_site`` is a hard cap guaranteeing convergence: after
that many injected faults a site runs clean forever.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

from repro_torch.core.engines.base import TransientError
from repro_torch.core.obs.metrics import MetricsRegistry, StatsView


class InjectedFault(Exception):
    """Marker mixin: distinguishes injected faults from organic errors."""


class InjectedCrash(InjectedFault, TransientError):
    """Transient step crash (matches the controller's retryable set)."""


class WorkerLost(InjectedFault, TransientError):
    """The pool slot executing a step died; any un-persisted result is
    gone. Transient — the controller retries the step."""


class InjectedPermanentCrash(InjectedFault, RuntimeError):
    """Non-transient crash: the retry loop must NOT absorb it (the step
    fails, and recovery — if any — happens at re-admission scope)."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of the faults to inject. All rates are
    per-attempt probabilities in [0, 1]; they partition one uniform draw
    (crash, then permanent, then worker loss), so their sum must be <= 1.
    """

    seed: int = 0
    crash_rate: float = 0.0            # transient InjectedCrash
    permanent_rate: float = 0.0        # InjectedPermanentCrash
    worker_loss_rate: float = 0.0      # WorkerLost (mid-step for ckpt steps)
    # checkpoint-wired steps: the kill iteration is drawn uniformly from
    # [0, mid_step_kill_window)
    mid_step_kill_window: int = 8
    # MultiClusterEngine: per-cluster Poisson preemption process
    preemption_rate_per_s: float = 0.0
    preemption_dark_s: float = 5.0
    # hard per-(workflow, step) injection cap — guarantees convergence
    max_failures_per_site: int = 3
    # restrict injection to these sites — entries match a bare step name
    # or a qualified "workflow/step" (None = every step)
    targets: Optional[FrozenSet[str]] = None
    # straggler injection (telemetry/anomaly exercises): per-attempt
    # probability of delaying a step by straggler_delay_s before it runs.
    # Drawn from a separate consult sequence ("straggler" coords), so
    # enabling it never perturbs the crash/loss fault replay above.
    straggler_rate: float = 0.0
    straggler_delay_s: float = 0.25

    def __post_init__(self):
        total = self.crash_rate + self.permanent_rate + self.worker_loss_rate
        if total > 1.0 + 1e-9:
            raise ValueError(f"fault rates sum to {total} > 1")

    def _u(self, *coords: str) -> float:
        """Deterministic uniform in [0, 1) keyed on (seed, *coords)."""
        h = hashlib.sha256(
            "|".join((str(self.seed),) + coords).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64


class ChaosInjector:
    """Runtime consulted by the engines; thread-safe, deterministic.

    One ``begin_attempt`` call per execution attempt per site. The
    per-site consult counter is monotonic across retries AND workflow
    re-admissions (it lives here, not in the ``StepRecord`` the gateway
    resets), so the injected sequence replays identically and the
    ``max_failures_per_site`` cap always converges.
    """

    def __init__(self, plan: FaultPlan,
                 registry: Optional[MetricsRegistry] = None):
        self.plan = plan
        self._lock = threading.Lock()
        self._consults: Dict[Tuple[str, str], int] = {}
        self._injected: Dict[Tuple[str, str], int] = {}
        self._straggler_consults: Dict[Tuple[str, str], int] = {}
        self._m_straggler = None
        self.registry = registry if registry is not None \
            else MetricsRegistry("chaos")
        self._m = {
            "consults": self.registry.counter("chaos_consults_total"),
            "crash": self.registry.counter("chaos_injected_total",
                                           kind="crash"),
            "crash_permanent": self.registry.counter(
                "chaos_injected_total", kind="crash_permanent"),
            "worker_lost": self.registry.counter("chaos_injected_total",
                                                 kind="worker_lost"),
            "mid_step_kill": self.registry.counter(
                "chaos_mid_step_kills_total"),
        }

    @property
    def stats(self) -> StatsView:
        return StatsView(self._m)

    def begin_attempt(self, workflow: str, step: str,
                      checkpointed: bool = False
                      ) -> Tuple[Optional[BaseException], Optional[int]]:
        """Consult the plan for one execution attempt of (workflow, step).

        Returns ``(fault, kill_iteration)``: both None for a clean
        attempt; ``(exc, None)`` to fail at the step boundary;
        ``(WorkerLost, k)`` (checkpointed steps only) to kill the slot at
        iteration ``k`` of the step body — the engine wires ``k`` into the
        ``StepCheckpointSession`` tick.
        """
        plan = self.plan
        site = (workflow, step)
        with self._lock:
            k = self._consults.get(site, 0)
            self._consults[site] = k + 1
            self._m["consults"].inc()
            if plan.targets is not None and step not in plan.targets \
                    and f"{workflow}/{step}" not in plan.targets:
                return None, None
            if self._injected.get(site, 0) >= plan.max_failures_per_site:
                return None, None
            u = plan._u("step", workflow, step, str(k))
            lo = plan.crash_rate
            if u < lo:
                kind = "crash"
            elif u < (lo := lo + plan.permanent_rate):
                kind = "crash_permanent"
            elif u < lo + plan.worker_loss_rate:
                kind = "worker_lost"
            else:
                return None, None
            self._injected[site] = self._injected.get(site, 0) + 1
            self._m[kind].inc()
            tag = f"{workflow}/{step} consult {k}"
            if kind == "crash":
                return InjectedCrash(f"injected transient crash: {tag}"), None
            if kind == "crash_permanent":
                return InjectedPermanentCrash(
                    f"injected permanent crash: {tag}"), None
            exc = WorkerLost(f"injected worker loss: {tag}")
            if checkpointed:
                self._m["mid_step_kill"].inc()
                at = int(plan._u("kill-iter", workflow, step, str(k))
                         * max(1, plan.mid_step_kill_window))
                return exc, at
            return exc, None

    def straggler_delay(self, workflow: str, step: str) -> float:
        """Consult the plan's straggler process for one attempt: returns
        the delay to sleep before executing (0.0 for a clean attempt).
        Separate consult counter and coord prefix from ``begin_attempt``,
        so the crash/loss draw sequence is unchanged by straggler use."""
        plan = self.plan
        if plan.straggler_rate <= 0.0:
            return 0.0
        site = (workflow, step)
        with self._lock:
            k = self._straggler_consults.get(site, 0)
            self._straggler_consults[site] = k + 1
            if plan.targets is not None and step not in plan.targets \
                    and f"{workflow}/{step}" not in plan.targets:
                return 0.0
            if plan._u("straggler", workflow, step, str(k)) \
                    >= plan.straggler_rate:
                return 0.0
            # lazy: the series only exists once a straggler actually fires
            # (keeps pre-existing snapshot shapes stable when unused)
            if self._m_straggler is None:
                self._m_straggler = self.registry.counter(
                    "chaos_injected_total", kind="straggler")
            self._m_straggler.inc()
            return plan.straggler_delay_s

    def injected_at(self, workflow: str, step: str) -> int:
        with self._lock:
            return self._injected.get((workflow, step), 0)
