"""Backpressured multi-tenant admission queue (weighted round-robin).

Each tenant gets a bounded FIFO; ``offer`` sheds load with ``QueueFull``
when the tenant's queue (or the global bound) is at capacity — or blocks
until space frees when ``block=True`` (the sync facade's choice, so plain
``submit()`` never sheds). ``pop``/``drain`` serve tenants by classic
weighted round-robin: up to ``weight`` items from the current tenant, then
rotate — a tenant flooding its queue cannot starve the others.

The queue is plain-threading (no asyncio), so the same instance can feed
the asyncio ``WorkflowGateway`` pump *and* a batch scheduler
(``MultiClusterEngine.submit_admitted`` drains it into ``submit_many``).

The ``WORKFLOW_ADMITTED`` event is published under the queue lock, before
the item becomes poppable, so it always precedes any ``STEP_*`` event of
that run.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, TYPE_CHECKING

from repro_torch.core.gateway.events import EventType
from repro_torch.core.ir import WorkflowIR
from repro_torch.core.obs.metrics import MetricsRegistry, StatsView

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.gateway.run import AsyncWorkflowRun


class QueueFull(RuntimeError):
    """Shed-load signal: the tenant's (or the global) queue is full."""

    def __init__(self, tenant: str, depth: int, limit: int):
        super().__init__(f"admission queue full for tenant {tenant!r}: "
                         f"depth={depth} limit={limit}")
        self.tenant = tenant
        self.depth = depth
        self.limit = limit


@dataclass
class AdmittedItem:
    """One queued submission (workflow + tenant metadata + optional async
    handle for lifecycle events)."""

    wf: WorkflowIR
    tenant: str = "default"
    priority: int = 0
    optimize: bool = True
    resume: bool = False
    handle: Optional["AsyncWorkflowRun"] = None
    offered_at: float = field(default_factory=time.time)
    # times this run has re-entered the queue after failure (gateway
    # re-admission); the first offer of a handle is readmit_count == 0
    readmit_count: int = 0


class AdmissionQueue:
    """Bounded per-tenant queues drained in weighted round-robin order."""

    def __init__(self, max_depth_per_tenant: int = 1024,
                 max_total: int = 8192,
                 weights: Optional[Dict[str, int]] = None,
                 default_weight: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 tenant_retention_s: float = 300.0):
        self.max_depth_per_tenant = max_depth_per_tenant
        self.max_total = max_total
        self.weights = dict(weights or {})
        self.default_weight = max(1, default_weight)
        # per-tenant series label GC: a tenant idle (no offer / pop / shed)
        # longer than this is dropped from the registry so long-lived
        # gateways don't accumulate unbounded label cardinality
        self.tenant_retention_s = tenant_retention_s
        self._cv = threading.Condition()
        self._queues: Dict[str, Deque[AdmittedItem]] = {}
        self._ring: Deque[str] = deque()   # active tenants, WRR order
        self._credit = 0                   # remaining serves for ring[0]
        self._total = 0
        self._listeners: List[Callable[[], None]] = []
        # aggregate counters + per-tenant shed/depth series (the gateway
        # passes its registry in so everything lands in one snapshot);
        # the legacy ``stats`` dict is a read view over the aggregates
        self.registry = registry if registry is not None \
            else MetricsRegistry("admission")
        self._m = {k: self.registry.counter(f"admission_{k}_total")
                   for k in ("offered", "shed", "popped")}
        self._m_depth = self.registry.gauge("admission_depth")
        self.registry.gauge_fn("admission_tenants", lambda: len(self._ring))
        # separate attribute (not in self._m — the legacy StatsView dict
        # shape is pinned by tests)
        self._m_gc = self.registry.counter("admission_tenant_gc_total")
        self._last_active: Dict[str, float] = {}
        self._last_gc = time.time()

    @property
    def stats(self) -> StatsView:
        return StatsView(self._m)

    def _tenant_shed(self, tenant: str) -> None:
        self._m["shed"].inc()
        self.registry.counter("admission_shed_total", tenant=tenant).inc()
        self._last_active[tenant] = time.time()

    # -- producer side -----------------------------------------------------
    def add_listener(self, cb: Callable[[], None]) -> None:
        """Register a callback fired (outside the lock) after each
        successful offer — the gateway uses this to wake its pump."""
        with self._cv:
            self._listeners.append(cb)

    def offer(self, item: AdmittedItem, block: bool = False,
              timeout: Optional[float] = None) -> None:
        """Enqueue ``item`` or raise ``QueueFull``. With ``block=True``,
        wait (up to ``timeout``) for space instead of shedding."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                depth = len(self._queues.get(item.tenant, ()))
                if (depth < self.max_depth_per_tenant
                        and self._total < self.max_total):
                    break
                if not block:
                    self._tenant_shed(item.tenant)
                    raise QueueFull(item.tenant, depth,
                                    self.max_depth_per_tenant)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._tenant_shed(item.tenant)
                    raise QueueFull(item.tenant, depth,
                                    self.max_depth_per_tenant)
                if not self._cv.wait(remaining):
                    self._tenant_shed(item.tenant)
                    raise QueueFull(item.tenant, depth,
                                    self.max_depth_per_tenant)
            if item.handle is not None and not item.readmit_count:
                # under the lock, before the item is poppable: ADMITTED
                # is guaranteed to precede every STEP_* of this run.
                # Re-admitted runs already announced WORKFLOW_REQUEUED;
                # ADMITTED stays unique (invariant 1).
                item.handle._publish(EventType.WORKFLOW_ADMITTED)
            if item.tenant not in self._queues:
                self._queues[item.tenant] = deque()
                self._ring.append(item.tenant)
            self._queues[item.tenant].append(item)
            self._total += 1
            self._m["offered"].inc()
            self.registry.counter("admission_offered_total",
                                  tenant=item.tenant).inc()
            self._m_depth.inc()
            self.registry.gauge("admission_depth",
                                tenant=item.tenant).inc()
            self._last_active[item.tenant] = time.time()
            listeners = list(self._listeners)
        for cb in listeners:
            cb()
        if time.time() - self._last_gc > self.tenant_retention_s:
            self.gc_idle_tenants()

    def try_offer(self, item: AdmittedItem) -> bool:
        try:
            self.offer(item)
            return True
        except QueueFull:
            return False

    # -- consumer side (WRR) -----------------------------------------------
    def pop(self) -> Optional[AdmittedItem]:
        with self._cv:
            return self._pop_locked()

    def drain(self, max_n: Optional[int] = None) -> List[AdmittedItem]:
        """Pop up to ``max_n`` items (all, if None) in WRR order."""
        out: List[AdmittedItem] = []
        with self._cv:
            while max_n is None or len(out) < max_n:
                item = self._pop_locked()
                if item is None:
                    break
                out.append(item)
        return out

    def _pop_locked(self) -> Optional[AdmittedItem]:
        while self._ring:
            t = self._ring[0]
            q = self._queues.get(t)
            if not q:
                self._ring.popleft()
                self._queues.pop(t, None)
                self._credit = 0
                continue
            if self._credit <= 0:
                self._credit = max(1, int(self.weights.get(
                    t, self.default_weight)))
            item = q.popleft()
            self._total -= 1
            self._credit -= 1
            if not q:                       # tenant drained: leave the ring
                self._ring.popleft()
                self._queues.pop(t, None)
                self._credit = 0
            elif self._credit <= 0:         # served its weight: next tenant
                self._ring.rotate(-1)
            self._m["popped"].inc()
            self._m_depth.dec()
            self.registry.gauge("admission_depth", tenant=t).dec()
            self._last_active[t] = time.time()
            self._cv.notify_all()           # space freed: wake blocked offers
            return item
        return None

    # -- per-tenant label GC ------------------------------------------------
    def gc_idle_tenants(self, now: Optional[float] = None) -> List[str]:
        """Drop the per-tenant registry series (``tenant=`` label) of
        tenants idle longer than ``tenant_retention_s`` with nothing
        queued. Aggregate counters are untouched; a returning tenant just
        re-creates its series from zero. Returns the tenants dropped.
        Called opportunistically from ``offer`` and from the gateway's
        telemetry tick."""
        now = time.time() if now is None else now
        with self._cv:
            self._last_gc = now
            doomed = [t for t, ts in self._last_active.items()
                      if now - ts > self.tenant_retention_s
                      and t not in self._queues]
            for t in doomed:
                del self._last_active[t]
        for t in doomed:                    # registry has its own lock
            self.registry.drop_labeled("tenant", t)
            self._m_gc.inc()
        return doomed

    # -- introspection -----------------------------------------------------
    def depth(self, tenant: str) -> int:
        with self._cv:
            return len(self._queues.get(tenant, ()))

    def tenants(self) -> List[str]:
        with self._cv:
            return list(self._ring)

    def __len__(self) -> int:
        return self._total
