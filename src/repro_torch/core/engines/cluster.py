"""Multi-cluster workflow scheduling (paper App. B.A).

Ant Group schedules workflows across heterogeneous clusters via a weighted
queue over: (a) workflow priority, (b) cluster CPU/memory capacity,
(c) user CPU/memory quota, (d) user GPU quota — keeping cluster loads
balanced. This module implements that scheduler over an event-driven
simulator (time advances to the next job completion; no sleeping), which is
what the RQ1-style throughput benchmark drives with 22k workflows/day-scale
loads.

Scheduling is fully event-driven: each workflow keeps a min-heap of ready
job indices fed by indegree decrements, and resource-blocked jobs park in
wake-on-cause retry sets — user-quota-blocked jobs are only re-tried when a
job of that same user completes (the only event that can lower the user's
usage), cluster-blocked jobs whenever any completion frees cluster capacity
— so each event touches O(woken + newly-ready) jobs, O((V+E)·log V) per
batch, instead of the former full rescan of every job of every active
workflow per event.

Artifact locality (tiered-cache integration)
--------------------------------------------
Pass ``caches`` (cluster name → ``TieredCacheStore``, ideally all sharing
one ``SharedRemoteTier``) to make placement locality-aware: a finished
job's artifact is offered to its cluster's store, and a consumer job is
placed on the fitting cluster minimizing its input materialization cost —
per input, ``min(fetch, recompute)`` where fetch is the holding tier's
``latency + bytes/bandwidth`` (or the cross-cluster transfer path when the
artifact is only resident elsewhere) and recompute is the Eq. 3-style
first-hop reconstruction cost (producer est_time_s). The winning cost is
added to the job's simulated duration, so makespans reflect data movement
instead of assuming uniform hit latency. With ``caches=None`` (default)
scheduling is bit-identical to the cache-oblivious behavior.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.cache.store import TieredCacheStore
from repro_torch.core.engines.base import Engine, StepRecord, StepStatus, WorkflowRun
from repro_torch.core.faults.plan import FaultPlan
from repro_torch.core.gateway.events import EventType
from repro_torch.core.ir import WorkflowIR
from repro_torch.core.obs.metrics import MetricsRegistry, StatsView


@dataclass
class Cluster:
    name: str
    cpu: float
    mem_bytes: float
    gpu: float = 0.0
    used_cpu: float = 0.0
    used_mem: float = 0.0
    used_gpu: float = 0.0
    # simulated preemption (FaultPlan): no placements while the sim clock
    # is before dark_until
    dark_until: float = 0.0

    def fits(self, job) -> bool:
        r = job.resources
        return (self.used_cpu + r.cpu <= self.cpu
                and self.used_mem + r.mem_bytes <= self.mem_bytes
                and self.used_gpu + r.gpu <= self.gpu + 1e-9)

    def load(self) -> float:
        return max(self.used_cpu / max(self.cpu, 1e-9),
                   self.used_mem / max(self.mem_bytes, 1e-9))


@dataclass
class UserQuota:
    cpu: float = 64.0
    mem_bytes: float = 64 * 2**30
    gpu: float = 4.0
    used_cpu: float = 0.0
    used_mem: float = 0.0
    used_gpu: float = 0.0

    def fits(self, job) -> bool:
        r = job.resources
        return (self.used_cpu + r.cpu <= self.cpu
                and self.used_mem + r.mem_bytes <= self.mem_bytes
                and self.used_gpu + r.gpu <= self.gpu + 1e-9)


@dataclass(order=True)
class _QItem:
    sort_key: Tuple                     # (-priority, seq): FIFO within a tier
    wf: WorkflowIR = field(compare=False)
    user: str = field(compare=False)
    priority: int = field(compare=False)
    submit_t: float = field(compare=False)


class _WfState:
    """Per-admitted-workflow scheduling state."""

    __slots__ = ("wf", "user", "run", "indeg", "remaining", "order", "jidx",
                 "ready", "idx")

    def __init__(self, wf: WorkflowIR, user: str, idx: int):
        self.wf = wf
        self.user = user
        self.idx = idx                      # admission order
        self.run = WorkflowRun(workflow=wf)
        self.order = list(wf.jobs)          # job insertion order
        self.jidx = {n: i for i, n in enumerate(self.order)}
        self.indeg = {n: wf.in_degree(n) for n in self.order}
        self.remaining = len(self.order)
        # min-heap of job indices whose deps are satisfied but not launched
        self.ready: List[int] = [i for i, n in enumerate(self.order)
                                 if self.indeg[n] == 0]
        heapq.heapify(self.ready)
        for n in self.order:
            self.run.steps[n] = StepRecord()


class MultiClusterEngine(Engine):
    """Event-driven simulation of the cross-cluster scheduling queue."""

    name = "cluster"

    def __init__(self, clusters: Optional[List[Cluster]] = None,
                 quotas: Optional[Dict[str, UserQuota]] = None,
                 caches: Optional[Dict[str, "TieredCacheStore"]] = None,
                 xfer_bandwidth_bytes_s: float = 1.2e8,
                 xfer_latency_s: float = 2e-2,
                 fault_plan: Optional[FaultPlan] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.clusters = clusters or [
            Cluster("gpu-cluster", cpu=512, mem_bytes=2048 * 2**30, gpu=64),
            Cluster("cpu-cluster", cpu=2048, mem_bytes=8192 * 2**30),
            Cluster("far-storage", cpu=1024, mem_bytes=4096 * 2**30),
        ]
        # precomputed candidate list: GPU jobs may only land on GPU clusters
        self._gpu_clusters = [c for c in self.clusters if c.gpu > 0]
        self.quotas = quotas or {}
        # per-cluster tiered artifact stores (None = cache-oblivious)
        self.caches = caches
        self.xfer_bandwidth_bytes_s = xfer_bandwidth_bytes_s
        self.xfer_latency_s = xfer_latency_s
        # simulated cluster preemption (FaultPlan.preemption_rate_per_s):
        # per-cluster Poisson process; a struck cluster goes dark for
        # preemption_dark_s, its in-flight jobs are evicted and re-enter
        # their ready queues (re-placed elsewhere or parked until recovery)
        self.fault_plan = fault_plan
        self._seq = itertools.count()
        # scheduler telemetry in registry instruments; ``metrics`` stays a
        # dict-compatible view (the equivalence suite compares it per-key
        # against a plain-dict reference, including the nested
        # ``cluster_busy_s`` map — float accumulation order is identical
        # because Counter.inc is the same ``+=`` under a lock)
        self.registry = registry if registry is not None \
            else MetricsRegistry("cluster")
        self._m = {
            "scheduled_jobs":
                self.registry.counter("cluster_scheduled_jobs_total"),
            "completed_workflows":
                self.registry.counter("cluster_completed_workflows_total"),
            "failed_admission":
                self.registry.counter("cluster_failed_admission_total"),
            "makespan_s": self.registry.gauge("cluster_makespan_s"),
            "fetch_wait_s": self.registry.counter("cluster_fetch_wait_s"),
            "recompute_wait_s":
                self.registry.counter("cluster_recompute_wait_s"),
            "preemptions": self.registry.counter("cluster_preemptions_total"),
            "preempted_jobs":
                self.registry.counter("cluster_preempted_jobs_total"),
        }
        # pre-created so every cluster reports a (possibly zero) series
        self._m_busy = {c.name: self.registry.counter("cluster_busy_cpu_s",
                                                      cluster=c.name)
                        for c in self.clusters}
        self._collector = None
        self._tsdb = None

    @property
    def metrics(self) -> StatsView:
        fields: Dict[str, object] = dict(self._m)
        fields["cluster_busy_s"] = \
            lambda: {n: c.value for n, c in self._m_busy.items()}
        return StatsView(fields)

    def attach_collector(self, collector) -> None:
        """Span-trace every subsequent ``submit_admitted`` batch: finished
        handles' event streams are ingested into ``collector`` and each
        returned run gets a ``report()``-able back-reference."""
        self._collector = collector

    def attach_telemetry(self, tsdb) -> None:
        """Sample this engine's registry into ``tsdb`` (a
        ``TimeSeriesDB``) at the end of every ``submit_many`` /
        ``submit_admitted`` batch — the batch simulator has no daemon
        loop, so batch boundaries are its sampling cadence."""
        self._tsdb = tsdb

    def _quota(self, user: str) -> UserQuota:
        if user not in self.quotas:
            self.quotas[user] = UserQuota()
        return self.quotas[user]

    def _pick_cluster(self, job, st: Optional["_WfState"] = None,
                      n: Optional[str] = None,
                      now: float = 0.0) -> Optional[Cluster]:
        """Weighted choice: prefer fitting cluster with the lowest load;
        GPU jobs must land on a GPU cluster. With per-cluster caches
        attached, artifact locality dominates: the fitting cluster with the
        cheapest input materialization wins, load breaks ties. Preempted
        (dark) clusters are excluded until they recover."""
        pool = self._gpu_clusters if job.resources.gpu > 0 else self.clusters
        if self.caches is None or st is None:
            best, best_load = None, float("inf")
            for c in pool:
                if c.dark_until <= now and c.fits(job):
                    l = c.load()
                    if l < best_load:
                        best, best_load = c, l
            return best
        best, best_key = None, None
        for c in pool:
            if c.dark_until <= now and c.fits(job):
                key = (round(self._input_cost_s(st, n, c), 9), c.load())
                if best_key is None or key < best_key:
                    best, best_key = c, key
        return best

    # -- artifact locality (tiered caches) ---------------------------------
    @staticmethod
    def _art_key(wf: WorkflowIR, job_name: str) -> str:
        return f"{wf.name}/{job_name}"

    def _input_fetch_s(self, wf: WorkflowIR, p: str,
                       cluster: Cluster) -> Tuple[float, float]:
        """(fetch_s, recompute_s) for predecessor p's artifact seen from
        `cluster`: fetch prices the holding tier (latency + bytes/bw) when
        locally resident (incl. a shared REMOTE tier), the cross-cluster
        transfer path when only a sibling cluster holds it, and infinity
        when it is cached nowhere (nothing to fetch — the consumer must
        recompute); recompute is the Eq. 3 first-hop reconstruction cost
        (the producer's est_time_s)."""
        job = wf.jobs[p]
        nbytes = max(1, job.est_mem_bytes)
        key = self._art_key(wf, p)
        store = self.caches.get(cluster.name)
        tier = store.find_tier(key) if store else None
        if tier is not None:
            fetch = tier.access_time_s(nbytes)
        elif any(c is not store and c.find_tier(key) is not None
                 for c in self.caches.values()):
            fetch = self.xfer_latency_s + nbytes / self.xfer_bandwidth_bytes_s
        else:
            fetch = float("inf")
        return fetch, job.est_time_s, nbytes

    def _input_cost_s(self, st: "_WfState", n: str,
                      cluster: Cluster) -> float:
        """Simulated time to materialize job n's inputs on `cluster`: per
        input, the consumer takes min(fetch, recompute)."""
        total = 0.0
        for p in st.wf.predecessors(n):
            fetch, recompute, _ = self._input_fetch_s(st.wf, p, cluster)
            total += min(fetch, recompute)
        return total

    def _charge_inputs_s(self, st: "_WfState", n: str,
                         cluster: Cluster) -> float:
        """Like _input_cost_s, but records the decision: a fetch goes
        through the SERVING store's get() (hit accounting + the promotion
        signal land on whichever cluster actually holds the artifact), a
        recompute re-offers the rebuilt artifact to the local store so
        later consumers on this cluster fetch instead of re-paying it, and
        the waits split into fetch vs recompute metrics."""
        store = self.caches.get(cluster.name)
        total = 0.0
        for p in st.wf.predecessors(n):
            fetch, recompute, nbytes = self._input_fetch_s(st.wf, p, cluster)
            key = self._art_key(st.wf, p)
            if fetch <= recompute:
                server = store if store is not None \
                    and store.find_tier(key) is not None else next(
                        (c for c in self.caches.values()
                         if c.find_tier(key) is not None), None)
                if server is not None:
                    server.get(key)
                    if server is not store and store is not None:
                        # cross-cluster pull: keep the fetched copy local
                        # so later consumers here skip the transfer
                        store.offer(key, None, compute_time_s=recompute,
                                    producer=p, nbytes=nbytes)
                total += fetch
                self._m["fetch_wait_s"].inc(fetch)
            else:
                total += recompute
                self._m["recompute_wait_s"].inc(recompute)
                if store is not None:
                    store.offer(key, None, compute_time_s=recompute,
                                producer=p, nbytes=nbytes)
        return total

    def lint_context(self):
        return {"clusters": self.clusters}

    def submit_many(self, workflows: List[Tuple[WorkflowIR, str, int]],
                    lint: str = "error",
                    handles: Optional[Dict[str, object]] = None
                    ) -> Dict[str, WorkflowRun]:
        """Simulate scheduling a batch of (workflow, user, priority).

        Each workflow is linted against this engine's clusters first: a
        job that fits NO cluster (CLR005) rejects its workflow up front
        instead of pinning it Pending in the queue forever
        (``lint="warn"|"off"`` restores the old behavior). Returns runs
        keyed by workflow name; self.metrics aggregates utilization &
        makespan.

        With a ``fault_plan`` whose ``preemption_rate_per_s > 0``, each
        cluster is struck by a seeded Poisson preemption process: the
        cluster goes dark for ``preemption_dark_s`` of simulated time, its
        in-flight jobs are evicted (freed, attempts bumped, re-readied for
        placement elsewhere or parked until recovery), and — when
        ``handles`` maps workflow names to async run handles —
        ``CLUSTER_PREEMPTED`` events are published per evicted job. With
        ``fault_plan=None`` scheduling is bit-identical to before."""
        if lint != "off":
            from repro_torch.core.analysis import lint_gate
            for wf, _user, _prio in workflows:
                lint_gate(wf, mode=lint, clusters=self.clusters)
        queue: List[_QItem] = []
        for wf, user, prio in workflows:
            wf.validate()
            heapq.heappush(queue, _QItem((-prio, next(self._seq)),
                                         wf, user, prio, 0.0))
        runs: Dict[str, WorkflowRun] = {}
        active: List[_WfState] = []
        # (finish_time, seq, cluster, user, wf_state, job_name); chaos
        # markers reuse the tuple shape with wf_state=None and job_name in
        # {"__preempt__", "__recover__"}
        events: List[Tuple[float, int, Cluster, str,
                           Optional[_WfState], str]] = []
        now = 0.0
        last_t = 0.0
        # darkness never leaks across batches: the sim clock restarts at 0
        for c in self.clusters:
            c.dark_until = 0.0
        plan = self.fault_plan
        chaos = plan is not None and plan.preemption_rate_per_s > 0
        # seq -> (cluster, user, wf_state, job_name) of jobs currently
        # executing (eviction candidates); evicted completion events stay
        # in the heap and are lazily discarded via `dead`
        inflight: Dict[int, Tuple[Cluster, str, _WfState, str]] = {}
        dead: Set[int] = set()
        rngs: Dict[str, random.Random] = {}
        done_local = 0
        if chaos:
            for c in self.clusters:
                rngs[c.name] = random.Random(f"{plan.seed}:{c.name}")
                t = rngs[c.name].expovariate(plan.preemption_rate_per_s)
                heapq.heappush(events, (t, next(self._seq), c, "",
                                        None, "__preempt__"))
        # admission indices of workflows with launchable work, visited in
        # admission order each pass; workflows with nothing ready are
        # never touched
        armed: List[int] = []
        armed_set = set()
        # wake-on-cause retry sets of (admission_idx, job_idx): a job that
        # failed its user-quota check can only fit once that user's usage
        # drops, so it waits for that user's next completion; a job with no
        # fitting cluster retries whenever any completion frees capacity
        quota_waiters: Dict[str, List[Tuple[int, int]]] = {}
        cluster_waiters: List[Tuple[int, int]] = []

        def arm(st: _WfState) -> None:
            if st.idx not in armed_set:
                armed_set.add(st.idx)
                heapq.heappush(armed, st.idx)

        def admit_from_queue() -> None:
            # Admission is explicitly unconditional: workflow admission has
            # no capacity gate — quota/cluster capacity is enforced per job
            # at launch time, so the priority queue drains completely.
            while queue:
                item = heapq.heappop(queue)
                st = _WfState(item.wf, item.user, len(active))
                active.append(st)
                runs[item.wf.name] = st.run
                arm(st)

        def launch_pass() -> None:
            # drain armed workflows in admission order (heap pops ascend)
            batch: List[int] = []
            while armed:
                batch.append(heapq.heappop(armed))
            armed_set.clear()
            for ai in batch:
                st = active[ai]
                wf = st.wf
                while st.ready:
                    i = heapq.heappop(st.ready)
                    n = st.order[i]
                    job = wf.jobs[n]
                    q = self._quota(st.user)
                    if not q.fits(job):
                        quota_waiters.setdefault(st.user, []).append((ai, i))
                        continue
                    c = self._pick_cluster(job, st, n, now=now)
                    if c is None:
                        self._m["failed_admission"].inc()
                        cluster_waiters.append((ai, i))
                        continue
                    r = job.resources
                    c.used_cpu += r.cpu
                    c.used_mem += r.mem_bytes
                    c.used_gpu += r.gpu
                    q.used_cpu += r.cpu
                    q.used_mem += r.mem_bytes
                    q.used_gpu += r.gpu
                    st.run.steps[n].status = StepStatus.RUNNING
                    st.run.steps[n].start = now
                    self._m["scheduled_jobs"].inc()
                    dur = job.est_time_s
                    if self.caches is not None:
                        dur += self._charge_inputs_s(st, n, c)
                    ev_seq = next(self._seq)
                    heapq.heappush(events, (now + dur, ev_seq, c, st.user,
                                            st, n))
                    if chaos:
                        inflight[ev_seq] = (c, st.user, st, n)

        admit_from_queue()
        launch_pass()
        while events:
            now, seq, c, user, st, n = heapq.heappop(events)
            if st is None:                       # chaos marker, not a job
                if n == "__preempt__":
                    self._m["preemptions"].inc()
                    c.dark_until = now + plan.preemption_dark_s
                    # evict everything in flight on the struck cluster:
                    # free its resources, bump attempts, re-ready the job
                    victims = [s for s, (vc, _, _, _) in inflight.items()
                               if vc is c]
                    for vseq in victims:
                        _, vuser, vst, vn = inflight.pop(vseq)
                        dead.add(vseq)
                        vjob = vst.wf.jobs[vn]
                        vr = vjob.resources
                        c.used_cpu -= vr.cpu
                        c.used_mem -= vr.mem_bytes
                        c.used_gpu -= vr.gpu
                        vq = self._quota(vuser)
                        vq.used_cpu -= vr.cpu
                        vq.used_mem -= vr.mem_bytes
                        vq.used_gpu -= vr.gpu
                        rec = vst.run.steps[vn]
                        rec.status = StepStatus.PENDING
                        rec.attempts += 1
                        rec.error = (f"preempted on {c.name} "
                                     f"at t={now:.3f}")
                        self._m["preempted_jobs"].inc()
                        heapq.heappush(vst.ready, vst.jidx[vn])
                        arm(vst)
                        h = handles.get(vst.wf.name) if handles else None
                        if h is not None:
                            h._publish(EventType.CLUSTER_PREEMPTED,
                                       step=vn, attempt=rec.attempts,
                                       error=rec.error)
                    heapq.heappush(events, (now + plan.preemption_dark_s,
                                            next(self._seq), c, "",
                                            None, "__recover__"))
                    if done_local < len(active):
                        nxt = now + rngs[c.name].expovariate(
                            plan.preemption_rate_per_s)
                        heapq.heappush(events, (nxt, next(self._seq), c,
                                                "", None, "__preempt__"))
                    launch_pass()
                else:                            # __recover__
                    # the cluster is placeable again: wake parked jobs
                    for ai, i in cluster_waiters:
                        stw = active[ai]
                        heapq.heappush(stw.ready, i)
                        arm(stw)
                    cluster_waiters = []
                    launch_pass()
                continue
            if chaos:
                if seq in dead:                  # evicted before finishing
                    dead.discard(seq)
                    continue
                inflight.pop(seq, None)
            job = st.wf.jobs[n]
            r = job.resources
            c.used_cpu -= r.cpu
            c.used_mem -= r.mem_bytes
            c.used_gpu -= r.gpu
            q = self._quota(user)
            q.used_cpu -= r.cpu
            q.used_mem -= r.mem_bytes
            q.used_gpu -= r.gpu
            rec = st.run.steps[n]
            # with caches the job holds its resources for est_time_s PLUS
            # the charged input-materialization wait (now - start); without
            # caches keep the exact legacy expression (equivalence suite)
            busy = (job.est_time_s if self.caches is None
                    else now - rec.start)
            self._m_busy[c.name].inc(busy * r.cpu)
            rec.status = StepStatus.SUCCEEDED
            rec.end = now
            last_t = now
            if self.caches is not None:
                store = self.caches.get(c.name)
                if store is not None:
                    # the artifact materializes on the cluster that ran the
                    # producer; demotion may later push it to shared REMOTE
                    store.offer(self._art_key(st.wf, n), None,
                                compute_time_s=job.est_time_s, producer=n,
                                nbytes=max(1, job.est_mem_bytes))
            st.remaining -= 1
            newly_ready = False
            for s in st.wf.successors(n):
                st.indeg[s] -= 1
                if st.indeg[s] == 0:
                    heapq.heappush(st.ready, st.jidx[s])
                    newly_ready = True
            if st.remaining == 0:
                st.run.status = "Succeeded"
                st.run.wall_time_s = now
                self._m["completed_workflows"].inc()
                done_local += 1
            if newly_ready:
                arm(st)
            # wake exactly the jobs this completion could unblock: the
            # finishing user's quota-waiters, and (cluster capacity freed)
            # every cluster-waiter
            woken = quota_waiters.pop(user, [])
            if cluster_waiters:
                woken += cluster_waiters
                cluster_waiters = []
            for ai, i in woken:
                stw = active[ai]
                heapq.heappush(stw.ready, i)
                arm(stw)
            launch_pass()
        # the last *completion* time (recovery markers may outlive the work)
        self._m["makespan_s"].set(last_t)
        if self._tsdb is not None:
            try:
                self._tsdb.sample(self.registry.snapshot())
            except Exception:  # noqa: BLE001 — telemetry is advisory
                pass
        return runs

    def submit(self, wf: WorkflowIR, optimize: bool = True, user: str = "u0",
               priority: int = 0, lint: str = "error", **kw) -> WorkflowRun:
        return self.submit_many([(wf, user, priority)], lint=lint)[wf.name]

    def submit_admitted(self, queue, max_n: Optional[int] = None
                        ) -> Dict[str, WorkflowRun]:
        """Drain a gateway ``AdmissionQueue`` (weighted-round-robin tenant
        order) into one simulated batch: tenants map to scheduler users,
        priorities pass through to the weighted queue, and any attached
        async handles are finished with their runs (emitting the coarse
        ``WORKFLOW_DONE``). This is the batch-scheduler consumer of the
        same backpressured admission layer that feeds ``LocalEngine``.

        Workflow names must be unique within the drained batch
        (``submit_many`` keys its results by name); duplicates raise
        ``ValueError`` instead of silently handing two submitters the
        same run."""
        from repro_torch.core.gateway.events import EventType
        items = queue.drain(max_n)
        seen: Dict[str, str] = {}
        for it in items:
            if it.wf.name in seen:
                raise ValueError(
                    f"duplicate workflow name {it.wf.name!r} in admitted "
                    f"batch (tenants {seen[it.wf.name]!r} and "
                    f"{it.tenant!r}); submit_many results are keyed by "
                    "name — rename or submit in separate batches")
            seen[it.wf.name] = it.tenant
        runs = self.submit_many(
            [(it.wf, it.tenant, it.priority) for it in items],
            handles={it.wf.name: it.handle for it in items
                     if it.handle is not None})
        for it in items:
            if it.handle is not None:
                run = runs[it.wf.name]
                it.handle.run = run
                it.handle._publish(EventType.WORKFLOW_DONE, status=run.status)
                it.handle._finish(run)
        c = self._collector
        if c is not None:
            import weakref
            for it in items:
                if it.handle is None:
                    continue
                run = runs[it.wf.name]
                c.ingest(it.handle.events_so_far(), wf=it.wf,
                         run_id=run.run_id, tenant=it.tenant)
                run._obs_collector = weakref.ref(c)
        return runs
