"""``WorkflowGateway`` — asyncio submission layer over a ``LocalEngine``.

One gateway owns one event loop (a daemon thread), one shared step worker
pool, one admission queue, and (for multi-tier caches) one background
promotion task. Every in-flight workflow of the engine is multiplexed onto
these shared resources:

* the **pump** coroutine drains the admission queue in weighted
  round-robin tenant order and spawns one lightweight task per workflow
  (no per-run threads);
* each workflow task replays the engine's push-based completion
  scheduling as coroutines: ready steps become asyncio tasks that execute
  ``LocalEngine._exec_step`` on the shared pool, and each completion
  decrements successor indegrees exactly as the sync scheduler did;
* a global ``max_inflight_steps`` semaphore bounds how many steps of ALL
  workflows may execute at once (backpressure below the admission gate);
* ``promote_interval_s`` drives ``TieredCacheStore.promote()`` from a
  real background task (the store's ``auto_promote_every`` hit-count
  trigger remains as a fallback for engines without a gateway);
* ``stop()`` cancels the background tasks, drains the loop, and joins the
  thread — ``LocalEngine.close()`` calls it on engine shutdown.

The sync facade (``LocalEngine.submit``) funnels through this same path
(``submit_nowait(block=True)`` + ``handle.result()``), so sync and async
submissions produce identical ``WorkflowRun`` results.

Streaming (``couler.run_stream`` / ``couler.map_stream``): for each
streamed artifact consumed chunk-wise inside a part, ``_run_part`` builds
an ``ArtifactChannel`` (bounded buffer + backpressure; see
``gateway.channels``) and starts the consumer as soon as the producer
emits its first chunk — the consumer's indegree contribution from that
producer is credited early, while every other dependency still gates it
normally. The in-flight-steps semaphore applies unchanged, so
``max_inflight_steps`` must be at least the streaming pipeline depth or
the stages cannot coexist (the channel's stall timeout turns that
misconfiguration into a failed run rather than a hang). A run cancelled
mid-stream interrupts blocked producers/consumers via the channel; the
interrupted steps are reverted to ``Pending`` so the run stays
resumable, replaying any chunk prefix already cached.

Speculative straggler backups reserve a slot from the same semaphore via
``try_reserve_step_slot`` (non-blocking; no spare slot means no backup),
so ``peak_inflight_steps`` honours the bound with speculation included.

Caveat: ``submit()`` called *from inside a step function* of the same
engine occupies a pool worker while it waits; deeply nested blocking
submissions can exhaust the pool — nest with ``submit_async`` instead.
"""
from __future__ import annotations

import asyncio
import concurrent.futures as cf
import threading
import time
import weakref
from typing import Dict, List, Optional, Set

from repro_torch.core.autosplit import schedule_parts, split_workflow
from repro_torch.core.engines.base import StepRecord, StepStatus, WorkflowRun
from repro_torch.core.gateway.admission import AdmissionQueue, AdmittedItem
from repro_torch.core.gateway.channels import (ArtifactChannel, StepContext,
                                         StreamCancelled)
from repro_torch.core.gateway.events import EventType
from repro_torch.core.gateway.run import AsyncWorkflowRun
from repro_torch.core.ir import WorkflowIR
from repro_torch.core.obs.metrics import MetricsRegistry, StatsView

_EVENT_FOR_STATUS = {
    StepStatus.SUCCEEDED: EventType.STEP_SUCCEEDED,
    StepStatus.CACHED: EventType.STEP_CACHED,
    StepStatus.SKIPPED: EventType.STEP_SKIPPED,
    StepStatus.FAILED: EventType.STEP_FAILED,
}


class WorkflowGateway:
    """Asyncio-driven submission gateway; see module docstring."""

    def __init__(self, engine, max_workers: Optional[int] = None,
                 max_inflight_steps: Optional[int] = None,
                 max_inflight_workflows: Optional[int] = None,
                 admission: Optional[AdmissionQueue] = None,
                 promote_interval_s: float = 0.25,
                 check_events: bool = False,
                 readmission=None,
                 registry: Optional[MetricsRegistry] = None,
                 collector=None,
                 telemetry_interval_s: float = 0.0,
                 anomaly=None,
                 slo=None,
                 telemetry_path=None):
        self.engine = engine
        # sanitizer mode: attach a TraceChecker to every run's publish
        # path so an invariant breach raises at the offending event
        self.check_events = check_events
        # straggler-aware re-admission: a failed (not cancelled) run
        # re-enters the admission queue after a capped, jittered backoff
        # with aged priority (repro_torch.core.faults.ReadmissionPolicy); the
        # satisfied step frontier is kept, failed steps reset. None (the
        # default) keeps failures terminal.
        self.readmission = readmission
        self.max_workers = max_workers or getattr(engine, "max_workers", 8)
        self.max_inflight_steps = (max_inflight_steps
                                   if max_inflight_steps
                                   else 2 * self.max_workers)
        self.max_inflight_workflows = max_inflight_workflows
        # one registry per gateway; a default admission queue shares it so
        # per-tenant depth/shed series land next to the gateway's own
        self.registry = registry if registry is not None else \
            MetricsRegistry("gateway")
        self.admission = admission if admission is not None else \
            AdmissionQueue(registry=self.registry)
        # span collector (couler.observe / attach_collector): when set,
        # every submitted run is registered and observed
        self.collector = collector
        self.promote_interval_s = promote_interval_s
        # continuous telemetry (couler.telemetry / telemetry_interval_s>0):
        # a TimeSeriesDB sampled on the loop's daemon cadence, plus the
        # optional anomaly monitor (in-band ALERT events) and SLO monitor
        # (burn-rate alerts + admission priority nudge)
        self.telemetry_interval_s = telemetry_interval_s
        self.telemetry_path = telemetry_path
        self.tsdb = None
        self.anomaly = anomaly
        self.slo = slo
        self._telemetry_task: Optional[asyncio.Task] = None
        if telemetry_interval_s and telemetry_interval_s > 0:
            from repro_torch.core.obs.timeseries import TimeSeriesDB
            self.tsdb = TimeSeriesDB(path=telemetry_path)
        if self.anomaly is not None:
            self.anomaly.bind(self.registry)
        if self.slo is not None:
            self.slo.bind(self.registry)
        m = self.registry
        # workflow outcome counters — all increments go through the
        # thread-safe instruments (the old dict was mutated from the loop
        # thread AND worker threads without a lock); the legacy
        # ``gateway.stats`` mapping survives as a read view below
        self._m_wf = {
            "submitted": m.counter("gateway_workflows_submitted_total"),
            "completed": m.counter("gateway_workflows_completed_total"),
            "failed": m.counter("gateway_workflows_failed_total"),
            "cancelled": m.counter("gateway_workflows_cancelled_total"),
            "readmitted": m.counter("gateway_workflows_readmitted_total"),
        }
        self._m_inflight = m.gauge("gateway_inflight_steps")
        self._m_peak = m.gauge("gateway_peak_inflight_steps")
        self._m_chunks = m.counter("gateway_stream_chunks_total")
        self._m_replayed = m.counter("gateway_stream_chunks_replayed_total")
        self._m_rewinds = m.counter("gateway_stream_rewinds_total")
        self._m_stalls = m.counter("gateway_stream_backpressure_stalls_total")
        self._m_stall_s = m.counter("gateway_stream_backpressure_stall_s")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._step_sem: Optional[asyncio.Semaphore] = None
        self._wf_sem: Optional[asyncio.Semaphore] = None
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._promote_task: Optional[asyncio.Task] = None
        self._wf_tasks: Set[asyncio.Task] = set()
        self._start_lock = threading.Lock()
        self._started = threading.Event()
        self._closed = False
        self.admission.add_listener(self._on_offer)

    @property
    def stats(self) -> StatsView:
        """Legacy dict-compatible view over the registry instruments."""
        fields = dict(self._m_wf)
        fields["peak_inflight_steps"] = self._m_peak
        return StatsView(fields)

    def attach_collector(self, collector) -> None:
        """Attach an ``ObsCollector`` (``couler.observe``): every run
        submitted from now on is span-traced and ``run.report()`` works."""
        self.collector = collector

    # -- lifecycle ---------------------------------------------------------
    def ensure_started(self) -> None:
        if self._started.is_set():
            return
        with self._start_lock:
            if self._started.is_set():
                return
            if self._closed:
                raise RuntimeError("gateway is closed")
            self._thread = threading.Thread(
                target=self._loop_main, daemon=True,
                name=f"wf-gateway-{id(self):x}")
            self._thread.start()
        self._started.wait()

    def _loop_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._pool = cf.ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="gateway-step")
        self._step_sem = asyncio.Semaphore(self.max_inflight_steps)
        if self.max_inflight_workflows:
            self._wf_sem = asyncio.Semaphore(self.max_inflight_workflows)
        self._wake = asyncio.Event()
        self._pump_task = loop.create_task(self._pump())
        if self.promote_interval_s and self._cache_promotable():
            self._promote_task = loop.create_task(self._promote_loop())
        if self.telemetry_interval_s and self.tsdb is not None:
            self._telemetry_task = loop.create_task(self._telemetry_loop())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    def _cache_promotable(self) -> bool:
        cache = getattr(self.engine, "cache", None)
        tiers = getattr(cache, "tiers", None)
        return callable(getattr(cache, "promote", None)) \
            and tiers is not None and len(tiers) > 1

    def stop(self, wait: bool = True, timeout: float = 10.0) -> None:
        """Cancel the pump/promotion/workflow tasks, stop the loop, join
        the thread, and release the worker pool. Idempotent."""
        with self._start_lock:
            self._closed = True
            loop, thread = self._loop, self._thread
        if loop is None or not self._started.is_set():
            return

        def _begin_shutdown() -> None:
            loop.create_task(self._shutdown())

        try:
            loop.call_soon_threadsafe(_begin_shutdown)
        except RuntimeError:              # loop already closed
            return
        if wait and thread is not None \
                and thread is not threading.current_thread():
            thread.join(timeout)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    async def _shutdown(self) -> None:
        # sweep until quiescent: workflow tasks spawn step tasks, and a
        # step completing mid-sweep may spawn successors
        cur = asyncio.current_task()
        while True:
            rest = [t for t in asyncio.all_tasks()
                    if t is not cur and not t.done()]
            if not rest:
                break
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)
        asyncio.get_running_loop().stop()

    # -- submission (thread-safe; callable from any thread) ----------------
    def submit_nowait(self, wf: WorkflowIR, optimize: bool = True,
                      tenant: str = "default", priority: int = 0,
                      run: Optional[WorkflowRun] = None,
                      resume: bool = False,
                      block: bool = False,
                      lint: str = "error") -> AsyncWorkflowRun:
        """Lint + validate + enqueue one workflow; returns its handle
        immediately. Lint errors (``repro_torch.core.analysis``) raise
        ``WorkflowLintError`` unless ``lint="warn"|"off"``; resumed runs
        were gated on first submission and are not re-linted. Raises
        ``QueueFull`` when the tenant's queue is at capacity (pass
        ``block=True`` to wait for space instead — the sync facade does)."""
        if self._closed:
            raise RuntimeError("gateway is closed")
        self.ensure_started()
        if run is None:
            if lint != "off":
                from repro_torch.core.analysis import lint_gate
                lint_gate(wf, mode=lint,
                          max_inflight_steps=self.max_inflight_steps)
            wf.validate()
            run = WorkflowRun(workflow=wf)
            for n in wf.jobs:
                run.steps[n] = StepRecord()
        handle = AsyncWorkflowRun(wf.name, run=run, tenant=tenant)
        if self.check_events:
            from repro_torch.core.analysis import TraceChecker
            handle.add_observer(TraceChecker(wf=wf).observe)
        if self.collector is not None:
            # register before the ADMITTED publish inside admission.offer
            # so the span tree sees the full stream; the weakref on the
            # run lets run.report() find its tree without pinning the
            # collector
            self.collector.register_run(run.run_id, wf=wf, tenant=tenant)
            handle.add_observer(self.collector.observe)
            run._obs_collector = weakref.ref(self.collector)
        item = AdmittedItem(wf=wf, tenant=tenant, priority=priority,
                            optimize=optimize, resume=resume, handle=handle)
        self.admission.offer(item, block=block)
        return handle

    def _on_offer(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None or self._closed:
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass

    # -- pump: admission queue -> workflow tasks ---------------------------
    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            item = self.admission.pop()
            if item is None:
                self._wake.clear()
                if len(self.admission) == 0:
                    await self._wake.wait()
                continue
            if self._wf_sem is not None:
                await self._wf_sem.acquire()
            task = loop.create_task(self._run_workflow(item))
            self._wf_tasks.add(task)
            task.add_done_callback(self._wf_task_done)

    def _wf_task_done(self, task: asyncio.Task) -> None:
        self._wf_tasks.discard(task)
        if self._wf_sem is not None:
            self._wf_sem.release()

    # -- per-workflow execution (mirrors LocalEngine's sync scheduler) -----
    async def _run_workflow(self, item: AdmittedItem) -> None:
        handle = item.handle
        run = handle.run
        eng = self.engine
        self._m_wf["submitted"].inc()
        loop = asyncio.get_running_loop()
        try:
            if handle.cancel_requested:       # cancelled while queued
                run.status = "Cancelled"
                self._m_wf["cancelled"].inc()
                handle._publish(EventType.WORKFLOW_DONE, status=run.status)
                handle._finish(run)
                return
            wf = run.workflow
            t0 = time.time()
            if item.optimize and not item.resume:
                parts = split_workflow(wf, eng.budget)
            else:
                parts = [wf]
            ok = True
            if len(parts) == 1:
                ok = await self._run_part(parts[0], run, handle)
            else:
                # maximum parallelism (Eq. 1): independent parts of a wave
                # run concurrently, waves in dependency order
                waves = schedule_parts(wf, parts)
                for wave in waves:
                    if not ok:
                        break
                    results = await asyncio.gather(
                        *(self._run_part(parts[i], run, handle)
                          for i in wave))
                    ok = all(results)
            dt = time.time() - t0
            run.wall_time_s = run.wall_time_s + dt if item.resume else dt
            if not ok:
                if self._maybe_readmit(item, run, handle):
                    await loop.run_in_executor(self._pool, run.persist)
                    return          # handle finishes on a later round trip
                run.status = "Failed"
                self._m_wf["failed"].inc()
            elif handle.cancel_requested and any(
                    r.status == StepStatus.PENDING
                    for r in run.steps.values()):
                run.status = "Cancelled"
                self._m_wf["cancelled"].inc()
            else:
                run.status = "Succeeded"
                self._m_wf["completed"].inc()
            await loop.run_in_executor(self._pool, run.persist)
            if self.slo is not None:
                self.slo.note_run(
                    handle.tenant, ok=(run.status == "Succeeded"),
                    makespan_s=run.wall_time_s,
                    queue_wait_s=max(0.0, t0 - item.offered_at))
            handle._publish(EventType.WORKFLOW_DONE, status=run.status)
            handle._finish(run)
        except asyncio.CancelledError:
            run.status = "Cancelled"
            handle._publish(EventType.WORKFLOW_DONE, status=run.status)
            handle._finish(run)
            raise
        except Exception as e:  # noqa: BLE001 — internal error, not a step
            run.status = "Failed"
            self._m_wf["failed"].inc()
            handle._publish(EventType.WORKFLOW_DONE, status="Failed",
                            error=f"{type(e).__name__}: {e}")
            handle._fail(e)

    # -- straggler-aware re-admission --------------------------------------
    def _maybe_readmit(self, item: AdmittedItem, run: WorkflowRun,
                       handle: AsyncWorkflowRun) -> bool:
        """Failed-run recovery (loop thread): when a re-admission policy
        allows another round trip, reset the unsatisfied steps, announce
        ``WORKFLOW_REQUEUED`` (a new checker epoch), and schedule the
        backoff re-offer. The handle stays unfinished — callers keep
        awaiting the same run across round trips."""
        pol = self.readmission
        if pol is None or handle.cancel_requested or self._closed \
                or not pol.should_readmit(item.readmit_count):
            return False
        failed = sorted(n for n, r in run.steps.items()
                        if r.status == StepStatus.FAILED)
        keep = (StepStatus.SUCCEEDED, StepStatus.SKIPPED, StepStatus.CACHED)
        for n, rec in run.steps.items():
            if rec.status not in keep:
                run.steps[n] = StepRecord()
        run.status = "Queued"
        item.readmit_count += 1
        item.resume = True              # keep the satisfied frontier
        item.priority = pol.aged_priority(item.priority)
        self._m_wf["readmitted"].inc()
        handle._publish(EventType.WORKFLOW_REQUEUED,
                        attempt=item.readmit_count,
                        error=f"steps failed: {', '.join(failed)}"
                              if failed else "")
        if self.anomaly is not None:
            alert = self.anomaly.note_requeue(run.workflow.name,
                                              tenant=handle.tenant)
            if alert is not None:
                handle._publish(EventType.ALERT, status=alert.detector,
                                error=alert.reason)
        delay = pol.delay_s(item.readmit_count)
        asyncio.get_running_loop().create_task(
            self._requeue_later(item, delay))
        return True

    async def _requeue_later(self, item: AdmittedItem, delay: float) -> None:
        handle, run = item.handle, item.handle.run
        try:
            await asyncio.sleep(delay)
        except asyncio.CancelledError:
            # gateway shutdown mid-backoff: finish the handle so sync
            # waiters unblock; the persisted run stays resumable
            run.status = "Cancelled"
            handle._publish(EventType.WORKFLOW_DONE, status="Cancelled")
            handle._finish(run)
            raise
        if handle.cancel_requested:
            run.status = "Cancelled"
            self._m_wf["cancelled"].inc()
            handle._publish(EventType.WORKFLOW_DONE, status="Cancelled")
            handle._finish(run)
            return
        # block=True from an executor thread: re-admission must not shed
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.admission.offer(item, block=True))

    def _record_frontier(self, run: WorkflowRun) -> None:
        """Fire-and-forget frontier snapshot through the engine's
        ``FrontierStore`` (if attached) after each step terminal event —
        the persistence half of checkpoint-resume."""
        store = getattr(self.engine, "frontier", None)
        if store is None:
            return
        try:
            self._pool.submit(store.record, run)
        except RuntimeError:            # pool shutting down
            pass

    async def _run_part(self, wfp: WorkflowIR, run: WorkflowRun,
                        handle: AsyncWorkflowRun) -> bool:
        """Asyncio port of ``LocalEngine._run_part``: per-job indegree
        counters decremented on completion, each finished step costing
        O(out-degree); steps execute on the SHARED pool gated by the
        global in-flight-steps semaphore."""
        eng = self.engine
        eng.cache.attach_workflow(run.workflow)
        satisfied = (StepStatus.SUCCEEDED, StepStatus.SKIPPED,
                     StepStatus.CACHED)
        done: Set[str] = {n for n, r in run.steps.items()
                          if n in wfp.jobs and r.status in satisfied}
        total = len(wfp.jobs)
        if len(done) >= total:
            return True
        # remaining unsatisfied dependencies per not-yet-done job; a pred
        # outside this part that is not already satisfied never resolves
        # here, which leaves the job pending and ends the part
        indeg: Dict[str, int] = {}
        ready: List[str] = []
        for n in wfp.jobs:
            if n in done:
                continue
            k = 0
            for p in run.workflow.predecessors(n):
                if p not in wfp.jobs and p not in run.steps:
                    continue
                rec = run.steps.get(p)
                if rec is not None and rec.status in satisfied:
                    continue
                k += 1
            indeg[n] = k
            if k == 0:
                ready.append(n)

        # streaming channels: one per streamed artifact consumed chunk-wise
        # in this part whose producer is also here and not yet satisfied;
        # consumers of already-done (or out-of-part) producers fall back to
        # the materialized artifact
        channels: Dict[str, ArtifactChannel] = {}
        by_producer: Dict[str, ArtifactChannel] = {}
        early: Dict[str, Set[str]] = {}   # consumer -> early-startable preds
        for n, j in wfp.jobs.items():
            if n in done or not (j.stream_input and j.stream_arg):
                continue
            p = j.stream_arg.split(":")[0]
            pj = wfp.jobs.get(p)
            if pj is None or not pj.stream_output or p in done:
                continue
            ch = channels.get(j.stream_arg)
            if ch is None:
                ch = ArtifactChannel(j.stream_arg, producer=p,
                                     capacity=pj.stream_buffer_chunks)
                channels[j.stream_arg] = ch
                by_producer[p] = ch
            ch.expect_consumer(n)
            # conditioned consumers cannot start before their predicate's
            # artifact exists; they launch normally and read the channel
            # history (or the materialized value) once ready
            if j.condition is None:
                early.setdefault(n, set()).add(p)
        ctx = StepContext(channels=channels, publish=handle._publish)
        if channels:
            handle.add_cancel_callback(
                lambda chans=tuple(channels.values()):
                    [c.cancel() for c in chans])

        loop = asyncio.get_running_loop()
        # completion handling is inlined at the tail of each step task (the
        # loop is single-threaded, so no locking): each finished step costs
        # O(out-degree) with no waiter re-registration — the part coroutine
        # only awaits one future resolved when the outstanding count drains
        state = {"failed": False, "outstanding": 0}
        part_done: asyncio.Future = loop.create_future()
        # consumer->producer edges already credited by an early (first-chunk)
        # start; finish_one must not decrement them a second time
        credited: Set[tuple] = set()

        def finish_one(name: str, status: Optional[StepStatus]) -> None:
            j = wfp.jobs.get(name)
            if j is not None and j.stream_arg in channels:
                # release the phantom cursor of a consumer that terminated
                # without ever attaching (skipped / failed / cancelled)
                channels[j.stream_arg].consumer_done(name)
            chn = by_producer.get(name)
            if chn is not None and status is not None and not chn.finished:
                # the engine closes/aborts on every normal exit; this is
                # belt-and-braces so readers never block on a dead producer
                chn.abort(RuntimeError(
                    f"{name} ended without closing its stream"))
            if status is not None:
                if status == StepStatus.FAILED:
                    state["failed"] = True      # in-flight steps drain out
                else:
                    done.add(name)
                    if not state["failed"] and not handle.cancel_requested:
                        for s in run.workflow.successors(name):
                            if s in indeg and s not in done \
                                    and (s, name) not in credited:
                                indeg[s] -= 1
                                if indeg[s] == 0:
                                    spawn(s)
            state["outstanding"] -= 1
            if state["outstanding"] == 0 and not part_done.done():
                part_done.set_result(None)

        def stream_ready(p: str) -> None:
            # producer p emitted its first chunk (scheduled onto the loop,
            # so serialized with finish_one): credit its edge to chunk-wise
            # consumers now — every *other* dependency still gates them
            if state["failed"] or handle.cancel_requested or p in done:
                return
            for s, ps in early.items():
                if p in ps and (s, p) not in credited \
                        and s in indeg and s not in done:
                    credited.add((s, p))
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        spawn(s)

        for p, chn in by_producer.items():
            chn.on_first_chunk = (
                lambda p=p: loop.call_soon_threadsafe(stream_ready, p))

        async def exec_one(name: str) -> None:
            status: Optional[StepStatus] = None
            try:
                async with self._step_sem:
                    if handle.cancel_requested:
                        return              # never launched: stays Pending
                    handle._publish(EventType.STEP_STARTED, step=name)
                    self._note_inflight(+1)
                    try:
                        status = await loop.run_in_executor(
                            self._pool, eng._exec_step, wfp.jobs[name], run,
                            ctx)
                    except StreamCancelled:
                        # cancelled mid-stream: revert to Pending so the
                        # run stays resumable; like a never-launched step
                        # it gets no terminal event (taxonomy exception)
                        run.steps[name] = StepRecord()
                        status = None
                    except Exception as e:  # noqa: BLE001
                        rec = run.steps[name]
                        rec.error = f"{type(e).__name__}: {e}"
                        rec.status = StepStatus.FAILED
                        status = StepStatus.FAILED
                    finally:
                        self._note_inflight(-1)
                    if status is not None:
                        handle._publish(
                            _EVENT_FOR_STATUS.get(status,
                                                  EventType.STEP_FAILED),
                            step=name, status=status.value,
                            error=run.steps[name].error)
                        self._record_frontier(run)
                        prof = getattr(run.steps[name], "profile", None)
                        if prof:
                            self._fold_profile(run, name, prof)
                        if self.anomaly is not None \
                                and status is StepStatus.SUCCEEDED:
                            self._note_step_telemetry(handle, run, name)
            finally:
                finish_one(name, status)

        def spawn(name: str) -> None:
            state["outstanding"] += 1
            loop.create_task(exec_one(name))

        for n in ready:
            spawn(n)
        if state["outstanding"]:
            await part_done
        if channels:
            self._fold_channel_stats(channels, run)
        return not state["failed"]

    def _fold_channel_stats(self, channels: Dict[str, ArtifactChannel],
                            run: WorkflowRun) -> None:
        """Part teardown: aggregate each channel's chunk/backpressure
        counters into the registry and annotate the producer's span —
        producer stall time is measured inside ``put`` and cannot be
        derived from the event stream alone."""
        for ch in channels.values():
            st = ch.stats
            self._m_chunks.inc(st["puts"])
            self._m_replayed.inc(st["replayed"])
            self._m_rewinds.inc(st["rewinds"])
            self._m_stalls.inc(st["stalls"])
            self._m_stall_s.inc(st["stall_s"])
            if self.collector is not None:
                self.collector.annotate_step(
                    run.run_id, ch.producer,
                    stream_stall_s=st["stall_s"],
                    stream_chunks=st["puts"],
                    stream_stalls=st["stalls"],
                    stream_max_lead=st["max_lead"])

    def _note_inflight(self, delta: int) -> None:
        # thread-safe now (registry gauges): speculation reserves slots
        # from worker threads, the loop thread drives exec_one — the old
        # dict high-water update could lose peaks across those contexts
        self._m_peak.set_max(self._m_inflight.add(delta))

    @property
    def _inflight_steps(self) -> int:
        """Live in-flight step count (reads the registry gauge; kept as an
        attribute-shaped view for pre-registry call sites and tests)."""
        return int(self._m_inflight.value)

    # -- speculation slot accounting (thread-safe) -------------------------
    def try_reserve_step_slot(self, timeout: float = 2.0) -> bool:
        """Try to reserve one in-flight-step slot from a worker thread
        WITHOUT waiting for one to free up — used by the engine's straggler
        speculation so backup copies count against the same
        ``max_inflight_steps`` bound as scheduled steps. Returns False when
        the bound is saturated (no backup launches) or the gateway is not
        running; ``timeout`` only bounds the loop round-trip."""
        loop = self._loop
        if loop is None or self._closed or not self._started.is_set():
            return False

        async def _try() -> bool:
            sem = self._step_sem
            if sem is None or sem.locked():
                return False
            await sem.acquire()
            self._note_inflight(+1)
            return True

        try:
            return asyncio.run_coroutine_threadsafe(_try(), loop) \
                .result(timeout)
        except Exception:       # loop closing, or timed out: no slot
            return False

    def release_step_slot(self) -> None:
        """Release a slot taken via ``try_reserve_step_slot``."""
        loop = self._loop
        if loop is None:
            return

        def _rel() -> None:
            self._note_inflight(-1)
            if self._step_sem is not None:
                self._step_sem.release()

        try:
            loop.call_soon_threadsafe(_rel)
        except RuntimeError:    # loop already closed: nothing to release
            pass

    # -- background cache promotion ---------------------------------------
    async def _promote_loop(self) -> None:
        """Drive ``TieredCacheStore.promote()`` periodically so hot
        artifacts climb toward MEM without relying on the hit-count
        trigger. Cancellation (engine shutdown) exits cleanly."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.promote_interval_s)
            try:
                await loop.run_in_executor(self._pool,
                                           self.engine.cache.promote)
            except RuntimeError:   # pool shut down mid-flight
                return
            except Exception:  # noqa: BLE001 — promotion is advisory
                pass

    # -- continuous telemetry ----------------------------------------------
    def start_telemetry(self, interval_s: float = 0.25, anomaly=None,
                        slo=None, path=None):
        """Turn on continuous telemetry on a live gateway
        (``couler.telemetry``): create the ``TimeSeriesDB`` (JSONL-backed
        when ``path`` is given), bind the anomaly / SLO monitors to this
        gateway's registry, and schedule the sampling task on the loop.
        Returns ``(tsdb, anomaly, slo)``. Idempotent for the task: calling
        again just updates the monitors/interval."""
        from repro_torch.core.obs.timeseries import TimeSeriesDB
        self.telemetry_interval_s = interval_s
        if self.tsdb is None:
            self.tsdb = TimeSeriesDB(path=path or self.telemetry_path)
        if anomaly is not None:
            self.anomaly = anomaly
        if self.anomaly is not None:
            self.anomaly.bind(self.registry)
        if slo is not None:
            self.slo = slo
        if self.slo is not None:
            self.slo.bind(self.registry)
        if self._started.is_set() and self._telemetry_task is None \
                and self._loop is not None and not self._closed:
            def _sched() -> None:
                if self._telemetry_task is None:
                    self._telemetry_task = \
                        self._loop.create_task(self._telemetry_loop())
            try:
                self._loop.call_soon_threadsafe(_sched)
            except RuntimeError:
                pass
        return self.tsdb, self.anomaly, self.slo

    def _telemetry_sources(self) -> List[MetricsRegistry]:
        """Registries feeding the TSDB, identity-deduped: the gateway's
        own (admission shares it by default) plus the engine's cache /
        chaos-injector / collector registries when distinct."""
        seen: List[MetricsRegistry] = []
        candidates = [
            self.registry,
            getattr(self.admission, "registry", None),
            getattr(getattr(self.engine, "cache", None), "registry", None),
            getattr(getattr(self.engine, "injector", None), "registry",
                    None),
            getattr(self.collector, "registry", None)
            if self.collector is not None else None,
        ]
        for r in candidates:
            if r is not None and all(r is not s for s in seen):
                seen.append(r)
        return seen

    def _telemetry_tick(self, now: Optional[float] = None) -> None:
        """One sampling pass (pool thread): merge registry snapshots into
        the TSDB, GC idle admission tenants, run the streaming detectors
        and the SLO burn evaluation + admission nudge."""
        tsdb = self.tsdb
        if tsdb is None:
            return
        merged: Dict[str, object] = {}
        for reg in self._telemetry_sources():
            merged.update(reg.snapshot())
        tsdb.sample(merged, ts=now)
        gc = getattr(self.admission, "gc_idle_tenants", None)
        if callable(gc):
            gc(now=now)
        if self.anomaly is not None:
            self.anomaly.evaluate(tsdb, now)
        if self.slo is not None:
            self.slo.evaluate(now)
            self.slo.nudge(self.admission)

    async def _telemetry_loop(self) -> None:
        """Periodic sampling task (same template as ``_promote_loop``);
        ticks run on the pool so snapshot/detector cost never blocks the
        loop. Cancellation (engine shutdown) exits cleanly."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.telemetry_interval_s)
            try:
                await loop.run_in_executor(self._pool, self._telemetry_tick)
            except RuntimeError:   # pool shut down mid-flight
                return
            except Exception:  # noqa: BLE001 — telemetry is advisory
                pass

    def _fold_profile(self, run: WorkflowRun, step: str,
                      prof: Dict[str, float]) -> None:
        """Record a step's compute-layer profile (jit compile vs execute
        split, device memory) as registry histograms/gauges and annotate
        its span so ``run.report()`` shows the breakdown."""
        m = self.registry
        if "compile_s" in prof:
            m.histogram("step_compile_s").observe(prof["compile_s"])
        if "execute_s" in prof:
            m.histogram("step_execute_s").observe(prof["execute_s"])
        if "device_bytes_in_use" in prof:
            m.gauge("device_bytes_in_use").set(prof["device_bytes_in_use"])
        if self.collector is not None:
            self.collector.annotate_step(run.run_id, step, **prof)

    def _note_step_telemetry(self, handle: AsyncWorkflowRun,
                             run: WorkflowRun, step: str) -> None:
        """Feed a succeeded step's duration to the straggler detector;
        publish any resulting alert in-band. Runs on the loop thread right
        after the step's terminal publish — never from inside an observer
        (the handle's publish lock is not reentrant)."""
        rec = run.steps.get(step)
        if rec is None or rec.start is None or rec.end is None \
                or rec.end <= rec.start:
            return
        alert = self.anomaly.note_step_duration(
            run.workflow.name, step, rec.end - rec.start,
            tenant=handle.tenant)
        if alert is not None:
            handle._publish(EventType.ALERT, step=step,
                            status=alert.detector, error=alert.reason)
