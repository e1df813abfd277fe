"""Local DAG executor — the reference COULER engine.

Implements the production behaviours of App. B:
  * topological scheduling with a worker pool (max parallelism, Eq. 1 goal)
  * automatic artifact caching (Algorithm 2) — steps whose outputs hit the
    cache are marked ``Cached`` and skipped; ``cache`` accepts the default
    single-tier ``CacheStore`` or a multi-tier ``TieredCacheStore``
    (``repro_torch.core.cache``) — both expose the same offer/get surface
  * controller auto-retry with backoff on the known transient patterns
  * straggler mitigation: a speculative duplicate races any step exceeding
    ``straggler_factor x est_time_s`` when spare workers exist
  * big-workflow auto-split (Algorithm 3) before scheduling
  * restart-from-failure: ``resume(run)`` skips Succeeded/Skipped/Cached

Scheduling runs on the engine's ``WorkflowGateway``
(``repro_torch.core.gateway``): one asyncio loop drives the push-based
completion callbacks for every in-flight workflow, sharing a single
worker pool, a single thread-safe cache store, and a backpressured
multi-tenant admission queue. ``submit``/``resume`` are thin sync facades
(enqueue + wait) over that path; ``submit_async`` exposes it natively as
an awaitable ``AsyncWorkflowRun`` with an event stream and cooperative
cancel. Call ``close()`` to stop the gateway loop, its background cache
promotion task, and the speculation executors.
"""
from __future__ import annotations

import asyncio
import concurrent.futures as cf
import hashlib
import itertools
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.api import StepOutput
from repro_torch.core.autosplit import Budget
from repro_torch.core.caching import CacheStore, CoulerPolicy
from repro_torch.core.engines.base import (Engine, StepRecord, StepStatus,
                                     WorkflowRun)
from repro_torch.core.faults import (ChaosInjector, FaultPlan, FrontierStore,
                               RetryPolicy, WorkerLost, restore_frontier,
                               retry_after_transient)
from repro_torch.core.gateway.channels import (StepContext, StreamBroken,
                                         StreamCancelled, StreamReader,
                                         StreamRewound)
from repro_torch.core.ir import Job, WorkflowIR


def _hash_value(v: Any) -> str:
    """The value's pickle, hashed, with every torch tensor in it (in a dict,
    list or tuple, or in an object's state such as a module's parameters)
    pickled by content: its dtype, its shape and a digest of the bytes of
    ``t.detach().contiguous()`` on the host. A tensor pickles by identity
    otherwise (two equal tensors give two keys), where a JAX array pickles
    by content. Equal values give equal keys whatever their device, storage,
    strides or offset; a value without tensors hashes as its plain pickle,
    or, where that fails, as its ``repr``. A value that does not pickle is
    keyed through its dicts, lists and tuples, each tensor by content (the
    ``repr`` of a large tensor is summarised); None, no reusable key, where
    a part holding a tensor cannot be keyed (``repro_torch.content_key``)."""
    from repro_torch.content_key import digest
    return digest(v)[0]


def cache_key(job: Job, artifact_values: Dict[str, Any],
              stream_key: Optional[str] = None) -> str:
    """Content key for a step's outputs. For a chunk-wise consumer
    (``stream_key`` given) the streamed input's contribution is the
    *producer's* cache key instead of a hash of the (possibly not yet
    materialized) value — equal producer key implies equal chunk stream.

    The step's function is keyed by its code, constants, closure cells'
    contents and defaults, and a literal argument that holds a tensor by
    content (``repro_torch.content_key``); a tensor-free literal by its
    ``repr``, as the reference keys every literal. A step with a part that
    cannot be keyed by content gets a fresh key, so it never hits."""
    import uuid
    from repro_torch.content_key import digest, function_digest
    fresh = f"nokey-{uuid.uuid4().hex}"
    parts = [job.name, job.kind, job.image, ",".join(job.command)]
    if job.fn is not None and hasattr(job.fn, "__code__"):
        fn_key = function_digest(job.fn)
        if fn_key is None:
            return fresh
        parts.append(fn_key)

    def literal(v):
        key, tensor = digest(v) if not isinstance(v, (str, int, float)) else (None, False)
        return (key if tensor else repr(v)), tensor and key is None

    for a in (job.args or ()):
        if isinstance(a, StepOutput):
            if stream_key is not None and a.artifact == job.stream_arg:
                parts.append(f"stream:{stream_key}")
            else:
                key = _hash_value(artifact_values.get(a.artifact))
                if key is None:
                    return fresh
                parts.append(key)
        else:
            text, unkeyable = literal(a)
            if unkeyable:
                return fresh
            parts.append(text)
    for k in sorted(job.kwargs or {}):
        text, unkeyable = literal(job.kwargs[k])
        if unkeyable:
            return fresh
        parts.append(f"{k}={text}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


class LocalEngine(Engine):
    name = "local"

    def __init__(self, max_workers: int = 8,
                 cache: Optional[CacheStore] = None,
                 budget: Optional[Budget] = None,
                 straggler_factor: float = 4.0,
                 retry_backoff_s: float = 0.02,
                 retry_backoff_max_s: float = 2.0,
                 enable_speculation: bool = True,
                 max_inflight_steps: Optional[int] = None,
                 max_inflight_workflows: Optional[int] = None,
                 promote_interval_s: float = 0.25,
                 admission=None,
                 check_events: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 frontier: bool = False,
                 readmission=None,
                 telemetry_interval_s: float = 0.0,
                 anomaly=None,
                 slo=None,
                 telemetry_path=None,
                 profile_steps: bool = False):
        self.max_workers = max_workers
        # compute-layer profiling: jit compile-vs-execute split (AOT
        # lower/compile when the step fn supports it) recorded on
        # StepRecord.profile. Bypasses speculation — a profiled step is
        # measured, not raced.
        self.profile_steps = profile_steps
        self.cache = cache if cache is not None else CacheStore(
            capacity_bytes=1 << 30, policy=CoulerPolicy())
        self.budget = budget or Budget()
        self.straggler_factor = straggler_factor
        self.retry_backoff_s = retry_backoff_s
        # capped exponential backoff + decorrelated jitter (faults.retry);
        # the old inline 2**(attempt-1) formula was unbounded + jitterless
        self.retry_policy = RetryPolicy(base_s=retry_backoff_s,
                                        cap_s=retry_backoff_max_s)
        self.enable_speculation = enable_speculation
        # chaos injection: consulted at every step-attempt boundary (and
        # mid-step for checkpoint-wired jobs); None = no faults
        self.injector = ChaosInjector(fault_plan) if fault_plan else None
        # frontier checkpoint-resume: record per-step completion through
        # the artifact cache after each terminal step event so a fresh
        # engine sharing the cache can resume_from_frontier()
        self.frontier = FrontierStore(self.cache) if frontier else None
        # per-(workflow, step) straggler history: repeated stragglers get
        # their speculation budget shrunk so backups launch sooner
        self._straggler_counts: Dict[str, int] = {}
        # checkpoint sessions: one CheckpointManager per (run, step)
        self._ckpt_mgrs: Dict[tuple, Any] = {}
        self._ckpt_lock = threading.Lock()
        # free-list of persistent 2-worker speculation executors, reused
        # across step invocations instead of constructing one per step
        self._spec_pools: List[cf.ThreadPoolExecutor] = []
        self._spec_lock = threading.Lock()
        # asyncio submission gateway (lazily started on first submit)
        self._gateway = None
        self._gateway_lock = threading.Lock()
        self._gateway_opts = dict(max_inflight_steps=max_inflight_steps,
                                  max_inflight_workflows=max_inflight_workflows,
                                  promote_interval_s=promote_interval_s,
                                  admission=admission,
                                  check_events=check_events,
                                  readmission=readmission,
                                  telemetry_interval_s=telemetry_interval_s,
                                  anomaly=anomaly,
                                  slo=slo,
                                  telemetry_path=telemetry_path)

    # ------------------------------------------------------------------
    @property
    def gateway(self):
        """The engine's ``WorkflowGateway`` (created on first access)."""
        gw = self._gateway
        if gw is None:
            with self._gateway_lock:
                if self._gateway is None:
                    from repro_torch.core.gateway import WorkflowGateway
                    self._gateway = WorkflowGateway(self,
                                                    **self._gateway_opts)
                gw = self._gateway
        return gw

    def lint_context(self):
        bound = self._gateway_opts["max_inflight_steps"] or \
            2 * self.max_workers
        return {"max_inflight_steps": bound}

    def submit(self, wf: WorkflowIR, optimize: bool = True,
               tenant: str = "default", priority: int = 0,
               lint: str = "error", **kw) -> WorkflowRun:
        """Sync facade: lint + enqueue on the gateway (blocking for queue
        space instead of shedding) and wait for the finished
        ``WorkflowRun``. Lint errors raise ``WorkflowLintError`` before
        anything is enqueued (``lint="warn"|"off"`` to opt out)."""
        handle = self.gateway.submit_nowait(wf, optimize=optimize,
                                            tenant=tenant, priority=priority,
                                            block=True, lint=lint)
        return handle.result()

    async def submit_async(self, wf: WorkflowIR, optimize: bool = True,
                           tenant: str = "default", priority: int = 0,
                           block: bool = False, lint: str = "error", **kw):
        """Native async path: admit ``wf`` into the gateway and return its
        ``AsyncWorkflowRun`` (await it, stream ``.events()``, or
        ``.cancel()``). Raises ``QueueFull`` when the tenant's admission
        queue is at capacity; ``block=True`` waits for space instead (the
        blocking offer parks on the queue's condition variable in a
        worker thread — no polling)."""
        from repro_torch.core.gateway import QueueFull
        gw = self.gateway
        try:
            # fast path: space available, no executor hop
            return gw.submit_nowait(wf, optimize=optimize, tenant=tenant,
                                    priority=priority, lint=lint)
        except QueueFull:
            if not block:
                raise
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: gw.submit_nowait(wf, optimize=optimize,
                                           tenant=tenant, priority=priority,
                                           block=True, lint=lint))

    def resume(self, run: WorkflowRun, tenant: str = "default",
               **kw) -> WorkflowRun:
        """Restart from failure (App. B.B): steps already Succeeded, Skipped
        or Cached keep their artifacts; Failed/Pending steps re-run."""
        keep = {StepStatus.SUCCEEDED, StepStatus.SKIPPED, StepStatus.CACHED}
        for n, rec in run.steps.items():
            if rec.status not in keep:
                run.steps[n] = StepRecord()
        handle = self.gateway.submit_nowait(run.workflow, run=run,
                                            resume=True, tenant=tenant,
                                            block=True)
        return handle.result()

    def resume_from_frontier(self, wf: WorkflowIR, tenant: str = "default",
                             snapshot=None) -> WorkflowRun:
        """Crash recovery on a FRESH engine: reconstruct a run of ``wf``
        from the frontier snapshot persisted through the artifact cache
        (or an explicit ``snapshot`` — e.g. a ``WorkflowRun.persist``
        file loaded via ``faults.load_run_snapshot``) and resume it.
        Steps whose recorded cache keys still hit stay done (``Cached``,
        artifacts restored); everything else re-runs. Requires this
        engine's ``cache`` to be (or share a tier with) the one the
        crashed run wrote through."""
        if snapshot is None:
            store = self.frontier or FrontierStore(self.cache)
            snapshot = store.load(wf)
        wf.validate()
        run = restore_frontier(wf, snapshot, self.cache)
        handle = self.gateway.submit_nowait(wf, run=run, resume=True,
                                            tenant=tenant, block=True)
        return handle.result()

    def close(self) -> None:
        """Shut down the gateway loop (stopping the background cache
        promotion task cleanly) and the speculation executors."""
        gw = self._gateway
        if gw is not None:
            gw.stop()
        with self._spec_lock:
            pools, self._spec_pools = self._spec_pools, []
        for p in pools:
            p.shutdown(wait=False)

    # ------------------------------------------------------------------
    def _exec_step(self, job: Job, run: WorkflowRun,
                   ctx: Optional[StepContext] = None) -> StepStatus:
        if job.stream_output or job.stream_input:
            return self._exec_stream_step(job, run, ctx)
        rec = run.steps[job.name]
        rec.start = time.time()
        rec.status = StepStatus.RUNNING

        # condition (couler.when)
        if job.condition is not None and not job.condition.evaluate(run.artifacts):
            rec.status = StepStatus.SKIPPED
            rec.end = time.time()
            return rec.status

        # cache check (Algorithm 2 consumer side); non-cacheable steps skip
        # the key hash entirely (it is only ever used for get/offer)
        key = cache_key(job, run.artifacts) if job.cacheable else ""
        rec.cache_key = key             # persisted for frontier resume
        if job.cacheable:
            hit = self.cache.get(key)
            if hit is not None:
                for out in job.outputs:
                    run.artifacts[out] = hit.value
                rec.status = StepStatus.CACHED
                rec.end = time.time()
                return rec.status

        publish = ctx.publish if ctx is not None else None
        iterations = 0
        while True:                                   # exec_while loop
            value, dur = self._invoke_with_retry(job, run, rec, publish)
            iterations += 1
            if job.loop_condition is None:
                break
            for out in job.outputs:                   # loop cond reads output
                run.artifacts[out] = value
            if not job.loop_condition.evaluate(run.artifacts):
                break
            if iterations >= job.max_iterations:
                break

        for out in job.outputs:
            run.artifacts[out] = value
        # monitor feedback (App. B.B): measured duration refines the IR's
        # time estimate, which feeds Eq. 3's w_i on the next cache decision
        # (weights_version keys the scorer's memo, so bump it)
        job.est_time_s = 0.5 * job.est_time_s + 0.5 * dur
        run.workflow.note_weights_changed()
        if job.cacheable:
            self.cache.offer(key, value, compute_time_s=dur,
                             producer=job.name, workflow=run.workflow)
        rec.status = StepStatus.SUCCEEDED
        rec.end = time.time()
        return rec.status

    # -- streaming steps (couler.run_stream / couler.map_stream) --------
    #
    # A streaming step ALWAYS takes this path, gateway or not: its fn
    # returns a generator, and storing that raw generator as the artifact
    # (the non-streaming path would) is never right — without a channel
    # the chunks are simply materialized with no overlap.
    #
    # Chunk-granular caching: chunk i of a step with key K is offered as
    # "K#c{i}" and the chunk count as manifest "K#n". A later run replays
    # the longest cached prefix (chunks stream downstream immediately) and
    # recomputes only the tail by re-running the source and skipping the
    # first k items — valid because streams are deterministic: equal key
    # implies equal chunk sequence. All chunks cached => the step is
    # ``Cached`` without invoking its fn at all.
    def _exec_stream_step(self, job: Job, run: WorkflowRun,
                          ctx: Optional[StepContext]) -> StepStatus:
        rec = run.steps[job.name]
        rec.start = time.time()
        rec.status = StepStatus.RUNNING
        out_art = job.outputs[0] if job.outputs else None
        ch = ctx.channels.get(out_art) if (ctx and out_art) else None
        in_ch = (ctx.channels.get(job.stream_arg)
                 if (ctx and job.stream_input and job.stream_arg) else None)

        if job.condition is not None \
                and not job.condition.evaluate(run.artifacts):
            rec.status = StepStatus.SKIPPED
            rec.end = time.time()
            if ch is not None:
                ch.close(0)
            return rec.status

        key = ""
        if job.cacheable:
            if in_ch is not None:
                # the consumer's key substitutes the producer's key for the
                # streamed (unmaterialized) input; an uncacheable upstream
                # (empty source_key) cannot identify the stream => no key
                key = (cache_key(job, run.artifacts,
                                 stream_key=in_ch.source_key)
                       if in_ch.source_key else "")
            else:
                key = cache_key(job, run.artifacts)
        if ch is not None:
            ch.source_key = key
        rec.cache_key = key             # persisted for frontier resume

        publish = ctx.publish if ctx else None
        failures = 0
        t0 = time.time()
        try:
            while True:
                rec.attempts += 1
                try:
                    if self.injector is not None:
                        fault, _ = self.injector.begin_attempt(
                            run.workflow.name, job.name)
                        if fault is not None:
                            raise fault
                    chunks, fully_cached = self._stream_once(
                        job, run, rec, ch, in_ch, key, publish)
                    break
                except StreamRewound:
                    # upstream producer retried: restart (replaying our own
                    # cached prefix) without spending our retry budget
                    if ch is not None:
                        ch.rewind()
                    continue
                except StreamBroken as e:
                    rec.error = f"{type(e).__name__}: {e}"
                    rec.status = StepStatus.FAILED
                    rec.end = time.time()
                    if ch is not None:
                        ch.abort(e)
                    return rec.status
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    if retry_after_transient(
                            e, attempt=failures, retry_limit=job.retry_limit,
                            policy=self.retry_policy, step=job.name,
                            publish=publish):
                        # retried producer rewinds its channel: attached
                        # readers restart from chunk 0
                        if ch is not None:
                            ch.rewind()
                        continue
                    rec.error = f"{type(e).__name__}: {e}"
                    rec.status = StepStatus.FAILED
                    rec.end = time.time()
                    if ch is not None:
                        ch.abort(e)
                    raise
        except StreamCancelled:
            # cooperative cancel mid-stream: propagate so the gateway
            # reverts this step to Pending (the run stays resumable)
            raise

        dur = time.time() - t0
        if out_art is not None:
            run.artifacts[out_art] = chunks
        if fully_cached:
            rec.status = StepStatus.CACHED
            rec.end = time.time()
            return rec.status
        job.est_time_s = 0.5 * job.est_time_s + 0.5 * dur
        run.workflow.note_weights_changed()
        if key:
            # manifest last: its presence promises the full chunk run was
            # offered (individual chunks may still be evicted later — the
            # replay loop probes per chunk and recomputes the tail)
            self.cache.offer(f"{key}#n", len(chunks), compute_time_s=0.0,
                             producer=job.name, workflow=run.workflow)
        rec.status = StepStatus.SUCCEEDED
        rec.end = time.time()
        return rec.status

    def _stream_once(self, job: Job, run: WorkflowRun, rec: StepRecord,
                     ch, in_ch, key: str, publish):
        """One attempt at producing the full chunk sequence: replay the
        cached prefix, then compute the tail from the source (the fn's
        generator, or the upstream channel/materialized chunks for
        consumers). Returns (chunks, fully_cached)."""
        from repro_torch.core.gateway.events import EventType
        rec.chunks_replayed = 0
        rec.chunks_emitted = 0
        chunks: List[Any] = []
        announced = [False]

        def emit(c: Any, replay: bool) -> None:
            if publish is not None and not announced[0]:
                announced[0] = True
                publish(EventType.STEP_STREAMING, step=job.name)
            if ch is not None:
                ch.put(c, replay=replay)   # blocks under backpressure
            chunks.append(c)
            if publish is not None:
                publish(EventType.STEP_CHUNK, step=job.name,
                        chunk=len(chunks) - 1)

        n_total: Optional[int] = None
        if key:
            m = self.cache.get(f"{key}#n")
            if m is not None:
                n_total = int(m.value)
            while n_total is None or len(chunks) < n_total:
                hit = self.cache.get(f"{key}#c{len(chunks)}")
                if hit is None:
                    break
                emit(hit.value, True)
                rec.chunks_replayed += 1
            if n_total is not None and len(chunks) >= n_total:
                if ch is not None:
                    ch.close(len(chunks))
                return chunks, True
        k = len(chunks)                    # cached prefix length

        reader: Optional[StreamReader] = None
        try:
            last = time.time()
            if job.stream_input:
                if in_ch is not None:
                    reader = in_ch.reader(job.name)
                    if k:
                        reader.seek(k)     # chunk j depends on input j only
                    indexed = enumerate(reader, start=k)
                else:
                    # producer already materialized (resume / other part /
                    # non-gateway execution): same chunks, no overlap
                    mat = run.artifacts.get(job.stream_arg)
                    it = iter(mat) if mat is not None else iter(())
                    indexed = enumerate(itertools.islice(it, k, None),
                                        start=k)
                per_chunk = self._stream_consumer_fn(job, run)
                for j, c_in in indexed:
                    c = per_chunk(c_in)
                    emit(c, False)
                    rec.chunks_emitted += 1
                    now = time.time()
                    if key:
                        self.cache.offer(f"{key}#c{j}", c,
                                         compute_time_s=now - last,
                                         producer=job.name,
                                         workflow=run.workflow)
                    last = now
            else:
                for j, c in enumerate(self._invoke_stream(job, run)):
                    if j < k:
                        continue           # deterministic prefix replayed
                    emit(c, False)
                    rec.chunks_emitted += 1
                    now = time.time()
                    if key:
                        self.cache.offer(f"{key}#c{j}", c,
                                         compute_time_s=now - last,
                                         producer=job.name,
                                         workflow=run.workflow)
                    last = now
        finally:
            if reader is not None:
                reader.close()
        if ch is not None:
            ch.close(len(chunks))
        return chunks, False

    def _stream_consumer_fn(self, job: Job, run: WorkflowRun):
        """Bind a chunk-wise consumer's non-stream args once; returns a
        callable chunk -> output chunk."""
        fn = job.fn
        if fn is None:
            return lambda c: c             # container placeholder: identity
        slots: List[Any] = []
        stream_idx = None
        for i, a in enumerate(job.args):
            if isinstance(a, StepOutput) and a.artifact == job.stream_arg \
                    and stream_idx is None:
                stream_idx = i
                slots.append(None)
            elif isinstance(a, StepOutput):
                slots.append(run.artifacts.get(a.artifact))
            else:
                slots.append(a)
        kwargs = job.kwargs

        if stream_idx is None:
            return lambda c: fn(c, *slots, **kwargs)

        def call(c: Any) -> Any:
            args = list(slots)
            args[stream_idx] = c
            return fn(*args, **kwargs)
        return call

    def _invoke_stream(self, job: Job, run: WorkflowRun):
        """Invoke a streaming producer's fn and return its chunk iterator.
        Speculation never applies here — racing a duplicate generator would
        double-emit chunks."""
        if job.fn is None:
            return iter([" ".join(job.command) or job.name])
        args = [run.artifacts.get(a.artifact) if isinstance(a, StepOutput)
                else a for a in job.args]
        res = job.fn(*args, **job.kwargs)
        return iter(res)

    def _invoke_with_retry(self, job: Job, run: WorkflowRun, rec: StepRecord,
                           publish=None):
        attempt = 0
        while True:
            attempt += 1
            rec.attempts = attempt
            t0 = time.time()
            try:
                mid_kill = None
                if self.injector is not None:
                    # chaos consult, one per attempt (the step boundary):
                    # crashes raise before the fn runs; worker loss runs
                    # the fn and loses the result with the slot — except
                    # for checkpoint-wired jobs, where the kill lands
                    # MID-STEP at an injector-chosen iteration instead
                    fault, kill_at = self.injector.begin_attempt(
                        run.workflow.name, job.name,
                        checkpointed=bool(job.checkpoint))
                    if fault is not None:
                        if kill_at is not None:
                            mid_kill = (fault, kill_at)
                        elif isinstance(fault, WorkerLost):
                            self._invoke(job, run)   # work done, result
                            raise fault              # died with the slot
                        else:
                            raise fault
                    # straggler injection (separate draw sequence): the
                    # delay lands inside the attempt, so rec.end-rec.start
                    # carries it and the telemetry straggler detector sees
                    # exactly what a slow worker would look like
                    d = self.injector.straggler_delay(
                        run.workflow.name, job.name)
                    if d > 0:
                        time.sleep(d)
                value = self._invoke(job, run, mid_kill=mid_kill)
                return value, time.time() - t0
            except Exception as e:  # noqa: BLE001
                if retry_after_transient(
                        e, attempt=attempt, retry_limit=job.retry_limit,
                        policy=self.retry_policy, step=job.name,
                        publish=publish):
                    continue
                rec.error = f"{type(e).__name__}: {e}"
                rec.status = StepStatus.FAILED
                rec.end = time.time()
                raise

    def _spec_pool_acquire(self) -> cf.ThreadPoolExecutor:
        with self._spec_lock:
            if self._spec_pools:
                return self._spec_pools.pop()
        return cf.ThreadPoolExecutor(max_workers=2,
                                     thread_name_prefix="speculation")

    def _spec_pool_release(self, pool: cf.ThreadPoolExecutor,
                           busy: bool) -> None:
        # A pool whose straggler is still running must NOT be reused (the
        # next occupant's backup would queue behind it) nor joined (the
        # backup already won); abandon it without waiting.
        if busy:
            pool.shutdown(wait=False)
            return
        with self._spec_lock:
            if len(self._spec_pools) < 2 * self.max_workers:
                self._spec_pools.append(pool)
                return
        pool.shutdown(wait=False)

    def _ckpt_session(self, job: Job, run: WorkflowRun, mid_kill):
        """Build the ``ckpt=`` session handed to a checkpoint-wired step.
        One ``CheckpointManager`` per (run, step) — shared across retry
        attempts AND re-admissions (same run_id), and rooted at the
        user-chosen directory so a fresh engine resumes from disk."""
        from repro_torch.training.checkpoint import (CheckpointManager,
                                                     StepCheckpointSession)
        mkey = (run.run_id, job.name)
        with self._ckpt_lock:
            mgr = self._ckpt_mgrs.get(mkey)
            if mgr is None:
                mgr = CheckpointManager(job.checkpoint)
                self._ckpt_mgrs[mkey] = mgr
        on_tick = None
        if mid_kill is not None:
            exc, kill_at = mid_kill

            def on_tick(it, _exc=exc, _at=kill_at):
                if it >= _at:
                    raise _exc
        return StepCheckpointSession(mgr, on_tick=on_tick)

    def _invoke(self, job: Job, run: WorkflowRun, mid_kill=None):
        if job.fn is None:
            return " ".join(job.command) or job.name   # container no-op
        args = [run.artifacts.get(a.artifact) if isinstance(a, StepOutput)
                else a for a in job.args]

        if job.checkpoint:
            # checkpoint-wired step: fn(..., ckpt=session) saves/restores
            # through training.checkpoint. No speculation — two racers
            # would share one checkpoint directory.
            kwargs = dict(job.kwargs)
            kwargs["ckpt"] = self._ckpt_session(job, run, mid_kill)
            return job.fn(*args, **kwargs)

        if self.profile_steps:
            return self._profiled_invoke(job, run, args)

        if not self.enable_speculation:
            return job.fn(*args, **job.kwargs)

        # straggler mitigation: race a speculative copy if the primary
        # exceeds straggler_factor x est_time_s. Executors come from a
        # persistent free-list (idle ones are reused across steps).
        spec_pool = self._spec_pool_acquire()
        futures: List[cf.Future] = []
        site = f"{run.workflow.name}/{job.name}"
        try:
            primary = spec_pool.submit(job.fn, *args, **job.kwargs)
            futures.append(primary)
            # repeated stragglers get speculation prioritized: each prior
            # straggler episode halves the patience before the backup
            budget_s = max(0.05, self.straggler_factor * job.est_time_s
                           / (1 + self._straggler_counts.get(site, 0)))
            try:
                return primary.result(timeout=budget_s)
            except cf.TimeoutError:
                # straggler observed (benign race on the counter: a lost
                # increment only delays the prioritization by one episode)
                self._straggler_counts[site] = \
                    self._straggler_counts.get(site, 0) + 1
                # the backup counts against the gateway's global
                # max_inflight_steps bound: reserve a slot (non-blocking) or
                # skip speculation — backups must not exceed the bound the
                # scheduled steps honour. Engines used without a gateway
                # have no bound to respect.
                gw = self._gateway
                if gw is not None and not gw.try_reserve_step_slot():
                    return primary.result()
                try:
                    backup = spec_pool.submit(job.fn, *args, **job.kwargs)
                except BaseException:
                    if gw is not None:
                        gw.release_step_slot()
                    raise
                if gw is not None:
                    # the slot stays held until the backup thread actually
                    # finishes, even when the primary wins the race
                    backup.add_done_callback(
                        lambda _f: gw.release_step_slot())
                futures.append(backup)
                done, _ = cf.wait([primary, backup],
                                  return_when=cf.FIRST_COMPLETED)
                f = done.pop()
                run.steps[job.name].speculative = True
                return f.result()
        finally:
            self._spec_pool_release(
                spec_pool, busy=any(not f.done() for f in futures))

    def _profiled_invoke(self, job: Job, run: WorkflowRun, args: List[Any]):
        """Invoke with compute-layer profiling (``profile_steps=True``).
        Torch runs eagerly and has no AOT phase, so the call is timed whole
        as ``execute_s``, fenced by ``_block_until_ready``, and there is no
        ``compile_s`` (as the JAX engine records for a fn that is not
        AOT-able). The profile lands on ``StepRecord.profile``; the gateway
        folds it into histograms and span annotations."""
        fn = job.fn
        prof: Dict[str, float] = {}
        t1 = time.time()
        value = fn(*args, **job.kwargs)
        _block_until_ready(value)
        prof["execute_s"] = time.time() - t1
        mem = _device_memory_bytes()
        if mem is not None:
            prof["device_bytes_in_use"] = float(mem)
        run.steps[job.name].profile = prof
        return value


def _block_until_ready(v: Any) -> None:
    """Wait for the work queued on the card, so that execute_s measures
    device time and not the launches: a torch step returns while its
    kernels still run. Torch has no fence for one value, so this waits for
    the whole device; a no-op until CUDA is initialised. A device fault
    raises here and fails the step."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _device_memory_bytes() -> Optional[int]:
    """Bytes the caching allocator holds in tensors on the card
    (``torch.cuda.memory_allocated``), or None until CUDA is initialised, as
    JAX's CPU backend gives none."""
    import torch
    if torch.cuda.is_initialized():
        return torch.cuda.memory_allocated()
    return None
