"""``AsyncWorkflowRun`` — the awaitable handle returned by ``submit_async``.

The handle is **loop-agnostic**: execution happens on the gateway's own
event loop (or, for the generic ``Engine.submit_async`` fallback, in a
worker thread), while awaiting and event iteration work from whatever
asyncio loop the caller runs — results ride a ``concurrent.futures.Future``
and events are fanned out to per-subscriber ``asyncio.Queue``s via
``call_soon_threadsafe``. The same handle therefore also has a blocking
``result()`` for sync facades.

Subscribers never miss events: ``events()`` atomically replays the full
history recorded so far before streaming live ones, so iterating after the
run finished still yields the complete, ordered stream.
"""
from __future__ import annotations

import asyncio
import concurrent.futures as cf
import itertools
import threading
import time
from typing import AsyncIterator, Callable, List, Optional, Tuple

from repro_torch.core.engines.base import WorkflowRun
from repro_torch.core.gateway.events import EventType, WorkflowEvent


class AsyncWorkflowRun:
    """Awaitable handle for one submitted workflow.

    * ``await handle`` / ``handle.result()`` -> the finished ``WorkflowRun``
    * ``async for ev in handle.events()`` -> ordered lifecycle events,
      ending with the single terminal ``WORKFLOW_DONE``
    * ``handle.cancel()`` -> cooperative cancellation: running steps finish,
      no new steps launch, the run ends ``Cancelled`` and stays resumable
      via ``engine.resume(run)``.
    """

    def __init__(self, workflow_name: str, run: Optional[WorkflowRun] = None,
                 tenant: str = "default"):
        self.workflow_name = workflow_name
        self.tenant = tenant
        self.run = run
        self._result: "cf.Future[WorkflowRun]" = cf.Future()
        self._lock = threading.Lock()
        self._history: List[WorkflowEvent] = []
        self._subs: List[Tuple[asyncio.AbstractEventLoop, asyncio.Queue]] = []
        self._cancel = threading.Event()
        self._cancel_cbs: List[Callable[[], None]] = []
        self._seq = itertools.count()
        # synchronous observers (TraceChecker sanitizer, ObsCollector):
        # called under the publish lock so each sees events in seq order
        self._observers: List[Callable[[WorkflowEvent], object]] = []

    def add_observer(self, cb: Callable[[WorkflowEvent], object]) -> None:
        """Register a synchronous per-event hook. Called under the publish
        lock in registration order — observers must be fast and must not
        publish; an observer raising (the TraceChecker sanitizer does, by
        design) propagates out of the offending ``_publish``."""
        with self._lock:
            self._observers.append(cb)

    # -- awaiting ----------------------------------------------------------
    def __await__(self):
        return asyncio.wrap_future(self._result).__await__()

    def result(self, timeout: Optional[float] = None) -> WorkflowRun:
        """Block until the run finishes (the sync facade's wait)."""
        return self._result.result(timeout)

    def done(self) -> bool:
        return self._result.done()

    @property
    def run_id(self) -> str:
        return self.run.run_id if self.run is not None else ""

    @property
    def status(self) -> str:
        return self.run.status if self.run is not None else "Pending"

    # -- cancellation ------------------------------------------------------
    def cancel(self) -> bool:
        """Request cooperative cancellation. Returns False if the run
        already finished. Steps currently executing run to completion;
        steps not yet launched stay ``Pending`` (so the resulting
        ``WorkflowRun`` is resumable)."""
        if self._result.done():
            return False
        self._cancel.set()
        with self._lock:
            cbs = list(self._cancel_cbs)
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass
        return True

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def add_cancel_callback(self, cb: Callable[[], None]) -> None:
        """Register a callback fired on ``cancel()`` (used by the gateway
        to interrupt blocked artifact-channel producers/consumers so a
        cancelled run drains instead of waiting out its streams). Called
        immediately if cancellation was already requested; must be
        thread-safe."""
        with self._lock:
            if not self._cancel.is_set():
                self._cancel_cbs.append(cb)
                return
        cb()

    # -- event stream ------------------------------------------------------
    async def events(self) -> AsyncIterator[WorkflowEvent]:
        """Async iterator over lifecycle events; terminates after the
        single ``WORKFLOW_DONE`` event. Safe to call from any loop, any
        number of times, before or after completion."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        with self._lock:
            backlog = list(self._history)
            self._subs.append((loop, q))
        try:
            for ev in backlog:
                yield ev
                if ev.terminal:
                    return
            while True:
                ev = await q.get()
                yield ev
                if ev.terminal:
                    return
        finally:
            with self._lock:
                try:
                    self._subs.remove((loop, q))
                except ValueError:
                    pass

    def events_so_far(self) -> List[WorkflowEvent]:
        """Snapshot of the events recorded so far (sync; for inspection)."""
        with self._lock:
            return list(self._history)

    # -- gateway-internal publishing ---------------------------------------
    def _publish(self, type_: EventType, step: str = "", status: str = "",
                 error: str = "", chunk: int = -1,
                 attempt: int = 0) -> WorkflowEvent:
        # seq assignment and history append happen under one lock: chunk
        # events arrive from worker threads concurrently with loop-thread
        # lifecycle events, and history must stay seq-sorted
        with self._lock:
            ev = WorkflowEvent(type=type_, workflow=self.workflow_name,
                               run_id=self.run_id, tenant=self.tenant,
                               step=step, status=status, error=error,
                               chunk=chunk, attempt=attempt,
                               seq=next(self._seq), ts=time.time())
            self._history.append(ev)
            dead = []
            for sub in self._subs:
                loop, q = sub
                try:
                    loop.call_soon_threadsafe(q.put_nowait, ev)
                except RuntimeError:      # subscriber's loop closed
                    dead.append(sub)
            for sub in dead:
                self._subs.remove(sub)
            for observer in self._observers:
                # a sanitizer raises TraceViolation at the offending
                # publish; the lock is released by the with-statement on
                # the way out
                observer(ev)
        return ev

    def _finish(self, run: WorkflowRun) -> None:
        self.run = run
        if not self._result.done():
            self._result.set_result(run)

    def _fail(self, exc: BaseException) -> None:
        if not self._result.done():
            self._result.set_exception(exc)
