"""Chunked producer→consumer artifact channels with backpressure.

An ``ArtifactChannel`` carries one streamed artifact between a producer
step and its chunk-wise consumers while both execute on the gateway's
shared worker pool. The channel is plain-threading (producers and
consumers run in pool threads; only the *scheduling* reaction to the
first chunk rides the asyncio loop, via ``on_first_chunk``):

* ``put`` appends a chunk and **blocks** once the producer is more than
  ``capacity`` chunks ahead of the slowest consumer — consumers that are
  declared (``expect_consumer``) but not yet attached count as cursor 0,
  so a producer can never sprint unboundedly before its consumer gets a
  step slot. ``consumer_done`` releases the phantom cursor of a consumer
  that terminated without ever attaching (skipped / cancelled / failed).
* ``reader`` attaches a cursor-tracked ``StreamReader``; iterating it
  yields chunks in order and ends after ``close(total)``. ``seek(k)``
  skips a cached prefix without waiting for those chunks to exist.
* ``rewind`` (producer transient-retry) clears the history and bumps the
  channel epoch; attached readers observe ``StreamRewound`` on their next
  access and restart from chunk 0 — consumer bodies re-map the stream,
  replaying their own cached chunk prefix instead of recomputing it.
* ``abort`` (producer permanent failure) raises ``StreamBroken`` in every
  reader; ``cancel`` (cooperative run cancellation) raises
  ``StreamCancelled`` in blocked producers *and* consumers so a cancelled
  run drains cleanly — the interrupted steps revert to ``Pending`` and
  the run stays resumable.

Deadlock note: a streaming pipeline needs one in-flight-step slot per
concurrently-live stage; size ``max_inflight_steps`` at or above the
streaming depth. As a safety net a ``put`` blocked longer than
``stall_timeout_s`` raises ``StreamStalled`` (fails the run) instead of
hanging forever.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set


class StreamError(RuntimeError):
    """Base class for streaming-channel signals."""


class StreamCancelled(StreamError):
    """The run was cooperatively cancelled mid-stream."""


class StreamRewound(StreamError):
    """The producer retried and restarted its stream from chunk 0."""


class StreamBroken(StreamError):
    """The producer failed permanently mid-stream."""


class StreamStalled(StreamError):
    """Backpressure wait exceeded ``stall_timeout_s`` (likely an
    under-provisioned ``max_inflight_steps`` for the streaming depth)."""


class ArtifactChannel:
    """Bounded in-order chunk channel for one streamed artifact."""

    def __init__(self, artifact: str, producer: str, capacity: int = 8,
                 stall_timeout_s: float = 60.0):
        self.artifact = artifact
        self.producer = producer
        self.capacity = max(1, int(capacity))
        self.stall_timeout_s = stall_timeout_s
        # the producer's chunk cache key, set before its first put; chained
        # stream consumers derive their own cache key from it
        self.source_key = ""
        self.on_first_chunk: Optional[Callable[[], None]] = None
        self._cv = threading.Condition()
        self._chunks: List[Any] = []
        self._epoch = 0
        self._total: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._expected: Set[str] = set()          # declared, not yet attached
        self._cursors: Dict[int, int] = {}        # reader id -> cursor
        self._rid = itertools.count()
        self._first_fired = False
        self.stats = {"puts": 0, "replayed": 0, "rewinds": 0, "max_lead": 0,
                      # backpressure accounting: how often a put blocked
                      # on a slow consumer, and for how long in total —
                      # the gateway folds these into its metrics registry
                      # and the producer span's stream-stall segment
                      "stalls": 0, "stall_s": 0.0}

    # -- consumer registration ---------------------------------------------
    def expect_consumer(self, name: str) -> None:
        """Declare a consumer that will attach later; until it does (or is
        released via ``consumer_done``) it throttles the producer at
        cursor 0."""
        with self._cv:
            self._expected.add(name)

    def consumer_done(self, name: str) -> None:
        """A declared consumer reached a terminal state; if it never
        attached, drop its phantom cursor so the producer is not throttled
        by a consumer that will never read."""
        with self._cv:
            self._expected.discard(name)
            self._cv.notify_all()

    def reader(self, consumer: str = "?") -> "StreamReader":
        with self._cv:
            rid = next(self._rid)
            self._cursors[rid] = 0
            self._expected.discard(consumer)
            self._cv.notify_all()
            return StreamReader(self, rid, self._epoch)

    # -- producer side ------------------------------------------------------
    def _min_cursor_locked(self) -> int:
        if self._expected:
            return 0
        if not self._cursors:
            return len(self._chunks)              # no consumers: unbounded
        return min(self._cursors.values())

    def put(self, chunk: Any, replay: bool = False) -> int:
        """Append one chunk (blocking while the lead exceeds ``capacity``);
        returns the chunk's index. Replayed (cache-prefix) chunks obey the
        same bound — an unbounded replay would defeat the buffer."""
        fire = False
        with self._cv:
            deadline = (time.monotonic() + self.stall_timeout_s
                        if self.stall_timeout_s else None)
            blocked_at = None
            while True:
                if self._cancelled:
                    raise StreamCancelled(self.artifact)
                if self._total is not None:
                    raise StreamError(f"{self.artifact}: put after close")
                if len(self._chunks) - self._min_cursor_locked() \
                        < self.capacity:
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise StreamStalled(
                        f"{self.artifact}: producer blocked "
                        f">{self.stall_timeout_s}s at lead "
                        f"{len(self._chunks) - self._min_cursor_locked()} "
                        f"(is max_inflight_steps >= the streaming depth?)")
                if blocked_at is None:
                    blocked_at = time.monotonic()
                    self.stats["stalls"] += 1
                self._cv.wait(remaining)
            if blocked_at is not None:
                self.stats["stall_s"] += time.monotonic() - blocked_at
            idx = len(self._chunks)
            self._chunks.append(chunk)
            self.stats["puts"] += 1
            if replay:
                self.stats["replayed"] += 1
            lead = len(self._chunks) - self._min_cursor_locked()
            if lead > self.stats["max_lead"]:
                self.stats["max_lead"] = lead
            if not self._first_fired:
                self._first_fired = True
                fire = True
            self._cv.notify_all()
        if fire and self.on_first_chunk is not None:
            self.on_first_chunk()
        return idx

    def close(self, total: int) -> None:
        with self._cv:
            self._total = total
            self._cv.notify_all()

    def abort(self, exc: BaseException) -> None:
        with self._cv:
            self._error = exc
            self._cv.notify_all()

    def cancel(self) -> None:
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()

    def rewind(self) -> None:
        """Producer retry: clear the history and bump the epoch; attached
        readers raise ``StreamRewound`` on their next access and restart."""
        with self._cv:
            self._epoch += 1
            self._chunks.clear()
            self._total = None
            self._error = None
            self.stats["rewinds"] += 1
            self._cv.notify_all()

    # -- introspection ------------------------------------------------------
    @property
    def finished(self) -> bool:
        with self._cv:
            return (self._total is not None or self._error is not None
                    or self._cancelled)

    def history(self) -> List[Any]:
        with self._cv:
            return list(self._chunks)


class StreamReader:
    """One consumer's cursor over an ``ArtifactChannel``; iterate for
    chunks in order (blocking), ``seek`` past a cached prefix, ``close``
    to detach (always close — a dangling cursor throttles the producer)."""

    def __init__(self, ch: ArtifactChannel, rid: int, epoch: int):
        self._ch = ch
        self._rid = rid
        self._epoch = epoch

    def seek(self, cursor: int) -> None:
        ch = self._ch
        with ch._cv:
            if self._epoch != ch._epoch:
                raise StreamRewound(ch.artifact)
            ch._cursors[self._rid] = cursor
            ch._cv.notify_all()

    def __iter__(self) -> "StreamReader":
        return self

    def __next__(self) -> Any:
        ch = self._ch
        with ch._cv:
            while True:
                if ch._cancelled:
                    raise StreamCancelled(ch.artifact)
                if self._epoch != ch._epoch:
                    raise StreamRewound(ch.artifact)
                cur = ch._cursors.get(self._rid)
                if cur is None:
                    raise StreamError(f"{ch.artifact}: reader closed")
                if cur < len(ch._chunks):
                    ch._cursors[self._rid] = cur + 1
                    chunk = ch._chunks[cur]
                    ch._cv.notify_all()      # lead shrank: wake the producer
                    return chunk
                if ch._error is not None:
                    raise StreamBroken(
                        f"{ch.artifact}: producer {ch.producer} failed: "
                        f"{ch._error}") from ch._error
                if ch._total is not None:
                    raise StopIteration
                ch._cv.wait(1.0)

    def close(self) -> None:
        ch = self._ch
        with ch._cv:
            ch._cursors.pop(self._rid, None)
            ch._cv.notify_all()


class StepContext:
    """Per-part execution context the gateway hands to
    ``LocalEngine._exec_step``: the part's artifact channels (keyed by
    artifact name) and a thread-safe ``publish`` for streaming progress
    events (``STEP_STREAMING`` / ``STEP_CHUNK``)."""

    __slots__ = ("channels", "publish")

    def __init__(self, channels: Optional[Dict[str, ArtifactChannel]] = None,
                 publish: Optional[Callable] = None):
        self.channels: Dict[str, ArtifactChannel] = channels or {}
        self.publish = publish
