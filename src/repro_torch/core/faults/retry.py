"""Transient-retry policy: capped exponential backoff with decorrelated
jitter, plus the one shared retry decision both of ``LocalEngine``'s
execution paths use.

The un-capped ``retry_backoff_s * 2**(attempt-1)`` the engine used to
compute inline grows without bound (attempt 20 of a 20ms base is over an
hour) and, jitterless, synchronizes every step that failed on the same
transient cause into a retry stampede. ``RetryPolicy`` fixes both: the
delay is clamped to ``cap_s`` and drawn from ``uniform(base, 3*delay)``
(decorrelated jitter), so colliding retriers spread out.

``retry_after_transient`` consolidates the duplicated retry logic from
the streaming path and ``_invoke_with_retry``: classify the error, emit
the ``WORKER_LOST`` / ``STEP_RETRY`` events, sleep the backoff, and tell
the caller whether to loop again. Retries are thereby visible in the
event stream (TraceChecker invariant 7) instead of silently absorbed.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.engines.base import is_transient
from repro_torch.core.faults.plan import WorkerLost
from repro_torch.core.gateway.events import EventType

# jitter draws need no replay guarantee (fault *decisions* are the
# deterministic part — see faults.plan); one shared source is fine
_jitter_rng = random.Random(0x5EED)


def capped_jittered_delay(attempt: int, base_s: float, cap_s: float,
                          rng: Optional[random.Random] = None,
                          jitter: bool = True) -> float:
    """Backoff before retry ``attempt`` (1-based): exponential in the
    attempt number, clamped to ``cap_s``, decorrelated-jittered."""
    d = min(cap_s, base_s * (2 ** max(0, attempt - 1)))
    if jitter and d > 0:
        d = min(cap_s, (rng or _jitter_rng).uniform(base_s, 3.0 * d))
    return max(0.0, d)


@dataclass(frozen=True)
class RetryPolicy:
    base_s: float = 0.02
    cap_s: float = 2.0
    jitter: bool = True

    def delay_s(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        return capped_jittered_delay(attempt, self.base_s, self.cap_s,
                                     rng=rng, jitter=self.jitter)


def retry_after_transient(exc: BaseException, *, attempt: int,
                          retry_limit: int, policy: RetryPolicy,
                          step: str = "",
                          publish: Optional[Callable] = None,
                          rng: Optional[random.Random] = None,
                          sleep: Callable[[float], None] = time.sleep
                          ) -> bool:
    """One retry decision after ``exc`` on attempt ``attempt`` (1-based).

    Returns True when the caller should retry — after publishing
    ``WORKER_LOST`` (worker-loss faults) and ``STEP_RETRY`` (carrying the
    UPCOMING attempt number, so per-step attempts strictly increase) and
    sleeping the backoff. Returns False for non-transient errors or an
    exhausted budget; the caller marks the step Failed and re-raises.
    """
    if not is_transient(exc) or attempt > retry_limit:
        return False
    if publish is not None:
        err = f"{type(exc).__name__}: {exc}"
        if isinstance(exc, WorkerLost):
            publish(EventType.WORKER_LOST, step=step, attempt=attempt,
                    error=err)
        publish(EventType.STEP_RETRY, step=step, attempt=attempt + 1,
                error=err)
    sleep(policy.delay_s(attempt, rng))
    return True
