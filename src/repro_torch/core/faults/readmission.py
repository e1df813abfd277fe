"""Straggler-aware re-admission policy.

A workflow that fails (step retry budget exhausted, cluster preempted)
does not have to stay failed: the gateway re-enters it into the
``AdmissionQueue`` — resetting failed steps, keeping the satisfied
frontier — after a capped-exponential, jittered backoff. Priority AGES
with each re-admission, so a repeatedly-unlucky tenant climbs the
weighted queue instead of starving behind fresh arrivals, while the
jittered backoff keeps a burst of simultaneous failures from stampeding
the queue in lockstep.

``max_readmissions`` bounds the loop: a workflow still failing after
that many round trips stays ``Failed`` (something is wrong with it, not
with the cluster).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.faults.retry import capped_jittered_delay


@dataclass(frozen=True)
class ReadmissionPolicy:
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    max_readmissions: int = 8
    # priority increment per re-admission (aging: retried runs climb)
    aging_priority_step: int = 1
    jitter: bool = True

    def should_readmit(self, readmit_count: int) -> bool:
        """True when a run that has already been re-admitted
        ``readmit_count`` times gets another round trip."""
        return readmit_count < self.max_readmissions

    def delay_s(self, readmit_count: int,
                rng: Optional[random.Random] = None) -> float:
        return capped_jittered_delay(readmit_count, self.base_backoff_s,
                                     self.max_backoff_s, rng=rng,
                                     jitter=self.jitter)

    def aged_priority(self, priority: int) -> int:
        return priority + self.aging_priority_step
