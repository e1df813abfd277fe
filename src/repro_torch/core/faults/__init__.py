"""Fault tolerance: deterministic chaos injection, frontier
checkpoint-resume, and straggler-aware re-admission.

See ``docs/fault_tolerance.md`` for the fault model, the event additions
(``STEP_RETRY`` / ``WORKER_LOST`` / ``CLUSTER_PREEMPTED`` /
``WORKFLOW_REQUEUED``), resume semantics, and every knob.
"""
from repro_torch.core.faults.frontier import (FRONTIER_PRODUCER, FrontierStore,
                                        load_run_snapshot, restore_frontier,
                                        run_snapshot)
from repro_torch.core.faults.plan import (ChaosInjector, FaultPlan, InjectedCrash,
                                    InjectedFault, InjectedPermanentCrash,
                                    WorkerLost)
from repro_torch.core.faults.readmission import ReadmissionPolicy
from repro_torch.core.faults.retry import (RetryPolicy, capped_jittered_delay,
                                     retry_after_transient)

__all__ = ["FaultPlan", "ChaosInjector", "InjectedFault", "InjectedCrash",
           "InjectedPermanentCrash", "WorkerLost", "RetryPolicy",
           "capped_jittered_delay", "retry_after_transient",
           "ReadmissionPolicy", "FrontierStore", "restore_frontier",
           "run_snapshot", "load_run_snapshot", "FRONTIER_PRODUCER"]
