"""Unified observability fabric: spans, metrics, critical-path attribution.

Zero-dependency instrumentation substrate for the workflow stack
(the measurement layer behind the paper's production claims — +15%
utilization / +17% completion rate are only observable if the system can
say where workflow time goes). Three pillars:

* ``metrics`` — thread-safe ``MetricsRegistry`` (counters / gauges /
  fixed-bucket histograms). Every component ``stats`` dict
  (``WorkflowGateway``, ``AdmissionQueue``, ``TieredCacheStore``,
  ``ChaosInjector``, ``MultiClusterEngine``) is now a compatibility view
  over registry instruments; stable metric names are catalogued in
  ``docs/observability.md``.
* ``spans`` — ``ObsCollector`` derives a span tree per run from the
  gateway's typed event stream: workflow span → step spans with
  queue-wait / cache-fetch / compute / retry / readmission-backoff /
  stream-stall segments, annotated with ``STEP_RETRY`` / ``WORKER_LOST``
  / ``CLUSTER_PREEMPTED`` / ``WORKFLOW_REQUEUED`` causes. Exports JSONL
  and Chrome trace-event JSON (Perfetto-loadable).
* ``attribution`` — critical-path analyzer turning a finished tree into
  a ``MakespanReport`` ("62% compute on train, 21% queue wait, ...")
  whose segments partition the makespan exactly.

Continuous-telemetry pillars on top of those:

* ``timeseries`` — bounded ring-buffer ``TimeSeriesDB`` sampling
  registry snapshots on the gateway daemon loop (windowed rate /
  percentile queries, JSONL persistence);
* ``anomaly`` — streaming detectors (per-site straggler robust z-score,
  readmission storms, cache-hit drift, admission saturation) emitting
  typed ``ALERT`` events in-band on run streams;
* ``slo`` — per-tenant SLO objectives with multi-window burn-rate
  evaluation and an optional admission-queue priority nudge;
* ``exposition`` — OpenMetrics text rendering of any snapshot.

Entry points: ``couler.observe(engine)`` attaches a collector to an
engine (every subsequent run is traced; ``run.report()`` then renders the
breakdown), ``couler.telemetry(engine)`` turns on continuous sampling +
anomaly detection, ``scripts/obs_report.py`` is the offline CLI over
JSONL exports, and ``scripts/obs_dashboard.py`` renders the live fleet
view.
"""
from repro_torch.core.obs.metrics import (Counter, Gauge, Histogram,
                                    MetricsRegistry, StatsView)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "ObsCollector", "Segment", "SpanTree", "StepSpan", "chrome_trace",
    "load_jsonl", "validate_chrome_trace",
    "MakespanReport", "build_report", "critical_path", "observe",
    "TimeSeriesDB",
    "Alert", "AnomalyMonitor", "StragglerDetector",
    "ReadmissionStormDetector", "CacheHitDriftDetector",
    "AdmissionSaturationDetector",
    "SLO", "SLOMonitor",
    "render_openmetrics", "parse_openmetrics",
]

# spans/attribution import the gateway event taxonomy, while the gateway
# stack imports obs.metrics — loading those pillars lazily (PEP 562) keeps
# ``from repro_torch.core.obs.metrics import ...`` cycle-free for every entry
# point into the package graph
_LAZY = {
    "ObsCollector": "spans", "Segment": "spans", "SpanTree": "spans",
    "StepSpan": "spans", "chrome_trace": "spans", "load_jsonl": "spans",
    "validate_chrome_trace": "spans",
    "MakespanReport": "attribution", "build_report": "attribution",
    "critical_path": "attribution",
    "TimeSeriesDB": "timeseries",
    "Alert": "anomaly", "AnomalyMonitor": "anomaly",
    "StragglerDetector": "anomaly", "ReadmissionStormDetector": "anomaly",
    "CacheHitDriftDetector": "anomaly",
    "AdmissionSaturationDetector": "anomaly",
    "SLO": "slo", "SLOMonitor": "slo",
    "render_openmetrics": "exposition", "parse_openmetrics": "exposition",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def observe(engine, collector=None):
    """Attach an ``ObsCollector`` to ``engine`` so every subsequent run
    gets a span tree and ``run.report()`` works. Gateway-native engines
    (``LocalEngine``) trace at full step granularity; ``MultiClusterEngine``
    ingests the coarse admitted-batch streams via ``attach_collector``.
    Returns the collector (pass an existing one to share it)."""
    from repro_torch.core.obs.spans import ObsCollector
    c = collector or ObsCollector()
    gw = getattr(engine, "gateway", None)
    if gw is not None and hasattr(gw, "attach_collector"):
        gw.attach_collector(c)
    elif hasattr(engine, "attach_collector"):
        engine.attach_collector(c)
    else:
        raise TypeError(
            f"engine {type(engine).__name__} has no gateway or "
            "attach_collector — nothing to observe")
    return c
