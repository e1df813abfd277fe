"""Streaming anomaly detection over fleet telemetry.

Four detector families, matching the failure modes the fault-tolerance
and admission layers actually produce:

* ``StragglerDetector`` — per-site (``workflow/step``) step durations
  through a streaming **robust z-score**: the site's trailing window
  yields a median and MAD (median absolute deviation), and a new
  duration fires when ``0.6745 * (d - median) / MAD`` exceeds the
  threshold. Robust statistics survive the odd slow sample that would
  wreck a mean/stddev detector; two extra guards (an absolute duration
  floor and a multiple-of-median floor) keep micro-jitter on
  millisecond-scale steps from ever firing — the clean-corpus
  zero-false-positive pin in ``tests/test_telemetry.py`` holds because
  of them.
* ``ReadmissionStormDetector`` — ``WORKFLOW_REQUEUED`` arrivals in a
  sliding window; crossing the count threshold fires once (hysteresis:
  re-arms only after the window drains), so sustained chaos yields one
  storm alert per episode, not one per requeue.
* ``CacheHitDriftDetector`` — per-store hit ratio over a short window
  vs a long window (from the ``cache_{hits,misses}_total{store=}``
  series in a ``TimeSeriesDB``); a drop beyond the threshold fires.
* ``AdmissionSaturationDetector`` — shed spikes (``admission_shed_total``
  increase over the window) and queue-depth saturation against a known
  capacity.

``AnomalyMonitor`` aggregates them behind two feeds:

* **event-driven** (``note_step_duration`` / ``note_requeue``) — called
  by the gateway on its loop thread as step terminals and requeues are
  published. Run-scoped alerts from these are *also* published in-band
  as typed ``ALERT`` events on the run's handle (the gateway does the
  publish), so ``TraceChecker`` (invariant 9) and ``ObsCollector`` see
  them in stream order.
* **series-driven** (``evaluate(tsdb)``) — called on each telemetry
  sampling tick for the fleet-scope detectors.

Every alert carries ``value``, ``threshold``, and the raw ``context``
that produced it, so the sanity fuzz can independently re-derive the
crossing (``scripts/sanity.py::telemetry_sanity``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.obs.metrics import MetricsRegistry

__all__ = ["Alert", "AnomalyMonitor", "StragglerDetector",
           "ReadmissionStormDetector", "CacheHitDriftDetector",
           "AdmissionSaturationDetector"]


@dataclass(frozen=True)
class Alert:
    """One detector firing. ``value`` and ``threshold`` are the measured
    quantity and the bound it crossed (``value`` >= / > ``threshold``
    depending on the detector); ``context`` holds the raw inputs so the
    crossing can be re-derived independently."""

    detector: str                 # straggler | readmission_storm | ...
    reason: str                   # human-readable, rides in ALERT .error
    value: float
    threshold: float
    ts: float
    scope: str = ""               # site / tenant / store the alert is about
    severity: str = "warning"
    context: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"detector": self.detector, "reason": self.reason,
                "value": self.value, "threshold": self.threshold,
                "ts": self.ts, "scope": self.scope,
                "severity": self.severity, "context": dict(self.context)}


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class StragglerDetector:
    """Per-site robust z-score over step durations.

    A duration fires only when ALL of:

    * the site has ``min_samples`` prior durations (cold sites never fire);
    * ``d`` > ``min_duration_s`` (absolute floor, checked FIRST: sub-jitter
      steps are never stragglers no matter how skewed, and the robust
      statistics are skipped entirely for them — this keeps the per-step
      cost flat on the gateway's terminal path);
    * ``z = 0.6745 * (d - median) / max(MAD, mad_floor)`` > ``z_threshold``;
    * ``d`` > ``median_ratio`` x the site median (scale-free floor).

    The median/MAD pair is cached per site and recomputed only every
    ``stats_refresh`` appends (amortized O(1) per note instead of an
    O(window log window) sort per step terminal); an alert's ``context``
    always carries the exact statistics it was judged against. The
    outlier is appended to the history *after* evaluation, so a
    straggler cannot mask itself — and a stale-by-a-few-samples cache
    only makes masking harder.
    """

    name = "straggler"

    def __init__(self, z_threshold: float = 4.0, min_samples: int = 8,
                 min_duration_s: float = 0.05, median_ratio: float = 2.0,
                 history: int = 128, mad_floor_s: float = 1e-4,
                 stats_refresh: int = 8):
        self.z_threshold = z_threshold
        self.min_samples = min_samples
        self.min_duration_s = min_duration_s
        self.median_ratio = median_ratio
        self.history = history
        self.mad_floor_s = mad_floor_s
        self.stats_refresh = max(1, stats_refresh)
        self._hist: Dict[str, List[float]] = {}
        # site -> [median, mad, scale, appends since compute]
        self._stats: Dict[str, List[float]] = {}

    def note(self, site: str, duration_s: float,
             ts: Optional[float] = None) -> Optional[Alert]:
        hist = self._hist.get(site)
        if hist is None:
            hist = []
            self._hist[site] = hist
        alert = None
        if duration_s > self.min_duration_s \
                and len(hist) >= self.min_samples:
            st = self._stats.get(site)
            if st is None or st[3] >= self.stats_refresh:
                med = _median(hist)
                mad = _median([abs(v - med) for v in hist])
                st = [med, mad, max(mad, self.mad_floor_s), 0.0]
                self._stats[site] = st
            med, mad, scale = st[0], st[1], st[2]
            z = 0.6745 * (duration_s - med) / scale
            if z > self.z_threshold and duration_s > self.median_ratio * med:
                ts = time.time() if ts is None else ts
                alert = Alert(
                    detector=self.name,
                    reason=(f"step duration {duration_s:.3f}s at {site} is "
                            f"z={z:.1f} above the site median "
                            f"{med:.3f}s (MAD {mad:.4f}s)"),
                    value=z, threshold=self.z_threshold, ts=ts, scope=site,
                    context={"duration_s": duration_s, "median_s": med,
                             "mad_s": mad, "scale_s": scale,
                             "n_samples": float(len(hist))})
        hist.append(duration_s)
        if len(hist) > self.history:
            del hist[0]
        if len(hist) > self.min_samples:        # sites below it have no stats
            st = self._stats.get(site)
            if st is not None:
                st[3] += 1.0
        return alert

    def site_history(self, site: str) -> List[float]:
        return list(self._hist.get(site, ()))


class ReadmissionStormDetector:
    """Sliding-window count of workflow requeues; fires once per episode
    (re-arms after the window drains below the threshold)."""

    name = "readmission_storm"

    def __init__(self, window_s: float = 30.0, threshold: int = 3):
        self.window_s = window_s
        self.threshold = threshold
        self._times: Deque[float] = deque()
        self._active = False

    def note(self, workflow: str, tenant: str, ts: float) -> Optional[Alert]:
        self._times.append(ts)
        lo = ts - self.window_s
        while self._times and self._times[0] < lo:
            self._times.popleft()
        n = len(self._times)
        if n < self.threshold:
            self._active = False
            return None
        if self._active:
            return None
        self._active = True
        return Alert(
            detector=self.name,
            reason=(f"{n} workflow requeues within {self.window_s:.0f}s "
                    f"(threshold {self.threshold}); latest: {workflow} "
                    f"(tenant {tenant})"),
            value=float(n), threshold=float(self.threshold), ts=ts,
            scope=tenant, severity="critical",
            context={"window_s": self.window_s, "count": float(n)})

    def recent_times(self) -> List[float]:
        return list(self._times)


class CacheHitDriftDetector:
    """Short-vs-long window hit-ratio drift per cache store (series-fed)."""

    name = "cache_hit_drift"

    def __init__(self, short_s: float = 30.0, long_s: float = 300.0,
                 drop_threshold: float = 0.2, min_requests: int = 50):
        self.short_s = short_s
        self.long_s = long_s
        self.drop_threshold = drop_threshold
        self.min_requests = min_requests

    def evaluate(self, tsdb, now: float) -> List[Alert]:
        out: List[Alert] = []
        for name in tsdb.names():
            if not name.startswith("cache_hits_total"):
                continue
            suffix = name[len("cache_hits_total"):]     # "{store=...}" or ""
            misses = f"cache_misses_total{suffix}"
            h_s = tsdb.delta(name, self.short_s, now=now)
            m_s = tsdb.delta(misses, self.short_s, now=now)
            h_l = tsdb.delta(name, self.long_s, now=now)
            m_l = tsdb.delta(misses, self.long_s, now=now)
            n_s, n_l = h_s + m_s, h_l + m_l
            if n_s < self.min_requests or n_l < self.min_requests:
                continue
            r_s, r_l = h_s / n_s, h_l / n_l
            drop = r_l - r_s
            if drop > self.drop_threshold:
                out.append(Alert(
                    detector=self.name,
                    reason=(f"cache hit ratio {suffix or '(aggregate)'} "
                            f"dropped {drop:.2f}: {r_l:.2f} over "
                            f"{self.long_s:.0f}s vs {r_s:.2f} over "
                            f"{self.short_s:.0f}s"),
                    value=drop, threshold=self.drop_threshold, ts=now,
                    scope=suffix.strip("{}"),
                    context={"ratio_short": r_s, "ratio_long": r_l,
                             "n_short": n_s, "n_long": n_l}))
        return out


class AdmissionSaturationDetector:
    """Shed spikes + queue-depth saturation (series-fed)."""

    name = "admission_saturation"

    def __init__(self, window_s: float = 30.0, shed_threshold: int = 5,
                 depth_capacity: Optional[int] = None,
                 depth_ratio: float = 0.9):
        self.window_s = window_s
        self.shed_threshold = shed_threshold
        self.depth_capacity = depth_capacity
        self.depth_ratio = depth_ratio

    def evaluate(self, tsdb, now: float) -> List[Alert]:
        out: List[Alert] = []
        shed = tsdb.delta("admission_shed_total", self.window_s, now=now)
        if shed >= self.shed_threshold:
            out.append(Alert(
                detector=self.name,
                reason=(f"admission shed {shed:.0f} submissions in the "
                        f"last {self.window_s:.0f}s "
                        f"(threshold {self.shed_threshold})"),
                value=shed, threshold=float(self.shed_threshold), ts=now,
                scope="shed", severity="critical",
                context={"window_s": self.window_s}))
        if self.depth_capacity:
            depth = tsdb.latest("admission_depth") or 0.0
            ratio = depth / self.depth_capacity
            if ratio >= self.depth_ratio:
                out.append(Alert(
                    detector=self.name,
                    reason=(f"admission queue depth {depth:.0f} is at "
                            f"{100 * ratio:.0f}% of capacity "
                            f"{self.depth_capacity}"),
                    value=ratio, threshold=self.depth_ratio, ts=now,
                    scope="depth",
                    context={"depth": depth,
                             "capacity": float(self.depth_capacity)}))
        return out


class AnomalyMonitor:
    """Detector aggregate: event feeds + per-tick series evaluation.

    Alerts land in a bounded log (``alerts``) and bump
    ``alerts_total{detector=}`` in the bound registry. The gateway binds
    its own registry (``bind``) so alert counters appear in the same
    snapshot the telemetry loop samples.
    """

    def __init__(self,
                 straggler: Optional[StragglerDetector] = None,
                 readmission: Optional[ReadmissionStormDetector] = None,
                 series_detectors: Optional[List[object]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_alerts: int = 1024):
        self.straggler = straggler if straggler is not None \
            else StragglerDetector()
        self.readmission_storm = readmission if readmission is not None \
            else ReadmissionStormDetector()
        self.series_detectors = list(series_detectors) \
            if series_detectors is not None \
            else [CacheHitDriftDetector(), AdmissionSaturationDetector()]
        self._lock = threading.Lock()
        self.alerts: Deque[Alert] = deque(maxlen=max_alerts)
        self._registry = registry

    def bind(self, registry: MetricsRegistry) -> "AnomalyMonitor":
        self._registry = registry
        return self

    # -- event-driven feeds (single writer: the gateway loop thread; the
    # detectors themselves are not locked — only the shared alert log is)
    def note_step_duration(self, workflow: str, step: str,
                           duration_s: float, tenant: str = "default",
                           ts: Optional[float] = None) -> Optional[Alert]:
        # ts stays lazy: the detector only needs a timestamp when it
        # actually fires, and this is the gateway's per-step hot path
        alert = self.straggler.note(f"{workflow}/{step}", duration_s, ts)
        if alert is not None:
            self.record(alert)
        return alert

    def note_requeue(self, workflow: str, tenant: str = "default",
                     ts: Optional[float] = None) -> Optional[Alert]:
        ts = time.time() if ts is None else ts
        alert = self.readmission_storm.note(workflow, tenant, ts)
        if alert is not None:
            self.record(alert)
        return alert

    # -- series-driven feed (telemetry tick) -------------------------------
    def evaluate(self, tsdb, now: Optional[float] = None) -> List[Alert]:
        now = time.time() if now is None else now
        fired: List[Alert] = []
        with self._lock:
            for det in self.series_detectors:
                try:
                    fired.extend(det.evaluate(tsdb, now))
                except Exception:   # noqa: BLE001 — detection is advisory
                    pass
            for a in fired:
                self._record_locked(a)
        return fired

    # -- bookkeeping -------------------------------------------------------
    def record(self, alert: Alert) -> None:
        """Record an externally produced alert (e.g. SLO burn) in the same
        log/counters."""
        with self._lock:
            self._record_locked(alert)

    def _record_locked(self, alert: Alert) -> None:
        self.alerts.append(alert)
        if self._registry is not None:
            self._registry.counter("alerts_total",
                                   detector=alert.detector).inc()

    def firing(self, within_s: float = 60.0,
               now: Optional[float] = None) -> List[Alert]:
        """Alerts raised within the trailing window (dashboard view)."""
        now = time.time() if now is None else now
        lo = now - within_s
        with self._lock:
            return [a for a in self.alerts if a.ts >= lo]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for a in self.alerts:
                out[a.detector] = out.get(a.detector, 0) + 1
            return out
