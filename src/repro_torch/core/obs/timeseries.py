"""Bounded ring-buffer time-series store over ``MetricsRegistry`` snapshots.

The PR-9 fabric answers per-run questions; fleet health (the paper's
+15% utilization / +17% completion claims are *trends*) needs the same
metrics **over time**. ``TimeSeriesDB`` is deliberately tiny: one bounded
ring per labeled series, fed by periodically calling ``sample`` with a
registry snapshot — the gateway does this from a daemon-loop task at
``telemetry_interval_s`` cadence (``couler.telemetry(engine)``), and any
offline consumer can do the same with a recorded JSONL file.

* **Label-aware**: series keep the flat snapshot spelling
  (``name{k=v,...}``, see ``metrics.format_series``) so admission's
  per-tenant depth and the cache's per-store hit counters stay distinct.
* **Bounded**: each ring holds the last ``capacity`` points; memory is
  O(series x capacity) regardless of gateway uptime.
* **Histogram flattening**: histogram snapshots (dicts) are stored as two
  scalar series ``name:count`` / ``name:sum`` — enough for windowed rate
  and mean queries without per-bucket rings.
* **Windowed queries**: ``delta``/``rate`` treat a series as a monotonic
  counter (increase over the trailing window); ``quantile`` treats the
  ring's point *values* as a gauge distribution.
* **JSONL persistence**: pass ``path=`` to append one
  ``{"ts": ..., "series": {...}}`` line per sample; ``load_jsonl``
  rebuilds a ``TimeSeriesDB`` from such a file for offline dashboards.

Zero dependencies, thread-safe (one lock; samplers and readers may live
on different threads).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

__all__ = ["TimeSeriesDB", "Point"]

#: one sample: (unix timestamp, value)
Point = Tuple[float, float]


class TimeSeriesDB:
    """Bounded per-series rings of ``(ts, value)`` points."""

    def __init__(self, capacity: int = 512, path: Optional[str] = None):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.capacity = capacity
        self.path = path
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[Point]] = {}
        self._samples = 0

    # -- ingest ------------------------------------------------------------
    def sample(self, snapshot: Mapping[str, object],
               ts: Optional[float] = None) -> None:
        """Fold one registry snapshot (``MetricsRegistry.snapshot()`` or a
        merge of several) into the rings. Non-numeric values are skipped;
        histogram dicts flatten to ``name:count`` / ``name:sum``."""
        ts = time.time() if ts is None else ts
        flat: Dict[str, float] = {}
        for name, v in snapshot.items():
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                flat[name] = float(v)
            elif isinstance(v, Mapping) and "count" in v and "sum" in v:
                flat[f"{name}:count"] = float(v["count"])
                flat[f"{name}:sum"] = float(v["sum"])
        with self._lock:
            for name, v in flat.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = deque(maxlen=self.capacity)
                    self._series[name] = ring
                ring.append((ts, v))
            self._samples += 1
        if self.path:
            line = json.dumps({"ts": ts, "series": flat}, sort_keys=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")

    # -- introspection -----------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def __len__(self) -> int:
        return len(self._series)

    @property
    def samples_taken(self) -> int:
        return self._samples

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def latest_ts(self) -> float:
        """Most recent sample timestamp across every series (0 if empty)."""
        with self._lock:
            return max((r[-1][0] for r in self._series.values() if r),
                       default=0.0)

    # -- windowed queries --------------------------------------------------
    def window(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[Point]:
        """Points of ``name`` within the trailing ``seconds`` window."""
        now = time.time() if now is None else now
        lo = now - seconds
        with self._lock:
            ring = self._series.get(name)
            if not ring:
                return []
            return [p for p in ring if p[0] >= lo]

    def delta(self, name: str, seconds: float,
              now: Optional[float] = None) -> float:
        """Increase of a (monotonic) counter series over the window:
        ``last - first`` of the windowed points (0 with < 2 points)."""
        pts = self.window(name, seconds, now=now)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> float:
        """Per-second increase of a counter series over the window."""
        pts = self.window(name, seconds, now=now)
        if len(pts) < 2:
            return 0.0
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return 0.0
        return (pts[-1][1] - pts[0][1]) / dt

    def quantile(self, name: str, q: float,
                 seconds: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """q-th percentile of the point *values* (gauge semantics) over
        the window (the whole ring when ``seconds`` is None)."""
        if seconds is None:
            with self._lock:
                vals = [v for _, v in self._series.get(name, ())]
        else:
            vals = [v for _, v in self.window(name, seconds, now=now)]
        if not vals:
            return 0.0
        vals.sort()
        i = min(len(vals) - 1, max(0, int(q * len(vals))))
        return vals[i]

    def mean(self, name: str, seconds: float,
             now: Optional[float] = None) -> float:
        vals = [v for _, v in self.window(name, seconds, now=now)]
        return sum(vals) / len(vals) if vals else 0.0

    # -- persistence -------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Write the full ring contents as sample lines (grouped by
        timestamp, in time order). Returns the number of lines."""
        by_ts: Dict[float, Dict[str, float]] = {}
        with self._lock:
            for name, ring in self._series.items():
                for ts, v in ring:
                    by_ts.setdefault(ts, {})[name] = v
        with open(path, "w") as f:
            for ts in sorted(by_ts):
                f.write(json.dumps({"ts": ts, "series": by_ts[ts]},
                                   sort_keys=True) + "\n")
        return len(by_ts)

    @classmethod
    def load_jsonl(cls, path: str, capacity: int = 512) -> "TimeSeriesDB":
        """Rebuild a database from ``export_jsonl`` / live-append output."""
        db = cls(capacity=capacity)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                db.sample(d.get("series", {}), ts=d.get("ts"))
        return db
