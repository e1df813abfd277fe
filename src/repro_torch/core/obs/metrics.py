"""Thread-safe metrics registry — the counters/gauges/histograms pillar.

Every hand-rolled ``stats`` dict in the gateway stack (``WorkflowGateway``,
``AdmissionQueue``, ``TieredCacheStore``, ``ChaosInjector``,
``MultiClusterEngine``) is now backed by instruments from a
``MetricsRegistry``; the old dict surface survives as a read-compatible
``StatsView`` so ``gateway.stats["submitted"]`` keeps working unchanged.

Design constraints, in order:

* **Correct under concurrency.** ``Counter.inc`` / ``Gauge.set`` take a
  per-instrument lock — increments from the gateway's step pool, the
  asyncio loop thread, and caller threads never lose updates (the old
  ``dict[key] += 1`` read-modify-write did).
* **Cheap.** One uncontended lock acquire per update (~0.3 µs); the
  ``observability_overhead`` benchmark pins the whole fabric below 2% of
  the n=2000 event-driven submit path.
* **Zero dependencies.** Plain ``threading``; export is a plain dict
  (``MetricsRegistry.snapshot``) in stable, documented names — see
  ``docs/observability.md`` for the catalog.

Labels: instruments are keyed by ``(name, sorted(label items))`` so
``registry.counter("admission_shed_total", tenant="a")`` and the same name
with ``tenant="b"`` are distinct series, like Prometheus label sets.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
           "DEFAULT_BUCKETS"]

# fixed histogram buckets (seconds): sub-ms dispatch up to minute-scale
# training steps; +Inf is implicit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0)


def _series_key(name: str, labels: Mapping[str, str]
                ) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def format_series(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Stable flat spelling of a series: ``name{k=v,...}`` (no labels:
    just ``name``) — the snapshot/export key format."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic (float-friendly) counter. ``inc`` only; ``set`` exists
    solely for the dict-compat write path (``StatsView.__setitem__``)."""

    __slots__ = ("name", "labels", "_lock", "_v")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, v: float = 1) -> None:
        with self._lock:
            self._v += v

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge(Counter):
    """Point-in-time value; adds ``dec`` and max-tracking ``set_max``."""

    __slots__ = ()

    def dec(self, v: float = 1) -> None:
        self.inc(-v)

    def add(self, v: float) -> float:
        """Atomic add-and-read (in-flight accounting wants the new value
        to feed a peak gauge without a second race window)."""
        with self._lock:
            self._v += v
            return self._v

    def set_max(self, v: float) -> None:
        """Monotonic high-water mark (``peak_inflight_steps``)."""
        with self._lock:
            if v > self._v:
                self._v = v


class Histogram:
    """Fixed-bucket histogram: cumulative counts per upper bound, plus
    ``sum``/``count`` for mean derivation. Buckets never change after
    construction, so concurrent observes only touch the counts array."""

    __slots__ = ("name", "labels", "buckets", "_lock", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self) -> Dict[str, object]:
        """Snapshot: ``{"count", "sum", "buckets": {le: cumulative}}``."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        out: Dict[str, object] = {"count": n, "sum": s}
        cum, buckets = 0, {}
        for ub, c in zip(self.buckets, counts):
            cum += c
            buckets[str(ub)] = cum
        buckets["+Inf"] = n
        out["buckets"] = buckets
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); +Inf bucket reports the largest
        finite bound."""
        with self._lock:
            counts = list(self._counts)
            n = self._count
        if n == 0:
            return 0.0
        target = max(1, int(q * n + 0.5))
        cum = 0
        for ub, c in zip(self.buckets, counts):
            cum += c
            if cum >= target:
                return ub
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create instrument registry; every accessor is thread-safe
    and idempotent (same name+labels → same instrument)."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple, object] = {}
        # lazy gauges: evaluated at snapshot() time (per-tier cache bytes,
        # queue depths — anything already tracked elsewhere)
        self._callbacks: Dict[str, Callable[[], float]] = {}

    def _get(self, cls, name: str, labels: Mapping[str, str],
             **kw) -> object:
        key = _series_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a callback gauge, sampled at ``snapshot()``."""
        with self._lock:
            self._callbacks[name] = fn

    # -- series removal (label GC) -----------------------------------------
    def drop(self, name: str, **labels: str) -> bool:
        """Remove one series (or, for a bare name with no instrument, a
        ``gauge_fn`` callback). Returns False when absent. The instrument
        object itself stays valid for holders of a stale reference — it
        just no longer appears in snapshots."""
        key = _series_key(name, labels)
        with self._lock:
            if self._instruments.pop(key, None) is not None:
                return True
            return self._callbacks.pop(name, None) is not None

    def drop_labeled(self, label: str, value: str) -> int:
        """Remove every series carrying ``label == value`` (per-tenant
        label GC for departed tenants). Returns the number dropped."""
        pair = (str(label), str(value))
        with self._lock:
            doomed = [k for k in self._instruments if pair in k[1]]
            for k in doomed:
                del self._instruments[k]
        return len(doomed)

    # -- export ------------------------------------------------------------
    def series(self) -> List[Tuple[str, object]]:
        with self._lock:
            insts = list(self._instruments.values())
            cbs = list(self._callbacks.items())
        extra: List[Tuple[str, object]] = []
        errors = 0
        for name, fn in cbs:
            try:
                extra.append((name, fn()))
            except Exception:   # noqa: BLE001 — sampling is best-effort
                errors += 1
        if errors:
            # a raising gauge_fn must not poison the snapshot — count it
            # (``gauge_fn_errors_total``) and keep sampling the rest
            c = self.counter("gauge_fn_errors_total")
            c.inc(errors)
            if all(i is not c for i in insts):
                insts.append(c)
        out: List[Tuple[str, object]] = [
            (format_series(i.name, i.labels), i.value) for i in insts]
        return out + extra

    def snapshot(self) -> Dict[str, object]:
        """Flat ``{series_name: value}`` dict (histograms nest their
        bucket dict). Stable names: see ``docs/observability.md``."""
        return dict(self.series())

    def get_value(self, name: str, **labels: str) -> float:
        """Read one series without creating it (0 if absent)."""
        key = _series_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
        return inst.value if inst is not None else 0


class StatsView:
    """Read/write dict-compatible facade over registry instruments.

    Legacy code and tests address component telemetry as plain dicts
    (``gateway.stats["submitted"]``, ``eng.metrics["cluster_busy_s"]``);
    this view maps each legacy key to a live instrument — or to a callable
    for composite values like the per-cluster busy-seconds dict — so those
    call sites keep working verbatim while mutations flow through the
    thread-safe instruments. Supports the Mapping protocol plus
    ``__setitem__`` (hard-set, used by a few legacy writers); ``+=``
    through the view is only as atomic as the caller's own locking, which
    is why internal hot paths call ``Counter.inc`` directly instead.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, object]):
        # value per key: Counter/Gauge instrument, or zero-arg callable
        self._fields = dict(fields)

    def _read(self, key: str):
        f = self._fields[key]
        if isinstance(f, (Counter, Histogram)):
            return f.value
        return f()

    # -- Mapping protocol --------------------------------------------------
    def __getitem__(self, key: str):
        return self._read(key)

    def __setitem__(self, key: str, value) -> None:
        f = self._fields[key]
        if not isinstance(f, Counter):
            raise TypeError(f"stats field {key!r} is derived; cannot set")
        f.set(value)

    def get(self, key: str, default=None):
        return self._read(key) if key in self._fields else default

    def __contains__(self, key: str) -> bool:
        return key in self._fields

    def __iter__(self) -> Iterable[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def keys(self):
        return self._fields.keys()

    def values(self):
        return [self._read(k) for k in self._fields]

    def items(self):
        return [(k, self._read(k)) for k in self._fields]

    def copy(self) -> Dict[str, object]:
        return dict(self.items())

    def __eq__(self, other) -> bool:
        if isinstance(other, StatsView):
            other = other.copy()
        if isinstance(other, Mapping) or isinstance(other, dict):
            return self.copy() == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"StatsView({self.copy()!r})"
