"""Unified metrics registry: counters, gauges, bucketed histograms.

One mechanism replaces the engine's ad-hoc stats dicts (``ServeEngine.
stats``), the cache dataclasses (``core.plancache.CacheStats``) and the
executor's per-run dict — all three keep their old read surfaces as
compatibility views, but every increment flows through here, so there is
exactly one increment site per event and one snapshot format.

* **Labeled series** — ``registry.counter("cache_hits", cache="results")``
  returns one counter per distinct label set; snapshots key series as
  ``name{k=v,...}``.
* **Lock-free reads** — writes take a per-metric lock (CPython ``+=`` is
  not atomic under free-threading and histogram updates touch several
  fields); reads copy plain ints/floats without locking. A snapshot may
  therefore be *slightly* stale but never torn for single-value metrics;
  histogram snapshots take the metric lock briefly to keep
  (count, sum, buckets) mutually consistent.
* **Histograms, not latency lists** — serve-tier percentiles come from
  fixed exponential buckets (p50/p99 by linear interpolation within the
  bucket), O(#buckets) memory regardless of traffic, accurate to the
  bucket resolution (validated against numpy quantiles in
  ``tests/test_obs.py``).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value


def exponential_buckets(start: float, factor: float, count: int
                        ) -> Tuple[float, ...]:
    return tuple(start * factor ** i for i in range(count))


# Default latency buckets: 10µs → ~84s in ×2 steps (23 buckets + +Inf).
DEFAULT_BUCKETS = exponential_buckets(1e-5, 2.0, 23)


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and interpolated
    percentiles. Bucket ``i`` counts observations ``<= bounds[i]``; one
    implicit +Inf bucket catches the rest."""

    __slots__ = ("bounds", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        # binary search for the first bound >= v
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Quantile ``q`` in [0, 1] by linear interpolation inside the
        containing bucket (clamped to observed min/max so tiny samples
        don't report a bucket edge far from any observation)."""
        with self._lock:
            counts = list(self._counts)
            total, mn, mx = self._count, self._min, self._max
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else mx
                frac = (rank - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(mn, min(mx, est))
            seen += c
        return mx

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, s = self._count, self._sum
            mn, mx = self._min, self._max
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": count, "sum": s, "mean": s / count,
            "min": mn, "max": mx,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


def _series_key(name: str, labels: Dict[str, Any]) -> Tuple:
    return (name, tuple(sorted(labels.items())))


def _series_name(key: Tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process-wide (or per-engine) named metric store.

    ``counter``/``gauge``/``histogram`` are get-or-create per
    (name, labels); creation takes the registry lock, subsequent lookups
    hit a dict read first so the hot increment path stays cheap.
    """

    def __init__(self):
        self._metrics: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, labels: Dict[str, Any], factory):
        key = _series_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = factory()
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, labels, lambda: Histogram(buckets))

    def series(self) -> List[str]:
        with self._lock:
            return sorted(_series_name(k) for k in self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``name{labels}`` → value (counters/gauges) or summary
        dict (histograms). Reads are lock-free per metric (see module
        docstring); the key list is copied under the registry lock."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for key, m in sorted(items, key=lambda kv: _series_name(kv[0])):
            out[_series_name(key)] = (
                m.snapshot() if isinstance(m, Histogram) else m.value)
        return out


REGISTRY = MetricsRegistry()
