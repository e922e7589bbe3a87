"""Counters, gauges and histograms over one process-wide store.

Port of the store in ``paddle_tpu/observability/metrics.py``: scalar
counters and gauges (the reference keeps them in
``core/monitor.StatRegistry``; here the store holds them itself) and
histograms with bounded raw-value buffers for percentiles, behind one
``snapshot()`` / ``reset()`` surface. Metric names are the reference's
'/'-namespaced ones (``serving/compiles``,
``serving/request_latency_ms/<tenant>``). The collective byte
accounting and the telemetry deltas are ROADMAP Queue 1 items 8 and 11.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional

from .. import concurrency as _concurrency

_HIST_BUF = 2048        # raw values kept per histogram for percentiles


def _pct(sorted_buf, q: float) -> float:
    """Nearest-rank percentile (ceil(q*n) ranked, 1-based) over an
    already-sorted buffer."""
    if not sorted_buf:
        return 0.0
    idx = max(0, min(math.ceil(q / 100.0 * len(sorted_buf)) - 1,
                     len(sorted_buf) - 1))
    return sorted_buf[idx]


class StatValue:
    """One scalar: a counter (``add``) or a gauge (``set``)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, v):
        with self._lock:
            self._value += v
            return self._value

    def set(self, v):
        with self._lock:
            self._value = v

    def get(self):
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution: exact count/sum/min/max, percentiles
    from the most recent ``_HIST_BUF`` observations."""

    __slots__ = ("name", "count", "total", "min", "max", "_buf", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._buf = deque(maxlen=_HIST_BUF)
        self._lock = _concurrency.make_lock("Histogram._lock")

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._buf.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            buf = sorted(self._buf)
        return _pct(buf, q)

    def values(self) -> List[float]:
        """The buffered observations, oldest first."""
        with self._lock:
            return list(self._buf)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            buf = sorted(self._buf)
            count, total = self.count, self.total
            mn, mx = self.min, self.max
        if not count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": total / count, "p50": _pct(buf, 50),
                "p95": _pct(buf, 95), "p99": _pct(buf, 99)}


class MetricRegistry:
    """Singleton store of scalars and histograms."""

    _instance: Optional["MetricRegistry"] = None
    _cls_lock = _concurrency.make_lock("MetricRegistry._cls_lock")

    def __init__(self):
        self._scalars: Dict[str, StatValue] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = _concurrency.make_lock("MetricRegistry._lock")

    @classmethod
    def instance(cls) -> "MetricRegistry":
        if cls._instance is None:
            with cls._cls_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def _scalar(self, name: str) -> StatValue:
        with self._lock:
            s = self._scalars.get(name)
            if s is None:
                s = self._scalars[name] = StatValue(name)
            return s

    def counter_add(self, name: str, value=1):
        return self._scalar(name).add(value)

    def gauge_set(self, name: str, value):
        self._scalar(name).set(value)

    def get(self, name: str):
        return self._scalar(name).get()

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def get_histogram(self, name: str) -> Optional[Histogram]:
        """The named histogram without creating it."""
        with self._lock:
            return self._hists.get(name)

    def observe(self, name: str, value: float):
        self.histogram(name).observe(value)

    def snapshot(self) -> Dict[str, object]:
        """Plain dict of every metric: scalars as numbers, histograms as
        {count,sum,min,max,mean,p50,p95,p99} sub-dicts."""
        with self._lock:
            scalars = list(self._scalars.values())
            hists = list(self._hists.values())
        out: Dict[str, object] = {s.name: s.get() for s in scalars}
        for h in hists:
            out[h.name] = h.summary()
        return out

    def reset(self):
        """Zero every scalar (names stay registered) and drop every
        histogram, as the reference's ``reset``."""
        with self._lock:
            scalars = list(self._scalars.values())
            self._hists.clear()
        for s in scalars:
            s.set(0)


def counter_add(name: str, value=1):
    return MetricRegistry.instance().counter_add(name, value)


def gauge_set(name: str, value):
    MetricRegistry.instance().gauge_set(name, value)


def hist_observe(name: str, value: float):
    MetricRegistry.instance().observe(name, value)


def metric_get(name: str):
    return MetricRegistry.instance().get(name)


def snapshot() -> Dict[str, object]:
    return MetricRegistry.instance().snapshot()


def reset():
    MetricRegistry.instance().reset()
