"""Gopher Scope: a labeled metrics registry (counters, gauges, histograms).

The port's copy of the JAX package's ``obs/metrics.py`` (numpy only, the
same arithmetic and the same ``gopher-metrics-v1`` snapshot: a snapshot
from either package passes the other's :func:`validate_metrics`).

Prometheus-shaped but dependency-free: a metric is ``(name, sorted label
items)``; counters accumulate, gauges overwrite, histograms keep a bounded
sample window plus exact count/sum so percentiles stay O(window) and a
long-running service can't grow without limit.

Producers (all host-side, all O(1) per run/request, reading only what a
run already brought to the host — there is nothing to disable because
nothing touches the device):

  * the engine feeds per-run superstep/wire/spill/retry/escalation totals
    (``GopherEngine._record_run_metrics``);
  * ``core.tiers`` feeds plan-build counts and EWMA-drift gauges
    (how far observations moved the traffic profile — the signal that a
    plan rebuild is due);
  * ``core.blocks.patch_host_block`` feeds zero-repack patch counters;
  * the serving loop feeds QPS, per-query latency, cache hits, landmark
    staleness and delta-apply latency (``GraphQueryService``);
  * ``resilience`` feeds restart and migration counts.

``snapshot()`` renders the whole registry as a plain dict (JSON-ready);
``launch/scope.py`` persists it next to its trace.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "set_default_registry", "validate_metrics"]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[dict]) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _render(key: _Key) -> str:
    name, items = key
    if not items:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in items) + "}"


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-window histogram: exact count/sum forever, percentiles over
    the most recent ``window`` observations."""

    def __init__(self, window: int = 8192):
        self.count = 0
        self.sum = 0.0
        self.window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.window.append(v)

    def percentile(self, pct: float) -> float:
        if not self.window:
            return 0.0
        return float(np.percentile(np.asarray(self.window), pct))

    def summary(self) -> dict:
        return dict(count=self.count, sum=self.sum,
                    mean=self.sum / self.count if self.count else 0.0,
                    p50=self.percentile(50), p95=self.percentile(95),
                    p99=self.percentile(99))


class MetricsRegistry:
    """Thread-safe named metric store. Metrics are created on first touch;
    repeated lookups return the same object, so hot paths can cache the
    handle (``m = reg.counter(...)`` once, ``m.inc()`` per event)."""

    def __init__(self, histogram_window: int = 8192):
        self._lock = threading.Lock()
        self._histogram_window = histogram_window
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._histograms: Dict[_Key, Histogram] = {}

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        k = _key(name, labels)
        with self._lock:
            m = self._counters.get(k)
            if m is None:
                m = self._counters[k] = Counter()
            return m

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        k = _key(name, labels)
        with self._lock:
            m = self._gauges.get(k)
            if m is None:
                m = self._gauges[k] = Gauge()
            return m

    def histogram(self, name: str, labels: Optional[dict] = None) -> Histogram:
        k = _key(name, labels)
        with self._lock:
            m = self._histograms.get(k)
            if m is None:
                m = self._histograms[k] = Histogram(self._histogram_window)
            return m

    # ---------------- export ----------------
    def snapshot(self) -> dict:
        """The whole registry as a plain JSON-ready dict."""
        with self._lock:
            return {
                "format": "gopher-metrics-v1",
                "counters": {_render(k): c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {_render(k): g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {_render(k): h.summary()
                               for k, h in sorted(self._histograms.items())},
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
        return path

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process default registry every producer writes to unless handed
    its own (the engine/service take a ``metrics=`` override)."""
    return _default


def set_default_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    global _default
    _default = reg if reg is not None else MetricsRegistry()
    return _default


def validate_metrics(obj: dict) -> None:
    """Assert ``obj`` is a structurally valid gopher-metrics snapshot (the
    CI smoke's schema check)."""
    assert isinstance(obj, dict), "metrics snapshot must be a JSON object"
    assert obj.get("format") == "gopher-metrics-v1", \
        f"bad format tag {obj.get('format')!r}"
    for sect in ("counters", "gauges", "histograms"):
        assert sect in obj and isinstance(obj[sect], dict), \
            f"missing section {sect!r}"
    for k, v in obj["counters"].items():
        assert isinstance(v, (int, float)), f"counter {k}: non-numeric"
        assert v >= 0, f"counter {k}: negative ({v})"
    for k, v in obj["gauges"].items():
        assert isinstance(v, (int, float)), f"gauge {k}: non-numeric"
    for k, h in obj["histograms"].items():
        for f in ("count", "sum", "mean", "p50", "p95", "p99"):
            assert f in h and isinstance(h[f], (int, float)), \
                f"histogram {k}: missing/bad {f!r}"
        assert h["count"] >= 0
        assert h["p50"] <= h["p95"] <= h["p99"], \
            f"histogram {k}: percentiles not monotone"
