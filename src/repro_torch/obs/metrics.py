"""Plain-dict metrics: counters, gauges, windowed histograms.

The aggregation companion to :mod:`repro_torch.obs.trace`: where the tracer
records *what happened when*, the registry keeps *how much and how
fast* — monotonically increasing counters, last-value gauges, and
histograms that answer p50/p95/p99 both cumulatively and per control
window (the serving-SLO shape: "p99 step latency in the last window").

Everything is plain Python data — :meth:`MetricsRegistry.snapshot`
returns nested dicts ready for JSON — and the registry is dependency-
free so any layer can hold one. Thread safety: a single lock around
mutations; metrics are recorded per control window / engine step, not
per frame, so contention is irrelevant (the per-frame hot path belongs
to the tracer's lock-free rings).
"""
from __future__ import annotations

import math
import threading


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list (q in [0, 1])."""
    if not sorted_vals:
        return float("nan")
    idx = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return sorted_vals[idx]


class _Histogram:
    """Windowed + cumulative value distribution.

    The *window* holds every observation since the last
    ``window_summary(reset=True)`` (windows are control-window sized, so
    unbounded-within-window is fine). The *cumulative* reservoir is
    bounded: when full it is thinned by keeping every other sample and
    doubling the accept stride — deterministic, keeps a uniform-ish
    spread over the whole history without randomness."""

    __slots__ = ("window", "samples", "max_samples", "_stride", "_skip",
                 "count", "total", "min", "max")

    def __init__(self, max_samples: int = 8192):
        self.window: list[float] = []
        self.samples: list[float] = []
        self.max_samples = max_samples
        self._stride = 1
        self._skip = 0
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        self.window.append(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self._skip += 1
        if self._skip >= self._stride:
            self._skip = 0
            self.samples.append(value)
            if len(self.samples) >= self.max_samples:
                self.samples = self.samples[::2]
                self._stride *= 2

    @staticmethod
    def _summarize(values: list[float], count: int, total: float,
                   vmin: float, vmax: float) -> dict:
        s = sorted(values)
        return {
            "count": count,
            "mean": total / count if count else float("nan"),
            "min": vmin if count else float("nan"),
            "max": vmax if count else float("nan"),
            "p50": _percentile(s, 0.50),
            "p95": _percentile(s, 0.95),
            "p99": _percentile(s, 0.99),
        }

    def summary(self) -> dict:
        return self._summarize(self.samples, self.count, self.total,
                               self.min, self.max)

    def window_summary(self, reset: bool) -> dict:
        vals = self.window
        out = self._summarize(
            vals, len(vals), sum(vals),
            min(vals) if vals else float("inf"),
            max(vals) if vals else float("-inf"))
        if reset:
            self.window = []
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}

    # ----------------------------------------------------------- recording
    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = _Histogram()
            hist.observe(value)

    # ------------------------------------------------------------- queries
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> float | None:
        return self._gauges.get(name)

    def window_summary(self, reset: bool = True) -> dict:
        """Per-histogram stats over the current window (observations
        since the previous ``window_summary(reset=True)``) — the
        WindowRecord-style per-window p50/p95/p99 roll-up."""
        with self._lock:
            return {name: h.window_summary(reset)
                    for name, h in self._hists.items()}

    def snapshot(self) -> dict:
        """The whole registry as plain nested dicts (JSON-ready):
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        with cumulative histogram stats."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {name: h.summary()
                               for name, h in self._hists.items()},
            }
