"""Counter / gauge / observation registry of the telemetry plane.

Three primitive kinds, all host Python scalars (no device traffic, no
tensor read, no RNG draw — the zero-semantic-footprint contract):

* **counter** — monotone accumulator (``population.escalations``).
* **gauge**   — last-written value plus its running max
  (``async.heap_depth``, ``population.nbytes``, ``launches.<kernel>``).
* **observation** — streaming summary of a value series
  (count/sum/min/max plus a bounded reservoir of the most recent values):
  ``train.pad_waste``, ``train.bucket_occupancy``, ``async.upload_age``.

The registry is owned by the tracer singleton; every mutating helper on
the tracer returns at once while tracing is disabled, so the metrics
layer costs nothing by default.
"""
from __future__ import annotations

from typing import Dict, List

_RESERVOIR = 4096  # most-recent values kept per observation series


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value", "max")

    def __init__(self) -> None:
        self.value = 0.0
        self.max = float("-inf")

    def set(self, v: float) -> None:
        self.value = v
        if v > self.max:
            self.max = v


class Observation:
    __slots__ = ("count", "total", "min", "max", "recent")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.recent: List[float] = []

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.recent) >= _RESERVOIR:
            del self.recent[: _RESERVOIR // 2]
        self.recent.append(v)


class MetricRegistry:
    """Name -> metric maps with get-or-create access and one snapshot."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.observations: Dict[str, Observation] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def observation(self, name: str) -> Observation:
        o = self.observations.get(name)
        if o is None:
            o = self.observations[name] = Observation()
        return o

    def snapshot(self) -> Dict:
        """JSON-ready view of every metric (for the JSONL sink)."""
        out: Dict = {"counters": {}, "gauges": {}, "observations": {}}
        for k, c in sorted(self.counters.items()):
            out["counters"][k] = c.value
        for k, g in sorted(self.gauges.items()):
            out["gauges"][k] = {"value": g.value, "max": g.max}
        for k, o in sorted(self.observations.items()):
            mean = o.total / o.count if o.count else 0.0
            out["observations"][k] = {"count": o.count, "sum": o.total,
                                      "min": o.min if o.count else 0.0,
                                      "max": o.max if o.count else 0.0,
                                      "mean": mean}
        return out

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.observations.clear()
