"""Typed metrics registry: counters, gauges, histograms under dotted names.

One :class:`MetricsRegistry` holds every instrument published during a unit
of work (the serving engine builds a fresh one per ``run()``; a module-level
:data:`METRICS` collects process-lifetime counters such as kernel dispatch
rejections).  Instruments are created on first use and addressed by stable
dotted names — the metric-name table in the README is the schema::

    reg = MetricsRegistry()
    reg.counter("serving.prefix.hits").inc()
    reg.gauge("pool.blocks.live").set(12)
    reg.histogram("serving.latency_s").observe(0.03)
    snap = reg.snapshot()      # flat {dotted-name: value} dict

``snapshot()`` flattens everything into plain scalars: a counter
contributes its count, a gauge its last value plus ``<name>.peak``, a
histogram ``<name>.count`` / ``.mean`` / ``.max`` / ``.p50`` / ``.p95``.
The percentile is the same nearest-rank formula the serving report always
used, so a report assembled from the snapshot is bit-identical to the old
hand-assembled dict.

Thread-safety: instrument creation is lock-protected; the individual
updates are plain attribute writes (the GIL makes ``+=`` on the serving
host loop safe, and the engine is single-threaded by construction).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonic count.  ``inc`` / ``add`` only go up."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        self.value += n

    add = inc

    def __repr__(self) -> str:
        return f"<Counter {self.name}={self.value}>"


class Gauge:
    """Last-write-wins value; the peak since creation rides along (the
    serving report's ``peak_used_blocks`` / ``peak_live_tokens``)."""

    __slots__ = ("name", "value", "peak")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0
        self.peak: Number = 0

    def set(self, v: Number) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v

    def __repr__(self) -> str:
        return f"<Gauge {self.name}={self.value} peak={self.peak}>"


class Histogram:
    """Value distribution with nearest-rank percentiles.

    Keeps raw observations up to ``max_samples`` (serving runs observe one
    latency per request — small); beyond that, new observations still feed
    count/sum/max but the percentile reservoir stops growing."""

    __slots__ = ("name", "samples", "count", "total", "max_value",
                 "max_samples")

    def __init__(self, name: str, max_samples: int = 65536) -> None:
        self.name = name
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max_value = 0.0
        self.max_samples = max_samples

    def observe(self, v: Number) -> None:
        f = float(v)
        self.count += 1
        self.total += f
        if f > self.max_value:
            self.max_value = f
        if len(self.samples) < self.max_samples:
            self.samples.append(f)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (``p`` in [0, 1]); 0.0 when empty —
        exactly the serving report's historical formula."""
        xs = sorted(self.samples)
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(math.ceil(p * len(xs))) - 1)]

    def __repr__(self) -> str:
        return f"<Histogram {self.name} n={self.count} mean={self.mean:.4g}>"


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Dotted-name → typed instrument, created on first use.

    Re-requesting a name returns the existing instrument; requesting it as
    a different type raises (the name *is* the schema)."""

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: type) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = kind(name)
                    self._instruments[name] = inst
        if not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"requested as {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        inst = self._get(name, Counter)
        assert isinstance(inst, Counter)
        return inst

    def gauge(self, name: str) -> Gauge:
        inst = self._get(name, Gauge)
        assert isinstance(inst, Gauge)
        return inst

    def histogram(self, name: str) -> Histogram:
        inst = self._get(name, Histogram)
        assert isinstance(inst, Histogram)
        return inst

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{dotted-name: scalar}`` view of every instrument (see the
        module docstring for the per-type flattening)."""
        out: Dict[str, Any] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                out[name] = inst.value
            elif isinstance(inst, Gauge):
                out[name] = inst.value
                out[name + ".peak"] = inst.peak
            else:
                out[name + ".count"] = inst.count
                out[name + ".mean"] = inst.mean
                out[name + ".max"] = inst.max_value
                out[name + ".p50"] = inst.percentile(0.50)
                out[name + ".p95"] = inst.percentile(0.95)
        return out


#: Process-level registry: long-lived publishers (the kernel registry's
#: dispatch-rejection counter) land here; per-run registries are built by
#: their owners (``Engine.run``).
METRICS = MetricsRegistry()
