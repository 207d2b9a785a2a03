"""repro_torch.obs — zero-dependency tracing + metrics for the whole stack.

The paper's evaluation method is measurement: per-network, per-optimization
breakdowns of where the cycles go.  Our stack grew eight PRs of machinery
whose telemetry was ad-hoc — hand-rolled ``time.perf_counter()`` stopwatches
in five modules and counters scattered over ``RunReport.metrics``, the block
pool, the scheduler and the kernel registry.  This package is the single
observability layer they all publish into:

* :class:`~repro_torch.obs.trace.Tracer` — nested spans with attributes in a
  bounded ring buffer; thread-safe; a **no-op when disabled** (one boolean
  check on the hot path).  Context-manager (``with tracer.span(...)``),
  explicit (``sp = tracer.span(...); sp.end()``) and decorator
  (``@tracer.trace()``) APIs.  Exports Chrome trace-event JSON (loads in
  Perfetto / ``chrome://tracing``) and a JSONL event log.
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — typed counters, gauges and
  histograms under stable dotted names (``serving.prefix.hits``,
  ``pool.blocks.live``, ``kernels.dispatch.rejections``, …).  The serving
  engine's ``RunReport.metrics`` is a snapshot of a per-run registry;
  ``benchmarks/run.py`` derives ``BENCH_serving.json`` from the same
  snapshot.

Module-level defaults: :data:`TRACER` (compile-side spans — pass runs,
flow stages, DSE candidate validation, autotune microbenchmarks — all time
through it whether or not recording is on) and :data:`METRICS`
(process-level counters such as kernel dispatch rejections).

Everything here is stdlib-only: no jax, no numpy — the tracer must be
importable from the innermost compile loop without adding a dependency
edge, and the exactness gates stay (engine outputs are byte-identical with
tracing on or off).
"""
from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               METRICS)
from repro_torch.obs.trace import Span, Tracer, TRACER

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "METRICS",
    "MetricsRegistry",
    "Span",
    "TRACER",
    "Tracer",
]
