"""Observability for the serving stack: tracing, metrics, profiling. Host-only
copies of ``repro.obs`` (numpy, threading and json; no torch).

Three cooperating pieces, each usable alone:

* ``registry`` — a general counter / gauge / histogram registry with
  per-metric locks and labeled families. ``repro_torch.serve.metrics`` is a
  facade over one of these; ``repro_torch.obs.export`` renders it in the
  Prometheus text exposition format.
* ``trace`` — request tracing: a ``Trace`` is minted per admitted
  query, ``Span``s are appended by every serving layer it crosses
  (queue wait, flush, plan, tile fetch, kernel, hedged shard dispatch,
  gather, delivery), and the finished trace lands in a ring buffer —
  plus the slow-query JSONL log when it blows a latency budget.
* ``profile`` — ``KernelProfiler`` wraps the score-kernel dispatch,
  recording per-(method, bucket, word_block) wall time and bytes-moved
  estimates, and optionally feeds the measurements back into the
  autotuner's cost cache as live "observed" entries.
"""
from .events import EventLog
from .profile import KernelProfiler
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Span, Trace, Tracer
from .export import render_prometheus

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Trace", "Tracer",
    "EventLog", "KernelProfiler", "render_prometheus",
]
