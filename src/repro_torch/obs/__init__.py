"""Observability for the serving stack: tracing, metrics, profiling. Host-side
copies of ``repro.obs`` (numpy, threading and json), plus the profiler
ranges of ``trace.span``, which need ``torch.autograd.profiler``.

Three cooperating pieces, each usable alone:

* ``registry`` — a general counter / gauge / histogram registry with
  per-metric locks and labeled families. ``repro_torch.serve.metrics`` is a
  facade over one of these; ``repro_torch.obs.export`` renders it in the
  Prometheus text exposition format.
* ``trace`` — request tracing: a ``Trace`` is minted per admitted
  query, ``Span``s are appended by every serving layer it crosses
  (``queue_wait``, tagged with the batch's flush reason; ``plan``,
  ``dedup_plan``, ``kernel_score``, ``prune``, ``tile_fetch``,
  ``select`` and ``deliver`` on the scored path; ``fast_path``,
  ``cache_lookup``, ``point_query`` and ``reject`` on the answered-at-
  submit paths; the frontend's ``scatter``, ``shard_dispatch`` and
  ``gather``; the bulk lane's ``bulk_shard``), and the finished trace
  lands in a ring buffer — plus the slow-query JSONL log when it blows a
  latency budget. ``span`` times a stage into those marks and, while a
  torch profiler runs, into a ``repro.<stage>`` profiler range as well;
  ``watch_gc`` adds ``repro.gc`` ranges around garbage collections.
* ``profile`` — ``KernelProfiler`` wraps the score-kernel dispatch,
  recording per-(method, bucket, word_block) host time (from the terms'
  upload through the scores' copy to the host) and bytes-moved
  estimates, and optionally feeds the measurements back into the
  autotuner's cost cache as live "observed" entries.
"""
from .events import EventLog
from .profile import KernelProfiler
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Span, Trace, Tracer, span
from .export import render_prometheus

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Trace", "Tracer", "span",
    "EventLog", "KernelProfiler", "render_prometheus",
]
