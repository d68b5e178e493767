"""Serving subsystem of the port: the single-host COBS query server.

Shape-bucketed micro-batching (``batcher``), kernel planning
(``planner``), LRU caches (``cache``), latency and occupancy metrics
(``metrics``) and the ``QueryServer`` front end (``server``), with request
tracing, the metrics registry and kernel profiling from
``repro_torch.obs``. The JAX package's multi-host frontend, RPC plane,
serving loop, network server and bulk lane are not ported yet (ROADMAP
A14, A15).
"""
from ..obs import (EventLog, KernelProfiler, MetricsRegistry, Span, Trace,
                   Tracer, render_prometheus)
from .batcher import MicroBatch, MicroBatcher, fit_bucket_edges
from .cache import LRUCache, result_key, term_key
from .metrics import MetricsSnapshot, ServingMetrics
from .planner import QueryPlan, QueryPlanner
from .request import QueryRequest, QueryResponse, Status
from .server import QueryServer, ServerConfig

__all__ = [
    "MicroBatch", "MicroBatcher", "fit_bucket_edges",
    "LRUCache", "result_key", "term_key",
    "MetricsSnapshot", "ServingMetrics", "QueryPlan", "QueryPlanner",
    "QueryRequest", "QueryResponse", "Status", "QueryServer", "ServerConfig",
    "EventLog", "KernelProfiler", "MetricsRegistry", "Span", "Trace",
    "Tracer", "render_prometheus",
]
