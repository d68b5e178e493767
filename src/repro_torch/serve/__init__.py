"""Serving subsystem of the port: the single-host COBS query server and
its network front door.

Shape-bucketed micro-batching (``batcher``), kernel planning
(``planner``), LRU caches (``cache``), latency and occupancy metrics
(``metrics``) and the ``QueryServer`` front end (``server``), with request
tracing, the metrics registry and kernel profiling from
``repro_torch.obs``; the active ``ServingLoop`` (``loop``), the TCP wire
protocol's ``NetServer`` and ``NetClient`` (``net``, byte-compatible with
the JAX package's) and the offline ``BulkLane`` (``bulk``). The JAX
package's multi-host frontend, shard workers and RPC plane are not ported
yet (ROADMAP A15).
"""
from ..obs import (EventLog, KernelProfiler, MetricsRegistry, Span, Trace,
                   Tracer, render_prometheus)
from .batcher import MicroBatch, MicroBatcher, fit_bucket_edges
from .bulk import BulkJob, BulkLane, BulkStatus
from .cache import LRUCache, result_key, term_key
from .loop import LoopClosed, ServingLoop
from .metrics import MetricsSnapshot, ServingMetrics
from .net import NetClient, NetResult, NetServer
from .planner import QueryPlan, QueryPlanner
from .request import QueryRequest, QueryResponse, Status
from .server import QueryServer, ServerConfig

__all__ = [
    "MicroBatch", "MicroBatcher", "fit_bucket_edges",
    "BulkJob", "BulkLane", "BulkStatus",
    "LRUCache", "result_key", "term_key",
    "MetricsSnapshot", "ServingMetrics", "QueryPlan", "QueryPlanner",
    "QueryRequest", "QueryResponse", "Status", "QueryServer", "ServerConfig",
    "LoopClosed", "ServingLoop", "NetClient", "NetResult", "NetServer",
    "EventLog", "KernelProfiler", "MetricsRegistry", "Span", "Trace",
    "Tracer", "render_prometheus",
]
