"""Serving subsystem of the port: the COBS query server, its network front
door and the multi-host sharded data plane.

Shape-bucketed micro-batching (``batcher``), kernel planning
(``planner``), LRU caches (``cache``), latency and occupancy metrics
(``metrics``) and the ``QueryServer`` front end (``server``), with request
tracing, the metrics registry and kernel profiling from
``repro_torch.obs``; the active ``ServingLoop`` (``loop``), the TCP wire
protocol's ``NetServer`` and ``NetClient`` (``net``, byte-compatible with
the JAX package's) and the offline ``BulkLane`` (``bulk``); per-host
``ShardWorker``s over placement-assigned v2 manifest shards (``worker``),
the scatter/gather ``Frontend`` with hedged dispatch and replica failover
(``frontend``), and the RPC shard data plane (``rpc``: ``WorkerServer``,
``WorkerChannel``, ``WorkerPool``, ``RpcFrontend``), whose wire frames
are the JAX package's, so fleets may mix the two. LM inference steps
(``step``) serve the model substrate: prefill, decode and the greedy
generation loop.
"""
from ..obs import (EventLog, KernelProfiler, MetricsRegistry, Span, Trace,
                   Tracer, render_prometheus)
from .batcher import MicroBatch, MicroBatcher, fit_bucket_edges
from .bulk import BulkJob, BulkLane, BulkStatus
from .cache import LRUCache, result_key, term_key
from .frontend import Frontend, FrontendConfig
from .loop import LoopClosed, ServingLoop
from .metrics import MetricsSnapshot, ServingMetrics
from .net import NetClient, NetResult, NetServer
from .planner import QueryPlan, QueryPlanner
from .request import QueryRequest, QueryResponse, Status
from .rpc import (ChannelDown, RpcError, RpcFrontend, WorkerChannel,
                  WorkerPool, WorkerServer)
from .server import QueryServer, ServerConfig
from .step import make_prefill_step, make_decode_step, greedy_generate
from .worker import DispatchCancelled, ShardWorker

__all__ = [
    "MicroBatch", "MicroBatcher", "fit_bucket_edges",
    "BulkJob", "BulkLane", "BulkStatus",
    "LRUCache", "result_key", "term_key",
    "MetricsSnapshot", "ServingMetrics", "QueryPlan", "QueryPlanner",
    "QueryRequest", "QueryResponse", "Status", "QueryServer", "ServerConfig",
    "Frontend", "FrontendConfig", "ShardWorker", "DispatchCancelled",
    "LoopClosed", "ServingLoop", "NetClient", "NetResult", "NetServer",
    "ChannelDown", "RpcError", "RpcFrontend", "WorkerChannel",
    "WorkerPool", "WorkerServer",
    "EventLog", "KernelProfiler", "MetricsRegistry", "Span", "Trace",
    "Tracer", "render_prometheus",
    "make_prefill_step", "make_decode_step", "greedy_generate",
]
