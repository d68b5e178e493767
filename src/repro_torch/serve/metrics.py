"""Serving metrics: latency percentiles, batch occupancy, cache hit rate.

A host-only copy of ``repro.serve.metrics``: a facade over a
``repro_torch.obs.registry.MetricsRegistry``. Every counter, gauge and
sliding-window histogram below is a named, labeled registry metric
(rendered by the Prometheus exporter), and the attribute surface
(``metrics.served``, ``metrics.percentile_ms(99)``,
``metrics.worker_recent_s``...) is kept as properties. Registry
histograms own a per-metric lock and copy under it, so ``percentile_ms``
/ ``snapshot`` are safe from any thread.

Latencies are recorded per REQUEST (queue wait + service), batch stats
per micro-batch, so occupancy weighs each flush equally while the
percentiles weigh each query. The multi-host frontend additionally
records per-worker dispatch latencies, hedge fires/wins and failovers;
the tile counters carry prefetch accounting plus per-shard
fault/eviction labels so a trace span can name WHICH shard faulted.
"""
from __future__ import annotations

import dataclasses
from collections import Counter as _Counter

import numpy as np

from ..obs.registry import MetricsRegistry


@dataclasses.dataclass
class MetricsSnapshot:
    served: int
    rejected: int
    dropped: int
    cache_hits: int
    batches: int
    p50_ms: float
    p99_ms: float
    mean_occupancy: float
    cache_hit_rate: float
    methods: dict[str, int]
    # out-of-core arena paging (0 / empty for dense single-shard indexes)
    page_faults: int = 0
    tile_hits: int = 0
    resident_tiles: int = 0
    tile_hit_rate: float = 0.0
    # double-buffered prefetch (0 when paging is demand-only)
    prefetched_tiles: int = 0
    prefetch_hits: int = 0
    prefetch_hit_rate: float = 0.0
    # serving-loop / network front-end gauges
    queue_depth: int = 0          # batcher backlog at the last sample
    max_queue_depth: int = 0      # backlog high-water mark
    connections: int = 0          # open client sessions
    total_connections: int = 0    # sessions ever accepted
    coalesce_rate: float = 0.0    # batched requests per kernel dispatch
    # multi-host dispatch (0 / empty for the single-host QueryServer)
    failed: int = 0          # requests unservable (shard lost all replicas)
    dispatches: int = 0
    hedges_fired: int = 0
    hedges_won: int = 0
    hedge_fire_rate: float = 0.0
    failovers: int = 0
    # real-RPC hedging (0 for in-process dispatch): duplicate requests
    # whose loser was cancelled, and dispatches that skipped a replica
    # already known dead (NOT failovers — no attempt was made)
    hedges_cancelled: int = 0
    skipped_dead: int = 0
    # replies undeliverable at session close/kick — counted, never silent
    dropped_replies: int = 0
    # networked data plane (0 when dispatch is in-process)
    channels_up: int = 0          # worker channels currently connected
    channel_reconnects: int = 0   # successful redials across the pool
    rpcs_sent: int = 0            # SHARD_QUERY frames sent
    rpcs_failed: int = 0          # dispatches failed by channel death
    worker_p99_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    # per-shard tile-cache activity (empty when paging is off)
    shard_faults: dict[str, int] = dataclasses.field(default_factory=dict)
    shard_evictions: dict[str, int] = dataclasses.field(
        default_factory=dict)
    # tracing (0 when the tracer is off / absent)
    traces_finished: int = 0
    slow_queries: int = 0
    # compressed-arena serving (0 when no dict-coded shard was staged)
    arena_raw_bytes: int = 0      # bytes staged to device in raw form
    arena_comp_bytes: int = 0     # bytes staged in compressed (dict) form
    decodes: int = 0              # host-side shard decodes observed
    # pruned (branch-and-bound) scoring (0 when never dispatched)
    pruned_blocks: int = 0        # (query, block) cells killed by the bound
    prune_rate: float = 0.0       # killed / considered
    tiles_skipped: int = 0        # shard-tile visits never issued
    pruned_bytes_saved: int = 0   # arena bytes NOT read thanks to pruning
    # offline bulk lane (0 when no bulk job ever ran)
    bulk_jobs: int = 0            # jobs finished (any terminal status)
    bulk_queries: int = 0         # queries scored through the bulk lane
    bulk_shards_swept: int = 0    # shard sweeps completed
    bulk_yields: int = 0          # sweep suspensions to interactive work
    bulk_staged_bytes: int = 0    # arena bytes staged by bulk sweeps

    def report(self) -> str:
        meth = " ".join(f"{m}={n}" for m, n in sorted(self.methods.items()))
        s = (f"served={self.served} rejected={self.rejected} "
             f"dropped={self.dropped} batches={self.batches} "
             f"p50={self.p50_ms:.2f}ms p99={self.p99_ms:.2f}ms "
             f"occupancy={self.mean_occupancy:.2f} "
             f"cache_hit_rate={self.cache_hit_rate:.2f} "
             f"tiles[resident={self.resident_tiles} "
             f"faults={self.page_faults} "
             f"hit_rate={self.tile_hit_rate:.2f} "
             f"prefetch_hit_rate={self.prefetch_hit_rate:.2f}] "
             f"dispatch[{meth}]")
        if self.total_connections or self.max_queue_depth:
            s += (f" net[conns={self.connections}/"
                  f"{self.total_connections} "
                  f"queue_depth={self.queue_depth} "
                  f"max_depth={self.max_queue_depth} "
                  f"coalesce={self.coalesce_rate:.2f}]")
        if self.dispatches:
            workers = " ".join(f"{w}={p:.2f}ms"
                               for w, p in sorted(self.worker_p99_ms.items()))
            s += (f" shard_rpcs[n={self.dispatches} "
                  f"hedge_rate={self.hedge_fire_rate:.3f} "
                  f"hedges_won={self.hedges_won} "
                  f"hedges_cancelled={self.hedges_cancelled} "
                  f"failovers={self.failovers} "
                  f"skipped_dead={self.skipped_dead} "
                  f"failed={self.failed}] "
                  f"workers_p99[{workers}]")
        if self.rpcs_sent or self.channel_reconnects:
            s += (f" rpc[sent={self.rpcs_sent} "
                  f"failed={self.rpcs_failed} "
                  f"channels_up={self.channels_up} "
                  f"reconnects={self.channel_reconnects}]")
        if self.dropped_replies:
            s += f" dropped_replies={self.dropped_replies}"
        if self.traces_finished:
            s += (f" traces[done={self.traces_finished} "
                  f"slow={self.slow_queries}]")
        if self.arena_comp_bytes:
            s += (f" arena[raw={self.arena_raw_bytes}B "
                  f"comp={self.arena_comp_bytes}B "
                  f"decodes={self.decodes}]")
        if self.pruned_blocks or self.tiles_skipped:
            s += (f" prune[blocks={self.pruned_blocks} "
                  f"rate={self.prune_rate:.2f} "
                  f"tiles_skipped={self.tiles_skipped} "
                  f"bytes_saved={self.pruned_bytes_saved}B]")
        if self.bulk_jobs or self.bulk_queries:
            s += (f" bulk[jobs={self.bulk_jobs} "
                  f"queries={self.bulk_queries} "
                  f"shards={self.bulk_shards_swept} "
                  f"yields={self.bulk_yields} "
                  f"staged={self.bulk_staged_bytes}B]")
        return s


class ServingMetrics:
    """``window`` bounds the per-request/per-batch sample history (sliding
    window for the percentiles); the integer counters stay exact totals
    for the server's whole lifetime. All recorders and readers are
    thread-safe (each underlying registry metric owns its lock)."""

    def __init__(self, window: int = 65536,
                 registry: MetricsRegistry | None = None):
        self._window = window
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        r = self.registry
        h = lambda name, help: r.histogram(name, help, window=window)
        self._requests = r.counter(
            "serve_requests_total", "request outcomes",
            labels=("status",))
        self._served = self._requests.labels("ok")
        self._rejected = self._requests.labels("rejected")
        self._dropped = self._requests.labels("dropped")
        self._failed = self._requests.labels("failed")
        self._cache_hits = r.counter("serve_cache_hits_total",
                                     "result-cache hits")
        self._latency = h("serve_latency_seconds",
                          "end-to-end request latency (wait + service)")
        self._wait = h("serve_wait_seconds", "batcher queue wait")
        self._service = h("serve_service_seconds", "scoring service time")
        self._occupancy = h("serve_batch_occupancy",
                            "micro-batch fill fraction at flush")
        self._batch_size = h("serve_batch_size",
                             "requests per scored micro-batch")
        self._batches = r.counter("serve_batches_total",
                                  "micro-batches scored")
        self._batched = r.counter(
            "serve_batched_requests_total",
            "requests served through a micro-batch")
        self._methods = r.counter(
            "serve_dispatch_requests_total",
            "requests per scoring method", labels=("method",))
        self._queue_depth = r.gauge("serve_queue_depth",
                                    "batcher backlog")
        self._connections = r.gauge("serve_connections",
                                    "open client sessions")
        self._conn_total = r.counter("serve_connections_total",
                                     "client sessions ever accepted")
        self._tiles = r.counter(
            "serve_tile_events_total", "device tile-cache activity",
            labels=("event",))
        self._tile_hits = self._tiles.labels("hit")
        self._tile_faults = self._tiles.labels("fault")
        self._tile_prefetched = self._tiles.labels("prefetch")
        self._tile_prefetch_hits = self._tiles.labels("prefetch_hit")
        self._resident = r.gauge("serve_resident_tiles",
                                 "device tiles resident after last pass")
        self._shard_tiles = r.counter(
            "serve_shard_tile_events_total",
            "per-shard tile-cache faults/evictions/hits",
            labels=("shard", "event"))
        self._dispatches = r.counter("serve_shard_dispatches_total",
                                     "shard RPCs issued")
        self._hedges_fired = r.counter("serve_hedges_fired_total",
                                       "backup shard RPCs issued")
        self._hedges_won = r.counter(
            "serve_hedges_won_total", "backups that beat the primary")
        self._failovers = r.counter(
            "serve_failovers_total",
            "dispatches served by a non-primary replica")
        self._hedges_cancelled = r.counter(
            "serve_hedges_cancelled_total",
            "duplicate shard RPCs cancelled after losing the race")
        self._skipped_dead = r.counter(
            "serve_skipped_dead_total",
            "replicas skipped up front because already known dead")
        self._dropped_replies = r.counter(
            "serve_dropped_replies_total",
            "replies undeliverable at session close or kick")
        # networked data plane: per-node channel state + RPC outcomes
        # (the multi-host RPC plane feeds these; all zero in-process)
        self._channel_up = r.gauge(
            "serve_channel_up", "worker channel connected (1) or down (0)",
            labels=("node",))
        self._channel_reconnects = r.counter(
            "serve_channel_reconnects_total",
            "successful worker-channel redials", labels=("node",))
        self._rpcs = r.counter(
            "serve_rpc_total", "worker RPCs by node and outcome",
            labels=("node", "outcome"))
        self._worker_lat = r.histogram(
            "serve_worker_latency_seconds",
            "per-worker shard dispatch latency", labels=("worker",),
            window=window, recent=128)
        # compressed-arena serving: bytes staged host->device per form
        # ("raw" = expanded tiles, "comp" = dict+refs pairs) and the
        # host-side shard decode times (MappedArena.decode_observer)
        self._arena_bytes = r.counter(
            "serve_arena_bytes_total",
            "arena bytes staged to device, by tile form",
            labels=("form",))
        self._arena_raw = self._arena_bytes.labels("raw")
        self._arena_comp = self._arena_bytes.labels("comp")
        self._decode = h("serve_decode_seconds",
                         "host-side compressed shard decode time")
        self._decodes = r.counter("serve_decodes_total",
                                  "host-side compressed shard decodes")
        # pruned (branch-and-bound) scoring: block kills, skipped tile
        # visits, and the arena bytes those skips never read — the
        # threshold's leverage, visible in STATS and Prometheus
        self._prune_blocks = r.counter(
            "serve_pruned_blocks_total", "pruned-scoring block outcomes",
            labels=("outcome",))
        self._pruned_blocks = self._prune_blocks.labels("pruned")
        self._prune_considered = self._prune_blocks.labels("considered")
        self._tiles_skipped = r.counter(
            "serve_pruned_tiles_skipped_total",
            "shard-tile visits skipped entirely by pruning")
        self._prune_bytes_saved = r.counter(
            "serve_pruned_bytes_saved_total",
            "arena bytes not read thanks to pruning")
        # offline bulk lane: shard-major sweeps that run when no
        # interactive batch is due — per-job outcomes, shard/query
        # throughput, preemption yields, and the staged-bytes headline
        self._bulk_jobs = r.counter(
            "serve_bulk_jobs_total", "bulk jobs by terminal status",
            labels=("status",))
        self._bulk_queries = r.counter(
            "serve_bulk_queries_total",
            "queries scored through the bulk lane")
        self._bulk_shards = r.counter(
            "serve_bulk_shards_total", "bulk shard sweeps completed")
        self._bulk_yields = r.counter(
            "serve_bulk_yields_total",
            "bulk sweep suspensions yielding to interactive work")
        self._bulk_staged = r.counter(
            "serve_bulk_staged_bytes_total",
            "arena bytes staged to device by bulk sweeps")
        self._bulk_shard_s = h("serve_bulk_shard_seconds",
                               "wall time per bulk shard sweep")
        # Optional back-reference set by the owning backend so snapshots
        # carry trace counts (finished / slow) without a separate poll.
        self.tracer = None

    # -- recording ---------------------------------------------------------
    def record_request(self, *, wait_s: float, service_s: float,
                       cached: bool = False) -> None:
        self._served.inc()
        self._wait.observe(wait_s)
        self._service.observe(service_s)
        self._latency.observe(wait_s + service_s)
        if cached:
            self._cache_hits.inc()

    def record_batch(self, size: int, occupancy: float, method: str) -> None:
        self._batch_size.observe(size)
        self._occupancy.observe(occupancy)
        self._methods.labels(method).inc(size)
        self._batches.inc()
        self._batched.inc(size)

    def set_queue_depth(self, depth: int) -> None:
        """Gauge: batcher backlog (sampled by the serving loop)."""
        self._queue_depth.set(depth)

    def record_connection(self, delta: int) -> None:
        """Gauge: a client session opened (+1) or closed (-1). Called
        from per-connection threads; the gauge locks internally."""
        self._connections.inc(delta)
        if delta > 0:
            self._conn_total.inc(delta)

    def record_rejected(self) -> None:
        self._rejected.inc()

    def record_dropped(self) -> None:
        self._dropped.inc()

    def record_failed(self) -> None:
        """A request that could not be served: some shard it needs has no
        live replica left."""
        self._failed.inc()

    def record_tiles(self, *, hits: int, faults: int, resident: int,
                     prefetched: int = 0, prefetch_hits: int = 0) -> None:
        """Device-tile cache activity for one scoring pass: cache hits,
        page faults (host->device shard stages, prefetches included), the
        resident-tile gauge after the pass, and the prefetch counters."""
        if hits:
            self._tile_hits.inc(hits)
        if faults:
            self._tile_faults.inc(faults)
        self._resident.set(resident)
        if prefetched:
            self._tile_prefetched.inc(prefetched)
        if prefetch_hits:
            self._tile_prefetch_hits.inc(prefetch_hits)

    def record_shard_tile(self, shard, event: str, n: int = 1) -> None:
        """Per-shard tile-cache event ("hit" / "fault" / "eviction"):
        the DeviceTileCache observer feeds this so traces and the
        exporter can name WHICH shard faulted."""
        self._shard_tiles.labels(shard, event).inc(n)

    def record_arena_bytes(self, *, raw: int = 0, comp: int = 0) -> None:
        """Bytes newly staged to device during one scoring pass, split by
        tile form (deltas of the tile cache's staged-byte counters)."""
        if raw:
            self._arena_raw.inc(raw)
        if comp:
            self._arena_comp.inc(comp)

    def record_lock_wait(self, seconds: float) -> None:
        """One acquisition of a ``ServingLoop``'s lock that found it held
        (``serve_loop_lock_wait_seconds``). Registered at the first wait,
        so a registry without contention renders as JAX's does."""
        self.registry.histogram(
            "serve_loop_lock_wait_seconds",
            "time a serving-loop thread waited for the loop's lock",
            window=self._window).observe(seconds)

    def record_select(self, where: str, n: int = 1) -> None:
        """``n`` requests whose hits the device selected (``where`` =
        "card", ``serve_select_card_total``) or the host did
        (``serve_select_host_total``, ``where`` its reason: "top_k",
        "overflow", "pruned" or "point"). Registered at the
        first selection, so a registry that never selects renders as
        JAX's does."""
        if where == "card":
            self.registry.counter(
                "serve_select_card_total",
                "requests whose hits the device selected").inc(n)
        else:
            self.registry.counter(
                "serve_select_host_total",
                "requests selected on the host, by reason",
                labels=("reason",)).labels(where).inc(n)

    def record_dedup_plan(self, built: bool) -> None:
        """One gated batch's dedup plan: ``built`` (its count cleared the
        gate, so it plans its rows for the dedup pair) or ``skipped``
        (its count kept it below the gate without a plan),
        ``serve_dedup_plan_total{outcome}``. Registered at the first
        gated batch, so a registry that never gates renders as JAX's
        does."""
        self.registry.counter(
            "serve_dedup_plan_total",
            "gated batches whose dedup plan was built or skipped",
            labels=("outcome",)).labels(
                "built" if built else "skipped").inc()

    def record_tile_route(self, stats) -> None:
        """One paged batch's row-gather route (a ``core.query.GatherStats``):
        its shard visits by route (``serve_shard_visits_total{route=
        resident,gathered,staged}``), the resident ones scored in the
        batch's grouped launch (``serve_grouped_shards_total``; over the
        resident visits, the grouped launch's engagement), the stored rows
        it read on the host and their bytes
        (``serve_tile_rows_gathered_total``,
        ``serve_tile_gathered_bytes_total``) and the host time of the
        reads (``serve_tile_gather_seconds``, one observation a batch; its
        sum is the summed time). Registered at the first paged batch, so
        a registry that never pages renders as JAX's does."""
        r = self.registry
        visits = r.counter("serve_shard_visits_total",
                           "shard visits of paged batches, by route",
                           labels=("route",))
        for route, n in stats.visits.items():
            visits.labels(route).inc(n)
        r.counter("serve_grouped_shards_total",
                  "resident shard visits scored in a grouped launch").inc(
                      stats.grouped)
        r.counter("serve_tile_rows_gathered_total",
                  "stored rows paged batches read on the host").inc(
                      stats.rows_gathered)
        r.counter("serve_tile_gathered_bytes_total",
                  "bytes of the rows paged batches read on the host").inc(
                      stats.bytes_gathered)
        r.histogram("serve_tile_gather_seconds",
                    "host time of a paged batch's row reads",
                    window=self._window).observe(stats.gather_s)

    def record_decode(self, seconds: float) -> None:
        """One host-side compressed shard decode (storage observer)."""
        self._decodes.inc()
        self._decode.observe(seconds)

    def record_prune(self, *, blocks_total: int, blocks_pruned: int,
                     tiles_skipped: int, bytes_saved: int) -> None:
        """One pruned dispatch's accounting (a core.query.PruneStats
        delta): cells considered/killed by the bound, shard-tile visits
        never issued, and arena bytes never read."""
        if blocks_total:
            self._prune_considered.inc(blocks_total)
        if blocks_pruned:
            self._pruned_blocks.inc(blocks_pruned)
        if tiles_skipped:
            self._tiles_skipped.inc(tiles_skipped)
        if bytes_saved > 0:
            self._prune_bytes_saved.inc(bytes_saved)

    def record_bulk_shard(self, *, staged_bytes: int,
                          seconds: float) -> None:
        """One bulk shard sweep: bytes it staged (0 when the tile was
        already resident) and its wall time."""
        self._bulk_shards.inc()
        if staged_bytes:
            self._bulk_staged.inc(staged_bytes)
        self._bulk_shard_s.observe(seconds)

    def record_bulk_yield(self) -> None:
        """The bulk lane suspended a sweep for due interactive work."""
        self._bulk_yields.inc()

    def record_bulk_job(self, status: str, *, queries: int) -> None:
        """A bulk job reached a terminal status."""
        self._bulk_jobs.labels(status).inc()
        if queries and status == "done":
            self._bulk_queries.inc(queries)

    def record_worker(self, worker: str, latency_s: float) -> None:
        """One shard dispatch served by ``worker`` (hedged or not)."""
        self._dispatches.inc()
        self._worker_lat.labels(worker).observe(latency_s)

    def record_hedges(self, *, fired: int, won: int,
                      cancelled: int = 0) -> None:
        if fired:
            self._hedges_fired.inc(fired)
        if won:
            self._hedges_won.inc(won)
        if cancelled:
            self._hedges_cancelled.inc(cancelled)

    def record_failovers(self, n: int) -> None:
        if n:
            self._failovers.inc(n)

    def record_skipped_dead(self, n: int) -> None:
        """Replicas filtered before dispatch because already known dead
        — distinct from failovers, which are at-call-time failures."""
        if n:
            self._skipped_dead.inc(n)

    def record_reply_dropped(self, n: int = 1) -> None:
        """A reply that could not be delivered (outbox full at kick, or
        queued behind a dead socket at drain)."""
        if n:
            self._dropped_replies.inc(n)

    def record_channel(self, node: str, *, up: bool,
                       reconnect: bool = False) -> None:
        """Worker-channel state transition (the reconnecting pool)."""
        self._channel_up.labels(node).set(1 if up else 0)
        if reconnect:
            self._channel_reconnects.labels(node).inc()

    def record_rpc(self, node: str, outcome: str, n: int = 1) -> None:
        """One worker RPC outcome: "sent", "ok", "failed", "cancelled"."""
        if n:
            self._rpcs.labels(node, outcome).inc(n)

    # -- legacy attribute surface ------------------------------------------
    @property
    def served(self) -> int:
        return self._served.value

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @property
    def dropped(self) -> int:
        return self._dropped.value

    @property
    def failed(self) -> int:
        return self._failed.value

    @property
    def cache_hits(self) -> int:
        return self._cache_hits.value

    @property
    def n_batches(self) -> int:
        return self._batches.value

    @property
    def batched_requests(self) -> int:
        return self._batched.value

    @property
    def method_counts(self) -> "_Counter[str]":
        return _Counter({vals[0]: child.value
                         for vals, child in self._methods.children()})

    @property
    def page_faults(self) -> int:
        return self._tile_faults.value

    @property
    def tile_hits(self) -> int:
        return self._tile_hits.value

    @property
    def resident_tiles(self) -> int:
        return int(self._resident.value)

    @property
    def prefetched_tiles(self) -> int:
        return self._tile_prefetched.value

    @property
    def prefetch_hits(self) -> int:
        return self._tile_prefetch_hits.value

    @property
    def arena_raw_bytes(self) -> int:
        return self._arena_raw.value

    @property
    def arena_comp_bytes(self) -> int:
        return self._arena_comp.value

    @property
    def decodes(self) -> int:
        return self._decodes.value

    @property
    def pruned_blocks(self) -> int:
        return self._pruned_blocks.value

    @property
    def prune_considered(self) -> int:
        return self._prune_considered.value

    @property
    def tiles_skipped(self) -> int:
        return self._tiles_skipped.value

    @property
    def pruned_bytes_saved(self) -> int:
        return self._prune_bytes_saved.value

    @property
    def bulk_jobs(self) -> int:
        return sum(child.value for _, child in self._bulk_jobs.children())

    @property
    def bulk_queries(self) -> int:
        return self._bulk_queries.value

    @property
    def bulk_shards_swept(self) -> int:
        return self._bulk_shards.value

    @property
    def bulk_yields(self) -> int:
        return self._bulk_yields.value

    @property
    def bulk_staged_bytes(self) -> int:
        return self._bulk_staged.value

    @property
    def queue_depth(self) -> int:
        return int(self._queue_depth.value)

    @property
    def max_queue_depth(self) -> int:
        return int(self._queue_depth.max)

    @property
    def connections(self) -> int:
        return int(self._connections.value)

    @property
    def total_connections(self) -> int:
        return self._conn_total.value

    @property
    def dispatches(self) -> int:
        return self._dispatches.value

    @property
    def hedges_fired(self) -> int:
        return self._hedges_fired.value

    @property
    def hedges_won(self) -> int:
        return self._hedges_won.value

    @property
    def failovers(self) -> int:
        return self._failovers.value

    @property
    def hedges_cancelled(self) -> int:
        return self._hedges_cancelled.value

    @property
    def skipped_dead(self) -> int:
        return self._skipped_dead.value

    @property
    def dropped_replies(self) -> int:
        return self._dropped_replies.value

    @property
    def channels_up(self) -> int:
        return sum(int(child.value)
                   for _, child in self._channel_up.children())

    @property
    def channel_reconnects(self) -> int:
        return sum(child.value
                   for _, child in self._channel_reconnects.children())

    def rpc_count(self, outcome: str) -> int:
        return sum(child.value for vals, child in self._rpcs.children()
                   if vals[1] == outcome)

    @property
    def worker_recent_s(self) -> dict[str, np.ndarray]:
        """Recent-window dispatch latencies per worker (consistent
        copies — adaptive hedging derives its p95 from these)."""
        return {vals[0]: child.recent_values()
                for vals, child in self._worker_lat.children()}

    def shard_tile_counts(self, event: str) -> dict[str, int]:
        return {vals[0]: child.value
                for vals, child in self._shard_tiles.children()
                if vals[1] == event and child.value}

    # -- reading -----------------------------------------------------------
    def percentile_ms(self, p: float) -> float:
        return self._latency.percentile(p) * 1e3

    def snapshot(self) -> MetricsSnapshot:
        n_cacheable = self.served
        tile_hits, page_faults = self.tile_hits, self.page_faults
        n_tiles = tile_hits + page_faults
        prefetched, prefetch_hits = (self.prefetched_tiles,
                                     self.prefetch_hits)
        dispatches = self.dispatches
        hedges_fired = self.hedges_fired
        n_batches = self.n_batches
        p50, p99 = self._latency.percentiles((50, 99))
        return MetricsSnapshot(
            page_faults=page_faults,
            tile_hits=tile_hits,
            resident_tiles=self.resident_tiles,
            tile_hit_rate=(tile_hits / n_tiles if n_tiles else 0.0),
            prefetched_tiles=prefetched,
            prefetch_hits=prefetch_hits,
            prefetch_hit_rate=(prefetch_hits / prefetched
                               if prefetched else 0.0),
            queue_depth=self.queue_depth,
            max_queue_depth=self.max_queue_depth,
            connections=self.connections,
            total_connections=self.total_connections,
            coalesce_rate=(self.batched_requests / n_batches
                           if n_batches else 0.0),
            failed=self.failed,
            dispatches=dispatches,
            hedges_fired=hedges_fired,
            hedges_won=self.hedges_won,
            hedge_fire_rate=(hedges_fired / dispatches
                             if dispatches else 0.0),
            failovers=self.failovers,
            hedges_cancelled=self.hedges_cancelled,
            skipped_dead=self.skipped_dead,
            dropped_replies=self.dropped_replies,
            channels_up=self.channels_up,
            channel_reconnects=self.channel_reconnects,
            rpcs_sent=self.rpc_count("sent"),
            rpcs_failed=self.rpc_count("failed"),
            worker_p99_ms={
                vals[0]: child.percentile(99) * 1e3
                for vals, child in self._worker_lat.children()
                if len(child)},
            shard_faults=self.shard_tile_counts("fault"),
            shard_evictions=self.shard_tile_counts("eviction"),
            traces_finished=(self.tracer.finished_count
                             if self.tracer is not None else 0),
            slow_queries=(self.tracer.slow_count
                          if self.tracer is not None else 0),
            arena_raw_bytes=self.arena_raw_bytes,
            arena_comp_bytes=self.arena_comp_bytes,
            decodes=self.decodes,
            pruned_blocks=self.pruned_blocks,
            prune_rate=(self.pruned_blocks / self.prune_considered
                        if self.prune_considered else 0.0),
            tiles_skipped=self.tiles_skipped,
            pruned_bytes_saved=self.pruned_bytes_saved,
            bulk_jobs=self.bulk_jobs,
            bulk_queries=self.bulk_queries,
            bulk_shards_swept=self.bulk_shards_swept,
            bulk_yields=self.bulk_yields,
            bulk_staged_bytes=self.bulk_staged_bytes,
            served=n_cacheable,
            rejected=self.rejected,
            dropped=self.dropped,
            cache_hits=self.cache_hits,
            batches=n_batches,
            p50_ms=p50 * 1e3,
            p99_ms=p99 * 1e3,
            mean_occupancy=self._occupancy.mean(),
            cache_hit_rate=(self.cache_hits / n_cacheable
                            if n_cacheable else 0.0),
            methods=dict(self.method_counts),
        )
