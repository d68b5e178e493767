"""Frontend: the scatter/gather half of the sharded serving data plane.

Life of a request (compare QueryServer, the single-host engine):

1. ``submit`` compiles the pattern, answers empty queries immediately, and
   otherwise lands the request in the same shape-bucketed micro-batcher.
2. ``step`` polls the batcher; each due micro-batch is SCATTERED shard by
   shard: for every v2 manifest shard, the ``ShardPlacement`` names the
   replica ranking and the ``HedgedExecutor`` dispatches the batch to the
   preferred live ``ShardWorker`` — firing a backup request at the next
   replica if the primary dawdles past the hedge deadline ('The Tail at
   Scale'), and failing over entirely when a worker is down. While shard
   i scores, shard i+1's owner prefetches its tile (double buffering
   across hosts).
3. Workers return per-query CANDIDATES (doc, score pairs already cut to
   the coverage threshold or local top-k); the frontend GATHERS them and
   runs the final selection under the engine's exact total order
   (descending score, ties ascending doc id) — the same score-combine as
   the JAX package's mesh top-k, so results are bit-identical to the
   single-host QueryEngine.

Clocking: with ``latency_models`` (node -> ShardSim) every dispatch
latency is simulated on the executor's injected SimClock and the frontend
reads request timestamps off that same clock — tests and benchmarks are
fully deterministic, straggler/hedge behavior included. Without models,
dispatch is timed on the wall clock (production mode).

This is ``repro.serve.frontend`` for the PyTorch port: the same batching,
scatter, hedging, gather and metrics, over the port's ``ShardWorker``s.
The concurrent scatter pool launches kernels from several host threads at
once; the kernel wrappers count their launches under a lock, and each
worker's tile cache orders a consumer's stream after the tile's copy.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..core.query import (SearchResult, compile_pattern, coverage_cutoff)
from ..index.hedge import (AllReplicasFailed, AttemptFailed, HedgedExecutor,
                           ShardSim)
from ..index.placement import ShardPlacement
from ..obs import EventLog, KernelProfiler, Tracer
from .base import ServingBackend
from .batcher import MicroBatch, MicroBatcher
from .metrics import ServingMetrics
from .request import QueryRequest, QueryResponse, Status
from .worker import ShardWorker


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    term_pad: int = 64          # bucket granularity (multiples of this)
    max_batch: int = 32         # micro-batch cap per bucket
    max_wait_s: float = 0.002   # flush timer for partially-filled buckets
    max_queued: int = 1024      # backpressure cap across all buckets
    # Fit bucket boundaries to the observed term-length histogram
    # (MicroBatcher adaptive mode; mirrors ServerConfig).
    adaptive_buckets: bool = False
    default_threshold: float = 0.8
    default_top_k: int = 10     # k for top_k() convenience calls
    hedge_after_s: float = 0.05  # backup-request deadline per shard dispatch
    max_hedges: int = 1
    # Adaptive hedging (ROADMAP open item): derive hedge_after from the
    # OBSERVED per-worker latency histogram instead of the fixed config
    # value. After every scored batch the frontend takes each worker's
    # dispatch-latency p95 (workers with >= hedge_auto_min_samples
    # samples) and sets the executor's hedge deadline to the MEDIAN of
    # those p95s: with one straggler among >= 3 workers the median tracks
    # a *healthy* worker's p95, so backups fire exactly against dispatches
    # that exceed what the fleet normally achieves. hedge_after_s is the
    # initial value until enough samples accumulate.
    hedge_auto: bool = False
    hedge_auto_min_samples: int = 16
    hedge_auto_floor_s: float = 1e-5   # sanity floor (never hedge-at-zero)
    # Concurrent scatter: per-shard dispatches are issued through a thread
    # pool of this size so worker compute overlaps across hosts (<= 1 =
    # sequential). Only active in wall-clock mode — simulated-latency runs
    # share one deterministic event clock and stay sequential regardless.
    scatter_threads: int = 4
    # Threshold-driven pruned scoring on every worker: shard dispatches
    # whose coverage threshold predicts enough block pruning run through
    # the chunked early-exit executor (see ShardWorker._score_pruned) —
    # gathered results stay bit-identical either way. Setting this
    # overrides the flags the workers were constructed with.
    pruned: bool = False
    prune_chunk: int = 32
    # -- observability (mirrors ServerConfig; see repro_torch.obs) --
    tracing: bool = True
    trace_slow_ms: float = 0.0
    trace_ring: int = 256
    trace_log: Optional[str] = None
    profile_kernels: bool = True


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class Frontend(ServingBackend):
    def __init__(self, workers: dict[str, ShardWorker],
                 placement: ShardPlacement,
                 config: FrontendConfig = FrontendConfig(), *,
                 clock: Optional[Callable[[], float]] = None,
                 latency_models: Optional[dict[str, ShardSim]] = None):
        # a node holding zero shards (more hosts than shard replicas) needs
        # no worker; every replicating node must hold its full replica set
        for node, held in placement.replica_assignment().items():
            if not held:
                continue
            if node not in workers:
                raise ValueError(f"placement node {node} replicates shards "
                                 f"{held} but has no worker")
            gaps = [g for g in held if not workers[node].holds(g)]
            if gaps:
                raise ValueError(
                    f"worker {node} missing replica shards {gaps}")
        self.workers = workers
        self.placement = placement
        self.config = config
        self.executor = HedgedExecutor(
            shards=dict(latency_models) if latency_models else {},
            hedge_after=config.hedge_after_s, max_hedges=config.max_hedges)
        self._simulated = bool(latency_models)
        if clock is None:
            clock = ((lambda: self.executor.clock.now) if self._simulated
                     else time.monotonic)
        self.clock = clock
        self.batcher = MicroBatcher(
            term_pad=config.term_pad, max_batch=config.max_batch,
            max_wait_s=config.max_wait_s, max_queued=config.max_queued,
            adaptive=config.adaptive_buckets)
        self.metrics = ServingMetrics()
        # Observability plane (mirrors QueryServer): tracer + slow-query
        # event log + kernel profiler shared by every worker, all feeding
        # the one metrics registry.
        self.events = EventLog(config.trace_log, ring=max(64,
                                                          config.trace_ring))
        self.tracer = Tracer(enabled=config.tracing, ring=config.trace_ring,
                             slow_ms=config.trace_slow_ms, sink=self.events,
                             clock=self.clock)
        self.metrics.tracer = self.tracer
        self.profiler = KernelProfiler(self.metrics.registry, None,
                                       enabled=config.profile_kernels)
        for w in workers.values():
            w.profiler = self.profiler
            w.tiles.observer = self._tile_observer(w)
            if config.pruned:
                w.pruned = True
                w.prune_chunk = int(config.prune_chunk)
        self._responses: dict[int, QueryResponse] = {}
        self._next_id = 0
        self._dispatch_seq = 0
        first = next(iter(workers.values()))
        self.params = first.params
        self.n_docs = first.layout.n_docs
        # Concurrent scatter pool (wall-clock mode only: simulated runs
        # share one deterministic event clock, so their dispatches stay
        # sequential and bit-reproducible).
        self._pool: Optional[ThreadPoolExecutor] = None
        if not self._simulated and config.scatter_threads > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=config.scatter_threads,
                thread_name_prefix="scatter")

    # -- control plane -------------------------------------------------------
    def fail_worker(self, node: str) -> list[int]:
        """Mark a host down (placement failover + dead dispatch). Returns
        the shards whose primary moved to a replica."""
        moved = self.placement.fail(node)
        if node in self.workers:
            self.workers[node].fail()
        if node in self.executor.shards:
            self.executor.shards[node].failed = True
        return moved

    def recover_worker(self, node: str) -> list[int]:
        restored = self.placement.recover(node)
        if node in self.workers:
            self.workers[node].recover()
        if node in self.executor.shards:
            self.executor.shards[node].failed = False
        return restored

    def _tile_observer(self, w: ShardWorker):
        """DeviceTileCache observer for one worker: caches index tiles by
        LOCAL shard slot, so translate back to the GLOBAL shard id before
        the per-shard fault/eviction counters see it. Workers may fault
        from scatter-pool threads — the counters lock internally."""
        def on_event(local: int, event: str, seconds: float) -> None:
            g = (int(w.shard_ids[local])
                 if 0 <= local < len(w.shard_ids) else int(local))
            self.metrics.record_shard_tile(g, event)
        return on_event

    # -- submission ----------------------------------------------------------
    def submit(self, pattern=None, *, terms: Optional[np.ndarray] = None,
               threshold: Optional[float] = None,
               top_k: Optional[int] = None,
               deadline: Optional[float] = None,
               trace_id: int = 0) -> int:
        """Accept one query; ``top_k`` switches the request from coverage-
        threshold selection to exact global top-k. A nonzero ``trace_id``
        (e.g. minted by a remote client and carried over the wire) is
        honored; otherwise the tracer mints one."""
        if (pattern is None) == (terms is None):
            raise ValueError("pass exactly one of pattern / terms")
        if terms is None:
            terms = compile_pattern(pattern, self.params)
        threshold = (self.config.default_threshold if threshold is None
                     else threshold)
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        trace = self.tracer.begin(rid, trace_id=trace_id or None,
                                  started_s=now)
        if terms.shape[0] == 0:
            empty = SearchResult(np.zeros(0, np.int32),
                                 np.zeros(0, np.int32), 0, 0)
            self.metrics.record_request(wait_s=0.0, service_s=0.0)
            resp = QueryResponse(rid, Status.OK, empty)
            if trace is not None:
                trace.add("fast_path", now, self.clock(), {"path": "empty"})
            self._responses[rid] = self.finalize_trace(trace, resp)
            return rid
        req = QueryRequest(rid, terms, terms.shape[0], threshold,
                           submitted_at=now, deadline=deadline,
                           top_k=int(top_k) if top_k else 0, trace=trace)
        if not self.batcher.submit(req):
            self.metrics.record_rejected()
            resp = QueryResponse(rid, Status.REJECTED)
            if trace is not None:
                trace.add("reject", now, self.clock(),
                          {"reason": "backpressure"})
            self._responses[rid] = self.finalize_trace(trace, resp)
        return rid

    # -- scatter/gather ------------------------------------------------------
    def _staged(self, cache: dict, worker: ShardWorker, buf, n_valid):
        key = worker.device
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = worker.stage_batch(buf, n_valid)
        return hit

    def _scatter_sequential(self, staged, buf, n_valid, cutoffs, topks,
                            Q: int):
        """Shard-by-shard hedged dispatch on one (possibly simulated)
        clock: every shard scatters at the same event instant, the slowest
        completion bounds the batch. Returns ([(node, latency, result)]
        in shard order, max completion latency)."""
        ex = self.executor
        t_base = ex.clock.now
        max_done = 0.0
        out = []
        n_shards = self.placement.n_shards
        for g in range(n_shards):
            if g + 1 < n_shards:
                # double buffering across hosts: stage shard g+1's tile
                # on its owner while shard g scores (wherever it lands)
                try:
                    nxt = self.placement.owner(g + 1)
                    self.workers[nxt].prefetch_shard(g + 1)
                except RuntimeError:
                    pass

            def call(node, g=g):
                w = self.workers[node]
                terms_dev, nvalid_dev = self._staged(staged, w, buf,
                                                     n_valid)
                return w.score_candidates(g, terms_dev, nvalid_dev,
                                          cutoffs, topks, Q)

            self._dispatch_seq += 1
            # rewind the event clock to the batch start per shard, track
            # the slowest completion
            ex.clock.now = t_base
            node, lat, res = ex.run(
                self._dispatch_seq, self.placement.replicas(g), call)
            max_done = max(max_done, lat)
            out.append((node, lat, res))
        ex.clock.now = t_base + max_done
        return out, max_done

    def _scatter_concurrent(self, staged, buf, n_valid, cutoffs, topks,
                            Q: int):
        """Concurrent scatter: every shard's dispatch runs on the thread
        pool so worker compute overlaps ACROSS hosts (each worker still
        serializes its own dispatches — one device per host).

        Wall-clock mode only. Semantics match sequential wall-clock
        dispatch exactly: hedging stays off (a synchronous in-process
        backup can never win — see repro_torch.index.hedge), failover
        walks the replica ranking inline, and the executor's
        failover/completion stats are aggregated in the submitting thread
        so the executor is never shared across threads. Gather order stays deterministic:
        futures are consumed in shard order, and the final per-query sort
        under (-score, doc) is order-independent anyway."""
        ex = self.executor
        n_shards = self.placement.n_shards
        replica_sets = [self.placement.replicas(g) for g in range(n_shards)]
        # stage the batch once per device up front: worker staging caches
        # are plain dicts (not thread-safe) and staging is cheap
        for replicas in replica_sets:
            for node in replicas:
                self._staged(staged, self.workers[node], buf, n_valid)
        # prefetch every shard tile on its owner before the dispatch wave:
        # transfers are issued asynchronously, so by the time a pool
        # thread's kernel asks for the tile it is (being) staged — the
        # all-at-once analogue of the sequential path's double buffering
        for g in range(n_shards):
            try:
                self.workers[self.placement.owner(g)].prefetch_shard(g)
            except RuntimeError:
                pass

        def dispatch(g: int):
            for rank, node in enumerate(replica_sets[g]):
                w = self.workers[node]
                terms_dev, nvalid_dev = staged[w.device]
                t0 = time.perf_counter()
                try:
                    res = w.score_candidates(g, terms_dev, nvalid_dev,
                                             cutoffs, topks, Q)
                except AttemptFailed:
                    continue
                return node, time.perf_counter() - t0, res, rank
            raise AllReplicasFailed(f"shard {g}: all replicas failed")

        futures = [self._pool.submit(dispatch, g) for g in range(n_shards)]
        out, failed = [], None
        for fut in futures:
            try:
                node, lat, res, rank = fut.result()
            except AllReplicasFailed as e:
                failed = e          # keep draining so the pool is clean
                continue
            self._dispatch_seq += 1
            ex.failovers += rank
            ex.completions.append((self._dispatch_seq, node, lat, False))
            out.append((node, lat, res))
        if failed is not None:
            raise failed
        return out

    def _scatter(self, staged, buf, n_valid, cutoffs, topks, Q: int):
        """Dispatch hook: scatter one staged batch across every shard and
        return ([(node, latency, (cands, method))] in shard order,
        max completion latency). Subclasses with a different transport
        (repro_torch.serve.rpc.RpcFrontend) override just this seam."""
        if self._pool is not None and self.placement.n_shards > 1:
            results = self._scatter_concurrent(staged, buf, n_valid,
                                               cutoffs, topks, Q)
            max_done = max((lat for _, lat, _ in results), default=0.0)
            return results, max_done
        return self._scatter_sequential(staged, buf, n_valid, cutoffs,
                                        topks, Q)

    def score_batch(self, batch: MicroBatch) -> None:
        """Scatter/score/gather one flushed micro-batch. Public so an
        active serving loop (repro_torch.serve.loop) can pull batches off
        ``poll_batches`` and score them from worker threads."""
        t0 = self.clock()
        Q, B = batch.size, batch.bucket
        q_pad = _next_pow2(Q)
        buf = np.zeros((q_pad, B, 2), dtype=np.uint32)
        n_valid = np.zeros(q_pad, dtype=np.int32)
        cutoffs = np.zeros(q_pad, dtype=np.int32)
        topks = np.zeros(q_pad, dtype=np.int32)
        for i, r in enumerate(batch.requests):
            buf[i, : r.n_terms] = r.terms
            n_valid[i] = r.n_terms
            k = r.top_k
            topks[i] = k
            if not k:
                cutoffs[i] = coverage_cutoff(r.threshold, r.n_terms)

        staged: dict = {}
        gathered: list[list[tuple[np.ndarray, np.ndarray]]] = \
            [[] for _ in range(Q)]
        ex = self.executor
        fired0, won0, fo0 = ex.hedges_fired, ex.hedges_won, ex.failovers
        canc0, skip0 = ex.hedges_cancelled, ex.skipped_dead
        tiles0 = self._tile_counters()
        prune0 = self._prune_counters()
        traced = any(r.trace is not None for r in batch.requests)
        method = ""
        t_sc0 = self.clock()
        try:
            results, max_done = self._scatter(staged, buf, n_valid,
                                              cutoffs, topks, Q)
        except AllReplicasFailed:
            # a shard lost every replica mid-flight: the batch is already
            # out of the batcher, so answer every request FAILED instead of
            # raising it into the serving loop and losing the rids
            # (only this failure domain — kernel/device errors propagate)
            t_fail = self.clock()
            for r in batch.requests:
                self.metrics.record_failed()
                resp = QueryResponse(
                    r.request_id, Status.FAILED,
                    wait_s=max(0.0, t0 - r.submitted_at))
                if r.trace is not None:
                    r.trace.add("queue_wait", r.submitted_at, t0,
                                {"flush": batch.reason or "direct",
                                 "batch_size": Q})
                    r.trace.add("scatter", t_sc0, t_fail,
                                {"outcome": "all_replicas_failed"})
                self._responses[r.request_id] = self.finalize_trace(
                    r.trace, resp)
            return
        # gather in shard order — deterministic however dispatch ran
        for node, lat, (cands, method) in results:
            self.metrics.record_worker(node, lat)
            for i in range(Q):
                gathered[i].append(cands[i])
        service = max_done if self._simulated else self.clock() - t0

        self.metrics.record_hedges(fired=ex.hedges_fired - fired0,
                                   won=ex.hedges_won - won0,
                                   cancelled=ex.hedges_cancelled - canc0)
        self.metrics.record_failovers(ex.failovers - fo0)
        self.metrics.record_skipped_dead(ex.skipped_dead - skip0)
        if self.config.hedge_auto:
            self._adapt_hedge_after()
        self.metrics.record_batch(Q, self.batcher.occupancy(batch), method)
        th, tf, tp, tph = self._tile_counters()
        self.metrics.record_tiles(
            hits=th - tiles0[0], faults=tf - tiles0[1],
            resident=sum(len(w.tiles) for w in self.workers.values()),
            prefetched=tp - tiles0[2], prefetch_hits=tph - tiles0[3])
        # pruned-dispatch deltas across the fleet (workers accumulate
        # PruneStats per dispatch; this batch's share is the difference)
        pr = self._prune_counters()
        if pr[0] != prune0[0] or pr[2] != prune0[2]:
            self.metrics.record_prune(
                blocks_total=pr[0] - prune0[0],
                blocks_pruned=pr[1] - prune0[1],
                tiles_skipped=pr[2] - prune0[2],
                bytes_saved=max(0, (pr[4] - prune0[4])
                                - (pr[3] - prune0[3])))

        # Batch-level shard_dispatch marks, replayed into every member
        # request's trace: one span per shard naming the serving node and
        # its role — "primary" (the placement's preferred replica),
        # "backup" (a hedged backup request won the race), or "failover"
        # (the primary was found dead at dispatch time). The executor
        # appends exactly one completion per dispatch in shard order, so
        # the tail of ex.completions lines up with ``results``.
        marks: list[tuple[str, float, float, dict]] = []
        if traced:
            comps = list(ex.completions)[-len(results):]
            for g, (node, lat, _res) in enumerate(results):
                hedged = bool(comps[g][3]) if g < len(comps) else False
                replicas = self.placement.replicas(g)
                role = ("primary" if replicas and node == replicas[0]
                        else ("backup" if hedged else "failover"))
                marks.append(("shard_dispatch", t_sc0, t_sc0 + lat,
                              {"shard": g, "node": node, "role": role,
                               "hedged": int(hedged)}))

        for i, r in enumerate(batch.requests):
            ts0 = self.clock()
            result = self._gather(gathered[i], r, int(topks[i]),
                                  int(cutoffs[i]))
            wait = max(0.0, t0 - r.submitted_at)
            self.metrics.record_request(wait_s=wait, service_s=service)
            resp = QueryResponse(
                r.request_id, Status.OK, result, method=method,
                batch_size=Q, wait_s=wait, service_s=service)
            if r.trace is not None:
                r.trace.add("queue_wait", r.submitted_at, t0,
                            {"flush": batch.reason or "direct",
                             "batch_size": Q})
                for name, s, e, tags in marks:
                    r.trace.add(name, s, e, tags)
                r.trace.add("gather", ts0, self.clock())
            self._responses[r.request_id] = self.finalize_trace(
                r.trace, resp)

    def _adapt_hedge_after(self) -> None:
        """hedge_after from the observed per-worker latency histograms:
        the median across workers of each worker's dispatch-latency p95
        (see FrontendConfig.hedge_auto). Median, not pooled p95 — with a
        straggler holding 1/n of the dispatches, the POOLED p95 rises to
        the straggler's latency and hedging would never fire; the
        cross-worker median keeps tracking the healthy fleet. Runs after
        every batch, so the p95 is taken over the RECENT sample window
        (metrics.worker_recent_s), not the full percentile history."""
        per_worker = [
            float(np.percentile(q, 95))
            for q in self.metrics.worker_recent_s.values()
            if q.size >= self.config.hedge_auto_min_samples]
        if not per_worker:
            return
        self.executor.hedge_after = max(self.config.hedge_auto_floor_s,
                                        float(np.median(per_worker)))

    @property
    def hedge_after_s(self) -> float:
        """The hedge deadline currently in force (adapted when
        ``hedge_auto`` is on, else the configured value)."""
        return self.executor.hedge_after

    def _tile_counters(self) -> tuple[int, int, int, int]:
        ws = self.workers.values()
        return (sum(w.tiles.hits for w in ws),
                sum(w.tiles.faults for w in ws),
                sum(w.tiles.prefetched for w in ws),
                sum(w.tiles.prefetch_hits for w in ws))

    def _prune_counters(self) -> tuple[int, int, int, int, int]:
        """(blocks_total, blocks_pruned, visits_skipped, bytes_read,
        baseline_bytes) summed over the fleet's cumulative PruneStats."""
        ws = self.workers.values()
        return (sum(w.prune_stats.blocks_total for w in ws),
                sum(w.prune_stats.blocks_pruned for w in ws),
                sum(w.prune_stats.shard_visits_skipped for w in ws),
                sum(w.prune_stats.bytes_read for w in ws),
                sum(w.prune_baseline_bytes for w in ws))

    def _gather(self, parts: list[tuple[np.ndarray, np.ndarray]],
                req: QueryRequest, top_k: int, cutoff: int) -> SearchResult:
        """Final selection over gathered candidates — the distributed
        score-combine. Blocks partition documents, so each doc appears in
        exactly one shard's candidates and the global sort under
        (-score, doc id) reproduces the single-host engine exactly."""
        docs = np.concatenate([p[0] for p in parts]) if parts else \
            np.zeros(0, np.int64)
        scores = np.concatenate([p[1] for p in parts]) if parts else \
            np.zeros(0, np.int32)
        order = np.lexsort((docs, -scores))
        if top_k:
            order = order[: min(top_k, self.n_docs)]
            cut = int(scores[order[-1]]) if order.size else 0
        else:
            cut = cutoff
        return SearchResult(docs[order].astype(np.int32),
                            scores[order].astype(np.int32),
                            req.n_terms, cut)

    # -- serving loop (poll_batches / step / drain / take_response /
    # retract / pop_responses come from ServingBackend) ----------------------
    def reset_metrics(self, *, clear_caches: bool = False) -> None:
        """Fresh counters (drivers call this after a warm-up pass). The
        frontend holds no result caches — ``clear_caches`` is accepted for
        driver compatibility with QueryServer and ignored."""
        self.metrics = ServingMetrics()
        self.metrics.tracer = self.tracer
        self.profiler.bind_registry(self.metrics.registry)
        self.executor.completions.clear()
        self.executor.hedges_fired = 0
        self.executor.hedges_won = 0
        self.executor.hedges_cancelled = 0
        self.executor.failovers = 0
        self.executor.skipped_dead = 0
