"""QueryServer: the single-host serving front end tying planner, batcher,
caches and metrics together, the counterpart of ``repro.serve.server``.

Life of a request:

1. ``submit`` compiles the pattern to distinct packed terms, answers at
   once on a result-cache hit, a single-term row-cache hit, or
   backpressure (queue full), and otherwise enqueues into the
   shape-bucketed micro-batcher.
2. ``step`` (called from the driver's loop) polls the batcher; every due
   micro-batch is planned (kernel choice from index layout x batch shape),
   scored on the index's device, split back into per-request results with
   each request's own threshold, and cached.
3. Responses accumulate until ``pop_responses``.

The server is single-threaded and clock-injectable: drivers decide the
cadence (closed-loop drivers call ``drain``, open-loop ones ``step`` on
arrival timestamps), and tests run on a virtual clock. Every kernel span
ends after the scores are on the host, so the profiler's kernel times
are complete device times, not launch times.

It differs from the JAX server in two deliberate ways: its tile cache does
not pad tiles to a common height (PyTorch runs eagerly, so padding would
only cost bytes), and it has no autotuner (ROADMAP A12), so
``ServerConfig.autotune`` and ``tuning_cache`` raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import codec as _codec
from ..core import hashing
from ..core.arena import DeviceTileCache
from ..core.index import BitSlicedIndex
from ..core.query import (PruneStats, SearchResult, _to_device,
                          compile_pattern, coverage_cutoff, dedup_inputs,
                          plan_dedup_batch, run_paged, run_paged_compressed,
                          run_paged_dedup, run_paged_pruned, select_hits,
                          select_top_k)
from ..device import resolve_device
from ..obs import EventLog, KernelProfiler, Tracer
from ..obs.profile import gather_bytes
from .base import ServingBackend
from .batcher import MicroBatch, MicroBatcher
from .cache import LRUCache, result_key, term_key
from .metrics import ServingMetrics
from .planner import DEFAULT_DEDUP_MIN_RATE, QueryPlanner
from .request import QueryRequest, QueryResponse, Status


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    term_pad: int = 64          # bucket granularity (multiples of this)
    max_batch: int = 32         # micro-batch cap per bucket
    max_wait_s: float = 0.002   # flush timer for partially-filled buckets
    max_queued: int = 1024      # backpressure cap across all buckets
    # Fit bucket boundaries to the observed term-length histogram instead
    # of the fixed term_pad grid (MicroBatcher adaptive mode).
    adaptive_buckets: bool = False
    result_cache: int = 1024    # whole-query LRU entries (0 disables)
    row_cache: int = 4096       # single-term row LRU entries (0 disables)
    default_threshold: float = 0.8
    # Device budget for shard tiles when serving an out-of-core (sharded,
    # mmapped) index; None = unbounded, every touched shard stays resident.
    # Ignored for dense single-shard storage.
    tile_cache_bytes: Optional[int] = None
    # The JAX kernels' tile width: carried in plans, validated by the
    # dedup path, no effect on the port's kernels.
    word_block: Optional[int] = None
    # Row-dedup path: minimum fraction of a batch's row reads that must be
    # duplicates before the dedup pair replaces the fused multi-query
    # kernel. None disables dedup.
    dedup_min_rate: Optional[float] = DEFAULT_DEDUP_MIN_RATE
    # Serve dict-coded shards from their compressed (dict, refs) device
    # form through the fused-decode kernels (when the dict ratio clears
    # the planner's threshold); raw shards are unaffected.
    compressed: bool = False
    # Threshold-driven pruned scoring through the chunked early-exit
    # executor, when the planner predicts enough block pruning; results
    # equal unpruned scoring either way.
    pruned: bool = False
    prune_chunk: int = 32
    # Minimum predicted block-prune rate before pruned dispatch (None =
    # planner.DEFAULT_PRUNE_MIN_RATE).
    prune_min_rate: Optional[float] = None
    # The JAX server's kernel autotuner and its persisted cache: not
    # ported yet (ROADMAP A12); True or a path raises NotImplementedError.
    autotune: bool = False
    tuning_cache: Optional[str] = None
    # -- observability (repro_torch.obs) --
    # Request tracing: every admitted query gets a Trace; layers append
    # spans; finished traces land in a bounded ring.
    tracing: bool = True
    # Completed traces slower than this (ms, end to end) go to the
    # slow-query JSONL log. 0 disables the slow sink (the ring still fills).
    trace_slow_ms: float = 0.0
    trace_ring: int = 256
    # JSONL slow-query log path; None keeps events in memory only.
    trace_log: Optional[str] = None
    # Per-dispatch kernel time and bytes-moved accounting, fed to the
    # metrics registry.
    profile_kernels: bool = True


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class QueryServer(ServingBackend):
    """The single-host server over ``index`` on ``device`` (None = the
    CUDA card; raises when the index lives elsewhere)."""

    def __init__(self, index: BitSlicedIndex,
                 config: ServerConfig = ServerConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        if config.autotune or config.tuning_cache:
            raise NotImplementedError(
                "ServerConfig.autotune and tuning_cache need the kernel "
                "autotuner, which the port has not yet (ROADMAP A12)")
        self.device = resolve_device(device)
        if index.device.type != self.device.type or (
                self.device.index is not None
                and index.device.index != self.device.index):
            raise ValueError(f"the index lives on {index.device}, the server "
                             f"on {self.device}")
        self.index = index
        self.config = config
        self.clock = clock
        self.planner = QueryPlanner(index, word_block=config.word_block,
                                    dedup_min_rate=config.dedup_min_rate,
                                    compressed=config.compressed,
                                    pruned=config.pruned,
                                    prune_chunk=config.prune_chunk,
                                    prune_min_rate=config.prune_min_rate)
        # whole-arena device footprint: the baseline a pruned batch's
        # bytes read are charged against for the bytes-saved metric
        self._arena_total_bytes = sum(
            int(index.storage.shard_hbm_nbytes(s))
            for s in range(index.storage.n_shards))
        self.batcher = MicroBatcher(
            term_pad=config.term_pad, max_batch=config.max_batch,
            max_wait_s=config.max_wait_s, max_queued=config.max_queued,
            adaptive=config.adaptive_buckets)
        self.metrics = ServingMetrics()
        self.results_cache = LRUCache(config.result_cache)
        self.rows_cache = LRUCache(config.row_cache)
        self._responses: dict[int, QueryResponse] = {}
        self._next_id = 0
        self._host_slot = np.asarray(index.layout.doc_slot)
        # Out-of-core serving state: shard tiles page onto the device
        # through a bounded LRU (unpadded, as the port's QueryEngine's);
        # dense storage is one "shard", the resident arena.
        self.tiles = DeviceTileCache(index.storage,
                                     capacity_bytes=config.tile_cache_bytes)
        # per-shard addressing on the index's device, staged once
        self._shard_args = [
            (sp.shard, torch.from_numpy(sp.row_offset).to(index.device),
             torch.from_numpy(sp.block_width).to(index.device))
            for sp in self.planner.shard_plans]
        # -- observability ---------------------------------------------------
        self.events = EventLog(config.trace_log,
                               ring=max(64, config.trace_ring))
        self.tracer = Tracer(enabled=config.tracing,
                             ring=config.trace_ring,
                             slow_ms=config.trace_slow_ms,
                             sink=self.events, clock=clock)
        self.metrics.tracer = self.tracer
        self.profiler = KernelProfiler(self.metrics.registry, None,
                                       enabled=config.profile_kernels)
        # Tile-cache events flow through one observer: per-shard labeled
        # counters always; per-batch fault/prefetch capture so the kernel
        # span can name the shards it had to stage.
        self._tile_events: list[tuple] = []
        self.tiles.observer = self._on_tile_event
        # host-side decodes land in the decode histogram; staged bytes are
        # per-batch deltas of the tile cache's per-form counters
        if hasattr(index.storage, "decode_observer"):
            index.storage.decode_observer = \
                lambda s, codec, sec: self.metrics.record_decode(sec)

    def _on_tile_event(self, shard: int, event: str,
                       seconds: float) -> None:
        self.metrics.record_shard_tile(shard, event)
        if event in ("fault", "prefetch"):
            self._tile_events.append((shard, event, self.clock(), seconds))

    # -- submission ---------------------------------------------------------
    def submit(self, pattern=None, *, terms: Optional[np.ndarray] = None,
               threshold: Optional[float] = None,
               top_k: Optional[int] = None,
               deadline: Optional[float] = None,
               trace_id: int = 0) -> int:
        """Accept one query (pattern or precompiled terms); returns the
        request id. ``top_k`` switches the request from coverage-threshold
        selection to exact top-k (QueryEngine.top_k's order). Fast paths
        answer at once; everything else waits in the micro-batcher until
        the next ``step``/``drain``. ``trace_id`` carries a caller-minted
        id into the request's trace; 0 mints one when tracing is on."""
        if (pattern is None) == (terms is None):
            raise ValueError("pass exactly one of pattern / terms")
        if terms is None:
            terms = compile_pattern(pattern, self.index.params)
        threshold = (self.config.default_threshold if threshold is None
                     else threshold)
        top_k = int(top_k) if top_k else 0
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        ell = terms.shape[0]
        trace = self.tracer.begin(rid, trace_id=trace_id or None,
                                  started_s=now)

        if ell == 0:
            empty = SearchResult(np.zeros(0, np.int32),
                                 np.zeros(0, np.int32), 0, 0)
            if trace is not None:
                trace.add("fast_path", now, self.clock(),
                          {"path": "empty"})
            self._answer(rid, Status.OK, empty, wait=0.0, service=0.0,
                         trace=trace)
            return rid

        key = result_key(terms, threshold, top_k)
        hit = self.results_cache.get(key)
        if hit is not None:
            self.metrics.record_request(wait_s=0.0, service_s=0.0,
                                        cached=True)
            if trace is not None:
                trace.add("cache_lookup", now, self.clock(), {"hit": 1})
            self._responses[rid] = self._finalize(trace, QueryResponse(
                rid, Status.OK, hit, method="cache", batch_size=1,
                cached=True))
            return rid

        if ell == 1 and self.rows_cache.capacity:
            result, row_hit = self._point_query(terms, threshold, top_k)
            service = self.clock() - now
            self.metrics.record_request(wait_s=0.0, service_s=service,
                                        cached=row_hit)
            if trace is not None:
                trace.add("point_query", now, self.clock(),
                          {"row_hit": int(row_hit)})
            self._responses[rid] = self._finalize(trace, QueryResponse(
                rid, Status.OK, result, method="row_cache", batch_size=1,
                wait_s=0.0, service_s=service, cached=row_hit))
            self.results_cache.put(key, result)
            return rid

        req = QueryRequest(rid, terms, ell, threshold,
                           submitted_at=now, deadline=deadline,
                           top_k=top_k, trace=trace)
        if not self.batcher.submit(req):
            self.metrics.record_rejected()
            if trace is not None:
                trace.add("reject", now, self.clock(),
                          {"reason": "backpressure"})
            self._responses[rid] = self._finalize(
                trace, QueryResponse(rid, Status.REJECTED))
            return rid
        return rid

    def _finalize(self, trace, resp: QueryResponse) -> QueryResponse:
        return self.finalize_trace(trace, resp)

    # -- point queries (COBS single-k-mer lookups) via the row cache --------
    def _gather_host_row(self, term: np.ndarray) -> np.ndarray:
        """ANDed arena row for one term, on the host: uint32 [nb * W] in
        slot-word order (as plan_rows + gather give it). Reads rows
        through the storage backend, so a mapped index pages in only the
        touched shards."""
        h = hashing.hash_terms_np(term[None, :],
                                  self.index.params.n_hashes)[0]  # [k]
        layout = self.index.layout
        rows = (h[:, None] % layout.block_width.astype(np.uint32)
                + layout.row_offset.astype(np.uint32))            # [k, nb]
        g = self.index.storage.read_rows_host(rows.astype(np.int64))
        anded = g[0]                                              # [nb, W]
        for i in range(1, g.shape[0]):
            anded = anded & g[i]
        return anded.reshape(-1)                                  # [nb * W]

    def _point_query(self, terms: np.ndarray, threshold: float,
                     top_k: int = 0) -> tuple[SearchResult, bool]:
        """Returns (result, served-from-row-cache)."""
        k = term_key(terms[0])
        row = self.rows_cache.get(k)
        hit = row is not None
        if row is None:
            row = self._gather_host_row(terms[0])
            self.rows_cache.put(k, row)
        bits = ((row[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
        scores = bits.astype(np.int32).reshape(-1)[self._host_slot]
        return self._select(scores, 1, threshold, top_k), hit

    @staticmethod
    def _select(scores: np.ndarray, n_terms: int, threshold: float,
                top_k: int) -> SearchResult:
        """Per-request selection: coverage threshold, or exact top-k under
        QueryEngine's (-score, doc id) order when top_k > 0."""
        if top_k:
            return select_top_k(scores, n_terms, top_k)
        return select_hits(scores, n_terms, threshold)

    # -- batch scoring -------------------------------------------------------
    def _run_plan(self, plan, fn, terms_dev, valid_dev,
                  fn_comp=None) -> np.ndarray:
        """Dispatch ``fn`` once against the dense arena, or, for a paged
        plan, once per shard tile (staged through the LRU tile cache),
        concatenating per-shard slot scores along the slot axis. With
        ``fn_comp`` (compressed plans) dict-coded shards stage their
        (dict, refs) form and score through the fused-decode kernels.
        Returns the scores on the host."""
        if not plan.paged:
            if (fn_comp is not None and self.index.storage.shard_codec(0)
                    in _codec.DICT_CODECS):
                dict_rows, refs = self.tiles.get_compressed(0)
                out = fn_comp(dict_rows, refs, self.index.row_offset,
                              self.index.block_width, terms_dev, valid_dev)
            else:
                out = fn(self.tiles.get(0), self.index.row_offset,
                         self.index.block_width, terms_dev, valid_dev)
            return out.cpu().numpy()
        if fn_comp is not None:
            return np.concatenate(
                run_paged_compressed(self.tiles, self._shard_args, fn,
                                     fn_comp, terms_dev, valid_dev),
                axis=-1)
        return np.concatenate(
            run_paged(self.tiles, self._shard_args, fn, terms_dev,
                      valid_dev), axis=-1)

    def _score_dedup(self, buf: np.ndarray, n_valid: np.ndarray, plan,
                     marks: Optional[list] = None) -> Optional[np.ndarray]:
        """Row-dedup dispatch, or None when the batch's dedup rate is
        below the plan's threshold. The global-layout plan decides; dense
        execution reuses it, paged execution re-plans per shard against
        the rebased addressing. ``marks`` collects (name, start, end,
        tags) stage timings for tracing."""
        layout = self.index.layout
        td0 = self.clock()
        dp = plan_dedup_batch(buf, n_valid, layout.row_offset,
                              layout.block_width)
        if marks is not None:
            marks.append(("dedup_plan", td0, self.clock(),
                          {"dedup_rate": round(float(dp.dedup_rate), 4),
                           "n_unique": int(dp.n_unique)}))
        if dp.dedup_rate < plan.dedup_threshold:
            return None
        fn = self.planner.dedup_score_fn(plan)
        fn_comp = (self.planner.comp_dedup_score_fn(plan)
                   if plan.compressed else None)
        tk0 = self.clock()
        if not plan.paged:
            dev = self.index.device
            if (fn_comp is not None and self.index.storage.shard_codec(0)
                    in _codec.DICT_CODECS):
                dict_rows, refs = self.tiles.get_compressed(0)
                out = fn_comp(dict_rows, refs,
                              *dedup_inputs(dp, refs.shape[0], dev, "refs"),
                              range_checked=True)
            else:
                arena = self.tiles.get(0)
                out = fn(arena, *dedup_inputs(dp, arena.shape[0], dev,
                                              "the arena"),
                         range_checked=True)
            slots = out.cpu().numpy()
        else:
            slots = run_paged_dedup(self.tiles, self.planner.shard_plans,
                                    fn, buf, n_valid, fn_comp=fn_comp)
        tk1 = self.clock()
        self._kernel_mark(marks, "dedup_c" if plan.compressed else "dedup",
                          plan, tk0, tk1, rows=int(dp.uniq_rows.shape[0]))
        return slots

    def _kernel_mark(self, marks: Optional[list], method: str, plan,
                     t0: float, t1: float, *, rows: int) -> None:
        """Record one kernel dispatch: trace mark (with the shards the
        tile cache had to stage mid-dispatch) and profiler histogram."""
        moved = gather_bytes(rows, int(self.index.storage.shape[1]))
        if marks is not None:
            tags = {"method": method, "bucket": plan.bucket,
                    "word_block": plan.word_block or 0,
                    "bytes_moved": moved}
            faulted = sorted({s for s, ev, _, _ in self._tile_events
                              if ev == "fault"})
            if faulted:
                tags["faulted_shards"] = faulted
            marks.append(("kernel_score", t0, t1, tags))
        self.profiler.record(
            method=method, bucket=plan.bucket, batch=plan.batch_size,
            seconds=t1 - t0, word_block=plan.word_block or 0,
            term_block=plan.term_block or 0, grid_order=plan.grid_order,
            bytes_moved=moved)

    def score_batch(self, batch: MicroBatch) -> None:
        """Plan, dispatch, and answer one flushed micro-batch."""
        t0 = self.clock()
        Q, B = batch.size, batch.bucket
        traced = any(r.trace is not None for r in batch.requests)
        marks: Optional[list] = [] if traced else None
        self._tile_events = []
        nb = self.index.layout.n_blocks
        tp0 = self.clock()
        # the weakest coverage threshold across the batch is the bound
        # every block must clear for at least one request: the planner's
        # basis for predicting the prune rate (None for all-top-k batches)
        thr_hint = min((r.threshold for r in batch.requests if not r.top_k),
                       default=None)
        plan = self.planner.plan(B, Q, threshold=thr_hint)
        if marks is not None:
            marks.append(("plan", tp0, self.clock(),
                          {"method": plan.method, "fused": int(plan.fused),
                           "paged": int(plan.paged),
                           "pruned": int(plan.pruned)}))
        # a compressed fused dispatch reports as "lookup_c"
        method = ("lookup_c" if plan.compressed and plan.method == "lookup"
                  else plan.method)
        ells = np.array([r.n_terms for r in batch.requests], dtype=np.int32)
        tiles0 = (self.tiles.hits, self.tiles.faults,
                  self.tiles.prefetched, self.tiles.prefetch_hits)
        bytes0 = (self.tiles.raw_bytes_staged, self.tiles.comp_bytes_staged)
        if plan.pruned:
            # chunked branch-and-bound executor: rarest-first term chunks
            # against running counts; blocks whose bound falls below the
            # cutoff skip all further gathers, staging and kernel work
            q_pad = 1 if Q == 1 else _next_pow2(Q)
            buf = np.zeros((q_pad, B, 2), dtype=np.uint32)
            n_valid = np.zeros(q_pad, dtype=np.int32)
            required = np.full(q_pad, np.iinfo(np.int32).max,
                               dtype=np.int64)
            topks = np.zeros(q_pad, dtype=np.int32)
            for i, r in enumerate(batch.requests):
                buf[i, : r.n_terms] = r.terms
                n_valid[i] = r.n_terms
                topks[i] = r.top_k
                required[i] = (0 if r.top_k else
                               coverage_cutoff(r.threshold, r.n_terms))
            method = "lookup_p"
            pstats = PruneStats()
            tk0 = self.clock()
            slots = run_paged_pruned(
                self.tiles, self.planner.shard_plans, buf, n_valid,
                required, topks, n_hashes=self.index.params.n_hashes,
                chunk_terms=plan.chunk_terms or self.config.prune_chunk,
                word_block=plan.word_block, stats=pstats)
            tk1 = self.clock()
            w = int(self.index.storage.shape[1])
            self._kernel_mark(marks, method, plan, tk0, tk1,
                              rows=max(1, pstats.bytes_read // (4 * w)))
            self.metrics.record_prune(
                blocks_total=pstats.blocks_total,
                blocks_pruned=pstats.blocks_pruned,
                tiles_skipped=pstats.shard_visits_skipped,
                bytes_saved=max(
                    0, self._arena_total_bytes - pstats.bytes_read))
            if marks is not None:
                marks.append(("prune", tk0, tk1, {
                    "blocks_pruned": int(pstats.blocks_pruned),
                    "blocks_total": int(pstats.blocks_total),
                    "tiles_skipped": int(pstats.shard_visits_skipped),
                    "bytes_read": int(pstats.bytes_read),
                    "predicted": round(float(plan.predicted_prune), 3)}))
            scores = slots[:Q][:, self._host_slot]
        elif Q == 1:
            buf = np.zeros((B, 2), dtype=np.uint32)
            buf[: ells[0]] = batch.requests[0].terms
            fn = self.planner.single_score_fn(plan)
            fn_comp = (self.planner.comp_single_score_fn(plan)
                       if plan.compressed else None)
            tk0 = self.clock()
            slots = self._run_plan(plan, fn,
                                   _to_device(buf, self.index.device),
                                   int(ells[0]), fn_comp=fn_comp)
            self._kernel_mark(marks, method, plan, tk0, self.clock(),
                              rows=B * nb)
            scores = slots[None, self._host_slot]
        else:
            # the query axis padded to a power of two, as the JAX server
            # pads it; padded queries have n_valid 0 and so no live cell
            q_pad = _next_pow2(Q)
            buf = np.zeros((q_pad, B, 2), dtype=np.uint32)
            for i, r in enumerate(batch.requests):
                buf[i, : r.n_terms] = r.terms
            n_valid = np.zeros(q_pad, dtype=np.int32)
            n_valid[:Q] = ells
            slots = None
            if plan.fused and plan.dedup_threshold is not None:
                slots = self._score_dedup(buf, n_valid, plan, marks)
                if slots is not None:
                    method = "dedup_c" if plan.compressed else "dedup"
            if slots is None:
                fn = self.planner.batch_score_fn(plan)
                fn_comp = (self.planner.comp_batch_score_fn(plan)
                           if plan.compressed else None)
                tk0 = self.clock()
                slots = self._run_plan(
                    plan, fn, _to_device(buf, self.index.device),
                    torch.from_numpy(n_valid).to(self.index.device),
                    fn_comp=fn_comp)
                self._kernel_mark(marks, method, plan, tk0, self.clock(),
                                  rows=q_pad * nb * B)
            scores = slots[:Q][:, self._host_slot]
        t1 = self.clock()
        service = t1 - t0

        if marks is not None:
            # tile stagings seen during this batch's dispatches, as their
            # own spans naming the shard (demand fault or prefetch)
            for s, ev, t_end, dur in self._tile_events:
                marks.append(("tile_fetch", t_end - dur, t_end,
                              {"shard": s, "event": ev}))
        self.planner.record(plan, method)
        self.metrics.record_batch(Q, self.batcher.occupancy(batch), method)
        self.metrics.record_arena_bytes(
            raw=self.tiles.raw_bytes_staged - bytes0[0],
            comp=self.tiles.comp_bytes_staged - bytes0[1])
        if plan.paged:
            self.metrics.record_tiles(
                hits=self.tiles.hits - tiles0[0],
                faults=self.tiles.faults - tiles0[1],
                resident=len(self.tiles),
                prefetched=self.tiles.prefetched - tiles0[2],
                prefetch_hits=self.tiles.prefetch_hits - tiles0[3])
        for i, r in enumerate(batch.requests):
            ts0 = self.clock()
            result = self._select(scores[i], r.n_terms, r.threshold,
                                  r.top_k)
            wait = max(0.0, t0 - r.submitted_at)
            self.metrics.record_request(wait_s=wait, service_s=service)
            resp = QueryResponse(
                r.request_id, Status.OK, result, method=method,
                batch_size=Q, wait_s=wait, service_s=service)
            if r.trace is not None:
                r.trace.add("queue_wait", r.submitted_at, t0,
                            {"flush": batch.reason or "direct",
                             "batch_size": Q})
                for name, ms, me, tags in marks:
                    r.trace.add(name, ms, me, tags)
                r.trace.add("select", ts0, self.clock())
                self.finalize_trace(r.trace, resp)
            self._responses[r.request_id] = resp
            self.results_cache.put(
                result_key(r.terms, r.threshold, r.top_k), result)

    def _answer(self, rid: int, status: Status, result, *, wait: float,
                service: float, trace=None) -> None:
        self.metrics.record_request(wait_s=wait, service_s=service)
        self._responses[rid] = self._finalize(trace, QueryResponse(
            rid, status, result, wait_s=wait, service_s=service))

    # -- serving loop (poll_batches / step / drain / take_response /
    # retract / pop_responses come from ServingBackend) ----------------------
    def reset_metrics(self, *, clear_caches: bool = False) -> None:
        """Fresh counters (drivers call this after warm-up so first-use
        costs stay out of the latency percentiles). clear_caches=True also
        empties the result and row caches, which a warm-up that replays
        the measured workload would otherwise fill."""
        self.metrics = ServingMetrics()
        self.metrics.tracer = self.tracer
        self.profiler.bind_registry(self.metrics.registry)
        self.planner.dispatch_counts.clear()
        if clear_caches:
            self.results_cache = LRUCache(self.results_cache.capacity)
            self.rows_cache = LRUCache(self.rows_cache.capacity)
