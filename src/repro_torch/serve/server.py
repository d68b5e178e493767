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

Dispatch. Every exhaustive batch, fused or dedup, runs one loop over the
store's shards (``core.query.score_shards``): a launch a shard, each
shard's scores copied into its columns of the dispatch's one buffer on
the device, and dense storage the one-shard case, whose one part is the
dispatch's scores as they are. A k = 1 lookup dispatch scores every raw
shard resident at its start in one grouped launch (each term's row hashed
and planned in the kernel, over the tile cache's block table, kept while
residency stays) into that buffer.

Selection. An exhaustive dispatch selects each request's hits on the
index's device (``select_scores``: slot order to document order, the
coverage cutoff, the hits compacted) and copies back only the hit lists,
through a pinned staging buffer. A request with ``top_k`` or with more
than ``SELECT_CAP`` hits takes its own score row to the host instead, and
pruned and point queries select on the host as before; every path gives
``select_hits``'s / ``select_top_k``'s result. ``serve_select_card_total``
and ``serve_select_host_total`` (by reason) count the requests of each.

Out of core. A sharded (mapped) index pages its shards through a
``DeviceTileCache`` of ``tile_cache_bytes``; ``warm_tiles``, called when
the store opens, stages tiles up to that budget (otherwise they are
staged on first use). The shard loop of a paged batch reaches each shard
as ``core.query.RowGatherRoute`` says: a resident tile is scored on the
card, a shard that is not resident has the batch's unique rows read from
the mapped store and scored by the dedup kernel, and a tile is staged
only where it fits without evicting one or the batch's rows cost as much
as the tile. ``tile_gathers`` (a ``GatherStats``) and the registry
(``serve_tile_rows_gathered_total``, ``serve_tile_gathered_bytes_total``,
``serve_tile_gather_seconds``, ``serve_shard_visits_total{route}``)
count what the route did.

The server is single-threaded and clock-injectable: drivers decide the
cadence (closed-loop drivers call ``drain``, open-loop ones ``step`` on
arrival timestamps), and tests run on a virtual clock. Every kernel span
ends after the scores (for an exhaustive dispatch, the hits selected from
them) are on the host, so the kernel profiler's times are host times from the
terms' upload through that copy, not launch times and not the kernels'
device time alone. ``obs.trace.span`` times
each stage: into the traced requests' marks, and into ``repro.<stage>``
ranges while a torch profiler runs (``repro.score_batch`` around a batch,
with ``repro.plan``, ``repro.stage``, ``repro.launch``, ``repro.copy`` and
``repro.select`` inside; ``repro.permute`` inside ``repro.select`` wherever
score rows reach the host).

With ``ServerConfig.autotune`` or ``tuning_cache`` the planner plans from
a ``KernelTuner``'s costs measured on the server's device and persisted to
disk (a reopened server plans from the file without re-tuning), and the
kernel profiler feeds live costs back into it, as in the JAX server. It
differs from the JAX server in three deliberate ways: its tile cache does
not pad tiles to a common height (PyTorch runs eagerly, so padding would
only cost bytes), it selects an exhaustive batch's hits on the device
(the JAX server selects in numpy; the answers are equal), and its dedup
gate reads a batch's rate off an exact count of its unique rows, planning
the rows, shard by shard, only of a batch that takes the dedup pair (the
JAX server plans every gated batch; the rate, and so the dispatch, is
equal). ``serve_dedup_plan_total{outcome}`` counts the batches planned and
skipped.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from ..core import hashing
from ..core.arena import DeviceTileCache
from ..core.index import BitSlicedIndex
from ..core.query import (GatherStats, PruneStats, RowGatherRoute,
                          SearchResult, _pad_unique, _to_device,
                          compile_pattern, count_dedup_batch,
                          coverage_cutoff, dedup_rate, grouped_form,
                          run_paged_dedup, run_paged_pruned, score_shards,
                          select_hits, select_top_k, shard_addressing)
from ..device import resolve_device
from ..kernels.autotune import KernelTuner, TuningCache
from ..kernels.bitslice_score import select_scores
from ..obs import EventLog, KernelProfiler, Tracer
from ..obs.profile import gather_bytes
from ..obs.trace import span
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
    # The JAX kernels' tile width: None = the tuner's choice when tuning
    # is wired in. Carried in plans, validated by the dedup path, no
    # effect on the port's kernels.
    word_block: Optional[int] = None
    # Row-dedup path: minimum fraction of a batch's row reads that must be
    # duplicates before the dedup pair replaces the fused multi-query
    # kernel. None disables dedup; a tuner-measured break-even overrides
    # this default.
    dedup_min_rate: Optional[float] = DEFAULT_DEDUP_MIN_RATE
    # Serve dict-coded shards from their compressed (dict, refs) device
    # form through the fused-decode kernels (the planner decides per batch
    # shape: measured lookup-vs-lookup_c cost, else the dict ratio); raw
    # shards are unaffected.
    compressed: bool = False
    # Threshold-driven pruned scoring through the chunked early-exit
    # executor, when the planner predicts enough block pruning; results
    # equal unpruned scoring either way.
    pruned: bool = False
    prune_chunk: int = 32
    # Minimum predicted block-prune rate before pruned dispatch, when no
    # measured break-even exists (None = planner.DEFAULT_PRUNE_MIN_RATE).
    prune_min_rate: Optional[float] = None
    # Tune kernel dispatch on demand per batch shape (costs measured on the
    # card drive the planner; entries persist in tuning_cache). False with
    # a tuning_cache still consults existing entries and never measures.
    autotune: bool = False
    # Path of the persisted tuning cache (JSON; by convention
    # repro_torch.core.store.tuning_path(store_dir), beside the v2
    # manifest). None keeps tuned entries in memory only.
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
    # metrics registry and (when a tuner is wired) back into the tuning
    # cache as live observed-cost entries.
    profile_kernels: bool = True


# Most hits a request's list brings back from an exhaustive dispatch. The
# lists of a batch come back whole (Q * (1 + 2 * SELECT_CAP) int32: 262 KB at
# 32 requests); a request with more hits copies its own score row.
SELECT_CAP = 1024
# the cutoff of a request the device does not select for (top-k, no terms)
_NO_CUT = np.iinfo(np.int32).max


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _CardHits:
    """An exhaustive dispatch's selection: its scores [>= Q, n_slots] in
    slot order, left on the index's device for the requests that take the host
    path, and each live request's hit list as ``select_scores`` wrote it
    ([Q, 1 + 2 * cap]), on the host in the server's staging buffer."""
    scores: torch.Tensor
    lists: np.ndarray


class QueryServer(ServingBackend):
    """The single-host server over ``index`` on ``device`` (None = the
    CUDA card; raises when the index lives elsewhere)."""

    def __init__(self, index: BitSlicedIndex,
                 config: ServerConfig = ServerConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.device = resolve_device(device)
        if index.device.type != self.device.type or (
                self.device.index is not None
                and index.device.index != self.device.index):
            raise ValueError(f"the index lives on {index.device}, the server "
                             f"on {self.device}")
        self.index = index
        self.config = config
        self.clock = clock
        # tuned dispatch: with a cache path, entries load from disk and
        # serving never re-tunes what is measured; autotune=True also
        # measures misses on demand, on the index's device
        self.tuner: Optional[KernelTuner] = None
        if config.autotune or config.tuning_cache:
            self.tuner = KernelTuner.for_index(
                index, TuningCache(config.tuning_cache),
                enabled=config.autotune)
        self.planner = QueryPlanner(index, tuner=self.tuner,
                                    word_block=config.word_block,
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
        # select_scores reads the index's resident doc_slot without its
        # range check (a device sync a batch) once the host has checked it
        self._slots_checked = bool(
            self._host_slot.size == 0
            or (self._host_slot.min() >= 0
                and self._host_slot.max() < index.layout.n_slots))
        # where a batch's hit lists land on the host (one batch at a time:
        # score_batch is not reentrant); pinned for the card's async copy
        self._staging = torch.empty(
            config.max_batch * (1 + 2 * SELECT_CAP), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        # Out-of-core serving state: shard tiles page onto the device
        # through a bounded LRU (unpadded, as the port's QueryEngine's);
        # dense storage is one "shard", the resident arena.
        self.tiles = DeviceTileCache(index.storage,
                                     capacity_bytes=config.tile_cache_bytes)
        self._addressing = shard_addressing(self.planner.shard_plans,
                                            index.device)
        # what the row-gather route of paged batches did, over the
        # server's life
        self.tile_gathers = GatherStats()
        # -- observability ---------------------------------------------------
        self.events = EventLog(config.trace_log,
                               ring=max(64, config.trace_ring))
        self.tracer = Tracer(enabled=config.tracing,
                             ring=config.trace_ring,
                             slow_ms=config.trace_slow_ms,
                             sink=self.events, clock=clock)
        self.metrics.tracer = self.tracer
        self.profiler = KernelProfiler(self.metrics.registry, self.tuner,
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

    def warm_tiles(self) -> list[int]:
        """Stage the shards' tiles, smallest first, that fit in the tile
        cache's budget without evicting one (every tile of an unbounded
        cache), as a deployment warms its cache when it opens a store;
        dict-coded shards in their (dict, refs) form when the server
        serves compressed. Every batch visits every shard and reads about
        as many rows of each, so the budget spares the most row gathers
        when it holds the most tiles. The pages of the shards left on the
        host are then mapped (``MappedArena.prefault``), so that the
        row-gather route's first reads do not fault them in one by one.
        Dense storage stages nothing. Returns the shards staged."""
        st = self.index.storage
        if st.n_shards < 2:
            return []
        comp = self.planner.compressed_enabled

        def dict_form(s: int) -> bool:
            return self.tiles.dict_form(s, comp)

        order = sorted(range(st.n_shards),
                       key=lambda s: self.tiles.form_nbytes(s, dict_form(s)))
        staged = self.tiles.warm(order, compressed=dict_form)
        if hasattr(st, "prefault"):
            for s in order:
                if not self.tiles.resident(s, dict_form(s)):
                    st.prefault(s)
        return staged

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
        self.metrics.record_select("point")
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
    def _cutoffs(self, requests) -> torch.Tensor:
        """Each request's integer coverage cutoff on the index's device,
        ``_NO_CUT`` where the device selects nothing (top-k, no terms)."""
        cut = np.array([_NO_CUT if r.top_k or not r.n_terms else
                        min(coverage_cutoff(r.threshold, r.n_terms), _NO_CUT)
                        for r in requests], dtype=np.int32)
        return torch.from_numpy(cut).to(self.index.device)

    def _card_hits(self, out: torch.Tensor, cut_dev: torch.Tensor,
                   seq: Optional[int]) -> _CardHits:
        """The tail of an exhaustive dispatch: the live requests' hits
        selected from ``out`` on the index's device, then their lists
        copied, the batch's one copy to the host, into the staging
        buffer."""
        scores = out.view(1, -1) if out.dim() == 1 else out
        with span("launch", seq=seq):
            lists = select_scores(scores, self.index.doc_slot, cut_dev,
                                  SELECT_CAP,
                                  range_checked=self._slots_checked)
        with span("copy", seq=seq):
            host = self._staging[: lists.numel()].view(lists.shape)
            host.copy_(lists, non_blocking=True)
            if lists.is_cuda:
                torch.cuda.current_stream(lists.device).synchronize()
        return _CardHits(scores, host.numpy())

    def _route(self, plan, buf: np.ndarray, n_valid: np.ndarray, *,
               single: bool = False) -> RowGatherRoute:
        """How a paged batch (host terms ``buf``, counts ``n_valid``)
        reaches each shard; its counts go to ``tile_gathers`` and the registry
        once the batch is scored (``_record_route``)."""
        return RowGatherRoute(self.tiles, self.planner.shard_plans, buf,
                              n_valid, n_hashes=self.index.params.n_hashes,
                              compressed=plan.compressed, single=single)

    def _record_route(self, route: Optional[RowGatherRoute]) -> None:
        if route is not None:
            self.tile_gathers.merge(route.stats)
            self.metrics.record_tile_route(route.stats)

    def _run_plan(self, plan, kind: str, terms_dev, valid_dev, cut_dev, *,
                  seq: Optional[int], route=None):
        """Dispatch ``plan``'s (raw, dict) score functions of ``kind`` over
        every shard (``score_shards``; dense storage is one shard, and a
        k = 1 lookup groups the resident raw shards), as ``route`` says
        for a paged plan. Returns the dispatch's hits, selected on the
        device against ``cut_dev``."""
        out = score_shards(
            self.tiles, self.planner.shard_plans,
            *self.planner.score_fns(plan, kind),
            lambda i, rows: (*self._addressing[i], terms_dev, valid_dev),
            route=route, seq=seq,
            grouped=grouped_form(self.index.params.n_hashes, plan.method))
        return self._card_hits(out, cut_dev, seq)

    def _score_dedup(self, buf: np.ndarray, n_valid: np.ndarray, plan,
                     cut_dev: Optional[torch.Tensor],
                     marks: Optional[list] = None, seq: Optional[int] = None):
        """Row-dedup dispatch, or None when the batch's dedup rate is
        below the plan's threshold. The rate is the plan's, counted by
        ``count_dedup_batch`` without the plan; a batch past the gate is
        then planned per shard against the rebased addressing
        (``run_paged_dedup``; the shards the row-gather route reaches, at
        once), and selects its hits on the device against ``cut_dev``.
        ``marks`` collects (name, start, end, tags) stage timings for
        tracing."""
        layout = self.index.layout
        with span("dedup_plan", marks, clock=self.clock, seq=seq) as sp:
            n_unique, n_gathers = count_dedup_batch(
                buf, n_valid, layout.row_offset, layout.block_width)
            rate = dedup_rate(n_unique, n_gathers)
            past = rate >= plan.dedup_threshold
            self.metrics.record_dedup_plan(past)
            if marks is not None:
                sp.tags = {"dedup_rate": round(float(rate), 4),
                           "n_unique": n_unique, "built": int(past)}
        if not past:
            return None
        fn, fn_dict = self.planner.score_fns(plan, "dedup")
        with span("kernel_score", marks, clock=self.clock, seq=seq) as ks:
            tk0 = self.clock()
            route = self._route(plan, buf, n_valid) if plan.paged else None
            slots = self._card_hits(
                run_paged_dedup(self.tiles, self.planner.shard_plans, fn,
                                buf, n_valid, fn_comp=fn_dict, route=route,
                                to_host=False, seq=seq),
                cut_dev, seq)
            self._record_route(route)
            self._kernel_mark(ks, marks,
                              "dedup_c" if plan.compressed else "dedup",
                              plan, tk0, self.clock(),
                              rows=_pad_unique(n_unique))
        return slots

    def _kernel_mark(self, ks, marks: Optional[list], method: str, plan,
                     t0: float, t1: float, *, rows: int) -> None:
        """Record one kernel dispatch: the tags of its ``kernel_score``
        span ``ks`` (with the shards the tile cache had to stage
        mid-dispatch), profiler histogram, and the live cost signal for
        the tuner."""
        moved = gather_bytes(rows, int(self.index.storage.shape[1]))
        if marks is not None:
            tags = {"method": method, "bucket": plan.bucket,
                    "word_block": plan.word_block or 0,
                    "bytes_moved": moved}
            faulted = sorted({s for s, ev, _, _ in self._tile_events
                              if ev == "fault"})
            if faulted:
                tags["faulted_shards"] = faulted
            ks.tags = tags
        self.profiler.record(
            method=method, bucket=plan.bucket, batch=plan.batch_size,
            seconds=t1 - t0, word_block=plan.word_block or 0,
            term_block=plan.term_block or 0, grid_order=plan.grid_order,
            bytes_moved=moved)

    def score_batch(self, batch: MicroBatch) -> None:
        """Plan, dispatch, and answer one flushed micro-batch."""
        with span("score_batch", seq=batch.seq):
            self._score_batch(batch)

    def _score_batch(self, batch: MicroBatch) -> None:
        t0 = self.clock()
        Q, B, seq = batch.size, batch.bucket, batch.seq
        traced = any(r.trace is not None for r in batch.requests)
        marks: Optional[list] = [] if traced else None
        self._tile_events = []
        nb = self.index.layout.n_blocks
        # the weakest coverage threshold across the batch is the bound
        # every block must clear for at least one request: the planner's
        # basis for predicting the prune rate (None for all-top-k batches)
        thr_hint = min((r.threshold for r in batch.requests if not r.top_k),
                       default=None)
        with span("plan", marks, clock=self.clock, seq=seq) as sp:
            plan = self.planner.plan(B, Q, threshold=thr_hint)
            if marks is not None:
                sp.tags = {"method": plan.method, "fused": int(plan.fused),
                           "paged": int(plan.paged),
                           "pruned": int(plan.pruned)}
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
            with span("stage", seq=seq):
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
            with span("prune", marks, clock=self.clock, seq=seq) as pr:
                with span("kernel_score", marks, clock=self.clock,
                          seq=seq) as ks:
                    tk0 = self.clock()
                    # the executor's own uploads and copies lie inside
                    with span("launch", seq=seq):
                        slots = run_paged_pruned(
                            self.tiles, self.planner.shard_plans, buf,
                            n_valid, required, topks,
                            n_hashes=self.index.params.n_hashes,
                            chunk_terms=(plan.chunk_terms
                                         or self.config.prune_chunk),
                            word_block=plan.word_block, stats=pstats)
                    tk1 = self.clock()
                    w = int(self.index.storage.shape[1])
                    self._kernel_mark(
                        ks, marks, method, plan, tk0, tk1,
                        rows=max(1, pstats.bytes_read // (4 * w)))
                self.metrics.record_prune(
                    blocks_total=pstats.blocks_total,
                    blocks_pruned=pstats.blocks_pruned,
                    tiles_skipped=pstats.shard_visits_skipped,
                    bytes_saved=max(
                        0, self._arena_total_bytes - pstats.bytes_read))
                if marks is not None:
                    pr.tags = {
                        "blocks_pruned": int(pstats.blocks_pruned),
                        "blocks_total": int(pstats.blocks_total),
                        "tiles_skipped": int(pstats.shard_visits_skipped),
                        "bytes_read": int(pstats.bytes_read),
                        "predicted": round(float(plan.predicted_prune), 3)}
        elif Q == 1:
            with span("stage", seq=seq):
                buf = np.zeros((B, 2), dtype=np.uint32)
                buf[: ells[0]] = batch.requests[0].terms
            with span("kernel_score", marks, clock=self.clock,
                      seq=seq) as ks:
                tk0 = self.clock()
                with span("stage", seq=seq):
                    terms_dev = _to_device(buf, self.index.device)
                    cut_dev = self._cutoffs(batch.requests)
                route = (self._route(plan, buf[None], ells[:1], single=True)
                         if plan.paged else None)
                slots = self._run_plan(plan, "single", terms_dev,
                                       int(ells[0]), cut_dev, seq=seq,
                                       route=route)
                self._record_route(route)
                self._kernel_mark(ks, marks, method, plan, tk0, self.clock(),
                                  rows=B * nb)
        else:
            # the query axis padded to a power of two, as the JAX server
            # pads it; padded queries have n_valid 0 and so no live cell
            with span("stage", seq=seq):
                q_pad = _next_pow2(Q)
                buf = np.zeros((q_pad, B, 2), dtype=np.uint32)
                for i, r in enumerate(batch.requests):
                    buf[i, : r.n_terms] = r.terms
                n_valid = np.zeros(q_pad, dtype=np.int32)
                n_valid[:Q] = ells
                cut_dev = self._cutoffs(batch.requests)
            slots = None
            if plan.fused and plan.dedup_threshold is not None:
                slots = self._score_dedup(buf, n_valid, plan, cut_dev,
                                          marks, seq)
                if slots is not None:
                    method = "dedup_c" if plan.compressed else "dedup"
            if slots is None:
                with span("kernel_score", marks, clock=self.clock,
                          seq=seq) as ks:
                    tk0 = self.clock()
                    with span("stage", seq=seq):
                        terms_dev = _to_device(buf, self.index.device)
                        valid_dev = torch.from_numpy(n_valid).to(
                            self.index.device)
                    route = (self._route(plan, buf, n_valid)
                             if plan.paged else None)
                    slots = self._run_plan(plan, "batch", terms_dev,
                                           valid_dev, cut_dev, seq=seq,
                                           route=route)
                    self._record_route(route)
                    self._kernel_mark(ks, marks, method, plan, tk0,
                                      self.clock(), rows=q_pad * nb * B)
        # the host tail: each request's result from its hit list, or from
        # its score row in document order, then its response and cache entry
        with span("select", seq=seq):
            if isinstance(slots, _CardHits):
                host = ["top_k" if r.top_k else
                        "overflow" if slots.lists[i, 0] > SELECT_CAP else None
                        for i, r in enumerate(batch.requests)]
            else:
                with span("permute", seq=seq):
                    scores = slots[:Q][:, self._host_slot]
                host = ["pruned"] * Q
            n_host = Q - host.count(None)
            if n_host < Q:
                self.metrics.record_select("card", Q - n_host)
            for reason, n in Counter(filter(None, host)).items():
                self.metrics.record_select(reason, n)
            sel_tags = {"card": Q - n_host, "host": n_host}
            t1 = self.clock()
            service = t1 - t0

            if marks is not None:
                # tile stagings seen during this batch's dispatches, as
                # their own spans naming the shard (demand fault or
                # prefetch)
                for s, ev, t_end, dur in self._tile_events:
                    marks.append(("tile_fetch", t_end - dur, t_end,
                                  {"shard": s, "event": ev}))
            self.planner.record(plan, method)
            self.metrics.record_batch(Q, self.batcher.occupancy(batch),
                                      method)
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
                if not isinstance(slots, _CardHits):
                    result = self._select(scores[i], r.n_terms, r.threshold,
                                          r.top_k)
                elif host[i]:
                    with span("permute", seq=seq):
                        row = slots.scores[i].cpu().numpy()[self._host_slot]
                    result = self._select(row, r.n_terms, r.threshold,
                                          r.top_k)
                else:
                    # the host's selection over the device's hits, which
                    # are in document order: its cutoff keeps them all and
                    # its stable sort gives select_hits's order; positions
                    # in the list map back to documents
                    n = int(slots.lists[i, 0])
                    pairs = slots.lists[i, 1:1 + 2 * n].reshape(n, 2)
                    sub = self._select(pairs[:, 1], r.n_terms, r.threshold,
                                       0)
                    result = dataclasses.replace(
                        sub, doc_ids=pairs[sub.doc_ids, 0])
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
                    r.trace.add("select", ts0, self.clock(), sel_tags)
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
