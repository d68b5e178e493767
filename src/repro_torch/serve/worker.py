"""ShardWorker: the per-host half of the sharded serving data plane.

A worker owns a sub-store view (``repro_torch.core.store.open_substore``)
of the shard files its ``ShardPlacement`` replica set assigns to it — it
never maps, stages, or scores any other part of the index. Per dispatch it
receives one micro-batch (padded term buffer + validity counts) and one
GLOBAL shard id from its replica set, scores that shard's tile through the
same CUDA kernels as the single-host engine (kernel choice =
``repro_torch.serve.planner.choose_method``, so the dispatch mix matches),
and compresses the [Q, shard_slots] score plane into per-query CANDIDATES:

* threshold mode — every (doc, score) of its blocks with
  score >= ceil(K * ell) (the paper's coverage cutoff);
* top-k mode    — its k best documents under the engine's exact total
  order (descending score, ties ascending doc id).

Candidate sets are what crosses the host boundary: the frontend gathers
them and runs the final selection, so the gathered result is bit-identical
to the single-host QueryEngine.

Tiles page through a per-worker ``DeviceTileCache`` (device budget per
host) padded to the PARENT store's tallest shard, so every worker's
dispatch shapes coincide with the JAX package's;
``prefetch_shard`` lets the frontend double-buffer the next planned shard
while another worker scores. Each cache stages on its own copy stream; a
consumer thread waits on the tile's copy event on its own current stream
(``DeviceTileCache._hand_out``), so workers may score from several host
threads at once.

``fail()``/``recover()`` flip a liveness flag: a dead worker raises
``AttemptFailed`` on dispatch, which the frontend's HedgedExecutor turns
into failover to the next replica. ``device=None`` means the CUDA card,
with no fallback.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core import codec as _codec
from ..core.arena import DeviceTileCache
from ..core.query import (PruneStats, ShardPlan, _to_device,
                          make_batch_score_fn, make_comp_batch_score_fn,
                          plan_shards_subset, run_paged_pruned)
from ..core.store import open_substore
from ..device import resolve_device
from ..index.hedge import AttemptFailed
from ..obs.profile import gather_bytes
from .planner import (DEFAULT_PRUNE_MIN_RATE, SHORT_QUERY_TERMS,
                      choose_method, predict_prune_rate)

# One score function per (n_hashes, method), shared by every worker in the
# process (the factories' grid_order is left at its default, as the JAX
# worker leaves it). PyTorch runs eagerly, so a score function holds no
# shape: workers padded to their own tallest shard (``local_pad``) share
# them too.
_SCORE_FNS: dict[tuple[int, str], object] = {}
# ... and the fused-decode twins for workers serving compressed shards.
_SCORE_FNS_C: dict[tuple[int, str], object] = {}


def _shared_score_fn(n_hashes: int, method: str):
    fn = _SCORE_FNS.get((n_hashes, method))
    if fn is None:
        fn = _SCORE_FNS[(n_hashes, method)] = make_batch_score_fn(n_hashes,
                                                                  method)
    return fn


def _shared_comp_score_fn(n_hashes: int, method: str):
    fn = _SCORE_FNS_C.get((n_hashes, method))
    if fn is None:
        fn = _SCORE_FNS_C[(n_hashes, method)] = make_comp_batch_score_fn(
            n_hashes, method)
    return fn


class DispatchCancelled(Exception):
    """A dispatch's cancellation flag fired (a hedged duplicate of the
    request already won elsewhere) — the worker stops scoring and the
    RPC plane answers SHARD_CANCELLED instead of a candidate set."""


class ShardWorker:
    """One fake/real host serving a subset of a v2 store's shards."""

    def __init__(self, name: str, store, shard_ids, *,
                 tile_cache_bytes: Optional[int] = None,
                 verify: bool = False, device=None,
                 short_query_terms: int = SHORT_QUERY_TERMS,
                 word_block: Optional[int] = None,
                 compressed: bool = False,
                 pruned: bool = False, prune_chunk: int = 32,
                 prune_min_rate: Optional[float] = None,
                 local_pad: bool = False):
        self.device = resolve_device(device)
        sub = open_substore(store, shard_ids, verify=verify,
                            device=self.device)
        self.name = name
        self.layout = sub.layout            # FULL store layout (metadata)
        self.storage = sub.storage          # only this host's shard files
        self.params = sub.params
        self.shard_ids = sub.shard_ids
        self.short_query_terms = short_query_terms
        # the tile width of every dispatch (ServerConfig.word_block):
        # recorded with each kernel span and handed to the pruned
        # executor; the port's kernels pick their own tiles
        self.word_block = word_block
        # Serve dict-coded shards from their compressed (dict, refs)
        # device form through the fused-decode kernels; raw shards on the
        # same worker keep the raw path. Candidates are bit-identical —
        # only this host's device working set changes.
        self.compressed = bool(compressed)
        self.compressed_dispatches = 0
        self._local = {g: i for i, g in enumerate(self.shard_ids)}
        self.plans: list[ShardPlan] = plan_shards_subset(
            sub.layout, sub.global_row_starts, sub.shard_ids)
        # pad tiles to the PARENT store's tallest shard: one dispatch shape
        # across every worker, not one per host's local maximum.
        # ``local_pad`` instead pads to THIS host's tallest shard — smaller
        # tiles and per-worker dispatch shapes.
        self.local_pad = bool(local_pad)
        if sub.n_shards_total <= 1:
            pad_rows = None
        elif self.local_pad:
            starts = np.asarray(sub.global_row_starts, dtype=np.int64)
            pad_rows = int(max(starts[g + 1] - starts[g]
                               for g in self.shard_ids))
        else:
            pad_rows = int(np.max(np.diff(sub.global_row_starts)))
        # -- pruned (chunked early-exit) candidate scoring ------------------
        self.pruned = bool(pruned)
        self.prune_chunk = int(prune_chunk)
        self.prune_min_rate = (DEFAULT_PRUNE_MIN_RATE
                               if prune_min_rate is None
                               else float(prune_min_rate))
        self.prune_stats = PruneStats()     # cumulative across dispatches
        self.pruned_dispatches = 0
        # cumulative device bytes of the shards pruned dispatches covered —
        # what exhaustive scoring would have staged; bytes saved =
        # baseline - prune_stats.bytes_read
        self.prune_baseline_bytes = 0
        w = int(self.storage.shape[1])
        mean_fn = getattr(self.storage, "mean_popcount", None)
        has_fn = getattr(self.storage, "has_popcounts", None)
        if callable(has_fn) and has_fn() and callable(mean_fn) and w:
            self.density = float(mean_fn()) / float(32 * w)
        else:
            self.density = float(self.params.fpr)
        self.tiles = DeviceTileCache(self.storage,
                                     capacity_bytes=tile_cache_bytes,
                                     pad_rows_to=pad_rows,
                                     device=self.device)
        # global slot -> original doc id (-1 for padding slots); workers
        # translate their slot planes to doc candidates host-side
        n_slots = self.layout.n_blocks * self.layout.block_docs
        self._slot_doc = np.full(n_slots, -1, dtype=np.int64)
        self._slot_doc[self.layout.doc_slot] = np.arange(self.layout.n_docs)
        # per-local-shard device-staged addressing
        self._args = [(p.shard, self._dev(p.row_offset),
                       self._dev(p.block_width)) for p in self.plans]
        self.failed = False
        self.dispatches = 0
        # dispatches abandoned mid-tile because their cancellation flag
        # fired (a hedged duplicate won) — the RPC plane's headline
        # "the loser was observably cancelled" counter
        self.cancelled_tiles = 0
        # Optional KernelProfiler (repro_torch.obs.profile): the frontend
        # wires its own in so per-shard kernel timings land in the shared
        # metrics registry tagged with this worker's dispatches.
        self.profiler = None
        # One dispatch at a time per worker: the frontend's concurrent
        # scatter may land two shards on the same host in parallel, and
        # the counters are not thread-safe. Serializing per worker models
        # one host's device anyway — the overlap win is ACROSS hosts.
        self._lock = threading.Lock()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return _to_device(np.asarray(a), self.device)

    # -- liveness (control plane / test hook) -------------------------------
    def fail(self) -> None:
        self.failed = True

    def recover(self) -> None:
        self.failed = False

    def holds(self, gshard: int) -> bool:
        return gshard in self._local

    # -- staging -------------------------------------------------------------
    def stage_batch(self, terms: np.ndarray, n_valid: np.ndarray):
        """Place one micro-batch's buffers on this worker's device (terms
        as int32 bit patterns). The frontend calls this once per (batch,
        device) and reuses the result across every shard dispatch that
        lands here."""
        return (self._dev(terms),
                self._dev(np.asarray(n_valid, dtype=np.int32)))

    def prefetch_shard(self, gshard: int) -> bool:
        """Double-buffering hook: stage the tile of global shard
        ``gshard`` host->device without blocking (no-op when resident).
        Compressed workers stage the form they will actually score."""
        if self.failed or gshard not in self._local:
            return False
        local = self._local[gshard]
        with self._lock:
            if self._comp_shard(local):
                return self.tiles.prefetch_compressed(local)
            return self.tiles.prefetch(local)

    # -- scoring -------------------------------------------------------------
    def _comp_shard(self, local: int) -> bool:
        return (self.compressed and
                self.storage.shard_codec(local) in _codec.DICT_CODECS)

    def score_shard(self, gshard: int, terms_dev, n_valid_dev
                    ) -> tuple[np.ndarray, ShardPlan, str]:
        """Score one held shard against a staged micro-batch. Returns
        (slot scores int32 [Q, shard_slots], the shard's plan, method)."""
        if self.failed:
            raise AttemptFailed(f"worker {self.name} is down")
        local = self._local.get(gshard)
        if local is None:
            raise AttemptFailed(
                f"worker {self.name} does not hold shard {gshard}")
        self.dispatches += 1
        plan = self.plans[local]
        _, offs, widths = self._args[local]
        q, bucket = int(terms_dev.shape[0]), int(terms_dev.shape[1])
        method = choose_method(self.params.n_hashes, bucket, q,
                               self.short_query_terms)
        t0 = time.perf_counter()
        if self._comp_shard(local):
            self.compressed_dispatches += 1
            dict_rows, refs = self.tiles.get_compressed(local)
            fn = _shared_comp_score_fn(self.params.n_hashes, method)
            slots = fn(dict_rows, refs, offs, widths, terms_dev,
                       n_valid_dev)
        else:
            fn = _shared_score_fn(self.params.n_hashes, method)
            slots = fn(self.tiles.get(local), offs, widths, terms_dev,
                       n_valid_dev)
        slots = slots.cpu().numpy()
        if self.profiler is not None:
            nb_local = int(getattr(plan.row_offset, "shape", (1,))[0])
            self.profiler.record(
                method=method, bucket=bucket, batch=q,
                seconds=time.perf_counter() - t0,
                word_block=self.word_block or 0,
                bytes_moved=gather_bytes(q * nb_local * bucket,
                                         int(self.storage.shape[1])),
                shard=gshard)
        return slots, plan, method

    def _check_cancel(self, cancelled) -> None:
        if cancelled is not None and cancelled():
            self.cancelled_tiles += 1
            raise DispatchCancelled(f"worker {self.name}: dispatch "
                                    f"cancelled between tiles")

    def score_candidates(self, gshard: int, terms_dev, n_valid_dev,
                         cutoffs: np.ndarray, topks: np.ndarray,
                         n_live: int, *, cancelled=None
                         ) -> tuple[list[tuple[np.ndarray, np.ndarray]], str]:
        """Score + select: per live query, the (doc_ids, scores) candidate
        arrays of this shard's documents — hits >= cutoffs[i] when
        topks[i] == 0, else the local top-k under (-score, doc id). Only
        candidates cross the host boundary, O(hits + k) per query instead
        of O(n_docs) — the scatter/gather contract of the frontend.

        With ``pruned`` enabled and the cost model predicting a win, the
        shard dispatch runs through the chunked early-exit executor
        instead: blocks whose bound cannot reach the cutoff skip all
        further gathers and kernel work, a fully-pruned shard never
        stages its tile, and candidates stay bit-identical (pruned
        partial sums are provably below every cutoff)."""
        # ``cancelled`` (optional zero-arg callable) is the RPC plane's
        # cancellation flag: checked before the tile is scored and again
        # before candidate extraction, so a dispatch whose hedged
        # duplicate already won abandons the remaining work and raises
        # DispatchCancelled instead of staging/scanning further.
        self._check_cancel(cancelled)
        with self._lock:
            pr = (self._score_pruned(gshard, terms_dev, n_valid_dev,
                                     cutoffs, topks, n_live)
                  if self.pruned else None)
            if pr is not None:
                slots, plan, method = pr
            else:
                slots, plan, method = self.score_shard(gshard, terms_dev,
                                                       n_valid_dev)
        self._check_cancel(cancelled)
        slot0 = plan.block_start * self.layout.block_docs
        docs = self._slot_doc[slot0: slot0 + slots.shape[1]]
        real = docs >= 0
        docs = docs[real]
        out = []
        for i in range(n_live):
            sc = slots[i][real]
            if topks[i] > 0:
                order = np.lexsort((docs, -sc))[: int(topks[i])]
                out.append((docs[order], sc[order].astype(np.int32)))
            else:
                m = sc >= cutoffs[i]
                out.append((docs[m], sc[m].astype(np.int32)))
        return out, method

    def _score_pruned(self, gshard: int, terms_dev, n_valid_dev,
                      cutoffs: np.ndarray, topks: np.ndarray, n_live: int
                      ) -> Optional[tuple[np.ndarray, ShardPlan, str]]:
        """Chunked early-exit dispatch of one held shard, or None when the
        cost model predicts no win (caller falls back to ``score_shard``).

        Shard-LOCAL top-k pruning is sound here: this worker only reports
        its own shard's top-k candidates, so the dynamic bound needs only
        this shard's running counts. Called under ``self._lock``."""
        if self.failed or gshard not in self._local:
            return None                 # score_shard raises the real error
        bucket = int(terms_dev.shape[1])
        if bucket <= self.prune_chunk:
            return None
        # the executor plans rows on the host: the counts come back here
        n_valid = n_valid_dev.cpu().numpy()
        covs = [cutoffs[i] / max(1, int(n_valid[i]))
                for i in range(n_live) if not topks[i]]
        if not covs:
            return None                 # all-top-k: no static prediction
        predicted = predict_prune_rate(float(min(covs)), self.density)
        break_even = self.prune_min_rate
        chunk = min(self.prune_chunk, bucket)
        if break_even >= 1.0 or predicted < break_even:
            return None
        local = self._local[gshard]
        plan = self.plans[local]
        self.dispatches += 1
        self.pruned_dispatches += 1
        self.prune_baseline_bytes += int(self.storage.shard_hbm_nbytes(local))
        Q = int(terms_dev.shape[0])
        required = np.full(Q, np.iinfo(np.int32).max, dtype=np.int64)
        for i in range(n_live):
            required[i] = 0 if topks[i] else int(cutoffs[i])
        bytes0 = self.prune_stats.bytes_read
        t0 = time.perf_counter()
        # ... and so do the terms, as the uint32 words they are
        terms = terms_dev.cpu().numpy().view(np.uint32)
        slots = run_paged_pruned(
            self.tiles, [plan], terms, n_valid, required,
            np.asarray(topks, dtype=np.int32),
            n_hashes=self.params.n_hashes, chunk_terms=chunk,
            word_block=self.word_block, stats=self.prune_stats)
        if self.profiler is not None:
            self.profiler.record(
                method="lookup_p", bucket=bucket, batch=Q,
                seconds=time.perf_counter() - t0,
                word_block=self.word_block or 0,
                bytes_moved=self.prune_stats.bytes_read - bytes0,
                shard=gshard)
        return slots, plan, "lookup_p"
