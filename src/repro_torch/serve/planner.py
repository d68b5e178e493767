"""Query planner: pick the scoring kernel per micro-batch, the counterpart
of ``repro.serve.planner`` without the autotuner.

The scoring paths (see ``repro_torch.kernels.bitslice_score``):

* ``lookup``   - fused gather + score from row indices; k=1 only. For
  batches this is the multi-query kernel: one launch for the whole
  [Q, nb, L] batch, with no [Q, L, W] gathered intermediate.
* ``dedup``    - the row-dedup pair riding on ``lookup`` plans: a
  unique-row gather, then an indirected score, so arena reads scale with
  the batch's unique rows instead of Q*nb*L. Chosen per batch by
  comparing the batch's dedup rate against the plan's threshold.
* ``vertical`` - Harley-Seal counters over a materialised gather; wins
  for long queries.
* ``unpack``   - the paper's 32-way expansion; the lowest fixed cost, for
  short queries.
* ``ref``      - the plain oracle; never planned.

Compressed dispatch: with ``compressed=True`` and rowdict-coded shards,
batches that plan ``lookup`` score dict-coded shards from their (dict,
refs) device form through the fused-decode kernels when the store's dict
ratio clears ``COMPRESSED_MIN_RATIO``.

The JAX planner can consult measured costs from a ``KernelTuner``; the
port has no tuner yet (ROADMAP A12), so it takes ``tuner=None`` only and
always plans by the shape heuristics below, which are the JAX planner's
own fallback. Given the same (bucket, batch, threshold) it makes the JAX
planner's untuned choice.

A plan is a pure function of (bucket, batch size, threshold); score
functions are built lazily per (method, tile config) and memoised. When
the storage is sharded the plan is marked ``paged`` and carries the
per-shard addressing (``plan_shards``): the server then dispatches once
per shard tile in the device tile cache and concatenates slot scores.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

from ..core.index import BitSlicedIndex
from ..core.query import (ShardPlan, make_batch_score_fn,
                          make_comp_batch_score_fn, make_comp_dedup_score_fn,
                          make_comp_score_fn, make_dedup_score_fn,
                          make_score_fn, plan_shards)

# Below this many (padded) terms the fixed costs dominate and the simple
# unpack expansion is the pick; at or above it, Harley-Seal or the fused
# lookup. Buckets are multiples of term_pad, so it bites at 64-term pads.
SHORT_QUERY_TERMS = 96

# The dedup path fires when at least this fraction of the batch's row
# reads are duplicates.
DEFAULT_DEDUP_MIN_RATE = 0.5

# Compressed (fused-decode) dispatch needs at least this much dict
# compression before the decode indirection is presumed worth the bytes
# it saves.
COMPRESSED_MIN_RATIO = 1.25

# Pruned dispatch needs at least this predicted block-prune rate before the
# chunked executor's extra dispatches are presumed worth the tile I/O and
# kernel work they skip.
DEFAULT_PRUNE_MIN_RATE = 0.5

NO_TUNER = ("the port has no kernel autotuner yet (ROADMAP A12): "
            "pass tuner=None")


def predict_prune_rate(threshold: float, density: float) -> float:
    """Expected fraction of blocks the bound eliminates, from the query
    coverage threshold and the index's mean slice density (set-bit share:
    the v2 manifest's popcount stats when present, else the Bloom FPR).

    Model: a non-matching document's running count grows ~``density`` a
    term, so a block with no real match sits near ``ell * density`` while
    the bound demands ``ell * threshold``; the margin (threshold -
    density) over the headroom (1 - density) is the share of the term
    budget a random block cannot recover. 0 when the threshold is at or
    below the noise floor."""
    if threshold <= density:
        return 0.0
    return float(min(1.0, max(
        0.0, 1.0 - (1.0 - threshold) / max(1e-6, 1.0 - density))))


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Dispatch decision for one micro-batch."""
    method: str        # 'lookup' | 'vertical' | 'unpack'
    bucket: int        # padded term length
    batch_size: int    # live queries in the batch
    fused: bool        # True = one multi-query launch for the whole batch
    paged: bool = False  # True = dispatch per shard tile, then combine
    n_shards: int = 1
    # kernel tile knobs of the JAX planner (validated, no effect here)
    word_block: Optional[int] = None
    term_block: Optional[int] = None
    grid_order: str = "wq"
    # minimum batch dedup rate for the row-dedup path (fused lookup plans
    # only); None disables dedup for this plan
    dedup_threshold: Optional[float] = None
    # True = dict-coded shards score from their (dict, refs) device form
    # through the fused-decode kernels; raw shards keep the raw path
    compressed: bool = False
    # True = the batch runs through the chunked pruned executor
    # (run_paged_pruned) in ``chunk_terms``-term chunks; taken only when
    # ``predicted_prune`` clears the break-even rate
    pruned: bool = False
    chunk_terms: int = 0
    predicted_prune: float = 0.0


def choose_method(n_hashes: int, bucket: int, batch_size: int,
                  short_query_terms: int = SHORT_QUERY_TERMS,
                  costs: Optional[dict] = None) -> str:
    """The kernel-choice rule of the JAX planner. ``costs`` (method ->
    measured cost) switches it from shape heuristics to the measured
    argmin; methods that do not apply to the index (lookup and lookup_c
    with k>1) are ignored, ties break to the alphabetically first method.
    The port's planner never passes costs (it has no tuner)."""
    if costs:
        ok = {m: c for m, c in costs.items()
              if m not in ("lookup", "lookup_c") or n_hashes == 1}
        if ok:
            return min(sorted(ok), key=ok.get)
    if batch_size > 1:
        # batches: the fused multi-query kernel whenever it applies (k=1);
        # otherwise the gather path, the ADD kernel picked by length
        if n_hashes == 1:
            return "lookup"
        return "unpack" if bucket < short_query_terms else "vertical"
    # singletons: short queries take the cheap expansion; long ones the
    # fused gather (k=1) or vertical counters
    if bucket < short_query_terms:
        return "unpack"
    return "lookup" if n_hashes == 1 else "vertical"


class QueryPlanner:
    """Chooses the kernel for each (bucket, batch size) micro-batch, owns
    the memoised score functions of the methods it dispatches and the
    per-shard addressing of sharded storage.

    ``word_block`` is the ServerConfig override of the tile width (carried
    in plans, no effect on the kernels); ``dedup_min_rate`` is the dedup
    threshold (None disables the dedup path); ``compressed`` allows
    fused-decode dispatch against dict-coded shards when the dict ratio
    clears ``COMPRESSED_MIN_RATIO``. ``tuner`` must be None."""

    def __init__(self, index: BitSlicedIndex, *,
                 short_query_terms: int = SHORT_QUERY_TERMS,
                 tuner=None,
                 word_block: Optional[int] = None,
                 dedup_min_rate: Optional[float] = DEFAULT_DEDUP_MIN_RATE,
                 compressed: bool = False,
                 pruned: bool = False, prune_chunk: int = 32,
                 prune_min_rate: Optional[float] = None):
        if tuner is not None:
            raise NotImplementedError(NO_TUNER)
        self.index = index
        self.short_query_terms = short_query_terms
        self.word_block = word_block
        self.dedup_min_rate = dedup_min_rate
        self.pruned_enabled = bool(pruned)
        self.prune_chunk = int(prune_chunk)
        self.prune_min_rate = (DEFAULT_PRUNE_MIN_RATE
                               if prune_min_rate is None
                               else float(prune_min_rate))
        # mean slice density for the prune-rate prediction: the store's
        # popcount stats when recorded, else the configured Bloom FPR
        w = index.storage.shape[1]
        mean_fn = getattr(index.storage, "mean_popcount", None)
        has_fn = getattr(index.storage, "has_popcounts", None)
        if callable(has_fn) and has_fn() and callable(mean_fn) and w:
            self.density = float(mean_fn()) / float(32 * w)
        else:
            self.density = float(index.params.fpr)
        self._k = index.params.n_hashes
        self._single_fns: dict[tuple, object] = {}
        self._batch_fns: dict[tuple, object] = {}
        self._dedup_fns: dict[Optional[int], object] = {}
        self._comp_single_fns: dict[tuple, object] = {}
        self._comp_batch_fns: dict[tuple, object] = {}
        self._comp_dedup_fns: dict[Optional[int], object] = {}
        self.dispatch_counts: Counter[str] = Counter()
        self.n_shards = index.storage.n_shards
        self.shard_plans: list[ShardPlan] = plan_shards(
            index.layout, index.storage.shard_row_starts)
        ratio_fn = getattr(index.storage, "dict_ratio", None)
        self.dict_ratio = ratio_fn() if callable(ratio_fn) else None
        self.compressed_enabled = bool(compressed) and \
            self.dict_ratio is not None

    # -- planning ----------------------------------------------------------
    def plan(self, bucket: int, batch_size: int,
             threshold: Optional[float] = None) -> QueryPlan:
        """Dispatch decision; records nothing. ``threshold`` (the batch's
        weakest coverage threshold) enables the pruned-dispatch decision
        (``lookup_pruned``)."""
        method = choose_method(self._k, bucket, batch_size,
                               self.short_query_terms)
        compressed = (self.compressed_enabled and method == "lookup"
                      and self.dict_ratio >= COMPRESSED_MIN_RATIO)
        fused = batch_size > 1 and method == "lookup"
        dedup = self.dedup_min_rate if fused else None
        if dedup is not None and dedup >= 1.0:
            # unreachable: disable outright, so the server never pays the
            # per-batch host-side dedup planning
            dedup = None
        plan = QueryPlan(method, bucket, batch_size, fused=fused,
                         paged=self.n_shards > 1, n_shards=self.n_shards,
                         word_block=self.word_block,
                         dedup_threshold=dedup, compressed=compressed)
        return self.lookup_pruned(plan, threshold) or plan

    def lookup_pruned(self, plan: QueryPlan,
                      coverage: Optional[float]) -> Optional[QueryPlan]:
        """Upgrade ``plan`` to pruned (chunked, early-exit) dispatch when
        the predicted prune rate clears ``prune_min_rate``, else None.
        ``coverage`` is the batch's weakest coverage threshold (None = a
        top-k-only batch: still pruneable, but with no basis for a
        prediction it stays unpruned)."""
        if (not self.pruned_enabled or coverage is None
                or plan.bucket <= self.prune_chunk):
            return None
        predicted = predict_prune_rate(float(coverage), self.density)
        if self.prune_min_rate >= 1.0 or predicted < self.prune_min_rate:
            return None
        return dataclasses.replace(
            plan, pruned=True, chunk_terms=min(self.prune_chunk, plan.bucket),
            predicted_prune=predicted)

    # -- score-function cache ---------------------------------------------
    def batch_score_fn(self, plan: QueryPlan):
        """score(arena, row_offset, block_width, terms [Q, L, 2], n_valid
        [Q]) -> [Q, n_slots] for this plan's method."""
        key = (plan.method, plan.word_block, plan.term_block,
               plan.grid_order)
        fn = self._batch_fns.get(key)
        if fn is None:
            fn = make_batch_score_fn(self._k, plan.method,
                                     grid_order=plan.grid_order)
            self._batch_fns[key] = fn
        return fn

    def dedup_score_fn(self, plan: QueryPlan):
        """score(arena, uniq_rows, indir, mask) -> [Q, n_slots]: the
        row-dedup pair."""
        fn = self._dedup_fns.get(plan.word_block)
        if fn is None:
            fn = make_dedup_score_fn(word_block=plan.word_block)
            self._dedup_fns[plan.word_block] = fn
        return fn

    def single_score_fn(self, plan: QueryPlan):
        key = (plan.method, plan.word_block, plan.term_block)
        fn = self._single_fns.get(key)
        if fn is None:
            fn = make_score_fn(self._k, plan.method)
            self._single_fns[key] = fn
        return fn

    # -- compressed (fused-decode) twins: same keys, (dict, refs) leading
    # arguments instead of the arena. A compressed plan needs both forms:
    # raw shards in a mixed-codec store keep the raw fn.
    def comp_batch_score_fn(self, plan: QueryPlan):
        key = (plan.method, plan.word_block, plan.term_block,
               plan.grid_order)
        fn = self._comp_batch_fns.get(key)
        if fn is None:
            fn = make_comp_batch_score_fn(self._k, plan.method,
                                          grid_order=plan.grid_order)
            self._comp_batch_fns[key] = fn
        return fn

    def comp_dedup_score_fn(self, plan: QueryPlan):
        fn = self._comp_dedup_fns.get(plan.word_block)
        if fn is None:
            fn = make_comp_dedup_score_fn(word_block=plan.word_block)
            self._comp_dedup_fns[plan.word_block] = fn
        return fn

    def comp_single_score_fn(self, plan: QueryPlan):
        key = (plan.method, plan.word_block, plan.term_block)
        fn = self._comp_single_fns.get(key)
        if fn is None:
            fn = make_comp_score_fn(self._k, plan.method)
            self._comp_single_fns[key] = fn
        return fn

    def record(self, plan: QueryPlan, method: Optional[str] = None) -> None:
        """Count a dispatch; ``method`` overrides the plan's label (the
        server reports 'dedup' when the row-dedup path actually ran)."""
        self.dispatch_counts[method or plan.method] += plan.batch_size

    @property
    def methods_used(self) -> tuple[str, ...]:
        return tuple(sorted(self.dispatch_counts))
