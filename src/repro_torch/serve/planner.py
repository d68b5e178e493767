"""Query planner: pick the scoring kernel per micro-batch, the counterpart
of ``repro.serve.planner``.

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
refs) device form through the fused-decode kernels (``lookup_c`` in the
tuner's cost table) when the measured decode-in-the-loop cost wins, or,
unmeasured, when the store's dict ratio clears ``COMPRESSED_MIN_RATIO``.

Method choice consults measured costs when a ``KernelTuner`` is wired in
(``repro_torch.kernels.autotune``): per (bucket, batch) it returns each
method's cost, the tile knobs the JAX planner carries (``word_block``,
``term_block``, ``grid_order``; the port's kernels ignore them) and the
dedup-rate and prune-rate break-evens, all persisted in the on-disk
tuning cache. Without a tuner, or on a miss of a read-only one, the shape
heuristics below apply. Given the same tuning entries and the same
(bucket, batch, threshold), the port makes the JAX planner's plan.

A plan is a pure function of (bucket, batch size, threshold) and the
tuner's entries; score functions are built lazily per (kind, method,
tile config) and memoised, a raw function and its dict twin together.
The planner keeps the per-shard addressing (``plan_shards``; dense storage
is one shard) that the server's one shard loop (``score_shards``)
dispatches over; a plan over sharded storage is marked ``paged``.
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
from ..kernels.autotune import KernelTuner

# Below this many (padded) terms the fixed costs dominate and the simple
# unpack expansion is the pick; at or above it, Harley-Seal or the fused
# lookup. Buckets are multiples of term_pad, so it bites at 64-term pads.
SHORT_QUERY_TERMS = 96

# Without measured costs, the dedup path fires when at least this fraction
# of the batch's row reads are duplicates (a measured break-even from the
# tuner overrides it).
DEFAULT_DEDUP_MIN_RATE = 0.5

# Without measured costs, compressed (fused-decode) dispatch needs at
# least this much dict compression before the decode indirection is
# presumed worth the bytes it saves; a measured lookup-vs-lookup_c argmin
# overrides it.
COMPRESSED_MIN_RATIO = 1.25

# Without a measured break-even (the tuner's "lookup_p" entry), pruned
# dispatch needs at least this predicted block-prune rate before the
# chunked executor's extra dispatches are presumed worth the tile I/O and
# kernel work they skip.
DEFAULT_PRUNE_MIN_RATE = 0.5


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
    # tuned kernel knobs of the JAX planner (None = kernel defaults;
    # carried and validated, no effect on the port's kernels)
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
    "lookup_c" (the fused-decode kernel) competes on equal footing: it
    wins only when its measured cost, decode included, beats every raw
    path."""
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

    ``tuner`` wires in measured method costs and break-evens (see the
    module docstring); ``word_block`` is the ServerConfig override of the
    tile width (carried in plans, no effect on the kernels);
    ``dedup_min_rate`` is the dedup threshold when no measured break-even
    exists (None disables the dedup path); ``compressed`` allows
    fused-decode dispatch against dict-coded shards, taken when the index
    has such shards and either the tuner's measured lookup_c cost wins the
    argmin or, unmeasured, the dict ratio clears
    ``COMPRESSED_MIN_RATIO``."""

    def __init__(self, index: BitSlicedIndex, *,
                 short_query_terms: int = SHORT_QUERY_TERMS,
                 tuner: Optional[KernelTuner] = None,
                 word_block: Optional[int] = None,
                 dedup_min_rate: Optional[float] = DEFAULT_DEDUP_MIN_RATE,
                 compressed: bool = False,
                 pruned: bool = False, prune_chunk: int = 32,
                 prune_min_rate: Optional[float] = None):
        self.index = index
        self.short_query_terms = short_query_terms
        self.tuner = tuner
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
        self._score_fns: dict[tuple, tuple] = {}
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
        """Dispatch decision; records nothing. Consults the tuner's measured
        costs when present, falling back to shape heuristics on misses
        (a read-only tuner never measures in the serving path).
        ``threshold`` (the batch's weakest coverage threshold) enables the
        pruned-dispatch decision (``lookup_pruned``)."""
        coverage = threshold
        entries = (self.tuner.costs(bucket, batch_size)
                   if self.tuner is not None else {})
        if not self.compressed_enabled:
            # never dispatch fused-decode when compressed serving is off,
            # even if a tuned lookup_c cost exists in a shared cache
            entries.pop("lookup_c", None)
        costs = {m: e.cost_us for m, e in entries.items()}
        method = choose_method(self._k, bucket, batch_size,
                               self.short_query_terms, costs=costs)
        compressed = method == "lookup_c"
        if compressed:
            method = "lookup"     # lookup_c is the fused lookup, decoded
            tuned = entries.get("lookup_c")
        else:
            tuned = entries.get(method)
            # no measured comparison for this shape: the dict-ratio
            # heuristic decides whether decoding pays
            if (self.compressed_enabled and method == "lookup"
                    and "lookup_c" not in entries
                    and self.dict_ratio >= COMPRESSED_MIN_RATIO):
                compressed = True
        word_block = (self.word_block if self.word_block is not None
                      else (tuned.word_block if tuned else None))
        term_block = tuned.term_block if tuned else None
        grid_order = tuned.grid_order if tuned else "wq"
        fused = batch_size > 1 and method == "lookup"
        threshold = None
        if fused:
            threshold = (tuned.dedup_threshold
                         if tuned is not None and
                         tuned.dedup_threshold is not None
                         else self.dedup_min_rate)
            if threshold is not None and threshold >= 1.0:
                # unreachable (the tuner's 2.0 "measured, never wins"
                # sentinel included): disable outright, so the server never
                # pays the per-batch host-side dedup planning
                threshold = None
        plan = QueryPlan(method, bucket, batch_size, fused=fused,
                         paged=self.n_shards > 1, n_shards=self.n_shards,
                         word_block=word_block, term_block=term_block,
                         grid_order=grid_order, dedup_threshold=threshold,
                         compressed=compressed)
        return self.lookup_pruned(plan, coverage) or plan

    def lookup_pruned(self, plan: QueryPlan,
                      coverage: Optional[float]) -> Optional[QueryPlan]:
        """Upgrade ``plan`` to pruned (chunked, early-exit) dispatch when
        the predicted prune rate clears the break-even, else None.
        ``coverage`` is the batch's weakest coverage threshold (None = a
        top-k-only batch: still pruneable, but with no basis for a
        prediction it stays unpruned). The break-even is the tuner's
        measured "lookup_p" entry's ``dedup_threshold`` (the minimum prune
        rate at which the chunked executor wins; 2.0 = measured, never
        wins) when one exists, else ``prune_min_rate``; that entry also
        gives the chunk size and word_block."""
        if (not self.pruned_enabled or coverage is None
                or plan.bucket <= self.prune_chunk):
            return None
        predicted = predict_prune_rate(float(coverage), self.density)
        break_even = self.prune_min_rate
        chunk = min(self.prune_chunk, plan.bucket)
        word_block = plan.word_block
        if self.tuner is not None:
            e = self.tuner.entry("lookup_p", plan.bucket, plan.batch_size)
            if e is not None:
                if e.dedup_threshold is not None:
                    break_even = e.dedup_threshold
                chunk = min(e.term_block or chunk, plan.bucket)
                if self.word_block is None:
                    word_block = e.word_block
        if break_even >= 1.0 or predicted < break_even:
            return None
        return dataclasses.replace(
            plan, pruned=True, chunk_terms=chunk, word_block=word_block,
            predicted_prune=predicted)

    # -- score-function cache ---------------------------------------------
    def score_fns(self, plan: QueryPlan, kind: str):
        """``plan``'s (raw, dict) score functions of ``kind``: "single"
        (terms [L, 2] -> [n_slots]), "batch" (terms [Q, L, 2], n_valid [Q]
        -> [Q, n_slots]) or "dedup" (the row-dedup pair over a shard's
        unique rows). The dict twin takes a shard's (dict, refs) pair in
        place of its tile and is None unless the plan is compressed (raw
        shards of a mixed-codec store keep the raw function). Built on
        first use and kept, a pair per kind and plan knobs."""
        key = (kind, plan.method, plan.word_block, plan.term_block,
               plan.grid_order)
        fns = self._score_fns.get(key)
        if fns is None:
            k, m, wb, go = (self._k, plan.method, plan.word_block,
                            plan.grid_order)
            fns = self._score_fns[key] = {
                "single": lambda: (make_score_fn(k, m),
                                   make_comp_score_fn(k, m)),
                "batch": lambda: (
                    make_batch_score_fn(k, m, grid_order=go),
                    make_comp_batch_score_fn(k, m, grid_order=go)),
                "dedup": lambda: (make_dedup_score_fn(word_block=wb),
                                  make_comp_dedup_score_fn(word_block=wb)),
            }[kind]()
        return fns if plan.compressed else (fns[0], None)

    def record(self, plan: QueryPlan, method: Optional[str] = None) -> None:
        """Count a dispatch; ``method`` overrides the plan's label (the
        server reports 'dedup' when the row-dedup path actually ran)."""
        self.dispatch_counts[method or plan.method] += plan.batch_size

    @property
    def methods_used(self) -> tuple[str, ...]:
        return tuple(sorted(self.dispatch_counts))
