"""Query processing (paper Fig. 3): HASH -> GATHER rows -> AND -> ADD ->
select, the counterpart of ``repro.core.query``.

The engine takes packed terms (uint32 [L, 2]) with a validity count,
scores every document slot on the index's device through the kernels in
``repro_torch.kernels``, and applies the coverage threshold K: the share
of the query's distinct q-grams that must hit a document for it to be
reported. Planning (term compilation, padding, threshold math, hit
selection) stays in pure numpy functions, with the same stable sorts as the
reference, so results are bit-identical to the JAX ``QueryEngine``.

Out-of-core indexes (storage of more than one shard, a ``MappedArena``
over a cobs-jax-v2 store) run paged: ``plan_shards`` rebases each shard's
block row offsets to the shard's first row, the engine pages one shard at
a time to the device through a ``DeviceTileCache`` (prefetching the next
while the current one is scored) and concatenates the per-shard slot
scores in shard order, which is the global slot order. With
``compressed=True``, rowdict-coded shards stay in their (dict, refs) form
on the device and are scored by the fused-decode kernels.

Batches whose queries share rows can run through the row-dedup pair
(``plan_dedup_batch``, ``run_paged_dedup``): each unique row of the batch is
gathered once, then every cell is scored through an indirection into those
rows. The single-host ``QueryServer`` picks it per batch.

Two executors score terms in chunks into running counts on the device:
``run_paged_pruned`` (the engine's ``*_pruned`` searches) drops blocks
that can no longer reach their cutoff, and ``run_shard_major`` stages
each shard once and sweeps a whole query set against it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import codec as _codec
from . import dna, hashing
from .arena import ArenaLayout, DeviceTileCache, _pad_dict_rows
from .index import BitSlicedIndex, IndexParams


# --------------------------------------------------------------------------
# Pure planning helpers
# --------------------------------------------------------------------------

def plan_rows(hashes: torch.Tensor, row_offset: torch.Tensor,
              block_width: torch.Tensor) -> torch.Tensor:
    """Map term hashes to arena rows, per block: int32 [..., k] (uint32 bit
    patterns) -> int32 [..., k, n_blocks], the paper's 'large output range,
    then modulo per sub-index' addressing."""
    rows = hashing.as_unsigned(hashes)[..., None] % block_width.to(torch.int64)
    return (rows + row_offset.to(torch.int64)).to(torch.int32)


@dataclass(frozen=True)
class ShardPlan:
    """Per-shard query addressing: the shard's blocks with row offsets
    rebased to the shard's first arena row. Scoring shard ``shard`` with
    (row_offset, block_width) against its tile gives the slot scores of
    blocks [block_start, block_end); per-shard outputs concatenated in
    shard order are the global slot scores."""
    shard: int
    block_start: int
    block_end: int
    row_offset: np.ndarray   # int32 [nb_s], shard-local
    block_width: np.ndarray  # int32 [nb_s]


def plan_shards(layout: ArenaLayout, shard_row_starts: np.ndarray
                ) -> list[ShardPlan]:
    """Map every storage shard to the blocks it holds: the all-shards case
    of ``plan_shards_subset``."""
    return plan_shards_subset(layout, shard_row_starts,
                              range(len(shard_row_starts) - 1))


def plan_shards_subset(layout: ArenaLayout, global_row_starts: np.ndarray,
                       shard_ids) -> list[ShardPlan]:
    """Addressing for a subset of a store's shards, as one host's
    ``SubStore`` holds them. ``global_row_starts`` are the parent store's
    shard boundaries and ``shard_ids`` the (sorted) global manifest rows
    held. ``ShardPlan.shard`` is the local tile index; block ranges stay
    global."""
    ranges = layout.shard_blocks(np.asarray(global_row_starts, np.int64))
    plans = []
    for local, g in enumerate(shard_ids):
        b0, b1 = ranges[g]
        base = np.int32(global_row_starts[g])
        plans.append(ShardPlan(
            shard=local, block_start=b0, block_end=b1,
            row_offset=layout.row_offset[b0:b1] - base,
            block_width=layout.block_width[b0:b1]))
    return plans


def compile_pattern(pattern, params: IndexParams) -> np.ndarray:
    """Pattern (DNA string or uint8 code array) -> distinct packed terms
    uint32 [ell, 2] under the index's k-mer parameters."""
    codes = dna.encode_dna(pattern) if isinstance(pattern, str) else pattern
    return dna.unique_terms(
        dna.pack_kmers(codes, params.kmer, params.canonical))


def padded_len(n_terms: int, term_pad: int) -> int:
    """Smallest multiple of ``term_pad`` holding ``n_terms`` (>= term_pad)."""
    return max(term_pad,
               ((n_terms + term_pad - 1) // term_pad) * term_pad)


def pad_terms(terms: np.ndarray, term_pad: int) -> tuple[np.ndarray, int]:
    """Packed terms [L, 2] -> (zero-padded [padded_len, 2], L)."""
    L = terms.shape[0]
    out = np.zeros((padded_len(L, term_pad), 2), dtype=np.uint32)
    out[:L] = terms
    return out, L


def pad_term_batch(term_sets: list[np.ndarray], term_pad: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Term sets -> (shared-padding buffer [Q, pad, 2], ells int32 [Q])."""
    ells = np.array([t.shape[0] for t in term_sets], dtype=np.int32)
    pad = padded_len(int(ells.max(initial=1)), term_pad)
    buf = np.zeros((len(term_sets), pad, 2), dtype=np.uint32)
    for i, t in enumerate(term_sets):
        buf[i, : t.shape[0]] = t
    return buf, ells


def coverage_cutoff(threshold: float, n_terms: int) -> int:
    """The paper's K-threshold: minimum score = ceil(threshold * ell),
    never below 1."""
    return max(1, math.ceil(threshold * n_terms))


@dataclass
class SearchResult:
    """One query's reported documents, best-first.

    Fields:
        doc_ids:   int32 [n_hits] original document ids, descending score
                   (ties keep ascending-id order - the sort is stable).
        scores:    int32 [n_hits] q-gram containment scores.
        n_terms:   number of distinct query q-grams (the paper's ell).
        threshold: the integer score cutoff applied: ceil(K * ell) for
                   ``search``/``search_batch``, the k-th best score for
                   ``top_k``, 0 for an empty result.
    """

    doc_ids: np.ndarray
    scores: np.ndarray
    n_terms: int
    threshold: int


def _empty(n_terms: int = 0) -> SearchResult:
    return SearchResult(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        n_terms, 0)


def select_hits(scores: np.ndarray, n_terms: int, threshold: float
                ) -> SearchResult:
    """Apply the coverage cutoff and order hits best-first (stable)."""
    if n_terms == 0:
        return _empty()
    cut = coverage_cutoff(threshold, n_terms)
    hits = np.nonzero(scores >= cut)[0]
    order = np.argsort(-scores[hits], kind="stable")
    return SearchResult(hits[order].astype(np.int32),
                        scores[hits][order].astype(np.int32), n_terms, cut)


def select_top_k(scores: np.ndarray, n_terms: int, k: int) -> SearchResult:
    """Best-k documents by score; ties resolve to ascending doc id. The
    reported threshold is the k-th best score."""
    k = min(k, scores.shape[0])
    if k == 0:
        return _empty(n_terms)
    order = np.argsort(-scores, kind="stable")[:k]
    top = scores[order].astype(np.int32)
    return SearchResult(order.astype(np.int32), top, n_terms, int(top[-1]))


def run_paged(tiles: DeviceTileCache, shard_args, fn, *args
              ) -> list[np.ndarray]:
    """Call ``fn(tile, offs, widths, *args)`` once per shard, in order.
    After shard i's kernels are launched, shard i+1 is prefetched: its copy
    runs on the tile cache's side stream while shard i is scored. Results
    come to the host only after every shard has been launched.
    ``shard_args`` is [(shard, row_offset, block_width)] with the offsets
    and widths already on the device."""
    parts = []
    for i, (s, offs, widths) in enumerate(shard_args):
        out = fn(tiles.get(s), offs, widths, *args)
        if i + 1 < len(shard_args):
            tiles.prefetch(shard_args[i + 1][0])
        parts.append(out)
    return [p.cpu().numpy() for p in parts]


def run_paged_compressed(tiles: DeviceTileCache, shard_args, fn_raw, fn_comp,
                         *args) -> list[np.ndarray]:
    """``run_paged`` with a per-shard codec dispatch: dict-coded shards
    stage their (dict, refs) pair and go through
    ``fn_comp(dict_rows, refs, offs, widths, *args)``, raw shards through
    ``fn_raw``. The prefetch stages the form the next shard will be
    scored in."""
    storage = tiles.storage
    comp = [storage.shard_codec(s) in _codec.DICT_CODECS
            for (s, _, _) in shard_args]
    parts = []
    for i, (s, offs, widths) in enumerate(shard_args):
        if comp[i]:
            dict_rows, refs = tiles.get_compressed(s)
            out = fn_comp(dict_rows, refs, offs, widths, *args)
        else:
            out = fn_raw(tiles.get(s), offs, widths, *args)
        if i + 1 < len(shard_args):
            nxt = shard_args[i + 1][0]
            (tiles.prefetch_compressed if comp[i + 1]
             else tiles.prefetch)(nxt)
        parts.append(out)
    return [p.cpu().numpy() for p in parts]


# unique-row count -> padded buffer length (a power of two, at least 8):
# the JAX executors' padding, the same rule as the tile cache's dictionaries
_pad_unique = _pad_dict_rows


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A 4-byte numpy array (uint32 words or int32 indices) as an int32
    tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _check_rows(rows: np.ndarray, n_rows: int, what: str) -> None:
    """Host-side range check of planned rows before they reach a kernel
    or a device gather (no device sync)."""
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise IndexError(f"planned rows [{int(rows.min())}, "
                         f"{int(rows.max())}] outside {what}'s {n_rows} rows")


# --------------------------------------------------------------------------
# Batched row dedup (the server's batch path when its queries share rows)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DedupBatchPlan:
    """Unique-row addressing for one micro-batch.

    The fused multi-query kernel reads an arena row per (query, block,
    term) cell. This plan collapses the batch's rows into ``uniq_rows``
    (each arena row listed once, padded with row 0 to a power of two, at
    least 8) and the ``indir`` indirection that maps every cell back to its
    unique row, so the kernels read U rows from the arena instead of
    Q*nb*L. For k > 1 the unit is the k-row set a term addresses:
    ``uniq_rows`` is [U_pad, k] and equal sets collapse to one gather and
    AND."""
    uniq_rows: np.ndarray   # int32 [U_pad] (k=1) or [U_pad, k] (0-padded)
    indir: np.ndarray       # int32 [Q, nb, L] -> index into uniq_rows
    mask: np.ndarray        # int32 [Q, nb, L] (1 = live term)
    n_unique: int           # live unique rows or row sets (<= U_pad)
    n_gathers: int          # live (query, block, term) cells

    @property
    def dedup_rate(self) -> float:
        """Share of the fused path's row reads the dedup path saves:
        1 - unique/total. 0 = fully disjoint batch, ->1 = heavy sharing."""
        if self.n_gathers == 0:
            return 0.0
        return 1.0 - self.n_unique / self.n_gathers


def plan_dedup_batch(terms: np.ndarray, n_valid: np.ndarray,
                     row_offset: np.ndarray, block_width: np.ndarray,
                     n_hashes: int = 1) -> DedupBatchPlan:
    """Host-side dedup planning for one padded micro-batch, the JAX numpy
    line for line.

    terms uint32 [Q, L, 2]; n_valid int32 [Q] (a padded query has 0, so
    none of its cells is live); (row_offset, block_width) the addressing
    of the arena, or of one shard, already rebased. The host hash mirror
    is bit-identical to the device hash, so the planned rows are the rows
    the fused kernel would read."""
    terms = np.asarray(terms)
    n_valid = np.asarray(n_valid, dtype=np.int32)
    Q, L = terms.shape[0], terms.shape[1]
    k = int(n_hashes)
    w = np.asarray(block_width).astype(np.uint32)
    off = np.asarray(row_offset).astype(np.uint32)
    valid = np.arange(L, dtype=np.int32)[None, :] < n_valid[:, None]
    if k == 1:
        h = hashing.hash_terms_np(terms, 1)[..., 0]           # [Q, L]
        rows = (h[..., None] % w[None, None, :] + off)        # [Q, L, nb]
        rows = np.swapaxes(rows, 1, 2).astype(np.int64)       # [Q, nb, L]
        cell_shape = rows.shape
        mask = np.broadcast_to(valid[:, None, :], cell_shape)
        live = rows[mask]                                     # [N]
        uniq, inv = np.unique(live, return_inverse=True)
        uniq_pad = np.zeros(_pad_unique(uniq.size), dtype=np.int32)
        uniq_pad[: uniq.size] = uniq
    else:
        h = hashing.hash_terms_np(terms, k)                   # [Q, L, k]
        rows = (h[..., None] % w + off)                       # [Q, L, k, nb]
        rows = np.transpose(rows, (0, 3, 1, 2)).astype(np.int64)  # [Q,nb,L,k]
        cell_shape = rows.shape[:3]
        mask = np.broadcast_to(valid[:, None, :], cell_shape)
        live = rows[mask]                                     # [N, k]
        uniq, inv = np.unique(live, axis=0, return_inverse=True)
        uniq_pad = np.zeros((_pad_unique(uniq.shape[0]), k), dtype=np.int32)
        uniq_pad[: uniq.shape[0]] = uniq
    indir = np.zeros(cell_shape, dtype=np.int32)
    indir[mask] = np.asarray(inv).reshape(-1).astype(np.int32)
    return DedupBatchPlan(uniq_rows=uniq_pad, indir=indir,
                          mask=mask.astype(np.int32),
                          n_unique=int(uniq.shape[0]),
                          n_gathers=int(live.shape[0]))


def make_dedup_score_fn(word_block: int | None = None):
    """Returns score(arena, uniq_rows, indir, mask, *, range_checked=False)
    -> int32 [Q, n_slots]: the dedup pair (``gather_rows`` then
    ``dedup_score``), equal to the fused multi-query kernel on the
    expanded indices. ``word_block`` is validated and has no effect."""

    def score(arena, uniq_rows, indir, mask, *, range_checked=False):
        return ops.bitslice_lookup_score_dedup(
            arena, uniq_rows, indir, mask, word_block=word_block,
            range_checked=range_checked)

    return score


def make_comp_dedup_score_fn(word_block: int | None = None):
    """Compressed twin of ``make_dedup_score_fn``: score(dict_rows, refs,
    uniq_rows, indir, mask, *, range_checked=False) -> int32 [Q, n_slots],
    each unique row (or ANDed row set) decoded out of the shard's
    dictionary inside the gather kernel."""

    def score(dict_rows, refs, uniq_rows, indir, mask, *,
              range_checked=False):
        return ops.bitslice_lookup_score_dedup_comp(
            dict_rows, refs, uniq_rows, indir, mask, word_block=word_block,
            range_checked=range_checked)

    return score


def dedup_inputs(dp: DedupBatchPlan, n_rows: int, device: torch.device,
                 what: str) -> tuple[torch.Tensor, ...]:
    """A plan's (uniq_rows, indir, mask) on ``device``, uniq_rows checked
    on the host against the ``n_rows`` rows of the tile (or refs) they
    index, so the kernels may skip their own check (indir indexes
    uniq_rows by construction)."""
    _check_rows(dp.uniq_rows, n_rows, what)
    return tuple(_to_device(a, device)
                 for a in (dp.uniq_rows, dp.indir, dp.mask))


def run_paged_dedup(tiles: DeviceTileCache, shard_plans: list[ShardPlan], fn,
                    terms: np.ndarray, n_valid: np.ndarray,
                    n_hashes: int = 1, fn_comp=None) -> np.ndarray:
    """Dedup-scored batch across shard tiles, the dedup analogue of
    ``run_paged``: per shard, plan the unique rows against the shard's
    rebased addressing, score through ``fn`` (from
    ``make_dedup_score_fn``), prefetch the next tile while the shard's
    kernels run, and concatenate the per-shard slot scores, which come to
    the host after every shard has been launched.

    With ``fn_comp`` (from ``make_comp_dedup_score_fn``) dict-coded shards
    stage their (dict, refs) pair and score through the decoding gather;
    raw shards keep ``fn``. ``n_hashes`` > 1 plans row-set dedup."""
    storage = tiles.storage
    comp = [fn_comp is not None
            and storage.shard_codec(sp.shard) in _codec.DICT_CODECS
            for sp in shard_plans]
    parts = []
    for i, sp in enumerate(shard_plans):
        dp = plan_dedup_batch(terms, n_valid, sp.row_offset, sp.block_width,
                              n_hashes=n_hashes)
        what = f"shard {sp.shard}'s tile"
        if comp[i]:
            dict_rows, refs = tiles.get_compressed(sp.shard)
            out = fn_comp(dict_rows, refs,
                          *dedup_inputs(dp, refs.shape[0], tiles.device, what),
                          range_checked=True)
        else:
            tile = tiles.get(sp.shard)
            out = fn(tile, *dedup_inputs(dp, tile.shape[0], tiles.device,
                                         what), range_checked=True)
        if i + 1 < len(shard_plans):
            nxt = shard_plans[i + 1].shard
            (tiles.prefetch_compressed if comp[i + 1]
             else tiles.prefetch)(nxt)
        parts.append(out)
    return np.concatenate([p.cpu().numpy() for p in parts], axis=1)


# --------------------------------------------------------------------------
# Pruned scoring (branch-and-bound over the coverage threshold)
# --------------------------------------------------------------------------
#
# The pruned path executes terms in chunks (rarest first when the store
# recorded popcount stats) and keeps a per-(query, block) running count on
# the device; after each chunk, a block whose best possible final score
# (running max + terms remaining) cannot reach the required cutoff is
# dropped. Partial sums in dropped blocks stay below the cutoff, so the
# reported hits and scores equal the exhaustive engine's.
#
# Each (chunk, shard) visit host-gathers only the chunk's unique touched
# rows out of the mapped shard and uploads that small matrix. When a
# shard's gathered bytes reach ``promote_ratio`` of its device bytes the
# shard is promoted: its tile is staged once through the DeviceTileCache
# (prefetched at half the threshold) and later chunks read it on the card.
# The planning is the JAX executor's numpy, line for line; only the chunk
# kernels and the running counts live on the device.


@dataclass
class PruneStats:
    """Work accounting for one pruned batch (mutated in place).

    ``bytes_read`` is the headline number: host arena bytes read (row
    gathers + promoted tile stagings), which the exhaustive path pays
    ``sum(shard_nbytes)`` for."""
    blocks_total: int = 0        # live (query, block) cells at entry
    blocks_pruned: int = 0       # cells dropped before the final chunk
    chunks: int = 0              # term chunks executed
    shard_visits: int = 0        # (chunk, shard) visits dispatched
    shard_visits_skipped: int = 0  # visits skipped (no live cell)
    tiles_promoted: int = 0      # shards escalated to full-tile staging
    kernel_dispatches: int = 0
    bytes_gathered: int = 0      # host bytes read by row gathers
    bytes_tile_staged: int = 0   # bytes of promoted full tiles

    @property
    def bytes_read(self) -> int:
        return self.bytes_gathered + self.bytes_tile_staged

    @property
    def prune_rate(self) -> float:
        if self.blocks_total == 0:
            return 0.0
        return self.blocks_pruned / self.blocks_total

    def merge(self, other: "PruneStats") -> None:
        """Accumulate another batch's counters."""
        for f in ("blocks_total", "blocks_pruned", "chunks", "shard_visits",
                  "shard_visits_skipped", "tiles_promoted",
                  "kernel_dispatches", "bytes_gathered", "bytes_tile_staged"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


def order_terms_rarest(storage, shard_plans: list[ShardPlan],
                       terms: np.ndarray, n_valid: np.ndarray,
                       n_hashes: int = 1, max_blocks: int = 8) -> np.ndarray:
    """Per-query term execution order for pruned scoring: int32 [Q, L]
    permutation, valid terms first, rarest first.

    A term's rarity is estimated on up to ``max_blocks`` blocks spread over
    the arena, as the sum of its row popcounts there (the least of its k
    hash rows), read from the store's popcount sidecars. Storage without
    stats keeps the natural order; correctness never depends on it."""
    terms = np.asarray(terms)
    n_valid = np.asarray(n_valid, dtype=np.int32)
    Q, L = terms.shape[0], terms.shape[1]
    natural = np.broadcast_to(np.arange(L, dtype=np.int32), (Q, L)).copy()
    has = getattr(storage, "has_popcounts", None)
    if L == 0 or has is None or not has():
        return natural
    starts = np.asarray(storage.shard_row_starts, dtype=np.int64)
    off = np.concatenate([sp.row_offset.astype(np.int64)
                          + int(starts[sp.shard]) for sp in shard_plans])
    wid = np.concatenate([sp.block_width.astype(np.int64)
                          for sp in shard_plans])
    sel = np.unique(np.linspace(0, off.shape[0] - 1,
                                min(max_blocks, off.shape[0])).astype(np.int64))
    off, wid = off[sel], wid[sel]
    h = hashing.hash_terms_np(terms, n_hashes).astype(np.int64)  # [Q, L, k]
    rows = h[..., None] % wid + off                       # [Q, L, k, S]
    uniq, inv = np.unique(rows.reshape(-1), return_inverse=True)
    pops = np.asarray(storage.row_popcounts(uniq), dtype=np.int64)
    est = pops[inv].reshape(rows.shape).min(axis=2).sum(axis=-1)  # [Q, L]
    est[np.arange(L, dtype=np.int32)[None, :] >= n_valid[:, None]] = (
        np.iinfo(np.int64).max)                           # padding last
    return np.argsort(est, axis=1, kind="stable").astype(np.int32)


def _unique_cells(cells: np.ndarray, k: int):
    """Unique rows (k=1) or row sets (k>1) of the live cells [N, k], and
    each cell's index among them."""
    if k == 1:
        return np.unique(cells[:, 0], return_inverse=True)
    return np.unique(cells, axis=0, return_inverse=True)


def _indirection(live: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """Per-cell index into the unique rows, int32 shaped like ``live``
    (0 where a cell is not live; its mask is 0 there)."""
    indir = np.zeros(live.shape, dtype=np.int32)
    indir[live] = np.asarray(inv).reshape(-1).astype(np.int32)
    return indir


def _device_row_sets(resident, dict_coded: bool, uniq: np.ndarray, k: int,
                     device: torch.device) -> torch.Tensor:
    """The promoted k>1 path's unique row sets, gathered and ANDed on the
    device out of the resident tile (or (dict, refs) pair)."""
    u_idx = np.zeros((_pad_unique(uniq.shape[0]), k), dtype=np.int32)
    u_idx[: uniq.shape[0]] = uniq
    if dict_coded:
        d, r = resident
        return ops.gather_and_rows_comp(d, r, _to_device(u_idx, device))
    return ops.gather_and_rows(resident, _to_device(u_idx, device))


def run_paged_pruned(tiles: DeviceTileCache, shard_plans: list[ShardPlan],
                     terms: np.ndarray, n_valid: np.ndarray,
                     required: np.ndarray, topk: np.ndarray, *,
                     n_hashes: int = 1, chunk_terms: int = 32,
                     word_block: int | None = None,
                     promote_ratio: float = 0.5,
                     order: np.ndarray | None = None,
                     stats: PruneStats | None = None) -> np.ndarray:
    """Branch-and-bound batch scoring across shard tiles.

    terms uint32 [Q, L, 2] (shared padding), n_valid int32 [Q];
    ``required`` [Q] is each query's fixed score cutoff
    (``coverage_cutoff``; 0 for top-k queries) and ``topk`` int32 [Q] the
    per-query k (0 = threshold query; the cutoff then tightens to the
    merged k-th largest running count). Returns int32 [Q, n_slots] slot
    scores, equal to ``run_paged``'s on every slot that can meet its
    query's cutoff; pruned blocks hold partial sums below it.

    ``order`` overrides the term order ([Q, L] permutation, valid first;
    default ``order_terms_rarest``). ``stats`` (a PruneStats) receives the
    work and I/O accounting. The running counts live on ``tiles.device``;
    each visit brings only its block max [Q, nb] to the host."""
    terms = np.asarray(terms)
    n_valid = np.asarray(n_valid, dtype=np.int32)
    required = np.asarray(required, dtype=np.int64).copy()
    topk = np.asarray(topk, dtype=np.int32)
    if stats is None:
        stats = PruneStats()
    storage = tiles.storage
    dev = tiles.device
    Q, L = terms.shape[0], terms.shape[1]
    W = int(storage.shape[1])
    k = int(n_hashes)
    ct = max(1, int(chunk_terms))
    n_sh = len(shard_plans)
    nbs = [sp.row_offset.shape[0] for sp in shard_plans]
    l_max = int(n_valid.max(initial=0))
    if l_max == 0 or Q == 0:
        return np.zeros((Q, sum(nbs) * W * 32), dtype=np.int32)

    if order is None:
        order = order_terms_rarest(storage, shard_plans, terms, n_valid,
                                   n_hashes=k)
    h = hashing.hash_terms_np(terms, k)                   # [Q, L, k]
    h_ord = np.take_along_axis(h, np.asarray(order, np.int64)[..., None],
                               axis=1)

    alive = [np.ones((Q, nb), dtype=bool) for nb in nbs]
    acc = [None] * n_sh
    block_max = [np.zeros((Q, nb), dtype=np.int64) for nb in nbs]
    tk_lower = [None] * n_sh                # [Q, kmax] per shard (top-k)
    promoted = [False] * n_sh
    prefetch_issued = [False] * n_sh        # promotion prefetch dispatched
    resident = [None] * n_sh                # device tile or (dict, refs)
    gathered = [0] * n_sh                   # cumulative gather bytes
    decode_counted = [False] * n_sh
    stats.blocks_total += int(Q * sum(nbs))
    kmax = int(topk.max(initial=0))
    is_topk = topk > 0

    n_chunks = -(-l_max // ct)
    offs = [sp.row_offset.astype(np.uint32) for sp in shard_plans]
    wids = [sp.block_width.astype(np.uint32) for sp in shard_plans]
    codecs = [storage.shard_codec(sp.shard) for sp in shard_plans]
    dict_coded = [c in _codec.DICT_CODECS for c in codecs]

    for c in range(n_chunks):
        stats.chunks += 1
        j0 = c * ct
        h_chunk = np.zeros((Q, ct, k), dtype=h_ord.dtype)
        width = min(ct, L - j0)
        h_chunk[:, :width] = h_ord[:, j0:j0 + width]
        valid_chunk = (j0 + np.arange(ct, dtype=np.int32)[None, :]
                       < n_valid[:, None])                # [Q, ct]
        visited = []
        for s, sp in enumerate(shard_plans):
            live = alive[s][:, :, None] & valid_chunk[:, None, :]  # [Q,nb,ct]
            if not live.any():
                stats.shard_visits_skipped += 1
                continue
            stats.shard_visits += 1
            visited.append(s)
            rows = (h_chunk[..., None] % wids[s] + offs[s])  # [Q, ct, k, nb]
            rows = np.transpose(rows, (0, 3, 1, 2)).astype(np.int64)
            if acc[s] is None:
                acc[s] = ops.chunk_acc_init(Q, nbs[s], W,
                                            word_block=word_block,
                                            device=dev)
            hbm = storage.shard_hbm_nbytes(sp.shard)
            if (not promoted[s] and not prefetch_issued[s]
                    and gathered[s] >= 0.5 * promote_ratio * hbm):
                # prefetch the full tile at half the promote threshold, so
                # its copy overlaps the remaining gather-fed chunks
                prefetch_issued[s] = True
                if dict_coded[s]:
                    tiles.prefetch_compressed(sp.shard)
                else:
                    tiles.prefetch(sp.shard)
            if not promoted[s] and gathered[s] >= promote_ratio * hbm:
                promoted[s] = True
                if dict_coded[s]:
                    resident[s] = tiles.get_compressed(sp.shard)
                else:
                    resident[s] = tiles.get(sp.shard)
                stats.tiles_promoted += 1
                stats.bytes_tile_staged += hbm
            mask = _to_device(live.astype(np.int32), dev)
            if promoted[s]:
                n_rows = (resident[s][1] if dict_coded[s]
                          else resident[s]).shape[0]
                _check_rows(rows, n_rows, f"shard {sp.shard}'s tile")
            if promoted[s] and k == 1:
                idx = _to_device(rows[..., 0].astype(np.int32), dev)
                if dict_coded[s]:
                    d, r = resident[s]
                    acc[s], bmax = ops.bitslice_chunk_score_multi_comp(
                        d, r, idx, mask, acc[s], range_checked=True)
                else:
                    acc[s], bmax = ops.bitslice_chunk_score_multi(
                        resident[s], idx, mask, acc[s], range_checked=True)
            elif promoted[s]:
                # k>1 promoted: the chunk's unique row sets are planned on
                # the host and gathered + ANDed on the device
                uniq, inv = _unique_cells(rows[live], k)
                mat_dev = _device_row_sets(resident[s], dict_coded[s], uniq,
                                           k, dev)
                # indir indexes the unique sets by construction
                acc[s], bmax = ops.bitslice_chunk_score_dedup(
                    mat_dev, _to_device(_indirection(live, inv), dev), mask,
                    acc[s], range_checked=True)
            else:
                uniq, inv = _unique_cells(rows[live], k)
                if dict_coded[s]:
                    d_host, r_host = storage.shard_dict_host(sp.shard)
                    refs = np.asarray(r_host)[uniq]       # [U] or [U, k]
                    mat = np.asarray(d_host[refs.reshape(-1)],
                                     dtype=np.uint32)
                    nread = int(np.unique(refs).size)
                else:
                    if (codecs[s] != _codec.CODEC_RAW
                            and not decode_counted[s]):
                        # non-dict compressed shards decode whole on touch
                        decode_counted[s] = True
                        stats.bytes_gathered += storage.shard_nbytes(sp.shard)
                    host = storage.shard_host(sp.shard)
                    mat = np.asarray(host[uniq.reshape(-1)],
                                     dtype=np.uint32)
                    nread = int(uniq.reshape(-1).size)
                if codecs[s] == _codec.CODEC_RAW or dict_coded[s]:
                    stats.bytes_gathered += nread * W * 4
                gathered[s] += mat.shape[0] * W * 4
                if k > 1:
                    mat = mat.reshape(-1, k, W)
                    anded = mat[:, 0]
                    for i in range(1, k):
                        anded = anded & mat[:, i]
                    mat = anded
                u_pad = np.zeros((_pad_unique(mat.shape[0]), W),
                                 dtype=np.uint32)
                u_pad[: mat.shape[0]] = mat
                acc[s], bmax = ops.bitslice_chunk_score_dedup(
                    _to_device(u_pad, dev),
                    _to_device(_indirection(live, inv), dev), mask, acc[s],
                    range_checked=True)
            stats.kernel_dispatches += 1
            block_max[s] = bmax.cpu().numpy().astype(np.int64)

        if c == n_chunks - 1:
            break
        if kmax > 0:
            for s in visited:
                tk_lower[s] = ops.chunk_topk_lower(acc[s], kmax).cpu().numpy()
            have = [t for t in tk_lower if t is not None]
            if have:
                merged = -np.sort(-np.concatenate(have, axis=1), axis=1)
                for q in np.nonzero(is_topk)[0]:
                    kq = int(topk[q])
                    if merged.shape[1] >= kq:
                        required[q] = max(required[q], int(merged[q, kq - 1]))
        executed = np.minimum(n_valid, (c + 1) * ct).astype(np.int64)
        remaining = n_valid.astype(np.int64) - executed
        any_alive = False
        for s in range(n_sh):
            keep = (block_max[s] + remaining[:, None]) >= required[:, None]
            newly = alive[s] & ~keep
            stats.blocks_pruned += int(newly.sum())
            alive[s] &= keep
            any_alive = any_alive or bool(alive[s].any())
        if not any_alive:
            break

    parts = []
    for s in range(n_sh):
        if acc[s] is None:
            parts.append(np.zeros((Q, nbs[s] * W * 32), dtype=np.int32))
        else:
            parts.append(ops.chunk_acc_scores(acc[s], W).cpu().numpy())
    return np.concatenate(parts, axis=1)


# --------------------------------------------------------------------------
# Shard-major streaming execution (the offline bulk lane)
# --------------------------------------------------------------------------
#
# The interactive path is query-major: every batch visits every shard, so
# a bounded tile cache re-stages tiles once per batch. ``run_shard_major``
# inverts the loop for bulk jobs: each shard tile is staged once (the next
# one prefetched while the current one is scored), the whole query set
# streams against it in slabs sized by ``ops.bulk_query_chunk``, and the
# per-(query, block) running counts use the pruned executor's chunk
# kernels, with its rarest-first order and threshold early exit. Results
# land in a host slot buffer shard by shard, so (out, next_shard,
# required) is a checkpoint to resume from.


@dataclass
class BulkStats:
    """Work accounting for shard-major sweeps (additive: pass the same
    object across resumed calls for totals).

    ``bytes_staged`` is the headline number: arena bytes the tile caches
    staged for the sweep (raw and dict forms, read off their counters)."""
    shards_swept: int = 0        # shards fully scored (all queries)
    tiles_staged: int = 0        # stagings issued (demand + prefetch)
    bytes_staged: int = 0        # bytes those stagings moved
    query_chunks: int = 0        # query slabs dispatched
    kernel_dispatches: int = 0
    blocks_total: int = 0        # (query, block) cells entering sweeps
    blocks_pruned: int = 0       # cells retired by threshold early exit

    @property
    def prune_rate(self) -> float:
        if self.blocks_total == 0:
            return 0.0
        return self.blocks_pruned / self.blocks_total

    def merge(self, other: "BulkStats") -> None:
        for f in ("shards_swept", "tiles_staged", "bytes_staged",
                  "query_chunks", "kernel_dispatches", "blocks_total",
                  "blocks_pruned"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


def run_shard_major(tiles, shard_plans: list[ShardPlan], terms: np.ndarray,
                    n_valid: np.ndarray, required: np.ndarray,
                    topk: np.ndarray, *, n_hashes: int = 1,
                    chunk_terms: int = 32, query_chunk: int | None = None,
                    word_block: int | None = None,
                    order: np.ndarray | None = None,
                    stats: BulkStats | None = None, start_shard: int = 0,
                    out: np.ndarray | None = None,
                    should_yield=None) -> tuple[np.ndarray, int, np.ndarray]:
    """Shard-major streaming scan: one tile staging amortized over Q.

    terms uint32 [Q, L, 2] (shared padding), n_valid int32 [Q];
    ``required`` [Q] per-query score cutoffs (0 for top-k) and ``topk``
    int32 [Q] per-query k (0 = threshold). Returns ``(out, next_shard,
    required)``: int32 [Q, n_slots] slot scores (shard s at columns
    [block_start, block_end) * W * 32), the first unswept shard, and the
    tightened cutoffs. Pruned (query, block) cells hold partial sums below
    the query's cutoff, as in ``run_paged_pruned``.

    ``tiles`` is one DeviceTileCache or a list parallel to
    ``shard_plans``. ``should_yield()`` is polled at shard boundaries: True
    suspends the sweep, and the caller resumes with ``start_shard`` /
    ``out`` / the returned cutoffs. Top-k cutoffs tighten after every
    completed shard from the k-th largest accumulated count."""
    plans = list(shard_plans)
    n_sh = len(plans)
    caches = (list(tiles) if isinstance(tiles, (list, tuple))
              else [tiles] * n_sh)
    terms = np.asarray(terms)
    n_valid = np.asarray(n_valid, dtype=np.int32)
    required = np.asarray(required, dtype=np.int64).copy()
    topk = np.asarray(topk, dtype=np.int32)
    if stats is None:
        stats = BulkStats()
    Q, L = terms.shape[0], terms.shape[1]
    k = int(n_hashes)
    ct = max(1, int(chunk_terms))
    if not plans:
        return np.zeros((Q, 0), dtype=np.int32), 0, required
    storage0 = caches[0].storage
    W = int(storage0.shape[1])
    ncols = max(sp.block_end for sp in plans) * W * 32
    if out is None:
        out = np.zeros((Q, ncols), dtype=np.int32)
    l_max = int(n_valid.max(initial=0))
    if Q == 0 or l_max == 0:
        return out, n_sh, required

    if order is None:
        # popcount estimate over the first cache's storage and the plans
        # addressed against it; the order is a heuristic only
        own = [sp for ca, sp in zip(caches, plans) if ca is caches[0]]
        order = order_terms_rarest(storage0, own, terms, n_valid,
                                   n_hashes=k)
    h = hashing.hash_terms_np(terms, k)                   # [Q, L, k]
    h_ord = np.take_along_axis(h, np.asarray(order, np.int64)[..., None],
                               axis=1)
    n_chunks = -(-l_max // ct)
    is_topk = topk > 0
    any_topk = bool(is_topk.any())

    def staged(cache, fn, *a):
        # under the cache's re-entrant lock, so the counter delta cannot
        # take in a concurrent staging by another user of the cache
        with cache._lock:
            b0 = cache.raw_bytes_staged + cache.comp_bytes_staged
            r = fn(*a)
            moved = cache.raw_bytes_staged + cache.comp_bytes_staged - b0
        if moved:
            stats.tiles_staged += 1
            stats.bytes_staged += moved
        return r

    for si in range(start_shard, n_sh):
        if (should_yield is not None and si > start_shard
                and should_yield()):
            return out, si, required
        sp, cache = plans[si], caches[si]
        dev = cache.device
        dict_coded = (cache.storage.shard_codec(sp.shard)
                      in _codec.DICT_CODECS)
        tile = staged(cache, cache.get_compressed if dict_coded
                      else cache.get, sp.shard)
        if si + 1 < n_sh:                     # double-buffer the next tile
            nsp, ncache = plans[si + 1], caches[si + 1]
            ndict = ncache.storage.shard_codec(nsp.shard) in \
                _codec.DICT_CODECS
            staged(ncache, ncache.prefetch_compressed if ndict
                   else ncache.prefetch, nsp.shard)
        n_rows = (tile[1] if dict_coded else tile).shape[0]

        nb = int(sp.block_end - sp.block_start)
        col0, col1 = sp.block_start * W * 32, sp.block_end * W * 32
        offs = sp.row_offset.astype(np.uint32)
        wids = sp.block_width.astype(np.uint32)
        qc = int(query_chunk) if query_chunk else ops.bulk_query_chunk(
            nb, W, word_block=word_block)
        # no slab wider than the (pow2-padded) query set itself
        qc = min(qc, max(8, 1 << max(0, Q - 1).bit_length()))
        for q0 in range(0, Q, qc):
            qn = min(qc, Q - q0)
            sl = slice(q0, q0 + qn)
            stats.query_chunks += 1
            stats.blocks_total += qn * nb
            # the last slab is padded up to qc with fully masked queries
            # (n_valid = 0), as the JAX sweep pads it
            hv = np.zeros((qc, L, k), dtype=h_ord.dtype)
            hv[:qn] = h_ord[sl]
            nv = np.zeros(qc, dtype=np.int32)
            nv[:qn] = n_valid[sl]
            req = np.zeros(qc, dtype=np.int64)
            req[:qn] = required[sl]
            alive = np.zeros((qc, nb), dtype=bool)
            alive[:qn] = True
            acc = ops.chunk_acc_init(qc, nb, W, word_block=word_block,
                                     device=dev)
            for c in range(n_chunks):
                j0 = c * ct
                valid_chunk = (j0 + np.arange(ct, dtype=np.int32)[None, :]
                               < nv[:, None])
                live = alive[:, :, None] & valid_chunk[:, None, :]
                if not live.any():
                    break
                h_chunk = np.zeros((qc, ct, k), dtype=h_ord.dtype)
                width = min(ct, L - j0)
                h_chunk[:, :width] = hv[:, j0:j0 + width]
                rows = (h_chunk[..., None] % wids + offs)  # [qc, ct, k, nb]
                rows = np.transpose(rows, (0, 3, 1, 2)).astype(np.int64)
                _check_rows(rows, n_rows, f"shard {sp.shard}'s tile")
                mask = _to_device(live.astype(np.int32), dev)
                if k == 1:
                    idx = _to_device(rows[..., 0].astype(np.int32), dev)
                    if dict_coded:
                        d, r = tile
                        acc, bmax = ops.bitslice_chunk_score_multi_comp(
                            d, r, idx, mask, acc, range_checked=True)
                    else:
                        acc, bmax = ops.bitslice_chunk_score_multi(
                            tile, idx, mask, acc, range_checked=True)
                else:
                    # k>1: the chunk's unique row sets, planned on the
                    # host, gathered and ANDed on the device
                    uniq, inv = _unique_cells(rows[live], k)
                    mat_dev = _device_row_sets(tile, dict_coded, uniq, k,
                                               dev)
                    acc, bmax = ops.bitslice_chunk_score_dedup(
                        mat_dev, _to_device(_indirection(live, inv), dev),
                        mask, acc, range_checked=True)
                stats.kernel_dispatches += 1
                if c < n_chunks - 1:
                    executed = np.minimum(nv, (c + 1) * ct).astype(np.int64)
                    remaining = nv.astype(np.int64) - executed
                    keep = (bmax.cpu().numpy().astype(np.int64)
                            + remaining[:, None]) >= req[:, None]
                    newly = alive & ~keep
                    stats.blocks_pruned += int(newly[:qn].sum())
                    alive &= keep
            out[sl, col0:col1] = ops.chunk_acc_scores(
                acc, W).cpu().numpy()[:qn]
        stats.shards_swept += 1
        if any_topk:
            # every accumulated count is a lower bound on some document's
            # final score (unswept slots 0, pruned slots partial), so the
            # k-th largest is a sound cutoff for the remaining shards
            ns = out.shape[1]
            for q in np.nonzero(is_topk)[0]:
                kq = int(topk[q])
                if ns >= kq > 0:
                    lb = int(np.partition(out[q], ns - kq)[ns - kq])
                    if lb > required[q]:
                        required[q] = lb
    return out, n_sh, required


# --------------------------------------------------------------------------
# Device scoring
# --------------------------------------------------------------------------

def gather_rows(arena: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """Gather + AND + mask: (arena [R, Wb], rows int32 [..., L, k, nb],
    valid bool [..., L]) -> int32 [..., L, nb * Wb]."""
    g = arena[rows.long()]                        # [..., L, k, nb, Wb]
    anded = g[..., 0, :, :]
    for i in range(1, rows.shape[-2]):
        anded = anded & g[..., i, :, :]
    anded = torch.where(valid[..., None, None], anded, 0)
    return anded.reshape(*rows.shape[:-2], -1)


def gather_rows_comp(dict_rows: torch.Tensor, refs: torch.Tensor,
                     rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``gather_rows`` against a rowdict pair: the double gather
    ``dict_rows[refs[rows]]`` decodes on the fly; same AND, mask and
    output."""
    return gather_rows(dict_rows, refs[rows.long()], valid)


def _check_method(method: str) -> None:
    if method not in ops.METHODS:
        raise ValueError(f"unknown method {method!r}; one of {ops.METHODS}")


def make_score_fn(n_hashes: int, method: str = "vertical"):
    """Returns score(arena, row_offset, block_width, terms int32 [L, 2],
    n_valid) -> int32 [n_slots] in slot order.

    k=1 'lookup' runs the fused gather kernel (``lookup_score`` for one
    block, ``lookup_score_blocks`` otherwise); every other case gathers and
    ANDs the rows, then scores them with 'unpack', 'vertical' ('lookup'
    with k>1) or the 'ref' oracle."""
    _check_method(method)

    def score(arena, row_offset, block_width, terms, n_valid):
        L = terms.shape[0]
        h = hashing.hash_terms(terms, n_hashes)            # [L, k]
        rows = plan_rows(h, row_offset, block_width)       # [L, k, nb]
        valid = torch.arange(L, device=terms.device) < int(n_valid)
        if method == "lookup" and n_hashes == 1:
            if row_offset.shape[0] == 1:
                return ops.bitslice_lookup_score(
                    arena, rows[:, 0, 0].contiguous(),
                    valid.to(torch.int32))
            idx = rows[:, 0, :].T.contiguous()             # [nb, L]
            msk = valid.to(torch.int32)[None, :].expand(idx.shape)
            return ops.bitslice_lookup_score_blocks(arena, idx,
                                                    msk.contiguous())
        flat = gather_rows(arena, rows, valid)             # [L, nb*Wb]
        return ops.bitslice_score(
            flat, method="vertical" if method == "lookup" else method)

    return score


def make_batch_score_fn(n_hashes: int, method: str = "vertical",
                        grid_order: str = "wq"):
    """Returns score(arena, row_offset, block_width, terms int32 [Q, L, 2],
    n_valid int32 [Q]) -> int32 [Q, n_slots].

    k=1 'lookup' sends the whole batch to the fused multi-query kernel;
    the other methods score the batch with an explicit batch axis where
    JAX vmaps the single-query scorer ('lookup' with k>1 is 'vertical').
    ``grid_order`` is the autotuner's key, validated by the kernel."""
    _check_method(method)

    def score_batch(arena, row_offset, block_width, terms, n_valid):
        Q, L = terms.shape[0], terms.shape[1]
        h = hashing.hash_terms(terms, n_hashes)            # [Q, L, k]
        rows = plan_rows(h, row_offset, block_width)       # [Q, L, k, nb]
        valid = (torch.arange(L, device=terms.device)[None, :]
                 < n_valid[:, None])                       # [Q, L]
        if method == "lookup" and n_hashes == 1:
            idx = rows[:, :, 0, :].transpose(1, 2).contiguous()  # [Q, nb, L]
            msk = valid.to(torch.int32)[:, None, :].expand(idx.shape)
            return ops.bitslice_lookup_score_multi(
                arena, idx, msk.contiguous(), grid_order=grid_order)
        flat = gather_rows(arena, rows, valid)             # [Q, L, nb*Wb]
        return ops.bitslice_score(
            flat, method="vertical" if method == "lookup" else method)

    return score_batch


def make_comp_score_fn(n_hashes: int, method: str = "vertical"):
    """Compressed twin of ``make_score_fn``: score(dict_rows, refs,
    row_offset, block_width, terms int32 [L, 2], n_valid) -> int32
    [n_slots]. k=1 'lookup' runs the fused-decode kernel
    (``lookup_score_blocks_compressed``, for one block too); every other
    case gathers ``dict_rows[refs[rows]]``, ANDs and scores as
    ``make_score_fn`` does."""
    _check_method(method)

    def score(dict_rows, refs, row_offset, block_width, terms, n_valid):
        L = terms.shape[0]
        h = hashing.hash_terms(terms, n_hashes)            # [L, k]
        rows = plan_rows(h, row_offset, block_width)       # [L, k, nb]
        valid = torch.arange(L, device=terms.device) < int(n_valid)
        if method == "lookup" and n_hashes == 1:
            idx = rows[:, 0, :].T.contiguous()             # [nb, L]
            msk = valid.to(torch.int32)[None, :].expand(idx.shape)
            return ops.bitslice_lookup_score_blocks_comp(
                dict_rows, refs, idx, msk.contiguous())
        flat = gather_rows_comp(dict_rows, refs, rows, valid)
        return ops.bitslice_score(
            flat, method="vertical" if method == "lookup" else method)

    return score


def make_comp_batch_score_fn(n_hashes: int, method: str = "vertical",
                             grid_order: str = "wq"):
    """Compressed twin of ``make_batch_score_fn``: score(dict_rows, refs,
    row_offset, block_width, terms int32 [Q, L, 2], n_valid int32 [Q]) ->
    int32 [Q, n_slots]. k=1 'lookup' sends the batch to the fused-decode
    multi-query kernel; the other methods score the double gather with a
    batch axis."""
    _check_method(method)

    def score_batch(dict_rows, refs, row_offset, block_width, terms,
                    n_valid):
        Q, L = terms.shape[0], terms.shape[1]
        h = hashing.hash_terms(terms, n_hashes)            # [Q, L, k]
        rows = plan_rows(h, row_offset, block_width)       # [Q, L, k, nb]
        valid = (torch.arange(L, device=terms.device)[None, :]
                 < n_valid[:, None])                       # [Q, L]
        if method == "lookup" and n_hashes == 1:
            idx = rows[:, :, 0, :].transpose(1, 2).contiguous()  # [Q, nb, L]
            msk = valid.to(torch.int32)[:, None, :].expand(idx.shape)
            return ops.bitslice_lookup_score_multi_comp(
                dict_rows, refs, idx, msk.contiguous(),
                grid_order=grid_order)
        flat = gather_rows_comp(dict_rows, refs, rows, valid)
        return ops.bitslice_score(
            flat, method="vertical" if method == "lookup" else method)

    return score_batch


class QueryEngine:
    """Search over a BitSlicedIndex on ``device`` (None = the CUDA card).

    method: 'vertical' (default, vertical-counter kernel), 'unpack'
    (paper-faithful kernel), 'lookup' (fused gather kernel for k=1
    indexes) or 'ref' (plain oracle).

    Dense storage (one shard) is scored in one device call against its
    tile. Sharded storage is scored shard by shard through ``tile_cache``
    (default: an unbounded DeviceTileCache, so every shard stays on the
    card after its first use) and concatenated; the results are the same
    either way. ``compressed=True`` keeps dict-coded shards (codec
    'rowdict' / 'rowdict+rle') in their (dict, refs) form on the device
    and scores them through the fused-decode kernels; raw shards are
    unaffected, and the flag stays off when no shard is dict-coded.

    ``search_pruned``, ``search_batch_pruned`` and ``top_k_pruned`` run
    the branch-and-bound executor (``run_paged_pruned``) over term chunks
    of ``prune_chunk`` terms; their results equal the unpruned ones.
    """

    def __init__(self, index: BitSlicedIndex, method: str = "vertical",
                 term_pad: int = 64,
                 tile_cache: DeviceTileCache | None = None,
                 compressed: bool = False, prune_chunk: int = 32,
                 device=None):
        self.device = resolve_device(device)
        if index.device.type != self.device.type or (
                self.device.index is not None
                and index.device.index != self.device.index):
            raise ValueError(f"the index lives on {index.device}, the engine "
                             f"on {self.device}")
        self.index = index
        self.method = method
        self.term_pad = term_pad
        self.prune_chunk = prune_chunk
        n_hashes = index.params.n_hashes
        self._score = make_score_fn(n_hashes, method)
        self._score_batch = make_batch_score_fn(n_hashes, method)
        self._paged = index.storage.n_shards > 1
        self.tiles = (tile_cache if tile_cache is not None
                      else DeviceTileCache(index.storage))
        self._shard_plans = plan_shards(index.layout,
                                        index.storage.shard_row_starts)
        # per-shard addressing on the device, staged once
        self._shard_args = [
            (sp.shard, torch.from_numpy(sp.row_offset).to(index.device),
             torch.from_numpy(sp.block_width).to(index.device))
            for sp in self._shard_plans]
        self._host_slot = np.asarray(index.layout.doc_slot)
        self.compressed = bool(compressed) and any(
            index.storage.shard_codec(s) in _codec.DICT_CODECS
            for s in range(index.storage.n_shards))
        self._score_comp = self._score_batch_comp = None
        if self.compressed:
            self._score_comp = make_comp_score_fn(n_hashes, method)
            self._score_batch_comp = make_comp_batch_score_fn(n_hashes,
                                                              method)

    def _terms(self, terms: np.ndarray) -> torch.Tensor:
        return _to_device(np.asarray(terms, dtype=np.uint32),
                          self.index.device)

    # -- scoring -------------------------------------------------------------
    def _slots(self, fn, fn_comp, axis: int, *args) -> np.ndarray:
        """Slot scores of ``fn`` (or ``fn_comp`` on dict-coded shards)
        over every shard, concatenated along ``axis``."""
        if not self._paged:
            if self.compressed:
                dict_rows, refs = self.tiles.get_compressed(0)
                out = fn_comp(dict_rows, refs, self.index.row_offset,
                              self.index.block_width, *args)
            else:
                out = fn(self.tiles.get(0), self.index.row_offset,
                         self.index.block_width, *args)
            return out.cpu().numpy()
        if self.compressed:
            parts = run_paged_compressed(self.tiles, self._shard_args, fn,
                                         fn_comp, *args)
        else:
            parts = run_paged(self.tiles, self._shard_args, fn, *args)
        return np.concatenate(parts, axis=axis)

    def score_terms(self, terms: np.ndarray) -> np.ndarray:
        """Distinct packed terms [L, 2] -> int32 scores [n_docs] (original
        document order)."""
        padded, L = pad_terms(terms, self.term_pad)
        slots = self._slots(self._score, self._score_comp, 0,
                            self._terms(padded), L)
        return slots[self._host_slot]

    def score_terms_batch(self, terms: np.ndarray, n_valid: np.ndarray
                          ) -> np.ndarray:
        """terms [Q, L, 2], n_valid [Q] -> scores [Q, n_docs]."""
        n_valid = torch.from_numpy(
            np.asarray(n_valid, dtype=np.int32)).to(self.index.device)
        slots = self._slots(self._score_batch, self._score_batch_comp, 1,
                            self._terms(terms), n_valid)
        return slots[:, self._host_slot]

    # -- search --------------------------------------------------------------
    def search(self, pattern, threshold: float = 0.8) -> SearchResult:
        """pattern: DNA string or uint8 code array. Reports every document
        whose q-gram score is >= ceil(threshold * ell), best first."""
        terms = compile_pattern(pattern, self.index.params)
        if terms.shape[0] == 0:
            return _empty()
        return select_hits(self.score_terms(terms), terms.shape[0], threshold)

    def search_batch(self, patterns: list, threshold: float = 0.8
                     ) -> list[SearchResult]:
        """Batched search with shared padding."""
        term_sets = [compile_pattern(p, self.index.params) for p in patterns]
        buf, ells = pad_term_batch(term_sets, self.term_pad)
        scores = self.score_terms_batch(buf, ells)
        return [select_hits(scores[i], int(ell), threshold)
                for i, ell in enumerate(ells)]

    def top_k(self, pattern, k: int = 10) -> SearchResult:
        """Rank documents by q-gram score and return the top k;
        ``threshold`` reports the k-th best score."""
        terms = compile_pattern(pattern, self.index.params)
        if terms.shape[0] == 0:
            return _empty()
        return select_top_k(self.score_terms(terms), terms.shape[0], k)

    # -- pruned search (branch-and-bound over the coverage cutoff) -----------
    def _pruned_doc_scores(self, term_sets: list[np.ndarray],
                           required: np.ndarray, topk: np.ndarray,
                           stats: PruneStats | None) -> np.ndarray:
        buf, ells = pad_term_batch(term_sets, self.term_pad)
        slots = run_paged_pruned(
            self.tiles, self._shard_plans, buf, ells, required, topk,
            n_hashes=self.index.params.n_hashes,
            chunk_terms=self.prune_chunk, stats=stats)
        return slots[:, self._host_slot]

    def search_pruned(self, pattern, threshold: float = 0.8,
                      stats: PruneStats | None = None) -> SearchResult:
        """``search`` through the pruned executor: the same results, with
        arena reads and kernel work cut by the threshold's kill rate
        (``stats`` receives the accounting)."""
        return self.search_batch_pruned([pattern], threshold, stats=stats)[0]

    def search_batch_pruned(self, patterns: list, threshold: float = 0.8,
                            stats: PruneStats | None = None
                            ) -> list[SearchResult]:
        """Batched twin of ``search_pruned``."""
        term_sets = [compile_pattern(p, self.index.params) for p in patterns]
        required = np.array([coverage_cutoff(threshold, t.shape[0])
                             for t in term_sets], dtype=np.int64)
        topk = np.zeros(len(term_sets), dtype=np.int32)
        scores = self._pruned_doc_scores(term_sets, required, topk, stats)
        return [select_hits(scores[i], int(t.shape[0]), threshold)
                for i, t in enumerate(term_sets)]

    def top_k_pruned(self, pattern, k: int = 10,
                     stats: PruneStats | None = None) -> SearchResult:
        """``top_k`` through the pruned executor: the cutoff tightens to the
        merged k-th largest running count as chunks accumulate, so blocks
        that cannot reach the top k stop being scored."""
        terms = compile_pattern(pattern, self.index.params)
        if terms.shape[0] == 0:
            return _empty()
        scores = self._pruned_doc_scores(
            [terms], np.zeros(1, np.int64), np.array([k], np.int32), stats)
        return select_top_k(scores[0], terms.shape[0], k)
