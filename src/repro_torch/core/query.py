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
from .arena import ArenaLayout, DeviceTileCache
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
    """

    def __init__(self, index: BitSlicedIndex, method: str = "vertical",
                 term_pad: int = 64,
                 tile_cache: DeviceTileCache | None = None,
                 compressed: bool = False, device=None):
        self.device = resolve_device(device)
        if index.device.type != self.device.type or (
                self.device.index is not None
                and index.device.index != self.device.index):
            raise ValueError(f"the index lives on {index.device}, the engine "
                             f"on {self.device}")
        self.index = index
        self.method = method
        self.term_pad = term_pad
        n_hashes = index.params.n_hashes
        self._score = make_score_fn(n_hashes, method)
        self._score_batch = make_batch_score_fn(n_hashes, method)
        self._paged = index.storage.n_shards > 1
        self.tiles = (tile_cache if tile_cache is not None
                      else DeviceTileCache(index.storage))
        # per-shard addressing on the device, staged once
        self._shard_args = [
            (sp.shard, torch.from_numpy(sp.row_offset).to(index.device),
             torch.from_numpy(sp.block_width).to(index.device))
            for sp in plan_shards(index.layout,
                                  index.storage.shard_row_starts)]
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
        return torch.from_numpy(
            np.ascontiguousarray(terms, dtype=np.uint32).view(np.int32)
        ).to(self.index.device)

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
