"""Public scoring operations, the counterparts of ``repro.kernels.ops``.

They keep the JAX wrappers' output shapes and (block, word, bit) slot
order. ``method='ref'`` runs the plain oracle of ``ref.py``; the other
methods go through the kernel wrappers in ``bitslice_score.py``, which take
any word count W, so no padding to a word block is needed (the JAX wrappers
pad W and slice back; the output is the same). The one exception is the
running-count buffer of the chunked executors, which keeps the JAX word
padding, so its shape and ``chunk_topk_lower``'s width are the JAX ones.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import bitslice_score as _k
from . import ref as _ref

METHODS = ("ref", "unpack", "vertical", "lookup")
DEFAULT_WORD_BLOCK = 128   # the TPU kernels' lane-aligned word block


def _word_block(W: int, word_block: int | None) -> int:
    """The JAX wrappers' word block for W words: the running-count
    buffers of the chunked executors pad their word axis to it."""
    wb = DEFAULT_WORD_BLOCK if word_block is None else int(word_block)
    return min(wb, max(8, W))


def bitslice_score(rows: torch.Tensor, method: str = "vertical"
                   ) -> torch.Tensor:
    """Score ADD step: int32 [L, W] masked rows -> int32 [W * 32]; a
    leading batch axis [B, L, W] gives [B, W * 32]. Zero rows add zero."""
    if method == "ref":
        return _ref.bitslice_score_ref(rows)
    if method == "unpack":
        out = _k.unpack_score(rows)
    elif method == "vertical":
        out = _k.vertical_score(rows)
    else:
        raise ValueError(f"unknown method {method!r}; one of "
                         "('ref', 'unpack', 'vertical')")
    return out.reshape(*rows.shape[:-2], -1)


def bitslice_lookup_score(arena: torch.Tensor, rows_idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Fused gather + score from the arena: rows_idx, mask int32 [L]
    -> int32 [W * 32]."""
    return _k.lookup_score(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_blocks(arena: torch.Tensor, rows_idx: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Multi-block fused gather + score: rows_idx, mask int32 [nb, L]
    -> int32 [nb * W * 32] in (block, word, bit) slot order."""
    return _k.lookup_score_blocks(arena, rows_idx, mask).reshape(-1)


def bitslice_lookup_score_multi(arena: torch.Tensor, rows_idx: torch.Tensor,
                                mask: torch.Tensor, grid_order: str = "wq"
                                ) -> torch.Tensor:
    """Multi-query fused gather + score: rows_idx, mask int32 [Q, nb, L]
    -> int32 [Q, nb * W * 32], each query in (block, word, bit) slot order.
    ``grid_order`` is accepted as the autotuner's key and validated."""
    out = _k.lookup_score_multi(arena, rows_idx, mask, grid_order=grid_order)
    return out.reshape(rows_idx.shape[0], -1)


BlockTable = _k.BlockTable


def bitslice_lookup_score_grouped(table: BlockTable,
                                  tiles: list[torch.Tensor],
                                  terms: torch.Tensor,
                                  n_valid: torch.Tensor | None,
                                  out: torch.Tensor) -> torch.Tensor:
    """Grouped fused gather + score on CUDA: every block of ``table`` (over
    ``tiles``) for every query of terms int32 [Q, L, 2] (n_valid int32
    [Q], or None: every term counts), written into out int32
    [Q, n_blocks * W * 32] at the block's slot, in (block, word, bit) slot
    order; out's other blocks are left as they are. Returns out."""
    _k.lookup_score_grouped(
        table, tiles, terms, n_valid,
        out.view(out.shape[0], table.n_blocks, table.W, 32))
    return out


def bitslice_lookup_score_blocks_comp(dict_rows: torch.Tensor,
                                      refs: torch.Tensor,
                                      rows_idx: torch.Tensor,
                                      mask: torch.Tensor) -> torch.Tensor:
    """``bitslice_lookup_score_blocks`` over a rowdict pair (dict [D, W],
    refs [R]): rows_idx, mask int32 [nb, L] -> int32 [nb * W * 32]."""
    return _k.lookup_score_blocks_compressed(dict_rows, refs, rows_idx,
                                             mask).reshape(-1)


def bitslice_lookup_score_multi_comp(dict_rows: torch.Tensor,
                                     refs: torch.Tensor,
                                     rows_idx: torch.Tensor,
                                     mask: torch.Tensor,
                                     grid_order: str = "wq") -> torch.Tensor:
    """``bitslice_lookup_score_multi`` over a rowdict pair: rows_idx, mask
    int32 [Q, nb, L] -> int32 [Q, nb * W * 32]."""
    out = _k.lookup_score_multi_compressed(dict_rows, refs, rows_idx, mask,
                                           grid_order=grid_order)
    return out.reshape(rows_idx.shape[0], -1)


def _check_word_block(word_block: int | None) -> None:
    """The JAX wrappers' tile width: validated, with no effect here (the
    kernels mask the ragged word edge instead of padding to it)."""
    if word_block is not None and int(word_block) < 1:
        raise ValueError(f"word_block must be positive, got {word_block}")


def bitslice_lookup_score_dedup(arena: torch.Tensor, uniq_rows: torch.Tensor,
                                indir: torch.Tensor, mask: torch.Tensor,
                                word_block: int | None = None, *,
                                range_checked: bool = False) -> torch.Tensor:
    """Row-dedup batched gather + score: (arena [R, W], uniq_rows int32 [U]
    or [U, k], indir / mask int32 [Q, nb, L]) -> int32 [Q, nb * W * 32] in
    (block, word, bit) slot order. ``gather_rows`` reads each unique row
    (each k-row set, ANDed) once into uniq [U, W]; ``dedup_score`` scores
    every cell through ``indir`` against it. Equal to
    ``bitslice_lookup_score_multi(arena, uniq_rows[indir], mask)`` for
    k = 1. ``range_checked`` says the caller checked uniq_rows against R
    and indir against U on the host."""
    _check_word_block(word_block)
    uniq = _k.gather_rows(arena, uniq_rows, range_checked=range_checked)
    out = _k.dedup_score(uniq, indir, mask, range_checked=range_checked)
    return out.reshape(indir.shape[0], -1)


def bitslice_score_dedup(uniq: torch.Tensor, indir: torch.Tensor,
                         mask: torch.Tensor, *, range_checked: bool = False
                         ) -> torch.Tensor:
    """The second half of the dedup pair over rows already gathered:
    uniq int32 [U, W] (each unique row or ANDed row set), indir / mask
    int32 [Q, nb, L] -> int32 [Q, nb * W * 32] in (block, word, bit) slot
    order."""
    out = _k.dedup_score(uniq, indir, mask, range_checked=range_checked)
    return out.reshape(indir.shape[0], -1)


def bitslice_lookup_score_dedup_comp(dict_rows: torch.Tensor,
                                     refs: torch.Tensor,
                                     uniq_rows: torch.Tensor,
                                     indir: torch.Tensor, mask: torch.Tensor,
                                     word_block: int | None = None, *,
                                     range_checked: bool = False
                                     ) -> torch.Tensor:
    """``bitslice_lookup_score_dedup`` over a rowdict pair (dict [D, W],
    refs [R]): ``gather_rows_compressed`` decodes each unique row (or k-row
    set, ANDed) as ``dict[refs[r]]``, then the same ``dedup_score``.
    int32 [Q, nb * W * 32]."""
    _check_word_block(word_block)
    uniq = _k.gather_rows_compressed(dict_rows, refs, uniq_rows,
                                     range_checked=range_checked)
    out = _k.dedup_score(uniq, indir, mask, range_checked=range_checked)
    return out.reshape(indir.shape[0], -1)


def and_rows(rows: torch.Tensor) -> torch.Tensor:
    """AND over the k hash rows: int32 [L, k, W] -> [L, W]."""
    return _ref.and_rows_ref(rows)


# --------------------------------------------------------------------------
# chunked scoring (the pruned and bulk executors)
# --------------------------------------------------------------------------
#
# The executors score terms in chunks and keep a per-(query, block)
# running-count buffer acc int32 [Q, nb, Wp, 32] on the device. Each chunk
# wrapper returns (acc', block_max int32 [Q, nb]); the executor brings only
# the block max to the host, for its survivor bound.


def chunk_acc_init(q: int, nb: int, w: int, word_block: int | None = None,
                   device=None) -> torch.Tensor:
    """Fresh running-count buffer int32 [Q, nb, Wp, 32] on ``device``
    (None = the CUDA card), its word axis padded as the JAX buffer's is."""
    wb = _word_block(w, word_block)
    wp = w + ((-w) % wb)
    return torch.zeros((q, nb, wp, 32), dtype=torch.int32,
                       device=resolve_device(device))


def chunk_acc_scores(acc: torch.Tensor, w: int) -> torch.Tensor:
    """Finished running counts -> int32 [Q, nb * W * 32] in the engine's
    (block, word, bit) slot order."""
    return acc[:, :, :w].reshape(acc.shape[0], -1)


def _with_block_max(acc: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    return acc, torch.amax(acc, dim=(2, 3))


def bitslice_chunk_score_dedup(uniq: torch.Tensor, indir: torch.Tensor,
                               mask: torch.Tensor, acc: torch.Tensor, *,
                               range_checked: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One term chunk against its unique-row matrix uniq int32 [U, W]:
    indir / mask int32 [Q, nb, Lc]. Returns (acc + chunk counts, per-block
    max int32 [Q, nb])."""
    return _with_block_max(_k.chunk_dedup_score(
        uniq, indir, mask, acc, range_checked=range_checked))


def bitslice_chunk_score_multi(arena: torch.Tensor, rows_idx: torch.Tensor,
                               mask: torch.Tensor, acc: torch.Tensor, *,
                               range_checked: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One term chunk fused-gathered from a resident shard tile. Returns
    (acc + chunk counts, per-block max int32 [Q, nb])."""
    return _with_block_max(_k.chunk_lookup_score_multi(
        arena, rows_idx, mask, acc, range_checked=range_checked))


def bitslice_chunk_score_multi_comp(dict_rows: torch.Tensor,
                                    refs: torch.Tensor,
                                    rows_idx: torch.Tensor,
                                    mask: torch.Tensor, acc: torch.Tensor, *,
                                    range_checked: bool = False
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One term chunk fused-decoded from a resident (dict, refs) pair.
    Returns (acc', per-block max)."""
    return _with_block_max(_k.chunk_lookup_score_multi_compressed(
        dict_rows, refs, rows_idx, mask, acc, range_checked=range_checked))


def chunk_topk_lower(acc: torch.Tensor, k: int) -> torch.Tensor:
    """Per-query k largest running counts of one shard's buffer, int32
    [Q, min(k, nb * Wp * 32)] descending (the padded words' zeros
    included, as in JAX). Running counts are lower bounds on final
    scores, so merging these across shards gives a sound top-k cutoff."""
    flat = acc.reshape(acc.shape[0], -1)
    return torch.topk(flat, min(int(k), flat.shape[1]), dim=1).values


def gather_and_rows(arena: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Device-side row sets of the promoted k>1 pruned path: tile int32
    [R, W], rows int32 [U, k] -> int32 [U, W], the k hash rows of each set
    ANDed."""
    return _ref.and_rows_ref(arena[rows.long()])  # [U, k, W] -> [U, W]


def gather_and_rows_comp(dict_rows: torch.Tensor, refs: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """``gather_and_rows`` against a resident (dict, refs) pair: the double
    gather decodes rowdict-coded rows on the fly."""
    return gather_and_rows(dict_rows, refs[rows.long()])


def bulk_query_chunk(nb: int, w: int, *, word_block: int | None = None,
                     budget_bytes: int = 32 * 2**20, floor: int = 8,
                     cap: int = 512) -> int:
    """Query-slab size of the shard-major bulk executor: the running-count
    buffer int32 [Qc, nb, Wp, 32] kept under ``budget_bytes``, rounded
    down to a power of two, within [floor, cap]. The JAX rule, kept so a
    sweep dispatches the same slabs."""
    wb = _word_block(w, word_block)
    wp = w + ((-w) % wb)
    per_q = max(1, nb * wp * 32 * 4)
    q = max(int(floor), int(budget_bytes) // per_q)
    q = 1 << (q.bit_length() - 1)                 # pow2 floor
    return int(min(int(cap), max(int(floor), q)))
