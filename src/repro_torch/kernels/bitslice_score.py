"""Wrappers around the hand-written CUDA scoring kernels, each with its plain
PyTorch version beside it.

The query's per-term work is: fetch the term's bit-sliced row (W words =
32W documents) and add each document's bit into its int32 count. Seven
CUDA kernels (``csrc/bitslice_score.cu``) carry the ten Pallas entry
points of ``repro.kernels.bitslice_score`` that the query paths reach:

* ``unpack_score``   - shift-and-mask each word into 32 counts;
* ``vertical_score`` - Harley-Seal counter planes, expanded once;
* ``lookup_score``, ``lookup_score_blocks``, ``lookup_score_multi`` - one
  fused gather + vertical count over [Q, nb, L] row indices;
* ``lookup_score_blocks_compressed``, ``lookup_score_multi_compressed`` -
  the same over a rowdict pair, reading row r as ``dict[refs[r]]``
  without expanding the tile;
* ``chunk_lookup_score_multi``, ``chunk_lookup_score_multi_compressed``,
  ``chunk_dedup_score`` - one term chunk of the pruned and bulk
  executors, added into a running-count buffer ``acc``.

Each wrapper checks device, dtype (int32 words), shape and contiguity.
For a CPU tensor it calls the plain version; for a CUDA tensor it launches
the kernel on the current stream, or raises. ``launches[name]`` counts the
kernel launches of each wrapper and nothing else.
"""
from __future__ import annotations

import torch

from . import _build

MAX_PLANES = 16                       # the kernels' counter-plane registers
MAX_TERMS = (1 << MAX_PLANES) - 1     # the most terms 16 planes can count
GRID_ORDERS = ("wq", "qw")

launches: dict[str, int] = {"unpack_score": 0, "vertical_score": 0,
                            "lookup_score": 0, "lookup_score_blocks": 0,
                            "lookup_score_multi": 0,
                            "lookup_score_blocks_compressed": 0,
                            "lookup_score_multi_compressed": 0,
                            "chunk_lookup_score_multi": 0,
                            "chunk_lookup_score_multi_compressed": 0,
                            "chunk_dedup_score": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def num_planes(n_terms: int) -> int:
    """Counter planes that hold counts up to n_terms."""
    return max(1, int(n_terms).bit_length())


# --------------------------------------------------------------------------
# Checks shared by the wrappers
# --------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, ndims: tuple[int, ...]) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(f"{name} must have {' or '.join(map(str, ndims))} "
                         f"dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises for a mix or
    for any other device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def _check_terms(L: int) -> None:
    if L > MAX_TERMS:
        raise ValueError(f"{L} terms exceed the {MAX_TERMS} that "
                         f"{MAX_PLANES} counter planes hold")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# unpack and vertical: rows [L, W] or [B, L, W] -> [W, 32] or [B, W, 32]
# --------------------------------------------------------------------------

def unpack_score_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``unpack_score``: shift-and-mask into 32 counts."""
    shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
    return ((rows[..., None] >> shifts) & 1).sum(dim=-3, dtype=torch.int32)


def _ripple(planes: list[torch.Tensor], row: torch.Tensor) -> None:
    carry = row
    for j, p in enumerate(planes):
        planes[j] = p ^ carry
        carry = p & carry


def _expand(planes: list[torch.Tensor]) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=planes[0].device)
    out = torch.zeros(planes[0].shape + (32,), dtype=torch.int32,
                      device=planes[0].device)
    for j, p in enumerate(planes):
        out |= ((p[..., None] >> shifts) & 1) << j
    return out


def vertical_score_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``vertical_score``: ripple-carry each row into
    ``num_planes(L)`` counter planes, then expand once."""
    L = rows.shape[-2]
    planes = [torch.zeros_like(rows[..., 0, :])
              for _ in range(num_planes(L))]
    for l in range(L):
        _ripple(planes, rows[..., l, :])
    return _expand(planes)


def _rows_launch(name: str, symbol: str, rows: torch.Tensor, *extra: int
                 ) -> torch.Tensor:
    """Launch C entry point ``symbol`` on rows [L, W] or [B, L, W]."""
    r3 = rows if rows.dim() == 3 else rows[None]
    B, L, W = r3.shape
    out = torch.empty((B, W, 32), dtype=torch.int32, device=rows.device)
    if out.numel():
        _build.launch(symbol, r3.data_ptr(), out.data_ptr(), B, L, W, *extra,
                      rows.device.index or 0, _stream(rows.device))
        launches[name] += 1
    return out if rows.dim() == 3 else out[0]


def unpack_score(rows: torch.Tensor) -> torch.Tensor:
    """int32 [L, W] -> int32 [W, 32] per-bit counts (a leading batch axis
    [B, L, W] gives [B, W, 32]). Replaces the Pallas ``unpack_score``."""
    _check("rows", rows, (2, 3))
    if not _on_cuda(rows):
        return unpack_score_plain(rows)
    return _rows_launch("unpack_score", "cobs_unpack", rows)


def vertical_score(rows: torch.Tensor) -> torch.Tensor:
    """int32 [L, W] -> int32 [W, 32] through vertical counters (a leading
    batch axis [B, L, W] gives [B, W, 32]). Replaces the Pallas
    ``vertical_score``. Takes at most MAX_TERMS rows."""
    _check("rows", rows, (2, 3))
    _check_terms(rows.shape[-2])
    if not _on_cuda(rows):
        return vertical_score_plain(rows)
    return _rows_launch("vertical_score", "cobs_vertical", rows,
                        num_planes(rows.shape[-2]))


# --------------------------------------------------------------------------
# fused lookup: arena [R, W], rows_idx / mask [..., L] -> [..., W, 32]
# --------------------------------------------------------------------------

def lookup_plain(arena: torch.Tensor, rows_idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lookup_score``, ``lookup_score_blocks`` and
    ``lookup_score_multi``: gather each term's row, zero it where mask is
    0, ripple-carry into vertical counters over the last (term) axis, and
    expand."""
    L = rows_idx.shape[-1]
    planes = [torch.zeros(rows_idx.shape[:-1] + (arena.shape[1],),
                          dtype=torch.int32, device=arena.device)
              for _ in range(num_planes(L))]
    for l in range(L):
        row = arena[rows_idx[..., l].long()]
        _ripple(planes, torch.where(mask[..., l, None] != 0, row, 0))
    return _expand(planes)


def _check_indices(rows_idx: torch.Tensor, mask: torch.Tensor, rank: int
                   ) -> None:
    """idx and mask: int32 of ``rank`` dimensions and one shape, at most
    MAX_TERMS terms."""
    _check("rows_idx", rows_idx, (rank,))
    _check("mask", mask, (rank,))
    if mask.shape != rows_idx.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != rows_idx shape "
                         f"{tuple(rows_idx.shape)}")
    _check_terms(rows_idx.shape[-1])


def _check_range(rows_idx: torch.Tensor, R: int, what: str) -> None:
    """Every row index in [0, R) (one device-to-host sync)."""
    if rows_idx.numel():
        lo, hi = torch.aminmax(rows_idx)
        if int(lo) < 0 or int(hi) >= R:
            raise IndexError(f"row indices [{int(lo)}, {int(hi)}] outside "
                             f"{what}'s {R} rows")


def _lookup(name: str, arena: torch.Tensor, rows_idx: torch.Tensor,
            mask: torch.Tensor, rank: int) -> torch.Tensor:
    _check("arena", arena, (2,))
    _check_indices(rows_idx, mask, rank)
    cuda = _on_cuda(arena, rows_idx, mask)
    R, W = arena.shape
    _check_range(rows_idx, R, "the arena")
    L = rows_idx.shape[-1]
    if not cuda:
        return lookup_plain(arena, rows_idx, mask)
    cells = rows_idx.shape[:-1].numel()
    out = torch.empty(rows_idx.shape[:-1] + (W, 32), dtype=torch.int32,
                      device=arena.device)
    if out.numel():
        _build.launch("cobs_lookup", arena.data_ptr(), rows_idx.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), cells, L, W,
                      num_planes(L), arena.device.index or 0,
                      _stream(arena.device))
        launches[name] += 1
    return out


def lookup_score(arena: torch.Tensor, rows_idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Fused gather + score: arena int32 [R, W], rows_idx int32 [L],
    mask int32 [L] -> int32 [W, 32]. Replaces the Pallas ``lookup_score``."""
    return _lookup("lookup_score", arena, rows_idx, mask, 1)


def lookup_score_blocks(arena: torch.Tensor, rows_idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Multi-block fused gather + score: rows_idx, mask int32 [nb, L]
    -> int32 [nb, W, 32]. Replaces the Pallas ``lookup_score_blocks``."""
    return _lookup("lookup_score_blocks", arena, rows_idx, mask, 2)


def lookup_score_multi(arena: torch.Tensor, rows_idx: torch.Tensor,
                       mask: torch.Tensor, grid_order: str = "wq"
                       ) -> torch.Tensor:
    """Multi-query fused gather + score: rows_idx, mask int32 [Q, nb, L]
    -> int32 [Q, nb, W, 32]. Replaces the Pallas ``lookup_score_multi``.

    ``grid_order`` ('wq' or 'qw') is the autotuner's key for the TPU grid's
    axis order; it is validated and has no effect here, where every
    (query, block, word) item is its own thread."""
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"unknown grid_order {grid_order!r}; "
                         f"one of {GRID_ORDERS}")
    return _lookup("lookup_score_multi", arena, rows_idx, mask, 3)


# --------------------------------------------------------------------------
# fused-decode lookup: dict [D, W], refs [R], rows_idx / mask [..., L]
# -> [..., W, 32], scoring dict[refs[row]] where the raw lookup scores
# arena[row]
# --------------------------------------------------------------------------

def lookup_comp_plain(dict_rows: torch.Tensor, refs: torch.Tensor,
                      rows_idx: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of ``lookup_score_blocks_compressed`` and
    ``lookup_score_multi_compressed``: per term, the double gather
    ``dict_rows[refs[row]]`` (the tile is never expanded), zeroed where
    mask is 0, ripple-carried into vertical counters, then expanded."""
    L = rows_idx.shape[-1]
    planes = [torch.zeros(rows_idx.shape[:-1] + (dict_rows.shape[1],),
                          dtype=torch.int32, device=dict_rows.device)
              for _ in range(num_planes(L))]
    for l in range(L):
        row = dict_rows[refs[rows_idx[..., l].long()].long()]
        _ripple(planes, torch.where(mask[..., l, None] != 0, row, 0))
    return _expand(planes)


def _lookup_comp(name: str, dict_rows: torch.Tensor, refs: torch.Tensor,
                 rows_idx: torch.Tensor, mask: torch.Tensor, rank: int
                 ) -> torch.Tensor:
    """The fused-decode wrappers. ``refs`` must lie in [0, D): the tile
    cache checks that once, when it stages the pair, and this wrapper
    does not repeat it on every call."""
    _check("dict_rows", dict_rows, (2,))
    _check("refs", refs, (1,))
    _check_indices(rows_idx, mask, rank)
    cuda = _on_cuda(dict_rows, refs, rows_idx, mask)
    _check_range(rows_idx, refs.shape[0], "refs")
    if not cuda:
        return lookup_comp_plain(dict_rows, refs, rows_idx, mask)
    W = dict_rows.shape[1]
    L = rows_idx.shape[-1]
    cells = rows_idx.shape[:-1].numel()
    out = torch.empty(rows_idx.shape[:-1] + (W, 32), dtype=torch.int32,
                      device=dict_rows.device)
    if out.numel():
        _build.launch("cobs_lookup_comp", dict_rows.data_ptr(),
                      refs.data_ptr(), rows_idx.data_ptr(), mask.data_ptr(),
                      out.data_ptr(), cells, L, W, num_planes(L),
                      dict_rows.device.index or 0, _stream(dict_rows.device))
        launches[name] += 1
    return out


def lookup_score_blocks_compressed(dict_rows: torch.Tensor,
                                   refs: torch.Tensor,
                                   rows_idx: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
    """Fused-decode multi-block gather + score: dict_rows int32 [D, W],
    refs int32 [R], rows_idx, mask int32 [nb, L] -> int32 [nb, W, 32].
    Replaces the Pallas ``lookup_score_blocks_compressed``."""
    return _lookup_comp("lookup_score_blocks_compressed", dict_rows, refs,
                        rows_idx, mask, 2)


def lookup_score_multi_compressed(dict_rows: torch.Tensor,
                                  refs: torch.Tensor,
                                  rows_idx: torch.Tensor, mask: torch.Tensor,
                                  grid_order: str = "wq") -> torch.Tensor:
    """Fused-decode multi-query gather + score: rows_idx, mask int32
    [Q, nb, L] -> int32 [Q, nb, W, 32]. Replaces the Pallas
    ``lookup_score_multi_compressed``; ``grid_order`` is validated and has
    no effect, as for ``lookup_score_multi``."""
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"unknown grid_order {grid_order!r}; "
                         f"one of {GRID_ORDERS}")
    return _lookup_comp("lookup_score_multi_compressed", dict_rows, refs,
                        rows_idx, mask, 3)


# --------------------------------------------------------------------------
# chunked accumulators: one term chunk added into the running counts
# acc [Q, nb, Wp, 32] (Wp >= W; words >= W read as zero rows)
# --------------------------------------------------------------------------

def chunk_plain(rows: torch.Tensor, rows_idx: torch.Tensor,
                mask: torch.Tensor, acc: torch.Tensor,
                refs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the three chunk kernels: the fused lookup's counts
    of the chunk (``lookup_comp_plain`` when ``refs`` is given), padded
    from W to acc's Wp words with zeros, added to ``acc``."""
    counts = (lookup_plain(rows, rows_idx, mask) if refs is None
              else lookup_comp_plain(rows, refs, rows_idx, mask))
    out = acc.clone()
    out[..., :counts.shape[-2], :] += counts
    return out


def _chunk(name: str, symbol: str, rows: torch.Tensor,
           refs: torch.Tensor | None, rows_idx: torch.Tensor,
           mask: torch.Tensor, acc: torch.Tensor,
           range_checked: bool) -> torch.Tensor:
    """Shared checks and launch of the chunk wrappers. rows_idx indexes
    ``refs`` when given, else ``rows``. On a CUDA tensor the range check
    costs one device sync; callers that checked the indices on the host
    before the upload (the executors in ``core/query.py``) pass
    ``range_checked``."""
    _check("acc", acc, (4,))
    _check_indices(rows_idx, mask, 3)
    W = rows.shape[1]
    Q, nb, L = rows_idx.shape
    if acc.shape[:2] != (Q, nb) or acc.shape[3] != 32 or acc.shape[2] < W:
        raise ValueError(f"acc shape {tuple(acc.shape)} does not hold "
                         f"[{Q}, {nb}, >= {W}, 32] running counts")
    cuda = _on_cuda(rows, rows_idx, mask, acc,
                    *(() if refs is None else (refs,)))
    if not cuda or not range_checked:
        _check_range(rows_idx, (rows if refs is None else refs).shape[0],
                     "the chunk's row source")
    if not cuda:
        return chunk_plain(rows, rows_idx, mask, acc, refs)
    out = torch.empty_like(acc)
    if out.numel():
        head = ((rows.data_ptr(),) if refs is None
                else (rows.data_ptr(), refs.data_ptr()))
        _build.launch(symbol, *head, rows_idx.data_ptr(), mask.data_ptr(),
                      acc.data_ptr(), out.data_ptr(), Q * nb, L, W,
                      acc.shape[2], num_planes(L), rows.device.index or 0,
                      _stream(rows.device))
        launches[name] += 1
    return out


def chunk_lookup_score_multi(arena: torch.Tensor, rows_idx: torch.Tensor,
                             mask: torch.Tensor, acc: torch.Tensor, *,
                             range_checked: bool = False) -> torch.Tensor:
    """One term chunk fused-gathered from a resident tile: arena int32
    [R, W], rows_idx / mask int32 [Q, nb, Lc], acc int32 [Q, nb, Wp, 32]
    -> acc + the chunk's counts. Replaces the Pallas
    ``chunk_lookup_score_multi``."""
    _check("arena", arena, (2,))
    return _chunk("chunk_lookup_score_multi", "cobs_chunk_lookup", arena,
                  None, rows_idx, mask, acc, range_checked)


def chunk_lookup_score_multi_compressed(
        dict_rows: torch.Tensor, refs: torch.Tensor, rows_idx: torch.Tensor,
        mask: torch.Tensor, acc: torch.Tensor, *,
        range_checked: bool = False) -> torch.Tensor:
    """``chunk_lookup_score_multi`` over a resident rowdict pair (dict
    [D, W], refs [R]), reading row r as ``dict[refs[r]]``. ``refs`` must
    lie in [0, D), which the tile cache checks when it stages the pair.
    Replaces the Pallas ``chunk_lookup_score_multi_compressed``."""
    _check("dict_rows", dict_rows, (2,))
    _check("refs", refs, (1,))
    return _chunk("chunk_lookup_score_multi_compressed",
                  "cobs_chunk_lookup_comp", dict_rows, refs, rows_idx, mask,
                  acc, range_checked)


def chunk_dedup_score(uniq: torch.Tensor, indir: torch.Tensor,
                      mask: torch.Tensor, acc: torch.Tensor, *,
                      range_checked: bool = False) -> torch.Tensor:
    """One term chunk read through ``indir`` from the chunk's unique rows:
    uniq int32 [U, W], indir / mask int32 [Q, nb, Lc], acc int32
    [Q, nb, Wp, 32] -> acc + the chunk's counts. Replaces the Pallas
    ``chunk_dedup_score``."""
    _check("uniq", uniq, (2,))
    return _chunk("chunk_dedup_score", "cobs_chunk_dedup", uniq, None,
                  indir, mask, acc, range_checked)
