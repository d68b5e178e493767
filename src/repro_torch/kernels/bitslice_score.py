"""Wrappers around the hand-written CUDA scoring kernels, each with its plain
PyTorch version beside it.

The query's per-term work is: fetch the term's bit-sliced row (W words =
32W documents) and add each document's bit into its int32 count. Ten
CUDA kernels (``csrc/bitslice_score.cu``) carry the thirteen Pallas entry
points of ``repro.kernels.bitslice_score``:

* ``unpack_score``   - shift-and-mask each word into 32 counts;
* ``vertical_score`` - Harley-Seal counter planes, expanded once;
* ``lookup_score``, ``lookup_score_blocks``, ``lookup_score_multi`` - one
  fused gather + vertical count over [Q, nb, L] row indices;
* ``lookup_score_blocks_compressed``, ``lookup_score_multi_compressed`` -
  the same over a rowdict pair, reading row r as ``dict[refs[r]]``
  without expanding the tile;
* ``chunk_lookup_score_multi``, ``chunk_lookup_score_multi_compressed``,
  ``chunk_dedup_score`` - one term chunk of the pruned and bulk
  executors, added into a running-count buffer ``acc``;
* ``gather_rows``, ``gather_rows_compressed``, ``dedup_score`` - the
  server's row-dedup pair: each unique row (or ANDed row set) of a batch
  gathered once, then every cell scored through an indirection into
  those rows.

Two kernels have no Pallas counterpart: ``select_scores``, the server's
selection of a dense batch's hits (slot order to document order, the
coverage cutoff, the hits compacted), which the JAX server makes on the
host; and ``lookup_score_grouped``, the fused lookup's grouped form,
which scores every block of a ``BlockTable`` (blocks of resident tiles)
for a batch in one launch, hashing and planning each term's row in the
kernel, where the JAX engine launches a lookup a shard.

Each wrapper checks device, dtype (int32 words), shape and contiguity.
For a CPU tensor it calls the plain version; for a CUDA tensor it launches
the kernel on the current stream, or raises. ``lookup_score_grouped``
launches only: its plain version hashes terms, and lives beside the hash
in the query engine (``core.query.lookup_grouped_plain``).
``launches[name]`` counts the kernel launches of each wrapper and nothing
else.

No wrapper limits the number of terms. ``vertical_score``, the three fused
lookups, the two fused-decode lookups, the three chunk wrappers and
``dedup_score`` take any L in one launch (their kernels split the term axis
across a block's threads and flush full counters into the block's counts),
and so does ``unpack_score`` (a warp per word splits the terms, its lanes
counting in int32).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import _build

# cluster size argument of the entry points of _build.SPLIT_KERNELS: 0 lets
# the entry point choose (1 = no cluster; 2, 4 or 8 blocks share a word
# tile's terms)
CLUSTER_AUTO = 0
GRID_ORDERS = ("wq", "qw")

launches: dict[str, int] = {"unpack_score": 0, "vertical_score": 0,
                            "lookup_score": 0, "lookup_score_blocks": 0,
                            "lookup_score_multi": 0,
                            "lookup_score_grouped": 0,
                            "lookup_score_blocks_compressed": 0,
                            "lookup_score_multi_compressed": 0,
                            "chunk_lookup_score_multi": 0,
                            "chunk_lookup_score_multi_compressed": 0,
                            "chunk_dedup_score": 0, "gather_rows": 0,
                            "gather_rows_compressed": 0, "dedup_score": 0,
                            "select_scores": 0}


# kernels launch from more than one host thread (a serving loop's worker
# and a bulk lane's), and ``+= 1`` on a dict entry is not atomic
_launches_lock = threading.Lock()


def _count(name: str) -> None:
    with _launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _launches_lock:
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


def _rows_launch(name: str, symbol: str, rows: torch.Tensor
                 ) -> torch.Tensor:
    """Launch C entry point ``symbol`` on rows [L, W] or [B, L, W], once
    for any L, at the cluster size the entry point picks."""
    r3 = rows if rows.dim() == 3 else rows[None]
    B, L, W = r3.shape
    out = torch.empty((B, W, 32), dtype=torch.int32, device=rows.device)
    if out.numel():
        _build.launch(symbol, r3.data_ptr(), out.data_ptr(), B, L, W,
                      CLUSTER_AUTO, rows.device.index or 0,
                      _stream(rows.device))
        _count(name)
    return out if rows.dim() == 3 else out[0]


def unpack_score(rows: torch.Tensor) -> torch.Tensor:
    """int32 [L, W] -> int32 [W, 32] per-bit counts (a leading batch axis
    [B, L, W] gives [B, W, 32]). Replaces the Pallas ``unpack_score``; any
    L in one launch."""
    _check("rows", rows, (2, 3))
    if not _on_cuda(rows):
        return unpack_score_plain(rows)
    return _rows_launch("unpack_score", "cobs_unpack", rows)


def vertical_score(rows: torch.Tensor) -> torch.Tensor:
    """int32 [L, W] -> int32 [W, 32] through vertical counters (a leading
    batch axis [B, L, W] gives [B, W, 32]). Replaces the Pallas
    ``vertical_score``; any L in one launch."""
    _check("rows", rows, (2, 3))
    if not _on_cuda(rows):
        return vertical_score_plain(rows)
    return _rows_launch("vertical_score", "cobs_vertical", rows)


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
    """idx and mask: int32 of ``rank`` dimensions and one shape."""
    _check("rows_idx", rows_idx, (rank,))
    _check("mask", mask, (rank,))
    if mask.shape != rows_idx.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != rows_idx shape "
                         f"{tuple(rows_idx.shape)}")


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
    if not cuda:
        return lookup_plain(arena, rows_idx, mask)
    return _lookup_launch(name, "cobs_lookup", (arena.data_ptr(),), rows_idx,
                          mask, W, arena.device)


def _lookup_launch(name: str, symbol: str, head: tuple[int, ...],
                   rows_idx: torch.Tensor, mask: torch.Tensor, W: int,
                   dev: torch.device) -> torch.Tensor:
    """One launch of a split lookup entry point (``cobs_lookup`` after the
    arena, ``cobs_lookup_comp`` after the rowdict pair, ``cobs_dedup_score``
    after uniq; ``head`` holds their pointers) for any L, at the cluster
    size the entry point picks."""
    out = torch.empty(rows_idx.shape[:-1] + (W, 32), dtype=torch.int32,
                      device=dev)
    if out.numel():
        L = rows_idx.shape[-1]
        _build.launch(symbol, *head, rows_idx.data_ptr(), mask.data_ptr(),
                      out.data_ptr(), rows_idx.shape[:-1].numel(), L, W,
                      CLUSTER_AUTO, dev.index or 0, _stream(dev))
        _count(name)
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
    (query, block, word tile) is its own block (or cluster) of threads."""
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"unknown grid_order {grid_order!r}; "
                         f"one of {GRID_ORDERS}")
    return _lookup("lookup_score_multi", arena, rows_idx, mask, 3)


# --------------------------------------------------------------------------
# grouped lookup: the blocks of a block table, from the batch's packed
# terms, hashed and planned in the kernel -> out [Q, n_blocks, W, 32]
# --------------------------------------------------------------------------

# an entry of the kernel's table (csrc/bitslice_score.cu: LookupBlock)
_BLOCK_ENTRY = np.dtype([("rows", "<u8"), ("row_offset", "<i4"),
                         ("width", "<i4"), ("slot", "<i4"), ("pad", "<i4")])


class BlockTable:
    """The blocks one grouped lookup (``lookup_score_grouped``) scores:
    entry e is the block of rows [row_offset[e], row_offset[e] + width[e])
    of ``tiles[tile_of[e]]`` (int32 [R, W]; ``width`` is the hash's
    modulus; ``tile_of`` None: tile e), and its counts go to ``slot[e]``
    on the output's block axis of ``n_blocks``. Built once on the host: a
    block whose rows pass its tile raises ``IndexError`` here, so the
    kernel reads only rows in range with no check a launch. On a CUDA device the entries are uploaded once,
    as the kernel's 24-byte structs. The table keeps no tile, only the
    tiles' data pointers (``ptrs``): a launch is given the tiles
    themselves, which hold the memory the entries point at."""

    def __init__(self, tiles: list[torch.Tensor], row_offset, width, slot,
                 n_blocks: int, tile_of=None):
        self.row_offset = np.asarray(row_offset, dtype=np.int64)
        self.width = np.asarray(width, dtype=np.int64)
        self.slot = np.asarray(slot, dtype=np.int64)
        self.n_blocks = int(n_blocks)
        n = self.row_offset.shape[0]
        self.tile_of = (np.arange(len(tiles)) if tile_of is None
                        else np.asarray(tile_of, dtype=np.int64))
        if not n or any(a.shape != (n,) for a in
                        (self.width, self.slot, self.tile_of)):
            raise ValueError("a block table needs one tile, row offset, "
                             "width and slot for each of its (>= 1) entries")
        if ((self.tile_of < 0) | (self.tile_of >= len(tiles))).any():
            raise ValueError(f"an entry's tile is not one of {len(tiles)}")
        for t in tiles:
            _check("tile", t, (2,))
        self.W = int(tiles[0].shape[1])
        self.device = tiles[0].device
        if any(t.shape[1] != self.W for t in tiles):
            raise ValueError("the tiles of a block table differ in width")
        _on_cuda(*tiles)
        heights = np.array([t.shape[0] for t in tiles],
                           dtype=np.int64)[self.tile_of]
        bad = np.nonzero((self.row_offset < 0) | (self.width < 1)
                         | (self.row_offset + self.width > heights))[0]
        if bad.size:
            e = int(bad[0])
            raise IndexError(
                f"block {e}'s rows [{self.row_offset[e]}, "
                f"{self.row_offset[e] + self.width[e]}) outside its tile's "
                f"{heights[e]} rows")
        if ((self.slot < 0) | (self.slot >= self.n_blocks)).any() or \
                np.unique(self.slot).size != n:
            raise ValueError(f"block slots must be distinct and in "
                             f"[0, {self.n_blocks})")
        self.ptrs = tuple(t.data_ptr() for t in tiles)
        self.entries = None
        if self.device.type == "cuda":
            host = np.zeros(n, dtype=_BLOCK_ENTRY)
            host["rows"] = np.asarray(self.ptrs, dtype=np.uint64)[
                self.tile_of]
            host["row_offset"] = self.row_offset
            host["width"] = self.width
            host["slot"] = self.slot
            self.entries = torch.from_numpy(host.view(np.uint8)).to(
                self.device)

    def __len__(self) -> int:
        return self.row_offset.shape[0]

    def check_tiles(self, tiles: list[torch.Tensor]) -> None:
        """Raises unless ``tiles`` are the table's, tile for tile (the
        same data pointers): those its entries point at."""
        if tuple(t.data_ptr() for t in tiles) != self.ptrs:
            raise ValueError("the tiles given are not the block table's")


def lookup_score_grouped(table: BlockTable, tiles: list[torch.Tensor],
                         terms: torch.Tensor, n_valid: torch.Tensor | None,
                         out: torch.Tensor) -> torch.Tensor:
    """Grouped fused lookup, on CUDA tensors only: ``tiles`` the table's
    (held by the caller until the launch is ordered), terms int32
    [Q, L, 2] (packed lo, hi words), n_valid int32 [Q] (a query's terms
    from n_valid[q] on count nothing; None: every term counts), out int32
    [Q, n_blocks, W, 32]. Writes the counts of every block of ``table``
    for every query into out at the block's slot, one launch for any L,
    and leaves out's other blocks as they are; returns out. Each term's
    row is the term's hash (``core.hashing.hash_terms``, one hash) modulo
    the block's width plus its offset, computed in the kernel, as the
    query engine plans a k = 1 lookup's rows; its plain version, which
    hashes on the host side, is ``core.query.lookup_grouped_plain``. No
    Pallas counterpart (the JAX engine launches a lookup a shard)."""
    _check("terms", terms, (3,))
    _check("out", out, (4,))
    Q, L, two = terms.shape
    if two != 2:
        raise ValueError(f"terms must be [Q, L, 2], got {tuple(terms.shape)}")
    if out.shape != (Q, table.n_blocks, table.W, 32):
        raise ValueError(f"out shape {tuple(out.shape)} != [{Q}, "
                         f"{table.n_blocks}, {table.W}, 32]")
    if n_valid is not None:
        _check("n_valid", n_valid, (1,))
        if n_valid.shape[0] != Q:
            raise ValueError(f"{n_valid.shape[0]} counts for {Q} queries")
    table.check_tiles(tiles)
    if not _on_cuda(tiles[0], terms, out,
                    *(() if n_valid is None else (n_valid,))):
        raise ValueError("the grouped lookup launches on a CUDA device; on "
                         "the CPU its plain version scores")
    dev = out.device
    _build.launch("cobs_lookup_grouped", table.entries.data_ptr(),
                  len(table), terms.data_ptr(),
                  None if n_valid is None else n_valid.data_ptr(),
                  out.data_ptr(), Q, table.n_blocks, L, table.W,
                  CLUSTER_AUTO, dev.index or 0, _stream(dev))
    _count("lookup_score_grouped")
    return out


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
    return _lookup_launch(name, "cobs_lookup_comp",
                          (dict_rows.data_ptr(), refs.data_ptr()), rows_idx,
                          mask, dict_rows.shape[1], dict_rows.device)


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
    """Shared checks and launch of the chunk wrappers: one launch for any
    L, at the cluster size the entry point picks. rows_idx indexes
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
    head = ((rows.data_ptr(),) if refs is None
            else (rows.data_ptr(), refs.data_ptr()))
    out = torch.empty_like(acc)            # never acc: they must not overlap
    if out.numel():
        _build.launch(symbol, *head, rows_idx.data_ptr(), mask.data_ptr(),
                      acc.data_ptr(), out.data_ptr(), Q * nb, L, W,
                      acc.shape[2], CLUSTER_AUTO, rows.device.index or 0,
                      _stream(rows.device))
        _count(name)
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


# --------------------------------------------------------------------------
# the row-dedup pair: unique rows gathered once into uniq [U, W], then every
# (query, block) cell scored through indir [Q, nb, L] into uniq
# --------------------------------------------------------------------------

def gather_plain(arena: torch.Tensor, uniq_idx: torch.Tensor
                 ) -> torch.Tensor:
    """Plain version of ``gather_rows``: ``arena[uniq_idx]`` for a flat
    list [U]; for row sets [U, k] the k gathered rows of each set ANDed."""
    g = arena[uniq_idx.long()]
    if uniq_idx.dim() == 1:
        return g
    out = g[:, 0]
    for j in range(1, uniq_idx.shape[1]):
        out = out & g[:, j]
    return out.contiguous()


def gather_comp_plain(dict_rows: torch.Tensor, refs: torch.Tensor,
                      uniq_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_rows_compressed``: ``gather_plain`` of
    ``dict_rows`` at ``refs[uniq_idx]``."""
    return gather_plain(dict_rows, refs[uniq_idx.long()])


def dedup_plain(uniq: torch.Tensor, indir: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dedup_score``: the fused lookup's plain version
    with ``uniq`` in the arena's place."""
    return lookup_plain(uniq, indir, mask)


def _gather(name: str, symbol: str, rows: torch.Tensor,
            refs: torch.Tensor | None, uniq_idx: torch.Tensor,
            range_checked: bool) -> torch.Tensor:
    """Shared checks and launch of the two gathers. uniq_idx indexes
    ``refs`` when given, else ``rows``; on a CUDA tensor the range check
    costs one device sync, which callers that checked the indices on the
    host before the upload skip with ``range_checked``."""
    _check("uniq_idx", uniq_idx, (1, 2))
    if uniq_idx.dim() == 2 and uniq_idx.shape[1] == 0:
        raise ValueError("uniq_idx [U, k] needs k >= 1")
    cuda = _on_cuda(rows, uniq_idx, *(() if refs is None else (refs,)))
    if not cuda or not range_checked:
        _check_range(uniq_idx, (rows if refs is None else refs).shape[0],
                     "the gather's row source")
    if not cuda:
        return (gather_plain(rows, uniq_idx) if refs is None
                else gather_comp_plain(rows, refs, uniq_idx))
    U, W = uniq_idx.shape[0], rows.shape[1]
    k = 1 if uniq_idx.dim() == 1 else uniq_idx.shape[1]
    out = torch.empty((U, W), dtype=torch.int32, device=rows.device)
    if out.numel():
        head = ((rows.data_ptr(),) if refs is None
                else (rows.data_ptr(), refs.data_ptr()))
        _build.launch(symbol, *head, uniq_idx.data_ptr(), out.data_ptr(), U,
                      k, W, rows.device.index or 0, _stream(rows.device))
        _count(name)
    return out


def gather_rows(arena: torch.Tensor, uniq_idx: torch.Tensor, *,
                range_checked: bool = False) -> torch.Tensor:
    """Unique-row gather: arena int32 [R, W], uniq_idx int32 [U] -> int32
    [U, W], each listed row read once. A [U, k] list of row sets gives the
    AND of each set's k rows (one launch where the JAX wrapper gathers k
    times and ANDs). Replaces the Pallas ``gather_rows``."""
    _check("arena", arena, (2,))
    return _gather("gather_rows", "cobs_gather_rows", arena, None, uniq_idx,
                   range_checked)


def gather_rows_compressed(dict_rows: torch.Tensor, refs: torch.Tensor,
                           uniq_idx: torch.Tensor, *,
                           range_checked: bool = False) -> torch.Tensor:
    """``gather_rows`` over a rowdict pair (dict [D, W], refs [R]): out[u]
    = dict[refs[uniq_idx[u]]], ANDed over k for [U, k] sets. ``refs`` must
    lie in [0, D), which the tile cache checks when it stages the pair.
    Replaces the Pallas ``gather_rows_compressed``."""
    _check("dict_rows", dict_rows, (2,))
    _check("refs", refs, (1,))
    return _gather("gather_rows_compressed", "cobs_gather_rows_comp",
                   dict_rows, refs, uniq_idx, range_checked)


def dedup_score(uniq: torch.Tensor, indir: torch.Tensor, mask: torch.Tensor,
                *, range_checked: bool = False) -> torch.Tensor:
    """Indirected multi-query score: uniq int32 [U, W] (from a gather),
    indir / mask int32 [Q, nb, L] -> int32 [Q, nb, W, 32]; a term counts
    where its mask is non-zero. Replaces the Pallas ``dedup_score``; any L
    in one launch."""
    _check("uniq", uniq, (2,))
    _check_indices(indir, mask, 3)
    cuda = _on_cuda(uniq, indir, mask)
    if not cuda or not range_checked:
        _check_range(indir, uniq.shape[0], "uniq")
    if not cuda:
        return dedup_plain(uniq, indir, mask)
    return _lookup_launch("dedup_score", "cobs_dedup_score",
                          (uniq.data_ptr(),), indir, mask, uniq.shape[1],
                          uniq.device)


# --------------------------------------------------------------------------
# selection: a dense batch's scores [>= Q, S] in slot order -> each query's
# hit list, the count and then (document, score) pairs in document order
# --------------------------------------------------------------------------

def select_plain(scores: torch.Tensor, doc_slot: torch.Tensor,
                 cut: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of ``select_scores``: each query's scores in document
    order, the documents at or above its cutoff, the first ``cap`` of
    them written as (document, score) pairs."""
    Q = cut.shape[0]
    out = torch.zeros((Q, 1 + 2 * cap), dtype=torch.int32,
                      device=scores.device)
    docs = scores[:Q, doc_slot.long()]              # [Q, n_docs]
    for q in range(Q):
        hit = torch.nonzero(docs[q] >= cut[q]).flatten()
        k = min(hit.shape[0], cap)
        out[q, 0] = hit.shape[0]
        out[q, 1:1 + 2 * k:2] = hit[:k].to(torch.int32)
        out[q, 2:2 + 2 * k:2] = docs[q, hit[:k]]
    return out


def select_scores(scores: torch.Tensor, doc_slot: torch.Tensor,
                  cut: torch.Tensor, cap: int, *,
                  range_checked: bool = False) -> torch.Tensor:
    """A dense batch's hits: scores int32 [R, S] in slot order (rows past
    Q = len(cut) are not read), doc_slot int32 [n_docs] (document d's
    slot, in [0, S)), cut int32 [Q] -> int32 [Q, 1 + 2 * cap]. Row q
    holds the number of documents d with ``scores[q, doc_slot[d]] >=
    cut[q]``, then the first ``cap`` of them as (d, score) pairs in
    ascending d, then zeros. A count above ``cap`` says the list was cut.
    No Pallas counterpart (the JAX server selects on the host). On a CUDA
    tensor the range check of ``doc_slot`` costs one device sync, which
    callers that checked it on the host before the upload skip with
    ``range_checked``."""
    _check("scores", scores, (2,))
    _check("doc_slot", doc_slot, (1,))
    _check("cut", cut, (1,))
    Q, (R, S) = cut.shape[0], scores.shape
    if Q > R:
        raise ValueError(f"{Q} cutoffs for {R} score rows")
    if not 1 <= cap < 1 << 30:
        raise ValueError(f"cap must lie in [1, 2**30), got {cap}")
    cuda = _on_cuda(scores, doc_slot, cut)
    if (not cuda or not range_checked) and doc_slot.numel():
        lo, hi = torch.aminmax(doc_slot)
        if int(lo) < 0 or int(hi) >= S:
            raise IndexError(f"document slots [{int(lo)}, {int(hi)}] "
                             f"outside the scores' {S} slots")
    if not cuda:
        return select_plain(scores, doc_slot, cut, cap)
    out = torch.empty((Q, 1 + 2 * cap), dtype=torch.int32,
                      device=scores.device)
    if Q:
        _build.launch("cobs_select_hits", scores.data_ptr(),
                      doc_slot.data_ptr(), cut.data_ptr(), out.data_ptr(), Q,
                      S, doc_slot.shape[0], cap, scores.device.index or 0,
                      _stream(scores.device))
        _count("select_scores")
    return out
