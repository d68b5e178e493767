"""Per-shard tile codecs: the compressed arena's encode/decode layer, a host
numpy copy of ``repro.core.codec`` (the port imports nothing of ``repro``).

Two codecs exploit two redundancy axes of a COBS arena, with a per-tile raw
fallback when neither pays:

* ``rowdict`` - dictionary of distinct rows. A tile [rows, W] becomes
  ``dict`` (uint32 [D, W], the distinct rows in ``np.unique`` order) +
  ``refs`` (int32 [rows], row -> dictionary slot). This is the device
  form: the DeviceTileCache stages (dict, refs) instead of the expanded
  tile, and the fused-decode CUDA kernels read row r as
  ``dict[refs[r]]``.

* ``bitplane_rle`` - zero-run-length coding over the tile's word stream
  (each arena row is one bit plane of the block's signature matrix, so
  sparse planes give long zero runs). Disk-only: decoded on the host.

* ``rowdict+rle`` - rowdict whose dictionary payload is RLE-coded on
  disk; its device form is still (dict, refs).

``encode_tile`` picks per tile and falls back to ``raw`` unless the coded
form is at least ``MIN_ENCODE_GAIN`` smaller. Decoding is exact, so a
store's content hashes (over the DECODED tile) survive raw<->compressed
migration.

The encoder stays in numpy on uint32 rows on purpose: the dictionary order
is ``np.unique(axis=0)`` over uint32 values, which is what makes the
component files byte-equal to the JAX package's. ``torch.unique(dim=0)``
on the port's int32 words would sort signed and give another order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CODEC_RAW = "raw"
CODEC_ROWDICT = "rowdict"
CODEC_RLE = "bitplane_rle"
CODEC_ROWDICT_RLE = "rowdict+rle"

CODECS = (CODEC_RAW, CODEC_ROWDICT, CODEC_RLE, CODEC_ROWDICT_RLE)
# codecs whose HBM form is (dict_rows, refs) — the kernels decode these
DICT_CODECS = (CODEC_ROWDICT, CODEC_ROWDICT_RLE)

# An encoded tile must be at least this factor smaller than raw, else the
# tile stays raw (decode cost must buy real bytes, not round-off).
MIN_ENCODE_GAIN = 1.05

# Component names -> on-disk file suffixes (see store._shard_files).
COMPONENT_SUFFIX = {
    "data": ".npy",          # raw tile
    "dict": ".dict.npy",     # rowdict distinct rows
    "refs": ".refs.npy",     # rowdict row -> dict slot
    "rle": ".rle.npy",       # zero-run stream (tile or dict payload)
}


# --------------------------------------------------------------------------
# bit-plane zero-run coding (pure numpy, fully vectorized both ways)
# --------------------------------------------------------------------------

def rle_encode(matrix: np.ndarray) -> np.ndarray:
    """uint32 [rows, W] -> uint32 stream.

    Layout (all uint32): [rows, W, n_pairs] header, then the zero-run
    lengths [n_pairs], the literal-run lengths [n_pairs], then the
    literal words in order. Runs alternate zero/literal starting with a
    (possibly empty) zero run; lengths cover the flat row-major stream.
    """
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    rows, W = matrix.shape
    flat = matrix.reshape(-1)
    n = flat.size
    if n == 0:
        return np.array([rows, W, 0], dtype=np.uint32)
    nz = flat != 0
    change = np.flatnonzero(nz[1:] != nz[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [n]])
    lens = (ends - starts).astype(np.int64)
    if nz[starts[0]]:                       # leads with literals: empty
        lens = np.concatenate([[0], lens])  # zero run keeps the phase
    if lens.size % 2:                       # trails with zeros: empty
        lens = np.concatenate([lens, [0]])  # literal run closes the pair
    z, lit = lens[0::2], lens[1::2]
    return np.concatenate([
        np.array([rows, W, z.size], dtype=np.uint32),
        z.astype(np.uint32), lit.astype(np.uint32),
        flat[nz]])


def rle_decode(stream: np.ndarray) -> np.ndarray:
    """Inverse of ``rle_encode``: uint32 stream -> uint32 [rows, W]."""
    stream = np.asarray(stream, dtype=np.uint32)
    rows, W, P = (int(stream[0]), int(stream[1]), int(stream[2]))
    z = stream[3: 3 + P].astype(np.int64)
    lit = stream[3 + P: 3 + 2 * P].astype(np.int64)
    literals = stream[3 + 2 * P:]
    out = np.zeros(rows * W, dtype=np.uint32)
    if literals.size:
        lit_cum = np.concatenate([[0], np.cumsum(lit)[:-1]])
        lit_starts = np.cumsum(z) + lit_cum        # flat start per run
        idx = (np.arange(literals.size, dtype=np.int64)
               + np.repeat(lit_starts - lit_cum, lit))
        out[idx] = literals
    return out.reshape(rows, W)


# --------------------------------------------------------------------------
# tile encode / decode
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressedTile:
    """One encoded shard tile: codec + named component arrays.

    Components by codec — raw: {data}; rowdict: {dict, refs};
    rowdict+rle: {rle (coded dict), refs}; bitplane_rle: {rle}.
    """
    codec: str
    rows: int
    doc_words: int
    arrays: dict

    @property
    def raw_nbytes(self) -> int:
        return self.rows * self.doc_words * 4

    @property
    def comp_nbytes(self) -> int:
        return int(sum(int(a.nbytes) for a in self.arrays.values()))

    @property
    def ratio(self) -> float:
        comp = self.comp_nbytes
        return self.raw_nbytes / comp if comp else 1.0

    def decode(self) -> np.ndarray:
        """The exact original tile, uint32 [rows, doc_words]."""
        if self.codec == CODEC_RAW:
            return np.asarray(self.arrays["data"])
        if self.codec == CODEC_RLE:
            return rle_decode(self.arrays["rle"])
        d, refs = self.dict_form()
        return np.ascontiguousarray(d[refs])

    def dict_form(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(dict_rows uint32 [D, W], refs int32 [rows]) for the rowdict
        codecs — the HBM-compressed form the kernels decode — else None."""
        if self.codec == CODEC_ROWDICT:
            return (np.asarray(self.arrays["dict"]),
                    np.asarray(self.arrays["refs"]))
        if self.codec == CODEC_ROWDICT_RLE:
            return (rle_decode(self.arrays["rle"]),
                    np.asarray(self.arrays["refs"]))
        return None


def _rowdict_split(matrix: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    uniq, inv = np.unique(matrix, axis=0, return_inverse=True)
    return (np.ascontiguousarray(uniq, dtype=np.uint32),
            np.ascontiguousarray(inv.reshape(-1), dtype=np.int32))


def encode_tile(matrix: np.ndarray, codec: str = "auto",
                min_gain: float = MIN_ENCODE_GAIN) -> CompressedTile:
    """Encode one tile. ``codec`` is a CODECS member or "auto" (smallest
    wins). Any choice — explicit included — falls back to raw when the
    coded form is not at least ``min_gain`` smaller than raw bytes."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    rows, W = matrix.shape
    if codec not in CODECS + ("auto",):
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    raw_nb = matrix.nbytes
    candidates: list[tuple[int, str, dict]] = []
    if codec in ("auto", CODEC_ROWDICT, CODEC_ROWDICT_RLE) and rows > 0:
        d, refs = _rowdict_split(matrix)
        if codec in ("auto", CODEC_ROWDICT):
            candidates.append((d.nbytes + refs.nbytes, CODEC_ROWDICT,
                               {"dict": d, "refs": refs}))
        if codec in ("auto", CODEC_ROWDICT_RLE):
            dr = rle_encode(d)
            if dr.nbytes < d.nbytes:
                candidates.append((dr.nbytes + refs.nbytes,
                                   CODEC_ROWDICT_RLE,
                                   {"rle": dr, "refs": refs}))
    if codec in ("auto", CODEC_RLE) and rows > 0:
        r = rle_encode(matrix)
        candidates.append((r.nbytes, CODEC_RLE, {"rle": r}))
    candidates = [c for c in candidates if c[0] * min_gain <= raw_nb]
    if not candidates:
        return CompressedTile(CODEC_RAW, rows, W, {"data": matrix})
    nb, chosen, arrays = min(candidates, key=lambda c: (c[0], c[1]))
    return CompressedTile(chosen, rows, W, arrays)


def tile_from_arrays(codec: str, arrays: dict, rows: int, doc_words: int
                     ) -> CompressedTile:
    """Rehydrate a CompressedTile from loaded (possibly mmapped)
    component arrays — the store's open path."""
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    return CompressedTile(codec, int(rows), int(doc_words), dict(arrays))


@dataclasses.dataclass(frozen=True)
class CompressedShardSource:
    """Lazy handle on one compressed shard's component files: the
    MappedArena source for non-raw manifest rows. Component ``.npy``
    files mmap like raw shards, so opening costs metadata only; bytes
    are read when the tile is decoded or its dict form staged."""
    codec: str
    paths: dict            # component name -> Path
    rows: int
    doc_words: int
    comp_nbytes: int       # sum of component array bytes (manifest)

    def load(self) -> CompressedTile:
        arrays = {name: np.load(p, mmap_mode="r")
                  for name, p in self.paths.items()}
        return tile_from_arrays(self.codec, arrays, self.rows,
                                self.doc_words)
