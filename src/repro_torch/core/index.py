"""The COBS data structure: classic (ClaBS) and compact bit-sliced indexes.

All sub-index blocks share one document-word width (block_docs // 32) and
are stacked along the row axis into one arena

    arena : int32 [total_rows, block_docs // 32]   (uint32 bit patterns)

with per-block row offsets and filter widths. A classic index is the case
of one block whose width covers the largest document. Query row addressing
for term t in block b is

    row(t, b) = row_offset[b] + hash(t) % w_b[b]

The index is a pair (``ArenaLayout`` metadata, ``ArenaStorage`` words) plus
the Bloom parameters, as in ``repro.core.index``. The build hashes, scatters
and packs on the index's device.

Two on-disk formats: ``cobs-jax-v1`` (a JSON manifest and one compressed
npz; loading reads the whole arena) and ``cobs-jax-v2`` (one ``.npy`` per
block group, ``core.store``; loading maps it). ``save_index`` writes v1
unless asked for v2, and ``load_index`` reads either.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import bloom, theory
from .arena import ArenaLayout, ArenaStorage, DeviceArena, MappedArena

DEFAULT_FPR = 0.3      # paper section 2.1: a high FPR is optimal here
DEFAULT_HASHES = 1     # paper: k = 1 minimizes cache faults / IOs
DEFAULT_KMER = 31      # microbial genomics standard


@dataclasses.dataclass(frozen=True)
class IndexParams:
    n_hashes: int = DEFAULT_HASHES
    fpr: float = DEFAULT_FPR
    kmer: int = DEFAULT_KMER
    canonical: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "IndexParams":
        return IndexParams(**d)


class BitSlicedIndex:
    """Arena-layout bit-sliced signature index (classic or compact): the
    composition of ``layout``, ``storage`` and ``params``. The metadata
    attributes (row_offset, block_width, doc_slot, doc_n_terms) come back
    as int32 tensors on the storage's device."""

    def __init__(self, layout: ArenaLayout, storage: ArenaStorage,
                 params: IndexParams | None = None):
        if tuple(storage.shape) != (layout.total_rows, layout.doc_words):
            raise ValueError(
                f"storage shape {tuple(storage.shape)} does not match the "
                f"layout ({layout.total_rows}, {layout.doc_words})")
        self.layout = layout
        self.storage = storage
        self.params = params if params is not None else IndexParams()
        self._device_meta: dict[str, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def arena(self) -> torch.Tensor:
        """Dense device arena."""
        return self.storage.full_device()

    def _meta(self, name: str) -> torch.Tensor:
        t = self._device_meta.get(name)
        if t is None:
            t = torch.from_numpy(getattr(self.layout, name)).to(self.device)
            self._device_meta[name] = t
        return t

    @property
    def row_offset(self) -> torch.Tensor:
        return self._meta("row_offset")

    @property
    def block_width(self) -> torch.Tensor:
        return self._meta("block_width")

    @property
    def doc_slot(self) -> torch.Tensor:
        return self._meta("doc_slot")

    @property
    def doc_n_terms(self) -> torch.Tensor:
        return self._meta("doc_n_terms")

    @property
    def block_docs(self) -> int:
        return self.layout.block_docs

    @property
    def n_docs(self) -> int:
        return self.layout.n_docs

    @property
    def n_blocks(self) -> int:
        return self.layout.n_blocks

    @property
    def doc_words(self) -> int:
        return self.layout.doc_words

    @property
    def total_rows(self) -> int:
        return self.layout.total_rows

    @property
    def n_slots(self) -> int:
        return self.layout.n_slots

    def size_bytes(self) -> int:
        return self.storage.nbytes()

    def expected_fpr(self) -> np.ndarray:
        """Per-document analytic FPR given the actual block widths."""
        widths = self.layout.block_width[self.layout.doc_slot
                                         // self.block_docs]
        return np.array([theory.bloom_fpr(int(w), self.params.n_hashes,
                                          int(n))
                         for w, n in zip(widths, self.layout.doc_n_terms)])


def _pad32(n: int) -> int:
    return ((n + 31) // 32) * 32


def plan_compact_layout(counts: np.ndarray, params: IndexParams,
                        block_docs: int, row_align: int = bloom.ROW_ALIGN
                        ) -> tuple[ArenaLayout, np.ndarray]:
    """The planning half of a compact build: document order, block widths
    and row offsets from term counts alone. Returns (layout, order), where
    order[j] is the original document id at slot j."""
    n_docs = counts.shape[0]
    block_docs = _pad32(block_docs)
    order = np.argsort(counts, kind="stable")          # ascending by size
    doc_slot = np.empty(n_docs, dtype=np.int32)
    doc_slot[order] = np.arange(n_docs, dtype=np.int32)

    n_blocks = (n_docs + block_docs - 1) // block_docs
    widths = np.empty(n_blocks, dtype=np.int32)
    for b in range(n_blocks):
        ids = order[b * block_docs:(b + 1) * block_docs]
        v_max = int(counts[ids].max()) if ids.size else 0
        widths[b] = bloom.aligned_width(
            theory.bloom_size(max(v_max, 1), params.fpr, params.n_hashes),
            row_align)
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
    layout = ArenaLayout.make(offsets, widths, doc_slot,
                              counts.astype(np.int32), block_docs, n_docs)
    return layout, order


def build_compact(doc_terms: list[np.ndarray],
                  params: IndexParams = IndexParams(),
                  block_docs: int = 1024, row_align: int = bloom.ROW_ALIGN,
                  device=None) -> BitSlicedIndex:
    """COBS compact build on ``device``: sort documents by size, block them
    into groups of ``block_docs``, size each block's filter for its largest
    member."""
    dev = resolve_device(device)
    if not doc_terms:
        raise ValueError("empty document set")
    counts = np.array([t.shape[0] for t in doc_terms], dtype=np.int64)
    layout, order = plan_compact_layout(counts, params, block_docs, row_align)
    blocks = []
    for b in range(layout.n_blocks):
        ids = order[b * layout.block_docs:(b + 1) * layout.block_docs]
        blocks.append(bloom.build_block_matrix(
            [doc_terms[i] for i in ids], int(layout.block_width[b]),
            params.n_hashes, layout.block_docs, dev))
    return BitSlicedIndex(layout, DeviceArena(torch.cat(blocks, dim=0)),
                          params)


def build_classic(doc_terms: list[np.ndarray],
                  params: IndexParams = IndexParams(),
                  row_align: int = bloom.ROW_ALIGN,
                  device=None) -> BitSlicedIndex:
    """ClaBS/BIGSI build on ``device``: one filter width sized for the
    largest document."""
    dev = resolve_device(device)
    if not doc_terms:
        raise ValueError("empty document set")
    n_docs = len(doc_terms)
    counts = np.array([t.shape[0] for t in doc_terms], dtype=np.int64)
    w = bloom.aligned_width(
        theory.bloom_size(max(int(counts.max()), 1), params.fpr,
                          params.n_hashes), row_align)
    block_docs = _pad32(n_docs)
    matrix = bloom.build_block_matrix(list(doc_terms), w, params.n_hashes,
                                      block_docs, dev)
    layout = ArenaLayout.make(
        np.zeros(1, np.int32), np.full(1, w, np.int32),
        np.arange(n_docs, dtype=np.int32), counts.astype(np.int32),
        block_docs, n_docs)
    return BitSlicedIndex(layout, DeviceArena(matrix), params)


def index_from_numpy(arena_u32: np.ndarray, row_offset, block_width,
                     doc_slot, doc_n_terms, block_docs: int, n_docs: int,
                     params: dict, device=None) -> BitSlicedIndex:
    """Carry an index across from numpy arrays: exactly what a JAX
    ``BitSlicedIndex`` exposes (``np.asarray(idx.storage.full_host())``,
    the ``idx.layout`` fields and ``idx.params.to_json()``)."""
    arena = np.ascontiguousarray(arena_u32, dtype=np.uint32)
    layout = ArenaLayout.make(row_offset, block_width, doc_slot, doc_n_terms,
                              block_docs, n_docs)
    storage = DeviceArena(
        torch.from_numpy(arena.view(np.int32)).to(resolve_device(device)))
    return BitSlicedIndex(layout, storage, IndexParams.from_json(params))


def merge_classic(a: BitSlicedIndex, b: BitSlicedIndex) -> BitSlicedIndex:
    """Merge two classic indexes built with identical parameters and widths
    (paper section 2.3). Documents concatenate along the word axis, so the
    merged arena is rebuilt dense from the sources' host shards, on
    ``a``'s device."""
    if a.n_blocks != 1 or b.n_blocks != 1:
        raise ValueError("merge_classic only merges classic (single-block) "
                         "indexes")
    if int(a.layout.block_width[0]) != int(b.layout.block_width[0]) \
            or a.params != b.params:
        raise ValueError("parameter mismatch")
    arena = np.concatenate([np.asarray(a.storage.full_host()),
                            np.asarray(b.storage.full_host())], axis=1)
    layout = ArenaLayout.make(
        a.layout.row_offset, a.layout.block_width,
        np.concatenate([a.layout.doc_slot,
                        b.layout.doc_slot + a.block_docs]),
        np.concatenate([a.layout.doc_n_terms, b.layout.doc_n_terms]),
        a.block_docs + b.block_docs, a.n_docs + b.n_docs)
    storage = DeviceArena(torch.from_numpy(
        np.ascontiguousarray(arena, dtype=np.uint32).view(np.int32)
    ).to(a.device))
    return BitSlicedIndex(layout, storage, a.params)


def merge_compact_layout(a: ArenaLayout, b: ArenaLayout) -> ArenaLayout:
    """Metadata half of the compact merge: blocks append along the row
    axis, b's slots shift by a's slot capacity."""
    if a.block_docs != b.block_docs:
        raise ValueError("block_docs mismatch")
    return ArenaLayout.make(
        np.concatenate([a.row_offset, b.row_offset + a.total_rows]),
        np.concatenate([a.block_width, b.block_width]),
        np.concatenate([a.doc_slot, b.doc_slot + a.n_slots]),
        np.concatenate([a.doc_n_terms, b.doc_n_terms]),
        a.block_docs, a.n_docs + b.n_docs)


def merge_compact(a: BitSlicedIndex, b: BitSlicedIndex) -> BitSlicedIndex:
    """Merge two compact indexes without rebuilding: the merged index is
    the two block lists back to back; b's slots shift by a's slot
    capacity. Two dense device arenas concatenate on ``a``'s device; any
    other storage merges as an O(metadata) shard-list concatenation
    (``MappedArena.concat``) that reads no arena bytes."""
    if a.params != b.params:
        raise ValueError("parameter mismatch")
    layout = merge_compact_layout(a.layout, b.layout)
    if isinstance(a.storage, DeviceArena) and \
            isinstance(b.storage, DeviceArena):
        storage: ArenaStorage = DeviceArena(torch.cat(
            [a.storage.full_device(), b.storage.full_device().to(a.device)],
            dim=0))
    else:
        storage = MappedArena.concat(a.storage, b.storage)
    return BitSlicedIndex(layout, storage, a.params)


def save_index(index: BitSlicedIndex, path: str | Path, *,
               version: int = 1, blocks_per_shard: int = 1) -> None:
    """Write ``index`` as a v1 directory (default) or, with ``version=2``,
    as a v2 shard store."""
    if version == 2:
        from . import store
        store.save_index_v2(index, path, blocks_per_shard=blocks_per_shard)
        return
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path / "index.npz",
        arena=np.asarray(index.storage.full_host(), dtype=np.uint32),
        row_offset=index.layout.row_offset,
        block_width=index.layout.block_width,
        doc_slot=index.layout.doc_slot,
        doc_n_terms=index.layout.doc_n_terms,
    )
    manifest = {
        "format": "cobs-jax-v1",
        "block_docs": index.block_docs,
        "n_docs": index.n_docs,
        "params": index.params.to_json(),
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))


def load_index(path: str | Path, device=None) -> BitSlicedIndex:
    """Open a v1 or v2 index directory; its arena (v1) or tiles (v2) go to
    ``device`` (None = the CUDA card)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    fmt = manifest.get("format")
    if fmt == "cobs-jax-v2":
        from . import store
        return store.load_index_v2(path, device=device)
    if fmt != "cobs-jax-v1":
        raise ValueError(f"unknown index format in {path}")
    dev = resolve_device(device)
    with np.load(path / "index.npz") as z:
        layout = ArenaLayout.make(
            z["row_offset"], z["block_width"], z["doc_slot"],
            z["doc_n_terms"], int(manifest["block_docs"]),
            int(manifest["n_docs"]))
        arena = np.ascontiguousarray(z["arena"], dtype=np.uint32)
    return BitSlicedIndex(
        layout, DeviceArena(torch.from_numpy(arena.view(np.int32)).to(dev)),
        IndexParams.from_json(manifest["params"]))
