"""Set-up of a cell's index through the program's own build layer.

``repro_torch.core.index.build_compact`` takes host arrays of terms, and a
card's share of the collection (about 116 G terms) does not pass through
the host. So the benchmark drives the same build layer block by block with
terms made on the device (``corpus.kmers_torch``):

* ``plan_compact_layout`` plans documents, blocks and widths;
* ``bloom.build_filters`` hashes and scatters 32 documents at a time, in
  pieces of their term axis whose filters are ORed;
* ``bloom.pack_doc_major`` packs them into a 32-document column of the
  block, written into one arena made once.

The index is then ``BitSlicedIndex(layout, DeviceArena(arena), params)``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import corpus as _corpus

# terms per build_filters call: 32 documents x PIECE_TERMS (a multiple of 16)
PIECE_TERMS = 1 << 21


def index_params(cfg: dict):
    from repro_torch.core.index import IndexParams
    ix = cfg["index"]
    return IndexParams(n_hashes=int(ix["n_hashes"]), fpr=float(ix["fpr"]),
                       kmer=int(ix["kmer"]),
                       canonical=bool(ix["canonical"]))


def plan(cfg: dict, corp: _corpus.Corpus):
    from repro_torch.core.index import plan_compact_layout
    return plan_compact_layout(corp.n_terms, index_params(cfg),
                               int(cfg["index"]["block_docs"]))


def _fill_block(out: torch.Tensor, corp: _corpus.Corpus, ids: np.ndarray,
                n_hashes: int, piece_terms: int) -> None:
    """Write the block of documents ``ids`` (local ids, slot order) into
    ``out``, int32 [w, block_docs // 32], zeroed. Columns of slots that
    hold no document stay zero."""
    from repro_torch.core import bloom
    w, device = out.shape[0], out.device
    for c0 in range(0, ids.shape[0], 32):
        chunk = ids[c0:c0 + 32]
        counts = np.zeros(32, dtype=np.int64)
        counts[:chunk.shape[0]] = corp.n_terms[chunk]
        gid = np.zeros(32, dtype=np.int64)
        gid[:chunk.shape[0]] = corp.gid[chunk]
        gid_d = torch.from_numpy(gid).to(device)
        filt = torch.zeros((32, w), dtype=torch.bool, device=device)
        for t0 in range(0, int(counts.max()), piece_terms):
            T = min(piece_terms, int(counts.max()) - t0)
            lo, hi = _corpus.kmers_torch(corp.key, gid_d, t0, T, corp.kmer)
            terms = torch.stack([_corpus.as_int32_bits(lo),
                                 _corpus.as_int32_bits(hi)], dim=-1)
            del lo, hi
            n_valid = torch.from_numpy(
                np.clip(counts - t0, 0, T).astype(np.int32)).to(device)
            filt |= bloom.build_filters(terms, n_valid, w, n_hashes)
            del terms
        out[:, c0 // 32:c0 // 32 + 1] = bloom.pack_doc_major(filt)


def build_dense(cfg: dict, corp: _corpus.Corpus, device: torch.device,
                piece_terms: int = PIECE_TERMS):
    """The resident index on ``device``, built into one arena."""
    from repro_torch.core.arena import DeviceArena
    from repro_torch.core.index import BitSlicedIndex
    params = index_params(cfg)
    layout, order = plan(cfg, corp)
    arena = torch.zeros((layout.total_rows, layout.doc_words),
                        dtype=torch.int32, device=device)
    for b in range(layout.n_blocks):
        r0, r1 = layout.block_row_range(b)
        _fill_block(arena[r0:r1], corp,
                    order[b * layout.block_docs:(b + 1) * layout.block_docs],
                    params.n_hashes, piece_terms)
    return BitSlicedIndex(layout, DeviceArena(arena), params)
