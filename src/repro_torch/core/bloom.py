"""Bloom filter construction for the bit-sliced index, on the device.

Bit layout used everywhere (the same as ``repro.core.bloom``):

  bit-sliced matrix  M : int32 [rows, doc_words]  (uint32 bit patterns)
  document d lives in   word d // 32, bit d % 32 (LSB-first)

so ``(M[r, d // 32] >> (d % 32)) & 1`` is Bloom bit r of document d.
"""
from __future__ import annotations

import numpy as np
import torch

from . import hashing

ROW_ALIGN = 512      # filter widths rounded up to a multiple of this
TERM_ALIGN = 1024    # term-count padding granularity for the build scatter
DOC_WORD_BITS = 32   # documents per packed word


def aligned_width(w: int, align: int = ROW_ALIGN) -> int:
    return max(align, ((w + align - 1) // align) * align)


def build_filters(terms: torch.Tensor, n_terms: torch.Tensor, w: int,
                  n_hashes: int) -> torch.Tensor:
    """Bloom filters for a chunk of documents.

    terms:   int32 [C, T, 2]  packed terms (uint32 bit patterns), padded on T
    n_terms: int32 [C]        number of valid terms per document
    returns  bool  [C, w]     one filter per document

    A scatter into a bool [C, w + 1] buffer whose last column is the dump
    row for padding terms.
    """
    C, T, _ = terms.shape
    h = hashing.hash_terms(terms, n_hashes)                  # [C, T, k]
    rows = hashing.as_unsigned(h) % w                        # int64
    valid = (torch.arange(T, device=terms.device)[None, :]
             < n_terms.to(terms.device)[:, None])
    rows = torch.where(valid[:, :, None], rows, w).reshape(C, -1)
    filt = torch.zeros((C, w + 1), dtype=torch.bool, device=terms.device)
    filt[torch.arange(C, device=terms.device)[:, None], rows] = True
    return filt[:, :w]


def pack_doc_major(filters: torch.Tensor) -> torch.Tensor:
    """bool [C, w] -> int32 [w, C // 32] bit-sliced block (C % 32 == 0).

    The transpose into the paper's layout: each output row holds one Bloom
    position across all documents of the block. Bit 31 lands in the int32
    sign bit, which is the uint32 word's bit pattern.
    """
    C, w = filters.shape
    if C % DOC_WORD_BITS:
        raise ValueError("pad the document count to a multiple of 32 first")
    f = filters.T.reshape(w, C // DOC_WORD_BITS, DOC_WORD_BITS)
    out = torch.zeros((w, C // DOC_WORD_BITS), dtype=torch.int32,
                      device=filters.device)
    for bit in range(DOC_WORD_BITS):
        out |= f[:, :, bit].to(torch.int32) << bit
    return out


def build_block_matrix(terms_list: list[np.ndarray], w: int, n_hashes: int,
                       block_docs: int, device: torch.device,
                       max_chunk_bytes: int = 1 << 28) -> torch.Tensor:
    """One sub-index block on ``device``: int32 [w, block_docs // 32].

    ``terms_list`` holds <= block_docs documents (uint32 [n, 2] numpy);
    missing documents are empty columns. Documents go through in chunks so
    the bool scatter buffer stays under ``max_chunk_bytes``.
    """
    if block_docs % DOC_WORD_BITS:
        raise ValueError("block_docs must be a multiple of 32")
    n = len(terms_list)
    if n > block_docs:
        raise ValueError(f"{n} documents do not fit a block of {block_docs}")
    chunk = max(DOC_WORD_BITS, min(block_docs, max_chunk_bytes // max(w, 1)))
    chunk = (chunk // DOC_WORD_BITS) * DOC_WORD_BITS
    parts = []
    for c0 in range(0, block_docs, chunk):
        c1 = min(c0 + chunk, block_docs)
        docs = terms_list[c0:min(c1, n)]
        counts = np.array([d.shape[0] for d in docs]
                          + [0] * (c1 - c0 - len(docs)), dtype=np.int32)
        t_max = int(counts.max()) if counts.size else 0
        t_pad = max(TERM_ALIGN,
                    ((t_max + TERM_ALIGN - 1) // TERM_ALIGN) * TERM_ALIGN)
        buf = np.zeros((c1 - c0, t_pad, 2), dtype=np.uint32)
        for i, d in enumerate(docs):
            buf[i, : d.shape[0]] = d
        filt = build_filters(torch.from_numpy(buf.view(np.int32)).to(device),
                             torch.from_numpy(counts).to(device), w, n_hashes)
        parts.append(pack_doc_major(filt))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
