"""Frozen copies of the index arithmetic that the reference needs.

The benchmark judges the program's answers with a reference that imports
nothing of the program, so the few pieces of COBS arithmetic that define
an answer are copied here, as they stood when the benchmark was written.
A later change to the program cannot move them. Each piece names what it
copies; ``cobsbench/tests/test_frozen.py`` holds them equal to the
program's on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# k-mer packing: a copy of ``repro_torch.core.dna`` (``_pack_windows``,
# ``pack_kmers`` without the canonical form, ``unique_terms``, and the
# 2-bit code table of ``encode_dna``). A k-mer of k <= 31 bases packs into
# two uint32 words: lo holds the first 16 bases, base t at bits 2t, and hi
# the rest.
# ---------------------------------------------------------------------------

BASES = b"ACGT"
CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    CODE[_b] = _i
    CODE[ord(chr(_b).lower())] = _i


def encode(seq: str) -> np.ndarray:
    """ACGT string -> uint8 2-bit codes (other characters dropped)."""
    codes = CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    return codes[codes != 255]


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mers of a code string as uint32 pairs [n, 2] (lo, hi)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0] - k + 1
    out = np.zeros((max(n, 0), 2), dtype=np.uint32)
    if n <= 0:
        return out
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    lo_n = min(k, 16)
    sh = (2 * np.arange(16, dtype=np.uint32))[None, :]
    out[:, 0] = np.bitwise_or.reduce(
        win[:, :lo_n].astype(np.uint32) << sh[:, :lo_n], axis=1)
    if k > 16:
        out[:, 1] = np.bitwise_or.reduce(
            win[:, 16:].astype(np.uint32) << sh[:, :k - 16], axis=1)
    return out


def unique_terms(terms: np.ndarray) -> np.ndarray:
    """Distinct packed terms in first-occurrence order."""
    if terms.shape[0] == 0:
        return terms
    key = terms[:, 0].astype(np.uint64) | (terms[:, 1].astype(np.uint64)
                                           << np.uint64(32))
    _, idx = np.unique(key, return_index=True)
    return terms[np.sort(idx)]


def query_terms(seq: str, k: int) -> np.ndarray:
    """A query's distinct terms, as the paper defines the query."""
    return unique_terms(pack_kmers(encode(seq), k))


# ---------------------------------------------------------------------------
# The 32-bit term hash: a copy of ``repro_torch.core.hashing`` (the
# murmur3-style mix over the (lo, hi) words with seeds 0..k-1), written
# once on uint32 numpy values and once on int64 torch values masked to
# 32 bits (the reference's device form; no int32 sign tricks).
# ---------------------------------------------------------------------------

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_SEED_MIX = 0x2545F491
_ADD = 0xE6546B64
_M32 = 0xFFFFFFFF


def _rotl_np(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def hash_np(terms: np.ndarray, n_hashes: int) -> np.ndarray:
    """uint32 [..., 2] terms -> uint32 [..., n_hashes] hashes."""
    terms = np.asarray(terms, dtype=np.uint32)
    u = np.uint32
    seeds = np.arange(n_hashes, dtype=np.uint32).reshape(
        (1,) * (terms.ndim - 1) + (n_hashes,))
    with np.errstate(over="ignore"):
        h = (seeds * u(_GOLD)) ^ u(_SEED_MIX)
        for word in (terms[..., 0:1], terms[..., 1:2]):
            kk = _rotl_np(word * u(_C1), 15) * u(_C2)
            h = _rotl_np(h ^ kk, 13) * u(5) + u(_ADD)
        h = h ^ u(8)
        h = h ^ (h >> u(16))
        h = h * u(_F1)
        h = h ^ (h >> u(13))
        h = h * u(_F2)
        return h ^ (h >> u(16))


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def hash_torch(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0
               ) -> torch.Tensor:
    """int64 lo/hi words (values in [0, 2^32)) -> int64 hash values in
    [0, 2^32) for hash seed ``seed``."""
    h = torch.full_like(lo, ((seed * _GOLD) & _M32) ^ _SEED_MIX)
    for word in (lo, hi):
        kk = (_rotl_t((word * _C1) & _M32, 15) * _C2) & _M32
        h = (_rotl_t(h ^ kk, 13) * 5 + _ADD) & _M32
    h = h ^ 8
    h = h ^ (h >> 16)
    h = (h * _F1) & _M32
    h = h ^ (h >> 13)
    h = (h * _F2) & _M32
    return h ^ (h >> 16)


# ---------------------------------------------------------------------------
# Bloom row placement and the compact layout: copies of
# ``repro_torch.core.theory.bloom_size``, ``repro_torch.core.bloom.
# aligned_width`` (ROW_ALIGN 512) and the planning of
# ``repro_torch.core.index.plan_compact_layout`` (documents sorted by term
# count, stable; blocks of ``block_docs``; each block's width sized for its
# largest member). Term t of a document in block b sets Bloom bit
# hash(t) % width[b] of that document.
# ---------------------------------------------------------------------------

ROW_ALIGN = 512


def bloom_size(v: int, fpr: float, k: int) -> int:
    if v <= 0:
        return 1
    return max(1, math.ceil(-k * v / math.log(1.0 - fpr ** (1.0 / k))))


def aligned_width(w: int, align: int = ROW_ALIGN) -> int:
    return max(align, ((w + align - 1) // align) * align)


def compact_blocks(counts: np.ndarray, fpr: float, n_hashes: int,
                   block_docs: int) -> tuple[np.ndarray, np.ndarray]:
    """(block of each document, width of each block)."""
    block_docs = ((block_docs + 31) // 32) * 32
    order = np.argsort(counts, kind="stable")
    block_of = np.empty(counts.shape[0], dtype=np.int64)
    block_of[order] = np.arange(counts.shape[0]) // block_docs
    n_blocks = (counts.shape[0] + block_docs - 1) // block_docs
    widths = np.array([
        aligned_width(bloom_size(
            max(int(counts[order[b * block_docs:(b + 1) * block_docs]]
                    .max()), 1), fpr, n_hashes))
        for b in range(n_blocks)], dtype=np.int64)
    return block_of, widths


# ---------------------------------------------------------------------------
# The coverage cut-off: a copy of ``repro_torch.core.query.coverage_cutoff``
# (the paper's K-threshold) and of the best-first order of ``select_hits``.
# ---------------------------------------------------------------------------

def coverage_cutoff(threshold: float, n_terms: int) -> int:
    return max(1, math.ceil(threshold * n_terms))
