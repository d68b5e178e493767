"""DNA k-mer handling: 2-bit encoding, k-mer packing, distinct terms.

Host-side numpy, a copy of ``repro.core.dna`` (the port never imports the
JAX package). Each k-mer (k <= 31) is packed into two uint32 words
(lo = first 16 bases, hi = the rest), which is what the hashing and index
layers consume. Byte q-grams of other corpora (English text) use the same
packing through ``pack_qgrams_bytes``.
"""
from __future__ import annotations

import numpy as np

# 2-bit DNA codes. Order matters: complement(c) == 3 - c.
_BASES = "ACGT"
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(_BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i

MAX_K = 31  # 31 bases * 2 bits = 62 bits <= two uint32 words


def encode_dna(seq: str) -> np.ndarray:
    """Encode an ACGT string to uint8 2-bit codes; other characters are
    dropped."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = _CODE[raw]
    return codes[codes != 255]


def decode_dna(codes: np.ndarray) -> str:
    """2-bit codes back to an ACGT string."""
    return "".join(_BASES[c] for c in np.asarray(codes))


def _pack_windows(win: np.ndarray) -> np.ndarray:
    """Pack 2-bit code windows [n, k] into uint32 pairs [n, 2] (lo, hi)."""
    n, k = win.shape
    lo_n = min(k, 16)
    out = np.zeros((n, 2), dtype=np.uint32)
    if n == 0:
        return out
    sh_lo = (2 * np.arange(lo_n, dtype=np.uint32))[None, :]
    out[:, 0] = np.bitwise_or.reduce(win[:, :lo_n].astype(np.uint32) << sh_lo,
                                     axis=1)
    if k > 16:
        sh_hi = (2 * np.arange(k - 16, dtype=np.uint32))[None, :]
        out[:, 1] = np.bitwise_or.reduce(
            win[:, 16:].astype(np.uint32) << sh_hi, axis=1)
    return out


def pack_kmers(codes: np.ndarray, k: int, canonical: bool = False
               ) -> np.ndarray:
    """All k-mers of a code string as packed uint32 pairs [n, 2].

    canonical=True replaces each k-mer by min(kmer, reverse_complement(kmer))
    compared as 2k-bit integers.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.zeros((0, 2), dtype=np.uint32)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    fwd = _pack_windows(win)
    if not canonical:
        return fwd
    rev = _pack_windows(np.ascontiguousarray((3 - win)[:, ::-1]))
    take_rev = _as_u64(rev) < _as_u64(fwd)
    return np.where(take_rev[:, None], rev, fwd)


def pack_qgrams_bytes(data: bytes, q: int) -> np.ndarray:
    """q-grams over raw bytes (e.g. English text), q <= 8 so that 8 bits * 8
    chars fit 64 bits; packed into the same uint32-pair representation."""
    if not 1 <= q <= 8:
        raise ValueError("byte q-grams support q in [1, 8]")
    raw = np.frombuffer(data, dtype=np.uint8)
    n = raw.shape[0] - q + 1
    if n <= 0:
        return np.zeros((0, 2), dtype=np.uint32)
    win = np.lib.stride_tricks.sliding_window_view(raw, q)
    out = np.zeros((n, 2), dtype=np.uint32)
    lo_n = min(q, 4)
    sh_lo = (8 * np.arange(lo_n, dtype=np.uint32))[None, :]
    out[:, 0] = np.bitwise_or.reduce(win[:, :lo_n].astype(np.uint32) << sh_lo,
                                     axis=1)
    if q > 4:
        sh_hi = (8 * np.arange(q - 4, dtype=np.uint32))[None, :]
        out[:, 1] = np.bitwise_or.reduce(
            win[:, 4:].astype(np.uint32) << sh_hi, axis=1)
    return out


def _as_u64(terms: np.ndarray) -> np.ndarray:
    return (terms[:, 0].astype(np.uint64)
            | (terms[:, 1].astype(np.uint64) << np.uint64(32)))


def unique_terms(terms: np.ndarray) -> np.ndarray:
    """Distinct packed terms in first-occurrence order."""
    if terms.shape[0] == 0:
        return terms
    _, idx = np.unique(_as_u64(terms), return_index=True)
    return terms[np.sort(idx)]


def document_terms(reads: list[np.ndarray], k: int, canonical: bool = False
                   ) -> np.ndarray:
    """Distinct k-mers over a document's reads, each read k-merized on its
    own."""
    parts = [pack_kmers(r, k, canonical) for r in reads]
    if not parts:
        return np.zeros((0, 2), dtype=np.uint32)
    return unique_terms(np.concatenate(parts, axis=0))
