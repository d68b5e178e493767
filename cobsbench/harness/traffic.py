"""The one traffic generator: a mix file of parameters -> queries, from
the seed.

A mix (``cobsbench/traffic/<mix>.json``) says:

* ``chunk``: the requests a client sends at once; it sends the next chunk
  once every answer of the last has come (a closed loop);
* ``pool``: the distinct queries made for the window; a client that gets
  through the pool starts it again from the first (``pool_index``), so a
  window never runs out of queries however fast the program answers;
* ``length``: ``{"kind": "fixed", "bp": n}`` or ``{"kind": "loguniform",
  "min_bp": a, "max_bp": b}`` (stratified over the pool, then shuffled,
  so every seed sends the same lengths);
* ``from_doc_share``: the share of queries cut from an indexed document at
  a uniform position (exactly that share; the rest are random bases);
* ``substitution_rate``: per-base substitutions applied to the cut queries;
* ``threshold``: the coverage threshold sent with each query;
* ``warmup_s``: how long the same traffic (a pool of an eighth the size,
  from another stream of the seed) runs before the window.

Every seed sends the same number of queries of the same lengths and
kinds; only the order, the documents, the positions and the bases differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import corpus as _corpus

WINDOW, WARMUP = 1, 2          # streams of the seed

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Queries:
    seqs: list            # str per query
    src: np.ndarray       # int64 local document id, -1 for random queries
    pos: np.ndarray       # int64 first base in the source document
    length: np.ndarray    # int64 bases

    def __len__(self) -> int:
        return len(self.seqs)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    M64 = _corpus.M64
    return np.random.default_rng([seed & M64, (seed >> 64) & M64, stream])


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["kind"] == "fixed":
        return np.full(n, int(spec["bp"]), dtype=np.int64)
    if spec["kind"] == "loguniform":
        lo, hi = np.log(spec["min_bp"]), np.log(spec["max_bp"])
        q = (np.arange(n) + 0.5) / n
        return rng.permutation(np.rint(np.exp(lo + q * (hi - lo)))
                               .astype(np.int64))
    raise ValueError(f"unknown length kind {spec['kind']!r}")


def pool(mix: dict, stream: int) -> int:
    """Distinct queries of a stream: the mix's pool for the window, an
    eighth of it for the warm-up."""
    n = int(mix["pool"])
    return max(1, n // 8) if stream == WARMUP else n


def pool_index(i, n_pool: int):
    """The pool's query that request ``i`` sends (the pool over again once
    it is used up)."""
    return i % n_pool


def make_queries(mix: dict, corp: _corpus.Corpus, seed: int, stream: int,
                 n: int) -> Queries:
    rng = rng_for(seed, stream)
    lengths = _lengths(mix["length"], n, rng)
    n_cut = int(round(n * float(mix["from_doc_share"])))
    from_doc = np.zeros(n, dtype=bool)
    from_doc[:n_cut] = True
    rng.shuffle(from_doc)
    src = np.where(from_doc, rng.integers(0, corp.n_docs, n), -1)
    room = corp.n_bases(np.maximum(src, 0)) - lengths + 1
    if (room[from_doc] < 1).any():
        raise ValueError("a query is longer than its source document")
    pos = np.where(from_doc, (rng.random(n) * room).astype(np.int64), 0)
    rate = float(mix["substitution_rate"])
    seqs: list = [None] * n
    for L in np.unique(lengths):
        idx = np.nonzero(lengths == L)[0]
        codes = rng.integers(0, 4, (idx.shape[0], int(L)), dtype=np.uint8)
        cut = from_doc[idx]
        if cut.any():
            doc = _corpus.bases_np(corp.key, corp.gid[src[idx[cut]]],
                                   pos[idx[cut]], int(L))
            sub = rng.random(doc.shape) < rate
            shift = rng.integers(1, 4, doc.shape, dtype=np.uint8)
            codes[cut] = np.where(sub, (doc + shift) % 4, doc)
        text = _LUT[codes].tobytes().decode("ascii")
        for j, i in enumerate(idx):
            seqs[i] = text[j * int(L):(j + 1) * int(L)]
    return Queries(seqs, src.astype(np.int64), pos, lengths)
