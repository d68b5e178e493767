"""Synthetic genomic corpora with the paper's skewed document sizes.

A copy of ``repro.data.synthetic``: the same numpy ``default_rng`` draws in
the same order, so both packages make the same corpus and the same queries
from the same seed. Document lengths are log-normal, clipped to
[min_length, max_length]; true-positive queries are substrings of indexed
documents, true negatives are random strings verified to share no k-mer
with any document.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import dna


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """Uniform random 2-bit code string (uint8 [length])."""
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def mutate(rng: np.random.Generator, codes: np.ndarray, rate: float
           ) -> np.ndarray:
    """Point-mutate a fraction ``rate`` of bases (never to the same base)."""
    out = codes.copy()
    n_mut = int(len(codes) * rate)
    if n_mut == 0:
        return out
    pos = rng.choice(len(codes), size=n_mut, replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n_mut, dtype=np.uint8)) % 4
    return out


@dataclass
class SyntheticCorpus:
    documents: list[np.ndarray]          # 2-bit code arrays
    doc_terms: list[np.ndarray]          # distinct packed k-mers per doc
    k: int
    canonical: bool = False
    names: list[str] = field(default_factory=list)
    _keys: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def n_docs(self) -> int:
        return len(self.documents)

    def term_counts(self) -> np.ndarray:
        return np.array([t.shape[0] for t in self.doc_terms], dtype=np.int64)

    def sorted_term_keys(self) -> np.ndarray:
        """Every document's k-mers as sorted uint64 keys (computed once),
        for the negative-query membership test."""
        if self._keys is None:
            parts = [_term_keys(t) for t in self.doc_terms]
            self._keys = np.sort(np.concatenate(parts) if parts
                                 else np.zeros(0, np.uint64))
        return self._keys


def make_corpus(n_docs: int, *, k: int = 31, mean_length: int = 2000,
                sigma: float = 1.0, min_length: int = 64,
                max_length: int | None = None, canonical: bool = False,
                seed: int = 0) -> SyntheticCorpus:
    """Log-normal document-size corpus; lengths are clipped at
    ``max_length`` (default 50x the mean)."""
    rng = np.random.default_rng(seed)
    mu = np.log(mean_length) - sigma ** 2 / 2
    lengths = np.exp(rng.normal(mu, sigma, size=n_docs)).astype(np.int64)
    lengths = np.clip(lengths, min_length, max_length or 50 * mean_length)
    docs, terms = [], []
    for i in range(n_docs):
        g = random_genome(rng, int(lengths[i]))
        docs.append(g)
        terms.append(dna.document_terms([g], k, canonical))
    return SyntheticCorpus(docs, terms, k, canonical,
                           [f"doc{i:06d}" for i in range(n_docs)])


def _term_keys(terms: np.ndarray) -> np.ndarray:
    return (terms[:, 0].astype(np.uint64)
            | (terms[:, 1].astype(np.uint64) << np.uint64(32)))


def _any_in(sorted_keys: np.ndarray, keys: np.ndarray) -> bool:
    if not sorted_keys.size:
        return False
    pos = np.minimum(np.searchsorted(sorted_keys, keys), sorted_keys.size - 1)
    return bool((sorted_keys[pos] == keys).any())


def make_queries(corpus: SyntheticCorpus, *, n_pos: int, n_neg: int,
                 length: int, seed: int = 1
                 ) -> tuple[list[np.ndarray], np.ndarray]:
    """Query batch in random order with ground-truth labels: (queries,
    origin), origin[i] the source document of a true positive and -1 for a
    verified true negative."""
    rng = np.random.default_rng(seed)
    k = corpus.k
    universe = corpus.sorted_term_keys()

    queries: list[np.ndarray] = []
    origin: list[int] = []
    long_enough = [i for i, d in enumerate(corpus.documents)
                   if len(d) >= max(length, k)]
    if n_pos and not long_enough:
        raise ValueError("no document long enough for positive queries")
    for _ in range(n_pos):
        d = int(rng.choice(long_enough))
        doc = corpus.documents[d]
        start = int(rng.integers(0, len(doc) - length + 1))
        queries.append(doc[start:start + length].copy())
        origin.append(d)

    made = 0
    while made < n_neg:
        cand = random_genome(rng, length)
        if not _any_in(universe,
                       _term_keys(dna.pack_kmers(cand, k, corpus.canonical))):
            queries.append(cand)
            origin.append(-1)
            made += 1

    perm = rng.permutation(len(queries))
    return [queries[i] for i in perm], np.array(origin, dtype=np.int64)[perm]
