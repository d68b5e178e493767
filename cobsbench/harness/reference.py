"""The plain reference, and the comparison that decides ``correct``.

The reference imports nothing of the program. From the benchmark's own
corpus (``corpus``) and the frozen arithmetic (``frozen``) it works out
again which block each document lands in, the width of that block, and
the Bloom bits of every document it checks; then it counts each query's
terms in each of those documents. It runs in plain PyTorch on whatever
device it is given, after the program's state has been freed.

What is checked. A sample of the answered requests, drawn from the seed
(every request when there are fewer), and for each of them these
documents: every document the answer reports, the query's source
document (for a query cut from one), and a shared sample of documents
drawn from the seed. For each (query, document) pair the answer must say
the same as the reference: reported exactly when the reference's count
reaches the coverage cut-off, and then with that count. The answer's term
count, its cut-off and its best-first order are checked too. Every
mismatch counts one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import corpus as _corpus
from . import frozen

PIECE = 1 << 23        # k-mers made at once while a document's bits are set


@dataclasses.dataclass
class Answer:
    """What the program answered one request (local document ids)."""
    doc_ids: np.ndarray
    scores: np.ndarray
    n_terms: int
    cutoff: int


class Reference:
    def __init__(self, corp: _corpus.Corpus, index_cfg: dict,
                 device: torch.device):
        self.corp = corp
        self.device = device
        self.k = int(index_cfg["kmer"])
        self.n_hashes = int(index_cfg["n_hashes"])
        self.block_of, self.widths = frozen.compact_blocks(
            corp.n_terms, float(index_cfg["fpr"]), self.n_hashes,
            int(index_cfg["block_docs"]))

    def width(self, d: int) -> int:
        return int(self.widths[self.block_of[d]])

    def doc_bits(self, d: int) -> torch.Tensor:
        """bool [width]: the Bloom filter of document d."""
        w = self.width(d)
        bits = torch.zeros(w, dtype=torch.bool, device=self.device)
        gid = torch.tensor([int(self.corp.gid[d])], device=self.device)
        n = int(self.corp.n_terms[d])
        for t0 in range(0, n, PIECE):
            lo, hi = _corpus.kmers_torch(self.corp.key, gid, t0,
                                         min(PIECE, n - t0), self.k)
            for j in range(self.n_hashes):
                bits[frozen.hash_torch(lo[0], hi[0], j) % w] = True
        return bits

    def query_hashes(self, terms: np.ndarray) -> torch.Tensor:
        """int64 [n, n_hashes] hashes of a query's uint32 [n, 2] terms."""
        t = torch.from_numpy(terms.astype(np.int64)).to(self.device)
        return torch.stack([frozen.hash_torch(t[:, 0], t[:, 1], j)
                            for j in range(self.n_hashes)], dim=1)

    def scores(self, pairs: dict[int, list[int]],
               hashes: dict[int, torch.Tensor],
               keep: dict[int, torch.Tensor] | None = None
               ) -> dict[tuple[int, int], int]:
        """{(query, doc): count} for pairs {doc: [queries]}. ``keep``
        (query -> bool [n]) counts only the kept terms."""
        out = {}
        for d, qs in pairs.items():
            bits = self.doc_bits(d)
            w = bits.shape[0]
            for q in qs:
                hit = bits[hashes[q] % w].all(dim=1)
                if keep is not None:
                    hit = hit & keep[q]
                out[(q, d)] = int(hit.sum())
            del bits
        return out


@dataclasses.dataclass
class Verdict:
    checked_requests: int
    checked_pairs: int
    mismatches: int
    first: list          # a few mismatches, for the log


def shared_docs(corp: _corpus.Corpus, seed: int, n: int) -> list[int]:
    rng = np.random.default_rng([seed & _corpus.M64,
                                 (seed >> 64) & _corpus.M64, 0xd0c5])
    return sorted(rng.choice(corp.n_docs, size=min(n, corp.n_docs),
                             replace=False).tolist())


def sample_requests(answered: list[int], n_total: int, seed: int,
                    n: int) -> list[int]:
    """Up to n answered request indices, in an order drawn from the seed
    over all n_total requests."""
    rng = np.random.default_rng([seed & _corpus.M64,
                                 (seed >> 64) & _corpus.M64, 0x5a3b])
    have = set(answered)
    return [int(i) for i in rng.permutation(n_total) if int(i) in have][:n]


def check_pairs(sample: list[int], answers: dict[int, Answer],
                src: np.ndarray, shared: list[int]) -> dict[int, list[int]]:
    pairs: dict[int, set] = {}
    for q in sample:
        docs = set(int(d) for d in answers[q].doc_ids) | set(shared)
        if src[q] >= 0:
            docs.add(int(src[q]))
        for d in docs:
            pairs.setdefault(d, set()).add(q)
    return {d: sorted(qs) for d, qs in sorted(pairs.items())}


def judge(sample: list[int], answers: dict[int, Answer],
          terms: dict[int, np.ndarray], src: np.ndarray, shared: list[int],
          threshold: float, ref: Reference) -> Verdict:
    """Compare the sampled answers with the reference."""
    pairs = check_pairs(sample, answers, src, shared)
    hashes = {q: ref.query_hashes(terms[q]) for q in sample}
    truth = ref.scores(pairs, hashes)
    per_q: dict[int, list[int]] = {}
    for d, qs in pairs.items():
        for q in qs:
            per_q.setdefault(q, []).append(d)
    bad: list = []
    for q in sample:
        a = answers[q]
        n = int(terms[q].shape[0])
        cut = frozen.coverage_cutoff(threshold, n)
        if a.n_terms != n or a.cutoff != cut:
            bad.append((q, "terms/cutoff", (a.n_terms, a.cutoff), (n, cut)))
        order = sorted(zip((-a.scores).tolist(), a.doc_ids.tolist()))
        if [d for _, d in order] != a.doc_ids.tolist():
            bad.append((q, "order", a.doc_ids.tolist()[:8], None))
        said = dict(zip(a.doc_ids.tolist(), a.scores.tolist()))
        for d in per_q.get(q, []):
            s = truth[(q, d)]
            want = s if s >= cut else None
            if said.get(d) != want:
                bad.append((q, d, said.get(d), want))
    return Verdict(len(sample), len(truth), len(bad), bad[:5])


def control_answers(sample: list[int], terms: dict[int, np.ndarray],
                    src: np.ndarray, shared: list[int], threshold: float,
                    ref: Reference, keep_share: float = 0.875
                    ) -> dict[int, Answer]:
    """The control: the reference in the program's place, scoring only the
    first ``keep_share`` of each query's terms and scaling the count up,
    which breaks the configuration's guarantee of exact counts. Its
    answers cover the documents the comparison checks."""
    empty = {q: Answer(np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 0)
             for q in sample}
    pairs = check_pairs(sample, empty, src, shared)
    hashes = {q: ref.query_hashes(terms[q]) for q in sample}
    keep = {}
    for q in sample:
        n = int(terms[q].shape[0])
        m = max(1, int(np.ceil(keep_share * n)))
        keep[q] = torch.arange(n, device=ref.device) < m
    sub = ref.scores(pairs, hashes, keep)
    per_q: dict[int, list[int]] = {}
    for d, qs in pairs.items():
        for q in qs:
            per_q.setdefault(q, []).append(d)
    out = {}
    for q in sample:
        n = int(terms[q].shape[0])
        m = max(1, int(np.ceil(keep_share * n)))
        cut = frozen.coverage_cutoff(threshold, n)
        got = {d: int(round(sub[(q, d)] * n / m)) for d in per_q[q]}
        hits = sorted(((-s, d) for d, s in got.items() if s >= cut))
        out[q] = Answer(np.array([d for _, d in hits], dtype=np.int64),
                        np.array([-s for s, _ in hits], dtype=np.int64),
                        n, cut)
    return out
