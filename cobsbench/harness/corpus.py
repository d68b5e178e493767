"""The benchmark's corpus, made from ``--seed`` and never held whole.

A configuration fixes how many documents the card holds and the spread of
their sizes (distinct 31-mers per document). The sizes are the same for
every seed: stratified quantiles of a clipped log-normal, dealt to the
documents in an order drawn from the seed. So every seed builds the same
layout and does the same work, on other bases.

Base i of the document with global id g is a function of (seed, g, i):
16 bases to a 32-bit word, word q of document g a splitmix64 of
(seed key, g, q). The builder makes a document's k-mers on the device
from these words; the traffic and the reference remake any stretch of any
document on the host or the device from the same words. A random
document of L bases has L - k + 1 distinct k-mers (a repeat among 4^31
values is too rare to matter, and would only set a Bloom bit twice), so a
document of n terms is n + k - 1 bases long.
"""
from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

M64 = (1 << 64) - 1
_G_DOC = 0x9E3779B97F4A7C15
_G_POS = 0xD1B54A32D192ED03
_SM1 = 0xBF58476D1CE4E5B9
_SM2 = 0x94D049BB133111EB


def _s64(c: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    c &= M64
    return c - (1 << 64) if c >> 63 else c


def _splitmix(z: int) -> int:
    z &= M64
    z = ((z ^ (z >> 30)) * _SM1) & M64
    z = ((z ^ (z >> 27)) * _SM2) & M64
    return z ^ (z >> 31)


def seed_key(seed: int, stream: int = 0) -> int:
    """The 64-bit key of (seed, stream); any whole seed."""
    return _splitmix(_splitmix(seed & M64) ^ (seed >> 64) ^ stream)


def words_np(key: int, gid: np.ndarray, q: np.ndarray) -> np.ndarray:
    """uint32 word q of document gid (broadcasting)."""
    u = np.uint64
    with np.errstate(over="ignore"):
        z = (u(key) + np.asarray(gid, dtype=u) * u(_G_DOC)
             + np.asarray(q, dtype=u) * u(_G_POS))
        z = (z ^ (z >> u(30))) * u(_SM1)
        z = (z ^ (z >> u(27))) * u(_SM2)
        z = z ^ (z >> u(31))
    return (z & u(0xFFFFFFFF)).astype(np.uint32)


def _lsr64(z: torch.Tensor, r: int) -> torch.Tensor:
    return (z >> r) & ((1 << (64 - r)) - 1)


def words_torch(key: int, gid: torch.Tensor, q: torch.Tensor
                ) -> torch.Tensor:
    """``words_np`` on int64 tensors: values in [0, 2^32) as int64."""
    z = _s64(key) + gid * _s64(_G_DOC) + q * _s64(_G_POS)
    z = (z ^ _lsr64(z, 30)) * _s64(_SM1)
    z = (z ^ _lsr64(z, 27)) * _s64(_SM2)
    z = z ^ _lsr64(z, 31)
    return z & 0xFFFFFFFF


def bases_np(key: int, gid: np.ndarray, pos: np.ndarray, length: int
             ) -> np.ndarray:
    """uint8 [n, length]: bases pos[i] .. pos[i] + length - 1 of document
    gid[i], as 2-bit codes."""
    gid = np.asarray(gid, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    q0 = pos // 16
    nq = (length + 15) // 16 + 1
    q = q0[:, None] + np.arange(nq)[None, :]
    w = words_np(key, gid[:, None], q)                       # [n, nq]
    sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    b = ((w[:, :, None] >> sh) & np.uint32(3)).astype(np.uint8)
    b = b.reshape(gid.shape[0], nq * 16)
    idx = (pos - q0 * 16)[:, None] + np.arange(length)[None, :]
    return np.take_along_axis(b, idx, axis=1)


def kmers_torch(key: int, gid: torch.Tensor, t0: int, T: int, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-mers at positions t0 .. t0 + T - 1 of documents ``gid``
    (int64 [C] on the device) as int64 (lo, hi) words [C, T] in
    [0, 2^32), packed as ``frozen.pack_kmers`` packs them. ``t0`` is a
    multiple of 16 and 16 < k <= 31."""
    if t0 % 16 or not 16 < k <= 31:
        raise ValueError("t0 must be a multiple of 16 and 16 < k <= 31")
    nq = (T + 15) // 16
    q = torch.arange(t0 // 16, t0 // 16 + nq + 2, device=gid.device)
    w = words_torch(key, gid[:, None], q[None, :])            # [C, nq + 2]
    sh = (2 * torch.arange(16, device=gid.device)).view(1, 1, 16)
    a = w[:, :nq] | (w[:, 1:nq + 1] << 32)
    lo = (a[:, :, None] >> sh) & 0xFFFFFFFF
    del a
    b = w[:, 1:nq + 1] | (w[:, 2:nq + 2] << 32)
    hi = (b[:, :, None] >> sh) & ((1 << (2 * (k - 16))) - 1)
    C = gid.shape[0]
    return lo.reshape(C, nq * 16)[:, :T], hi.reshape(C, nq * 16)[:, :T]


def as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Corpus:
    """The card's documents: local id i is global document ``gid[i]`` of
    the collection, with ``n_terms[i]`` distinct k-mers."""
    key: int
    kmer: int
    gid: np.ndarray        # int64 [n_docs]
    n_terms: np.ndarray    # int64 [n_docs]

    @property
    def n_docs(self) -> int:
        return int(self.gid.shape[0])

    def n_bases(self, i) -> np.ndarray:
        return self.n_terms[i] + self.kmer - 1


def stratified_sizes(n: int, mean: float, sigma: float, lo: int, hi: int
                     ) -> np.ndarray:
    """n sizes at the mid-quantiles of a log-normal of this mean and
    sigma, clipped to [lo, hi], ascending."""
    mu = float(np.log(mean)) - sigma * sigma / 2
    nd = statistics.NormalDist(mu, sigma)
    s = np.exp(np.array([nd.inv_cdf((j + 0.5) / n) for j in range(n)]))
    return np.clip(np.rint(s), lo, hi).astype(np.int64)


def make_corpus(corpus_cfg: dict, kmer: int, seed: int) -> Corpus:
    """This card's share of the configuration's collection."""
    n = int(corpus_cfg["n_docs"])
    sizes = stratified_sizes(n, corpus_cfg["mean_terms"],
                             corpus_cfg["sigma"], corpus_cfg["min_terms"],
                             corpus_cfg["max_terms"])
    rng = np.random.default_rng([seed & M64, (seed >> 64) & M64, 0x5eed])
    cards = int(corpus_cfg.get("cards", 1))
    card = int(corpus_cfg.get("card", 0))
    gid = np.arange(n, dtype=np.int64) * cards + card
    return Corpus(seed_key(seed), kmer, gid, sizes[rng.permutation(n)])
