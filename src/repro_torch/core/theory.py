"""Analytic machinery of the paper (section 2.1), a copy of
``repro.core.theory``.

* Bloom filter false positive rate and parameter selection.
* Theorem 1 (Solomon & Kingsford): false positive rate of a *query* of
  ell distinct terms at threshold K against a filter with per-lookup FPR p.
* The Chernoff bound variant.

Plain numpy / math: used to size filters at build time and to check
empirical FPRs.
"""
from __future__ import annotations

import math

import numpy as np


def bloom_fpr(w: int, k: int, v: int) -> float:
    """FPR (1 - e^{-kv/w})^k of a w-bit filter, k hashes, v inserted terms."""
    if v <= 0:
        return 0.0
    return (1.0 - math.exp(-k * v / w)) ** k


def bloom_size(v: int, fpr: float, k: int) -> int:
    """Minimal width w such that a filter with k hashes holding v terms has
    false positive rate <= fpr:  w = -k*v / ln(1 - fpr^(1/k))."""
    if not 0.0 < fpr < 1.0:
        raise ValueError("fpr must be in (0, 1)")
    if v <= 0:
        return 1
    return max(1, math.ceil(-k * v / math.log(1.0 - fpr ** (1.0 / k))))


def optimal_k(w: int, v: int) -> int:
    """Textbook optimum k = w/v * ln 2 (the paper argues k=1 is better for
    this workload)."""
    if v <= 0:
        return 1
    return max(1, round(w / v * math.log(2.0)))


def fill_rate(w: int, k: int, v: int) -> float:
    """Expected fraction of set bits: 1 - (1 - 1/w)^{kv}."""
    if v <= 0:
        return 0.0
    return 1.0 - (1.0 - 1.0 / w) ** (k * v)


def _log_binom_pmf_cumsum(ell: int, p: float) -> np.ndarray:
    """log pmf of Binomial(ell, p) for i = 0..ell, computed stably."""
    i = np.arange(ell + 1, dtype=np.float64)
    # log C(ell, i) via cumulative sum of log((ell - i + 1) / i)
    log_comb = np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, ell + 1)[::-1]
                                 / np.arange(1, ell + 1)))])
    return log_comb + i * math.log(max(p, 1e-300)) + (ell - i) * math.log1p(-p)


def query_fpr(ell: int, p: float, theta: float) -> float:
    """Theorem 1: P[more than floor(theta*ell) lookups are false positives]
    = 1 - sum_{i=0}^{floor(theta*ell)} C(ell,i) p^i (1-p)^(ell-i)."""
    if ell <= 0:
        return 0.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    t = int(math.floor(theta * ell))
    if t >= ell:
        return 0.0
    logs = _log_binom_pmf_cumsum(ell, p)[: t + 1]
    m = logs.max()
    cdf = math.exp(m) * np.exp(logs - m).sum()
    return float(max(0.0, 1.0 - cdf))


def query_fpr_chernoff(ell: int, p: float, theta: float) -> float:
    """Chernoff bound of the paper: exp(-ell (theta - p)^2 / (2 (1 - p))),
    valid for theta >= p."""
    if theta < p:
        return 1.0
    return math.exp(-ell * (theta - p) ** 2 / (2.0 * (1.0 - p)))


def expected_false_positive_docs(n_docs: int, ell: int, p: float,
                                 theta: float) -> float:
    """Expected count of false-positive documents for one query (the
    paper's '143 false positives in one million documents' example)."""
    return n_docs * query_fpr(ell, p, theta)
