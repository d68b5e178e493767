"""Bloom filter sizing (paper section 2.1), a copy of the two functions of
``repro.core.theory`` that the build needs."""
from __future__ import annotations

import math


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
