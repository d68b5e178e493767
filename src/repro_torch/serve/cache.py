"""LRU caches for the serving hot paths.

Two cacheable artifacts dominate repeated traffic:

* whole-query results — identical (terms, threshold) pairs recur under
  real workloads (health probes, popular sequences); a hit skips queue,
  kernel, and selection entirely.
* single-term row gathers — COBS point queries (ell = 1, the paper's
  Table 3 single-k-mer workload) reduce to one ANDed arena row; hot terms
  are answered from a host-side row cache without touching the device.

Both are plain LRU with hit/miss counters exposed to the metrics module.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Hashable, Optional

import numpy as np


class LRUCache:
    """Bounded mapping with least-recently-used eviction and hit stats."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Hashable) -> Optional[Any]:
        if self.capacity == 0:
            self.misses += 1
            return None
        try:
            v = self._d[key]
        except KeyError:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def result_key(terms: np.ndarray, threshold: float, top_k: int = 0) -> tuple:
    """Cache key for a whole query: digest of the distinct packed terms
    plus the selection inputs (coverage threshold, or top-k when > 0)."""
    digest = hashlib.blake2b(np.ascontiguousarray(terms).tobytes(),
                             digest_size=16).digest()
    return (digest, terms.shape[0], float(threshold), int(top_k))


def term_key(term: np.ndarray) -> int:
    """Cache key for one packed term: its 64-bit value."""
    return int(term[0]) | (int(term[1]) << 32)
