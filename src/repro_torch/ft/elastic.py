"""Elastic scaling of the data axis.

When the healthy-chip count changes (node loss, pool resize), the global
batch must keep its size and ORDER semantics while the per-replica split
changes. ElasticBatchPlan computes a deterministic assignment of global
example indices to replicas for any world size, so scaling from e.g. 32 to
24 data shards mid-run neither drops nor duplicates examples, and the
step-indexed data pipeline stays reproducible (same global batch per step
regardless of topology).

The model/optimizer state is topology-independent (trees of tensors):
re-meshing moves them to the new mesh's devices. A copy of the JAX
package's ``ft/elastic.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ElasticBatchPlan:
    """Contiguous blocks of ``per_replica`` rows; where the global batch does
    not divide the world, the tail replicas are padded with index -1."""
    global_batch: int
    world_size: int

    @property
    def per_replica(self) -> int:
        return -(-self.global_batch // self.world_size)   # ceil

    def indices_for(self, replica: int, step: int) -> np.ndarray:
        """Global example indices owned by ``replica`` at ``step``
        (contiguous blocks; tail replicas may get padding index -1)."""
        if not 0 <= replica < self.world_size:
            raise ValueError("bad replica")
        base = step * self.global_batch
        start = replica * self.per_replica
        stop = min(start + self.per_replica, self.global_batch)
        idx = np.arange(start, stop, dtype=np.int64) + base
        pad = self.per_replica - idx.shape[0]
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        return idx

    def coverage_ok(self, step: int = 0) -> bool:
        """Every global index owned exactly once (padding aside)."""
        seen: list[int] = []
        for r in range(self.world_size):
            seen.extend(i for i in self.indices_for(r, step) if i >= 0)
        want = list(range(step * self.global_batch,
                          (step + 1) * self.global_batch))
        return sorted(seen) == want
