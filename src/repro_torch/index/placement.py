"""Item -> node placement for fault tolerance and elastic scaling.

A copy of the JAX package's ``repro.index.placement`` (host-only code, so
the port keeps its own copy instead of importing the original); tested
equal to it.

COBS' compact index is a concatenation of INDEPENDENT sub-indexes (paper
section 2.3) — the unit of distribution, recovery, and elasticity is
therefore an independent sub-range of the index. Two granularities exist:

* ``BlockPlacement`` — one Bloom-filter block per item (the original
  control-plane granularity of the JAX package's mesh data plane);
* ``ShardPlacement`` — one cobs-jax-v2 *manifest row* (shard file) per
  item. The shard is the on-disk placement unit: a host opens a sub-store
  view of exactly the shard files assigned to it
  (``repro_torch.core.store.open_substore``) and serves them through a
  ``repro_torch.serve.ShardWorker``.

Both use rendezvous (highest-random-weight) hashing, so adding or removing
a node moves only ~replication/n of the items (elastic scaling); each item
is placed on ``replication`` distinct nodes, node failure flips queries to
the next-highest replica with zero data movement, and recovery rebuilds
only the lost node's items (not the whole index).

This is host-side control-plane logic (pure python, deterministic); the
data plane is the ShardWorker/Frontend pair (multi-host serving).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path


def _weight(item_id: int, node: str) -> int:
    h = hashlib.blake2b(f"{item_id}:{node}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


@dataclass
class RendezvousPlacement:
    """HRW placement of ``n_items`` integer-identified items over nodes."""

    nodes: list[str]
    n_items: int
    replication: int = 2
    _down: set[str] = field(default_factory=set)

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("need at least one node")
        if self.replication < 1:
            raise ValueError("replication >= 1")
        self.nodes = list(dict.fromkeys(self.nodes))  # dedupe, keep order

    # -- placement ----------------------------------------------------------
    def replicas(self, item_id: int) -> list[str]:
        """All replica nodes for an item, preference order (HRW ranking)."""
        ranked = sorted(self.nodes, key=lambda n: _weight(item_id, n),
                        reverse=True)
        return ranked[: min(self.replication, len(ranked))]

    def owner(self, item_id: int) -> str:
        """Preferred LIVE node for an item (failover-aware)."""
        for n in self.replicas(item_id):
            if n not in self._down:
                return n
        raise RuntimeError(f"item {item_id}: all replicas down")

    def assignment(self) -> dict[str, list[int]]:
        """node -> items currently served (live owners only)."""
        out: dict[str, list[int]] = {n: [] for n in self.nodes
                                     if n not in self._down}
        for b in range(self.n_items):
            out[self.owner(b)].append(b)
        return out

    def replica_assignment(self) -> dict[str, list[int]]:
        """node -> every item it REPLICATES (owner or backup). This is the
        set of shards a host must materialize to be able to take over as a
        failover/hedge target without data movement."""
        out: dict[str, list[int]] = {n: [] for n in self.nodes}
        for b in range(self.n_items):
            for n in self.replicas(b):
                out[n].append(b)
        return out

    def is_covered(self) -> bool:
        """Every item has at least one live replica."""
        try:
            for b in range(self.n_items):
                self.owner(b)
            return True
        except RuntimeError:
            return False

    # -- failures -----------------------------------------------------------
    def fail(self, node: str) -> list[int]:
        """Mark node down; returns items whose PRIMARY moved (these flip to
        a replica — no rebuild needed while replication holds)."""
        if node not in self.nodes:
            raise KeyError(node)
        moved = [b for b in range(self.n_items) if self.owner(b) == node]
        self._down.add(node)
        return moved

    def recover(self, node: str) -> list[int]:
        """Node back up; returns items to restore onto it (rebuild/copy set
        = exactly its replica set, nothing else)."""
        self._down.discard(node)
        return [b for b in range(self.n_items) if node in self.replicas(b)]

    @property
    def live_nodes(self) -> list[str]:
        return [n for n in self.nodes if n not in self._down]

    # -- elasticity ---------------------------------------------------------
    def add_node(self, node: str) -> list[int]:
        """Scale up; returns items that must MOVE to the new node (HRW
        guarantees expected n_items * replication / (n+1))."""
        before = {b: set(self.replicas(b)) for b in range(self.n_items)}
        self.nodes.append(node)
        return [b for b in range(self.n_items)
                if set(self.replicas(b)) != before[b]]

    def remove_node(self, node: str) -> list[int]:
        """Scale down; returns items that must be re-homed."""
        if node not in self.nodes:
            raise KeyError(node)
        before = {b: set(self.replicas(b)) for b in range(self.n_items)}
        self.nodes.remove(node)
        self._down.discard(node)
        return [b for b in range(self.n_items)
                if set(self.replicas(b)) != before[b]]


class BlockPlacement(RendezvousPlacement):
    """HRW placement at Bloom-filter-block granularity (legacy surface)."""

    def __init__(self, nodes: list[str], n_blocks: int, replication: int = 2):
        super().__init__(nodes, n_blocks, replication)

    @property
    def n_blocks(self) -> int:
        return self.n_items


class ShardPlacement(RendezvousPlacement):
    """HRW placement of cobs-jax-v2 manifest rows (shard files) over hosts.

    The shard is the multi-host serving unit: ``replica_assignment()[h]``
    is exactly the shard subset host ``h`` opens via ``open_substore``, and
    ``owner``/``replicas`` drive the frontend's scatter and hedged-failover
    dispatch.
    """

    def __init__(self, nodes: list[str], n_shards: int, replication: int = 2):
        super().__init__(nodes, n_shards, replication)

    @property
    def n_shards(self) -> int:
        return self.n_items

    @classmethod
    def for_store(cls, path, nodes: list[str],
                  replication: int = 2) -> "ShardPlacement":
        """Placement over the manifest rows of a v2 store directory."""
        import json

        from ..core.store import FORMAT_V2
        manifest = json.loads((Path(path) / "manifest.json").read_text())
        if manifest.get("format") != FORMAT_V2:
            raise ValueError(f"not a {FORMAT_V2} store: {path}")
        return cls(nodes, len(manifest["shards"]), replication)
