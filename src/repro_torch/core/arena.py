"""Arena layout / storage split (the counterpart of ``repro.core.arena``).

* ``ArenaLayout`` is pure host-side metadata: per-block row offsets and
  filter widths, the document-slot permutation, term counts. It decides
  query addressing and never touches arena bytes.
* ``ArenaStorage`` is where the arena words live: ``DeviceArena`` holds one
  dense int32 tensor on its device, ``HostArena`` one dense numpy array
  that is copied to its device on first use.
* ``DeviceTileCache`` is the device paging policy: a bounded LRU of shard
  id -> device tile with hit and fault counters.

Arena words are int32 tensors carrying uint32 bit patterns; ``shard_host``
returns them as numpy uint32.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Geometric metadata of an arena; pure, host-side and immutable.

    row_offset[b] is the global first arena row of block b; block b owns
    rows [row_offset[b], row_offset[b] + block_width[b]). Document i of the
    original corpus lives at slot doc_slot[i] (block slot // block_docs,
    column slot % block_docs).
    """

    row_offset: np.ndarray   # int32 [n_blocks]
    block_width: np.ndarray  # int32 [n_blocks]
    doc_slot: np.ndarray     # int32 [n_docs]
    doc_n_terms: np.ndarray  # int32 [n_docs]
    block_docs: int
    n_docs: int

    @staticmethod
    def make(row_offset, block_width, doc_slot, doc_n_terms,
             block_docs: int, n_docs: int) -> "ArenaLayout":
        return ArenaLayout(
            row_offset=np.asarray(row_offset, dtype=np.int32),
            block_width=np.asarray(block_width, dtype=np.int32),
            doc_slot=np.asarray(doc_slot, dtype=np.int32),
            doc_n_terms=np.asarray(doc_n_terms, dtype=np.int32),
            block_docs=int(block_docs),
            n_docs=int(n_docs),
        )

    @property
    def n_blocks(self) -> int:
        return int(self.row_offset.shape[0])

    @property
    def doc_words(self) -> int:
        return self.block_docs // 32

    @property
    def total_rows(self) -> int:
        if self.n_blocks == 0:
            return 0
        return int(self.row_offset[-1]) + int(self.block_width[-1])

    @property
    def n_slots(self) -> int:
        return self.n_blocks * self.block_docs


class ArenaStorage:
    """Arena word storage. ``shape`` mirrors the dense [rows, doc_words]
    array; shards are contiguous row ranges covering [0, rows) with
    boundaries ``shard_row_starts`` (int64 [n_shards + 1]). ``device`` is
    where ``shard_device`` puts its tiles."""

    shape: tuple[int, int]
    shard_row_starts: np.ndarray
    device: torch.device
    dtype = np.dtype(np.uint32)

    @property
    def n_shards(self) -> int:
        return len(self.shard_row_starts) - 1

    def nbytes(self) -> int:
        return int(self.shape[0]) * int(self.shape[1]) * 4

    def shard_nbytes(self, s: int) -> int:
        rows = int(self.shard_row_starts[s + 1] - self.shard_row_starts[s])
        return rows * int(self.shape[1]) * 4

    def shard_host(self, s: int) -> np.ndarray:
        """Shard ``s`` as numpy uint32 [rows, doc_words]."""
        raise NotImplementedError

    def shard_device(self, s: int) -> torch.Tensor:
        """Shard ``s`` as an int32 tensor on ``device``."""
        return torch.from_numpy(
            np.ascontiguousarray(self.shard_host(s)).view(np.int32)
        ).to(self.device)

    def full_host(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.shard_host(s))
                               for s in range(self.n_shards)], axis=0)

    def full_device(self) -> torch.Tensor:
        if self.n_shards == 1:
            return self.shard_device(0)
        return torch.cat([self.shard_device(s)
                          for s in range(self.n_shards)], dim=0)


def _starts(n_rows: int) -> np.ndarray:
    return np.array([0, n_rows], dtype=np.int64)


class DeviceArena(ArenaStorage):
    """One dense int32 tensor, one shard, on the tensor's device."""

    def __init__(self, arena: torch.Tensor):
        if arena.dtype != torch.int32 or arena.dim() != 2:
            raise TypeError("a DeviceArena holds an int32 [rows, words] "
                            f"tensor, got {arena.dtype} {tuple(arena.shape)}")
        self.arena = arena.contiguous()
        self.device = arena.device
        self.shape = tuple(arena.shape)
        self.shard_row_starts = _starts(self.shape[0])
        self._host: np.ndarray | None = None

    def shard_host(self, s: int) -> np.ndarray:
        if self._host is None:
            self._host = self.arena.cpu().numpy().view(np.uint32)
        return self._host

    def shard_device(self, s: int) -> torch.Tensor:
        return self.arena


class HostArena(ArenaStorage):
    """One dense numpy uint32 array; its device copy is made on first use
    and kept."""

    def __init__(self, arena: np.ndarray, device=None):
        self.arena = np.ascontiguousarray(arena, dtype=np.uint32)
        self.device = resolve_device(device)
        self.shape = tuple(self.arena.shape)
        self.shard_row_starts = _starts(self.shape[0])
        self._device: torch.Tensor | None = None

    def shard_host(self, s: int) -> np.ndarray:
        return self.arena

    def shard_device(self, s: int) -> torch.Tensor:
        if self._device is None:
            self._device = super().shard_device(s)
        return self._device


def wrap_arena(arena, device=None) -> ArenaStorage:
    """Adopt an arena under the storage protocol: storage passes through,
    a numpy array becomes a HostArena, a tensor a DeviceArena."""
    if isinstance(arena, ArenaStorage):
        return arena
    if isinstance(arena, np.ndarray):
        return HostArena(arena, device)
    return DeviceArena(arena)


def common_tile_rows(storage: ArenaStorage) -> int | None:
    """Row count unifying all of a sharded storage's tiles (the tallest
    shard), or None for dense single-shard storage."""
    if storage.n_shards <= 1:
        return None
    return int(np.max(np.diff(storage.shard_row_starts)))


class DeviceTileCache:
    """Bounded LRU of shard id -> device tile (raw tiles).

    ``capacity_bytes`` caps resident tile bytes (None = unbounded). A miss
    ("page fault") stages the shard onto the storage's device and may evict
    least-recently-used tiles. ``pad_rows_to`` zero-pads every staged tile
    to a common row count; addressed rows are always below the real shard
    height, so results are unchanged.

    ``prefetch`` stages a tile ahead of use and counts as a fault;
    ``prefetch_hits`` counts gets served by a prefetched tile. Not
    thread-safe: nothing in this package shares a cache between threads.
    """

    def __init__(self, storage: ArenaStorage,
                 capacity_bytes: int | None = None,
                 pad_rows_to: int | None = None):
        self.storage = storage
        self.capacity_bytes = capacity_bytes
        self.pad_rows_to = pad_rows_to
        self._tiles: OrderedDict[int, torch.Tensor] = OrderedDict()
        self._sizes: dict[int, int] = {}
        self._prefetched: set[int] = set()
        self.resident_bytes = 0
        self.hits = 0
        self.faults = 0
        self.prefetched = 0
        self.prefetch_hits = 0
        self.evictions = 0

    def _stage(self, s: int) -> torch.Tensor:
        tile = self.storage.shard_device(s)
        if not self.pad_rows_to:
            return tile
        pad = self.pad_rows_to - tile.shape[0]
        if pad < 0:
            raise ValueError(f"shard {s} taller than pad_rows_to")
        if pad == 0:
            return tile
        return torch.nn.functional.pad(tile, (0, 0, 0, pad))

    def _tile_nbytes(self, s: int) -> int:
        if not self.pad_rows_to:
            return self.storage.shard_nbytes(s)
        return self.pad_rows_to * int(self.storage.shape[1]) * 4

    @property
    def resident_shards(self) -> tuple[int, ...]:
        return tuple(self._tiles)

    def _insert(self, s: int) -> torch.Tensor:
        tile = self._stage(s)
        need = self._tile_nbytes(s)
        if self.capacity_bytes is not None:
            while (self._tiles
                   and self.resident_bytes + need > self.capacity_bytes):
                old, _ = self._tiles.popitem(last=False)
                self.resident_bytes -= self._sizes.pop(old)
                self._prefetched.discard(old)
                self.evictions += 1
        self._tiles[s] = tile
        self._sizes[s] = need
        self.resident_bytes += need
        return tile

    def get(self, s: int) -> torch.Tensor:
        """Shard ``s``'s tile on the device, staged on a miss."""
        tile = self._tiles.get(s)
        if tile is not None:
            self._tiles.move_to_end(s)
            self.hits += 1
            if s in self._prefetched:
                self._prefetched.discard(s)
                self.prefetch_hits += 1
            return tile
        self.faults += 1
        return self._insert(s)

    def prefetch(self, s: int) -> bool:
        """Stage shard ``s`` ahead of use. Counts as a fault; returns True
        if a tile was staged, False if it was already resident."""
        if s in self._tiles:
            return False
        self.faults += 1
        self.prefetched += 1
        self._prefetched.add(s)
        self._insert(s)
        return True
