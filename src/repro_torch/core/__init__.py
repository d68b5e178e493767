"""COBS core: the compact bit-sliced signature index, on the device."""
from . import bloom, dna, hashing, theory
from .arena import (ArenaLayout, ArenaStorage, DeviceArena, DeviceTileCache,
                    HostArena)
from .index import (BitSlicedIndex, IndexParams, build_classic, build_compact,
                    index_from_numpy)
from .query import (QueryEngine, SearchResult, make_batch_score_fn,
                    make_score_fn)

__all__ = [
    "ArenaLayout", "ArenaStorage", "BitSlicedIndex", "DeviceArena",
    "DeviceTileCache", "HostArena", "IndexParams", "QueryEngine",
    "SearchResult", "bloom", "build_classic", "build_compact", "dna",
    "hashing", "index_from_numpy", "make_batch_score_fn", "make_score_fn",
    "theory",
]
