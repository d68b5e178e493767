"""COBS core: the compact bit-sliced signature index, on the device."""
from . import bloom, codec, dna, hashing, store, theory
from .arena import (ArenaLayout, ArenaStorage, DeviceArena, DeviceTileCache,
                    HostArena, MappedArena)
from .codec import CODECS, CompressedTile, encode_tile
from .index import (BitSlicedIndex, IndexParams, build_classic, build_compact,
                    index_from_numpy, load_index, merge_classic,
                    merge_compact, save_index)
from .multi import MultiHit, MultiIndexEngine
from .query import (QueryEngine, SearchResult, make_batch_score_fn,
                    make_score_fn)
from .store import (SubStore, load_index_v2, merge_stores,
                    migrate_store_codec, migrate_v1_to_v2, open_store,
                    open_substore, save_index_v2)

__all__ = [
    "ArenaLayout", "ArenaStorage", "BitSlicedIndex", "CODECS",
    "CompressedTile", "DeviceArena", "DeviceTileCache", "HostArena",
    "IndexParams", "MappedArena", "MultiHit", "MultiIndexEngine",
    "QueryEngine", "SearchResult", "SubStore",
    "bloom", "build_classic", "build_compact", "codec", "dna",
    "encode_tile", "hashing", "index_from_numpy", "load_index",
    "load_index_v2", "make_batch_score_fn", "make_score_fn",
    "merge_classic", "merge_compact", "merge_stores", "migrate_store_codec",
    "migrate_v1_to_v2", "open_store", "open_substore", "save_index",
    "save_index_v2", "store", "theory",
]
