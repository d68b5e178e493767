"""Arena layout / storage split (the counterpart of ``repro.core.arena``).

* ``ArenaLayout`` is pure host-side metadata: per-block row offsets and
  filter widths, the document-slot permutation, term counts. It decides
  query addressing and never touches arena bytes.
* ``ArenaStorage`` is where the arena words live: ``DeviceArena`` holds one
  dense int32 tensor on its device, ``HostArena`` one dense numpy array
  that is copied to its device on first use, and ``MappedArena`` a list of
  row-range shards, each a read-only ``np.memmap`` over a ``.npy`` file of
  a ``cobs-jax-v2`` store (or a lazy compressed source, or an in-memory
  array). Mapped shards are paged to the device one at a time; the index
  never has to be resident anywhere end to end.
* ``DeviceTileCache`` is the device paging policy: a bounded LRU of shard
  id -> device tile (raw tiles, or a rowdict shard's (dict, refs) pair),
  with hit, fault, eviction and staged-byte counters equal to the JAX
  cache's for the same access sequence.

Arena words are int32 tensors carrying uint32 bit patterns; ``shard_host``
returns them as numpy uint32.
"""
from __future__ import annotations

import dataclasses
import mmap
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..obs.trace import span
from . import codec as _codec


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

    def block_row_range(self, b: int) -> tuple[int, int]:
        start = int(self.row_offset[b])
        return start, start + int(self.block_width[b])

    def shard_blocks(self, shard_row_starts: np.ndarray
                     ) -> list[tuple[int, int]]:
        """Partition blocks by shard: [(block_start, block_end)] per shard
        for row boundaries ``shard_row_starts`` (int64 [n_shards + 1]).
        Every shard boundary must fall on a block boundary."""
        bounds = np.concatenate([self.row_offset.astype(np.int64),
                                 [self.total_rows]])
        out = []
        for s in range(len(shard_row_starts) - 1):
            lo = int(np.searchsorted(bounds, shard_row_starts[s]))
            hi = int(np.searchsorted(bounds, shard_row_starts[s + 1]))
            if (bounds[lo] != shard_row_starts[s]
                    or bounds[hi] != shard_row_starts[s + 1]):
                raise ValueError("shard boundary not on a block boundary")
            out.append((lo, hi))
        return out


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
        host = np.ascontiguousarray(self.shard_host(s))
        if not host.flags.writeable:        # a read-only memmap: copy it
            host = host.copy()
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    def full_host(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.shard_host(s))
                               for s in range(self.n_shards)], axis=0)

    def full_device(self) -> torch.Tensor:
        if self.n_shards == 1:
            return self.shard_device(0)
        return torch.cat([self.shard_device(s)
                          for s in range(self.n_shards)], dim=0)

    def read_rows_host(self, rows: np.ndarray) -> np.ndarray:
        """Arbitrary global rows as numpy uint32 [..., doc_words]. Reads
        only the rows' shards; never materialises a mapped arena."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty((rows.size, self.shape[1]), dtype=self.dtype)
        flat = rows.reshape(-1)
        owner = np.searchsorted(self.shard_row_starts, flat, side="right") - 1
        for s in np.unique(owner):
            sel = owner == s
            local = flat[sel] - int(self.shard_row_starts[s])
            out[sel] = np.asarray(self.shard_host(int(s)))[local]
        return out.reshape(*rows.shape, self.shape[1])

    # -- popcount stats (recorded by v2 stores; absent elsewhere) -----------
    def has_popcounts(self) -> bool:
        return False

    def shard_popcounts(self, s: int) -> np.ndarray | None:
        return None

    def row_popcounts(self, rows: np.ndarray) -> np.ndarray | None:
        return None

    def mean_popcount(self) -> float | None:
        return None

    # -- compression surface (raw everywhere except MappedArena) ------------
    def shard_codec(self, s: int) -> str:
        """This shard's on-disk codec (``codec.CODECS``)."""
        return _codec.CODEC_RAW

    def shard_comp_nbytes(self, s: int) -> int:
        """Encoded (on-disk) shard bytes (== shard_nbytes for raw)."""
        return self.shard_nbytes(s)

    def shard_hbm_nbytes(self, s: int) -> int:
        """Bytes of the shard's compressed device form: dict + refs for
        rowdict codecs, raw otherwise (disk-only RLE gains excluded)."""
        return self.shard_nbytes(s)

    def shard_dict_host(self, s: int
                        ) -> tuple[np.ndarray, np.ndarray] | None:
        """(dict_rows uint32 [D, W], refs int32 [rows]) for rowdict-coded
        shards, None otherwise: what ``get_compressed`` stages."""
        return None

    def comp_summary(self) -> tuple[int, int, int]:
        """(raw_bytes, encoded_bytes, n_compressed_shards) over all
        shards."""
        raw = comp = n = 0
        for s in range(self.n_shards):
            raw += self.shard_nbytes(s)
            comp += self.shard_comp_nbytes(s)
            if self.shard_codec(s) != _codec.CODEC_RAW:
                n += 1
        return raw, comp, n

    def dict_ratio(self) -> float | None:
        """Expanded bytes over (dict + refs) bytes across the dict-coded
        shards; None when no shard has a dict form."""
        raw = comp = 0
        for s in range(self.n_shards):
            if self.shard_codec(s) in _codec.DICT_CODECS:
                raw += self.shard_nbytes(s)
                comp += self.shard_hbm_nbytes(s)
        if comp == 0:
            return None
        return raw / comp


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


class MappedArena(ArenaStorage):
    """Row-range shards backed by ``.npy`` files (read-only ``np.memmap``),
    lazy compressed sources (``codec.CompressedShardSource``) and/or
    in-memory arrays. File-backed shards open lazily with
    ``mmap_mode='r'``, so touching a shard costs page faults, not a load;
    in-memory sources make a merge an O(metadata) shard-list concatenation.

    Compressed sources decode on their first ``shard_host`` touch (the
    decoded tile is kept), or hand their dictionary form to the tile cache
    through ``shard_dict_host`` without ever expanding.
    ``decode_observer(shard, codec, seconds)``, when set, sees every host
    decode. ``device`` (None = the CUDA card) is where ``shard_device``
    puts a shard.
    """

    def __init__(self, sources: list, shard_row_starts: np.ndarray,
                 doc_words: int, dtype=np.uint32,
                 pop_sources: list | None = None, device=None):
        self.sources = list(sources)        # Path | str | ndarray | source
        self.shard_row_starts = np.asarray(shard_row_starts, dtype=np.int64)
        if len(self.sources) != self.n_shards:
            raise ValueError("sources / shard_row_starts length mismatch")
        self.shape = (int(self.shard_row_starts[-1]), int(doc_words))
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self._open: dict[int, np.ndarray] = {}
        self._open_dict: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # optional per-row popcount sidecars (Path | ndarray | None per
        # shard, the v2 manifest's "pops" field)
        self.pop_sources = (list(pop_sources) if pop_sources is not None
                            else [None] * self.n_shards)
        if len(self.pop_sources) != self.n_shards:
            raise ValueError("pop_sources / shard_row_starts length mismatch")
        self._open_pops: dict[int, np.ndarray] = {}
        self.decode_observer = None
        self.decodes = 0

    def _shard_rows(self, s: int) -> int:
        return int(self.shard_row_starts[s + 1] - self.shard_row_starts[s])

    def _notify_decode(self, s: int, codec: str, seconds: float) -> None:
        self.decodes += 1
        if self.decode_observer is not None:
            try:
                self.decode_observer(s, codec, seconds)
            except Exception:
                pass              # accounting must never fail a read

    def shard_host(self, s: int) -> np.ndarray:
        a = self._open.get(s)
        if a is None:
            src = self.sources[s]
            if isinstance(src, _codec.CompressedShardSource):
                t0 = time.perf_counter()
                a = src.load().decode()
                self._notify_decode(s, src.codec, time.perf_counter() - t0)
            elif isinstance(src, np.ndarray):
                a = src
            else:
                a = np.load(src, mmap_mode="r")
            want_rows = self._shard_rows(s)
            if a.shape != (want_rows, self.shape[1]):
                raise ValueError(f"shard {s}: shape {a.shape} != "
                                 f"({want_rows}, {self.shape[1]})")
            self._open[s] = a
        return a

    def prefault(self, s: int) -> None:
        """Read one word of every page of shard ``s``'s mapped file, so
        that later reads of its rows find the pages mapped and in memory
        (nothing for a shard held in memory or decoded from a compressed
        source)."""
        a = self.shard_host(s)
        if isinstance(a, np.memmap) and a.size:
            step = max(1, mmap.PAGESIZE // (a.shape[1] * a.itemsize))
            np.add.reduce(a[::step, 0], dtype=np.uint64)

    # -- popcount stats surface ----------------------------------------------
    def has_popcounts(self) -> bool:
        """True when every shard carries a popcount sidecar."""
        return all(p is not None for p in self.pop_sources)

    def shard_popcounts(self, s: int) -> np.ndarray | None:
        """Per-row popcounts of shard ``s`` (uint32 [rows], mmap-backed),
        or None when the store has no sidecar for it."""
        src = self.pop_sources[s]
        if src is None:
            return None
        a = self._open_pops.get(s)
        if a is None:
            a = src if isinstance(src, np.ndarray) else np.load(
                src, mmap_mode="r")
            if a.shape != (self._shard_rows(s),):
                raise ValueError(
                    f"shard {s}: popcount sidecar shape {a.shape} != "
                    f"({self._shard_rows(s)},)")
            self._open_pops[s] = a
        return a

    def row_popcounts(self, rows: np.ndarray) -> np.ndarray | None:
        """Popcounts of arbitrary global rows (int64 [..] -> int64 [..]),
        reading only the touched sidecar pages. None when any shard lacks
        stats."""
        if not self.has_popcounts():
            return None
        rows = np.asarray(rows, dtype=np.int64)
        flat = rows.reshape(-1)
        out = np.empty(flat.size, dtype=np.int64)
        owner = np.searchsorted(self.shard_row_starts, flat, side="right") - 1
        for s in np.unique(owner):
            sel = owner == s
            local = flat[sel] - int(self.shard_row_starts[s])
            out[sel] = np.asarray(self.shard_popcounts(int(s))[local],
                                  dtype=np.int64)
        return out.reshape(rows.shape)

    def mean_popcount(self) -> float | None:
        """Mean set-bit count per arena row over all shards, or None
        without stats."""
        if not self.has_popcounts():
            return None
        total = n = 0
        for s in range(self.n_shards):
            p = self.shard_popcounts(s)
            total += int(np.asarray(p, dtype=np.int64).sum())
            n += p.shape[0]
        return total / n if n else 0.0

    # -- compression surface -------------------------------------------------
    def shard_codec(self, s: int) -> str:
        src = self.sources[s]
        if isinstance(src, _codec.CompressedShardSource):
            return src.codec
        return _codec.CODEC_RAW

    def shard_comp_nbytes(self, s: int) -> int:
        src = self.sources[s]
        if isinstance(src, _codec.CompressedShardSource):
            return int(src.comp_nbytes)
        return self.shard_nbytes(s)

    def shard_hbm_nbytes(self, s: int) -> int:
        d = self.shard_dict_host(s)
        if d is None:
            return self.shard_nbytes(s)
        return int(d[0].nbytes) + int(d[1].nbytes)

    def shard_dict_host(self, s: int
                        ) -> tuple[np.ndarray, np.ndarray] | None:
        if self.shard_codec(s) not in _codec.DICT_CODECS:
            return None
        cached = self._open_dict.get(s)
        if cached is None:
            src = self.sources[s]
            t0 = time.perf_counter()
            cached = src.load().dict_form()
            # rowdict maps straight through; rowdict+rle expands its
            # dictionary payload here, which counts as a decode
            if src.codec == _codec.CODEC_ROWDICT_RLE:
                self._notify_decode(s, src.codec, time.perf_counter() - t0)
            self._open_dict[s] = cached
        return cached

    @staticmethod
    def concat(a: ArenaStorage, b: ArenaStorage) -> "MappedArena":
        """Row-axis concatenation without touching bytes: the merged arena
        is the two shard lists back to back, on ``a``'s device."""
        if a.shape[1] != b.shape[1]:
            raise ValueError("doc_words mismatch")

        def shard_sources(st: ArenaStorage) -> list:
            if isinstance(st, MappedArena):
                return st.sources
            return [st.shard_host(s) for s in range(st.n_shards)]

        starts = np.concatenate([
            a.shard_row_starts,
            b.shard_row_starts[1:] + int(a.shard_row_starts[-1])])
        return MappedArena(shard_sources(a) + shard_sources(b), starts,
                           doc_words=a.shape[1], dtype=a.dtype,
                           device=a.device)


def wrap_arena(arena, device=None) -> ArenaStorage:
    """Adopt an arena under the storage protocol: storage passes through,
    a numpy array becomes a HostArena, a tensor a DeviceArena."""
    if isinstance(arena, ArenaStorage):
        return arena
    if isinstance(arena, np.ndarray):
        return HostArena(arena, device)
    return DeviceArena(arena)


# --------------------------------------------------------------------------
# Device paging
# --------------------------------------------------------------------------

# each part of an upload starts on a 256-byte boundary of its allocation
_ALIGN_WORDS = 64


def _pad_dict_rows(n: int) -> int:
    """Pow2 padding (floor 8) of a staged dictionary's height, as the JAX
    cache pads it, so both caches account the same bytes."""
    return max(8, 1 << max(0, int(n) - 1).bit_length())


def common_tile_rows(storage: ArenaStorage) -> int | None:
    """Row count unifying all of a sharded storage's tiles (the tallest
    shard), or None for dense single-shard storage."""
    if storage.n_shards <= 1:
        return None
    return int(np.max(np.diff(storage.shard_row_starts)))


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceTileCache:
    """Bounded LRU of shard id -> device tile.

    ``capacity_bytes`` caps resident tile bytes (None = unbounded). A miss
    ("page fault") stages the shard onto ``device`` (None = the storage's
    device) and may evict tiles. ``pad_rows_to`` zero-pads every staged
    tile to a common row count; addressed rows are always below the real
    shard height, so results are unchanged. (The JAX cache pads so that
    one compiled kernel serves every shard; PyTorch runs eagerly, so here
    padding only costs bytes and the QueryEngine does not ask for it.)

    Compressed residency: ``get_compressed`` stages a rowdict shard's
    (dict, refs) pair instead of the expanded tile, and the cache accounts
    the compressed bytes. The dict is zero-padded to a pow2 height (floor
    8) and refs are padded with slot 0 up to ``pad_rows_to``; ``refs`` are
    checked to lie in [0, D) once, here, and not on every kernel call. Raw
    and compressed forms are separate entries (key ``s`` and ``("c", s)``)
    in one LRU and one byte budget; eviction takes the least recently
    used RAW tile first (``_evict_victim``).

    ``prefetch`` stages a tile ahead of use and counts as a fault;
    ``prefetch_hits`` counts gets served by a prefetched tile. Every
    staging from host memory is one host copy from the (read-only,
    mmap-backed) shard into one of the cache's two staging buffers, used
    in turn, then a copy to the device. The buffers are kept and grown,
    never asked for anew a fault (``staging_allocs`` counts their
    allocations); on a CUDA device they are pinned and the copy is
    asynchronous, on the cache's own side stream, and the host waits for
    the last copy out of a buffer before it writes that buffer again, so
    the host copy of one staging overlaps the device copy of the one
    before. The consuming stream waits on the copy's event when it gets
    the tile, and the tile is ``record_stream``-ed onto it, so the caching
    allocator cannot hand the tile's memory out again while a kernel
    still reads it. A copy from pageable memory would be synchronous,
    which is why the buffers are pinned: with them, the next shard's copy
    overlaps the current shard's kernel. While a torch profiler runs, the
    host copy and the copy's enqueue are the ranges ``repro.tile.host_copy``
    and ``repro.tile.h2d``. ``upload`` sends other host data (the rows a
    batch gathers from a shard that is not resident) the same way.

    ``generation`` counts residency changes (a tile staged or evicted, the
    cache cleared). ``block_table`` keeps one grouped lookup's block table
    over resident tiles (``ops.BlockTable``) and builds it anew once the
    generation moves; the table holds no tile, so an evicted tile's memory
    goes back as soon as the dispatch that got it drops it.

    Counters (hits, faults, prefetched, prefetch_hits, evictions, the
    per-shard dicts, resident and staged bytes) equal the JAX cache's for
    the same access sequence. ``observer(shard, event, seconds)`` sees
    every hit, fault, prefetch and eviction; ``seconds`` is the host time
    of a staging. All mutation happens under one re-entrant lock, so a
    cache can be shared between threads.
    """

    def __init__(self, storage: ArenaStorage,
                 capacity_bytes: int | None = None,
                 pad_rows_to: int | None = None,
                 device=None):
        self.storage = storage
        self.capacity_bytes = capacity_bytes
        self.pad_rows_to = pad_rows_to
        self.device = _canonical(storage.device if device is None
                                 else resolve_device(device))
        self._lock = threading.RLock()
        # key: shard id (raw tile) or ("c", shard id) (dict form)
        self._tiles: OrderedDict = OrderedDict()
        self._ready: dict = {}          # key -> the side stream's copy event
        self._sizes: dict = {}
        self._prefetched: set = set()
        self._copy_stream = None
        # two int32 host buffers used in turn, and for each the event of
        # the last copy out of it
        self._staging: list = [None, None]
        self._staging_free: list = [None, None]
        self._turn = 0
        self.staging_allocs = 0
        self.resident_bytes = 0
        self.hits = 0
        self.faults = 0
        self.prefetched = 0
        self.prefetch_hits = 0
        self.evictions = 0
        self.raw_bytes_staged = 0
        self.comp_bytes_staged = 0
        self.shard_hits: dict[int, int] = {}
        self.shard_faults: dict[int, int] = {}
        self.shard_evictions: dict[int, int] = {}
        self.generation = 0
        self._table = None      # (generation, base, n_blocks, plans, table)
        self.observer = None

    def _notify(self, s: int, event: str, seconds: float = 0.0) -> None:
        if self.observer is not None:
            try:
                self.observer(s, event, seconds)
            except Exception:
                pass              # accounting must never fail a gather

    # -- staging -------------------------------------------------------------
    def _staging_buffer(self, n_words: int) -> tuple[int, torch.Tensor]:
        """The next staging buffer in turn and its slot, int32 [>=
        n_words], once the last copy out of it has ended; grown by half
        again at the least, so tiles of slightly different heights do not
        each allocate."""
        i = self._turn
        self._turn = 1 - i
        if self._staging_free[i] is not None:
            self._staging_free[i].synchronize()
            self._staging_free[i] = None
        buf = self._staging[i]
        if buf is None or buf.numel() < n_words:
            grown = 0 if buf is None else buf.numel() * 3 // 2
            self._staging[i] = buf = None
            self._staging[i] = buf = torch.empty(
                max(n_words, grown), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
            self.staging_allocs += 1
        return i, buf

    def upload(self, shapes: list[tuple[int, ...]], fill,
               fill_span: str = "tile.host_copy"):
        """Host data to the cache's device through the staging buffer:
        ``fill(views)`` writes each part into its view, an int32 numpy
        array of ``shapes[i]`` in the buffer (inside the range
        ``repro.<fill_span>``), and one copy takes them all. Returns the
        parts on the device, each at a 256-byte boundary of one
        allocation, and the side stream's event (None off CUDA). Under
        the cache's lock, as the buffers are the cache's."""
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        offs = np.concatenate([[0], np.cumsum(
            [-(-n // _ALIGN_WORDS) * _ALIGN_WORDS for n in sizes])])
        total = max(1, int(offs[-1]))
        ready = None
        with self._lock:
            slot, buf = self._staging_buffer(total)
            with span(fill_span):
                host = buf.numpy()
                fill([host[o:o + n].reshape(s)
                      for o, n, s in zip(offs, sizes, shapes)])
            if self.device.type != "cuda":
                with span("tile.h2d"):
                    dev = buf[:total].clone().to(self.device)
            else:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(device=self.device)
                with span("tile.h2d"), torch.cuda.stream(self._copy_stream):
                    dev = buf[:total].to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                self._staging_free[slot] = ready
        return [dev[o:o + n].view(s)
                for o, n, s in zip(offs, sizes, shapes)], ready

    def _upload(self, arrays: list[np.ndarray], rows: list[int]):
        """Copy 4-byte host arrays, each zero-padded along axis 0 to
        ``rows[i]``, to the cache's device as int32 tensors. Returns the
        tensors and the side stream's event (None off CUDA)."""
        arrays = [np.asarray(a) for a in arrays]

        def fill(views):
            for a, v in zip(arrays, views):
                v[:a.shape[0]] = a.view(np.int32)
                v[a.shape[0]:] = 0

        return self.upload([(n,) + a.shape[1:]
                            for a, n in zip(arrays, rows)], fill)

    def wait(self, tensors, ready) -> None:
        """Order the current stream after the copy ``ready`` of
        ``tensors`` (from ``upload``) and tie their memory to it."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors:
                t.record_stream(stream)

    def _storage_on_device(self) -> bool:
        return (isinstance(self.storage, (DeviceArena, HostArena))
                and _canonical(self.storage.device) == self.device)

    def _stage(self, s: int):
        if self._storage_on_device():
            tile = self.storage.shard_device(s)
            pad = (self.pad_rows_to - tile.shape[0] if self.pad_rows_to
                   else 0)
            if pad < 0:
                raise ValueError(f"shard {s} taller than pad_rows_to")
            if pad:
                tile = torch.nn.functional.pad(tile, (0, 0, 0, pad))
            return tile, None
        host = self.storage.shard_host(s)
        rows = self.pad_rows_to or int(host.shape[0])
        if rows < host.shape[0]:
            raise ValueError(f"shard {s} taller than pad_rows_to")
        (tile,), ready = self._upload([host], [rows])
        return tile, ready

    def _stage_compressed(self, s: int):
        d = self.storage.shard_dict_host(s)
        if d is None:
            raise ValueError(f"shard {s} has no dict form "
                             f"(codec {self.storage.shard_codec(s)!r})")
        dict_rows, refs = d
        D, R = int(dict_rows.shape[0]), int(refs.shape[0])
        pad_to = self.pad_rows_to or R
        if pad_to < R:
            raise ValueError(f"shard {s} taller than pad_rows_to")
        if R and (int(refs.min()) < 0 or int(refs.max()) >= D):
            raise ValueError(f"shard {s}: refs outside its {D}-row "
                             "dictionary")
        (dict_tile, refs_tile), ready = self._upload(
            [dict_rows, refs], [_pad_dict_rows(D), pad_to])
        return (dict_tile, refs_tile), ready

    def _tile_nbytes(self, s: int) -> int:
        if not self.pad_rows_to:
            return self.storage.shard_nbytes(s)
        return self.pad_rows_to * int(self.storage.shape[1]) * 4

    # -- the LRU -------------------------------------------------------------
    @staticmethod
    def _shard_of(key) -> int:
        return key[1] if isinstance(key, tuple) else key

    def __len__(self) -> int:
        return len(self._tiles)

    @property
    def resident_shards(self) -> tuple[int, ...]:
        return tuple(self._shard_of(k) for k in self._tiles)

    def has_compressed(self, s: int) -> bool:
        return ("c", s) in self._tiles

    def resident(self, s: int, compressed: bool = False) -> bool:
        """Whether shard ``s``'s tile (or (dict, refs) pair) is staged."""
        return (("c", s) if compressed else s) in self._tiles

    def dict_form(self, s: int, compressed: bool) -> bool:
        """Whether shard ``s`` is scored from its (dict, refs) pair: under
        compressed serving, where its codec is dict-coded."""
        return compressed and self.storage.shard_codec(s) in _codec.DICT_CODECS

    def form_nbytes(self, s: int, compressed: bool = False) -> int:
        """Device bytes shard ``s``'s tile (or (dict, refs) pair) takes
        once staged, as the cache accounts them."""
        if not compressed:
            return self._tile_nbytes(s)
        dict_rows, refs = self.storage.shard_dict_host(s)
        return 4 * (_pad_dict_rows(dict_rows.shape[0]) * dict_rows.shape[1]
                    + (self.pad_rows_to or int(refs.shape[0])))

    def fits(self, nbytes: int) -> bool:
        """Whether ``nbytes`` more fit beside the resident tiles without
        evicting one."""
        return (self.capacity_bytes is None
                or self.resident_bytes + nbytes <= self.capacity_bytes)

    def warm(self, shards, compressed=lambda s: False) -> list[int]:
        """Stage, in order, the tiles of ``shards`` that fit beside the
        resident ones without evicting any (the (dict, refs) pair where
        ``compressed(s)``), as a deployment warms its cache when its store
        opens. Each counts as a prefetch; returns the shards staged."""
        staged = []
        for s in shards:
            c = bool(compressed(s))
            if (not self.resident(s, c)
                    and self.fits(self.form_nbytes(s, c))):
                self._prefetch(("c", s) if c else s)
                staged.append(s)
        return staged

    def _evict_victim(self):
        """The least recently used RAW tile goes first: a dict entry holds
        ratio-times more arena per resident byte. Plain LRU when only dict
        entries remain."""
        for key in self._tiles:                # OrderedDict: LRU first
            if not isinstance(key, tuple):
                return key
        return next(iter(self._tiles))

    def _insert(self, key):
        s = self._shard_of(key)
        compressed = isinstance(key, tuple)
        t0 = time.perf_counter()
        tile, ready = (self._stage_compressed(s) if compressed
                       else self._stage(s))
        staged_s = time.perf_counter() - t0
        if compressed:
            need = sum(int(t.nbytes) for t in tile)
            self.comp_bytes_staged += need
        else:
            need = self._tile_nbytes(s)
            self.raw_bytes_staged += need
        if self.capacity_bytes is not None:
            while (self._tiles
                   and self.resident_bytes + need > self.capacity_bytes):
                old = self._evict_victim()
                del self._tiles[old]
                self._ready.pop(old, None)
                self.resident_bytes -= self._sizes.pop(old)
                self._prefetched.discard(old)
                old_s = self._shard_of(old)
                self.shard_evictions[old_s] = \
                    self.shard_evictions.get(old_s, 0) + 1
                self.evictions += 1
                self.generation += 1
                self._notify(old_s, "eviction")
        self._tiles[key] = tile
        self.generation += 1
        if ready is not None:
            self._ready[key] = ready
        self._sizes[key] = need
        self.resident_bytes += need
        return tile, staged_s

    def _hand_out(self, key, tile):
        """Order the current stream after the tile's copy and tie the
        tile's memory to that stream."""
        self.wait(tile if isinstance(tile, tuple) else (tile,),
                  self._ready.get(key))
        return tile

    def _get(self, key):
        with self._lock:
            s = self._shard_of(key)
            tile = self._tiles.get(key)
            if tile is not None:
                self._tiles.move_to_end(key)
                self.hits += 1
                self.shard_hits[s] = self.shard_hits.get(s, 0) + 1
                if key in self._prefetched:
                    self._prefetched.discard(key)
                    self.prefetch_hits += 1
                self._notify(s, "hit")
                return self._hand_out(key, tile)
            self.faults += 1
            self.shard_faults[s] = self.shard_faults.get(s, 0) + 1
            tile, staged_s = self._insert(key)
            self._notify(s, "fault", staged_s)
            return self._hand_out(key, tile)

    def get(self, s: int) -> torch.Tensor:
        """Shard ``s``'s raw tile (int32 [rows, W]) on the device, staged
        on a miss."""
        return self._get(s)

    def get_compressed(self, s: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(dict int32 [D_pad, W], refs int32 [rows or pad_rows_to]) on the
        device: the fused-decode kernels' inputs."""
        return self._get(("c", s))

    def _prefetch(self, key) -> bool:
        with self._lock:
            if key in self._tiles:
                return False
            s = self._shard_of(key)
            self.faults += 1
            self.shard_faults[s] = self.shard_faults.get(s, 0) + 1
            self.prefetched += 1
            self._prefetched.add(key)
            _, staged_s = self._insert(key)
            self._notify(s, "prefetch", staged_s)
            return True

    def prefetch(self, s: int) -> bool:
        """Stage shard ``s`` ahead of use. Counts as a fault; returns True
        if a tile was staged, False if it was already resident."""
        return self._prefetch(s)

    def prefetch_compressed(self, s: int) -> bool:
        """``prefetch`` for the dict form (see ``get_compressed``)."""
        return self._prefetch(("c", s))

    def block_table(self, plans, tiles: list[torch.Tensor], base: int,
                    n_blocks: int) -> ops.BlockTable:
        """The block table of a grouped lookup over ``plans``' blocks
        (``core.query.ShardPlan``s of raw shards resident now; ``tiles``
        their tiles, as ``get`` handed them out) in a dispatch over blocks
        [base, base + n_blocks): a plan's block b is an entry of its rows
        (its row offset and width) in the plan's tile, at slot b - base. Kept
        while the generation, the plans and the span stay, and built anew
        otherwise: a block whose rows pass its tile raises then. The
        entries' tile pointers hold while the generation does."""
        with self._lock:
            kept = self._table
            if (kept is None or kept[:3] != (self.generation, base, n_blocks)
                    or len(kept[3]) != len(plans)
                    or any(a is not b for a, b in zip(kept[3], plans))):
                table = ops.BlockTable(
                    tiles, np.concatenate([sp.row_offset for sp in plans]),
                    np.concatenate([sp.block_width for sp in plans]),
                    np.concatenate([np.arange(sp.block_start, sp.block_end)
                                    - base for sp in plans]), n_blocks,
                    tile_of=np.repeat(np.arange(len(plans)), [
                        sp.block_end - sp.block_start for sp in plans]))
                self._table = kept = (self.generation, base, n_blocks,
                                      list(plans), table)
            return kept[4]

    def clear(self) -> None:
        with self._lock:
            self._tiles.clear()
            self._ready.clear()
            self._sizes.clear()
            self._prefetched.clear()
            self.resident_bytes = 0
            self.generation += 1
