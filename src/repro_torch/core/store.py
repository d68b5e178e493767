"""cobs-jax-v2: the out-of-core, shard-per-block-group index directory, the
counterpart of ``repro.core.store``. The format string stays
``"cobs-jax-v2"``: the two packages open each other's stores.

Layout on disk::

    <path>/
      manifest.json            format, params, layout metadata, shard table
      meta.npz                 row_offset / block_width / doc_slot / doc_n_terms
      shard-000000.npy         raw .npy (or shard-000000.dict.npy +
      shard-000001.npy          .refs.npy, .rle.npy for compressed codecs)
      pops-000000.npy          per-row popcount sidecar
      ...

Each shard holds the arena rows of one block group (``blocks_per_shard``
consecutive blocks). The manifest's shard table records, per shard, the
block range, the row range, the codec and its component files, and a
blake2b hash of the decoded tile, so an opened store can verify integrity
shard by shard. Shards are ``.npy`` files opened with ``mmap_mode='r'``:
opening a store costs metadata only, and the tile cache pages shards to
the card one at a time.

The writer streams: ``ShardStoreWriter.write_shard`` persists one finished
block group and forgets it. The manifest (key order, ``indent=2``,
rounding) and the ``pops-*.npy`` sidecars are written exactly as the JAX
writer writes them, so a store built by either package is byte-equal.
The port's kernel tuner keeps its cache beside the manifest as
``tuning-torch.json`` (``tuning_path``); the JAX tuner's ``tuning.json``
holds costs measured on another device and is not read or written here.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import codec as _codec
from .arena import ArenaLayout, MappedArena
from .index import BitSlicedIndex, IndexParams

FORMAT_V2 = "cobs-jax-v2"
# not the JAX package's "tuning.json": costs measured on a TPU must never
# steer the card, so each package keeps its own file
TUNING_CACHE_NAME = "tuning-torch.json"


def tuning_path(path: str | Path) -> Path:
    """The kernel-tuning cache persisted beside a v2 store's manifest:
    tuned entries key on the arena geometry the store fixes, so the cache
    travels with the shards it was measured for (a reopened store serves
    with measured choices and never re-tunes; see
    ``repro_torch.kernels.autotune.TuningCache``)."""
    return Path(path) / TUNING_CACHE_NAME


def _hash_array(a: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                           digest_size=16).hexdigest()


# "pops-" prefix, not a "shard-" suffix: data shards must stay exactly
# the ``shard-*.npy`` glob that merge tooling and resume tests rely on
def _pops_name(s: int) -> str:
    return f"pops-{s:06d}.npy"


def row_popcounts(matrix: np.ndarray, *, rows_per_slab: int = 1 << 16
                  ) -> np.ndarray:
    """Per-slice popcount stats: uint32 [rows] with the number of set doc
    bits in each arena row of a decoded shard tile. Recorded at build time
    as a ``pops-*.npy`` sidecar so the pruned executor can order a query's
    terms rarest-first (low-popcount rows keep non-matching blocks'
    running counts low, which is what makes the branch-and-bound kill
    blocks early) without ever reading the arena itself."""
    out = np.empty(matrix.shape[0], dtype=np.uint32)
    for r0 in range(0, matrix.shape[0], rows_per_slab):
        slab = np.ascontiguousarray(matrix[r0:r0 + rows_per_slab])
        if hasattr(np, "bitwise_count"):        # numpy 2: a popcount
            counts = np.bitwise_count(slab.view(np.uint32))
        else:
            counts = np.unpackbits(slab.view(np.uint8), axis=1)
        out[r0:r0 + slab.shape[0]] = counts.sum(axis=1, dtype=np.int64)
    return out


def shard_row_bounds(layout: ArenaLayout, blocks_per_shard: int = 1
                     ) -> np.ndarray:
    """Shard boundaries (int64 [n_shards+1]) grouping ``blocks_per_shard``
    consecutive blocks per shard — always on block edges."""
    if blocks_per_shard < 1:
        raise ValueError("blocks_per_shard must be >= 1")
    bounds = [0]
    for b0 in range(0, layout.n_blocks, blocks_per_shard):
        b1 = min(b0 + blocks_per_shard, layout.n_blocks) - 1
        bounds.append(int(layout.row_offset[b1]) + int(layout.block_width[b1]))
    return np.asarray(bounds, dtype=np.int64)


def _shard_name(s: int) -> str:
    return f"shard-{s:06d}.npy"


def _shard_stem(s: int) -> str:
    return f"shard-{s:06d}"


_CODEC_COMPONENTS = {
    _codec.CODEC_RAW: ("data",),
    _codec.CODEC_ROWDICT: ("dict", "refs"),
    _codec.CODEC_ROWDICT_RLE: ("rle", "refs"),
    _codec.CODEC_RLE: ("rle",),
}


def _shard_files(s: int, codec: str) -> dict[str, str]:
    """Component name -> file name for shard ``s`` under ``codec``. Raw
    keeps the historic single ``shard-%06d.npy``; compressed shards store
    each component as its own mmap-able ``.npy``."""
    stem = _shard_stem(s)
    return {c: stem + _codec.COMPONENT_SUFFIX[c]
            for c in _CODEC_COMPONENTS[codec]}


def _pops_from_entry(path: Path, entry: dict) -> Path | None:
    """Popcount-sidecar path for one manifest shard row, or None for
    stores written before the stats field existed (readers then fall back
    to natural term order — the field is optional both ways)."""
    name = entry.get("pops")
    if not name:
        return None
    p = path / name
    return p if p.exists() else None


def _source_from_entry(path: Path, entry: dict, doc_words: int):
    """MappedArena source for one manifest shard row: the raw file path,
    or a lazy CompressedShardSource for non-raw codecs. Manifests written
    before the codec layer have no "codec" key — treated as raw."""
    codec = entry.get("codec", _codec.CODEC_RAW)
    if codec == _codec.CODEC_RAW:
        return path / entry["file"]
    rows = int(entry["rows"][1]) - int(entry["rows"][0])
    return _codec.CompressedShardSource(
        codec=codec,
        paths={c: path / f for c, f in entry["files"].items()},
        rows=rows,
        doc_words=int(doc_words),
        comp_nbytes=int(entry["comp_bytes"]))


class ShardStoreWriter:
    """Streaming writer for a v2 store.

    The layout (known up front from term counts alone) fixes the shard
    table; block-group matrices are then written one at a time in any
    order. ``finalize`` persists metadata + manifest and fails if shards
    are missing. Re-running over an existing directory resumes: shards
    whose file already matches the expected shape (and hash, if a partial
    manifest is present) are skipped by the builder via ``have_shard``.

    ``codec`` selects the per-shard tile codec (``codec.CODECS``,
    or "auto" for smallest-wins): each tile is encoded independently and
    falls back to raw when compression doesn't pay, so a store may mix
    codecs shard by shard. Content hashes are ALWAYS over the decoded
    tile — raw<->compressed migration preserves them.
    """

    def __init__(self, path: str | Path, layout: ArenaLayout,
                 params: IndexParams, blocks_per_shard: int = 1,
                 codec: str = _codec.CODEC_RAW):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.layout = layout
        self.params = params
        self.blocks_per_shard = int(blocks_per_shard)
        if codec not in _codec.CODECS + ("auto",):
            raise ValueError(f"unknown codec {codec!r}")
        self.codec = codec
        self.row_starts = shard_row_bounds(layout, blocks_per_shard)
        self.block_ranges = layout.shard_blocks(self.row_starts)
        self._hashes: dict[int, str] = {}
        self._entries: dict[int, dict] = {}   # codec/files/bytes per shard

    @property
    def n_shards(self) -> int:
        return len(self.row_starts) - 1

    def shard_shape(self, s: int) -> tuple[int, int]:
        rows = int(self.row_starts[s + 1] - self.row_starts[s])
        return rows, self.layout.doc_words

    def shard_blocks(self, s: int) -> tuple[int, int]:
        return self.block_ranges[s]

    @staticmethod
    def _valid_components(codec: str, arrays: dict, rows: int, W: int
                          ) -> bool:
        """Cheap (header/shape-only) consistency check for resumed shard
        component files — full integrity is the manifest hash's job."""
        try:
            if codec == _codec.CODEC_RAW:
                return (arrays["data"].shape == (rows, W)
                        and arrays["data"].dtype == np.uint32)
            if "refs" in arrays:
                r = arrays["refs"]
                if r.shape != (rows,) or r.dtype != np.int32:
                    return False
            if codec == _codec.CODEC_ROWDICT:
                d = arrays["dict"]
                return (d.ndim == 2 and d.shape[1] == W
                        and d.dtype == np.uint32)
            rle = arrays["rle"]
            if rle.ndim != 1 or rle.dtype != np.uint32 or rle.size < 3:
                return False
            if codec == _codec.CODEC_RLE:
                return int(rle[0]) == rows and int(rle[1]) == W
            return int(rle[1]) == W     # rowdict+rle header: [D, W, P]
        except (KeyError, IndexError, AttributeError):
            return False

    def _resume_entry(self, s: int) -> dict | None:
        """Inspect disk for a complete shard ``s`` written by ANY codec
        (a resumed build may change the requested codec; what's on disk
        wins). Returns the codec/files/byte fields of the manifest entry,
        or None when no consistent set of component files exists."""
        rows, W = self.shard_shape(s)
        for codec in _CODEC_COMPONENTS:
            files = _shard_files(s, codec)
            paths = {c: self.path / f for c, f in files.items()}
            if not all(p.exists() for p in paths.values()):
                continue
            try:
                arrays = {c: np.load(p, mmap_mode="r")
                          for c, p in paths.items()}
            except (ValueError, OSError):
                continue
            if not self._valid_components(codec, arrays, rows, W):
                continue
            comp = int(sum(int(a.nbytes) for a in arrays.values()))
            raw_nb = rows * W * 4
            entry = {"codec": codec, "files": files, "comp_bytes": comp,
                     "ratio": round(raw_nb / comp, 4) if comp else 1.0}
            if codec == _codec.CODEC_ROWDICT:
                entry["dict_rows"] = int(arrays["dict"].shape[0])
            elif codec == _codec.CODEC_ROWDICT_RLE:
                entry["dict_rows"] = int(arrays["rle"][0])
            pops_path = self.path / _pops_name(s)
            if pops_path.exists():
                try:
                    pops = np.load(pops_path, mmap_mode="r")
                    if pops.shape == (rows,):
                        entry["pops"] = _pops_name(s)
                        entry["mean_pop"] = round(
                            float(np.asarray(pops).mean()) if rows else 0.0,
                            4)
                except (ValueError, OSError):
                    pass
            return entry
        return None

    def have_shard(self, s: int) -> bool:
        """A resumable shard: component files exist, shapes consistent."""
        return self._resume_entry(s) is not None

    def _clean_shard_files(self, s: int) -> None:
        stem = _shard_stem(s)
        for name in [stem + suffix
                     for suffix in _codec.COMPONENT_SUFFIX.values()] \
                + [_pops_name(s)]:
            f = self.path / name
            if f.exists():
                f.unlink()

    def write_shard(self, s: int, matrix: np.ndarray) -> None:
        if matrix.shape != self.shard_shape(s) or matrix.dtype != np.uint32:
            raise ValueError(
                f"shard {s}: got {matrix.dtype}{matrix.shape}, want "
                f"uint32{self.shard_shape(s)}")
        tile = _codec.encode_tile(matrix, self.codec)
        self._clean_shard_files(s)   # stale other-codec components confuse resume
        files = _shard_files(s, tile.codec)
        for comp, name in files.items():
            np.save(self.path / name, tile.arrays[comp])
        # per-slice popcount sidecar: an OPTIONAL manifest field (old
        # stores simply lack it and readers fall back to natural term
        # order), so the format stays backward- and forward-compatible
        pops = row_popcounts(matrix)
        np.save(self.path / _pops_name(s), pops)
        self._hashes[s] = _hash_array(matrix)   # hash the DECODED tile
        entry = {"codec": tile.codec, "files": files,
                 "comp_bytes": tile.comp_nbytes,
                 "ratio": round(tile.ratio, 4),
                 "pops": _pops_name(s),
                 "mean_pop": round(float(pops.mean()) if pops.size else 0.0,
                                   4)}
        d = tile.dict_form()
        if d is not None:
            entry["dict_rows"] = int(d[0].shape[0])
        self._entries[s] = entry

    def _shard_host_from_disk(self, s: int, entry: dict) -> np.ndarray:
        arrays = {c: np.load(self.path / f, mmap_mode="r")
                  for c, f in entry["files"].items()}
        rows, W = self.shard_shape(s)
        return _codec.tile_from_arrays(entry["codec"], arrays, rows,
                                       W).decode()

    def finalize(self) -> Path:
        shards = []
        raw_total = comp_total = 0
        for s in range(self.n_shards):
            info = self._entries.get(s)
            if info is None:                   # resumed shard: read disk
                info = self._resume_entry(s)
                if info is None:
                    raise FileNotFoundError(
                        f"missing shard files for shard {s} in {self.path}")
            h = self._hashes.get(s)
            if h is None:                      # resumed shard: hash from disk
                h = _hash_array(self._shard_host_from_disk(s, info))
            b0, b1 = self.block_ranges[s]
            rows, W = self.shard_shape(s)
            raw_total += rows * W * 4
            comp_total += int(info["comp_bytes"])
            entry = {
                "blocks": [b0, b1],
                "rows": [int(self.row_starts[s]), int(self.row_starts[s + 1])],
                "hash": h,
                **info,
            }
            if info["codec"] == _codec.CODEC_RAW:
                entry["file"] = info["files"]["data"]   # legacy readers
            shards.append(entry)
        np.savez(self.path / "meta.npz",
                 row_offset=self.layout.row_offset,
                 block_width=self.layout.block_width,
                 doc_slot=self.layout.doc_slot,
                 doc_n_terms=self.layout.doc_n_terms)
        manifest = {
            "format": FORMAT_V2,
            "block_docs": self.layout.block_docs,
            "n_docs": self.layout.n_docs,
            "params": self.params.to_json(),
            "codec": self.codec,
            "raw_bytes": raw_total,
            "comp_bytes": comp_total,
            "ratio": round(raw_total / comp_total, 4) if comp_total else 1.0,
            "shards": shards,
        }
        out = self.path / "manifest.json"
        tmp = self.path / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=2))
        tmp.rename(out)                        # manifest commit is atomic
        return out


def _read_store_meta(path: Path) -> tuple[dict, ArenaLayout, IndexParams]:
    """Manifest + layout + params of a v2 store (metadata only)."""
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest.get("format") != FORMAT_V2:
        raise ValueError(f"not a {FORMAT_V2} store: {path}")
    with np.load(path / "meta.npz") as z:
        layout = ArenaLayout.make(
            z["row_offset"], z["block_width"], z["doc_slot"],
            z["doc_n_terms"], int(manifest["block_docs"]),
            int(manifest["n_docs"]))
    params = IndexParams.from_json(manifest["params"])
    return manifest, layout, params


def _verify_shards(storage: MappedArena, shards: list[dict],
                   which: range | list[int] | None = None) -> None:
    """Check content hashes of the storage's shards against the manifest
    rows ``shards`` (local index i holds manifest row shards[i])."""
    for i in (range(len(shards)) if which is None else which):
        got = _hash_array(storage.shard_host(i))
        if got != shards[i]["hash"]:
            name = shards[i].get("file") or "+".join(
                sorted(shards[i].get("files", {}).values())) or f"#{i}"
            raise IOError(f"shard {name} content hash mismatch")


def open_store(path: str | Path, *, verify: bool = False, device=None
               ) -> tuple[ArenaLayout, MappedArena, IndexParams]:
    """Open a v2 store as (layout, mmap-backed storage, params) without
    reading arena bytes (``verify=True`` additionally checks every shard's
    content hash, which does read them). ``device`` (None = the CUDA card)
    is where the storage's tiles go."""
    path = Path(path)
    manifest, layout, params = _read_store_meta(path)
    shards = manifest["shards"]
    starts = np.asarray([s["rows"][0] for s in shards]
                        + [shards[-1]["rows"][1]], dtype=np.int64)
    sources = [_source_from_entry(path, s, layout.doc_words)
               for s in shards]
    storage = MappedArena(sources, starts, doc_words=layout.doc_words,
                          pop_sources=[_pops_from_entry(path, s)
                                       for s in shards], device=device)
    if verify:
        _verify_shards(storage, shards)
    return layout, storage, params


@dataclass(frozen=True)
class SubStore:
    """A per-host view of a v2 store: only the assigned manifest rows.

    ``layout`` stays the FULL store layout (query addressing needs global
    block geometry), while ``storage`` maps only the selected shard files,
    re-indexed locally (local shard i is global manifest row
    ``shard_ids[i]``). ``global_row_starts`` gives the parent store's shard
    boundaries so per-shard addressing can be rebased against the global
    arena (see ``query.plan_shards_subset``).
    """

    layout: ArenaLayout
    storage: MappedArena
    params: IndexParams
    shard_ids: tuple[int, ...]
    global_row_starts: np.ndarray   # int64 [n_shards_total + 1]

    @property
    def n_shards_total(self) -> int:
        return len(self.global_row_starts) - 1


def open_substore(path: str | Path, shard_ids, *, verify: bool = False,
                  device=None) -> SubStore:
    """Open a manifest-subset view of a v2 store: a host materializes (as
    lazily-mmapped sources) only the shard files its placement assigns to
    it. Metadata cost only; ``verify=True`` hash-checks exactly the
    selected shards (the host's integrity gate at open)."""
    path = Path(path)
    manifest, layout, params = _read_store_meta(path)
    shards = manifest["shards"]
    ids = sorted(dict.fromkeys(int(s) for s in shard_ids))
    if not ids:
        raise ValueError("open_substore needs at least one shard id")
    if ids[0] < 0 or ids[-1] >= len(shards):
        raise ValueError(f"shard ids {ids} out of range "
                         f"[0, {len(shards)})")
    global_starts = np.asarray([s["rows"][0] for s in shards]
                               + [shards[-1]["rows"][1]], dtype=np.int64)
    heights = [shards[g]["rows"][1] - shards[g]["rows"][0] for g in ids]
    local_starts = np.concatenate([[0], np.cumsum(heights)]).astype(np.int64)
    storage = MappedArena(
        [_source_from_entry(path, shards[g], layout.doc_words)
         for g in ids],
        local_starts, doc_words=layout.doc_words,
        pop_sources=[_pops_from_entry(path, shards[g]) for g in ids],
        device=device)
    if verify:
        _verify_shards(storage, [shards[g] for g in ids])
    return SubStore(layout=layout, storage=storage, params=params,
                    shard_ids=tuple(ids), global_row_starts=global_starts)


def load_index_v2(path: str | Path, *, verify: bool = False, device=None
                  ) -> BitSlicedIndex:
    """The store at ``path`` as a mmap-backed index whose tiles go to
    ``device`` (None = the CUDA card)."""
    layout, storage, params = open_store(path, verify=verify, device=device)
    return BitSlicedIndex(layout, storage, params)


def save_index_v2(index: BitSlicedIndex, path: str | Path, *,
                  blocks_per_shard: int = 1,
                  codec: str = _codec.CODEC_RAW) -> None:
    """Write any index (whatever its storage backend) as a v2 store, one
    block group at a time — host memory stays bounded by one shard."""
    writer = ShardStoreWriter(path, index.layout, index.params,
                              blocks_per_shard, codec=codec)
    starts = writer.row_starts
    for s in range(writer.n_shards):
        rows = np.arange(starts[s], starts[s + 1], dtype=np.int64)
        writer.write_shard(
            s, np.ascontiguousarray(
                index.storage.read_rows_host(rows).astype(np.uint32)))
    writer.finalize()


def migrate_store_codec(src: str | Path, dst: str | Path,
                        codec: str = "auto") -> dict:
    """Re-encode a v2 store under another codec (raw<->compressed both
    ways; ``codec`` may be any CODECS member or "auto"). Shard geometry
    is preserved exactly, and because content hashes cover the DECODED
    tile, every shard's hash is identical in src and dst — migration is
    integrity-checkable end to end. Returns the dst manifest."""
    src = Path(src)
    layout, storage, params = open_store(src, device="cpu")   # host only
    manifest = json.loads((src / "manifest.json").read_text())
    b0, b1 = manifest["shards"][0]["blocks"]
    writer = ShardStoreWriter(dst, layout, params,
                              blocks_per_shard=max(1, int(b1) - int(b0)),
                              codec=codec)
    if writer.n_shards != storage.n_shards or not np.array_equal(
            writer.row_starts, storage.shard_row_starts):
        raise ValueError("migrate_store_codec: shard geometry mismatch "
                         "(non-uniform blocks_per_shard store?)")
    for s in range(writer.n_shards):
        writer.write_shard(
            s, np.ascontiguousarray(np.asarray(storage.shard_host(s),
                                               dtype=np.uint32)))
    writer.finalize()
    return json.loads((Path(dst) / "manifest.json").read_text())


def migrate_v1_to_v2(src: str | Path, dst: str | Path, *,
                     blocks_per_shard: int = 1) -> None:
    """Rewrite a legacy v1 monolith directory as a v2 shard store. The v1
    npz must be decompressed once (that is the format's flaw); shards are
    then written group by group."""
    src = Path(src)
    manifest = json.loads((src / "manifest.json").read_text())
    if manifest.get("format") != "cobs-jax-v1":
        raise ValueError(f"not a cobs-jax-v1 index: {src}")
    with np.load(src / "index.npz") as z:
        layout = ArenaLayout.make(
            z["row_offset"], z["block_width"], z["doc_slot"],
            z["doc_n_terms"], int(manifest["block_docs"]),
            int(manifest["n_docs"]))
        params = IndexParams.from_json(manifest["params"])
        writer = ShardStoreWriter(dst, layout, params, blocks_per_shard)
        arena = z["arena"]
        for s in range(writer.n_shards):
            r0, r1 = int(writer.row_starts[s]), int(writer.row_starts[s + 1])
            writer.write_shard(s, np.ascontiguousarray(arena[r0:r1]))
    writer.finalize()


def merge_stores(a: str | Path, b: str | Path, out: str | Path) -> None:
    """Merge two v2 COMPACT stores into a third by manifest concatenation:
    shard files are hard-linked (copied if the filesystem refuses links)
    and never read — the paper's section 2.3 concatenation as an
    O(metadata + n_shards) directory operation."""
    la, _, pa = open_store(a, device="cpu")     # metadata only
    lb, _, pb = open_store(b, device="cpu")
    if pa != pb:
        raise ValueError("parameter mismatch")
    from .index import merge_compact_layout
    layout = merge_compact_layout(la, lb)

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    man_a = json.loads((Path(a) / "manifest.json").read_text())
    man_b = json.loads((Path(b) / "manifest.json").read_text())
    W = layout.doc_words
    shards, row_base, block_base = [], 0, 0
    raw_total = comp_total = 0
    for src_dir, man in ((Path(a), man_a), (Path(b), man_b)):
        for s in man["shards"]:
            i = len(shards)
            codec = s.get("codec", _codec.CODEC_RAW)
            src_files = s.get("files") or {"data": s["file"]}
            new_files = _shard_files(i, codec)
            for comp, src_name in src_files.items():
                target = out / new_files[comp]
                if target.exists():
                    target.unlink()
                try:
                    os.link(src_dir / src_name, target)
                except OSError:
                    shutil.copyfile(src_dir / src_name, target)
            raw_nb = (int(s["rows"][1]) - int(s["rows"][0])) * W * 4
            comp_nb = int(s.get("comp_bytes", raw_nb))
            raw_total += raw_nb
            comp_total += comp_nb
            entry = {
                "blocks": [s["blocks"][0] + block_base,
                           s["blocks"][1] + block_base],
                "rows": [s["rows"][0] + row_base, s["rows"][1] + row_base],
                "hash": s["hash"],
                "codec": codec,
                "files": new_files,
                "comp_bytes": comp_nb,
                "ratio": float(s.get("ratio", 1.0)),
            }
            if "dict_rows" in s:
                entry["dict_rows"] = int(s["dict_rows"])
            if codec == _codec.CODEC_RAW:
                entry["file"] = new_files["data"]
            if s.get("pops") and (src_dir / s["pops"]).exists():
                target = out / _pops_name(i)
                if target.exists():
                    target.unlink()
                try:
                    os.link(src_dir / s["pops"], target)
                except OSError:
                    shutil.copyfile(src_dir / s["pops"], target)
                entry["pops"] = _pops_name(i)
                if "mean_pop" in s:
                    entry["mean_pop"] = float(s["mean_pop"])
            shards.append(entry)
        row_base += int(man["shards"][-1]["rows"][1])
        block_base += int(man["shards"][-1]["blocks"][1])
    np.savez(out / "meta.npz",
             row_offset=layout.row_offset, block_width=layout.block_width,
             doc_slot=layout.doc_slot, doc_n_terms=layout.doc_n_terms)
    codecs = {man_a.get("codec", _codec.CODEC_RAW),
              man_b.get("codec", _codec.CODEC_RAW)}
    manifest = {
        "format": FORMAT_V2,
        "block_docs": layout.block_docs,
        "n_docs": layout.n_docs,
        "params": pa.to_json(),
        "codec": codecs.pop() if len(codecs) == 1 else "mixed",
        "raw_bytes": raw_total,
        "comp_bytes": comp_total,
        "ratio": round(raw_total / comp_total, 4) if comp_total else 1.0,
        "shards": shards,
    }
    tmp = out / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.rename(out / "manifest.json")
