"""Parallel, resumable and out-of-core compact-index construction (the
counterpart of ``repro.index.build_parallel``).

Blocks are independent, so ``build_compact_parallel`` builds them from a
thread pool and checkpoints each finished block (``block%06d.npy`` plus a
``blocks.json`` list of finished blocks); a restart reuses them.

``build_compact_streaming`` is the out-of-core variant: each block group is
built on the device by ``bloom.build_block_matrix``, copied to the host,
encoded and written as one shard of a ``cobs-jax-v2`` store, then
released. One block group per worker is live at a time, so the full arena
is never concatenated anywhere. The returned index maps the store just
written, and a rerun over an interrupted store skips every shard already
on disk. Both builders give arenas equal, word for word, to
``core.index.build_compact``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..core import bloom
from ..core.arena import DeviceArena
from ..core.index import BitSlicedIndex, IndexParams, plan_compact_layout
from ..core.store import ShardStoreWriter, load_index_v2
from ..device import resolve_device


def _block_host(terms: list[np.ndarray], w: int, params: IndexParams,
                block_docs: int, dev: torch.device) -> np.ndarray:
    """One block matrix built on ``dev``, as host uint32 [w, words]."""
    m = bloom.build_block_matrix(terms, w, params.n_hashes, block_docs, dev)
    return m.cpu().numpy().view(np.uint32)


def build_compact_parallel(
    doc_terms: list[np.ndarray],
    params: IndexParams = IndexParams(),
    block_docs: int = 1024,
    row_align: int = bloom.ROW_ALIGN,
    workers: int = 4,
    checkpoint_dir: str | Path | None = None,
    device=None,
) -> BitSlicedIndex:
    """``build_compact`` built block-parallel on ``device`` (None = the CUDA
    card), with optional per-block checkpoint and restart."""
    dev = resolve_device(device)
    if not doc_terms:
        raise ValueError("empty document set")
    counts = np.array([t.shape[0] for t in doc_terms], dtype=np.int64)
    layout, order = plan_compact_layout(counts, params, block_docs, row_align)
    block_docs = layout.block_docs
    n_blocks = layout.n_blocks

    ckpt = Path(checkpoint_dir) if checkpoint_dir else None
    done: dict[int, np.ndarray] = {}
    if ckpt is not None:
        ckpt.mkdir(parents=True, exist_ok=True)
        manifest = ckpt / "blocks.json"
        if manifest.exists():
            for b in json.loads(manifest.read_text()).get("done", []):
                f = ckpt / f"block{b:06d}.npy"
                if f.exists():
                    done[int(b)] = np.load(f)

    def build_one(b: int) -> tuple[int, np.ndarray]:
        if b in done:
            return b, done[b]
        ids = order[b * block_docs:(b + 1) * block_docs]
        m = _block_host([doc_terms[i] for i in ids],
                        int(layout.block_width[b]), params, block_docs, dev)
        if ckpt is not None:
            np.save(ckpt / f"block{b:06d}.npy", m)
        return b, m

    def checkpoint_manifest(results: dict[int, np.ndarray]) -> None:
        if ckpt is not None:
            (ckpt / "blocks.json").write_text(
                json.dumps({"done": sorted(results.keys())}))

    results: dict[int, np.ndarray] = {}
    if workers <= 1:
        for b in range(n_blocks):
            results.update([build_one(b)])
            checkpoint_manifest(results)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for b, m in pool.map(build_one, range(n_blocks)):
                results[b] = m
                checkpoint_manifest(results)

    arena = np.concatenate([results[b] for b in range(n_blocks)], axis=0)
    return BitSlicedIndex(
        layout, DeviceArena(torch.from_numpy(
            np.ascontiguousarray(arena).view(np.int32)).to(dev)), params)


@dataclasses.dataclass
class StreamingBuildStats:
    """Host-memory accounting for a streaming build: ``peak_block_bytes``
    is the high-water mark of block-group matrices live at once inside the
    builder, beside ``max_shard_bytes`` and ``total_arena_bytes``.
    ``comp_bytes``/``comp_ratio`` record the store's on-disk compression
    (1.0 for raw builds)."""
    n_shards: int
    n_resumed: int
    max_shard_bytes: int
    total_arena_bytes: int
    peak_block_bytes: int
    comp_bytes: int = 0
    comp_ratio: float = 1.0
    n_compressed_shards: int = 0


def build_compact_streaming(
    doc_terms: list[np.ndarray],
    store_path: str | Path,
    params: IndexParams = IndexParams(),
    block_docs: int = 1024,
    row_align: int = bloom.ROW_ALIGN,
    blocks_per_shard: int = 1,
    workers: int = 1,
    codec: str = "raw",
    device=None,
) -> tuple[BitSlicedIndex, StreamingBuildStats]:
    """Build a compact index on ``device`` (None = the CUDA card) straight
    into a cobs-jax-v2 store at ``store_path``.

    The same plan and block matrices as ``build_compact``, but never more
    than ``workers`` block groups in host memory: each finished group is
    written as one shard (encoded under ``codec``, "auto" for smallest
    wins) and released. Shards already on disk are skipped. Returns the
    index mapped from the store, on ``device``, and the accounting."""
    dev = resolve_device(device)
    if not doc_terms:
        raise ValueError("empty document set")
    counts = np.array([t.shape[0] for t in doc_terms], dtype=np.int64)
    layout, order = plan_compact_layout(counts, params, block_docs, row_align)
    writer = ShardStoreWriter(store_path, layout, params, blocks_per_shard,
                              codec=codec)

    lock = threading.Lock()
    live_bytes = 0
    peak_bytes = 0
    n_resumed = 0

    def account(delta: int) -> None:
        nonlocal live_bytes, peak_bytes
        with lock:
            live_bytes += delta
            peak_bytes = max(peak_bytes, live_bytes)

    def build_shard(s: int) -> None:
        nonlocal n_resumed
        if writer.have_shard(s):
            with lock:
                n_resumed += 1
            return
        b0, b1 = writer.shard_blocks(s)
        nbytes = writer.shard_shape(s)[0] * layout.doc_words * 4
        account(+nbytes)
        try:
            groups = []
            for b in range(b0, b1):
                ids = order[b * layout.block_docs:(b + 1) * layout.block_docs]
                groups.append(_block_host(
                    [doc_terms[i] for i in ids], int(layout.block_width[b]),
                    params, layout.block_docs, dev))
            matrix = groups[0] if len(groups) == 1 else \
                np.concatenate(groups, axis=0)
            writer.write_shard(s, matrix)
        finally:
            account(-nbytes)

    if workers <= 1:
        for s in range(writer.n_shards):
            build_shard(s)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(build_shard, range(writer.n_shards)))
    writer.finalize()

    index = load_index_v2(store_path, device=dev)
    shard_bytes = [index.storage.shard_nbytes(s)
                   for s in range(index.storage.n_shards)]
    raw_total, comp_total, n_comp = index.storage.comp_summary()
    stats = StreamingBuildStats(
        n_shards=writer.n_shards,
        n_resumed=n_resumed,
        max_shard_bytes=max(shard_bytes),
        total_arena_bytes=sum(shard_bytes),
        peak_block_bytes=peak_bytes,
        comp_bytes=comp_total,
        comp_ratio=round(raw_total / comp_total, 4) if comp_total else 1.0,
        n_compressed_shards=n_comp,
    )
    return index, stats
