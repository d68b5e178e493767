"""Entry: the closed loop of ``inproc_closed`` over an index served out of
core, as a deployment serves a collection larger than its card: the
store on the host, mapped, and a bounded tile cache on the card.

Set-up builds the cell's index block by block on the card (``harness/
build.py``'s ``plan`` and ``_fill_block`` into a one-block buffer), copies
each block to the host and writes it as one shard of a ``cobs-jax-v2``
store (``ShardStoreWriter``, writer threads beside the card's build)
under a fresh directory in ``TMPDIR``. It then opens the store with
``open_store``, as a deployment would, serves it through ``QueryServer``
with the configuration's ``server`` settings, its tile budget given as
the deployment's share of the store (``tile_cache_share``, turned into
``tile_cache_bytes`` of the store built here), and warms the tile cache
to its budget (``QueryServer.warm_tiles``). All of it counts as set-up,
with the warm-up traffic. The store is deleted when the run ends, on
failure too.

A program whose server cannot warm a tile cache (no
``QueryServer.warm_tiles``; that name is part of this yardstick) has no
row-gather route for paged batches either: it restages every tile it
lacks for every batch (the whole store, tens of GB, a chunk of 32 reads),
cannot serve this deployment, and the entry stops at once, before any
set-up, with exit code 3.

End-to-end metric: ``queries_per_s``, as in ``inproc_closed``. Counters
for the readers (window only): ``tile_raw_bytes_staged`` (the tile
cache's staged bytes), ``tile_evictions``, ``tile_rows_gathered``,
``tile_gathered_bytes``, ``tile_gather_s`` (``serve_tile_*``) and
``shard_visits`` by route (``serve_shard_visits_total``).
"""
from __future__ import annotations

import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cobsbench.entries import inproc_closed
from cobsbench.harness import build, session, traffic

WRITERS = 4        # threads writing shards while the card builds the next


def _supported() -> bool:
    from repro_torch.serve import QueryServer
    return hasattr(QueryServer, "warm_tiles")


def serve(ctx: session.Context, index):
    """``index``'s server with the configuration's ``server`` settings, its
    tile budget ``tile_cache_share`` of the store's bytes."""
    from repro_torch.serve import QueryServer, ServerConfig
    opts = dict(ctx.cfg.get("server", {}))
    share = float(opts.pop("tile_cache_share"))
    budget = int(share * index.storage.nbytes())
    return QueryServer(index, ServerConfig(**opts, tile_cache_bytes=budget),
                       device=ctx.device)


def build_store(ctx: session.Context, path: Path) -> None:
    """The cell's index as a store of one block a shard at ``path``."""
    from repro_torch.core.store import ShardStoreWriter
    cfg, corp = ctx.cfg, ctx.corpus()
    params = build.index_params(cfg)
    layout, order = build.plan(cfg, corp)
    writer = ShardStoreWriter(path, layout, params, blocks_per_shard=1)
    bd = layout.block_docs
    buf = torch.empty((int(layout.block_width.max()), layout.doc_words),
                      dtype=torch.int32, device=ctx.device)
    pending = []
    with ThreadPoolExecutor(WRITERS) as pool:
        for b in range(layout.n_blocks):
            blk = buf[:int(layout.block_width[b])]
            blk.zero_()
            build._fill_block(blk, corp, order[b * bd:(b + 1) * bd],
                              params.n_hashes, build.PIECE_TERMS)
            # a copy of its own: the buffer takes the next block
            host = blk.to("cpu", copy=True).numpy().view(np.uint32)
            pending.append(pool.submit(writer.write_shard, b, host))
            while len(pending) > WRITERS:
                pending.pop(0).result()
        for f in pending:
            f.result()
    writer.finalize()


def _registry_value(server, name: str) -> float | None:
    m = server.metrics.registry.get(name)
    if m is None:
        return None
    return m.sum if hasattr(m, "sum") else m.value


def route_counters(server, tiles0: dict) -> dict:
    """The tile cache's and the row-gather route's counters over the
    window (the server's metrics were reset when it opened; ``tiles0``
    holds the cache's own counters then)."""
    t = server.tiles
    visits = server.metrics.registry.get("serve_shard_visits_total")
    return {
        "tile_raw_bytes_staged": t.raw_bytes_staged - tiles0["raw"],
        "tile_faults": t.faults - tiles0["faults"],
        "tile_evictions": t.evictions - tiles0["evictions"],
        "tiles_resident": len(t),
        "tile_rows_gathered": _registry_value(
            server, "serve_tile_rows_gathered_total"),
        "tile_gathered_bytes": _registry_value(
            server, "serve_tile_gathered_bytes_total"),
        "tile_gather_s": _registry_value(server, "serve_tile_gather_seconds"),
        "shard_visits": ({labels[0]: c.value
                          for labels, c in visits.children()}
                         if visits is not None else None),
    }


def run(ctx: session.Context) -> session.Run:
    if not _supported():
        ctx.log("this program's server cannot warm a tile cache "
                "(QueryServer.warm_tiles), so it has no row-gather route for "
                "paged batches: every batch would restage the store; the "
                "deployment cannot be served")
        raise SystemExit(3)
    from repro_torch.core.index import BitSlicedIndex
    from repro_torch.core.store import open_store
    from repro_torch.serve import ServingLoop
    from repro_torch.serve.request import Status
    corp = ctx.corpus()
    store = Path(tempfile.mkdtemp(prefix="cobsbench-store-"))
    loop = None
    try:
        t = time.monotonic()
        build_store(ctx, store)
        if ctx.on_card:
            torch.cuda.synchronize()
        layout, storage, params = open_store(store, device=ctx.device)
        index = BitSlicedIndex(layout, storage, params)
        ctx.log(f"store: {index.n_docs} documents, {storage.n_shards} "
                f"shards, {storage.nbytes()} bytes, written and opened in "
                f"{time.monotonic() - t:.1f} s")
        t = time.monotonic()
        server = serve(ctx, index)
        warm = server.warm_tiles()
        if ctx.on_card:
            torch.cuda.synchronize()
        ctx.log(f"tile cache: {len(warm)} of {storage.n_shards} tiles, "
                f"{server.tiles.resident_bytes} of "
                f"{server.tiles.capacity_bytes} bytes, staged in "
                f"{time.monotonic() - t:.1f} s")
        rec = session.Recorder(server, ctx.trace)
        loop = ServingLoop(server).start()
        chunk = int(ctx.mix["chunk"])
        warm_q = traffic.make_queries(ctx.mix, corp, ctx.seed,
                                      traffic.WARMUP,
                                      traffic.pool(ctx.mix, traffic.WARMUP))
        inproc_closed._chunks(loop, warm_q, ctx.threshold, chunk,
                              float(ctx.mix["warmup_s"]), index.params)
        q = traffic.make_queries(ctx.mix, corp, ctx.seed, traffic.WINDOW,
                                 traffic.pool(ctx.mix, traffic.WINDOW))
        server.reset_metrics(clear_caches=True)
        tiles0 = {"raw": server.tiles.raw_bytes_staged,
                  "faults": server.tiles.faults,
                  "evictions": server.tiles.evictions}
        win = session.Window(ctx, rec)
        ctx.setup_done()
        with win.open():
            got, t0, sent = inproc_closed._chunks(
                loop, q, ctx.threshold, chunk, ctx.seconds, index.params)
        counters = session.program_counters(server)
        counters.update(route_counters(server, tiles0))
        answers = {i: session.answer_of(r.result) for i, _, r in got
                   if r.status == Status.OK}
        window_s = max((t for _, t, _ in got), default=t0) - t0
        run = session.Run(
            window_s=window_s, queries=q, n_requests=sent, answers=answers,
            e2e={"queries_per_s": len(answers) / window_s},
            counters=counters, on_card=ctx.on_card,
            device_name=session.device_name(ctx.device),
            trace=win.trace,
            info={"window_s": window_s, "tiles_warmed": len(warm),
                  "store_bytes": storage.nbytes(),
                  # answers in each second of the window, and the worker's
                  # mean batch time: where a slow run lost its time
                  "answers_per_s": np.bincount(
                      [int(t - t0) for _, t, _ in got]).tolist(),
                  "service_ms_mean": 1e3 * server.metrics.registry.get(
                      "serve_service_seconds").mean(),
                  **{k: counters[k] for k in (
                      "batches", "shard_visits", "tile_evictions",
                      "tile_faults", "tile_rows_gathered", "tile_gather_s")}})
        if ctx.trace and ctx.on_card:
            run.roofline = session.roofline_of(rec.batches, index,
                                               ctx.device, run.device_name)
        return run
    finally:
        if loop is not None:
            loop.stop()
        shutil.rmtree(store, ignore_errors=True)
