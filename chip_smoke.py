#!/usr/bin/env python3
"""Drive the PyTorch port of COBS (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card. It

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and checks
   a small build and small searches on the card against the CPU;
2. builds a compact COBS index on the card: 2048 synthetic documents with
   log-normal sizes (sigma 1.0, mean 100 kb, seed 0), k = 31, one hash
   function, FPR 0.3, blocks of 1024 documents;
3. holds every kernel against its plain PyTorch version on the card, on
   rows and indices drawn from that index and on the shapes of
   ``tests/test_kernels.py``;
4. runs the main path with every launch counter at 0: 128 queries of the
   serving traffic mix (40/80/160/320 bp, half true positives, half
   verified negatives) through ``search``, ``search_batch`` (batches of 32)
   and ``top_k`` for each method, then a classic index and a two-hash
   compact index. All methods must agree, no positive query may miss its
   origin document, and each kernel must have been launched;
5. drives the out-of-core path ("[store]"), its launch counters from 0:
   the corpus streamed into a raw cobs-jax-v2 store of 8 shards (blocks of
   256 documents), opened with its hashes verified and searched through a
   DeviceTileCache bounded at half the store's bytes and an unbounded one,
   against the dense index; then a replicated collection (the first 256
   documents, 8 copies each, blocks of 128) built rowdict-coded and raw,
   searched with ``compressed=True`` through the fused-decode kernels
   against the raw store;
6. drives the pruned executor ("[prune]"), its launch counters from 0:
   ``search_pruned``, ``search_batch_pruned`` (batches of 32) and
   ``top_k_pruned`` on the raw store and (``compressed=True``) the rowdict
   store, ``run_paged_pruned`` with every shard promoted on its first
   visit, and the two-hash index; every result must equal the exhaustive
   engine's;
7. drives the shard-major bulk executor ("[bulk]"), its counters from 0:
   ``run_shard_major`` over all 128 queries at threshold 0.8 and top 10 on
   the dense index, the raw store through a cache bounded at its tallest
   shard (each shard staged once) and the rowdict store, plus one sweep
   suspended after every shard and resumed;
8. drives the single-host QueryServer ("[serve]"), its counters from 0,
   with default settings: the dense index under the serving mix (plus 8
   top_k requests) and under overlapping reads (8 windows of 1,000 bases,
   32 reads of 150 bases each at uniform starts, about 4.8x coverage, sent
   window by window), the raw store through a tile cache of half its bytes
   and the rowdict store with ``compressed=True`` under overlapping reads.
   Every response must equal the QueryEngine's, every read find its
   source, the reads dispatch the row-dedup pair (``dedup``, ``dedup_c``)
   and the mix the fused lookup; each dedup-path kernel call equals its
   plain version. The store directories are deleted after this phase;
9. traces 32 lookup searches, 32 pruned searches and one bulk sweep with
   torch.profiler (device time, the top device and host operations; the
   chunked executors under cProfile too), and times each kernel at the
   main path's shapes beside its bound, its plain version and, for the
   gathers, ``torch.index_select``.

It prints the card's name and power limit and a ``{"kernels": ...}`` line,
writes its measurements to ``chiprun_out/chip_smoke.json``, and ends with
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Without CUDA, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEV = "cuda"

N_DOCS, KMER, MEAN_LEN, SIGMA, SEED = 2048, 31, 100_000, 1.0, 0
BLOCK_DOCS = 1024
N_QUERIES, BATCH, THRESHOLD, TOP = 128, 32, 0.8, 10
METHODS = ("lookup", "vertical", "unpack", "ref")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12       # the data sheet's 32-bit rate outside tensor cores
SOURCE = "src/repro_torch/kernels/csrc/bitslice_score.cu"
PALLAS = "src/repro/kernels/bitslice_score.py"
# wrapper -> (its line in PALLAS, the Pallas kernel body, the CUDA kernel)
KERNELS = {
    "unpack_score": (65, "_unpack_kernel", "unpack_kernel"),
    "vertical_score": (126, "_vertical_kernel", "vertical_kernel"),
    "lookup_score_blocks": (208, "_lookup_blocks_kernel", "lookup_kernel"),
    "lookup_score_multi": (278, "_lookup_multi_kernel", "lookup_kernel"),
    "lookup_score": (836, "_lookup_kernel", "lookup_kernel"),
    "lookup_score_multi_compressed": (537, "_lookup_multi_comp_kernel",
                                      "lookup_comp_kernel"),
    "lookup_score_blocks_compressed": (595, "_lookup_blocks_comp_kernel",
                                       "lookup_comp_kernel"),
    "chunk_dedup_score": (678, "_chunk_dedup_kernel", "chunk_dedup_kernel"),
    "chunk_lookup_score_multi": (746, "_chunk_multi_kernel",
                                 "chunk_lookup_kernel"),
    "chunk_lookup_score_multi_compressed": (795, "_chunk_multi_comp_kernel",
                                            "chunk_lookup_comp_kernel"),
    "gather_rows": (368, "_gather_kernel", "gather_kernel"),
    "dedup_score": (426, "_dedup_score_kernel", "dedup_kernel"),
    "gather_rows_compressed": (486, "kernel (inside gather_rows_compressed)",
                               "gather_comp_kernel"),
}
CHUNK_KERNELS = ("chunk_dedup_score", "chunk_lookup_score_multi",
                 "chunk_lookup_score_multi_compressed")
MAIN_KERNELS = ("unpack_score", "vertical_score", "lookup_score_blocks",
                "lookup_score_multi", "lookup_score")
DEDUP_KERNELS = ("gather_rows", "gather_rows_compressed", "dedup_score")
# the [serve] phase's overlapping reads: 8 windows of 1,000 bases, 32 reads
# of 150 bases a window at uniform starts (about 4.8x coverage)
READ_WINDOWS, WINDOW_LEN, READS_PER_WINDOW, READ_LEN = 8, 1000, 32, 150
OUT_DIR = ROOT / "chiprun_out"       # measurements; listed in .gitignore
# the out-of-core path: stores under OUT_DIR, deleted at the end
STORE_DIR = OUT_DIR / "smoke_stores"
STORE_BLOCK_DOCS = 256          # 2048 documents -> 8 shards
COMP_BASE, COMP_COPIES, COMP_BLOCK_DOCS = 256, 8, 128


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def make_workload(make_queries, corpus, n_queries: int, seed: int = 100):
    """The serving traffic mix of ``repro.launch.serve.make_workload``:
    exactly n_queries of lengths 40/80/160/320 bp, half true positives and
    half verified negatives, shuffled."""
    queries, origin = [], []
    lengths = (40, 80, 160, 320)
    for i, length in enumerate(lengths):
        count = n_queries // len(lengths) + (i < n_queries % len(lengths))
        if count == 0:
            continue
        q, o = make_queries(corpus, n_pos=count - count // 2,
                            n_neg=count // 2, length=length, seed=seed + i)
        queries.extend(q)
        origin.extend(o)
    perm = np.random.default_rng(seed).permutation(len(queries))
    return [queries[i] for i in perm], [int(origin[i]) for i in perm]


def same_result(a, b) -> bool:
    return (np.array_equal(a.doc_ids, b.doc_ids)
            and np.array_equal(a.scores, b.scores)
            and a.n_terms == b.n_terms and a.threshold == b.threshold)


def same_results(xs, ys) -> bool:
    return len(xs) == len(ys) and all(map(same_result, xs, ys))


class KernelCheck:
    """Holds kernels against their plain versions on the card; ``err``
    keeps the largest absolute difference seen per wrapper."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {name: 0 for name in KERNELS}

    def compare(self, name, got, want, what):
        self.torch.cuda.synchronize()
        diff = (int((got.long() - want.long()).abs().max())
                if got.shape == want.shape and got.numel() else 0)
        self.err[name] = max(self.err[name], diff)
        check(got.shape == want.shape and self.torch.equal(got, want),
              f"{name} != its plain version on {what}")


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_build_kernels(rt) -> dict:
    t0 = time.perf_counter()
    path, report = rt.build.build()
    rt.build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {path.name} in {secs:.2f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return {"seconds": secs, "library": path.name}


def phase_small_reference(rt, torch) -> None:
    """A small build and search on the card equal the CPU's, word for word
    and result for result; the hash equals its numpy mirror."""
    corpus = rt.make_corpus(64, k=15, mean_length=400, sigma=1.0, seed=7)
    rng = np.random.default_rng(3)
    terms = rng.integers(0, 2 ** 32, size=(4096, 2), dtype=np.uint32)
    terms[:4] = 0xFFFFFFFF
    for n in (1, 2, 3):
        got = rt.hashing.hash_terms(
            torch.from_numpy(terms.view(np.int32)).to(DEV), n)
        check(np.array_equal(got.cpu().numpy().view(np.uint32),
                             rt.hashing.hash_terms_np(terms, n)),
              f"hash_terms({n}) on the card differs from its numpy mirror")
    queries, _ = rt.make_queries(corpus, n_pos=4, n_neg=4, length=80,
                                 seed=11)
    for n_hashes in (1, 2):
        params = rt.IndexParams(n_hashes, 0.3, 15)
        for kind, build in (
                ("compact", lambda d: rt.build_compact(
                    corpus.doc_terms, params, block_docs=32, row_align=64,
                    device=d)),
                ("classic", lambda d: rt.build_classic(
                    corpus.doc_terms, params, device=d))):
            gpu, cpu = build(DEV), build("cpu")
            check(np.array_equal(gpu.storage.full_host(),
                                 cpu.storage.full_host()),
                  f"{kind} k={n_hashes}: card arena != CPU arena")
            for method in METHODS:
                eg = rt.QueryEngine(gpu, method=method)
                ec = rt.QueryEngine(cpu, method=method, device="cpu")
                check(same_results(
                    [eg.search(q, 0.5) for q in queries]
                    + eg.search_batch(queries, 0.5)
                    + [eg.top_k(q, 5) for q in queries],
                    [ec.search(q, 0.5) for q in queries]
                    + ec.search_batch(queries, 0.5)
                    + [ec.top_k(q, 5) for q in queries]),
                    f"{kind} k={n_hashes} {method}: card != CPU")
    torch.cuda.synchronize()
    log("[reference] small build and searches on the card equal the CPU's")


def phase_build_index(rt, torch):
    t0 = time.perf_counter()
    corpus = rt.make_corpus(N_DOCS, k=KMER, mean_length=MEAN_LEN,
                            sigma=SIGMA, seed=SEED)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = rt.build_compact(corpus.doc_terms, rt.IndexParams(1, 0.3, KMER),
                             block_docs=BLOCK_DOCS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bases = int(sum(len(d) for d in corpus.documents))
    info = {
        "docs": index.n_docs, "bases": bases,
        "terms": int(corpus.term_counts().sum()),
        "blocks": index.n_blocks,
        "block_widths": [int(w) for w in index.layout.block_width],
        "rows": index.total_rows, "arena_bytes": index.size_bytes(),
        "host_corpus_s": host_s, "device_build_s": build_s,
        "build_peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    check(index.device.type == torch.device(DEV).type,
          "the arena is not on the card")
    log(f"[index] {info['docs']} docs, {bases} bases, {info['terms']} terms; "
        f"{info['blocks']} blocks of widths {info['block_widths']}; "
        f"{info['rows']} rows x {index.doc_words} words = "
        f"{info['arena_bytes']} bytes on the card")
    log(f"[index] host corpus {host_s:.2f} s, device build {build_s:.2f} s, "
        f"build peak device memory {info['build_peak_device_bytes']} bytes")
    return corpus, index, info


def phase_kernels_vs_plain(rt, torch, index, chk: KernelCheck) -> None:
    """Each kernel equals its plain version on the card, on rows drawn from
    the compact index and on the shapes of the kernel tests (the
    fused-decode kernels at their main path's shapes: ``phase_store``)."""
    k = rt.kernels
    g = torch.Generator().manual_seed(5)
    compare = chk.compare

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(DEV)

    arena = index.storage.full_device()
    R, W = arena.shape
    # rows and indices drawn from the built arena, at the main path's shapes
    for L in (64, 192, 320):
        idx = torch.randint(0, R, (BATCH, index.n_blocks, L), generator=g,
                            dtype=torch.int32).to(DEV)
        mask = (torch.rand((BATCH, index.n_blocks, L), generator=g) < 0.9
                ).to(torch.int32).to(DEV)
        rows = arena[idx.long()].permute(0, 2, 1, 3).reshape(
            BATCH, L, index.n_blocks * W).contiguous()
        for name, fn, plain in (
                ("unpack_score", k.unpack_score, k.unpack_score_plain),
                ("vertical_score", k.vertical_score, k.vertical_score_plain)):
            compare(name, fn(rows[0]), plain(rows[0]), f"arena rows L={L}")
            compare(name, fn(rows), plain(rows), f"arena batch L={L}")
        compare("lookup_score", k.lookup_score(arena, idx[0, 0], mask[0, 0]),
                k.lookup_plain(arena, idx[0, 0], mask[0, 0]), f"L={L}")
        compare("lookup_score_blocks",
                k.lookup_score_blocks(arena, idx[0], mask[0]),
                k.lookup_plain(arena, idx[0], mask[0]), f"L={L}")
        compare("lookup_score_multi",
                k.lookup_score_multi(arena, idx, mask),
                k.lookup_plain(arena, idx, mask), f"L={L}")
    # the shapes of tests/test_kernels.py
    for W_ in (8, 96, 128, 130, 384):
        for L in (1, 7, 200, 1000):
            rows = words(L, W_)
            for name, fn, plain in (
                    ("unpack_score", k.unpack_score, k.unpack_score_plain),
                    ("vertical_score", k.vertical_score,
                     k.vertical_score_plain)):
                compare(name, fn(rows), plain(rows), f"[{L}, {W_}]")
        for (Q, nb, L) in ((1, 1, 8), (3, 2, 17), (4, 1, 33), (2, 3, 64)):
            small = words(4 * L, W_)
            idx = torch.randint(0, 4 * L, (Q, nb, L), generator=g,
                                dtype=torch.int32).to(DEV)
            mask = torch.randint(0, 2, (Q, nb, L), generator=g,
                                 dtype=torch.int32).to(DEV)
            compare("lookup_score", k.lookup_score(small, idx[0, 0],
                                                   mask[0, 0]),
                    k.lookup_plain(small, idx[0, 0], mask[0, 0]),
                    f"W={W_} L={L}")
            compare("lookup_score_blocks",
                    k.lookup_score_blocks(small, idx[0], mask[0]),
                    k.lookup_plain(small, idx[0], mask[0]), f"W={W_} L={L}")
            compare("lookup_score_multi",
                    k.lookup_score_multi(small, idx, mask, grid_order="qw"),
                    k.lookup_plain(small, idx, mask), f"W={W_} Q={Q}")
    # the fused-decode kernels at the shapes of tests/test_compression.py:
    # blocks of 128 documents (4 words), dictionaries of 31 and 155 rows
    # over 88,064- and 3,584-row shards, 64-term buckets, batches of 6
    for D, R in ((155, 3584), (31, 88064)):
        dict_rows, refs = words(D, 4), torch.randint(
            0, D, (R,), generator=g, dtype=torch.int32).to(DEV)
        for (Q, nb, L) in ((1, 1, 64), (6, 1, 64), (5, 2, 64)):
            idx = torch.randint(0, R, (Q, nb, L), generator=g,
                                dtype=torch.int32).to(DEV)
            mask = torch.randint(0, 2, (Q, nb, L), generator=g,
                                 dtype=torch.int32).to(DEV)
            compare("lookup_score_blocks_compressed",
                    k.lookup_score_blocks_compressed(dict_rows, refs, idx[0],
                                                     mask[0]),
                    k.lookup_comp_plain(dict_rows, refs, idx[0], mask[0]),
                    f"D={D} R={R} L={L}")
            compare("lookup_score_multi_compressed",
                    k.lookup_score_multi_compressed(dict_rows, refs, idx,
                                                    mask),
                    k.lookup_comp_plain(dict_rows, refs, idx, mask),
                    f"D={D} R={R} Q={Q} nb={nb}")
    log(f"[kernels] every kernel equals its plain version: max_abs_err "
        f"{chk.err}")


def run_method(rt, index, method, queries, **engine_kw):
    """search, search_batch and top_k over the queries; returns results,
    single-search latencies (s) and batch seconds."""
    engine = rt.QueryEngine(index, method=method, **engine_kw)
    engine.search(queries[0], THRESHOLD)             # first-use costs
    engine.search_batch(queries[:BATCH], THRESHOLD)
    lat, singles = [], []
    for q in queries:
        t0 = time.perf_counter()
        singles.append(engine.search(q, THRESHOLD))
        lat.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    batched = []
    for i in range(0, len(queries), BATCH):
        batched += engine.search_batch(queries[i:i + BATCH], THRESHOLD)
    batch_s = time.perf_counter() - t0
    tops = [engine.top_k(q, TOP) for q in queries]
    return singles, batched, tops, lat, batch_s


def check_positives(results, origin, what: str, limit: int | None = None):
    n = 0
    for r, o in zip(results, origin):
        if o < 0 or (limit is not None and o >= limit):
            continue
        n += 1
        check(o in set(r.doc_ids.tolist()),
              f"{what}: positive query missed its origin document {o}")
    return n


def phase_main_path(rt, torch, corpus, index):
    """The main path, launch counters from 0: every method on the compact
    index, then the classic and two-hash indexes. Returns the record, the
    queries, their origin documents and the classic index."""
    k = rt.kernels
    t0 = time.perf_counter()
    queries, origin = make_workload(rt.make_queries, corpus, N_QUERIES)
    log(f"[workload] {len(queries)} queries "
        f"({sum(o >= 0 for o in origin)} positive) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"methods": {}}
    k.reset_launches()
    base = None
    for method in METHODS:
        before = dict(k.launches)
        singles, batched, tops, lat, batch_s = run_method(
            rt, index, method, queries)
        delta = {n: k.launches[n] - before[n] for n in k.launches}
        check(same_results(singles, batched),
              f"{method}: search and search_batch differ")
        if base is None:
            base = (singles, tops)
        check(same_results(singles, base[0]),
              f"{method}: search differs from {METHODS[0]}")
        check(same_results(tops, base[1]),
              f"{method}: top_k differs from {METHODS[0]}")
        n_pos = check_positives(singles, origin, method)
        p50 = statistics.median(lat)
        m = {"p50_search_ms": p50 * 1e3,
             "p99_search_ms": float(np.percentile(lat, 99)) * 1e3,
             "batch_queries_per_s": len(queries) / batch_s,
             "launches": delta,
             "hits": int(sum(len(r.doc_ids) for r in singles))}
        out["methods"][method] = m
        log(f"[search:{method}] p50 {m['p50_search_ms']:.3f} ms, p99 "
            f"{m['p99_search_ms']:.3f} ms per search; batch "
            f"{m['batch_queries_per_s']:.1f} queries/s; {m['hits']} hits; "
            f"{n_pos} positives all found; launches {delta}")
    want = {"lookup": ("lookup_score_blocks", "lookup_score_multi"),
            "vertical": ("vertical_score",), "unpack": ("unpack_score",)}
    for method, names in want.items():
        for name in names:
            check(out["methods"][method]["launches"][name] > 0,
                  f"{method} phase launched no {name}")

    # a classic index (one block: lookup_score) and a two-hash compact
    # index (the AND path through vertical and unpack)
    sub = corpus.doc_terms[:256]
    extra = {
        "classic k=1": rt.build_classic(sub, rt.IndexParams(1, 0.3, KMER)),
        "compact k=2": rt.build_compact(sub, rt.IndexParams(2, 0.3, KMER),
                                        block_docs=128),
    }
    for what, idx in extra.items():
        before = dict(k.launches)
        results = {}
        for method in METHODS:
            singles, batched, tops, _, _ = run_method(rt, idx, method,
                                                      queries)
            check(same_results(singles, batched),
                  f"{what} {method}: search and search_batch differ")
            results[method] = (singles, tops)
            check_positives(singles, origin, f"{what} {method}", limit=256)
        for method in METHODS[1:]:
            check(same_results(results[method][0], results[METHODS[0]][0])
                  and same_results(results[method][1],
                                   results[METHODS[0]][1]),
                  f"{what}: {method} differs from {METHODS[0]}")
        delta = {n: k.launches[n] - before[n] for n in k.launches}
        out[what] = {"blocks": idx.n_blocks, "rows": idx.total_rows,
                     "launches": delta}
        log(f"[{what}] {idx.n_blocks} block(s), {idx.total_rows} rows: all "
            f"methods agree, no positive missed; launches {delta}")
    check(out["classic k=1"]["launches"]["lookup_score"] > 0,
          "the classic index launched no lookup_score")
    out["launches"] = dict(k.launches)
    for name in MAIN_KERNELS:
        check(out["launches"][name] > 0,
              f"the main path never launched {name}")
    log(f"[main path] launches {out['launches']}")
    return out, queries, origin, extra, base


# --------------------------------------------------------------------------
# The out-of-core path: paged raw store, then the compressed arena
# --------------------------------------------------------------------------

def plan_lookup(rt, torch, term_sets, row_offset, block_width, n_hashes=1):
    """Fused-lookup inputs of a batch of term sets against blocks
    (row_offset, block_width), as the engine plans them: row indices
    [Q, nb, L] and term masks [Q, nb, L], plus the rows [Q, L, k, nb]."""
    buf, ells = rt.query.pad_term_batch(term_sets, 64)
    terms = torch.from_numpy(buf.view(np.int32)).to(DEV)
    h = rt.hashing.hash_terms(terms, n_hashes)
    rows = rt.query.plan_rows(h, row_offset, block_width)
    L = terms.shape[1]
    valid = (torch.arange(L, device=DEV)[None, :]
             < torch.from_numpy(ells).to(DEV)[:, None])
    ridx = rows[:, :, 0, :].transpose(1, 2).contiguous()        # [Q, nb, L]
    mask = valid.to(torch.int32)[:, None, :].expand(ridx.shape)
    return ridx, mask.contiguous(), rows, valid


def pct_ms(lat, p) -> float:
    return float(np.percentile(lat, p)) * 1e3


def phase_store(rt, torch, corpus, queries, origin, chk: KernelCheck):
    """The out-of-core path with the launch counters from 0. Returns the
    record, the launches of this path, and the fused-decode kernels'
    timing inputs."""
    k = rt.kernels
    params = rt.IndexParams(1, 0.3, KMER)
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    out = {}
    # -- the raw paged store and its dense twin -----------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = rt.build_compact_streaming(
        corpus.doc_terms, STORE_DIR / "raw", params,
        block_docs=STORE_BLOCK_DOCS, blocks_per_shard=1, codec="raw")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = rt.load_index_v2(STORE_DIR / "raw", verify=True)
    verify_s = time.perf_counter() - t0
    st = index.storage
    check(st.n_shards == 8, f"the raw store has {st.n_shards} shards, not 8")
    check(stats.peak_block_bytes <= stats.max_shard_bytes,
          f"streaming build held {stats.peak_block_bytes} bytes at once, "
          f"more than one shard's {stats.max_shard_bytes}")
    dense = rt.build_compact(corpus.doc_terms, params,
                             block_docs=STORE_BLOCK_DOCS)
    check(np.array_equal(st.full_host(), dense.storage.full_host()),
          "the streamed store's arena != the dense build's")
    shard_bytes = [st.shard_nbytes(s) for s in range(st.n_shards)]
    out["raw_store"] = {
        "shards": st.n_shards, "shard_bytes": shard_bytes,
        "store_bytes": st.nbytes(), "build_s": build_s,
        "open_verify_s": verify_s, "stats": vars(stats)}
    log(f"[store:raw] {st.n_shards} shards of {shard_bytes} bytes "
        f"({st.nbytes()} in all); streamed build {build_s:.2f} s (peak "
        f"{stats.peak_block_bytes} block bytes), open + verify "
        f"{verify_s:.2f} s; arena equals the dense build")
    # the dense engine's answers, before the counters start
    want = {}
    for method in METHODS:
        n = N_QUERIES if method in ("lookup", "vertical") else BATCH
        singles, batched, tops, _, _ = run_method(rt, dense, method,
                                                  queries[:n])
        want[method] = (singles, batched, tops)

    k.reset_launches()                      # the store path starts here
    cap = st.nbytes() // 2
    out["paged"] = {"capacity_bytes": cap}
    for label, make_cache in (
            ("bounded", lambda: rt.DeviceTileCache(st, capacity_bytes=cap)),
            ("unbounded", lambda: rt.DeviceTileCache(st))):
        for method in METHODS:
            if label == "unbounded" and method not in ("lookup", "vertical"):
                continue
            n = len(want[method][0])
            tiles = make_cache()
            staged = []
            tiles.observer = (lambda s, e, secs: staged.append(secs)
                              if e in ("fault", "prefetch") else None)
            singles, batched, tops, lat, _ = run_method(
                rt, index, method, queries[:n], tile_cache=tiles)
            check(same_results(singles, want[method][0])
                  and same_results(batched, want[method][1])
                  and same_results(tops, want[method][2]),
                  f"paged {label} {method} != the dense engine")
            check_positives(singles, origin[:n], f"paged {method}")
            m = {"queries": n, "p50_search_ms": pct_ms(lat, 50),
                 "p99_search_ms": pct_ms(lat, 99), "faults": tiles.faults,
                 "hits": tiles.hits, "evictions": tiles.evictions,
                 "prefetch_hits": tiles.prefetch_hits,
                 "raw_bytes_staged": tiles.raw_bytes_staged,
                 "host_staging_s": sum(staged)}
            if label == "bounded":
                check(tiles.faults > st.n_shards and tiles.evictions > 0
                      and tiles.prefetch_hits > 0,
                      f"bounded cache {method}: faults {tiles.faults}, "
                      f"evictions {tiles.evictions}, prefetch hits "
                      f"{tiles.prefetch_hits}")
            out["paged"][f"{label} {method}"] = m
            log(f"[store:{label}] {method}: {n} queries equal the dense "
                f"engine; p50 {m['p50_search_ms']:.3f} ms, p99 "
                f"{m['p99_search_ms']:.3f} ms a search; {tiles.faults} "
                f"faults, {tiles.evictions} evictions, "
                f"{tiles.prefetch_hits} prefetch hits, "
                f"{tiles.raw_bytes_staged} bytes staged in "
                f"{m['host_staging_s']:.3f} s of host staging")
    b = out["paged"]["bounded lookup"]
    # -- the compressed arena: a replicated collection ----------------------
    rep_terms = [corpus.doc_terms[i % COMP_BASE]
                 for i in range(COMP_BASE * COMP_COPIES)]
    t0 = time.perf_counter()
    comp, cstats = rt.build_compact_streaming(
        rep_terms, STORE_DIR / "rowdict", params,
        block_docs=COMP_BLOCK_DOCS, codec="rowdict")
    comp_build_s = time.perf_counter() - t0
    raw, _ = rt.build_compact_streaming(
        rep_terms, STORE_DIR / "rep-raw", params,
        block_docs=COMP_BLOCK_DOCS, codec="raw")
    cst = comp.storage
    codecs = [cst.shard_codec(s) for s in range(cst.n_shards)]
    dict_shards = [s for s, c in enumerate(codecs)
                   if c in rt.codec.DICT_CODECS]
    check(len(dict_shards) >= 1,
          f"no rowdict shard at {COMP_COPIES} copies: {codecs}")
    check(np.array_equal(cst.full_host(), raw.storage.full_host()),
          "the rowdict store decodes to another arena than the raw store")
    out["comp_store"] = {
        "shards": cst.n_shards, "codecs": codecs,
        "dict_ratio": cst.dict_ratio(), "comp_summary": cst.comp_summary(),
        "build_s": comp_build_s, "stats": vars(cstats)}
    log(f"[store:comp] {COMP_BASE} documents x {COMP_COPIES} copies, "
        f"{cst.n_shards} shards: {len(dict_shards)} rowdict, "
        f"{cst.n_shards - len(dict_shards)} raw; device-form ratio "
        f"{cst.dict_ratio():.3f}; rowdict build {comp_build_s:.2f} s")
    for method in ("lookup", "vertical"):
        singles, batched, tops, lat, _ = run_method(
            rt, comp, method, queries, compressed=True)
        r_singles, r_batched, r_tops, r_lat, _ = run_method(
            rt, raw, method, queries)
        check(same_results(singles, r_singles)
              and same_results(batched, r_batched)
              and same_results(tops, r_tops),
              f"compressed {method} != the raw store")
        n_pos = check_positives(singles, origin, f"compressed {method}",
                                limit=COMP_BASE)
        if method == "lookup":
            comp_want = (r_singles, r_batched, r_tops)
        engine = rt.QueryEngine(comp, method=method, compressed=True)
        check(engine.compressed, "compressed=True left the flag off")
        for q in queries[:8]:
            sc = engine.score_terms(rt.query.compile_pattern(q, params))
            copies = sc.reshape(COMP_COPIES, COMP_BASE)
            check(bool((copies == copies[0]).all()),
                  "copies of a document got different scores")
        tiles = engine.tiles
        raw_want = sum(cst.shard_nbytes(s) for s in range(cst.n_shards)
                       if s not in dict_shards)
        check(tiles.comp_bytes_staged > 0, "no compressed bytes staged")
        check(tiles.raw_bytes_staged == raw_want,
              f"raw bytes staged {tiles.raw_bytes_staged} != the raw "
              f"shards' {raw_want}: a dict-coded shard was staged raw")
        raw_tiles = rt.QueryEngine(raw, method=method)
        raw_tiles.search_batch(queries[:BATCH], THRESHOLD)
        m = {"p50_search_ms": pct_ms(lat, 50),
             "p99_search_ms": pct_ms(lat, 99),
             "raw_store_p50_search_ms": pct_ms(r_lat, 50),
             "comp_bytes_staged": tiles.comp_bytes_staged,
             "raw_bytes_staged": tiles.raw_bytes_staged,
             "raw_store_raw_bytes_staged": raw_tiles.tiles.raw_bytes_staged}
        out["comp_store"][method] = m
        log(f"[store:comp] {method}: {len(queries)} queries equal the raw "
            f"store, {n_pos} positives all found; copies score alike; p50 "
            f"{m['p50_search_ms']:.3f} ms (raw store "
            f"{m['raw_store_p50_search_ms']:.3f} ms); staged "
            f"{m['comp_bytes_staged']} compressed + {m['raw_bytes_staged']}"
            f" raw bytes against the raw store's "
            f"{m['raw_store_raw_bytes_staged']}")
    launches = dict(k.launches)             # the store path ends here
    out["launches"] = launches
    for name in ("lookup_score", "lookup_score_multi", "vertical_score",
                 "unpack_score", "lookup_score_blocks_compressed",
                 "lookup_score_multi_compressed"):
        check(launches[name] > 0, f"the store path never launched {name}")
    log(f"[store] launches {launches}")

    # -- host-to-device per fault, each shard cold and synchronised ---------
    fault = []
    for s in range(st.n_shards):
        tiles = rt.DeviceTileCache(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiles.get(s)
        torch.cuda.synchronize()
        fault.append((shard_bytes[s], time.perf_counter() - t0))
    out["h2d_per_fault"] = {
        "bytes": [f[0] for f in fault], "seconds": [f[1] for f in fault],
        "bytes_per_s": sum(f[0] for f in fault) / sum(f[1] for f in fault),
        "bounded_lookup_bytes_per_fault": b["raw_bytes_staged"] / b["faults"],
        "bounded_lookup_host_s_per_fault":
            b["host_staging_s"] / b["faults"]}
    h2d = out["h2d_per_fault"]
    log(f"[store:h2d] a cold fault, synchronised: "
        f"{h2d['bytes_per_s'] / 1e9:.2f} GB/s over the 8 shards "
        f"({fault[-1][0]} bytes in {fault[-1][1] * 1e3:.2f} ms for the "
        f"largest); bounded lookup run: "
        f"{h2d['bounded_lookup_bytes_per_fault']:.0f} bytes and "
        f"{h2d['bounded_lookup_host_s_per_fault'] * 1e3:.3f} ms of host "
        f"staging a fault")

    # -- the fused-decode kernels against their plain versions --------------
    s_big = max(dict_shards, key=cst.shard_nbytes)
    lookup = rt.QueryEngine(comp, method="lookup", compressed=True)
    dict_rows, refs = lookup.tiles.get_compressed(s_big)
    _, offs, widths = lookup._shard_args[s_big]
    term_sets = [rt.query.compile_pattern(q, params) for q in queries]
    long_sets = [t for t in term_sets if t.shape[0] > 256][:BATCH]
    singles = [plan_lookup(rt, torch, [t], offs, widths)[:2]
               for t in long_sets]
    batch = plan_lookup(rt, torch, term_sets[:BATCH], offs, widths)[:2]
    expanded = dict_rows[refs.long()].contiguous()
    for ridx, msk in singles[:4]:
        chk.compare("lookup_score_blocks_compressed",
                    k.lookup_score_blocks_compressed(dict_rows, refs,
                                                     ridx[0], msk[0]),
                    k.lookup_comp_plain(dict_rows, refs, ridx[0], msk[0]),
                    f"shard {s_big}, L={ridx.shape[-1]}")
        chk.compare("lookup_score_blocks_compressed",
                    k.lookup_score_blocks_compressed(dict_rows, refs,
                                                     ridx[0], msk[0]),
                    k.lookup_score_blocks(expanded, ridx[0], msk[0]),
                    f"the raw kernel on shard {s_big}'s expanded tile")
    chk.compare("lookup_score_multi_compressed",
                k.lookup_score_multi_compressed(dict_rows, refs, *batch),
                k.lookup_comp_plain(dict_rows, refs, *batch),
                f"the first batch of {BATCH} on shard {s_big}")
    chk.compare("lookup_score_multi_compressed",
                k.lookup_score_multi_compressed(dict_rows, refs, *batch),
                k.lookup_score_multi(expanded, *batch),
                f"the raw kernel on shard {s_big}'s expanded tile")
    log(f"[store:kernels] the fused-decode kernels equal their plain "
        f"versions and the raw kernel on the expanded tile of shard {s_big}"
        f" (dict {list(dict_rows.shape)}, refs [{refs.shape[0]}])")
    comp_inputs = {"dict_rows": dict_rows, "refs": refs, "shard": s_big,
                   "singles": singles, "batch": batch}
    # what the pruned and bulk phases run on and hold their results to
    stores = {"raw": index, "raw_want": want["lookup"], "comp": comp,
              "comp_want": comp_want,
              "raw_unbounded_p50_ms":
                  out["paged"]["unbounded lookup"]["p50_search_ms"],
              "comp_p50_ms": out["comp_store"]["lookup"]["p50_search_ms"]}
    return out, launches, comp_inputs, stores


# --------------------------------------------------------------------------
# The chunked executors: pruned search and the shard-major bulk sweep
# --------------------------------------------------------------------------

class ChunkRecorder:
    """Inside ``with``, keeps the arguments of every call of the named
    wrappers (the chunk wrappers unless ``names`` says otherwise; the
    executors and ops look them up at call time), so that the kernels can
    be held against their plain versions and timed at the path's own
    shapes afterwards. It launches nothing itself."""

    def __init__(self, kernels, names=CHUNK_KERNELS):
        self.k = kernels
        self.names = names
        self.calls = {n: [] for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.k, n) for n in self.names}
        for n, fn in self.saved.items():
            def rec(*args, _n=n, _fn=fn, **kw):
                self.calls[_n].append(args)
                return _fn(*args, **kw)
            setattr(self.k, n, rec)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.k, n, fn)


def chunk_plain(k, name, args):
    """The plain version of chunk wrapper ``name`` on its call's args."""
    if name == "chunk_lookup_score_multi_compressed":
        d, r, idx, mask, acc = args
        return k.chunk_plain(d, idx, mask, acc, refs=r)
    rows, idx, mask, acc = args
    return k.chunk_plain(rows, idx, mask, acc)


def check_chunk_calls(k, chk, calls: dict, what: str) -> None:
    for name, recs in calls.items():
        for args in recs:
            chk.compare(name, getattr(k, name)(*args),
                        chunk_plain(k, name, args),
                        f"{what}, idx {list(args[-3].shape)}, acc "
                        f"{list(args[-1].shape)}")


def check_chunk_ragged(rt, torch, chk) -> None:
    """The chunk kernels at small ragged shapes: W not a multiple of 32,
    running-count words past W (Wp > W), masks with zeros."""
    k, ops = rt.kernels, rt.ops
    g = torch.Generator().manual_seed(11)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(DEV)

    for Q, nb, L, W, wb in ((1, 1, 8, 3, None), (3, 2, 17, 33, None),
                            (2, 3, 32, 40, 32), (2, 1, 5, 130, None)):
        R, D = 4 * L + 3, L + 1
        rows = ints(-2 ** 31, 2 ** 31, R, W)
        refs = ints(0, D, R)
        idx, mask = ints(0, R, Q, nb, L), ints(0, 2, Q, nb, L)
        acc = ops.chunk_acc_init(Q, nb, W, word_block=wb, device=DEV)
        acc += ints(0, 40, *acc.shape)
        calls = {"chunk_lookup_score_multi": [(rows, idx, mask, acc)],
                 "chunk_dedup_score": [(rows, idx, mask, acc)],
                 "chunk_lookup_score_multi_compressed":
                     [(rows[:D].contiguous(), refs, idx, mask, acc)]}
        check_chunk_calls(k, chk, calls, f"ragged W={W}, Wp={acc.shape[2]}")


def pruned_stats(st) -> dict:
    return dict(vars(st), bytes_read=st.bytes_read, prune_rate=st.prune_rate)


def stats_line(st) -> str:
    return (f"blocks {st.blocks_total} (pruned {st.prune_rate:.3f}), "
            f"visits {st.shard_visits} (+{st.shard_visits_skipped} "
            f"skipped), chunks {st.chunks}, promoted {st.tiles_promoted}, "
            f"gathered {st.bytes_gathered} B, tile-staged "
            f"{st.bytes_tile_staged} B")


def run_pruned(rt, engine, queries, rec: ChunkRecorder):
    """search_pruned singles (timed), search_batch_pruned in batches of 32
    (recorded by ``rec``) and top_k_pruned, each with its own PruneStats."""
    engine.search_pruned(queries[0], THRESHOLD)      # open maps, sidecars
    stats = {n: rt.query.PruneStats() for n in ("search", "batch", "top_k")}
    lat, singles = [], []
    for q in queries:
        t0 = time.perf_counter()
        singles.append(engine.search_pruned(q, THRESHOLD,
                                            stats=stats["search"]))
        lat.append(time.perf_counter() - t0)
    batched = []
    t0 = time.perf_counter()
    with rec:
        for i in range(0, len(queries), BATCH):
            batched += engine.search_batch_pruned(
                queries[i:i + BATCH], THRESHOLD, stats=stats["batch"])
    batch_s = time.perf_counter() - t0
    tops = [engine.top_k_pruned(q, TOP, stats=stats["top_k"])
            for q in queries]
    return singles, batched, tops, lat, batch_s, stats


def promoted_batches(rt, index, queries, n_hashes=1):
    """run_paged_pruned with promote_ratio 0 (every shard staged on its
    first visit) in batches of 32 at THRESHOLD: results and stats."""
    q_mod = rt.query
    tiles = rt.DeviceTileCache(index.storage)
    plans = q_mod.plan_shards(index.layout, index.storage.shard_row_starts)
    slot = np.asarray(index.layout.doc_slot)
    stats, results = q_mod.PruneStats(), []
    for i in range(0, len(queries), BATCH):
        term_sets = [q_mod.compile_pattern(q, index.params)
                     for q in queries[i:i + BATCH]]
        buf, ells = q_mod.pad_term_batch(term_sets, 64)
        required = np.array([q_mod.coverage_cutoff(THRESHOLD, int(e))
                             for e in ells], np.int64)
        slots = q_mod.run_paged_pruned(
            tiles, plans, buf, ells, required, np.zeros(len(ells), np.int32),
            n_hashes=n_hashes, chunk_terms=32, promote_ratio=0.0,
            stats=stats)
        results += [q_mod.select_hits(slots[j][slot], int(e), THRESHOLD)
                    for j, e in enumerate(ells)]
    return results, stats, tiles


def phase_prune(rt, torch, stores, queries, origin, k2, chk):
    """The pruned executor with the launch counters from 0. Returns the
    record, this path's launches and the dedup kernel's timing inputs."""
    k = rt.kernels
    # the two-hash index's exhaustive answers, before the counters start
    k2_engine = rt.QueryEngine(k2, method="vertical")
    k2_want = []
    for i in range(0, len(queries), BATCH):
        k2_want += k2_engine.search_batch(queries[i:i + BATCH], THRESHOLD)
    k2_tops = [k2_engine.top_k(q, TOP) for q in queries[:BATCH]]

    k.reset_launches()                      # the pruned path starts here
    out, recs = {}, {}
    for label, index, want, p50_paged, comp in (
            ("raw", stores["raw"], stores["raw_want"],
             stores["raw_unbounded_p50_ms"], False),
            ("comp", stores["comp"], stores["comp_want"],
             stores["comp_p50_ms"], True)):
        engine = rt.QueryEngine(index, method="lookup", compressed=comp,
                                prune_chunk=32)
        recs[label] = ChunkRecorder(k)
        singles, batched, tops, lat, batch_s, stats = run_pruned(
            rt, engine, queries, recs[label])
        check(same_results(singles, want[0]) and same_results(batched, want[1])
              and same_results(tops, want[2]),
              f"pruned {label} != the exhaustive engine")
        n_pos = check_positives(singles, origin, f"pruned {label}",
                                limit=None if label == "raw" else COMP_BASE)
        st = index.storage
        store_bytes = sum(st.shard_hbm_nbytes(s) for s in range(st.n_shards))
        m = {"queries": len(queries), "p50_search_ms": pct_ms(lat, 50),
             "p99_search_ms": pct_ms(lat, 99),
             "exhaustive_paged_p50_ms": p50_paged,
             "batch_queries_per_s": len(queries) / batch_s,
             "store_device_bytes": store_bytes,
             "faults": engine.tiles.faults,
             "stats": {n: pruned_stats(v) for n, v in stats.items()}}
        out[label] = m
        for n, v in stats.items():
            log(f"[prune:{label}] {n}: {stats_line(v)}; read {v.bytes_read}"
                f" of the store's {store_bytes} device-form bytes "
                f"({v.bytes_read / store_bytes:.4f} a pass of "
                f"{len(queries) if n != 'batch' else len(queries) // BATCH} "
                f"{'batches' if n == 'batch' else 'queries'})")
        log(f"[prune:{label}] {len(queries)} queries x 3 entry points equal "
            f"the exhaustive engine, {n_pos} positives found; search_pruned"
            f" p50 {m['p50_search_ms']:.3f} ms, p99 {m['p99_search_ms']:.3f}"
            f" ms (exhaustive paged p50 {p50_paged:.3f} ms); batches "
            f"{m['batch_queries_per_s']:.1f} queries/s; tile faults "
            f"{engine.tiles.faults}")
    # every shard promoted on its first visit: the fused chunk kernels
    for label, index, want in (("raw", stores["raw"], stores["raw_want"]),
                               ("comp", stores["comp"], stores["comp_want"])):
        recs[f"{label} promoted"] = rec = ChunkRecorder(k)
        with rec:
            results, stats, tiles = promoted_batches(rt, index, queries)
        check(same_results(results, want[1]),
              f"promoted pruned {label} != the exhaustive engine")
        check(stats.tiles_promoted > 0 and stats.bytes_gathered == 0,
              f"promoted pruned {label}: {stats_line(stats)}")
        out[f"{label} promoted"] = {
            "stats": pruned_stats(stats), "faults": tiles.faults,
            "raw_bytes_staged": tiles.raw_bytes_staged,
            "comp_bytes_staged": tiles.comp_bytes_staged}
        log(f"[prune:{label} promoted] equal the exhaustive engine; "
            f"{stats_line(stats)}; cache staged {tiles.raw_bytes_staged} "
            f"raw + {tiles.comp_bytes_staged} compressed bytes in "
            f"{tiles.faults} faults")
    # two hashes: host AND unpromoted, device gather + AND promoted
    engine = rt.QueryEngine(k2, method="vertical", prune_chunk=32)
    st2, got = rt.query.PruneStats(), []
    for i in range(0, len(queries), BATCH):
        got += engine.search_batch_pruned(queries[i:i + BATCH], THRESHOLD,
                                          stats=st2)
    tops = [engine.top_k_pruned(q, TOP) for q in queries[:BATCH]]
    promoted, st2p, _ = promoted_batches(rt, k2, queries, n_hashes=2)
    check(same_results(got, k2_want) and same_results(tops, k2_tops)
          and same_results(promoted, k2_want),
          "pruned two-hash index != the exhaustive engine")
    check(st2p.tiles_promoted > 0, "the two-hash run promoted no shard")
    out["compact k=2"] = {"stats": pruned_stats(st2),
                          "promoted_stats": pruned_stats(st2p)}
    log(f"[prune:k=2] equal the exhaustive engine; {stats_line(st2)}; "
        f"promoted: {stats_line(st2p)}")
    launches = dict(k.launches)             # the pruned path ends here
    out["launches"] = launches
    for name in CHUNK_KERNELS:
        check(launches[name] > 0, f"the pruned path never launched {name}")
    log(f"[prune] launches {launches}")
    for label, rec in recs.items():
        check_chunk_calls(k, chk, rec.calls, f"pruned {label}")
    check_chunk_ragged(rt, torch, chk)
    log("[prune:kernels] every chunk kernel call of the pruned path "
        "equals its plain version, and so do the ragged shapes")
    return out, launches, recs["raw"].calls["chunk_dedup_score"][:8]


def bulk_results(rt, index, out, ells, top: int):
    slot = np.asarray(index.layout.doc_slot)
    if top:
        return [rt.query.select_top_k(out[i][slot], int(e), top)
                for i, e in enumerate(ells)]
    return [rt.query.select_hits(out[i][slot], int(e), THRESHOLD)
            for i, e in enumerate(ells)]


def phase_bulk(rt, torch, index, stores, queries, base, chk):
    """run_shard_major with the launch counters from 0. Returns the
    record, this path's launches and the fused chunk kernels' timing
    inputs."""
    k, q_mod = rt.kernels, rt.query
    raw, comp = stores["raw"], stores["comp"]
    st = raw.storage
    cap = max(st.shard_nbytes(s) for s in range(st.n_shards))
    term_sets = [q_mod.compile_pattern(q, index.params) for q in queries]
    buf, ells = q_mod.pad_term_batch(term_sets, 64)
    Q = len(queries)
    thr_req = np.array([q_mod.coverage_cutoff(THRESHOLD, int(e))
                        for e in ells], np.int64)
    sweeps = {"threshold": (thr_req, np.zeros(Q, np.int32)),
              "top": (np.zeros(Q, np.int64), np.full(Q, TOP, np.int32))}

    def sweep(idx, tiles, mode, **kw):
        required, topk = sweeps[mode]
        stats = q_mod.BulkStats()
        plans = q_mod.plan_shards(idx.layout, idx.storage.shard_row_starts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = q_mod.run_shard_major(tiles, plans, buf, ells, required, topk,
                                    stats=stats, **kw)
        torch.cuda.synchronize()
        return res, stats, time.perf_counter() - t0

    k.reset_launches()                      # the bulk path starts here
    out, recs, outs = {}, {}, {}
    for label, idx, make_cache, want in (
            ("dense", index, lambda: rt.DeviceTileCache(index.storage),
             base),
            ("raw bounded", raw,
             lambda: rt.DeviceTileCache(st, capacity_bytes=cap),
             (stores["raw_want"][0], stores["raw_want"][2])),
            ("comp", comp, lambda: rt.DeviceTileCache(comp.storage),
             (stores["comp_want"][0], stores["comp_want"][2]))):
        recs[label] = ChunkRecorder(k)
        m = {}
        for mode in ("threshold", "top"):
            tiles = make_cache()
            with recs[label]:
                (res, nxt, _), stats, secs = sweep(idx, tiles, mode)
            outs[(label, mode)] = res
            got = bulk_results(rt, idx, res, ells, TOP if mode == "top" else 0)
            check(nxt == idx.storage.n_shards and same_results(
                got, want[1] if mode == "top" else want[0]),
                f"bulk {label} {mode} != the exhaustive engine")
            m[mode] = {"stats": dict(vars(stats),
                                     prune_rate=stats.prune_rate),
                       "wall_s": secs, "queries_per_s": Q / secs,
                       "faults": tiles.faults,
                       "evictions": tiles.evictions}
            log(f"[bulk:{label}] {mode}: {Q} queries equal the exhaustive "
                f"engine in {secs * 1e3:.1f} ms ({Q / secs:.1f} queries/s);"
                f" {stats.shards_swept} shards, {stats.tiles_staged} "
                f"stagings of {stats.bytes_staged} bytes, "
                f"{stats.query_chunks} slabs, {stats.kernel_dispatches} "
                f"kernels, blocks pruned {stats.prune_rate:.3f}")
        out[label] = m
    b = out["raw bounded"]["threshold"]["stats"]
    check(b["tiles_staged"] == st.n_shards and b["bytes_staged"]
          == st.nbytes(),
          f"bounded bulk sweep staged {b['tiles_staged']} tiles of "
          f"{b['bytes_staged']} bytes, not {st.n_shards} of {st.nbytes()}")
    # suspended after every shard and resumed from the returned state
    plans = q_mod.plan_shards(raw.layout, st.shard_row_starts)
    tiles, state, hops = rt.DeviceTileCache(st), (None, 0, thr_req), 0
    while state[1] < len(plans):
        state = q_mod.run_shard_major(
            tiles, plans, buf, ells, state[2], np.zeros(Q, np.int32),
            start_shard=state[1], out=state[0], should_yield=lambda: True)
        hops += 1
    check(hops == st.n_shards and np.array_equal(
        state[0], outs[("raw bounded", "threshold")]),
        "the suspended and resumed sweep != the unbroken sweep")
    out["suspended"] = {"hops": hops}
    log(f"[bulk:suspend] {hops} hops of one shard each give the unbroken "
        f"sweep's slot scores")
    launches = dict(k.launches)             # the bulk path ends here
    out["launches"] = launches
    for name in ("chunk_lookup_score_multi",
                 "chunk_lookup_score_multi_compressed"):
        check(launches[name] > 0, f"the bulk path never launched {name}")
    log(f"[bulk] launches {launches}; the bounded raw sweep staged "
        f"{b['tiles_staged']} tiles, {b['bytes_staged']} bytes (the store)")
    for label, rec in recs.items():
        check_chunk_calls(k, chk, rec.calls, f"bulk {label}")
    log("[bulk:kernels] every chunk kernel call of the bulk path equals "
        "its plain version")
    comp_calls = recs["comp"].calls["chunk_lookup_score_multi_compressed"]
    tallest = max(a[1].shape[0] for a in comp_calls)
    timing = {
        "chunk_lookup_score_multi":
            recs["dense"].calls["chunk_lookup_score_multi"][:8],
        "chunk_lookup_score_multi_compressed":
            [a for a in comp_calls if a[1].shape[0] == tallest][:8]}
    return out, launches, timing


# --------------------------------------------------------------------------
# The single-host QueryServer and its row-dedup path
# --------------------------------------------------------------------------

def overlapping_reads(corpus, seed: int, limit: int | None = None):
    """A sequencing run's reads: READ_WINDOWS windows of WINDOW_LEN bases,
    one from each of as many seeded source documents (among the first
    ``limit``), each read READS_PER_WINDOW times as READ_LEN-base reads at
    uniform starts. Returns [(reads, source document)] window by window."""
    rng = np.random.default_rng(seed)
    docs = corpus.documents[:limit] if limit else corpus.documents
    eligible = [i for i, d in enumerate(docs) if len(d) >= WINDOW_LEN]
    windows = []
    for d in rng.choice(eligible, size=READ_WINDOWS, replace=False):
        w0 = int(rng.integers(0, len(docs[d]) - WINDOW_LEN + 1))
        starts = rng.integers(0, WINDOW_LEN - READ_LEN + 1, READS_PER_WINDOW)
        windows.append(([docs[d][w0 + int(s):w0 + int(s) + READ_LEN]
                         for s in starts], int(d)))
    return windows


class DedupPlans:
    """Inside ``with``, keeps (dedup rate, unique rows, gathers) of every
    batch plan the server makes (``server.plan_dedup_batch`` is looked up
    at call time). It changes nothing the server computes."""

    def __init__(self, server_mod):
        self.mod = server_mod
        self.plans = []

    def __enter__(self):
        self.saved = self.mod.plan_dedup_batch

        def rec(*args, **kw):
            dp = self.saved(*args, **kw)
            self.plans.append((dp.dedup_rate, dp.n_unique, dp.n_gathers))
            return dp
        self.mod.plan_dedup_batch = rec
        return self

    def __exit__(self, *exc):
        self.mod.plan_dedup_batch = self.saved


def serve_groups(server, groups):
    """Closed loop: submit each group's requests, drain, collect. Returns
    the responses in submission order and the wall seconds."""
    out = []
    t0 = time.perf_counter()
    for group in groups:
        ids = [server.submit(p, **kw) for p, kw in group]
        server.drain()
        resp = server.pop_responses()
        out += [resp[i] for i in ids]
    return out, time.perf_counter() - t0


def run_server(rt, torch, index, config, groups, want, what, rec):
    """Serve ``groups`` twice through one QueryServer: a warm pass, then,
    after ``reset_metrics(clear_caches=True)``, the measured pass with the
    dedup wrappers recorded by ``rec``. Every response must be OK and equal
    ``want`` (same order). Returns the server, the measured responses, the
    record and the batch dedup plans of the measured pass."""
    server = rt.QueryServer(index, config)
    for label in ("warm", "measured"):
        if label == "measured":
            server.reset_metrics(clear_caches=True)
            with rec, DedupPlans(rt.server_mod) as plans:
                resp, secs = serve_groups(server, groups)
        else:
            resp, secs = serve_groups(server, groups)
        check(all(r.status == rt.Status.OK for r in resp),
              f"[serve:{what}] {label}: a response is not OK")
        check(all(same_result(r.result, w) for r, w in zip(resp, want)),
              f"[serve:{what}] {label}: a response differs from the "
              "QueryEngine's")
    torch.cuda.synchronize()
    e2e = [r.latency_s for r in resp]
    service = [r.service_s for r in resp]
    rates = [p[0] for p in plans.plans]
    tiles = server.tiles
    m = {"requests": len(resp), "wall_s": secs,
         "queries_per_s": len(resp) / secs,
         "p50_e2e_ms": pct_ms(e2e, 50), "p99_e2e_ms": pct_ms(e2e, 99),
         "p50_service_ms": pct_ms(service, 50),
         "p99_service_ms": pct_ms(service, 99),
         "dispatch": dict(server.planner.dispatch_counts),
         "dedup_rates": rates,
         "unique_rows": sum(p[1] for p in plans.plans),
         "gathers": sum(p[2] for p in plans.plans),
         "tile_faults": tiles.faults,
         "raw_bytes_staged": tiles.raw_bytes_staged,
         "comp_bytes_staged": tiles.comp_bytes_staged}
    log(f"[serve:{what}] {len(resp)} requests equal the QueryEngine's; "
        f"{m['queries_per_s']:.1f} queries/s; e2e p50 {m['p50_e2e_ms']:.3f} "
        f"ms, p99 {m['p99_e2e_ms']:.3f} ms; service p50 "
        f"{m['p50_service_ms']:.3f} ms, p99 {m['p99_service_ms']:.3f} ms; "
        f"dispatch {m['dispatch']}")
    log(f"[serve:{what}] batch dedup rates "
        f"{[round(r, 3) for r in rates]}; {m['unique_rows']} unique rows "
        f"against {m['gathers']} gathers; {tiles.faults} tile faults, "
        f"{tiles.raw_bytes_staged} raw + {tiles.comp_bytes_staged} "
        "compressed bytes staged (both passes)")
    return server, resp, m, plans.plans


def dedup_plain(k, name, args):
    """The plain version of dedup-path wrapper ``name`` on its call's
    args."""
    return {"gather_rows": k.gather_plain,
            "gather_rows_compressed": k.gather_comp_plain,
            "dedup_score": k.dedup_plain}[name](*args)


def check_dedup_calls(k, chk, calls: dict, what: str) -> None:
    for name, recs in calls.items():
        for args in recs:
            chk.compare(name, getattr(k, name)(*args),
                        dedup_plain(k, name, args),
                        f"{what}, {[list(a.shape) for a in args]}")


def check_dedup_ragged(torch, k, chk) -> None:
    """The three dedup-path kernels at ragged shapes: W = 3, 33, 40, 130;
    U = 8 and 1,024; row sets of k = 2 for the gathers."""
    g = torch.Generator().manual_seed(13)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(DEV)

    for W in (3, 33, 40, 130):
        for U in (8, 1024):
            R, D = 3 * U + 5, U + 3
            arena, dct = ints(-2 ** 31, 2 ** 31, R, W), ints(-2 ** 31,
                                                            2 ** 31, D, W)
            refs = ints(0, D, R)
            calls = {"gather_rows": [], "gather_rows_compressed": [],
                     "dedup_score": []}
            for idx in (ints(0, R, U), ints(0, R, U, 2)):
                calls["gather_rows"].append((arena, idx))
                calls["gather_rows_compressed"].append((dct, refs, idx))
            uniq = ints(-2 ** 31, 2 ** 31, U, W)
            for Q, nb, L in ((3, 2, 17), (32, 1, 128)):
                calls["dedup_score"].append(
                    (uniq, ints(0, U, Q, nb, L), ints(0, 2, Q, nb, L)))
            check_dedup_calls(k, chk, calls, f"ragged W={W} U={U}")


def dedup_vs_fused(torch, k, lib, gather_args, dedup_args) -> dict:
    """One recorded dedup batch: the dedup pair (gather + indirected
    score) against ``lookup_score_multi`` on the same batch with the
    indices expanded (uniq_rows[indir]), both by direct launches, timed
    in turns (pair, fused, fused, pair) with CUDA events."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    arena, uniq_idx = gather_args
    _, indir, mask = dedup_args
    U, W = uniq_idx.shape[0], arena.shape[1]
    Q, nb, L = indir.shape
    planes = k.num_planes(L)
    idx = uniq_idx.long()[indir.long()].to(torch.int32).contiguous()
    uniq = torch.empty((U, W), dtype=torch.int32, device=DEV)
    out_d = torch.empty((Q, nb, W, 32), dtype=torch.int32, device=DEV)
    out_f = torch.empty_like(out_d)

    def pair():
        lib.cobs_gather_rows(arena.data_ptr(), uniq_idx.data_ptr(),
                             uniq.data_ptr(), U, 1, W, dev, stream)
        lib.cobs_dedup_score(uniq.data_ptr(), indir.data_ptr(),
                             mask.data_ptr(), out_d.data_ptr(), Q * nb, L, W,
                             planes, dev, stream)

    def fused():
        lib.cobs_lookup(arena.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                        out_f.data_ptr(), Q * nb, L, W, planes, dev, stream)

    pair()
    fused()
    torch.cuda.synchronize()
    check(torch.equal(out_d, out_f),
          "the dedup pair != lookup_score_multi on the expanded indices")
    times = {"pair": [], "fused": []}
    for name in ("pair", "fused", "fused", "pair"):
        times[name].append(loop_ms(torch, [pair if name == "pair"
                                           else fused] * 64))
    pair_ms = statistics.mean(times["pair"])
    fused_ms = statistics.mean(times["fused"])
    live = int(mask.count_nonzero())
    return {"shape": f"indir [{Q}, {nb}, {L}], uniq [{U}, {W}], arena "
                     f"{list(arena.shape)}",
            "pair_ms": pair_ms, "fused_ms": fused_ms,
            "unique_rows": U, "live_cells": live}


def same_shapes(calls, n: int = 8):
    """Up to ``n`` recorded calls whose arguments have the first call's
    shapes."""
    first = [a.shape for a in calls[0]]
    return [c for c in calls if [a.shape for a in c] == first][:n]


def trace_serve(torch, rt, index, mix_group, read_group) -> dict:
    """Where a served batch's time goes: one group of the mix and one
    window of reads through a warm default server, timed, then under
    torch.profiler (device time by op against the un-profiled wall time:
    the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile
    server = rt.QueryServer(index, rt.ServerConfig())
    out = {}
    for what, group in (("mix group", mix_group), ("read window",
                                                   read_group)):
        serve_groups(server, [group])                # warm
        server.reset_metrics(clear_caches=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_groups(server, [group])
        wall_us = (time.perf_counter() - t0) * 1e6
        server.reset_metrics(clear_caches=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_groups(server, [group])
            torch.cuda.synchronize()
        server.reset_metrics(clear_caches=True)
        device, n_dev = {}, {}
        for ev in prof.events():
            if str(ev.device_type).endswith("CUDA"):
                device[ev.name] = (device.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us())
                n_dev[ev.name] = n_dev.get(ev.name, 0) + 1
        dev_us = sum(device.values())
        host = sorted(((e.key, e.self_cpu_time_total)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])
        out[what] = {
            "requests": len(group), "wall_us": wall_us, "device_us": dev_us,
            "device_busy_share": dev_us / wall_us,
            "device_top_us": [(n, t, n_dev[n]) for n, t in sorted(
                device.items(), key=lambda kv: -kv[1])[:6]],
            "host_self_top_us": host[:8]}
        log(f"[trace:serve {what}] {len(group)} requests: wall "
            f"{wall_us:.0f} us, device {dev_us:.0f} us (busy share "
            f"{dev_us / wall_us:.3f}); top device ops (us, count): "
            + "; ".join(f"{n[:44]} {t:.0f} ({c})" for n, t, c in
                        out[what]["device_top_us"]))
        log(f"[trace:serve {what}] top host ops by self time (us): "
            + "; ".join(f"{n[:40]} {t:.0f}" for n, t in
                        out[what]["host_self_top_us"]))
    return out


def phase_serve(rt, torch, corpus, index, stores, queries, origin, chk):
    """The single-host QueryServer with the launch counters from 0: the
    dense index under the disjoint serving mix and overlapping reads, the
    raw store (tile cache bounded at half of it) and the rowdict store
    (compressed=True) under overlapping reads. Returns the record, this
    path's launches and the dedup kernels' timing inputs."""
    k = rt.kernels
    raw, comp = stores["raw"], stores["comp"]
    reads = overlapping_reads(corpus, SEED + 15)
    comp_reads = overlapping_reads(corpus, SEED + 16, limit=COMP_BASE)

    def read_groups(windows):
        return [[(r, {}) for r in rs] for rs, _ in windows]

    def read_positives(resp, windows, what):
        src = [d for rs, d in windows for _ in rs]
        for r, d in zip(resp, src):
            check(d in set(r.result.doc_ids.tolist()),
                  f"[serve:{what}] a read missed its source document {d}")

    # the engines' answers, before the counters start
    dense_eng = rt.QueryEngine(index, method="lookup")
    n_top = 8
    mix_groups = [[(q, {}) for q in queries[i:i + BATCH]]
                  for i in range(0, len(queries), BATCH)]
    mix_groups.append([(q, {"top_k": TOP}) for q in queries[:n_top]])
    mix_want = ([dense_eng.search(q, THRESHOLD) for q in queries]
                + [dense_eng.top_k(q, TOP) for q in queries[:n_top]])
    def flat(windows):
        return [r for rs, _ in windows for r in rs]

    reads_want = [dense_eng.search(r, THRESHOLD) for r in flat(reads)]
    raw_eng = rt.QueryEngine(raw, method="lookup")
    raw_want = [raw_eng.search(r, THRESHOLD) for r in flat(reads)]
    comp_eng = rt.QueryEngine(comp, method="lookup", compressed=True)
    comp_want = [comp_eng.search(r, THRESHOLD) for r in flat(comp_reads)]

    k.reset_launches()                      # the serving path starts here
    out, recs = {}, {}
    cases = (
        ("dense mix", index, rt.ServerConfig(), mix_groups, mix_want),
        ("dense reads", index, rt.ServerConfig(), read_groups(reads),
         reads_want),
        ("raw", raw, rt.ServerConfig(tile_cache_bytes=raw.storage.nbytes()
                                     // 2), read_groups(reads), raw_want),
        ("comp", comp, rt.ServerConfig(compressed=True),
         read_groups(comp_reads), comp_want))
    for what, idx, cfg, groups, want in cases:
        recs[what] = ChunkRecorder(k, DEDUP_KERNELS)
        server, resp, m, _ = run_server(rt, torch, idx, cfg, groups, want,
                                        what, recs[what])
        out[what] = m
        if what == "dense mix":
            n_pos = check_positives([r.result for r in resp[:len(queries)]],
                                    origin, "[serve:dense mix]")
            log(f"[serve:dense mix] {n_pos} positives all found; "
                f"{n_top} top_k={TOP} requests equal QueryEngine.top_k")
        else:
            read_positives(resp, comp_reads if what == "comp" else reads,
                           what)
    d = out["dense mix"]["dispatch"]
    check(d.get("lookup", 0) > 0,
          f"[serve:dense mix] dispatch {d}: no fused lookup batch")
    for what, method in (("dense reads", "dedup"), ("raw", "dedup"),
                         ("comp", "dedup_c")):
        check(out[what]["dispatch"].get(method, 0) > 0,
              f"[serve:{what}] dispatch {out[what]['dispatch']}: no "
              f"{method}")
    launches = dict(k.launches)             # the serving path ends here
    out["launches"] = launches
    for name in DEDUP_KERNELS + ("lookup_score_multi",):
        check(launches[name] > 0, f"the serving path never launched {name}")
    log(f"[serve] launches {launches}")
    for what, rec in recs.items():
        check_dedup_calls(k, chk, rec.calls, f"serve {what}")
    check_dedup_ragged(torch, k, chk)
    log("[serve:kernels] every gather_rows, gather_rows_compressed and "
        "dedup_score call of the serving path equals its plain version, "
        "and so do the ragged shapes")
    out["trace"] = trace_serve(torch, rt, index, mix_groups[0],
                               read_groups(reads)[0])
    dense_calls = recs["dense reads"].calls
    out["dedup_vs_fused"] = vs = dedup_vs_fused(
        torch, k, rt.build.library(), dense_calls["gather_rows"][0],
        dense_calls["dedup_score"][0])
    log(f"[serve:dense] one dedup batch ({vs['shape']}, {vs['live_cells']} "
        f"live cells): dedup pair {vs['pair_ms'] * 1e3:.2f} us against "
        f"lookup_score_multi on the expanded indices "
        f"{vs['fused_ms'] * 1e3:.2f} us")
    # timing inputs: up to 8 recorded calls of one shape (for the rowdict
    # gather, on the store's tallest shard)
    comp_calls = recs["comp"].calls["gather_rows_compressed"]
    tallest = max(a[1].shape[0] for a in comp_calls)
    timing = {"gather_rows": same_shapes(dense_calls["gather_rows"]),
              "dedup_score": same_shapes(dense_calls["dedup_score"]),
              "gather_rows_compressed": same_shapes(
                  [a for a in comp_calls if a[1].shape[0] == tallest])}
    return out, launches, timing


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def phase_trace(rt, torch, index, queries, p50_ms: float) -> dict:
    """Where a lookup search's time goes: torch.profiler over 32 single
    searches and one batch of 32. Device time per search is set against
    the un-profiled p50, which gives the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    engine = rt.QueryEngine(index, method="lookup")
    sample = queries[:BATCH]
    out = {}
    for what, run in (
            ("search", lambda: [engine.search(q, THRESHOLD) for q in sample]),
            ("search_batch", lambda: engine.search_batch(sample, THRESHOLD))):
        run()                                        # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device = {}
        for ev in prof.events():
            if str(ev.device_type).endswith("CUDA"):
                device[ev.name] = (device.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us())
        host = sorted(((e.key, e.self_cpu_time_total)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])
        per_query_us = sum(device.values()) / len(sample)
        out[what] = {
            "device_us_per_query": per_query_us,
            "device_top_us": sorted(device.items(),
                                    key=lambda kv: -kv[1])[:6],
            "host_self_top_us": host[:8],
        }
        log(f"[trace:{what}] device {per_query_us:.1f} us per query; top "
            "device ops (total us over 32 queries): "
            + "; ".join(f"{n[:48]} {t:.1f}" for n, t in
                        out[what]["device_top_us"]))
        log(f"[trace:{what}] top host ops by self time (us): "
            + "; ".join(f"{n[:40]} {t:.0f}" for n, t in
                        out[what]["host_self_top_us"]))
    out["device_busy_share_single"] = (
        out["search"]["device_us_per_query"] / (p50_ms * 1e3))
    log(f"[trace] device busy share of a single lookup search: "
        f"{out['device_busy_share_single']:.3f} (device time per search / "
        f"un-profiled p50 {p50_ms:.3f} ms)")
    return out

def phase_trace_chunked(rt, torch, stores, index, queries) -> dict:
    """Where the chunked executors spend their time: 32 search_pruned
    calls on the raw store and one 128-query bulk sweep of the dense
    index, each run warm, then timed, then under torch.profiler (device
    time by op against the un-profiled wall time: the device's busy
    share), then under cProfile (host time by function)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    q_mod = rt.query
    engine = rt.QueryEngine(stores["raw"], method="lookup", prune_chunk=32)
    sample = queries[:BATCH]
    term_sets = [q_mod.compile_pattern(q, index.params) for q in queries]
    buf, ells = q_mod.pad_term_batch(term_sets, 64)
    required = np.array([q_mod.coverage_cutoff(THRESHOLD, int(e))
                         for e in ells], np.int64)
    tiles = rt.DeviceTileCache(index.storage)
    plans = q_mod.plan_shards(index.layout, index.storage.shard_row_starts)
    runs = {
        "search_pruned x32": lambda: [engine.search_pruned(q, THRESHOLD)
                                      for q in sample],
        "bulk sweep x128": lambda: q_mod.run_shard_major(
            tiles, plans, buf, ells, required, np.zeros(len(ells), np.int32)),
    }
    out = {}
    for what, run in runs.items():
        run()                                        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device, n_dev = {}, {}
        for ev in prof.events():
            if str(ev.device_type).endswith("CUDA"):
                device[ev.name] = (device.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us())
                n_dev[ev.name] = n_dev.get(ev.name, 0) + 1
        cp = cProfile.Profile()
        cp.enable()
        run()
        torch.cuda.synchronize()
        cp.disable()
        host = sorted(pstats.Stats(cp).stats.items(),
                      key=lambda kv: -kv[1][2])[:10]
        dev_us = sum(device.values())
        out[what] = {
            "wall_us": wall_us, "device_us": dev_us,
            "device_busy_share": dev_us / wall_us,
            "device_top_us": [(n, t, n_dev[n]) for n, t in sorted(
                device.items(), key=lambda kv: -kv[1])[:6]],
            "host_tottime_top_us": [
                (f"{fn[2]} ({Path(fn[0]).name}:{fn[1]})", st[2] * 1e6, st[1])
                for fn, st in host]}
        log(f"[trace:{what}] wall {wall_us:.0f} us, device {dev_us:.0f} us "
            f"(busy share {dev_us / wall_us:.3f}); top device ops (us, "
            "count): " + "; ".join(f"{n[:44]} {t:.0f} ({c})" for n, t, c in
                                    out[what]["device_top_us"]))
        log(f"[trace:{what}] host self time under cProfile (us, calls): "
            + "; ".join(f"{n[:60]} {t:.0f} ({c})" for n, t, c in
                        out[what]["host_tottime_top_us"]))
    return out


def event_ms(torch, fn, reps: int) -> float:
    """Median over reps of one call's device time between CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(torch, calls, rounds: int = 5) -> float:
    """Median over rounds of (events around all ``calls`` back to back) /
    len(calls): the kernel's time per launch on the device timeline."""
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for c in calls:
            c()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / len(calls))
    return statistics.median(per)


def profiled_kernel_ms(torch, calls, kernel_name: str
                       ) -> tuple[float | None, int, dict]:
    """Mean device time of ``kernel_name`` over the kernel records
    torch.profiler delivers for the calls (None when it delivers none),
    the number of those records (a session may lose a few of them), and
    the count of every device event name the session saw."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for c in calls:
            c()
        torch.cuda.synchronize()
    seen, times = {}, []
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            seen[ev.name] = seen.get(ev.name, 0) + 1
            if kernel_name in ev.name:
                times.append(ev.time_range.elapsed_us())
    return ((sum(times) / len(times) / 1e3 if times else None), len(times),
            seen)


def lookup_case(torch, k, lib, name, what, src, rows, refs=None):
    """A timing case of a fused lookup over ``src`` = [(ridx, mask)]
    against ``rows`` (the arena, or with ``refs`` a rowdict dictionary):
    (name, shape, direct launches, plain call, bytes, operations). The
    bytes are each index and mask read once, one row (and with refs one
    4-byte refs entry) per counted term, and the counts written."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    W = rows.shape[1]
    calls = []
    for ridx, msk in src:
        cells, L = ridx.numel() // ridx.shape[-1], ridx.shape[-1]
        o = torch.empty(ridx.shape[:-1] + (W, 32), dtype=torch.int32,
                        device=DEV)
        head = ((rows.data_ptr(),) if refs is None
                else (rows.data_ptr(), refs.data_ptr()))
        fn = lib.cobs_lookup if refs is None else lib.cobs_lookup_comp
        calls.append(lambda f=fn, h=head, r=ridx, m=msk, o=o, c=cells, L=L:
                     f(*h, r.data_ptr(), m.data_ptr(), o.data_ptr(), c, L, W,
                       k.num_planes(L), dev, stream))
    ridx, msk = src[0]
    L = ridx.shape[-1]
    cells = ridx.numel() // L
    active = int(msk.count_nonzero())
    planes = k.num_planes(L)
    if refs is None:
        plain = lambda: k.lookup_plain(rows, ridx, msk)
        shape = f"{what} = {list(ridx.shape)}, arena {list(rows.shape)}"
    else:
        plain = lambda: k.lookup_comp_plain(rows, refs, ridx, msk)
        shape = (f"{what} = {list(ridx.shape)}, dict {list(rows.shape)}, "
                 f"refs [{refs.shape[0]}]")
    nbytes = (ridx.numel() * 8 + active * W * 4 + cells * W * 32 * 4
              + (active * 4 if refs is not None else 0))
    return (name, shape, calls, plain, nbytes,
            2 * planes * (active * W + cells * W * 32))


CHUNK_SYMBOLS = {"chunk_lookup_score_multi": "cobs_chunk_lookup",
                 "chunk_lookup_score_multi_compressed": "cobs_chunk_lookup_comp",
                 "chunk_dedup_score": "cobs_chunk_dedup"}


def chunk_case(torch, k, lib, name, recs):
    """A timing case of a chunk kernel over calls recorded on its path:
    (name, shape, direct launches, plain call, bytes, operations). The
    bytes are each index and mask read once, each distinct row the live
    terms touch read once (and for the fused decode each distinct refs
    entry), acc read once and the new acc written once."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, CHUNK_SYMBOLS[name])
    comp = name == "chunk_lookup_score_multi_compressed"
    calls = []
    for args in recs:
        rows, idx, msk, acc = (args[0],) + args[2:] if comp else args
        head = ((rows.data_ptr(), args[1].data_ptr()) if comp
                else (rows.data_ptr(),))
        o = torch.empty_like(acc)
        Q, nb, L = idx.shape
        calls.append(lambda f=fn, h=head, i=idx, m=msk, a=acc, o=o,
                     c=Q * nb, L=L, W=rows.shape[1], Wp=acc.shape[2]:
                     f(*h, i.data_ptr(), m.data_ptr(), a.data_ptr(),
                       o.data_ptr(), c, L, W, Wp, k.num_planes(L), dev,
                       stream))
    args = recs[0]
    rows, idx, msk, acc = (args[0],) + args[2:] if comp else args
    W, Wp = rows.shape[1], acc.shape[2]
    cells, L = idx.numel() // idx.shape[-1], idx.shape[-1]
    touched = idx[msk != 0].unique()
    if comp:
        row_bytes = (touched.numel() * 4
                     + args[1][touched.long()].unique().numel() * W * 4)
        shape = (f"idx {list(idx.shape)}, acc {list(acc.shape)}, dict "
                 f"{list(rows.shape)}, refs [{args[1].shape[0]}]")
    else:
        row_bytes = touched.numel() * W * 4
        shape = (f"{'indir' if name == 'chunk_dedup_score' else 'idx'} "
                 f"{list(idx.shape)}, acc {list(acc.shape)}, "
                 f"{'uniq' if name == 'chunk_dedup_score' else 'arena'} "
                 f"{list(rows.shape)}")
    active = int(msk.count_nonzero())
    planes = k.num_planes(L)
    nbytes = idx.numel() * 8 + row_bytes + 2 * acc.numel() * 4
    nops = 2 * planes * (active * W + cells * Wp * 32) + acc.numel()
    return (name, shape, calls, lambda: chunk_plain(k, name, args), nbytes,
            nops)


def gather_case(torch, k, lib, name, recs):
    """A timing case of a dedup-path gather over calls recorded on the
    serving path: (name, shape, direct launches, plain call, bytes,
    operations, library call). The bytes are each index (and refs entry)
    read once, each distinct source row read once and the rows written
    once. The library call is one ``torch.index_select`` of the same rows:
    for the rowdict gather, of the dictionary at refs[uniq_idx], composed
    outside the call."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    comp = name == "gather_rows_compressed"
    fn = lib.cobs_gather_rows_comp if comp else lib.cobs_gather_rows
    calls = []
    for args in recs:
        rows, idx = args[0], args[-1]
        U, W = idx.shape[0], rows.shape[1]
        kk = 1 if idx.dim() == 1 else idx.shape[1]
        o = torch.empty((U, W), dtype=torch.int32, device=DEV)
        head = ((rows.data_ptr(), args[1].data_ptr()) if comp
                else (rows.data_ptr(),))
        calls.append(lambda h=head, i=idx, o=o, U=U, kk=kk, W=W: fn(
            *h, i.data_ptr(), o.data_ptr(), U, kk, W, dev, stream))
    args = recs[0]
    rows, idx = args[0], args[-1]
    U, W = idx.shape[0], rows.shape[1]
    src = args[1][idx.long()] if comp else idx
    nbytes = (idx.numel() * 4 * (2 if comp else 1)
              + src.unique().numel() * W * 4 + U * W * 4)
    if comp:
        shape = (f"uniq_idx {list(idx.shape)}, dict {list(rows.shape)}, "
                 f"refs [{args[1].shape[0]}]")
        plain = lambda: k.gather_comp_plain(*args)
    else:
        shape = f"uniq_idx {list(idx.shape)}, arena {list(rows.shape)}"
        plain = lambda: k.gather_plain(*args)
    library = None
    if idx.dim() == 1:
        flat_src = src.contiguous()
        library = lambda: torch.index_select(rows, 0, flat_src)
    return (name, shape, calls, plain, nbytes, idx.numel() * W, library)


def dedup_case(torch, k, lib, recs):
    """A timing case of ``dedup_score`` over calls recorded on the
    serving path. The bytes are each indirection and mask read once, each
    distinct uniq row the live terms touch read once and the counts
    written once."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for uniq, indir, msk in recs:
        Q, nb, L = indir.shape
        W = uniq.shape[1]
        o = torch.empty((Q, nb, W, 32), dtype=torch.int32, device=DEV)
        calls.append(lambda u=uniq, i=indir, m=msk, o=o, c=Q * nb, L=L, W=W:
                     lib.cobs_dedup_score(u.data_ptr(), i.data_ptr(),
                                          m.data_ptr(), o.data_ptr(), c, L,
                                          W, k.num_planes(L), dev, stream))
    uniq, indir, msk = recs[0]
    W = uniq.shape[1]
    cells, L = indir.numel() // indir.shape[-1], indir.shape[-1]
    active = int(msk.count_nonzero())
    touched = indir[msk != 0].unique().numel()
    nbytes = indir.numel() * 8 + touched * W * 4 + cells * W * 32 * 4
    planes = k.num_planes(L)
    return ("dedup_score",
            f"indir {list(indir.shape)}, uniq {list(uniq.shape)}", calls,
            lambda: k.dedup_plain(*recs[0]), nbytes,
            2 * planes * (active * W + cells * W * 32))


def library_kernel_ms(torch, library, reps: int = 256):
    """Device time of one library call: the profiler's mean kernel record
    over ``reps`` calls times the kernels a call launches, else CUDA
    events around the calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(4):
        library()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            library()
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() for ev in prof.events()
             if str(ev.device_type).endswith("CUDA")
             and "memcpy" not in ev.name.lower()
             and "memset" not in ev.name.lower()]
    if times:
        # the mean kernel record times the kernels a call launches (a
        # session may lose a few records, as for the wrappers' kernels)
        per_call = max(1, round(len(times) / reps))
        return sum(times) / len(times) * per_call / 1e3, "torch.profiler"
    return loop_ms(torch, [library] * reps), "cuda events"


def phase_timings(rt, torch, index, classic, queries, max_err, launches,
                  comp, chunk, serve) -> list[dict]:
    k = rt.kernels
    q_mod = rt.query
    lib = rt.build.library()
    arena = index.storage.full_device()
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()

    def plan(idx, term_sets):
        """Main-path inputs of a batch of term sets on ``idx``."""
        ridx, mask, rows, valid = plan_lookup(
            rt, torch, term_sets, idx.row_offset, idx.block_width,
            idx.params.n_hashes)
        flat = q_mod.gather_rows(idx.storage.full_device(), rows, valid)
        return ridx, mask, flat.contiguous()

    # the longest bucket: 320-bp queries pad to 320 terms
    term_sets = [q_mod.compile_pattern(q, index.params) for q in queries]
    long_sets = [t for t in term_sets if t.shape[0] > 256][:BATCH]
    singles = [plan(index, [t]) for t in long_sets]
    batch_idx, batch_mask, _ = plan(index, term_sets[:BATCH])
    classic_singles = [plan(classic, [t]) for t in long_sets]

    cases = []
    W = arena.shape[1]
    # unpack / vertical on the gathered rows of one 320-term query
    for name, sym, plain in (("unpack_score", "cobs_unpack",
                              k.unpack_score_plain),
                             ("vertical_score", "cobs_vertical",
                              k.vertical_score_plain)):
        flats = [s[2][0] for s in singles]
        L, Wf = flats[0].shape
        outs = [torch.empty((1, Wf, 32), dtype=torch.int32, device=DEV)
                for _ in flats]
        extra = (k.num_planes(L),) if name == "vertical_score" else ()
        # bind sym and extra now: a late-bound closure would launch the
        # last loop iteration's kernel for every case
        calls = [(lambda f=f, o=o, fn=getattr(lib, sym), extra=extra: fn(
            f.data_ptr(), o.data_ptr(), 1, L, Wf, *extra, dev, stream))
            for f, o in zip(flats, outs)]
        planes = k.num_planes(L)
        ops = (2 * L * Wf * 32 if name == "unpack_score"
               else 2 * planes * (L * Wf + Wf * 32))
        cases.append((name, f"rows [{L}, {Wf}]", calls,
                      lambda p=plain, f=flats[0]: p(f),
                      L * Wf * 4 + Wf * 32 * 4, ops))
    # fused lookups on the compact index (single and batch), the classic
    # index, and a rowdict shard of the compressed store
    cases += [
        lookup_case(torch, k, lib, "lookup_score_blocks", "idx [nb, L]",
                    [(s[0][0], s[1][0]) for s in singles], arena),
        lookup_case(torch, k, lib, "lookup_score_multi", "idx [Q, nb, L]",
                    [(batch_idx, batch_mask)], arena),
        lookup_case(torch, k, lib, "lookup_score", "idx [L]",
                    [(s[0][0, 0], s[1][0, 0]) for s in classic_singles],
                    classic.storage.full_device()),
        lookup_case(torch, k, lib, "lookup_score_blocks_compressed",
                    "idx [nb, L]",
                    [(r[0], m[0]) for r, m in comp["singles"]],
                    comp["dict_rows"], comp["refs"]),
        lookup_case(torch, k, lib, "lookup_score_multi_compressed",
                    "idx [Q, nb, L]", [comp["batch"]], comp["dict_rows"],
                    comp["refs"]),
    ]
    # the chunk kernels on calls recorded on their paths: the pruned raw
    # store's first batch (dedup), the dense and rowdict bulk sweeps
    cases += [chunk_case(torch, k, lib, name, chunk[name])
              for name in CHUNK_KERNELS]
    # the serving path's dedup batches: overlapping reads on the dense
    # index (gather, score) and on the rowdict store (decoding gather)
    cases += [gather_case(torch, k, lib, "gather_rows",
                          serve["gather_rows"]),
              dedup_case(torch, k, lib, serve["dedup_score"]),
              gather_case(torch, k, lib, "gather_rows_compressed",
                          serve["gather_rows_compressed"])]
    profiled_kernel_ms(torch, cases[0][2][:1], "")   # the profiler's first use
    out = []
    for name, shape, calls, plain, nbytes, nops, *library in cases:
        library = library[0] if library else None
        for c in calls:                                  # warm-up
            c()
        torch.cuda.synchronize()
        # 256 launches, cycling over the queries' inputs
        reps = calls * max(1, 256 // len(calls))
        ev = loop_ms(torch, reps)
        line, body, symbol = KERNELS[name]
        prof, n_records, seen = profiled_kernel_ms(torch, reps, symbol)
        if prof is None:
            log(f"[time] {name}: the profiler saw no {symbol} among the "
                f"device events {seen}")
        plain_ms = event_ms(torch, plain, 7)
        library_ms, library_source = (library_kernel_ms(torch, library)
                                      if library is not None
                                      else (None, None))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        rec = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS}:{line}", "pallas_kernel":
                f"{name} ({body})", "matched": max_err[name] == 0,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": prof if prof is not None else ev,
            "ms_source": "torch.profiler" if prof is not None
                         else "cuda events",
            "profiler_records": n_records, "profiled_launches": len(reps),
            "loop_ms": ev, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": nops, "shape": shape,
            "library_ms": library_ms, "library_ms_source": library_source,
            "profiler_device_events": None if prof is not None else seen,
        }
        out.append(rec)
        log(f"[time] {name} at {shape}: kernel {rec['ms'] * 1e3:.2f} us "
            f"({rec['ms_source']}, {n_records} of {len(reps)} launches "
            f"recorded), back-to-back {ev * 1e3:.2f} us/launch, "
            f"plain {plain_ms * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.4f}"
            f" us ({rec['bound_by']}: {nbytes} bytes, {nops} ops)"
            + ("" if library_ms is None else
               f", torch.index_select {library_ms * 1e3:.2f} us "
               f"({library_source})"))
    log("[time] library_ms is null except for the two gathers "
        "(torch.index_select): no single PyTorch call computes the other "
        "functions")
    return out


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


class _Port:
    """The port's modules, imported once src is on the path."""

    def __init__(self):
        from repro_torch.core import (DeviceTileCache, IndexParams,
                                      QueryEngine, build_classic,
                                      build_compact, codec, hashing,
                                      load_index_v2, query)
        from repro_torch.data import make_corpus, make_queries
        from repro_torch.index import build_compact_streaming
        from repro_torch.kernels import _build, bitslice_score, ops
        from repro_torch.serve import QueryServer, ServerConfig, Status
        from repro_torch.serve import server as server_mod
        self.IndexParams, self.QueryEngine = IndexParams, QueryEngine
        self.QueryServer, self.ServerConfig = QueryServer, ServerConfig
        self.Status, self.server_mod = Status, server_mod
        self.build_classic, self.build_compact = build_classic, build_compact
        self.hashing, self.query, self.codec = hashing, query, codec
        self.DeviceTileCache, self.load_index_v2 = DeviceTileCache, \
            load_index_v2
        self.build_compact_streaming = build_compact_streaming
        self.make_corpus, self.make_queries = make_corpus, make_queries
        self.build, self.kernels, self.ops = _build, bitslice_score, ops


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    rt = _Port()
    record = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        record["card"] = card_line()
        log(f"[card] {record['card']}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        record["build"] = phase_build_kernels(rt)
        phase_small_reference(rt, torch)
        corpus, index, record["index"] = phase_build_index(rt, torch)
        chk = KernelCheck(torch)
        phase_kernels_vs_plain(rt, torch, index, chk)
        main_path, queries, origin, extra, base = phase_main_path(
            rt, torch, corpus, index)
        record["main_path"] = main_path
        try:
            record["store"], store_launches, comp, stores = phase_store(
                rt, torch, corpus, queries, origin, chk)
            record["prune"], prune_launches, dedup_calls = phase_prune(
                rt, torch, stores, queries, origin, extra["compact k=2"],
                chk)
            record["bulk"], bulk_launches, chunk = phase_bulk(
                rt, torch, index, stores, queries, base, chk)
            chunk["chunk_dedup_score"] = dedup_calls
            record["trace_chunked"] = phase_trace_chunked(
                rt, torch, stores, index, queries)
            record["serve"], serve_launches, serve = phase_serve(
                rt, torch, corpus, index, stores, queries, origin, chk)
        finally:
            shutil.rmtree(STORE_DIR, ignore_errors=True)
        record["trace"] = phase_trace(
            rt, torch, index, queries,
            main_path["methods"]["lookup"]["p50_search_ms"])
        # each kernel's launches on the paths that drive it
        launches = {n: main_path["launches"][n] + store_launches[n]
                    + prune_launches[n] + bulk_launches[n]
                    + serve_launches[n] for n in KERNELS}
        record["kernels"] = phase_timings(
            rt, torch, index, extra["classic k=1"], queries, chk.err,
            launches, comp, chunk, serve)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    record["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"[done] {record['seconds']:.1f} s; measurements in "
        f"{OUT_DIR / 'chip_smoke.json'}")
    print(record["card"])
    print(json.dumps({"kernels": record["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
