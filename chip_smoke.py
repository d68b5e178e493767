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
   ``tests/test_kernels.py``; holds the split kernels (vertical, lookup,
   the fused-decode lookup, the three chunk kernels, dedup, unpack) where
   a split can go wrong: word tiles (W 1 to 384, running counts padded
   past W), term slices and clusters (L 1 to 1,025, across the 1,024-term
   index stage; cluster sizes 1 to 8), 1 to 200 cells, masks with zeros, and L of 65,535, 65,536 and 70,144
   (against the plain unpack of the gathered rows), plus a slice of more
   than 65,535 terms; then answers a 70,100-base query (70,144 padded
   terms) on an 8-document index through the ``vertical``, ``lookup`` and
   ``unpack`` engines and one served request, equal to ``method="ref"``,
   and runs the six wrappers of the fused-decode, dedup and chunk kernels
   at that length ("[long]": one launch each); and holds the server's
   selection kernel (``select_scores``) against ``select_plain`` bit for
   bit at the dense read batch's shape, [32, 34,816] scores of 34,134
   documents, once with read-like scores and once forced past the hit
   lists' cap, beside the copy of the lists to pinned memory and
   ``index_select`` + ``>=`` + ``nonzero`` as a library yardstick
   ("[select]"); and holds the grouped lookup (``lookup_score_grouped``)
   against the per-shard fused lookup and its plain version bit for bit
   at the paged cell's resident tiles (23 and 34 blocks of 32 words, each
   a tile of its own, 1 and 32 reads of 120 terms), timed as a graph of 64
   launches beside the 23 per-shard lookups it replaces and, on the
   host's clock, a batch through either ("[grouped]");
4. runs the main path with every launch counter at 0: 128 queries of the
   serving traffic mix (40/80/160/320 bp, half true positives, half
   verified negatives) through ``search``, ``search_batch`` (batches of 32)
   and ``top_k`` for each method, then a classic index and a two-hash
   compact index. All methods must agree, no positive query may miss its
   origin document, and each kernel must have been launched (the mix is
   ``repro_torch.launch.serve.make_workload``'s, the CLI's own). Then,
   each with its launch counters from 0: a ``MultiIndexEngine`` over the
   main and classic indexes ("[multi]": every merged hit list equal to the
   merge of the two datasets' plain engines, one vertical launch a search
   and dataset), and a ``DistributedIndex`` of the main index on a
   (pod 2, data 2, model 2) mesh of the card ("[dist]": 8 slices of about
   61 MB; ``scores_for`` of 16 queries equal to the plain engine's
   ``score_terms`` and ``search_batch`` (top 32) of the whole mix equal to
   a plain merge, for the vertical and lookup paths; batch p50 and the
   card's busy share; every kernel call equal to its plain version);
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
   plain version, and so do the gathers at ragged widths, row sets of 1-5
   rows and sources whose data pointers are 4-, 8- and 16-byte aligned,
   and the pair run as the server runs it (the dedup launch the gather's
   programmatic dependent);
9. drives the kernel tuner ("[tune]"), its counters from 0 and kept out
   of the kernel line's launches: the dense reads, the dense mix and the
   rowdict reads served again with ``autotune=True`` into a tuning cache
   file each (every response equal to the engine's; the tuned entries,
   dispatch mix and queries/s printed beside the untuned [serve] run),
   then each reopened read-only from its file, which must tune nothing
   and hit; the raw store's ``lookup_p`` break-even at the read shape
   (``tools/split_probe.py --tune`` asks how far fresh tunes spread and
   what a fixture past the L2 changes). The tuner must have launched the
   eight kernels its measurements run, and every served dedup-path call
   must equal its plain version;
10. drives the network front door ("[net]"), its counters from 0 and kept
   out of the kernel line's launches: 8 NetClient threads pipeline the
   dense mix and the dense reads (window by window) into
   ``NetServer(ServingLoop(QueryServer))`` on localhost (wire queries/s,
   client-side latency, the server's wait and service, dispatch mix and
   mean batch size, beside the in-process [serve] run); STATS in both
   formats and a traced query; BULK frames through a ``BulkLane`` on the
   raw store (cache of half the store; alone, each shard staged once,
   then beside 2 clients sending the raw reads, whose latency is printed
   with and without the sweep), a pruned job through the lane, and BULK
   on the rowdict store served compressed; then ``close(drain=True)`` with
   requests queued. Every answer must be OK and equal to the engine's or
   [bulk]'s, every bulk job DONE, no reply dropped; the six kernels of
   the path must have launched, from the loop's worker and the lane's
   thread, each wrapper's launches equal to its calls, and its first
   calls equal to their plain versions;
11. drives the multi-host data plane ("[multihost]"), its counters from 0
   and kept out of the kernel line's launches: a ``Frontend`` over 3 fake
   hosts (replication 2, unbounded tile caches) on the raw store serves
   the dense mix, the raw reads window by window and single short
   queries, with sequential and with concurrent scatter (queries/s,
   client e2e p50/p99, per-worker dispatch p50, the card's busy share of
   one scattered batch); a host fails while a batch is in flight and
   recovers (failovers, no request lost); pruned workers on the raw store
   and compressed workers (plain and pruned) on the rowdict store, each
   fleet also swept by a ``BulkLane``; then an ``RpcFrontend`` over 3
   ``WorkerServer``s on localhost, first with a straggler and hedging (the
   hedged duplicates win, the losers are cancelled on the wire), then with
   one server closed mid-load. Every answer must be OK and equal to the
   engine's on the same store; the path's kernels must have launched,
   each wrapper's launches equal to its calls, and every call must equal
   its plain version on the card;
   then ("[cluster]") a ``WorkerCluster`` of 3 worker processes on the card
   over the raw store (replication 2), behind an ``RpcFrontend`` in a
   ``ServingLoop`` and a ``NetServer``: the dense mix and the raw reads
   from 8 NetClient threads (queries/s, client e2e p50/p99, per-worker
   dispatch p50, card memory of the fleet), then one worker SIGKILLed
   mid-load and restarted on its port (every answer OK and equal, none
   lost, failovers above 0, the channel back up; the children's kernels
   are held through their answers); and ("[cli]") ``python -m
   repro_torch.launch.serve`` on the card as a user runs it: closed load on
   2048 documents, a v2 store served by 3 fake hosts with one failed, the
   same store with a ``--bulk`` sweep of the mix, and ``--listen``
   answered over the wire and drained by SIGINT (each run exits 0 with
   every answer right). The store directories are deleted after these
   phases;
12. traces 32 lookup searches, 32 pruned searches and one bulk sweep with
   torch.profiler (device time, the top device and host operations; the
   chunked executors under cProfile too), and times each kernel at the
   main path's shapes (a CUDA graph of 64 launches, so no host gaps)
   against its bound, its plain version and, for the gathers,
   ``torch.index_select``; the split kernels also at vertical
   rows [320, 8] and [32, 320, 64] and unpack and vertical rows [64, 64]
   (a short singleton), each at cluster sizes 1, 2, 4 and 8 beside the
   size the entry point chooses, with their launch shape (blocks,
   threads, cluster, word tile, slices, planes, shared memory,
   registers);
13. serves the LM substrate ("[lm]", no kernel of its own and none in the
   kernel line): every arch's ``smoke()`` config, drawn from a seeded CPU
   generator, runs on the card and on the CPU (``forward_train``, a
   prefill and three decode steps: logits and every cache leaf within
   rtol = atol = 5e-2, each row compared only before a MoE router's near
   tie); then qwen2.5-3b, recurrentgemma-2b and xlstm-125m at full width
   and depth with random weights drawn on the card: 4 prompts of 64
   tokens and 32 greedy tokens into a cache of 128 (the prefill against
   ``forward_train``; each greedy token against the teacher-forced argmax
   where forward's top-2 margin exceeds twice the tolerance; card memory
   after init; prefill ms and decode ms a token, p50 of 31, beside
   ``launch/analytic.py``'s ``bytes_model`` over 3.35 TB/s);
14. trains the LM substrate ("[train]", no kernel of its own): every
   arch's ``smoke()`` config, 4 train steps on the card and on the CPU
   from the same state (fp32 and bf16 compute; losses, grad norms and
   parameters within stated bounds); qwen2.5-3b and xlstm-125m at full
   width and depth (random weights drawn on the card, remat, the in-place
   AdamW): 8 steps of batch 4 x 128 on a repeated ``synthetic_batch``,
   step ms (p50 of steps 2-8) and tokens/s beside a bound
   (``flops_model`` over 989 TFLOP/s plus 28 B a parameter over 3.35
   TB/s), peak card memory, falling losses, and one profiled qwen2.5-3b
   step ("[train:trace]": kernels, busy share, device time by group, no
   autograd node selecting one layer of a stacked leaf); the
   ``AsyncCheckpointer`` on xlstm-125m's state ("[train:ckpt]": host copy
   and write apart, a restore to the card bit-equal); qwen3-4b smoke under
   ``run_with_restarts`` with failures at steps 5 and 9 in a child process
   with deterministic algorithms ("[train:restart]": bit-equal to the
   clean run); and ``python -m repro_torch.launch.train`` twice on the
   card ("[train:cli]": 6 steps, then resumed from step 5 to 9);
15. holds the analytic dry-run against the card ("[dryrun]", no kernel of
   its own): ``python -m repro_torch.launch.dryrun`` over every arch,
   shape and production mesh at full width in a child process
   ("[dryrun:cli]": exit 0, per mesh 32 ok, 8 skipped and 1 COBS cell,
   CUDA never initialised); each of the 32 supported smoke cells on a
   (1, 1) mesh of the card, its arguments made real ("[dryrun:smoke]": the
   bytes allocated equal the per-leaf prediction in the allocator's
   512-byte blocks; one step run, its outputs the predicted leaves, the
   peak above the arguments printed as the measured temp, which the
   dry-run does not predict). Every shard factor is 1 on that mesh, so
   this checks the cells' leaves and the allocator's rounding, not the
   division by the mesh that the 16x16 numbers rest on; the full-width
   qwen2.5-3b train cell on "meta" ("[dryrun:full]": its state equal,
   leaf by leaf and in bytes, to the state [train:full] allocated); and
   [dist]'s slices against the dry-run's COBS padding ("[dryrun:cobs]").

It prints the card's name and power limit and a ``{"kernels": ...}`` line,
writes its measurements to ``chiprun_out/chip_smoke.json``, and ends with
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Without CUDA, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
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
# wrapper -> (its line in PALLAS, the Pallas kernel body, the CUDA kernel);
# None for a kernel the Pallas port lacks
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
    # no Pallas counterpart: the JAX engine launches a lookup a shard
    "lookup_score_grouped": (None, None, "grouped::lookup_kernel"),
}
# the kernels the tuner's measurements launch
TUNE_KERNELS = ("lookup_score_multi", "lookup_score_multi_compressed",
                "gather_rows", "gather_rows_compressed", "dedup_score",
                "unpack_score", "vertical_score", "chunk_dedup_score")
CHUNK_KERNELS = ("chunk_dedup_score", "chunk_lookup_score_multi",
                 "chunk_lookup_score_multi_compressed")
MAIN_KERNELS = ("unpack_score", "vertical_score", "lookup_score_blocks",
                "lookup_score_grouped", "lookup_score")
DEDUP_KERNELS = ("gather_rows", "gather_rows_compressed", "dedup_score")
# the wrappers [long] holds at 70,144 terms, each in one launch
LONG_WRAPPERS = ("lookup_score_blocks_compressed",
                 "lookup_score_multi_compressed", "chunk_lookup_score_multi",
                 "chunk_lookup_score_multi_compressed", "chunk_dedup_score",
                 "dedup_score")
# where a split can go wrong: word tiles, term slices, clusters, cells (W 4
# is the rowdict store's width, its running counts padded to Wp = 8; L 32
# the pruned path's chunk, 1,025 one term past the first index stage)
SPLIT_WORDS = (1, 3, 4, 8, 31, 32, 33, 64, 130, 384)
SPLIT_TERMS = (1, 7, 32, 63, 64, 65, 320, 1000, 1025)
SPLIT_CELLS = (1, 2, 64, 200)
LONG_TERMS = (65_535, 65_536, 70_144)
CLUSTERS = (1, 2, 4, 8)
LONG_BP = 70_100        # a query of 70,144 padded terms
# at W = 32 (8 slices a block) one block of this many terms flushes its
# counter planes: a slice passes 65,535 terms
FLUSH_TERMS = 8 * 65_535 + 1000
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
    ptxas, kernel = {}, "?"
    for line in report.splitlines():
        if "Compiling entry function" in line:
            # the mangled name holds the kernel's: ...<len><name>E<args>,
            # a template's ...<len><name>ILi<vec>EE... (gather_kernel<4>)
            m = re.search(r"\d+([A-Za-z_]+_kernel)(?:ILi(\d+)EE)?E", line)
            kernel = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                      if m else line.strip())
        elif "Used" in line or "spill" in line:
            ptxas.setdefault(kernel, []).append(
                line.split(":", 1)[-1].strip())
    for kernel, lines in ptxas.items():
        log(f"[build] ptxas {kernel}: {'; '.join(lines)}")
    return {"seconds": secs, "library": path.name, "ptxas": ptxas}


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
    check_split_kernels(rt, torch, chk, words, g)
    log(f"[kernels] every kernel equals its plain version: max_abs_err "
        f"{chk.err}")


# the dense read batch of the benchmark's cell: 32 reads of 150 bp (120
# terms) over 34 blocks of 1,024 documents, 34,134 of them live
SELECT_Q, SELECT_DOCS, SELECT_SLOTS, SELECT_TERMS = 32, 34_134, 34 * 1024, 120


def phase_select(rt, torch) -> dict:
    """[select]: ``select_scores`` against ``select_plain`` at the dense
    read batch's shape with the server's ``SELECT_CAP``: scores in slot
    order drawn like a read's (binomial(120, 0.3) for a document without
    the read, one document a query at 112-120), threshold 0.8 (about one
    hit a query), then threshold 0.25 (most documents: every list over
    the cap). Equal bit for bit, the kernel's launches equal to its calls.
    Times: the kernel (CUDA events over a graph of 64 launches); its byte
    bound (doc_slot and the live rows' scores read once, the lists written
    once, at 3.35 TB/s); the lists' copy into pinned memory (events over
    16 copies), and launch, copy and sync on the host's clock, as the
    server makes them; ``select_plain`` on the card (events around one
    call); ``index_select`` + ``>=`` + ``nonzero`` as the
    library's nearest calls (the port does not call them; ``nonzero``
    syncs, so events over 8 calls, not a graph), and with its copy of the
    hit indices to the host."""
    k, cap = rt.kernels, rt.server_mod.SELECT_CAP
    g = torch.Generator(device=DEV).manual_seed(SEED)
    shape = (SELECT_Q, SELECT_SLOTS)
    scores = torch.binomial(
        torch.full(shape, float(SELECT_TERMS), device=DEV),
        torch.full(shape, 0.3, device=DEV), generator=g).to(torch.int32)
    perm = torch.randperm(SELECT_SLOTS, generator=g, device=DEV)
    doc_slot = perm[:SELECT_DOCS].to(torch.int32).contiguous()
    src = torch.randint(0, SELECT_DOCS, (SELECT_Q,), generator=g,
                        device=DEV)
    scores[torch.arange(SELECT_Q, device=DEV), doc_slot[src].long()] = \
        torch.randint(112, SELECT_TERMS + 1, (SELECT_Q,), generator=g,
                      device=DEV, dtype=torch.int32)
    out = {"shape": [SELECT_Q, SELECT_SLOTS], "docs": SELECT_DOCS,
           "cap": cap}
    for name, thr in (("reads", 0.8), ("overflow", 0.25)):
        cut = torch.full((SELECT_Q,), rt.query.coverage_cutoff(
            thr, SELECT_TERMS), dtype=torch.int32, device=DEV)
        before = k.launches["select_scores"]
        got = k.select_scores(scores, doc_slot, cut, cap)
        check(k.launches["select_scores"] == before + 1,
              "select_scores launched once a call")
        want = k.select_plain(scores, doc_slot, cut, cap)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"select_scores != select_plain ({name})")
        counts = got[:, 0]
        if name == "reads":
            check(bool((counts >= 1).all()) and int(counts.max()) <= cap,
                  "every read finds its document, within the cap")
        else:
            check(bool((counts > cap).all()), "every list over the cap")
        out[f"hits_{name}"] = [int(counts.min()), int(counts.max())]
    cut = torch.full((SELECT_Q,), rt.query.coverage_cutoff(
        0.8, SELECT_TERMS), dtype=torch.int32, device=DEV)
    lists = k.select_scores(scores, doc_slot, cut, cap)
    pinned = torch.empty(lists.shape, dtype=torch.int32, pin_memory=True)
    slot_long = doc_slot.long()

    def library():
        docs = torch.index_select(scores, 1, slot_long)
        return torch.nonzero(docs >= cut[:, None])

    with on_side_stream(torch):
        kernel_us = 1e3 * graph_ms(torch, [lambda: k.select_scores(
            scores, doc_slot, cut, cap, range_checked=True)])
        library_us = 1e3 * loop_ms(torch, [library] * 8)
        copy_us = 1e3 * loop_ms(torch, [lambda: pinned.copy_(
            lists, non_blocking=True)] * 16)
    plain_us = 1e3 * event_ms(
        torch, lambda: k.select_plain(scores, doc_slot, cut, cap), 5)
    # the library's hit list reaches the host only through a sync'd copy
    t0 = time.perf_counter()
    for _ in range(64):
        library().cpu()
    library_host_us = 1e6 * (time.perf_counter() - t0) / 64
    t0 = time.perf_counter()
    for _ in range(64):
        got = k.select_scores(scores, doc_slot, cut, cap, range_checked=True)
        pinned.copy_(got, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    server_host_us = 1e6 * (time.perf_counter() - t0) / 64
    bound_us = 1e6 * (4 * SELECT_DOCS + 4 * SELECT_Q * SELECT_DOCS
                      + lists.numel() * 4) / HBM_BYTES_PER_S
    out.update(kernel_us=kernel_us, bound_us=bound_us, copy_us=copy_us,
               plain_us=plain_us, library_us=library_us,
               library_host_us=library_host_us,
               server_host_us=server_host_us, list_bytes=lists.numel() * 4)
    log(f"[select] [{SELECT_Q}, {SELECT_SLOTS}] of {SELECT_DOCS} docs, cap "
        f"{cap}: equal to select_plain (hits {out['hits_reads']}, over the "
        f"cap {out['hits_overflow']}); kernel {kernel_us:.2f} us (bound "
        f"{bound_us:.3f} us), lists' copy ({lists.numel() * 4} B, pinned) "
        f"{copy_us:.2f} us, launch + copy + sync on the host "
        f"{server_host_us:.1f} us; plain {plain_us:.1f} us; library "
        f"index_select + >= + nonzero {library_us:.2f} us, with its copy "
        f"to the host {library_host_us:.1f} us")
    return out


# [grouped]: the paged cell's resident tiles (23 of 34 blocks of W = 32
# words, each its own tile) and the dense cell's one arena (34 blocks at
# their row offsets in one tile, its 356,782,080 rows scaled down to
# GROUPED_DENSE_ROWS), at a read batch of the served bucket (a read of 150
# bases is 120 31-mers, a multiple of the batcher's quantum of 8)
GROUPED_BLOCKS, GROUPED_ALL, GROUPED_ROWS = 23, 34, 1 << 20
GROUPED_Q, GROUPED_L, GROUPED_W = 32, 120, 32
GROUPED_DENSE_ROWS = 1 << 23


def dense_blocks(g, torch, n_blocks: int, total: int):
    """A dense arena's block layout of ``n_blocks`` blocks over about
    ``total`` rows: widths that grow along the arena (as blocks of
    documents sorted by size do, by a factor of about 8 end to end), each
    block at the row where the one before ends, so every offset but the
    first is nonzero. Returns (row_offset, block_width), int64 numpy."""
    ramp = np.geomspace(1.0, 8.0, n_blocks)
    jitter = 1.0 + 0.1 * torch.rand(n_blocks, generator=g).numpy()
    width = np.maximum(1, (ramp * jitter * total
                           / (ramp * jitter).sum()).astype(np.int64))
    return np.concatenate([[0], np.cumsum(width)[:-1]]), width


def phase_grouped(rt, torch) -> dict:
    """[grouped]: ``lookup_score_grouped`` (``grouped::lookup_kernel``)
    against the per-shard fused lookup (``lookup_score_multi``, the
    indexed ``lookup_kernel``, on rows planned from ``hash_terms``) and
    its plain version (``query.lookup_grouped_plain``), bit for bit: the
    paged case, GROUPED_BLOCKS and GROUPED_ALL blocks, each a tile of its
    own allocation of about GROUPED_ROWS rows; and the dense case, one
    arena tile of GROUPED_DENSE_ROWS rows holding GROUPED_ALL blocks at
    their row offsets (``dense_blocks``), as the dense store's one shard
    is; each for 1 and GROUPED_Q reads of GROUPED_L terms (n_valid of 0,
    some and all of L). Times at 23 paged blocks: the kernel (a CUDA graph
    of 64 launches) and its byte bound (the terms read once, one row a
    live (query, block, term), the counts written once, at 3.35 TB/s); the
    23 per-shard lookups of one batch on precomputed rows (a graph of 23
    launches: the kernels the grouped launch replaces); the plain version
    (events around one call); and, on the host's clock and synchronised, a
    batch through the engine's per-shard score function and through its
    grouped form (``query.grouped_lookup``, its table kept), at Q = 32 and
    at one request."""
    k, q_mod = rt.kernels, rt.query
    g = torch.Generator().manual_seed(SEED)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32)

    W, L = GROUPED_W, GROUPED_L
    tiles, plans = [], []
    for b in range(GROUPED_ALL):
        R = GROUPED_ROWS - int(ints(0, 4096, 1))
        tiles.append(ints(-2 ** 31, 2 ** 31, R, W).to(DEV))
        plans.append(q_mod.ShardPlan(b, b, b + 1, np.zeros(1, np.int32),
                                     np.array([R], np.int32)))
    terms = ints(-2 ** 31, 2 ** 31, GROUPED_Q, L, 2).to(DEV)
    n_valid = ints(L - 20, L + 1, GROUPED_Q)
    n_valid[1], n_valid[2] = 0, 7
    n_valid = n_valid.to(DEV)
    h = rt.hashing.hash_terms(terms, 1)
    mask = (torch.arange(L, device=DEV)[None, :] < n_valid[:, None]).to(
        torch.int32)[:, None, :].contiguous()

    def planned(off, width):
        return q_mod.plan_rows(
            h, torch.tensor([int(off)], dtype=torch.int32, device=DEV),
            torch.tensor([int(width)], dtype=torch.int32, device=DEV))[
            :, :, 0, 0][:, None, :].contiguous()

    def held(what, table, tiles_, idx_of):
        """The table's launch against the per-shard lookup of each of its
        blocks and against the plain version, at Q = 1 and GROUPED_Q."""
        nb = table.n_blocks
        for Q in (1, GROUPED_Q):
            got = torch.full((Q, nb, W, 32), -1, dtype=torch.int32,
                             device=DEV)
            before = k.launches["lookup_score_grouped"]
            k.lookup_score_grouped(table, tiles_, terms[:Q], n_valid[:Q],
                                   got)
            check(k.launches["lookup_score_grouped"] == before + 1,
                  "lookup_score_grouped launched once a call")
            for e in range(len(table)):
                want = k.lookup_score_multi(
                    tiles_[int(table.tile_of[e])], idx_of(e)[:Q], mask[:Q])
                check(torch.equal(got[:, int(table.slot[e])], want[:, 0]),
                      f"[grouped] {what}: block {e} of {nb}, Q = {Q} != "
                      f"the per-shard lookup")
            plain = torch.full_like(got, -1)
            q_mod.lookup_grouped_plain(table, tiles_, terms[:Q],
                                       n_valid[:Q], plain)
            check(torch.equal(plain, got),
                  f"[grouped] {what}: {nb} blocks, Q = {Q} != "
                  "lookup_grouped_plain")

    idx = [planned(0, t.shape[0]) for t in tiles]
    out = {"shape": f"terms [{GROUPED_Q}, {L}, 2], {GROUPED_BLOCKS} blocks "
                    f"of W = {W}, tiles of ~{GROUPED_ROWS} rows"}
    for nb in (GROUPED_BLOCKS, GROUPED_ALL):
        slots = torch.randperm(nb, generator=g).tolist()
        table = k.BlockTable(tiles[:nb], np.zeros(nb), [t.shape[0] for t in
                                                        tiles[:nb]],
                             slots, nb)
        held(f"paged, {nb} tiles", table, tiles[:nb], lambda e: idx[e])
    # the dense store: one arena tile, its blocks at their row offsets
    offs, wids = dense_blocks(g, torch, GROUPED_ALL, GROUPED_DENSE_ROWS)
    arena = ints(-2 ** 31, 2 ** 31, int(offs[-1] + wids[-1]), W).to(DEV)
    dense = k.BlockTable([arena], offs, wids, np.arange(GROUPED_ALL),
                         GROUPED_ALL, tile_of=np.zeros(GROUPED_ALL))
    dense_idx = [planned(o, w) for o, w in zip(offs, wids)]
    held("dense, one arena", dense, [arena], lambda e: dense_idx[e])
    out["dense_shape"] = (f"one arena of {arena.shape[0]} rows, "
                          f"{GROUPED_ALL} blocks at offsets up to "
                          f"{int(offs[-1])}")
    del arena, dense, dense_idx
    nb = GROUPED_BLOCKS
    table = k.BlockTable(tiles[:nb], np.zeros(nb),
                         [t.shape[0] for t in tiles[:nb]], list(range(nb)),
                         nb)
    res = torch.empty((GROUPED_Q, nb, W, 32), dtype=torch.int32, device=DEV)
    lib = rt.build.library()
    dev, stream = torch.cuda.current_device(), None
    outs = [torch.empty((GROUPED_Q, 1, W, 32), dtype=torch.int32,
                        device=DEV) for _ in range(nb)]
    with on_side_stream(torch):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_us = 1e3 * graph_ms(torch, [lambda: k.lookup_score_grouped(
            table, tiles[:nb], terms, n_valid, res)])
        chain = [(lambda b=b: lib.cobs_lookup(
            tiles[b].data_ptr(), idx[b].data_ptr(), mask.data_ptr(),
            outs[b].data_ptr(), GROUPED_Q, L, W, k.CLUSTER_AUTO, dev,
            stream)) for b in range(nb)]
        per_shard_us = 1e3 * nb * graph_ms(torch, chain, n=nb * 3)
    plain_us = 1e3 * event_ms(
        torch, lambda: q_mod.lookup_grouped_plain(table, tiles[:nb], terms,
                                                  n_valid, res), 3)
    live = int(n_valid.sum())
    nbytes = (terms.numel() * 4 + n_valid.numel() * 4
              + live * nb * W * 4 + res.numel() * 4)
    bound_us = 1e6 * nbytes / HBM_BYTES_PER_S
    # the host's side of one batch: the per-shard score function over the
    # 23 tiles (hash, plan, range check, launch a tile, the parts' cat)
    # against the grouped form (its table kept), each synchronised
    addr = [(torch.zeros(1, dtype=torch.int32, device=DEV),
             torch.tensor([t.shape[0]], dtype=torch.int32, device=DEV))
            for t in tiles[:nb]]
    host_us = {}
    for form, Q in (("batch", GROUPED_Q), ("single", 1)):
        fn = (q_mod.make_batch_score_fn(1, "lookup") if form == "batch"
              else q_mod.make_score_fn(1, "lookup"))
        t_in = terms if form == "batch" else terms[0]
        nv = n_valid if form == "batch" else int(n_valid[0])
        runs = {
            "per_shard": lambda: torch.cat(
                [fn(t, *a, t_in, nv) for t, a in zip(tiles[:nb], addr)],
                dim=-1),
            "grouped": lambda: q_mod.grouped_lookup(table, tiles[:nb],
                                                    t_in, nv)}
        check(torch.equal(runs["per_shard"](), runs["grouped"]()),
              f"[grouped] the {form} form's grouped scores != per shard")
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(64):
                run()
            torch.cuda.synchronize()
            host_us[f"{form}_{name}"] = 1e6 * (time.perf_counter() - t0) / 64
    out.update(kernel_us=kernel_us, per_shard_kernels_us=per_shard_us,
               plain_us=plain_us, bound_us=bound_us, bytes=nbytes,
               host_us=host_us)
    log(f"[grouped] {out['shape']}; {out['dense_shape']}: equal to the "
        f"per-shard lookup and the plain version at {GROUPED_BLOCKS} and "
        f"{GROUPED_ALL} tiles and the dense arena, Q = 1 and {GROUPED_Q}; "
        f"kernel {kernel_us:.2f} us (a graph of 64 "
        f"launches; bound {bound_us:.3f} us, {nbytes} bytes), the "
        f"{nb} per-shard lookups it replaces {per_shard_us:.2f} us; plain "
        f"{plain_us:.1f} us; a batch on the host's clock: " + ", ".join(
            f"{n} {v:.1f} us" for n, v in host_us.items()))
    del tiles, res, outs
    torch.cuda.empty_cache()
    return out


def check_grouped_calls(rt, torch, chk, calls: list, what: str,
                        n: int = 4) -> None:
    """The first ``n`` recorded ``lookup_score_grouped`` calls of a path
    (at least one) launched again and held against the plain version on
    the same table, tiles, terms and n_valid (the arguments hold the
    tiles the table points at)."""
    check(len(calls) > 0, f"[{what}] recorded no lookup_score_grouped call")
    for table, tiles, terms, n_valid, out in calls[:n]:
        got = torch.full_like(out, -1)
        rt.kernels.lookup_score_grouped(table, tiles, terms, n_valid, got)
        want = torch.full_like(out, -1)
        rt.query.lookup_grouped_plain(table, tiles, terms, n_valid, want)
        chk.compare("lookup_score_grouped", got, want,
                    f"{what}, terms {list(terms.shape)}, {len(table)} "
                    f"blocks over {len(tiles)} tiles")


def unpack_rows_plain(k, rows):
    """``unpack_score_plain`` of rows [..., L, W] in slabs of rows that
    keep its 32-way expansion under 2^28 elements: the vectorised plain
    count, for L where the ripple loop's plain version is too slow."""
    slab = max(1, (1 << 28) // max(1, rows[..., :1, :].numel() * 32))
    out = None
    for a in range(0, max(rows.shape[-2], 1), slab):
        part = k.unpack_score_plain(rows[..., a:a + slab, :])
        out = part if out is None else out + part
    return out


def masked_rows(rows, idx, mask):
    """The rows a fused lookup counts: rows[idx], zero where mask is 0."""
    return rows[idx.long()] * (mask[..., None] != 0).to(rows.dtype)


def split_dims(kernel, inputs) -> tuple[int, int, int, int]:
    """(cells, L, W, Wp) of split kernel ``kernel``'s inputs, as
    split_direct takes them."""
    if kernel in ("vertical", "unpack"):
        cells, L, W = inputs[0].shape
        return cells, L, W, W
    chunk = kernel.startswith("chunk_")
    idx = inputs[-3 if chunk else -2]
    L, W = idx.shape[-1], inputs[0].shape[1]
    Wp = inputs[-1].shape[2] if chunk else W
    return idx.numel() // max(L, 1), L, W, Wp


def split_direct(torch, rt, kernel, cs, *inputs):
    """One direct launch of split kernel ``kernel`` (one of
    ``_build.SPLIT_KERNELS``) through its own entry point at cluster size
    ``cs`` on its inputs: vertical or unpack (rows [B, L, W]), lookup
    (arena, idx, mask), dedup (uniq, indir, mask), lookup_comp (dict, refs,
    idx, mask), chunk_lookup or chunk_dedup (rows, idx, mask, acc) or
    chunk_lookup_comp (dict, refs, idx, mask, acc); returns its output.
    Not counted in ``launches``."""
    cells, L, W, Wp = split_dims(kernel, inputs)
    if kernel.startswith("chunk_"):
        out = torch.empty_like(inputs[-1])
        dims = (cells, L, W, Wp)
    else:
        lead = ((cells,) if kernel in ("vertical", "unpack")
                else inputs[-2].shape[:-1])
        out = torch.empty(lead + (W, 32), dtype=torch.int32, device=DEV)
        dims = (cells, L, W)
    rt.build.launch(rt.build.SPLIT_KERNELS[kernel],
                    *(t.data_ptr() for t in inputs),
                    out.data_ptr(), *dims, cs, torch.cuda.current_device(),
                    torch.cuda.current_stream().cuda_stream)
    return out


def check_split_kernels(rt, torch, chk, words, g) -> None:
    """The split kernels' wrappers (vertical_score, the three fused
    lookups, the two fused-decode lookups, the three chunk wrappers,
    dedup_score, unpack_score) where a split can go wrong: every word tiling of
    SPLIT_WORDS (running counts padded past W as the executors pad them),
    term count of SPLIT_TERMS and cell count of SPLIT_CELLS with masks
    holding zeros (and one mask of 3, which counts), each cluster size at a
    few of them, the long L of LONG_TERMS against the plain unpack of the
    gathered rows (one launch each), and one slice of more than 65,535
    terms (the flush of full counter planes)."""
    k = rt.kernels
    compare = chk.compare
    t0 = time.perf_counter()
    n = 0
    for W in SPLIT_WORDS:
        arena = words(512, W)
        dict_rows, refs = words(40, W), torch.randint(
            0, 40, (512,), generator=g, dtype=torch.int32).to(DEV)
        for L in SPLIT_TERMS:
            for cells in SPLIT_CELLS:
                idx = torch.randint(0, 512, (cells, L), generator=g,
                                    dtype=torch.int32).to(DEV)
                mask = (torch.rand((cells, L), generator=g) < 0.8).to(
                    torch.int32).to(DEV)
                mask[0, 0] = 0
                mask[-1, -1] = 3
                rows = words(cells, L, W)
                acc = rt.ops.chunk_acc_init(cells, 1, W, device=DEV)
                acc += torch.randint(0, 50, acc.shape, generator=g,
                                     dtype=torch.int32).to(DEV)
                what = (f"split W={W} L={L} cells={cells} "
                        f"Wp={acc.shape[2]}")
                want_v = k.vertical_score_plain(rows)
                want_u = unpack_rows_plain(k, rows)
                want = k.lookup_plain(arena, idx, mask)
                want_c = k.lookup_comp_plain(dict_rows, refs, idx, mask)
                want_k = k.chunk_plain(arena, idx[:, None], mask[:, None],
                                       acc)
                want_kc = k.chunk_plain(dict_rows, idx[:, None],
                                        mask[:, None], acc, refs)
                if cells == 1:
                    compare("vertical_score", k.vertical_score(rows[0]),
                            want_v[0], what)
                    compare("unpack_score", k.unpack_score(rows[0]),
                            want_u[0], what)
                    compare("lookup_score",
                            k.lookup_score(arena, idx[0], mask[0]), want[0],
                            what)
                compare("vertical_score", k.vertical_score(rows), want_v,
                        what)
                compare("unpack_score", k.unpack_score(rows), want_u, what)
                compare("lookup_score_blocks",
                        k.lookup_score_blocks(arena, idx, mask), want, what)
                compare("lookup_score_blocks_compressed",
                        k.lookup_score_blocks_compressed(dict_rows, refs, idx,
                                                         mask), want_c, what)
                q = 2 if cells % 2 == 0 else 1
                compare("lookup_score_multi", k.lookup_score_multi(
                    arena, idx.reshape(cells // q, q, L),
                    mask.reshape(cells // q, q, L)),
                    want.reshape(cells // q, q, W, 32), what)
                compare("lookup_score_multi_compressed",
                        k.lookup_score_multi_compressed(
                            dict_rows, refs, idx.reshape(cells // q, q, L),
                            mask.reshape(cells // q, q, L)),
                        want_c.reshape(cells // q, q, W, 32), what)
                compare("chunk_dedup_score", k.chunk_dedup_score(
                    arena, idx[:, None], mask[:, None], acc), want_k, what)
                compare("chunk_lookup_score_multi",
                        k.chunk_lookup_score_multi(
                            arena, idx[:, None], mask[:, None], acc), want_k,
                        what)
                compare("chunk_lookup_score_multi_compressed",
                        k.chunk_lookup_score_multi_compressed(
                            dict_rows, refs, idx[:, None], mask[:, None],
                            acc), want_kc, what)
                # the arena as the unique-row matrix, idx as indir
                compare("dedup_score", k.dedup_score(
                    arena, idx.reshape(cells // q, q, L),
                    mask.reshape(cells // q, q, L)),
                    want.reshape(cells // q, q, W, 32), what)
                n += 1
                if W in (1, 4, 8, 33, 130) and L in (63, 320, 1000, 1025) \
                        and cells <= 2:
                    for cs in CLUSTERS:
                        wc = f"{what} cluster {cs}"
                        compare("vertical_score", split_direct(
                            torch, rt, "vertical", cs, rows), want_v, wc)
                        compare("lookup_score_blocks", split_direct(
                            torch, rt, "lookup", cs, arena, idx, mask), want,
                            wc)
                        compare("lookup_score_blocks_compressed",
                                split_direct(torch, rt, "lookup_comp", cs,
                                             dict_rows, refs, idx, mask),
                                want_c, wc)
                        compare("chunk_dedup_score", split_direct(
                            torch, rt, "chunk_dedup", cs, arena, idx, mask,
                            acc), want_k, wc)
                        compare("chunk_lookup_score_multi", split_direct(
                            torch, rt, "chunk_lookup", cs, arena, idx, mask,
                            acc), want_k, wc)
                        compare("chunk_lookup_score_multi_compressed",
                                split_direct(torch, rt, "chunk_lookup_comp",
                                             cs, dict_rows, refs, idx, mask,
                                             acc), want_kc, wc)
                        compare("dedup_score", split_direct(
                            torch, rt, "dedup", cs, arena, idx, mask), want,
                            wc)
                        compare("unpack_score", split_direct(
                            torch, rt, "unpack", cs, rows), want_u, wc)
    log(f"[kernels:split] {n} (W, L, cells) shapes and the cluster sizes "
        f"{CLUSTERS} equal the plain versions (vertical, lookup, "
        f"lookup_comp, chunk_lookup, chunk_lookup_comp, chunk_dedup, dedup, "
        f"unpack) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for L in LONG_TERMS:
        for W, cells in ((1, 1), (4, 2), (8, 2), (33, 2)):
            arena = words(4096, W)
            idx = torch.randint(0, 4096, (cells, L), generator=g,
                                dtype=torch.int32).to(DEV)
            mask = (torch.rand((cells, L), generator=g) < 0.9).to(
                torch.int32).to(DEV)
            mask[0] = 1                       # cell 0 counts every term
            arena[:, 0] |= 1                  # ... in document 0
            # a rowdict pair whose rows all hold document 0 too
            dict_rows, refs = words(300, W), torch.randint(
                0, 300, (4096,), generator=g, dtype=torch.int32).to(DEV)
            dict_rows[:, 0] |= 1
            rows = words(cells, L, W)
            acc = rt.ops.chunk_acc_init(cells, 1, W, device=DEV)
            acc += torch.randint(0, 1000, acc.shape, generator=g,
                                 dtype=torch.int32).to(DEV)
            want_v = unpack_rows_plain(k, rows)
            want = unpack_rows_plain(k, masked_rows(arena, idx, mask))
            want_c = unpack_rows_plain(k, masked_rows(
                dict_rows[refs.long()], idx, mask))
            want_k, want_kc = acc.clone(), acc.clone()
            want_k[:, 0, :W] += want
            want_kc[:, 0, :W] += want_c
            what = f"long W={W} L={L} cells={cells}"
            check(L < 65_536 or int(want.max()) > 65_535,
                  f"{what}: no count needs a 17th plane")
            check(L < 65_536 or int(want_c.max()) > 65_535,
                  f"{what}: no decoded count needs a 17th plane")
            compare("vertical_score", k.vertical_score(rows), want_v, what)
            compare("lookup_score_blocks",
                    k.lookup_score_blocks(arena, idx, mask), want, what)
            compare("lookup_score_multi",
                    k.lookup_score_multi(arena, idx[None], mask[None]),
                    want[None], what)
            compare("lookup_score_blocks_compressed",
                    k.lookup_score_blocks_compressed(dict_rows, refs, idx,
                                                     mask), want_c, what)
            compare("lookup_score_multi_compressed",
                    k.lookup_score_multi_compressed(dict_rows, refs,
                                                    idx[None], mask[None]),
                    want_c[None], what)
            before = dict(k.launches)
            compare("chunk_dedup_score", k.chunk_dedup_score(
                arena, idx[:, None], mask[:, None], acc), want_k, what)
            compare("chunk_lookup_score_multi", k.chunk_lookup_score_multi(
                arena, idx[:, None], mask[:, None], acc), want_k, what)
            compare("chunk_lookup_score_multi_compressed",
                    k.chunk_lookup_score_multi_compressed(
                        dict_rows, refs, idx[:, None], mask[:, None], acc),
                    want_kc, what)
            compare("dedup_score", k.dedup_score(arena, idx[None],
                                                 mask[None]),
                    want[None], what)
            compare("unpack_score", k.unpack_score(rows), want_v, what)
            if cells == 1:
                compare("unpack_score", k.unpack_score(rows[0]), want_v[0],
                        what)
            once = {n: k.launches[n] - before[n]
                    for n in ("chunk_dedup_score", "chunk_lookup_score_multi",
                              "chunk_lookup_score_multi_compressed",
                              "dedup_score", "unpack_score")}
            check(once == {"chunk_dedup_score": 1,
                           "chunk_lookup_score_multi": 1,
                           "chunk_lookup_score_multi_compressed": 1,
                           "dedup_score": 1,
                           "unpack_score": 2 if cells == 1 else 1},
                  f"{what}: the chunk, dedup and unpack wrappers launched "
                  f"{once}, not once a call")
            if cells == 1:
                compare("lookup_score", k.lookup_score(arena, idx[0],
                                                       mask[0]),
                        want[0], what)
                compare("vertical_score", k.vertical_score(rows[0]),
                        want_v[0], what)
    # a slice of more than 65,535 terms: one block (cluster 1) of
    # FLUSH_TERMS terms at W = 32 (8 slices) flushes its planes
    L, W = FLUSH_TERMS, 32
    arena = words(4096, W)
    dict_rows, refs = words(300, W), torch.randint(
        0, 300, (4096,), generator=g, dtype=torch.int32).to(DEV)
    idx = torch.randint(0, 4096, (1, L), generator=g,
                        dtype=torch.int32).to(DEV)
    mask = torch.ones((1, L), dtype=torch.int32, device=DEV)
    rows = words(1, L, W)
    acc = torch.randint(0, 1000, (1, 1, W, 32), generator=g,
                        dtype=torch.int32).to(DEV)
    dev = torch.cuda.current_device()
    for kernel in ("lookup", "lookup_comp", "chunk_lookup",
                   "chunk_lookup_comp", "chunk_dedup", "dedup", "vertical"):
        check(rt.build.split_info(kernel, 1, L, W, 1, dev)["planes"] == 16,
              f"the flush case does not fill 16 counter planes ({kernel})")
    want = unpack_rows_plain(k, masked_rows(arena, idx, mask))
    want_c = unpack_rows_plain(k, masked_rows(dict_rows[refs.long()], idx,
                                              mask))
    for cs in (1, 0):
        what = f"flush W={W} L={L} cluster {cs or 'auto'}"
        compare("lookup_score_blocks", split_direct(
            torch, rt, "lookup", cs, arena, idx, mask), want, what)
        compare("lookup_score_blocks_compressed", split_direct(
            torch, rt, "lookup_comp", cs, dict_rows, refs, idx, mask),
            want_c, what)
        compare("chunk_dedup_score", split_direct(
            torch, rt, "chunk_dedup", cs, arena, idx, mask, acc),
            acc + want[:, None], what)
        compare("chunk_lookup_score_multi", split_direct(
            torch, rt, "chunk_lookup", cs, arena, idx, mask, acc),
            acc + want[:, None], what)
        compare("chunk_lookup_score_multi_compressed", split_direct(
            torch, rt, "chunk_lookup_comp", cs, dict_rows, refs, idx, mask,
            acc), acc + want_c[:, None], what)
        compare("dedup_score", split_direct(
            torch, rt, "dedup", cs, arena, idx, mask), want, what)
        compare("vertical_score", split_direct(torch, rt, "vertical", cs,
                                               rows),
                unpack_rows_plain(k, rows), what)
    log(f"[kernels:long] L {LONG_TERMS} (the chunk, dedup and unpack "
        f"wrappers in one launch) and a slice of {L // 8} terms (flushed) "
        f"equal the plain unpack of the gathered rows (vertical, lookup, "
        f"lookup_comp, chunk_lookup, chunk_lookup_comp, chunk_dedup, dedup, "
        f"unpack) in {time.perf_counter() - t0:.1f} s")


def phase_long_query(rt, torch, chk) -> dict:
    """A query of more than 65,535 terms on the card: an 8-document compact
    index (k = 15, one hash, FPR 0.3) whose first document is a random
    70,100-base sequence, queried with that sequence (70,144 padded terms,
    all counted for document 0: 17 counter planes) through the vertical,
    lookup and unpack engines (search, search_batch beside a short query,
    top_k) and one served request, each equal to ``method="ref"``; then the
    six wrappers of the fused-decode, dedup and chunk kernels at that
    length (LONG_WRAPPERS), each against the plain unpack of its gathered
    rows, in one launch each."""
    k = rt.kernels
    t0 = time.perf_counter()
    corpus = rt.make_corpus(8, k=15, mean_length=400, sigma=1.0, seed=7)
    codes = np.random.default_rng(16).integers(0, 4, size=LONG_BP,
                                               dtype=np.uint8)
    doc_terms = [rt.dna.document_terms([codes], 15)] + corpus.doc_terms[1:]
    index = rt.build_compact(doc_terms, rt.IndexParams(1, 0.3, 15),
                             block_docs=32, row_align=64)
    short, thr = corpus.documents[3][:300], 0.001
    ref = rt.QueryEngine(index, method="ref")
    want = ([ref.search(codes, thr)] + ref.search_batch([short, codes], thr)
            + [ref.top_k(codes, 5)])
    n_terms = int(want[0].n_terms)
    check(n_terms > 65_535 and int(want[-1].doc_ids[0]) == 0
          and int(want[-1].scores[0]) > 65_535,
          f"[long] the query's {n_terms} terms do not pass 16 planes")
    out = {"terms": n_terms, "padded": -(-n_terms // 64) * 64,
           "top_score": int(want[-1].scores[0])}
    k.reset_launches()
    for method in ("vertical", "lookup", "unpack"):
        eng = rt.QueryEngine(index, method=method)
        got = ([eng.search(codes, thr)] + eng.search_batch([short, codes], thr)
               + [eng.top_k(codes, 5)])
        check(same_results(got, want), f"[long] {method} != ref")
    server = rt.QueryServer(index, rt.ServerConfig())
    rid = server.submit(codes, threshold=thr)
    server.drain()
    resp = server.pop_responses()[rid]
    check(resp.status == rt.Status.OK and same_result(resp.result, want[0]),
          "[long] the served request != ref")
    out["engine_launches"] = {n: v for n, v in k.launches.items() if v}
    out["served_method"] = resp.method
    # the six wrappers, L = 70,144: cell 0 counts every term, in document
    # 0 of every row
    g = torch.Generator().manual_seed(16)
    L, W = out["padded"], 4

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(DEV)

    dict_rows, uniq = ints(-2 ** 31, 2 ** 31, 300, W), ints(
        -2 ** 31, 2 ** 31, 5000, W)
    dict_rows[:, 0] |= 1
    uniq[:, 0] |= 1
    refs, idx = ints(0, 300, 5000), ints(0, 5000, 2, 1, L)
    mask = ints(0, 2, 2, 1, L)
    mask[0] = 1
    acc = ints(0, 1000, 2, 1, 8, 32)
    want_c = unpack_rows_plain(k, masked_rows(dict_rows[refs.long()], idx,
                                              mask))
    want_d = unpack_rows_plain(k, masked_rows(uniq, idx, mask))
    want_acc, want_acc_c = acc.clone(), acc.clone()
    want_acc[:, :, :W] += want_d
    want_acc_c[:, :, :W] += want_c
    check(int(want_d.max()) > 65_535, "[long] no count passes 65,535")
    k.reset_launches()
    chk.compare("lookup_score_multi_compressed",
                k.lookup_score_multi_compressed(dict_rows, refs, idx, mask),
                want_c, f"long L={L}")
    chk.compare("lookup_score_blocks_compressed",
                k.lookup_score_blocks_compressed(dict_rows, refs, idx[:, 0],
                                                 mask[:, 0]),
                want_c[:, 0], f"long L={L}")
    chk.compare("dedup_score", k.dedup_score(uniq, idx, mask), want_d,
                f"long L={L}")
    chk.compare("chunk_dedup_score",
                k.chunk_dedup_score(uniq, idx, mask, acc), want_acc,
                f"long L={L}")
    chk.compare("chunk_lookup_score_multi",
                k.chunk_lookup_score_multi(uniq, idx, mask, acc), want_acc,
                f"long L={L}")
    chk.compare("chunk_lookup_score_multi_compressed",
                k.chunk_lookup_score_multi_compressed(dict_rows, refs, idx,
                                                      mask, acc),
                want_acc_c, f"long L={L}")
    once = {n: v for n, v in k.launches.items() if v}
    check(once == {n: 1 for n in LONG_WRAPPERS},
          f"[long] the six wrappers launched {once}, not 1 launch each")
    out["long_launches"] = once
    out["seconds"] = time.perf_counter() - t0
    log(f"[long] a {LONG_BP}-base query ({n_terms} terms, padded to {L}; "
        f"document 0 scores {out['top_score']}): vertical, lookup and "
        f"unpack search, search_batch, top_k and a served request "
        f"({resp.method}) equal ref; launches {out['engine_launches']}; "
        f"the six fused-decode, dedup and chunk wrappers at L={L} equal the "
        f"plain counts, launches {once}; {out['seconds']:.1f} s")
    return out


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


def phase_main_path(rt, torch, corpus, index, chk):
    """The main path, launch counters from 0: every method on the compact
    index, then the classic and two-hash indexes; the first grouped
    lookups held against their plain version. Returns the record, the
    queries, their origin documents and the classic index."""
    k = rt.kernels
    t0 = time.perf_counter()
    # the serving traffic mix of the CLI: exactly N_QUERIES of lengths
    # 40/80/160/320 bp, half true positives and half verified negatives
    queries, origin = rt.make_workload(corpus, N_QUERIES)
    origin = [int(o) for o in origin]
    log(f"[workload] {len(queries)} queries "
        f"({sum(o >= 0 for o in origin)} positive) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"methods": {}}
    k.reset_launches()
    base = None
    grouped = ChunkRecorder(k, ("lookup_score_grouped",), keep=4)
    for method in METHODS:
        before = dict(k.launches)
        with grouped:
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
    want = {"lookup": ("lookup_score_blocks", "lookup_score_grouped"),
            "vertical": ("vertical_score",), "unpack": ("unpack_score",)}
    for method, names in want.items():
        for name in names:
            check(out["methods"][method]["launches"][name] > 0,
                  f"{method} phase launched no {name}")
    check_grouped_calls(rt, torch, chk, grouped.calls["lookup_score_grouped"],
                        "main")

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
# Multi-index querying and the mesh-sharded index
# --------------------------------------------------------------------------

def merged_hits(rt, engines: dict, pattern, threshold: float) -> list:
    """The merge MultiIndexEngine makes of its engines' results: hits
    ranked by score over the query's term count, ties by (dataset,
    doc_id)."""
    hits = []
    for name, engine in engines.items():
        r = engine.search(pattern, threshold)
        hits.extend(rt.MultiHit(name, int(d), int(s), r.n_terms)
                    for d, s in zip(r.doc_ids, r.scores))
    hits.sort(key=lambda h: (-h.score / max(h.n_terms, 1), h.dataset,
                             h.doc_id))
    return hits


def phase_multi(rt, torch, index, classic, queries, origin) -> dict:
    """MultiIndexEngine (vertical, on the card) over the main index and the
    classic k=1 index, its launch counters from 0: every query's merged
    hits must equal the merge of the two datasets' plain (``ref``)
    engines, each positive find its origin in the main dataset, and each
    search launch vertical_score once a dataset."""
    k = rt.kernels
    t0 = time.perf_counter()
    datasets = {"main": index, "classic": classic}
    multi = rt.MultiIndexEngine()
    for name, idx in datasets.items():
        multi.attach(name, idx)
    plain = {name: rt.QueryEngine(idx, method="ref")
             for name, idx in datasets.items()}
    multi.search(queries[0], THRESHOLD)              # first-use costs
    k.reset_launches()                     # the multi-index path starts here
    lat, results = [], []
    for q in queries:
        t = time.perf_counter()
        results.append(multi.search(q, THRESHOLD))
        lat.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    launches = dict(k.launches)            # the multi-index path ends here
    check(launches["vertical_score"] == len(datasets) * len(queries)
          and sum(launches.values()) == launches["vertical_score"],
          f"[multi] {len(queries)} searches over {len(datasets)} datasets "
          f"launched {launches}")
    for i, (q, hits) in enumerate(zip(queries, results)):
        check(hits == merged_hits(rt, plain, q, THRESHOLD),
              f"[multi] query {i}: hits differ from the plain engines' "
              "merge")
        if origin[i] >= 0:
            check(("main", origin[i]) in {(h.dataset, h.doc_id)
                                          for h in hits},
                  f"[multi] query {i} missed its origin {origin[i]}")
    sub = multi.search(queries[0], THRESHOLD, datasets=("classic",))
    check(sub == merged_hits(rt, {"classic": plain["classic"]}, queries[0],
                             THRESHOLD), "[multi] a subset search differs")
    out = {"datasets": list(datasets), "queries": len(queries),
           "hits": sum(map(len, results)),
           "p50_search_ms": pct_ms(lat, 50),
           "p99_search_ms": pct_ms(lat, 99),
           "launches": {n: c for n, c in launches.items() if c},
           "seconds": time.perf_counter() - t0}
    log(f"[multi] {len(queries)} queries over {list(datasets)}: "
        f"{out['hits']} merged hits, each list equal to the plain engines' "
        f"merge, every positive found; search p50 "
        f"{out['p50_search_ms']:.3f} / p99 {out['p99_search_ms']:.3f} ms; "
        f"launches {out['launches']}; {out['seconds']:.1f} s")
    return out


DIST_SHAPE = (2, 2, 2)
DIST_AXES = ("pod", "data", "model")
DIST_METHODS = ("vertical", "lookup")
DIST_KERNELS = ("vertical_score", "lookup_score_multi")
DIST_TOPK, DIST_SCORE_QUERIES, DIST_REPS = 32, 16, 8


def dist_plain_merge(dist, scores, topk: int):
    """The distributed top-k on the host, ``jax.lax.top_k``'s order (the
    lower index first among ties): scores [Q, n_docs] in document order
    -> each doc shard's top-k, gathered in doc-rank order, cut again ->
    (values [Q, t], padded slots [Q, t])."""
    nb, spb, wl = dist.n_blocks, dist.slots_per_block, dist.words_local
    slot_scores = np.zeros((scores.shape[0], nb * spb), dtype=np.int64)
    slot_scores[:, dist._padded_doc_slot] = scores
    vals, slots = [], []
    for d in range(dist.n_doc_shards):
        gslot = (np.arange(nb)[:, None] * spb + d * wl * 32
                 + np.arange(wl * 32)[None, :]).reshape(-1)
        local = slot_scores[:, gslot]
        cut = np.argsort(-local, axis=1, kind="stable")[:, :topk]
        vals.append(np.take_along_axis(local, cut, 1))
        slots.append(gslot[cut])
    vals, slots = np.concatenate(vals, 1), np.concatenate(slots, 1)
    best = np.argsort(-vals, axis=1, kind="stable")[:, :topk]
    return (np.take_along_axis(vals, best, 1),
            np.take_along_axis(slots, best, 1))


def phase_dist(rt, torch, index, queries, origin, chk) -> dict:
    """DistributedIndex over the main index on a DIST_SHAPE mesh of the one
    card (documents over pod x data, rows over model: 8 slices), its
    launch counters from 0: ``scores_for`` of DIST_SCORE_QUERIES queries
    equal to the plain engine's ``score_terms`` and ``search_batch``
    (top DIST_TOPK) of the whole mix equal to a plain merge of the plain
    engine's scores, every positive found, for each method; the batch's
    p50 over DIST_REPS passes and the card's busy share of one profiled
    pass. Every kernel call equals its plain version on the card."""
    k = rt.kernels
    t_phase = time.perf_counter()
    ref = rt.QueryEngine(index, method="ref")
    mesh = rt.make_mesh(DIST_SHAPE, DIST_AXES)
    term_sets = [rt.query.compile_pattern(q, index.params) for q in queries]
    buf, ells = rt.query.pad_term_batch(term_sets, 64)
    plain_scores = ref.score_terms_batch(buf, ells)          # [Q, n_docs]
    out = {"mesh": dict(zip(DIST_AXES, DIST_SHAPE)), "methods": {},
           "arena_shape": list(index.arena.shape)}
    rec = ChunkRecorder(k, DIST_KERNELS)
    k.reset_launches()                  # the mesh-sharded path starts here
    with rec:
        for method in DIST_METHODS:
            t0 = time.perf_counter()
            dist = rt.DistributedIndex(index, mesh,
                                       doc_axes=DIST_AXES[:2],
                                       row_axis=DIST_AXES[2],
                                       score_method=method)
            torch.cuda.synchronize()
            m = {"build_s": time.perf_counter() - t0,
                 "slices": len(dist.slices),
                 "slice_bytes": [int(a.numel()) * 4 for _, a, _, _
                                 in dist.slices.values()],
                 "slice_shapes": [list(a.shape) for _, a, _, _
                                  in dist.slices.values()]}
            for i, terms in enumerate(term_sets[:DIST_SCORE_QUERIES]):
                check(np.array_equal(dist.scores_for(terms),
                                     plain_scores[i]),
                      f"[dist:{method}] scores_for of query {i} differs "
                      "from the plain engine's score_terms")
            want_v, want_s = dist_plain_merge(dist, plain_scores, DIST_TOPK)
            lat = []
            for _ in range(DIST_REPS):
                t0 = time.perf_counter()
                res = dist.search_batch(queries, THRESHOLD, topk=DIST_TOPK)
                lat.append(time.perf_counter() - t0)
            for i, (ids, vals) in enumerate(res):
                keep = ((want_v[i] >= max(1, int(np.ceil(THRESHOLD
                                                         * ells[i]))))
                        & (dist.slot_doc[want_s[i]] >= 0))
                check(np.array_equal(ids, dist.slot_doc[want_s[i]][keep])
                      and np.array_equal(vals, want_v[i][keep]),
                      f"[dist:{method}] query {i}: hits differ from the "
                      "plain merge")
                check(origin[i] < 0 or origin[i] in set(ids.tolist()),
                      f"[dist:{method}] query {i} missed its origin")
            m.update(busy_share(torch, lambda: dist.search_batch(
                queries, THRESHOLD, topk=DIST_TOPK)))
            m.update(p50_batch_ms=pct_ms(lat, 50), p99_batch_ms=pct_ms(
                lat, 99), hits=sum(len(ids) for ids, _ in res))
            out["methods"][method] = m
            del dist
            log(f"[dist:{method}] {m['slices']} slices of "
                f"{min(m['slice_bytes']):,}-{max(m['slice_bytes']):,} bytes "
                f"on the card (built in {m['build_s']:.2f} s); scores_for "
                f"of {DIST_SCORE_QUERIES} queries equal score_terms; "
                f"search_batch of {len(queries)} (top {DIST_TOPK}) equal to "
                f"the plain merge, {m['hits']} hits, every positive found; "
                f"batch p50 {m['p50_batch_ms']:.3f} / p99 "
                f"{m['p99_batch_ms']:.3f} ms; busy {m['device_busy_share']:.2%}"
                f" of one profiled pass ({m['device_us']:.0f} of "
                f"{m['wall_us']:.0f} us; kernels "
                f"{m['kernel_busy_share']:.2%})")
        torch.cuda.synchronize()
    launches = dict(k.launches)         # the mesh-sharded path ends here
    for name in DIST_KERNELS:
        check(launches[name] > 0, f"the [dist] phase never launched {name}")
    for name in KERNELS:
        check(launches[name] == len(rec.threads.get(name, ())),
              f"[dist] {name}: {launches[name]} launches counted for "
              f"{len(rec.threads.get(name, ()))} calls")
    out["launches"] = {n: c for n, c in launches.items() if c}
    t0 = time.perf_counter()
    out["plain_checks"] = check_every_call(k, chk, rec.calls, "dist")
    out["plain_check_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dist] launches {out['launches']}, each equal to its wrapper's "
        f"calls; every call equals its plain version on the card "
        f"({out['plain_checks']} calls, {out['plain_check_s']:.1f} s); "
        f"{out['seconds']:.1f} s")
    return out


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
    offs, widths = rt.query.shard_addressing(
        rt.query.plan_shards(comp.layout, cst.shard_row_starts), DEV)[s_big]
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
    executors and ops look them up at call time), or of each wrapper's
    first ``keep`` calls (the arguments hold their tensors), and the name
    of the thread that made each call, so that the kernels can be held
    against their plain versions and timed at the path's own shapes
    afterwards. It launches nothing itself."""

    def __init__(self, kernels, names=CHUNK_KERNELS, keep=None):
        self.k = kernels
        self.names = names
        self.keep = keep
        self.calls = {n: [] for n in names}
        self.threads = {n: [] for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.k, n) for n in self.names}
        for n, fn in self.saved.items():
            def rec(*args, _n=n, _fn=fn, **kw):
                if self.keep is None or len(self.calls[_n]) < self.keep:
                    self.calls[_n].append(args)
                self.threads[_n].append(threading.current_thread().name)
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
    dedup plan the server's batches make, one a shard and one for the
    rows a route gathers (``core.query.plan_dedup_batch`` is looked up at
    call time). It changes nothing the server computes."""

    def __init__(self, query_mod):
        self.mod = query_mod
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


def run_server(rt, torch, index, config, groups, want, what, rec,
               tag="serve"):
    """Serve ``groups`` twice through one QueryServer: a warm pass, then,
    after ``reset_metrics(clear_caches=True)``, the measured pass with the
    dedup wrappers recorded by ``rec``. Every response must be OK and equal
    ``want`` (same order). Returns the server, the measured responses, the
    record and the batch dedup plans of the measured pass; its lines are
    tagged ``[tag:what]``."""
    server = rt.QueryServer(index, config)
    for label in ("warm", "measured"):
        if label == "measured":
            server.reset_metrics(clear_caches=True)
            n0 = server.profiler.count
            with rec, DedupPlans(rt.query) as plans:
                resp, secs = serve_groups(server, groups)
        else:
            resp, secs = serve_groups(server, groups)
        check(all(r.status == rt.Status.OK for r in resp),
              f"[{tag}:{what}] {label}: a response is not OK")
        check(all(same_result(r.result, w) for r, w in zip(resp, want)),
              f"[{tag}:{what}] {label}: a response differs from the "
              "QueryEngine's")
    torch.cuda.synchronize()
    e2e = [r.latency_s for r in resp]
    service = [r.service_s for r in resp]
    rates = [p[0] for p in plans.plans]
    tiles = server.tiles
    # the measured pass's kernel spans (plan to scores on the host), the
    # live costs a tuner is fed, by dispatched method
    spans = {}
    for r in server.profiler.records(server.profiler.count - n0):
        spans.setdefault(r["method"], []).append(r["seconds"] * 1e6)
    m = {"requests": len(resp), "wall_s": secs,
         "queries_per_s": len(resp) / secs,
         "p50_e2e_ms": pct_ms(e2e, 50), "p99_e2e_ms": pct_ms(e2e, 99),
         "p50_service_ms": pct_ms(service, 50),
         "p99_service_ms": pct_ms(service, 99),
         "dispatch": dict(server.planner.dispatch_counts),
         "dedup_rates": rates,
         "unique_rows": sum(p[1] for p in plans.plans),
         "gathers": sum(p[2] for p in plans.plans),
         "span_us": {m: statistics.median(v) for m, v in spans.items()},
         "tile_faults": tiles.faults,
         "raw_bytes_staged": tiles.raw_bytes_staged,
         "comp_bytes_staged": tiles.comp_bytes_staged}
    log(f"[{tag}:{what}] {len(resp)} requests equal the QueryEngine's; "
        f"{m['queries_per_s']:.1f} queries/s; e2e p50 {m['p50_e2e_ms']:.3f} "
        f"ms, p99 {m['p99_e2e_ms']:.3f} ms; service p50 "
        f"{m['p50_service_ms']:.3f} ms, p99 {m['p99_service_ms']:.3f} ms; "
        f"dispatch {m['dispatch']}")
    log(f"[{tag}:{what}] batch dedup rates "
        f"{[round(r, 3) for r in rates]}; {m['unique_rows']} unique rows "
        f"against {m['gathers']} gathers; kernel span medians (us) "
        f"{ {k: round(v, 1) for k, v in m['span_us'].items()} }; "
        f"{tiles.faults} tile faults, "
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
    """The three dedup-path kernels at ragged and vector shapes: W = 3, 4,
    32, 33, 40, 130 (the gathers' 4-, 8- and 16-byte vectors and the
    ragged word edge); U = 8, 33, 1,024 and 5,000 (a warp's 32 row sets
    part full, and blocks of several warps); row sets of k = 1, 2, 3 and 5
    (more rows than a round keeps in flight) for the gathers, each over a
    source that starts 0, 1 or 2 words into its storage (a contiguous view
    whose data pointer is 16-, 4- or 8-byte aligned); and the pair as the
    server runs it, dedup_score on the stream right after the gather that
    writes its uniq rows."""
    g = torch.Generator().manual_seed(13)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(DEV)

    def at(off, rows, W):
        """[rows, W] random words, ``off`` words into their storage."""
        return ints(-2 ** 31, 2 ** 31, rows * W + off)[off:].view(rows, W)

    for W in (3, 4, 32, 33, 40, 130):
        for U in (8, 33, 1024, 5000):
            R, D = 3 * U + 5, U + 3
            refs = ints(0, D, R)
            calls = {"gather_rows": [], "gather_rows_compressed": [],
                     "dedup_score": []}
            for off in (0, 1, 2):
                arena, dct = at(off, R, W), at(off, D, W)
                for idx in (ints(0, R, U), ints(0, R, U, 2),
                            ints(0, R, U, 3), ints(0, R, U, 5)):
                    calls["gather_rows"].append((arena, idx))
                    calls["gather_rows_compressed"].append((dct, refs, idx))
            uniq = ints(-2 ** 31, 2 ** 31, U, W)
            for Q, nb, L in ((3, 2, 17), (32, 1, 128)):
                calls["dedup_score"].append(
                    (uniq, ints(0, U, Q, nb, L), ints(0, 2, Q, nb, L)))
            check_dedup_calls(k, chk, calls, f"ragged W={W} U={U}")
            arena, idx = calls["gather_rows"][-1]
            dct = calls["gather_rows_compressed"][-1][0]
            _, indir, mask = calls["dedup_score"][-1]
            for name, gathered, want in (
                    ("gather_rows", lambda: k.gather_rows(
                        arena, idx, range_checked=True),
                     k.gather_plain(arena, idx)),
                    ("gather_rows_compressed",
                     lambda: k.gather_rows_compressed(
                         dct, refs, idx, range_checked=True),
                     k.gather_comp_plain(dct, refs, idx))):
                got = k.dedup_score(gathered(), indir, mask,
                                    range_checked=True)
                chk.compare("dedup_score", got,
                            k.dedup_plain(want, indir, mask),
                            f"the pair after {name}, W={W} U={U}")


def dedup_vs_fused(torch, k, lib, gather_args, dedup_args) -> dict:
    """One recorded dedup batch: the dedup pair (gather + indirected
    score) against ``lookup_score_multi`` on the same batch with the
    indices expanded (uniq_rows[indir]), both by direct launches, timed
    in turns (pair, fused, fused, pair) with CUDA events: around 64
    host-launched calls (as in earlier runs) and around a CUDA graph of
    64 calls (device time alone)."""
    dev = torch.cuda.current_device()
    arena, uniq_idx = gather_args
    _, indir, mask = dedup_args
    U, W = uniq_idx.shape[0], arena.shape[1]
    Q, nb, L = indir.shape
    idx = uniq_idx.long()[indir.long()].to(torch.int32).contiguous()
    uniq = torch.empty((U, W), dtype=torch.int32, device=DEV)
    out_d = torch.empty((Q, nb, W, 32), dtype=torch.int32, device=DEV)
    out_f = torch.empty_like(out_d)

    def pair():
        stream = torch.cuda.current_stream().cuda_stream
        lib.cobs_gather_rows(arena.data_ptr(), uniq_idx.data_ptr(),
                             uniq.data_ptr(), U, 1, W, dev, stream)
        lib.cobs_dedup_score(uniq.data_ptr(), indir.data_ptr(),
                             mask.data_ptr(), out_d.data_ptr(), Q * nb, L, W,
                             k.CLUSTER_AUTO, dev, stream)

    def fused():
        lib.cobs_lookup(arena.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                        out_f.data_ptr(), Q * nb, L, W, k.CLUSTER_AUTO, dev,
                        torch.cuda.current_stream().cuda_stream)

    pair()
    fused()
    torch.cuda.synchronize()
    check(torch.equal(out_d, out_f),
          "the dedup pair != lookup_score_multi on the expanded indices")
    times = {"pair": [], "fused": []}
    graphs = {"pair": [], "fused": []}
    with on_side_stream(torch):
        for name in ("pair", "fused", "fused", "pair"):
            fn = pair if name == "pair" else fused
            times[name].append(loop_ms(torch, [fn] * 64))
            graphs[name].append(graph_ms(torch, [fn]))
    torch.cuda.synchronize()
    live = int(mask.count_nonzero())
    return {"shape": f"indir [{Q}, {nb}, {L}], uniq [{U}, {W}], arena "
                     f"{list(arena.shape)}",
            "pair_ms": statistics.mean(times["pair"]),
            "fused_ms": statistics.mean(times["fused"]),
            "pair_graph_ms": statistics.mean(graphs["pair"]),
            "fused_graph_ms": statistics.mean(graphs["fused"]),
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
    path's launches, the dedup kernels' timing inputs and the traffic
    (what -> index, request groups, the engine's answers) for [tune]."""
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
        recs[what] = ChunkRecorder(k, DEDUP_KERNELS
                                   + ("lookup_score_grouped",))
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
    for name in DEDUP_KERNELS + ("lookup_score_grouped",):
        check(launches[name] > 0, f"the serving path never launched {name}")
    log(f"[serve] launches {launches}")
    for what, rec in recs.items():
        check_dedup_calls(k, chk, {n: rec.calls[n] for n in DEDUP_KERNELS},
                          f"serve {what}")
    check_dedup_ragged(torch, k, chk)
    check_grouped_calls(rt, torch, chk, [
        c for rec in recs.values() for c in rec.calls["lookup_score_grouped"]],
        "serve")
    log("[serve:kernels] every gather_rows, gather_rows_compressed and "
        "dedup_score call of the serving path equals its plain version, "
        "and so do the ragged shapes and the first grouped lookups")
    out["trace"] = trace_serve(torch, rt, index, mix_groups[0],
                               read_groups(reads)[0])
    dense_calls = recs["dense reads"].calls
    out["dedup_vs_fused"] = vs = dedup_vs_fused(
        torch, k, rt.build.library(), dense_calls["gather_rows"][0],
        dense_calls["dedup_score"][0])
    log(f"[serve:dense] one dedup batch ({vs['shape']}, {vs['live_cells']} "
        f"live cells): dedup pair {vs['pair_ms'] * 1e3:.2f} us against "
        f"lookup_score_multi on the expanded indices "
        f"{vs['fused_ms'] * 1e3:.2f} us per host-launched call; from a CUDA "
        f"graph {vs['pair_graph_ms'] * 1e3:.2f} against "
        f"{vs['fused_graph_ms'] * 1e3:.2f} us")
    # timing inputs: up to 8 recorded calls of one shape (for the rowdict
    # gather, on the store's tallest shard)
    comp_calls = recs["comp"].calls["gather_rows_compressed"]
    tallest = max(a[1].shape[0] for a in comp_calls)
    timing = {"gather_rows": same_shapes(dense_calls["gather_rows"]),
              "dedup_score": same_shapes(dense_calls["dedup_score"]),
              "gather_rows_compressed": same_shapes(
                  [a for a in comp_calls if a[1].shape[0] == tallest])}
    traffic = {what: (idx, groups, want)
               for what, idx, _, groups, want in cases}
    return out, launches, timing, traffic


# --------------------------------------------------------------------------
# The kernel tuner
# --------------------------------------------------------------------------

def tuned_entries(tuner) -> list:
    """(key, method, cost_us, dedup_threshold, live) of every entry in the
    tuner's cache, in key order."""
    return [(key, e.method, e.cost_us, e.dedup_threshold, e.observed)
            for key, e in sorted(tuner.cache.entries.items())]


def phase_tune(rt, torch, stores, traffic, untuned, chk):
    """The kernel tuner on the card, its launch counters from 0: (a) the
    dense reads, the dense mix and the rowdict reads served with
    ``autotune=True`` into a cache file each, beside the untuned [serve]
    run of the same traffic; (b) each reopened read-only from its file,
    which must tune nothing and hit; (c) the raw store's ``lookup_p``
    entry at the read shape. Every response must equal the engine's.
    Returns the record and the phase's launches, which stay out of the
    other phases' counts."""
    k = rt.kernels
    t_phase = time.perf_counter()
    cfg = rt.ServerConfig()
    read_shape = (-(-(READ_LEN - KMER + 1) // cfg.term_pad) * cfg.term_pad,
                  cfg.max_batch)
    out = {"read_shape": list(read_shape)}
    recs = {}
    k.reset_launches()                      # the tuner's path starts here
    for what in ("dense reads", "dense mix", "comp"):
        idx, groups, want = traffic[what]
        path = STORE_DIR / f"tuning-torch-{what.replace(' ', '-')}.json"
        extra = {"compressed": True} if what == "comp" else {}
        row = {}
        for label, config in (
                ("autotuned", rt.ServerConfig(
                    autotune=True, tuning_cache=str(path), **extra)),
                ("reopened", rt.ServerConfig(tuning_cache=str(path),
                                             **extra))):
            recs[f"{what} {label}"] = rec = ChunkRecorder(k, DEDUP_KERNELS)
            server, _, m, _ = run_server(rt, torch, idx, config, groups,
                                         want, f"{what} {label}", rec,
                                         tag="tune")
            tuner = server.tuner
            m.update(tunes=tuner.tunes, cache_hits=tuner.cache.hits,
                     observations=tuner.observations,
                     entries=tuned_entries(tuner))
            row[label] = m
        check(row["autotuned"]["tunes"] > 0 and path.exists(),
              f"[tune:{what}] the autotuned server tuned nothing")
        check(row["reopened"]["tunes"] == 0
              and row["reopened"]["cache_hits"] > 0,
              f"[tune:{what}] the reopened server tuned "
              f"{row['reopened']['tunes']} shapes, hit "
              f"{row['reopened']['cache_hits']} entries")
        for key, method, cost, thr, live in row["reopened"]["entries"]:
            log(f"[tune:{what}] {key}: {method} {cost:.1f} us, dedup "
                f"threshold {thr}{', live' if live else ''}")
        u = untuned[what]
        log(f"[tune:{what}] tuned {row['autotuned']['tunes']} shapes, "
            f"reopened tuned {row['reopened']['tunes']} and hit "
            f"{row['reopened']['cache_hits']}; measured pass: autotuned "
            f"dispatch {row['autotuned']['dispatch']}, "
            f"{row['autotuned']['queries_per_s']:.1f} queries/s; reopened "
            f"dispatch {row['reopened']['dispatch']}, "
            f"{row['reopened']['queries_per_s']:.1f} queries/s; untuned "
            f"[serve] dispatch {u['dispatch']}, {u['queries_per_s']:.1f} "
            f"queries/s, e2e p50 {u['p50_e2e_ms']:.3f} / p99 "
            f"{u['p99_e2e_ms']:.3f} ms, service p50 "
            f"{u['p50_service_ms']:.3f} / p99 {u['p99_service_ms']:.3f} ms")
        out[what] = row
    # (c) the pruned executor's break-even on the raw store
    t = rt.KernelTuner.for_index(stores["raw"], rt.TuningCache())
    e = t.entry("lookup_p", *read_shape)
    out["lookup_p"] = dataclasses.asdict(e)
    log(f"[tune:lookup_p] raw store at L={read_shape[0]} Q={read_shape[1]}:"
        f" chunk {e.term_block}, worst-case chunked cost {e.cost_us:.1f} "
        f"us, prune break-even {e.dedup_threshold}")
    torch.cuda.synchronize()
    launches = dict(k.launches)             # the tuner's path ends here
    out["launches"] = launches
    for name in TUNE_KERNELS:
        check(launches[name] > 0, f"the [tune] phase never launched {name}")
    for what, rec in recs.items():
        check_dedup_calls(k, chk, rec.calls, f"tune {what}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tune] launches {launches}; every served dedup-path call equals "
        f"its plain version; {out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------------------------------------
# The network front door: ServingLoop, NetServer / NetClient, BulkLane
# --------------------------------------------------------------------------

NET_CLIENTS = 8          # interactive wire clients of (a) and (e)
NET_READERS = 2          # interactive clients beside the sweep of (c)
NET_KERNELS = ("lookup_score_grouped", "gather_rows", "dedup_score",
               "chunk_lookup_score_multi", "chunk_dedup_score",
               "chunk_lookup_score_multi_compressed")
NET_TIMEOUT = 300.0


class TimedLock:
    """Stands in for a ServingLoop's lock (``loop._lock``) and records, by
    the role of the thread (its name without trailing digits), how long
    each acquire waited and how long the lock was then held."""

    def __init__(self, lock):
        self.lock = lock
        self.local = threading.local()
        self.waits, self.holds = {}, {}      # role -> [seconds]

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.__enter__()      # the loop's lock is a context manager
        t1 = time.perf_counter()
        depth = getattr(self.local, "depth", 0)
        if depth == 0:
            self.local.t1 = t1
            role = threading.current_thread().name.rstrip("0123456789")
            self.waits.setdefault(role, []).append(t1 - t0)
        self.local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        self.local.depth -= 1
        if self.local.depth == 0:
            role = threading.current_thread().name.rstrip("0123456789")
            self.holds.setdefault(role, []).append(
                time.perf_counter() - self.local.t1)
        self.lock.__exit__(*exc)

    def reset(self) -> None:
        self.waits, self.holds = {}, {}

    def summary(self) -> dict:
        """role -> acquires, wait p50 / p99 / total and hold p50 / total
        (ms)."""
        return {role: {"acquires": len(w), "wait_p50_ms": pct_ms(w, 50),
                       "wait_p99_ms": pct_ms(w, 99),
                       "wait_total_ms": sum(w) * 1e3,
                       "hold_p50_ms": pct_ms(self.holds.get(role, [0]), 50),
                       "hold_total_ms": sum(self.holds.get(role, [])) * 1e3}
                for role, w in sorted(self.waits.items())}


def lock_line(summary: dict) -> str:
    return "; ".join(
        f"{role} {x['acquires']} acquires waited p50 {x['wait_p50_ms']:.3f}"
        f" / p99 {x['wait_p99_ms']:.3f} ms ({x['wait_total_ms']:.1f} ms in "
        f"all), held p50 {x['hold_p50_ms']:.3f} ms ({x['hold_total_ms']:.1f}"
        " ms in all)" for role, x in summary.items())


def close_net(net) -> None:
    """``net.close(drain=True)`` without its wait for the accept thread:
    closing the listener does not wake an ``accept`` blocked on it, so
    ``close`` waits out its 5 s join; shutting the listener down first
    wakes it."""
    net._listener.shutdown(socket.SHUT_RDWR)
    net.close(drain=True)


def wire_rounds(rt, address, rounds, n_clients: int):
    """``rounds``: lists of (pattern, kwargs). ``n_clients`` NetClient
    threads, one session each, send each round's requests round-robin and
    pipelined, and wait for their answers before the next round. Returns
    the NetResults in round order, each one's latency from submit to
    answer on the client (s), and the wall seconds."""
    starts = np.cumsum([0] + [len(r) for r in rounds])
    results, lat, errors = [None] * starts[-1], [None] * starts[-1], []
    barrier = threading.Barrier(n_clients)

    def client(ci):
        try:
            with rt.NetClient(*address, timeout_s=NET_TIMEOUT) as cl:
                for ri, rnd in enumerate(rounds):
                    barrier.wait(NET_TIMEOUT)
                    flight = []
                    for j in range(ci, len(rnd), n_clients):
                        i, (pattern, kw) = int(starts[ri]) + j, rnd[j]
                        t0 = time.perf_counter()
                        fut = cl.submit(pattern, **kw)
                        fut.add_done_callback(
                            lambda f, i=i, t0=t0: lat.__setitem__(
                                i, time.perf_counter() - t0))
                        flight.append((i, fut))
                    for i, fut in flight:
                        results[i] = fut.result(NET_TIMEOUT)
        except Exception as e:          # reported below, fails the run
            errors.append(f"client {ci}: {e!r}")
            barrier.abort()

    threads = [threading.Thread(target=client, args=(ci,),
                                name=f"net-client{ci}")
               for ci in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(NET_TIMEOUT)
    secs = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"wire clients failed: {errors or 'a client hung'}")
    return results, lat, secs


def check_wire(rt, results, want, what: str, method: str | None = None):
    bad = [r.status.value for r in results if r.status != rt.Status.OK]
    check(not bad, f"[net:{what}] {len(bad)} responses not OK: "
          f"{sorted(set(bad))}")
    check(all(method is None or r.method == method for r in results),
          f"[net:{what}] a response was not served by {method}")
    check(same_results([r.result for r in results], want),
          f"[net:{what}] a wire result differs from the engine's")


def job_done(rt, job, what: str) -> None:
    check(job.wait(NET_TIMEOUT), f"[net:{what}] bulk job {job.job_id} "
          "never finished")
    check(job.status is rt.BulkStatus.DONE,
          f"[net:{what}] bulk job {job.job_id} ended {job.status.value}: "
          f"{job.error}")


def bulk_stats(job) -> dict:
    return dict(vars(job.stats), prune=dict(vars(job.prune)),
                wall_s=job.finished_at - job.submitted_at)


def phase_net(rt, torch, stores, queries, traffic, untuned, chk):
    """The network front door on the card, its launch counters from 0 and
    kept out of the kernel line: (a) NET_CLIENTS clients pipeline the dense
    mix and the dense reads into NetServer(ServingLoop(QueryServer)); (b)
    STATS in both formats and a traced query; (c) BULK over the wire on the
    raw store (cache of half the store) alone, then beside NET_READERS
    clients sending the raw reads, and a pruned job through the lane; (d)
    BULK on the rowdict store; (e) close(drain=True) with requests queued.
    Every answer must be OK and equal the engine's or [bulk]'s, every bulk
    job DONE. Returns the record and the phase's launches."""
    k, q_mod = rt.kernels, rt.query
    t_phase = time.perf_counter()
    out = {}
    rec = ChunkRecorder(k, tuple(KERNELS), keep=4)
    # the traced query of (b) asks a threshold no other request uses
    traced = (queries[0], 0.7, rt.QueryEngine(
        traffic["dense mix"][0], method="lookup").search(queries[0], 0.7))
    k.reset_launches()                      # the network path starts here
    with rec:
        out["interactive"] = net_interactive(rt, torch, traffic, untuned,
                                             traced)
        out["bulk"] = net_bulk(rt, torch, stores, queries, traffic)
        out["drain"] = net_drain(rt, traffic)
        torch.cuda.synchronize()
    launches = dict(k.launches)             # the network path ends here
    out["launches"] = launches
    for name in NET_KERNELS:
        check(launches[name] > 0, f"the [net] phase never launched {name}")
    # every wrapper call of the phase ran on the card and launched once:
    # the guarded counters add up to the calls, whichever thread made them
    for name in KERNELS:
        check(launches[name] == len(rec.threads[name]),
              f"[net] {name}: {launches[name]} launches counted for "
              f"{len(rec.threads[name])} calls")
    by_thread = {}
    for name, names in rec.threads.items():
        for t in names:
            by_thread.setdefault(t, {}).setdefault(name, 0)
            by_thread[t][name] += 1
    out["launches_by_thread"] = by_thread
    check("bulk-lane" in by_thread and any(
        t.startswith("serve-worker") for t in by_thread),
        f"[net] kernels launched from {sorted(by_thread)}: not from both "
        "the loop's worker and the bulk lane")
    check_chunk_calls(k, chk, {n: rec.calls[n] for n in CHUNK_KERNELS},
                      "net")
    check_dedup_calls(k, chk, {n: rec.calls[n] for n in DEDUP_KERNELS},
                      "net")
    for args in rec.calls["lookup_score_multi"][:2]:
        chk.compare("lookup_score_multi", k.lookup_score_multi(*args),
                    k.lookup_plain(*args), f"net, idx {list(args[1].shape)}")
    check_grouped_calls(rt, torch, chk, rec.calls["lookup_score_grouped"],
                        "net")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[net] launches {launches}; by thread "
        f"{ {t: sum(c.values()) for t, c in by_thread.items()} }; each "
        f"equals its wrappers' calls; the first calls of the chunk, dedup, "
        f"lookup and grouped lookup kernels equal their plain versions; "
        f"{out['seconds']:.1f} s")
    return out, launches


def net_interactive(rt, torch, traffic, untuned, traced) -> dict:
    """(a) and (b): the dense mix and reads over the wire, then STATS and a
    traced query."""
    index, mix_groups, mix_want = traffic["dense mix"]
    _, read_groups, reads_want = traffic["dense reads"]
    server = rt.QueryServer(index, rt.ServerConfig())
    loop = rt.ServingLoop(server)
    loop._lock = lock = TimedLock(loop._lock)
    net = rt.NetServer(loop).start()
    out = {}
    try:
        for what, rounds, want in (
                ("dense mix", [[r for g in mix_groups for r in g]],
                 mix_want),
                ("dense reads", read_groups, reads_want)):
            for label in ("warm", "measured"):
                if label == "measured":
                    with loop._lock:        # no batch scores meanwhile
                        server.reset_metrics(clear_caches=True)
                        lock.reset()
                res, lat, secs = wire_rounds(rt, net.address, rounds,
                                             NET_CLIENTS)
                check_wire(rt, res, want, f"{what} {label}")
            snap = loop.metrics_snapshot()
            m = {"requests": len(res), "wall_s": secs,
                 "queries_per_s": len(res) / secs,
                 "p50_e2e_ms": pct_ms(lat, 50), "p99_e2e_ms": pct_ms(lat, 99),
                 "p50_wait_ms": pct_ms([r.wait_s for r in res], 50),
                 "p50_service_ms": pct_ms([r.service_s for r in res], 50),
                 "p99_service_ms": pct_ms([r.service_s for r in res], 99),
                 "dispatch": dict(server.planner.dispatch_counts),
                 "batches": snap.batches, "cache_hits": snap.cache_hits,
                 "mean_batch": snap.coalesce_rate, "lock": lock.summary()}
            out[what] = m
            u = untuned[what]
            log(f"[net:{what}] {len(res)} requests from {NET_CLIENTS} "
                f"clients over the wire, each OK and equal to the engine's:"
                f" {m['queries_per_s']:.1f} queries/s; client e2e p50 "
                f"{m['p50_e2e_ms']:.3f} / p99 {m['p99_e2e_ms']:.3f} ms; "
                f"server wait p50 {m['p50_wait_ms']:.3f} ms, service p50 "
                f"{m['p50_service_ms']:.3f} / p99 {m['p99_service_ms']:.3f}"
                f" ms; dispatch {m['dispatch']}; {m['batches']} batches, "
                f"mean batch {m['mean_batch']:.2f}, {m['cache_hits']} cache "
                f"hits. In process [serve]: {u['queries_per_s']:.1f} "
                f"queries/s, e2e p50 {u['p50_e2e_ms']:.3f} / p99 "
                f"{u['p99_e2e_ms']:.3f} ms, service p50 "
                f"{u['p50_service_ms']:.3f} ms, dispatch {u['dispatch']}")
            log(f"[net:{what}] the loop's lock: {lock_line(m['lock'])}")
        check(out["dense mix"]["dispatch"].get("lookup", 0) > 0,
              f"[net:dense mix] dispatch {out['dense mix']['dispatch']}: no"
              " fused lookup batch")
        check(out["dense reads"]["dispatch"].get("dedup", 0) > 0,
              f"[net:dense reads] dispatch {out['dense reads']['dispatch']}"
              ": no dedup batch")
        out["stats"] = net_stats(rt, net, traced)
    finally:
        close_net(net)
    return out


def net_stats(rt, net, traced) -> dict:
    """(b): STATS as JSON and as Prometheus text, and one traced query:
    ``traced`` is (pattern, a threshold no earlier request used, so that
    it is scored and not cached, the engine's answer)."""
    fields = {f.name for f in dataclasses.fields(rt.MetricsSnapshot)}
    with rt.NetClient(*net.address, timeout_s=NET_TIMEOUT) as cl:
        snap = cl.stats()
        text = cl.stats(prometheus=True)
        r = cl.search(traced[0], threshold=traced[1])
    check(set(snap) == fields, f"[net:stats] JSON keys {sorted(snap)} are "
          "not the snapshot's fields")
    series = [s for s in rt.parse_prometheus(text) if s.startswith("serve_")]
    check(len(series) > 0, "[net:stats] no serve_ series in the text")
    check(r.status == rt.Status.OK and same_result(r.result, traced[2]),
          "[net:trace] the traced query is not OK or differs from the "
          "engine's")
    check(r.trace_id != 0 and bool(r.stages) and "kernel_score" in r.stages,
          f"[net:trace] trace {r.trace_id}: stages {r.stages}")
    log(f"[net:stats] STATS JSON has the snapshot's {len(fields)} fields "
        f"(served {snap['served']}), the Prometheus text {len(series)} "
        f"serve_ series; traced query {r.trace_id:#x} stages "
        f"{ {s: round(v * 1e3, 3) for s, v in r.stages.items()} } ms")
    return {"served": snap["served"], "series": len(series),
            "stages_ms": {s: v * 1e3 for s, v in r.stages.items()}}


def net_bulk(rt, torch, stores, queries, traffic) -> dict:
    """(c) and (d): BULK frames and a pruned job through BulkLanes."""
    raw, comp = stores["raw"], stores["comp"]
    st = raw.storage
    _, raw_reads, raw_reads_want = traffic["raw"]
    raw_want, comp_want = stores["raw_want"][0], stores["comp_want"][0]
    out = {}
    # (c) the raw store through a cache of half its bytes; no result
    # cache, so the reads are scored in both runs
    server = rt.QueryServer(raw, rt.ServerConfig(
        tile_cache_bytes=st.nbytes() // 2, result_cache=0))
    loop = rt.ServingLoop(server)
    loop._lock = lock = TimedLock(loop._lock)
    lane = rt.BulkLane(server, loop).start()
    net = rt.NetServer(loop).start()
    try:
        with rt.NetClient(*net.address, timeout_s=NET_TIMEOUT) as cl:
            res = cl.bulk(queries, threshold=THRESHOLD,
                          timeout_s=NET_TIMEOUT)
        check_wire(rt, res, raw_want, "bulk raw", method="bulk")
        job = lane.jobs()[-1]
        job_done(rt, job, "bulk raw")
        s = job.stats
        check(s.tiles_staged == st.n_shards and s.bytes_staged
              == st.nbytes(), f"[net:bulk raw] staged {s.tiles_staged} "
              f"tiles of {s.bytes_staged} bytes, not {st.n_shards} of "
              f"{st.nbytes()}")
        out["raw alone"] = bulk_stats(job)
        log(f"[net:bulk raw] {len(queries)} queries in one BULK frame, "
            f"each OK and equal to [bulk]'s, in "
            f"{out['raw alone']['wall_s'] * 1e3:.1f} ms; each of "
            f"{st.n_shards} shards staged once, {s.bytes_staged} bytes")
        lock.reset()
        reads, lat, secs = wire_rounds(rt, net.address, raw_reads,
                                       NET_READERS)
        check_wire(rt, reads, raw_reads_want, "raw reads")
        alone = {"p50_e2e_ms": pct_ms(lat, 50), "p99_e2e_ms": pct_ms(lat, 99),
                 "queries_per_s": len(reads) / secs,
                 "mean_batch": server.metrics.snapshot().coalesce_rate,
                 "lock": lock.summary()}
        log(f"[net:raw reads] alone, mean batch "
            f"{alone['mean_batch']:.2f}; the loop's lock: "
            f"{lock_line(alone['lock'])}")
        yields0 = server.metrics.bulk_yields
        box = {}

        def sweep():
            with rt.NetClient(*net.address, timeout_s=NET_TIMEOUT) as cl:
                box["res"] = cl.bulk(queries, threshold=THRESHOLD,
                                     timeout_s=NET_TIMEOUT)

        sweeper = threading.Thread(target=sweep, name="net-bulk-client")
        sweeper.start()
        reads, lat, secs = wire_rounds(rt, net.address, raw_reads,
                                       NET_READERS)
        sweeper.join(NET_TIMEOUT)
        check(not sweeper.is_alive() and "res" in box,
              "[net:bulk raw + reads] the BULK client never finished")
        check_wire(rt, reads, raw_reads_want, "raw reads beside the sweep")
        check_wire(rt, box["res"], raw_want, "bulk raw beside the reads",
                   method="bulk")
        job = lane.jobs()[-1]
        job_done(rt, job, "bulk raw beside the reads")
        during = {"p50_e2e_ms": pct_ms(lat, 50),
                  "p99_e2e_ms": pct_ms(lat, 99),
                  "queries_per_s": len(reads) / secs,
                  "bulk_yields": server.metrics.bulk_yields - yields0,
                  "sweep": bulk_stats(job)}
        out["raw reads"] = {"alone": alone, "beside the sweep": during}
        log(f"[net:raw reads] {len(reads)} reads from {NET_READERS} clients"
            f", each OK and equal to the engine's: alone p50 "
            f"{alone['p50_e2e_ms']:.3f} / p99 {alone['p99_e2e_ms']:.3f} ms "
            f"({alone['queries_per_s']:.1f} queries/s); beside the BULK "
            f"sweep p50 {during['p50_e2e_ms']:.3f} / p99 "
            f"{during['p99_e2e_ms']:.3f} ms ({during['queries_per_s']:.1f} "
            f"queries/s); the lane yielded {during['bulk_yields']} times, "
            f"the sweep (equal to [bulk]'s) took "
            f"{during['sweep']['wall_s'] * 1e3:.1f} ms and staged "
            f"{job.stats.tiles_staged} tiles, {job.stats.bytes_staged} bytes")
        job = lane.submit(queries, threshold=THRESHOLD, pruned=True)
        job_done(rt, job, "pruned job")
        check(same_results(job.results, raw_want),
              "[net:pruned job] a result differs from [bulk]'s")
        out["raw pruned"] = bulk_stats(job)
        log(f"[net:pruned job] {len(queries)} queries through the lane's "
            f"pruned sweep, equal to [bulk]'s, in "
            f"{out['raw pruned']['wall_s'] * 1e3:.1f} ms; blocks pruned "
            f"{job.stats.prune_rate:.3f}, {job.prune.bytes_read} bytes read"
            f", {job.stats.tiles_staged} tiles staged")
    finally:
        close_net(net)
    # (d) the rowdict store, served compressed
    server = rt.QueryServer(comp, rt.ServerConfig(compressed=True))
    loop = rt.ServingLoop(server)
    lane = rt.BulkLane(server, loop).start()
    net = rt.NetServer(loop).start()
    try:
        with rt.NetClient(*net.address, timeout_s=NET_TIMEOUT) as cl:
            res = cl.bulk(queries, threshold=THRESHOLD,
                          timeout_s=NET_TIMEOUT)
        check_wire(rt, res, comp_want, "bulk comp", method="bulk")
        job = lane.jobs()[-1]
        job_done(rt, job, "bulk comp")
        out["comp"] = bulk_stats(job)
        log(f"[net:bulk comp] {len(queries)} queries over the rowdict store"
            f", each OK and equal to the raw twin's, in "
            f"{out['comp']['wall_s'] * 1e3:.1f} ms; {job.stats.tiles_staged}"
            f" tiles, {job.stats.bytes_staged} bytes staged")
    finally:
        close_net(net)
    return out


def net_drain(rt, traffic) -> dict:
    """(e): the dense mix from NET_CLIENTS clients into a server whose
    partial batches wait (max_wait_s 60), then close(drain=True) with them
    queued: every request answered OK, no reply dropped."""
    index, mix_groups, mix_want = traffic["dense mix"]
    server = rt.QueryServer(index, rt.ServerConfig(max_wait_s=60.0))
    loop = rt.ServingLoop(server)
    accepted = []
    submit = loop.submit

    def counting_submit(*args, **kw):
        rid = submit(*args, **kw)
        accepted.append(rid)
        return rid

    loop.submit = counting_submit
    net = rt.NetServer(loop).start()
    rounds = [[r for g in mix_groups for r in g]]
    n = len(rounds[0])
    box = {}
    clients = threading.Thread(
        target=lambda: box.setdefault("run", wire_rounds(
            rt, net.address, rounds, NET_CLIENTS)), name="net-drain")
    clients.start()
    deadline = time.perf_counter() + NET_TIMEOUT
    while len(accepted) < n and time.perf_counter() < deadline:
        time.sleep(0.001)
    pending = loop.pending()
    close_net(net)
    clients.join(NET_TIMEOUT)
    check(len(accepted) == n and not clients.is_alive() and "run" in box,
          f"[net:drain] {len(accepted)} of {n} requests accepted")
    check(pending > 0, "[net:drain] nothing was queued at close")
    res = box["run"][0]
    check_wire(rt, res, mix_want, "drain")
    dropped = server.metrics.dropped_replies
    check(dropped == 0, f"[net:drain] {dropped} replies dropped")
    log(f"[net:drain] close(drain=True) with {pending} of {n} accepted "
        f"requests queued: all {n} answered OK and equal to the engine's, "
        f"0 replies dropped")
    return {"requests": n, "queued_at_close": pending, "dropped": dropped}


# --------------------------------------------------------------------------
# The multi-host data plane
# --------------------------------------------------------------------------

MH_NODES = ("h0", "h1", "h2")       # fake hosts of one process
MH_REPLICATION = 2
# the kernels [multihost] must launch: single short queries (unpack), the
# fused lookups of raw and compressed workers, and the chunk lookups of the
# lane's sweeps over the fleets (chunk_dedup_score too wherever a pruned
# worker gathers rows)
MH_KERNELS = ("unpack_score", "lookup_score_multi",
              "lookup_score_multi_compressed", "chunk_lookup_score_multi",
              "chunk_lookup_score_multi_compressed")
MH_STRAGGLE_S, MH_HEDGE_AFTER_S = 0.2, 0.05
MH_SINGLES = 8
MH_TIMEOUT = 120.0


def mh_plain(k, name, args):
    """The plain version of a [multihost] or [dist] wrapper call,
    vectorised over the terms: the plain unpack of the rows the kernel
    counts (a chunk's counts added to its running counts)."""
    if name in ("unpack_score", "vertical_score"):
        return unpack_rows_plain(k, args[0])
    if name in ("lookup_score_multi_compressed",
                "chunk_lookup_score_multi_compressed"):
        d, r, *rest = args
        args = (d[r.long()], *rest)            # the rows dict[refs[row]]
    rows, idx, mask = args[:3]
    counts = unpack_rows_plain(k, masked_rows(rows, idx, mask))
    if name not in CHUNK_KERNELS:
        return counts
    out = args[3].clone()
    out[..., :counts.shape[-2], :] += counts
    return out


def check_every_call(k, chk, calls: dict, what: str) -> dict:
    """Every recorded call against its plain version on the card. Returns
    name -> calls."""
    for name, recs in calls.items():
        for args in recs:
            chk.compare(name, getattr(k, name)(*args),
                        mh_plain(k, name, args),
                        f"{what}, {[list(a.shape) for a in args]}")
    return {name: len(recs) for name, recs in calls.items()}


def mh_fleet(rt, store, *, worker_kw=None, **cfg):
    """A Frontend over MH_NODES, replication MH_REPLICATION, unbounded
    tile caches, FrontendConfig(**cfg)."""
    place = rt.ShardPlacement.for_store(store, list(MH_NODES),
                                        replication=MH_REPLICATION)
    held = place.replica_assignment()
    workers = {n: rt.ShardWorker(n, store, held[n], **(worker_kw or {}))
               for n in MH_NODES if held[n]}
    return rt.Frontend(workers, place, rt.FrontendConfig(**cfg))


def mh_close(fe) -> None:
    if fe._pool is not None:
        fe._pool.shutdown(wait=True)


def mh_serve(rt, fe, groups, want, what: str):
    """Serve ``groups`` through ``fe`` (serve_groups); every response must
    be OK and equal ``want``. Returns the responses and wall seconds."""
    resp, secs = serve_groups(fe, groups)
    check(len(resp) == len(want), f"[multihost:{what}] {len(resp)} "
          f"responses for {len(want)} requests")
    bad = [r.status.value for r in resp if r.status != rt.Status.OK]
    check(not bad, f"[multihost:{what}] {len(bad)} responses not OK: "
          f"{sorted(set(bad))}")
    check(same_results([r.result for r in resp], want),
          f"[multihost:{what}] a response differs from the engine's")
    return resp, secs


def mh_measure(rt, fe, groups, want, what: str) -> dict:
    """A warm pass, then (fresh metrics) the measured pass."""
    mh_serve(rt, fe, groups, want, f"{what} warm")
    fe.reset_metrics()
    resp, secs = mh_serve(rt, fe, groups, want, what)
    snap = fe.metrics.snapshot()
    lat = [r.latency_s for r in resp]
    per_worker = {n: float(np.percentile(v, 50)) * 1e3
                  for n, v in fe.metrics.worker_recent_s.items() if v.size}
    return {"requests": len(resp), "wall_s": secs,
            "queries_per_s": len(resp) / secs,
            "p50_e2e_ms": pct_ms(lat, 50), "p99_e2e_ms": pct_ms(lat, 99),
            "worker_dispatch_p50_ms": per_worker,
            "dispatches": snap.dispatches, "batches": snap.batches,
            "methods": dict(snap.methods),
            "hedge_fire_rate": snap.hedge_fire_rate,
            "hedges_fired": snap.hedges_fired, "failovers": snap.failovers}


def mh_line(m: dict) -> str:
    per_worker = {n: round(v, 3)
                  for n, v in m["worker_dispatch_p50_ms"].items()}
    return (f"{m['queries_per_s']:.1f} queries/s; e2e p50 "
            f"{m['p50_e2e_ms']:.3f} / p99 {m['p99_e2e_ms']:.3f} ms; worker "
            f"dispatch p50 (ms) {per_worker}"
            f"; {m['batches']} batches, {m['dispatches']} shard dispatches, "
            f"methods {m['methods']}; hedge rate {m['hedge_fire_rate']:.3f}"
            f", failovers {m['failovers']}")


def phase_multihost(rt, torch, stores, queries, traffic, untuned, chk):
    """The multi-host data plane on the card, its launch counters from 0
    and kept out of the kernel line: (a) a Frontend over MH_NODES on the
    raw store serves the dense mix and the reads window by window, with
    sequential and concurrent scatter; (b) a host fails while a batch is
    in flight and recovers; (c) pruned workers on the raw store,
    compressed workers on the rowdict store, and a BulkLane sweep over
    each fleet; (d) an RpcFrontend over MH_NODES' WorkerServers on
    localhost, first with a straggler and hedging, then with a server
    closed mid-load. Every answer must be OK and equal to the engine's on
    the same store, no request lost. Returns the record and the phase's
    launches."""
    k = rt.kernels
    t_phase = time.perf_counter()
    raw_store, comp_store = STORE_DIR / "raw", STORE_DIR / "rowdict"
    _, mix_groups, _ = traffic["dense mix"]
    _, read_groups, reads_want = traffic["raw"]
    raw_want, comp_want = stores["raw_want"], stores["comp_want"]
    n_top = len(mix_groups[-1])
    mix_want = raw_want[0] + raw_want[2][:n_top]
    comp_mix_want = comp_want[0] + comp_want[2][:n_top]
    # a user sending one short query at a time (MH_SINGLES of at most 80
    # bases, a bucket under the planner's short-query cut): batches of one
    short = [i for i, q in enumerate(queries) if len(q) <= 80][:MH_SINGLES]
    singles = ([[(queries[i], {})] for i in short],
               [raw_want[0][i] for i in short])
    out = {}
    rec = ChunkRecorder(k, tuple(KERNELS))
    k.reset_launches()                      # the multi-host path starts here
    with rec:
        out["fleet"] = mh_in_process(rt, torch, raw_store, mix_groups,
                                     mix_want, read_groups, reads_want,
                                     singles, untuned)
        out["failover"] = mh_failover(rt, raw_store, mix_groups, mix_want)
        out["pruned"] = mh_pruned_comp(rt, raw_store, comp_store, queries,
                                       mix_groups, mix_want, comp_mix_want,
                                       raw_want[0], comp_want[0])
        out["rpc"] = mh_rpc(rt, raw_store, mix_groups, mix_want)
        torch.cuda.synchronize()
    launches = dict(k.launches)             # the multi-host path ends here
    out["launches"] = launches
    for name in MH_KERNELS:
        check(launches[name] > 0,
              f"the [multihost] phase never launched {name}")
    for name in KERNELS:
        check(launches[name] == len(rec.threads[name]),
              f"[multihost] {name}: {launches[name]} launches counted for "
              f"{len(rec.threads[name])} calls")
    by_thread = {}
    for name, names in rec.threads.items():
        for t in names:
            role = t.rstrip("0123456789_")
            by_thread.setdefault(role, {}).setdefault(name, 0)
            by_thread[role][name] += 1
    out["launches_by_thread"] = by_thread
    t0 = time.perf_counter()
    calls = {n: c for n, c in rec.calls.items() if c}
    grouped = calls.pop("lookup_score_grouped", [])
    out["plain_checks"] = check_every_call(k, chk, calls, "multihost")
    if grouped:
        check_grouped_calls(rt, torch, chk, grouped, "multihost",
                            n=len(grouped))
        out["plain_checks"]["lookup_score_grouped"] = len(grouped)
    out["plain_check_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[multihost] launches { {n: c for n, c in launches.items() if c} };"
        f" by thread { {t: sum(c.values()) for t, c in by_thread.items()} }"
        f"; each equals its wrappers' calls; every call equals its plain "
        f"version on the card ({out['plain_checks']} calls, "
        f"{out['plain_check_s']:.1f} s); "
        f"{out['seconds']:.1f} s")
    return out, launches


def busy_share(torch, run) -> dict:
    """The card's busy share of one call of ``run``, within one pass: the
    device time torch.profiler records over a warm call against the wall
    time of that same profiled call. Device time sums every CUDA event the
    profiler records (kernels, memory copies and sets); the kernels' part
    is kept apart. The wall of an un-profiled call stands beside it, to
    show what the profiler adds."""
    from torch.profiler import ProfilerActivity, profile
    run()                                            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    unprofiled_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [ev for ev in prof.events()
           if str(ev.device_type).endswith("CUDA")]
    dev_us = sum(ev.time_range.elapsed_us() for ev in dev)
    kernel_us = sum(ev.time_range.elapsed_us() for ev in dev
                    if not ev.name.startswith(("Memcpy", "Memset")))
    return {"wall_us": wall_us, "unprofiled_wall_us": unprofiled_us,
            "device_us": dev_us, "kernel_us": kernel_us,
            "device_busy_share": dev_us / wall_us,
            "kernel_busy_share": kernel_us / wall_us}


def mh_busy_share(torch, fe, group) -> dict:
    """The card's busy share over one scattered batch (``busy_share`` of
    one group through a warm frontend)."""
    return {"requests": len(group),
            **busy_share(torch, lambda: serve_groups(fe, [group]))}


def mh_in_process(rt, torch, store, mix_groups, mix_want, read_groups,
                  reads_want, singles, untuned) -> dict:
    """(a): the dense mix, the reads and single short queries through an
    in-process fleet, with sequential (1 thread) and concurrent (the
    default 4) scatter."""
    out = {}
    for label, threads in (("sequential", 1), ("concurrent", 4)):
        fe = mh_fleet(rt, store, scatter_threads=threads)
        try:
            for what, groups, want in (("dense mix", mix_groups, mix_want),
                                       ("reads", read_groups, reads_want),
                                       ("singles", *singles)):
                m = mh_measure(rt, fe, groups, want, f"{label} {what}")
                out[f"{label} {what}"] = m
                log(f"[multihost:{label} {what}] {m['requests']} requests "
                    f"over {len(MH_NODES)} hosts (replication "
                    f"{MH_REPLICATION}), each OK and equal to the raw "
                    f"store's engine: {mh_line(m)}")
            if threads > 1:
                out["busy"] = b = mh_busy_share(torch, fe, mix_groups[0])
                log(f"[multihost:trace] one scattered group of "
                    f"{b['requests']} requests, profiled: wall "
                    f"{b['wall_us']:.0f} us (un-profiled "
                    f"{b['unprofiled_wall_us']:.0f} us), device "
                    f"{b['device_us']:.0f} us of which kernels "
                    f"{b['kernel_us']:.0f} us (busy share "
                    f"{b['device_busy_share']:.4f}, kernels "
                    f"{b['kernel_busy_share']:.4f})")
        finally:
            mh_close(fe)
    check(out["sequential singles"]["methods"].get("unpack", 0) > 0,
          f"[multihost:singles] methods "
          f"{out['sequential singles']['methods']}: no unpack")
    for what in ("dense mix", "reads", "singles"):
        s, c = out[f"sequential {what}"], out[f"concurrent {what}"]
        log(f"[multihost:{what}] sequential {s['queries_per_s']:.1f} "
            f"against concurrent {c['queries_per_s']:.1f} queries/s")
    u = untuned["raw"]
    log(f"[multihost:reads] in process on one QueryServer ([serve:raw], a "
        f"cache of half the store): {u['queries_per_s']:.1f} queries/s, "
        f"e2e p50 {u['p50_e2e_ms']:.3f} ms")
    return out


def mh_failover(rt, store, mix_groups, mix_want) -> dict:
    """(b): fail_worker on the owner of shard 0 from inside another
    worker's dispatch (a batch in flight), serve on, then recover it."""
    fe = mh_fleet(rt, store)
    try:
        place = fe.placement
        victim = place.owner(0)
        # a host that owns a shard: it scores in every batch
        other = next(place.owner(g) for g in range(place.n_shards)
                     if place.owner(g) != victim)
        w = fe.workers[other]
        score, fired = w.score_candidates, []

        def failing_score(*args, **kw):
            if not fired and w.dispatches >= 2:
                fired.append(fe.fail_worker(victim))
            return score(*args, **kw)

        w.score_candidates = failing_score
        resp, _ = mh_serve(rt, fe, mix_groups, mix_want, "failover")
        w.score_candidates = score
        snap = fe.metrics.snapshot()
        check(bool(fired) and snap.failovers > 0,
              f"[multihost:failover] failovers {snap.failovers} after "
              f"failing {victim}")
        before = fe.workers[victim].dispatches
        restored = fe.recover_worker(victim)
        mh_serve(rt, fe, mix_groups[:1], mix_want[:len(mix_groups[0])],
                 "recovered")
        check(not fe.workers[victim].failed and victim in
              fe.placement.live_nodes and fe.workers[victim].dispatches
              > before, f"[multihost:failover] {victim} did not come back")
        out = {"victim": victim, "moved": fired[0], "restored": restored,
               "requests": len(resp), "failovers": snap.failovers,
               "skipped_dead": snap.skipped_dead}
        log(f"[multihost:failover] {victim} failed mid-batch (shards "
            f"{fired[0]} moved): all {len(resp)} requests OK and equal, "
            f"{snap.failovers} failovers; recovered (replica set "
            f"{restored}), it serves again")
    finally:
        mh_close(fe)
    return out


def mh_sweep(rt, fe, queries, want, what: str) -> dict:
    """A BulkLane over the fleet: each shard swept on its live primary's
    tile cache."""
    lane = rt.BulkLane(fe)
    job = lane.submit(queries, threshold=THRESHOLD)
    lane.drain()
    check(job.status is rt.BulkStatus.DONE,
          f"[multihost:{what}] bulk job ended {job.status.value}: "
          f"{job.error}")
    check(same_results(job.results, want),
          f"[multihost:{what}] a bulk result differs from the engine's")
    return bulk_stats(job)


def mh_pruned_comp(rt, raw_store, comp_store, queries, mix_groups, mix_want,
                   comp_mix_want, raw_threshold_want,
                   comp_threshold_want) -> dict:
    """(c): pruned workers on the raw store (FrontendConfig(pruned=True));
    compressed workers on the rowdict store, plain and pruned; and a
    BulkLane sweep of the 128 queries over the raw and rowdict fleets."""
    out = {}
    for what, store, wkw, cfg, want, bulk_want in (
            ("pruned", raw_store, {}, {"pruned": True}, mix_want,
             raw_threshold_want),
            ("compressed", comp_store, {"compressed": True}, {},
             comp_mix_want, comp_threshold_want),
            ("pruned compressed", comp_store, {"compressed": True},
             {"pruned": True}, comp_mix_want, None)):
        fe = mh_fleet(rt, store, worker_kw=wkw, **cfg)
        try:
            m = mh_measure(rt, fe, mix_groups, want, what)
            ws = fe.workers.values()
            m["pruned_dispatches"] = sum(w.pruned_dispatches for w in ws)
            m["compressed_dispatches"] = sum(w.compressed_dispatches
                                             for w in ws)
            m["tiles_promoted"] = sum(w.prune_stats.tiles_promoted
                                      for w in ws)
            m["prune_rate"] = fe.metrics.snapshot().prune_rate
            if bulk_want is not None:
                m["bulk"] = mh_sweep(rt, fe, queries, bulk_want,
                                     f"{what} bulk")
        finally:
            mh_close(fe)
        out[what] = m
        if cfg.get("pruned"):
            check(m["methods"].get("lookup_p", 0) > 0
                  and m["pruned_dispatches"] > 0,
                  f"[multihost:{what}] methods {m['methods']}: no lookup_p")
        if wkw.get("compressed"):
            check(m["compressed_dispatches"] > 0,
                  f"[multihost:{what}] no compressed dispatch")
        log(f"[multihost:{what}] {m['requests']} requests, each OK and "
            f"equal to the engine's: {mh_line(m)}; {m['pruned_dispatches']}"
            f" pruned and {m['compressed_dispatches']} compressed shard "
            f"dispatches (both passes), {m['tiles_promoted']} tiles "
            f"promoted, prune rate {m['prune_rate']:.3f}"
            + (f"; the lane swept {len(queries)} queries over the fleet in "
               f"{m['bulk']['wall_s'] * 1e3:.1f} ms, equal to the engine's"
               if "bulk" in m else ""))
    return out


def mh_rpc_fleet(rt, store, straggle=None, **cfg):
    """(RpcFrontend, servers): one WorkerServer a host of MH_NODES on an
    ephemeral localhost port (threads of this process)."""
    place = rt.ShardPlacement.for_store(store, list(MH_NODES),
                                        replication=MH_REPLICATION)
    held = place.replica_assignment()
    servers = {n: rt.WorkerServer(rt.ShardWorker(n, store, held[n]),
                                  straggle_s=(straggle or {}).get(n, 0.0))
               .start() for n in MH_NODES if held[n]}
    pool = rt.WorkerPool({n: s.address for n, s in servers.items()})
    pool.wait_connected(timeout_s=MH_TIMEOUT)
    return rt.RpcFrontend(pool, place, rt.FrontendConfig(**cfg)), servers


def close_worker_server(server, **kw) -> None:
    """``server.close`` without its 5 s wait for the accept thread (see
    ``close_net``)."""
    try:
        server._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    server.close(**kw)


def mh_rpc(rt, store, mix_groups, mix_want) -> dict:
    """(d): the RPC data plane. A straggler (MH_STRAGGLE_S before every
    dispatch) behind hedge_after_s=MH_HEDGE_AFTER_S: real duplicate RPCs
    win and the losers are cancelled; then the mix without a straggler,
    measured, and again with one server closed (abort) mid-load."""
    out = {}
    place = rt.ShardPlacement.for_store(store, list(MH_NODES),
                                        replication=MH_REPLICATION)
    straggler = place.owner(0)
    groups = mix_groups[:2]
    want = mix_want[:sum(len(g) for g in groups)]
    fe, servers = mh_rpc_fleet(rt, store, {straggler: MH_STRAGGLE_S},
                               hedge_after_s=MH_HEDGE_AFTER_S)
    try:
        m = mh_measure(rt, fe, groups, want, "rpc straggler")
        ex = fe.executor
        stats = fe.pool.channel(straggler).stats()
        m.update(hedges_won=ex.hedges_won,
                 hedges_cancelled=ex.hedges_cancelled,
                 cancelled_tiles=stats["cancelled_tiles"])
        check(ex.hedges_fired > 0 and ex.hedges_won > 0
              and ex.hedges_cancelled > 0 and stats["cancelled_tiles"] > 0,
              f"[multihost:rpc straggler] hedges fired {ex.hedges_fired}, "
              f"won {ex.hedges_won}, cancelled {ex.hedges_cancelled}; "
              f"{straggler} cancelled {stats['cancelled_tiles']} tiles")
        out["straggler"] = m
        log(f"[multihost:rpc straggler] {straggler} sleeps "
            f"{MH_STRAGGLE_S} s before each dispatch, hedges after "
            f"{MH_HEDGE_AFTER_S} s: {m['requests']} requests OK and equal;"
            f" {mh_line(m)}; hedges won {ex.hedges_won}, cancelled "
            f"{ex.hedges_cancelled}; {straggler} cancelled "
            f"{stats['cancelled_tiles']} tiles")
        servers[straggler].straggle_s = 0.0
        fe.executor.hedge_after = 30.0
        m = mh_measure(rt, fe, mix_groups, mix_want, "rpc")
        out["mix"] = m
        log(f"[multihost:rpc dense mix] {m['requests']} requests over the "
            f"wire to {len(servers)} WorkerServers, each OK and equal: "
            f"{mh_line(m)}")
        victim = place.owner(1)
        killer = threading.Timer(0.05, close_worker_server,
                                 args=(servers[victim],),
                                 kwargs={"abort": True})
        killer.start()
        resp, secs = mh_serve(rt, fe, mix_groups + mix_groups,
                              mix_want + mix_want, "rpc kill")
        killer.join(MH_TIMEOUT)
        snap = fe.metrics.snapshot()
        check(not fe.pool.channel(victim).healthy,
              f"[multihost:rpc kill] {victim}'s channel is still up")
        out["kill"] = {"victim": victim, "requests": len(resp),
                       "wall_s": secs, "failovers": snap.failovers,
                       "rpcs_failed": snap.rpcs_failed,
                       "channels_up": snap.channels_up}
        log(f"[multihost:rpc kill] {victim} closed (abort) mid-load: all "
            f"{len(resp)} requests OK and equal, 0 lost; failovers "
            f"{snap.failovers}, rpcs failed {snap.rpcs_failed}, channels up"
            f" {snap.channels_up}")
    finally:
        fe.close()
        for s in servers.values():
            close_worker_server(s)
    return out


# --------------------------------------------------------------------------
# The process fleet and the serving CLI
# --------------------------------------------------------------------------

CL_NODES = ("c0", "c1", "c2")           # worker processes on the one card
CL_CLIENTS = 8
CL_KILL_AFTER_S = 0.2


def cl_round(rt, fe, net, groups, want, what: str) -> dict:
    """``groups`` from CL_CLIENTS NetClient threads (``wire_rounds``);
    every answer OK and equal to ``want``. Returns the measurements."""
    fe.reset_metrics()
    results, lat, secs = wire_rounds(rt, net.address, groups, CL_CLIENTS)
    bad = [r.status.value for r in results if r.status != rt.Status.OK]
    check(not bad, f"[cluster:{what}] {len(bad)} answers not OK: "
          f"{sorted(set(bad))}")
    check(same_results([r.result for r in results], want),
          f"[cluster:{what}] an answer differs from the engine's")
    snap = fe.metrics.snapshot()
    return {"requests": len(results), "wall_s": secs,
            "queries_per_s": len(results) / secs,
            "p50_e2e_ms": pct_ms(lat, 50), "p99_e2e_ms": pct_ms(lat, 99),
            "worker_dispatch_p50_ms": {
                n: float(np.percentile(v, 50)) * 1e3
                for n, v in fe.metrics.worker_recent_s.items() if v.size},
            "batches": snap.batches, "dispatches": snap.dispatches,
            "methods": dict(snap.methods), "failovers": snap.failovers,
            "rpcs_failed": snap.rpcs_failed,
            "channels_up": snap.channels_up}


def phase_cluster(rt, torch, traffic, stores, multihost) -> dict:
    """A WorkerCluster of CL_NODES worker processes on the card over the
    raw store (replication MH_REPLICATION), behind an RpcFrontend inside a
    ServingLoop and a NetServer: the dense mix, then the raw reads window
    by window, from CL_CLIENTS NetClient threads (a warm pass, then the
    measured one); then one worker SIGKILLed mid-load and restarted on its
    port. Every answer must be OK and equal to the engine's on the same
    store, none lost, failovers above 0 and the channel back up. The
    kernels launch in the children, which the parent's counters cannot
    see: they are held through the answers (and each worker's STATS
    dispatch count), and against their plain versions by [multihost],
    which runs the same worker code in this process."""
    t_phase = time.perf_counter()
    store = STORE_DIR / "raw"
    _, mix_groups, _ = traffic["dense mix"]
    _, read_groups, reads_want = traffic["raw"]
    raw_want = stores["raw_want"]
    mix_want = raw_want[0] + raw_want[2][:len(mix_groups[-1])]
    out = {}
    (STORE_DIR / "cluster").mkdir(exist_ok=True)
    free = [torch.cuda.mem_get_info()[0]]
    t0 = time.perf_counter()
    cl = rt.WorkerCluster(str(store), list(CL_NODES),
                          replication=MH_REPLICATION,
                          run_dir=str(STORE_DIR / "cluster"),
                          spawn_timeout_s=MH_TIMEOUT)
    fe = net = None
    try:
        cl.start()
        out["spawn_s"] = time.perf_counter() - t0
        free.append(torch.cuda.mem_get_info()[0])
        place = rt.ShardPlacement.for_store(store, list(CL_NODES),
                                            replication=MH_REPLICATION)
        pool = rt.WorkerPool(cl.addresses)
        pool.wait_connected(timeout_s=MH_TIMEOUT)
        fe = rt.RpcFrontend(pool, place,
                            rt.FrontendConfig(hedge_after_s=30.0))
        net = rt.NetServer(rt.ServingLoop(fe)).start()
        for what, groups, want in (("dense mix", mix_groups, mix_want),
                                   ("raw reads", read_groups, reads_want)):
            cl_round(rt, fe, net, groups, want, f"{what} warm")
            m = cl_round(rt, fe, net, groups, want, what)
            out[what] = m
            log(f"[cluster:{what}] {m['requests']} requests from "
                f"{CL_CLIENTS} clients to {len(CL_NODES)} worker processes,"
                f" each OK and equal: {m['queries_per_s']:.1f} queries/s; "
                f"e2e p50 {m['p50_e2e_ms']:.3f} / p99 {m['p99_e2e_ms']:.3f}"
                f" ms; worker dispatch p50 (ms) "
                f"{ {n: round(v, 3) for n, v in m['worker_dispatch_p50_ms'].items()} }"
                f"; {m['batches']} batches, {m['dispatches']} shard "
                f"dispatches, methods {m['methods']}")
        # the card's free memory before the spawn, after it and after the
        # traffic (nvidia-smi lists no process inside a container)
        free.append(torch.cuda.mem_get_info()[0])
        out["memory"] = {"card_bytes_at_spawn": free[0] - free[1],
                         "card_bytes_after_traffic": free[0] - free[2]}
        log(f"[cluster:memory] the {len(CL_NODES)} workers, up in "
            f"{out['spawn_s']:.1f} s, took "
            f"{(free[0] - free[1]) / 2**20:.0f} MiB of the card at spawn, "
            f"{(free[0] - free[2]) / 2**20:.0f} MiB with their tiles "
            "staged")
        rpc = multihost["rpc"]["mix"]
        log(f"[cluster] beside [multihost:rpc dense mix] (3 WorkerServers "
            f"in this process, no loop or wire client): "
            f"{rpc['queries_per_s']:.1f} queries/s, e2e p50 "
            f"{rpc['p50_e2e_ms']:.3f} ms")

        victim = place.owner(0)
        killer = threading.Timer(CL_KILL_AFTER_S, cl.kill, args=(victim,))
        killer.start()
        m = cl_round(rt, fe, net, mix_groups * 3, mix_want * 3, "kill")
        killer.join(MH_TIMEOUT)
        free.append(torch.cuda.mem_get_info()[0])       # the victim gone
        check(m["failovers"] > 0 and cl.procs[victim].poll() is not None,
              f"[cluster:kill] {victim} killed after {CL_KILL_AFTER_S} s: "
              f"failovers {m['failovers']}, exit {cl.procs[victim].poll()}")
        t0 = time.perf_counter()
        cl.restart(victim)
        deadline = time.monotonic() + MH_TIMEOUT
        while (not pool.channel(victim).healthy
               and time.monotonic() < deadline):
            time.sleep(0.05)
        check(pool.channel(victim).healthy
              and pool.channel(victim).reconnects >= 1,
              f"[cluster:kill] {victim}'s channel did not come back")
        m["restart_s"] = time.perf_counter() - t0
        m["reconnects"] = pool.channel(victim).reconnects
        after = cl_round(rt, fe, net, mix_groups, mix_want, "restarted")
        free.append(torch.cuda.mem_get_info()[0])
        # one worker's context and tiles: what its restart took back
        out["memory"]["one_worker_bytes"] = free[3] - free[4]
        out["kill"] = m
        stats = {n: pool.channel(n).stats() for n in CL_NODES}
        check(all(st["dispatches"] > 0 for st in stats.values()),
              f"[cluster] a worker dispatched nothing: {stats}")
        out["worker_stats"] = stats
        log(f"[cluster:kill] {victim} SIGKILLed {CL_KILL_AFTER_S} s into "
            f"{m['requests']} requests: all OK and equal, 0 lost; failovers"
            f" {m['failovers']}, rpcs failed {m['rpcs_failed']}; restarted "
            f"in {m['restart_s']:.1f} s, its channel reconnected, "
            f"{after['requests']} more requests OK and equal; the restarted "
            f"worker took {(free[3] - free[4]) / 2**20:.0f} MiB of the card;"
            f" STATS dispatches "
            f"{ {n: st['dispatches'] for n, st in stats.items()} }")
    finally:
        if net is not None:
            close_net(net)
        if fe is not None:
            fe.close()
        cl.close()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[cluster] {out['seconds']:.1f} s")
    return out


CLI_TIMEOUT = 300
CLI_CLOSED_DOCS, CLI_STORE_DOCS = 2048, 512


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def cli_cmd(*args) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.serve", *args]


def cli_run(what: str, queries: int, *args) -> dict:
    """One CLI run on the card (no --device): it must exit 0 and report
    every answer right; returns its report's p50 and dispatch mix."""
    t0 = time.perf_counter()
    proc = subprocess.run(cli_cmd("--queries", str(queries), *args),
                          cwd=ROOT, env=cli_env(), capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    check(proc.returncode == 0,
          f"[cli:{what}] exited {proc.returncode}:\n{text[-3000:]}")
    check(f"accuracy vs ground truth: {queries}/{queries}" in proc.stdout,
          f"[cli:{what}] not every answer right:\n{text[-3000:]}")
    p50 = re.search(r" p50=([\d.]+)ms", proc.stdout)
    disp = re.search(r"dispatch\[([^\]]*)\]", proc.stdout)
    qps = re.search(r"-> (\d+) qps", proc.stdout)
    check(p50 is not None and disp is not None and qps is not None,
          f"[cli:{what}] no p50, qps or dispatch in its report:\n"
          f"{proc.stdout[-3000:]}")
    out = {"seconds": secs, "p50_ms": float(p50.group(1)),
           "queries_per_s": int(qps.group(1)), "dispatch": disp.group(1),
           "stdout": proc.stdout[-4000:]}
    log(f"[cli:{what}] exit 0, accuracy {queries}/{queries}, "
        f"{out['queries_per_s']} qps, p50 {out['p50_ms']} ms, dispatch["
        f"{out['dispatch']}]; {secs:.1f} s")
    return out


CLI_LISTEN_DOCS, CLI_LISTEN_QUERIES = 256, 64


def cli_listen(rt) -> dict:
    """``--listen 0`` on the card: a NetClient's answers must equal a
    QueryEngine's on the CLI's own corpus (built here the same way); then
    SIGINT drains it and it exits 0 with its report."""
    corpus = rt.make_corpus(CLI_LISTEN_DOCS, k=15, mean_length=2000,
                            sigma=1.0, seed=0)
    engine = rt.QueryEngine(rt.build_compact(
        corpus.doc_terms, rt.IndexParams(1, 0.3, 15), block_docs=64),
        method="lookup")
    queries, _ = rt.make_workload(corpus, CLI_LISTEN_QUERIES)
    want = [engine.search(q, THRESHOLD) for q in queries]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli_cmd("--n-docs", str(CLI_LISTEN_DOCS), "--listen", "0"),
        cwd=ROOT, env=cli_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    seen, addr = [], None
    try:
        deadline = time.monotonic() + CLI_TIMEOUT
        while addr is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            check(line is not None, "[cli:listen] exited before serving:\n"
                  + "".join(seen)[-3000:])
            seen.append(line)
            m = re.match(r"serving on ([\d.]+):(\d+) ", line)
            if m:
                addr = (m.group(1), int(m.group(2)))
        up_s = time.perf_counter() - t0
        results, lat, secs = wire_rounds(
            rt, addr, [[(q, {"threshold": THRESHOLD}) for q in queries]],
            CL_CLIENTS)
        check(all(r.status == rt.Status.OK for r in results)
              and same_results([r.result for r in results], want),
              "[cli:listen] a wire answer differs from the engine's")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=CLI_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=30)
    while (line := lines.get(timeout=5)) is not None:
        seen.append(line)
    text = "".join(seen)
    served = re.search(r"served=(\d+) rejected=(\d+) dropped=(\d+)", text)
    check(rc == 0 and "draining in-flight batches" in text
          and served is not None
          and served.groups() == (str(len(queries)), "0", "0"),
          f"[cli:listen] exit {rc} after SIGINT:\n{text[-3000:]}")
    out = {"seconds": time.perf_counter() - t0, "up_s": up_s,
           "requests": len(results), "queries_per_s": len(results) / secs,
           "p50_e2e_ms": pct_ms(lat, 50), "p99_e2e_ms": pct_ms(lat, 99)}
    log(f"[cli:listen] serving after {up_s:.1f} s; {len(results)} wire "
        f"answers from {CL_CLIENTS} clients equal the engine's "
        f"({out['queries_per_s']:.1f} queries/s, e2e p50 "
        f"{out['p50_e2e_ms']:.3f} ms); SIGINT drained it, exit 0, "
        f"served={served.group(1)}; {out['seconds']:.1f} s")
    return out


def phase_cli(rt, queries) -> dict:
    """``python -m repro_torch.launch.serve`` as a user runs it, on the card
    (no --device): closed load on 2048 documents; a v2 store streamed and
    served by 3 fake hosts with host1 failed; the same store with an
    offline --bulk sweep of the mix's 128 patterns; and --listen, answered
    over the wire and drained by SIGINT."""
    t0 = time.perf_counter()
    store = STORE_DIR / "cli"
    bulk = STORE_DIR / "cli-bulk.txt"
    bulk.write_text("".join(rt.dna.decode_dna(q) + "\n" for q in queries))
    out = {"closed": cli_run("closed", 256, "--n-docs",
                             str(CLI_CLOSED_DOCS))}
    v2 = ("--n-docs", str(CLI_STORE_DOCS), "--store-format", "v2",
          "--index-dir", str(store))
    out["hosts"] = cli_run("hosts", 128, *v2, "--hosts", "3",
                           "--fail-host", "host1")
    check("down=['host1']" in out["hosts"]["stdout"],
          "[cli:hosts] host1 is not down")
    out["bulk"] = cli_run("bulk", 128, *v2, "--bulk", str(bulk))
    check(re.search(rf"bulk\[cli-bulk.txt\] done: {len(queries)} queries",
                    out["bulk"]["stdout"]) is not None
          and "loaded index from" in out["bulk"]["stdout"],
          "[cli:bulk] the sweep did not finish on the loaded store")
    out["listen"] = cli_listen(rt)
    out["seconds"] = time.perf_counter() - t0
    log(f"[cli] {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# The LM substrate's serving path ([lm:*]); no kernel of its own
# --------------------------------------------------------------------------

# bf16 logits and states: the bound the CPU tests hold the port to against
# JAX (tests/test_torch_lm_models.py), here between the card and the CPU
LM_TOL = 5e-2
LM_TOL32 = 1e-2        # fp32 compute, decode against forward at full depth
LM_TIE = 5e-3          # a router margin under this may flip a MoE expert
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_CACHE, LM_SMOKE_DECODES = 8, 12, 16, 3
# [lm:full]: 4 prompts of 64 tokens, 32 new tokens into a cache of 128
LM_FULL_ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m")
LM_PROMPTS, LM_PROMPT_LEN, LM_NEW, LM_CACHE = 4, 64, 32, 128


def lm_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: lm_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from lm_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


class RouteMargins:
    """Records each MoE router call's top-k margin per token while on: a
    margin under ``LM_TIE`` may pick another expert on another device, so
    that row is compared only before it."""

    def __init__(self, rt):
        self.rt, self.calls, self.at = rt, [], 0

    def __enter__(self):
        route = self.route = self.rt.lm_moe.route

        def recorded(p, cfg, xt):
            out = route(p, cfg, xt)
            probs = out[1].sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            self.calls.append((self.at, (probs[:, k - 1] - probs[:, k])
                               .float().cpu()))
            return out

        self.rt.lm_moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.rt.lm_moe.route = self.route

    def cut(self, batch: int, length: int) -> list:
        """Row b -> its first position with a near tie (length if none)."""
        cut = [length] * batch
        for offset, m in self.calls:
            n = m.numel() // batch
            for i in (m < LM_TIE).nonzero().flatten().tolist():
                row, pos = divmod(i, n)
                cut[row] = min(cut[row], offset + pos)
        return cut


def lm_max_err(torch, got, want, what: str, cut=None, row_axis=0) -> float:
    """Largest |got - want|; fails beyond rtol = atol = LM_TOL. With
    ``cut``, row b (along ``row_axis``) counts only its first cut[b]
    positions (the next axis)."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}, "
          f"expected {tuple(want.shape)}")
    if cut is not None:
        pairs = [(got.select(row_axis, b).narrow(row_axis, 0, n),
                  want.select(row_axis, b).narrow(row_axis, 0, n))
                 for b, n in enumerate(cut) if n]
        got = torch.cat([g.flatten() for g, _ in pairs] or [got[:0]])
        want = torch.cat([w.flatten() for _, w in pairs] or [want[:0]])
    if not got.numel():
        return 0.0
    diff = (got - want).abs()
    check(bool((diff <= LM_TOL * (1 + want.abs())).all()),
          f"{what}: beyond rtol = atol = {LM_TOL} (max {float(diff.max())})")
    return float(diff.max())


def lm_run(torch, rt, model, params, toks, enc, vis, margins=None):
    """forward_train, prefill of all but the last LM_SMOKE_DECODES tokens
    and LM_SMOKE_DECODES decode steps; caches copied after the last."""
    S = toks.shape[1]
    pre = S - LM_SMOKE_DECODES
    full, aux = model.forward_train(params, toks, enc_feats=enc,
                                    vis_embeds=vis)
    logits, caches = rt.lm_prefill_step(model, LM_SMOKE_CACHE,
                                        last_only=False)(
        params, {"tokens": toks[:, :pre], "enc_feats": enc})
    decode = rt.lm_decode_step(model)
    steps = []
    for t in range(pre, S):
        if margins is not None:
            margins.at = t
        lg, caches = decode(params, caches, toks[:, t:t + 1], t)
        steps.append(lg)
    return {"forward": full, "aux": aux, "prefill": logits,
            "decodes": steps,
            "caches": dict(lm_leaves(lm_tree(lambda t: t.clone(), caches)))}


def lm_smoke(rt, torch, arch: str) -> dict:
    """One smoke() config on the card and on the CPU from the same draws:
    forward_train, prefill and three decode steps within LM_TOL."""
    cfg = rt.lm_configs.get(arch, smoke=True)
    cpu = rt.lm_build(cfg, "cpu")
    params_cpu, _ = cpu.init(torch.Generator().manual_seed(SEED))
    params = lm_tree(lambda t: t.to(DEV), params_cpu)
    rng = np.random.default_rng(SEED)
    B, S = LM_SMOKE_B, LM_SMOKE_S
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
           if cfg.n_enc_layers else None)
    vis = (rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32)
           if cfg.frontend == "vision" else None)
    with RouteMargins(rt) as margins:
        want = lm_run(torch, rt, cpu, params_cpu, torch.from_numpy(toks),
                      enc, vis, margins)
    cut = margins.cut(B, S)
    if min(cut) == S:
        cut = None                        # no near tie: every position
    got = lm_run(torch, rt, rt.lm_build(cfg, DEV), params,
                 torch.from_numpy(toks).to(DEV), enc, vis)
    torch.cuda.synchronize()
    pre, what = S - LM_SMOKE_DECODES, f"[lm:smoke {arch}]"
    err = {"forward": lm_max_err(torch, got["forward"], want["forward"],
                                 f"{what} forward", cut),
           "prefill": lm_max_err(torch, got["prefill"], want["prefill"],
                                 f"{what} prefill",
                                 cut and [min(n, pre) for n in cut])}
    for k in want["aux"]:
        err[k] = lm_max_err(torch, got["aux"][k], want["aux"][k],
                            f"{what} {k}")
    for i, (g, w) in enumerate(zip(got["decodes"], want["decodes"])):
        rows = [b for b in range(B) if cut is None or cut[b] > pre + i]
        err[f"decode{i + 1}"] = lm_max_err(torch, g[rows], w[rows],
                                           f"{what} decode {i + 1}")
    check(set(got["caches"]) == set(want["caches"]),
          f"{what} cache trees differ")
    cache_err = 0.0
    for path, w in want["caches"].items():
        g = got["caches"][path]
        check(g.dtype == w.dtype, f"{what} cache {path} dtype {g.dtype}")
        if w.is_floating_point():
            # a near tie moves the K/V of later positions (MoE archs hold
            # only attention caches, positions on axis 2)
            cache_err = max(cache_err, lm_max_err(
                torch, g, w, f"{what} cache {path}", cut, row_axis=1))
        else:
            check(torch.equal(g.cpu(), w), f"{what} cache {path}")
    err["caches"] = cache_err
    for name in ("forward", "prefill"):
        check(bool(torch.isfinite(got[name]).all()),
              f"{what} {name} logits not finite")
    rows_cut = 0 if cut is None else sum(n < S for n in cut)
    log(f"[lm:smoke {arch}] max |card - cpu|: "
        + ", ".join(f"{k} {v:.4g}" for k, v in err.items())
        + f"; rows cut at a router near-tie: {rows_cut} of {B}")
    return {"max_abs_err": err, "rows_cut": rows_cut, "cut": cut}


def lm_timed_generate(rt, torch, model, params, prompt):
    """greedy_generate's loop with each step timed (synchronised): the
    tokens, the prefill logits, each step's logits, prefill ms and each
    decode's ms."""
    S = prompt.shape[1]
    prefill = rt.lm_prefill_step(model, LM_CACHE, last_only=False)
    decode = rt.lm_decode_step(model)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, decode_ms = [logits[:, -1]], []
        tokens = [prompt, logits[:, -1:].argmax(-1).to(prompt.dtype)]
        for i in range(LM_NEW - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = decode(params, caches, tokens[-1], S + i)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(lg[:, -1])
            tokens.append(lg[:, -1:].argmax(-1).to(prompt.dtype))
    return torch.cat(tokens, dim=1), logits, steps, prefill_ms, decode_ms


LM_KERNEL_GROUPS = (("products", ("gemm", "cutlass", "xmma", "nvjet")),
                    ("copies and casts", ("copy",)),
                    ("softmax", ("softmax",)))


def lm_trace(rt, torch, model, params, prompt, steps: int = 3) -> dict:
    """torch.profiler over ``steps`` decode steps after a prefill: the
    card's busy share of their wall, device time by kernel group (GEMMs;
    copies, which are the bf16 casts of the fp32 weights and the cache
    writes; softmax; the rest) and kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    S = prompt.shape[1]
    decode = rt.lm_decode_step(model)
    with torch.no_grad():
        logits, caches = rt.lm_prefill_step(model, LM_CACHE)(
            params, {"tokens": prompt})
        token = logits.argmax(-1).to(prompt.dtype)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                _, caches = decode(params, caches, token, S + i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = [ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")]
    by_group = {name: 0.0 for name, _ in LM_KERNEL_GROUPS}
    by_group["other"] = 0.0
    by_name: dict = {}
    for ev in dev:
        us = ev.time_range.elapsed_us()
        low = ev.name.lower()
        group = next((g for g, keys in LM_KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        by_group[group] += us / steps
        # a kernel's name and the functor it runs, without the templates
        label = " ".join(dict.fromkeys(re.findall(
            r"\w+_kernel\w*|\w+Functor\w*|nvjet\w*|cutlass_\w+", ev.name)))
        label = label[:80] or ev.name[:80]
        by_name[label] = by_name.get(label, 0.0) + us / steps
    device_us = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_us_a_step": wall_us / steps,
            "device_us_a_step": device_us,
            "busy_share": device_us * steps / wall_us,
            "kernels_a_step": len(dev) / steps,
            "device_us_by_group": by_group, "top_kernels_us": dict(top)}


def lm_teacher_forced(out, steps, full, P: int, margin: float):
    """Greedy token i against the argmax of ``full`` (forward_train over
    the generated prefix) at position P + i - 1, at the steps whose top-2
    margin there exceeds ``margin`` -> (compared, skipped, differing, the
    largest |step logits - forward's|)."""
    compared = skipped = differing = 0
    err = 0.0
    for i, step in enumerate(steps):
        ref = full[:, P + i - 1].float()
        top2 = ref.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= margin
        same = ref.argmax(-1) == out[:, P + i].long()
        compared += int((~near).sum())
        skipped += int(near.sum())
        differing += int((~near & ~same).sum())
        err = max(err, float((step.float() - ref).abs().max()))
    return compared, skipped, differing, err


def lm_full(rt, torch, arch: str) -> dict:
    """A full() config at full width and depth with random weights from a
    seeded generator on the card: 4 prompts of 64 tokens, 32 greedy tokens
    into a cache of 128, served at the config's bf16 (times beside the
    bound; the prefill against forward_train; the decode steps no farther
    from the fp32 forward than bf16 forward_train is) and at fp32 compute
    (every greedy token against the teacher-forced argmax)."""
    cfg = rt.lm_configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()        # what earlier phases hold
    t0 = time.perf_counter()
    model = rt.lm_build(cfg)
    params, _ = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem = (torch.cuda.memory_allocated() - base) / 2 ** 30
    n_params = sum(t.numel() for _, t in lm_leaves(params))
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN)).astype(np.int32)).to(DEV)
    # a first pass warms the allocator and the GEMM heuristics
    lm_timed_generate(rt, torch, model, params, prompt[:, :8])
    out, pre_logits, steps, prefill_ms, decode_ms = lm_timed_generate(
        rt, torch, model, params, prompt)
    P, what = LM_PROMPT_LEN, f"[lm:full {arch}]"
    model32 = rt.lm_build(dataclasses.replace(cfg, compute_dtype="float32"))
    with torch.no_grad():
        again = rt.lm_greedy(model, params, prompt, LM_NEW, LM_CACHE)
        check(torch.equal(again, out),
              f"{what} greedy_generate differs from the timed loop")
        fwd_prompt, _ = model.forward_train(params, prompt)
        full, _ = model.forward_train(params, out[:, :-1])
        ref32, _ = model32.forward_train(params, out[:, :-1])
    torch.cuda.synchronize()
    check(out.shape == (LM_PROMPTS, P + LM_NEW),
          f"{what} output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(full).all()), f"{what} non-finite logits")
    prefill_err = lm_max_err(torch, pre_logits, fwd_prompt,
                             f"{what} prefill against forward")
    # bf16: through the whole depth the decode path and forward_train each
    # land up to a few tenths from the fp32 function; the decode path must
    # be no farther from it than forward_train is. Its tokens against the
    # bf16 forward's argmax are reported, not required.
    c16, s16, d16, step_err = lm_teacher_forced(out, steps, full, P,
                                                2 * LM_TOL)
    step32_err = max(float((st.float() - ref32[:, P + i - 1]).abs().max())
                     for i, st in enumerate(steps))
    fwd32_err = float((full[:, P - 1:] - ref32[:, P - 1:]).abs().max())
    check(step32_err <= 1.5 * fwd32_err + LM_TOL,
          f"{what} decode {step32_err:.4g} from the fp32 forward, "
          f"forward_train {fwd32_err:.4g}")
    # fp32 compute, same weights: the teacher-forced check
    out32, _, steps32, _, _ = lm_timed_generate(rt, torch, model32, params,
                                                prompt)
    with torch.no_grad():
        full32, _ = model32.forward_train(params, out32[:, :-1])
    compared, skipped, failed, err32 = lm_teacher_forced(
        out32, steps32, full32, P, 2 * LM_TOL32)
    check(err32 <= LM_TOL32, f"{what} fp32 decode {err32:.4g} from the fp32 "
          "forward")
    check(failed == 0, f"{what} {failed} fp32 greedy tokens differ from "
          "the teacher-forced argmax")
    check(compared > 0, f"{what} every step a near tie")
    bound_ms = rt.lm_analytic.bytes_model(cfg, "decode", LM_CACHE,
                                          LM_PROMPTS) / HBM_BYTES_PER_S * 1e3
    trace = lm_trace(rt, torch, model, params, prompt)
    res = {"params": n_params, "init_s": init_s, "mem_after_init_gib": mem,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
           "prefill_ms": prefill_ms,
           "decode_ms_p50": statistics.median(decode_ms),
           "decode_ms_min": min(decode_ms), "decode_ms_max": max(decode_ms),
           "decode_bound_ms": bound_ms, "prefill_max_abs_err": prefill_err,
           "decode_vs_forward_max_abs_err": step_err,
           "decode_vs_fp32_forward_max_abs_err": step32_err,
           "forward_vs_fp32_forward_max_abs_err": fwd32_err,
           "bf16_tokens": {"compared": c16, "skipped_near_ties": s16,
                           "differing": d16},
           "fp32_decode_vs_forward_max_abs_err": err32,
           "teacher_forced_fp32": {"compared": compared, "skipped_near_ties":
                                   skipped, "failed": failed},
           "decode_trace": trace}
    log(f"[lm:full {arch}] {n_params / 1e9:.3f} G params fp32, init "
        f"{init_s:.1f} s, card memory after init {mem:.2f} GiB (peak "
        f"{res['peak_gib']:.2f}); prefill {LM_PROMPTS}x{P} "
        f"{prefill_ms:.1f} ms; decode p50 {res['decode_ms_p50']:.2f} ms a "
        f"token (min {res['decode_ms_min']:.2f}, max "
        f"{res['decode_ms_max']:.2f}) against a bound of {bound_ms:.3f} ms "
        f"(bytes_model over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); prefill vs "
        f"forward {prefill_err:.4g}; decode vs forward {step_err:.4g}, vs the "
        f"fp32 forward {step32_err:.4g} (forward {fwd32_err:.4g}); bf16 "
        f"tokens equal to forward's argmax at {c16 - d16} of {c16} steps "
        f"with a margin over {2 * LM_TOL} ({s16} closer); fp32 teacher-"
        f"forced: decode vs forward {err32:.3g}, {compared} compared, "
        f"{skipped} near ties skipped, {failed} failed")
    log(f"[lm:trace {arch}] a profiled decode step: "
        f"{trace['wall_us_a_step'] / 1e3:.2f} ms wall, "
        f"{trace['device_us_a_step'] / 1e3:.2f} ms on the card (busy "
        f"{100 * trace['busy_share']:.1f}%), "
        f"{trace['kernels_a_step']:.0f} kernels; by group (ms): "
        + ", ".join(f"{g} {us / 1e3:.2f}"
                    for g, us in trace["device_us_by_group"].items())
        + "; top: " + "; ".join(f"{n} {us / 1e3:.2f}"
                                for n, us in trace["top_kernels_us"].items()))
    del model, model32, params, steps, steps32, full, full32, ref32, \
        fwd_prompt, pre_logits, out, out32, again
    torch.cuda.empty_cache()
    return res


def phase_lm(rt, torch, card: str) -> dict:
    """[lm:smoke] every arch's smoke() config on the card against the CPU;
    [lm:full] three full() configs served greedily at full width."""
    t0 = time.perf_counter()
    log(f"[lm] {card}")
    out = {"smoke": {a: lm_smoke(rt, torch, a)
                     for a in rt.lm_configs.list_archs()}}
    out["full"] = {a: lm_full(rt, torch, a) for a in LM_FULL_ARCHS}
    out["seconds"] = time.perf_counter() - t0
    log(f"[lm] {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# [train]: the LM substrate's training path
# --------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)  # [train:smoke]
TRAIN_SMOKE_STEPS = 4
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 12
# card against CPU, each step: losses (and aux losses) within this at fp32
# compute, LM_TOL at bf16; grad_norm within these relative bounds; every
# parameter within 2.1 x the sum of the steps' learning rates (Adam's first
# steps are sign-like: a grad near zero of either sign moves a parameter by
# up to lr either way)
TRAIN_LOSS_TOL32 = 1e-4
TRAIN_GNORM_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# [train:full]: 8 steps of batch 4 x 128 on one repeated batch, the CLI's
# schedule for --steps 8 (lr 3e-4, warmup 2)
TRAIN_FULL_ARCHS = ("qwen2.5-3b", "xlstm-125m")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 128, 8
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 (data sheet)
ADAM_BYTES_PER_PARAM = 28     # read p, g, m, v; write p, m, v (fp32)
TRAIN_DIR = OUT_DIR / "smoke_train"
TRAIN_TIMEOUT = 300
# the kernel groups of a profiled train step (the optimizer by its range)
TRAIN_KERNEL_GROUPS = (("GEMMs", ("gemm", "cutlass", "xmma", "nvjet")),
                       ("casts and copies", ("copy",)),
                       ("zero fills", ("fill",)))


def state_to(rt, state, device):
    """A copy of a TrainState on ``device`` (``rng`` stays on the CPU)."""
    move = lambda t: t.to(device, copy=True)
    return state._replace(step=move(state.step),
                          params=lm_tree(move, state.params),
                          opt_state=lm_tree(move, state.opt_state),
                          rng=state.rng.clone())


def train_batch(cfg, rng):
    B, S = TRAIN_SMOKE_B, TRAIN_SMOKE_S
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_enc_layers:
        b["enc_feats"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b["vis_embeds"] = rng.normal(size=(B, 4, cfg.d_model)) \
            .astype(np.float32)
    return b


def cut_labels_at_ties(rt, torch, model, params, batch) -> tuple[dict, int]:
    """bf16 MoE: labels of each row masked (-1) from its first router near
    tie on the CPU (another device may pick another expert there); the
    count of rows cut."""
    with RouteMargins(rt) as margins, torch.no_grad():
        model.forward_train(params, batch["tokens"],
                            enc_feats=batch.get("enc_feats"),
                            vis_embeds=batch.get("vis_embeds"))
    B, S = batch["labels"].shape
    labels = batch["labels"].copy()
    cut = margins.cut(B, S)
    for b, n in enumerate(cut):
        labels[b, n:] = -1
    return dict(batch, labels=labels), sum(n < S for n in cut)


def param_gap(rt, torch, a, b) -> float:
    leaves = rt.train_optim.tree_leaves
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def train_smoke(rt, torch, arch: str, dtype: str) -> dict:
    """TRAIN_SMOKE_STEPS train steps of a smoke() config on the card and on
    the CPU from the same state and batch."""
    cfg = rt.lm_configs.get(arch, smoke=True)
    if dtype != cfg.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    what = f"[train:smoke {arch} {dtype}]"
    opt = rt.AdamWConfig(**TRAIN_OPT)
    cpu = rt.lm_build(cfg, "cpu")
    state_cpu = rt.make_init_state(cpu, opt)(
        torch.Generator().manual_seed(SEED))
    state = state_to(rt, state_cpu, DEV)
    batch = train_batch(cfg, np.random.default_rng(SEED))
    rows_cut = 0
    if dtype == "bfloat16" and cfg.moe is not None:
        batch, rows_cut = cut_labels_at_ties(rt, torch, cpu,
                                             state_cpu.params, batch)
    step_cpu = rt.make_train_step(cpu, opt)
    step_dev = rt.make_train_step(rt.lm_build(cfg, DEV), opt)
    loss_tol = TRAIN_LOSS_TOL32 if dtype == "float32" else LM_TOL
    lr_sum, losses, err = 0.0, [], {"loss": 0.0, "grad_norm_rel": 0.0,
                                    "params": 0.0}
    for i in range(TRAIN_SMOKE_STEPS):
        state_cpu, want = step_cpu(state_cpu, batch)
        state, got = step_dev(state, batch)
        check(set(got) == set(want), f"{what} metrics {sorted(got)}")
        for k in set(want) - {"accuracy", "grad_norm", "lr"}:
            d = abs(float(got[k]) - float(want[k]))
            check(d <= loss_tol, f"{what} step {i + 1} {k}: card "
                  f"{float(got[k]):.6g}, cpu {float(want[k]):.6g}")
            err["loss"] = max(err["loss"], d)
        g, w = float(got["grad_norm"]), float(want["grad_norm"])
        err["grad_norm_rel"] = max(err["grad_norm_rel"], abs(g - w) / w)
        check(abs(g - w) <= TRAIN_GNORM_RTOL[dtype] * w,
              f"{what} step {i + 1} grad_norm: card {g:.6g}, cpu {w:.6g}")
        lr_sum += float(want["lr"])
        gap = param_gap(rt, torch, state.params, state_cpu.params)
        err["params"] = max(err["params"], gap)
        check(gap <= 2.1 * lr_sum, f"{what} step {i + 1}: a parameter "
              f"{gap:.3g} from the CPU's, bound {2.1 * lr_sum:.3g}")
        check(int(state.step) == i + 1 and np.array_equal(
            state.rng.numpy(), state_cpu.rng.numpy()),
              f"{what} step or rng differs")
        losses.append(float(got["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{what} losses {losses}")
    return {"losses": losses, "max_abs_err": err, "rows_cut": rows_cut,
            "params_bound": 2.1 * lr_sum}


def train_trace(rt, torch, step_fn, state, batch):
    """One torch.profiler'd train step: its wall, the card's busy share,
    kernels, device time by group (the optimizer by its
    ``record_function`` range on the card's timeline) and the autograd
    nodes that select one layer of a stacked leaf."""
    from torch.profiler import ProfilerActivity, profile, record_function
    optim = rt.train_optim
    update = optim.adamw_update

    def marked(*args, **kw):
        with record_function("adamw_update"):
            return update(*args, **kw)

    optim.adamw_update = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        optim.adamw_update = update
    events = prof.events()
    on_dev = lambda ev: str(ev.device_type).endswith("CUDA")
    dev = [ev for ev in events if on_dev(ev)]
    # the range's annotation on the card's timeline, where the profiler
    # records one; else its kernels' time through the host range
    marks = [ev for ev in dev if ev.name == "adamw_update"]
    kernels = [ev for ev in dev if ev.name != "adamw_update"]
    span = (min(ev.time_range.start for ev in marks),
            max(ev.time_range.end for ev in marks)) if marks else None
    groups = {name: 0.0 for name, _ in TRAIN_KERNEL_GROUPS}
    groups.update({"optimizer": 0.0, "other": 0.0})
    for ev in kernels:
        us = ev.time_range.elapsed_us()
        low = ev.name.lower()
        if span and span[0] <= ev.time_range.start <= span[1]:
            group = "optimizer"
        else:
            group = next((g for g, keys in TRAIN_KERNEL_GROUPS
                          if any(k in low for k in keys)), "other")
        groups[group] += us
    if span is None:           # the optimizer's kernels are elementwise
        host = [ev for ev in events
                if ev.name == "adamw_update" and not on_dev(ev)]
        groups["optimizer"] = sum(ev.device_time_total for ev in host)
        groups["other"] -= groups["optimizer"]
    device_us = sum(groups.values())
    nodes = {}
    for ev in events:          # bare and engine-wrapped autograd nodes
        for node in ("SelectBackward0", "UnbindBackward0"):
            if node in ev.name and not on_dev(ev):
                nodes[ev.name] = nodes.get(ev.name, 0) + 1
    return state, {"wall_us": wall_us, "device_us": device_us,
                   "busy_share": device_us / wall_us,
                   "kernels": len(kernels), "device_us_by_group": groups,
                   "optimizer_on_timeline": span is not None,
                   "autograd_nodes": nodes}


def train_full(rt, torch, arch: str, trace: bool) -> tuple[dict, object]:
    """A full() config at full width and depth, random fp32 weights from a
    seeded generator on the card: TRAIN_STEPS in-place train steps of batch
    TRAIN_B x TRAIN_S (one repeated synthetic_batch) at the config's bf16
    with remat; step ms beside the bound; the state after them."""
    cfg = rt.lm_configs.get(arch)
    what = f"[train:full {arch}]"
    gc.collect()            # no earlier garbage freed inside the counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = rt.lm_build(cfg)
    opt = rt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    req_base = requested_bytes(torch)
    state = rt.make_init_state(model, opt)(
        torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_alloc = torch.cuda.memory_allocated() - base
    state_req = None if req_base is None else \
        requested_bytes(torch) - req_base
    state_gib = state_alloc / 2 ** 30
    # the state's leaves as [dryrun:full] holds them against the dry-run
    state_leaves = [(p, list(t.shape), str(t.dtype), t.device.type,
                     t.numel() * t.element_size())
                    for p, t in rt.dr_analysis.flatten(state)]
    n_params = sum(t.numel() for _, t in lm_leaves(state.params))
    batch = rt.synthetic_batch(0, cfg.vocab, TRAIN_B, TRAIN_S)
    step_fn = rt.make_train_step(model, opt)
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(all(np.isfinite(losses)), f"{what} losses {losses}")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    check(int(state.step) == TRAIN_STEPS, f"{what} step {int(state.step)}")
    fb = rt.lm_analytic.flops_model(cfg, "train", TRAIN_S, TRAIN_B)
    gemm_ms = fb.computed_flops / BF16_FLOPS_PER_S * 1e3
    adam_ms = ADAM_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    p50 = statistics.median(step_ms[1:])
    res = {"params": n_params, "init_s": init_s, "state_gib": state_gib,
           "state_leaves": state_leaves, "state_alloc_bytes": state_alloc,
           "state_requested_bytes": state_req,
           "peak_gib": peak, "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": TRAIN_B * TRAIN_S / p50 * 1e3,
           "losses": losses, "flops": fb.computed_flops,
           "bound_ms": gemm_ms + adam_ms, "bound_flops_ms": gemm_ms,
           "bound_optimizer_ms": adam_ms}
    log(f"{what} {n_params / 1e9:.3f} G params fp32, remat "
        f"{cfg.remat}; state (params, mu, nu) {state_gib:.2f} GiB after init "
        f"({init_s:.1f} s); {TRAIN_STEPS} steps of {TRAIN_B}x{TRAIN_S}: "
        f"step p50 {p50:.1f} ms (steps 2-{TRAIN_STEPS}; first "
        f"{step_ms[0]:.1f} ms, min {min(step_ms[1:]):.1f}, max "
        f"{max(step_ms[1:]):.1f}), {res['tokens_per_s']:,.0f} tokens/s, "
        f"against a bound of {res['bound_ms']:.2f} ms "
        f"({fb.computed_flops / 1e12:.2f} TFLOP over "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s = {gemm_ms:.2f} "
        f"ms, plus {ADAM_BYTES_PER_PARAM} B a parameter over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {adam_ms:.2f} ms); peak "
        f"{peak:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if trace:
        state, tr = train_trace(rt, torch, step_fn, state, batch)
        tr["busy_share_of_p50"] = tr["device_us"] / (p50 * 1e3)
        res["trace"] = tr
        log(f"[train:trace {arch}] a profiled step: {tr['wall_us'] / 1e3:.1f}"
            f" ms wall, {tr['device_us'] / 1e3:.1f} ms on the card (busy "
            f"{100 * tr['busy_share']:.1f}% of it, "
            f"{100 * tr['busy_share_of_p50']:.1f}% of the unprofiled p50), "
            f"{tr['kernels']} kernels; by group (ms): " + ", ".join(
                f"{g} {us / 1e3:.2f}"
                for g, us in tr["device_us_by_group"].items())
            + f"; autograd nodes {tr['autograd_nodes']}")
        check(not any("SelectBackward0" in n for n in tr["autograd_nodes"]),
              f"[train:trace {arch}] a stacked leaf selected a layer at a "
              "time in the backward pass")
    return res, state


def train_ckpt(rt, torch, state) -> dict:
    """The AsyncCheckpointer on a full state: the host copy (save()) and
    the write (wait()) timed apart, then a restore to the card compared
    leaf by leaf, bit for bit."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    mgr = rt.CheckpointManager(TRAIN_DIR / "ckpt")
    ac = rt.AsyncCheckpointer(mgr)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in rt.train_optim.tree_leaves(
                      {"p": state.params, "o": state.opt_state}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ac.save(int(state.step), state)
    t1 = time.perf_counter()
    ac.wait()
    t2 = time.perf_counter()
    restored, step = mgr.restore(state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(step == int(state.step), f"[train:ckpt] restored step {step}")
    same = all(torch.equal(a, b) for a, b in zip(
        rt.train_optim.tree_leaves({"p": restored.params,
                                    "o": restored.opt_state}),
        rt.train_optim.tree_leaves({"p": state.params,
                                    "o": state.opt_state})))
    check(same and torch.equal(restored.step, state.step)
          and np.array_equal(restored.rng.numpy(), state.rng.numpy()),
          "[train:ckpt] a restored leaf differs")
    on = restored.params["embed"]["tok"].device.type
    check(on == torch.device(DEV).type, "[train:ckpt] restored off the card")
    res = {"bytes": n_bytes, "host_copy_s": t1 - t0, "write_s": t2 - t1,
           "restore_s": t3 - t2}
    log(f"[train:ckpt] {n_bytes / 2 ** 30:.2f} GiB state: save() (host "
        f"copy) {res['host_copy_s']:.2f} s, write {res['write_s']:.2f} s, "
        f"restore to the card {res['restore_s']:.2f} s; every leaf "
        "bit-equal")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return res


def restart_child(root: str) -> int:
    """[train:restart]'s child process (deterministic algorithms from its
    first CUDA call): qwen3-4b smoke under run_with_restarts, clean and
    with failures injected at steps 5 and 9, checkpoints under ``root``;
    prints one JSON line."""
    import torch
    torch.use_deterministic_algorithms(True)
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import FailureInjector, run_with_restarts
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_init_state,
                                   make_train_step)
    from repro_torch.train.optim import tree_leaves
    cfg = configs.get("qwen3-4b", smoke=True)
    model = build_model(cfg, DEV)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    init, step = make_init_state(model, opt), make_train_step(model, opt)
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (64, 2, 12)).astype(np.int32)).to(DEV)

    def step_fn(state, i):
        state, m = step(state, {"tokens": data[i % 64],
                                "labels": data[i % 64]})
        return state, {"loss": float(m["loss"])}

    runs = {}
    for name, fail in (("clean", set()), ("crashed", {5, 9})):
        runs[name] = run_with_restarts(
            lambda: init(torch.Generator(device=DEV).manual_seed(SEED)),
            step_fn, CheckpointManager(Path(root) / name), total_steps=12,
            checkpoint_every=4, injector=FailureInjector(fail_at=fail))
    (a, log_a, ra), (b, log_b, rb) = runs["clean"], runs["crashed"]
    losses = lambda entries: {m["step"]: m["loss"] for m in entries}
    print(json.dumps({
        "restarts": [ra, rb], "steps_run": [len(log_a), len(log_b)],
        "losses_equal": losses(log_a) == losses(log_b),
        "losses": [m["loss"] for m in log_a],
        "params_equal": all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a.params), tree_leaves(b.params)))}))
    return 0


def train_restart(rt, torch) -> dict:
    """qwen3-4b smoke under run_with_restarts on the card, clean and with
    failures injected at steps 5 and 9, in a child process with
    deterministic algorithms: the losses and final parameters equal."""
    env = cli_env()
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.restart_child(sys.argv[1]))",
             str(TRAIN_DIR)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=TRAIN_TIMEOUT)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"[train:restart] child exited "
          f"{proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["seconds"] = secs
    check(res["restarts"] == [0, 2], f"[train:restart] restarts "
          f"{res['restarts']}")
    check(res["losses_equal"] and res["params_equal"],
          "[train:restart] the restarted run differs from the clean run")
    log(f"[train:restart] qwen3-4b smoke, 12 steps, checkpoints every 4, "
        f"failures at 5 and 9: restarts {res['restarts'][1]}, "
        f"{res['steps_run'][1]} steps run (clean {res['steps_run'][0]}), "
        "losses and parameters bit-equal to the clean run (deterministic "
        f"algorithms); {secs:.1f} s")
    return res


def train_cli() -> dict:
    """``python -m repro_torch.launch.train`` on the card: 6 steps with a
    checkpoint every 3, then resumed to 9."""
    ck = TRAIN_DIR / "cli"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "xlstm-125m", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(ck)]
    res = {}
    try:
        for name, extra in (("first", ["--steps", "6", "--ckpt-every", "3"]),
                            ("resumed", ["--steps", "9"])):
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra, cwd=ROOT, env=cli_env(),
                                  capture_output=True, text=True,
                                  timeout=TRAIN_TIMEOUT)
            secs = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            check(proc.returncode == 0 and lines and lines[-1] == "done",
                  f"[train:cli {name}] exited {proc.returncode}:\n"
                  f"{(proc.stdout + proc.stderr)[-3000:]}")
            res[name] = {"seconds": secs, "lines": lines}
        check(res["resumed"]["lines"][0] == "resumed from step 5",
              f"[train:cli] {res['resumed']['lines'][:1]}")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"[train:cli] xlstm-125m smoke on the card: 6 steps in "
        f"{res['first']['seconds']:.1f} s ({res['first']['lines'][-2]}); "
        f"resumed from step 5 to 9 in {res['resumed']['seconds']:.1f} s "
        f"({res['resumed']['lines'][-2]})")
    return res


def phase_train(rt, torch, card: str) -> dict:
    """[train:smoke] every arch's smoke() config, card against CPU, at fp32
    and bf16 compute; [train:full] qwen2.5-3b and xlstm-125m at full width
    ([train:trace] a profiled qwen2.5-3b step); [train:ckpt];
    [train:restart]; [train:cli]."""
    t0 = time.perf_counter()
    log(f"[train] {card}")
    out = {"smoke": {}}
    for arch in rt.lm_configs.list_archs():
        for dtype in ("float32", "bfloat16"):
            r = train_smoke(rt, torch, arch, dtype)
            out["smoke"][f"{arch} {dtype}"] = r
            log(f"[train:smoke {arch} {dtype}] {TRAIN_SMOKE_STEPS} steps, "
                "card against cpu: max |loss| "
                f"{r['max_abs_err']['loss']:.3g}, grad_norm rel "
                f"{r['max_abs_err']['grad_norm_rel']:.3g}, params "
                f"{r['max_abs_err']['params']:.3g} (bound "
                f"{r['params_bound']:.3g}); losses "
                + " ".join(f"{x:.4f}" for x in r["losses"])
                + (f"; rows cut at a router near tie: {r['rows_cut']}"
                   if r["rows_cut"] else ""))
    out["full"] = {}
    for arch in TRAIN_FULL_ARCHS:
        res, state = train_full(rt, torch, arch,
                                trace=arch == TRAIN_FULL_ARCHS[0])
        out["full"][arch] = res
        if arch == "xlstm-125m":
            out["ckpt"] = train_ckpt(rt, torch, state)
        del state
        torch.cuda.empty_cache()
    out["restart"] = train_restart(rt, torch)
    out["cli"] = train_cli()
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# [dryrun]: the analytic dry-run held against the card
# --------------------------------------------------------------------------

DRYRUN_TIMEOUT = 300
DRYRUN_FULL_ARCH = "qwen2.5-3b"       # [train:full]'s state
ALLOC_BLOCK = 512     # the caching allocator rounds each block up to this
CARD_BYTES = 80e9


def requested_bytes(torch):
    """The caching allocator's count of requested bytes (each allocation's
    own size, unrounded), or None where this torch does not keep it."""
    v = torch.cuda.memory_stats().get("requested_bytes.all.current")
    return None if v is None else int(v)


def round_block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def on_host(path: str) -> bool:
    """The train state's PRNG key, which the port's step keeps on the
    host (JAX's is an argument like any other)."""
    return path.endswith("/rng")


def dryrun_cli(rt) -> dict:
    """``python -m repro_torch.launch.dryrun`` (every arch, shape and
    production mesh at full width) in a child process: exit 0, per mesh 32
    ok, 8 skipped and 1 COBS record, no error, CUDA never initialised."""
    out = OUT_DIR / "dryrun.jsonl"
    out.unlink(missing_ok=True)          # the dry-run appends
    code = ("import sys, torch\n"
            "from repro_torch.launch import dryrun\n"
            f"rc = dryrun.main(['--out', {str(out)!r}])\n"
            "print('CUDA_INITIALIZED', torch.cuda.is_initialized())\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=cli_env(),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"[dryrun:cli] exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check("CUDA_INITIALIZED False" in proc.stdout,
          "[dryrun:cli] the dry-run initialised CUDA")
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    res = {"seconds": secs, "meshes": {}}
    for mesh in ("single-pod-16x16", "multi-pod-2x16x16"):
        mine = [r for r in recs if r["mesh"] == mesh]
        lm = [r for r in mine if r["arch"] != "cobs-index"]
        cobs = [r for r in mine if r["arch"] == "cobs-index"]
        ok = [r for r in lm if r["status"] == "ok"]
        n = {"ok": len(ok), "skipped": sum(r["status"] == "skipped"
                                           for r in lm),
             "cobs": len(cobs), "errors": sum(r["status"] == "error"
                                              for r in mine)}
        check(n == {"ok": 32, "skipped": 8, "cobs": 1, "errors": 0}
              and cobs[0]["status"] == "ok",
              f"[dryrun:cli] {mesh}: {n}")
        args = {f"{r['arch']} x {r['shape']}":
                r["memory"]["argument_size_in_bytes"] for r in ok}
        worst = max(args, key=args.get)
        n.update(index_bytes_per_chip=cobs[0]["index_bytes_per_chip"],
                 over_card=sorted(k for k, v in args.items()
                                  if v > CARD_BYTES),
                 largest=(worst, args[worst]),
                 bottlenecks={b: sum(r["roofline"].get("bottleneck") == b
                                     for r in ok)
                              for b in ("compute", "memory", "collective")},
                 coll_lower_bound=sorted(
                     f"{r['arch']} x {r['shape']}" for r in ok
                     if "t_collective_min_s" in r["roofline"]))
        res["meshes"][mesh] = n
        log(f"[dryrun:cli] {mesh}: {n['ok']} ok, {n['skipped']} skipped, "
            f"1 COBS cell ({n['index_bytes_per_chip']:,} index bytes a "
            f"device), 0 errors; arguments alone a device (a lower bound "
            f"of its memory: no temporaries) above 80 GB in "
            f"{len(n['over_card'])} cells, the largest {worst} "
            f"({args[worst]:,} B); bottlenecks {n['bottlenecks']}, and "
            f"{len(n['coll_lower_bound'])} cells whose collective time is "
            f"a lower bound")
    log(f"[dryrun:cli] python -m repro_torch.launch.dryrun: exit 0, CUDA "
        f"never initialised, {secs:.1f} s (child process)")
    return res


def dr_real_args(rt, torch, cell, gen) -> tuple:
    """A smoke cell's arguments made real on the card: parameters (and the
    train state) drawn from ``gen`` by the model's own init, zero caches,
    tokens in range, fp32 encoder features."""
    cfg, s, model = cell.cfg, cell.shape, cell.model
    B, S = s.global_batch, s.seq_len

    def tokens(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=DEV,
                             dtype=torch.int32)

    def batch(labels: bool) -> dict:
        b = {"tokens": tokens(B, S)}
        if labels:
            b["labels"] = tokens(B, S)
        if cfg.n_enc_layers:
            b["enc_feats"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                         generator=gen, device=DEV)
        return b

    if s.mode == "train":
        return (rt.make_init_state(model, rt.AdamWConfig())(gen),
                batch(True))
    params, _ = model.init(gen)
    if s.mode == "prefill":
        return params, batch(False)
    return (params, model.init_cache(B, S), tokens(B, 1),
            torch.full((), S // 2, dtype=torch.int32, device=DEV))


def leaf_sig(flat) -> list:
    return [(p, list(t.shape), str(t.dtype)) for p, t in flat]


def dryrun_smoke(rt, torch) -> dict:
    """Each supported smoke cell on a (1, 1) mesh of the card: its
    arguments made real, the allocated bytes equal to the dry-run's
    per-leaf prediction in the allocator's 512-byte blocks (and the
    requested bytes to the prediction itself), the step run once: its
    outputs the predicted leaves, finite, and the peak above the
    arguments printed as the measured temp."""
    an, sp = rt.dr_analysis, rt.dr_specs
    mesh = rt.make_mesh((1, 1), ("data", "model"))
    gen = torch.Generator(device=DEV)
    out = {}
    for arch in rt.lm_configs.list_archs():
        for shape in sp.SHAPES:
            if not sp.cell_supported(rt.lm_configs.get(arch, smoke=True),
                                     shape)[0]:
                continue
            what = f"[dryrun:smoke {arch} x {shape}]"
            cell = sp.make_cell(arch, shape, mesh, smoke=True)
            mem = an.memory_from_specs(cell.args, cell.in_shardings,
                                       cell.outs, cell.out_specs, mesh,
                                       cell.donate_argnums)
            leaves = an.leaf_bytes(cell.args, cell.in_shardings, mesh)
            want_alloc = sum(round_block(b) for p, b in leaves
                             if not on_host(p))
            want_req = sum(b for p, b in leaves if not on_host(p))
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            req0 = requested_bytes(torch)
            gen.manual_seed(SEED)
            args = dr_real_args(rt, torch, cell, gen)
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated() - base
            req = None if req0 is None else requested_bytes(torch) - req0
            real = an.flatten(args)
            check(leaf_sig(real) == leaf_sig(an.flatten(cell.args)),
                  f"{what} the real arguments' leaves differ from the "
                  "cell's")
            check(all((t.device.type == "cpu") == on_host(p)
                      for p, t in real),
                  f"{what} an argument off the card")
            check(alloc == want_alloc,
                  f"{what} {alloc:,} B allocated for the arguments, "
                  f"predicted {want_alloc:,} ({want_req:,} in 512-B blocks)")
            check(req is None or req == want_req,
                  f"{what} {req} B requested, predicted {want_req}")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cell.shape.mode == "train":
                result = cell.step_fn(*args)
            else:
                with torch.no_grad():
                    result = cell.step_fn(*args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            check(leaf_sig(an.flatten(result))
                  == leaf_sig(an.flatten(cell.outs)),
                  f"{what} the step's outputs differ from the predicted "
                  "leaves")
            check(all(bool(torch.isfinite(t).all()) for _, t in
                      an.flatten(result) if t.is_floating_point()),
                  f"{what} non-finite outputs")
            r = {"predicted": mem, "alloc_bytes": alloc,
                 "requested_bytes": req, "peak_bytes": peak,
                 "temp_bytes": peak - alloc, "step_s": step_s}
            r["temp_over_args"] = r["temp_bytes"] / alloc
            out[f"{arch} x {shape}"] = r
            log(f"{what} arguments {alloc:,} B allocated = predicted "
                f"{want_alloc:,} in 512-B blocks ({want_req:,} B of "
                f"leaves, requested {req if req is None else f'{req:,}'}); "
                f"step {step_s * 1e3:.1f} ms, peak {peak:,} B: measured "
                f"temp {r['temp_bytes']:,} B = {r['temp_over_args']:.2f}x "
                f"the arguments; predicted outputs "
                f"{mem['output_size_in_bytes']:,} B")
            del args, result, real
    torch.cuda.empty_cache()
    return out


def dryrun_full(rt, torch, train: dict) -> dict:
    """The full-width qwen2.5-3b train cell on a (1, 1) "meta" mesh: its
    state leaf by leaf (path, shape, dtype) and in bytes equal to the state
    ``[train:full]`` allocated on the card."""
    an = rt.dr_analysis
    what = f"[dryrun:full {DRYRUN_FULL_ARCH}]"
    mesh = rt.make_mesh((1, 1), ("data", "model"), device="meta")
    t0 = time.perf_counter()
    cell = rt.dr_specs.make_cell(DRYRUN_FULL_ARCH, "train_4k", mesh)
    build_s = time.perf_counter() - t0
    mem = an.memory_from_specs(cell.args, cell.in_shardings, cell.outs,
                               cell.out_specs, mesh, cell.donate_argnums)
    leaves = an.leaf_bytes(cell.args[0], cell.in_shardings[0], mesh)
    state = an.flatten(cell.args[0])
    real = train["full"][DRYRUN_FULL_ARCH]
    got = [(p, shape, dtype) for p, shape, dtype, _, _ in
           real["state_leaves"]]
    check(got == leaf_sig(state),
          f"{what} the dry-run's state leaves differ from [train:full]'s")
    check(all((dev == "cpu") == on_host(p) for p, _, _, dev, _ in
              real["state_leaves"]), f"{what} a state leaf off the card")
    card = sum(leaf[4] for leaf in real["state_leaves"]
               if not on_host(leaf[0]))
    pred = sum(b for p, b in leaves if not on_host(p))
    check(pred == card, f"{what} predicted {pred:,} B of state on the card, "
          f"[train:full] holds {card:,}")
    req = real["state_requested_bytes"]
    check(req is None or req == pred,
          f"{what} [train:full] requested {req} B, predicted {pred}")
    res = {"build_s": build_s, "state_bytes": mem["argument_bytes"][0],
           "state_card_bytes": pred, "train_full_alloc_bytes":
               real["state_alloc_bytes"], "train_full_requested_bytes": req,
           "argument_size_in_bytes": mem["argument_size_in_bytes"],
           "alias_size_in_bytes": mem["alias_size_in_bytes"]}
    log(f"{what} built on meta in {build_s:.2f} s: state {pred:,} B on the "
        f"card (+ {mem['argument_bytes'][0] - pred} B of PRNG key on the "
        f"host) = [train:full]'s {card:,} B of leaves (requested "
        f"{req if req is None else f'{req:,}'}; allocated "
        f"{real['state_alloc_bytes']:,} B in the allocator's blocks, "
        f"{real['state_alloc_bytes'] / 2 ** 30:.2f} GiB); the whole cell "
        f"at batch 256 x 4,096 would take {mem['argument_size_in_bytes']:,}"
        f" B of arguments on one card")
    return res


def dryrun_cobs(rt, dist: dict) -> dict:
    """[dist]'s DistributedIndex slices against ``cobs_padding`` of the
    main index's arena shape on the same (2, 2, 2) mesh."""
    pred = rt.dryrun.cobs_padding(tuple(dist["arena_shape"]), dist["mesh"])
    for method, m in dist["methods"].items():
        check(m["slices"] == pred["n_slices"],
              f"[dryrun:cobs] {method}: {m['slices']} slices, predicted "
              f"{pred['n_slices']}")
        for shape, nb in zip(m["slice_shapes"], m["slice_bytes"]):
            check(tuple(shape) == pred["slice_shape"]
                  and nb == pred["slice_bytes"],
                  f"[dryrun:cobs] {method}: a slice {shape} of {nb:,} B, "
                  f"predicted {pred['slice_shape']} of "
                  f"{pred['slice_bytes']:,}")
    log(f"[dryrun:cobs] arena {tuple(dist['arena_shape'])} on "
        f"{dist['mesh']}: each of the {pred['n_slices']} slices of every "
        f"[dist] method {pred['slice_shape']}, {pred['slice_bytes']:,} B, "
        f"as cobs_padding predicts (rows padded to {pred['rows_padded']:,},"
        f" words to {pred['words_padded']})")
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in pred.items()}


def phase_dryrun(rt, torch, card: str, train: dict, dist: dict) -> dict:
    """[dryrun:cli], [dryrun:smoke], [dryrun:full], [dryrun:cobs]."""
    t0 = time.perf_counter()
    log(f"[dryrun] {card}")
    out = {"cli": dryrun_cli(rt), "smoke": dryrun_smoke(rt, torch),
           "full": dryrun_full(rt, torch, train), "cobs": dryrun_cobs(rt,
                                                                    dist)}
    temps = [r["temp_over_args"] for r in out["smoke"].values()]
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun:smoke] {len(temps)} cells, arguments allocated as "
        f"predicted in every one; measured temp {min(temps):.2f}-"
        f"{max(temps):.2f}x the arguments (median "
        f"{statistics.median(temps):.2f})")
    log(f"[dryrun] {out['seconds']:.1f} s")
    return out


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


def graph_ms(torch, calls, n: int = 64, rounds: int = 5) -> float:
    """Median over rounds of (events around one replay of a CUDA graph of
    n launches cycling over ``calls``) / n: a kernel's device time per
    launch with no host gaps between launches (a graph node adds well
    under a microsecond). The calls must launch on the current stream,
    and it must not be the default stream (which cannot be captured)."""
    s = torch.cuda.current_stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s, capture_error_mode="thread_local"):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    s.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(s)
        graph.replay()
        b.record(s)
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def on_side_stream(torch):
    """A context that makes a fresh stream current (after the current
    one's work), for timing by ``graph_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    return torch.cuda.stream(side)


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
                       k.CLUSTER_AUTO, dev, stream))
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
                       o.data_ptr(), c, L, W, Wp, k.CLUSTER_AUTO, dev,
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
                                          W, k.CLUSTER_AUTO, dev, stream))
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


def phase_timings(rt, torch, index, classic, queries, max_err, launches,
                  comp, chunk, serve) -> tuple[list[dict], list[dict]]:
    """Each wrapper's kernel timed at its path's shapes (the kernels line),
    and the split kernels' extra vertical cases (not in that line)."""
    k = rt.kernels
    q_mod = rt.query
    lib = rt.build.library()
    arena = index.storage.full_device()

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
    # the shortest bucket (40- and 80-bp queries pad to 64 terms), which
    # the planner scores with unpack as singletons
    short_flats = [plan(index, [t])[2][0] for t in term_sets
                   if t.shape[0] <= 64][:BATCH]
    batch_idx, batch_mask, _ = plan(index, term_sets[:BATCH])
    classic_singles = [plan(classic, [t]) for t in long_sets]

    cases = []
    # unpack / vertical on the gathered rows of one 320-term query
    flats = [s[2][0] for s in singles]
    cases += [rows_case(torch, k, lib, "unpack_score", flats),
              rows_case(torch, k, lib, "vertical_score", flats)]
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
    # the split kernels at more shapes, not in the kernels line: vertical on
    # rows [320, 8] (the raw store's one-block tiles; here the gathered
    # rows of the 256-document classic index) and on a batch of 32
    # 320-term queries [32, 320, 64]; unpack and vertical on the rows of a
    # short singleton query, [64, 64]
    extra_cases = [
        rows_case(torch, k, lib, "vertical_score",
                  [s[2][0] for s in classic_singles]),
        rows_case(torch, k, lib, "vertical_score",
                  [plan(index, long_sets)[2]]),
        rows_case(torch, k, lib, "unpack_score", short_flats),
        rows_case(torch, k, lib, "vertical_score", short_flats)]
    # each split case's first inputs: (kernel, its inputs, as split_direct
    # takes them)
    by_name = {c[0]: c for c in cases}
    split_inputs = {
        id(by_name["unpack_score"]): ("unpack", flats[0][None]),
        id(by_name["vertical_score"]): ("vertical", flats[0][None]),
        id(by_name["lookup_score_blocks"]): (
            "lookup", arena, singles[0][0][0], singles[0][1][0]),
        id(by_name["lookup_score_multi"]): ("lookup", arena, batch_idx,
                                         batch_mask),
        id(by_name["lookup_score"]): (
            "lookup", classic.storage.full_device(),
            classic_singles[0][0][0], classic_singles[0][1][0]),
        id(by_name["lookup_score_blocks_compressed"]): (
            "lookup_comp", comp["dict_rows"], comp["refs"],
            comp["singles"][0][0][0], comp["singles"][0][1][0]),
        id(by_name["lookup_score_multi_compressed"]): (
            "lookup_comp", comp["dict_rows"], comp["refs"], *comp["batch"]),
        id(by_name["chunk_dedup_score"]): (
            "chunk_dedup", *chunk["chunk_dedup_score"][0]),
        id(by_name["chunk_lookup_score_multi"]): (
            "chunk_lookup", *chunk["chunk_lookup_score_multi"][0]),
        id(by_name["chunk_lookup_score_multi_compressed"]): (
            "chunk_lookup_comp",
            *chunk["chunk_lookup_score_multi_compressed"][0]),
        id(by_name["dedup_score"]): ("dedup", *serve["dedup_score"][0]),
        id(extra_cases[0]): ("vertical", classic_singles[0][2][0][None]),
        id(extra_cases[1]): ("vertical", extra_cases[1][7]),
        id(extra_cases[2]): ("unpack", short_flats[0][None]),
        id(extra_cases[3]): ("vertical", short_flats[0][None])}
    out, extras = [], []
    for case in cases + extra_cases:
        name, shape, calls, plain, nbytes, nops = case[:6]
        library = case[6] if len(case) > 6 else None
        for c in calls:                                  # warm-up
            c()
        torch.cuda.synchronize()
        # 256 launches, cycling over the queries' inputs
        reps = calls * max(1, 256 // len(calls))
        ev = loop_ms(torch, reps)
        gms = graph_ms(torch, calls)
        line, body, _ = KERNELS[name]
        plain_ms = event_ms(torch, plain, 7)
        library_ms = graph_ms(torch, [library]) if library else None
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        rec = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS}:{line}", "pallas_kernel":
                f"{name} ({body})", "matched": max_err[name] == 0,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": gms, "ms_source": "cuda graph of 64 launches",
            "loop_ms": ev, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": nops, "shape": shape,
            "library_ms": library_ms,
        }
        if id(case) in split_inputs:
            kernel, *inputs = split_inputs[id(case)]
            rec.update(split_sweep(torch, rt, kernel, *inputs))
        (extras if any(case is c for c in extra_cases) else out).append(rec)
        log(f"[time] {name} at {shape}: kernel {rec['ms'] * 1e3:.2f} us "
            f"({rec['ms_source']}), host-launched back-to-back "
            f"{ev * 1e3:.2f} us/launch, plain {plain_ms * 1e3:.1f} us, bound "
            f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']}: {nbytes} "
            f"bytes, {nops} ops)"
            + ("" if library_ms is None else
               f", torch.index_select {library_ms * 1e3:.2f} us"))
        if "launch_shape" in rec:
            ls = rec["launch_shape"]
            log(f"[time] {name} at {shape}: {ls['blocks']} blocks of "
                f"{ls['threads']} threads in clusters of {ls['cluster']}, "
                f"word tile {ls['word_tile']}, {ls['slices']} slices, "
                f"{ls['planes']} planes, {ls['static_smem_bytes']} bytes of "
                f"shared memory, {ls['registers']} registers; kernel us by "
                f"cluster size " + ", ".join(
                    f"{cs}: {t * 1e3:.2f}" for cs, t in
                    rec["cluster_ms"].items()))
    log("[time] library_ms is null except for the two gathers "
        "(torch.index_select): no single PyTorch call computes the other "
        "functions")
    return out, extras


def rows_case(torch, k, lib, name, rows_list):
    """A timing case of unpack_score or vertical_score over rows [L, W] or
    [B, L, W]: (name, shape, direct launches, plain call, bytes,
    operations, library call, the first rows as [B, L, W])."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    r3s = [r if r.dim() == 3 else r[None] for r in rows_list]
    B, L, W = r3s[0].shape
    fn = lib.cobs_unpack if name == "unpack_score" else lib.cobs_vertical
    outs = [torch.empty((B, W, 32), dtype=torch.int32, device=DEV)
            for _ in r3s]
    calls = [(lambda r=r, o=o: fn(r.data_ptr(), o.data_ptr(), B, L, W,
                                   k.CLUSTER_AUTO, dev, stream))
             for r, o in zip(r3s, outs)]
    plain = (k.unpack_score_plain if name == "unpack_score"
             else k.vertical_score_plain)
    ops = B * (2 * L * W * 32 if name == "unpack_score"
               else 2 * k.num_planes(L) * (L * W + W * 32))
    shape = f"rows [{L}, {W}]" if B == 1 else f"rows [{B}, {L}, {W}]"
    return (name, shape, calls, lambda: plain(rows_list[0]),
            B * (L * W * 4 + W * 32 * 4), ops, None, r3s[0])


def split_sweep(torch, rt, kernel, *inputs) -> dict:
    """A split kernel's launch shape at these inputs (the entry point's
    own cluster choice) and its time at each cluster size (``graph_ms``)."""
    dev = torch.cuda.current_device()
    cells, L, W, Wp = split_dims(kernel, inputs)
    shape = rt.build.split_info(kernel, cells, L, W, 0, dev, Wp=Wp)
    times = {}
    for cs in CLUSTERS:
        call = (lambda cs=cs: split_direct(torch, rt, kernel, cs, *inputs))
        call()
        times[cs] = graph_ms(torch, [call])
    return {"launch_shape": shape, "cluster_ms": times}


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
                                      MultiHit, MultiIndexEngine,
                                      QueryEngine, build_classic,
                                      build_compact, codec, dna, hashing,
                                      load_index_v2, query)
        from repro_torch.data import make_corpus, make_queries
        from repro_torch.index import (DistributedIndex, ShardPlacement,
                                       build_compact_streaming)
        from repro_torch.kernels import _build, bitslice_score, ops
        from repro_torch.kernels.autotune import KernelTuner, TuningCache
        from repro_torch.launch.cluster import WorkerCluster
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.serve import make_workload
        from repro_torch.obs.export import parse_prometheus
        from repro_torch.serve import (BulkLane, BulkStatus, Frontend,
                                       FrontendConfig, MetricsSnapshot,
                                       NetClient, NetServer, QueryPlanner,
                                       QueryServer, RpcFrontend,
                                       ServerConfig, ServingLoop,
                                       ShardWorker, Status, WorkerPool,
                                       WorkerServer)
        from repro_torch.serve import server as server_mod
        from repro_torch import configs as lm_configs
        from repro_torch.launch import analytic as lm_analytic
        from repro_torch.models import build_model as lm_build
        from repro_torch.models import moe as lm_moe
        from repro_torch.serve import (greedy_generate, make_decode_step,
                                       make_prefill_step)
        from repro_torch.checkpoint import (AsyncCheckpointer,
                                            CheckpointManager)
        from repro_torch.launch.train import synthetic_batch
        from repro_torch.train import (AdamWConfig, make_init_state,
                                       make_train_step)
        from repro_torch.train import optim as train_optim
        self.IndexParams, self.QueryEngine = IndexParams, QueryEngine
        self.QueryServer, self.ServerConfig = QueryServer, ServerConfig
        self.Status, self.server_mod = Status, server_mod
        self.build_classic, self.build_compact = build_classic, build_compact
        self.hashing, self.query, self.codec = hashing, query, codec
        self.dna = dna
        self.DeviceTileCache, self.load_index_v2 = DeviceTileCache, \
            load_index_v2
        self.build_compact_streaming = build_compact_streaming
        self.make_corpus, self.make_queries = make_corpus, make_queries
        self.build, self.kernels, self.ops = _build, bitslice_score, ops
        self.KernelTuner, self.TuningCache = KernelTuner, TuningCache
        self.QueryPlanner = QueryPlanner
        self.ServingLoop, self.NetServer = ServingLoop, NetServer
        self.NetClient, self.MetricsSnapshot = NetClient, MetricsSnapshot
        self.BulkLane, self.BulkStatus = BulkLane, BulkStatus
        self.parse_prometheus = parse_prometheus
        self.ShardPlacement, self.ShardWorker = ShardPlacement, ShardWorker
        self.Frontend, self.FrontendConfig = Frontend, FrontendConfig
        self.WorkerServer, self.WorkerPool = WorkerServer, WorkerPool
        self.RpcFrontend = RpcFrontend
        self.MultiHit, self.MultiIndexEngine = MultiHit, MultiIndexEngine
        self.DistributedIndex, self.make_mesh = DistributedIndex, make_mesh
        self.WorkerCluster, self.make_workload = WorkerCluster, make_workload
        self.lm_configs, self.lm_analytic = lm_configs, lm_analytic
        self.lm_build, self.lm_moe = lm_build, lm_moe
        self.lm_prefill_step, self.lm_decode_step = make_prefill_step, \
            make_decode_step
        self.lm_greedy = greedy_generate
        self.AdamWConfig, self.train_optim = AdamWConfig, train_optim
        self.make_init_state, self.make_train_step = make_init_state, \
            make_train_step
        self.CheckpointManager, self.AsyncCheckpointer = \
            CheckpointManager, AsyncCheckpointer
        self.synthetic_batch = synthetic_batch
        from repro_torch.launch import analysis as dr_analysis
        from repro_torch.launch import dryrun, specs as dr_specs
        self.dr_analysis, self.dryrun, self.dr_specs = dr_analysis, dryrun, \
            dr_specs


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
        record["select"] = phase_select(rt, torch)
        record["grouped"] = phase_grouped(rt, torch)
        record["long_query"] = phase_long_query(rt, torch, chk)
        main_path, queries, origin, extra, base = phase_main_path(
            rt, torch, corpus, index, chk)
        record["main_path"] = main_path
        record["multi"] = phase_multi(rt, torch, index, extra["classic k=1"],
                                      queries, origin)
        record["dist"] = phase_dist(rt, torch, index, queries, origin, chk)
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
            record["serve"], serve_launches, serve, traffic = phase_serve(
                rt, torch, corpus, index, stores, queries, origin, chk)
            record["tune"], record["tune_launches"] = phase_tune(
                rt, torch, stores, traffic, record["serve"], chk)
            record["net"], record["net_launches"] = phase_net(
                rt, torch, stores, queries, traffic, record["serve"], chk)
            record["multihost"], record["multihost_launches"] = \
                phase_multihost(rt, torch, stores, queries, traffic,
                                record["serve"], chk)
            record["cluster"] = phase_cluster(rt, torch, traffic, stores,
                                              record["multihost"])
            record["cli"] = phase_cli(rt, queries)
        finally:
            shutil.rmtree(STORE_DIR, ignore_errors=True)
        record["trace"] = phase_trace(
            rt, torch, index, queries,
            main_path["methods"]["lookup"]["p50_search_ms"])
        # each kernel's launches on the paths that drive it
        launches = {n: main_path["launches"][n] + store_launches[n]
                    + prune_launches[n] + bulk_launches[n]
                    + serve_launches[n] for n in KERNELS}
        with on_side_stream(torch):      # graph_ms captures this stream
            record["kernels"], record["kernels_extra"] = phase_timings(
                rt, torch, index, extra["classic k=1"], queries, chk.err,
                launches, comp, chunk, serve)
        torch.cuda.synchronize()
        record["lm"] = phase_lm(rt, torch, record["card"])
        record["train"] = phase_train(rt, torch, record["card"])
        record["dryrun"] = phase_dryrun(rt, torch, record["card"],
                                        record["train"], record["dist"])
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
