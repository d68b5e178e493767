"""Kernel autotuner: measured dispatch costs per (arena, batch) shape, with
a persisted on-disk cache, the counterpart of ``repro.kernels.autotune``.

For each batch shape the serving planner asks about, the tuner

1. times each scoring method on a synthetic arena of the index's word
   width (row count capped: keys still carry the REAL shape), through the
   kernel wrappers the port's server calls (see the bias below);
2. for the fused ``lookup`` method (and its fused-decode twin
   ``lookup_c``) also times the row-dedup pair at two unique-row fractions
   and derives the **dedup-rate break-even threshold**, which the planner
   compares against each live batch's dedup rate;
3. for the pruned executor (``lookup_p``) derives the prune-rate
   break-even against the best whole-query dispatch;
4. persists every entry to a JSON ``TuningCache`` (by convention beside a
   v2 store's manifest, ``repro_torch.core.store.tuning_path``), so a
   reopened index serves with measured choices and never re-tunes.

The cache format is the JAX package's (``version: 1``): a file either
package writes loads in the other. The decision logic (break-even fits,
sentinels, keys, live-entry preference) is the JAX tuner's line for line.
It differs in two deliberate ways:

* The port's kernels have no tile knobs, so the tuner takes no knob
  candidates: each method is timed once, and the entry records the first
  of the JAX tuner's candidates (``WORD_BLOCK``, ``TERM_BLOCK``,
  ``GRID_ORDER``). The JAX tuner times every candidate and keeps the
  first of equal times, so under equal timings both record the same
  entry.
* A time is the median host wall time of one call after a warm-up call,
  each call ending in ``torch.cuda.synchronize``: the planner compares
  costs that include what the server pays on the host (the pair's second
  launch, the fused path's range check, which waits for the card), not
  device time alone.

The timed calls are not the whole served path, and the gap is biased
against the dedup pair: the pair is charged its host plan
(``np.unique`` over the batch, ``_measure_plan_host``), while the fused
lookup and the ADD methods are timed from ready row indices, without the
hashing and row planning the server runs before them. On an H100 at the
dense read batch this prices the pair out (dedup threshold 2.0) although
served kernel spans show it the cheapest path (PERF.md, sections 6 and 7;
ROADMAP, the dedup pair's open question).

Layering: this module sits with the kernels (it imports ``ops``); the
serving planner (``repro_torch.serve.planner``) consults it.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import bitslice_score as _k
from . import ops

CACHE_VERSION = 1
DEFAULT_WORD_BLOCKS = (64, 128, 256)
DEFAULT_TERM_BLOCKS = (8, 16)
# the JAX kernels' default term tile (repro.kernels.bitslice_score), the
# term_block recorded for the fused methods
DEFAULT_TERM_BLOCK = 8
# The knobs an entry records: the first of the JAX tuner's candidates,
# which it keeps when all candidates time the same (the port's kernels
# have no tile knobs, so the port times each method once).
WORD_BLOCK = DEFAULT_WORD_BLOCKS[0]
TERM_BLOCK = DEFAULT_TERM_BLOCKS[0]
GRID_ORDER = _k.GRID_ORDERS[0]

# Methods the tuner knows how to measure for a batch dispatch. "lookup_c"
# is the fused decode-in-the-loop lookup over a rowdict pair: measurable
# only when the tuner knows the index's dict ratio (``comp_ratio``), and
# picked by the planner only when its measured cost beats the raw fused
# kernel.
#
# "lookup_p" (the pruned chunked executor) is tunable through ``entry`` but
# deliberately not listed here: it is chosen by prune-rate break-even
# against the argmin of these methods, never by cost argmin itself, and
# live profiler observations of it would poison the cost table.
TUNABLE_METHODS = ("lookup", "lookup_c", "vertical", "unpack")

# Key prefix for live observed-cost entries (see TunedEntry.observed).
# tuning_key() output always starts with "r<rows>", so no collision.
LIVE_PREFIX = "live."

# Chunk size used when measuring the pruned (chunked) path's break-even:
# the break-even is a rate comparison and only weakly chunk-size
# dependent, so one fixture size keeps the tuning cost bounded.
PRUNE_TUNE_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class TunedEntry:
    """The measured best config for one (method, shape) key.

    ``cost_us`` is the measured per-dispatch cost at the chosen config.
    ``dedup_threshold`` (lookup only) is the minimum batch dedup rate at
    which the row-dedup path beats the fused multi-query kernel: None =
    never measured (heuristics apply), 0.0 = dedup wins even for fully
    disjoint batches, 2.0 = measured and dedup never won (no real batch
    reaches rate 2, so the planner keeps the fused kernel).
    """
    method: str
    word_block: int
    term_block: int
    grid_order: str
    cost_us: float
    dedup_threshold: float | None = None
    # True for entries derived from live serving measurements (the
    # KernelProfiler feeding back through ``KernelTuner.observe``), stored
    # under a "live."-prefixed key; ``entry``/``costs`` prefer them.
    observed: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "TunedEntry":
        return TunedEntry(
            method=str(d["method"]), word_block=int(d["word_block"]),
            term_block=int(d["term_block"]),
            grid_order=str(d["grid_order"]), cost_us=float(d["cost_us"]),
            dedup_threshold=(None if d.get("dedup_threshold") is None
                             else float(d["dedup_threshold"])),
            observed=bool(d.get("observed", False)))


def tuning_key(n_rows: int, doc_words: int, n_hashes: int, n_blocks: int,
               method: str, bucket: int, batch: int) -> str:
    """Cache key: arena shape x index addressing x batch shape x method.
    Everything that changes the dispatched kernel's shape is in the key;
    nothing else is (so a rebuilt index of the same geometry hits)."""
    return (f"r{n_rows}.w{doc_words}.k{n_hashes}.b{n_blocks}"
            f".{method}.L{bucket}.Q{batch}")


class TuningCache:
    """JSON-backed map of tuning key -> TunedEntry.

    ``path=None`` keeps the cache in memory only. ``save`` writes
    atomically (tmp + rename); ``hits`` / ``misses`` let callers observe
    that a reopened cache serves without re-tuning.

    An unreadable cache file (corrupt JSON, another version, malformed
    entries) must never take serving down: tuned configs are an
    optimisation, not state. Such a file is treated as empty (``invalid``
    is set), the planner falls back to heuristics, and the next ``save``
    rewrites it. Entries of another geometry need no special casing: the
    key carries the full arena shape, so they just miss.
    """

    def __init__(self, path: str | Path | None = None):
        self.path = None if path is None else Path(path)
        self.entries: dict[str, TunedEntry] = {}
        self.hits = 0
        self.misses = 0
        self.invalid = False      # file existed but could not be used
        if self.path is not None and self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                if data.get("version") != CACHE_VERSION:
                    raise ValueError(
                        f"version {data.get('version')!r} != "
                        f"{CACHE_VERSION}")
                self.entries = {k: TunedEntry.from_json(v)
                                for k, v in data["entries"].items()}
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError):
                # json.JSONDecodeError is a ValueError; missing or mistyped
                # fields raise KeyError/TypeError/ValueError from
                # from_json; a non-dict payload raises AttributeError
                self.entries = {}
                self.invalid = True

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key: str) -> TunedEntry | None:
        e = self.entries.get(key)
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def put(self, key: str, entry: TunedEntry) -> None:
        self.entries[key] = entry

    def save(self) -> None:
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": CACHE_VERSION,
                   "entries": {k: e.to_json()
                               for k, e in sorted(self.entries.items())}}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        tmp.rename(self.path)


def _timeit(fn, repeats: int) -> float:
    """Median host wall seconds per call, after one warm-up call. ``fn``
    ends in a device synchronise, so a time covers the work, not the
    enqueue."""
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _pad_unique(n: int) -> int:
    """Mirror of repro_torch.core.query's unique-row padding (kernels do
    not import core): unique count -> power-of-two length, floor 8."""
    return max(8, 1 << max(0, int(n) - 1).bit_length())


class KernelTuner:
    """On-demand per-shape tuning bound to one index geometry, on
    ``device`` (None = the CUDA card).

    ``entry(method, bucket, batch)`` returns the cached TunedEntry, or,
    when ``enabled`` and the key is absent, measures the method, persists
    the entry and returns it. With ``enabled=False`` the tuner is
    read-only: cache hits inform the planner, misses return None
    (heuristics apply), nothing is ever measured in the serving path. A
    kernel that fails to build or launch during a tune raises out of
    ``entry``.

    Measurement runs against a synthetic arena of the index's word width
    with rows capped at ``max_tune_rows`` and blocks capped at
    ``max_tune_blocks``. Keys always carry the real geometry. The JAX
    tuner's knob candidates (``word_blocks``, ``term_blocks``,
    ``grid_orders``) are not taken: the port's kernels have no knobs.
    """

    def __init__(self, n_rows: int, doc_words: int, n_hashes: int,
                 n_blocks: int, cache: TuningCache | None = None, *,
                 enabled: bool = True, repeats: int = 2, max_tune_rows: int = 2048,
                 max_tune_blocks: int = 4, seed: int = 0,
                 comp_ratio: float | None = None, device=None):
        self.device = resolve_device(device)
        self.n_rows = int(n_rows)
        self.doc_words = int(doc_words)
        self.n_hashes = int(n_hashes)
        self.n_blocks = int(n_blocks)
        self.cache = cache if cache is not None else TuningCache()
        self.enabled = enabled
        (self.repeats, self.max_tune_rows,
         self.max_tune_blocks) = map(int, (repeats, max_tune_rows,
                                           max_tune_blocks))
        if min(self.repeats, self.max_tune_rows, self.max_tune_blocks) < 1:
            raise ValueError(
                f"repeats, max_tune_rows and max_tune_blocks must be "
                f"positive, got {repeats}, {max_tune_rows}, "
                f"{max_tune_blocks}")
        self.seed = int(seed)
        # The index's dict compression ratio (ArenaStorage.dict_ratio):
        # None = no dict-coded shards, and "lookup_c" is untunable. The
        # ratio shapes the synthetic dict fixture, so the measured decode
        # cost streams a dict working set of the real one's size.
        self.comp_ratio = None if comp_ratio is None else float(comp_ratio)
        self.tunes = 0              # measurement runs (0 on a reopen)
        self._arena = None          # (uint32 host copy, int32 device)
        self._dict = None           # (dict_rows, refs) on the device
        # -- live observed-cost feedback (KernelProfiler -> observe) --
        # Rolling per-key sample windows; every ``live_min_samples`` new
        # observations the median is (re-)promoted to a cache entry under
        # LIVE_PREFIX so the planner sees serving-measured costs.
        self.prefer_observed = True
        self.live_min_samples = 8
        self.observations = 0
        self._live_lock = threading.Lock()
        self._live_samples: dict[str, "deque[float]"] = {}
        self._live_cfg: dict[str, tuple[int, int, str]] = {}
        self._live_new: dict[str, int] = {}

    @classmethod
    def for_index(cls, index, cache: TuningCache | None = None, **kw
                  ) -> "KernelTuner":
        """A tuner of ``index``'s geometry on the index's device. dict_ratio
        is None for all-raw stores, which disables the compressed method;
        pass comp_ratio explicitly to override."""
        if "comp_ratio" not in kw:
            ratio_fn = getattr(index.storage, "dict_ratio", None)
            kw["comp_ratio"] = ratio_fn() if callable(ratio_fn) else None
        kw.setdefault("device", index.device)
        return cls(index.storage.shape[0], index.storage.shape[1],
                   index.params.n_hashes, index.layout.n_blocks,
                   cache, **kw)

    # -- synthetic measurement fixture --------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A 4-byte numpy array as an int32 tensor on the tuner's device."""
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32)).to(self.device)

    def _tune_arena(self) -> torch.Tensor:
        """int32 [rows, W] random words on the device (the JAX draw)."""
        if self._arena is None:
            rng = np.random.default_rng(self.seed)
            rows = max(8, min(self.n_rows, self.max_tune_rows))
            host = rng.integers(0, 2 ** 32, size=(rows, self.doc_words),
                                dtype=np.uint32)
            self._arena = (host, self._dev(host))
        return self._arena[1]

    def _tune_dict(self) -> tuple:
        """Synthetic (dict_rows, refs) at the index's measured ratio: the
        tuning arena's first ~R/ratio rows as the dictionary, refs drawn
        uniformly, so the fused-decode kernels stream a dict working set
        of the size the real compressed shards would."""
        if self._dict is None:
            arena = self._tune_arena()
            R = int(arena.shape[0])
            ratio = max(1.0, self.comp_ratio or 1.0)
            D = _pad_unique(max(8, int(round(R / ratio))))
            rng = np.random.default_rng(self.seed + 3)
            self._dict = (arena[: min(D, R)],
                          self._dev(rng.integers(
                              0, min(D, R), size=R).astype(np.int32)))
        return self._dict

    def _batch_fixture(self, bucket: int, batch: int, n_unique: int | None
                       ) -> tuple:
        """(idx [Q, nb, L], mask) as int32 numpy arrays, drawing rows from
        ``n_unique`` distinct values (None = unconstrained, the fused
        kernel's fixture)."""
        rng = np.random.default_rng(self.seed + bucket * 31 + batch)
        nb = max(1, min(self.n_blocks, self.max_tune_blocks))
        R = int(self._tune_arena().shape[0])
        n = batch * nb * bucket
        if n_unique is None:
            idx = rng.integers(0, R, size=(batch, nb, bucket))
        elif n_unique >= min(n, R):
            # as disjoint as the arena allows: every cell a distinct row
            # (wrapping only when the batch outsizes the tuning arena)
            idx = np.resize(rng.permutation(R), n).reshape(
                batch, nb, bucket)
        else:
            pool = rng.choice(R, size=n_unique, replace=False)
            idx = rng.choice(pool, size=(batch, nb, bucket))
        mask = np.ones((batch, nb, bucket), dtype=np.int32)
        return idx.astype(np.int32), mask

    # -- measurement --------------------------------------------------------
    # Each timed call is the call the port's server makes for the method,
    # ending in a synchronise (the server's copy of the scores to the host
    # waits for the card the same way).
    def _measure_fused(self, bucket: int, batch: int, word_block: int,
                       grid_order: str) -> float:
        arena = self._tune_arena()
        idx, mask = map(self._dev, self._batch_fixture(bucket, batch, None))

        def one() -> None:
            ops.bitslice_lookup_score_multi(arena, idx, mask,
                                            grid_order=grid_order)
            self._sync()

        return _timeit(one, self.repeats)

    def _measure_fused_c(self, bucket: int, batch: int, word_block: int,
                         grid_order: str) -> float:
        dict_rows, refs = self._tune_dict()
        idx, mask = map(self._dev, self._batch_fixture(bucket, batch, None))

        def one() -> None:
            ops.bitslice_lookup_score_multi_comp(dict_rows, refs, idx, mask,
                                                 grid_order=grid_order)
            self._sync()

        return _timeit(one, self.repeats)

    def _measure_dedup(self, bucket: int, batch: int, word_block: int,
                       n_unique: int, compressed: bool = False
                       ) -> tuple[float, int]:
        """(seconds, actual padded unique-row count). The fixture's real
        unique count is capped by the tuning arena height and reduced by
        with-replacement draws, so the break-even fit must use the U the
        kernels really gathered. ``compressed`` measures the fused-decode
        dedup pair against the dict fixture. The rows are range-checked
        once on the host, as the server's ``dedup_inputs`` does, so the
        pair runs with ``range_checked=True`` as it is served."""
        arena = self._tune_arena()
        idx, mask = self._batch_fixture(bucket, batch, n_unique)
        uniq, inv = np.unique(idx, return_inverse=True)
        indir = inv.reshape(idx.shape).astype(np.int32)
        uniq_pad = np.zeros(_pad_unique(uniq.size), dtype=np.int32)
        uniq_pad[: uniq.size] = uniq
        if compressed:
            dict_rows, refs = self._tune_dict()
            n_src = int(refs.shape[0])
        else:
            n_src = int(arena.shape[0])
        if int(uniq_pad.min()) < 0 or int(uniq_pad.max()) >= n_src:
            raise IndexError(f"tuning rows outside [0, {n_src})")
        u_d, i_d, m_d = map(self._dev, (uniq_pad, indir, mask))

        def one() -> None:
            if compressed:
                ops.bitslice_lookup_score_dedup_comp(
                    dict_rows, refs, u_d, i_d, m_d, word_block=word_block,
                    range_checked=True)
            else:
                ops.bitslice_lookup_score_dedup(
                    arena, u_d, i_d, m_d, word_block=word_block,
                    range_checked=True)
            self._sync()

        return _timeit(one, self.repeats), int(uniq_pad.size)

    def _measure_plan_host(self, bucket: int, batch: int) -> float:
        """Host-side dedup planning cost for this batch shape: the
        np.unique over all live (block, row) cells plus the indirection
        scatter, the work plan_dedup_batch does per batch before the dedup
        kernels can run. The break-even fit charges it to the dedup
        path."""
        idx, mask = self._batch_fixture(bucket, batch, None)
        live_mask = mask.astype(bool)

        def plan() -> None:
            live = idx[live_mask]
            uniq, inv = np.unique(live, return_inverse=True)
            indir = np.zeros(idx.shape, dtype=np.int32)
            indir[live_mask] = np.asarray(inv).reshape(-1).astype(np.int32)

        return _timeit(plan, self.repeats)

    def _measure_add(self, method: str, bucket: int, batch: int,
                     word_block: int, term_block: int) -> float:
        """unpack/vertical dispatch cost including the arena gather the
        serving path performs before the ADD step (make_batch_score_fn
        gathers arena[rows] into [Q, L, nb * W], then scores): the fused
        lookup's cost has its gather in-kernel. k>1's AND is omitted."""
        arena = self._tune_arena()
        R = int(arena.shape[0])
        nb = max(1, min(self.n_blocks, self.max_tune_blocks))
        rng = np.random.default_rng(self.seed + 1)
        idx = self._dev(rng.integers(
            0, R, size=(batch, bucket, nb)).astype(np.int32))

        def one() -> None:
            flat = arena[idx.long()].reshape(batch, bucket,
                                             nb * self.doc_words)
            ops.bitslice_score(flat, method=method)
            self._sync()

        return _timeit(one, self.repeats)

    def _measure_chunk(self, bucket: int, batch: int, word_block: int,
                       chunk: int) -> float:
        """One pruned-executor chunk dispatch at the worst case: no block
        pruned yet, every (query, block, term) cell touching a distinct
        row. The timed body includes the host row gather and upload the
        executor performs per chunk (rows stream out of the mmap, not a
        staged tile) plus the accumulate kernel."""
        self._tune_arena()
        host = self._arena[0]
        R = int(host.shape[0])
        nb = max(1, min(self.n_blocks, self.max_tune_blocks))
        chunk = max(1, min(chunk, bucket))
        rng = np.random.default_rng(self.seed + 7)
        idx = rng.integers(0, R, size=(batch, nb, chunk))
        uniq, inv = np.unique(idx, return_inverse=True)
        indir = self._dev(np.asarray(inv).reshape(idx.shape)
                          .astype(np.int32))
        mask = self._dev(np.ones(idx.shape, dtype=np.int32))
        u_pad = _pad_unique(uniq.size)
        acc = ops.chunk_acc_init(batch, nb, self.doc_words, word_block,
                                 device=self.device)

        def one() -> None:
            rows = np.zeros((u_pad, self.doc_words), dtype=np.uint32)
            rows[: uniq.size] = host[uniq]
            ops.bitslice_chunk_score_dedup(self._dev(rows), indir, mask,
                                           acc, range_checked=True)
            self._sync()

        return _timeit(one, self.repeats)

    def _dedup_threshold(self, bucket: int, batch: int, word_block: int,
                         fused_s: float, compressed: bool = False
                         ) -> float | None:
        """Break-even dedup rate from two measured unique fractions.

        The dedup cost is ~linear in the unique-row count U: measure a
        near-disjoint fixture and a ~90%-shared one, fit cost(U) = a + b*U
        through the actual padded unique counts each produced, add the
        measured host planning cost (which only the dedup path pays), and
        solve cost(U*) + host == fused. threshold = 1 - U*/N. Returns 2.0
        (unreachable rate = measured, never wins) when even the heavily
        shared measurement plus its planning loses to the fused kernel."""
        n = batch * max(1, min(self.n_blocks, self.max_tune_blocks)) * bucket
        d_hi, u_hi = self._measure_dedup(bucket, batch, word_block, n,
                                         compressed)
        d_lo, u_lo = self._measure_dedup(bucket, batch, word_block,
                                         max(8, n // 10), compressed)
        host = self._measure_plan_host(bucket, batch)
        if u_lo >= u_hi:
            return None                       # fixtures indistinguishable
        if d_lo + host >= fused_s:
            return 2.0                        # measured: dedup never wins
        if d_hi + host <= fused_s:
            return 0.0                        # dedup wins even disjoint
        b = (d_hi - d_lo) / (u_hi - u_lo)
        if b <= 0:
            return 0.0
        a = d_hi - b * u_hi
        u_star = (fused_s - host - a) / b
        return float(min(1.0, max(0.0, 1.0 - u_star / n)))

    def _tune(self, method: str, bucket: int, batch: int) -> TunedEntry:
        self.tunes += 1
        # one measurement per method, recorded at the first knob candidates
        wb, tb, go = WORD_BLOCK, TERM_BLOCK, GRID_ORDER
        if method == "lookup_p":
            # Pruned (chunked) executor break-even. Field reuse on the
            # returned entry: ``term_block`` carries the chunk size and
            # ``dedup_threshold`` the minimum predicted prune rate at which
            # chunked execution beats the best unpruned dispatch (0.0 =
            # pruned wins with nothing pruned, 2.0 = measured and pruned
            # never wins). cost_us is the worst-case (nothing pruned)
            # full-query chunked cost.
            chunk = max(1, min(PRUNE_TUNE_CHUNK, bucket))
            n_chunks = -(-bucket // chunk)
            c0 = self._measure_chunk(bucket, batch, wb, chunk)
            full = c0 * n_chunks
            if self.n_hashes == 1:
                fused = self._measure_fused(bucket, batch, wb, go)
            else:
                fused = self._measure_add("vertical", bucket, batch, wb,
                                          DEFAULT_TERM_BLOCK)
            # Expected pruned cost at prune rate p is ~ full - p*(full -
            # c0): the first chunk always runs in full, later chunks skip
            # pruned blocks. Solve full - p*(full - c0) <= fused.
            if full <= fused:
                thr = 0.0
            elif fused <= c0 or full <= c0:
                thr = 2.0
            else:
                thr = float(min(1.0, max(
                    0.0, (full - fused) / (full - c0))))
            return TunedEntry("lookup_p", wb, chunk, "wq", full * 1e6,
                              dedup_threshold=thr)
        if method in ("lookup", "lookup_c"):
            compressed = method == "lookup_c"
            measure = (self._measure_fused_c if compressed
                       else self._measure_fused)
            t = measure(bucket, batch, wb, go)
            thr = self._dedup_threshold(bucket, batch, wb, t, compressed)
            return TunedEntry(method, wb, DEFAULT_TERM_BLOCK, go, t * 1e6,
                              dedup_threshold=thr)
        t = self._measure_add(method, bucket, batch, wb, tb)
        return TunedEntry(method, wb, tb, "wq", t * 1e6)

    # -- public surface ------------------------------------------------------
    def key(self, method: str, bucket: int, batch: int) -> str:
        k = tuning_key(self.n_rows, self.doc_words, self.n_hashes,
                       self.n_blocks, method, bucket, batch)
        if method == "lookup_c" and self.comp_ratio is not None:
            # decode cost depends on the dict working-set size: a store
            # rebuilt at another ratio must re-measure, not hit
            k += f".cr{self.comp_ratio:.2f}"
        return k

    def entry(self, method: str, bucket: int, batch: int
              ) -> TunedEntry | None:
        """Cached entry for (method, bucket, batch); tunes and persists on
        a miss when enabled, else returns None (the caller falls back to
        heuristics).

        A live observed-cost entry (LIVE_PREFIX key) is preferred over the
        synthetic one when present: it reflects the real arena, cache
        residency and batch mix. It also suppresses a synthetic tune on a
        cold cache. The synthetic entry's dedup_threshold is grafted on,
        because live entries never carry one (the profiler sees only
        dispatched configurations)."""
        if method in ("lookup", "lookup_c") and self.n_hashes != 1:
            return None
        if method == "lookup_c" and self.comp_ratio is None:
            return None               # no dict-coded shards to decode from
        key = self.key(method, bucket, batch)
        live = (self.cache.entries.get(LIVE_PREFIX + key)
                if self.prefer_observed else None)
        e = self.cache.get(key)
        if e is None and self.enabled and live is None:
            e = self._tune(method, bucket, batch)
            self.cache.put(key, e)
            self.cache.save()
        if live is not None:
            if (e is not None and live.dedup_threshold is None
                    and e.dedup_threshold is not None):
                live = dataclasses.replace(
                    live, dedup_threshold=e.dedup_threshold)
            return live
        return e

    def observe(self, method: str, bucket: int, batch: int,
                seconds: float, *, word_block: int,
                term_block: int = 0, grid_order: str = "wq") -> None:
        """Feed one live kernel measurement (from the KernelProfiler) into
        the cost cache. Samples accumulate per tuning key; every
        ``live_min_samples`` new ones the rolling median is promoted to an
        ``observed=True`` entry under LIVE_PREFIX and persisted.
        Non-tunable methods (the dedup pair, chosen by threshold rather
        than cost argmin) are ignored."""
        if method not in TUNABLE_METHODS:
            return
        key = self.key(method, bucket, batch)
        with self._live_lock:
            q = self._live_samples.get(key)
            if q is None:
                q = self._live_samples[key] = deque(maxlen=64)
            q.append(float(seconds))
            self._live_cfg[key] = (int(word_block),
                                   int(term_block) or DEFAULT_TERM_BLOCK,
                                   str(grid_order))
            self.observations += 1
            self._live_new[key] = self._live_new.get(key, 0) + 1
            if (len(q) < self.live_min_samples
                    or self._live_new[key] < self.live_min_samples):
                return
            self._live_new[key] = 0
            cost_us = float(np.median(np.fromiter(q, float))) * 1e6
            wb, tb, go = self._live_cfg[key]
            entry = TunedEntry(method, wb, tb, go, cost_us, observed=True)
        self.cache.put(LIVE_PREFIX + key, entry)
        self.cache.save()

    def costs(self, bucket: int, batch: int,
              methods: tuple[str, ...] = TUNABLE_METHODS
              ) -> dict[str, TunedEntry]:
        """Entries for every applicable method of a batch shape (the
        planner's cost table)."""
        out = {}
        for m in methods:
            e = self.entry(m, bucket, batch)
            if e is not None:
                out[m] = e
        return out
