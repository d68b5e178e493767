"""Kernel profiling: per-(method, bucket, word_block) dispatch time and
bytes-moved accounting for every score dispatch.

A dispatch's time is host time on the server's clock, from the upload of
the batch's terms through the copy of its scores to the host: the
kernels, the copies around them and the host work between them, not the
kernels' device time alone (a profiler trace gives that).

The serving layers already know everything worth recording at the
moment a kernel returns — the method the planner chose, the bucket and
batch geometry, the word_block actually dispatched, and (for the
dedup path) how many arena rows the gather streamed. ``KernelProfiler.
record`` is the single funnel: it feeds a labeled histogram + counter
in the metrics registry (Prometheus-visible), keeps a bounded ring of
raw records for tests/reports, and forwards each measurement to
``KernelTuner.observe`` so the autotuner's cost model learns from live
traffic instead of only offline synthetic fixtures.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional


def gather_bytes(n_rows: int, doc_words: int, itemsize: int = 4) -> int:
    """Bytes-moved estimate for an arena gather: rows streamed from the
    bit-sliced arena times the row stride. The dedup plan's
    ``n_unique`` (padded) rows for the dedup path, Q*nb*L for the fused
    kernel — per-slice addressing reads whole rows either way."""
    return int(n_rows) * int(doc_words) * int(itemsize)


class KernelProfiler:
    """Sink for score-kernel timings. All methods are thread-safe and
    cheap when ``enabled`` is False (one branch)."""

    def __init__(self, registry=None, tuner=None, *, enabled: bool = True,
                 ring: int = 512):
        self.enabled = enabled
        self.tuner = tuner
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=ring)
        self._count = 0
        self._hist = None
        self._bytes = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        self._hist = registry.histogram(
            "kernel_score_seconds",
            "score dispatch host time, terms upload to scores on the host",
            labels=("method", "bucket", "word_block"))
        self._bytes = registry.counter(
            "kernel_bytes_moved_total",
            "estimated arena bytes gathered by score dispatches",
            labels=("method", "bucket"))

    def record(self, *, method: str, bucket: int, batch: int,
               seconds: float, word_block: int = 0,
               term_block: int = 0, grid_order: str = "wq",
               bytes_moved: int = 0, shard: Optional[int] = None) -> None:
        """One finished kernel dispatch."""
        if not self.enabled:
            return
        if self._hist is not None:
            self._hist.labels(method, bucket, word_block).observe(seconds)
        if self._bytes is not None and bytes_moved:
            self._bytes.labels(method, bucket).inc(bytes_moved)
        rec = {"method": method, "bucket": int(bucket),
               "batch": int(batch), "word_block": int(word_block),
               "seconds": float(seconds), "bytes_moved": int(bytes_moved)}
        if shard is not None:
            rec["shard"] = int(shard)
        with self._lock:
            self._ring.append(rec)
            self._count += 1
        if self.tuner is not None and word_block:
            try:
                self.tuner.observe(method, bucket, batch, seconds,
                                   word_block=word_block,
                                   term_block=term_block,
                                   grid_order=grid_order)
            except Exception:
                # cost feedback is advisory; a cache-save hiccup (full
                # disk, read-only mount) must not fail the scoring path
                pass

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def records(self, n: int = 0) -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        return recs[-n:] if n else recs
