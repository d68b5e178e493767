"""Request tracing: spans per serving stage, ring-buffered traces.

A ``Trace`` is minted when a query is admitted (QueryServer/Frontend
``submit``) and travels with the request through every layer; each
layer appends flat ``Span``s — (name, start, end, tags) on the shared
monotonic clock — rather than maintaining an open-span stack, because
a request's stages run on different threads (submitter, dispatcher,
scoring worker, scatter pool) and the batch-level stages (flush, plan,
kernel) are legitimately shared by every request in the micro-batch.
The tree structure a UI would want is recoverable from the intervals;
``benchmarks/trace_report.py`` renders exactly that.

``Tracer`` owns trace lifecycle: minting ids, the bounded ring of
finished traces (for the STATS surface / tests), and the slow-query
sink — a finished trace whose end-to-end latency exceeds ``slow_ms``
is emitted to the JSONL ``EventLog`` with its full span tree.

Everything is cheap when disabled: ``tracer.begin`` returns None and
every call site guards with ``if trace is not None`` (span recording
itself is two clock reads and an append under a small lock).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional


class Span:
    """One timed stage. ``tags`` is small str->str/num metadata
    (method, shard, replica role, hit/fault...)."""

    __slots__ = ("name", "start_s", "end_s", "tags")

    def __init__(self, name: str, start_s: float, end_s: float,
                 tags: Optional[dict] = None):
        self.name = name
        self.start_s = start_s
        self.end_s = end_s
        self.tags = tags or {}

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def to_json(self) -> dict:
        d = {"name": self.name, "start_s": self.start_s,
             "end_s": self.end_s}
        if self.tags:
            d["tags"] = self.tags
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"{self.tags})")


class Trace:
    """Spans for one request. Thread-safe appends; ``finish`` is
    idempotent (the first caller wins) so the deliver path and the
    sync-driver path cannot double-emit."""

    def __init__(self, trace_id: int, request_id: int = 0, *,
                 started_s: float = 0.0):
        self.trace_id = trace_id
        self.request_id = request_id
        self.started_s = started_s
        self.ended_s: Optional[float] = None
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def add(self, name: str, start_s: float, end_s: float,
            tags: Optional[dict] = None) -> Span:
        s = Span(name, start_s, end_s, tags)
        with self._lock:
            self._spans.append(s)
        return s

    @property
    def done(self) -> bool:
        return self.ended_s is not None

    @property
    def duration_s(self) -> float:
        end = self.ended_s
        if end is None:
            with self._lock:
                end = max((s.end_s for s in self._spans),
                          default=self.started_s)
        return end - self.started_s

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def stage_totals(self) -> dict[str, float]:
        """Per-stage wall time, summed over same-named spans — the
        compact breakdown the RESULT frame carries back to the client.
        Stages keep first-seen (i.e. roughly causal) order."""
        out: dict[str, float] = {}
        for s in self.spans():
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "started_s": self.started_s,
            "ended_s": self.ended_s,
            "duration_ms": self.duration_s * 1e3,
            "spans": [s.to_json() for s in self.spans()],
        }


class Tracer:
    """Trace factory + finished-trace ring + slow-query sink.

    ``clock`` must be the same callable the serving clock uses
    (monotonic by default; the sim-clock in tests) so span timestamps
    and request deadlines share an epoch. ``sink`` is an EventLog-like
    object with ``emit(kind, payload)``; only traces slower than
    ``slow_ms`` reach it.
    """

    def __init__(self, *, enabled: bool = True, ring: int = 256,
                 slow_ms: float = 0.0, sink=None,
                 clock: Optional[Callable[[], float]] = None):
        self.enabled = enabled
        self.slow_ms = slow_ms
        self.sink = sink
        self.clock = clock or time.monotonic
        # When a ServingLoop fronts the backend, the loop finishes the
        # trace after callback delivery (so "deliver" is a span); sync
        # drivers finish in pop_responses. The loop flips this flag.
        self.defer_finish = False
        self._lock = threading.Lock()
        self._ring: "deque[Trace]" = deque(maxlen=ring)
        self._ids = itertools.count(1)
        self._finished = 0
        self._slow = 0

    def mint_id(self) -> int:
        return next(self._ids)

    def begin(self, request_id: int = 0, *,
              trace_id: Optional[int] = None,
              started_s: Optional[float] = None) -> Optional[Trace]:
        """New trace, or None when tracing is off. A nonzero wire
        trace id (client-minted) is honored verbatim."""
        if not self.enabled:
            return None
        tid = trace_id if trace_id else self.mint_id()
        t0 = self.clock() if started_s is None else started_s
        return Trace(tid, request_id, started_s=t0)

    def finish(self, trace: Optional[Trace]) -> None:
        """Seal the trace, ring-buffer it, and emit to the slow-query
        sink if over budget. Idempotent; None is a no-op."""
        if trace is None:
            return
        with trace._lock:           # claim: first finisher wins
            if trace.ended_s is not None:
                return
            trace.ended_s = self.clock()
        with self._lock:
            self._ring.append(trace)
            self._finished += 1
            slow = trace.duration_s * 1e3 >= self.slow_ms > 0
            if slow:
                self._slow += 1
        if slow and self.sink is not None:
            self.sink.emit("slow_query", trace.to_json())

    # -- reading -----------------------------------------------------------
    @property
    def finished_count(self) -> int:
        with self._lock:
            return self._finished

    @property
    def slow_count(self) -> int:
        with self._lock:
            return self._slow

    def recent(self, n: int = 0) -> list[Trace]:
        """Most recent finished traces (all buffered when n=0)."""
        with self._lock:
            traces = list(self._ring)
        return traces[-n:] if n else traces

    def find(self, trace_id: int) -> Optional[Trace]:
        with self._lock:
            for t in reversed(self._ring):
                if t.trace_id == trace_id:
                    return t
        return None
