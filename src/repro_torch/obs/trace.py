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

``span`` is the one primitive the serving path times its stages with. It
feeds a batch's per-request marks as above, and while a torch profiler
session is open it also opens a ``torch.profiler.record_function`` range
named ``repro.<stage>``. The profiler stamps that range itself, so the
program's stages and the device's kernels and copies lie on one clock in
the profiler's trace. ``watch_gc`` adds a ``repro.gc`` range around
every Python garbage collection while a profile is open.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional

import torch.autograd.profiler as _autograd_profiler


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


# -- profiler ranges --------------------------------------------------------
# The profiler's range names are ``PREFIX + stage``. Ranges open while
# ``torch.autograd.profiler._is_profiler_enabled`` is set: the process-wide
# flag of an open profiler session, not the calling thread's
# ``_profiler_enabled()``, which is false on every thread under a profile
# that records all threads. On a thread that a one-thread profile does
# not record, a range costs its enter and exit and is not recorded.
PREFIX = "repro."

_OFF = contextlib.nullcontext()       # what ``span`` returns with nothing to do


class _Span:
    __slots__ = ("name", "marks", "tags", "clock", "args", "start",
                 "_range")

    def __init__(self, name: str, marks: Optional[list],
                 clock: Callable[[], float], args: Optional[str]):
        self.name = name
        self.marks = marks
        self.tags = None
        self.clock = clock
        self.args = args
        self._range = None

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(
                PREFIX + self.name, self.args)
            self._range.__enter__()
        if self.marks is not None:
            self.start = self.clock()
        return self

    def __exit__(self, *exc) -> None:
        if self.marks is not None:
            self.marks.append((self.name, self.start, self.clock(),
                               self.tags))
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def span(name: str, marks: Optional[list] = None, *,
         clock: Callable[[], float] = time.monotonic,
         seq: Optional[int] = None, **counts: int):
    """Context manager timing one stage.

    With ``marks`` (a list; a batch whose requests are traced) it appends
    ``(name, start, end, tags)`` on ``clock`` when the stage ends, ``tags``
    being what the block set on the returned object (None if nothing).
    While a profiler session is open it also opens the range
    ``repro.<name>``, with ``seq=<seq>`` as its args when the stage
    belongs to a batch, so a batch's ranges can be joined across threads,
    and ``<key>=<value>`` for each of ``counts`` after it (the ``launch``
    range's ``grouped``), each separated by a space. With neither, the
    cost is one test of a flag."""
    if marks is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    args = " ".join([*(() if seq is None else (f"seq={seq}",)),
                     *(f"{k}={v}" for k, v in counts.items())])
    return _Span(name, marks, clock, args or None)


class _GcSpans:
    """``gc.callbacks`` hook: a ``repro.gc`` range from a collection's
    "start" to its "stop", with the generation in its args, while a
    profiler session is open."""

    def __init__(self):
        self._open = threading.local()
        self._users = 0
        self._lock = threading.Lock()

    def __call__(self, phase: str, info: dict) -> None:
        # the interpreter reports an exception raised here as unraisable
        # and goes on with the collection
        if phase == "start":
            if _autograd_profiler._is_profiler_enabled:
                r = _autograd_profiler.record_function(
                    PREFIX + "gc", f"generation={info['generation']}")
                r.__enter__()
                self._open.range = r
        else:
            r = getattr(self._open, "range", None)
            if r is not None:
                self._open.range = None
                r.__exit__(None, None, None)

    def watch(self) -> None:
        with self._lock:
            self._users += 1
            if self._users == 1:
                gc.callbacks.append(self)

    def unwatch(self) -> None:
        with self._lock:
            if self._users == 0:
                return
            self._users -= 1
            if self._users == 0:
                gc.callbacks.remove(self)


_GC_SPANS = _GcSpans()


def watch_gc() -> None:
    """Install the ``repro.gc`` hook (counted: every ``watch_gc`` takes one
    ``unwatch_gc``; the hook stays while any caller watches)."""
    _GC_SPANS.watch()


def unwatch_gc() -> None:
    _GC_SPANS.unwatch()
