"""Reduction of the program's own profiler ranges in a traced window.

The program opens a ``torch.profiler.record_function`` range named
``repro.<stage>`` around each stage of its served path while a profiler
runs (``src/repro_torch/obs/trace.py: span``). The profiler stamps those
ranges itself, on the clock of the device's kernels and copies, and
``devtrace.from_profiler`` keeps them among the trace's host events. A
profile records the ranges of the threads it covers: the thread that
opened it, or every thread when it is opened with
``profile_all_threads``.
"""
from __future__ import annotations

from . import devtrace

PREFIX = "repro."


def present(tr: devtrace.Trace) -> bool:
    """Whether any ``repro.*`` range ends in the window: a program that
    opens none (one older than its spans) gives its readers nothing."""
    lo, hi = tr.window
    return any(e.name.startswith(PREFIX) and lo < e.end_ns <= hi
               for e in tr.host)


def summed_s(tr: devtrace.Trace, name: str) -> float:
    """Summed time of the ranges named ``name`` in the window, over every
    recorded thread (two threads inside one range for 1 ms give 2 ms)."""
    lo, hi = tr.window
    return sum(e - s for s, e in devtrace.clip(
        [(e.start_ns, e.end_ns) for e in tr.host if e.name == name],
        lo, hi)) * 1e-9


def _overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def unnamed_idle_share(tr: devtrace.Trace) -> float | None:
    """The share of the device's idle time in the window (the window less
    the union of its device activity) during which no ``repro.*`` range
    is open on any recorded host thread; None when the device never
    idles or the program opened no range."""
    if not present(tr):
        return None
    lo, hi = tr.window
    busy = devtrace.merge(devtrace.clip(
        [(e.start_ns, e.end_ns) for e in tr.device], lo, hi))
    idle = (hi - lo) - sum(e - s for s, e in busy)
    if idle <= 0:
        return None
    named = devtrace.merge(devtrace.clip(
        [(e.start_ns, e.end_ns) for e in tr.host
         if e.name.startswith(PREFIX)], lo, hi))
    named_idle = sum(e - s for s, e in named) - _overlap_ns(named, busy)
    return 100.0 * (idle - named_idle) / idle
