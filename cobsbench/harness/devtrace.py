"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
idle gaps and the time of the scoring kernels.

Busy time is the union of the intervals in which any device activity
(kernel, copy, set) ran, so a copy that overlaps a kernel counts once.
The window is the benchmark's own ``cobsbench.window`` span; device
activity outside it is clipped off. An idle gap is named by the innermost
host span (an ATen op or a span the benchmark records around a call into
the program) open at the gap's midpoint.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

WINDOW_SPAN = "cobsbench.window"

# __global__ kernels of the program's scoring library
SCORE_KERNEL = re.compile(
    r"\b(?:lookup|lookup_comp|vertical|unpack|dedup|chunk_lookup|"
    r"chunk_lookup_comp|chunk_dedup|gather|gather_comp)_kernel\b")


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]          # ns
    device: list                     # Event, device activity
    host: list                       # Event, host spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, disjoint union of [start, end) intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_ns(intervals, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """Idle [start, end) stretches of [lo, hi) between the intervals."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def from_profiler(prof) -> Trace | None:
    """The events of a finished profiler; None without a window span."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return None
    device, host, window = [], [], None
    for e in events:
        start = int(e.start_ns())
        ev = Event(e.name(), start, start + int(e.duration_ns()))
        if "CUDA" in str(e.device_type()):
            device.append(ev)
        elif ev.name == WINDOW_SPAN:
            window = (ev.start_ns, ev.end_ns)
        else:
            host.append(ev)
    if window is None:
        return None
    return Trace(window, device, host)


def busy_s(tr: Trace) -> float:
    return busy_ns([(e.start_ns, e.end_ns) for e in tr.device],
                   *tr.window) * 1e-9


def score_kernel_s(tr: Trace) -> float:
    lo, hi = tr.window
    return sum(e - s for s, e in clip(
        [(e.start_ns, e.end_ns) for e in tr.device
         if SCORE_KERNEL.search(e.name)], lo, hi)) * 1e-9


def top_device_ops(tr: Trace, n: int = 10) -> list:
    lo, hi = tr.window
    total: dict[str, int] = {}
    for e in tr.device:
        s, t = max(e.start_ns, lo), min(e.end_ns, hi)
        if t > s:
            total[e.name] = total.get(e.name, 0) + t - s
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns * 1e-9] for name, ns in top]


def top_idle_gaps(tr: Trace, n: int = 10) -> list:
    """The n longest idle gaps, each named by the host span open at its
    midpoint."""
    g = sorted(gaps([(e.start_ns, e.end_ns) for e in tr.device],
                    *tr.window), key=lambda se: se[0] - se[1])[:n]
    starts = np.array([e.start_ns for e in tr.host], dtype=np.int64)
    ends = np.array([e.end_ns for e in tr.host], dtype=np.int64)
    out = []
    for s, e in g:
        mid = (s + e) // 2
        name = "host (no span open)"
        if starts.size:
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if open_.size:
                name = tr.host[int(open_[np.argmax(starts[open_])])].name
        out.append([name[:120], (e - s) * 1e-9])
    return out
