"""Counter / gauge / histogram registry with per-metric locking.

The serving stack mostly runs single-threaded behind the ServingLoop's
backend lock, but three producers live outside it: per-connection
socket threads (connection gauge), the scatter thread pool (per-worker
latencies), and any monitoring thread calling ``snapshot`` or the
Prometheus renderer. Every metric therefore owns a lock and every
read/write takes it — uncontended acquisition is ~100ns, invisible
next to a kernel dispatch, and it turns "iterating a deque while a
worker appends" from a RuntimeError into a consistent copy.

Labeled metrics follow the Prometheus family model: ``registry.counter
("x_total", labels=("method",))`` returns a family; ``family.labels
("fused")`` returns (creating on first use) the child counter for that
label value. Unlabeled metrics are their own child with no labels.
"""
from __future__ import annotations

import threading
from typing import Iterable, Optional, Sequence

import numpy as np


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (plus a high-water mark)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n
            if self._value > self._max:
                self._max = self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max


class Histogram:
    """Sliding-window sample store with exact lifetime count/sum.

    Percentiles are computed over the last ``window`` observations
    (matching the old ServingMetrics deques); ``recent`` keeps a short
    secondary window for hot-path consumers (adaptive hedging derives a
    p95 per batch over 128 samples, not 65k).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, window: int = 65536,
                 recent: int = 128):
        from collections import deque
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: "deque[float]" = deque(maxlen=window)
        self._recent: "deque[float]" = deque(maxlen=recent)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(v)
            self._recent.append(v)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def values(self) -> np.ndarray:
        """Consistent copy of the sample window."""
        with self._lock:
            return np.fromiter(self._samples, float, len(self._samples))

    def recent_values(self) -> np.ndarray:
        with self._lock:
            return np.fromiter(self._recent, float, len(self._recent))

    def percentile(self, p: float) -> float:
        v = self.values()
        return float(np.percentile(v, p)) if v.size else 0.0

    def percentiles(self, ps: Sequence[float]) -> list[float]:
        v = self.values()
        if not v.size:
            return [0.0] * len(ps)
        return [float(x) for x in np.percentile(v, list(ps))]

    def mean(self) -> float:
        v = self.values()
        return float(v.mean()) if v.size else 0.0


class Family:
    """A labeled metric family: one child per label-value tuple."""

    def __init__(self, cls, name: str, help: str, label_names: tuple,
                 **kwargs):
        self.cls = cls
        self.name = name
        self.help = help
        self.label_names = label_names
        self.kind = cls.kind
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, *values):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self.cls(self.name, self.help, **self._kwargs)
                self._children[values] = child
            return child

    def children(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Name -> metric (or labeled family). Constructors are idempotent:
    asking for an existing name returns the existing object (and raises
    if the kind or labels disagree — two subsystems silently sharing a
    name with different meanings is a bug worth failing loudly on)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_make(self, cls, name: str, help: str,
                     labels: Iterable[str], **kwargs):
        label_names = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                existing = m.label_names if isinstance(m, Family) else ()
                if existing != label_names:
                    raise ValueError(
                        f"metric {name!r} labels {existing} != "
                        f"{label_names}")
                return m
            if label_names:
                m = Family(cls, name, help, label_names, **kwargs)
            else:
                m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (), *, window: int = 65536,
                  recent: int = 128) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 window=window, recent=recent)

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> list[tuple[str, object]]:
        """(name, metric-or-family) pairs, sorted by name."""
        with self._lock:
            return sorted(self._metrics.items())
