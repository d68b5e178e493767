"""Request/response envelope for the query-serving subsystem.

A request is a *compiled* query: distinct packed terms plus the coverage
threshold. Pattern compilation (DNA string -> packed k-mers) happens once
at the server's front door (``QueryServer.submit``) so everything behind
the queue operates on fixed-shape term buffers.

Timestamps are seconds on the server's clock (``time.monotonic`` unless a
test injects its own); ``deadline`` is absolute on that clock.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from ..core.query import SearchResult


class Status(str, enum.Enum):
    OK = "ok"                    # scored, result attached
    REJECTED = "rejected"        # backpressure: queue full at submit
    DROPPED = "dropped_deadline"  # deadline expired before scoring
    FAILED = "failed"            # unservable: a shard lost every replica


@dataclasses.dataclass
class QueryRequest:
    """One compiled query waiting to be scored."""

    request_id: int
    terms: np.ndarray            # uint32 [ell, 2] distinct packed terms
    n_terms: int                 # ell (terms.shape[0])
    threshold: float             # coverage fraction K
    submitted_at: float          # server-clock seconds
    deadline: Optional[float] = None   # absolute; None = never drop
    bucket: int = 0              # padded term length (set by the batcher)
    top_k: int = 0               # > 0 = exact top-k selection instead of
    #                              the coverage threshold
    # Observability: the Trace minted at admission (None = tracing off)
    # rides with the request so every layer it crosses can append spans.
    # ``trace`` holds live span state and is deliberately excluded from
    # equality/repr noise via compare=False.
    trace: Optional[object] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def trace_id(self) -> int:
        return self.trace.trace_id if self.trace is not None else 0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


@dataclasses.dataclass
class QueryResponse:
    """Outcome of one request.

    ``result`` is None unless ``status == Status.OK``. ``method`` names the
    kernel the planner dispatched ('' for cache hits and non-OK statuses);
    ``batch_size`` counts live queries in the micro-batch that served this
    request (1 for cache hits). ``wait_s``/``service_s`` split the latency
    into queueing and scoring time.
    """

    request_id: int
    status: Status
    result: Optional[SearchResult] = None
    method: str = ""
    batch_size: int = 0
    wait_s: float = 0.0
    service_s: float = 0.0
    cached: bool = False
    # Observability: the request's trace id (0 = untraced), the compact
    # per-stage timing breakdown {stage: seconds} the wire layer ships
    # back in the RESULT frame, and the full Trace for in-process
    # consumers (slow-query assertions, the loop's deliver span).
    trace_id: int = 0
    stages: Optional[dict] = None
    trace: Optional[object] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def latency_s(self) -> float:
        return self.wait_s + self.service_s
