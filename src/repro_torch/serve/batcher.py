"""Shape-bucketed dynamic micro-batching (a host-only copy of
``repro.serve.batcher``; ``padded_len`` comes from the port's
``core/query.py``).

Queries arrive with arbitrary term counts. Padding every query to the
global maximum wastes kernel work, while padding each to its own length
gives every batch its own shape (the JAX package compiles one kernel per
shape; here it keeps batches of one shape together). The batcher takes the
middle road the serving literature (and COBS §3's bulk queries) points at:
queries are grouped into *buckets* by padded term length (multiples of
``term_pad``), and each bucket accumulates a dense micro-batch that flushes
when it is full, when its oldest entry has waited ``max_wait_s``, or on an
explicit drain. Bucket count is bounded by the term-length spread, not the
query count. With ``adaptive=True`` the bucket boundaries are refit to the
observed term-length histogram (``fit_bucket_edges``), so workloads whose
lengths cluster between grid lines batch densely instead of padding up to
the next ``term_pad`` multiple.

Backpressure is a hard cap on queued requests: ``submit`` refuses beyond
``max_queued`` and the caller answers the client with Status.REJECTED
instead of letting the queue grow without bound. Deadline handling is at
poll time: every poll sweeps EXPIRED requests out of their buckets —
wherever they sit in the queue, not just at the head — returns them
separately, and never scores them; ``next_due_at`` accounts for every
queued deadline so an active dispatcher wakes in time to answer the
drop.

The batcher is passive (no threads): a driver calls ``submit`` and then
``poll``/``drain`` from its own loop, which keeps it deterministic for
tests and embeddable under any async runtime. An active serving loop
wraps it in exactly such a runtime — an active dispatcher thread that sleeps
until ``next_due_at`` and wakes on submission — so network clients get
fill/wait-timer flushes without any caller poking the server.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

from ..core.query import padded_len
from .request import QueryRequest


def fit_bucket_edges(lengths, *, max_buckets: int = 8, quantum: int = 8
                     ) -> list[int]:
    """Bucket edges fitted to an observed term-length histogram.

    Plain ``padded_len(n, term_pad)`` buckets waste up to ``term_pad - 1``
    padded terms per query when the workload's lengths cluster between
    multiples. This picks up to ``max_buckets`` edges at the quantiles of
    the observed distribution, each rounded up to a multiple of
    ``quantum`` (the sublane granularity the kernels want) — so dense
    clusters get an edge of their own and the shape count stays bounded by
    ``max_buckets`` shapes. Edges are sorted ascending and always cover
    the observed maximum; an empty sample returns []."""
    ls = sorted(int(x) for x in lengths if int(x) > 0)
    if not ls:
        return []
    edges: list[int] = []
    n = len(ls)
    for i in range(1, max_buckets + 1):
        idx = max(0, min(n - 1, (i * n) // max_buckets - 1))
        e = padded_len(ls[idx], quantum)
        if not edges or e > edges[-1]:
            edges.append(e)
    return edges


@dataclasses.dataclass
class MicroBatch:
    """A dense, same-bucket group of live requests ready to score."""
    bucket: int                       # padded term length of every member
    requests: list[QueryRequest]
    # why and when the batch flushed ("full" / "timer" / "force") — trace
    # spans tag the flush reason so a p99 investigation can tell
    # wait-timer flushes from fill flushes at a glance
    reason: str = ""
    flushed_at: float = 0.0

    @property
    def size(self) -> int:
        return len(self.requests)


class MicroBatcher:
    def __init__(self, *, term_pad: int = 64, max_batch: int = 32,
                 max_wait_s: float = 0.002, max_queued: int = 1024,
                 adaptive: bool = False, adapt_quantum: int = 8,
                 adapt_buckets: int = 8, adapt_every: int = 256,
                 adapt_window: int = 4096):
        if max_batch < 1 or max_queued < 1:
            raise ValueError("max_batch and max_queued must be >= 1")
        self.term_pad = term_pad
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queued = max_queued
        # bucket -> FIFO of requests; OrderedDict gives deterministic
        # bucket visit order (insertion order of first use).
        self._buckets: "OrderedDict[int, deque[QueryRequest]]" = OrderedDict()
        self._queued = 0
        # Adaptive bucket boundaries: instead of the fixed term_pad grid,
        # fit edges to the observed term-length histogram every
        # ``adapt_every`` submissions (``fit_bucket_edges``), so a
        # workload clustered between grid lines batches densely. The
        # fitted edges only steer NEW submissions — queued requests keep
        # the bucket stamped at submit, so every in-flight micro-batch
        # stays shape-consistent. Queries past the largest fitted edge
        # fall back to the fixed grid (the edges always cover the
        # observed maximum, so this only happens on a fresh record).
        self.adaptive = bool(adaptive)
        self.adapt_quantum = int(adapt_quantum)
        self.adapt_buckets = int(adapt_buckets)
        self.adapt_every = max(1, int(adapt_every))
        self._observed: "deque[int]" = deque(maxlen=int(adapt_window))
        self._edges: list[int] = []
        self._since_fit = 0

    # -- enqueue -----------------------------------------------------------
    def __len__(self) -> int:
        return self._queued

    @property
    def full(self) -> bool:
        return self._queued >= self.max_queued

    @property
    def bucket_edges(self) -> list[int]:
        """The fitted edges currently steering new submissions ([] =
        fixed ``term_pad`` grid)."""
        return list(self._edges)

    def bucket_of(self, n_terms: int) -> int:
        for e in self._edges:
            if n_terms <= e:
                return e
        return padded_len(n_terms, self.term_pad)

    def fit(self, lengths=None) -> list[int]:
        """Refit bucket edges now — from ``lengths`` (a known workload
        histogram, e.g. a bulk job's term counts) or from the lengths
        observed so far. Returns the new edges."""
        sample = self._observed if lengths is None else lengths
        edges = fit_bucket_edges(sample, max_buckets=self.adapt_buckets,
                                 quantum=self.adapt_quantum)
        if edges:
            self._edges = edges
        self._since_fit = 0
        return list(self._edges)

    def observe(self, n_terms: int) -> None:
        """Record one observed term count (adaptive mode refits every
        ``adapt_every`` observations)."""
        self._observed.append(int(n_terms))
        self._since_fit += 1
        if self.adaptive and self._since_fit >= self.adapt_every:
            self.fit()

    def submit(self, req: QueryRequest) -> bool:
        """Queue a request; False = refused (backpressure)."""
        if self.full:
            return False
        if self.adaptive:
            self.observe(req.n_terms)
        b = self.bucket_of(req.n_terms)
        req.bucket = b
        self._buckets.setdefault(b, deque()).append(req)
        self._queued += 1
        return True

    def retract_last(self, rid: int) -> QueryRequest | None:
        """Remove and return a JUST-submitted request (still the tail of
        its bucket) — the serving loop's outstanding-work cap uses this
        to bounce an enqueue it only recognizes as over-budget after the
        backend's fast paths have had their chance. None = not found."""
        for b, q in self._buckets.items():
            if q and q[-1].request_id == rid:
                req = q.pop()
                self._queued -= 1
                if not q:
                    del self._buckets[b]
                return req
        return None

    def next_due_at(self) -> float | None:
        """Earliest server-clock instant at which some queued request
        becomes due: immediately for a full bucket, else the oldest
        entry's wait-timer expiry or ANY queued member's deadline,
        whichever is first. None = nothing queued. An active dispatcher
        sleeps until this instant instead of polling on a fixed tick —
        deadlines of non-head requests count, so their DROPPED replies are
        never delayed behind a long wait timer."""
        due = None
        for q in self._buckets.values():
            if not q:
                continue
            head = q[0]
            t = (head.submitted_at if len(q) >= self.max_batch
                 else head.submitted_at + self.max_wait_s)
            for r in q:
                if r.deadline is not None:
                    t = min(t, r.deadline)
            due = t if due is None else min(due, t)
        return due

    # -- flush -------------------------------------------------------------
    def _take(self, q: "deque[QueryRequest]", now: float, limit: int,
              expired: list[QueryRequest]) -> list[QueryRequest]:
        live: list[QueryRequest] = []
        while q and len(live) < limit:
            r = q.popleft()
            self._queued -= 1
            (expired if r.expired(now) else live).append(r)
        return live

    def poll(self, now: float, *, force: bool = False
             ) -> tuple[list[MicroBatch], list[QueryRequest]]:
        """Collect every bucket that is due at ``now``.

        Returns (batches, expired): dense micro-batches to score plus the
        requests whose deadline passed while queued (to answer DROPPED).
        force=True flushes everything regardless of fill/wait — the drain
        path and the load-generator's end-of-run.
        """
        batches: list[MicroBatch] = []
        expired: list[QueryRequest] = []
        for b, q in list(self._buckets.items()):
            if any(r.expired(now) for r in q):
                # deadline sweep: expired members ANYWHERE in the bucket
                # answer DROPPED now — the live ones keep waiting for
                # fill/timer rather than flushing early on their account
                keep: "deque[QueryRequest]" = deque()
                for r in q:
                    (keep if not r.expired(now) else expired).append(r)
                self._queued -= len(q) - len(keep)
                self._buckets[b] = q = keep
            while q:
                if len(q) >= self.max_batch:
                    reason = "full"
                elif now - q[0].submitted_at >= self.max_wait_s:
                    reason = "timer"
                elif force:
                    reason = "force"
                else:
                    break
                live = self._take(q, now, self.max_batch, expired)
                if live:
                    batches.append(MicroBatch(b, live, reason=reason,
                                              flushed_at=now))
            if not q:
                del self._buckets[b]
        return batches, expired

    def occupancy(self, batch: MicroBatch) -> float:
        return batch.size / self.max_batch
