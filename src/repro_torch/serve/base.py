"""Shared serving-backend surface.

``QueryServer`` (single host) and ``Frontend`` (sharded scatter/gather)
present one identical control surface to their drivers: the synchronous
``step``/``drain`` loop, and the ``poll_batches`` / ``score_batch`` /
``take_response`` / ``retract`` quartet the active ``ServingLoop`` is
built on. The flush/drop accounting lives here ONCE so the two backends
cannot drift.

A backend provides ``batcher``, ``metrics``, ``clock``, ``_responses``,
and ``score_batch``. All per-request state rides on the QueryRequest
itself (terms, threshold, top_k, deadline), so a request that dies
before scoring — expired or retracted — leaves nothing behind to clean
up.
"""
from __future__ import annotations

from typing import Optional

from .batcher import MicroBatch
from .request import QueryResponse, Status


class ServingBackend:
    """Mixin: the driver-facing serving loop over a MicroBatcher."""

    def finalize_trace(self, trace, resp: QueryResponse) -> QueryResponse:
        """Attach a request's trace to its response: trace id, the
        per-stage timing breakdown (what the RESULT frame ships), and
        the Trace itself. The trace is SEALED here for synchronous
        drivers; under a ServingLoop the loop finishes it after
        callback delivery instead (``tracer.defer_finish``) so the
        slow-query log sees a "deliver" span too."""
        if trace is None:
            return resp
        resp.trace_id = trace.trace_id
        resp.trace = trace
        resp.stages = trace.stage_totals()
        tracer = getattr(self, "tracer", None)
        if tracer is not None and not tracer.defer_finish:
            tracer.finish(trace)
        return resp

    def poll_batches(self, now: Optional[float] = None, *,
                     force: bool = False) -> list[MicroBatch]:
        """Flush the batcher at ``now``: expired requests are answered
        DROPPED immediately, due micro-batches are returned for scoring
        (inline via ``step``, or from a serving-loop worker thread)."""
        now = self.clock() if now is None else now
        batches, expired = self.batcher.poll(now, force=force)
        for r in expired:
            self.metrics.record_dropped()
            if r.trace is not None:
                r.trace.add("queue_wait", r.submitted_at, now,
                            {"outcome": "dropped"})
            self._responses[r.request_id] = self.finalize_trace(
                r.trace, QueryResponse(
                    r.request_id, Status.DROPPED,
                    wait_s=max(0.0, now - r.submitted_at)))
        return batches

    def step(self, now: Optional[float] = None, *, force: bool = False
             ) -> int:
        """Score every micro-batch due at ``now``; returns requests
        answered this step (scored + dropped)."""
        dropped0 = self.metrics.dropped
        batches = self.poll_batches(now, force=force)
        n = self.metrics.dropped - dropped0
        for batch in batches:
            self.score_batch(batch)
            n += batch.size
        return n

    def drain(self) -> None:
        """Flush every queued request regardless of batch fill or
        timers."""
        while len(self.batcher):
            self.step(force=True)

    def pop_responses(self) -> dict[int, QueryResponse]:
        out = self._responses
        self._responses = {}
        return out

    def take_response(self, rid: int) -> Optional[QueryResponse]:
        """Pop one request's response if it is ready (the serving loop's
        fast-path check right after ``submit``)."""
        return self._responses.pop(rid, None)

    def retract(self, rid: int) -> bool:
        """Un-queue a just-submitted request (serving-loop backpressure:
        the caller answers it REJECTED itself). The retracted request's
        trace is sealed here — the caller's plain REJECTED response
        never passes back through finalize_trace."""
        req = self.batcher.retract_last(rid)
        if req is None:
            return False
        if req.trace is not None:
            tracer = getattr(self, "tracer", None)
            if tracer is not None:
                req.trace.add("reject", req.submitted_at, self.clock(),
                              {"reason": "backpressure"})
                tracer.finish(req.trace)
        return True
