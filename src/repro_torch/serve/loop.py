"""ServingLoop: the active front-end the passive batcher was designed for.

Everything below ``submit`` in the serving stack is deliberately passive —
the micro-batcher flushes only when somebody polls it, which keeps it
deterministic for tests and embeddable anywhere. But COBS's one-kernel-
per-batch economics (the paper's §3 bulk query) only pay off when
CONCURRENT INDEPENDENT clients coalesce into shared micro-batches, and
independent clients cannot poll each other's server. The loop closes that
gap with two thread roles around an unmodified QueryServer / Frontend:

* the **dispatcher** sleeps until the batcher's ``next_due_at`` (or a
  submission wakes it), flushes due micro-batches via ``poll_batches``
  (expired requests are answered DROPPED right there), samples the
  queue-depth gauge, and hands each flushed batch to the work queue;
* **workers** pull flushed micro-batches and run ``score_batch``.
  Scoring is serialized per backend (one device; the planner's score-fn
  cache, tile cache, and metrics are single-threaded state), but response
  callbacks are delivered OUTSIDE the lock, so wire serialization and
  client wakeups overlap the next batch's kernel.

Requests enter through ``submit`` with a completion callback: fast paths
(result-cache hits, point queries, empty queries, backpressure REJECTED)
fire the callback synchronously; everything else fires it from the worker
that scores — or drops — the request. Exactly one callback per submit,
including during shutdown.

Backpressure is end to end: when the batcher's hard queue cap refuses a
request, the caller gets a Status.REJECTED response through the same
callback (the wire layer turns it into a 429-style reply) — never a hang.
``stop(drain=True)`` is graceful: no new submissions, every queued
request force-flushed and scored, every callback fired, then the threads
join. ``drain=False`` answers queued requests REJECTED without scoring.

This is ``repro.serve.loop`` for the PyTorch port, the same code over the
port's ``QueryServer``. The loop takes no device: a scoring worker
launches its kernels on the current stream of the backend's device, as
the thread that calls ``QueryServer.drain`` would.

While a torch profiler runs, the loop's stages are profiler ranges
(``obs.trace.span``): ``repro.loop.submit`` (admission under the lock),
``repro.loop.lock_wait`` (an acquisition that found the lock held),
``repro.loop.timer_wait`` (the dispatcher holding a partial bucket for
its flush timer), ``repro.loop.deliver`` (the response callbacks) and,
between ``start`` and ``stop``, ``repro.gc`` around every garbage
collection. Each contended acquisition is also observed in the backend's
``serve_loop_lock_wait_seconds`` histogram.

The first loop to start in a process moves every object the process holds
then (the index, the torch modules, the rest of set-up) into the garbage
collector's permanent generation (``gc.freeze``), as a server does once
its index is loaded: a full collection while serving then scans what
serving makes, not set-up's objects, which cost a collection a few
hundred milliseconds on a card's host. The last loop to stop gives them
back (``gc.unfreeze``).
"""
from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..obs import trace as _trace
from ..obs.trace import span
from .request import QueryResponse, Status

# Dispatcher fallback tick: the loop sleeps until the batcher's next due
# instant (submissions and finished batches wake it via an event), but
# never longer than this defensive bound — a missed wakeup is re-checked
# at worst one tick later. It is a backstop, not the latency floor.
DEFAULT_POLL_S = 0.1


_running = 0                  # loops started and not stopped
_running_lock = threading.Lock()


def _freeze_setup() -> None:
    global _running
    with _running_lock:
        _running += 1
        if _running == 1:
            gc.freeze()


def _unfreeze_setup() -> None:
    global _running
    with _running_lock:
        _running -= 1
        if _running == 0:
            gc.unfreeze()


class LoopClosed(RuntimeError):
    """submit() after stop(): the loop no longer accepts work."""


class _Lock:
    """The loop's one re-entrant lock. An acquisition that finds it held
    by another thread waits inside a ``loop.lock_wait`` span and hands
    the wait to ``on_wait(seconds)``; an uncontended one costs a
    non-blocking acquire."""

    __slots__ = ("_lock", "_on_wait")

    def __init__(self, on_wait: Callable[[float], None]):
        self._lock = threading.RLock()
        self._on_wait = on_wait

    def __enter__(self) -> "_Lock":
        lock = self._lock
        if lock.acquire(blocking=False):
            return self
        t0 = time.perf_counter()
        with span("loop.lock_wait"):
            lock.acquire()
        try:
            self._on_wait(time.perf_counter() - t0)
        except BaseException:
            lock.release()            # no __exit__ follows a failed __enter__
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()


class ServingLoop:
    """Active dispatcher + scoring workers around a QueryServer/Frontend.

    ``backend`` is anything with the serving surface the two front-ends
    share: submit / poll_batches / score_batch / take_response / batcher /
    metrics / clock.
    """

    def __init__(self, backend, *, poll_interval_s: float = DEFAULT_POLL_S,
                 workers: int = 1):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.backend = backend
        self.poll_interval_s = poll_interval_s
        self.n_workers = workers
        # One reentrant lock serializes ALL backend access (submission,
        # flush, scoring): the backends are single-threaded by design.
        # Coalescing benefits — submissions arriving while a batch scores
        # queue up at the lock and enter the batcher together.
        self._lock = _Lock(
            lambda s: self.backend.metrics.record_lock_wait(s))
        self._cbs: dict[int, Callable[[QueryResponse], None]] = {}
        self._wake = threading.Event()
        self._batchq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._inflight = 0            # flushed batches not yet scored
        self._accepting = False
        self._stopping = False
        self._drain = True
        self._threads: list[threading.Thread] = []
        # Attached offline bulk lane (set by BulkLane(loop=...)): its
        # sweeps take this loop's lock one shard at a time and yield to
        # interactive batches between shards; stop() halts it first so a
        # mid-sweep job checkpoints before the workers join.
        self.bulk_lane = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def clock(self):
        return self.backend.clock

    @property
    def running(self) -> bool:
        return bool(self._threads)

    def start(self) -> "ServingLoop":
        if self._threads:
            raise RuntimeError("loop already started")
        self._accepting = True
        self._stopping = False
        # The loop owns trace finishing: backends attach trace + stage
        # breakdown at response creation but leave the trace open so the
        # callback-delivery time lands in it as a final "deliver" span
        # (sealed in _deliver, after the callback returns).
        tracer = getattr(self.backend, "tracer", None)
        if tracer is not None:
            tracer.defer_finish = True
        d = threading.Thread(target=self._dispatch, name="serve-dispatch",
                             daemon=True)
        self._threads = [d] + [
            threading.Thread(target=self._work, name=f"serve-worker{i}",
                             daemon=True)
            for i in range(self.n_workers)]
        _trace.watch_gc()
        _freeze_setup()
        for t in self._threads:
            t.start()
        return self

    def stop(self, *, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Graceful shutdown. drain=True scores everything still queued
        before returning; drain=False answers it REJECTED. Either way
        every outstanding callback fires before the threads join."""
        if not self._threads:
            return
        if self.bulk_lane is not None:
            self.bulk_lane.stop()
        with self._lock:
            self._accepting = False
            self._drain = drain
            self._stopping = True
        self._wake.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []
        _trace.unwatch_gc()
        _unfreeze_setup()
        tracer = getattr(self.backend, "tracer", None)
        if tracer is not None:
            tracer.defer_finish = False

    # -- submission ----------------------------------------------------------
    def submit(self, pattern=None, *, terms: Optional[np.ndarray] = None,
               threshold: Optional[float] = None,
               top_k: Optional[int] = None,
               deadline: Optional[float] = None,
               trace_id: int = 0,
               on_done: Callable[[QueryResponse], None]) -> int:
        """Thread-safe submit; ``on_done(response)`` fires exactly once —
        synchronously for fast paths (cache hit, point query, REJECTED),
        from a loop thread otherwise. Raises LoopClosed after stop()."""
        with self._lock, span("loop.submit"):
            if not self._accepting:
                raise LoopClosed("serving loop is shut down")
            rid = self.backend.submit(pattern, terms=terms,
                                      threshold=threshold, top_k=top_k,
                                      deadline=deadline,
                                      trace_id=trace_id)
            resp = self.backend.take_response(rid)
            if resp is None:
                # END-TO-END backpressure: the batcher's cap only counts
                # un-flushed requests, but the dispatcher moves flushed
                # batches to the (unbounded) work queue immediately — so
                # the loop caps TOTAL outstanding work (queued + flushed
                # + scoring) at the same knob. Checked only for requests
                # that actually ENQUEUED: fast paths (cache hits, point
                # queries, empty queries) cost no queue space and stay
                # servable under overload.
                if (len(self._cbs) >= self.backend.batcher.max_queued
                        and self.backend.retract(rid)):
                    self.backend.metrics.record_rejected()
                    resp = QueryResponse(rid, Status.REJECTED)
                else:
                    self._cbs[rid] = on_done
                    self.backend.metrics.set_queue_depth(
                        len(self.backend.batcher))
        if resp is not None:
            on_done(resp)          # outside the lock
        else:
            self._wake.set()
        return rid

    def pending(self) -> int:
        """Requests queued or mid-score (approximate, for monitoring)."""
        with self._lock:
            return len(self._cbs)

    def metrics_snapshot(self):
        """Consistent metrics snapshot: taken under the backend lock, so
        a monitoring thread never iterates the percentile deques while a
        worker is appending to them (deque mutation during iteration is
        a RuntimeError)."""
        with self._lock:
            return self.backend.metrics.snapshot()

    # -- internals -----------------------------------------------------------
    def _ready_callbacks(self) -> list[tuple[Callable, QueryResponse]]:
        """MUST be called under the lock: pair every finished response
        with its registered callback."""
        out = []
        for rid, resp in self.backend.pop_responses().items():
            cb = self._cbs.pop(rid, None)
            if cb is not None:
                out.append((cb, resp))
        return out

    def _deliver(self, ready: list[tuple[Callable, QueryResponse]]) -> None:
        if not ready:
            return
        tracer = getattr(self.backend, "tracer", None)
        with span("loop.deliver"):
            for cb, resp in ready:
                t0 = self.clock()
                try:
                    cb(resp)
                except Exception:
                    # a dead client (e.g. socket closed mid-reply) must not
                    # take the loop thread with it; the result is simply
                    # undeliverable
                    pass
                if resp.trace is not None and tracer is not None:
                    resp.trace.add("deliver", t0, self.clock())
                    tracer.finish(resp.trace)

    def _flush(self, *, force: bool) -> None:
        """Flush due batches into the work queue; deliver any DROPPED."""
        with self._lock:
            for b in self.backend.poll_batches(force=force):
                self._inflight += 1
                self._batchq.put(b)
            self.backend.metrics.set_queue_depth(len(self.backend.batcher))
            ready = self._ready_callbacks()
        self._deliver(ready)

    def _reject_queued(self) -> None:
        """drain=False shutdown: answer everything still queued REJECTED
        without scoring it."""
        with self._lock:
            ready = []
            for b in self.backend.poll_batches(force=True):
                for r in b.requests:
                    self.backend.metrics.record_rejected()
                    cb = self._cbs.pop(r.request_id, None)
                    if cb is not None:
                        ready.append((cb, QueryResponse(
                            r.request_id, Status.REJECTED)))
            ready.extend(self._ready_callbacks())
        self._deliver(ready)

    def _idle(self) -> bool:
        with self._lock:
            return len(self.backend.batcher) == 0 and self._inflight == 0

    def _dispatch(self) -> None:
        while not self._stopping:
            # sleep until the earliest flush deadline (or a submission /
            # stop wakes us); an empty batcher sleeps long — submissions
            # always wake the loop, so idleness costs nothing
            with self._lock:
                due = self.backend.batcher.next_due_at()
            # sleep until the due instant itself — a NEW earlier-due
            # submission always wakes the loop, so no shorter tick is
            # needed; poll_interval_s is a defensive ceiling, not a poll
            timeout = self.poll_interval_s if due is None else \
                min(max(0.0, due - self.clock()), self.poll_interval_s)
            if timeout > 0:
                if due is None:
                    self._wake.wait(timeout)
                else:
                    # a partial bucket held for its flush timer
                    with span("loop.timer_wait"):
                        self._wake.wait(timeout)
            self._wake.clear()
            self._flush(force=False)
        # shutdown: drain (score) or reject everything still queued, then
        # wait for workers to finish in-flight batches
        if self._drain:
            while not self._idle():
                self._flush(force=True)
                self._wake.wait(self.poll_interval_s)
                self._wake.clear()
        else:
            self._reject_queued()
            while not self._idle():
                self._wake.wait(self.poll_interval_s)
                self._wake.clear()
        for _ in range(self.n_workers):
            self._batchq.put(None)

    def _work(self) -> None:
        while True:
            batch = self._batchq.get()
            if batch is None:
                return
            ready: list = []
            with self._lock:
                try:
                    self.backend.score_batch(batch)
                except Exception:
                    # a kernel/device failure mid-batch: the batch is
                    # already out of the batcher, so answer its requests
                    # FAILED instead of letting the exception kill this
                    # worker (which would leak _inflight and wedge the
                    # loop) — exactly-once callbacks hold even here
                    for r in batch.requests:
                        resp = self.backend.take_response(r.request_id)
                        if resp is None:
                            self.backend.metrics.record_failed()
                            resp = self.backend.finalize_trace(
                                r.trace, QueryResponse(r.request_id,
                                                       Status.FAILED))
                        cb = self._cbs.pop(r.request_id, None)
                        if cb is not None:
                            ready.append((cb, resp))
                finally:
                    self._inflight -= 1
                ready.extend(self._ready_callbacks())
            self._deliver(ready)
            self._wake.set()      # dispatcher may be waiting on inflight
