"""Straggler mitigation: hedged query execution over replicated shards.

A copy of the JAX package's ``repro.index.hedge`` (host-only code, so the
port keeps its own copy instead of importing the original); tested equal
to it.

Queries against a sharded signature index are stateless scans, which makes
the classic 'hedged request' policy (Dean & Barroso, 'The Tail at Scale')
directly applicable: issue to the primary replica; if no completion within
the hedge deadline (e.g. p95 latency), issue a backup request to the next
replica and take whichever finishes first.

The executor drives BOTH pure simulation and the serving frontend's real
dispatch path:

* ``run_query(query_id, replicas)`` — simulation only: per-attempt latency
  comes from the ``ShardSim`` latency model of the chosen node (injected
  clock, fully deterministic; the original surface).
* ``run(query_id, replicas, call)`` — real dispatch: ``call(node)``
  actually executes the work (a ShardWorker scoring a shard) and returns
  its result. Latency per attempt still comes from the node's ShardSim
  model when one is registered (deterministic tests/benchmarks) and from
  the wall clock otherwise (production). An attempt whose ``call`` raises
  ``AttemptFailed`` is treated as a dead replica and the executor fails
  over to the next one.

  In SYNCHRONOUS call mode hedges are only issued against backup nodes
  that HAVE a latency model: in-process calls are synchronous, so once a
  wall-clock primary has returned, duplicating the work on a replica can
  never finish earlier — pure wall-clock mode therefore applies failover
  but no backup requests.
* ``run_async(query_id, replicas, begin, cancel)`` — the real-world
  hedging seam: ``begin(node)`` launches the attempt and returns a
  Future (an RPC in flight), so hedged backups are genuine duplicate
  requests fired on the wall clock. The first success wins; every still
  outstanding loser is cancelled through ``cancel(node, future)`` (on
  the RPC plane that sends a CANCEL frame the worker observes between
  shard tiles). A future failing with ``AttemptFailed`` triggers
  failover to the next untried replica.

Tail-latency statistics plus hedge-fire/-win/-cancel and failover
counters are recorded so benchmarks can show the p99 win and the serving
metrics can export them. ``failovers`` counts only at-call-time failures
(a replica that died under an actual attempt); replicas already known
dead are filtered up front and counted separately as ``skipped_dead`` —
a permanently dead primary must not inflate the failover rate.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, wait
from dataclasses import dataclass, field
from typing import Callable, Optional


class AttemptFailed(Exception):
    """Raised by a dispatch ``call`` to signal a dead/unreachable replica."""


class AllReplicasFailed(RuntimeError):
    """Every replica of a dispatch target is down — the caller's failure
    domain (distinct type so serving code can tell replica loss apart from
    unrelated runtime errors, e.g. a kernel crash)."""


class SimClock:
    """Deterministic event clock for tests/benchmarks."""

    def __init__(self):
        self.now = 0.0

    def advance(self, dt: float):
        self.now += dt


@dataclass
class ShardSim:
    """Latency model of one shard/node: base latency plus optional
    per-window straggle injected by tests."""
    name: str
    base_latency: float = 1.0
    straggle_until: float = -1.0
    straggle_factor: float = 10.0
    failed: bool = False

    def latency(self, now: float) -> float | None:
        if self.failed:
            return None
        if now < self.straggle_until:
            return self.base_latency * self.straggle_factor
        return self.base_latency


@dataclass
class _Attempt:
    done_at: float
    shard: str
    query_id: int
    hedged: bool
    result: object = None

    def __lt__(self, other: "_Attempt") -> bool:
        return self.done_at < other.done_at


@dataclass
class HedgedExecutor:
    """Executes shard requests with hedging + failover.

    shards: node name -> ShardSim latency model. In real-dispatch mode a
        node without a model is timed on the wall clock instead.
    replicas: query placement ranking, e.g. ShardPlacement.replicas
    hedge_after: backup request deadline (same unit as ShardSim latency /
        seconds in wall-clock mode)
    """
    shards: dict[str, ShardSim]
    hedge_after: float = 2.0
    max_hedges: int = 1
    clock: SimClock = field(default_factory=SimClock)
    # bounded history for the percentile stats (a long-lived frontend would
    # otherwise grow this forever); the integer counters stay exact totals
    completions: "deque[tuple[int, str, float, bool]]" = field(
        default_factory=lambda: deque(maxlen=65536))
    hedges_fired: int = 0
    hedges_won: int = 0
    hedges_cancelled: int = 0
    failovers: int = 0
    skipped_dead: int = 0
    # run_async executes from concurrent scatter threads; the counter
    # read-modify-writes go through this lock (the synchronous paths
    # are single-threaded by contract and skip it)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    # -- dispatch ------------------------------------------------------------
    def run_query(self, query_id: int, replicas: list[str]
                  ) -> tuple[str, float]:
        """Pure simulation: returns (serving_shard, completion_latency).
        Raises if every replica is failed."""
        shard, latency, _ = self._run(query_id, replicas, call=None)
        return shard, latency

    def run(self, query_id: int, replicas: list[str],
            call: Callable[[str], object]) -> tuple[str, float, object]:
        """Real dispatch: executes ``call(node)`` per attempt and returns
        (serving_node, completion_latency, result) of the winning attempt.
        Hedge/failover policy is identical to the simulation."""
        return self._run(query_id, replicas, call=call)

    def run_async(self, query_id: int, replicas: list[str],
                  begin: Callable[[str], Future],
                  cancel: Optional[Callable[[str, Future], None]] = None
                  ) -> tuple[str, float, object]:
        """Asynchronous dispatch over futures: ``begin(node)`` launches
        the attempt (an RPC in flight) and the executor hedges on the
        WALL clock — a backup fires ``hedge_after`` seconds after the
        previous attempt if nothing has completed, as a real duplicate
        request. First success wins; outstanding losers are cancelled
        via ``cancel(node, future)`` and counted in ``hedges_cancelled``.

        ``begin`` raising ``AttemptFailed`` (known-unreachable channel)
        or a future resolving to ``AttemptFailed`` fails over to the next
        untried replica. Returns (winning_node, latency_s, result)."""
        start = time.perf_counter()
        live = [r for r in replicas
                if not (r in self.shards and self.shards[r].failed)]
        with self._lock:
            self.skipped_dead += len(replicas) - len(live)
        # replicas not yet attempted, in placement-ranking order
        untried = deque(live)
        pending: dict[Future, tuple[str, bool]] = {}

        def issue(hedged: bool) -> bool:
            """Launch the next untried replica; False when exhausted.
            A begin() that refuses synchronously counts as a failover
            (it was this attempt's turn) and the walk continues."""
            while untried:
                node = untried.popleft()
                try:
                    fut = begin(node)
                except AttemptFailed:
                    with self._lock:
                        self.failovers += 1
                    continue
                pending[fut] = (node, hedged)
                return True
            return False

        if not issue(hedged=False):
            raise AllReplicasFailed(
                f"query {query_id}: all replicas failed")

        hedges_issued = 0
        next_hedge_at = start + self.hedge_after
        winner: Optional[tuple[str, bool, object]] = None
        error: Optional[BaseException] = None
        try:
            while pending:
                timeout = None
                if hedges_issued < self.max_hedges and untried:
                    timeout = max(0.0, next_hedge_at - time.perf_counter())
                done, _ = wait(list(pending), timeout=timeout,
                               return_when=FIRST_COMPLETED)
                if not done:
                    # hedge deadline passed with every attempt still in
                    # flight: fire a real duplicate request at the next
                    # untried replica
                    if issue(hedged=True):
                        with self._lock:
                            self.hedges_fired += 1
                    hedges_issued += 1
                    next_hedge_at += self.hedge_after
                    continue
                for fut in done:
                    node, hedged = pending.pop(fut)
                    exc = fut.exception()
                    if exc is None:
                        winner = (node, hedged, fut.result())
                        break
                    if not isinstance(exc, AttemptFailed):
                        error = exc           # not a replica death
                        break
                    with self._lock:
                        self.failovers += 1
                if winner is not None or error is not None:
                    break
                if not pending and not issue(hedged=False):
                    raise AllReplicasFailed(
                        f"query {query_id}: all replicas failed")
        finally:
            # cancel the losers (or everything, on an unexpected error)
            for fut, (node, hedged) in pending.items():
                fut.cancel()
                if cancel is not None:
                    try:
                        cancel(node, fut)
                    except Exception:
                        pass
                if winner is not None:
                    with self._lock:
                        self.hedges_cancelled += 1
        if error is not None:
            raise error
        if winner is None:
            raise AllReplicasFailed(
                f"query {query_id}: all replicas failed")
        node, hedged, result = winner
        latency = time.perf_counter() - start
        if hedged:
            with self._lock:
                self.hedges_won += 1
        self.completions.append((query_id, node, latency, hedged))
        return node, latency, result

    def _attempt_latency(self, node: str, at: float,
                         call: Optional[Callable[[str], object]]
                         ) -> tuple[float | None, object]:
        """(latency, result) of one attempt; latency None = replica dead.
        With a registered model the latency is simulated (the call, when
        present, still executes so the result is real); without one the
        call is timed on the wall clock."""
        model = self.shards.get(node)
        if model is not None:
            lat = model.latency(at)
            if lat is None:
                return None, None
            if call is None:
                return lat, None
            try:
                return lat, call(node)
            except AttemptFailed:
                return None, None
        if call is None:
            raise KeyError(f"no latency model for simulated node {node!r}")
        t0 = time.perf_counter()
        try:
            result = call(node)
        except AttemptFailed:
            return None, None
        return time.perf_counter() - t0, result

    def _run(self, query_id: int, replicas: list[str],
             call: Optional[Callable[[str], object]]
             ) -> tuple[str, float, object]:
        start = self.clock.now
        events: list[_Attempt] = []

        def issue(shard_name: str, at: float, hedged: bool) -> bool:
            lat, result = self._attempt_latency(shard_name, at, call)
            if lat is None:
                return False
            heapq.heappush(events, _Attempt(at + lat, shard_name, query_id,
                                            hedged, result))
            return True

        # known-dead replicas (model.failed) are skipped up front; a replica
        # that turns out dead at call time fails over to the next one here.
        live = [r for r in replicas
                if not (r in self.shards and self.shards[r].failed)]
        primary_i = 0
        while primary_i < len(live) and not issue(live[primary_i], start,
                                                  hedged=False):
            primary_i += 1
        # at-call-time deaths are failovers; replicas filtered as known
        # dead ahead of the serving primary are skips, not failovers — a
        # permanently dead primary must not inflate the failover rate
        self.failovers += primary_i
        if primary_i >= len(live):
            self.skipped_dead += len(replicas) - len(live)
            raise AllReplicasFailed(
                f"query {query_id}: all replicas failed")
        self.skipped_dead += replicas.index(live[primary_i]) - primary_i
        live = live[primary_i:]

        # replicas not yet attempted, in placement-ranking order: each
        # hedge walks to the NEXT untried node, so the budget is spent on
        # distinct backups and never wraps back onto an already-issued
        # attempt (the old modulo indexing burned budget on the primary
        # with 2 live replicas and max_hedges >= 2)
        untried = deque(live[1:])
        hedges_issued = 0
        next_hedge_at = start + self.hedge_after
        while events:
            attempt = events[0]
            # hedge fires before the fastest outstanding attempt completes?
            while (hedges_issued < self.max_hedges
                   and next_hedge_at < attempt.done_at
                   and untried):
                # only hedge nodes with a latency model: a synchronous
                # wall-clock backup finishes AFTER the already-returned
                # primary by construction — it could never win (see
                # module docstring), so skip it WITHOUT spending budget
                backup = None
                while untried:
                    cand = untried.popleft()
                    if call is None or cand in self.shards:
                        backup = cand
                        break
                if backup is None:
                    break
                if issue(backup, next_hedge_at, hedged=True):
                    self.hedges_fired += 1
                hedges_issued += 1
                next_hedge_at += self.hedge_after
                attempt = events[0]
            heapq.heappop(events)
            self.clock.now = max(self.clock.now, attempt.done_at)
            latency = attempt.done_at - start
            if attempt.hedged:
                self.hedges_won += 1
            self.completions.append((query_id, attempt.shard, latency,
                                     attempt.hedged))
            return attempt.shard, latency, attempt.result
        raise RuntimeError("no attempt completed")

    # -- statistics ----------------------------------------------------------
    def latencies(self) -> list[float]:
        return [c[2] for c in self.completions]

    def hedged_fraction(self) -> float:
        if not self.completions:
            return 0.0
        return sum(1 for c in self.completions if c[3]) / len(self.completions)

    def percentile(self, q: float) -> float:
        ls = sorted(self.latencies())
        if not ls:
            return 0.0
        i = min(len(ls) - 1, int(q * len(ls)))
        return ls[i]
