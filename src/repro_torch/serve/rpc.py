"""The networked shard data plane: real RPC fan-out with cancellable
hedges.

This is ``repro.serve.rpc`` for the PyTorch port. An in-process frontend
dispatches shards by function call, so hedging there is simulation-only
(a synchronous backup can never beat an already-returned primary). This
module puts the wire (``repro_torch.serve.net``, protocol v4, byte-equal
to the JAX package's, so fleets may mix the two) under the
``HedgedExecutor`` seam:

* ``WorkerServer`` — one ``ShardWorker`` behind its own TCP server.
  SHARD_QUERY frames land in a job queue drained by a single scorer
  thread (one device per host — dispatches serialize anyway); CANCEL
  frames set the rid's cancellation flag, which the scorer observes
  between shard tiles (``ShardWorker.score_candidates(cancelled=...)``)
  and answers SHARD_CANCELLED without scoring the rest. STATS returns
  the worker's counters (``cancelled_tiles`` is the headline: a hedge
  loser was OBSERVABLY cancelled, not silently completed).
* ``WorkerChannel`` — one reconnecting client channel per placement
  node: a persistent pipelined connection, a reader thread resolving
  per-rid futures, liveness PINGs, and exponential backoff with jitter
  when the peer dies. A channel failure fails every in-flight future
  with ``RpcError`` (an ``AttemptFailed``: the executor fails over) and
  redials in the background — connections are reused across batches.
* ``WorkerPool`` — placement node name -> live channel, plus the
  fleet-level accounting (per-node PruneStats accumulated off
  SHARD_RESULT frames) the frontend's metrics deltas read.
* ``RpcFrontend`` — the scatter/gather frontend with its dispatch seam
  rewired: every shard dispatch is ``HedgedExecutor.run_async`` over
  channel futures, so hedged backups are REAL duplicate RPCs fired on
  the wall clock and the loser is cancelled with a CANCEL frame when
  the winner returns. Gather, final selection, and therefore results
  stay bit-identical to the in-process frontend and the single-host
  QueryEngine.

``WorkerChannel.close`` joins the reader thread only once it has started:
the redialer publishes a reader after starting it, so a channel closed
while its first connection is still being set up never joins a thread
that has not started.
"""
from __future__ import annotations

import itertools
import json
import queue
import random
import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..index.hedge import (AllReplicasFailed, AttemptFailed,
                           HedgedExecutor)
from ..index.placement import ShardPlacement
from ..obs import EventLog, KernelProfiler, Tracer
from .batcher import MicroBatcher
from .frontend import Frontend, FrontendConfig
from .metrics import ServingMetrics
from .net import (MSG_CANCEL, MSG_HELLO, MSG_PING, MSG_PONG,
                  MSG_SHARD_QUERY, MSG_SHARD_RESULT, MSG_STATS,
                  PROTO_VERSION, SHARD_CANCELLED, SHARD_FAILED, SHARD_OK,
                  _Session, decode_hello, decode_rid, decode_shard_query,
                  decode_shard_result, decode_stats, encode_cancel,
                  encode_hello, encode_ping, encode_shard_query,
                  encode_shard_result, encode_stats, read_frame,
                  write_frame)
from .worker import DispatchCancelled, ShardWorker


class ChannelDown(AttemptFailed):
    """The node's channel is not connected — the dispatch was never sent
    (the executor fails over without burning a wire round trip)."""


class RpcError(AttemptFailed):
    """An in-flight RPC failed because the channel died under it (torn
    frame, reset, worker killed mid-SHARD_RESULT). Distinct from
    ChannelDown so tests can assert pending futures fail with the
    channel-death error rather than a refused send."""


# -- worker side ---------------------------------------------------------------

class WorkerServer:
    """One ShardWorker process's TCP front door (protocol v4).

    ``straggle_s`` is the test/benchmark straggler hook: every dispatch
    sleeps that long BEFORE scoring, in small ticks that observe the
    cancellation flag — an injected tail that a hedged duplicate on a
    healthy worker beats, and whose cancellation is observable in
    ``cancelled_tiles``."""

    def __init__(self, worker: ShardWorker, *, host: str = "127.0.0.1",
                 port: int = 0, backlog: int = 64,
                 straggle_s: float = 0.0):
        self.worker = worker
        self.straggle_s = float(straggle_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(backlog)
        self.address: tuple[str, int] = self._listener.getsockname()
        self._jobs: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._conns: set[_Session] = set()
        self._conns_lock = threading.Lock()
        self._closing = False
        self._accept_thread: Optional[threading.Thread] = None
        self._scorer: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WorkerServer":
        self._scorer = threading.Thread(target=self._score_loop,
                                        name="worker-score", daemon=True)
        self._scorer.start()
        self._accept_thread = threading.Thread(
            target=self._accept, name="worker-accept", daemon=True)
        self._accept_thread.start()
        return self

    def close(self, *, abort: bool = False) -> None:
        """Stop serving. ``abort=True`` dies like a killed process:
        every connection is severed IMMEDIATELY (clients see a dead
        peer mid-stream and fail over), queued jobs fail into the
        severed sockets instead of being drained gracefully."""
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        with self._conns_lock:
            sessions = list(self._conns)
            if abort:
                self._conns = set()
        if abort:
            for s in sessions:
                s.kick()
        self._jobs.put(None)
        if self._scorer is not None:
            self._scorer.join(timeout=5.0)
            self._scorer = None
        if not abort:
            with self._conns_lock:
                sessions, self._conns = list(self._conns), set()
        for s in sessions:
            s.finish(timeout_s=0.2 if abort else 1.0)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict:
        w = self.worker
        return {"name": w.name,
                "shards": [int(g) for g in w.shard_ids],
                "n_docs": int(w.layout.n_docs),
                "dispatches": int(w.dispatches),
                "cancelled_tiles": int(w.cancelled_tiles),
                "pruned_dispatches": int(w.pruned_dispatches),
                "queue_depth": self._jobs.qsize()}

    # -- connection handling -------------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._closing:
                    conn.close()
                    continue
                session = _Session(conn)
                self._conns.add(session)
            threading.Thread(target=self._serve_conn, args=(session,),
                             name="worker-conn", daemon=True).start()

    def _serve_conn(self, session: _Session) -> None:
        conn = session.sock
        # rid -> cancellation flag, for every dispatch this connection
        # has in flight (rids are unique per connection; the flag is set
        # by CANCEL and observed by the scorer between shard tiles)
        flags: dict[int, threading.Event] = {}
        try:
            session.send(encode_hello(self.worker.params,
                                      self.worker.layout.n_docs,
                                      PROTO_VERSION))
            while True:
                payload = read_frame(conn)
                if payload is None or not payload:
                    return
                t = payload[0]
                if t == MSG_SHARD_QUERY:
                    (rid, gshard, buf, n_valid, cutoffs, topks,
                     n_live) = decode_shard_query(payload)
                    ev = threading.Event()
                    flags[rid] = ev
                    self._jobs.put((session, flags, rid, gshard, buf,
                                    n_valid, cutoffs, topks, n_live, ev))
                elif t == MSG_CANCEL:
                    # CANCEL follows its SHARD_QUERY on the same FIFO
                    # connection, so the flag always exists (or the
                    # dispatch already finished and was cleaned up)
                    ev = flags.get(decode_rid(payload))
                    if ev is not None:
                        ev.set()
                elif t == MSG_PING:
                    session.send(encode_ping(decode_rid(payload),
                                             pong=True))
                elif t == MSG_STATS:
                    fmt, _ = decode_stats(payload)
                    session.send(encode_stats(
                        fmt, json.dumps(self.stats()).encode()))
                else:
                    raise ConnectionError(f"unexpected message {t}")
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                owned = session in self._conns
                self._conns.discard(session)
            if owned:
                session.finish(timeout_s=1.0)

    # -- scoring -------------------------------------------------------------
    def _prune_tuple(self) -> tuple[int, int, int, int, int]:
        w = self.worker
        return (w.prune_stats.blocks_total, w.prune_stats.blocks_pruned,
                w.prune_stats.shard_visits_skipped,
                w.prune_stats.bytes_read, w.prune_baseline_bytes)

    def _score_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            (session, flags, rid, gshard, buf, n_valid, cutoffs, topks,
             n_live, ev) = job
            try:
                if ev.is_set():
                    # cancelled while queued: never reached a tile
                    self.worker.cancelled_tiles += 1
                    raise DispatchCancelled("cancelled in queue")
                if self.straggle_s > 0:
                    # injected tail, ticking the cancellation flag the
                    # same way scoring checks it between tiles
                    end = time.monotonic() + self.straggle_s
                    while time.monotonic() < end:
                        if ev.is_set():
                            self.worker.cancelled_tiles += 1
                            raise DispatchCancelled("cancelled mid-tile")
                        time.sleep(0.002)
                prune0 = self._prune_tuple()
                terms_dev, nvalid_dev = self.worker.stage_batch(buf,
                                                                n_valid)
                cands, method = self.worker.score_candidates(
                    gshard, terms_dev, nvalid_dev, cutoffs, topks,
                    n_live, cancelled=ev.is_set)
                prune1 = self._prune_tuple()
                delta = tuple(b - a for a, b in zip(prune0, prune1))
                session.send(encode_shard_result(rid, SHARD_OK, method,
                                                 cands[:n_live], delta))
            except DispatchCancelled:
                session.send(encode_shard_result(rid, SHARD_CANCELLED,
                                                 "cancelled"))
            except AttemptFailed as e:
                session.send(encode_shard_result(rid, SHARD_FAILED,
                                                 str(e)))
            except Exception as e:       # noqa: BLE001 — reply, don't die
                session.send(encode_shard_result(rid, SHARD_FAILED,
                                                 repr(e)))
            finally:
                flags.pop(rid, None)


# -- frontend side -------------------------------------------------------------

# reconnect backoff: BASE * 2^attempt, capped, with +-50% jitter so a
# fleet of frontends does not redial a recovering worker in lockstep
BACKOFF_BASE_S = 0.05
BACKOFF_MAX_S = 2.0


class WorkerChannel:
    """One reconnecting channel to one worker process.

    Lives for the pool's lifetime: the connection is reused across
    batches, a dead peer fails every pending future with ``RpcError``
    (no hang — the executor fails over), and a background thread redials
    with exponential backoff + jitter until the worker returns."""

    def __init__(self, node: str, host: str, port: int, *,
                 metrics: Optional[ServingMetrics] = None,
                 timeout_s: float = 30.0,
                 backoff_base_s: float = BACKOFF_BASE_S,
                 backoff_max_s: float = BACKOFF_MAX_S):
        self.node, self.host, self.port = node, host, int(port)
        self.metrics = metrics
        self.timeout_s = timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.params = None
        self.n_docs: Optional[int] = None
        self.healthy = False
        self.reconnects = 0          # successful dials after the first
        self.disconnects = 0
        self._connected_once = False
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._wlock = threading.Lock()
        self._flock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._pongs: dict[int, Future] = {}
        self._stats_futs: "queue.SimpleQueue[Future]" = queue.SimpleQueue()
        self._rids = itertools.count(1)
        self._closed = False
        # cumulative PruneStats accumulated off SHARD_RESULT deltas:
        # (blocks_total, blocks_pruned, visits_skipped, bytes_read,
        # baseline_bytes) — the remote analogue of worker.prune_stats
        self._prune = [0, 0, 0, 0, 0]
        self._redial = threading.Thread(target=self._reconnect_loop,
                                        name=f"chan-{node}", daemon=True)
        self._redial_wake = threading.Event()
        self._redial.start()

    # -- connection management -----------------------------------------------
    def _dial_once(self) -> bool:
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = read_frame(sock)
            if hello is None or hello[0] != MSG_HELLO:
                sock.close()
                return False
            params, n_docs, _version = decode_hello(hello)
        except (OSError, ConnectionError):
            return False
        sock.settimeout(None)
        with self._flock:
            if self._closed:
                sock.close()
                return True              # stop redialing
            self.params, self.n_docs = params, n_docs
            self._sock = sock
            reconnect = self._connected_once
            self._connected_once = True
            if reconnect:
                self.reconnects += 1
        # a redial is counted everywhere before the channel reads healthy
        # (C8); healthy is set under the lock and before the reader
        # starts, so a reader that fails at once leaves it False
        if self.metrics is not None:
            self.metrics.record_channel(self.node, up=True,
                                        reconnect=reconnect)
        with self._flock:
            if self._closed:
                return True              # close() took and shut the socket
            self.healthy = True
        reader = threading.Thread(target=self._read_loop, args=(sock,),
                                  name=f"chan-read-{self.node}",
                                  daemon=True)
        reader.start()
        self._reader = reader            # published only once started
        return True

    def _reconnect_loop(self) -> None:
        attempt = 0
        while not self._closed:
            if self.healthy:
                # park until the reader reports the channel down
                self._redial_wake.wait(timeout=0.25)
                self._redial_wake.clear()
                attempt = 0
                continue
            if self._dial_once():
                attempt = 0
                continue
            delay = min(self.backoff_max_s,
                        self.backoff_base_s * (2 ** attempt))
            time.sleep(delay * (0.5 + random.random()))
            attempt += 1

    def _fail_channel(self, err: Exception) -> None:
        """The peer died: mark unhealthy, fail EVERY pending future with
        a distinct error (no caller hangs), wake the redialer."""
        with self._flock:
            was_healthy = self.healthy
            self.healthy = False
            self._sock = None
            pending, self._pending = list(self._pending.values()), {}
            pongs, self._pongs = list(self._pongs.values()), {}
        stats = []
        while True:
            try:
                stats.append(self._stats_futs.get_nowait())
            except queue.Empty:
                break
        rpc_err = RpcError(f"channel to {self.node} "
                           f"({self.host}:{self.port}) died: {err!r}")
        for fut in pending + pongs + stats:
            _resolve(fut, error=rpc_err)
        if was_healthy:
            self.disconnects += 1
            if self.metrics is not None:
                self.metrics.record_channel(self.node, up=False)
                if pending:
                    self.metrics.record_rpc(self.node, "failed",
                                            len(pending))
        self._redial_wake.set()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                payload = read_frame(sock)
                if payload is None or not payload:
                    raise ConnectionError("worker closed the channel")
                t = payload[0]
                if t == MSG_SHARD_RESULT:
                    rid, status, method, cands, prune = \
                        decode_shard_result(payload)
                    with self._flock:
                        fut = self._pending.pop(rid, None)
                        for i, d in enumerate(prune):
                            self._prune[i] += d
                    if fut is None:
                        continue         # cancelled and forgotten
                    if status == SHARD_OK:
                        if self.metrics is not None:
                            self.metrics.record_rpc(self.node, "ok")
                        _resolve(fut, value=(cands, method))
                    elif status == SHARD_CANCELLED:
                        _resolve(fut, error=AttemptFailed(
                            f"{self.node}: dispatch cancelled"))
                    else:
                        _resolve(fut, error=AttemptFailed(
                            f"{self.node}: {method}"))
                elif t == MSG_PONG:
                    nonce = decode_rid(payload)
                    with self._flock:
                        fut = self._pongs.pop(nonce, None)
                    if fut is not None:
                        _resolve(fut, value=True)
                elif t == MSG_STATS:
                    _, body = decode_stats(payload)
                    try:
                        sfut = self._stats_futs.get_nowait()
                    except queue.Empty:
                        raise ConnectionError("unsolicited STATS")
                    _resolve(sfut, value=body)
                else:
                    raise ConnectionError(f"unexpected message {t}")
        except Exception as e:           # noqa: BLE001 — sweep, then die
            self._fail_channel(e)

    # -- RPC surface ---------------------------------------------------------
    def submit_shard(self, gshard: int, buf: np.ndarray,
                     n_valid: np.ndarray, cutoffs: np.ndarray,
                     topks: np.ndarray, n_live: int) -> Future:
        """One shard dispatch in flight: returns a Future resolving to
        (cands, method). The rid rides on the future (``fut.rid``) so a
        hedging loser can be cancelled by id."""
        with self._flock:
            if not self.healthy or self._sock is None:
                raise ChannelDown(f"channel to {self.node} is down")
            rid = next(self._rids)
            fut: Future = Future()
            fut.rid = rid
            fut.node = self.node
            self._pending[rid] = fut
            sock = self._sock
        payload = encode_shard_query(rid, gshard, buf, n_valid, cutoffs,
                                     topks, n_live)
        try:
            with self._wlock:
                write_frame(sock, payload)
        except OSError as e:
            with self._flock:
                self._pending.pop(rid, None)
            self._fail_channel(e)
            raise ChannelDown(f"channel to {self.node} died on send") \
                from e
        if self.metrics is not None:
            self.metrics.record_rpc(self.node, "sent")
        return fut

    def cancel(self, rid: int) -> None:
        """Best-effort CANCEL: the worker checks the flag between shard
        tiles; a dispatch that already finished ignores it."""
        with self._flock:
            self._pending.pop(rid, None)
            sock = self._sock if self.healthy else None
        if sock is None:
            return
        try:
            with self._wlock:
                write_frame(sock, encode_cancel(rid))
        except OSError:
            pass
        if self.metrics is not None:
            self.metrics.record_rpc(self.node, "cancelled")

    def ping(self, timeout_s: float = 2.0) -> bool:
        """Liveness probe over the live channel (False when down)."""
        with self._flock:
            if not self.healthy or self._sock is None:
                return False
            nonce = next(self._rids)
            fut: Future = Future()
            self._pongs[nonce] = fut
            sock = self._sock
        try:
            with self._wlock:
                write_frame(sock, encode_ping(nonce))
            return bool(fut.result(timeout_s))
        except Exception:
            with self._flock:
                self._pongs.pop(nonce, None)
            return False

    def stats(self, timeout_s: float = 5.0) -> dict:
        with self._flock:
            if not self.healthy or self._sock is None:
                raise ChannelDown(f"channel to {self.node} is down")
            fut: Future = Future()
            self._stats_futs.put(fut)
            sock = self._sock
        with self._wlock:
            write_frame(sock, encode_stats(0))
        return json.loads(fut.result(timeout_s))

    def prune_counters(self) -> tuple[int, int, int, int, int]:
        with self._flock:
            return tuple(self._prune)

    def close(self) -> None:
        with self._flock:
            self._closed = True
            sock, self._sock = self._sock, None
            self.healthy = False
        self._redial_wake.set()
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        reader = self._reader
        if reader is not None:           # a started thread, or None
            reader.join(timeout=2.0)


def _resolve(fut: Future, *, value=None, error: Exception = None) -> None:
    """Resolve a future that the hedging executor may have cancelled
    already (set_result on a cancelled Future raises)."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(value)
    except Exception:
        pass


class WorkerPool:
    """Placement node name -> live WorkerChannel.

    The pool owns the channels (connection reuse across batches and
    queries), surfaces fleet health, and aggregates the per-node
    PruneStats the frontend's metrics deltas read."""

    def __init__(self, nodes: dict[str, tuple[str, int]], *,
                 metrics: Optional[ServingMetrics] = None,
                 timeout_s: float = 30.0):
        self.channels: dict[str, WorkerChannel] = {
            node: WorkerChannel(node, host, port, metrics=metrics,
                                timeout_s=timeout_s)
            for node, (host, port) in nodes.items()}

    def bind_metrics(self, metrics: ServingMetrics) -> None:
        for ch in self.channels.values():
            ch.metrics = metrics
            metrics.record_channel(ch.node, up=ch.healthy)

    def wait_connected(self, timeout_s: float = 10.0) -> None:
        """Block until every channel has dialed its worker once."""
        deadline = time.monotonic() + timeout_s
        for ch in self.channels.values():
            while not ch.healthy:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {ch.node} at {ch.host}:{ch.port} "
                        f"not reachable after {timeout_s:.0f}s")
                time.sleep(0.01)

    def channel(self, node: str) -> WorkerChannel:
        return self.channels[node]

    @property
    def params(self):
        for ch in self.channels.values():
            if ch.params is not None:
                return ch.params
        raise RuntimeError("no channel has completed its HELLO yet")

    @property
    def n_docs(self) -> int:
        for ch in self.channels.values():
            if ch.n_docs is not None:
                return ch.n_docs
        raise RuntimeError("no channel has completed its HELLO yet")

    def health(self) -> dict[str, bool]:
        return {n: ch.healthy for n, ch in self.channels.items()}

    def begin_shard(self, node: str, gshard: int, buf, n_valid, cutoffs,
                    topks, n_live: int) -> Future:
        return self.channels[node].submit_shard(gshard, buf, n_valid,
                                                cutoffs, topks, n_live)

    def cancel(self, node: str, fut: Future) -> None:
        rid = getattr(fut, "rid", None)
        if rid is not None:
            self.channels[node].cancel(rid)

    def prune_counters(self) -> tuple[int, int, int, int, int]:
        totals = [0, 0, 0, 0, 0]
        for ch in self.channels.values():
            for i, v in enumerate(ch.prune_counters()):
                totals[i] += v
        return tuple(totals)

    def close(self) -> None:
        for ch in self.channels.values():
            ch.close()


class RpcFrontend(Frontend):
    """The scatter/gather frontend over the RPC data plane.

    Identical to ``Frontend`` in everything above the dispatch seam
    (batching, gather, final selection, metrics, tracing) — only
    ``_scatter`` changes: each shard dispatch is an
    ``HedgedExecutor.run_async`` over ``WorkerPool`` channel futures, so
    hedged backups are real duplicate RPCs and losers are cancelled on
    the wire. Index parameters and document count come from the workers'
    HELLOs instead of local ShardWorker objects."""

    def __init__(self, pool: WorkerPool, placement: ShardPlacement,
                 config: FrontendConfig = FrontendConfig(), *,
                 clock: Optional[Callable[[], float]] = None):
        self.pool = pool
        self.workers: dict[str, ShardWorker] = {}   # dispatch is remote
        self.placement = placement
        self.config = config
        self.executor = HedgedExecutor(
            shards={}, hedge_after=config.hedge_after_s,
            max_hedges=config.max_hedges)
        self._simulated = False
        self.clock = clock if clock is not None else time.monotonic
        self.batcher = MicroBatcher(
            term_pad=config.term_pad, max_batch=config.max_batch,
            max_wait_s=config.max_wait_s, max_queued=config.max_queued,
            adaptive=config.adaptive_buckets)
        self.metrics = ServingMetrics()
        pool.bind_metrics(self.metrics)
        self.events = EventLog(config.trace_log,
                               ring=max(64, config.trace_ring))
        self.tracer = Tracer(enabled=config.tracing,
                             ring=config.trace_ring,
                             slow_ms=config.trace_slow_ms,
                             sink=self.events, clock=self.clock)
        self.metrics.tracer = self.tracer
        self.profiler = KernelProfiler(self.metrics.registry, None,
                                       enabled=config.profile_kernels)
        self._responses = {}
        self._next_id = 0
        self._dispatch_seq = 0
        self._seq_lock = threading.Lock()
        self.params = pool.params
        self.n_docs = pool.n_docs
        # run_async blocks a thread per in-flight shard, so the scatter
        # pool is mandatory here (sized at least one slot per shard up
        # to the configured width)
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, config.scatter_threads),
            thread_name_prefix="scatter")

    def verify_placement(self) -> dict[str, list[int]]:
        """Best-effort check that each node's worker actually holds its
        replica set (worker STATS lists its shards). Returns the gaps
        per node — empty dict when the fleet matches the placement."""
        gaps: dict[str, list[int]] = {}
        for node, held in self.placement.replica_assignment().items():
            if not held:
                continue
            try:
                shards = set(self.pool.channel(node).stats()["shards"])
            except Exception:            # noqa: BLE001
                continue                 # unreachable: checked at dispatch
            missing = [g for g in held if g not in shards]
            if missing:
                gaps[node] = missing
        return gaps

    def _scatter(self, staged, buf, n_valid, cutoffs, topks, Q: int):
        """Concurrent hedged RPC scatter: one run_async per shard on the
        scatter pool. Each dispatch fires its primary immediately, fires
        real duplicate backups on the wall clock if the primary dawdles
        past hedge_after, and cancels the loser when a winner returns."""
        ex = self.executor
        n_shards = self.placement.n_shards

        def dispatch(g: int):
            with self._seq_lock:
                self._dispatch_seq += 1
                seq = self._dispatch_seq
            return ex.run_async(
                seq, self.placement.replicas(g),
                begin=lambda node: self.pool.begin_shard(
                    node, g, buf, n_valid, cutoffs, topks, Q),
                cancel=self.pool.cancel)

        futures = [self._pool.submit(dispatch, g)
                   for g in range(n_shards)]
        out, failed = [], None
        for fut in futures:
            try:
                out.append(fut.result())
            except AllReplicasFailed as e:
                failed = e               # keep draining: pool stays clean
        if failed is not None:
            raise failed
        max_done = max((lat for _, lat, _ in out), default=0.0)
        return out, max_done

    def _tile_counters(self) -> tuple[int, int, int, int]:
        return (0, 0, 0, 0)              # tiles live in worker processes

    def _prune_counters(self) -> tuple[int, int, int, int, int]:
        return self.pool.prune_counters()

    def fail_worker(self, node: str) -> list[int]:
        return self.placement.fail(node)

    def recover_worker(self, node: str) -> list[int]:
        return self.placement.recover(node)

    def reset_metrics(self, *, clear_caches: bool = False) -> None:
        super().reset_metrics(clear_caches=clear_caches)
        self.pool.bind_metrics(self.metrics)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self.pool.close()
