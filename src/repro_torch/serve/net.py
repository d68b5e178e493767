"""Network serving: a length-prefixed binary wire protocol over TCP.

This is the seam that turns the in-process serving library into a real
multi-user system: any number of client processes connect, pipeline
queries, and the ServingLoop coalesces them into shared micro-batches —
the cross-client batching the bit-sliced design's one-kernel-per-batch
economics depend on.

Framing is deliberately primitive (stdlib ``struct``, no schema
compiler): every frame is a 4-byte big-endian payload length followed by
the payload, whose first byte is the message type.

* ``HELLO``  (server -> client, once per connection): protocol version +
  the index parameters (n_hashes, kmer, canonical, fpr) and document
  count, so clients can compile DNA patterns to packed terms themselves —
  the wire carries compiled terms, never raw sequences.
* ``QUERY``  (client -> server): client-chosen request id (u64, echoed
  back — ids only need to be unique per connection), threshold (f64, NaN
  = server default), top_k (u32, 0 = threshold mode), deadline (f64
  RELATIVE seconds, <= 0 = none; the server rebases it onto its own
  clock, so client/server clock skew never drops a request), term count,
  then the packed uint32 little-endian term pairs.
* ``RESULT`` (server -> client): echoed request id, status byte
  (OK / REJECTED / DROPPED / FAILED — REJECTED is the 429-style
  backpressure reply, sent immediately when the queue cap refuses the
  request), the serving method + batch size, server-side wait/service
  seconds, and the SearchResult fields (n_terms, cutoff, doc ids,
  scores) as little-endian int32 arrays. A client reconstructs the exact
  SearchResult the in-process server produced — bit-identical, which the
  end-to-end property test asserts against a QueryEngine oracle.

Protocol version 2 adds end-to-end observability, all of it
OPTIONAL trailing bytes so version-1 frames remain valid:

* ``QUERY`` may carry a trailing u64 trace id (client-minted, nonzero):
  the server adopts it for the request's server-side trace, so a slow-
  query log line can be joined to the exact client call. A v1 client
  simply never appends it; the server treats absent as "no tracing".
* ``RESULT`` carries — only when the query carried a nonzero trace id —
  a trailing trace block: the echoed trace id plus a compact per-stage
  timing breakdown (stage name, total seconds) aggregated from the
  server-side trace spans (queue_wait / plan / kernel_score /
  shard_dispatch / gather ...).
* ``STATS`` (bidirectional): the client sends ``[MSG_STATS, format]``
  and the server replies with the same frame type carrying either a
  JSON metrics snapshot (format 0) or the Prometheus text exposition of
  the whole metrics registry (format 1).

Protocol version 3 adds the offline bulk lane:

* ``BULK`` (client -> server): a whole query set in one frame —
  client-chosen base request id (u64), threshold (f64, NaN = server
  default), top_k (u32, 0 = threshold mode), query count, then per
  query a u32 term count followed by the packed term pairs. The server
  submits the set to its attached ``BulkLane`` (shard-major sweep that
  runs in interactive idle time) and answers with ONE ``RESULT`` frame
  per query at ``rid_base + i`` when the sweep completes — the same
  RESULT format interactive queries use, so a client demultiplexes both
  lanes with one reader. A server without a bulk lane answers every
  query REJECTED immediately.

Protocol version 4 adds the worker data plane — the frames the sharded
frontend uses to scatter real RPCs at ShardWorker processes (the JAX
package's ``repro.serve.rpc``; the port has the codecs, not yet the RPC
plane):

* ``SHARD_QUERY`` (frontend -> worker): one shard dispatch of one
  micro-batch — request id (u64), global shard id, padded query count,
  bucket width, live query count, then the per-query n_valid / cutoff /
  top-k arrays and the padded packed term buffer.
* ``SHARD_RESULT`` (worker -> frontend): echoed rid, status byte
  (OK / CANCELLED / FAILED), the scoring method (or the error text on
  FAILED), this dispatch's PruneStats delta, then per-query candidate
  (doc, score) arrays.
* ``CANCEL`` (frontend -> worker): echoed rid — fired when a hedged
  duplicate of the dispatch already won. The worker checks the rid's
  cancellation flag between shard tiles and answers CANCELLED without
  scoring the rest.
* ``PING``/``PONG``: liveness probe for the reconnecting channel pool.

A server pinned to ``proto_version=1`` (constructor knob) speaks the old
protocol bit-for-bit — the mixed-version interop tests hold both
directions: old client against a new server (pinned v1) and raw v1
frames against a v2 server.

Sessions are pipelined: a client may have any number of queries in
flight; responses come back in completion order (batch flushes), matched
by request id. Shutdown is graceful: ``NetServer.close(drain=True)``
stops accepting, lets the loop drain every queued request, writes every
response, then closes the sockets — clients see their answers, then EOF.

This is ``repro.serve.net`` for the PyTorch port. Every constant, struct
layout and codec is the JAX module's, so the bytes on the wire are the
same in both directions: a JAX ``NetClient`` queries a torch
``NetServer``, and a torch ``NetClient`` a JAX ``NetServer``. The one
difference is in ``_Session.finish``, which joins the writer again after
its final kick, so the writer has stopped when ``finish`` returns.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import queue
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from ..core.index import IndexParams
from ..core.query import SearchResult, compile_pattern
from ..obs.export import render_prometheus
from .loop import LoopClosed, ServingLoop
from .request import QueryResponse, Status

PROTO_VERSION = 4        # v4: worker data plane (v3: BULK, v2: trace)
MIN_PROTO_VERSION = 1    # oldest version a client will still talk to

MSG_HELLO = 1
MSG_QUERY = 2
MSG_RESULT = 3
MSG_STATS = 4
MSG_BULK = 5
MSG_SHARD_QUERY = 6
MSG_SHARD_RESULT = 7
MSG_CANCEL = 8
MSG_PING = 9
MSG_PONG = 10

STATS_SNAPSHOT = 0       # JSON-encoded MetricsSnapshot
STATS_PROMETHEUS = 1     # Prometheus text exposition of the registry

_LEN = struct.Struct("!I")
# type, version, n_docs, n_hashes, kmer, canonical, fpr
_HELLO = struct.Struct("!BHIBBBd")
# type, rid, threshold, top_k, deadline_rel_s, n_terms
_QUERY = struct.Struct("!BQdIdI")
# type, rid, status, batch_size, wait_s, service_s, n_terms, cutoff,
# n_hits, method_len
_RESULT = struct.Struct("!BQBIddIiIB")
# type, rid_base, threshold, top_k, n_queries
_BULK = struct.Struct("!BQdII")
# per-query header inside a BULK frame: term count
_BULK_Q = struct.Struct("!I")
# optional QUERY tail: client-minted trace id
_TRACE_ID = struct.Struct("!Q")
# optional RESULT tail header: trace id, n_stages; each stage is a u8
# name length + name bytes + f64 total seconds
_TRACE_HEAD = struct.Struct("!QB")
_STAGE_SECONDS = struct.Struct("!d")

# v4 worker data plane
# type, rid, gshard, q_pad, bucket, n_live
_SHARD_QUERY = struct.Struct("!BQIIII")
# type, rid, status, method_len (method doubles as the error text on
# SHARD_FAILED), then the PruneStats delta and per-query candidates
_SHARD_RESULT = struct.Struct("!BQBB")
# blocks_total, blocks_pruned, shard_visits_skipped, bytes_read,
# baseline_bytes — this dispatch's pruning delta
_SHARD_PRUNE = struct.Struct("!5Q")
_SHARD_NQ = struct.Struct("!I")
# type, rid (CANCEL) / nonce (PING, PONG)
_RID_ONLY = struct.Struct("!BQ")

SHARD_OK = 0
SHARD_CANCELLED = 1
SHARD_FAILED = 2

# wire status byte <-> Status (order is the protocol, do not reorder)
_STATUS_CODES = (Status.OK, Status.REJECTED, Status.DROPPED, Status.FAILED)
_STATUS_TO_CODE = {s: i for i, s in enumerate(_STATUS_CODES)}

MAX_FRAME = 64 * 2**20          # sanity bound on a declared payload length


# -- framing helpers ---------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """n bytes or None on clean EOF at a frame boundary; raises
    ConnectionError on EOF mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ConnectionError("EOF mid-frame")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds {MAX_FRAME}")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ConnectionError("EOF before frame payload")
    return payload


def write_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


# -- message encode/decode ----------------------------------------------------

def encode_hello(params: IndexParams, n_docs: int,
                 version: int = PROTO_VERSION) -> bytes:
    return _HELLO.pack(MSG_HELLO, version, n_docs, params.n_hashes,
                       params.kmer, int(params.canonical), params.fpr)


def decode_hello(payload: bytes) -> tuple[IndexParams, int, int]:
    (_, version, n_docs, n_hashes, kmer, canonical,
     fpr) = _HELLO.unpack(payload)
    return (IndexParams(n_hashes=n_hashes, fpr=fpr, kmer=kmer,
                        canonical=bool(canonical)), n_docs, version)


def encode_query(rid: int, terms: np.ndarray, threshold: Optional[float],
                 top_k: int, deadline_s: Optional[float],
                 trace_id: int = 0) -> bytes:
    """``trace_id`` nonzero appends the v2 trailing trace-id field — only
    send it to a server that announced protocol >= 2 (a v1 server's strict
    length check would tear the session)."""
    th = float("nan") if threshold is None else float(threshold)
    dl = 0.0 if deadline_s is None else float(deadline_s)
    body = np.ascontiguousarray(terms, dtype="<u4").tobytes()
    head = _QUERY.pack(MSG_QUERY, rid, th, int(top_k), dl,
                       terms.shape[0]) + body
    if trace_id:
        head += _TRACE_ID.pack(trace_id)
    return head


def decode_query(payload: bytes
                 ) -> tuple[int, np.ndarray, Optional[float], int,
                            Optional[float], int]:
    """Accepts BOTH v1 frames (terms only) and v2 frames (terms + the
    optional trailing trace id); returns trace_id 0 when absent."""
    (_, rid, th, top_k, dl, n_terms) = _QUERY.unpack_from(payload)
    body = payload[_QUERY.size:]
    trace_id = 0
    if len(body) == n_terms * 8 + _TRACE_ID.size:
        (trace_id,) = _TRACE_ID.unpack_from(body, n_terms * 8)
        body = body[: n_terms * 8]
    elif len(body) != n_terms * 8:
        raise ConnectionError(
            f"QUERY rid={rid}: {len(body)} term bytes != {n_terms} terms")
    terms = np.frombuffer(body, dtype="<u4").reshape(n_terms, 2)
    terms = terms.astype(np.uint32)          # native, writable
    return (rid, terms, None if math.isnan(th) else th, top_k,
            dl if dl > 0 else None, trace_id)


def _encode_trace_block(trace_id: int, stages: Optional[dict]) -> bytes:
    """Compact per-stage breakdown: trace id + up to 255 (name, seconds)
    pairs, insertion order preserved (admission -> delivery)."""
    items = list((stages or {}).items())[:255]
    out = [_TRACE_HEAD.pack(trace_id, len(items))]
    for name, seconds in items:
        nb = str(name).encode()[:255]
        out.append(struct.pack("!B", len(nb)) + nb
                   + _STAGE_SECONDS.pack(float(seconds)))
    return b"".join(out)


def _decode_trace_block(payload: bytes, off: int) -> tuple[int, dict]:
    (trace_id, n_stages) = _TRACE_HEAD.unpack_from(payload, off)
    off += _TRACE_HEAD.size
    stages: dict[str, float] = {}
    for _ in range(n_stages):
        nlen = payload[off]
        off += 1
        name = payload[off: off + nlen].decode()
        off += nlen
        (seconds,) = _STAGE_SECONDS.unpack_from(payload, off)
        off += _STAGE_SECONDS.size
        stages[name] = seconds
    return trace_id, stages


def encode_result(rid: int, resp: QueryResponse, *,
                  trace_id: int = 0) -> bytes:
    """``trace_id`` nonzero (the id the QUERY carried) appends the v2
    trace block with the response's per-stage breakdown."""
    res = resp.result
    method = resp.method.encode()[:255]
    if res is None:
        head = _RESULT.pack(MSG_RESULT, rid, _STATUS_TO_CODE[resp.status],
                            resp.batch_size, resp.wait_s, resp.service_s,
                            0, 0, 0, len(method))
        frame = head + method
    else:
        head = _RESULT.pack(MSG_RESULT, rid, _STATUS_TO_CODE[resp.status],
                            resp.batch_size, resp.wait_s, resp.service_s,
                            res.n_terms, int(res.threshold),
                            res.doc_ids.shape[0], len(method))
        frame = (head + method
                 + np.ascontiguousarray(res.doc_ids, dtype="<i4").tobytes()
                 + np.ascontiguousarray(res.scores, dtype="<i4").tobytes())
    if trace_id:
        frame += _encode_trace_block(trace_id, resp.stages)
    return frame


def decode_result(payload: bytes) -> tuple[int, "NetResult"]:
    (_, rid, code, batch_size, wait_s, service_s, n_terms, cutoff,
     n_hits, mlen) = _RESULT.unpack_from(payload)
    off = _RESULT.size
    method = payload[off: off + mlen].decode()
    off += mlen
    status = _STATUS_CODES[code]
    result = None
    if status == Status.OK:
        docs = np.frombuffer(payload, dtype="<i4", count=n_hits,
                             offset=off).astype(np.int32)
        scores = np.frombuffer(payload, dtype="<i4", count=n_hits,
                               offset=off + 4 * n_hits).astype(np.int32)
        result = SearchResult(docs, scores, n_terms, cutoff)
        off += 8 * n_hits
    trace_id, stages = 0, None
    if len(payload) > off:                   # v2 trailing trace block
        trace_id, stages = _decode_trace_block(payload, off)
    return rid, NetResult(status, result, method, batch_size, wait_s,
                          service_s, trace_id, stages)


def encode_stats(fmt: int, body: bytes = b"") -> bytes:
    """Both directions: the request is the bare [type, format] header,
    the reply appends the rendered body."""
    return struct.pack("!BB", MSG_STATS, fmt) + body


def decode_stats(payload: bytes) -> tuple[int, bytes]:
    if len(payload) < 2:
        raise ConnectionError("STATS frame too short")
    return payload[1], payload[2:]


def encode_bulk(rid_base: int, term_sets: list, threshold: Optional[float],
                top_k: int = 0) -> bytes:
    """One frame carrying a whole bulk query set; the server replies with
    one RESULT per query at ``rid_base + i``. Frames are bounded by
    MAX_FRAME — a client with more queries than fit splits into several
    BULK frames (each is an independent job)."""
    th = float("nan") if threshold is None else float(threshold)
    out = [_BULK.pack(MSG_BULK, rid_base, th, int(top_k), len(term_sets))]
    for t in term_sets:
        t = np.ascontiguousarray(t, dtype="<u4")
        out.append(_BULK_Q.pack(t.shape[0]) + t.tobytes())
    return b"".join(out)


def decode_bulk(payload: bytes
                ) -> tuple[int, list, Optional[float], int]:
    (_, rid_base, th, top_k, n_queries) = _BULK.unpack_from(payload)
    off = _BULK.size
    term_sets = []
    for i in range(n_queries):
        if off + _BULK_Q.size > len(payload):
            raise ConnectionError(f"BULK frame truncated at query {i}")
        (nt,) = _BULK_Q.unpack_from(payload, off)
        off += _BULK_Q.size
        nb = nt * 8
        if off + nb > len(payload):
            raise ConnectionError(f"BULK frame truncated at query {i}")
        terms = np.frombuffer(payload, dtype="<u4", count=nt * 2,
                              offset=off).reshape(nt, 2)
        term_sets.append(terms.astype(np.uint32))
        off += nb
    if off != len(payload):
        raise ConnectionError("BULK frame has trailing bytes")
    return rid_base, term_sets, None if math.isnan(th) else th, top_k


# -- v4 worker data plane ------------------------------------------------------

def encode_shard_query(rid: int, gshard: int, buf: np.ndarray,
                       n_valid: np.ndarray, cutoffs: np.ndarray,
                       topks: np.ndarray, n_live: int) -> bytes:
    """One shard dispatch of one micro-batch: the exact arrays
    Frontend.score_batch hands a local ShardWorker, so the remote path
    scores bit-identically to the in-process one."""
    q_pad, bucket, _ = buf.shape
    return b"".join((
        _SHARD_QUERY.pack(MSG_SHARD_QUERY, rid, gshard, q_pad, bucket,
                          int(n_live)),
        np.ascontiguousarray(n_valid, dtype="<i4").tobytes(),
        np.ascontiguousarray(cutoffs, dtype="<i4").tobytes(),
        np.ascontiguousarray(topks, dtype="<i4").tobytes(),
        np.ascontiguousarray(buf, dtype="<u4").tobytes(),
    ))


def decode_shard_query(payload: bytes
                       ) -> tuple[int, int, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray, int]:
    (_, rid, gshard, q_pad, bucket, n_live) = _SHARD_QUERY.unpack_from(
        payload)
    off = _SHARD_QUERY.size
    want = off + 3 * 4 * q_pad + 8 * q_pad * bucket
    if len(payload) != want:
        raise ConnectionError(
            f"SHARD_QUERY rid={rid}: {len(payload)} bytes != {want}")

    def i32(n):
        nonlocal off
        a = np.frombuffer(payload, dtype="<i4", count=n, offset=off)
        off += 4 * n
        return a.astype(np.int32)

    n_valid, cutoffs, topks = i32(q_pad), i32(q_pad), i32(q_pad)
    buf = np.frombuffer(payload, dtype="<u4", count=q_pad * bucket * 2,
                        offset=off).reshape(q_pad, bucket, 2)
    return (rid, gshard, buf.astype(np.uint32), n_valid, cutoffs, topks,
            n_live)


def encode_shard_result(rid: int, status: int, method: str,
                        cands: Optional[list] = None,
                        prune: tuple = (0, 0, 0, 0, 0)) -> bytes:
    """status SHARD_OK carries per-query candidate (doc, score) arrays
    plus this dispatch's PruneStats delta; on SHARD_FAILED the method
    field carries the error text instead."""
    m = method.encode()[:255]
    out = [_SHARD_RESULT.pack(MSG_SHARD_RESULT, rid, status, len(m)), m,
           _SHARD_PRUNE.pack(*(int(x) for x in prune)),
           _SHARD_NQ.pack(len(cands or []))]
    for docs, scores in (cands or []):
        docs = np.ascontiguousarray(docs, dtype="<i4")
        out.append(_SHARD_NQ.pack(docs.shape[0]) + docs.tobytes()
                   + np.ascontiguousarray(scores, dtype="<i4").tobytes())
    return b"".join(out)


def decode_shard_result(payload: bytes
                        ) -> tuple[int, int, str, list, tuple]:
    (_, rid, status, mlen) = _SHARD_RESULT.unpack_from(payload)
    off = _SHARD_RESULT.size
    method = payload[off: off + mlen].decode()
    off += mlen
    prune = _SHARD_PRUNE.unpack_from(payload, off)
    off += _SHARD_PRUNE.size
    (n_queries,) = _SHARD_NQ.unpack_from(payload, off)
    off += _SHARD_NQ.size
    cands = []
    for i in range(n_queries):
        if off + _SHARD_NQ.size > len(payload):
            raise ConnectionError(f"SHARD_RESULT truncated at query {i}")
        (n,) = _SHARD_NQ.unpack_from(payload, off)
        off += _SHARD_NQ.size
        if off + 8 * n > len(payload):
            raise ConnectionError(f"SHARD_RESULT truncated at query {i}")
        docs = np.frombuffer(payload, dtype="<i4", count=n,
                             offset=off).astype(np.int32)
        scores = np.frombuffer(payload, dtype="<i4", count=n,
                               offset=off + 4 * n).astype(np.int32)
        cands.append((docs, scores))
        off += 8 * n
    if off != len(payload):
        raise ConnectionError("SHARD_RESULT frame has trailing bytes")
    return rid, status, method, cands, prune


def encode_cancel(rid: int) -> bytes:
    return _RID_ONLY.pack(MSG_CANCEL, rid)


def encode_ping(nonce: int, *, pong: bool = False) -> bytes:
    return _RID_ONLY.pack(MSG_PONG if pong else MSG_PING, nonce)


def decode_rid(payload: bytes) -> int:
    """rid of a CANCEL / nonce of a PING or PONG."""
    return _RID_ONLY.unpack_from(payload)[1]


# -- server -------------------------------------------------------------------

def _backend_info(backend) -> tuple[IndexParams, int]:
    """(index params, n_docs) of any serving backend."""
    index = getattr(backend, "index", None)
    if index is not None:
        return index.params, index.n_docs
    # Frontend / RpcFrontend expose params + n_docs directly (an
    # RpcFrontend has no local workers at all — they live behind RPC)
    params = getattr(backend, "params", None)
    if params is not None:
        return params, backend.n_docs
    worker = next(iter(backend.workers.values()))
    return worker.params, backend.n_docs


# Per-connection reply backlog (frames) before a client that stopped
# reading is kicked. Bounded so a stalled session can never hold memory
# or threads hostage.
OUTBOX_FRAMES = 1024


class _Session:
    """One accepted connection: the socket plus a bounded reply outbox
    drained by a dedicated writer thread. Loop threads enqueue replies
    and NEVER touch the socket — a client that stops reading fills its
    own outbox and gets kicked, instead of wedging a scoring worker in a
    blocking sendall and stalling every other client."""

    def __init__(self, sock: socket.socket,
                 on_drop: Optional[Callable[[int], None]] = None):
        self.sock = sock
        self.outbox: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=OUTBOX_FRAMES)
        self.dropped_replies = 0
        self._on_drop = on_drop
        self.writer = threading.Thread(target=self._write_loop,
                                       name="serve-write", daemon=True)
        self.writer.start()

    def _drop(self, n: int = 1) -> None:
        """Account an undelivered reply — a drop is NEVER silent: it is
        counted here and surfaced through the server's metrics."""
        self.dropped_replies += n
        if self._on_drop is not None:
            try:
                self._on_drop(n)
            except Exception:
                pass

    def send(self, payload: bytes) -> None:
        try:
            self.outbox.put_nowait(payload)
        except queue.Full:
            self._drop()
            self.kick()                       # slow reader: drop the session

    def _write_loop(self) -> None:
        dead = False
        while True:
            p = self.outbox.get()
            if p is None:
                return
            if dead:
                self._drop()                  # drain, counting every loss
                continue
            try:
                write_frame(self.sock, p)
            except OSError:
                dead = True                   # client went away
                self._drop()

    def kick(self) -> None:
        """Force both directions down (unblocks reader AND writer)."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def finish(self, timeout_s: float = 5.0) -> None:
        """Flush queued replies, stop the writer, close the socket.

        Drain-aware: wait (bounded by the deadline) for the writer to
        empty the outbox BEFORE enqueueing the shutdown sentinel — the
        old code put() the sentinel with a timeout, so a full outbox at
        close silently orphaned every queued reply. A peer that stalls
        past the deadline is kicked and the writer's counting drain
        accounts each undelivered frame in ``dropped_replies``. The writer
        is joined once more after the final kick, so it has stopped, and
        every drop is counted, when ``finish`` returns."""
        deadline = time.monotonic() + timeout_s
        while not self.outbox.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        try:
            self.outbox.put(
                None, timeout=max(0.01, deadline - time.monotonic()))
        except queue.Full:
            # writer wedged on a stalled peer: sever the socket so the
            # write loop falls into its counting drain, then sentinel
            self.kick()
            try:
                self.outbox.put(None, timeout=timeout_s)
            except queue.Full:
                pass
        self.writer.join(timeout=timeout_s)
        self.kick()
        # a writer wedged in sendall wakes only at this kick: wait for its
        # counting drain (bounded) before the socket closes under it
        self.writer.join(timeout=timeout_s)
        self.sock.close()


class NetServer:
    """TCP front door over a ServingLoop.

    One accept thread plus one reader thread per connection; responses
    are enqueued by the loop's completion callbacks into the session's
    bounded outbox and written by the session's writer thread, so a
    session is fully pipelined — the reader never waits for scoring, and
    the scorer never waits for any client's socket."""

    def __init__(self, loop: ServingLoop, *, host: str = "127.0.0.1",
                 port: int = 0, backlog: int = 128,
                 proto_version: int = PROTO_VERSION):
        if not MIN_PROTO_VERSION <= proto_version <= PROTO_VERSION:
            raise ValueError(f"proto_version {proto_version} unsupported")
        self.loop = loop
        # pinned to 1 the server speaks the old protocol bit-for-bit
        # (no trace fields, no STATS) — the interop escape hatch
        self.proto_version = proto_version
        self.params, self.n_docs = _backend_info(loop.backend)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(backlog)
        self.address: tuple[str, int] = self._listener.getsockname()
        self._conns: set[_Session] = set()
        self._conns_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = False

    @property
    def metrics(self):
        return self.loop.backend.metrics

    def _record_drop(self, n: int) -> None:
        rec = getattr(self.metrics, "record_reply_dropped", None)
        if rec is not None:
            rec(n)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "NetServer":
        if not self.loop.running:
            self.loop.start()
        self._accept_thread = threading.Thread(
            target=self._accept, name="serve-accept", daemon=True)
        self._accept_thread.start()
        return self

    def close(self, *, drain: bool = True, stop_loop: bool = True) -> None:
        """Graceful shutdown: stop accepting, drain the loop (every
        queued request scored and its response enqueued), flush each
        session's outbox, then close the sockets — clients receive all
        their answers, then EOF."""
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if stop_loop:
            self.loop.stop(drain=drain)
        with self._conns_lock:
            sessions, self._conns = list(self._conns), set()
        for s in sessions:
            s.finish()

    # -- connection handling -------------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                        # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._closing:
                    conn.close()
                    continue
                session = _Session(conn, on_drop=self._record_drop)
                self._conns.add(session)
            threading.Thread(target=self._serve_conn, args=(session,),
                             name="serve-conn", daemon=True).start()

    def _stats_body(self, fmt: int) -> bytes:
        if fmt == STATS_PROMETHEUS:
            return render_prometheus(self.metrics.registry).encode()
        snap = self.loop.metrics_snapshot()
        return json.dumps(dataclasses.asdict(snap)).encode()

    def _handle_bulk(self, session: _Session, payload: bytes) -> None:
        """BULK frame: hand the set to the attached bulk lane; the job's
        completion callback writes one RESULT per query at rid_base + i.
        No lane (or a lane refusing the job) answers REJECTED — the same
        429-style contract as interactive backpressure."""
        rid_base, term_sets, th, top_k = decode_bulk(payload)
        lane = getattr(self.loop, "bulk_lane", None)

        def reject_all() -> None:
            for i in range(len(term_sets)):
                session.send(encode_result(
                    rid_base + i, QueryResponse(-1, Status.REJECTED)))

        if lane is None:
            reject_all()
            return

        def on_done(job, rid_base=rid_base) -> None:
            if job.results is None:           # failed / cancelled sweep
                for i in range(job.n_queries):
                    session.send(encode_result(
                        rid_base + i,
                        QueryResponse(-1, Status.FAILED)))
                return
            wait_s = max(0.0, job.started_at - job.submitted_at)
            service_s = max(0.0, job.finished_at - job.started_at)
            for i, res in enumerate(job.results):
                session.send(encode_result(
                    rid_base + i,
                    QueryResponse(rid_base + i, Status.OK, result=res,
                                  method="bulk", batch_size=job.n_queries,
                                  wait_s=wait_s, service_s=service_s)))

        try:
            lane.submit(term_sets=term_sets, threshold=th, top_k=top_k,
                        tag=f"net:{rid_base}", on_done=on_done)
        except (ValueError, RuntimeError):
            reject_all()

    def _serve_conn(self, session: _Session) -> None:
        conn = session.sock
        self.metrics.record_connection(+1)
        v2 = self.proto_version >= 2
        v3 = self.proto_version >= 3
        owned = True                          # close() may take ownership
        try:
            session.send(encode_hello(self.params, self.n_docs,
                                      self.proto_version))
            while True:
                payload = read_frame(conn)
                if payload is None:
                    return                    # client closed its session
                if v2 and payload and payload[0] == MSG_STATS:
                    fmt, _ = decode_stats(payload)
                    session.send(encode_stats(fmt, self._stats_body(fmt)))
                    continue
                if v3 and payload and payload[0] == MSG_BULK:
                    self._handle_bulk(session, payload)
                    continue
                if not payload or payload[0] != MSG_QUERY:
                    raise ConnectionError(
                        f"unexpected message "
                        f"{payload[:1].hex() or 'empty'}")
                rid, terms, th, top_k, dl, tid = decode_query(payload)
                deadline = (None if dl is None
                            else self.loop.clock() + dl)
                # the trace block goes back only when the CLIENT asked
                # for tracing (nonzero trace id) on a v2 session
                tid = tid if v2 else 0

                def on_done(resp: QueryResponse, rid=rid,
                            tid=tid) -> None:
                    session.send(encode_result(rid, resp, trace_id=tid))

                try:
                    self.loop.submit(terms=terms, threshold=th,
                                     top_k=top_k or None,
                                     deadline=deadline, trace_id=tid,
                                     on_done=on_done)
                except LoopClosed:
                    # shutting down: 429-style refusal, session stays up
                    # until the client closes or the server finishes
                    session.send(encode_result(
                        rid, QueryResponse(-1, Status.REJECTED)))
        except (ConnectionError, OSError, struct.error):
            pass                      # torn/malformed session: drop it
        finally:
            self.metrics.record_connection(-1)
            with self._conns_lock:
                owned = session in self._conns
                self._conns.discard(session)
            if owned:
                # flush replies already enqueued (e.g. for requests still
                # in flight when the client half-closed), then close
                session.finish()


# -- client -------------------------------------------------------------------

@dataclasses.dataclass
class NetResult:
    """One wire response: status + the reconstructed SearchResult (None
    unless status == OK) plus the server-side timing split. On a traced
    v2 session ``trace_id`` echoes the id this client minted for the
    query and ``stages`` is the server-side per-stage breakdown (name ->
    total seconds) — joinable against the server's slow-query log."""
    status: Status
    result: Optional[SearchResult]
    method: str = ""
    batch_size: int = 0
    wait_s: float = 0.0
    service_s: float = 0.0
    trace_id: int = 0
    stages: Optional[dict] = None


# Client-minted trace ids: unique per process (counter) and salted with
# the pid so two client processes against one server rarely collide.
_TRACE_COUNTER = itertools.count(1)


def _mint_trace_id() -> int:
    return ((os.getpid() & 0xFFFF) << 40) | next(_TRACE_COUNTER)


class NetClient:
    """Pipelined client session.

    ``submit`` returns a Future resolved by the reader thread when the
    matching RESULT frame arrives; ``search``/``top_k`` are the blocking
    conveniences. Patterns compile client-side with the index parameters
    announced in the server's HELLO, so the wire only ever carries packed
    terms. Thread-safe: many threads may submit on one session."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0,
                 trace: bool = True):
        self.timeout_s = timeout_s
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = read_frame(self._sock)
        if hello is None or hello[0] != MSG_HELLO:
            raise ConnectionError("no HELLO from server")
        self.params, self.n_docs, self.proto_version = decode_hello(hello)
        if not MIN_PROTO_VERSION <= self.proto_version <= PROTO_VERSION:
            raise ConnectionError(
                f"protocol version {self.proto_version} outside "
                f"[{MIN_PROTO_VERSION}, {PROTO_VERSION}]")
        # trace ids ride on queries only when the server can take them
        self.trace = bool(trace) and self.proto_version >= 2
        self._sock.settimeout(None)           # reader blocks until frames
        self._wlock = threading.Lock()
        self._flock = threading.Lock()
        self._futs: dict[int, Future] = {}
        self._stats_futs: "queue.SimpleQueue[Future]" = queue.SimpleQueue()
        self._next_rid = 0
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="netclient-read", daemon=True)
        self._reader.start()

    # -- submission ----------------------------------------------------------
    def submit(self, pattern=None, *, terms: Optional[np.ndarray] = None,
               threshold: Optional[float] = None,
               top_k: Optional[int] = None,
               deadline_s: Optional[float] = None) -> "Future[NetResult]":
        """Send one query; deadline_s is RELATIVE (server rebases it)."""
        if (pattern is None) == (terms is None):
            raise ValueError("pass exactly one of pattern / terms")
        if terms is None:
            terms = compile_pattern(pattern, self.params)
        fut: Future = Future()
        with self._flock:
            if self._closed:
                raise ConnectionError("client is closed")
            rid = self._next_rid
            self._next_rid += 1
            self._futs[rid] = fut
        tid = _mint_trace_id() if self.trace else 0
        payload = encode_query(rid, terms, threshold, int(top_k or 0),
                               deadline_s, trace_id=tid)
        try:
            with self._wlock:
                write_frame(self._sock, payload)
        except OSError as e:
            with self._flock:
                self._futs.pop(rid, None)
            raise ConnectionError(f"send failed: {e}") from e
        return fut

    def search(self, pattern=None, *, terms: Optional[np.ndarray] = None,
               threshold: Optional[float] = None,
               deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None) -> NetResult:
        return self.submit(pattern, terms=terms, threshold=threshold,
                           deadline_s=deadline_s).result(
                               timeout_s or self.timeout_s)

    def top_k(self, pattern=None, *, terms: Optional[np.ndarray] = None,
              k: int = 10, deadline_s: Optional[float] = None,
              timeout_s: Optional[float] = None) -> NetResult:
        return self.submit(pattern, terms=terms, top_k=k,
                           deadline_s=deadline_s).result(
                               timeout_s or self.timeout_s)

    # -- bulk lane ----------------------------------------------------------
    def submit_bulk(self, patterns=None, *, term_sets=None,
                    threshold: Optional[float] = None,
                    top_k: int = 0) -> "list[Future[NetResult]]":
        """Send a whole query set as one BULK frame (protocol >= 3); the
        server sweeps it through its offline bulk lane in interactive
        idle time. Returns one Future per query, in submission order —
        all resolve together when the sweep completes."""
        if self.proto_version < 3:
            raise ConnectionError("BULK requires protocol >= 3")
        if (patterns is None) == (term_sets is None):
            raise ValueError("pass exactly one of patterns / term_sets")
        if term_sets is None:
            term_sets = [compile_pattern(p, self.params) for p in patterns]
        futs: list[Future] = []
        with self._flock:
            if self._closed:
                raise ConnectionError("client is closed")
            rid_base = self._next_rid
            self._next_rid += len(term_sets)
            for i in range(len(term_sets)):
                fut: Future = Future()
                self._futs[rid_base + i] = fut
                futs.append(fut)
        payload = encode_bulk(rid_base, term_sets, threshold, top_k)
        try:
            with self._wlock:
                write_frame(self._sock, payload)
        except OSError as e:
            with self._flock:
                for i in range(len(term_sets)):
                    self._futs.pop(rid_base + i, None)
            raise ConnectionError(f"send failed: {e}") from e
        return futs

    def bulk(self, patterns=None, *, term_sets=None,
             threshold: Optional[float] = None, top_k: int = 0,
             timeout_s: Optional[float] = None) -> list[NetResult]:
        """Blocking bulk sweep: one result per query, submission order.
        Bulk jobs wait for interactive idle time, so pass a generous
        timeout for a loaded server."""
        futs = self.submit_bulk(patterns, term_sets=term_sets,
                                threshold=threshold, top_k=top_k)
        t = timeout_s or self.timeout_s
        return [f.result(t) for f in futs]

    # -- observability -------------------------------------------------------
    def stats(self, *, prometheus: bool = False,
              timeout_s: Optional[float] = None):
        """Server metrics over the wire (v2 sessions only): the parsed
        JSON MetricsSnapshot dict, or the raw Prometheus text exposition
        when ``prometheus=True``. STATS replies come back in request
        order on this session (the server answers them inline)."""
        if self.proto_version < 2:
            raise ConnectionError("STATS requires protocol >= 2")
        fut: Future = Future()
        with self._flock:
            if self._closed:
                raise ConnectionError("client is closed")
            self._stats_futs.put(fut)
        fmt = STATS_PROMETHEUS if prometheus else STATS_SNAPSHOT
        try:
            with self._wlock:
                write_frame(self._sock, encode_stats(fmt))
        except OSError as e:
            raise ConnectionError(f"send failed: {e}") from e
        body = fut.result(timeout_s or self.timeout_s)
        return body.decode() if prometheus else json.loads(body)

    # -- reader --------------------------------------------------------------
    def _read_loop(self) -> None:
        err: Optional[Exception] = None
        try:
            while True:
                payload = read_frame(self._sock)
                if payload is None:
                    break
                if payload and payload[0] == MSG_STATS:
                    _, body = decode_stats(payload)
                    try:
                        sfut = self._stats_futs.get_nowait()
                    except queue.Empty:
                        raise ConnectionError("unsolicited STATS reply")
                    sfut.set_result(body)
                    continue
                if not payload or payload[0] != MSG_RESULT:
                    raise ConnectionError(
                        f"unexpected message "
                        f"{payload[:1].hex() or 'empty'}")
                rid, res = decode_result(payload)
                with self._flock:
                    fut = self._futs.pop(rid, None)
                if fut is not None:
                    fut.set_result(res)
        except Exception as e:
            # broad on purpose: ANY reader death (torn socket, malformed
            # frame, decode error like an unknown status byte) must reach
            # the sweep below, or in-flight futures hang until their
            # callers' timeouts
            err = e
        with self._flock:
            # mark the session dead BEFORE sweeping, so a submit racing
            # this sweep either registers early enough to be swept here
            # or sees _closed and raises — never a forever-pending Future
            self._closed = True
            futs, self._futs = list(self._futs.values()), {}
        while True:
            try:
                futs.append(self._stats_futs.get_nowait())
            except queue.Empty:
                break
        for fut in futs:
            fut.set_exception(err or ConnectionError("session closed"))

    def close(self) -> None:
        with self._flock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_WR)   # polite half-close
        except OSError:
            pass
        self._reader.join(timeout=self.timeout_s)
        self._sock.close()

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
