"""The port's serving loop and network front door against the JAX package,
on the CPU.

Every wire constant and codec of ``repro_torch.serve.net`` must be the JAX
module's: the port's bytes equal JAX's for each message (HELLO, QUERY with
and without a trace id, RESULT with and without a trace block, STATS,
BULK, the v4 SHARD_QUERY, SHARD_RESULT, CANCEL, PING and PONG), and each
package decodes the other's bytes to the same fields. Live: concurrent
torch clients against a torch ``NetServer`` over the port's
``QueryServer``, a JAX client against a torch server and a torch client
against a JAX server, a server pinned to protocol 1 and raw v1 frames, all
equal to the JAX ``QueryEngine``; STATS and traces; REJECTED under
backpressure, DROPPED at a deadline, graceful drain; the loop's failure
paths beside the JAX loop's. The store is written by the JAX streaming
builder and opened by the port on the CPU.

No test waits on the wall clock for an outcome: the port's servers run on
a manual clock that only the test advances, and every socket, join and
future has a timeout. The session tests hold ``_Session.finish`` to its
contract: a slow reader gets every frame, and with a wedged reader the
writer has stopped when ``finish`` returns and received + dropped equals
sent (five runs). Every comparison of results is exact.
"""
import dataclasses
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core.query import SearchResult as JaxResult
from repro.data import make_corpus, make_queries
from repro.index import ShardPlacement as JaxPlacement
from repro.index import build_compact_streaming as jax_streaming
from repro.serve import Frontend as JaxFrontend
from repro.serve import FrontendConfig as JaxFrontendConfig
from repro.serve import NetClient as JaxClient
from repro.serve import NetServer as JaxNetServer
from repro.serve import QueryServer as JaxServer
from repro.serve import ServerConfig as JaxConfig
from repro.serve import ServingLoop as JaxLoop
from repro.serve import ShardWorker as JaxWorker
from repro.serve import net as jnet
from repro.serve.request import QueryResponse as JaxResponse
from repro.serve.request import Status as JaxStatus

from repro_torch.core import IndexParams, load_index_v2
from repro_torch.index import ShardPlacement
from repro_torch.core.query import SearchResult, compile_pattern
from repro_torch.obs.export import parse_prometheus
from repro_torch.serve import (Frontend, FrontendConfig, LoopClosed,
                               MetricsSnapshot, NetClient, NetServer,
                               QueryServer, ServerConfig, ServingLoop,
                               ShardWorker, Status)
from repro_torch.serve import net as tnet
from repro_torch.serve.request import QueryResponse

torch.set_num_threads(2)

CPU = "cpu"
JPARAMS = JaxParams(n_hashes=1, fpr=0.3, kmer=15)
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus, the JAX index of a three-shard store and the port's
    index over the same files, and the JAX engine that is the oracle."""
    c = make_corpus(96, k=15, mean_length=400, sigma=1.0, seed=11)
    store = tmp_path_factory.mktemp("net") / "v2"
    jidx, _ = jax_streaming(c.doc_terms, store, JPARAMS, block_docs=32,
                            row_align=64)
    tidx = load_index_v2(store, device=CPU)
    assert tidx.storage.n_shards >= 3
    return c, jidx, tidx, JaxEngine(jidx)


class Clock:
    """A server clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _torch_serve(tidx, clock=None, **cfg):
    """(server, NetServer) over the port's QueryServer on a manual clock,
    bound to an ephemeral localhost port."""
    cfg.setdefault("max_wait_s", 0.0)
    server = QueryServer(tidx, ServerConfig(**cfg), clock=clock or Clock(),
                         device=CPU)
    return server, NetServer(ServingLoop(server)).start()


def _close(net, **kw) -> None:
    """``net.close(**kw)`` without its wait for the accept thread: closing
    the listener does not wake an ``accept`` blocked on it, so ``close``
    waits out its 5 s join. Shutting the listener down first wakes it."""
    net._listener.shutdown(socket.SHUT_RDWR)
    net.close(**kw)


def _queries(c, n_pos, n_neg, length, seed):
    return make_queries(c, n_pos=n_pos, n_neg=n_neg, length=length,
                        seed=seed)[0]


def _assert_identical(got, want):
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.n_terms == want.n_terms
    assert got.threshold == want.threshold


def _wait_for(cond, what: str, timeout: float = TIMEOUT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


# --------------------------------------------------------------------------
# The protocol's constants and codecs, byte for byte
# --------------------------------------------------------------------------

CONSTANTS = ["PROTO_VERSION", "MIN_PROTO_VERSION", "MSG_HELLO", "MSG_QUERY",
             "MSG_RESULT", "MSG_STATS", "MSG_BULK", "MSG_SHARD_QUERY",
             "MSG_SHARD_RESULT", "MSG_CANCEL", "MSG_PING", "MSG_PONG",
             "STATS_SNAPSHOT", "STATS_PROMETHEUS", "SHARD_OK",
             "SHARD_CANCELLED", "SHARD_FAILED", "MAX_FRAME",
             "OUTBOX_FRAMES"]
STRUCTS = ["_LEN", "_HELLO", "_QUERY", "_RESULT", "_BULK", "_BULK_Q",
           "_TRACE_ID", "_TRACE_HEAD", "_STAGE_SECONDS", "_SHARD_QUERY",
           "_SHARD_RESULT", "_SHARD_PRUNE", "_SHARD_NQ", "_RID_ONLY"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_protocol_constant_equal(name):
    assert getattr(tnet, name) == getattr(jnet, name)


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_layout_equal(name):
    t, j = getattr(tnet, name), getattr(jnet, name)
    assert isinstance(t, struct.Struct)
    assert (t.format, t.size) == (j.format, j.size)


def test_status_codes_in_protocol_order():
    assert [s.value for s in tnet._STATUS_CODES] == \
        [s.value for s in jnet._STATUS_CODES]
    assert [s.value for s in tnet._STATUS_CODES] == \
        ["ok", "rejected", "dropped_deadline", "failed"]


_RNG = np.random.default_rng(23)
_TERMS = _RNG.integers(0, 2 ** 32, size=(5, 2), dtype=np.uint32)
_SETS = [_RNG.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
         for n in (3, 1, 7, 0)]
_BUF = _RNG.integers(0, 2 ** 32, size=(4, 8, 2), dtype=np.uint32)
_STAGES = {"queue_wait": 0.001, "kernel_score": 0.25, "select": 0.002}
_CANDS = [(np.array([5, 2, 9], np.int32), np.array([7, 6, 6], np.int32)),
          (np.zeros(0, np.int32), np.zeros(0, np.int32))]


def _response(pkg, status, *, hits=True, trace_id=0, stages=None):
    """A response of ``pkg`` ('jax' or 'torch') in that package's types."""
    Res, Resp, St = ((JaxResult, JaxResponse, JaxStatus) if pkg == "jax"
                     else (SearchResult, QueryResponse, Status))
    res = (Res(np.array([5, 2, 9], np.int32), np.array([7, 6, 6], np.int32),
               8, 6) if hits else None)
    return Resp(0, St(status), res, method="lookup", batch_size=4,
                wait_s=0.25, service_s=0.125, trace_id=trace_id,
                stages=stages)


# message -> (encoder over (package's net module, package name))
CODECS = {
    "hello": lambda m, p: m.encode_hello(
        (JaxParams if p == "jax" else IndexParams)(
            n_hashes=3, fpr=0.125, kmer=31, canonical=True), 96, 4),
    "hello_v1": lambda m, p: m.encode_hello(
        (JaxParams if p == "jax" else IndexParams)(), 7, 1),
    "query": lambda m, p: m.encode_query(42, _TERMS, 0.75, 7, 1.5),
    "query_defaults": lambda m, p: m.encode_query(0, _TERMS, None, 0, None),
    "query_trace": lambda m, p: m.encode_query(7, _TERMS, 0.5, 0, None,
                                               trace_id=0xBEEF00012345),
    "result": lambda m, p: m.encode_result(3, _response(p, "ok")),
    "result_trace": lambda m, p: m.encode_result(
        5, _response(p, "ok", trace_id=77, stages=_STAGES), trace_id=77),
    "result_rejected": lambda m, p: m.encode_result(
        9, _response(p, "rejected", hits=False)),
    "result_dropped_trace": lambda m, p: m.encode_result(
        6, _response(p, "dropped_deadline", hits=False, trace_id=9,
                     stages={"queue_wait": 0.5}), trace_id=9),
    "result_failed": lambda m, p: m.encode_result(
        1, _response(p, "failed", hits=False)),
    "stats_request": lambda m, p: m.encode_stats(m.STATS_PROMETHEUS),
    "stats_reply": lambda m, p: m.encode_stats(
        m.STATS_SNAPSHOT, json.dumps({"served": 3}).encode()),
    "bulk": lambda m, p: m.encode_bulk(41, _SETS, 0.75, 0),
    "bulk_top_k": lambda m, p: m.encode_bulk(0, _SETS, None, 5),
    "shard_query": lambda m, p: m.encode_shard_query(
        11, 2, _BUF, np.array([8, 3, 0, 0], np.int32),
        np.array([7, 2, 0, 0], np.int32), np.array([0, 0, 4, 0], np.int32),
        3),
    "shard_result": lambda m, p: m.encode_shard_result(
        12, m.SHARD_OK, "lookup", _CANDS, (10, 4, 1, 4096, 8192)),
    "shard_result_failed": lambda m, p: m.encode_shard_result(
        13, m.SHARD_FAILED, "RuntimeError: boom"),
    "cancel": lambda m, p: m.encode_cancel(2 ** 63 + 5),
    "ping": lambda m, p: m.encode_ping(99),
    "pong": lambda m, p: m.encode_ping(99, pong=True),
}


def _plain(x):
    """Decoded fields as plain Python values, comparable across packages."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "value") and isinstance(x.value, str):   # Status
        return x.value
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def _decode(m, name, payload):
    kind = name.split("_")[0]
    if name.startswith("shard_query"):
        return m.decode_shard_query(payload)
    if name.startswith("shard_result"):
        return m.decode_shard_result(payload)
    if kind in ("cancel", "ping", "pong"):
        return (payload[0], m.decode_rid(payload))
    return getattr(m, f"decode_{kind}")(payload)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_bytes_equal_and_cross_decode(name):
    jbytes, tbytes = CODECS[name](jnet, "jax"), CODECS[name](tnet, "torch")
    assert tbytes == jbytes
    want = _plain(_decode(jnet, name, jbytes))
    assert _plain(_decode(tnet, name, jbytes)) == want    # torch reads JAX
    assert _plain(_decode(jnet, name, tbytes)) == want    # JAX reads torch


def test_truncated_frames_raise_alike():
    for m in (jnet, tnet):
        with pytest.raises(ConnectionError):
            m.decode_bulk(m.encode_bulk(0, _SETS, None, 5)[:-3])
        with pytest.raises(ConnectionError):
            m.decode_query(m.encode_query(1, _TERMS, 0.5, 0, None)[:-1])
        with pytest.raises(ConnectionError):
            m.decode_shard_result(m.encode_shard_result(
                1, m.SHARD_OK, "x", _CANDS)[:-2])
        with pytest.raises(ConnectionError):
            m.decode_stats(bytes([m.MSG_STATS]))


# --------------------------------------------------------------------------
# Live: clients against servers, equal to the JAX QueryEngine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["threshold", "top_k"])
def test_concurrent_torch_clients_equal_jax_engine(world, mode):
    """Four torch clients pipeline queries (duplicates included) into one
    torch server; every answer equals the JAX engine's, and the loop
    coalesced them (fewer batches than requests)."""
    c, _, tidx, oracle = world
    server, net = _torch_serve(tidx, max_batch=8)
    n_clients, per_client = 4, 10
    failures: list[str] = []
    answered: list[int] = []

    def client(ci: int) -> None:
        rng = np.random.default_rng(300 + ci)
        qs = _queries(c, 3, 2, (40, 80, 160)[ci % 3], 400 + ci)
        try:
            with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
                assert cl.params == IndexParams(**JPARAMS.to_json())
                assert cl.n_docs == tidx.n_docs
                flight = []
                for _ in range(per_client):
                    q = qs[int(rng.integers(len(qs)))]
                    th = float(rng.choice([0.5, 0.8]))
                    k = int(rng.choice([1, 3]))
                    fut = (cl.submit(q, top_k=k) if mode == "top_k"
                           else cl.submit(q, threshold=th))
                    flight.append((q, th, k, fut))
                for q, th, k, fut in flight:
                    r = fut.result(TIMEOUT)
                    assert r.status == Status.OK
                    _assert_identical(r.result, oracle.top_k(q, k=k)
                                      if mode == "top_k"
                                      else oracle.search(q, threshold=th))
                    answered.append(1)
        except Exception as e:             # pragma: no cover - diagnostics
            failures.append(f"client {ci}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    _close(net)
    assert not failures, failures
    assert len(answered) == n_clients * per_client
    snap = server.metrics.snapshot()
    assert snap.served == n_clients * per_client
    assert snap.batches < snap.served
    assert snap.total_connections == n_clients
    _wait_for(lambda: server.metrics.connections == 0, "the gauge to drop")


def test_jax_client_against_torch_server(world):
    """A JAX NetClient reads a torch NetServer: HELLO, threshold and top-k
    results, a trace block and STATS, as from a JAX server."""
    c, _, tidx, oracle = world
    server, net = _torch_serve(tidx, max_batch=4)
    qs = _queries(c, 2, 1, 120, 5)
    try:
        with JaxClient(*net.address, timeout_s=TIMEOUT) as cl:
            assert cl.proto_version == tnet.PROTO_VERSION
            assert cl.params == JPARAMS and cl.n_docs == tidx.n_docs
            for q in qs:
                r = cl.search(q, threshold=0.6)
                assert r.status == JaxStatus.OK and r.trace_id != 0
                assert "kernel_score" in r.stages
                _assert_identical(r.result, oracle.search(q, threshold=0.6))
                _assert_identical(cl.top_k(q, k=5).result,
                                  oracle.top_k(q, k=5))
            assert cl.stats()["served"] >= len(qs)
            r = cl.search(np.zeros(3, np.uint8))      # shorter than k
            assert r.status == JaxStatus.OK and r.result.doc_ids.size == 0
    finally:
        _close(net)


def test_torch_client_against_jax_server(world):
    """A torch NetClient reads a JAX NetServer over the JAX QueryServer."""
    c, jidx, _, oracle = world
    jserver = JaxServer(jidx, JaxConfig(max_batch=4, max_wait_s=0.001))
    net = JaxNetServer(JaxLoop(jserver)).start()
    qs = _queries(c, 2, 1, 120, 6)
    try:
        with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
            assert cl.proto_version == jnet.PROTO_VERSION and cl.trace
            assert cl.params == IndexParams(**JPARAMS.to_json())
            futs = [cl.submit(q, threshold=0.8) for q in qs]
            futs += [cl.submit(q, top_k=4) for q in qs]
            for q, f in zip(qs, futs[: len(qs)]):
                r = f.result(TIMEOUT)
                assert r.status == Status.OK and r.stages
                _assert_identical(r.result, oracle.search(q, threshold=0.8))
                assert jserver.tracer.find(r.trace_id) is not None
            for q, f in zip(qs, futs[len(qs):]):
                _assert_identical(f.result(TIMEOUT).result,
                                  oracle.top_k(q, k=4))
            snap = cl.stats()
            assert snap["served"] >= 2 * len(qs)
            assert "serve_requests_total" in cl.stats(prometheus=True)
    finally:
        _close(net)


def test_net_server_over_frontends_equal_jax_pair(world, tmp_path):
    """A torch NetServer in front of a torch Frontend (3 hosts, replication
    2, the primary of shard 0 down) answers a torch client as a JAX
    NetServer in front of a JAX Frontend answers it: every result equal,
    and equal to the JAX engine's."""
    c, _, _, oracle = world
    store = tmp_path / "v2"
    jax_streaming(c.doc_terms, store, JPARAMS, block_docs=32, row_align=64)
    nets = []
    for P, W, F, C, L, N, kw in (
            (JaxPlacement, JaxWorker, JaxFrontend, JaxFrontendConfig,
             JaxLoop, JaxNetServer, {}),
            (ShardPlacement, ShardWorker, Frontend, FrontendConfig,
             ServingLoop, NetServer, {"device": CPU})):
        place = P.for_store(store, ["h0", "h1", "h2"], replication=2)
        held = place.replica_assignment()
        fe = F({n: W(n, store, held[n], **kw) for n in place.nodes
                if held[n]}, place, C(max_batch=4, max_wait_s=0.0))
        fe.fail_worker(place.owner(0))
        nets.append(N(L(fe)).start())
    qs = _queries(c, 3, 2, 120, 8)
    answers = []
    try:
        for net in nets:
            with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
                futs = [cl.submit(q, threshold=0.7) for q in qs]
                futs += [cl.submit(q, top_k=4) for q in qs]
                answers.append([f.result(TIMEOUT) for f in futs])
                assert cl.stats()["failovers"] > 0
    finally:
        for net in nets:
            _close(net)
    jax_res, torch_res = answers
    for g, w in zip(torch_res, jax_res):
        assert g.status == w.status == Status.OK
        assert g.method == w.method
        _assert_identical(g.result, w.result)
    for q, r in zip(qs, torch_res[:len(qs)]):
        _assert_identical(r.result, oracle.search(q, threshold=0.7))
    for q, r in zip(qs, torch_res[len(qs):]):
        _assert_identical(r.result, oracle.top_k(q, k=4))


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_v1_pinned_torch_server(world, client):
    """A torch server pinned to protocol 1: either client sees version 1,
    sends no trace id, gets plain v1 results and refuses STATS itself."""
    c, _, tidx, oracle = world
    server = QueryServer(tidx, ServerConfig(max_batch=4, max_wait_s=0.0),
                         clock=Clock(), device=CPU)
    net = NetServer(ServingLoop(server), proto_version=1).start()
    (q,) = _queries(c, 1, 0, 120, 43)
    Client = NetClient if client == "torch" else JaxClient
    try:
        with Client(*net.address, timeout_s=TIMEOUT) as cl:
            assert cl.proto_version == 1 and not cl.trace
            r = cl.search(q, threshold=0.8)
            assert r.status.value == "ok"
            assert r.trace_id == 0 and r.stages is None
            _assert_identical(r.result, oracle.search(q, threshold=0.8))
            with pytest.raises(ConnectionError):
                cl.stats()
            with pytest.raises(ConnectionError):
                cl.bulk([q], threshold=0.8)
    finally:
        _close(net)


def test_raw_v1_frames_against_torch_server(world):
    """Raw protocol-1 QUERY frames (no trailing trace id) against a v4
    torch server come back as plain v1 RESULT frames."""
    c, _, tidx, oracle = world
    _, net = _torch_serve(tidx, max_batch=4)
    (q,) = _queries(c, 1, 0, 120, 41)
    terms = compile_pattern(q, IndexParams(**JPARAMS.to_json()))
    try:
        sock = socket.create_connection(net.address, timeout=TIMEOUT)
        try:
            hello = jnet.read_frame(sock)
            assert hello[0] == jnet.MSG_HELLO
            assert jnet.decode_hello(hello)[2] == jnet.PROTO_VERSION
            frame = jnet._QUERY.pack(jnet.MSG_QUERY, 11, 0.8, 0, 0.0,
                                     terms.shape[0]) + \
                np.ascontiguousarray(terms, dtype="<u4").tobytes()
            jnet.write_frame(sock, frame)
            rid, res = jnet.decode_result(jnet.read_frame(sock))
            assert rid == 11 and res.status == JaxStatus.OK
            assert res.trace_id == 0 and res.stages is None
            _assert_identical(res.result, oracle.search(q, threshold=0.8))
        finally:
            sock.close()
    finally:
        _close(net)


def test_stats_and_trace_round_trip(world):
    """A traced query returns its client-minted id and a per-stage
    breakdown, the server's trace carries the same id, and STATS serves
    the snapshot (every field) and the Prometheus text."""
    c, _, tidx, oracle = world
    server, net = _torch_serve(tidx, max_batch=4)
    (q,) = _queries(c, 1, 0, 120, 47)
    try:
        with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
            r = cl.search(q, threshold=0.8)
            assert r.status == Status.OK and r.trace_id != 0
            assert r.stages and "kernel_score" in r.stages
            assert all(v >= 0 for v in r.stages.values())
            _assert_identical(r.result, oracle.search(q, threshold=0.8))
            trace = server.tracer.find(r.trace_id)
            assert trace is not None and trace.done
            assert "deliver" in [s.name for s in trace.spans()]
            snap = cl.stats()
            assert set(snap) == {f.name for f in
                                 dataclasses.fields(MetricsSnapshot)}
            assert snap["served"] == 1 and snap["connections"] == 1
            parsed = parse_prometheus(cl.stats(prometheus=True))
            assert parsed['serve_requests_total{status="ok"}'] == 1
    finally:
        _close(net)


# --------------------------------------------------------------------------
# Backpressure, deadlines, drain
# --------------------------------------------------------------------------

def test_backpressure_rejects_without_hang(world):
    """Past the queue cap the client gets REJECTED at once; the accepted
    requests wait (the wait timer never fires on the frozen clock) and
    are scored at close(drain=True)."""
    c, _, tidx, oracle = world
    cap = 4
    server, net = _torch_serve(tidx, max_batch=64, max_wait_s=60.0,
                               max_queued=cap, result_cache=0, row_cache=0)
    qs = _queries(c, 6, 2, 120, 13)
    cl = NetClient(*net.address, timeout_s=TIMEOUT)
    try:
        futs = [cl.submit(q, threshold=0.8) for q in qs[: cap + 3]]
        rejected = [f.result(TIMEOUT) for f in futs[cap:]]
        assert [r.status for r in rejected] == [Status.REJECTED] * 3
        assert all(r.result is None for r in rejected)
        assert not any(f.done() for f in futs[:cap])
        _close(net, drain=True)
        for q, f in zip(qs, futs[:cap]):
            r = f.result(TIMEOUT)
            assert r.status == Status.OK
            _assert_identical(r.result, oracle.search(q, threshold=0.8))
    finally:
        cl.close()
    snap = server.metrics.snapshot()
    assert snap.rejected == 3 and snap.served == cap


def test_deadline_dropped_at_flush(world):
    """A queued request whose deadline passes (the test moves the clock)
    is answered DROPPED at the next flush without being scored, even
    behind a head with no deadline, which is still scored at drain."""
    c, _, tidx, oracle = world
    clock = Clock()
    server, net = _torch_serve(tidx, clock=clock, max_batch=64,
                               max_wait_s=60.0, result_cache=0, row_cache=0)
    qs = _queries(c, 2, 0, 120, 17)
    cl = NetClient(*net.address, timeout_s=TIMEOUT)
    try:
        head = cl.submit(qs[0])
        late = cl.submit(qs[1], deadline_s=0.05)
        _wait_for(lambda: net.loop.pending() == 2, "both requests queued")
        assert not late.done()
        clock.t += 0.1
        net.loop._wake.set()
        r = late.result(TIMEOUT)
        assert r.status == Status.DROPPED and r.result is None
        assert r.wait_s == pytest.approx(0.1)
        assert not head.done()
        _close(net, drain=True)
        rh = head.result(TIMEOUT)
        assert rh.status == Status.OK
        _assert_identical(rh.result, oracle.search(qs[0]))
    finally:
        cl.close()
    snap = server.metrics.snapshot()
    assert snap.dropped == 1 and snap.served == 1


def test_graceful_drain_answers_every_request(world):
    c, _, tidx, oracle = world
    server, net = _torch_serve(tidx, max_batch=64, max_wait_s=60.0,
                               result_cache=0, row_cache=0)
    qs = _queries(c, 4, 2, 80, 19)
    cl = NetClient(*net.address, timeout_s=TIMEOUT)
    try:
        futs = [cl.submit(q, threshold=0.7) for q in qs]
        _wait_for(lambda: net.loop.pending() == len(qs), "all queued")
        assert server.metrics.snapshot().served == 0
        _close(net, drain=True)
        for q, f in zip(qs, futs):
            r = f.result(TIMEOUT)
            assert r.status == Status.OK
            _assert_identical(r.result, oracle.search(q, threshold=0.7))
    finally:
        cl.close()
    assert server.metrics.snapshot().served == len(qs)
    assert server.metrics.dropped_replies == 0


# --------------------------------------------------------------------------
# The loop's failure paths, beside the JAX loop's
# --------------------------------------------------------------------------

def _loops(world, **cfg):
    """A JAX and a torch ServingLoop over servers with the same config."""
    _, jidx, tidx, _ = world
    cfg = dict(dict(max_batch=64, max_wait_s=60.0, result_cache=0,
                    row_cache=0), **cfg)
    return (JaxLoop(JaxServer(jidx, JaxConfig(**cfg))),
            ServingLoop(QueryServer(tidx, ServerConfig(**cfg), clock=Clock(),
                                    device=CPU)))


def test_loop_rejects_after_stop(world):
    for loop in _loops(world):
        loop.start().stop()
        with pytest.raises(RuntimeError) as e:
            loop.submit(terms=np.ones((4, 2), np.uint32),
                        on_done=lambda r: None)
        assert type(e.value).__name__ == "LoopClosed"
    assert issubclass(LoopClosed, RuntimeError)


def test_loop_stop_without_drain_rejects_queued(world):
    """stop(drain=False) answers every queued request REJECTED, one
    callback each, in both packages."""
    terms = compile_pattern(np.full(60, 1, np.uint8),
                            IndexParams(**JPARAMS.to_json()))
    outcomes = []
    for loop in _loops(world):
        loop.start()
        got: dict = {}
        for i in range(3):
            loop.submit(terms=terms,
                        on_done=lambda r, i=i: got.setdefault(i, []).append(r))
        loop.stop(drain=False)
        assert not loop.running
        outcomes.append({i: [r.status.value for r in rs]
                         for i, rs in got.items()})
    assert outcomes[0] == outcomes[1] == {i: ["rejected"] for i in range(3)}


def test_loop_survives_scoring_failure(world):
    """A score_batch that raises answers its batch FAILED (counted) and
    the loop goes on serving, in both packages."""
    c, _, _, oracle = world
    (q1,) = _queries(c, 1, 0, 120, 31)
    (q2,) = _queries(c, 1, 0, 160, 33)
    statuses = []
    for loop in _loops(world, max_batch=4, max_wait_s=0.0):
        server = loop.backend
        real, armed = server.score_batch, [True]

        def flaky(batch, real=real, armed=armed):
            if armed.pop() if armed else False:
                raise RuntimeError("injected kernel failure")
            return real(batch)

        server.score_batch = flaky
        loop.start()
        got: dict = {}
        evs = {key: threading.Event() for key in "ab"}

        def cb(key, got=got, evs=evs):
            return lambda r: (got.__setitem__(key, r), evs[key].set())

        try:
            loop.submit(terms=compile_pattern(q1, server.index.params),
                        on_done=cb("a"))
            assert evs["a"].wait(TIMEOUT)
            loop.submit(terms=compile_pattern(q2, server.index.params),
                        threshold=0.8, on_done=cb("b"))
            assert evs["b"].wait(TIMEOUT)
        finally:
            loop.stop()
        assert server.metrics.failed == 1
        _assert_identical(got["b"].result, oracle.search(q2, threshold=0.8))
        statuses.append((got["a"].status.value, got["b"].status.value))
    assert statuses == [("failed", "ok")] * 2


def test_overload_still_serves_fast_paths(world):
    """Over the outstanding-work cap an uncached query is REJECTED, and a
    result-cache hit is still served."""
    c, _, tidx, _ = world
    server = QueryServer(tidx, ServerConfig(max_batch=64, max_wait_s=60.0,
                                            max_queued=2, row_cache=0),
                         clock=Clock(), device=CPU)
    (hot,) = _queries(c, 1, 0, 120, 37)
    rid = server.submit(hot, threshold=0.8)
    server.drain()
    want = server.pop_responses()[rid].result
    loop = ServingLoop(server).start()
    try:
        got: list = []
        fills = _queries(c, 2, 1, 160, 39)
        for q in fills[:2]:
            loop.submit(terms=compile_pattern(q, server.index.params),
                        on_done=lambda r: None)
        assert loop.pending() == 2
        loop.submit(terms=compile_pattern(fills[2], server.index.params),
                    on_done=got.append)
        assert got[-1].status == Status.REJECTED
        loop.submit(terms=compile_pattern(hot, server.index.params),
                    threshold=0.8, on_done=got.append)
        assert got[-1].status == Status.OK and got[-1].cached
        _assert_identical(got[-1].result, want)
    finally:
        loop.stop()


# --------------------------------------------------------------------------
# Sessions: delivered or counted, and the writer stopped when finish returns
# --------------------------------------------------------------------------

def _session_pair(on_drop=None):
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    return tnet._Session(a, on_drop=on_drop), b


def test_session_slow_reader_gets_every_frame():
    session, peer = _session_pair()
    n, got, errs = 40, [], []

    def reader():
        try:
            while True:
                frame = tnet.read_frame(peer)
                if frame is None:
                    return
                got.append(frame)
                time.sleep(0.002)             # slow, not stopped
        except Exception as e:                # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for i in range(n):
        session.send(bytes([i % 256]) * 4096)
    session.finish(timeout_s=TIMEOUT)
    t.join(TIMEOUT)
    assert not t.is_alive() and not errs
    assert not session.writer.is_alive()
    assert len(got) == n and got[-1] == bytes([39]) * 4096
    assert session.dropped_replies == 0
    peer.close()


@pytest.mark.parametrize("run", range(5))
def test_session_wedged_reader_writer_stopped(run):
    """A peer that stops reading wedges the writer in sendall. finish()
    kicks it and joins it again, so the writer has stopped when finish
    returns, and every reply is either received or counted dropped."""
    drops = []
    session, peer = _session_pair(on_drop=drops.append)
    n, payload = 120, b"x" * 65536            # far past the socket buffers
    for _ in range(n):
        session.send(payload)
    t0 = time.monotonic()
    session.finish(timeout_s=0.5)
    assert time.monotonic() - t0 < 10.0
    assert not session.writer.is_alive()
    dropped = session.dropped_replies
    assert dropped > 0
    received = 0
    try:
        while tnet.read_frame(peer) is not None:
            received += 1
    except (ConnectionError, OSError):        # the torn frame of the kick
        pass
    assert received + dropped == n
    assert sum(drops) == dropped
    peer.close()


def test_drop_accounting_reaches_metrics(world):
    _, _, tidx, _ = world
    server, net = _torch_serve(tidx, max_batch=4)
    net._record_drop(3)
    snap = server.metrics.snapshot()
    assert snap.dropped_replies == 3
    assert "dropped_replies=3" in snap.report()
    _close(net, drain=False)
