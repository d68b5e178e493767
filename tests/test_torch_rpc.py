"""The port's RPC shard data plane against the JAX package, on the CPU.

``repro_torch.serve.rpc`` speaks the JAX package's v4 shard frames, so a
fleet may mix the two: torch ``WorkerServer``s behind a JAX
``RpcFrontend``, and JAX ``WorkerServer``s behind a torch ``RpcFrontend``,
must each answer every request equal to the JAX ``QueryEngine`` (the
oracle), threshold and top-k. An all-torch fleet answers equal to the
oracle over raw, rowdict (served compressed) and pruned workers; a
straggler's hedged duplicate wins and the loser is cancelled on the wire;
a server killed mid-load loses no request; a torn frame fails the pending
requests at once; a channel reconnects after its peer restarts on the
same port, and reads healthy only once the metrics count the redial (the
JAX channel reads healthy first, ROADMAP C8); and a channel closed before
its reader thread has started
closes cleanly (the JAX channel joins the unstarted thread and raises,
ROADMAP C5). Every socket wait has a timeout of its own.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.core import build_compact as jax_build
from repro.data import make_corpus, make_queries
from repro.index import ShardPlacement as JaxPlacement
from repro.index import build_compact_streaming as jax_streaming
from repro.serve import FrontendConfig as JaxConfig
from repro.serve import RpcFrontend as JaxRpcFrontend
from repro.serve import ShardWorker as JaxWorker
from repro.serve import WorkerChannel as JaxChannel
from repro.serve import WorkerPool as JaxPool
from repro.serve import WorkerServer as JaxServer

from repro_torch.index import ShardPlacement
from repro_torch.serve import (FrontendConfig, RpcFrontend, ShardWorker,
                               Status, WorkerChannel, WorkerPool,
                               WorkerServer)
from repro_torch.serve.net import (MSG_PING, MSG_SHARD_QUERY, PROTO_VERSION,
                                   SHARD_OK, decode_rid, decode_shard_query,
                                   encode_hello, encode_ping,
                                   encode_shard_result, read_frame,
                                   write_frame)
from repro_torch.serve.rpc import ChannelDown, RpcError

torch.set_num_threads(2)

CPU = "cpu"
PARAMS = JaxParams(n_hashes=1, fpr=0.3, kmer=15)
TIMEOUT = 30.0


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(corpus, kind -> (store, corpus of its queries, JAX oracle))."""
    root = tmp_path_factory.mktemp("torch-rpc")
    c = make_corpus(96, k=15, mean_length=400, sigma=1.0, seed=11)
    jax_streaming(c.doc_terms, root / "raw", PARAMS, block_docs=32,
                  row_align=64)
    oracle = JaxEngine(jax_build(c.doc_terms, PARAMS, block_docs=32,
                                 row_align=64))
    base = make_corpus(24, k=15, mean_length=300, min_length=200, seed=3)
    rep = [base.doc_terms[i % 24] for i in range(24 * 12)]
    comp, _ = jax_streaming(rep, root / "comp", JaxParams(1, 0.03, 15),
                            block_docs=128, codec="rowdict")
    return {"raw": (root / "raw", c, oracle),
            "comp": (root / "comp", base, JaxEngine(comp, compressed=True))}


def _fleet(store, nodes, *, servers="torch", frontend="torch",
           replication=2, straggle=None, worker_kw=None, **cfg):
    """(frontend, servers) over in-process WorkerServers on ephemeral
    localhost ports, each side from the package named."""
    P = ShardPlacement if frontend == "torch" else JaxPlacement
    placement = P.for_store(store, nodes,
                            replication=min(replication, len(nodes)))
    held = placement.replica_assignment()
    straggle, kw = straggle or {}, worker_kw or {}
    out = {}
    for n in nodes:
        if not held[n]:
            continue
        if servers == "torch":
            w = ShardWorker(n, store, held[n], device=CPU, **kw)
            out[n] = WorkerServer(w, straggle_s=straggle.get(n, 0.0))
        else:
            w = JaxWorker(n, store, held[n], **kw)
            out[n] = JaxServer(w, straggle_s=straggle.get(n, 0.0))
        out[n].start()
    if frontend == "torch":
        pool = WorkerPool({n: s.address for n, s in out.items()})
        pool.wait_connected(timeout_s=TIMEOUT)
        fe = RpcFrontend(pool, placement,
                         FrontendConfig(max_wait_s=0.0, **cfg))
    else:
        pool = JaxPool({n: s.address for n, s in out.items()})
        pool.wait_connected(timeout_s=TIMEOUT)
        fe = JaxRpcFrontend(pool, placement,
                            JaxConfig(max_wait_s=0.0, **cfg))
    return fe, out


def _close(server, **kw):
    """``server.close`` without its 5 s wait for the accept thread: closing
    a listener does not wake an ``accept`` blocked on it (in either
    package), shutting it down does."""
    try:
        server._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    server.close(**kw)


def _shutdown(fe, servers):
    fe.close()
    for s in servers.values():
        _close(s)


def _serve(fe, requests):
    ids = [fe.submit(p, **kw) for p, kw in requests]
    fe.drain()
    resp = fe.pop_responses()
    assert len(resp) == len(ids)
    return [resp[i] for i in ids]


def assert_oracle(resp, requests, oracle):
    for r, (p, kw) in zip(resp, requests):
        assert r.status.value == "ok", r
        want = (oracle.top_k(p, k=kw["top_k"]) if "top_k" in kw
                else oracle.search(p, threshold=kw["threshold"]))
        np.testing.assert_array_equal(r.result.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(r.result.scores, want.scores)
        assert (r.result.n_terms, r.result.threshold) == \
            (want.n_terms, want.threshold)


def _requests(corpus, seed, n_pos=4, n_neg=2, threshold=0.75, k=5):
    qs, _ = make_queries(corpus, n_pos=n_pos, n_neg=n_neg, length=120,
                         seed=seed)
    return ([(p, {"threshold": threshold}) for p in qs]
            + [(p, {"top_k": k}) for p in qs])


@pytest.mark.parametrize("servers,frontend", [("torch", "jax"),
                                              ("jax", "torch")])
def test_mixed_fleet_equals_oracle(built, servers, frontend):
    store, c, oracle = built["raw"]
    fe, srv = _fleet(store, ["w0", "w1", "w2"], servers=servers,
                     frontend=frontend, hedge_after_s=30.0)
    try:
        assert fe.verify_placement() == {}
        reqs = _requests(c, seed=3)
        assert_oracle(_serve(fe, reqs), reqs, oracle)
        snap = fe.metrics.snapshot()
        assert snap.rpcs_sent >= fe.placement.n_shards
        assert snap.channels_up == len(srv)
        want = oracle.index.params
        assert (fe.params.n_hashes, fe.params.fpr, fe.params.kmer) == \
            (want.n_hashes, want.fpr, want.kmer)
        assert fe.n_docs == 96
    finally:
        _shutdown(fe, srv)


@pytest.mark.parametrize("kind", ["raw", "rowdict", "pruned"])
def test_torch_fleet_equals_oracle(built, kind):
    store, c, oracle = built["comp" if kind == "rowdict" else "raw"]
    kw = {"rowdict": {"compressed": True},
          "pruned": {"pruned": True, "prune_chunk": 16}}.get(kind, {})
    fe, srv = _fleet(store, ["w0", "w1", "w2"], worker_kw=kw,
                     hedge_after_s=30.0)
    try:
        reqs = _requests(c, seed=7, threshold=0.8)
        resp = _serve(fe, reqs)
        assert_oracle(resp, reqs, oracle)
        if kind == "pruned":
            assert any(r.method == "lookup_p" for r in resp)
            assert fe.metrics.snapshot().pruned_blocks > 0
        if kind == "rowdict":
            assert sum(s.worker.compressed_dispatches
                       for s in srv.values()) > 0
    finally:
        _shutdown(fe, srv)


def test_hedge_fires_real_duplicate_and_cancels_loser(built):
    store, c, oracle = built["raw"]
    placement = ShardPlacement.for_store(store, ["w0", "w1"], replication=2)
    straggler = placement.owner(0)
    fe, srv = _fleet(store, ["w0", "w1"], straggle={straggler: 0.2},
                     hedge_after_s=0.05)
    try:
        reqs = _requests(c, seed=5, n_pos=3, n_neg=1)[:4]
        _serve(fe, reqs)                  # warm
        fe.reset_metrics()
        assert_oracle(_serve(fe, reqs), reqs, oracle)
        ex = fe.executor
        assert ex.hedges_fired > 0 and ex.hedges_won > 0
        assert ex.hedges_cancelled > 0
        assert fe.pool.channel(straggler).stats()["cancelled_tiles"] > 0
        assert fe.metrics.snapshot().hedges_cancelled == ex.hedges_cancelled
        assert fe.metrics.rpc_count("cancelled") > 0
    finally:
        _shutdown(fe, srv)


def test_server_killed_mid_load_zero_lost(built):
    store, c, oracle = built["raw"]
    fe, srv = _fleet(store, ["w0", "w1", "w2"], hedge_after_s=30.0)
    try:
        reqs = _requests(c, seed=6)[:8]
        _serve(fe, reqs)                  # warm
        victim = fe.placement.owner(0)
        killer = threading.Timer(0.02, _close, args=(srv[victim],),
                                 kwargs={"abort": True})
        killer.start()
        resp = []
        for _ in range(4):
            resp += _serve(fe, reqs)
        killer.join(TIMEOUT)
        assert not killer.is_alive()
        assert_oracle(resp, reqs * 4, oracle)
        assert not fe.pool.channel(victim).healthy
    finally:
        _shutdown(fe, srv)


# --------------------------------------------------------------------------
# Channel failure modes against a scripted peer
# --------------------------------------------------------------------------

class _FakeWorker:
    """A scripted peer speaking the port's wire: HELLOs like a worker,
    then on each SHARD_QUERY 'torn' dies mid-SHARD_RESULT and 'ok' replies
    an empty result."""

    def __init__(self, script="ok", port=0):
        self.script = script
        self.dead = False
        self._live: set = set()
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", port))
        self.listener.listen(8)
        self.address = self.listener.getsockname()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            if self.dead:
                conn.close()
                continue
            self._live.add(conn)
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    def _conn(self, conn):
        conn.settimeout(TIMEOUT)
        try:
            write_frame(conn, encode_hello(PARAMS, 96, PROTO_VERSION))
            while True:
                payload = read_frame(conn)
                if payload is None or self.dead:
                    return
                if payload[0] == MSG_PING:
                    write_frame(conn, encode_ping(decode_rid(payload),
                                                  pong=True))
                    continue
                if payload[0] != MSG_SHARD_QUERY:
                    continue
                rid, _, _, _, _, _, n_live = decode_shard_query(payload)
                if self.script == "torn":
                    # the length prefix promises 4096 bytes, 10 come
                    self.dead = True
                    conn.sendall(struct.pack("!I", 4096) + b"\x01" * 10)
                    conn.close()
                    self.close()
                    return
                empty = [(np.zeros(0, np.int32), np.zeros(0, np.int32))
                         for _ in range(n_live)]
                write_frame(conn, encode_shard_result(rid, SHARD_OK, "fake",
                                                      empty))
        except (OSError, ConnectionError):
            pass
        finally:
            self._live.discard(conn)

    def close(self):
        """Die like a killed process: listener and live connections."""
        self.dead = True
        try:
            self.listener.close()
        except OSError:
            pass
        for conn in list(self._live):
            for fn in (lambda: conn.shutdown(socket.SHUT_RDWR), conn.close):
                try:
                    fn()
                except OSError:
                    pass


def _submit_dummy(ch):
    buf = np.zeros((1, 8, 2), np.uint32)
    z = np.zeros(1, np.int32)
    return ch.submit_shard(0, buf, z, z, z, 1)


def _wait_healthy(ch, want=True):
    deadline = time.monotonic() + TIMEOUT
    while ch.healthy != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return ch.healthy == want


def test_torn_frame_fails_pending_fast():
    fake = _FakeWorker(script="torn")
    ch = WorkerChannel("t0", *fake.address)
    try:
        assert _wait_healthy(ch)
        fut = _submit_dummy(ch)
        t0 = time.monotonic()
        with pytest.raises(RpcError, match="t0"):
            fut.result(timeout=TIMEOUT)
        assert time.monotonic() - t0 < 5.0
        assert not ch.healthy
        time.sleep(0.1)                   # the redial is refused
        with pytest.raises(ChannelDown):
            _submit_dummy(ch)
    finally:
        ch.close()
        fake.close()


def test_channel_reconnects_after_restart():
    fake = _FakeWorker(script="ok")
    host, port = fake.address
    ch = WorkerChannel("r0", host, port)
    try:
        assert _wait_healthy(ch)
        assert _submit_dummy(ch).result(TIMEOUT)[1] == "fake"
        fake.close()
        with pytest.raises((RpcError, ChannelDown)):
            _submit_dummy(ch).result(TIMEOUT)
        assert not ch.healthy
        deadline = time.monotonic() + TIMEOUT
        while True:                       # the old port may linger a moment
            try:
                fake = _FakeWorker(script="ok", port=port)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert _wait_healthy(ch)
        assert ch.reconnects >= 1
        assert _submit_dummy(ch).result(TIMEOUT)[1] == "fake"
        assert ch.ping(timeout_s=TIMEOUT)
    finally:
        ch.close()
        fake.close()


class _HeldMetrics:
    """A metrics stub whose ``record_channel(..., reconnect=True)`` blocks
    until released, counting the redials it was told of."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.reconnects = 0

    def record_channel(self, node, *, up, reconnect=False):
        if reconnect:
            self.entered.set()
            assert self.release.wait(TIMEOUT)
            self.reconnects += 1

    def record_rpc(self, node, outcome, n=1):
        pass


def _restart(port):
    deadline = time.monotonic() + TIMEOUT
    while True:                           # the old port may linger a moment
        try:
            return _FakeWorker(script="ok", port=port)
        except OSError:
            assert time.monotonic() < deadline
            time.sleep(0.1)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_redial_counted_before_healthy(pkg):
    """The redialer is held inside the metrics' count of a redial: the
    port's channel still reads unhealthy then, and once released its
    ``healthy``, ``reconnects`` and the metrics' count agree; the JAX
    channel already reads healthy before the metrics count it (C8)."""
    metrics = _HeldMetrics()
    fake = _FakeWorker(script="ok")
    host, port = fake.address
    Channel = WorkerChannel if pkg == "torch" else JaxChannel
    ch = Channel("c8", host, port, metrics=metrics)
    try:
        assert _wait_healthy(ch)
        fake.close()
        with pytest.raises(Exception):
            _submit_dummy(ch).result(TIMEOUT)
        assert _wait_healthy(ch, want=False)
        fake = _restart(port)
        assert metrics.entered.wait(TIMEOUT)
        assert ch.reconnects == 1 and metrics.reconnects == 0
        if pkg == "torch":
            time.sleep(0.2)
            assert not ch.healthy
        else:
            assert ch.healthy
        metrics.release.set()
        assert _wait_healthy(ch)
        if pkg == "jax":                  # healthy came before the count
            deadline = time.monotonic() + TIMEOUT
            while metrics.reconnects < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert ch.reconnects == metrics.reconnects == 1
    finally:
        metrics.release.set()
        ch.close()
        fake.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_close_before_the_reader_starts(monkeypatch, pkg):
    """The redialer is held just before it starts the reader thread of its
    first connection, and the channel is closed then: the port's close
    returns cleanly and the reader, once started, finds the socket shut;
    the JAX close joins the thread that has not started (C5)."""
    entered, release = threading.Event(), threading.Event()
    start = threading.Thread.start

    def held_start(self):
        if self.name.startswith("chan-read-"):
            entered.set()
            release.wait(TIMEOUT)
        start(self)

    monkeypatch.setattr(threading.Thread, "start", held_start)
    fake = _FakeWorker(script="ok")
    Channel = WorkerChannel if pkg == "torch" else JaxChannel
    ch = Channel("c5", *fake.address)
    try:
        assert entered.wait(TIMEOUT)
        if pkg == "torch":
            ch.close()
            assert not ch.healthy
        else:
            with pytest.raises(RuntimeError, match="before it is started"):
                ch.close()
    finally:
        release.set()
    deadline = time.monotonic() + TIMEOUT
    while ((ch._reader is None or ch._reader.ident is None)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    reader = ch._reader
    ch.close()
    fake.close()
    reader.join(TIMEOUT)
    assert not reader.is_alive()
