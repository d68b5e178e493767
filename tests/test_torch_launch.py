"""The port's serving CLI and worker cluster against the JAX package, on the
CPU, in subprocesses at tiny sizes.

``python -m repro_torch.launch.serve --device cpu`` must run every mode of
``python -m repro.launch.serve`` and report every answer right
(``accuracy vs ground truth: N/N``): closed and open load, a v2 store
built by either package's CLI and served by the other's, three fake hosts
with one failed, an offline ``--bulk`` sweep, and ``--listen`` answered by
a JAX ``NetClient`` and drained by SIGINT. A ``WorkerCluster`` of three
port worker processes answers equal to a JAX ``QueryEngine`` (the oracle)
behind a JAX ``RpcFrontend`` (a mixed fleet) and behind the port's, where
one worker is SIGKILLed mid-load (zero failed queries) and restarted on
its port (the channel reconnects); the counterpart of
``tests/test_rpc_plane.py::test_multiprocess_cluster_kill_and_reconnect``.

Every subprocess and socket wait has a timeout of its own, and in-process
servers have their listener shut down before ``close`` (otherwise ``close``
waits 5 s for the accept thread, in both packages).
"""
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import QueryEngine as JaxEngine
from repro.core import dna
from repro.core import load_index as jax_load
from repro.data import make_corpus, make_queries
from repro.index import ShardPlacement as JaxPlacement
from repro.serve import FrontendConfig as JaxConfig
from repro.serve import NetClient as JaxClient
from repro.serve import RpcFrontend as JaxRpcFrontend
from repro.serve import WorkerPool as JaxPool

from repro_torch.index import ShardPlacement
from repro_torch.launch.cluster import WorkerCluster
from repro_torch.serve import (FrontendConfig, NetClient, NetServer,
                               RpcFrontend, ServingLoop, Status, WorkerPool)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
N_DOCS = 130            # the CLI's v2 stores: blocks of 64 -> 3 shards
NODES = ["p0", "p1", "p2"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env.update(JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="2")
    return env


def _cmd(pkg: str, *args) -> list[str]:
    cmd = [sys.executable, "-m", f"{pkg}.launch.serve", *args]
    return cmd + (["--device", "cpu"] if pkg == "repro_torch" else [])


def _start(pkg: str, *args) -> subprocess.Popen:
    return subprocess.Popen(_cmd(pkg, *args), env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc: subprocess.Popen, queries: int) -> str:
    """The run's output; it exited 0 and answered every query right."""
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"timed out:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]
    assert f"accuracy vs ground truth: {queries}/{queries}" in out, \
        out[-3000:]
    return out


def _run(pkg: str, *args, queries: int) -> str:
    return _finish(_start(pkg, "--queries", str(queries), *args), queries)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Two v2 stores of the CLI's corpus, one built by each package's CLI
    (the port's run in closed mode), built side by side."""
    root = tmp_path_factory.mktemp("cli")
    runs = {pkg: (root / pkg, _start(pkg, "--n-docs", str(N_DOCS),
                                     "--queries", "16", "--store-format",
                                     "v2", "--index-dir", str(root / pkg)))
            for pkg in ("repro_torch", "repro")}
    return {pkg: (path, _finish(proc, 16))
            for pkg, (path, proc) in runs.items()}


@pytest.fixture(scope="module")
def world(stores):
    """The CLI's corpus, queries of it and the JAX oracle on the JAX-built
    store."""
    corpus = make_corpus(N_DOCS, k=15, mean_length=2000, sigma=1.0, seed=0)
    qs, origin = make_queries(corpus, n_pos=6, n_neg=3, length=120, seed=21)
    return corpus, qs, origin, JaxEngine(jax_load(stores["repro"][0]))


def test_closed_mode_streams_a_store(stores):
    _, out = stores["repro_torch"]
    assert "mode=closed served 16 queries" in out
    assert re.search(r"streamed v2 store: 130 docs, 3 shards", out), out
    assert "dispatch[" in out


def test_open_mode_dense_index():
    out = _run("repro_torch", "--n-docs", "48", "--mode", "open", "--qps",
               "300", queries=24)
    assert "built compact index: 48 docs" in out
    assert "mode=open served 24 queries" in out


@pytest.mark.parametrize("server,built_by", [("repro_torch", "repro"),
                                            ("repro", "repro_torch")])
def test_store_built_by_one_cli_served_by_the_other(stores, server,
                                                    built_by):
    path, _ = stores[built_by]
    out = _run(server, "--n-docs", str(N_DOCS), "--store-format", "v2",
               "--index-dir", str(path), "--tile-cache-mib", "0.1",
               queries=16)
    assert f"loaded index from {path} (3 shard(s))" in out
    if server == "repro":
        assert re.search(r"tiles\[resident=\d+ faults=[1-9]", out), out
    else:
        # the port stages the tile that fits once (in the warm-up pass)
        # and reads each batch's rows of the other shards from the store
        assert re.search(r"tiles\[resident=1 faults=0 ", out), out
        assert re.search(r"shard visits\[resident=[1-9]\d* "
                         r"gathered=[1-9]\d* staged=0\] "
                         r"rows gathered=[1-9]", out), out


def test_hosts_with_a_failed_host(stores):
    path, _ = stores["repro"]
    out = _run("repro_torch", "--n-docs", str(N_DOCS), "--store-format",
               "v2", "--index-dir", str(path), "--hosts", "3",
               "--fail-host", "host1", queries=16)
    assert ("multi-host frontend: 3 hosts, replication 2, 3 shards, "
            "down=['host1']") in out
    assert re.search(r"failovers=[1-9]", out), out


def test_bulk_file_sweeps_every_shard(stores, world, tmp_path):
    path, _ = stores["repro"]
    _, qs, _, _ = world
    bulk = tmp_path / "reads.txt"
    bulk.write_text("# reads\n\n" + "".join(dna.decode_dna(q) + "\n"
                                           for q in qs))
    out = _run("repro_torch", "--n-docs", str(N_DOCS), "--store-format",
               "v2", "--index-dir", str(path), "--bulk", str(bulk),
               queries=16)
    assert re.search(rf"bulk\[reads.txt\] done: {len(qs)} queries x 3 "
                     r"shard sweeps", out), out


def _read_lines(proc, lines: queue.Queue) -> None:
    for line in proc.stdout:
        lines.put(line)
    lines.put(None)


def test_listen_answers_a_jax_client_and_drains_on_sigint():
    corpus = make_corpus(48, k=15, mean_length=2000, sigma=1.0, seed=0)
    qs, _ = make_queries(corpus, n_pos=4, n_neg=2, length=100, seed=3)
    from repro.core import IndexParams, build_compact
    oracle = JaxEngine(build_compact(corpus.doc_terms,
                                     IndexParams(1, 0.3, 15), block_docs=64))
    proc = subprocess.Popen(_cmd("repro_torch", "--n-docs", "48",
                                 "--listen", "0"),
                            env=_env(), text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=_read_lines, args=(proc, lines),
                              daemon=True)
    reader.start()
    seen, addr = [], None
    try:
        deadline = time.monotonic() + TIMEOUT
        while addr is None:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            assert line is not None, "".join(seen)
            seen.append(line)
            m = re.match(r"serving on ([\d.]+):(\d+) \(wire protocol v4", line)
            if m:
                addr = (m.group(1), int(m.group(2)))
        client = JaxClient(*addr, timeout_s=30.0)
        try:
            futs = [(q, client.submit(q, threshold=0.8)) for q in qs]
            tops = [(q, client.submit(q, top_k=5)) for q in qs[:2]]
            for q, f in futs:
                r = f.result(30.0)
                want = oracle.search(q, threshold=0.8)
                assert r.status.value == "ok"
                np.testing.assert_array_equal(r.result.doc_ids, want.doc_ids)
                np.testing.assert_array_equal(r.result.scores, want.scores)
            for q, f in tops:
                r = f.result(30.0)
                np.testing.assert_array_equal(
                    r.result.doc_ids, oracle.top_k(q, k=5).doc_ids)
        finally:
            client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    reader.join(timeout=10)
    while True:
        line = lines.get_nowait()
        if line is None:
            break
        seen.append(line)
    out = "".join(seen)
    assert "draining in-flight batches ..." in out
    assert f"served={len(qs) + 2} rejected=0 dropped=0" in out, out


@pytest.fixture(scope="module")
def cluster(stores):
    path, _ = stores["repro"]
    with WorkerCluster(str(path), NODES, replication=2,
                       device="cpu") as cl:
        yield cl, path


def _close(server) -> None:
    """``close`` without its 5 s wait for the accept thread."""
    try:
        server._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    server.close(drain=False)


def _assert_oracle(result, want):
    np.testing.assert_array_equal(result.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(result.scores, want.scores)
    assert (result.n_terms, result.threshold) == \
        (want.n_terms, want.threshold)


def test_port_workers_under_a_jax_frontend(cluster, world):
    cl, path = cluster
    _, qs, _, oracle = world
    assert all(cl.procs[n].poll() is None for n in NODES)
    pool = JaxPool(cl.addresses)
    pool.wait_connected(timeout_s=30.0)
    fe = JaxRpcFrontend(pool, JaxPlacement.for_store(str(path), NODES,
                                                     replication=2),
                        JaxConfig(max_wait_s=0.0, hedge_after_s=30.0))
    try:
        assert fe.verify_placement() == {}
        ids = ([fe.submit(q, threshold=0.75) for q in qs]
               + [fe.submit(q, top_k=5) for q in qs])
        fe.drain()
        resp = fe.pop_responses()
        for i, rid in enumerate(ids):
            q = qs[i % len(qs)]
            want = (oracle.search(q, threshold=0.75) if i < len(qs)
                    else oracle.top_k(q, k=5))
            assert resp[rid].status.value == "ok"
            _assert_oracle(resp[rid].result, want)
        assert fe.metrics.snapshot().channels_up == len(NODES)
    finally:
        fe.close()


def test_cluster_kill_mid_load_and_restart(cluster, world):
    """3 port worker processes behind the port's RpcFrontend and a TCP
    front door, 3 clients; one worker SIGKILLed mid-load -> zero failed
    queries, every answer equal to the oracle; restarted on the same port,
    its channel reconnects."""
    cl, path = cluster
    _, qs, _, oracle = world
    placement = ShardPlacement.for_store(str(path), NODES, replication=2)
    pool = WorkerPool(cl.addresses)
    pool.wait_connected(timeout_s=30.0)
    fe = RpcFrontend(pool, placement,
                     FrontendConfig(max_wait_s=0.0, hedge_after_s=30.0))
    net = NetServer(ServingLoop(fe, workers=2)).start()
    try:
        victim = placement.owner(0)

        def client(out):
            cli = NetClient(*net.address, timeout_s=TIMEOUT)
            try:
                for _ in range(3):
                    futs = [(q, cli.submit(q, threshold=0.75)) for q in qs]
                    for q, f in futs:
                        out.append((q, f.result(TIMEOUT)))
            finally:
                cli.close()

        outs = [[] for _ in range(3)]
        threads = [threading.Thread(target=client, args=(o,)) for o in outs]
        for t in threads:
            t.start()
        time.sleep(0.3)                   # queries in flight
        cl.kill(victim)                   # SIGKILL, no drain
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        n = 0
        for out in outs:
            for q, r in out:
                assert r.status == Status.OK, (q, r.status)
                _assert_oracle(r.result, oracle.search(q, threshold=0.75))
                n += 1
        assert n == 3 * 3 * len(qs)       # zero lost queries

        cl.restart(victim)                # same port: the channel redials
        deadline = time.monotonic() + 30
        while (not pool.channel(victim).healthy
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert pool.channel(victim).healthy
        assert pool.channel(victim).reconnects >= 1
        assert fe.metrics.snapshot().channel_reconnects >= 1
        ids = [fe.submit(q, threshold=0.75) for q in qs]
        fe.drain()
        resp = fe.pop_responses()
        for q, rid in zip(qs, ids):
            _assert_oracle(resp[rid].result, oracle.search(q, 0.75))
    finally:
        _close(net)
        fe.close()


def test_make_workload_equals_jax():
    """The CLI's traffic mix (which chip_smoke.py serves) makes the same
    queries and labels in both packages."""
    from repro.launch.serve import make_workload as jax_workload
    from repro_torch.data import make_corpus as port_corpus
    from repro_torch.launch.serve import make_workload
    for n in (0, 1, 7, 24):
        got = make_workload(port_corpus(40, k=15, mean_length=500, seed=2), n)
        want = jax_workload(make_corpus(40, k=15, mean_length=500, seed=2), n)
        assert len(got[0]) == len(want[0]) == n
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        assert [int(o) for o in got[1]] == [int(o) for o in want[1]]


@pytest.mark.parametrize("spec", [
    "n0=127.0.0.1:7001,n1=:7002", " a=h:1 , b=10.0.0.2:65535", "x=@PF",
    "n0", "n0=", "=h:1", "n0=h:port"])
def test_worker_spec_parsed_alike(spec, tmp_path):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    pf = tmp_path / "w.port"
    pf.write_text("127.0.0.1 4242\n")
    spec = spec.replace("PF", str(pf))
    outs = []
    for mod in (serve, jax_serve):
        try:
            outs.append(("ok", mod.parse_worker_spec(spec, timeout_s=1.0)))
        except SystemExit as e:
            outs.append(("exit", str(e)))
    assert outs[0] == outs[1]


def test_bulk_patterns_read_alike(tmp_path):
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    f = tmp_path / "p.txt"
    f.write_text("# header\nACGT\n\n  GGCC  \n#x\nTTAA\n")
    assert serve.load_bulk_patterns(f) == jax_serve.load_bulk_patterns(f) \
        == ["ACGT", "GGCC", "TTAA"]
    f.write_text("# only comments\n\n")
    for mod in (serve, jax_serve):
        with pytest.raises(SystemExit, match="no patterns"):
            mod.load_bulk_patterns(f)
