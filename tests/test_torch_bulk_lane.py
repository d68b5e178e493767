"""The port's offline bulk lane against the JAX BulkLane, on the CPU.

The same bulk jobs go through ``repro_torch.serve.BulkLane`` over the
port's ``QueryServer`` and through the JAX ``BulkLane`` over the JAX
``QueryServer``, on the same stores (24 base documents x 6, k = 15, written
by the JAX streaming builder: raw with one 32-document block a shard,
rowdict with 128-document blocks, dense single-shard). The JAX server gets
an unpadded ``DeviceTileCache``, as the port's server has, so staged bytes
compare. Threshold and top-k jobs, pruned and not, must give the JAX
lane's results, slot scores, cutoffs, ``BulkStats`` and ``PruneStats``,
and the JAX ``QueryEngine``'s answers; a cache of one shard stages each
tile once; a checkpoint written by either package resumes in the other
(its ``required`` stays int64); ``stop()`` requeues a running job; a
failing sweep ends FAILED alike; BULK frames over the wire are answered
from the lane, or REJECTED without one; and a sweep on the lane's thread
runs beside interactive batches on the loop's. Every comparison of
results is exact.
"""
import dataclasses
import socket
import threading

import numpy as np
import pytest
import torch

from repro.core import DeviceTileCache as JaxCache
from repro.core import IndexParams as JaxParams
from repro.core import QueryEngine as JaxEngine
from repro.data import make_corpus
from repro.index import build_compact_streaming as jax_streaming
from repro.index import ShardPlacement as JaxPlacement
from repro.serve import BulkJob as JaxJob
from repro.serve import BulkLane as JaxLane
from repro.serve import Frontend as JaxFrontend
from repro.serve import FrontendConfig as JaxFrontendConfig
from repro.serve import NetClient as JaxClient
from repro.serve import QueryServer as JaxServer
from repro.serve import ServerConfig as JaxConfig
from repro.serve import ShardWorker as JaxWorker

from repro_torch.core import load_index_v2
from repro_torch.core import query as q
from repro_torch.serve import (BulkJob, BulkLane, BulkStatus, NetClient,
                               NetServer, QueryServer, ServerConfig,
                               ServingLoop, Status)
from repro_torch.index import ShardPlacement
from repro_torch.serve import Frontend, FrontendConfig, ShardWorker
from repro_torch.serve import bulk as tbulk

torch.set_num_threads(2)

CPU = "cpu"
JPARAMS = JaxParams(n_hashes=1, fpr=0.03, kmer=15)
TIMEOUT = 60.0
KINDS = ["raw", "comp", "dense"]
BULK_FIELDS = [f.name for f in dataclasses.fields(q.BulkStats)]
PRUNE_FIELDS = [f.name for f in dataclasses.fields(q.PruneStats)]


def _redundant_terms(n_base=24, reps=6, seed=3):
    c = make_corpus(n_base, k=15, mean_length=160, min_length=120,
                    seed=seed)
    return c, [c.doc_terms[i % n_base] for i in range(n_base * reps)]


def _patterns(c, n_random=4, seed=0):
    rng = np.random.default_rng(seed)
    pats = ["".join(rng.choice(list("ACGT"), size=70))
            for _ in range(n_random)]
    return pats + [c.documents[i][10:100] for i in range(4)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The corpus, kind -> (JAX index, port index over the same files),
    and the directory of the stores (one per kind)."""
    c, terms = _redundant_terms()
    root = tmp_path_factory.mktemp("bulk-lane")
    kw = {"raw": dict(block_docs=32, blocks_per_shard=1, codec="raw"),
          "comp": dict(block_docs=128, blocks_per_shard=1, codec="rowdict"),
          "dense": dict(block_docs=32, blocks_per_shard=64, codec="raw")}
    out = {}
    for kind, args in kw.items():
        jidx, _ = jax_streaming(terms, root / kind, JPARAMS, **args)
        out[kind] = (jidx, load_index_v2(root / kind, device=CPU))
    assert out["raw"][1].storage.n_shards > 2
    assert out["dense"][1].storage.n_shards == 1
    return c, out, root


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _jax_server(jidx, cap=None):
    server = JaxServer(jidx, JaxConfig(result_cache=0, row_cache=0))
    # the port's cache does not pad tiles: give the JAX server the same
    server.tiles = JaxCache(jidx.storage, capacity_bytes=cap)
    server.tiles.observer = server._on_tile_event
    return server


def _torch_server(tidx, cap=None, **cfg):
    return QueryServer(tidx, ServerConfig(result_cache=0, row_cache=0,
                                          tile_cache_bytes=cap, **cfg),
                       clock=Clock(), device=CPU)


def _lanes(stores, kind, cap=None):
    jidx, tidx = stores[1][kind]
    return (JaxLane(_jax_server(jidx, cap), chunk_terms=16),
            BulkLane(_torch_server(tidx, cap), chunk_terms=16))


def _mode_kw(mode):
    return {"top_k": int(mode[3:])} if mode.startswith("top") else \
        {"threshold": float(mode)}


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.n_terms, g.threshold) == (w.n_terms, w.threshold)


@pytest.fixture(scope="module")
def oracle(stores):
    """(kind, patterns, mode) -> the JAX QueryEngine's answers, one
    engine per store (so each compiles once)."""
    engines, answers = {}, {}

    def results(kind, pats, mode):
        key = (kind, mode, tuple(p if isinstance(p, str) else p.tobytes()
                                 for p in pats))
        if key not in answers:
            if kind not in engines:
                engines[kind] = JaxEngine(stores[1][kind][0],
                                          compressed=(kind == "comp"))
            eng = engines[kind]
            answers[key] = (
                [eng.top_k(p, k=int(mode[3:])) for p in pats]
                if mode.startswith("top")
                else [eng.search(p, threshold=float(mode)) for p in pats])
        return answers[key]
    return results


def assert_same_job(tjob, jjob):
    """The port's job ended as the JAX job did: results, sweep state and
    work counters."""
    assert tjob.status is BulkStatus.DONE, tjob.error
    assert jjob.status.value == "done", jjob.error
    assert_same_results(tjob.results, jjob.results)
    for f in ("terms", "n_valid", "perm", "slots", "required", "topk",
              "order"):
        t, j = getattr(tjob, f), np.asarray(getattr(jjob, f))
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert tjob.next_shard == jjob.next_shard == tjob.shards_total
    for f in BULK_FIELDS:
        assert getattr(tjob.stats, f) == getattr(jjob.stats, f), f
    for f in PRUNE_FIELDS:
        assert getattr(tjob.prune, f) == getattr(jjob.prune, f), f


JOBS = [(kind, mode, pruned) for kind in KINDS
        for mode in ("0.5", "0.9", "top3") for pruned in (False, True)
        if not (pruned and mode.startswith("top"))]


@pytest.mark.parametrize("kind,mode,pruned", JOBS,
                         ids=[f"{k}-{m}-{'pruned' if p else 'sweep'}"
                              for k, m, p in JOBS])
def test_job_equals_jax_lane_and_engine(stores, oracle, kind, mode, pruned):
    c = stores[0]
    jlane, tlane = _lanes(stores, kind)
    pats = _patterns(c, seed=len(kind))
    jobs = [lane.submit(pats, pruned=pruned, **_mode_kw(mode))
            for lane in (jlane, tlane)]
    for lane in (jlane, tlane):
        lane.drain()
    jjob, tjob = jobs
    assert_same_job(tjob, jjob)
    assert_same_results(tjob.results,
                        oracle(kind, pats, mode))
    assert tjob.stats.shards_swept == stores[1][kind][1].storage.n_shards
    assert tjob.stats.kernel_dispatches > 0 or pruned
    snaps = [lane.backend.metrics.snapshot() for lane in (jlane, tlane)]
    for f in ("bulk_jobs", "bulk_queries", "bulk_shards_swept",
              "bulk_staged_bytes", "bulk_yields"):
        assert getattr(snaps[1], f) == getattr(snaps[0], f), f


def _frontends(stores, kind):
    """(JAX frontend, torch frontend) over 3 hosts, replication 2, on the
    store of ``kind`` (served compressed on the rowdict store), the
    primary of shard 0 down."""
    store = stores[2] / kind
    kw = {"compressed": True} if kind == "comp" else {}
    out = []
    for P, W, F, C, dev in (
            (JaxPlacement, JaxWorker, JaxFrontend, JaxFrontendConfig, {}),
            (ShardPlacement, ShardWorker, Frontend, FrontendConfig,
             {"device": CPU})):
        place = P.for_store(store, ["h0", "h1", "h2"], replication=2)
        held = place.replica_assignment()
        fe = F({n: W(n, store, held[n], **kw, **dev)
                for n in place.nodes if held[n]}, place,
               C(max_wait_s=0.0, scatter_threads=1))
        fe.fail_worker(place.owner(0))
        out.append(fe)
    return out


FLEET_JOBS = [("raw", "0.5", False), ("raw", "top3", False),
              ("raw", "0.9", True), ("comp", "0.5", False)]


@pytest.mark.parametrize("kind,mode,pruned", FLEET_JOBS,
                         ids=[f"{k}-{m}-{'pruned' if p else 'sweep'}"
                              for k, m, p in FLEET_JOBS])
def test_lane_over_frontend_equals_jax(stores, oracle, kind, mode, pruned):
    """A lane over a torch Frontend sweeps each shard on a live replica's
    tile cache, as the JAX lane over a JAX Frontend does: equal results,
    sweep state, work counters and engine answers."""
    c = stores[0]
    jfe, tfe = _frontends(stores, kind)
    jlane, tlane = (JaxLane(jfe, chunk_terms=16),
                    BulkLane(tfe, chunk_terms=16))
    pats = _patterns(c, seed=5)
    jobs = [lane.submit(pats, pruned=pruned, **_mode_kw(mode))
            for lane in (jlane, tlane)]
    for lane in (jlane, tlane):
        lane.drain()
    assert_same_job(jobs[1], jobs[0])
    assert_same_results(jobs[1].results, oracle(kind, pats, mode))
    caches, plans = tlane._targets()
    assert len(plans) == stores[1][kind][1].storage.n_shards
    dead = tfe.placement.replicas(0)[0]
    assert caches[0] is not tfe.workers[dead].tiles
    assert tlane._params() == tfe.params
    snaps = [fe.metrics.snapshot() for fe in (jfe, tfe)]
    for f in ("bulk_jobs", "bulk_queries", "bulk_shards_swept",
              "bulk_staged_bytes"):
        assert getattr(snaps[1], f) == getattr(snaps[0], f), f


def test_each_tile_staged_once(stores):
    """Through a cache that holds one shard, the sweep stages each shard
    once: the store's bytes, as the JAX lane does."""
    c = stores[0]
    st = stores[1]["raw"][1].storage
    cap = max(st.shard_nbytes(s) for s in range(st.n_shards))
    jlane, tlane = _lanes(stores, "raw", cap)
    pats = _patterns(c)
    jobs = [lane.submit(pats, threshold=0.3) for lane in (jlane, tlane)]
    for lane in (jlane, tlane):
        lane.drain()
    jjob, tjob = jobs
    assert_same_job(tjob, jjob)
    assert tjob.stats.tiles_staged == st.n_shards
    assert tjob.stats.bytes_staged == st.nbytes()
    assert tjob.staged_bytes_per_query * len(pats) == tjob.stats.bytes_staged
    assert tlane.backend.tiles.faults == st.n_shards


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("mode", ["0.5", "top3"])
def test_checkpoint_resumes_across_packages(stores, oracle, tmp_path, writer,
                                           mode):
    """One shard swept by the writer's lane, checkpointed to a file and to
    a dict; the other package's lane resumes from each and sweeps only
    the rest. The checkpoints are equal (``required`` int64), and so are
    the results."""
    c = stores[0]
    jidx, tidx = stores[1]["raw"]
    n_sh = tidx.storage.n_shards
    pats = _patterns(c)
    cks = {}
    for pkg, lane in zip(("jax", "torch"), _lanes(stores, "raw")):
        job = lane.submit(pats, checkpoint_path=tmp_path / f"{pkg}.npz",
                          **_mode_kw(mode))
        caches, plans = lane._targets()
        job.shards_total = len(plans)
        lane._step(job, caches, plans)          # exactly one shard
        assert job.next_shard == 1
        cks[pkg] = job.checkpoint()
        assert cks[pkg]["required"].dtype == np.int64
    for f in ("slots", "required"):
        np.testing.assert_array_equal(cks["jax"][f], cks["torch"][f])
    assert cks["jax"]["next_shard"] == cks["torch"]["next_shard"] == 1
    reader = "torch" if writer == "jax" else "jax"
    load = (BulkJob if reader == "torch" else JaxJob).load
    want = oracle("raw", pats, mode)
    for resume in (load(tmp_path / f"{writer}.npz"), cks[writer]):
        lane = dict(zip(("jax", "torch"), _lanes(stores, "raw")))[reader]
        job = lane.submit(pats, resume=resume, **_mode_kw(mode))
        assert job.required.dtype == np.int64
        lane.drain()
        assert job.status.value == "done", job.error
        assert job.stats.shards_swept == n_sh - 1
        assert_same_results(job.results, want)


def test_stop_requeues_running_job(stores, oracle):
    """stop() arriving mid-sweep leaves the job checkpointed at its last
    shard and back at the queue's head; a restarted lane finishes it
    without rescoring that shard."""
    c = stores[0]
    jidx, tidx = stores[1]["raw"]
    lane = BulkLane(_torch_server(tidx), chunk_terms=16)
    first, release = threading.Event(), threading.Event()
    step = lane._step

    def held_step(job, caches, plans):
        step(job, caches, plans)
        if job.next_shard == 1:
            first.set()
            assert release.wait(TIMEOUT)

    lane._step = held_step
    pats = _patterns(c)
    lane.start()
    job = lane.submit(pats, threshold=0.5)
    assert first.wait(TIMEOUT)
    stopper = threading.Thread(target=lane.stop, args=(TIMEOUT,))
    stopper.start()
    while not lane._stopped:
        stopper.join(0.001)
    release.set()
    stopper.join(TIMEOUT)
    assert not stopper.is_alive() and lane._thread is None
    assert job.status is BulkStatus.QUEUED and job.next_shard == 1
    assert list(lane._queue) == [job] and not job.done.is_set()
    other = lane.submit(pats, top_k=2)
    assert lane.cancel(other.job_id)
    assert other.status is BulkStatus.CANCELLED and other.done.is_set()
    lane.start()
    try:
        assert job.wait(TIMEOUT)
    finally:
        lane.stop(TIMEOUT)
    assert job.status is BulkStatus.DONE, job.error
    assert job.stats.shards_swept == tidx.storage.n_shards
    assert_same_results(job.results,
                        oracle("raw", pats, "0.5"))


def test_cancel_only_queued(stores):
    c = stores[0]
    snaps = []
    for lane in _lanes(stores, "raw"):
        pats = _patterns(c)
        job = lane.submit(pats, threshold=0.5)
        caches, plans = lane._targets()
        job.shards_total = len(plans)
        job.status = type(job.status)("running")
        lane._step(job, caches, plans)
        assert 0 < job.next_shard < job.shards_total
        assert not lane.cancel(job.job_id)
        job2 = lane.submit(pats, top_k=2)
        assert lane.cancel(job2.job_id)
        assert job2.status.value == "cancelled" and job2.done.is_set()
        snap = lane.backend.metrics.snapshot()
        snaps.append((snap.bulk_jobs, snap.bulk_queries,
                      snap.bulk_shards_swept))
    assert snaps[0] == snaps[1] == (1, 0, 1)     # the cancelled job counts


def test_submit_validation(stores):
    errors = []
    for lane in _lanes(stores, "raw"):
        with pytest.raises(ValueError) as e:
            lane.submit(term_sets=[np.zeros((4, 2), np.uint32)], top_k=3,
                        pruned=True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert tbulk.BULK_TERM_QUANTUM == 8
    assert [s.value for s in BulkStatus] == \
        ["queued", "running", "done", "failed", "cancelled"]


def test_failed_sweep_ends_failed_alike(stores):
    """A sweep that raises ends FAILED, with the error's text, its
    callback fired once and the failure counted, in both packages."""
    c = stores[0]
    seen = []
    for lane in _lanes(stores, "raw"):
        def boom(job, caches, plans):
            raise RuntimeError("injected device failure")

        lane._step = boom
        done = []
        job = lane.submit(_patterns(c), threshold=0.5, on_done=done.append)
        lane.drain()
        assert done == [job] and job.done.is_set() and job.results is None
        seen.append((job.status.value, job.error,
                     lane.backend.metrics.snapshot().bulk_jobs))
    assert seen[0] == seen[1] == \
        ("failed", "RuntimeError: injected device failure", 1)


# --------------------------------------------------------------------------
# The lane behind a serving loop and the wire
# --------------------------------------------------------------------------

def _close(net) -> None:
    """``net.close()`` without its 5 s wait for the accept thread, which a
    closed listener does not wake (a shut-down one does)."""
    net._listener.shutdown(socket.SHUT_RDWR)
    net.close()


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_bulk_over_the_wire(stores, oracle, client):
    """BULK frames from either package's client are swept by the torch
    server's lane and answered one RESULT per query, equal to the JAX
    engine's; an interactive query interleaves on the same session."""
    c = stores[0]
    jidx, tidx = stores[1]["raw"]
    server = _torch_server(tidx, max_wait_s=0.0)
    loop = ServingLoop(server)
    lane = BulkLane(server, loop, chunk_terms=16).start()
    net = NetServer(loop).start()
    pats = _patterns(c)
    Client = NetClient if client == "torch" else JaxClient
    try:
        with Client(*net.address, timeout_s=TIMEOUT) as cl:
            assert cl.proto_version >= 3
            res = cl.bulk(pats, threshold=0.5, timeout_s=TIMEOUT)
            one = cl.search(pats[0], threshold=0.5)
            res_k = cl.bulk(pats, top_k=3, timeout_s=TIMEOUT)
    finally:
        _close(net)
    assert lane._thread is None                 # the loop's stop halted it
    assert all(r.status.value == "ok" and r.method == "bulk"
               and r.batch_size == len(pats) for r in res + res_k)
    assert_same_results([r.result for r in res],
                        oracle("raw", pats, "0.5"))
    assert_same_results([r.result for r in res_k],
                        oracle("raw", pats, "top3"))
    assert one.status.value == "ok"
    jobs = lane.jobs()
    assert [j.tag for j in jobs] == ["net:0", f"net:{len(pats) + 1}"]
    assert all(j.status is BulkStatus.DONE for j in jobs)


def test_bulk_frame_without_lane_rejected(stores):
    c = stores[0]
    server = _torch_server(stores[1]["raw"][1], max_wait_s=0.0)
    net = NetServer(ServingLoop(server)).start()
    try:
        with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
            res = cl.bulk(_patterns(c)[:3], threshold=0.5,
                          timeout_s=TIMEOUT)
    finally:
        _close(net)
    assert [r.status for r in res] == [Status.REJECTED] * 3


def test_failed_sweep_answers_failed_over_the_wire(stores):
    c = stores[0]
    server = _torch_server(stores[1]["raw"][1], max_wait_s=0.0)
    loop = ServingLoop(server)
    lane = BulkLane(server, loop, chunk_terms=16)

    def boom(job, caches, plans):
        raise RuntimeError("injected device failure")

    lane._step = boom
    lane.start()
    net = NetServer(loop).start()
    try:
        with NetClient(*net.address, timeout_s=TIMEOUT) as cl:
            res = cl.bulk(_patterns(c)[:3], threshold=0.5,
                          timeout_s=TIMEOUT)
    finally:
        _close(net)
    assert [r.status for r in res] == [Status.FAILED] * 3
    assert lane.jobs()[0].status is BulkStatus.FAILED


def test_sweep_beside_interactive_batches(stores, oracle):
    """A sweep on the lane's thread while the loop's worker scores
    interactive queries: both finish, every answer equal to the JAX
    engine's, and the lane's work reaches the server's metrics."""
    c = stores[0]
    jidx, tidx = stores[1]["raw"]
    server = _torch_server(tidx, max_wait_s=0.0)
    loop = ServingLoop(server).start()
    lane = BulkLane(server, loop, chunk_terms=8).start()
    pats = _patterns(c)
    try:
        job = lane.submit(pats * 8, threshold=0.5)
        done, got = threading.Event(), []

        def on_done(resp):
            got.append(resp)
            if len(got) == len(pats):
                done.set()

        for p in pats:
            loop.submit(p, threshold=0.5, on_done=on_done)
        assert done.wait(TIMEOUT), "interactive queries starved"
        assert job.wait(TIMEOUT), "the sweep never finished"
    finally:
        loop.stop()
    assert lane._thread is None
    want = oracle("raw", pats, "0.5")
    assert all(r.status is Status.OK for r in got)
    by_rid = sorted(got, key=lambda r: r.request_id)
    assert_same_results([r.result for r in by_rid], want)
    assert job.status is BulkStatus.DONE, job.error
    assert_same_results(job.results, want * 8)
    snap = server.metrics.snapshot()
    assert snap.bulk_jobs == 1 and snap.bulk_queries == len(pats) * 8
    assert snap.bulk_shards_swept == tidx.storage.n_shards
    assert snap.bulk_staged_bytes == job.stats.bytes_staged
    assert "bulk[" in snap.report()
