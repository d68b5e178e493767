"""The port's profiler ranges (``repro_torch.obs.trace.span``) on the CPU.

While a torch profiler runs, the served path opens a ``repro.<stage>``
range around each of its stages, stamped by the profiler itself; with no
profiler it opens none and costs a flag test a stage. A profile opened on
one thread without ``profile_all_threads`` records that thread's ranges
only, so the loop's dispatcher and worker show in a profile of every
thread. A traced request's per-stage breakdown (what the wire ships) is
the same with the ranges as without.
"""
import gc
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import IndexParams
from repro_torch.core.index import build_compact
from repro_torch.core.query import compile_pattern
from repro_torch.data.synthetic import make_corpus
from repro_torch.obs import trace as otrace
from repro_torch.obs.export import render_prometheus
from repro_torch.serve import (MicroBatcher, QueryServer, ServerConfig,
                               ServingLoop)
from repro_torch.serve.request import QueryRequest, Status

PARAMS = IndexParams(kmer=15, n_hashes=1, fpr=0.3)
CPU = [ProfilerActivity.CPU]
# the stage names a RESULT frame may carry for a scored request (the
# trace's own "deliver" follows the frame)
WIRE_STAGES = {"queue_wait", "plan", "dedup_plan", "kernel_score", "prune",
               "tile_fetch", "select"}
# what the dense path reaches: one request held for the flush timer, then
# a burst that fills two buckets, then a top-k request (its score row comes
# to the host: repro.permute)
DENSE = {"repro.compile", "repro.loop.submit", "repro.loop.timer_wait",
         "repro.loop.deliver", "repro.flush.timer", "repro.flush.full",
         "repro.score_batch", "repro.plan", "repro.stage",
         "repro.kernel_score", "repro.launch", "repro.copy",
         "repro.select", "repro.permute", "repro.gc"}
LOOP_THREADS = DENSE - {"repro.compile", "repro.loop.submit", "repro.gc"}


def _all_threads():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


@pytest.fixture(scope="module")
def world():
    c = make_corpus(64, k=15, mean_length=300, sigma=0.5, seed=3)
    idx = build_compact(c.doc_terms, PARAMS, block_docs=32, row_align=64,
                        device="cpu")
    return c, idx


def _server(idx, **cfg):
    cfg.setdefault("result_cache", 0)
    return QueryServer(idx, ServerConfig(**cfg), device="cpu")


def _serve(loop, c, n, start=0, **kw):
    """Compile and submit ``n`` reads at once (``kw`` as ``submit``'s,
    threshold 0.8 by default); wait for every answer."""
    done = threading.Semaphore(0)
    got = []

    def on_done(resp):
        got.append(resp)
        done.release()

    for i in range(start, start + n):
        terms = compile_pattern(c.documents[i % c.n_docs][:120], PARAMS)
        loop.submit(terms=terms, on_done=on_done,
                    **{"threshold": 0.8, **kw})
    for _ in range(n):
        assert done.acquire(timeout=60)
    return got


def _ranges(prof, prefix="repro."):
    """(name, start_ns, end_ns, thread) of every range named ``prefix*``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix):
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns()),
                        e.start_thread_id()))
    return out


def _dense_run(c, idx, **kw):
    """The dense path under a profile: one request flushed by the timer,
    then eight in two full buckets, then a top-k request, then a
    collection."""
    loop = ServingLoop(_server(idx, max_wait_s=0.2, max_batch=4)).start()
    try:
        with profile(activities=CPU, **kw) as prof:
            got = (_serve(loop, c, 1) + _serve(loop, c, 8, start=1)
                   + _serve(loop, c, 1, start=9, top_k=3))
            gc.collect()
    finally:
        loop.stop()
    assert all(r.status == Status.OK for r in got)
    return prof, got


def test_a_profile_of_every_thread_sees_each_stage_of_the_dense_path(world):
    c, idx = world
    prof, _ = _dense_run(c, idx, experimental_config=_all_threads())
    names = {n for n, *_ in _ranges(prof)}
    assert DENSE <= names, DENSE - names


def test_a_profile_of_one_thread_sees_that_threads_ranges(world):
    """Without ``profile_all_threads`` the profile records the thread that
    opened it: the submitter's compile and admission, not the loop's
    dispatcher and worker."""
    c, idx = world
    prof, _ = _dense_run(c, idx)
    names = {n for n, *_ in _ranges(prof)}
    assert {"repro.compile", "repro.loop.submit"} <= names
    assert not names & LOOP_THREADS
    assert len({t for *_, t in _ranges(prof)}) == 1


def test_a_batchs_stages_lie_inside_its_score_batch(world):
    c, idx = world
    prof, _ = _dense_run(c, idx, experimental_config=_all_threads())
    rs = _ranges(prof)

    def inside(child, parent):
        kids = [r for r in rs if r[0] == child]
        outer = [r for r in rs if r[0] == parent]
        assert kids and outer
        for _, s, e, t in kids:
            assert any(t == pt and ps <= s and e <= pe
                       for _, ps, pe, pt in outer), (child, parent)

    for child in ("repro.plan", "repro.stage", "repro.launch", "repro.copy",
                  "repro.select", "repro.kernel_score"):
        inside(child, "repro.score_batch")
    inside("repro.permute", "repro.select")
    inside("repro.launch", "repro.kernel_score")
    inside("repro.copy", "repro.kernel_score")


def test_ranges_sit_in_an_outer_range_and_over_the_copys_aten_events(world):
    """Scored synchronously (the profiling thread drains): the batch's
    range inside a caller's range around ``score_batch``, and the scores'
    copy over the ``aten::`` events of ``out.cpu()``."""
    c, idx = world
    server = _server(idx)
    score = server.score_batch

    def wrapped(batch):
        with record_function("caller.score_batch"):
            return score(batch)

    server.score_batch = wrapped
    for i in range(4):
        server.submit(c.documents[i][:120])
    with profile(activities=CPU) as prof:
        server.drain()
    assert len(server.pop_responses()) == 4
    rs = _ranges(prof, "")
    outer = [r for r in rs if r[0] == "caller.score_batch"]
    batch = [r for r in rs if r[0] == "repro.score_batch"]
    assert outer and len(batch) == len(outer)
    for (_, s, e, _), (_, os_, oe, _) in zip(sorted(batch, key=lambda r: r[1]),
                                             sorted(outer,
                                                    key=lambda r: r[1])):
        assert os_ <= s and e <= oe
    copies = [r for r in rs if r[0] == "repro.copy"]
    aten = [r for r in rs if r[0].startswith("aten::")]
    assert copies
    for _, s, e, _ in copies:
        assert any(s <= a_s and a_e <= e for _, a_s, a_e, _ in aten)


def test_lock_wait_only_when_another_thread_holds_the_lock(world):
    c, idx = world
    server = _server(idx)
    loop = ServingLoop(server, poll_interval_s=30.0).start()
    try:
        with profile(activities=CPU) as quiet:
            for _ in range(5):
                loop.pending()
                loop.metrics_snapshot()
        assert not [r for r in _ranges(quiet) if r[0] ==
                    "repro.loop.lock_wait"]
        assert server.metrics.registry.get(
            "serve_loop_lock_wait_seconds") is None

        held = threading.Event()

        def hold():
            with loop._lock:
                held.set()
                time.sleep(0.05)

        t = threading.Thread(target=hold)
        with profile(activities=CPU) as busy:
            t.start()
            assert held.wait(10)
            loop.pending()
        t.join()
    finally:
        loop.stop()
    waits = [r for r in _ranges(busy) if r[0] == "repro.loop.lock_wait"]
    assert len(waits) == 1 and waits[0][2] - waits[0][1] >= 20e6
    hist = server.metrics.registry.get("serve_loop_lock_wait_seconds")
    assert len(hist) == 1 and hist.percentile(50) >= 0.02
    assert "serve_loop_lock_wait_seconds" in render_prometheus(
        server.metrics.registry)


def test_gc_ranges_between_start_and_stop_only(world):
    _, idx = world
    loop = ServingLoop(_server(idx)).start()
    other = ServingLoop(_server(idx)).start()
    other.stop()                 # the hook is counted: still on for `loop`
    try:
        with profile(activities=CPU) as on:
            gc.collect()
    finally:
        loop.stop()
    with profile(activities=CPU) as off:
        gc.collect()
    assert [r for r in _ranges(on) if r[0] == "repro.gc"]
    assert not [r for r in _ranges(off) if r[0] == "repro.gc"]
    assert otrace._GC_SPANS not in gc.callbacks


def test_set_up_frozen_while_a_loop_runs(world):
    """The first loop to start freezes what the process holds; a second
    loop's start and stop leave that be, and the last to stop unfreezes
    it."""
    _, idx = world
    before = gc.get_freeze_count()      # the interpreter's own, at start
    loop = ServingLoop(_server(idx)).start()
    try:
        frozen = gc.get_freeze_count()
        assert frozen > before
        other = ServingLoop(_server(idx)).start()
        other.stop()             # counted: still frozen for `loop`
        assert gc.get_freeze_count() >= frozen
    finally:
        loop.stop()
    assert gc.get_freeze_count() == 0


def test_no_profiler_no_range_entered(world, monkeypatch):
    c, idx = world

    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    server = _server(idx, max_wait_s=0.001, max_batch=4)
    loop = ServingLoop(server).start()
    try:
        got = _serve(loop, c, 9)
        gc.collect()
        server.tiles.clear()
        server.tiles.get(0)       # a tile staged from the host
    finally:
        loop.stop()
    assert len(got) == 9 and all(r.status == Status.OK for r in got)
    assert otrace.span("select") is otrace.span("plan")  # the shared no-op


def test_a_traced_requests_stages_are_the_wires(world):
    """The per-request breakdown keeps today's names and order, with and
    without a profile of every thread."""
    c, idx = world
    for kw in ({}, {"experimental_config": _all_threads()}):
        _, got = _dense_run(c, idx, **kw)
        for r in got:
            keys = tuple(r.stages)
            assert set(keys) <= WIRE_STAGES, keys
            assert keys[:2] == ("queue_wait", "plan")
            assert keys[-1] == "select" and "kernel_score" in keys


def test_span_marks_on_the_given_clock():
    t = [10.0]

    def clock():
        t[0] += 1.0
        return t[0]

    marks = []
    with otrace.span("plan", marks, clock=clock) as sp:
        sp.tags = {"method": "lookup"}
    with otrace.span("select", marks, clock=clock):
        pass
    assert marks == [("plan", 11.0, 12.0, {"method": "lookup"}),
                     ("select", 13.0, 14.0, None)]
    with profile(activities=CPU) as prof:
        with otrace.span("copy", marks, clock=clock, seq=7):
            pass
    assert marks[-1][0] == "copy"
    assert [r[0] for r in _ranges(prof)] == ["repro.copy"]


def test_launch_range_carries_the_grouped_shards(world, monkeypatch):
    """A range's args are ``seq=<seq>`` and then each count as
    ``<key>=<value>``: the ``launch`` range of a k = 1 lookup batch names
    the shards its grouped launch scored (the dense index's one, once its
    tile is resident; none for the first batch, which stages it)."""
    c, idx = world
    args = []
    real = otrace._autograd_profiler.record_function

    def recorded(name, a=None):
        args.append((name, a))
        return real(name, a)

    monkeypatch.setattr(otrace._autograd_profiler, "record_function",
                        recorded)
    with profile(activities=CPU):
        with otrace.span("copy", seq=7, grouped=3):
            pass
        with otrace.span("copy", grouped=0):
            pass
        s = _server(idx, dedup_min_rate=None)
        reads = [d[:150] for d in c.documents if d.shape[0] >= 150][:4]
        for _ in range(2):
            for r in reads:
                s.submit(r, threshold=0.5)
            s.drain()
    assert args[:2] == [("repro.copy", "seq=7 grouped=3"),
                        ("repro.copy", "grouped=0")]
    launches = [a.split() for n, a in args if n == "repro.launch" and
                "grouped" in (a or "")]
    assert [g for _, g in launches] == ["grouped=0", "grouped=1"]
    assert all(sq.startswith("seq=") for sq, _ in launches)


def test_flushed_batches_are_numbered():
    b = MicroBatcher(term_pad=8, max_batch=2, max_wait_s=1.0)
    for i in range(5):
        b.submit(QueryRequest(i, None, 3, 0.8, submitted_at=0.0))
    full, _ = b.poll(0.5)
    rest, _ = b.poll(0.5, force=True)
    assert [x.seq for x in full] == [1, 2]
    assert [(x.seq, x.reason) for x in rest] == [(3, "force")]
