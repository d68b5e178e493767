"""The readers of the program's own profiler ranges (``harness/spans.py``,
``metrics/entry.compile_us_per_query.reads.py``,
``metrics/loop.lock_wait_us_per_query.reads.py``,
``metrics/device.idle_unnamed_share.reads.py``): hand-built traces with
hand-computed values, and a traced run of the tiny cell on the CPU."""
import dataclasses
import time

import pytest
import torch

from cobsbench.harness import devtrace, session, spans, traffic
from cobsbench.harness.spec import Spec

E = devtrace.Event
SPEC = Spec()
COMPILE = SPEC.metric("entry.compile_us_per_query.reads")
LOCK = SPEC.metric("loop.lock_wait_us_per_query.reads")
UNNAMED = SPEC.metric("device.idle_unnamed_share.reads")
READERS = (COMPILE, LOCK, UNNAMED)


def _run(trace, served=4, on_card=True):
    return session.Run(window_s=trace.window_s if trace else 0.0,
                       queries=None, n_requests=served, answers={}, e2e={},
                       counters={"served": served}, on_card=on_card,
                       device_name="test", trace=trace)


def _trace():
    """Window [100, 200) ns: the device busy 100-120 and 150-160 (70 ns
    idle); two host threads' ranges, one outside the window, one not the
    program's."""
    return devtrace.Trace(window=(100, 200), device=[
        E("lookup_kernel", 100, 120), E("Memcpy DtoH", 150, 160)],
        host=[E("repro.compile", 90, 104),        # clipped to 4 ns
              E("repro.compile", 104, 110),
              E("repro.loop.lock_wait", 110, 140),  # thread 1
              E("repro.loop.lock_wait", 130, 170),  # thread 2, overlapping
              E("repro.compile", 250, 260),       # after the window
              E("aten::copy_", 175, 185)])        # not a program range


def test_summed_ranges_count_each_thread():
    tr = _trace()
    assert spans.summed_s(tr, "repro.compile") == pytest.approx(10e-9)
    assert spans.summed_s(tr, "repro.loop.lock_wait") == pytest.approx(70e-9)
    assert COMPILE.read(_run(tr)) == pytest.approx(1e6 * 10e-9 / 4)
    assert LOCK.read(_run(tr)) == pytest.approx(1e6 * 70e-9 / 4)


def test_unnamed_idle_takes_the_union_of_the_threads_ranges():
    """The ranges' union, clipped, is 100-170; it overlaps the busy 100-120
    and 150-160, so 40 of the 70 idle ns are named: 30 / 70."""
    assert UNNAMED.read(_run(_trace())) == pytest.approx(100 * 30 / 70)
    busy = devtrace.Trace(window=(0, 10), device=[E("k", 0, 10)],
                          host=[E("repro.copy", 2, 4)])
    assert UNNAMED.read(_run(busy)) is None          # never idle
    bare = devtrace.Trace(window=(0, 10), device=[E("k", 0, 2)],
                          host=[E("repro.copy", 2, 4)])
    assert UNNAMED.read(_run(bare)) == pytest.approx(100 * 6 / 8)


def test_nothing_to_read():
    tr = _trace()
    parent = devtrace.Trace(window=tr.window, device=tr.device,
                            host=[e for e in tr.host
                                  if not e.name.startswith("repro.")])
    for reader in READERS:
        assert reader.read(_run(tr, on_card=False)) is None
        assert reader.read(_run(None)) is None
        assert reader.read(_run(parent)) is None     # a program without ranges
    for reader in (COMPILE, LOCK):
        assert reader.read(_run(tr, served=0)) is None


def _ctx(tiny, trace=True):
    cell = tiny.cell("dense.reads")
    return session.Context(cell="dense.reads",
                           cfg=tiny.config(cell["config"]),
                           mix=tiny.mix(cell["traffic"]), seed=7,
                           seconds=1.0, trace=trace,
                           device=torch.device("cpu"),
                           t_process=time.monotonic(), log=lambda m: None)


def test_a_traced_run_of_the_tiny_cell(tiny):
    """The submitting thread's ranges reach the harness's trace of the
    window; read as the card's trace would be, the readers give values.
    Off the card (as ``run.py`` reports on the CPU) they give none."""
    ctx = _ctx(tiny)
    run = tiny.entry(tiny.cell("dense.reads")["entry"]).run(ctx)
    assert run.trace is not None and run.counters["served"] > 0
    on_card = dataclasses.replace(run, on_card=True)
    assert COMPILE.read(on_card) > 0
    assert LOCK.read(on_card) >= 0
    assert 0 <= UNNAMED.read(on_card) <= 100
    for reader in READERS:
        assert reader.read(run) is None
    host = run.trace.host
    submits = [e for e in host if e.name == "repro.loop.submit"]
    inner = [e for e in host if e.name == "cobsbench.submit"]
    assert submits and inner
    for e in inner:
        assert any(s.start_ns <= e.start_ns and e.end_ns <= s.end_ns
                   for s in submits)


def test_the_programs_batch_inside_the_benchmarks_span(tiny):
    """A batch scored on the profiling thread: ``repro.score_batch`` inside
    the recorder's ``cobsbench.score_batch``, and ``repro.copy`` over the
    ``aten::`` events of the scores' copy, all stamped by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    ctx = _ctx(tiny)
    server = ctx.server(ctx.build_index())
    rec = session.Recorder(server, True)
    q = traffic.make_queries(ctx.mix, ctx.corpus(), ctx.seed,
                             traffic.WINDOW, 8)
    for seq in q.seqs[:4]:
        server.submit(seq, threshold=ctx.threshold)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.active = True
        server.drain()
    assert len(rec.batches) >= 1
    tr = devtrace.Trace((0, 2 ** 62), [], [
        E(e.name(), int(e.start_ns()),
          int(e.start_ns()) + int(e.duration_ns()))
        for e in prof.profiler.kineto_results.events()])
    outer = [e for e in tr.host if e.name == "cobsbench.score_batch"]
    inner = [e for e in tr.host if e.name == "repro.score_batch"]
    assert len(inner) == len(outer) == len(rec.batches)
    for e in inner:
        assert any(o.start_ns <= e.start_ns and e.end_ns <= o.end_ns
                   for o in outer)
    aten = [e for e in tr.host if e.name.startswith("aten::")]
    copies = [e for e in tr.host if e.name == "repro.copy"]
    assert copies
    for c in copies:
        assert any(c.start_ns <= a.start_ns < c.end_ns for a in aten)
